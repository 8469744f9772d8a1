from .config import ConfigNode, load_config, save_config, to_dict

__all__ = ["ConfigNode", "load_config", "save_config", "to_dict"]
