from .detr import DETR, detr_from_config
from .gpv import GPV, build_gpv

__all__ = ["DETR", "detr_from_config", "GPV", "build_gpv"]
