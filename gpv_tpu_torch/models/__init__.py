from .detr import DETR
from .gpv import GPV

__all__ = ["DETR", "GPV"]
