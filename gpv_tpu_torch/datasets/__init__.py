from .image import load_image, resize_uint8

__all__ = ["load_image", "resize_uint8"]
