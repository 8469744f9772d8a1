from .coco import (DATASET_CLASSES, CocoCapTestOriginalSplit,
                   CocoCaptioning, CocoClassification, CocoDetection,
                   CocoMultitaskDataset, CocoVqa, CocoVqaTestOriginalSplit,
                   GenericCocoDataset, RefCocop)
from .image import load_image, resize_uint8

__all__ = [
    "DATASET_CLASSES", "CocoCapTestOriginalSplit", "CocoCaptioning",
    "CocoClassification", "CocoDetection", "CocoMultitaskDataset", "CocoVqa",
    "CocoVqaTestOriginalSplit", "GenericCocoDataset", "RefCocop",
    "load_image", "resize_uint8",
]
