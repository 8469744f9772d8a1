from .build import build_engine
from .predictions import (compute_cap_test_predictions,
                          compute_vqa_test_predictions, evaluate_predictions,
                          iter_padded_batches, make_predictions,
                          predict_dataset, update_samples_with_image_size)

__all__ = [
    "build_engine", "compute_cap_test_predictions",
    "compute_vqa_test_predictions", "evaluate_predictions",
    "iter_padded_batches", "make_predictions", "predict_dataset",
    "update_samples_with_image_size",
]
