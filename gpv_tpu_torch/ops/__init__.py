# fold_bn is not re-exported here: it depends on gpv_tpu_torch.nn, which
# depends on this package.
from .attention import (attend_plain, biattend_plain, fused_attention,
                        fused_biattention)
from .image import normalize_image, preprocess, resize_image
from .posenc import sine_position_embedding_2d, sine_position_encoding_1d
from .roi_align import roi_align, roi_align_mean_pooled

__all__ = [
    "attend_plain", "biattend_plain", "fused_attention", "fused_biattention",
    "normalize_image", "preprocess", "resize_image",
    "sine_position_embedding_2d", "sine_position_encoding_1d", "roi_align",
    "roi_align_mean_pooled",
]
