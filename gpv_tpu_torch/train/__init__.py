from .optimizer import (build_optimizer, clip_detr_grads, frozen_names,
                        group_labels, param_group, warmup_linear_schedule)

__all__ = ["build_optimizer", "clip_detr_grads", "frozen_names",
           "group_labels", "param_group", "warmup_linear_schedule"]
