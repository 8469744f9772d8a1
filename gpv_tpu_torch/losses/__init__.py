from .criterion import (LossConfig, TASK_IDS, TEXT_TASKS, gpv_criterion,
                        localization_losses, text_ce_losses)

__all__ = ["LossConfig", "TASK_IDS", "TEXT_TASKS", "gpv_criterion",
           "localization_losses", "text_ce_losses"]
