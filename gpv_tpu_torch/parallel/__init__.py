from .train_step import TrainState, batch_to_device, make_train_step

__all__ = ["TrainState", "batch_to_device", "make_train_step"]
