"""Processes and collectives (`mesh`), tensor parallelism
(`sharding_rules`, `tensor_parallel`) and the train step (`train_step`).
The step's names resolve at first use: the model's modules import
`tensor_parallel`, and the step imports the modules."""

__all__ = ["TrainState", "batch_to_device", "make_train_step"]


def __getattr__(name):
    if name in __all__:
        from . import train_step
        return getattr(train_step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
