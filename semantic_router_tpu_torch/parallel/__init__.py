"""The one-device LoRA training step (``train_step``).  The JAX package's
mesh, sharding and multi-host modules are not ported: a mesh over more
than one device is refused (``training.loop.run_lora_training``)."""

from .train_step import (
    TrainState,
    cross_entropy_loss,
    make_lora_optimizer,
    make_train_step,
)

__all__ = ["TrainState", "cross_entropy_loss", "make_lora_optimizer",
           "make_train_step"]
