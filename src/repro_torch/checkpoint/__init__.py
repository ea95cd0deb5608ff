"""Checkpoints of nested dicts of tensors, in the JAX package's npz
format (``repro/checkpoint``), so a checkpoint written by one package
restores in the other."""

from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
