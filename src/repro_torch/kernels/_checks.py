"""Argument checks shared by the CUDA kernel wrappers: each launcher takes
raw pointers, so everything it assumes is checked here first."""

from __future__ import annotations

import torch


def check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``dtype`` on
    ``device`` whose shape matches ``shape`` (``None`` entries match any
    size)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got one "
                         f"on {x.device}")
    if x.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, x.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the int ctypes passes."""
    return torch.cuda.current_stream(device).cuda_stream
