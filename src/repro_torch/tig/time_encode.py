"""TGAT-style functional time encoding Phi (paper §II-C), as
``repro/tig/time_encode.py``.

    Phi(dt) = cos(dt * w + b),   w_k = 1 / 10^{alpha * k / d}

``w`` and ``b`` are trainable (initialized to the TGAT values).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["init_time_encoder", "time_encode"]


def init_time_encoder(dim: int, max_scale: float = 9.0,
                      device=None) -> dict:
    """Trainable params for a ``dim``-dimensional time encoding."""
    w = 1.0 / np.power(10.0, max_scale * np.arange(dim) / max(dim - 1, 1))
    return {
        "w": torch.tensor(w, dtype=torch.float32, device=device),
        "b": torch.zeros(dim, dtype=torch.float32, device=device),
    }


def time_encode(params: dict, dt: torch.Tensor) -> torch.Tensor:
    """Phi(dt): shape (..., dim) for dt of shape (...)."""
    return torch.cos(dt[..., None] * params["w"] + params["b"])
