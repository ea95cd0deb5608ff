"""The LM token pipeline, as ``repro/data`` (numpy)."""

from repro_torch.data.pipeline import (LMDataConfig, packed_batches,
                                       synthetic_corpus)

__all__ = ["LMDataConfig", "packed_batches", "synthetic_corpus"]
