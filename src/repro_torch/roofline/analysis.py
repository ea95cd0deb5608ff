"""Roofline terms of one step on the H100, the counterpart of
``repro/roofline/analysis.py``.

The JAX package derives its three terms from a compiled XLA artifact for
a TPU. The port derives them from the step cost counter
(``op_cost.OpCost``), which counts what a step dispatches, on the card,
the CPU or the ``meta`` device alike:

    compute term    = FLOPs            / peak FLOP/s of the dtype
    memory term     = bytes            / HBM_BW
    collective term = collective bytes / LINK_BW

The port trains and serves on one card, so a report is of one card
(``MESH``, ``CHIPS``). ``RooflineReport`` keeps the JAX report's fields
and names: ``hlo_flops`` and ``hlo_bytes`` hold the counter's FLOPs and
bytes. The counted FLOPs are those of the JAX program that each kernel
stands in for (``op_cost``), masked attention chunks included, so the
compute term and a counted-FLOP share of the peak overstate the work of
masked attention; ``MODEL_FLOPS`` (6 N D) is the utilisation yardstick.

Hardware constants, NVIDIA H100 SXM5 (80 GB) data sheet, dense (no
sparsity): 989 TFLOP/s bf16 and 495 TFLOP/s TF32 on the tensor cores,
67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s HBM3, 900 GB/s of NVLink
(4th generation, 18 links) per GPU. The port turns TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``), so float32 compute
takes the float32 peak.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.roofline.op_cost import OpCost

__all__ = ["BF16_FLOPS", "TF32_FLOPS", "FP32_FLOPS", "HBM_BW", "LINK_BW",
           "MESH", "CHIPS", "CollectiveStats", "RooflineReport",
           "MODEL_FLOPS", "peak_flops", "roofline_report", "analyze_step"]

BF16_FLOPS = 989e12      # FLOP/s, dense bf16 on the tensor cores
TF32_FLOPS = 495e12      # FLOP/s, dense TF32 on the tensor cores
FP32_FLOPS = 67e12       # FLOP/s, float32 on the CUDA cores
HBM_BW = 3.35e12         # bytes/s, HBM3
LINK_BW = 900e9          # bytes/s of NVLink per GPU (H100 SXM5 data sheet)
MESH = "h100x1"          # the report's mesh: one card
CHIPS = 1


def peak_flops(dtype: str = "bfloat16") -> float:
    """The card's peak for a compute dtype: bf16 on the tensor cores,
    float32 on the CUDA cores (TF32 is off in the port)."""
    if dtype in ("bfloat16", "bf16", "float16", "fp16"):
        return BF16_FLOPS
    if dtype in ("float32", "fp32"):
        return FP32_FLOPS
    raise ValueError(f"no peak for compute dtype {dtype!r}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))


def MODEL_FLOPS(n_params: int, tokens: int, kind: str = "train") -> float:
    """6*N*D for training; 2*N*D for inference forward passes."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params * tokens


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # one card's counts
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    # terms in seconds
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / counted FLOPs
    per_device_peak_memory: Optional[float]
    collective_counts: dict
    collective_bytes_by_kind: dict
    note: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def roofline_report(cost: OpCost, *, arch: str, shape: str,
                    model_flops: float, dtype: str = "bfloat16",
                    peak_memory: Optional[float] = None,
                    note: str = "") -> RooflineReport:
    """The report of a counted step (``cost``, one card's counts)."""
    coll = CollectiveStats(counts=dict(cost.collective_counts),
                           bytes_by_kind=dict(cost.collective_bytes_by_kind))
    flops = float(cost.flops)
    bytes_ = float(cost.bytes)
    coll_bytes = float(cost.collective_bytes)
    compute_s = flops / peak_flops(dtype)
    memory_s = bytes_ / HBM_BW
    collective_s = coll_bytes / LINK_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return RooflineReport(
        arch=arch, shape=shape, mesh=MESH, chips=CHIPS,
        hlo_flops=flops, hlo_bytes=bytes_, collective_bytes=coll_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        useful_ratio=(model_flops / flops) if flops else 0.0,
        per_device_peak_memory=peak_memory,
        collective_counts=coll.counts,
        collective_bytes_by_kind=coll.bytes_by_kind, note=note)


def analyze_step(fn, *args, arch: str, shape: str, model_flops: float,
                 dtype: str = "bfloat16",
                 peak_memory: Optional[float] = None,
                 note: str = "", **kwargs) -> RooflineReport:
    """Run ``fn(*args, **kwargs)`` once under ``OpCost`` and report it:
    the counterpart of ``analyze_compiled``. Any device works; on
    ``meta`` nothing is allocated."""
    with OpCost() as cost:
        fn(*args, **kwargs)
    return roofline_report(cost, arch=arch, shape=shape,
                           model_flops=model_flops, dtype=dtype,
                           peak_memory=peak_memory, note=note)
