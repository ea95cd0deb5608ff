"""The roofline of the port: the analytic byte models of SPEED's kernels
(``kernel_bytes``) and of PAC's epoch boundary (``pipeline_bubble``), the
step cost counter (``op_cost``) and the roofline report with the H100's
peaks (``analysis``). Copies of ``repro/roofline`` where those are plain
Python; the counter takes the place of the HLO walker."""

from repro_torch.roofline.analysis import (MODEL_FLOPS, CollectiveStats,
                                           RooflineReport, analyze_step,
                                           peak_flops, roofline_report)
from repro_torch.roofline.op_cost import OpCost

__all__ = ["MODEL_FLOPS", "CollectiveStats", "RooflineReport",
           "analyze_step", "peak_flops", "roofline_report", "OpCost"]
