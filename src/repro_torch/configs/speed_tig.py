"""The paper's TIG workload, copied from ``repro/configs/speed_tig.py``:
TGN at the paper's small-dataset widths (Wikipedia, Reddit, MOOC)."""

from repro_torch.tig.models import TIGConfig

__all__ = ["TIG"]

TIG = TIGConfig(
    flavor="tgn",
    dim=172,             # paper's feature dim on the small datasets
    dim_time=100,
    dim_edge=172,
    dim_node=172,
    num_neighbors=10,
    batch_size=200,      # paper §III-A small-dataset batch size
)
