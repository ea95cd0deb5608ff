"""The paper's TIG workload, copied from ``repro/configs/speed_tig.py``:
TGN at the paper's small-dataset widths (Wikipedia, Reddit, MOOC), and
the JAX package's two-layer preset ``TIG_MXU``."""

from repro_torch.tig.models import TIGConfig

__all__ = ["TIG", "TIG_MXU"]

TIG = TIGConfig(
    flavor="tgn",
    dim=172,             # paper's feature dim on the small datasets
    dim_time=100,
    dim_edge=172,
    dim_node=172,
    num_neighbors=10,
    batch_size=200,      # paper §III-A small-dataset batch size
)

# The JAX package's two-layer perf preset, without its kernel switch (the
# port dispatches by device). Its widths are multiples of 128 (dim 128,
# raw_msg_dim 2*128 + 64 + 64 = 384, one head of 128, K 16) to fill the
# TPU's 128-lane tiles: a TPU concern, nothing the H100 kernels need. Not
# paper-faithful (use TIG for Tab.III-V); it needs 64-d edge and node
# features, which no ``synthetic_tig`` preset has.
TIG_MXU = TIGConfig(
    flavor="tgn",
    dim=128,
    dim_time=64,
    dim_edge=64,
    dim_node=64,
    num_neighbors=16,
    batch_size=200,
    n_heads=1,
    n_layers=2,
)
