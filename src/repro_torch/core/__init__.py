"""SPEED core: streaming edge partitioning (SEP) + parallel acceleration
(PAC), copied from ``repro/core`` (numpy only, the same results bit for
bit).

The paper's primary contribution, as host-side algorithms:
  * ``repro_torch.core.centrality`` — temporal time-decay centrality (Eq.1-2).
  * ``repro_torch.core.sep``        — Alg.1 streaming vertex-cut partitioner.
  * ``repro_torch.core.baselines``  — HDRF / Greedy / Random / LDG / KL.
  * ``repro_torch.core.metrics``    — RF / EC / balance + Thm.1-2 bounds.
  * ``repro_torch.core.pac``        — shuffle-combine, Alg.2 cycle schedule,
                                shared-node memory sync (reference impl).

The accelerator half of PAC (one card, the partitions' steps as one) is
``repro_torch.tig.distributed``.
"""

from repro_torch.core.baselines import (
    greedy_partition,
    hdrf_partition,
    kl_partition,
    ldg_partition,
    random_partition,
)
from repro_torch.core.centrality import (
    degree_centrality,
    temporal_centrality,
    top_k_hubs,
)
from repro_torch.core.metrics import (
    edge_cut_fraction,
    partition_stats,
    replication_factor,
    thm1_rf_bound,
    thm2_ec_bound,
)
from repro_torch.core.pac import (
    build_subgraph,
    cycle_schedule,
    derived_speedup,
    make_local_indices,
    shuffle_combine,
    sync_shared_memory,
)
from repro_torch.core.sep import (
    PartitionResult,
    sep_partition,
    streaming_vertex_cut,
    streaming_vertex_cut_reference,
)

__all__ = [
    "PartitionResult",
    "sep_partition",
    "streaming_vertex_cut",
    "streaming_vertex_cut_reference",
    "hdrf_partition",
    "greedy_partition",
    "random_partition",
    "ldg_partition",
    "kl_partition",
    "temporal_centrality",
    "degree_centrality",
    "top_k_hubs",
    "replication_factor",
    "edge_cut_fraction",
    "partition_stats",
    "thm1_rf_bound",
    "thm2_ec_bound",
    "shuffle_combine",
    "build_subgraph",
    "make_local_indices",
    "cycle_schedule",
    "sync_shared_memory",
    "derived_speedup",
]
