"""TIG models and the single-device trainer, in PyTorch.

Modules, each the counterpart of the one of the same name in ``repro.tig``:
  * ``graph``, ``data``  — TemporalGraph and synthetic datasets (numpy).
  * ``sampler``          — host-side T-CSR temporal neighbor index (numpy).
  * ``batching``         — chronological batch programs (numpy).
  * ``evaluation``       — AP / AUROC (numpy).
  * ``time_encode``, ``modules``, ``models`` — the TIG architecture.
  * ``engine``           — one training epoch / one scoring pass.
  * ``protocol``         — chronological splits, stream scoring and
                           ``run_protocol``.
  * ``restart``          — TIGER's restarter (replayless memory warm-up).
  * ``stream``           — out-of-core shards and the epoch prefetcher.
  * ``distributed``      — PAC over SEP partitions on one card.
  * ``train``            — ``train_single``, ``train_sharded``, and the
                           single steps ``make_train_step`` /
                           ``make_eval_step``.

The package exports the JAX package's eight names.
"""

from repro_torch.tig.graph import TemporalGraph, chronological_split
from repro_torch.tig.models import TIGConfig
from repro_torch.tig.protocol import ProtocolSplits, run_protocol, split_views
from repro_torch.tig.stream import EpochPrefetcher, ShardedStream

__all__ = ["TemporalGraph", "chronological_split", "TIGConfig",
           "ShardedStream", "EpochPrefetcher",
           "ProtocolSplits", "run_protocol", "split_views"]
