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
  * ``train``            — ``train_single``, ``train_sharded``.
"""
