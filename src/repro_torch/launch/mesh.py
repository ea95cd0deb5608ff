"""PAC's mesh over ``torch.distributed``, as ``repro/launch/mesh.py``'s
``make_tig_mesh`` / ``local_part_ranks``.

The JAX package lays the P sub-graph partitions on a process-spanning
"part" axis of devices. Here a rank (one process) drives one card (NCCL)
or one CPU process (gloo), and the P partition slots are cut into
contiguous blocks of P / world, one a rank: rank r holds slots
``[r * P / world, (r + 1) * P / world)``, so a rank's slots are a row
range of every partitioned array, the contract of the row-range-sharded
plan (``plan_epoch(layout="sharded", local_ranks=...)``). A rank runs its
block as one union step (``tig.distributed``).

The mesh is made over the default process group, which the caller starts
(``torch.distributed.init_process_group``; ``launch.pac_cluster`` does).
The epoch boundary's collectives run on a second group over the same
ranks (``TIGMesh.boundary``), never on the one whose gradient all-reduce
is captured in the step.
``make_production_mesh`` (the LM pods) is not ported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["TIGMesh", "make_tig_mesh", "local_part_ranks"]


@dataclasses.dataclass(frozen=True)
class TIGMesh:
    """One rank's view of the mesh: its process group, the world size,
    its rank, the number of partition slots, its own contiguous slots,
    the device it runs on, and the group of the epoch boundary's
    collectives.

    ``boundary`` is a second group over the same ranks, for the epoch
    boundary's collectives (the shared-node sync, the loss and state
    gathers); the step's gradient all-reduce, captured in its CUDA graph,
    runs on ``group``. The overlapped boundary issues its collectives on
    a side stream beside the next epoch's steps, and so they never share
    a communicator with the captured all-reduce. That alone does not rule
    out a hang: NCCL's kernels block while they wait for their peers, and
    two communicators whose kernels reach the cards in a different order
    on different ranks can deadlock unless both are resident at once. No
    run over several cards has tested it."""

    group: object
    world: int
    rank: int
    num_parts: int
    ranks: np.ndarray
    device: torch.device
    boundary: object


def make_tig_mesh(num_parts: Optional[int] = None) -> TIGMesh:
    """The PAC mesh over the default process group: ``num_parts``
    partition slots (default: one a rank), a contiguous block of
    ``num_parts // world`` a rank.

    On an NCCL group a rank drives card ``LOCAL_RANK`` (default: its
    rank) of a machine holding ``LOCAL_WORLD_SIZE`` ranks (default: all
    of them). A group with more ranks on this machine than it has cards
    is refused here, before any collective: NCCL would refuse two ranks
    on one card ("Duplicate GPU detected") or hang. A gloo group runs on
    the CPU. Raises when there is no card for NCCL, as every entry point
    of the port does."""
    if not dist.is_initialized():
        raise ValueError("make_tig_mesh needs a process group: call "
                         "torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    num_parts = world if num_parts is None else int(num_parts)
    if num_parts < 1 or num_parts % world:
        raise ValueError(f"num_parts={num_parts} is not divisible by the "
                         f"world size {world}")
    backend = dist.get_backend()
    if backend == "nccl":
        resolve_device("cuda")
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local_world > cards:
            raise ValueError(
                f"the NCCL group has {local_world} ranks on this machine, "
                f"which has {cards} card(s): NCCL runs one rank a card "
                f"(two ranks on one card fail with 'Duplicate GPU "
                f"detected'); use gloo on the CPU to run more ranks")
        device = torch.device("cuda",
                              int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"backend {backend!r}: expected 'nccl' (cards) "
                         f"or 'gloo' (CPU)")
    per = num_parts // world
    # every rank makes the mesh at the same point of the same program, so
    # every rank makes the boundary's group in the same order, as
    # ``new_group`` requires
    return TIGMesh(group=dist.group.WORLD, world=world, rank=rank,
                   num_parts=num_parts,
                   ranks=np.arange(rank * per, (rank + 1) * per,
                                   dtype=np.int64),
                   device=device,
                   boundary=dist.new_group(ranks=list(range(world))))


def local_part_ranks(mesh: TIGMesh) -> np.ndarray:
    """The partition slots this rank holds, contiguous on the "part"
    axis (the rows ``plan_epoch(local_ranks=...)`` builds here)."""
    return mesh.ranks.copy()

