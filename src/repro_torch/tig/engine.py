"""The streaming epoch engine, as ``repro/tig/engine.py``: one training
epoch and one forward-only scoring pass over a chronological batch
program.

The JAX package compiles an epoch into one program (``jax.jit`` of a
``lax.scan`` with donated carries). Here an epoch is one step body run
``steps`` times over tensors the epoch owns (``_Epoch``): the params, the
AdamW moments and step count, the model state, the (steps, ...) batch
program staged once on the device, a 0-dim int32 step counter and the
outputs. A step reads row ``counter`` of the batches by a device gather,
samples its neighbor grids at ``counter`` (``ops.sample_roles``), flushes,
embeds, decodes, takes the loss and its gradient with respect to the
params only, applies AdamW in place, writes every new state entry, the
loss or the logits back into the epoch's tensors, and advances the
counter. It reads and writes nothing else, so:

* ``make_train_epoch`` / ``make_eval_epoch`` on the card capture the step
  once as a CUDA graph and replay it once a batch, the counterpart of
  ``jax.jit`` over the scan body. The first call of a graph runs
  ``WARMUP_STEPS`` steps eagerly on a side stream (kernel builds, their
  shared-memory attributes, autograd's buffers), captures the step and
  replays it for the rest; later calls replay every step. A capture that
  fails raises: nothing runs eagerly in its place.
* ``scan_train_epoch`` / ``scan_eval_stream`` run the same step in a plain
  loop, with no graph. That is what the CPU runs, and on the card what
  the graphed programs are held against. ``make_*`` on the CPU are these
  loops.

The carried state is a constant to the gradient, as in JAX. The card's
flush updates ``mem`` and ``last`` in place, so every call copies the
caller's tensors into the epoch's own: the caller's state stays as it
was, as JAX's immutable arrays do, and each call returns new tensors.

With ``tcsr`` (a staged ``ChronoNeighborIndex.device_export``) the batch
program is raw edge records (``plan="device"``) and each step samples its
neighbor grids at its batch index through ``kernels.ops.sample_roles``
(with ``n_layers`` L > 1: ``ops.neighbor_sample`` over L windows, the
export's depth at least L).

A scoring pass built with ``collect_embeddings`` also owns (steps, B,
dim) ``src_embed`` / ``dst_embed`` outputs, written at the counter like
the logits (node classification trains its head on them).

PAC's epoch (the Alg.2 cycle and wrap-around of ``cycle_length`` /
``wrap_steps``, over the union of the partitions) is
``distributed._PACEpoch``, on this step's pieces.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.build import KERNELS
from repro_torch.optim import Optimizer
from repro_torch.tig.cache import lru_get
from repro_torch.tig.models import TIGConfig, step_loss
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["sample_batch_neighbors", "check_depth", "scan_train_epoch",
           "scan_eval_stream", "make_train_epoch", "make_eval_epoch",
           "release"]

_ROLES = ("src", "dst", "neg")
WARMUP_STEPS = 2        # eager steps before a capture (real steps)
_GRAPHS_MAX = 4         # captured epochs a program keeps (LRU)
_EVAL_PROGRAMS: dict = {}
_EVAL_PROGRAMS_MAX = 32


def sample_batch_neighbors(batch: dict, tcsr: dict, batch_of,
                           cfg: TIGConfig) -> dict:
    """Add device-sampled neighbor grids to a raw-edge batch.

    One (3B,) sample over src ++ dst ++ neg (``ops.sample_roles``, one
    launch on the card), with dead rows (padding / invalid) sampling node
    0 and their ids / edge rows masked to -1 (times are left as sampled),
    exactly as the host planner fills its grids. ``batch_of``: an int, a
    0-dim int32 tensor on the batch's device (read there on the card) or
    a (3B,) int32 tensor, one a row.

    With ``cfg.n_layers`` L > 1 the grids come back (L, B, K) from one
    nodes-form launch (``ops.neighbor_sample``) over L x 3B rows with
    per-row windows L-1, ..., 0 (each 3B rows), so layer l's grid holds
    the (L-1-l)-th most recent K-window; the T-CSR must be exported with
    ``depth >= L``. The windows are built on the device: the step stays
    capturable.
    """
    b = batch["src"].shape[0]
    n_l, k = cfg.n_layers, cfg.num_neighbors
    if n_l == 1:
        nb, nt, ne = ops.sample_roles(tcsr, *(batch[r] for r in _ROLES),
                                      batch["valid"], batch_of, k)
    else:
        ids3 = torch.cat([batch[r] for r in _ROLES])
        alive = (ids3 >= 0) & batch["valid"].repeat(3)
        clean = torch.where(alive, ids3, 0).to(torch.int32)
        win = torch.arange(n_l - 1, -1, -1, dtype=torch.int32,
                           device=ids3.device)[:, None].expand(n_l, 3 * b)
        if isinstance(batch_of, torch.Tensor) and batch_of.dim() == 1:
            batch_of = batch_of.repeat(n_l)
        nb, nt, ne = ops.neighbor_sample(tcsr, clean.repeat(n_l), batch_of,
                                         k, window=win.reshape(-1))
        keep = alive[:, None]
        nb = torch.where(keep, nb.view(n_l, 3 * b, k), -1)
        nt = nt.view(n_l, 3 * b, k)
        ne = torch.where(keep, ne.view(n_l, 3 * b, k), -1)
    out = dict(batch)
    for j, role in enumerate(_ROLES):
        rows = slice(j * b, (j + 1) * b)
        out[f"nbr_{role}"] = nb[..., rows, :]
        out[f"nbrt_{role}"] = nt[..., rows, :]
        out[f"nbre_{role}"] = ne[..., rows, :]
    return out


def check_depth(tcsr, cfg: TIGConfig) -> None:
    """Refuse a staged T-CSR exported shallower than ``cfg.n_layers``: the
    window-w gather reaches ``(w + 1) K`` events back, into the front pad
    of ``K * depth`` events (``indptr[0]``) for the first node. Read once
    when an epoch program takes the T-CSR, never inside the step."""
    if tcsr is None:
        return
    pad = int(tcsr["indptr"][0])
    if pad < cfg.num_neighbors * cfg.n_layers:
        raise ValueError(
            f"the staged T-CSR's front pad holds {pad} events, under "
            f"K * n_layers = {cfg.num_neighbors * cfg.n_layers}: export it "
            f"with device_export(depth >= {cfg.n_layers})")


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream of every warm-up before a capture on ``device``. One for
    all: cuBLAS keeps a workspace for each stream it runs on for the life
    of the process, so a new stream per capture held one more each."""
    return torch.cuda.Stream(device)


def _advance(counter: torch.Tensor) -> None:
    """The step's last write: the next step reads the next batch."""
    counter.add_(1)


def _staged(batches: dict) -> dict:
    """A (steps, ...) numpy batch program as CPU tensors, without the
    host-side ``labels``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batches.items() if k != "labels"}


class _Epoch:
    """The tensors one epoch program owns, and its step.

    ``opt`` None makes a scoring pass (no grads, (steps, B) logits out,
    and with ``collect`` the (steps, B, dim) embeddings of src and dst);
    otherwise a training epoch ((steps,) losses out). ``tables`` and
    ``tcsr`` are the caller's tensors, read in place (a captured graph
    keeps their addresses, so ``_replayed`` keys its graphs by them)."""

    def __init__(self, cfg: TIGConfig, opt, params, opt_state, state,
                 batches: dict, tables: dict, tcsr, device,
                 collect: bool = False):
        check_depth(tcsr, cfg)
        self.cfg, self.opt, self.tables, self.tcsr = cfg, opt, tables, tcsr
        self.device = device
        train = opt is not None

        def own(x):
            return x.detach().to(device, copy=True)

        self.params = tree_map(lambda x: own(x).requires_grad_(train),
                               params)
        self.opt_state = tree_map(own, opt_state) if train else None
        self.state = {k: own(v) for k, v in state.items()}
        self.batches = {k: own(v) for k, v in _staged(batches).items()}
        self.steps, b = self.batches["src"].shape
        self.counter = torch.zeros((), dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        if train:
            self.out = {"loss": torch.zeros((self.steps,), **f32)}
        else:
            self.out = {k: torch.zeros((self.steps, b), **f32)
                        for k in ("pos_logit", "neg_logit")}
            if collect:
                self.out.update({k: torch.zeros((self.steps, b, cfg.dim),
                                                **f32)
                                 for k in ("src_embed", "dst_embed")})
        self.graph = None
        self.per_replay: dict = {}

    @torch.no_grad()
    def load(self, params, opt_state, state, batches: dict) -> None:
        """Copy a call's inputs into the epoch's tensors; counter to 0."""
        for own, given in ((self.params, params),
                           (self.opt_state, opt_state), (self.state, state)):
            for d, s in zip(tree_leaves(own or {}), tree_leaves(given or {})):
                d.copy_(s)
        for k, v in _staged(batches).items():
            self.batches[k].copy_(v)
        self.counter.zero_()

    def step(self) -> None:
        """One step at batch ``counter``, reading and writing only the
        epoch's tensors (and reading ``tables`` / ``tcsr``)."""
        s = self.counter
        at = s.view(1)
        batch = {k: v.index_select(0, at)[0]
                 for k, v in self.batches.items()}
        if self.tcsr is not None:
            batch = sample_batch_neighbors(batch, self.tcsr, s, self.cfg)
        at = at.long()
        state = self._aliases()
        if self.opt is None:
            with torch.no_grad():
                _loss, (new, aux) = step_loss(self.params, state, batch,
                                              self.tables, self.cfg)
                for k, out in self.out.items():
                    out.index_copy_(0, at, aux[k][None])
        else:
            loss, new = self._update(state, batch,
                                     lambda loss, _aux: (loss, loss))
            self.out["loss"].index_copy_(0, at, loss[None])
        self._write_back(state, new)
        _advance(s)

    def _aliases(self) -> dict:
        """Aliases of the state tensors without autograd history: the
        card's flush writes mem / last through them in place, and the
        epoch's own tensors stay plain leaves."""
        return {k: v.detach() for k, v in self.state.items()}

    def _update(self, state: dict, batch: dict, objective):
        """``step_loss``, then AdamW in place on the gradient with respect
        to the params of the scalar that ``objective(loss, aux)`` returns
        first. Returns the second thing it returns (what the epoch
        records), detached, and the new state."""
        leaves = tree_leaves(self.params)
        with torch.enable_grad():
            loss, (new, aux) = step_loss(self.params, state, batch,
                                         self.tables, self.cfg)
            target, record = objective(loss, aux)
            grads = torch.autograd.grad(target, leaves, allow_unused=True)
        # a leaf the loss does not reach (e.g. the time encoder of the
        # memory-only flavors) has a zero gradient, as in JAX
        it = iter(self._reduce([torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, grads)]))
        self.opt.apply_(tree_map(lambda _: next(it), self.params),
                        self.opt_state, self.params)
        return record.detach(), new

    def _reduce(self, grads: list) -> list:
        """The gradients AdamW applies, in leaf order: the step's own (PAC
        over several ranks averages them across the ranks here)."""
        return grads

    @torch.no_grad()
    def _write_back(self, state: dict, new: dict) -> None:
        """The card's flush returns mem / last themselves, written in
        place; every other new entry is copied back."""
        for k, v in new.items():
            if v is not state[k]:
                self.state[k].copy_(v)

    def run_eager(self) -> None:
        for _ in range(self.steps):
            self.step()

    def replay(self) -> None:
        """The whole epoch through the step's CUDA graph: the first call
        runs ``WARMUP_STEPS`` steps eagerly on a side stream and captures
        the step; every step after those is one replay. Each replay adds
        the kernel launches its capture recorded to ``KERNELS``."""
        done = 0
        if self.graph is None:
            side = _side_stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                while done < min(WARMUP_STEPS, self.steps):
                    self.step()
                    done += 1
            torch.cuda.current_stream(self.device).wait_stream(side)
            before = {n: k.launches for n, k in KERNELS.items()}
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.step()
            # the capture ran nothing: its launches count once a replay
            for n, kern in KERNELS.items():
                self.per_replay[n] = kern.launches - before[n]
                kern.launches = before[n]
            self.graph = graph
        for _ in range(self.steps - done):
            self.graph.replay()
        for n, c in self.per_replay.items():
            KERNELS[n].launches += c * (self.steps - done)

    def result(self, copy: bool):
        """The call's outputs; ``copy`` when the epoch's tensors will be
        reused by a later call."""
        def out(x):
            return x.detach().clone() if copy else x.detach()

        state = {k: out(v) for k, v in self.state.items()}
        if self.opt is None:
            return state, {k: out(v) for k, v in self.out.items()}
        return (tree_map(out, self.params), tree_map(out, self.opt_state),
                state, out(self.out["loss"]))


def scan_train_epoch(params, opt_state, state, batches, tables, *,
                     cfg: TIGConfig, opt: Optimizer, tcsr=None, device=None):
    """One training epoch over a (steps, ...) batch program, as a plain
    loop of eager steps.

    ``params``, ``opt_state``, ``state`` and ``tables`` are tensor dicts on
    ``device`` (default ``"cuda"``; raises if there is no card and the
    caller did not ask for the CPU); ``batches`` is a numpy program from
    ``build_batch_program``. Returns ``(params, opt_state, state, losses)``
    with ``losses`` a (steps,) tensor on the device.
    """
    device = resolve_device(device)
    epoch = _Epoch(cfg, opt, params, opt_state, state, batches, tables,
                   tcsr, device)
    epoch.run_eager()
    return epoch.result(copy=False)


def scan_eval_stream(params, state, batches, tables, *, cfg: TIGConfig,
                     collect_embeddings: bool = False, tcsr=None,
                     device=None):
    """Forward-only pass over a chronological stream (memory keeps
    updating, params frozen), as a plain loop of eager steps. Returns
    ``(state, aux)`` with ``aux`` holding (steps, B) ``pos_logit`` /
    ``neg_logit`` on the device, and with ``collect_embeddings`` (steps,
    B, dim) ``src_embed`` / ``dst_embed`` (off by default: only node
    classification needs them)."""
    device = resolve_device(device)
    epoch = _Epoch(cfg, None, params, None, state, batches, tables, tcsr,
                   device, collect=collect_embeddings)
    epoch.run_eager()
    return epoch.result(copy=False)


def _layout(tree) -> tuple:
    """Shapes and dtypes of a tensor tree, in leaf order."""
    return tuple((tuple(x.shape), x.dtype) for x in tree_leaves(tree))


def _where(tree) -> tuple:
    """Addresses, shapes and strides of the tensors a graph reads in
    place (``tables``, ``tcsr``)."""
    if tree is None:
        return ()
    return tuple((k, v.data_ptr(), tuple(v.shape), v.stride(), v.dtype)
                 for k, v in sorted(tree.items()))


def _replayed(graphs: dict, cfg, opt, params, opt_state, state, batches,
              tables, tcsr, device, collect: bool = False):
    """One call of a graphed program: the epoch captured for this stream
    and shape (built on a miss), loaded with the call's inputs and
    replayed; returns new tensors."""
    key = (_layout(params), _layout(opt_state or {}), _layout(state),
           tuple((k, v.shape, v.dtype.str) for k, v in sorted(
               batches.items()) if k != "labels"),
           _where(tables), _where(tcsr))
    epoch = lru_get(graphs, key, _GRAPHS_MAX, lambda: _Epoch(
        cfg, opt, params, opt_state, state, batches, tables, tcsr, device,
        collect=collect))
    epoch.load(params, opt_state, state, batches)
    epoch.replay()
    return epoch.result(copy=True)


def make_train_epoch(cfg: TIGConfig, opt: Optimizer, *, device=None):
    """The training epoch program: ``(params, opt_state, state, batches,
    tables, *, tcsr=None) -> (params, opt_state, state, losses)``, as
    ``scan_train_epoch`` returns them.

    On the card (``device`` defaults to ``"cuda"``; raises without one)
    each stream and shape gets its own captured step, kept with the
    program in ``.graphs`` (LRU, ``_GRAPHS_MAX``); on the CPU the program
    is ``scan_train_epoch``."""
    device = resolve_device(device)
    if device.type != "cuda":
        return functools.partial(scan_train_epoch, cfg=cfg, opt=opt,
                                 device=device)
    graphs: dict = {}

    def train_epoch(params, opt_state, state, batches, tables, *,
                    tcsr=None):
        return _replayed(graphs, cfg, opt, params, opt_state, state,
                         batches, tables, tcsr, device)

    train_epoch.graphs = graphs
    return train_epoch


def make_eval_epoch(cfg: TIGConfig, *, collect_embeddings: bool = False,
                    device=None):
    """The scoring program: ``(params, state, batches, tables, *,
    tcsr=None) -> (state, aux)``, as ``scan_eval_stream`` returns them
    (with ``collect_embeddings``, the embeddings too).

    Programs are cached per (cfg, collect_embeddings, device) with LRU
    eviction, as the JAX package's: per-epoch validation and final
    scoring reuse one program and its captured steps (train, val and test
    streams each get their own: a graph keeps the addresses of its
    T-CSR). On the CPU the program is ``scan_eval_stream``."""
    device = resolve_device(device)
    if device.type != "cuda":
        return functools.partial(scan_eval_stream, cfg=cfg,
                                 collect_embeddings=collect_embeddings,
                                 device=device)

    def build():
        graphs: dict = {}

        def eval_epoch(params, state, batches, tables, *, tcsr=None):
            return _replayed(graphs, cfg, None, params, None, state,
                             batches, tables, tcsr, device,
                             collect=collect_embeddings)

        eval_epoch.graphs = graphs
        return eval_epoch

    key = (dataclasses.astuple(cfg), collect_embeddings, str(device))
    return lru_get(_EVAL_PROGRAMS, key, _EVAL_PROGRAMS_MAX, build)


def release(tables: dict) -> None:
    """Drop every cached scoring graph that reads ``tables``, with its
    copies of state and batches and its memory pool: for a run whose
    tables are its own, once it is done no later call can replay them."""
    ptrs = {v.data_ptr() for v in tables.values()}
    for program in _EVAL_PROGRAMS.values():
        for key in [k for k, ep in program.graphs.items()
                    if ptrs & {v.data_ptr() for v in ep.tables.values()}]:
            del program.graphs[key]
