"""The port's epoch programs (``engine.make_train_epoch`` /
``make_eval_epoch``) against the JAX package's, and the step they share
held to what a CUDA graph capture needs, on the CPU at small widths.

On the CPU the programs are the eager loops ``scan_train_epoch`` /
``scan_eval_stream`` over the same step that the card captures once and
replays; the card's side is in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``. Tolerances are those of
``tests/test_torch_train.py``: losses, params, moments, memory and logits
to 1e-4 (float32 sums in another order, which AdamW's division by the
root of the second moment magnifies), the attention's key bias excepted.

The capture probe runs a train step (with the in-place AdamW) and a
scoring step of each flavor, and two PAC steps, under a dispatch mode that fails on what a
capture cannot take: a read of a device value on the host
(``_local_scalar_dense``), a tensor built from host data (``lift_fresh``),
and data-dependent shapes (``nonzero``, a boolean-mask index). The mode is
suspended inside the kernel entry points (``ops.sample_roles``,
``ops.neighbor_sample``, ``ops.fused_flush``, ``ops.temporal_attention``):
on the card those are the hand-written kernels; on the CPU their plain
versions run, which no graph captures.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import (  # noqa: E402
    TorchDispatchMode, _disable_current_modes)

from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.tig import engine as jengine  # noqa: E402
from repro.tig import models as jm  # noqa: E402
from repro.tig.sampler import ChronoNeighborIndex as JaxIndex  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import sep_partition, shuffle_combine  # noqa: E402
from repro_torch.kernels import fused_flush as tflush  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tig import batching as tb  # noqa: E402
from repro_torch.tig import distributed, engine  # noqa: E402
from repro_torch.tig import models as tm  # noqa: E402
from repro_torch.tig.data import synthetic_tig  # noqa: E402
from repro_torch.tig.graph import chronological_split  # noqa: E402
from repro_torch.tig.protocol import split_views  # noqa: E402
from repro_torch.tig.sampler import ChronoNeighborIndex  # noqa: E402
from repro_torch.tig.train import epoch_rng  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SMALL = dict(dim=16, dim_time=8, dim_edge=16, dim_node=16, num_neighbors=4,
             n_heads=2, batch_size=50)
TOL = 1e-4
FLAVORS = ("jodie", "dyrep", "tgn", "tige")
KERNEL_ENTRIES = ("sample_roles", "neighbor_sample", "fused_flush",
                  "temporal_attention")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _without_key_bias(tree):
    """The softmax is invariant to the key bias: its gradient is float32
    noise in both packages, which AdamW scales up to ~lr a step."""
    if "attn" in tree:
        del tree["attn"]["k"]["b"]
    return tree


def _setup(flavor: str, plan: str, split: int = 0):
    """A split of ``synthetic_tig("tiny")``, its batch program, tables and
    staged T-CSR (``plan="device"``) in both packages' forms."""
    g = synthetic_tig("tiny")
    cfg_t = tm.TIGConfig(flavor=flavor, **SMALL)
    cfg_j = jm.TIGConfig(flavor=flavor, **SMALL)
    sp = split_views(g)
    tr = sp.train
    args = (tr.src, tr.dst, tr.t, tr.eidx, g.num_nodes, cfg_t.num_neighbors,
            cfg_t.batch_size)
    index = ChronoNeighborIndex(*args)
    prog, hist = tb.build_batch_program(tr, cfg_t, epoch_rng(0, 0, 1),
                                        index=index, plan=plan)
    ex = JaxIndex(*args).device_export()
    if split == 1:
        va = sp.val
        index = ChronoNeighborIndex(
            va.src, va.dst, va.t, va.eidx, g.num_nodes, cfg_t.num_neighbors,
            cfg_t.batch_size, history=hist)
        prog, _ = tb.build_batch_program(
            va, cfg_t, epoch_rng(0, 0, 2),
            history=None if plan == "device" else hist,
            neg_pool=sp.neg_pool, index=index, plan=plan)
        ex = JaxIndex(va.src, va.dst, va.t, va.eidx, g.num_nodes,
                      cfg_t.num_neighbors, cfg_t.batch_size,
                      history=hist).device_export()
    tables = tb.make_tables(g.edge_feat, g.node_feat)
    use_tcsr = plan == "device"
    return dict(
        g=g, cfg_t=cfg_t, cfg_j=cfg_j, prog=prog,
        tables_t={k: torch.from_numpy(v) for k, v in tables.items()},
        tables_j={k: jnp.asarray(v) for k, v in tables.items()},
        prog_j={k: jnp.asarray(v) for k, v in prog.items() if k != "labels"},
        tcsr_t={k: torch.from_numpy(v)
                for k, v in index.device_export().items()}
        if use_tcsr else None,
        tcsr_j={k: jnp.asarray(v) for k, v in ex.items()}
        if use_tcsr else None)


def _leaves(tree) -> list:
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _jax_kw(s):
    return {} if s["tcsr_j"] is None else {"tcsr": s["tcsr_j"]}


@pytest.mark.parametrize("plan", ["host", "device"])
@pytest.mark.parametrize("flavor", FLAVORS)
def test_make_train_epoch_matches_jax(flavor, plan):
    s = _setup(flavor, plan)
    cfg_t, cfg_j = s["cfg_t"], s["cfg_j"]
    jparams = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    jopt = jax_adamw(lr=1e-3, max_grad_norm=1.0)
    jp, jo, js, jl = jengine.make_train_epoch(cfg_j, jopt)(
        jparams, jopt.init(jparams), jm.init_state(cfg_j, s["g"].num_nodes),
        s["prog_j"], s["tables_j"], **_jax_kw(s))

    params = convert.params_from_numpy(_np(jparams))
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    tp, to, ts, tl = engine.make_train_epoch(cfg_t, opt, device="cpu")(
        params, opt.init(params), tm.init_state(cfg_t, s["g"].num_nodes),
        s["prog"], s["tables_t"], tcsr=s["tcsr_t"])

    assert tl.shape == (s["prog"]["src"].shape[0],)
    _close(tl.numpy(), jl)
    for tree_t, tree_j in ((convert.params_to_numpy(tp), _np(jp)),
                           *((convert.params_to_numpy(to[m]), _np(jo[m]))
                             for m in ("mu", "nu"))):
        jax.tree.map(_close, _without_key_bias(tree_t),
                     _without_key_bias(tree_j))
    assert int(to["step"]) == int(jo["step"]) == s["prog"]["src"].shape[0]
    state = convert.state_to_numpy(ts)
    for key, v in _np(js).items():
        _close(state[key], v)


def _warm_state(cfg, num_nodes: int, seed: int = 0) -> dict:
    """A state with nonzero memory and last-update times (dump row 0)."""
    rng = np.random.default_rng(seed)
    st = convert.state_to_numpy(tm.init_state(cfg, num_nodes, "cpu"))
    for key in ("mem", "mem2"):
        st[key] = rng.normal(0, 0.3, st[key].shape).astype(np.float32)
        st[key][-1] = 0.0
    st["last"] = rng.uniform(0, 1, st["last"].shape).astype(np.float32)
    st["last"][-1] = 0.0
    return st


@pytest.mark.parametrize("flavor", FLAVORS)
def test_make_eval_epoch_matches_jax(flavor):
    s = _setup(flavor, "device", split=1)
    cfg_t, cfg_j = s["cfg_t"], s["cfg_j"]
    jparams = jm.init_params(jax.random.PRNGKey(1), cfg_j)
    st = _warm_state(cfg_t, s["g"].num_nodes)
    js, jaux = jengine.make_eval_epoch(cfg_j)(
        jparams, {k: jnp.asarray(v) for k, v in st.items()}, s["prog_j"],
        s["tables_j"], tcsr=s["tcsr_j"])
    ts, taux = engine.make_eval_epoch(cfg_t, device="cpu")(
        convert.params_from_numpy(_np(jparams)), convert.state_from_numpy(st),
        s["prog"], s["tables_t"], tcsr=s["tcsr_t"])
    steps, b = s["prog"]["src"].shape
    for key in ("pos_logit", "neg_logit"):
        assert taux[key].shape == (steps, b)
        _close(taux[key].numpy(), jaux[key])
    state = convert.state_to_numpy(ts)
    for key, v in _np(js).items():
        _close(state[key], v)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_inplace_adamw_is_bitwise_apply(weight_decay):
    """Five updates of ``apply_`` (in place) against ``apply`` (new
    tensors), with the global-norm clip active: bitwise equal, and the
    tensors written are the ones given."""
    gen = torch.Generator().manual_seed(0)

    def tree(scale=1.0):
        return {"a": {"w": torch.randn((5, 3), generator=gen) * scale,
                      "b": torch.randn((3,), generator=gen) * scale},
                "c": torch.randn((7,), generator=gen) * scale}

    opt = adamw(lr=1e-2, weight_decay=weight_decay, max_grad_norm=1.0)
    params = tree()
    state = opt.init(params)
    own_p = tree_map(torch.clone, params)
    own_s = opt.init(own_p)
    ptrs = [x.data_ptr() for x in _leaves([own_p, own_s])]
    for _ in range(5):
        grads = tree(scale=3.0)
        params, state = opt.apply(grads, state, params)
        opt.apply_(grads, own_s, own_p)
        got, want = _leaves([own_p, own_s]), _leaves([params, state])
        assert [x.data_ptr() for x in got] == ptrs
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert int(own_s["step"]) == 5


class CaptureProbe(TorchDispatchMode):
    """Fails on an op a CUDA graph capture cannot take."""

    HOST = ("_local_scalar_dense", "lift_fresh", "lift_fresh_copy",
            "nonzero", "masked_select")
    INDEX = ("index", "index_put", "index_put_", "_index_put_impl_")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.HOST:
            raise AssertionError(f"{func} would break a capture")
        if name in self.INDEX and any(
                i is not None and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]):
            raise AssertionError(f"{func} with a boolean mask would break "
                                 f"a capture")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def kernels_unprobed(monkeypatch):
    """The kernel entry points run with the probe suspended."""
    def suspended(fn):
        def run(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return run

    for name in KERNEL_ENTRIES:
        monkeypatch.setattr(ops, name, suspended(getattr(ops, name)))


@pytest.mark.parametrize("op", ["item", "host tensor", "mask index",
                                "nonzero"])
def test_capture_probe_catches_host_work(op):
    x = torch.arange(6.0)
    run = {"item": lambda: float(x.sum()),
           "host tensor": lambda: x + torch.tensor([1.0]),
           "mask index": lambda: x[x > 2],
           "nonzero": lambda: torch.nonzero(x)}[op]
    with pytest.raises(AssertionError, match="capture"):
        with CaptureProbe():
            run()


@pytest.mark.parametrize("flavor", FLAVORS)
def test_steps_are_capture_safe(flavor, kernels_unprobed):
    """Two train steps (the second flushes real pending messages, and both
    apply AdamW in place) and two scoring steps, device-planned, under the
    probe: the step body the card captures (``engine._Epoch.step``),
    after the epoch's tensors are staged."""
    s = _setup(flavor, "device")
    cfg = s["cfg_t"]
    prog = {k: v[:2] for k, v in s["prog"].items()}
    params = tm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    state = tm.init_state(cfg, s["g"].num_nodes, "cpu")
    dev = torch.device("cpu")
    train = engine._Epoch(cfg, opt, params, opt.init(params), state, prog,
                          s["tables_t"], s["tcsr_t"], dev)
    score = engine._Epoch(cfg, None, params, None, state, prog,
                          s["tables_t"], s["tcsr_t"], dev)
    with CaptureProbe():
        for _ in range(2):
            train.step()
            score.step()
    assert int(train.opt_state["step"]) == int(train.counter) == 2
    assert int(score.counter) == 2
    assert torch.isfinite(train.out["loss"]).all()
    assert torch.isfinite(score.out["pos_logit"]).all()


@pytest.mark.parametrize("plan", ["device", "host"])
def test_pac_step_is_capture_safe(plan, kernels_unprobed):
    """The PAC step (``distributed._PACEpoch.step``: Alg.2's row-masked
    reset and backup, each device's grid row and batch index, the
    per-device losses) under the probe, over 4 SEP parts of ``tiny``
    shuffle-combined onto 2 devices: a step where one device wraps round
    (its cycle ends, the next step resets it) and the next."""
    g = synthetic_tig("tiny")
    cfg = tm.TIGConfig(flavor="tgn", **SMALL)
    tr = chronological_split(g)[0]
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, 4)
    lists = shuffle_combine(part.node_lists(), 2, np.random.default_rng(0))
    ep = distributed.plan_epoch(tr, lists, part.shared_nodes, cfg,
                                np.random.default_rng(1), plan=plan)
    union = distributed.union_plan(ep, cfg)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    epoch = distributed._PACEpoch(cfg, opt, params, opt.init(params), union,
                                  torch.device("cpu"))
    s = int(ep.n_batches.min()) - 1
    assert s + 2 < ep.steps
    epoch.counter.fill_(s)
    with CaptureProbe():
        for _ in range(2):
            epoch.step()
    assert int(epoch.counter) == s + 2
    assert torch.isfinite(epoch.out["loss"][s:s + 2]).all()
    assert (epoch.out["loss"][s:s + 2] > 0).all()


@pytest.mark.parametrize("flush", ["plain", "in place"])
def test_programs_leave_the_callers_tensors_unchanged(flush, monkeypatch):
    """A program copies params, moments and state in and returns new
    tensors. With the card's in-place flush contract (``FusedFlush`` on
    its plain in-place forward) the results match the plain flush's."""
    s = _setup("tgn", "device")
    cfg = s["cfg_t"]
    params = tm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    state = {k: torch.from_numpy(v)
             for k, v in _warm_state(cfg, s["g"].num_nodes).items()}
    state["pend_ids"] = torch.from_numpy(np.concatenate(
        [s["prog"]["src"][0], s["prog"]["dst"][0]]).astype(np.int32))
    state["pend_raw"] = torch.randn(state["pend_raw"].shape,
                                    generator=torch.Generator().manual_seed(1))
    inputs = (params, opt.init(params), state)

    def run():
        trained = engine.make_train_epoch(cfg, opt, device="cpu")(
            *inputs, s["prog"], s["tables_t"], tcsr=s["tcsr_t"])
        scored = engine.make_eval_epoch(cfg, device="cpu")(
            params, state, s["prog"], s["tables_t"], tcsr=s["tcsr_t"])
        return _leaves(trained) + _leaves(list(scored))

    want = run()
    if flush == "in place":
        monkeypatch.setattr(tflush, "fused_flush_fwd", tflush.flush_fwd_ref)
        monkeypatch.setattr(ops, "fused_flush", tflush.FusedFlush.apply)
    before = [x.clone() for x in _leaves(list(inputs))]
    got = run()
    ptrs = {x.data_ptr() for x in _leaves(list(inputs))}
    for x, was in zip(_leaves(list(inputs)), before):
        assert torch.equal(x, was)
    assert not ptrs & {x.data_ptr() for x in got}
    assert not torch.equal(got[-4], state["mem"])     # trained mem
    for x, y in zip(got, want):
        _close(x.detach().numpy(), y.detach().numpy())
