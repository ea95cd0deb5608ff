"""The port's epoch plans, training epoch and ``train_single`` against the
JAX package's, on ``synthetic_tig("tiny")`` at small widths, on the CPU.

Plans are numpy in both packages and must be bit-identical. Training is
float32 with sums taken in another order: losses, params and memory agree
to 1e-4 (AdamW divides by the root of the second moment, which magnifies
the last-bit differences of near-zero gradients), val / test AP to 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.tig import batching as jb  # noqa: E402
from repro.tig import models as jm  # noqa: E402
from repro.tig.data import synthetic_tig as jax_synthetic_tig  # noqa: E402
from repro.tig.engine import make_train_epoch  # noqa: E402
from repro.tig.engine import (  # noqa: E402
    sample_batch_neighbors as jax_sample_batch_neighbors)
from repro.tig.protocol import split_views as jax_split_views  # noqa: E402
from repro.tig.sampler import ChronoNeighborIndex as JaxIndex  # noqa: E402
from repro.tig.train import epoch_rng as jax_epoch_rng  # noqa: E402
from repro.tig.train import train_single as jax_train_single  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tig import batching as tb  # noqa: E402
from repro_torch.tig import models as tm  # noqa: E402
from repro_torch.tig.data import synthetic_tig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.tig.engine import (  # noqa: E402
    sample_batch_neighbors, scan_train_epoch)
from repro_torch.tig.protocol import split_views  # noqa: E402
from repro_torch.tig.sampler import ChronoNeighborIndex  # noqa: E402
from repro_torch.tig.train import epoch_rng, train_single  # noqa: E402

SMALL = dict(flavor="tgn", dim=16, dim_time=8, dim_edge=16, dim_node=16,
             num_neighbors=4, n_heads=2, batch_size=50)
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("plan", ["host", "device"])
def test_batch_programs_bit_identical(plan):
    g, jg = synthetic_tig("tiny"), jax_synthetic_tig("tiny")
    for f in ("src", "dst", "t", "edge_feat", "node_feat", "labels"):
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
    cfg_t, cfg_j = tm.TIGConfig(**SMALL), jm.TIGConfig(**SMALL)
    sp_t, sp_j = split_views(g), jax_split_views(jg)
    np.testing.assert_array_equal(sp_t.neg_pool, sp_j.neg_pool)
    np.testing.assert_array_equal(sp_t.inductive, sp_j.inductive)
    hist_t = hist_j = None
    for i, (vt, vj) in enumerate(zip(sp_t.views, sp_j.views)):
        bt, hist_t = tb.build_batch_program(
            vt, cfg_t, epoch_rng(0, 0, i + 1), history=hist_t,
            neg_pool=sp_t.neg_pool, plan=plan)
        bj, hist_j = jb.build_batch_program(
            vj, cfg_j, jax_epoch_rng(0, 0, i + 1), history=hist_j,
            neg_pool=sp_j.neg_pool, plan=plan)
        assert bt.keys() == bj.keys()
        for key in bt:
            assert bt[key].dtype == bj[key].dtype, key
            np.testing.assert_array_equal(bt[key], bj[key], err_msg=key)
        for f in ("nbr", "time", "eidx"):
            np.testing.assert_array_equal(getattr(hist_t, f),
                                          getattr(hist_j, f))


def test_scan_train_epoch_matches_jax():
    g = synthetic_tig("tiny")
    cfg_t, cfg_j = tm.TIGConfig(**SMALL), jm.TIGConfig(**SMALL)
    tr = split_views(g).train
    args = (tr.src, tr.dst, tr.t, tr.eidx, g.num_nodes, cfg_t.num_neighbors,
            cfg_t.batch_size)
    index = ChronoNeighborIndex(*args)
    prog, _ = tb.build_batch_program(tr, cfg_t, epoch_rng(0, 0, 1),
                                     index=index, plan="device")
    tables = tb.make_tables(g.edge_feat, g.node_feat)
    ex = JaxIndex(*args).device_export()

    jparams = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    jopt = jax_adamw(lr=1e-3, max_grad_norm=1.0)
    jp, jo, js, jl = make_train_epoch(cfg_j, jopt)(
        jparams, jopt.init(jparams), jm.init_state(cfg_j, g.num_nodes),
        {k: jnp.asarray(v) for k, v in prog.items() if k != "labels"},
        {k: jnp.asarray(v) for k, v in tables.items()},
        tcsr={k: jnp.asarray(v) for k, v in ex.items()})

    params = convert.params_from_numpy(_np(jparams))
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    tp, to, ts, tl = scan_train_epoch(
        params, opt.init(params), tm.init_state(cfg_t, g.num_nodes), prog,
        {k: torch.from_numpy(v) for k, v in tables.items()}, cfg=cfg_t,
        opt=opt, tcsr={k: torch.from_numpy(v)
                       for k, v in index.device_export().items()},
        device="cpu")

    assert tl.shape == (prog["src"].shape[0],)
    _close(tl.numpy(), jl)
    # the softmax is invariant to the key bias, so its gradient is float32
    # noise in both packages, which AdamW scales up to ~lr per step: its
    # value and moments are not compared
    for tree_t, tree_j in ((convert.params_to_numpy(tp), _np(jp)),
                           *((convert.params_to_numpy(to[m]), _np(jo[m]))
                             for m in ("mu", "nu"))):
        del tree_t["attn"]["k"]["b"], tree_j["attn"]["k"]["b"]
        jax.tree.map(_close, tree_t, tree_j)
    assert int(to["step"]) == int(jo["step"]) == prog["src"].shape[0]
    state = convert.state_to_numpy(ts)
    for key, v in _np(js).items():
        _close(state[key], v)


@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("step", ["mid", "last"])
def test_sample_batch_neighbors_matches_jax(step, backend):
    """The step's sampling (``ops.sample_roles`` on the CPU, and the engine
    around it) against the JAX package's ``sample_batch_neighbors`` (its
    XLA path, or its Pallas kernel in interpret mode) on the same raw
    batch, bit for bit: a mid-epoch batch with invalid slots and -1 ids
    put in, and the last batch, padded by the planner."""
    g = synthetic_tig("tiny")
    cfg_t = tm.TIGConfig(**SMALL)
    cfg_j = jm.TIGConfig(**SMALL, use_pallas=backend != "xla",
                         kernel_backend="interpret")
    tr = split_views(g).train
    index = ChronoNeighborIndex(tr.src, tr.dst, tr.t, tr.eidx, g.num_nodes,
                                cfg_t.num_neighbors, cfg_t.batch_size)
    prog, _ = tb.build_batch_program(tr, cfg_t, epoch_rng(0, 0, 1),
                                     index=index, plan="device")
    s = prog["src"].shape[0] // 2 if step == "mid" else -1
    raw = {k: prog[k][s].copy() for k in ("src", "dst", "neg", "t",
                                          "eidx", "valid")}
    if step == "mid":
        raw["valid"][::7] = False
        raw["src"][3::11] = -1
        raw["dst"][5::13] = -1
    else:
        assert (raw["src"] < 0).any() and not raw["valid"].all()
    s %= prog["src"].shape[0]
    ex = index.device_export()
    want = jax_sample_batch_neighbors(
        {k: jnp.asarray(v) for k, v in raw.items()},
        {k: jnp.asarray(v) for k, v in ex.items()}, s, cfg_j)
    tcsr = {k: torch.from_numpy(v) for k, v in ex.items()}
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    got = sample_batch_neighbors(batch, tcsr, s, cfg_t)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    nb, nt, ne = ops.sample_roles(tcsr, batch["src"], batch["dst"],
                                  batch["neg"], batch["valid"], s,
                                  cfg_t.num_neighbors)
    for j, role in enumerate(("src", "dst", "neg")):
        rows = slice(j * len(raw["src"]), (j + 1) * len(raw["src"]))
        for x, name in ((nb, "nbr"), (nt, "nbrt"), (ne, "nbre")):
            np.testing.assert_array_equal(x[rows].numpy(),
                                          np.asarray(want[f"{name}_{role}"]))
    dead = ~np.tile(raw["valid"], 3) | (np.concatenate(
        [raw["src"], raw["dst"], raw["neg"]]) < 0)
    assert dead.any() and (nb.numpy()[dead] == -1).all()


@pytest.fixture(scope="module")
def tiny_runs():
    """One ``train_single`` epoch in each package from the same params."""
    g = synthetic_tig("tiny")
    cfg_j = jm.TIGConfig(**SMALL)
    jres = jax_train_single(jax_synthetic_tig("tiny"), cfg_j, epochs=1,
                            plan="device", prefetch=False)
    p0 = convert.params_from_numpy(
        _np(jm.init_params(jax.random.PRNGKey(0), cfg_j)))
    runs = {plan: train_single(g, tm.TIGConfig(**SMALL), epochs=1,
                               plan=plan, params=p0, device="cpu")
            for plan in ("device", "host")}
    return jres, runs


def test_train_single_matches_jax(tiny_runs):
    jres, runs = tiny_runs
    tres = runs["device"]
    _close(tres.losses, jres.losses)
    np.testing.assert_allclose(tres.val_ap, jres.val_ap, atol=1e-3)
    np.testing.assert_allclose(tres.test_ap, jres.test_ap, atol=1e-3)
    np.testing.assert_allclose(tres.test_ap_inductive,
                               jres.test_ap_inductive, atol=1e-3)


def test_train_single_host_plan_equals_device_plan(tiny_runs):
    _, runs = tiny_runs
    dev, host = runs["device"], runs["host"]
    assert dev.losses == host.losses
    assert (dev.val_ap, dev.test_ap) == (host.val_ap, host.test_ap)
    for key in dev.state:
        assert torch.equal(dev.state[key], host.state[key])


def test_scans_leave_the_callers_state_unchanged(monkeypatch):
    """The card's flush updates ``mem`` / ``last`` in place; the scans copy
    them once at entry, so the caller's state stays as JAX's immutable
    arrays do (``train_single`` scores val and test from the states it
    passed in). Run on the CPU with the flush routed through
    ``FusedFlush`` and its in-place plain forward."""
    from repro_torch.kernels import fused_flush as tflush
    from repro_torch.kernels import ops
    from repro_torch.tig.engine import make_train_epoch
    from repro_torch.tig.protocol import score_stream
    from repro_torch.tig.train import train_epoch

    calls = []

    def inplace_flush(*a):
        calls.append(1)
        return tflush.FusedFlush.apply(*a)

    monkeypatch.setattr(tflush, "fused_flush_fwd", tflush.flush_fwd_ref)
    monkeypatch.setattr(ops, "fused_flush", inplace_flush)
    g = synthetic_tig("tiny")
    cfg = tm.TIGConfig(**SMALL)
    tr = split_views(g).train
    prog, _ = tb.build_batch_program(tr, cfg, epoch_rng(0, 0, 1),
                                     plan="host")
    prog = {k: v[:4] for k, v in prog.items()}
    tables = {k: torch.from_numpy(v)
              for k, v in tb.make_tables(g.edge_feat, g.node_feat).items()}
    params = tm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gen = torch.Generator().manual_seed(1)

    def fresh_state():
        state = tm.init_state(cfg, g.num_nodes, "cpu")
        state["mem"] = torch.randn(state["mem"].shape, generator=gen)
        state["mem"][-1] = 0.0
        state["last"] = torch.rand(state["last"].shape, generator=gen)
        state["last"][-1] = 0.0
        # pending messages of a previous batch, so the first flush writes
        state["pend_ids"] = torch.from_numpy(
            np.concatenate([prog["src"][0], prog["dst"][0]]).astype(np.int32))
        state["pend_raw"] = torch.randn(state["pend_raw"].shape,
                                        generator=gen)
        return state

    # the stand-in does write in place: a bare step changes its input
    state = fresh_state()
    before = state["mem"].clone()
    batch = {k: torch.from_numpy(v[0]) for k, v in prog.items()
             if k != "labels"}
    tm.step_loss(params, state, batch, tables, cfg)
    assert calls and not torch.equal(state["mem"], before)

    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    for run in (
            lambda s: train_epoch(params, opt.init(params), s, prog, tables,
                                  make_train_epoch(cfg, opt,
                                                   device="cpu"))[2],
            lambda s: score_stream(params, cfg, s, prog, tables,
                                   device="cpu")["state"]):
        state = fresh_state()
        mem0, last0 = state["mem"].clone(), state["last"].clone()
        n_calls = len(calls)
        out = run(state)
        assert len(calls) == n_calls + 4
        assert torch.equal(state["mem"], mem0)
        assert torch.equal(state["last"], last0)
        assert not torch.equal(out["mem"], mem0)
