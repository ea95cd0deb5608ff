"""Multi-layer temporal attention (``n_layers`` L > 1) in the port against
the JAX package, on the CPU at small widths on ``synthetic_tig("tiny")``.

The fold itself (``modules.stacked_temporal_attention``) at L = 1 is
``temporal_attention`` bit for bit and at L = 2 agrees with JAX's
``lax.scan`` fold to 1e-5, forward and grads. Sampling and planning are
integer or copied data and must be equal bitwise: the windowed
``sample_batch_neighbors`` (L = 2, 3) and the host plan's (steps, L, B,
K) grids. ``step_loss`` agrees to rtol 1e-4 / atol 1e-5, and
``train_single`` / ``pac_train`` to ``TOL`` 1e-4 (losses, params, memory;
float32 sums in another order, which AdamW's division by the root of the
second moment magnifies) and 1e-3 (AP), as ``tests/test_torch_train.py``
and ``tests/test_torch_pac.py`` hold them at one layer. Within the port,
host and device plans, and ``train_sharded`` and ``train_single``, are
bitwise equal (one intra-op thread). The step bodies at L = 2 pass the
capture probe of ``tests/test_torch_graph.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sep_partition as jax_sep_partition  # noqa: E402
from repro.tig import batching as jb  # noqa: E402
from repro.tig import distributed as jd  # noqa: E402
from repro.tig import models as jm  # noqa: E402
from repro.tig import modules as jmod  # noqa: E402
from repro.tig.data import synthetic_tig as jax_synthetic_tig  # noqa: E402
from repro.tig.engine import (  # noqa: E402
    sample_batch_neighbors as jax_sample_batch_neighbors)
from repro.tig.graph import chronological_split as jax_split  # noqa: E402
from repro.tig.protocol import split_views as jax_split_views  # noqa: E402
from repro.tig.train import epoch_rng as jax_epoch_rng  # noqa: E402
from repro.tig.train import train_single as jax_train_single  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.speed_tig import TIG_MXU  # noqa: E402
from repro_torch.core import sep_partition, shuffle_combine  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tig import batching as tb  # noqa: E402
from repro_torch.tig import distributed as td  # noqa: E402
from repro_torch.tig import engine  # noqa: E402
from repro_torch.tig import models as tm  # noqa: E402
from repro_torch.tig import modules as tmod  # noqa: E402
from repro_torch.tig.data import synthetic_tig  # noqa: E402
from repro_torch.tig.graph import chronological_split  # noqa: E402
from repro_torch.tig.protocol import split_views  # noqa: E402
from repro_torch.tig.sampler import ChronoNeighborIndex  # noqa: E402
from repro_torch.tig.stream import (ShardedStream,  # noqa: E402
                                    write_graph_shards)
from repro_torch.tig.train import (epoch_rng, train_sharded,  # noqa: E402
                                   train_single)
from repro_torch.tree import tree_map  # noqa: E402
from test_torch_graph import (CaptureProbe,  # noqa: E402,F401
                              kernels_unprobed)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tests: the suite runs in
    several worker processes at once, and a torch that takes every core
    in each of them makes the workers contend for the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(flavor="tgn", dim=16, dim_time=8, dim_edge=16, dim_node=16,
             num_neighbors=4, n_heads=2, batch_size=50)
L2 = dict(SMALL, n_layers=2)
TOL = 1e-4
RTOL, ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _without_key_bias(tree):
    """The softmax is invariant to the key bias: its gradient is float32
    noise in both packages, which AdamW scales up to ~lr a step."""
    del tree["attn"]["k"]["b"]
    return tree


@pytest.fixture
def one_thread():
    """Multi-threaded CPU reductions are not bitwise reproducible run to
    run; the bitwise checks between two port runs take one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the fold

def _fold_inputs(n_layers, b=32, k=5, d=16, d_extra=12, d_kv=24, seed=0):
    """Seeded numpy inputs of the fold: JAX's stacked params, h0, extra,
    (L, B, K, d_kv) neighbor features and masks with a row of none."""
    rng = np.random.default_rng(seed)
    p = _np(jmod.stacked_attn_init(jax.random.PRNGKey(seed), n_layers,
                                   d + d_extra, d_kv, d, 2))
    h0 = rng.normal(size=(b, d)).astype(np.float32)
    extra = rng.normal(size=(b, d_extra)).astype(np.float32)
    kv = rng.normal(size=(n_layers, b, k, d_kv)).astype(np.float32)
    mask = rng.random((n_layers, b, k)) < 0.7
    mask[:, 0] = False
    return p, h0, extra, kv, mask


def test_stacked_fold_at_one_layer_is_temporal_attention():
    p, h0, extra, kv, mask = (torch.from_numpy(x) if isinstance(
        x, np.ndarray) else convert.params_from_numpy(x)
        for x in _fold_inputs(1))
    got = tmod.stacked_temporal_attention(p, h0, extra, kv, mask, n_heads=2)
    want = tmod.temporal_attention(tree_map(lambda x: x[0], p),
                                   torch.cat([h0, extra], dim=-1), kv[0],
                                   mask[0], n_heads=2)
    assert torch.equal(got, want)


def test_stacked_fold_at_two_layers_matches_jax():
    """Forward and the grads of every input (the params' (L, ...) leaves,
    h0, extra, the neighbor features) against ``jax.grad`` of JAX's
    ``lax.scan`` fold, to 1e-5; and the fold differs from either layer
    alone (the carry threads through)."""
    p, h0, extra, kv, mask = _fold_inputs(2, seed=1)
    w = np.random.default_rng(2).normal(size=(32, 16)).astype(np.float32)

    def jloss(p, h0, extra, kv):
        out = jmod.stacked_temporal_attention(p, h0, extra, kv,
                                              jnp.asarray(mask), n_heads=2)
        return (out * w).sum(), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(p, h0, extra, kv)
    tp = tree_map(lambda x: x.requires_grad_(), convert.params_from_numpy(p))
    tx = [torch.from_numpy(x).requires_grad_() for x in (h0, extra, kv)]
    tout = tmod.stacked_temporal_attention(tp, *tx, torch.from_numpy(mask),
                                           n_heads=2)
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout, atol=1e-5,
                               rtol=1e-5)
    tg = [tree_map(lambda x: x.grad.numpy(), tp)] + [x.grad.numpy()
                                                     for x in tx]
    for a, b in zip(tg, jg):
        jax.tree.map(lambda u, v: np.testing.assert_allclose(
            u, np.asarray(v), atol=1e-5, rtol=1e-5), a, b)
    for layer in range(2):
        single = tmod.temporal_attention(
            tree_map(lambda x: x[layer].detach(), tp),
            torch.cat([tx[0], tx[1]], -1).detach(), tx[2][layer].detach(),
            torch.from_numpy(mask[layer]), n_heads=2)
        assert not torch.allclose(tout.detach(), single)


# ------------------------------------------------------------ sampling

def _train_index(cfg_t, depth):
    g = synthetic_tig("tiny")
    tr = split_views(g).train
    index = ChronoNeighborIndex(tr.src, tr.dst, tr.t, tr.eidx, g.num_nodes,
                                cfg_t.num_neighbors, cfg_t.batch_size)
    prog, _ = tb.build_batch_program(tr, cfg_t, epoch_rng(0, 0, 1),
                                     index=index, plan="device")
    return index, prog, index.device_export(depth=depth)


@pytest.mark.parametrize("n_layers,step,backend", [
    (2, "mid", "xla"), (2, "last", "xla"), (3, "mid", "xla"),
    (3, "last", "xla"), (2, "mid", "interpret")])
def test_windowed_sample_batch_neighbors_matches_jax(n_layers, step,
                                                     backend):
    """The windowed (L, B, K) grids of one nodes-form sample against the
    JAX package's ``sample_batch_neighbors`` (its XLA path, or its Pallas
    kernel in interpret mode), bit for bit: a mid-epoch batch with
    invalid slots and -1 ids put in, and the planner's padded last batch;
    the layer of window 0 is the one-layer grid."""
    cfg_t = tm.TIGConfig(**dict(SMALL, n_layers=n_layers))
    cfg_j = jm.TIGConfig(**dict(SMALL, n_layers=n_layers),
                         use_pallas=backend != "xla",
                         kernel_backend="interpret")
    _, prog, ex = _train_index(cfg_t, n_layers)
    s = prog["src"].shape[0] // 2 if step == "mid" else -1
    raw = {k: prog[k][s].copy() for k in ("src", "dst", "neg", "t",
                                          "eidx", "valid")}
    if step == "mid":
        raw["valid"][::7] = False
        raw["src"][3::11] = -1
        raw["dst"][5::13] = -1
    s %= prog["src"].shape[0]
    want = jax_sample_batch_neighbors(
        {k: jnp.asarray(v) for k, v in raw.items()},
        {k: jnp.asarray(v) for k, v in ex.items()}, s, cfg_j)
    tcsr = {k: torch.from_numpy(v) for k, v in ex.items()}
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    got = engine.sample_batch_neighbors(batch, tcsr, s, cfg_t)
    assert got.keys() == want.keys()
    for key in got:
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    one = engine.sample_batch_neighbors(
        batch, tcsr, s, dataclasses.replace(cfg_t, n_layers=1))
    for key in ("nbr_src", "nbrt_dst", "nbre_neg"):
        assert torch.equal(got[key][-1], one[key])
    assert (got["nbr_src"] >= 0).any() and (got["nbr_src"] < 0).any()
    # an older window holds older events where both are filled
    t0, t1 = got["nbrt_src"][-1], got["nbrt_src"][-2]
    both = (t0 >= 0).all(1) & (t1 >= 0).all(1)
    assert both.any() and (t1[both].max(1).values
                           <= t0[both].min(1).values).all()


def test_windowed_sampling_takes_per_row_batch_indices():
    """PAC passes a batch index a row (3B,); at L layers the sampler
    repeats it for each window: equal to one scalar index."""
    cfg = tm.TIGConfig(**L2)
    _, prog, ex = _train_index(cfg, 2)
    s = prog["src"].shape[0] // 2
    tcsr = {k: torch.from_numpy(v) for k, v in ex.items()}
    batch = {k: torch.from_numpy(prog[k][s]) for k in ("src", "dst", "neg",
                                                       "valid")}
    rows = torch.full((3 * cfg.batch_size,), s, dtype=torch.int32)
    a = engine.sample_batch_neighbors(batch, tcsr, rows, cfg)
    b = engine.sample_batch_neighbors(batch, tcsr, s, cfg)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_shallow_export_is_refused_when_staged():
    """A T-CSR exported at depth 1 under a two-layer model is refused when
    an epoch program takes it, before any step runs."""
    cfg = tm.TIGConfig(**L2)
    index, prog, _ = _train_index(cfg, 2)
    g = synthetic_tig("tiny")
    tables = {k: torch.from_numpy(v) for k, v in
              tb.make_tables(g.edge_feat, g.node_feat).items()}
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    shallow = {k: torch.from_numpy(v)
               for k, v in index.device_export(depth=1).items()}
    with pytest.raises(ValueError, match="depth"):
        engine.scan_eval_stream(params, tm.init_state(cfg, g.num_nodes),
                                prog, tables, cfg=cfg, tcsr=shallow,
                                device="cpu")


# ------------------------------------------------------------ the plan

def test_host_plan_at_two_layers_equals_jax():
    """The (steps, L, B, K) host grids of the three splits, array for
    array, with the history handed on as ``train_single`` does."""
    g, jg = synthetic_tig("tiny"), jax_synthetic_tig("tiny")
    cfg_t, cfg_j = tm.TIGConfig(**L2), jm.TIGConfig(**L2)
    sp_t, sp_j = split_views(g), jax_split_views(jg)
    hist_t = hist_j = None
    for i, (vt, vj) in enumerate(zip(sp_t.views, sp_j.views)):
        bt, hist_t = tb.build_batch_program(
            vt, cfg_t, epoch_rng(0, 0, i + 1), history=hist_t,
            neg_pool=sp_t.neg_pool)
        bj, hist_j = jb.build_batch_program(
            vj, cfg_j, jax_epoch_rng(0, 0, i + 1), history=hist_j,
            neg_pool=sp_j.neg_pool)
        assert bt.keys() == bj.keys()
        steps, b = bt["src"].shape
        assert bt["nbr_src"].shape == (steps, 2, b, cfg_t.num_neighbors)
        for key in bt:
            assert bt[key].dtype == bj[key].dtype, key
            np.testing.assert_array_equal(bt[key], bj[key], err_msg=key)


@pytest.mark.parametrize("flavor", ["tgn", "tige"])
def test_step_loss_at_two_layers_matches_jax(flavor):
    """Two consecutive steps on host grids, from JAX's stacked params:
    loss, logits, every gradient (the (L, ...) attention leaves among
    them) and the carried state."""
    g = synthetic_tig("tiny")
    kw = dict(L2, flavor=flavor)
    cfg_t, cfg_j = tm.TIGConfig(**kw), jm.TIGConfig(**kw)
    batches, _ = tb.build_batch_program(split_views(g).train, cfg_t,
                                        epoch_rng(0, 0, 1))
    tables = tb.make_tables(g.edge_feat, g.node_feat)
    jparams = jm.init_params(jax.random.PRNGKey(1), cfg_j)
    assert np.shape(jparams["attn"]["q"]["w"])[0] == 2
    tparams = convert.params_from_numpy(_np(jparams))
    jstate = jm.init_state(cfg_j, g.num_nodes)
    tstate = tm.init_state(cfg_t, g.num_nodes)
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    tt = {k: torch.from_numpy(v) for k, v in tables.items()}
    grad_fn = jax.value_and_grad(jm.step_loss, has_aux=True)
    for s in (0, 1):
        batch = {k: v[s] for k, v in batches.items() if k != "labels"}
        (jl, (jstate, jaux)), jg = grad_fn(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            jt, cfg_j)
        tstate = {k: v.detach() for k, v in tstate.items()}
        p = tree_map(lambda x: x.detach().requires_grad_(), tparams)
        tl, (tstate, taux) = tm.step_loss(
            p, tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
            tt, cfg_t)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(taux["pos_logit"].detach().numpy(),
                                   jaux["pos_logit"], rtol=RTOL, atol=ATOL)
        tg = tree_map(lambda x: x.grad.numpy(), p)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=RTOL, atol=ATOL), tg, _np(jg))
        tsn = convert.state_to_numpy(tstate)
        for key, v in _np(jstate).items():
            np.testing.assert_allclose(tsn[key], v, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ the trainers

def _p0(cfg_j):
    return convert.params_from_numpy(
        _np(jm.init_params(jax.random.PRNGKey(0), cfg_j)))


@pytest.fixture(scope="module")
def l2_runs():
    """One ``train_single`` epoch at two layers: JAX's (device plan), the
    port's under both plans from JAX's initial params, and the port's at
    one layer; one intra-op thread, for the bitwise comparisons."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg_j = jm.TIGConfig(**L2)
        jres = jax_train_single(jax_synthetic_tig("tiny"), cfg_j, epochs=1,
                                plan="device", prefetch=False)
        g = synthetic_tig("tiny")
        runs = {plan: train_single(g, tm.TIGConfig(**L2), epochs=1,
                                   plan=plan, params=_p0(cfg_j),
                                   device="cpu")
                for plan in ("device", "host")}
        runs["one layer"] = train_single(g, tm.TIGConfig(**SMALL), epochs=1,
                                         device="cpu")
    finally:
        torch.set_num_threads(n)
    return jres, runs


def test_train_single_at_two_layers_matches_jax(l2_runs):
    jres, runs = l2_runs
    tres = runs["device"]
    _close(tres.losses, jres.losses)
    np.testing.assert_allclose(tres.val_ap, jres.val_ap, atol=1e-3)
    np.testing.assert_allclose(tres.test_ap, jres.test_ap, atol=1e-3)
    np.testing.assert_allclose(tres.test_ap_inductive,
                               jres.test_ap_inductive, atol=1e-3)
    jax.tree.map(_close, _without_key_bias(convert.params_to_numpy(
        tres.params)), _without_key_bias(_np(jres.params)))


def test_train_single_at_two_layers_host_plan_equals_device_plan(l2_runs):
    _, runs = l2_runs
    dev, host = runs["device"], runs["host"]
    assert dev.losses == host.losses
    assert (dev.val_ap, dev.test_ap) == (host.val_ap, host.test_ap)
    for key in dev.state:
        assert torch.equal(dev.state[key], host.state[key])


def test_two_layers_differ_from_one(l2_runs):
    _, runs = l2_runs
    assert runs["device"].losses != runs["one layer"].losses
    assert np.all(np.isfinite(runs["device"].losses))


def test_train_sharded_at_two_layers_is_train_single(l2_runs, tmp_path,
                                                     one_thread):
    """Shards give the same plans, T-CSR (at depth 2) and table bytes as
    the in-memory graph: the same losses bit for bit."""
    _, runs = l2_runs
    g = synthetic_tig("tiny")
    write_graph_shards(g, str(tmp_path), shard_edges=333)
    got = train_sharded(ShardedStream.open(str(tmp_path)),
                        tm.TIGConfig(**L2), epochs=1, protocol=True,
                        params=_p0(jm.TIGConfig(**L2)), device="cpu")
    assert got.losses == runs["device"].losses
    assert np.isfinite(got.metrics["test_ap"])


@pytest.mark.parametrize("plan", ["device", "host"])
def test_pac_train_at_two_layers_matches_jax(plan):
    """4 SEP parts on 4 devices, one epoch, against JAX's vmap
    ``pac_train`` from the same params: losses (P, steps), params and
    the post-sync memories to 1e-4, val / test AP to 1e-3."""
    g, jg = synthetic_tig("tiny"), jax_synthetic_tig("tiny")
    tr, jtr = chronological_split(g)[0], jax_split(jg)[0]
    cfg_t, cfg_j = tm.TIGConfig(**L2), jm.TIGConfig(**L2)
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, 4, k=0.05)
    jpart = jax_sep_partition(jtr.src, jtr.dst, jtr.t, jg.num_nodes, 4,
                              k=0.05)
    kw = dict(num_devices=4, epochs=1, plan=plan)
    want = jd.pac_train(jtr, jpart, cfg_j, mesh=None, prefetch=False,
                        epoch_boundary="serial", eval_graph=jg, **kw)
    got = td.pac_train(tr, part, cfg_t, eval_graph=g, params=_p0(cfg_j),
                       device="cpu", **kw)
    for a, b in zip(got.losses, want.losses):
        assert a.shape == np.asarray(b).shape
        _close(a, b)
    assert len(set(got.plan.n_batches.tolist())) > 1
    jax.tree.map(_close, _without_key_bias(convert.params_to_numpy(
        got.params)), _without_key_bias(_np(want.params)))
    for k, v in want.memory_states.items():
        _close(got.memory_states[k].numpy(), v)
    for k in ("val_ap", "test_ap"):
        np.testing.assert_allclose(got.metrics[k], want.metrics[k],
                                   atol=1e-3)


# ------------------------------------------------------------ capture

@pytest.mark.parametrize("flavor", ["tgn", "tige"])
def test_two_layer_steps_are_capture_safe(flavor, kernels_unprobed):
    """Two train steps and two scoring steps at L = 2, device-planned
    (the windows built on the device), under the capture probe."""
    cfg = tm.TIGConfig(**dict(L2, flavor=flavor))
    _, prog, ex = _train_index(cfg, 2)
    prog = {k: v[:2] for k, v in prog.items()}
    g = synthetic_tig("tiny")
    tables = {k: torch.from_numpy(v) for k, v in
              tb.make_tables(g.edge_feat, g.node_feat).items()}
    tcsr = {k: torch.from_numpy(v) for k, v in ex.items()}
    params = tm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    state = tm.init_state(cfg, g.num_nodes, "cpu")
    dev = torch.device("cpu")
    train = engine._Epoch(cfg, opt, params, opt.init(params), state, prog,
                          tables, tcsr, dev)
    score = engine._Epoch(cfg, None, params, None, state, prog, tables,
                          tcsr, dev)
    with CaptureProbe():
        for _ in range(2):
            train.step()
            score.step()
    assert int(train.opt_state["step"]) == int(train.counter) == 2
    assert torch.isfinite(train.out["loss"]).all()
    assert torch.isfinite(score.out["pos_logit"]).all()


@pytest.mark.parametrize("plan", ["device", "host"])
def test_two_layer_pac_step_is_capture_safe(plan, kernels_unprobed):
    """The PAC step at L = 2 under the probe, 4 SEP parts of ``tiny``
    shuffle-combined onto 2 devices: the step where a device wraps round
    and the next (per-row batch indices repeated for each window, or the
    host grids' layer axis moved first)."""
    g = synthetic_tig("tiny")
    cfg = tm.TIGConfig(**L2)
    tr = chronological_split(g)[0]
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, 4)
    lists = shuffle_combine(part.node_lists(), 2, np.random.default_rng(0))
    ep = td.plan_epoch(tr, lists, part.shared_nodes, cfg,
                       np.random.default_rng(1), plan=plan)
    union = td.union_plan(ep, cfg)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    epoch = td._PACEpoch(cfg, opt, params, opt.init(params), union,
                         torch.device("cpu"))
    s = int(ep.n_batches.min()) - 1
    epoch.counter.fill_(s)
    with CaptureProbe():
        for _ in range(2):
            epoch.step()
    assert int(epoch.counter) == s + 2
    assert torch.isfinite(epoch.out["loss"][s:s + 2]).all()
    assert (epoch.out["loss"][s:s + 2] > 0).all()


# ------------------------------------------------------------ TIG_MXU

def test_tig_mxu_trains_on_a_graph_at_its_dims():
    """The two-layer preset (dim 128, one head, K 16) for one epoch under
    both plans on ``tiny``'s stream with 64-d edge and node features (no
    preset of ``synthetic_tig`` has them)."""
    g = synthetic_tig("tiny")
    rng = np.random.default_rng(0)
    g = dataclasses.replace(
        g, edge_feat=rng.normal(size=(g.num_edges, TIG_MXU.dim_edge))
        .astype(np.float32),
        node_feat=np.zeros((g.num_nodes, TIG_MXU.dim_node), np.float32))
    assert TIG_MXU.n_layers == 2
    params = tm.init_params(torch.Generator().manual_seed(0), TIG_MXU)
    runs = [train_single(g, TIG_MXU, epochs=1, plan=plan, params=params,
                         device="cpu") for plan in ("device", "host")]
    for res in runs:
        assert np.isfinite(res.losses).all()
        assert 0.0 < res.val_ap <= 1.0
    _close(runs[0].losses, runs[1].losses)
