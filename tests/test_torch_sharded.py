"""The port's out-of-core path against the JAX package's, on the CPU at
small widths: the protocol's split of a ``ShardedStream``, scoring with
collected embeddings, the node-classification head, ``train_sharded``,
and PAC from shards.

The stream is ``synthetic_tig("tiny")`` labelled with the parity of each
edge's source (a state the embeddings tell apart; the preset's rare
flips leave the test split a label or two, and a head fit to random
labels turns float32 noise into AUROC), written as shards of 333 rows,
not a multiple of the batch of 50. As in
``tests/test_torch_train.py``: losses agree with JAX to 1e-4, AP to 1e-3,
embeddings to 1e-4; the head from the same initial params (converted
from JAX's ``mlp_init``) gives AUROC within 1e-4 of JAX's on the same
embeddings, and within 1e-3 at the end of a run (its embeddings carry
the run's float32 differences). Within the port on the CPU, shards
against the in-memory graph and prefetching on against off are bitwise
equal (on one intra-op thread).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.tig import distributed as jd  # noqa: E402
from repro.tig import models as jm  # noqa: E402
from repro.tig import stream as js  # noqa: E402
from repro.tig.modules import mlp_init as jax_mlp_init  # noqa: E402
from repro.tig.protocol import split_views as jax_split_views  # noqa: E402
from repro.tig.protocol import (  # noqa: E402
    train_classifier_head as jax_head)
from repro.tig.train import train_sharded as jax_train_sharded  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import sep_partition  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint  # noqa
from repro_torch.tig import distributed as td  # noqa: E402
from repro_torch.tig import models as tm  # noqa: E402
from repro_torch.tig.batching import (build_batch_program,  # noqa: E402
                                      make_tables)
from repro_torch.tig.engine import scan_eval_stream  # noqa: E402
from repro_torch.tig.data import synthetic_tig  # noqa: E402
from repro_torch.tig.graph import chronological_split  # noqa: E402
from repro_torch.tig.protocol import (inductive_node_mask,  # noqa: E402
                                      score_stream, split_views,
                                      train_classifier_head)
from repro_torch.tig.stream import ShardedStream, write_graph_shards  # noqa
from repro_torch.tig.train import (epoch_rng, train_sharded,  # noqa: E402
                                   train_single)

SMALL = dict(flavor="tgn", dim=16, dim_time=8, dim_edge=16, dim_node=16,
             num_neighbors=4, n_heads=2, batch_size=50)
SHARD = 333
TOL = 1e-4
AP_KEYS = ("train_ap", "val_ap", "test_ap", "val_ap_inductive",
           "test_ap_inductive")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: PyTorch's multi-threaded CPU reductions are not
    bitwise reproducible from run to run, and the port's checks here are
    bitwise (on the card the kernels are)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph():
    g = synthetic_tig("tiny")
    g.labels = (g.src % 2).astype(np.int64)
    return g


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    g = _graph()
    path = str(tmp_path_factory.mktemp("tiny_shards"))
    write_graph_shards(g, path, shard_edges=SHARD)
    return g, ShardedStream.open(path)


def _p0():
    cfg = jm.TIGConfig(**SMALL)
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                   cfg))


def _head0(d, n_classes=2):
    """JAX's head init, as its ``train_classifier_head`` draws it."""
    return jax.tree.map(np.asarray, jax_mlp_init(jax.random.PRNGKey(0),
                                                 [d, 64, n_classes]))


def _run_port(sh, **kw):
    return train_sharded(sh, tm.TIGConfig(**SMALL), device="cpu",
                         params=convert.params_from_numpy(_p0()), **kw)


@pytest.fixture(scope="module")
def sharded_runs(shards):
    """JAX's and the port's ``train_sharded`` on the same shards, the
    protocol with node classification, from the same params and head."""
    g, sh = shards
    kw = dict(epochs=2, protocol=True, eval_node_class=True)
    want = jax_train_sharded(js.ShardedStream.open(sh.path),
                             jm.TIGConfig(**SMALL), prefetch=False, **kw)
    got = _run_port(sh, head_params=convert.params_from_numpy(
        _head0(SMALL["dim"])), **kw)
    return got, want


# ----------------------------------------------------------- the protocol

def test_split_views_of_shards_equal_the_graphs(shards):
    g, sh = shards
    a, b = split_views(sh), split_views(g)
    j = jax_split_views(js.ShardedStream.open(sh.path))
    for sp in (b, j):
        for va, vb in zip(a.views, sp.views):
            for f in ("src", "dst", "t", "eidx", "labels"):
                np.testing.assert_array_equal(getattr(va, f),
                                              getattr(vb, f), err_msg=f)
        for f in ("inductive", "neg_pool"):
            np.testing.assert_array_equal(getattr(a, f), getattr(sp, f))
        assert a.bounds == sp.bounds and a.time_scale == sp.time_scale
        assert a.num_nodes == sp.num_nodes and a.name == sp.name
    with pytest.raises(TypeError, match="ShardedStream or TemporalGraph"):
        split_views(object())


@pytest.mark.parametrize("chunk", [1, 7, 1 << 20])
def test_inductive_node_mask_in_chunks(chunk):
    g = _graph()
    seen = np.zeros(g.num_nodes, bool)
    seen[g.src[:500]] = seen[g.dst[:500]] = True
    got = inductive_node_mask(g.src[:500], g.dst[:500], g.num_nodes,
                              chunk_edges=chunk)
    np.testing.assert_array_equal(got, ~seen)


def test_train_sharded_matches_jax(sharded_runs):
    got, want = sharded_runs
    np.testing.assert_allclose(got.losses, want.losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.val_curve, want.val_curve, atol=1e-3)
    assert got.best_epoch == want.best_epoch
    for k in AP_KEYS:
        np.testing.assert_allclose(got.metrics[k], want.metrics[k],
                                   atol=1e-3, err_msg=k)
    assert np.isfinite(want.metrics["node_auroc"])
    np.testing.assert_allclose(got.metrics["node_auroc"],
                               want.metrics["node_auroc"], atol=1e-3)
    assert set(got.setup_seconds) == {"index", "stage"}


def test_score_stream_collects_jaxs_embeddings(shards, sharded_runs):
    """The test split scored with collected embeddings, from the same
    params and a fresh memory, in both packages (JAX's program is the one
    its ``run_protocol`` compiled)."""
    from repro.tig.engine import make_eval_epoch as jax_eval_epoch
    from repro.tig.protocol import score_stream as jax_score

    g, sh = shards
    _, want_run = sharded_runs
    cfg_t, cfg_j = tm.TIGConfig(**SMALL), jm.TIGConfig(**SMALL)
    view = split_views(sh).test
    prog, _ = build_batch_program(view, cfg_t, epoch_rng(0, 0, 3),
                                  neg_pool=split_views(sh).neg_pool)
    jp = jax.tree.map(np.asarray, want_run.params)
    tables = {k: torch.from_numpy(v) for k, v in
              make_tables(g.edge_feat, g.node_feat).items()}
    got = score_stream(convert.params_from_numpy(jp), cfg_t,
                       tm.init_state(cfg_t, g.num_nodes), prog, tables,
                       collect_embeddings=True, device="cpu")
    want = jax_score(want_run.params, cfg_j, jm.init_state(cfg_j,
                                                           g.num_nodes),
                     prog, {k: np.asarray(v) for k, v in tables.items()},
                     jax_eval_epoch(cfg_j, collect_embeddings=True),
                     collect_embeddings=True)
    assert got["embeddings"].shape == (int(prog["valid"].sum()),
                                       SMALL["dim"])
    np.testing.assert_allclose(got["embeddings"], want["embeddings"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["ap"], want["ap"], atol=1e-3)
    with pytest.raises(ValueError, match="collect_embeddings"):
        score_stream(convert.params_from_numpy(jp), cfg_t,
                     tm.init_state(cfg_t, g.num_nodes), prog, tables,
                     functools.partial(scan_eval_stream, cfg=cfg_t,
                                       device="cpu"),
                     collect_embeddings=True)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_classifier_head_matches_jax(n_classes):
    rng = np.random.default_rng(n_classes)
    emb = rng.normal(size=(400, 16)).astype(np.float32)
    labels = (emb[:, :n_classes].argmax(1) + (rng.uniform(size=400) < 0.2)
              ) % n_classes
    labels[::17] = -1                        # unlabeled rows are dropped
    want = jax_head(emb, labels, n_classes)
    got = train_classifier_head(
        emb, labels, n_classes, device="cpu",
        params=convert.params_from_numpy(_head0(16, n_classes)))
    assert 0.5 < want <= 1.0
    assert abs(got - want) <= 1e-4
    # too few rows or one class: NaN, as JAX's
    assert np.isnan(train_classifier_head(emb[:5], labels[:5], 2,
                                          device="cpu"))


# ------------------------------------------------- within the port, exact

@pytest.fixture(scope="module")
def port_runs(shards):
    g, sh = shards
    kw = dict(epochs=2, protocol=True, eval_node_class=True)
    return {"serial": _run_port(sh, prefetch=False, **kw),
            "depth 1": _run_port(sh, **kw),
            "depth 2": _run_port(sh, depth=2, **kw)}


@pytest.mark.parametrize("run", ["depth 1", "depth 2"])
def test_prefetch_is_bitwise_serial(port_runs, run):
    got, want = port_runs[run], port_runs["serial"]
    assert got.losses == want.losses
    assert got.val_curve == want.val_curve
    assert got.metrics.keys() == want.metrics.keys()
    for k, v in want.metrics.items():
        assert got.metrics[k] == v or (np.isnan(v) and np.isnan(
            got.metrics[k])), k
    for a, b in zip(_leaves(got.params), _leaves(want.params)):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_train_sharded_losses_are_train_singles(shards, port_runs):
    """Shards and the in-memory graph give the same plans, T-CSR and
    table bytes, so the same losses bit for bit; the restored best params
    score as ``evaluate_params`` scores them."""
    from repro_torch.tig.train import evaluate_params

    g, sh = shards
    cfg = tm.TIGConfig(**SMALL)
    got = port_runs["serial"]
    single = train_single(g, cfg, epochs=2, device="cpu",
                          params=convert.params_from_numpy(_p0()))
    assert got.losses == single.losses
    m = evaluate_params(g, cfg, got.params, device="cpu")
    for k in AP_KEYS:
        assert m[k] == got.metrics[k], k


def test_train_sharded_without_protocol_and_with_checkpoints(shards,
                                                             tmp_path):
    _, sh = shards
    res = _run_port(sh, epochs=2, ckpt_dir=str(tmp_path), ckpt_every=1,
                    plan="host")
    assert res.metrics is None and res.val_curve == []
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert latest_step(str(tmp_path)) == 1
    back = restore_checkpoint(str(tmp_path), 1, {"params": res.params})
    for a, b in zip(_leaves(back["params"]), _leaves(res.params)):
        assert torch.equal(a, b)
    dev = _run_port(sh, epochs=2)
    assert dev.losses == res.losses            # host and device plans
    with pytest.raises(ValueError, match="plan="):
        _run_port(sh, plan="mesh")


def test_train_single_node_classification_and_checkpoints(tmp_path):
    g = _graph()
    cfg = tm.TIGConfig(**SMALL)
    p0 = convert.params_from_numpy(_p0())
    res = train_single(g, cfg, epochs=2, eval_node_class=True, device="cpu",
                       params=p0, ckpt_dir=str(tmp_path), ckpt_every=2)
    plain = train_single(g, cfg, epochs=2, device="cpu", params=p0,
                         prefetch=False)
    assert res.losses == plain.losses and res.val_ap == plain.val_ap
    assert np.isnan(plain.node_auroc) and 0.0 <= res.node_auroc <= 1.0
    assert latest_step(str(tmp_path)) == 1


# ------------------------------------------------------------ PAC, shards

def _pac(g, tr, sh_train, sh_full, plan, **kw):
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, 2, k=0.05)
    return td.pac_train(sh_train if sh_train is not None else tr, part,
                        tm.TIGConfig(**SMALL), num_devices=2, epochs=2,
                        plan=plan, device="cpu",
                        eval_graph=sh_full if sh_full is not None else g,
                        params=convert.params_from_numpy(_p0()), **kw)


@pytest.mark.parametrize("plan", ["host", "device"])
def test_plan_epoch_from_shards_equals_in_memory_and_jax(shards, tmp_path,
                                                         plan):
    g, _ = shards
    tr = chronological_split(g)[0]
    path = str(tmp_path / "train")
    write_graph_shards(tr, path, shard_edges=SHARD)
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, 2, k=0.05)
    cfg_t, cfg_j = tm.TIGConfig(**SMALL), jm.TIGConfig(**SMALL)
    lists = part.node_lists()
    plans = [
        td.plan_epoch(ShardedStream.open(path), lists, part.shared_nodes,
                      cfg_t, epoch_rng(0, 0, 11), plan=plan),
        td.plan_epoch(tr, lists, part.shared_nodes, cfg_t,
                      epoch_rng(0, 0, 11), plan=plan),
        jd.plan_epoch(js.ShardedStream.open(path), lists, part.shared_nodes,
                      cfg_j, epoch_rng(0, 0, 11), plan=plan)]
    got = plans[0]
    for want in plans[1:]:
        for f in ("n_batches", "nfeat_local", "efeat_local", "shared_local",
                  "steps", "edges_per_device", "offsets"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        for tree_t, tree_j in ((got.batches, want.batches),
                               (got.tcsr or {}, want.tcsr or {})):
            assert tree_t.keys() == tree_j.keys()
            for k in tree_t:
                assert tree_t[k].dtype == tree_j[k].dtype, k
                np.testing.assert_array_equal(tree_t[k], tree_j[k],
                                              err_msg=k)


def test_pac_train_from_shards_is_in_memory_pac(shards, tmp_path):
    """``pac_train`` on the train split as shards, scored on the full
    stream as shards, equals the in-memory run bit for bit (prefetch on
    against off too); with node classification it reports an AUROC."""
    g, sh = shards
    tr = chronological_split(g)[0]
    sh_tr = write_graph_shards(tr, str(tmp_path / "train"),
                               shard_edges=SHARD)
    mem = _pac(g, tr, None, None, "device", prefetch=False)
    got = _pac(g, tr, sh_tr, sh, "device", eval_node_class=True, depth=2)
    for a, b in zip(got.losses, mem.losses):
        np.testing.assert_array_equal(a, b)
    for k in ("mem", "last"):
        assert torch.equal(got.memory_states[k], mem.memory_states[k])
    for k in AP_KEYS[1:]:
        assert got.metrics[k] == mem.metrics[k], k
    assert np.isnan(mem.metrics["node_auroc"])
    assert 0.0 <= got.metrics["node_auroc"] <= 1.0
