"""PAC over several ranks (``repro_torch.tig.distributed`` with a
``launch.mesh.make_tig_mesh`` mesh) on the CPU, through gloo, against the
JAX package's row-range-sharded plan and its ``pac_train``.

The sharded plan (``layout="sharded"``, ``local_ranks``) must equal the
JAX package's array for array, and a rank's union of its own partitions
must equal the replicated plan's union restricted to them. A gloo world
of one (``pac_train(mesh=...)``, which plans the sharded layout) must be
bitwise ``mesh=None`` (the replicated layout) and, within
``tests/test_torch_pac.py``'s rules (1e-4 on losses, params and memories;
1e-3 on AP), JAX's sharded ``pac_train``. Two ranks of
``python -m repro_torch.launch.pac_cluster --device cpu`` (8 SEP parts on
4 partition slots, 2 a rank, 2 epochs) must agree bit for bit with each
other and within those rules with the single-process run. Every bitwise
comparison here runs on one intra-op thread: multi-threaded CPU
reductions differ from run to run.
"""

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.core import sep_partition as jax_sep_partition  # noqa: E402
from repro.tig import distributed as jd  # noqa: E402
from repro.tig import models as jm  # noqa: E402
from repro.tig.data import synthetic_tig as jax_synthetic_tig  # noqa: E402
from repro.tig.graph import chronological_split as jax_split  # noqa: E402
from repro.tig.protocol import time_scale_of as jax_time_scale  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import sep_partition  # noqa: E402
from repro_torch.launch import mesh as lm  # noqa: E402
from repro_torch.tig import distributed as td  # noqa: E402
from repro_torch.tig import models as tm  # noqa: E402
from repro_torch.tig import stream  # noqa: E402
from repro_torch.tig.data import synthetic_tig  # noqa: E402
from repro_torch.tig.graph import chronological_split  # noqa: E402
from repro_torch.tig.protocol import time_scale_of  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(flavor="tgn", dim=16, dim_time=8, dim_edge=16, dim_node=16,
             num_neighbors=4, batch_size=50)
TOL = 1e-4
CLUSTER_TIMEOUT = 300       # seconds a cluster run may take, then killed


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _case(parts=4):
    g, jg = synthetic_tig("tiny"), jax_synthetic_tig("tiny")
    tr, jtr = chronological_split(g)[0], jax_split(jg)[0]
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, parts, k=0.05)
    return g, tr, jg, jtr, part


def _plans(plan, **kw):
    """The port's and the JAX package's plans of 4 SEP parts on 4
    devices from the same draws."""
    g, tr, jg, jtr, part = _case()
    got = td.plan_epoch(tr, part.node_lists(), part.shared_nodes,
                        tm.TIGConfig(**SMALL), np.random.default_rng(0),
                        time_scale=time_scale_of(tr.t), plan=plan, **kw)
    want = jd.plan_epoch(jtr, part.node_lists(), part.shared_nodes,
                         jm.TIGConfig(**SMALL), np.random.default_rng(0),
                         time_scale=jax_time_scale(jtr.t), plan=plan, **kw)
    return got, want


@pytest.mark.parametrize("ranks", [None, [0, 1], [2, 3], [1]],
                         ids=["full", "0-1", "2-3", "1"])
@pytest.mark.parametrize("plan", ["host", "device"])
def test_sharded_plan_equals_jax(plan, ranks):
    """``plan_epoch(layout="sharded", local_ranks=ranks)`` array for
    array against JAX's; a rank's plan holds the full sharded plan's rows
    of its ranks and the same global schedule; its bytes for one device
    equal JAX's and are under the replicated layout's."""
    got, want = _plans(plan, layout="sharded", local_ranks=ranks)
    for f in ("n_batches", "nfeat_local", "efeat_local", "shared_local",
              "capacity", "edge_capacity", "steps", "edges_per_device",
              "offsets", "layout", "local_ranks"):
        _equal_trees(getattr(got, f), getattr(want, f), f)
    _equal_trees(got.batches, want.batches, "batches")
    _equal_trees(got.tcsr, want.tcsr, "tcsr")
    assert (got.tcsr is None) == (plan == "host")
    assert got.device_input_bytes() == want.device_input_bytes()
    for f in ("grid_bytes", "tcsr_bytes", "plan_bytes"):
        assert getattr(got, f)() == getattr(want, f)(), f
    full, _ = _plans(plan, layout="sharded")
    replicated, _ = _plans(plan)
    assert got.device_input_bytes() < replicated.device_input_bytes()
    assert (full.offsets == 0).all()
    rows = list(range(4)) if ranks is None else ranks
    np.testing.assert_array_equal(got.held_ranks(), rows)
    for key in full.batches:
        np.testing.assert_array_equal(got.batches[key],
                                      full.batches[key][rows])
    for key in (full.tcsr or {}):
        np.testing.assert_array_equal(got.tcsr[key], full.tcsr[key][rows])
    for f in ("n_batches", "edges_per_device", "shared_local"):
        np.testing.assert_array_equal(getattr(got, f), getattr(full, f))
    assert got.plan_bytes() == full.plan_bytes() * len(rows) // 4


@pytest.mark.parametrize("plan", ["host", "device"])
def test_union_of_sharded_plan_equals_replicated(plan):
    """The union of the full sharded plan equals the union of the
    replicated plan array for array, and the union a rank builds from
    its own ``local_ranks`` plan equals the replicated union of those
    partitions."""
    cfg = tm.TIGConfig(**SMALL)
    replicated, _ = _plans(plan)
    full, _ = _plans(plan, layout="sharded")
    _equal_trees(td.union_plan(full, cfg), td.union_plan(replicated, cfg))
    for ranks in ([0, 1], [2, 3], [1]):
        local, _ = _plans(plan, layout="sharded", local_ranks=ranks)
        u = td.union_plan(local, cfg)
        assert u["parts"] == len(ranks)
        _equal_trees(u, td.union_plan(replicated, cfg, ranks))
    with pytest.raises(ValueError, match="holds only"):
        td.union_plan(local, cfg, [0])


def _pac_kw(**kw):
    return dict(num_devices=4, epochs=2, plan="device", **kw)


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The port's single-process ``pac_train`` without a mesh (the
    replicated layout) and over a gloo world of one (the sharded one),
    and JAX's in the sharded layout (vmap, serial boundary, no prefetch),
    8 SEP parts shuffle-combined onto 4 devices, from the same params."""
    g, tr, jg, jtr, part = _case(8)
    jpart = jax_sep_partition(jtr.src, jtr.dst, jtr.t, jg.num_nodes, 8,
                              k=0.05)
    p0 = jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(0), jm.TIGConfig(**SMALL)))

    def run(**kw):
        return td.pac_train(tr, part, tm.TIGConfig(**SMALL), eval_graph=g,
                            params=convert.params_from_numpy(p0),
                            **_pac_kw(), **kw)

    runs = {"replicated": run(device="cpu")}
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        runs["sharded"] = run(mesh=lm.make_tig_mesh(4))
    finally:
        dist.destroy_process_group()
    runs["jax"] = jd.pac_train(
        jtr, jpart, jm.TIGConfig(**SMALL), grid_layout="sharded",
        mesh=None, epoch_boundary="serial", prefetch=False, eval_graph=jg,
        **_pac_kw())
    return runs


def test_sharded_pac_train_is_bitwise_replicated(sharded_runs):
    rep, shd = sharded_runs["replicated"], sharded_runs["sharded"]
    assert shd.plan.layout == "sharded" and rep.plan.layout == "replicated"
    for a, b in zip(rep.losses, shd.losses):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(rep.params), tree_leaves(shd.params)):
        assert torch.equal(a, b)
    for k in rep.memory_states:
        assert torch.equal(rep.memory_states[k], shd.memory_states[k]), k
    _equal_trees(rep.metrics, shd.metrics)
    assert shd.plan.device_input_bytes() < rep.plan.device_input_bytes()


def test_sharded_pac_train_matches_jax(sharded_runs):
    got, want = sharded_runs["sharded"], sharded_runs["jax"]
    assert len(got.losses) == len(want.losses) == 2
    for a, b in zip(got.losses, want.losses):
        assert a.shape == np.asarray(b).shape
        _close(a, b)
    tp = convert.params_to_numpy(got.params)
    jp = jax.tree.map(np.asarray, want.params)
    # the attention's key bias has a float32-noise gradient in both
    # packages (the softmax ignores it), which AdamW scales up
    del tp["attn"]["k"]["b"], jp["attn"]["k"]["b"]
    jax.tree.map(_close, tp, jp)
    for k, v in want.memory_states.items():
        _close(got.memory_states[k].numpy(), v)
    for k in ("val_ap", "test_ap", "val_ap_inductive", "test_ap_inductive"):
        np.testing.assert_allclose(got.metrics[k], want.metrics[k],
                                   atol=1e-3, err_msg=k)
    assert got.derived_speedup == want.derived_speedup


@pytest.fixture
def gloo_world_of_one(tmp_path):
    """An in-process gloo group of one rank (a file store: no socket)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield lm.make_tig_mesh(4)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("sync_mode", ["latest", "mean"])
def test_gloo_world_of_one_is_bitwise_mesh_none(gloo_world_of_one,
                                                sync_mode):
    """A world of one rank holding all 4 partition slots: the sharded
    plan, the flat-buffer all-reduce of one rank and the sync's
    collectives change no bit of ``mesh=None``'s run."""
    mesh = gloo_world_of_one
    assert (mesh.world, mesh.rank, mesh.num_parts) == (1, 0, 4)
    np.testing.assert_array_equal(lm.local_part_ranks(mesh), [0, 1, 2, 3])
    g, tr, _, _, part = _case(8)
    cfg = tm.TIGConfig(**SMALL)
    kw = _pac_kw(sync_mode=sync_mode, eval_graph=g)
    on_mesh = td.pac_train(tr, part, cfg, mesh=mesh, **kw)
    alone = td.pac_train(tr, part, cfg, device="cpu", **kw)
    assert on_mesh.plan.layout == "sharded"
    for a, b in zip(on_mesh.losses, alone.losses):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(on_mesh.params), tree_leaves(alone.params)):
        assert torch.equal(a, b)
    for k in alone.memory_states:
        assert torch.equal(on_mesh.memory_states[k],
                           alone.memory_states[k]), k
    _equal_trees(on_mesh.metrics, alone.metrics)


def test_stage_over_a_mesh(gloo_world_of_one):
    mesh = gloo_world_of_one
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = stream.stage_partitioned(rows, mesh, 4)
    assert got.device == mesh.device and torch.equal(
        got, torch.from_numpy(rows))
    with pytest.raises(ValueError, match="rows given"):
        stream.stage_partitioned(rows[:2], mesh, 4)
    with pytest.raises(ValueError, match="partition slots"):
        stream.stage_partitioned(rows, mesh, 8)
    tree = {"a": torch.ones(3), "b": {"c": torch.zeros((), dtype=torch.int32)}}
    out = td.stage_replicated_tree(tree, mesh)
    assert torch.equal(out["a"], tree["a"]) and out["a"] is not tree["a"]
    assert out["b"]["c"].dtype == torch.int32
    g, tr, _, _, part = _case(4)
    with pytest.raises(ValueError, match="partition slots"):
        td.pac_train(tr, part, tm.TIGConfig(**SMALL), num_devices=2,
                     mesh=mesh)


def test_make_tig_mesh_refuses_bad_worlds(monkeypatch):
    """No group; P not divisible by the world; an NCCL group with more
    ranks on the machine than cards (refused before any collective)."""
    with pytest.raises(ValueError, match="init_process_group"):
        lm.make_tig_mesh()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    with pytest.raises(ValueError, match="not divisible"):
        lm.make_tig_mesh(3)
    mesh = lm.make_tig_mesh(6)
    np.testing.assert_array_equal(mesh.ranks, [3, 4, 5])
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="Duplicate GPU"):
        lm.make_tig_mesh()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cluster(tmp_path, sync_mode):
    """Two ranks of the launcher on gloo, 2 partition slots each; their
    npz files. Each rank runs in its own session, killed with its group
    if the run outlives ``CLUSTER_TIMEOUT``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    port = _free_port()
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.pac_cluster",
         "--device", "cpu", "--num-processes", "2", "--process-id", str(r),
         "--coordinator", f"127.0.0.1:{port}", "--local-devices", "2",
         "--epochs", "2", "--parts", "8", "--seed", "0",
         "--sync-mode", sync_mode, "--timeout", "120", "--out",
         str(outs[r])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CLUSTER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "held [0, 1]" in logs[0] and "held [2, 3]" in logs[1]
    return [np.load(o) for o in outs]


@pytest.mark.parametrize("sync_mode", ["latest", "mean"])
def test_two_process_cluster_matches_single_process(tmp_path, sync_mode):
    rank0, rank1 = _run_cluster(tmp_path, sync_mode)
    assert sorted(rank0.files) == sorted(rank1.files)
    for key in rank0.files:
        np.testing.assert_array_equal(rank0[key], rank1[key], err_msg=key)
    g, tr, _, _, part = _case(8)
    res = td.pac_train(tr, part, tm.TIGConfig(**SMALL), num_devices=4,
                       epochs=2, seed=0, sync_mode=sync_mode, eval_graph=g,
                       device="cpu")
    want = {f"loss_{e}": x for e, x in enumerate(res.losses)}
    want.update({f"param_{i}": x.numpy()
                 for i, x in enumerate(tree_leaves(res.params))})
    want.update({f"state_{k}": res.memory_states[k].numpy()
                 for k in ("mem", "mem2", "last")})
    want.update({f"metric_{k}": np.asarray(v)
                 for k, v in res.metrics.items()})
    assert sorted(want) == sorted(rank0.files)
    for key, v in want.items():
        if key.startswith("metric_"):
            np.testing.assert_allclose(rank0[key], v, atol=1e-3,
                                       err_msg=key)
        else:
            assert rank0[key].shape == v.shape, key
            _close(rank0[key], v)
