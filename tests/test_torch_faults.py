"""PAC's fault tolerance in the port (``repro_torch.faults``, checkpoints
and ``resume``, the fault sites, the restarter bundle and the overlapped
epoch boundary of ``repro_torch.tig.distributed.pac_train``) against the
JAX package's ``repro.faults`` and ``repro.tig.distributed``, on the CPU.

The injector's cases are ``tests/test_elastic.py``'s, run against both
packages in this one process: the same specs must fire at the same calls
(a ``prob < 1`` draw seeds on ``hash(site)``, which Python salts per
process, so the two agree only within one). ``is_host_loss`` is held to
JAX's cases and to torch's own peer-loss errors. Resuming, the fault
sites, ``epochs=0`` and ``overlap == serial`` are held bitwise within
the port, on one intra-op thread (multi-threaded CPU reductions differ
run to run); a JAX checkpoint resumed in the port is held to JAX's own
resume from it within ``tests/test_torch_pac.py``'s rules (1e-4 on
losses, params and memories; 1e-3 on AP).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import faults as jf  # noqa: E402
from repro.core import sep_partition as jax_sep_partition  # noqa: E402
from repro.tig import distributed as jd  # noqa: E402
from repro.tig import models as jm  # noqa: E402
from repro.tig.data import synthetic_tig as jax_synthetic_tig  # noqa: E402
from repro.tig.graph import chronological_split as jax_split  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import faults as tf  # noqa: E402
from repro_torch.core import sep_partition  # noqa: E402
from repro_torch.launch import mesh as lm  # noqa: E402
from repro_torch.tig import distributed as td  # noqa: E402
from repro_torch.tig import models as tm  # noqa: E402
from repro_torch.tig.data import synthetic_tig  # noqa: E402
from repro_torch.tig.graph import chronological_split  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SMALL = dict(flavor="tgn", dim=16, dim_time=8, dim_edge=16, dim_node=16,
             num_neighbors=4, batch_size=50)
TOL = 1e-4
PACKAGES = {"jax": jf, "torch": tf}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_env_faults(monkeypatch):
    monkeypatch.delenv(tf.FAULTS_ENV, raising=False)
    monkeypatch.delenv("REPRO_PAC_ORIG_RANK", raising=False)


# --------------------------------------------------------- fault injector

def _outcome(fn):
    """What one call did: None, or the exception's kind and message (the
    kinds named alike in both packages)."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the outcome under test
        return type(exc).__name__, str(exc)
    return None


def _fires(spec, calls, **kw):
    """Each package's outcomes of ``calls`` ((site, ctx) pairs) on one
    injector parsed from ``spec``; they must agree."""
    out = {}
    for name, mod in PACKAGES.items():
        inj = mod.FaultInjector.parse(spec, **kw)
        out[name] = [_outcome(lambda s=s, c=c: inj.fire(s, **c))
                     for s, c in calls] + [inj.armed]
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_parse_grammar():
    text = ("host_kill@epoch=1,rank=1;staging_oom@at=2;"
            "sync_fail@prob=0.5,seed=7,action=raise")
    specs = tf.parse_faults(text)
    assert [vars(s) for s in specs] == [vars(s)
                                        for s in jf.parse_faults(text)]
    assert [s.site for s in specs] == ["host_kill", "staging_oom",
                                      "sync_fail"]
    assert specs[0].epoch == 1 and specs[0].rank == 1
    assert specs[0].resolved_action() == "kill"
    assert specs[1].at == 2
    assert specs[1].resolved_action() == "oom"
    assert specs[2].prob == 0.5 and specs[2].seed == 7
    assert tf.parse_faults("") == [] and tf.parse_faults(";") == []


@pytest.mark.parametrize("spec,match", [
    ("host_kill@bogus=1", "unknown fault spec arg"),
    ("sync_fail@action=explode", "unknown fault action")])
def test_parse_rejects_unknown_args_and_actions(spec, match):
    got = {name: _outcome(lambda m=mod: m.parse_faults(spec))
           for name, mod in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "ValueError" and match in got["torch"][1]


def test_fire_matches_epoch_and_fires_once():
    got = _fires("sync_fail@epoch=2",
                 [("sync_fail", {"epoch": e}) for e in (0, 1, 2, 2)],
                 process_index=0)
    assert got[:2] == [None, None] and got[2][0] == "InjectedFault"
    assert got[3] is None and got[4] is False   # fires at most once


def test_fire_counts_calls_per_site():
    got = _fires("staging_oom@at=3",
                 [("staging_oom", {}), ("other_site", {}),
                  ("staging_oom", {}), ("staging_oom", {})],
                 process_index=0)
    assert got[:3] == [None] * 3 and got[3][0] == "MemoryError"


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_filter(rank):
    got = _fires("prefetch_worker@epoch=0,rank=1",
                 [("prefetch_worker", {"epoch": 0})], process_index=rank)
    assert (got[0] is None) == (rank == 0)


def test_rank_comes_from_the_launcher_then_the_group(monkeypatch):
    """No ``process_index``: ``REPRO_PAC_ORIG_RANK`` (the elastic
    launcher's original rank), else the rank of an initialized
    ``torch.distributed`` group, else 0."""
    spec = "host_kill@rank=1,action=raise"
    assert tf.FaultInjector.parse(spec)._process_index() == 0
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    with pytest.raises(tf.InjectedFault):
        tf.FaultInjector.parse(spec).fire("host_kill")
    monkeypatch.setenv("REPRO_PAC_ORIG_RANK", "0")
    tf.FaultInjector.parse(spec).fire("host_kill")


def test_prob_draws_are_deterministic():
    calls = [("sync_fail", {})] * 20
    first = _fires("sync_fail@prob=0.5,seed=7", calls, process_index=0)
    assert _fires("sync_fail@prob=0.5,seed=7", calls,
                  process_index=0) == first
    assert sum(x is not None for x in first[:-1]) == 1   # fires once


def test_inert_injector_is_noop():
    inj = tf.FaultInjector.from_env(env_var="REPRO_FAULTS_UNSET_FOR_TEST")
    inj.fire("host_kill", epoch=0)
    assert not inj.armed


def _chained():
    try:
        try:
            raise OSError("Broken pipe")
        except OSError as inner:
            raise ValueError("staging failed") from inner
    except ValueError as chained:
        return chained


# JAX's cases, each classified alike by both packages
JAX_CASES = {
    "HostLossError": (lambda m: m.HostLossError("peer gone"), True),
    "gloo closed": (lambda m: RuntimeError(
        "Gloo all-reduce failed: Connection closed by peer"), True),
    "deadline": (lambda m: RuntimeError(
        "DEADLINE_EXCEEDED: heartbeat timeout"), True),
    "cause chain": (lambda m: _chained(), True),
    "shape mismatch": (lambda m: ValueError("shape mismatch for mem"),
                       False),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_is_host_loss_classification(case):
    make, want = JAX_CASES[case]
    assert tf.is_host_loss(make(tf)) is want
    assert jf.is_host_loss(make(jf)) is want


def _dist_error(text):
    cls = getattr(dist, "DistBackendError", RuntimeError)
    return cls(text)


# what torch.distributed raises when a peer is lost (the wording of torch
# 2.x's gloo transport, c10d's store and NCCL's watchdog), and two local
# errors that must stay local
TORCH_CASES = {
    "gloo pair closed": (lambda: _dist_error(
        "[/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:553] "
        "Connection closed by peer [127.0.0.1]:16554. This is typically "
        "caused by a remote worker crashing."), True),
    "gloo read error": (lambda: RuntimeError(
        "[../third_party/gloo/gloo/transport/tcp/pair.cc:598] Read error "
        "[10.0.0.2]:40021: Connection reset by peer"), True),
    "gloo recv timeout": (lambda: RuntimeError(
        "[../third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:81] "
        "Timed out waiting 300000ms for recv operation to complete"), True),
    "DistBackendError": (lambda: _dist_error(
        "NCCL communicator encountered error"), True),
    "store DistNetworkError": (lambda: getattr(
        dist, "DistNetworkError", RuntimeError)(
        "failed to recv, got 0 bytes"), True),
    "NCCL watchdog timeout": (lambda: _dist_error(
        "[Rank 0] Watchdog caught collective operation timeout: "
        "WorkNCCL(SeqNum=7, OpType=ALLREDUCE, NumelIn=1, NumelOut=1, "
        "Timeout(ms)=300000) ran for 300018 milliseconds before timing "
        "out."), True),
    "ncclRemoteError": (lambda: _dist_error(
        "NCCL error in: /pytorch/torch/csrc/distributed/c10d/"
        "ProcessGroupNCCL.cpp:3356, remote process exited or there was a "
        "network error, NCCL version 2.28.9\nncclRemoteError: A call "
        "failed possibly due to a network error or a remote process "
        "exiting prematurely."), True),
    "aborted communicator": (lambda: _dist_error(
        "NCCL communicator was aborted on rank 0."), True),
    "ncclInvalidUsage": (lambda: _dist_error(
        "NCCL error in: /pytorch/torch/csrc/distributed/c10d/"
        "ProcessGroupNCCL.cpp:3356, invalid usage (run with "
        "NCCL_DEBUG=WARN for details), NCCL version 2.28.9\n"
        "ncclInvalidUsage: This usually reflects invalid usage of NCCL "
        "library.\nLast error:\nDuplicate GPU detected : rank 1 and rank 0 "
        "both on CUDA device 1000"), False),
    "local shape error": (lambda: RuntimeError(
        "The size of tensor a (16) must match the size of tensor b (8) at "
        "non-singleton dimension 1"), False),
}


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_is_host_loss_on_torch_errors(case):
    make, want = TORCH_CASES[case]
    assert tf.is_host_loss(make()) is want
    wrapped = RuntimeError("PAC step failed")
    wrapped.__cause__ = make()
    assert tf.is_host_loss(wrapped) is want


# ------------------------------------------------------ pac_train recovery

def _pac_case(num_parts=8):
    g = synthetic_tig("tiny", seed=0)
    train_g = chronological_split(g)[0]
    part = sep_partition(train_g.src, train_g.dst, train_g.t, g.num_nodes,
                         num_parts, k=0.05)
    return g, train_g, part


def _kw(**kw):
    return dict(num_devices=4, seed=0, shuffle_parts=True, plan="device",
                device="cpu", **kw)


def _same(a, b, metrics=False):
    """Two ``pac_train`` results equal bit for bit."""
    assert len(a.losses) == len(b.losses)
    for x, y in zip(a.losses, b.losses):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert a.memory_states.keys() == b.memory_states.keys()
    for k in a.memory_states:
        assert torch.equal(a.memory_states[k], b.memory_states[k]), k
    if metrics:
        assert a.metrics.keys() == b.metrics.keys()
        for k, x in a.metrics.items():
            y = b.metrics[k]
            assert x == y or (np.isnan(x) and np.isnan(y)), k


def test_pac_resume_is_bit_identical(tmp_path):
    """Kill-and-resume parity: 2 epochs + checkpoint, then resume to 3
    epochs == an undisturbed 3-epoch run, bit for bit (params, memory,
    and the resumed epoch's losses); the resumed AdamW step keeps its
    dtype."""
    _g, train_g, part = _pac_case()
    d = str(tmp_path / "ckpt")
    full = td.pac_train(train_g, part, tm.TIGConfig(**SMALL), epochs=3,
                        **_kw())
    td.pac_train(train_g, part, tm.TIGConfig(**SMALL), epochs=2,
                 ckpt_dir=d, ckpt_every=1, **_kw())
    assert sorted(os.listdir(d)) == [f"ckpt_0000000{s}.{x}" for s in (0, 1)
                                     for x in ("json", "npz")]
    with np.load(os.path.join(d, "ckpt_00000001.npz")) as data:
        assert data["opt_state|step"].dtype == np.int32
        assert data["states|mem"].shape[0] == 4
    res = td.pac_train(train_g, part, tm.TIGConfig(**SMALL), epochs=3,
                       ckpt_dir=d, resume=True, **_kw())
    assert len(res.losses) == 1 and len(res.epoch_seconds) == 1
    np.testing.assert_array_equal(full.losses[2], res.losses[0])
    full.losses = full.losses[2:]
    _same(full, res)


def test_pac_train_epoch_zero_kill_leaves_resumable_ckpt(tmp_path, capsys):
    """A staging fault after the first checkpoints leaves a directory the
    next ``pac_train`` resumes from; resuming past the last epoch trains
    nothing (``losses == []``) and returns the restored params."""
    _g, train_g, part = _pac_case()
    d = str(tmp_path / "ckpt")
    cfg = tm.TIGConfig(**SMALL)
    full = td.pac_train(train_g, part, cfg, epochs=2, **_kw())
    # staging call 3 = epoch 2's plan (epochs 0 / 1 are calls 1 / 2), so
    # the crash lands after epoch 1's checkpoint is on disk
    with pytest.raises(MemoryError):
        td.pac_train(train_g, part, cfg, epochs=3, ckpt_dir=d,
                     ckpt_every=1, faults=tf.FaultInjector.parse(
                         "staging_oom@at=3", process_index=0), **_kw())
    capsys.readouterr()
    res = td.pac_train(train_g, part, cfg, epochs=2, ckpt_dir=d,
                       resume=True, **_kw())
    assert capsys.readouterr().out == (
        f"PAC_RESUME: step 1 restored from {d}, continuing at epoch 2\n")
    assert res.losses == [] and res.epoch_seconds == []
    for x, y in zip(tree_leaves(full.params), tree_leaves(res.params)):
        assert torch.equal(x, y)


def test_nothing_trained_matches_jax():
    """``epochs=0``: JAX's nothing-trained result, the plan of epoch 0 and
    fresh stacked memories."""
    g, train_g, part = _pac_case()
    jg = jax_synthetic_tig("tiny", seed=0)
    jtr = jax_split(jg)[0]
    jpart = jax_sep_partition(jtr.src, jtr.dst, jtr.t, jg.num_nodes, 8,
                              k=0.05)
    got = td.pac_train(train_g, part, tm.TIGConfig(**SMALL), epochs=0,
                       **_kw())
    want = jd.pac_train(jtr, jpart, jm.TIGConfig(**SMALL), num_devices=4,
                        epochs=0, seed=0, plan="device")
    assert got.losses == want.losses == []
    assert got.memory_states.keys() == set(want.memory_states)
    for k, v in want.memory_states.items():
        x = got.memory_states[k].numpy()
        assert x.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(x, v, err_msg=k)
    np.testing.assert_array_equal(got.edges_per_device,
                                  want.edges_per_device)
    assert got.derived_speedup == want.derived_speedup


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's ``pac_train(epochs=2, ckpt_every=1)`` writes the checkpoints;
    the port and JAX each resume from step 1 to epoch 3 and score the
    result: losses, params and memories within 1e-4, AP within 1e-3."""
    d = str(tmp_path / "ckpt")
    g, train_g, part = _pac_case()
    jg = jax_synthetic_tig("tiny", seed=0)
    jtr = jax_split(jg)[0]
    jpart = jax_sep_partition(jtr.src, jtr.dst, jtr.t, jg.num_nodes, 8,
                              k=0.05)
    jkw = dict(num_devices=4, seed=0, plan="device")
    jd.pac_train(jtr, jpart, jm.TIGConfig(**SMALL), epochs=2, ckpt_dir=d,
                 ckpt_every=1, **jkw)
    want = jd.pac_train(jtr, jpart, jm.TIGConfig(**SMALL), epochs=3,
                        ckpt_dir=d, resume=True, eval_graph=jg, **jkw)
    got = td.pac_train(train_g, part, tm.TIGConfig(**SMALL), epochs=3,
                       ckpt_dir=d, resume=True, eval_graph=g, **_kw())
    assert len(got.losses) == len(want.losses) == 1
    np.testing.assert_allclose(got.losses[0], np.asarray(want.losses[0]),
                               rtol=TOL, atol=TOL)
    tp = convert.params_to_numpy(got.params)
    jp = jax.tree.map(np.asarray, want.params)
    # the attention's key bias has a float32-noise gradient in both
    # packages (the softmax ignores it), which AdamW scales up
    del tp["attn"]["k"]["b"], jp["attn"]["k"]["b"]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=TOL, atol=TOL), tp, jp)
    for k, v in want.memory_states.items():
        np.testing.assert_allclose(got.memory_states[k].numpy(), v,
                                   rtol=TOL, atol=TOL, err_msg=k)
    for k in ("val_ap", "test_ap", "val_ap_inductive", "test_ap_inductive"):
        np.testing.assert_allclose(got.metrics[k], want.metrics[k],
                                   atol=1e-3, err_msg=k)


@pytest.mark.parametrize("spec,exc", [
    ("prefetch_worker@epoch=1", "InjectedFault"),
    ("staging_oom@at=2", "MemoryError"),
    ("sync_fail@epoch=1", "InjectedFault"),
    ("host_kill@epoch=1,action=raise", "InjectedFault")])
def test_pac_train_fault_sites(tmp_path, spec, exc):
    """Each site fails the run where JAX's does: at epoch 1 (the 2nd
    staging call), after epoch 0's checkpoint and before epoch 1's."""
    _g, train_g, part = _pac_case()
    d = str(tmp_path / "ckpt")
    with pytest.raises((tf.InjectedFault, MemoryError)) as info:
        td.pac_train(train_g, part, tm.TIGConfig(**SMALL), epochs=2,
                     ckpt_dir=d, ckpt_every=1,
                     faults=tf.FaultInjector.parse(spec, process_index=0),
                     **_kw())
    assert type(info.value).__name__ == exc
    if exc == "InjectedFault":
        assert info.value.ctx["epoch"] == 1
    assert sorted(os.listdir(d)) == ["ckpt_00000000.json",
                                     "ckpt_00000000.npz"]


def test_pac_train_faults_come_from_the_environment(monkeypatch):
    _g, train_g, part = _pac_case()
    monkeypatch.setenv(tf.FAULTS_ENV, "sync_fail@epoch=0")
    with pytest.raises(tf.InjectedFault, match="sync_fail"):
        td.pac_train(train_g, part, tm.TIGConfig(**SMALL), epochs=1,
                     **_kw())


def test_pac_eval_warm_restart_saves_restarter(tmp_path):
    """``eval_warm="restart"`` scores the protocol through the restarter
    and saves the fitted head beside the checkpoints, a bundle that
    loads in both packages."""
    from repro.tig.restart import load_restarter as jax_load_restarter
    from repro_torch.tig.restart import load_restarter

    g, train_g, part = _pac_case()
    d = str(tmp_path / "ckpt")
    res = td.pac_train(train_g, part, tm.TIGConfig(**SMALL), epochs=2,
                       eval_graph=g, eval_warm="restart", ckpt_dir=d,
                       ckpt_every=1, **_kw())
    assert res.metrics is not None and 0.4 < res.metrics["val_ap"] <= 1.0
    path = os.path.join(d, "restarter.npz")
    assert os.path.isfile(path)
    assert os.path.isfile(os.path.join(d, "ckpt_00000001.npz"))
    mine = load_restarter(path, tm.TIGConfig(**SMALL), device="cpu")
    theirs = jax_load_restarter(path, jm.TIGConfig(**SMALL))
    assert np.isfinite(mine.fit_mse) and mine.fit_mse == theirs.fit_mse
    np.testing.assert_array_equal(mine.bank.emb, theirs.bank.emb)


# ------------------------------------------------- the overlapped boundary

@pytest.mark.parametrize("plan", ["device", "host"])
def test_pac_overlap_matches_serial(plan):
    """The overlapped boundary (deferred loss reads) == the serial oracle,
    bit for bit, for both plans."""
    _g, train_g, part = _pac_case()
    kw = _kw(epochs=2)
    kw["plan"] = plan
    ser = td.pac_train(train_g, part, tm.TIGConfig(**SMALL),
                       epoch_boundary="serial", **kw)
    ovl = td.pac_train(train_g, part, tm.TIGConfig(**SMALL),
                       epoch_boundary="overlap", **kw)
    _same(ser, ovl)
    for res in (ser, ovl):
        assert len(res.epoch_seconds) == len(res.plan_seconds) == 2
        assert all(e >= p >= 0 for e, p in zip(res.epoch_seconds,
                                               res.plan_seconds))


def test_pac_depth_and_prefetch_off_match():
    """depth 1 and 3 under the overlapped boundary and the fully serial
    loop (``prefetch=False``) give the same results, metrics included."""
    g, train_g, part = _pac_case()
    kw = _kw(epochs=2, eval_graph=g)
    base = td.pac_train(train_g, part, tm.TIGConfig(**SMALL),
                        epoch_boundary="serial", prefetch=False, **kw)
    for depth in (1, 3):
        _same(base, td.pac_train(train_g, part, tm.TIGConfig(**SMALL),
                                 epoch_boundary="overlap", depth=depth,
                                 **kw), metrics=True)


def test_overlap_over_a_gloo_world_of_one(tmp_path):
    """Over a gloo world of one (the boundary's collectives on their own
    group): overlap == serial == ``mesh=None``, bit for bit."""
    g, train_g, part = _pac_case()
    kw = _kw(epochs=2, eval_graph=g)
    alone = td.pac_train(train_g, part, tm.TIGConfig(**SMALL), **kw)
    del kw["device"]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = lm.make_tig_mesh(4)
        runs = [td.pac_train(train_g, part, tm.TIGConfig(**SMALL),
                             mesh=mesh, epoch_boundary=b, **kw)
                for b in ("overlap", "serial")]
        assert mesh.boundary is not None
        assert mesh.boundary is not mesh.group is dist.group.WORLD
    finally:
        dist.destroy_process_group()
    for res in runs:
        _same(res, alone, metrics=True)
