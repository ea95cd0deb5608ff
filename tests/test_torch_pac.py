"""PAC on one card (``repro_torch.tig.distributed``) against the JAX
package's ``repro.tig.distributed``, on the CPU at small widths.

Plans are numpy in both packages and must be equal array for array. The
union of the partitions (``union_plan``) must map back to each device's
plan, and its T-CSR must sample each union row as the device's own
export samples the local node. ``pac_train`` is held against the JAX
package's vmap executor (``mesh=None``, serial boundary, no prefetch):
2 SEP parts on 2 devices, and 4 SEP parts shuffle-combined onto 2, two
epochs each, both plans and both sync modes across the cases. As in
``tests/test_torch_train.py``: losses (P, steps), params and the
post-sync memories to 1e-4 (float32 sums in another order, which AdamW's
division by the root of the second moment magnifies), val / test AP to
1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import sep_partition as jax_sep_partition  # noqa: E402
from repro.tig import distributed as jd  # noqa: E402
from repro.tig import models as jm  # noqa: E402
from repro.tig.data import synthetic_tig as jax_synthetic_tig  # noqa: E402
from repro.tig.graph import chronological_split as jax_split  # noqa: E402
from repro.tig.protocol import time_scale_of as jax_time_scale  # noqa: E402
from repro.tig.train import evaluate_params as jax_evaluate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import sep_partition, shuffle_combine  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tig import distributed as td  # noqa: E402
from repro_torch.tig import models as tm  # noqa: E402
from repro_torch.tig.data import synthetic_tig  # noqa: E402
from repro_torch.tig.engine import sample_batch_neighbors  # noqa: E402
from repro_torch.tig.graph import chronological_split  # noqa: E402
from repro_torch.tig.protocol import time_scale_of  # noqa: E402
from repro_torch.tig.train import epoch_rng, evaluate_params  # noqa: E402

SMALL = dict(flavor="tgn", dim=16, dim_time=8, dim_edge=16, dim_node=16,
             num_neighbors=4, n_heads=2, batch_size=50)
TOL = 1e-4
# (SEP parts, plan, sync mode, eval warm-up) on 2 devices, two epochs
CASES = {
    "2 parts, device plan, latest": (2, "device", "latest", "memory"),
    "2 parts, host plan, mean": (2, "host", "mean", "memory"),
    "4 parts shuffled, device plan, mean": (4, "device", "mean", "memory"),
    "4 parts shuffled, host plan, latest, replay":
        (4, "host", "latest", "replay"),
}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _graphs():
    g, jg = synthetic_tig("tiny"), jax_synthetic_tig("tiny")
    return g, chronological_split(g)[0], jg, jax_split(jg)[0]


def _node_lists(part, ep, n_dev=2, seed=0):
    """The epoch's super-partitions, as ``pac_train`` draws them."""
    small = part.node_lists()
    rng = epoch_rng(seed, ep, 11)
    if len(small) > n_dev:
        return shuffle_combine(small, n_dev, rng), rng
    return small, rng


def _plans(parts, plan, ep=1):
    """The port's and the JAX package's epoch plans from the same draws."""
    g, tr, jg, jtr = _graphs()
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, parts, k=0.05)
    lists, rng = _node_lists(part, ep)
    _, jrng = _node_lists(part, ep)
    cfg_t, cfg_j = tm.TIGConfig(**SMALL), jm.TIGConfig(**SMALL)
    got = td.plan_epoch(tr, lists, part.shared_nodes, cfg_t, rng,
                        time_scale=time_scale_of(tr.t), plan=plan)
    want = jd.plan_epoch(jtr, lists, part.shared_nodes, cfg_j, jrng,
                         time_scale=jax_time_scale(jtr.t), plan=plan)
    return got, want, cfg_t


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("plan", ["host", "device"])
def test_plan_epoch_equals_jax(plan, parts):
    got, want, _ = _plans(parts, plan)
    for f in ("n_batches", "nfeat_local", "efeat_local", "shared_local",
              "capacity", "edge_capacity", "steps", "edges_per_device",
              "offsets"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(got.node_lists, want.node_lists):
        np.testing.assert_array_equal(a, b)
    for name, tree_t, tree_j in (("batches", got.batches, want.batches),
                                 ("tcsr", got.tcsr or {}, want.tcsr or {})):
        assert tree_t.keys() == tree_j.keys(), name
        for k in tree_t:
            assert tree_t[k].dtype == tree_j[k].dtype, (name, k)
            np.testing.assert_array_equal(tree_t[k], tree_j[k],
                                          err_msg=f"{name}.{k}")
    assert (got.tcsr is None) == (plan == "host")
    assert got.plan_bytes() > 0


@pytest.mark.parametrize("plan", ["host", "device"])
def test_union_plan_maps_back_to_each_device(plan):
    """Union ids less their device's offset are the device's local ids,
    the restacked tables hold each device's rows, and the union T-CSR
    samples every union row at every batch index as the device's own
    export samples its local node: so no device's front pad is ever
    returned as a neighbor (the last node of each device included)."""
    ep, _, cfg = _plans(4, plan)
    u = td.union_plan(ep, cfg)
    p, cap, e_cap = len(ep.n_batches), ep.capacity, ep.edge_capacity
    assert (u["parts"], u["capacity"], u["edge_capacity"]) == (p, cap, e_cap)
    for k in range(p):
        rows = slice(ep.offsets[k], ep.offsets[k] + ep.n_batches[k])
        for key, v in u["batches"].items():
            local, stride = ep.batches[key][rows], (
                cap if key in td._NODE_KEYS else
                e_cap if key in td._EDGE_KEYS else 0)
            back = np.where(v[rows] >= 0, v[rows] - k * stride, v[rows]) \
                if stride else v[rows]
            np.testing.assert_array_equal(back, local, err_msg=key)
        np.testing.assert_array_equal(
            u["nfeat"][k * cap:(k + 1) * cap], ep.nfeat_local[k, :cap])
        np.testing.assert_array_equal(
            u["efeat"][k * e_cap:(k + 1) * e_cap], ep.efeat_local[k, :e_cap])
    assert not u["nfeat"][-1].any() and not u["efeat"][-1].any()
    assert u["nfeat"].shape[0] == p * cap + 1
    if plan == "host":
        assert u["tcsr"] is None
        return
    tc = {k: torch.from_numpy(v) for k, v in u["tcsr"].items()}
    assert tc["indptr"].shape == (p * cap + 2,)
    assert tc["indptr"][-1] == tc["indptr"][-2] == len(tc["nbr"])
    k_n = cfg.num_neighbors
    for k in range(p):
        lo, hi = ep.tcsr["indptr"][k, 0], ep.tcsr["indptr"][k, cap]
        own = {key: torch.from_numpy(np.concatenate([
            np.zeros(k_n, v.dtype), v[lo:hi]])) for key, v in
            ep.tcsr.items() if key != "indptr"}
        own["indptr"] = torch.from_numpy(
            ep.tcsr["indptr"][k] - lo + k_n)
        nodes = torch.arange(cap, dtype=torch.int32)
        for b in range(int(ep.n_batches[k]) + 1):
            nb, nt, ne = ref.sample_ref(*(own[x] for x in (
                "indptr", "nbr", "t", "eidx", "bat")), nodes, b, k_n)
            ub, ut, ue = ref.sample_ref(*(tc[x] for x in (
                "indptr", "nbr", "t", "eidx", "bat")), nodes + k * cap, b,
                k_n)
            assert torch.equal(ub, torch.where(nb >= 0, nb + k * cap, -1))
            assert torch.equal(ue, torch.where(ne >= 0, ne + k * e_cap, -1))
            assert torch.equal(ut, nt)
        # the device's last node reads events, not the next device's pad
        assert (ub[-1] >= 0).sum() == min(
            k_n, int(ep.tcsr["indptr"][k, cap] -
                     ep.tcsr["indptr"][k, cap - 1]))


def test_naive_union_tcsr_returns_a_pad_entry():
    """Control: the devices' offset ``indptr`` rows concatenated over the
    plan's own event arrays (pads kept) end each device's last node at
    the next device's first node, across that device's pad."""
    ep, _, cfg = _plans(4, "device")
    cap, k_n = ep.capacity, cfg.num_neighbors
    k = next(k for k in range(len(ep.n_batches) - 1)
             if ep.tcsr["indptr"][k, cap] > ep.tcsr["indptr"][k, cap - 1])
    naive = np.concatenate([ep.tcsr["indptr"][j, :cap]
                            for j in range(len(ep.n_batches))])
    tc = {x: torch.from_numpy(ep.tcsr[x]) for x in ("nbr", "t", "eidx",
                                                     "bat")}
    node = torch.tensor([k * cap + cap - 1], dtype=torch.int32)
    nb, _, _ = ref.sample_ref(torch.from_numpy(naive), tc["nbr"], tc["t"],
                              tc["eidx"], tc["bat"], node, 10**6, k_n)
    assert (nb[0, -1] == 0) and (tc["bat"][naive[node + 1] - 1] == 0)


def test_unstack_states_layout():
    """The union's pending rows (every device's src rows, then every
    device's dst rows) go back to each device's (2B,) rows in local ids,
    and the memory rows to (P, cap + 1, d)."""
    p, cap, b, d = 3, 5, 2, 4
    cfg = tm.TIGConfig(**{**SMALL, "dim": d, "batch_size": p * b})
    gen = torch.Generator().manual_seed(0)
    state = tm.init_state(cfg, p * cap)
    state["mem"] = torch.randn((p * cap + 1, d), generator=gen)
    state["mem"][-1] = 0.0
    ids = torch.arange(2 * p * b, dtype=torch.int32) % (p * cap)
    ids[3] = p * cap
    state["pend_ids"] = ids
    state["pend_t"] = torch.arange(2 * p * b, dtype=torch.float32)
    out = td.unstack_states(state, p, cap, b)
    assert out["mem"].shape == (p, cap + 1, d)
    for k in range(p):
        assert torch.equal(out["mem"][k, :cap],
                           state["mem"][k * cap:(k + 1) * cap])
        assert not out["mem"][k, cap].any()
        src = list(range(k * b, (k + 1) * b))
        dst = [p * b + r for r in src]
        assert torch.equal(out["pend_t"][k], state["pend_t"][src + dst])
        want = state["pend_ids"][src + dst]
        want = torch.where(want < p * cap, want - k * cap, cap)
        assert torch.equal(out["pend_ids"][k], want.to(torch.int32))


@pytest.fixture(scope="module")
def pac_runs():
    """JAX's and the port's ``pac_train`` of each case, from the same
    params, two epochs, with the protocol's metrics."""
    g, tr, jg, jtr = _graphs()
    cfg_t, cfg_j = tm.TIGConfig(**SMALL), jm.TIGConfig(**SMALL)
    p0 = jax.tree.map(np.asarray,
                      jm.init_params(jax.random.PRNGKey(0), cfg_j))
    runs = {}
    for name, (parts, plan, sync, warm) in CASES.items():
        part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, parts,
                             k=0.05)
        jpart = jax_sep_partition(jtr.src, jtr.dst, jtr.t, jg.num_nodes,
                                  parts, k=0.05)
        kw = dict(num_devices=2, epochs=2, plan=plan, sync_mode=sync,
                  eval_warm=warm)
        want = jd.pac_train(jtr, jpart, cfg_j, mesh=None, prefetch=False,
                            epoch_boundary="serial", eval_graph=jg, **kw)
        got = td.pac_train(tr, part, cfg_t, eval_graph=g,
                           params=convert.params_from_numpy(p0),
                           device="cpu", **kw)
        runs[name] = (got, want)
    return runs


@pytest.mark.parametrize("case", sorted(CASES))
def test_pac_train_matches_jax(pac_runs, case):
    got, want = pac_runs[case]
    assert len(got.losses) == len(want.losses) == 2
    for a, b in zip(got.losses, want.losses):
        assert a.shape == np.asarray(b).shape
        _close(a, b)
    # the wrap-around and the cycle backup are exercised
    assert len(set(got.plan.n_batches.tolist())) > 1
    np.testing.assert_array_equal(got.plan.n_batches, want.plan.n_batches)
    tp = convert.params_to_numpy(got.params)
    jp = jax.tree.map(np.asarray, want.params)
    # the attention's key bias has a float32-noise gradient in both
    # packages (the softmax ignores it), which AdamW scales up
    del tp["attn"]["k"]["b"], jp["attn"]["k"]["b"]
    jax.tree.map(_close, tp, jp)
    states = {k: v.numpy() for k, v in got.memory_states.items()}
    assert states.keys() == set(want.memory_states)
    for k, v in want.memory_states.items():
        assert states[k].shape == np.asarray(v).shape, k
        _close(states[k], v)
    for k in ("val_ap", "test_ap", "val_ap_inductive", "test_ap_inductive"):
        np.testing.assert_allclose(got.metrics[k], want.metrics[k],
                                   atol=1e-3, err_msg=k)
    assert np.isnan(got.metrics["train_ap"]) == np.isnan(
        want.metrics["train_ap"])
    assert got.derived_speedup == want.derived_speedup
    np.testing.assert_array_equal(got.edges_per_device,
                                  want.edges_per_device)


def test_sync_shared_memory_equals_numpy_oracle():
    """The torch sync against ``repro_torch.core.pac.sync_shared_memory``
    (the numpy oracle), with ties in ``last`` (the first device wins)."""
    from repro_torch.core.pac import sync_shared_memory as oracle

    rng = np.random.default_rng(4)
    p, rows, d, s = 3, 30, 5, 9
    states = {"mem": rng.standard_normal((p, rows, d)).astype(np.float32),
              "mem2": rng.standard_normal((p, rows, d)).astype(np.float32),
              "last": rng.integers(0, 3, (p, rows)).astype(np.float32)}
    shared = np.stack([rng.permutation(rows - 1)[:s] for _ in range(p)])
    for mode in ("latest", "mean"):
        got = td.sync_shared_memory(
            {k: torch.from_numpy(v) for k, v in states.items()}, shared,
            sync_mode=mode)
        for key in ("mem", "mem2"):
            want = oracle(states[key], states["last"], shared, mode)
            _close(got[key].numpy(), want, 1e-6)
        if mode == "latest":
            np.testing.assert_array_equal(
                got["mem"].numpy(),
                oracle(states["mem"], states["last"], shared, mode))


def test_evaluate_params_matches_jax():
    g, _, jg, _ = _graphs()
    cfg_j = jm.TIGConfig(**SMALL)
    p0 = jax.tree.map(np.asarray,
                      jm.init_params(jax.random.PRNGKey(1), cfg_j))
    want = jax_evaluate(jg, cfg_j, p0, seed=3)
    got = evaluate_params(g, tm.TIGConfig(**SMALL),
                          convert.params_from_numpy(p0), seed=3,
                          device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)


@pytest.mark.parametrize("option", ["host_replay", "layout", "local_ranks",
                                    "source"])
def test_plan_epoch_refuses_what_is_not_ported(option):
    """What is not ported raises "not ported"; the layouts that are
    ported refuse an invalid layout or combination with JAX's
    ValueError."""
    g, tr, _, _ = _graphs()
    cfg = tm.TIGConfig(**SMALL)
    lists = [np.arange(10), np.arange(10, 20)]
    kw, match = {
        "host_replay": (dict(host_replay=True), "not ported"),
        "layout": (dict(layout="bogus"),
                   "expected 'replicated' or 'sharded'"),
        "local_ranks": (dict(local_ranks=[0]),
                        "local_ranks requires layout='sharded'"),
        "source": ({}, "not ported")}[option]
    source = object() if option == "source" else tr
    with pytest.raises(ValueError, match=match):
        td.plan_epoch(source, lists, np.zeros(0, np.int64), cfg,
                      np.random.default_rng(0), **kw)


@pytest.mark.parametrize("option", ["mesh", "plan", "epoch_boundary",
                                    "ckpt_dir", "resume", "faults"])
def test_pac_train_refuses_what_is_not_ported(option):
    """What is not ported raises "not ported"; a mesh whose partition
    slots are not ``num_devices`` and an unknown plan raise
    ValueErrors."""
    from repro_torch.launch.mesh import TIGMesh

    g, tr, _, _ = _graphs()
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, 2)
    mesh = TIGMesh(group=None, world=1, rank=0, num_parts=4,
                   ranks=np.arange(4), device=torch.device("cpu"))
    kw, match = {
        "mesh": (dict(mesh=mesh), "the mesh has 4 partition slots"),
        "plan": (dict(plan="bogus"), "plan='bogus'"),
        "epoch_boundary": (dict(epoch_boundary="overlap"), "not ported"),
        "ckpt_dir": (dict(ckpt_dir="ckpt"), "not ported"),
        "resume": (dict(resume=True), "not ported"),
        "faults": (dict(faults=object()), "not ported")}[option]
    with pytest.raises(ValueError, match=match):
        td.pac_train(tr, part, tm.TIGConfig(**SMALL), num_devices=2,
                     device="cpu", **kw)


def test_union_index_is_each_devices_own_batch():
    """A PAC step reads device k's grid row ``offsets[k] + s % n_k`` and
    samples it as of batch ``s % n_k``; the union's loss rows are the
    devices' own batch means. One step of the union against each device
    run alone on its own plan (same params, fresh state)."""
    ep, _, cfg = _plans(2, "device", ep=0)
    u = td.union_plan(ep, cfg)
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    epoch = td._PACEpoch(cfg, opt, params, opt.init(params), u,
                         torch.device("cpu"))
    s = int(ep.n_batches.min())       # one device has wrapped round
    epoch.counter.fill_(s)
    epoch.step()
    got = epoch.out["loss"][s]
    for k in range(len(ep.n_batches)):
        row = int(ep.offsets[k] + s % ep.n_batches[k])
        lo, hi = ep.tcsr["indptr"][k, 0], ep.tcsr["indptr"][k, -1]
        pad = cfg.num_neighbors
        tcsr = {key: torch.from_numpy(np.concatenate(
            [np.zeros(pad, v.dtype), v[lo:hi]]))
            for key, v in ep.tcsr.items() if key != "indptr"}
        tcsr["indptr"] = torch.from_numpy(ep.tcsr["indptr"][k] - lo + pad)
        batch = {key: torch.from_numpy(v[row]) for key, v in
                 ep.batches.items()}
        batch = sample_batch_neighbors(batch, tcsr,
                                       int(s % ep.n_batches[k]), cfg)
        tables = {"nfeat": torch.from_numpy(ep.nfeat_local[k]),
                  "efeat": torch.from_numpy(ep.efeat_local[k])}
        state = tm.init_state(cfg, ep.capacity)
        loss, _ = tm.step_loss(params, state, batch, tables, cfg)
        _close(got[k].item(), loss.item(), 1e-6)
