"""The port's SEP partitioner, baselines, metrics and PAC host helpers
(``repro_torch.core``) against the JAX package's ``repro.core``, on the
CPU: both are numpy, so every output must be equal, bit for bit.

The inputs are the train split of ``synthetic_tig("small")`` (power-law,
time-sorted) and a seeded random stream.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import pac as jpac  # noqa: E402
from repro.tig.data import synthetic_tig as jax_synthetic_tig  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import metrics, pac  # noqa: E402
from repro_torch.tig.data import synthetic_tig  # noqa: E402
from repro_torch.tig.graph import chronological_split  # noqa: E402


def _stream(which: str):
    if which == "small":
        g = synthetic_tig("small")
        np.testing.assert_array_equal(g.src, jax_synthetic_tig("small").src)
        tr, _, _, _ = chronological_split(g)
        return tr.src, tr.dst, tr.t, g.num_nodes
    rng = np.random.default_rng(7)
    n, e = 300, 4_000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    return src, dst, np.sort(rng.random(e)) * 1e6, n


def _equal(a, b, what=""):
    """Equal values of two results: arrays, scalars, dataclasses (all
    fields but the timing ``elapsed_s``), lists and dicts of them."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            if f.name != "elapsed_s":
                _equal(getattr(a, f.name), getattr(b, f.name), f.name)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _equal(x, y, what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif a is None:
        assert b is None, what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
        assert np.asarray(a).dtype == np.asarray(b).dtype, what


CENTRALITY = {
    "temporal": lambda c, s, d, t, n: c.temporal_centrality(s, d, t, n),
    "temporal raw beta 0.9": lambda c, s, d, t, n: c.temporal_centrality(
        s, d, (t - t.min()) / max(np.ptp(t), 1e-12), n, beta=0.9,
        normalize_time=False),
    "degree": lambda c, s, d, t, n: c.degree_centrality(s, d, n),
    "top_k_hubs 0.05": lambda c, s, d, t, n: c.top_k_hubs(
        c.temporal_centrality(s, d, t, n), 0.05),
    "top_k_hubs 0 / 1": lambda c, s, d, t, n: [
        c.top_k_hubs(c.degree_centrality(s, d, n), k) for k in (0.0, 1.0)],
}


@pytest.mark.parametrize("stream", ["small", "random"])
@pytest.mark.parametrize("case", sorted(CENTRALITY))
def test_centrality_equals_jax(case, stream):
    s, d, t, n = _stream(stream)
    _equal(CENTRALITY[case](core, s, d, t, n),
           CENTRALITY[case](jcore, s, d, t, n), case)


PARTITIONERS = {
    "sep": lambda c, s, d, t, n: c.sep_partition(s, d, t, n, 4, k=0.05),
    "sep chunk 512": lambda c, s, d, t, n: c.sep_partition(
        s, d, t, n, 4, k=0.05, chunk_size=512),
    "sep chunk 0 (per-edge)": lambda c, s, d, t, n: c.sep_partition(
        s, d, t, n, 4, k=0.05, chunk_size=0),
    "sep 8 parts, k 0.1, no broadcast": lambda c, s, d, t, n:
        c.sep_partition(s, d, t, n, 8, k=0.1, shared_to_all=False),
    "streaming_vertex_cut_reference": lambda c, s, d, t, n:
        c.streaming_vertex_cut_reference(
            s, d, n, 4, centrality=c.temporal_centrality(s, d, t, n),
            hubs=c.top_k_hubs(c.temporal_centrality(s, d, t, n), 0.05)),
    "hdrf": lambda c, s, d, t, n: c.hdrf_partition(s, d, n, 4),
    "greedy": lambda c, s, d, t, n: c.greedy_partition(s, d, n, 4),
    "random": lambda c, s, d, t, n: c.random_partition(s, d, n, 4, seed=3),
    "ldg": lambda c, s, d, t, n: c.ldg_partition(s, d, n, 4),
}


@pytest.mark.parametrize("stream", ["small", "random"])
@pytest.mark.parametrize("case", sorted(PARTITIONERS))
def test_partitioners_equal_jax(case, stream):
    s, d, t, n = _stream(stream)
    got = PARTITIONERS[case](core, s, d, t, n)
    want = PARTITIONERS[case](jcore, s, d, t, n)
    _equal(got, want, case)
    _equal(got.node_lists(), want.node_lists(), case)
    _equal(metrics.partition_stats(got), jmetrics.partition_stats(want),
           case)


def test_kl_equals_jax():
    pytest.importorskip("networkx")
    s, d, _, n = _stream("random")
    _equal(core.kl_partition(s, d, n, 4, max_iter=2),
           jcore.kl_partition(s, d, n, 4, max_iter=2))


def _metric_cases():
    s, d, t, n = _stream("small")
    res = {m.__name__: m.sep_partition(s, d, t, n, 4, k=0.05)
           for m in (core, jcore)}
    deg = core.degree_centrality(s, d, n)
    return {
        "replication_factor": lambda m, r: [
            m.replication_factor(r), m.replication_factor(r, "all")],
        "edge_cut_fraction": lambda m, r: m.edge_cut_fraction(r),
        "partition_stats": lambda m, r: m.partition_stats(r),
        "thm1_rf_bound": lambda m, r: [m.thm1_rf_bound(k, p) for k in (
            0.0, 0.05, 0.3) for p in (2, 4, 8)],
        "thm2_ec_bound": lambda m, r: [m.thm2_ec_bound(
            n, len(s), k, 1.0, a) for k in (0.01, 0.05) for a in (
                1.5, 2.5)],
        "fit_power_law_alpha": lambda m, r: [
            m.fit_power_law_alpha(deg), m.fit_power_law_alpha(deg, 3)],
    }, res


@pytest.mark.parametrize("case", ["replication_factor", "edge_cut_fraction",
                                  "partition_stats", "thm1_rf_bound",
                                  "thm2_ec_bound", "fit_power_law_alpha"])
def test_metrics_equal_jax(case):
    cases, res = _metric_cases()
    _equal(cases[case](metrics, res["repro_torch.core"]),
           cases[case](jmetrics, res["repro.core"]), case)


def _pac_case(case, m, c):
    s, d, t, n = _stream("small")
    part = c.sep_partition(s, d, t, n, 8, k=0.05)
    lists = part.node_lists()
    if case == "shuffle_combine":
        rng = np.random.default_rng(5)
        return [m.shuffle_combine(lists, nd, rng) for nd in (2, 4, 8)]
    if case == "build_subgraph":
        return [m.build_subgraph(s, d, nodes, n) for nodes in lists]
    if case == "make_local_indices":
        return m.make_local_indices(lists, n)
    if case == "cycle_schedule":
        edges = [len(m.build_subgraph(s, d, nodes, n)) for nodes in lists]
        sched = m.cycle_schedule(edges, 50)
        return [sched, sched.batch_index(17), sched.is_cycle_end(9)]
    if case == "derived_speedup":
        return [m.derived_speedup(e) for e in (
            part.edge_counts(), [5, 5, 5, 5], [0, 0], [9, 1])]
    rng = np.random.default_rng(2)
    mem = rng.standard_normal((3, 20, 6)).astype(np.float32)
    last = rng.integers(0, 4, (3, 20)).astype(np.float32)   # ties
    shared = np.stack([rng.permutation(20)[:7] for _ in range(3)])
    return [m.sync_shared_memory(mem, last, shared, mode)
            for mode in ("latest", "mean")]


@pytest.mark.parametrize("case", ["shuffle_combine", "build_subgraph",
                                  "make_local_indices", "cycle_schedule",
                                  "derived_speedup", "sync_shared_memory"])
def test_pac_host_helpers_equal_jax(case):
    _equal(_pac_case(case, pac, core), _pac_case(case, jpac, jcore), case)


def test_core_exports_match_jax():
    assert core.__all__ == jcore.__all__
    for name in core.__all__:
        assert getattr(core, name).__name__ == getattr(jcore, name).__name__
