"""The port's chunked data plane (``repro_torch.tig.stream``, the chunked
T-CSR build and the JODIE loader) against the JAX package's
``repro.tig.stream``, on the CPU.

Everything here is numpy or an exact copy, so the checks are exact: the
shard files of both packages are the same bytes, a directory one writes
the other opens, ``from_chunks`` gives the one-shot index's arrays, and
``stage_device_tables`` gives ``make_tables``' rows. The prefetcher cases
mirror ``tests/test_stream.py``'s.
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.tig import stream as js  # noqa: E402
from repro.tig.data import load_jodie_csv as jax_load_jodie  # noqa: E402
from repro.tig.data import synthetic_tig as jax_synthetic_tig  # noqa: E402
from repro.tig.sampler import ChronoNeighborIndex as JaxIndex  # noqa: E402
from repro_torch.tig import stream as ts  # noqa: E402
from repro_torch.tig.batching import LocalStream, make_tables  # noqa: E402
from repro_torch.tig.data import load_jodie_csv, synthetic_tig  # noqa: E402
from repro_torch.tig.graph import TemporalGraph  # noqa: E402
from repro_torch.tig.protocol import split_views  # noqa: E402
from repro_torch.tig.sampler import ChronoNeighborIndex  # noqa: E402
from repro_torch.tig.stream import (EpochPrefetcher, ShardedStream,  # noqa
                                    iter_jodie_blocks, stage_device_tables,
                                    write_graph_shards, write_jodie_shards)

JODIE_CSV = """user_id,item_id,timestamp,state_label,f0,f1
0,0,1,0,0.5,1.5
1,0,2,0,0.25
2,1,3,1
1,2,4,,0.75,2.5,9.9
0,1,10,0,1.0,2.0,3.0
"""

NO_FEAT_CSV = """user_id,item_id,timestamp,state_label
0,0,1,0
1,1,2.5,1
0,1,3,0
"""

CLEAN_CSV = "user_id,item_id,timestamp,state_label,f0,f1\n" + "".join(
    f"{u},{u % 3},{ts},{ts % 2},{0.5 * u},{1.5 * ts}\n"
    for ts, u in enumerate(range(40)))

INDEX_ARRAYS = ("_indptr", "_nbr", "_t", "_e", "_bkey")


def _csv(tmp_path, text, name="ml_x.csv"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


# ------------------------------------------------------------ shard format

def test_graph_shard_roundtrip(tmp_path):
    g = synthetic_tig("tiny", seed=3)
    sh = write_graph_shards(g, str(tmp_path / "tiny"), shard_edges=257)
    assert sh.num_shards == -(-g.num_edges // 257)
    assert sh.num_edges == g.num_edges
    re = ShardedStream.open(str(tmp_path / "tiny"))
    g2 = re.as_graph()
    for f in ("src", "dst", "t", "labels", "edge_feat"):
        np.testing.assert_array_equal(getattr(g2, f), getattr(g, f))
    assert g2.num_nodes == g.num_nodes
    np.testing.assert_array_equal(re.column("src"), g.src)
    chunks = list(re.edge_chunks())
    assert sum(len(c[0]) for c in chunks) == g.num_edges
    np.testing.assert_array_equal(
        np.concatenate([c[3] for c in chunks]), np.arange(g.num_edges))
    feats = np.concatenate([c[4] for c in re.edge_chunks(features=True)])
    np.testing.assert_array_equal(feats, g.edge_feat)
    assert isinstance(re.load(0, "efeat"), np.memmap)


def test_open_rejects_non_shard_dir(tmp_path):
    os.makedirs(tmp_path / "x", exist_ok=True)
    with open(tmp_path / "x" / "meta.json", "w") as f:
        f.write('{"format": "something-else"}')
    with pytest.raises(ValueError, match="tig-shards-v1"):
        ShardedStream.open(str(tmp_path / "x"))


@pytest.mark.parametrize("node_feat", ["zeros", "random"])
def test_shard_files_are_the_jax_packages_bytes(tmp_path, node_feat):
    """Both packages write the same files, byte for byte, and each opens
    the other's directory to the same graph."""
    g, jg = synthetic_tig("tiny", seed=1), jax_synthetic_tig("tiny", seed=1)
    if node_feat == "random":
        nf = np.random.default_rng(0).normal(
            size=g.node_feat.shape).astype(np.float32)
        g.node_feat, jg.node_feat = nf, nf.copy()
    ts.write_graph_shards(g, str(tmp_path / "port"), shard_edges=300)
    js.write_graph_shards(jg, str(tmp_path / "jax"), shard_edges=300)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert ("node_feat.npy" in names) == (node_feat == "random")
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n
    mine = js.ShardedStream.open(str(tmp_path / "port")).as_graph()
    theirs = ShardedStream.open(str(tmp_path / "jax")).as_graph()
    for f in ("src", "dst", "t", "labels", "edge_feat", "node_feat"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(g, f))
        np.testing.assert_array_equal(getattr(theirs, f), getattr(g, f))


# --------------------------------------------------------- JODIE ingestion

def test_load_jodie_csv_ragged_and_int_timestamps(tmp_path):
    p = _csv(tmp_path, JODIE_CSV)
    g = load_jodie_csv(p, d_n=8)
    assert g.num_edges == 5
    assert g.edge_feat.shape == (5, 3)
    np.testing.assert_allclose(
        g.edge_feat[:4],
        [[0.5, 1.5, 0.0], [0.25, 0.0, 0.0], [0.0, 0.0, 0.0],
         [0.75, 2.5, 9.9]])
    assert g.labels.tolist() == [0, 0, 1, 0, 0]
    assert g.t.tolist() == [1.0, 2.0, 3.0, 4.0, 10.0]
    assert g.src.tolist() == [0, 1, 2, 1, 0]
    assert g.dst.tolist() == [3, 3, 4, 5, 4]
    assert g.node_feat.shape == (6, 8)


def test_load_jodie_csv_no_feature_columns(tmp_path):
    g = load_jodie_csv(_csv(tmp_path, NO_FEAT_CSV, "ml_nofeat.csv"))
    assert g.edge_feat.shape == (3, 1)
    np.testing.assert_array_equal(g.edge_feat, 0.0)
    assert g.t.tolist() == [1.0, 2.5, 3.0]


@pytest.mark.parametrize("text", [JODIE_CSV, NO_FEAT_CSV, CLEAN_CSV],
                         ids=["ragged", "no features", "clean"])
def test_load_jodie_csv_matches_jax(tmp_path, text):
    p = _csv(tmp_path, text)
    g, jg = load_jodie_csv(p, d_n=4), jax_load_jodie(p, d_n=4)
    for f in ("src", "dst", "t", "labels", "edge_feat", "node_feat"):
        a, b = getattr(g, f), getattr(jg, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert g.name == jg.name


def test_write_jodie_shards_matches_in_memory_loader(tmp_path):
    p = _csv(tmp_path, JODIE_CSV)
    sh = write_jodie_shards(p, str(tmp_path / "shards"), shard_edges=2)
    assert sh.num_shards == 3
    g_mem = load_jodie_csv(p, d_n=sh.dim_node)
    g_sh = sh.as_graph()
    for f in ("src", "dst", "t", "labels", "edge_feat"):
        np.testing.assert_array_equal(getattr(g_sh, f), getattr(g_mem, f))
    assert g_sh.num_nodes == g_mem.num_nodes
    js.write_jodie_shards(p, str(tmp_path / "jax"), shard_edges=2)
    for n in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "shards" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n


def test_write_jodie_shards_rejects_unsorted(tmp_path):
    p = _csv(tmp_path, "u,i,ts,l\n0,0,5,0\n1,1,4,0\n", "ml_bad.csv")
    with pytest.raises(ValueError, match="non-decreasing"):
        write_jodie_shards(p, str(tmp_path / "bad"))


def test_write_jodie_shards_without_label_column(tmp_path):
    p = _csv(tmp_path, "user_id,item_id,timestamp\n0,0,1\n1,0,2\n0,1,3\n",
             "ml_min.csv")
    sh = write_jodie_shards(p, str(tmp_path / "min"))
    assert not sh.has_labels
    assert sh.as_graph().labels is None


def test_iter_jodie_blocks_block_sizes(tmp_path):
    p = _csv(tmp_path, JODIE_CSV)
    blocks = list(iter_jodie_blocks(p, block_rows=2))
    assert [len(b[0]) for b in blocks] == [2, 2, 1]


@pytest.mark.parametrize("text", [JODIE_CSV, CLEAN_CSV],
                         ids=["ragged", "clean"])
def test_block_parsers_match_each_other_and_jax(tmp_path, text):
    """The vectorized and the row-by-row parser agree (the clean blocks
    take the vectorized one, the ragged one falls back), and both equal
    the JAX package's blocks."""
    p = _csv(tmp_path, text)
    fast = list(iter_jodie_blocks(p, block_rows=16, fast=True))
    slow = list(iter_jodie_blocks(p, block_rows=16, fast=False))
    jax_blocks = list(js.iter_jodie_blocks(p, block_rows=16))
    assert len(fast) == len(slow) == len(jax_blocks)
    for bf, bs, bj in zip(fast, slow, jax_blocks):
        for cf, cs, cj in zip(bf, bs, bj):
            np.testing.assert_array_equal(cf, cs)
            np.testing.assert_array_equal(cf, cj)
            assert cf.dtype == cs.dtype == cj.dtype
    lines = text.splitlines(keepends=True)[1:]
    width = ts._sniff_feat_width(p)
    assert (ts._parse_jodie_rows_fast(lines, width) is None) == \
        (text is JODIE_CSV)


def test_fast_parser_rejects_nonfinite_id_and_label_fields():
    fast = ts._parse_jodie_rows_fast
    assert fast(["nan,1,2.0,0,0.5\n"], 1) is None
    assert fast(["0,inf,2.0,0,0.5\n"], 1) is None
    assert fast(["0,1,2.0,nan,0.5\n"], 1) is None
    ok = fast(["0,1,nan,0,nan\n"], 1)
    assert ok is not None and np.isnan(ok[2][0]) and np.isnan(ok[4][0, 0])


def test_fast_parser_pads_missing_feature_width():
    lines = ["0,1,2,1\n", "1,2,3,0\n"]
    fast = ts._parse_jodie_rows_fast(lines, 3)
    slow = ts._parse_jodie_rows(lines, 3)
    assert fast is not None
    for cf, cs in zip(fast, slow):
        np.testing.assert_array_equal(cf, cs)


# ---------------------------------------------------------- device staging

@pytest.mark.parametrize("node_feat", ["zeros", "random"])
def test_stage_device_tables_matches_make_tables(tmp_path, node_feat):
    g = synthetic_tig("tiny", seed=5)
    if node_feat == "random":
        g.node_feat = np.random.default_rng(1).normal(
            size=g.node_feat.shape).astype(np.float32)
    sh = write_graph_shards(g, str(tmp_path / "s"), shard_edges=123)
    with _no_warning():
        staged = stage_device_tables(sh, device="cpu")
    ref = make_tables(g.edge_feat, g.node_feat)
    for k in ("efeat", "nfeat"):
        assert staged[k].dtype == torch.float32
        np.testing.assert_array_equal(staged[k].numpy(), ref[k], err_msg=k)
    # the JAX package stages the same rows
    jstaged = js.stage_device_tables(js.ShardedStream.open(sh.path))
    for k in ("efeat", "nfeat"):
        np.testing.assert_array_equal(staged[k].numpy(),
                                      np.asarray(jstaged[k]))


class _no_warning:
    """Fails on any warning inside (``torch.from_numpy`` warns on the
    read-only arrays of a memory map)."""

    def __enter__(self):
        import warnings

        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)


# ---------------------------------------------------- chunked T-CSR build

def _chunks(stream, size):
    return [(stream.src[lo:lo + size], stream.dst[lo:lo + size],
             stream.t[lo:lo + size], stream.eidx[lo:lo + size])
            for lo in range(0, stream.num_edges, size)]


@pytest.mark.parametrize("shard,batch", [(16_384, 200), (1_000, 200),
                                         (7, 200), (37, 5), (200, 200)])
@pytest.mark.parametrize("history", [False, True])
def test_from_chunks_equals_one_shot_and_jax(shard, batch, history):
    """At shard sizes that are not a multiple of the batch (a batch then
    straddles two shards and must be re-aligned), and at tiny ones; with
    a history, the second half of the stream continuing the first's."""
    g = synthetic_tig("small", scale=6.0 if shard > 10_000 else
                      1.0 if shard >= 1_000 else 0.25)
    t = g.t / g.t[-1]
    half = g.num_edges // 2
    lo = half if history else 0
    view = LocalStream(src=g.src[lo:], dst=g.dst[lo:], t=t[lo:],
                       eidx=np.arange(lo, g.num_edges),
                       num_local_nodes=g.num_nodes)
    args = (g.num_nodes, 4, batch)
    hist = ChronoNeighborIndex(g.src[:half], g.dst[:half], t[:half],
                               np.arange(half), *args).final_snapshot() \
        if history else None
    one = ChronoNeighborIndex(view.src, view.dst, view.t, view.eidx, *args,
                              history=hist)
    chunks = _chunks(view, shard)
    assert len(chunks) >= 2
    got = ChronoNeighborIndex.from_chunks(lambda: iter(chunks), *args,
                                          history=hist)
    jax = JaxIndex.from_chunks(chunks, *args, history=hist)
    for name in INDEX_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(one, name),
                                      err_msg=name)
        np.testing.assert_array_equal(getattr(got, name), getattr(jax, name),
                                      err_msg=name)
    assert got.num_batches == one.num_batches == jax.num_batches
    for key, v in one.device_export().items():
        np.testing.assert_array_equal(got.device_export()[key], v)


def test_from_chunks_refuses_a_source_that_changes():
    g = synthetic_tig("tiny")
    tr = split_views(g).train
    calls = []

    def chunks():
        calls.append(1)
        n = 400 if len(calls) == 1 else 200
        return iter(_chunks(tr, 100)[: n // 100])

    with pytest.raises(ValueError, match="chunk passes disagree"):
        ChronoNeighborIndex.from_chunks(chunks, g.num_nodes, 4, 50)


def test_from_chunks_of_a_generator_is_listed():
    g = synthetic_tig("tiny")
    tr = split_views(g).train
    one = ChronoNeighborIndex(tr.src, tr.dst, tr.t, tr.eidx, g.num_nodes, 4,
                              50)
    got = ChronoNeighborIndex.from_chunks(
        (c for c in _chunks(tr, 130)), g.num_nodes, 4, 50)
    for name in INDEX_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(one, name))


# -------------------------------------------------------------- prefetcher

def test_prefetcher_order_and_results():
    built = []

    def build(ep):
        built.append(ep)
        return ep * 10

    with EpochPrefetcher(build, 4) as pf:
        assert [pf.get(ep) for ep in range(4)] == [0, 10, 20, 30]
    assert built == [0, 1, 2, 3]


def test_prefetcher_disabled_inline():
    pf = EpochPrefetcher(lambda ep: ep, 3, enabled=False)
    assert [pf.get(e) for e in range(3)] == [0, 1, 2]
    assert pf._worker is None


def test_prefetcher_close_detaches_pipeline():
    pf = EpochPrefetcher(lambda ep: ep, 5)
    assert pf.get(0) == 0
    pf.close()
    assert pf._futures == {} and pf._worker is None


def test_prefetcher_propagates_exceptions():
    def build(ep):
        if ep == 1:
            raise RuntimeError("boom")
        return ep

    with EpochPrefetcher(build, 3) as pf:
        assert pf.get(0) == 0
        with pytest.raises(RuntimeError, match="boom"):
            pf.get(1)


def test_prefetcher_single_persistent_worker():
    tids, built = [], []

    def build(ep):
        tids.append(threading.get_ident())
        built.append(ep)
        return ep

    with EpochPrefetcher(build, 6, depth=3) as pf:
        assert [pf.get(e) for e in range(6)] == list(range(6))
    assert built == list(range(6))
    assert len(set(tids)) == 1
    assert tids[0] != threading.get_ident()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_depth_matches_inline(depth):
    """A stateful builder (one generator drawn in epoch order) gives the
    same plans at any depth as inline."""
    def plans(**kw):
        rng = np.random.default_rng(0)
        with EpochPrefetcher(lambda ep: rng.integers(0, 1 << 30, 3), 5,
                             **kw) as pf:
            return [pf.get(e) for e in range(5)]

    want = plans(enabled=False)
    for a, b in zip(plans(depth=depth), want):
        np.testing.assert_array_equal(a, b)


def test_prefetcher_depth0_is_inline():
    built = []

    def build(ep):
        built.append(ep)
        return ep

    with EpochPrefetcher(build, 3, depth=0) as pf:
        assert [pf.get(e) for e in range(3)] == [0, 1, 2]
        assert pf._worker is None
    with pytest.raises(ValueError, match="depth"):
        EpochPrefetcher(build, 3, depth=-1)


def test_prefetcher_exception_at_get_cancels_pipeline():
    def build(ep):
        if ep == 1:
            raise RuntimeError("boom")
        return ep

    with EpochPrefetcher(build, 6, depth=4) as pf:
        assert pf.get(0) == 0
        with pytest.raises(RuntimeError, match="boom"):
            pf.get(1)
        assert pf._futures == {}


def test_prefetcher_close_mid_build_is_bounded():
    """``close`` joins once the build the worker began is done, and no
    build starts after it."""
    started, release = [], threading.Event()

    def build(ep):
        started.append(ep)
        if ep == 1:
            release.wait(5.0)
        return ep

    pf = EpochPrefetcher(build, 10, depth=4)
    assert pf.get(0) == 0
    deadline = time.monotonic() + 5.0
    while 1 not in started and time.monotonic() < deadline:
        time.sleep(0.01)
    threading.Timer(0.1, release.set).start()
    t0 = time.monotonic()
    pf.close()
    assert time.monotonic() - t0 < 5.0
    assert pf._worker is None and pf._futures == {}
    n = len(started)
    time.sleep(0.05)
    assert started == [0, 1] and len(started) == n


def test_graph_columns_of_a_sharded_stream_are_writable(tmp_path):
    """The id / time columns a sharded stream hands the planners are new
    arrays, not the read-only maps (the epoch programs copy them to the
    device through ``torch.from_numpy``)."""
    g = synthetic_tig("tiny")
    sh = write_graph_shards(g, str(tmp_path / "s"))
    assert sh.num_shards == 1
    for field in ("src", "dst", "t", "label"):
        assert sh.column(field).flags.writeable
    assert isinstance(ShardedStream.open(sh.path).as_graph(), TemporalGraph)
