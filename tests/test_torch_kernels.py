"""The port's plain kernel versions (``repro_torch.kernels.ref``) against
the JAX package's oracles and its Pallas kernels in interpret mode, on the
same numpy inputs; and the port's device dispatch on CPU tensors.

Tolerances: sampling is exact (integer ids, copied times); the flush, the
temporal attention, the GRU cell (forward and all six grads) and flash
attention agree to 1e-5 forward and backward, float32 sums taken in
another order. The flush's backward from the touched rows is held to
autograd of ``flush_ref`` in float64 to 1e-10 (the same function, sums in
another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention  # noqa: E402
from repro.kernels.fused_flush import fused_flush_fwd  # noqa: E402
from repro.kernels.neighbor_sample import neighbor_sample_fwd  # noqa: E402
from repro.kernels.temporal_attn import (temporal_attn,  # noqa: E402
                                         temporal_attn_bwd)
from repro.models.layers import chunked_attention  # noqa: E402
from repro.tig.sampler import ChronoNeighborIndex as JaxIndex  # noqa: E402
from repro_torch.kernels import fused_flush as tflush  # noqa: E402
from repro_torch.kernels import fused_gru as tgru  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.build import KERNELS  # noqa: E402
from repro_torch.kernels.neighbor_sample import (  # noqa: E402
    ROW_THREADS, sample_roles_fwd)
from repro_torch.kernels.neighbor_sample import (  # noqa: E402
    neighbor_sample_fwd as torch_sample_fwd)
from repro_torch.tig.sampler import ChronoNeighborIndex  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tests: the suite runs in
    several worker processes at once, and a torch that takes every core
    in each of them makes the workers contend for the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=0)


# ------------------------------------------------------------- sampling

def _tcsr_case():
    """A stream whose nodes 25..29 have no events and many nodes fewer
    than K events; exported at depth 2 so window 1 is in bounds."""
    rng = np.random.default_rng(0)
    n, e, k, bsz = 30, 150, 6, 10
    args = (rng.integers(0, 25, e), rng.integers(0, 25, e),
            np.sort(rng.uniform(0, 10, e)), np.arange(e))
    tidx = ChronoNeighborIndex(*args, n, k, bsz)
    jidx = JaxIndex(*args, n, k, bsz)
    batch_of = rng.integers(0, tidx.num_batches + 1, n).astype(np.int32)
    return tidx, jidx, batch_of, k


def test_device_export_matches_jax():
    tidx, jidx, _, _ = _tcsr_case()
    for depth in (1, 2):
        a, b = tidx.device_export(depth), jidx.device_export(depth)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("window", [0, 1])
def test_sample_ref_exact(window):
    tidx, _, batch_of, k = _tcsr_case()
    ex = tidx.device_export(depth=2)
    nodes = np.arange(tidx.num_nodes, dtype=np.int32)
    jargs = [jnp.asarray(ex[key]) for key in
             ("indptr", "nbr", "t", "eidx", "bat")]
    want = jref.sample_ref(*jargs, jnp.asarray(nodes), jnp.asarray(batch_of),
                           k, window)
    kern = neighbor_sample_fwd(*jargs, jnp.asarray(nodes),
                               jnp.asarray(batch_of), k=k, interpret=True,
                               window=window)
    got = ref.sample_ref(*(_t(ex[key]) for key in
                           ("indptr", "nbr", "t", "eidx", "bat")),
                         _t(nodes), _t(batch_of), k, window)
    host = tidx.sample(nodes, batch_of, window=window)
    for g, w, kn, h in zip(got, want, kern, host):
        assert g.dtype == {np.int32: torch.int32,
                           np.float32: torch.float32}[np.asarray(w).dtype.type]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(kn))
        np.testing.assert_array_equal(g.numpy(), h.astype(g.numpy().dtype))
    assert (got[0] == -1).all(1)[25:].all()       # degree-0 nodes
    assert ((got[0] == -1).any(1) & (got[0] >= 0).any(1)).any()  # K > deg


def test_sample_takes_a_0dim_batch_index():
    """A 0-dim batch index (on the card: a device scalar the kernel reads)
    samples as the int does, in both forms."""
    tidx, _, _, k = _tcsr_case()
    tcsr = {key: _t(v) for key, v in tidx.device_export().items()}
    nodes = torch.arange(tidx.num_nodes, dtype=torch.int32)
    s = tidx.num_batches // 2
    scalar = torch.tensor(s, dtype=torch.int32)
    for x, y in zip(ops.neighbor_sample(tcsr, nodes, scalar, k),
                    ops.neighbor_sample(tcsr, nodes, s, k)):
        assert torch.equal(x, y)
    src, dst, neg = nodes[:10], nodes[10:20], nodes[20:]
    valid = torch.ones(10, dtype=torch.bool)
    for x, y in zip(ops.sample_roles(tcsr, src, dst, neg, valid, scalar, k),
                    ops.sample_roles(tcsr, src, dst, neg, valid, s, k)):
        assert torch.equal(x, y)


def _kernel_search(seg, keys, tpr, below=np.less):
    """The search of ``csrc/neighbor_sample.cu`` for every key at once: in
    each round thread i of the row's ``tpr`` probes split point
    lo + (i + 1) q + (i + 1) rem // (tpr + 1) of [lo, lo + n), n = q (tpr +
    1) + rem, and the count c of probes ``below`` the key names the part
    that holds the answer: lo = probe c - 1 plus one (or lo), hi = probe c
    (or hi). Returns (end, rounds)."""
    keys = np.asarray(keys, np.int64)
    lo = np.zeros(keys.shape, np.int64)
    hi = np.full(keys.shape, len(seg), np.int64)
    rounds = np.zeros(keys.shape, np.int64)
    lanes = np.arange(tpr)[None, :]

    def split(lo, n, i):
        q, rem = n // (tpr + 1), n % (tpr + 1)
        return lo + (i + 1) * q + (i + 1) * rem // (tpr + 1)

    while (lo < hi).any():
        live = lo < hi
        n = hi - lo
        probes = split(lo[:, None], n[:, None], lanes)
        probes = np.where(live[:, None], probes, 0)
        c = below(seg[probes], keys[:, None]).sum(1)
        new_lo = np.where(c > 0, split(lo, n, c - 1) + 1, lo)
        new_hi = np.where(c < tpr, split(lo, n, np.minimum(c, tpr - 1)), hi)
        lo = np.where(live, new_lo, lo)
        hi = np.where(live, new_hi, hi)
        rounds += live
    return lo, rounds


# segment lengths on each side of the kernel's round boundaries: a part of
# (TPR + 1)^r - 1 events takes r rounds, one of (TPR + 1)^r takes r + 1
_SEARCH_LENGTHS = [0, 1, ROW_THREADS] + [
    (ROW_THREADS + 1) ** r + d for r in (1, 2, 3) for d in (-1, 0, 1)]


@pytest.mark.parametrize("n", sorted(set(_SEARCH_LENGTHS)))
def test_kernel_search_is_bisect_left(n):
    """Sorted segments with repeated keys (runs of about 40), every key from
    below the first to above the last: the kernel's search ends where
    ``searchsorted(side="left")`` does, within its round bound."""
    rng = np.random.default_rng(n)
    seg = np.sort(rng.integers(0, max(2, n // 40), n)).astype(np.int32)
    keys = np.arange(-1, int(seg.max(initial=0)) + 3)
    end, rounds = _kernel_search(seg, keys, ROW_THREADS)
    np.testing.assert_array_equal(end, np.searchsorted(seg, keys,
                                                       side="left"))
    bound, m = 0, n
    while m:
        m //= ROW_THREADS + 1
        bound += 1
    assert rounds.max() <= bound


def _kernel_row(ex, node, batch_of, k, window, tpr, fault=None):
    """One row of ``csrc/neighbor_sample.cu`` on the host, lane by lane:
    the search's rounds; in a warp's last round (a part of n <= tpr events,
    k <= tpr) the window's n + k candidates from lo - (w+1)k loaded two a
    lane beside the probes, slot j taken from candidate (end - lo) + j by
    a shuffle; else the window after the search, masked before the
    segment start. Faults: "count" takes slot j from candidate c + j (c
    the count of probes below the key, duplicates and all); "mask" masks
    at the array start, so a node of fewer than K events borrows the
    padding or the node before it."""
    bat, start = ex["bat"], int(ex["indptr"][node])
    lo, hi, key = start, int(ex["indptr"][node + 1]), batch_of + 1
    first = 0 if fault == "mask" else start
    lanes = np.arange(tpr)

    def split(lo, q, rem, i):
        return lo + (i + 1) * q + (i + 1) * rem // (tpr + 1)

    def slot(idx, ok):
        idx = np.where(ok, idx, 0)
        return (np.where(ok, ex["nbr"][idx], -1),
                np.where(ok, ex["t"][idx], np.float32(-1.0)),
                np.where(ok, ex["eidx"][idx], -1))

    while lo < hi:
        n = hi - lo
        q, rem = n // (tpr + 1), n % (tpr + 1)
        c = int((bat[split(lo, q, rem, lanes)] < key).sum())
        if tpr == 32 and n <= tpr and k <= tpr:
            lim = hi - window * k
            p0 = lo - (window + 1) * k + lanes
            s0 = slot(p0, (p0 >= first) & (p0 < lim))
            s1 = slot(p0 + 32, (p0 + 32 >= first) & (p0 + 32 < lim))
            end = c if fault == "count" else (
                split(0, q, rem, c - 1) + 1 if c else 0)
            e = end + lanes
            return tuple(np.where(e < 32, x0[e & 31], x1[e & 31])[:k]
                         for x0, x1 in zip(s0, s1))
        lo, hi = (split(lo, q, rem, c - 1) + 1 if c else lo,
                  split(lo, q, rem, c) if c < tpr else hi)
    idx = lo - (window + 1) * k + np.arange(k)
    return slot(idx, idx >= first)


@pytest.mark.parametrize("fault", [None, "count", "mask"])
def test_kernel_rows_match_sample_ref(fault):
    """The kernel's rows, emulated, against ``sample_ref`` bitwise: the
    sampling case at depth 2 (windows 0 / 1, nodes without events), and
    segments on each side of the round boundaries at K 1 / 10 / 32 / 64
    (K 64 loads the window after the search) with window 1. Each fault of
    ``_kernel_row`` must fail."""
    tidx, _, batch_of, k = _tcsr_case()
    cases = [(tidx.device_export(depth=2), np.arange(tidx.num_nodes),
              batch_of, kk, w) for kk in (k, 1) for w in (0, 1)]
    rng = np.random.default_rng(0)
    lengths = [0, 1, 5, 32, 33, 34, 40, 1088, 1089, 1090, 2000]
    bat = [np.zeros(128, np.int64)] + [
        np.sort(rng.integers(1, 2 + n // 8, n)) for n in lengths]
    total = 128 + sum(lengths)
    hub = {"indptr": 128 + np.concatenate([[0], np.cumsum(lengths)]),
           "nbr": rng.integers(0, 1000, total).astype(np.int32),
           "t": rng.random(total).astype(np.float32),
           "eidx": np.arange(total, dtype=np.int32),
           "bat": np.concatenate(bat).astype(np.int32)}
    nodes = np.repeat(np.arange(len(lengths)), 12)
    keys = rng.integers(0, 3 + max(lengths) // 8, len(nodes))
    cases += [(hub, nodes, keys, kk, 1) for kk in (1, 10, 32, 64)]
    wrong = 0
    for ex, nds, bo, kk, w in cases:
        want = ref.sample_ref(*(_t(ex[key]) for key in
                                ("indptr", "nbr", "t", "eidx", "bat")),
                              _t(nds.astype(np.int32)),
                              _t(bo.astype(np.int32)), kk, w)
        rows = [_kernel_row(ex, int(nd), int(b), kk, w, ROW_THREADS,
                            fault) for nd, b in zip(nds, bo)]
        for got, wnt in zip(zip(*rows), want):
            same = np.array_equal(np.stack(got), wnt.numpy())
            assert same or fault
            wrong += not same
    assert (wrong > 0) == (fault is not None)


def test_kernel_search_check_catches_probes_at_the_key():
    """Counting probes <= key (bisect_right) must fail the same check."""
    n = (ROW_THREADS + 1) ** 2 + 1
    rng = np.random.default_rng(n)
    seg = np.sort(rng.integers(0, n // 40, n)).astype(np.int32)
    keys = np.arange(-1, int(seg.max()) + 3)
    end, _ = _kernel_search(seg, keys, ROW_THREADS, below=np.less_equal)
    assert (end != np.searchsorted(seg, keys, side="left")).any()
    np.testing.assert_array_equal(end, np.searchsorted(seg, keys,
                                                       side="right"))


# ---------------------------------------------------------------- flush

def _flush_case(seed=0):
    rng = np.random.default_rng(seed)
    r, n, dm, d = 24, 12, 10, 6
    ids = np.array([3, 5, 3, 12, 7, 5, 5, 12, 0, 1, 2, 3] * 2, np.int32)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    mem = f(n + 1, d)
    mem[n] = 0.0
    last = np.abs(f(n + 1))
    last[n] = 0.0
    return [ids, f(r, dm), np.abs(f(r)) + 1.0, mem, last, f(dm, 3 * d),
            f(d, 3 * d), f(3 * d), f(3 * d)]


def test_flush_ref_forward_matches_jax():
    args = _flush_case()
    got = ref.flush_ref(*map(_t, args))
    want = jref.flush_ref(*map(jnp.asarray, args))
    kern = fused_flush_fwd(*map(jnp.asarray, args), interpret=True)
    for g, w, kn in zip(got, want, kern):
        _close(g.numpy(), w)
        _close(g.numpy(), kn)


def test_flush_ref_grads_match_jax():
    args = _flush_case(1)
    rng = np.random.default_rng(2)
    diff = (1, 5, 6, 7, 8)                     # msg, wx, wh, bx, bh
    outs = jref.flush_ref(*map(jnp.asarray, args))
    cot = [rng.normal(size=o.shape).astype(np.float32) for o in outs]

    def f(*xs):
        full = list(map(jnp.asarray, args))
        for i, x in zip(diff, xs):
            full[i] = x
        return jref.flush_ref(*full)

    _, vjp = jax.vjp(f, *(jnp.asarray(args[i]) for i in diff))
    want = vjp(tuple(map(jnp.asarray, cot)))
    ts = [_t(a).requires_grad_(i in diff) for i, a in enumerate(args)]
    mem2, _last2, mbar = ref.flush_ref(*ts)      # last' has no gradient
    got = torch.autograd.grad([mem2, mbar], [ts[i] for i in diff],
                              [_t(cot[0]), _t(cot[2])])
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def _inplace_flush(monkeypatch):
    """Stand the card's in-place forward in by its plain version, so the
    ``autograd.Function`` glue runs on the CPU."""
    monkeypatch.setattr(tflush, "fused_flush_fwd", tflush.flush_fwd_ref)


@pytest.mark.parametrize("diff", [(1, 5, 6, 7, 8), (5, 6, 7, 8)],
                         ids=["msg-and-weights", "weights-only"])
def test_fused_flush_function_backward_is_flush_ref(monkeypatch, diff):
    """The autograd.Function around the flush kernel: forward in place on
    ``mem`` / ``last``, backward from the touched rows
    (``flush_bwd_rows``), against autograd of ``flush_ref``, in float64.
    With ``message_fn="id"`` the messages are state, and only the GRU
    weights take a gradient."""
    _inplace_flush(monkeypatch)
    args = [x if x.dtype == np.int32 else x.astype(np.float64)
            for x in _flush_case(3)]
    a = [_t(x).requires_grad_(i in diff) for i, x in enumerate(args)]
    b = [_t(x).requires_grad_(i in diff) for i, x in enumerate(args)]
    mem_in, last_in = a[3].data_ptr(), a[4].data_ptr()
    out_a = tflush.FusedFlush.apply(*a)
    out_b = ref.flush_ref(*b)
    assert out_a[0].data_ptr() == mem_in and out_a[1].data_ptr() == last_in
    assert not out_a[1].requires_grad            # last' has no gradient
    for x, y in zip(out_a, out_b):
        _close(x.detach().numpy(), y.detach().numpy(), 0.0)
    cot = [torch.randn(out_a[i].shape, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(i))
           for i in (0, 2)]
    ga = torch.autograd.grad((out_a[0], out_a[2]), [a[i] for i in diff], cot,
                             allow_unused=True)
    used = [i for i in (0, 2) if out_b[i].requires_grad]
    gb = torch.autograd.grad([out_b[i] for i in used], [b[i] for i in diff],
                             [cot[(0, 2).index(i)] for i in used])
    for x, y in zip(ga, gb):
        _close(x.numpy(), y.numpy(), 1e-10)
    with pytest.raises(NotImplementedError):
        tflush.FusedFlush.apply(*(_t(x).requires_grad_(i == 3)
                                  for i, x in enumerate(args)))


def _ids_case(name):
    """Pending ids over N = 12 (12 is padding)."""
    rng = np.random.default_rng(7)
    n = 12
    ids = {
        "heavy-duplicates": np.concatenate([rng.integers(0, 3, 38),
                                            [n, n]]),
        "all-padding": np.full(16, n),
        "one-row": np.array([5]),
        "ragged-37": rng.integers(0, n + 1, 37),
        "flush-case": _flush_case()[0],
    }[name]
    return ids.astype(np.int32), n


@pytest.mark.parametrize("name", ["heavy-duplicates", "all-padding",
                                  "one-row", "ragged-37", "flush-case"])
def test_flush_bwd_rows_is_flush_ref_autograd(name):
    """The backward from the R touched rows against autograd of
    ``flush_ref``, float64, for msg and the four GRU weights."""
    ids, n = _ids_case(name)
    rng = np.random.default_rng(8)
    r, dm, d = ids.shape[0], 10, 6
    f = lambda *s: _t(rng.normal(size=s))  # noqa: E731
    mem, last = f(n + 1, d), f(n + 1).abs()
    mem[n], last[n] = 0.0, 0.0
    args = [_t(ids), f(r, dm), f(r).abs() + 1.0, mem, last, f(dm, 3 * d),
            f(d, 3 * d), f(3 * d), f(3 * d)]
    g_mem, g_mbar = f(n + 1, d), f(r, dm)
    diff = (1, 5, 6, 7, 8)
    b = [x.clone().requires_grad_(i in diff) for i, x in enumerate(args)]
    mem_b, _last_b, mbar_b = ref.flush_ref(*b)
    want = torch.autograd.grad((mem_b, mbar_b), [b[i] for i in diff],
                               (g_mem, g_mbar))
    fwd = tflush.flush_fwd_ref(*(x.clone() for x in args))
    _close(fwd[0].numpy(), mem_b.detach().numpy(), 0.0)
    _close(fwd[2].numpy(), mbar_b.detach().numpy(), 0.0)
    np.testing.assert_array_equal(fwd[4].numpy(),
                                  tflush.first_rows(_t(ids), n).numpy())
    got = tflush.flush_bwd_rows(g_mem, g_mbar, _t(ids), fwd[2], fwd[3],
                                fwd[4], *args[5:], n_dump=n)
    for x, y in zip(got, want):
        _close(x.numpy(), y.numpy(), 1e-10)


def _gather_kernel_mean(ids, msg, n_dump, threads=256):
    """A plain emulation of the mean of ``csrc/fused_flush.cu``'s launch A
    (``flush_gather_kernel`` / ``mean_columns``, ``GATHER_THREADS`` =
    256): the k-th of an id's cnt rows owns columns [k dm / cnt, (k + 1)
    dm / cnt); below 256 of them, 256 // w row groups sum strided rows in
    float32, and the partials are added in group order."""
    r, dm = msg.shape
    mbar = np.full((r, dm), np.nan, np.float32)
    for i in range(r):
        if ids[i] >= n_dump:
            mbar[i] = 0.0
            continue
        rows = np.flatnonzero(ids == ids[i])
        cnt, k = len(rows), int(np.flatnonzero(rows == i)[0])
        c0, c1 = k * dm // cnt, (k + 1) * dm // cnt
        w, inv = c1 - c0, np.float32(1.0 / cnt)
        if w == 0:
            continue
        groups = max(1, threads // w)
        part = np.zeros((groups, w), np.float32)
        for g in range(groups):
            for m in rows[g::groups]:
                part[g] += msg[m, c0:c1]
        total = np.zeros(w, np.float32)
        for g in range(groups):
            total += part[g]
        mbar[rows, c0:c1] = total * inv
    return mbar


@pytest.mark.parametrize("n_ids,r,dm", [(3, 60, 616), (30, 37, 616),
                                        (2, 100, 10), (400, 5, 616)])
def test_flush_gather_column_split_is_segment_mean(n_ids, r, dm):
    """Launch A's schedule covers every column of every row once and
    gives the segment mean to float32 precision, with ids heavier than
    the row has columns (cnt > dm), ids on one row, and padding."""
    rng = np.random.default_rng(n_ids)
    n = 500
    ids = np.where(rng.uniform(size=r) < 0.9, rng.integers(0, n_ids, r), n)
    msg = rng.normal(size=(r, dm)).astype(np.float32)
    got = _gather_kernel_mean(ids, msg, n)
    want = ref.segment_mean(_t(ids), _t(msg), n).numpy()
    assert not np.isnan(got).any()
    _close(got, want)


def test_flush_backward_allocates_no_table_of_n_rows(monkeypatch):
    """Neither what ``FusedFlush`` saves nor any tensor its backward makes
    has N + 1 rows (counted at dispatch); autograd of ``flush_ref`` makes
    several, which shows the count sees them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    self.seen.append((str(func), tuple(o.shape)))
            return out

    _inplace_flush(monkeypatch)
    rng = np.random.default_rng(9)
    r, n, dm, d = 24, 1000, 10, 6
    f = lambda *s: _t(rng.normal(size=s).astype(np.float32))  # noqa: E731
    mem, last = f(n + 1, d), f(n + 1).abs()
    mem[n], last[n] = 0.0, 0.0
    ids = _t(rng.integers(0, 30, r).astype(np.int32))
    args = [ids, f(r, dm), f(r).abs() + 1.0, mem, last, f(dm, 3 * d),
            f(d, 3 * d), f(3 * d), f(3 * d)]
    cot = (f(n + 1, d), f(r, dm))

    def backward_shapes(fn):
        diff = (1, 5, 6, 7, 8)
        xs = [x.clone().requires_grad_(i in diff) for i, x in enumerate(args)]
        outs = fn(*xs)
        saved = [t.shape for t in getattr(outs[0].grad_fn,
                                          "saved_tensors", ())]
        with Shapes() as mode:
            torch.autograd.grad((outs[0], outs[2]), [xs[i] for i in diff],
                                cot)
        return saved, [s for _, s in mode.seen if n + 1 in s]

    saved, big = backward_shapes(tflush.FusedFlush.apply)
    assert big == []
    assert len(saved) == 8 and all(n + 1 not in s for s in saved)
    _, big_ref = backward_shapes(ref.flush_ref)
    assert len(big_ref) >= 2


# ------------------------------------------------------------ attention

def _attn_case():
    rng = np.random.default_rng(4)
    b, k, h, d = 12, 5, 2, 8
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    mask = rng.uniform(size=(b, k)) < 0.6
    mask[0] = False                              # a row with no neighbor
    mask[1] = True
    return f(b, h, d), f(b, k, h, d), f(b, k, h, d), mask, f(b, h, d)


def test_temporal_attention_ref_forward_matches_jax():
    q, k, v, mask, _ = _attn_case()
    got = ref.temporal_attention_ref(_t(q), _t(k), _t(v), _t(mask))
    jargs = tuple(map(jnp.asarray, (q, k, v, mask)))
    _close(got.numpy(), jref.temporal_attention_ref(*jargs))
    _close(got.numpy(), temporal_attn(*jargs, block_b=4, interpret=True))
    assert float(got[0].abs().max()) == 0.0


def test_temporal_attention_ref_backward_matches_jax():
    q, k, v, mask, g = _attn_case()
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(
        ref.temporal_attention_ref(*xs, _t(mask)), xs, _t(g))
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: jref.temporal_attention_ref(a, b, c, jm),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    kern = temporal_attn_bwd(*map(jnp.asarray, (g, q, k, v, mask)),
                             block_b=4, interpret=True)
    for x, w, kn in zip(got, want, kern):
        _close(x.numpy(), w)
        _close(x.numpy(), kn)


def _fma(a, b, c):
    """float32 ``fmaf``: one rounding of a * b + c (the product of two
    float32 values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(parts):
    """Lane partials (..., n) combined by the xor butterfly of the
    kernels' shuffles (offsets n / 2, ..., 1); lane 0's sum."""
    idx = torch.arange(parts.shape[-1])
    off = parts.shape[-1] // 2
    while off:
        parts = parts + parts[..., idx ^ off]
        off //= 2
    return parts[..., 0]


def _split_dot(x, y):
    """(B, H, D) . (B, K, H, D) -> (B, K, H) as the kernels take it: lane
    l of a group of GROUP sums columns l, l + GROUP, ... by FMA, then the
    butterfly over the group."""
    from repro_torch.kernels.temporal_attn import GROUP

    lanes = []
    for lane in range(GROUP):
        p = torch.zeros(y.shape[:3])
        for c in range(lane, x.shape[-1], GROUP):
            p = _fma(x[:, None, :, c], y[..., c], p)
        lanes.append(p)
    return _butterfly(torch.stack(lanes, -1))


def _lane_sums(x, ok, by=None):
    """Per-head sums over the valid slots as one warp takes them: the
    valid slots listed in order, entry i on lane i % 32 (added in order,
    or by FMA with ``by``), then the butterfly. x, by: (B, K, H); ok:
    (B, K) -> (B, H)."""
    b, kn, h = x.shape
    rank = ok.long().cumsum(1) - 1
    parts = torch.zeros(b, h, 32)
    for j in range(kn):
        lane = (rank[:, j] % 32).clamp_min(0)[:, None, None].expand(b, h, 1)
        cur = parts.gather(-1, lane)[..., 0]
        new = cur + x[:, j] if by is None else _fma(x[:, j], by[:, j], cur)
        parts = parts.scatter(-1, lane,
                              torch.where(ok[:, j, None], new, cur)[..., None])
    return _butterfly(parts)


def _attn_kernel_order(q, k, v, mask, g=None, ks=None, drop=None):
    """A float32 emulation of the arithmetic order of the kernels in
    ``csrc/temporal_attn.cu``: ``out`` (``g`` None) or ``(dq, dk, dv)``.
    Slots go in slices of ``ks`` (all K when None): an online softmax in
    the forward; in the backward a pass for the statistics, then the
    gradients from the last slice to the first. ``drop``: a row whose last
    valid slot is passed over (a faulty kernel)."""
    b, kn, h, d = k.shape
    ok = mask.clone()
    if drop is not None:
        ok[drop, int(torch.nonzero(mask[drop])[-1])] = False
    ks = ks or kn
    slices = [(j0, min(j0 + ks, kn)) for j0 in range(0, kn, ks)]
    multi, bwd = len(slices) > 1, g is not None
    rs = torch.sqrt(torch.tensor(float(d)))
    scale = 1.0 / rs
    m = torch.full((b, h), -torch.inf)
    lsum, tsum = torch.zeros(b, h), torch.zeros(b, h)

    def scores(j0, j1):
        sc = _split_dot(q, k[:, j0:j1])
        return (sc * scale, _split_dot(g, v[:, j0:j1])) if bwd else (
            sc / rs, None)

    def stats(sc, da, okj, m, lsum, tsum):
        m_new = torch.maximum(m, torch.where(okj[..., None], sc,
                                             -torch.inf).amax(1))
        alpha = torch.where(m == -torch.inf, 0.0, torch.exp(m - m_new))
        p = torch.where(okj[..., None], torch.exp(sc - m_new[:, None]), 0.0)
        lsum = lsum * alpha + _lane_sums(p, okj)
        if bwd:
            tsum = tsum * alpha + _lane_sums(p, okj, da)
        return p, m_new, lsum, tsum, alpha

    if not bwd:
        acc = torch.zeros(b, h, d)
        for j0, j1 in slices:
            okj = ok[:, j0:j1]
            sc, _ = scores(j0, j1)
            p, m, lsum, _, alpha = stats(sc, None, okj, m, lsum, tsum)
            w = p if multi else p / lsum[:, None]
            if multi:
                acc = acc * alpha[..., None]
            for j in range(j1 - j0):
                acc = torch.where(okj[:, j, None, None],
                                  _fma(w[:, j, :, None], v[:, j0 + j], acc),
                                  acc)
        if multi:
            acc = torch.where(lsum[..., None] > 0, acc / lsum[..., None], 0.0)
        return acc
    for j0, j1 in slices:                      # pass 1: the statistics
        sc, da = scores(j0, j1)
        p, m, lsum, tsum, _ = stats(sc, da, ok[:, j0:j1], m, lsum, tsum)
    tot = torch.where(lsum > 0, tsum / lsum, 0.0)
    dq = torch.zeros(b, h, d)
    dk, dv = torch.zeros(b, kn, h, d), torch.zeros(b, kn, h, d)
    for i in reversed(range(len(slices))):     # pass 2: the gradients
        j0, j1 = slices[i]
        okj = ok[:, j0:j1, None]
        if i != len(slices) - 1:               # the last slice kept its p
            sc, da = scores(j0, j1)
            p = torch.exp(sc - m[:, None])
        att = p / lsum[:, None]
        ds = att * (da - tot[:, None]) * scale
        for j in range(j1 - j0):
            dq = torch.where(okj[:, j, :, None],
                             _fma(ds[:, j, :, None], k[:, j0 + j], dq), dq)
        dk[:, j0:j1] = torch.where(okj[..., None], ds[..., None] * q[:, None],
                                   0.0)
        dv[:, j0:j1] = torch.where(okj[..., None],
                                   att[..., None] * g[:, None], 0.0)
    return dq, dk, dv


def _attn_path_case(b, kn, h, d, seed):
    """Inputs like the TGN path's: a row's valid slots are a suffix of
    its K (the sampler front-pads), an eighth of the rows have none, one
    row has all, one row's mask is not a suffix."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    cnt = rng.integers(0, kn + 1, b)
    cnt[:b // 8] = 0
    cnt[b // 8] = kn
    mask = np.arange(kn)[None, :] >= (kn - cnt)[:, None]
    mask[b // 8 + 1] = rng.uniform(size=kn) < 0.5
    return f(b, h, d), f(b, kn, h, d), f(b, kn, h, d), mask, f(b, h, d)


@pytest.mark.parametrize("b,kn,h,d,ks", [
    (600, 10, 2, 86, None),     # the TGN path's shape
    (600, 1, 2, 86, None),
    (600, 32, 2, 86, None),
    (40, 10, 3, 7, 3),          # slices of 3 slots: online softmax
])
@pytest.mark.parametrize("drop", [False, True])
def test_attn_kernel_order_matches_plain(b, kn, h, d, ks, drop):
    """The kernels' arithmetic order in float32 (split dot products in the
    shuffle order, per-head softmax across lanes, ds) agrees with the
    plain version and its autograd in float64 within TOL, forward and
    backward, with exact zeros for a row without neighbors; passing over
    one row's last valid slot breaks the agreement."""
    q, k, v, mask, g = map(_t, _attn_path_case(b, kn, h, d, seed=kn + d))
    row = int(torch.nonzero(mask.any(-1))[0]) if drop else None
    out = _attn_kernel_order(q, k, v, mask, ks=ks, drop=row)
    grads = _attn_kernel_order(q, k, v, mask, g=g, ks=ks, drop=row)
    xs = [x.double().requires_grad_() for x in (q, k, v)]
    want = ref.temporal_attention_ref(*xs, mask)
    want_g = torch.autograd.grad(want, xs, g.double())
    err_f = float((out.double() - want.detach()).abs().max())
    err_b = max(float((x.double() - w).abs().max())
                for x, w in zip(grads, want_g))
    if drop:
        assert err_f > TOL and err_b > TOL, (err_f, err_b)
        return
    assert err_f <= TOL and err_b <= TOL, (err_f, err_b)
    none = ~mask.any(-1)
    assert none.any()
    for x in (out, *grads):
        assert float(x[none].abs().max()) == 0.0


# ------------------------------------------------------------- dispatch

def test_ops_take_the_plain_version_on_cpu():
    counts = {name: kern.launches for name, kern in KERNELS.items()}
    q, k, v, mask, _ = _attn_case()
    out = ops.temporal_attention(_t(q), _t(k), _t(v), _t(mask))
    torch.testing.assert_close(out, ref.temporal_attention_ref(
        _t(q), _t(k), _t(v), _t(mask)), rtol=0, atol=0)
    args = list(map(_t, _flush_case()))
    for x, y in zip(ops.fused_flush(*args), ref.flush_ref(*args)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    tidx, _, batch_of, kk = _tcsr_case()
    tcsr = {key: _t(v) for key, v in tidx.device_export().items()}
    nodes = torch.arange(tidx.num_nodes, dtype=torch.int32)
    got = ops.neighbor_sample(tcsr, nodes, _t(batch_of), kk)
    want = ref.sample_ref(tcsr["indptr"], tcsr["nbr"], tcsr["t"],
                          tcsr["eidx"], tcsr["bat"], nodes, _t(batch_of), kk)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    roles = (nodes[:10], nodes[10:20] - 15, nodes[20:],
             torch.arange(10) % 3 > 0, 4, kk)
    got = ops.sample_roles(tcsr, *roles)
    want = ref.sample_roles_ref(tcsr["indptr"], tcsr["nbr"], tcsr["t"],
                                tcsr["eidx"], tcsr["bat"], *roles)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert {n: kern.launches for n, kern in KERNELS.items()} == counts


def test_kernel_wrappers_refuse_cpu_tensors():
    tidx, _, batch_of, k = _tcsr_case()
    ex = {key: _t(v) for key, v in tidx.device_export().items()}
    with pytest.raises(ValueError, match="CUDA"):
        torch_sample_fwd(ex["indptr"], ex["nbr"], ex["t"], ex["eidx"],
                         ex["bat"], torch.zeros(3, dtype=torch.int32), 0, k)
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sample_roles_fwd(ex["indptr"], ex["nbr"], ex["t"], ex["eidx"],
                         ex["bat"], ids, ids, ids,
                         torch.ones(3, dtype=torch.bool), 0, k)
    with pytest.raises(ValueError, match="CUDA"):
        tflush.fused_flush_fwd(*map(_t, _flush_case()))



# ------------------------------------------------------------------ GRU

def _gru_case(seed, b, d_in, d_h):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return ([f(b, d_in), f(b, d_h), f(d_in, 3 * d_h, scale=d_in ** -0.5),
             f(d_h, 3 * d_h, scale=d_h ** -0.5), f(3 * d_h, scale=0.1),
             f(3 * d_h, scale=0.1)], f(b, d_h))


# 130 rows: the Pallas kernels' second row block of 128 is ragged
GRU_SHAPES = [(37, 24, 16), (130, 20, 12)]


@pytest.mark.parametrize("b,d_in,d_h", GRU_SHAPES)
def test_gru_forward_matches_jax(b, d_in, d_h):
    args, _ = _gru_case(b, b, d_in, d_h)
    before = KERNELS["fused_gru"].launches
    got = ops.gru(*map(_t, args))
    assert KERNELS["fused_gru"].launches == before     # CPU: plain version
    jargs = list(map(jnp.asarray, args))
    _close(got.numpy(), jref.gru_ref(*jargs))
    _close(got.numpy(), jops.gru(*jargs, backend="interpret"))


@pytest.mark.parametrize("b,d_in,d_h", GRU_SHAPES)
def test_gru_grads_match_jax(b, d_in, d_h):
    """All six grads against the Pallas backward kernel in interpret mode
    (through the JAX op's custom VJP) and against JAX autodiff of the
    oracle; the port's plain backward is autograd through ``gru_ref``."""
    args, g = _gru_case(b + 1, b, d_in, d_h)
    ts = [_t(a).requires_grad_() for a in args]
    got = torch.autograd.grad(ops.gru(*ts), ts, _t(g))
    plain = ref.gru_bwd_ref(_t(g), *map(_t, args))
    for fn in (lambda *a: jops.gru(*a, backend="interpret", bwd="fused"),
               jref.gru_ref):
        _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
        want = vjp(jnp.asarray(g))
        for x, w, p in zip(got, want, plain):
            assert x.shape == p.shape
            _close(x.numpy(), w)
            _close(x.numpy(), p.numpy(), 0.0)


def _tf32(t):
    """Float32 rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero as ``cvt.rna.tf32.f32`` rounds, on the bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(t):
    """Float32 with the 13 low mantissa bits cleared: how the tensor cores
    read a tf32 operand."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a b as the GRU kernels form it: each operand split once into tf32
    parts, hi rounded to nearest and lo = a - hi, which the tensor cores
    read truncated to tf32; a_lo b_lo dropped; float32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_truncated(a - ah), _tf32_truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    """a b with both operands rounded once to tf32 (one tensor-core pass)."""
    return _tf32(a) @ _tf32(b)


def _gru_kernel_math(mm, g, x, h, wx, wh, bx, bh):
    """The GRU kernels' forward and backward with every product through
    ``mm``: h' and (dx, dh, dwx, dwh, dbx, dbh), the gates recomputed, the
    bias grads as a row of ones times the gate grads."""
    d = h.shape[1]
    gx, gh = mm(x, wx) + bx, mm(h, wh) + bh
    r = torch.sigmoid(gx[:, :d] + gh[:, :d])
    z = torch.sigmoid(gx[:, d:2 * d] + gh[:, d:2 * d])
    nh = gh[:, 2 * d:]
    n = torch.tanh(gx[:, 2 * d:] + r * nh)
    dn = g * (1.0 - z) * (1.0 - n * n)
    dr = dn * nh * r * (1.0 - r)
    dz = g * (h - n) * z * (1.0 - z)
    dgx = torch.cat([dr, dz, dn], 1)
    dgh = torch.cat([dr, dz, dn * r], 1)
    ones = torch.ones((1, x.shape[0]))
    return ((1.0 - z) * n + z * h,
            (mm(dgx, wx.T), g * z + mm(dgh, wh.T), mm(x.T, dgx),
             mm(h.T, dgh), mm(ones, dgx)[0], mm(ones, dgh)[0]))


@pytest.mark.parametrize("scheme", ["3xtf32", "tf32"])
@pytest.mark.parametrize("b,d_in,d_h", [(400, 616, 172), (37, 24, 16)])
def test_gru_tensor_core_scheme_keeps_float32_parity(b, d_in, d_h, scheme):
    """The card's GRU kernels multiply by 3xTF32 on the tensor cores. Its
    emulation here agrees with ``gru_ref`` in float64 within the limits
    the card's checks hold the kernels to (1e-5 forward, 1e-5 of each
    grad's largest magnitude); one tf32 pass, the control, does not."""
    args, g = _gru_case(b + 2, b, d_in, d_h)
    mm = _mm_3xtf32 if scheme == "3xtf32" else _mm_tf32
    out, grads = _gru_kernel_math(mm, _t(g), *map(_t, args))
    f64 = [_t(a).double() for a in args]
    want = ref.gru_ref(*f64)
    want_grads = ref.gru_bwd_ref(_t(g).double(), *f64)
    fwd_ok = float((out.double() - want).abs().max()) <= TOL
    grads_ok = all(
        float((x.double() - w).abs().max())
        <= TOL * max(1.0, float(w.abs().max()))
        for x, w in zip(grads, want_grads))
    if scheme == "3xtf32":
        assert fwd_ok and grads_ok
    else:
        assert not fwd_ok and not grads_ok


def test_fused_gru_function_runs_both_kernels(monkeypatch):
    """The autograd.Function around the GRU kernels saves the inputs and
    hands the cotangent to the backward kernel. On the CPU the kernels are
    stood in by their plain versions, so the glue is what is tested."""
    calls = []

    def fwd(*a):
        calls.append("fwd")
        return ref.gru_ref(*a).detach()

    def bwd(g, *a):
        calls.append("bwd")
        return ref.gru_bwd_ref(g, *a)

    monkeypatch.setattr(tgru, "fused_gru_fwd", fwd)
    monkeypatch.setattr(tgru, "fused_gru_bwd", bwd)
    args, g = _gru_case(5, 9, 7, 5)
    a = [_t(x).requires_grad_() for x in args]
    b = [_t(x).requires_grad_() for x in args]
    out = tgru.FusedGRU.apply(*a)
    want = ref.gru_ref(*b)
    _close(out.detach().numpy(), want.detach().numpy(), 0.0)
    for x, y in zip(torch.autograd.grad(out, a, _t(g)),
                    torch.autograd.grad(want, b, _t(g))):
        _close(x.numpy(), y.numpy(), 0.0)
    assert calls == ["fwd", "bwd"]


# ---------------------------------------------------- flash attention

def _fa_case(seed, b, h, s, d, hkv=None):
    """(B, H, S, D) q and (B, Hkv, S, D) k, v (Hkv = H by default)."""
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None), (False, 16)])
@pytest.mark.parametrize("s", [48, 40])
def test_flash_attention_ref_matches_jax(s, causal, window):
    """The plain version against JAX's dense oracle and, where S is a
    multiple of its 16-row blocks (the Pallas kernel leaves keys past S
    unmasked), the Pallas kernel in interpret mode, with its out-of-window
    key blocks skipped."""
    q, k, v = _fa_case(s, 2, 3, s, 16)
    got = ref.flash_attention_ref(*map(_t, (q, k, v)), causal=causal,
                                  window=window)
    jargs = list(map(jnp.asarray, (q, k, v)))
    _close(got.numpy(), jref.flash_attention_ref(*jargs, causal=causal,
                                                 window=window))
    if s % 16 == 0:
        _close(got.numpy(), flash_attention(
            *jargs, causal=causal, window=window, block_q=16, block_k=16,
            interpret=True))


@pytest.mark.parametrize("window", [None, 20])
def test_flash_attention_op_takes_gqa_in_the_model_layout(window):
    """``ops.flash_attention`` on (B, S, H, D) q and (B, S, Hkv, D) k, v:
    the JAX model's ``chunked_attention`` (kv-major GQA) gives the same."""
    q, k, v = (x.transpose(0, 2, 1, 3) for x in _fa_case(7, 2, 6, 48, 16,
                                                         hkv=2))
    before = KERNELS["flash_attention"].launches
    got = ops.flash_attention(*map(_t, (q, k, v)), causal=True,
                              window=window)
    assert KERNELS["flash_attention"].launches == before   # CPU: plain
    assert got.shape == q.shape
    want = chunked_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                             window=window, chunk=16)
    _close(got.numpy(), want)


def _fa_kernel_schedule(q, k, v, causal, window, drop_edge=False,
                        mask_at_sq=False):
    """The bf16 flash kernel's loop, in plain PyTorch on (B, H, Sq, D)
    float32 q and (B, H, Sk, D) K / V already repeated to H heads: query
    tiles of ``BLOCK_Q``, each over the key tiles of ``BLOCK_KV[D]`` from
    the one holding its first query's window start to its last key (the
    last of all Sk without causality), keys past Sk zero-filled and
    masked; a running max from -1e30, masked scores -inf, P split into
    hi + lo bf16 parts for P V, float32 sums, the output rounded to bf16.
    ``drop_edge``: a faulty schedule that passes over the key tile at each
    query tile's window edge; ``mask_at_sq``: one that masks keys past Sq
    in place of Sk."""
    from repro_torch.kernels.flash_attention import BLOCK_KV, BLOCK_Q

    s, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    block_kv = BLOCK_KV[d]
    scale = 1.0 / np.sqrt(d)
    # zero-filled to whole tiles past both lengths, as TMA fills
    pad = -(-max(s, sk) // block_kv) * block_kv - sk
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k, v))
    key_lim = s if mask_at_sq else sk
    out = torch.zeros_like(q)
    for q0 in range(0, s, BLOCK_Q):
        rows = torch.arange(q0, min(q0 + BLOCK_Q, s))[:, None]
        k_end = min(q0 + BLOCK_Q, sk) if causal else sk
        k_begin = max(0, q0 - window + 1) if window else 0
        t_begin, t_end = k_begin // block_kv, -(-k_end // block_kv)
        m = torch.full(q.shape[:2] + (len(rows), 1), -1e30)
        lsum = torch.zeros_like(m)
        acc = torch.zeros(q.shape[:2] + (len(rows), d))
        for t in range(t_begin, t_end):
            if drop_edge and window and q0 >= window and t == t_begin:
                continue
            keys = torch.arange(t * block_kv, (t + 1) * block_kv)
            sc = q[..., rows[:, 0], :] @ k[..., keys, :].transpose(-1, -2)
            ok = (keys < key_lim)[None, :].expand(len(rows), -1).clone()
            if causal:
                ok &= keys[None, :] <= rows
            if window:
                ok &= keys[None, :] > rows - window
            sc = (sc * scale).masked_fill(~ok, -torch.inf)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            corr, p = torch.exp(m - m_new), torch.exp(sc - m_new)
            hi = p.bfloat16().float()
            lo = (p - hi).bfloat16().float()
            vt = v[..., keys, :]
            acc = acc * corr + (hi @ vt + lo @ vt)
            lsum = lsum * corr + p.sum(-1, keepdim=True)
            m = m_new
        out[..., rows[:, 0], :] = acc / lsum.clamp_min(1e-30)
    return out.bfloat16().float()


@pytest.mark.parametrize("s,h,hkv,d,causal,window,drop_edge", [
    (17, 2, 2, 32, True, None, False),      # within one tile
    (333, 4, 2, 32, True, None, False),     # diagonal inside tiles, ragged
    (300, 4, 2, 32, True, 100, False),      # window edge inside tiles
    (300, 4, 2, 32, True, 1, False),        # window 1
    (257, 4, 1, 32, False, 200, False),     # a window without causality
    (300, 4, 2, 128, True, 128, False),
    (300, 2, 2, 256, True, 100, False),     # 64-key tiles at D 256
    (300, 5, 1, 64, True, 100, False),
    (300, 4, 2, 32, True, 100, True),       # faulty: edge tile passed over
    (300, 4, 2, 128, True, 128, True),
    (257, 4, 1, 32, False, 200, True),
    (300, 2, 2, 256, True, 100, True)])
def test_flash_kernel_tile_schedule_matches_plain(s, h, hkv, d, causal,
                                                  window, drop_edge):
    """An emulation of the bf16 kernel's tile schedule agrees with the
    plain version (float32 inside, compared in float64) within the card's
    bf16 limit, 2^-8 |plain| + 2^-14 |P| |V|, at ragged shapes with causal
    and window edges inside tiles; the schedule that drops the window-edge
    key tile does not."""
    q, k, v = (_t(x).bfloat16().float()
               for x in _fa_case(s + d, 1, h, s, d, hkv=hkv))
    k, v = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
    got = _fa_kernel_schedule(q, k, v, causal, window, drop_edge)
    att = ref.flash_attention_probs(q, k, causal=causal, window=window)
    want = (att @ v).double()
    lim = 2 ** -8 * want.abs() + 2 ** -14 * (att @ v.abs()).double()
    ratio = float(((got.double() - want).abs() / lim).max())
    assert (ratio <= 1.0) == (not drop_edge), ratio


@pytest.mark.parametrize("sq,sk,h,hkv,d,mask_at_sq", [
    (130, 300, 4, 4, 64, False),     # cross-attention: fewer queries
    (300, 75, 4, 2, 32, False),      # more queries than keys
    (1, 257, 2, 2, 256, False),      # one query, 64-key tiles
    (77, 333, 3, 1, 128, False),     # odd group: unpaired blocks
    (130, 300, 4, 4, 64, True),      # faulty: keys masked at Sq
    (77, 333, 3, 1, 128, True)])
def test_flash_kernel_tile_schedule_at_a_key_length(sq, sk, h, hkv, d,
                                                    mask_at_sq):
    """The emulated schedule, non-causal with Sk keys of its own (the
    kernel's key length), agrees with the plain version within the bf16
    limit; the one that masks keys at the query length does not."""
    rng = np.random.default_rng(sq * sk)
    q = _t(rng.standard_normal((1, h, sq, d)).astype(np.float32))
    k, v = (_t(rng.standard_normal((1, hkv, sk, d)).astype(
        np.float32)).bfloat16().float().repeat_interleave(h // hkv, dim=1)
        for _ in range(2))
    q = q.bfloat16().float()
    got = _fa_kernel_schedule(q, k, v, False, None, mask_at_sq=mask_at_sq)
    att = ref.flash_attention_probs(q, k, causal=False)
    want = (att @ v).double()
    lim = 2 ** -8 * want.abs() + 2 ** -14 * (att @ v.abs()).double()
    ratio = float(((got.double() - want).abs() / lim).max())
    assert (ratio <= 1.0) == (not mask_at_sq), ratio


def test_gru_and_flash_wrappers_refuse_cpu_tensors():
    args, g = _gru_case(0, 4, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tgru.fused_gru_fwd(*map(_t, args))
    with pytest.raises(ValueError, match="CUDA"):
        tgru.fused_gru_bwd(_t(g), *map(_t, args))
    q, k, v = (_t(x.transpose(0, 2, 1, 3).copy())
               for x in _fa_case(0, 1, 4, 8, 32, hkv=2))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(*(x[..., :24].bfloat16() for x in (q, k, v)))
