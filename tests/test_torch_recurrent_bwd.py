"""The plain backwards of the port's two recurrences, the versions the
backward kernels (``csrc/rwkv6_scan_bwd.cu``, ``csrc/selective_scan_bwd.cu``)
are held to on the card: ``ref.rwkv6_bwd_ref`` against autograd of
``ref.rwkv6_ref`` and against ``jax.vjp`` of the JAX package's WKV, and
``ref.selective_scan_bwd_ref`` against autograd of
``ref.selective_scan_ref``. Then the kernels' own algebra in plain
PyTorch: ``ref.rwkv6_bwd_chunked_ref`` (64-token chunks, sub-chunk edge
states, every decay a product of w) against ``rwkv6_bwd_ref`` and
``jax.vjp`` at trained and strong decays, ragged S, with a state and a
final cotangent; ``ref.selective_scan_bwd_scanned_ref`` (runs of 16
tokens composed into 128-token chunks) against ``selective_scan_bwd_ref``
and autograd; and the faulty versions the card's checks use at the new
seams (the sub-chunk products dropped, the carry between runs dropped),
which must miss the limit. Inputs from numpy, small shapes.

Tolerances:
- float32: every gradient within 1e-5 of its largest |autograd| (the
  same float32 states, sums over the state in another order).
- WKV against ``jax.vjp``: 1e-4 of the largest (JAX's chunked XLA path
  forms its decays as exponentials of summed logarithms, another
  rounding of the same function; its token scan, 1e-5).
- bf16 WKV: 1e-5 of the largest plus one bf16 unit (2^-7) of each
  element: both sides round the same float32 gradient of r, k, v once.
- bf16 selective scan: db, dc, da and the state's gradient as float32
  (both round db and dc once); dx and ddt within 2^-6 of their largest:
  autograd through the bf16 forward rounds du (the gradient of dt x) to
  bf16, then du dt, du x and ddt's sum, up to three roundings of 2^-8
  where the plain backward forms them in float32 and rounds once
  (measured at most 5.0e-3).
- The kernels' algebra against the plain versions: 1e-5 of each
  gradient's largest (the same function, its sums in another order), plus
  one bf16 unit of each element for the gradients both sides return in
  bf16; against ``jax.vjp`` of the token scan, 1e-5; against autograd of
  the scan, as the plain backward above.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tests: the suite runs in
    several worker processes at once, and a torch that takes every core
    in each of them makes the workers contend for the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REL = 1e-5
BF16_UNIT = 2.0 ** -7
SCAN_BF16_DX_REL = 2.0 ** -6


def _close_rel(got, want, rel, what, unit=0.0):
    got = got.detach().double()
    want = want.detach().double()
    lim = rel * float(want.abs().max()) + unit * want.abs()
    err = (got - want).abs()
    assert bool((err <= lim).all()), (
        f"{what}: max |diff| {float(err.max()):.3g}, largest "
        f"{float(want.abs().max()):.3g}")


def _wkv_inputs(seed, b, h, s, *, strong=False, state=False, d=64):
    """Decays as ``tests/test_torch_rwkv.py`` draws them: trained (~0.7
    to 1) or strong, w = exp(-exp(N(1.5, 0.5)))."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (0.3 * rng.standard_normal((b, h, s, d)) for _ in range(4))
    w = np.exp(-np.exp(rng.normal(1.5, 0.5, (b, h, s, d)) if strong else
                       rng.standard_normal((b, h, s, d)) * 0.5 - 2.0))
    u = 0.5 * rng.standard_normal((h, d))
    st = 0.3 * rng.standard_normal((b, h, d, d)) if state else None
    dst = rng.standard_normal((b, h, d, d)) if state else None
    f32 = lambda x: None if x is None else x.astype(np.float32)  # noqa: E731
    return [f32(x) for x in (r, k, v, w, u, do)], f32(st), f32(dst)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _wkv_autograd(r, k, v, w, u, do, st, dst):
    leaves = [x.clone().requires_grad_(True)
              for x in (r, k, v, w, u) + (() if st is None else (st,))]
    o, s_out = ref.rwkv6_ref(*leaves[:5], state=leaves[5] if st is not None
                             else None, return_state=True)
    outs, cots = [o], [do.to(o.dtype)]
    if dst is not None:
        outs.append(s_out)
        cots.append(dst)
    return torch.autograd.grad(outs, leaves, cots)


WKV_CASES = {   # (B, H, S, strong decays, state and final cotangent, dtype)
    "trained": (2, 2, 96, False, False, torch.float32),
    "strong decays": (1, 2, 128, True, False, torch.float32),
    "state, final cotangent": (2, 2, 64, False, True, torch.float32),
    "ragged S": (1, 2, 100, False, True, torch.float32),
    "strong, ragged, state": (1, 2, 77, True, True, torch.float32),
    "bf16": (2, 2, 96, False, True, torch.bfloat16),
}


@pytest.mark.parametrize("case", list(WKV_CASES))
def test_wkv_plain_backward_matches_autograd(case):
    b, h, s, strong, state, dtype = WKV_CASES[case]
    (r, k, v, w, u, do), st, dst = (
        lambda a: ([_t(x) for x in a[0]], _t(a[1]), _t(a[2])))(
            _wkv_inputs(len(case) + s, b, h, s, strong=strong, state=state))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    if strong and s % 64 == 0:
        # where the plain chunked form (the TPU kernel's algebra) overflows
        assert not torch.isfinite(ref.rwkv6_chunked_ref(
            r, k, v, w, u, state=st)).all()
    want = _wkv_autograd(r, k, v, w, u, do, st, dst)
    got = ref.rwkv6_bwd_ref(r, k, v, w, u, do, state=st, dstate=dst)
    assert (got[5] is None) == (st is None)
    names = ("dr", "dk", "dv", "dw", "du", "dstate0")
    for name, g, wnt in zip(names, got, want):
        assert g.shape == wnt.shape and g.dtype == wnt.dtype, name
        unit = BF16_UNIT if g.dtype == torch.bfloat16 else 0.0
        _close_rel(g, wnt, REL, f"{case} {name}", unit)
        assert bool(torch.isfinite(g).all()), name


@pytest.mark.parametrize("form", ["scan", "chunked_xla"])
@pytest.mark.parametrize("state", [False, True])
def test_wkv_plain_backward_matches_jax_vjp(form, state):
    """At trained decays, against ``jax.vjp`` of the JAX package's token
    scan and of its chunked XLA path (the function it trains through)."""
    (r, k, v, w, u, do), st, dst = _wkv_inputs(3, 1, 2, 128, state=state)
    fn = jref.rwkv6_ref if form == "scan" else jref.rwkv6_chunked_xla
    prim = [jnp.asarray(x) for x in (r, k, v, w, u)] + (
        [jnp.asarray(st)] if state else [])

    def f(*a):
        return fn(*a[:5], state=a[5] if state else None, return_state=True)

    _, vjp = jax.vjp(f, *prim)
    want = vjp((jnp.asarray(do), jnp.asarray(dst) if state else
                jnp.zeros((1, 2, 64, 64), jnp.float32)))
    got = ref.rwkv6_bwd_ref(*(_t(x) for x in (r, k, v, w, u, do)),
                            state=_t(st), dstate=_t(dst))
    rel = REL if form == "scan" else 1e-4
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                            want):
        _close_rel(g, torch.from_numpy(np.array(wnt)), rel,
                   f"{form} {name}")


def _scan_inputs(seed, b, s, di, n, dtype, state):
    """The hymba path's ranges: dt a softplus output ~0.01-1, a = -(1..n)
    scaled, x, b, c of order 1."""
    rng = np.random.default_rng(seed)
    x, dy = (rng.standard_normal((b, s, di)) for _ in range(2))
    dt = np.log1p(np.exp(rng.normal(-2.0, 1.0, (b, s, di))))
    bm, cm = (rng.standard_normal((b, s, n)) for _ in range(2))
    a = -np.tile(np.arange(1, n + 1), (di, 1)) * rng.uniform(0.5, 1.5,
                                                             (di, n))
    h0 = rng.standard_normal((b, di, n)) if state else None
    dh = rng.standard_normal((b, di, n)) if state else None
    t = lambda z: None if z is None else torch.from_numpy(  # noqa: E731
        z.astype(np.float32))
    x, dt, bm, cm, dy = (t(z).to(dtype) for z in (x, dt, bm, cm, dy))
    return x, dt, bm, cm, t(a), dy, t(h0), t(dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("s", [40, 128])
def test_scan_plain_backward_matches_autograd(s, state, dtype):
    x, dt, bm, cm, a, dy, h0, dh = _scan_inputs(s, 2, s, 24, 8, dtype,
                                                state)
    leaves = [z.clone().requires_grad_(True) for z in (x, dt, bm, cm, a)
              + (() if h0 is None else (h0,))]
    y, h = ref.selective_scan_ref(*leaves[:5], state=leaves[5] if state
                                  else None)
    outs, cots = [y], [dy]
    if state:
        outs.append(h)
        cots.append(dh)
    want = torch.autograd.grad(outs, leaves, cots)
    got = ref.selective_scan_bwd_ref(x, dt, bm, cm, a, dy, state=h0,
                                     dstate=dh)
    assert (got[5] is None) == (not state)
    for name, g, wnt in zip(("dx", "ddt", "db", "dc", "da", "dstate0"), got,
                            want):
        assert g.shape == wnt.shape and g.dtype == wnt.dtype, name
        bf16 = g.dtype == torch.bfloat16
        if bf16 and name in ("dx", "ddt"):
            _close_rel(g, wnt, SCAN_BF16_DX_REL, name)
        else:
            _close_rel(g, wnt, REL, name, BF16_UNIT if bf16 else 0.0)


def _ratio(got, want, unit_bf16=True):
    """The largest error over its limit (1e-5 of the largest |want|, plus
    one bf16 unit of each element for bf16 gradients) across the
    gradients; None pairs skipped."""
    worst = 0.0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        gd, wd = g.detach().double(), w.detach().double()
        lim = REL * float(wd.abs().max()) + (
            BF16_UNIT * wd.abs() if unit_bf16 and g.dtype == torch.bfloat16
            else 0.0)
        worst = max(worst, float(((gd - wd).abs() / lim).max()))
    return worst


@pytest.mark.parametrize("case", list(WKV_CASES))
def test_wkv_chunked_algebra_matches_plain_backward(case):
    """``rwkv6_bwd_chunked_ref`` (the kernel's chunks, sub-chunk edge
    states and dw expanded about them) against ``rwkv6_bwd_ref``, every
    gradient and the initial state's, within 1e-5 of the largest (+ one
    bf16 unit in bf16), at trained and strong decays, ragged S and with a
    state and a final cotangent."""
    b, h, s, strong, state, dtype = WKV_CASES[case]
    (r, k, v, w, u, do), st, dst = (
        lambda a: ([_t(x) for x in a[0]], _t(a[1]), _t(a[2])))(
            _wkv_inputs(len(case) + s, b, h, s, strong=strong, state=state))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    want = ref.rwkv6_bwd_ref(r, k, v, w, u, do, state=st, dstate=dst)
    got = ref.rwkv6_bwd_chunked_ref(r, k, v, w, u, do, state=st,
                                    dstate=dst)
    names = ("dr", "dk", "dv", "dw", "du", "dstate0")
    for name, g, wnt in zip(names, got, want):
        if wnt is None:
            assert g is None, name
            continue
        assert g.shape == wnt.shape and g.dtype == wnt.dtype, name
        assert bool(torch.isfinite(g).all()), name
        unit = BF16_UNIT if g.dtype == torch.bfloat16 else 0.0
        _close_rel(g, wnt, REL, f"{case} {name}", unit)


@pytest.mark.parametrize("strong,s,state", [
    (False, 128, False), (True, 100, True), (False, 77, True),
    (True, 200, False)])
def test_wkv_chunked_algebra_matches_jax_vjp(strong, s, state):
    """``rwkv6_bwd_chunked_ref`` against ``jax.vjp`` of the JAX package's
    token scan ``repro.kernels.ref.rwkv6_ref``, to 1e-5 of each gradient's
    largest, at trained and strong decays (w = exp(-exp(N(1.5, 0.5))),
    where the TPU form's log-space decays overflow) and ragged S."""
    (r, k, v, w, u, do), st, dst = _wkv_inputs(7 + s, 1, 2, s, strong=strong,
                                               state=state)
    prim = [jnp.asarray(x) for x in (r, k, v, w, u)] + (
        [jnp.asarray(st)] if state else [])

    def f(*a):
        return jref.rwkv6_ref(*a[:5], state=a[5] if state else None,
                              return_state=True)

    _, vjp = jax.vjp(f, *prim)
    want = vjp((jnp.asarray(do), jnp.asarray(dst) if state else
                jnp.zeros((1, 2, 64, 64), jnp.float32)))
    got = ref.rwkv6_bwd_chunked_ref(*(_t(x) for x in (r, k, v, w, u, do)),
                                    state=_t(st), dstate=_t(dst))
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                            want):
        _close_rel(g, torch.from_numpy(np.array(wnt)), REL, f"jax {name}")


@pytest.mark.parametrize("strong", [False, True])
def test_wkv_chunked_algebra_without_sub_chunk_products_fails(strong):
    """The card's control at the new design's seam: the chunked algebra
    with the products of the sub-chunks between two reference points
    dropped (``fault="sub_ref"``) misses the limit the kernel is held to,
    at trained and strong decays."""
    (r, k, v, w, u, do), st, dst = (
        lambda a: ([_t(x) for x in a[0]], _t(a[1]), _t(a[2])))(
            _wkv_inputs(11, 1, 2, 100, strong=strong, state=True))
    want = ref.rwkv6_bwd_ref(r, k, v, w, u, do, state=st, dstate=dst)
    good = ref.rwkv6_bwd_chunked_ref(r, k, v, w, u, do, state=st,
                                     dstate=dst)
    bad = ref.rwkv6_bwd_chunked_ref(r, k, v, w, u, do, state=st,
                                    dstate=dst, fault="sub_ref")
    assert _ratio(good, want) <= 1.0
    assert _ratio(bad, want) > 1.0


SCAN_CASES = {   # (B, S, di, n, dtype, a state and its cotangent)
    "S 40": (2, 40, 24, 8, torch.float32, False),
    "S 128, state": (2, 128, 24, 16, torch.float32, True),
    "ragged S 333, state": (1, 333, 20, 8, torch.float32, True),
    "bf16, ragged, state": (2, 300, 24, 16, torch.bfloat16, True),
    "one token": (3, 1, 16, 8, torch.bfloat16, True),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_scanned_order_matches_plain_backward(case):
    """``selective_scan_bwd_scanned_ref`` (the kernel's runs, chunk pairs
    and carries) against ``selective_scan_bwd_ref`` within 1e-5 of each
    gradient's largest, plus one bf16 unit of each element where both
    round a bf16 gradient once."""
    b, s, di, n, dtype, state = SCAN_CASES[case]
    x, dt, bm, cm, a, dy, h0, dh = _scan_inputs(len(case) + s, b, s, di, n,
                                                dtype, state)
    want = ref.selective_scan_bwd_ref(x, dt, bm, cm, a, dy, state=h0,
                                      dstate=dh)
    got = ref.selective_scan_bwd_scanned_ref(x, dt, bm, cm, a, dy,
                                             state=h0, dstate=dh)
    for name, g, wnt in zip(("dx", "ddt", "db", "dc", "da", "dstate0"), got,
                            want):
        if wnt is None:
            assert g is None, name
            continue
        assert g.shape == wnt.shape and g.dtype == wnt.dtype, name
        unit = BF16_UNIT if g.dtype == torch.bfloat16 else 0.0
        _close_rel(g, wnt, REL, f"{case} {name}", unit)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [100, 257])
def test_scan_scanned_order_matches_autograd(s, dtype):
    """``selective_scan_bwd_scanned_ref`` against autograd of
    ``selective_scan_ref`` with a state and its cotangent, at the plain
    backward's tolerances (float32 1e-5 of the largest; in bf16 dx and ddt
    within 2^-6 of their largest, the rest 1e-5 plus one bf16 unit)."""
    x, dt, bm, cm, a, dy, h0, dh = _scan_inputs(s + 3, 2, s, 24, 8, dtype,
                                                True)
    leaves = [z.clone().requires_grad_(True) for z in (x, dt, bm, cm, a, h0)]
    y, h = ref.selective_scan_ref(*leaves[:5], state=leaves[5])
    want = torch.autograd.grad([y, h], leaves, [dy, dh])
    got = ref.selective_scan_bwd_scanned_ref(x, dt, bm, cm, a, dy, state=h0,
                                             dstate=dh)
    for name, g, wnt in zip(("dx", "ddt", "db", "dc", "da", "dstate0"), got,
                            want):
        bf16 = g.dtype == torch.bfloat16
        if bf16 and name in ("dx", "ddt"):
            _close_rel(g, wnt, SCAN_BF16_DX_REL, name)
        else:
            _close_rel(g, wnt, REL, name, BF16_UNIT if bf16 else 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_scanned_order_without_run_carry_fails(dtype):
    """The card's control at the new design's seam: the scanned order
    with the carry between the runs inside a chunk dropped
    (``fault="run_carry"``) misses the limit the kernel is held to."""
    x, dt, bm, cm, a, dy, h0, dh = _scan_inputs(5, 2, 200, 24, 8, dtype,
                                                True)
    want = ref.selective_scan_bwd_ref(x, dt, bm, cm, a, dy, state=h0,
                                      dstate=dh)
    good = ref.selective_scan_bwd_scanned_ref(x, dt, bm, cm, a, dy,
                                              state=h0, dstate=dh)
    bad = ref.selective_scan_bwd_scanned_ref(x, dt, bm, cm, a, dy, state=h0,
                                             dstate=dh, fault="run_carry")
    assert _ratio(good, want) <= 1.0
    assert _ratio(bad, want) > 1.0
