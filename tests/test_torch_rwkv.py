"""The port's RWKV6 serving path against the JAX package on the CPU: the
plain WKV versions against ``repro.kernels.ref`` and the Pallas kernel in
interpret mode, and the REDUCED RWKV6 model (``forward``, ``serve_step``,
``generate``) against ``repro.models`` with converted params.

Tolerances:
- WKV, float32: 1e-5 absolute at |o| of order 1 (float32 sums in another
  order; the chunked algebra against the scan). The card kernel's
  algebra (``ref.rwkv6_subchunk_ref``) is held to the same bound, also at
  strong decays (|log w| * 64 far above 80) where the TPU form's
  exponents overflow; an emulation of its tensor-core products is held
  to 1e-5 of the largest |o| (at least 1) against a float64 scan, and one
  tf32 pass must miss that bound.
- Model, float32: logits 1e-4 for ``forward`` and for one ``serve_step``
  from the same cache; greedy tokens identical over 16 free-running steps.
  Free-running logits are not compared to 1e-4: the token-shift carries
  are stored in bfloat16 even in float32 (as in the JAX package), and a
  last-bit difference in float32 flips one bfloat16 unit now and then
  (measured: 8.6e-4 after 16 steps).
- Model, bfloat16: bf16 rounds at other places in the two frameworks.
  Measured on seeds 0-3 (REDUCED, 2 x 128 tokens, |logits| <= 4.8): max
  |diff| 0.086-0.20, mean 0.0105-0.0111; the bound is max 0.3, mean 0.02.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import list_archs as jax_archs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_chunked  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.sampling import sample_tokens as jax_sample  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan  # noqa: E402
from repro_torch.kernels.build import KERNELS  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (CHUNK, rwkv6_chunked_fwd,  # noqa: E402
                                            rwkv6_fwd, rwkv6_seq_fwd)
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import serve  # noqa: E402
from repro_torch.models.sampling import (filter_logits,  # noqa: E402
                                         sample_tokens)

ARCH = "rwkv6-1.6b"
WKV_TOL = 1e-5
BF16_MAX, BF16_MEAN = 0.3, 0.02


def _wkv_inputs(seed, b, h, s, d=64, state=False, strong=False):
    """Decays in (~0.7, 1), the regime of trained RWKV models, or with
    ``strong`` w = exp(-exp(N(1.5, 0.5))), |log w| ~ 4.5; r, k, v scaled
    so |o| is of order 1."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.3 * rng.standard_normal((b, h, s, d)) for _ in range(3))
    w = np.exp(-np.exp(rng.normal(1.5, 0.5, (b, h, s, d)) if strong else
                       rng.standard_normal((b, h, s, d)) * 0.5 - 2.0))
    u = 0.5 * rng.standard_normal((h, d))
    st = 0.3 * rng.standard_normal((b, h, d, d)) if state else None
    f32 = lambda x: None if x is None else x.astype(np.float32)  # noqa: E731
    return [f32(x) for x in (r, k, v, w, u)], f32(st)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _bshd(x):
    """(B, H, S, D) numpy -> the port op's (B, S, H, D) layout, a view."""
    return torch.from_numpy(x).transpose(1, 2)


def _close(a, b, tol=WKV_TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


# --------------------------------------------------------------- WKV

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 64, 100, 192])
def test_wkv_plain_matches_jax(s, with_state):
    (r, k, v, w, u), st = _wkv_inputs(s, 1, 2, s, state=with_state)
    jargs = [_j(x) for x in (r, k, v, w, u)]
    targs = [_t(x) for x in (r, k, v, w, u)]
    want_o, want_s = jref.rwkv6_ref(*jargs, state=_j(st), return_state=True)
    xla_o, xla_s = jref.rwkv6_chunked_xla(*jargs, state=_j(st),
                                          return_state=True)
    before = KERNELS["rwkv6"].launches
    got_o, got_s = ops.rwkv6(*(_bshd(x) for x in (r, k, v, w)), _t(u),
                             state=_t(st))
    assert KERNELS["rwkv6"].launches == before     # CPU: the plain version
    assert got_o.dtype == torch.float32 and got_o.shape == (1, s, 2, 64)
    got_o = got_o.transpose(1, 2)
    for want in ((want_o, want_s), (xla_o, xla_s)):
        _close(got_o, want[0])
        _close(got_s, want[1])
    scan_o, scan_s = ref.rwkv6_ref(*targs, state=_t(st), return_state=True)
    _close(scan_o, want_o)
    _close(scan_s, want_s)
    if s % 64 == 0:
        pal_o, pal_s = rwkv6_chunked(*jargs, state=_j(st), chunk=64,
                                     interpret=True)
        _close(got_o, pal_o)
        _close(got_s, pal_s)


@pytest.mark.parametrize("s,chunk", [(64, 64), (100, 64), (128, 64),
                                     (128, 32)])
def test_wkv_output_dtype_follows_the_branch(s, chunk):
    """bf16 r/k/v: the scan branch returns float32, the chunked branch
    r's dtype, in both packages."""
    (r, k, v, w, u), _ = _wkv_inputs(7, 1, 2, s)
    bf = [torch.from_numpy(x).bfloat16() for x in (r, k, v)]
    got = ops.rwkv6(*(x.transpose(1, 2) for x in bf), _bshd(w), _t(u),
                    chunk=chunk, return_state=False).transpose(1, 2)
    jbf = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in bf]
    want = jref.rwkv6_chunked_xla(*jbf, _j(w), _j(u), chunk=chunk)
    chunked = not (s % chunk or s <= chunk)
    assert got.dtype == (torch.bfloat16 if chunked else torch.float32)
    assert str(want.dtype) == ("bfloat16" if chunked else "float32")
    # one bf16 unit at most between two roundings of close float32 values
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=WKV_TOL)


def test_wkv_kernel_wrapper_takes_only_card_tensors():
    (r, k, v, w, u), _ = _wkv_inputs(3, 1, 2, 4)
    before = KERNELS["rwkv6"].launches
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_fwd(*(_bshd(x).contiguous() for x in (r, k, v, w)), _t(u))
    assert KERNELS["rwkv6"].launches == before


@pytest.mark.parametrize("s", [4, 100])
def test_wkv_kernel_entries_take_only_card_tensors(s):
    (r, k, v, w, u), _ = _wkv_inputs(3, 1, 2, s)
    args = [_bshd(x).contiguous() for x in (r, k, v, w)] + [_t(u)]
    before = {n: KERNELS[n].launches for n in ("rwkv6", "rwkv6_seq")}
    for fn in (rwkv6_chunked_fwd, rwkv6_seq_fwd):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    assert {n: KERNELS[n].launches for n in before} == before


@pytest.mark.parametrize("s,kernel", [(1, "rwkv6_seq"), (CHUNK - 1, "rwkv6_seq"),
                                      (CHUNK, "rwkv6"), (100, "rwkv6")])
def test_wkv_kernel_dispatch_by_shape(monkeypatch, s, kernel):
    """S below a chunk goes to the sequential kernel, the rest to the
    chunked one."""
    seen = []
    monkeypatch.setattr(rwkv6_scan, "_launch",
                        lambda kern, *a: seen.append(kern.name))
    x = torch.zeros((1, s, 2, 64))
    rwkv6_fwd(x, x, x, x, torch.zeros((2, 64)))
    assert seen == [kernel]


def _scan64(r, k, v, w, u, st):
    """The token scan in float64 (numpy); (B, H, S, D) inputs."""
    r, k, v, w, u = (np.asarray(x, np.float64) for x in (r, k, v, w, u))
    st = np.zeros(r.shape[:2] + (64, 64)) if st is None else st.astype(
        np.float64)
    outs = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(np.einsum("bhk,bhkv->bhv", r[:, :, t],
                              st + u[None, :, :, None] * kv))
        st = w[:, :, t, :, None] * st + kv
    return np.stack(outs, 2), st


@pytest.mark.parametrize("decay", ["trained", "strong"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [64, 100, 192])
def test_wkv_subchunk_form_matches_jax(s, with_state, decay):
    """The card kernel's algebra: sub-chunk reference points, decays as
    products of w, every factor at most 1."""
    (r, k, v, w, u), st = _wkv_inputs(s + 11, 1, 2, s, state=with_state,
                                      strong=decay == "strong")
    want_o, want_s = jref.rwkv6_ref(*(_j(x) for x in (r, k, v, w, u)),
                                    state=_j(st), return_state=True)
    got_o, got_s = ref.rwkv6_subchunk_ref(*(_t(x) for x in (r, k, v, w, u)),
                                          state=_t(st), return_state=True)
    assert got_o.dtype == torch.float32
    _close(got_o, want_o)
    _close(got_s, want_s)


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_z_centred_chunk_form_fails_at_strong_decays(with_state):
    """Control: at |log w| * 64 far above 80 the TPU form's exponents,
    centred on half the chunk's log-decay, overflow in JAX's XLA path and
    in the port's plain copy of it; the sub-chunk form stays within
    WKV_TOL of the scan."""
    s = 192
    (r, k, v, w, u), st = _wkv_inputs(5, 1, 2, s, state=with_state,
                                      strong=True)
    assert np.median(-np.log(w)) * 64 > 200
    jargs = [_j(x) for x in (r, k, v, w, u)]
    want_o = np.asarray(jref.rwkv6_ref(*jargs, state=_j(st)))
    xla_o = np.asarray(jref.rwkv6_chunked_xla(*jargs, state=_j(st)))
    targs = [_t(x) for x in (r, k, v, w, u)]
    port_o = ref.rwkv6_chunked_ref(*targs, state=_t(st)).numpy()
    for bad in (xla_o, port_o):
        assert not (np.isfinite(bad).all()
                    and np.abs(bad - want_o).max() <= 1e-3)
    _close(ref.rwkv6_subchunk_ref(*targs, state=_t(st)), want_o)


def _top16(x):
    """float32 with the low 16 bits cleared: a bfloat16 cut from the bits."""
    return (x.contiguous().view(torch.int32) & ~0xFFFF).view(torch.float32)


def _bf16_parts(x):
    """x = hi + mid + lo exactly, each part a bfloat16 cut from the bits
    (the kernel's split for its wgmma products)."""
    hi = _top16(x)
    mid = _top16(x - hi)
    return hi, mid, (x - hi) - mid


def _mm_bf16x3(a, b):
    """a b as the chunked kernel's wgmma products form it: both operands in
    three bfloat16 parts, the six terms down to 2^-16 of hi hi, float32
    sums (a bfloat16 b is its own hi part)."""
    (a0, a1, a2), (b0, b1, b2) = _bf16_parts(a), _bf16_parts(b)
    return ((a2 @ b0 + a1 @ b0) + (a0 @ b2 + a1 @ b1 + a0 @ b1)) + a0 @ b0


def _tf32(t):
    """Float32 rounded to tf32 on the bits (ties away), as the GRU tile's
    split rounds its hi part."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
            ).view(torch.float32)


def _mm_3xtf32(a, b):
    """a b as the chunked kernel's mma.sync cross tiles form it: hi
    rounded to tf32, lo = x - hi read truncated, a_lo b_lo dropped."""
    def trunc(t):
        return (t.contiguous().view(torch.int32) & ~0x1FFF
                ).view(torch.float32)
    ah, bh = _tf32(a), _tf32(b)
    return trunc(a - ah) @ bh + ah @ trunc(b - bh) + ah @ bh


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


@pytest.mark.parametrize("scheme", ["kernel", "tf32"])
@pytest.mark.parametrize("decay", ["trained", "strong"])
@pytest.mark.parametrize("s", [100, 192])
def test_wkv_tensor_core_scheme_keeps_float32_parity(s, decay, scheme):
    """The chunked kernel's products (bfloat16 parts on wgmma for those
    with v and the state, 3xTF32 mma.sync for the cross-sub-chunk
    weights), emulated here with r, k, v rounded to bfloat16 as the model
    gives them, agree with a float64 scan within 1e-5 of the largest |o|
    (at least 1), the card check's bound; one tf32 pass, the control, does
    not."""
    (r, k, v, w, u), st = _wkv_inputs(s + 3, 1, 2, s, state=True,
                                      strong=decay == "strong")
    r, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
               for x in (r, k, v))
    want_o, want_s = _scan64(r, k, v, w, u, st)
    mm, mm_cross = ((_mm_bf16x3, _mm_3xtf32) if scheme == "kernel"
                    else (_mm_tf32, _mm_tf32))
    got_o, got_s = ref.rwkv6_subchunk_ref(
        *(_t(x) for x in (r, k, v, w, u)), state=_t(st), return_state=True,
        mm=mm, mm_cross=mm_cross)
    ok = all(np.abs(g.double().numpy() - x).max()
             <= WKV_TOL * max(1.0, np.abs(x).max())
             for g, x in ((got_o, want_o), (got_s, want_s)))
    assert ok == (scheme == "kernel")


def _butterfly(x, lanes=32):
    """The kernel's reduce-scatter of a lane's 36 diagonal-block items
    (``halve`` with masks 16, 8, 4, 2, 1, odd sizes padded with a zero):
    returns per lane its final two slots as (item index or -1, sum)."""
    cur = {lane: (list(x[lane]), list(range(len(x[lane]))))
           for lane in range(lanes)}
    for m in (16, 8, 4, 2, 1):
        nxt = {}
        for lane in range(lanes):
            vals, idx = cur[lane]
            if len(vals) % 2:
                vals, idx = vals + [0.0], idx + [-1]
            half = len(vals) // 2
            up = bool(lane & m)
            pv, _ = cur[lane ^ m]
            if len(pv) % 2:
                pv = pv + [0.0]
            keep = slice(half, None) if up else slice(None, half)
            nxt[lane] = ([a + c for a, c in zip(vals[keep], pv[keep])],
                         idx[keep])
        cur = nxt
    return {lane: list(zip(cur[lane][1], cur[lane][0])) for lane in cur}


def test_wkv_diagonal_butterfly_places_every_item():
    """The chunked kernel sums each diagonal-block item over its 32 lanes
    by a butterfly reduce-scatter and finds, per lane, which item it holds
    by undoing the halvings (padding excluded); emulated here, every item
    lands on exactly one lane with the sum over all lanes."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 36))
    got = {}
    for lane, slots in _butterfly(x).items():
        for f, (item, total) in enumerate(slots):
            p = f + 2 * (lane & 1)
            if p >= 3:
                continue
            p += 3 * ((lane >> 1) & 1)
            if p >= 5:
                continue
            p += 5 * ((lane >> 2) & 1)
            if p >= 9:
                continue
            p += 9 * ((lane >> 3) & 1) + 18 * ((lane >> 4) & 1)
            assert item == p
            got[p] = total
    assert sorted(got) == list(range(36))
    np.testing.assert_allclose([got[p] for p in range(36)], x.sum(0),
                               rtol=1e-12)


# ------------------------------------------------------------ configs

def _cfgs(dtype):
    return (dataclasses.replace(jax_config(ARCH, reduced=True), dtype=dtype),
            dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype))


# the ArchConfig fields the RWKV6 code reads; the head counts, rope and act
# of the JAX config belong to the attention families
RWKV6_FIELDS = ("name", "family", "citation", "n_layers", "d_model", "d_ff",
                "vocab", "norm_eps", "rwkv", "rwkv_head_dim", "dtype")


def test_configs_are_copies():
    """Every field of the port's ArchConfig that the RWKV6 code reads has
    the JAX config's value; the registry holds every LM arch of the JAX
    package's, and an unknown name raises ``KeyError``."""
    assert list_archs() == [a for a in jax_archs() if a != "speed-tig"]
    for reduced in (False, True):
        a = dataclasses.asdict(jax_config(ARCH, reduced=reduced))
        b = dataclasses.asdict(get_config(ARCH, reduced=reduced))
        assert {f: b[f] for f in RWKV6_FIELDS} == {f: a[f]
                                                   for f in RWKV6_FIELDS}
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_params_round_trip_key_for_key():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    tp = convert.params_from_numpy(jp)
    back = convert.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the port's own init builds the same tree: keys, shapes, dtypes
    own = tm.init_params(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    own_np = convert.params_to_numpy(own)
    assert jax.tree.structure(own_np) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(own_np)):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)


def test_other_families_are_not_ported_yet():
    """None is left: every LM arch of the JAX package's registry (all but
    the TIG workload ``speed-tig``) is in the port's, FULL and REDUCED,
    and an unknown name raises ``KeyError`` in both tables."""
    names = [a for a in jax_archs() if a != "speed-tig"]
    assert list_archs() == names
    for reduced in (False, True):
        assert [get_config(a, reduced=reduced).name for a in names] == names
        with pytest.raises(KeyError):
            get_config("no-such-arch", reduced=reduced)


# -------------------------------------------------------------- model

@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    return request.param, jcfg, tcfg, jp, tp


def _check_logits(dtype, got, want, tol32=1e-4):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= tol32, diff.max()
    else:
        assert diff.max() <= BF16_MAX and diff.mean() <= BF16_MEAN, (
            diff.max(), diff.mean())


def test_forward_matches_jax(model):
    dtype, jcfg, tcfg, jp, tp = model
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 128))
    want, _ = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, jcfg))(
        jp, jnp.asarray(tokens))
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg,
                          device="cpu")
    assert float(aux) == 0.0
    assert got.dtype == tm.compute_dtype(tcfg)
    assert got.shape == (2, 128, jcfg.vocab)
    _check_logits(dtype, got, want)


def test_greedy_decode_matches_jax(model):
    """The serve_lm loop (4 prompt tokens, 12 greedy ones) in JAX; at
    every step one port ``serve_step`` from JAX's cache; then the port's
    ``generate`` on the same prompts."""
    dtype, jcfg, tcfg, jp, tp = model
    b, plen, gen = 2, 4, 12
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab, (b, plen))
    step = jax.jit(lambda p, c, bt: jm.serve_step(p, c, bt, jcfg))
    cache = jm.init_cache(jcfg, 1, b, plen + gen)
    tok, out = None, []
    for t in range(plen + gen):
        tok = prompts[:, t] if t < plen else tok
        if t >= plen:
            out.append(tok)
        batch = {"token": tok, "pos": np.full((b,), t, np.int32)}
        tcache = convert.cache_from_numpy(jax.tree.map(np.asarray, cache))
        got, tnew = tm.serve_step(tp, tcache, batch, tcfg, device="cpu")
        logits, cache = step(jp, cache, {k: jnp.asarray(x)
                                         for k, x in batch.items()})
        _check_logits(dtype, got, logits)
        if dtype == "float32":
            _close(tnew["wkv"], cache["wkv"], 1e-4)
        tok = np.array(jnp.argmax(logits[:, :jcfg.vocab], axis=-1))
    assert tnew["tm_shift"].dtype == torch.bfloat16
    res = serve.generate(tp, tcfg, prompts, gen, device="cpu")
    assert res.tokens.shape == (b, gen)
    if dtype == "float32":
        np.testing.assert_array_equal(res.tokens, np.stack(out, axis=1))


# ----------------------------------------------------------- sampling

def _nucleus(logits, top_p):
    """The smallest set of top logits whose softmax mass reaches top_p."""
    order = np.argsort(-logits)
    p = np.exp(logits[order] - logits.max())
    cum = np.cumsum(p / p.sum())
    return set(order[:int(np.sum(cum < top_p)) + 1].tolist())


def test_sample_tokens_support():
    rng = np.random.default_rng(0)
    logits = (2.0 * rng.standard_normal((3, 40))).astype(np.float32)
    lt = torch.from_numpy(logits)
    assert torch.equal(sample_tokens(lt), torch.from_numpy(
        np.array(jnp.argmax(logits, axis=-1))).long())
    gen = torch.Generator().manual_seed(0)
    for top_k, top_p in ((5, 1.0), (0, 0.6), (8, 0.5)):
        masked = filter_logits(lt, temperature=0.7, top_k=top_k,
                               top_p=top_p).numpy()
        draws = torch.stack([sample_tokens(
            lt, temperature=0.7, top_k=top_k, top_p=top_p, generator=gen)
            for _ in range(200)], 1).numpy()
        keys = jax.random.split(jax.random.PRNGKey(0), 20)
        jdraws = np.stack([np.asarray(jax_sample(
            kk, jnp.asarray(logits), temperature=0.7, top_k=top_k,
            top_p=top_p)) for kk in keys], 1)
        for row in range(3):
            allowed = set(range(40))
            if top_k:
                allowed &= set(np.argsort(-logits[row])[:top_k].tolist())
            if top_p < 1.0:
                allowed &= _nucleus(np.where(
                    np.isin(np.arange(40), list(allowed)),
                    logits[row] / 0.7, -1e30), top_p)
            assert set(np.flatnonzero(masked[row] > -1e29)) == allowed
            assert set(draws[row].tolist()) <= allowed
            assert set(jdraws[row].tolist()) <= allowed
            assert len(set(draws[row].tolist())) > 1


def test_serve_cli_on_cpu(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "3",
                "--gen", "4"])
    out = capsys.readouterr().out
    assert "rwkv6-1.6b (reduced, cpu)" in out and "tok/s" in out
