"""The port's hybrid family (hymba: parallel attention and mamba heads)
against the JAX package on the CPU: ``causal_conv1d``, the selective
scan's plain version, ``mamba_apply`` and ``mamba_decode_step``, the hybrid
``block_apply`` / ``block_decode``, and the REDUCED Hymba-1.5B model
(``forward``, ``serve_step``, ``generate``, the serve CLI) against
``repro.models`` with params carried over by ``repro_torch.convert``. On
the CPU ``ops.selective_scan`` is ``ref.selective_scan_ref`` and
``ops.flash_attention`` the plain dense attention.

Tolerances (absolute unless said):
- ``causal_conv1d`` with and without a state, float32: 1e-5.
- ``selective_scan_ref`` against a float64 recurrence: 1e-6 of the
  largest |y| and |h| in float32; in bfloat16, where dt x is rounded to
  bfloat16 as the JAX package rounds it (and the recurrence is fed the
  same rounded product), y to one bfloat16 unit (2^-8) of the largest |y|
  and the state to 1e-6.
- ``mamba_apply`` at S 128 (JAX's chunked scan) and S 40 (its plain
  scan), with and without initial states, with ``return_state``, float32:
  1e-5 (measured within 2.3e-6, the state within 1e-6, the conv state
  equal).
- ``mamba_decode_step`` over 8 successive tokens against JAX's: 1e-5.
- The hybrid ``block_apply`` and ``block_decode``, float32: 1e-5.
- ``forward``, float32: logits 1e-4 (measured 4.2e-6).
- Greedy decode past the ring's wrap (prompt 24 + gen 24 against the
  REDUCED window of 32), float32: tokens identical, and every
  ``serve_step`` from JAX's cache within 1e-4 of JAX's logits. The K / V
  and conv caches are bfloat16 even in float32 (as in the JAX package):
  where a step's new entry rounds to the neighbouring bfloat16 value, its
  logits are held to 1e-3 (``CACHE_FLIP_TOL``, as in
  ``tests/test_torch_moe.py``); the float32 SSM state to 1e-5. Measured:
  logits within 3.0e-6 at steps without such a rounding, 1.6e-5 at the
  22 of 48 steps with one, the state within 3.6e-7.
- ``forward`` in bfloat16 within the dense bound of
  ``tests/test_torch_moe.py``: max 0.3, mean 0.02 (bf16 rounds at other
  places in the two frameworks). Measured on seeds 0-3 (REDUCED, 2 x 128
  tokens, |logits| <= 4.5): max |diff| 0.066-0.082, mean 0.0103-0.0107.
- Params: the port's own init has JAX's keys, shapes and dtypes, its
  constant leaves JAX's values exactly (``a_log`` = log(1..n) within one
  float32 unit: the port's is correctly rounded, XLA's CPU log(7) one unit
  off), and a JAX tree converts and back bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import selective_scan as sscan  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import serve  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "hymba-1.5b"
TOL = 1e-5
SCAN_TOL = 1e-6
LOGIT_TOL = 1e-4
CACHE_FLIP_TOL = 1e-3
BF16_MAX, BF16_MEAN = 0.3, 0.02
BF16_CACHES = ("k", "v", "conv")


def _cfgs(dtype, **kw):
    return (dataclasses.replace(jax_config(ARCH, reduced=True), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


def _jparams(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree))


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------ configs

def test_configs_are_copies():
    """Every field of the port's ArchConfig has the JAX config's value,
    FULL and REDUCED."""
    for reduced in (False, True):
        a = dataclasses.asdict(jax_config(ARCH, reduced=reduced))
        b = dataclasses.asdict(get_config(ARCH, reduced=reduced))
        assert b == {name: a[name] for name in b}
    assert get_config(ARCH).family == "hybrid"


def test_params_tree_and_constants_match_jax(model):
    jcfg, tcfg, jp, _ = model
    jp = jax.tree.map(np.asarray, jp)
    own = convert.params_to_numpy(tm.init_params(
        torch.Generator().manual_seed(0), tcfg, device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(own)):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
    back = convert.params_to_numpy(convert.params_from_numpy(jp))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    js, ts = jp["layers"]["ssm"], own["layers"]["ssm"]
    for key in ("d_skip", "conv_b"):
        np.testing.assert_array_equal(ts[key], js[key])
    # a_log = log(1..n): the port's is the correctly rounded float32 log;
    # XLA's CPU log is one unit off at log(7)
    n = tcfg.ssm_state
    np.testing.assert_array_equal(
        ts["a_log"], np.broadcast_to(np.log(np.arange(1.0, n + 1)).astype(
            np.float32), ts["a_log"].shape))
    np.testing.assert_allclose(ts["a_log"], js["a_log"], rtol=2.0 ** -23,
                               atol=0)
    np.testing.assert_array_equal(ts["dt_proj"]["b"], js["dt_proj"]["b"])
    for key in ("ln_attn_out", "ln_ssm_out"):
        np.testing.assert_array_equal(own["layers"][key]["g"],
                                      jp["layers"][key]["g"])
    di = tcfg.ssm_expand * tcfg.d_model
    assert ts["a_log"].shape == (tcfg.n_layers, di, tcfg.ssm_state)
    assert ts["x_proj"]["w"].shape == (tcfg.n_layers, di,
                                       16 + 2 * tcfg.ssm_state)


def test_full_width_param_count():
    """Hymba-1.5B at its published widths: one port block's params times
    32 layers, plus the untied embedding and head and the final norm, is
    1,662,264,000 (float32, 6.65 GB), JAX's count from its shapes."""
    cfg = get_config(ARCH)
    block = tt.block_init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    ssm = sum(x.numel() for x in tree_leaves(block["ssm"]))
    assert ssm == 16_176_000
    n = (cfg.n_layers * sum(x.numel() for x in tree_leaves(block))
         + 2 * cfg.vocab * cfg.d_model + cfg.d_model)
    shapes = jax.eval_shape(lambda k: jm.init_params(k, jax_config(ARCH)),
                            jax.random.PRNGKey(0))
    assert n == sum(x.size for x in jax.tree.leaves(shapes)) == 1_662_264_000


# ------------------------------------------------------------- layers

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 13, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    st = (rng.standard_normal((2, 3, 24)).astype(np.float32)
          if with_state else None)
    want, wst = jl.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
    got, gst = tl.causal_conv1d(_t(x), _t(w), _t(b),
                                None if st is None else _t(st))
    _close(got, want)
    _close(gst, wst, 0.0)


def _scan_inputs(rng, bsz, s, di, n, dtype, with_state):
    x = torch.from_numpy(rng.standard_normal((bsz, s, di))).to(dtype)
    dt = torch.from_numpy(rng.uniform(0.001, 0.5, (bsz, s, di))).to(dtype)
    b, c = (torch.from_numpy(rng.standard_normal((bsz, s, n))).to(dtype)
            for _ in range(2))
    a = -torch.arange(1, n + 1, dtype=torch.float32).repeat(di, 1)
    a = a * torch.from_numpy(rng.uniform(0.5, 1.5, (di, 1))).float()
    st = (torch.from_numpy(rng.standard_normal((bsz, di, n))).float()
          if with_state else None)
    return x, dt, b, c, a, st


def _scan64(x, dt, b, c, a, st):
    """The recurrence in float64, fed dt x as the compute dtype rounds
    it."""
    u = (dt * x).double()
    h = (torch.zeros(x.shape[0], x.shape[2], a.shape[1], dtype=torch.float64)
         if st is None else st.double())
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(dt[:, t, :, None].double() * a.double()) * h
             + u[:, t, :, None] * b[:, t, None, :].double())
        ys.append((h * c[:, t, None, :].double()).sum(-1))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,with_state", [(37, False), (64, True),
                                          (1, True)])
def test_selective_scan_ref_against_float64(dtype, s, with_state):
    args = _scan_inputs(np.random.default_rng(s), 2, s, 24, 8, dtype,
                        with_state)
    y, h = ref.selective_scan_ref(*args[:5], state=args[5])
    y64, h64 = _scan64(*args)
    assert y.dtype == dtype and h.dtype == torch.float32
    ymax = float(y64.abs().max())
    ytol = (2.0 ** -8 if dtype == torch.bfloat16 else SCAN_TOL) * ymax
    assert float((y.double() - y64).abs().max()) <= ytol
    assert float((h.double() - h64).abs().max()) <= SCAN_TOL * max(
        1.0, float(h64.abs().max()))
    # ops dispatches a CPU tensor to the plain version
    yo, ho = ops.selective_scan(*args[:5], state=args[5])
    assert torch.equal(yo, y) and torch.equal(ho, h)


def _mamba(seed=0, d=128, n=8):
    jp = jssm.mamba_init(jax.random.PRNGKey(seed), d, state=n, conv=4,
                         expand=2)
    return jp, _jparams(jp)


@pytest.mark.parametrize("s", [128, 40])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_matches_jax(s, with_state):
    """S 128 takes JAX's chunked scan (S % 64 == 0, S > 64), S 40 its plain
    scan; the port has one path."""
    jp, tp = _mamba()
    rng = np.random.default_rng(s + with_state)
    x = rng.standard_normal((2, s, 128)).astype(np.float32)
    cs = (rng.standard_normal((2, 3, 256)).astype(np.float32)
          if with_state else None)
    hs = (rng.standard_normal((2, 256, 8)).astype(np.float32)
          if with_state else None)
    want, (wc, wh) = jax.jit(lambda p, x, cs, hs: jssm.mamba_apply(
        p, x, state=8, conv_state=cs, ssm_state=hs, return_state=True))(
        jp, jnp.asarray(x), None if cs is None else jnp.asarray(cs),
        None if hs is None else jnp.asarray(hs))
    got, (gc, gh) = tssm.mamba_apply(
        tp, _t(x), state=8, conv_state=None if cs is None else _t(cs),
        ssm_state=None if hs is None else _t(hs), return_state=True)
    assert gh.dtype == torch.float32 and gc.shape == (2, 3, 256)
    _close(got, want)
    _close(gc, wc, 0.0)
    _close(gh, wh)
    if not with_state:          # without return_state, the output alone
        _close(tssm.mamba_apply(tp, _t(x), state=8), want)


# ------------------------------------- the chunked kernel's arithmetic
# An emulation of csrc/selective_scan.cu's chunked form in float32, in the
# kernel's order: per thread a local scan of its ITEMS tokens into (decay
# product, state), the warp scan of the THREADS_PER_CHANNEL pairs with the
# carry folded into the first, the runs again from the scanned states, y
# summed over the states in order; fmaf where the kernel fuses. The
# exponentials are 2^(dt (a log2 e)) as the kernel forms them, the run's
# decay product one of them over the run's summed dt (float32 exp2 here,
# the SFU's ex2.approx there).

def _fma(p, q, r):
    """fmaf: p q + r rounded once to float32 (the float64 product of two
    float32 values is exact)."""
    return (p.double() * q.double() + r.double()).float()


def _chunked_scan(x, dt, b, c, a, *, state=None, carry=True):
    """The chunked form's function of ``ref.selective_scan_ref``'s
    arguments; ``carry=False`` is a faulty version that starts every chunk
    after the first from zeros."""
    tpc, items, chunk = sscan.THREADS_PER_CHANNEL, sscan.ITEMS, sscan.CHUNK
    bsz, s, di = x.shape
    n = a.shape[1]
    pad = (-s) % chunk                   # zero-filled: the identity pair

    def runs(t, w):                      # (B, chunks, TPC, ITEMS, w)
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
        return t.view(bsz, -1, tpc, items, w)

    u, dtf = runs(dt * x, di), runs(dt, di)
    bf, cf = runs(b, n), runs(c, n)
    a2 = a.float() * torch.tensor(1.4426950408889634)    # a log2(e)
    h0 = (torch.zeros(bsz, di, n) if state is None else state.float())
    cin, ys = h0, []
    for ci in range(u.shape[1]):
        da = torch.exp2(dtf[:, ci, ..., None] * a2)      # (B, TPC, I, di, n)
        ub = u[:, ci, ..., None] * bf[:, ci, :, :, None, :]
        sdt = dtf[:, ci, :, 0]
        for i in range(1, items):
            sdt = sdt + dtf[:, ci, :, i]                 # (B, TPC, di)
        pa, ph = torch.exp2(sdt[..., None] * a2), ub[:, :, 0]
        for i in range(1, items):
            ph = _fma(da[:, :, i], ph, ub[:, :, i])
        h_in = cin if carry or ci == 0 else torch.zeros_like(cin)
        ph = torch.cat([_fma(pa[:, :1], h_in[:, None], ph[:, :1]),
                        ph[:, 1:]], 1)
        d = 1
        while d < tpc:                   # Hillis-Steele over the threads
            ph = torch.cat([ph[:, :d], _fma(pa[:, d:], ph[:, :-d],
                                            ph[:, d:])], 1)
            pa = torch.cat([pa[:, :d], pa[:, d:] * pa[:, :-d]], 1)
            d *= 2
        h = torch.cat([h_in[:, None], ph[:, :-1]], 1)
        hs = []
        for i in range(items):
            h = _fma(da[:, :, i], h, ub[:, :, i])
            hs.append(h)
        hs = torch.stack(hs, 2)                          # (B, TPC, I, di, n)
        y = torch.zeros(hs.shape[:-1])
        for k in range(n):
            y = _fma(cf[:, ci, :, :, None, k], hs[..., k], y)
        ys.append(y.reshape(bsz, chunk, di))
        cin = ph[:, -1]
    return torch.cat(ys, 1)[:, :s].to(x.dtype), cin


def _scan_limit_ratio(got, want):
    """The largest error over its limit (at most 1 passes), at
    ``chip_smoke.py`` phase 17's limits: the state to 1e-5 of its largest
    |want|; y to 1e-5 of the largest |want y|, plus one bfloat16 unit
    (2^-7) of each element where ``got``'s y is bfloat16."""
    (y, h), (yw, hw) = got, want
    yd, ywd = y.double(), yw.double()
    lim = 1e-5 * float(ywd.abs().max()) + (
        2.0 ** -7 * ywd.abs() if y.dtype == torch.bfloat16 else 0.0)
    return max(float(((yd - ywd).abs() / lim).max()),
               float((h.double() - hw.double()).abs().max())
               / (1e-5 * float(hw.double().abs().max())))


def _scan_case(seed, bsz, s, di, n, dtype, with_state, decay="model"):
    """Inputs as ``chip_smoke.py`` phase 17 makes them (dt =
    softplus(N(-4, 0.5)), a = -(1..n)), or with strong decays (dt ~ 1, a =
    -16: a run's decay product underflows) or weak ones (dt ~ 1e-3)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((bsz, s, di))).to(dtype)
    b, c = (torch.from_numpy(rng.standard_normal((bsz, s, n))).to(dtype)
            for _ in range(2))
    a = -torch.arange(1, n + 1, dtype=torch.float32).repeat(di, 1)
    if decay == "strong":
        dt = rng.uniform(0.75, 1.25, (bsz, s, di))
        a = torch.full((di, n), -16.0)
    elif decay == "weak":
        dt = rng.uniform(0.5e-3, 1.5e-3, (bsz, s, di))
    else:
        dt = np.logaddexp(0.0, rng.normal(-4.0, 0.5, (bsz, s, di)))
    dt = torch.from_numpy(dt).to(dtype)
    st = (torch.from_numpy(rng.standard_normal((bsz, di, n))).float()
          if with_state else None)
    return x, dt, b, c, a, st


EMULATION_CASES = {   # (B, S, di, n, dtype, initial state, decays)
    "S 4096 f32": (1, 4096, 16, 16, torch.float32, False, "model"),
    "S 4096 bf16": (1, 4096, 16, 16, torch.bfloat16, False, "model"),
    "ragged S 333 with a state": (2, 333, 24, 8, torch.bfloat16, True,
                                  "model"),
    "a chunk - 1": (1, 127, 16, 16, torch.float32, True, "model"),
    "a chunk + 1": (1, 129, 16, 16, torch.float32, True, "model"),
    "strong decays": (1, 300, 16, 16, torch.float32, True, "strong"),
    "weak decays": (1, 1000, 16, 16, torch.float32, True, "weak"),
    "weak decays bf16": (1, 1000, 16, 8, torch.bfloat16, True, "weak"),
}


@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_chunked_scan_emulation_matches_plain_and_float64(case):
    """The chunked form's order within phase 17's limits of
    ``selective_scan_ref`` and of the float64 recurrence."""
    args = _scan_case(len(case), *EMULATION_CASES[case])
    got = _chunked_scan(*args[:5], state=args[5])
    assert got[0].dtype == args[0].dtype and got[1].dtype == torch.float32
    assert _scan_limit_ratio(
        got, ref.selective_scan_ref(*args[:5], state=args[5])) <= 1.0
    assert _scan_limit_ratio(got, _scan64(*args)) <= 1.0


def test_chunked_scan_emulation_without_carry_fails():
    """The control: chunks that drop the carry fall outside the limits."""
    args = _scan_case(3, 1, 1000, 16, 16, torch.float32, True)
    want = ref.selective_scan_ref(*args[:5], state=args[5])
    assert _scan_limit_ratio(
        _chunked_scan(*args[:5], state=args[5]), want) <= 1.0
    assert _scan_limit_ratio(
        _chunked_scan(*args[:5], state=args[5], carry=False), want) > 1.0


@pytest.mark.parametrize("s", [128, 333])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_with_chunked_scan_matches_jax(monkeypatch, s,
                                                   with_state):
    """``mamba_apply`` with ``ops.selective_scan`` replaced by the chunked
    form's emulation, against JAX's at ``test_mamba_apply_matches_jax``'s
    tolerance."""
    monkeypatch.setattr(ops, "selective_scan", _chunked_scan)
    jp, tp = _mamba()
    rng = np.random.default_rng(s + with_state)
    x = rng.standard_normal((2, s, 128)).astype(np.float32)
    cs = (rng.standard_normal((2, 3, 256)).astype(np.float32)
          if with_state else None)
    hs = (rng.standard_normal((2, 256, 8)).astype(np.float32)
          if with_state else None)
    want, (_, wh) = jax.jit(lambda p, x, cs, hs: jssm.mamba_apply(
        p, x, state=8, conv_state=cs, ssm_state=hs, return_state=True))(
        jp, jnp.asarray(x), None if cs is None else jnp.asarray(cs),
        None if hs is None else jnp.asarray(hs))
    got, (_, gh) = tssm.mamba_apply(
        tp, _t(x), state=8, conv_state=None if cs is None else _t(cs),
        ssm_state=None if hs is None else _t(hs), return_state=True)
    _close(got, want)
    _close(gh, wh)


@pytest.mark.parametrize("s,di,offset,chunked", [
    (sscan.CHUNK - 1, 64, 0, False),     # below the threshold: per state
    (sscan.CHUNK, 64, 0, True),          # at it
    (4096, 3200, 0, True),               # hymba-1.5B's forward
    (1, 3200, 0, False),                 # decode
    (333, 100, 0, False),                # channels not a multiple of 8
    (333, 64, 1, False)])                # x not 16-byte aligned
def test_selective_scan_form_by_shape(s, di, offset, chunked):
    """The wrapper's dispatch rule, ``takes_chunked``, read on CPU
    tensors."""
    x = torch.zeros(1 * s * di + offset, dtype=torch.bfloat16)[offset:]
    x = x.view(1, s, di)
    b = torch.zeros((1, s, 16), dtype=torch.bfloat16)
    assert sscan.takes_chunked(x, x, b, b) is chunked


def test_mamba_decode_steps_match_jax():
    """8 successive tokens, each port step from its own carried states,
    against JAX's steps from JAX's."""
    jp, tp = _mamba(seed=1)
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((8, 3, 1, 128)).astype(np.float32)
    jc = jnp.zeros((3, 3, 256))
    jh = jnp.zeros((3, 256, 8))
    tc, th = torch.zeros((3, 3, 256)), torch.zeros((3, 256, 8))
    step = jax.jit(lambda p, x, c, h: jssm.mamba_decode_step(p, x, c, h,
                                                             state=8))
    for x in xs:
        want, (jc, jh) = step(jp, jnp.asarray(x), jc, jh)
        got, (tc, th) = tssm.mamba_decode_step(tp, _t(x), tc, th, state=8)
        _close(got, want)
        _close(tc, jc)
        _close(th, jh)


def _block(seed=3):
    jcfg, tcfg = _cfgs("float32")
    pd = jt.pad_dims(jcfg, 1)
    jp = jt.block_init(jax.random.PRNGKey(seed), jcfg, pd)
    assert {"ssm", "ln_attn_out", "ln_ssm_out"} <= set(jp)
    return jcfg, tcfg, pd, jp, _jparams(jp)


def test_hybrid_block_apply_matches_jax():
    jcfg, tcfg, pd, jp, tp = _block()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(40), (2, 1))
    want, _ = jax.jit(lambda p, x, q: jt.block_apply(p, jcfg, pd, x, q))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    got, aux = tt.block_apply(tp, tcfg, _t(x), _t(pos))
    _close(got, want)
    assert float(aux) == 0.0


def test_hybrid_block_decode_matches_jax():
    """One step from a random cache on the ring (position 45 of a 32-slot
    window cache): x and every cache leaf."""
    jcfg, tcfg, pd, jp, tp = _block(seed=4)
    rng = np.random.default_rng(4)
    cache = jt.init_block_cache(jcfg, pd, 2, 32)
    assert set(cache) == {"k", "v", "conv", "ssm"}
    assert (cache["conv"].dtype, cache["ssm"].dtype) == (jnp.bfloat16,
                                                         jnp.float32)
    cache = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32),
                            v.dtype) for k, v in cache.items()}
    own = tt.init_block_cache(tcfg, 2, 32)
    assert {k: (v.dtype, tuple(v.shape)) for k, v in own.items()} == {
        k: (convert.cache_from_numpy({"x": np.asarray(v)})["x"].dtype,
            v.shape) for k, v in cache.items()}
    x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    p1 = np.full((2,), 45, np.int32)
    want, wc = jax.jit(lambda p, x, q, c: jt.block_decode(
        p, jcfg, pd, x, q, c))(jp, jnp.asarray(x1), jnp.asarray(p1), cache)
    got, gc = tt.block_decode(tp, tcfg, _t(x1), _t(p1).long(),
                              convert.cache_from_numpy(
                                  jax.tree.map(np.asarray, cache)))
    _close(got, want)
    assert set(gc) == set(wc)
    for key in gc:
        assert gc[key].dtype == (torch.bfloat16 if key in BF16_CACHES
                                 else torch.float32)
        _close(gc[key], wc[key], 0.0 if key in ("k", "v") else TOL)


# -------------------------------------------------------------- model

@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs("float32")
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _jparams(jp)


def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 128))
    want, _ = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, jcfg))(
        jp, jnp.asarray(tokens))
    got, aux = tm.forward(tp, {"tokens": _t(tokens)}, tcfg, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (2, 128, jcfg.vocab)
    _close(got, want, LOGIT_TOL)
    assert float(aux) == 0.0


def test_greedy_decode_past_the_ring_matches_jax(model):
    """JAX's serve loop (24 prompt tokens, 24 greedy ones; the cache is
    clamped to the window's 32 slots, so the ring is written twice over);
    at every step one port ``serve_step`` from JAX's cache; then the
    port's ``generate`` on the same prompts."""
    jcfg, tcfg, jp, tp = model
    b, plen, gen = 2, 24, 24
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab, (b, plen))
    step = jax.jit(lambda p, c, bt: jm.serve_step(p, c, bt, jcfg))
    cache = jm.init_cache(jcfg, 1, b, plen + gen)
    assert cache["k"].shape[2] == jcfg.window == 32
    assert tm.init_cache(tcfg, b, plen + gen, device="cpu")["k"].shape[2] \
        == 32
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
        # a step's new K / V / conv entries are stored in bfloat16: where a
        # last-bit float32 difference rounds one to the next bfloat16
        # value, the logits move by up to that entry's share
        flips = 0
        for key in BF16_CACHES:
            a, w = _np(tnew[key]), _np(cache[key])
            off = a != w
            flips += int(off.sum())
            assert np.all(np.abs(a - w)[off]
                          <= 2.0 ** -7 * np.abs(w)[off] + 1e-6)
        _close(tnew["ssm"], cache["ssm"])
        _close(got, logits, LOGIT_TOL if flips == 0 else CACHE_FLIP_TOL)
        tok = np.array(jnp.argmax(logits, axis=-1))
    res = serve.generate(tp, tcfg, prompts, gen, device="cpu")
    np.testing.assert_array_equal(res.tokens, np.stack(out, axis=1))


def test_bf16_forward_within_bound():
    jcfg, tcfg = _cfgs("bfloat16")
    fwd = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, jcfg)[0])
    for seed in range(4):
        jp = jm.init_params(jax.random.PRNGKey(seed), jcfg)
        tokens = np.random.default_rng(seed).integers(0, jcfg.vocab,
                                                      (2, 128))
        want = fwd(jp, jnp.asarray(tokens))
        got, _ = tm.forward(_jparams(jp), {"tokens": _t(tokens)}, tcfg,
                            device="cpu")
        assert got.dtype == torch.bfloat16
        diff = np.abs(_np(got) - _np(want))
        assert diff.max() <= BF16_MAX and diff.mean() <= BF16_MEAN, (
            seed, diff.max(), diff.mean())


def test_serve_cli_hymba_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "3", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"{ARCH} (reduced, cpu)" in out and "tok/s" in out
