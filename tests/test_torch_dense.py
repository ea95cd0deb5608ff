"""The port's StarCoder2 serving path against the JAX package on the CPU:
RoPE, the GELU FFN, decode attention, one dense block, and the REDUCED
StarCoder2 model (``forward``, ``serve_step``, ``generate``) against
``repro.models`` with converted params. Full-sequence attention goes
through ``ops.flash_attention``, whose CPU branch is the plain dense
version; JAX's model runs ``chunked_attention``.

Tolerances:
- Layers, float32: 1e-5 absolute (float32 sums in another order).
- Model, float32: logits 1e-4 for ``forward`` and for every ``serve_step``
  from JAX's cache; greedy tokens identical over 16 free-running steps
  across a ring-buffer wrap.
- Model, bfloat16: the JAX model rounds the attention scores and the
  probabilities to bfloat16 (``chunked_attention``), the port keeps them
  in float32 inside flash attention, and bf16 rounds at other places in
  the two frameworks. Measured on seeds 0-3 (REDUCED, 2 x 128 tokens,
  |logits| <= 4.9): max |diff| 0.035-0.048, mean 0.0062-0.0067; the
  bound is max 0.3, mean 0.02, as for RWKV6. (Float32 measured 4.3e-6.)
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
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.build import KERNELS  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import serve  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCH = "starcoder2-3b"
TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_MAX, BF16_MEAN = 0.3, 0.02


def _cfgs(dtype):
    return (dataclasses.replace(jax_config(ARCH, reduced=True), dtype=dtype),
            dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


def _jparams(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree))


# ------------------------------------------------------------ configs

def test_starcoder2_configs_are_copies():
    """Every field of the port's ArchConfig has the JAX config's value."""
    for reduced in (False, True):
        a = dataclasses.asdict(jax_config(ARCH, reduced=reduced))
        b = dataclasses.asdict(get_config(ARCH, reduced=reduced))
        assert b == {name: a[name] for name in b}
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.resolved_head_dim, full.window) == (30, 3072, 24, 2, 128,
                                                     4096)


def test_params_tree_matches_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    own = convert.params_to_numpy(tm.init_params(
        torch.Generator().manual_seed(0), tcfg, device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(own)):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
    back = convert.params_to_numpy(convert.params_from_numpy(jp))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- layers

def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 8192, (2, 10))
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                         jl.rope_freqs(32, 100_000.0))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        tl.rope_freqs(32, 100_000.0))
    _close(got, want)
    _close(tl.rope_freqs(128, 1e5), jl.rope_freqs(128, 1e5), 0.0)


def test_ffn_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jp = jl.ffn_init(jax.random.PRNGKey(1), 64, 256, "gelu")
    got = tl.ffn_apply(_jparams(jp), torch.from_numpy(x), "gelu")
    _close(got, jl.ffn_apply(jp, jnp.asarray(x), "gelu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.ffn_init(torch.Generator(), 64, 256, "swiglu")


def test_decode_attention_matches_jax():
    """GQA in kv-major order, a float32 query against bfloat16 caches."""
    rng = np.random.default_rng(2)
    b, h, hkv, dh, s = 2, 8, 2, 32, 12
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
              for _ in range(2))
    valid = rng.uniform(size=(b, s)) < 0.7
    valid[:, 0] = True
    jk, jv = (jnp.asarray(c).astype(jnp.bfloat16) for c in (kc, vc))
    want = jl.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(valid))
    tk, tv = (torch.from_numpy(c).bfloat16() for c in (kc, vc))
    got = tl.decode_attention(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(valid))
    _close(got, want)


def test_dense_block_matches_jax():
    jcfg, tcfg = _cfgs("float32")
    jp = jt.block_init(jax.random.PRNGKey(3), jcfg, jt.pad_dims(jcfg, 1))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 96, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(96), (2, 1))
    want, _ = jt.block_apply(jp, jcfg, jt.pad_dims(jcfg, 1), jnp.asarray(x),
                             jnp.asarray(pos))
    before = KERNELS["flash_attention"].launches
    got = tt.block_apply(_jparams(jp), tcfg, torch.from_numpy(x),
                         torch.from_numpy(pos))
    assert KERNELS["flash_attention"].launches == before   # CPU: plain
    _close(got, want, LOGIT_TOL)


# -------------------------------------------------------------- model

@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    return request.param, jcfg, tcfg, jp, _jparams(jp)


def _check_logits(dtype, got, want):
    diff = np.abs(_np(got) - _np(want))
    if dtype == "float32":
        assert diff.max() <= LOGIT_TOL, diff.max()
    else:
        assert diff.max() <= BF16_MAX and diff.mean() <= BF16_MEAN, (
            diff.max(), diff.mean())


def test_forward_matches_jax(model):
    """128 tokens: twice the REDUCED window of 64."""
    dtype, jcfg, tcfg, jp, tp = model
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 128))
    want, _ = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, jcfg))(
        jp, jnp.asarray(tokens))
    got = tm.forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg,
                     device="cpu")
    assert got.dtype == tm.compute_dtype(tcfg)
    assert got.shape == (2, 128, jcfg.vocab)
    _check_logits(dtype, got, want)


def test_greedy_decode_matches_jax(model):
    """The serve_lm loop in JAX: 56 prompt tokens and 16 greedy ones, 72
    steps through a ring buffer of min(72, window 64) slots, so it wraps.
    At every step one port ``serve_step`` from JAX's cache; then the
    port's ``generate`` on the same prompts."""
    dtype, jcfg, tcfg, jp, tp = model
    b, plen, gen = 2, 56, 16
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab, (b, plen))
    step = jax.jit(lambda p, c, bt: jm.serve_step(p, c, bt, jcfg))
    cache = jm.init_cache(jcfg, 1, b, plen + gen)
    assert cache["k"].shape[2] == jcfg.window < plen + gen
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
        tok = np.array(jnp.argmax(logits[:, :jcfg.vocab], axis=-1))
    assert tnew["k"].dtype == torch.bfloat16
    assert tuple(tnew["k"].shape) == tuple(cache["k"].shape)
    res = serve.generate(tp, tcfg, prompts, gen, device="cpu")
    assert res.tokens.shape == (b, gen)
    if dtype == "float32":
        np.testing.assert_array_equal(res.tokens, np.stack(out, axis=1))


def test_init_cache_is_clamped_to_the_window():
    tcfg = get_config(ARCH, reduced=True)
    cache = tm.init_cache(tcfg, 3, 200, device="cpu")
    assert tuple(cache["k"].shape) == (tcfg.n_layers, 3, tcfg.window,
                                       tcfg.n_kv_heads, 32)
    assert tuple(tm.init_cache(tcfg, 3, 40, device="cpu")["v"].shape) == (
        tcfg.n_layers, 3, 40, tcfg.n_kv_heads, 32)
    with pytest.raises(ValueError, match="cache_len"):
        tm.init_cache(tcfg, 3, device="cpu")


def test_serve_cli_starcoder2_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "3", "--gen", "4"])
    out = capsys.readouterr().out
    assert "starcoder2-3b (reduced, cpu)" in out and "tok/s" in out
