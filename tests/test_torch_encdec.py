"""The port's last two serving families against the JAX package on the
CPU: SeamlessM4T-medium's encoder-decoder (``sinusoidal_positions``,
``encode``, the cross-attention ``block_apply``, ``fill_enc_cache``,
``serve_step`` with and without the encoder memory, ``forward``, greedy
``generate``) and Qwen2-VL-7B's vision-language decoder (``apply_mrope``,
``forward`` over prepended patches with (t, h, w) positions, greedy
decode), REDUCED, float32, with JAX params carried over by
``repro_torch.convert``; and the plain flash attention at a key length of
its own (cross-attention) against JAX's ``chunked_attention``. On the CPU
``ops.flash_attention`` is the plain dense version; JAX's model runs
``chunked_attention``.

Tolerances (absolute unless said):
- ``sinusoidal_positions``: 4e-6. Angles reach 47 rad; XLA's and
  PyTorch's float32 ``pow`` may differ by one unit (2^-24 relative, 2.8e-6
  of a 47-rad angle), which moves sin and cos by as much (measured
  6.0e-8).
- ``apply_mrope``: 1e-5 (angles up to 100 rad, the same units as RoPE's;
  measured 4.8e-7); with three equal position streams it is
  ``apply_rope`` bit for bit.
- The plain flash at Sq != Sk against ``chunked_attention``: 1e-5
  (float32 sums in another order; measured 1.4e-6).
- ``encode``: the encoder runs in bfloat16 whatever the config (as in the
  JAX package), where JAX rounds the attention's scores, weights and sums
  to bfloat16 and the port's flash keeps them in float32. The two
  memories are held to two bfloat16 units (2 x 2^-7) of the largest
  |memory| (measured 1.12 units at seed 0; 1.07-1.52 over seeds 0-2).
  Every later check starts from JAX's memory (``encode`` replaced by
  JAX's result), so it holds the decoder alone.
- The cross-attention block, float32, from the same bfloat16 memory:
  1e-5 (measured 4.2e-7).
- ``fill_enc_cache`` from JAX's memory: K and V are bfloat16 products of
  bfloat16 values, each rounded once from float32 sums taken in another
  order: equal, or one bfloat16 unit apart (2^-7 of the value; measured
  equal).
- ``forward``, float32: logits 1e-4, as in ``tests/test_torch_moe.py``
  (float32 sums in another order through every layer; measured 5.6e-6).
- Every ``serve_step`` from JAX's cache, float32: logits 1e-5, about ten
  float32 units of the largest logit (|logit| < 8, a unit at most
  9.5e-7), for float32 sums in another order over two layers (measured
  3.5e-6); a step whose new K / V entry rounds to the neighbouring
  bfloat16 value (one unit) is held to 1e-3 (``CACHE_FLIP_TOL``, as in
  ``tests/test_torch_moe.py``; measured 4.7e-4). Greedy tokens
  identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import list_archs as jax_archs  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import serve  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SEAMLESS, QWEN = "seamless-m4t-medium", "qwen2-vl-7b"
ARCHS = (SEAMLESS, QWEN)
TOL = 1e-5
SIN_TOL = 4e-6
LOGIT_TOL = 1e-4
CACHE_FLIP_TOL = 1e-3
BF16_UNIT = 2.0 ** -7


def _cfgs(arch):
    return (dataclasses.replace(jax_config(arch, reduced=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, reduced=True),
                                dtype="float32"))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


def _t(x):
    """A JAX or numpy array as a tensor of the same dtype (bfloat16
    through float32, which holds it exactly)."""
    return convert.cache_from_numpy({"x": np.asarray(x)})["x"]


def _jparams(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree))


def _within_a_unit(got, want):
    """bfloat16 values equal or one unit apart."""
    a, w = _np(got), _np(want)
    assert np.all(np.abs(a - w) <= BF16_UNIT * np.abs(w))


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies(arch):
    """Every field of the port's ArchConfig has the JAX config's value,
    FULL and REDUCED; the registry holds every LM arch of the JAX
    package's."""
    for reduced in (False, True):
        a = dataclasses.asdict(jax_config(arch, reduced=reduced))
        b = dataclasses.asdict(get_config(arch, reduced=reduced))
        assert b == {name: a[name] for name in b}
    assert list_archs() == [a for a in jax_archs() if a != "speed-tig"]


def test_full_width_param_counts():
    """JAX's counts from its shapes: SeamlessM4T-medium 877,094,912
    (float32, 3.51 GB), Qwen2-VL-7B 7,615,487,488 (30.46 GB); the port's
    seamless blocks (one encoder, one decoder layer with cross-attention)
    times 12 each, plus the untied embedding and head and the two norms,
    give the first."""
    for arch, n in ((SEAMLESS, 877_094_912), (QWEN, 7_615_487_488)):
        shapes = jax.eval_shape(
            lambda k, a=arch: jm.init_params(k, jax_config(a)),
            jax.random.PRNGKey(0))
        assert sum(x.size for x in jax.tree.leaves(shapes)) == n
    cfg = get_config(SEAMLESS)
    gen = torch.Generator().manual_seed(0)

    def count(tree):
        return sum(x.numel() for x in tree_leaves(tree))

    dec = count(tt.block_init(gen, cfg, cross=True, device="cpu"))
    enc = count(tt.block_init(gen, cfg, device="cpu"))
    assert (cfg.n_layers * dec + cfg.n_enc_layers * enc
            + 2 * cfg.vocab * cfg.d_model + 2 * cfg.d_model) == 877_094_912


# ------------------------------------------------------------- layers

@pytest.mark.parametrize("offset", [0, 7])
def test_sinusoidal_positions_match_jax(offset):
    got = tl.sinusoidal_positions(40, 64, offset)
    assert got.dtype == torch.float32 and got.shape == (40, 64)
    _close(got, jl.sinusoidal_positions(40, 64, offset), SIN_TOL)


def test_apply_mrope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, 4, 64)).astype(np.float32)
    pos3 = rng.integers(0, 100, (2, 3, 24))
    sections = (8, 12, 12)
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                          jl.rope_freqs(64, 1e6), sections)
    freqs = tl.rope_freqs(64, 1e6)
    got = tl.apply_mrope(_t(x), _t(pos3), freqs, sections)
    _close(got, want)
    # three equal streams: RoPE over the whole ladder, bit for bit
    pos = _t(pos3[:, 0])
    assert torch.equal(tl.apply_mrope(_t(x), pos[:, None].expand(-1, 3, -1),
                                      freqs, sections),
                       tl.apply_rope(_t(x), pos, freqs))
    with pytest.raises(ValueError, match="sections"):
        tl.apply_mrope(_t(x), _t(pos3), freqs, (8, 12, 11))


@pytest.mark.parametrize("sq,sk,h,hkv", [(40, 72, 4, 4), (64, 24, 6, 2),
                                         (1, 33, 4, 2)])
def test_plain_flash_takes_a_key_length(sq, sk, h, hkv):
    """Cross-attention's shapes: Sq queries over Sk keys, non-causal, no
    window, GQA, against the JAX model's ``chunked_attention``."""
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, hkv, 16)).astype(np.float32)
            for _ in range(2))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    assert got.shape == q.shape
    _close(got, jl.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=False))


def test_flash_key_length_only_without_causality_or_window():
    q = torch.zeros((1, 8, 2, 16))
    kv = torch.zeros((1, 12, 2, 16))
    with pytest.raises(ValueError, match="as many keys"):
        ops.flash_attention(q, kv, kv, causal=True)
    with pytest.raises(ValueError, match="as many keys"):
        ops.flash_attention(q, kv, kv, causal=False, window=4)
    with pytest.raises(ValueError, match="one key"):
        ops.flash_attention(q, kv[:, :0], kv[:, :0], causal=False)


# ------------------------------------------------------ encoder-decoder

@pytest.fixture(scope="module")
def seamless():
    jcfg, tcfg = _cfgs(SEAMLESS)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    frames = np.random.default_rng(0).standard_normal(
        (2, jcfg.frontend_tokens, jcfg.d_model)).astype(np.float32)
    enc = jax.jit(lambda p, f: jm.encode(p, f, jcfg))(jp, jnp.asarray(frames))
    return jcfg, tcfg, jp, _jparams(jp), frames, enc


@pytest.fixture
def jax_memory(seamless, monkeypatch):
    """``encode`` replaced by JAX's memory of the fixture's frames."""
    enc = _t(seamless[5])
    monkeypatch.setattr(tm, "encode", lambda *a, **k: enc)
    return enc


def test_encode_within_two_bf16_units(seamless):
    jcfg, tcfg, _, tp, frames, want = seamless
    got = tm.encode(tp, _t(frames), tcfg, device="cpu")
    assert got.dtype == torch.bfloat16 and got.shape == frames.shape
    assert float(np.abs(_np(got) - _np(want)).max()) <= (
        2 * BF16_UNIT * float(np.abs(_np(want)).max()))


def test_cross_block_apply_matches_jax(seamless):
    """A decoder layer (causal self-attention, cross-attention over a
    bfloat16 memory, GELU FFN) in float32."""
    jcfg, tcfg, _, _, _, enc = seamless
    pd = jt.pad_dims(jcfg, 1)
    jp = jt.block_init(jax.random.PRNGKey(5), jcfg, pd, cross=True)
    assert {"ln_cross", "cross"} <= set(jp) and "qn" not in jp["cross"]
    x = np.random.default_rng(5).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(24), (2, 1))
    want, _ = jax.jit(lambda p, x, q, e: jt.block_apply(
        p, jcfg, pd, x, q, enc_out=e))(jp, jnp.asarray(x), jnp.asarray(pos),
                                       enc)
    got, aux = tt.block_apply(_jparams(jp), tcfg, _t(x), _t(pos),
                              enc_out=_t(enc))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want)


def test_fill_enc_cache_matches_jax(seamless, jax_memory):
    jcfg, tcfg, jp, tp, frames, _ = seamless
    want = jax.jit(lambda p, c, f: jm.fill_enc_cache(p, c, f, jcfg))(
        jp, jm.init_cache(jcfg, 1, 2, 16, enc_len=frames.shape[1]),
        jnp.asarray(frames))
    got = tm.fill_enc_cache(
        tp, tm.init_cache(tcfg, 2, 16, device="cpu", enc_len=frames.shape[1]),
        _t(frames), tcfg, device="cpu")
    assert set(got) == set(want) == {"k", "v", "enc_k", "enc_v"}
    for key in ("enc_k", "enc_v"):
        assert got[key].dtype == torch.bfloat16
        assert got[key].shape == want[key].shape == (
            tcfg.n_layers, 2, frames.shape[1], tcfg.n_kv_heads,
            tcfg.resolved_head_dim)
        _within_a_unit(got[key], want[key])


def _greedy_from_jax(jcfg, tcfg, jp, tp, cache, prompts, gen):
    """JAX's serve loop (greedy after the prompt), and at every step one
    port ``serve_step`` from JAX's cache, held to JAX's logits and cache.
    Returns JAX's generated tokens (B, gen)."""
    step = jax.jit(lambda p, c, bt: jm.serve_step(p, c, bt, jcfg))
    b, plen = prompts.shape
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
        assert set(tnew) == set(cache)
        flips = 0
        for key in tnew:
            a, w = _np(tnew[key]), _np(cache[key])
            if key in ("enc_k", "enc_v"):       # never written in decode
                assert tnew[key] is tcache[key]
                np.testing.assert_array_equal(a, w)
                continue
            off = a != w
            flips += int(off.sum())
            assert np.all(np.abs(a - w)[off]
                          <= BF16_UNIT * np.abs(w)[off] + 1e-6)
        _close(got, logits, TOL if flips == 0 else CACHE_FLIP_TOL)
        tok = np.array(jnp.argmax(logits, axis=-1))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("enc_len", [32, 0])
def test_serve_steps_from_jax_cache_match_jax(seamless, enc_len):
    """Six steps of greedy decode from JAX's filled cache, each port step
    from JAX's cache; without ``enc_len`` the cache has no memory and the
    steps skip cross-attention, in both packages."""
    jcfg, tcfg, jp, tp, frames, _ = seamless
    cache = jm.init_cache(jcfg, 1, 2, 6, enc_len=enc_len)
    if enc_len:
        cache = jm.fill_enc_cache(jp, cache, jnp.asarray(frames), jcfg)
    assert ("enc_k" in cache) == bool(enc_len)
    prompts = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 3))
    _greedy_from_jax(jcfg, tcfg, jp, tp, cache, prompts, 3)


def test_seamless_forward_matches_jax(seamless, jax_memory):
    jcfg, tcfg, jp, tp, frames, _ = seamless
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 40))
    want, _ = jax.jit(lambda p, b: jm.forward(p, b, jcfg))(
        jp, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})
    got, aux = tm.forward(tp, {"tokens": _t(tokens), "frames": _t(frames)},
                          tcfg, device="cpu")
    assert got.shape == (2, 40, jcfg.vocab) and float(aux) == 0.0
    _close(got, want, LOGIT_TOL)


def test_seamless_greedy_generate_matches_jax(seamless, jax_memory):
    """JAX's serve loop from its filled cache (8 prompt tokens, 8 greedy
    ones); the port's ``generate`` on the same prompts and frames gives
    the same tokens, and raises without frames."""
    jcfg, tcfg, jp, tp, frames, _ = seamless
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 8))
    cache = jm.fill_enc_cache(
        jp, jm.init_cache(jcfg, 1, 2, 16, enc_len=frames.shape[1]),
        jnp.asarray(frames), jcfg)
    want = _greedy_from_jax(jcfg, tcfg, jp, tp, cache, prompts, 8)
    res = serve.generate(tp, tcfg, prompts, 8, frames=frames, device="cpu")
    np.testing.assert_array_equal(res.tokens, want)
    with pytest.raises(ValueError, match="frames"):
        serve.generate(tp, tcfg, prompts, 1, device="cpu")


# ------------------------------------------------------ vision-language

@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = _cfgs(QWEN)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _jparams(jp)


def _positions3(f, s):
    """Qwen2-VL's (t, h, w) positions of a 4-wide patch grid of ``f``
    patches followed by ``s`` text tokens, whose three streams continue
    from the grid's largest position plus one; (1, 3, f + s)."""
    grid = np.stack([np.zeros(f, int), np.arange(f) // 4, np.arange(f) % 4])
    text = np.arange(s) + grid.max() + 1
    return np.concatenate([grid, np.tile(text, (3, 1))], axis=1)[None]


def test_qwen2_vl_forward_with_patches_matches_jax(qwen):
    """16 patches prepended to 48 tokens (S 64, as JAX's chunked attention
    takes it); logits of the 48 text positions."""
    jcfg, tcfg, jp, tp = qwen
    rng = np.random.default_rng(9)
    f, s = jcfg.frontend_tokens, 48
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, s)),
             "patches": rng.standard_normal((2, f, jcfg.d_model)).astype(
                 np.float32),
             "positions3": np.repeat(_positions3(f, s), 2, axis=0)}
    want, _ = jax.jit(lambda p, b: jm.forward(p, b, jcfg))(
        jp, {k: jnp.asarray(x) for k, x in batch.items()})
    got, _ = tm.forward(tp, {k: _t(x) for k, x in batch.items()}, tcfg,
                        device="cpu")
    assert got.shape == (2, s, jcfg.vocab)
    _close(got, want, LOGIT_TOL)


def test_qwen2_vl_greedy_decode_matches_jax(qwen):
    """Text decode, t = h = w = the position: JAX's serve loop (8 prompt
    tokens, 8 greedy), each port step from JAX's cache, then the port's
    ``generate``."""
    jcfg, tcfg, jp, tp = qwen
    prompts = np.random.default_rng(10).integers(0, jcfg.vocab, (2, 8))
    want = _greedy_from_jax(jcfg, tcfg, jp, tp,
                            jm.init_cache(jcfg, 1, 2, 16), prompts, 8)
    res = serve.generate(tp, tcfg, prompts, 8, device="cpu")
    np.testing.assert_array_equal(res.tokens, want)


# -------------------------------------------------------------- trees

@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_cache_trees_key_for_key(arch, request):
    """The port's own init and decode cache have JAX's keys, shapes and
    dtypes (the encoder-decoder's ``enc_layers``, ``enc_norm``,
    ``layers/cross``, ``layers/ln_cross``, ``enc_k`` / ``enc_v``); a JAX
    param tree converts and back bit for bit."""
    jcfg, tcfg, jp = request.getfixturevalue(
        "seamless" if arch == SEAMLESS else "qwen")[:3]
    jp = jax.tree.map(np.asarray, jp)
    own = convert.params_to_numpy(tm.init_params(
        torch.Generator().manual_seed(0), tcfg, device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(own)):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
    back = convert.params_to_numpy(convert.params_from_numpy(jp))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    if tcfg.enc_dec:
        assert {"enc_layers", "enc_norm"} <= set(own)
        assert {"cross", "ln_cross"} <= set(own["layers"])
    jc = convert.cache_from_numpy(jax.tree.map(
        np.asarray, jm.init_cache(jcfg, 1, 2, 16, enc_len=8)))
    tc = tm.init_cache(tcfg, 2, 16, device="cpu", enc_len=8)
    assert {k: (v.dtype, v.shape) for k, v in tc.items()} == {
        k: (v.dtype, v.shape) for k, v in jc.items()}
    assert ("enc_k" in tc) == tcfg.enc_dec


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(capsys, arch):
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                "--prompt-len", "3", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"{arch} (reduced, cpu)" in out and "tok/s" in out
