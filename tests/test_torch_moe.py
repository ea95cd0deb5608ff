"""The port's gated, qk-norm and MoE decoder families against the JAX
package on the CPU: ``moe_apply``, the gated FFNs, a qk-norm attention
block, a MoE block (``block_apply``, ``block_decode``), and the REDUCED
OLMoE-1B-7B, Qwen3-MoE-235B-A22B, Gemma-7B, Minitron-4B and Qwen3-32B
models (``forward``, ``serve_step``, ``generate``) against
``repro.models`` with converted params. Full-sequence attention goes
through ``ops.flash_attention``, whose CPU branch is the plain dense
version; JAX's model runs ``chunked_attention``.

Tolerances:
- Layers and ``moe_apply``, float32: 1e-5 absolute (float32 sums in
  another order; the combine sums a token's k contributions in gate
  order, JAX's scatter-add in expert order).
- Model, float32: logits 1e-4 for ``forward`` and for every
  ``serve_step`` from JAX's cache, the aux loss 1e-5; greedy tokens
  identical (measured: logits within 6.4e-6, aux equal). The caches hold
  K and V in bfloat16 (as in the JAX package): where a step's new entry
  rounds to the neighbouring bfloat16 value (one unit, 2^-8 relative;
  near 0, within 1e-6), its logits are held to 1e-3 (measured 2.8e-4
  with qk-norm, whose unit-RMS keys make such roundings likelier).
- Model, bfloat16: bf16 rounds at other places in the two frameworks,
  and the float32 router of a MoE layer then sees inputs that differ by
  a rounding: a near-tie flips one top-k choice now and then, and the
  token takes another expert; with capacity drops (the REDUCED loads
  reach 195 of 192 slots) that also moves which later tokens an expert
  drops. Measured on seeds 0-3 (REDUCED, 2 x 128 tokens, |logits| <=
  5.1): dense max |diff| 0.061-0.070, mean 0.0093-0.0101; MoE 0-4 of
  256 tokens routed to another expert set (over both layers), tokens
  before the first such token (in the dispatch's token order) max
  0.031-0.078, every token's mean 0.0097-0.021, max 0.076-2.6. The bound:
  dense max 0.3 and mean 0.02, as for StarCoder2; MoE at most 8 tokens
  rerouted, max 0.3 before the first, mean 0.03 over all.
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import serve  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tests: the suite runs in
    several worker processes at once, and a torch that takes every core
    in each of them makes the workers contend for the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b", "gemma-7b", "minitron-4b",
         "qwen3-32b")
MOE_ARCHS = ARCHS[:2]
TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_MAX, BF16_MEAN = 0.3, 0.02
MOE_BF16_MEAN, MOE_MAX_REROUTED = 0.03, 8
CACHE_FLIP_TOL = 1e-3


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(arch, reduced=True), dtype=dtype))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


def _jparams(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree))


# ------------------------------------------------------------ configs

def test_registry_holds_the_ported_archs():
    """Every LM arch of the JAX package's registry (all but the TIG
    workload ``speed-tig``), and these five among them."""
    assert list_archs() == [a for a in jax_archs() if a != "speed-tig"]
    assert set(ARCHS) <= set(list_archs())
    full = get_config("olmoe-1b-7b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_experts,
            full.top_k, full.d_ff_expert, full.vocab, full.qk_norm,
            full.is_moe) == (16, 2048, 16, 64, 8, 1024, 50_304, True, True)
    gemma = get_config("gemma-7b")
    assert (gemma.resolved_head_dim, gemma.act, gemma.tie_embeddings,
            gemma.is_moe) == (256, "geglu", True, False)
    hymba = get_config("hymba-1.5b")
    assert (hymba.family, hymba.n_layers, hymba.d_model, hymba.n_heads,
            hymba.n_kv_heads, hymba.resolved_head_dim, hymba.window,
            hymba.ssm_state, hymba.vocab) == ("hybrid", 32, 1600, 25, 5, 64,
                                              1024, 16, 32_001)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies(arch):
    """Every field of the port's ArchConfig has the JAX config's value."""
    for reduced in (False, True):
        a = dataclasses.asdict(jax_config(arch, reduced=reduced))
        b = dataclasses.asdict(get_config(arch, reduced=reduced))
        assert b == {name: a[name] for name in b}
        assert get_config(arch, reduced=reduced).is_moe == (
            jax_config(arch, reduced=reduced).is_moe)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_round_trips_key_for_key(arch):
    """The MoE (``layers/moe/router/w``, ``layers/moe/wi|wg|wo`` as (L, E,
    ., .)), qk-norm (``layers/attn/qn|kn/g``) and tied (no ``lm_head``)
    trees: the port's own init has JAX's keys, shapes and dtypes, and a
    JAX tree converts to tensors and back bit for bit."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    own = convert.params_to_numpy(tm.init_params(
        torch.Generator().manual_seed(0), tcfg, device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(own)):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
    back = convert.params_to_numpy(convert.params_from_numpy(jp))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert ("lm_head" in own) == (not tcfg.tie_embeddings)
    assert ("qn" in own["layers"]["attn"]) == tcfg.qk_norm
    if tcfg.is_moe:
        assert own["layers"]["moe"]["wi"].shape == (
            tcfg.n_layers, tcfg.n_experts, tcfg.d_model, tcfg.d_ff_expert)


# ---------------------------------------------------------------- MoE

# (T, E, k, act, capacity factor, dropless, an expert without a token,
# whether an expert overflows)
MOE_CASES = {
    "drops": (64, 4, 2, "swiglu", 0.5, False, False, True),
    "drops, top-1, ragged": (37, 8, 1, "geglu", 1.0, False, False, True),
    # ceil(150 / 6) x 1.1 = 27.5 slots, cut to 27; the largest load is 28
    "capacity cut by int()": (50, 6, 3, "swiglu", 1.1, False, False, True),
    "dropless": (40, 4, 2, "swiglu", 1.25, True, False, False),
    "an expert without a token": (48, 4, 2, "swiglu", 0.75, False, True,
                                  True),
    "ungated, relu_sq": (33, 4, 2, "relu_sq", 1.5, False, False, False),
    "top-k of many experts": (24, 16, 8, "swiglu", 1.5, False, False,
                              False),
}


def _moe_case(t, e, k, act, idle, seed=0, d=32, d_ff=48):
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed), d,
                                                d_ff, e, act))
    x = rng.standard_normal((t, d)).astype(np.float32)
    if idle:
        # a constant feature the last expert's router weight reads with a
        # large negative weight: its logit is far below every other's
        x[:, 0] = 3.0
        w = jp["router"]["w"].copy()
        w[:, -1] = 0.0
        w[0, -1] = -20.0
        jp["router"]["w"] = w
    return jp, x


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    t, e, k, act, cf, dropless, idle, overflows = MOE_CASES[case]
    jp, x = _moe_case(t, e, k, act, idle)
    want, want_aux = jmoe.moe_apply(jp, jnp.asarray(x), top_k=k, act=act,
                                    capacity_factor=cf, dropless=dropless)
    got, aux = tmoe.moe_apply(convert.params_from_numpy(jp),
                              torch.from_numpy(x), top_k=k, act=act,
                              capacity_factor=cf, dropless=dropless)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)
    # what the case is about: the routing the port saw
    cap = tmoe.capacity(t, k, e, cf, dropless)
    assert cap == (t if dropless else
                   int(max(1, -(-t * k // e) * cf)))
    top_i = torch.topk(torch.softmax(torch.from_numpy(x) @ torch.tensor(
        jp["router"]["w"]), -1), k, -1).indices
    load = torch.bincount(top_i.reshape(-1), minlength=e)
    dropped = int((load - cap).clamp(min=0).sum())
    assert (dropped > 0) == overflows, (load, cap)
    if idle:
        assert int(load[-1]) == 0
    if dropless:
        assert dropped == 0 and cap == t


def test_moe_apply_is_deterministic():
    """Two calls agree bit for bit (the combine has no atomics)."""
    jp, x = _moe_case(64, 4, 2, "swiglu", False, seed=1)
    p, xt = convert.params_from_numpy(jp), torch.from_numpy(x)
    a = tmoe.moe_apply(p, xt, top_k=2, act="swiglu", capacity_factor=0.5)
    b = tmoe.moe_apply(p, xt, top_k=2, act="swiglu", capacity_factor=0.5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------------------- layers

@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu_sq"])
def test_ffn_matches_jax(act):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jp = jl.ffn_init(jax.random.PRNGKey(1), 64, 96, act)
    tp = _jparams(jp)
    assert ("wg" in tp) == (act != "relu_sq")
    own = tl.ffn_init(torch.Generator().manual_seed(0), 64, 96, act)
    assert sorted(own) == sorted(tp)
    _close(tl.ffn_apply(tp, torch.from_numpy(x), act),
           jl.ffn_apply(jp, jnp.asarray(x), act))


def test_qk_norm_block_matches_jax():
    """A Qwen3-32B block (GQA 8 / 2, qk-norm, SwiGLU), float32."""
    jcfg, tcfg = _cfgs("qwen3-32b", "float32")
    pd = jt.pad_dims(jcfg, 1)
    jp = jt.block_init(jax.random.PRNGKey(3), jcfg, pd)
    assert "qn" in jp["attn"] and "wg" in jp["ffn"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(40), (2, 1))
    want, _ = jt.block_apply(jp, jcfg, pd, jnp.asarray(x), jnp.asarray(pos))
    got, aux = tt.block_apply(_jparams(jp), tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos))
    _close(got, want, LOGIT_TOL)
    assert float(aux) == 0.0
    # the qk-norm itself: q and k RMS-normed per head before RoPE
    q, k, _ = tt._project_qkv(_jparams(jp)["attn"], tcfg,
                              torch.from_numpy(x), torch.from_numpy(pos))
    jq, jk, _ = jt._project_qkv(jp["attn"], jcfg, pd, jnp.asarray(x),
                                jnp.asarray(pos))
    _close(q, jq)
    _close(k, jk)


@pytest.mark.parametrize("batch", [2, 12])
def test_moe_block_matches_jax(batch):
    """An OLMoE block: ``block_apply`` (x and the aux loss) over a prompt,
    then one ``block_decode`` step from the same cache; at batch 2 decode
    is dropless (B k <= 4 E), at 12 it takes the decode capacity."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b", "float32")
    pd = jt.pad_dims(jcfg, 1)
    assert (batch * jcfg.top_k <= 4 * jcfg.n_experts) == (batch == 2)
    jp = jt.block_init(jax.random.PRNGKey(4), jcfg, pd)
    tp = _jparams(jp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((batch, 24, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(24), (batch, 1))
    want, want_aux = jt.block_apply(jp, jcfg, pd, jnp.asarray(x),
                                    jnp.asarray(pos))
    got, aux = tt.block_apply(tp, tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos))
    _close(got, want, LOGIT_TOL)
    _close(aux, want_aux)

    cache = jt.init_block_cache(jcfg, pd, batch, 32)
    kc = rng.standard_normal(cache["k"].shape).astype(np.float32)
    vc = rng.standard_normal(cache["v"].shape).astype(np.float32)
    cache = {"k": jnp.asarray(kc, jnp.bfloat16),
             "v": jnp.asarray(vc, jnp.bfloat16)}
    x1 = rng.standard_normal((batch, 1, jcfg.d_model)).astype(np.float32)
    p1 = np.full((batch,), 20, np.int32)
    want, wc = jt.block_decode(jp, jcfg, pd, jnp.asarray(x1),
                               jnp.asarray(p1), cache)
    got, gc = tt.block_decode(tp, tcfg, torch.from_numpy(x1),
                              torch.from_numpy(p1).long(),
                              convert.cache_from_numpy(
                                  jax.tree.map(np.asarray, cache)))
    _close(got, want, LOGIT_TOL)
    _close(gc["k"], wc["k"], 0.0)


# -------------------------------------------------------------- model

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _cfgs(request.param, "float32")
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _jparams(jp)


def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 96))
    want, want_aux = jax.jit(lambda p, t: jm.forward(
        p, {"tokens": t}, jcfg))(jp, jnp.asarray(tokens))
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg,
                          device="cpu")
    assert got.dtype == torch.float32 and got.shape == (2, 96, jcfg.vocab)
    _close(got, want, LOGIT_TOL)
    _close(aux, want_aux)
    assert (float(aux) > 0) == tcfg.is_moe


def test_greedy_decode_matches_jax(model):
    """The serve_lm loop (8 prompt tokens, 8 greedy ones) in JAX; at every
    step one port ``serve_step`` from JAX's cache; then the port's
    ``generate`` on the same prompts."""
    jcfg, tcfg, jp, tp = model
    b, plen, gen = 2, 8, 8
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
        # the step's new K / V entries are stored in bfloat16: where a
        # last-bit float32 difference rounds one to the next bfloat16
        # value (or, near 0, to another tiny one), the logits move by up
        # to that entry's share
        flips = 0
        for key in ("k", "v"):
            a, w = _np(tnew[key]), _np(cache[key])
            off = a != w
            flips += int(off.sum())
            assert np.all(np.abs(a - w)[off]
                          <= 2.0 ** -7 * np.abs(w)[off] + 1e-6)
        _close(got, logits, LOGIT_TOL if flips == 0 else CACHE_FLIP_TOL)
        tok = np.array(jnp.argmax(logits[:, :jcfg.vocab], axis=-1))
    res = serve.generate(tp, tcfg, prompts, gen, device="cpu")
    np.testing.assert_array_equal(res.tokens, np.stack(out, axis=1))


def _expert_sets(monkeypatch):
    """Record each MoE layer's top-k expert sets, (T, k) sorted, of both
    packages' forwards (the JAX one run eagerly)."""
    seen = {"jax": [], "port": []}
    jax_moe, port_moe = jt.moe_apply, tt.moe_apply

    def jax_rec(p, x, **kw):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"]["w"], -1)
        seen["jax"].append(np.sort(np.asarray(
            jax.lax.top_k(probs, kw["top_k"])[1]), -1))
        return jax_moe(p, x, **kw)

    def port_rec(p, x, **kw):
        probs = torch.softmax(x.float() @ p["router"]["w"], -1)
        seen["port"].append(np.sort(torch.topk(
            probs, kw["top_k"], -1).indices.numpy(), -1))
        return port_moe(p, x, **kw)

    monkeypatch.setattr(jt, "moe_apply", jax_rec)
    monkeypatch.setattr(tt, "moe_apply", port_rec)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_within_bound(arch, monkeypatch):
    """bfloat16 ``forward`` on seeds 0-3 within the module's bound; MoE:
    the tokens routed to another expert set are counted, and the tokens
    before the first of them held to the dense bound."""
    seen = _expert_sets(monkeypatch)
    # remat off: it changes no value, and lets the JAX forward run eagerly
    jcfg, tcfg = _cfgs(arch, "bfloat16", remat=False)
    for seed in range(4):
        for v in seen.values():
            v.clear()
        jp = jm.init_params(jax.random.PRNGKey(seed), jcfg)
        tokens = np.random.default_rng(seed).integers(0, jcfg.vocab, (2, 128))
        with jax.disable_jit():
            want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
        got, _ = tm.forward(_jparams(jp), {"tokens": torch.from_numpy(
            tokens)}, tcfg, device="cpu")
        assert got.dtype == torch.bfloat16
        diff = np.abs(_np(got) - _np(want)).reshape(2 * 128, -1)
        if not tcfg.is_moe:
            assert diff.max() <= BF16_MAX and diff.mean() <= BF16_MEAN, (
                seed, diff.max(), diff.mean())
            continue
        assert len(seen["jax"]) == len(seen["port"]) == tcfg.n_layers
        rerouted = np.any([(a != b).any(-1) for a, b in
                           zip(seen["jax"], seen["port"])], axis=0)
        first = int(rerouted.argmax()) if rerouted.any() else len(rerouted)
        assert int(rerouted.sum()) <= MOE_MAX_REROUTED, (seed, rerouted.sum())
        assert diff[:first].max() <= BF16_MAX, (seed, diff[:first].max())
        assert diff.mean() <= MOE_BF16_MEAN, (seed, diff.mean())


def test_serve_cli_moe_on_cpu(capsys):
    serve.main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "3", "--gen", "4"])
    out = capsys.readouterr().out
    assert "olmoe-1b-7b (reduced, cpu)" in out and "tok/s" in out
