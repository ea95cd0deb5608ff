"""LM training of the port against the JAX package on the CPU: ``loss_fn``
and its gradients for every family, one ``make_train_step`` step with
``sgd`` and with ``train_lm``'s AdamW and schedule, ``microbatch`` 2,
``remat`` and the per-layer split of the stacked params, the plain flash
attention backward, the card's autograd glue of flash attention, WKV and
the selective scan (with plain versions in the kernels' place), REDUCED
RWKV6 and hymba training steps through that glue against the CPU's, and
the MoE dispatch's backward over dropped tokens. REDUCED configs, float32 unless stated, params from
the JAX package through ``convert.params_from_numpy``.

Tolerances:
- loss, ce and aux: 1e-5 relative (float32 sums in another order);
  every gradient leaf within 1e-4 of its largest |JAX| (the same, over
  a backward pass).
- SeamlessM4T: its encoder runs in bfloat16 whatever the config's
  dtype, in both packages, and JAX rounds the encoder's attention
  probabilities to bfloat16 where the port does not. So both sides take
  JAX's encoder memory as the value of their own encoder's output (the
  gradient still flows through each side's encoder), and the loss and
  the decoder's gradients are held as above; the gradients computed in
  bfloat16 (the encoder's, and the cross-attention's K and V
  projections of the bfloat16 memory) within 2e-2 of their largest
  |JAX| (measured at most 9.3e-3, seed 1).
- bfloat16 StarCoder2: loss within 1e-2 relative; JAX rounds the
  attention probabilities to bfloat16 before P V
  (``chunked_attention``), the port does not.
- one step: ``sgd`` params within 1e-5 of each leaf's largest |JAX|;
  AdamW within 2 lr_t per element (a first Adam step moves each element
  by about lr_t sign(g), so a gradient near 0 may flip it).
- ``remat`` and the split: bitwise (the same operations).
- the plain flash backward against autograd of the plain forward: 1e-5
  of the largest |autograd| (float32, another order of the sums).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tests: the suite runs in
    several worker processes at once, and a torch that takes every core
    in each of them makes the workers contend for the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = ("starcoder2-3b", "minitron-4b", "qwen3-32b", "gemma-7b",
            "olmoe-1b-7b", "seamless-m4t-medium", "qwen2-vl-7b",
            "rwkv6-1.6b", "hymba-1.5b")
LOSS_REL, GRAD_REL = 1e-5, 1e-4
BF16_GRAD_REL = 2e-2        # seamless's bfloat16 encoder path
BF16_PATH = ("['enc_layers']", "['enc_norm']", "['layers']['cross']['wk']",
             "['layers']['cross']['wv']")


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(arch, reduced=True), dtype=dtype,
                                **kw))


def _batch(cfg, seed=0, b=2, s=32):
    """Tokens and next-token targets (a few masked with -1), plus the
    encoder-decoder's frames or the vision-language family's patches and
    their (t, h, w) positions, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[0, :3] = -1
    batch = {"tokens": toks[:, :-1], "targets": targets}
    f = 16
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (b, f, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (b, f, cfg.d_model)).astype(np.float32)
        side = 4
        idx = np.arange(f)
        grid = np.stack([np.zeros(f, np.int32), idx // side, idx % side])
        text = np.broadcast_to(np.arange(s) + side, (3, s))
        batch["positions3"] = np.broadcast_to(
            np.concatenate([grid, text], 1), (b, 3, f + s)).astype(np.int32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _port_grads(params, batch, cfg):
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss, (ce, aux) = tm.loss_fn(live, _port_batch(batch), cfg,
                                 device="cpu")
    grads = torch.autograd.grad(loss, tree_leaves(live))
    it = iter(grads)
    return loss, ce, aux, tree_map(lambda _: next(it), live)


def _close_rel(got, want, rel, what):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    lim = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{what}: max |diff| {err:.3g} > {lim:.3g}"


@pytest.fixture(scope="module")
def jax_grads():
    """jax.value_and_grad of the JAX ``loss_fn``, jitted per config."""
    return jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True),
                   static_argnums=2)


def _swap_memory(monkeypatch, jp, batch, jcfg):
    """Both packages' ``encode`` give JAX's encoder memory as their value
    and their own encoder's gradient (the value swapped in with a
    stop-gradient difference)."""
    mem = np.asarray(jm.encode(jp, jnp.asarray(batch["frames"]), jcfg),
                     np.float32)
    jenc, tenc = jm.encode, tm.encode

    def jswap(params, frames, cfg, tp=1):
        e = jenc(params, frames, cfg, tp)
        return jnp.asarray(mem, e.dtype) + (e - jax.lax.stop_gradient(e))

    def tswap(params, frames, cfg, device=None):
        e = tenc(params, frames, cfg, device)
        return torch.from_numpy(mem).to(e.dtype) + (e - e.detach())

    monkeypatch.setattr(jm, "encode", jswap)
    monkeypatch.setattr(tm, "encode", tswap)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch, jax_grads, monkeypatch):
    jcfg, tcfg = _cfgs(arch)
    jp = jm.init_params(jax.random.PRNGKey(1), jcfg)
    batch = _batch(jcfg)
    if jcfg.enc_dec:
        _swap_memory(monkeypatch, jp, batch, jcfg)
        # traced here, with the swap
        jax_grads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True),
                            static_argnums=2)
    (jloss, (jce, jaux)), jg = jax_grads(jp, _jax_batch(batch), jcfg)
    loss, ce, aux, tg = _port_grads(convert.params_from_numpy(_np(jp)),
                                    batch, tcfg)
    for what, a, b in (("loss", loss, jloss), ("ce", ce, jce),
                       ("aux", aux, jaux)):
        np.testing.assert_allclose(float(a.detach()), float(b),
                                   rtol=LOSS_REL, atol=1e-7, err_msg=what)
    if tcfg.is_moe:
        assert float(aux.detach()) > 0
    flat_j = jax.tree_util.tree_flatten_with_path(_np(jg))[0]
    flat_t = tree_leaves(tg)
    assert len(flat_j) == len(flat_t)
    for (path, want), got in zip(flat_j, flat_t):
        name = jax.tree_util.keystr(path)
        assert tuple(got.shape) == want.shape, name
        bf16 = jcfg.enc_dec and name.startswith(BF16_PATH)
        _close_rel(got, want, BF16_GRAD_REL if bf16 else GRAD_REL,
                   f"{arch} d{name}")


def test_bf16_starcoder2_loss_within_bound(jax_grads):
    jcfg, tcfg = _cfgs("starcoder2-3b", dtype="bfloat16")
    jp = jm.init_params(jax.random.PRNGKey(1), jcfg)
    batch = _batch(jcfg)
    (jloss, _), _ = jax_grads(jp, _jax_batch(batch), jcfg)
    loss, _, _, tg = _port_grads(convert.params_from_numpy(_np(jp)), batch,
                                 tcfg)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-2 * abs(
        float(jloss))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(tg))


def _one_step(arch, jopt, topt, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = jm.init_params(jax.random.PRNGKey(2), jcfg)
    tp = convert.params_from_numpy(_np(jp))
    js, ts = jopt.init(jp), topt.init(tp)
    batch = _batch(jcfg, seed=3, b=4)
    jp, js, jmet = jax.jit(jm.make_train_step(jcfg, jopt))(
        jp, js, _jax_batch(batch))
    tp2, ts, tmet = tm.make_train_step(tcfg, topt, device="cpu")(
        tp, ts, _port_batch(batch))
    assert tp2 is tp                         # updated in place
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=LOSS_REL)
    assert int(ts["step"]) == int(js["step"]) == 1
    return _np(jp), tp


@pytest.mark.parametrize("arch", ["starcoder2-3b", "olmoe-1b-7b"])
def test_sgd_step_matches_jax(arch):
    want, got = _one_step(arch, joptim.sgd(0.5), toptim.sgd(0.5))
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        _close_rel(g, w, 1e-5, arch)


def test_adamw_schedule_step_matches_jax():
    """``train_lm``'s optimizer, at a step whose lr_t is 1/20 of lr."""
    lr, steps = 3e-3, 50

    def make(o):
        return o.adamw(lr=o.linear_warmup_cosine(lr, 20, steps),
                       weight_decay=0.1, max_grad_norm=1.0)

    want, got = _one_step("starcoder2-3b", make(joptim), make(toptim))
    lr_t = lr * 1 / 20
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert float(np.abs(g.numpy() - w).max()) <= 2 * lr_t


def test_microbatch_step_matches_jax():
    want, got = _one_step("starcoder2-3b", joptim.sgd(0.5),
                          toptim.sgd(0.5), microbatch=2)
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        _close_rel(g, w, 1e-5, "microbatch 2")


@pytest.fixture
def one_thread():
    """One intra-op thread: multi-threaded CPU sums are not bitwise
    reproducible from call to call."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads_of(arch, **kw):
    _, cfg = _cfgs(arch, **kw)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    loss, _, _, g = _port_grads(params, _batch(cfg), cfg)
    return loss, tree_leaves(g)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "seamless-m4t-medium"])
def test_remat_is_bitwise(arch, one_thread):
    on, g_on = _grads_of(arch, remat=True)
    off, g_off = _grads_of(arch, remat=False)
    assert torch.equal(on, off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


def test_layer_split_is_bitwise_indexing(monkeypatch, one_thread):
    """The per-layer views by ``torch.unbind`` give the gradients that
    indexing each layer gives, bit for bit."""
    loss, g = _grads_of("olmoe-1b-7b")
    monkeypatch.setattr(tm, "_layers", lambda tree, n: [
        tm._layer(tree, i) for i in range(n)])
    loss_i, g_i = _grads_of("olmoe-1b-7b")
    assert torch.equal(loss, loss_i)
    assert all(torch.equal(a, b) for a, b in zip(g, g_i))


# ------------------------------------------------- flash attention backward

FLASH_BWD = {   # (B, Sq, Sk, H, Hkv, D, window, causal)
    "gqa window": (2, 40, 40, 6, 2, 16, 9, True),
    "causal": (1, 33, 33, 4, 4, 8, None, True),
    "cross, Sk > Sq": (2, 13, 29, 4, 2, 8, None, False),
    "cross, Sk < Sq": (1, 31, 7, 3, 1, 12, None, False),
}


def _flash_inputs(b, sq, sk, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d),
                          (b, sq, h, d))]


def _plain_bwd_model_layout(q, k, v, o, lse, do, causal, window):
    """``ref.flash_attention_bwd_ref`` in the model's layout: K and V
    repeated kv-major, dk and dv summed over each KV group."""
    group = q.shape[2] // k.shape[2]
    qh, kh, vh, oh, doh = (x.transpose(1, 2) for x in (
        q, k.repeat_interleave(group, 2), v.repeat_interleave(group, 2), o,
        do))
    dq, dk, dv = ref.flash_attention_bwd_ref(qh, kh, vh, oh, lse, doh,
                                             causal=causal, window=window)
    b, hq, sk, d = dk.shape

    def per_kv(x):
        return x.view(b, hq // group, group, sk, d).sum(2).transpose(1, 2)

    return dq.transpose(1, 2), per_kv(dk), per_kv(dv)


@pytest.mark.parametrize("case", list(FLASH_BWD))
def test_plain_flash_backward_matches_autograd(case):
    b, sq, sk, h, hkv, d, window, causal = FLASH_BWD[case]
    q, k, v, do = _flash_inputs(b, sq, sk, h, hkv, d)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(o, leaves, do)
    for lse in (None, "given"):
        if lse is not None:      # the forward's rows' log-sum-exp
            s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(
                h // hkv, 2)) / math.sqrt(d)
            m = ref.attention_mask(sq, sk, causal, window, q.device)
            lse = torch.logsumexp(s.masked_fill(~m, -torch.inf), -1)
        got = _plain_bwd_model_layout(q, k, v, o.detach(), lse, do, causal,
                                      window)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == w.shape
            _close_rel(a, w.numpy(), 1e-5, f"{case} {name}")


def _fake_kernels(monkeypatch):
    """The card's branch of ``ops`` on CPU tensors, with model-layout
    plain versions in the flash kernels' place; counts their calls."""
    calls = {"fwd": 0, "lse": 0, "bwd": 0}

    def fwd(q, k, v, *, causal=True, window=None, return_lse=False):
        calls["fwd"] += 1
        group = q.shape[2] // k.shape[2]
        qh, kh, vh = (x.transpose(1, 2) for x in (
            q, k.repeat_interleave(group, 2), v.repeat_interleave(group, 2)))
        o = ref.flash_attention_ref(qh, kh, vh, causal=causal,
                                    window=window).transpose(1, 2)
        if not return_lse:
            return o
        calls["lse"] += 1
        s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(q.shape[-1])
        m = ref.attention_mask(q.shape[1], k.shape[1], causal, window,
                                q.device)
        return o, torch.logsumexp(s.masked_fill(~m, -torch.inf), -1)

    def bwd(q, k, v, o, lse, do, *, causal=True, window=None):
        calls["bwd"] += 1
        return _plain_bwd_model_layout(q, k, v, o, lse, do, causal, window)

    monkeypatch.setattr(ops, "_route", lambda x: "cuda")
    monkeypatch.setattr(ops, "flash_attention_fwd", fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd", bwd)
    return calls


def test_flash_autograd_glue(monkeypatch):
    """``ops.flash_attention``'s card branch: no log-sum-exp without a
    gradient; under autograd ``FlashAttention`` saves the forward's lse
    and its backward gives the plain autograd's dq, dk, dv (dk, dv per KV
    head)."""
    b, sq, sk, h, hkv, d, window, causal = FLASH_BWD["gqa window"]
    q, k, v, do = _flash_inputs(b, sq, sk, h, hkv, d, seed=1)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(ops.flash_attention(
        *leaves, causal=causal, window=window), leaves, do)
    calls = _fake_kernels(monkeypatch)
    with torch.no_grad():
        ops.flash_attention(*leaves, causal=causal, window=window)
    assert calls == {"fwd": 1, "lse": 0, "bwd": 0}
    o = ops.flash_attention(*leaves, causal=causal, window=window)
    assert o.grad_fn is not None and "FlashAttention" in type(
        o.grad_fn).__name__
    got = torch.autograd.grad(o, leaves, do)
    assert calls == {"fwd": 2, "lse": 1, "bwd": 1}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close_rel(a, w.numpy(), 1e-5, name)


def _fake_recurrences(monkeypatch):
    """The card's branch of ``ops.rwkv6`` and ``ops.selective_scan`` on
    CPU tensors, with model-layout plain versions in the forward and
    backward kernels' place; counts their calls."""
    calls = {"rwkv6": 0, "rwkv6_bwd": 0, "scan": 0, "scan_bwd": 0}

    def heads(*xs):      # (B, S, H, D) <-> (B, H, S, D)
        return [x.transpose(1, 2) for x in xs]

    def rwkv6_fwd(r, k, v, w, u, state=None, *, out_dtype=torch.float32):
        calls["rwkv6"] += 1
        o, st = ref.rwkv6_ref(*heads(r, k, v, w), u, state=state,
                              return_state=True)
        return o.transpose(1, 2).to(out_dtype), st

    def rwkv6_bwd(r, k, v, w, u, do, state=None, dstate=None):
        calls["rwkv6_bwd"] += 1
        assert do.dtype == torch.float32
        dr, dk, dv, dw, du, ds0 = ref.rwkv6_bwd_ref(
            *heads(r, k, v, w), u, *heads(do), state=state, dstate=dstate)
        return (*heads(dr, dk, dv, dw), du, ds0)

    def scan_fwd(x, dt, b, c, a, state=None):
        calls["scan"] += 1
        return ref.selective_scan_ref(x, dt, b, c, a, state=state)

    def scan_bwd(x, dt, b, c, a, dy, state=None, dstate=None):
        calls["scan_bwd"] += 1
        assert dy.dtype == torch.float32
        return ref.selective_scan_bwd_ref(x, dt, b, c, a, dy, state=state,
                                          dstate=dstate)

    monkeypatch.setattr(ops, "_route", lambda x: "cuda")
    monkeypatch.setattr(ops, "rwkv6_fwd", rwkv6_fwd)
    monkeypatch.setattr(ops, "rwkv6_bwd", rwkv6_bwd)
    monkeypatch.setattr(ops, "selective_scan_fwd", scan_fwd)
    monkeypatch.setattr(ops, "selective_scan_bwd", scan_bwd)
    return calls


def _grads_vs(fn, args, cots):
    leaves = [x.clone().requires_grad_(True) for x in args]
    outs = fn(*leaves)
    assert all(o.grad_fn is not None for o in outs)
    return outs, torch.autograd.grad(outs, leaves, cots)


def test_rwkv6_autograd_glue(monkeypatch):
    """``ops.rwkv6``'s card branch: the forward kernel alone under
    ``no_grad``; under autograd ``RWKV6``, whose backward (the backward
    kernel) gives the gradients of r, k, v, w, u and the initial state
    that autograd gives through the CPU branch, from the output's and the
    final state's cotangents (float32, S 70: the token scan on the CPU)."""
    rng = np.random.default_rng(4)
    b, s, h, d = 2, 70, 2, 64
    r, k, v, do = (torch.from_numpy(0.3 * rng.standard_normal(
        (b, s, h, d)).astype(np.float32)) for _ in range(4))
    w = torch.from_numpy(np.exp(-np.exp(rng.standard_normal(
        (b, s, h, d)) * 0.5 - 2.0)).astype(np.float32))
    u = torch.from_numpy(0.5 * rng.standard_normal((h, d)).astype(
        np.float32))
    st, dst = (torch.from_numpy(rng.standard_normal((b, h, d, d)).astype(
        np.float32)) for _ in range(2))

    def call(r, k, v, w, u, st):
        return ops.rwkv6(r, k, v, w, u, state=st)

    args = (r, k, v, w, u, st)
    (o_cpu, _), want = _grads_vs(call, args, (do, dst))
    calls = _fake_recurrences(monkeypatch)
    with torch.no_grad():
        o, _ = call(*args)
    assert calls == {"rwkv6": 1, "rwkv6_bwd": 0, "scan": 0, "scan_bwd": 0}
    _close_rel(o, o_cpu.detach().numpy(), 1e-5, "o")
    (o, _), got = _grads_vs(call, args, (do, dst))
    assert "RWKV6" in type(o.grad_fn).__name__
    assert calls == {"rwkv6": 2, "rwkv6_bwd": 1, "scan": 0, "scan_bwd": 0}
    for name, a, wnt in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                            want):
        _close_rel(a, wnt.numpy(), 1e-5, name)


def test_selective_scan_autograd_glue(monkeypatch):
    """``ops.selective_scan``'s card branch: the forward kernel alone
    under ``no_grad``; under autograd ``SelectiveScan``, whose backward
    gives the gradients of x, dt, b, c, a and the initial state that
    autograd gives through the CPU branch (float32)."""
    rng = np.random.default_rng(5)
    bsz, s, di, n = 2, 40, 24, 8
    x, dt, dy = (torch.from_numpy(rng.standard_normal((bsz, s, di)).astype(
        np.float32)) for _ in range(3))
    dt = torch.nn.functional.softplus(dt - 2.0)
    bm, cm = (torch.from_numpy(rng.standard_normal((bsz, s, n)).astype(
        np.float32)) for _ in range(2))
    a = -torch.arange(1, n + 1, dtype=torch.float32).repeat(di, 1)
    h0, dh = (torch.from_numpy(rng.standard_normal((bsz, di, n)).astype(
        np.float32)) for _ in range(2))

    def call(x, dt, bm, cm, a, h0):
        return ops.selective_scan(x, dt, bm, cm, a, state=h0)

    args = (x, dt, bm, cm, a, h0)
    (y_cpu, _), want = _grads_vs(call, args, (dy, dh))
    calls = _fake_recurrences(monkeypatch)
    with torch.no_grad():
        y, _ = call(*args)
    assert calls == {"rwkv6": 0, "rwkv6_bwd": 0, "scan": 1, "scan_bwd": 0}
    assert torch.equal(y, y_cpu.detach())
    (y, _), got = _grads_vs(call, args, (dy, dh))
    assert "SelectiveScan" in type(y.grad_fn).__name__
    assert calls == {"rwkv6": 0, "rwkv6_bwd": 0, "scan": 2, "scan_bwd": 1}
    for name, g, wnt in zip(("dx", "ddt", "db", "dc", "da", "dstate0"), got,
                            want):
        _close_rel(g, wnt.numpy(), 1e-5, name)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_rwkv6_and_hymba_train_steps_on_the_card_branch(arch, monkeypatch):
    """Two REDUCED ``make_train_step`` steps with ``sgd`` through the
    card's branch of ``ops`` (plain versions in the kernels' place,
    ``remat`` on) equal the CPU's: losses to 1e-5 relative, params to
    1e-5 of each leaf's largest. A step runs each layer's recurrence
    twice forward (``remat`` recomputes it) and once backward."""
    _, cfg = _cfgs(arch)
    assert cfg.remat
    p0 = tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batches = [_port_batch(_batch(cfg, seed=i)) for i in range(2)]

    def run():
        params = tree_map(torch.clone, p0)
        opt = toptim.sgd(0.5)
        state = opt.init(params)
        step = tm.make_train_step(cfg, opt, device="cpu")
        losses = []
        for batch in batches:
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        return losses, params

    want_losses, want = run()
    flash = _fake_kernels(monkeypatch)
    calls = _fake_recurrences(monkeypatch)
    losses, got = run()
    fwd, bwd = (("rwkv6", "rwkv6_bwd") if arch.startswith("rwkv")
                else ("scan", "scan_bwd"))
    steps = len(batches) * cfg.n_layers
    assert (calls[fwd], calls[bwd]) == (2 * steps, steps)
    if arch.startswith("hymba"):
        assert (flash["fwd"], flash["bwd"]) == (2 * steps, steps)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_REL)
    for a, wnt in zip(tree_leaves(got), tree_leaves(want)):
        _close_rel(a, wnt.numpy(), 1e-5, arch)


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root, loaded as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,over", [("rwkv6-1.6b", True),
                                       ("hymba-1.5b", False)])
def test_ulp_spread(arch, over):
    """``chip_smoke.ulp_spread``, the probe of the CPU's own float32 noise
    that sets phase 25's limit for RWKV6's free-running params: on phase
    25's REDUCED ``sgd`` run (lr 0.5, three steps of 2 x 64 tokens), one
    float32 unit of noise on every param at each step's start grows past
    1e-5 of a leaf's largest for RWKV6 (so its card-vs-CPU params are
    held step by step to 1e-5, and free-running to this spread), and
    stays under it for hymba (held free-running to 1e-5)."""
    smoke = _chip_smoke()
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    p0 = tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 65)))
        batches.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    opt = toptim.sgd(0.5)
    spread = smoke.ulp_spread(torch, tm.make_train_step(cfg, opt,
                                                        device="cpu"),
                              p0, opt.init(p0), batches)
    print(f"{arch}: one float32 unit of noise a step grows to {spread:.3g} "
          f"of a leaf's largest in three steps")
    assert math.isfinite(spread) and (spread > 1e-5) == over, spread


# ------------------------------------------------- MoE dispatch backward

@pytest.mark.parametrize("cf", [0.5, 1.0])
def test_moe_dispatch_backward_over_drops_matches_jax(cf):
    """The dispatch writes dropped tokens to one shared dump slot; their
    backward must give those copies nothing (the ``where``), as JAX's
    does: gradients of x and every param against ``jax.grad``."""
    t, e, k, d, d_ff = 64, 4, 2, 32, 48
    rng = np.random.default_rng(0)
    jp = _np(jmoe.moe_init(jax.random.PRNGKey(0), d, d_ff, e, "swiglu"))
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((t, d)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, top_k=k, act="swiglu",
                                capacity_factor=cf)
        return jnp.sum(y * w) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = tree_map(lambda a: a.requires_grad_(True),
                  convert.params_from_numpy(jp))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, tx, top_k=k, act="swiglu",
                            capacity_factor=cf)
    gx, *gp = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                                  [tx] + tree_leaves(tp))
    _close_rel(gx, np.asarray(jgx), GRAD_REL, "dx")
    for a, b_ in zip(gp, jax.tree.leaves(_np(jgp))):
        _close_rel(a, b_, GRAD_REL, "dparam")
    # the case drops tokens: some token lost an assignment
    top_i = torch.topk(torch.softmax(tx.detach() @ tp["router"]["w"].detach(),
                                     -1), k, -1).indices
    load = torch.bincount(top_i.reshape(-1), minlength=e)
    assert int(load.max()) > tmoe.capacity(t, k, e, cf)
