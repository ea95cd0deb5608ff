"""An emulation, in plain PyTorch on the CPU, of the flash forward
kernel's float32 form (``csrc/flash_attention.cu``, ``fa_f32_tc_kernel``):
its blocks and tiles, its 3xTF32 products on the tensor cores, their
chains and the online softmax between them.

* Blocks: two slots of ``F32_SLOT_ROWS`` query rows (16 a warp), two
  heads of one KV group on the same rows where the group is even, else
  twice the rows of one head; each block walks the key tiles of
  ``F32_BLOCK_KV`` keys from the one holding its first row's window start
  to the one holding its last row (every key where the call is not
  causal). A tile that holds no key for some rows adds exactly nothing to
  them (weights exp2(-inf) = 0, a correction of exp2(0) = 1), so the
  kernel's warps, which pass over such tiles, get what the block's walk
  gets.
* Products: each float32 operand is split into a tf32 hi rounded on its
  bits as ``Tf32x3::split`` rounds (half an ulp added, the low 13 bits
  cleared) and lo = x - hi, read truncated to tf32 by the tensor cores;
  a b is summed as lo hi + hi lo + hi hi (lo lo dropped), each mma adding
  a pass's 8 products to its accumulator and rounding toward zero to
  float32, as the tensor cores' accumulate truncates.
* Chains: S = Q K^T sums each ``F32_S_CHAIN`` k-steps (8 head-dim
  columns each, over the head dim padded with zeros to 32, 64, 128 or
  256) from zero in one accumulator, the partials added in float32; P V
  sums each tile's keys from zero, and the partial is added to the
  rescaled O in float32. P V's k index is permuted within each 8-key
  group (2 t for t, 2 t + 1 for t + 4), so that S's accumulator is P V's
  A fragment, and V's rows are read in the same order.
* Softmax: in log2 units with the scale folded into the exponent's FMA,
  masked scores -inf, the running max from -1e30.

Held to the plain version (``ref.flash_attention_probs @ v``) within
the float32 limit of phases 11 and 20 and of the GPU tests (1e-5
absolute) at GQA 6 / 2 and 12 / 1, windows 100 and 1, a ragged S, D 21,
32, 64, 128 and 256 and non-causal Sk != Sq. Four faulty forms must fail
it: one tf32 pass, the window-edge tile dropped, P V summed in one chain
over a block's whole walk, and P permuted but V not.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    F32_S_CHAIN, f32_tiles)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tests: the suite runs in
    several worker processes at once, and a torch that takes every core
    in each of them makes the workers contend for the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5      # phases 11 and 20's float32 limit, absolute
LOG2E = 1.4426950408889634
# P V's A fragment: k index t of an 8-key group holds key PERM[t]
PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def _tf32_parts(x, one_pass):
    """x as the tensor cores read its 3xTF32 split: hi rounded to tf32 on
    its bits, lo = x - hi truncated to tf32; hi alone for one pass."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    if one_pass:
        return hi, None
    lo = ((x - hi).contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)
    return hi, lo


def _rz(x):
    """float64 x rounded toward zero to float32."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _chain(a, b, one_pass, acc=None):
    """acc (zeros where None) plus a @ b ((..., m, k) @ (..., k, n)) in
    one tensor-core accumulator: each k-step of 8 adds a pass's exact
    products and rounds toward zero to float32, the small passes (lo hi,
    hi lo) first."""
    ah, al = _tf32_parts(a, one_pass)
    bh, bl = _tf32_parts(b, one_pass)
    if acc is None:
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for c in range(0, a.shape[-1], 8):
        x, y = ah[..., c:c + 8].double(), bh[..., c:c + 8, :].double()
        terms = [x @ y] if one_pass else [
            al[..., c:c + 8].double() @ y, x @ bl[..., c:c + 8, :].double(),
            x @ y]
        for t in terms:
            acc = _rz(acc.double() + t)
    return acc


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of x (..., S, D), zero past its end (the
    staging's zero fill)."""
    out = x.new_zeros(x.shape[:-2] + (n, x.shape[-1]))
    part = x[..., r0:r0 + n, :]
    out[..., :part.shape[-2], :] = part
    return out


def _emulate(q, k, v, causal, window, fault=None):
    """o (Sq, H, D) of the emulated float32 form for one batch row; q
    (Sq, H, D), k and v (Sk, Hkv, D) float32. ``fault``: "one tf32
    pass", "edge tile dropped" (a block's first tile left out where it
    has another), "one long chain" (P V summed into O in the tensor-core
    accumulator over the block's whole walk) or "P permuted, V not"."""
    sq, h, d = q.shape
    sk, hkv = k.shape[:2]
    nk, slot, bk = f32_tiles(d)
    group = h // hkv
    span = slot if group % 2 == 0 else 2 * slot   # a block's query rows
    one_pass = fault == "one tf32 pass"
    # 1.0f / sqrtf(d) and its product with log2(e), in float32
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    sl2 = float(np.float32(scale) * np.float32(LOG2E))
    width = 8 * nk

    def heads(x, rep):
        x = torch.nn.functional.pad(x, (0, width - d)).transpose(0, 1)
        return x.repeat_interleave(rep, 0).contiguous()

    qh, kh, vh = heads(q, 1), heads(k, group), heads(v, group)
    perm = torch.tensor([g + t for g in range(0, bk, 8) for t in PERM])
    out = torch.empty(h, sq, d)
    for q0 in range(0, sq, span):
        rows = torch.arange(q0, min(q0 + span, sq))
        qb = qh[:, rows]
        k_begin = max(0, q0 - window + 1) if window else 0
        k_end = min(q0 + span, sk) if causal else sk
        tiles = list(range(k_begin // bk * bk, k_end, bk))
        if fault == "edge tile dropped" and len(tiles) > 1:
            tiles = tiles[1:]
        n = rows.shape[0]
        m = torch.full((h, n, 1), -1e30)
        lsum = torch.zeros(h, n, 1)
        o = torch.zeros(h, n, width)
        for kt in tiles:
            kb, vb = _rows(kh, kt, bk), _rows(vh, kt, bk)
            s = torch.zeros(h, n, bk)
            for c in range(0, width, 8 * F32_S_CHAIN):
                cs = slice(c, c + 8 * F32_S_CHAIN)
                s = s + _chain(qb[..., cs], kb[..., cs].transpose(-1, -2),
                               one_pass)
            keys = torch.arange(kt, kt + bk)
            vis = ref.attention_mask(sq, sk + bk, causal, window, "cpu")[
                rows][:, keys] & (keys < sk)
            s = s.masked_fill(~vis, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
            corr = torch.exp2(m - m_new)
            # exp2f(fmaf(s, sl2, -m)): one rounding of the exponent
            p = torch.exp2((s.double() * sl2 - m_new.double()).float())
            lsum = lsum * corr + p.sum(-1, keepdim=True)
            o = o * corr
            if fault == "P permuted, V not":
                p = p[..., perm]
            if fault == "one long chain":
                o = _chain(p, vb, one_pass, acc=o)
            else:
                o = o + _chain(p, vb, one_pass)
            m = m_new
        out[:, rows] = (o / lsum.clamp_min(1e-30))[..., :d]
    return out.transpose(0, 1)


def _case(seed, sq, sk, h, hkv, d, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy((q_scale * rng.standard_normal((sq, h, d))).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((sk, hkv, d)).astype(
        np.float32)) for _ in range(2))
    return q, k, v


def _plain(q, k, v, causal, window):
    """The plain version, ``ref.flash_attention_probs @ v`` in float32,
    in the model's (Sq, H, D) layout."""
    group = q.shape[1] // k.shape[1]
    qh = q.transpose(0, 1)[None]
    kh, vh = (x.transpose(0, 1).repeat_interleave(group, 0)[None]
              for x in (k, v))
    att = ref.flash_attention_probs(qh, kh, causal=causal, window=window)
    return (att @ vh)[0].transpose(0, 1)


def _ratio(q, k, v, causal, window, fault=None) -> float:
    got = _emulate(q, k, v, causal, window, fault)
    return float((got - _plain(q, k, v, causal, window)).abs().max()) / TOL


# the long walk of the "one long chain" control: 1,024 keys causal, with
# peaked scores (q scaled 3x), as a trained model's rows attend to a few
# keys: the truncating accumulate then errs by ~2^-24 of |O| an add
LONG = (1024, 1024, 2, 1, 32, True, None, 3.0)


@pytest.mark.parametrize("sq,sk,h,hkv,d,causal,window,q_scale", [
    (200, 200, 6, 2, 64, True, 100, 1.0),     # GQA 6 / 2: 128-row blocks
    (200, 200, 12, 1, 128, True, 100, 1.0),   # GQA 12 / 1: paired heads
    (150, 150, 4, 2, 21, True, 1, 1.0),       # D 21 (padded to 32), window 1
    (333, 333, 4, 2, 32, True, None, 1.0),    # ragged S, D 32
    (130, 130, 4, 2, 256, True, 100, 1.0),    # D 256: 32-row slots, 32 keys
    (77, 200, 4, 2, 64, False, None, 1.0),    # Sk > Sq
    (150, 70, 3, 1, 128, False, None, 1.0),   # Sk < Sq, an odd group
    LONG])
def test_emulated_f32_forward_holds_the_limit(sq, sk, h, hkv, d, causal,
                                              window, q_scale):
    """The emulated 3xTF32 form (its blocks, tiles, splits, chains and
    key permutation) against the plain version, within 1e-5 absolute."""
    x = _case(sq * 7 + d, sq, sk, h, hkv, d, q_scale)
    ratio = _ratio(*x, causal, window)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("fault", ["one tf32 pass", "edge tile dropped",
                                   "one long chain", "P permuted, V not"])
def test_faulty_f32_forwards_fail_the_limit(fault):
    """One tf32 pass (hi products only), each block's window-edge tile
    dropped, P V summed into O in one truncating accumulator over the
    whole walk (384 mma adds at 1,024 keys: 128 k-steps, 3 passes each),
    or P's keys permuted for the A fragment while V's rows are read in
    order: each fails the same limit."""
    if fault == "one long chain":
        sq, sk, h, hkv, d, causal, window, q_scale = LONG
    else:
        sq, sk, h, hkv, d, causal, window, q_scale = (
            200, 200, 12, 1, 128, True, 100, 1.0)
    x = _case(sq * 7 + d, sq, sk, h, hkv, d, q_scale)
    ratio = _ratio(*x, causal, window, fault)
    assert ratio > 1.0, ratio


def test_f32_forward_tiles():
    """The float32 form's tiles by head dim: (NK, rows a slot, keys a
    tile); S's chain of 8 k-steps (64 head-dim columns)."""
    assert [f32_tiles(d) for d in (1, 21, 32, 33, 64, 128, 200, 256)] == [
        (4, 64, 64), (4, 64, 64), (4, 64, 64), (8, 64, 64), (8, 64, 64),
        (16, 64, 64), (32, 32, 32), (32, 32, 32)]
    assert F32_S_CHAIN == 8
    with pytest.raises(ValueError):
        f32_tiles(257)
