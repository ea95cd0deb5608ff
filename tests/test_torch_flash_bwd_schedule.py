"""An emulation, in plain PyTorch on the CPU, of the flash backward
kernel's two tensor-core forms (``csrc/flash_attention_bwd.cu``): the
bf16 form's two walks' tiling, its masks and its products, and the
float32 form's 3xTF32 products, chains, runs and their ordered sum.

* dK / dV: blocks of 128 keys (two warpgroups of 64) and KV head, whose
  steps (query head of the group, 64-query tile that sees one of the
  block's keys) are cut into runs (``_splits``, the kernel's
  ``dkdv_splits``); a warpgroup passes over a tile none of its keys see,
  masks only a tile that crosses the causal diagonal or the window's
  lower edge, and adds each tile's P^T dO and dS^T Q (P and dS as bf16 hi
  + lo) to float32 sums; the runs' sums are added in order.
* dQ: 64 query rows a warpgroup (two heads of a KV group on the same
  rows where the group is even, else 128 rows of one head), 128-key tiles
  from the block's first window key to its last row, each warpgroup over
  the tiles that hold a key for one of its rows.
* At D 256: dK / dV blocks of 64 keys whose two warpgroups split each
  64-query step's S^T and dP^T by query halves (each masking its own half
  where that half crosses a boundary) and dK / dV by column halves, over
  P^T and dS^T of all 64 queries; dQ blocks of 64 rows of one head over
  64-key tiles, S and dP split by key halves, dQ by column halves.

The emulation is held to ``ref.flash_attention_bwd_ref`` within phase
24's limit (``chip_smoke.flash_bwd_ratio``: 1e-5 of each gradient's
largest |plain| plus one bf16 unit, 2^-7, of each element, outputs
rounded to bf16 as the kernel's are); two faulty schedules must fail it:
tiles at the window's lower edge passed over, and P / dS rounded once to
bf16 with no lo part.

* float32: FR rows resident (keys of a dK / dV block, queries of a dQ
  block) over steps of FC columns (64 x 64 to D 64, 64 x 32 for dK / dV
  and 64 x 64 for dQ to D 128, 32 x 32 to D 256), the dK / dV steps cut
  into runs (``_f_splits``, the
  kernel's ``f_splits``). Every product is 3xTF32: each operand split
  into a tf32 hi rounded on its bits and lo = x - hi read truncated to
  tf32, summed as lo hi + hi lo + hi hi; each mma adds a pass's 8
  products to its accumulator and rounds toward zero to float32, as the
  tensor cores' accumulate truncates. S and dP sum each 32 columns of
  the padded head dim into a partial from zero (an accumulator a pass),
  dV, dK and dQ each step's columns (one accumulator); partials are
  added in float32, the runs in order. Held to phase 24's float32 limit
  (1e-5 of each gradient's largest |plain|) at D 21 / 32 / 64 / 128 /
  256, GQA with window edges and Sk != Sq; one tf32 pass, a run dropped
  from the sum and one long chain over a block's walk must fail it.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


TOL, BF16_UNIT = 1e-5, 2.0 ** -7       # phase 24's limits
WG_ROWS, KV_KEYS, BQ, BK = 64, 128, 64, 128   # the kernel's tiles
W_KEYS, W_HALF = 64, 32                # its tiles at D 256
MIN_BLOCKS, MIN_STEPS = 4 * 132, 8     # its dK / dV runs


def _splits(sq, sk, h, hkv, window, keys=KV_KEYS):
    """The runs of a dK / dV block's steps, as ``dkdv_splits`` (B 1;
    ``keys`` a block, W_KEYS at D 256)."""
    blocks = -(-sk // keys) * hkv
    i_hi = min(sq, keys - 1 + window) if window else sq
    steps = h // hkv * -(-i_hi // BQ)
    return max(1, min(-(-MIN_BLOCKS // blocks), steps // MIN_STEPS))


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of x, zero past its end (TMA's fill)."""
    out = x.new_zeros((n,) + x.shape[1:])
    part = x[r0:r0 + n]
    out[:part.shape[0]] = part
    return out


def _parts(x, no_lo):
    """x as bf16 hi + lo parts (float32 values), or hi alone."""
    hi = x.bfloat16().float()
    return (hi,) if no_lo else (hi, (x - hi).bfloat16().float())


def _visible(rows, keys, causal, window):
    m = torch.ones(rows.shape[0], keys.shape[0], dtype=torch.bool)
    if causal:
        m &= keys[None, :] <= rows[:, None]
    if window:
        m &= keys[None, :] > rows[:, None] - window
    return m


def _dkdv(q, k, v, do, lse2, dl, causal, window, drop_edge, no_lo):
    sq, h, d = q.shape
    sk, hkv = k.shape[:2]
    group, sl2 = h // hkv, math.log2(math.e) / math.sqrt(d)
    splits = _splits(sq, sk, h, hkv, window)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, sk, KV_KEYS):
        t_lo = (k0 if causal else 0) // BQ
        i_hi = min(sq, k0 + KV_KEYS - 1 + window) if window else sq
        n_t = max(0, -(-i_hi // BQ) - t_lo)
        total = group * n_t
        for hk in range(hkv):
            runs = []
            for split in range(splits):
                acc = torch.zeros(2, 2, WG_ROWS, d)     # [wg][dk, dv]
                for s in range(total * split // splits,
                               total * (split + 1) // splits):
                    hh, q0 = hk * group + s // n_t, (t_lo + s % n_t) * BQ
                    q_last = min(q0 + BQ, sq) - 1
                    qs = torch.arange(q0, q0 + BQ)
                    for wg in range(2):
                        kw = k0 + wg * WG_ROWS
                        if not (kw < sk and (not causal or kw <= q_last) and (
                                not window or kw + WG_ROWS - 1 > q0 - window)):
                            continue
                        at_window = bool(window) and kw <= q_last - window
                        if drop_edge and at_window:
                            continue
                        kt, vt = (_rows(x[:, hk], kw, WG_ROWS) for x in (k, v))
                        qt, ot = (_rows(x[:, hh], q0, BQ) for x in (q, do))
                        p = torch.exp2(kt @ qt.T * sl2
                                       - _rows(lse2[hh], q0, BQ)[None, :])
                        ds = p * (vt @ ot.T - _rows(dl[hh], q0, BQ)[None, :])
                        if (causal and kw + WG_ROWS - 1 > q0) or at_window:
                            m = ~_visible(qs, torch.arange(kw, kw + WG_ROWS),
                                          causal, window).T
                            p, ds = p.masked_fill(m, 0.0), ds.masked_fill(m, 0.0)
                        acc[wg, 1] += sum(x @ ot for x in _parts(p, no_lo))
                        acc[wg, 0] += sum(x @ qt for x in _parts(ds, no_lo))
                runs.append(acc)
            total_sum = runs[0]
            for r in runs[1:]:
                total_sum = total_sum + r
            n = min(KV_KEYS, sk - k0)
            both = torch.cat([total_sum[0], total_sum[1]], dim=1)  # dk, dv
            dk[k0:k0 + n, hk] = both[0, :n] / math.sqrt(d)
            dv[k0:k0 + n, hk] = both[1, :n]
    return dk, dv


def _dq(q, k, v, do, lse2, dl, causal, window, drop_edge, no_lo):
    sq, h, d = q.shape
    sk, hkv = k.shape[:2]
    group, sl2 = h // hkv, math.log2(math.e) / math.sqrt(d)
    pair = group % 2 == 0
    rows = WG_ROWS if pair else 2 * WG_ROWS
    dq = torch.zeros_like(q)
    for q0 in range(0, sq, rows):
        k_end = min(q0 + rows, sk) if causal else sk
        k_begin = max(0, q0 - window + 1) if window else 0
        t_begin = k_begin // BK
        n_tiles = -(-k_end // BK) - t_begin
        for h0 in range(0, h, 2 if pair else 1):
            for slot in range(2):
                hh = h0 + (slot if pair else 0)
                r0 = q0 + (0 if pair else slot * WG_ROWS)
                r_last = min(r0 + WG_ROWS, sq) - 1
                if r0 > r_last:
                    continue
                i_lo = (max(0, r0 - window + 1) // BK - t_begin
                        if window else 0)
                i_hi = (min(n_tiles, r_last // BK + 1 - t_begin)
                        if causal else n_tiles)
                qt, ot = (_rows(x[:, hh], r0, WG_ROWS) for x in (q, do))
                l2 = _rows(lse2[hh], r0, WG_ROWS)[:, None]
                d_ = _rows(dl[hh], r0, WG_ROWS)[:, None]
                acc = torch.zeros(WG_ROWS, d)
                for i in range(i_lo, i_hi):
                    kt0 = (t_begin + i) * BK
                    at_window = bool(window) and kt0 <= r_last - window
                    if drop_edge and at_window:
                        continue
                    kt, vt = (_rows(x[:, hh // group], kt0, BK) for x in (k, v))
                    ds = torch.exp2(qt @ kt.T * sl2 - l2) * (ot @ vt.T - d_)
                    if (causal and kt0 + BK - 1 > r0) or at_window:
                        ds = ds.masked_fill(~_visible(
                            torch.arange(r0, r0 + WG_ROWS),
                            torch.arange(kt0, kt0 + BK), causal, window), 0.0)
                    acc += sum(x @ kt for x in _parts(ds, no_lo))
                dq[r0:r_last + 1, hh] = acc[:r_last + 1 - r0] / math.sqrt(d)
    return dq


def _dkdv_wide(q, k, v, do, lse2, dl, causal, window, drop_edge, no_lo):
    """The D 256 dK / dV walk: 64-key blocks, S^T and dP^T by query halves,
    the step's products over all 64 queries."""
    sq, h, d = q.shape
    sk, hkv = k.shape[:2]
    group, sl2 = h // hkv, math.log2(math.e) / math.sqrt(d)
    splits = _splits(sq, sk, h, hkv, window, W_KEYS)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    keys = torch.arange(W_KEYS)
    for k0 in range(0, sk, W_KEYS):
        t_lo = (k0 if causal else 0) // BQ
        i_hi = min(sq, k0 + W_KEYS - 1 + window) if window else sq
        n_t = max(0, -(-i_hi // BQ) - t_lo)
        total = group * n_t
        for hk in range(hkv):
            kt, vt = (_rows(x[:, hk], k0, W_KEYS) for x in (k, v))
            runs = []
            for split in range(splits):
                acc = torch.zeros(2, W_KEYS, d)           # dk, dv
                for s in range(total * split // splits,
                               total * (split + 1) // splits):
                    hh, q0 = hk * group + s // n_t, (t_lo + s % n_t) * BQ
                    q_last = min(q0 + BQ, sq) - 1
                    if not ((not causal or k0 <= q_last) and (
                            not window or k0 + W_KEYS - 1 > q0 - window)):
                        continue
                    qt, ot = (_rows(x[:, hh], q0, BQ) for x in (q, do))
                    p = torch.exp2(kt @ qt.T * sl2
                                   - _rows(lse2[hh], q0, BQ)[None, :])
                    ds = p * (vt @ ot.T - _rows(dl[hh], q0, BQ)[None, :])
                    for g in range(2):                    # query halves
                        qc = q0 + W_HALF * g
                        qc_last = min(qc + W_HALF, sq) - 1
                        at_window = bool(window) and k0 <= qc_last - window
                        cols = slice(W_HALF * g, W_HALF * (g + 1))
                        if drop_edge and at_window:
                            p[:, cols], ds[:, cols] = 0.0, 0.0
                        elif (causal and k0 + W_KEYS - 1 > qc) or at_window:
                            m = ~_visible(torch.arange(qc, qc + W_HALF),
                                          k0 + keys, causal, window).T
                            p[:, cols] = p[:, cols].masked_fill(m, 0.0)
                            ds[:, cols] = ds[:, cols].masked_fill(m, 0.0)
                    acc[1] += sum(x @ ot for x in _parts(p, no_lo))
                    acc[0] += sum(x @ qt for x in _parts(ds, no_lo))
                runs.append(acc)
            total_sum = runs[0]
            for r in runs[1:]:
                total_sum = total_sum + r
            n = min(W_KEYS, sk - k0)
            dk[k0:k0 + n, hk] = total_sum[0, :n] / math.sqrt(d)
            dv[k0:k0 + n, hk] = total_sum[1, :n]
    return dk, dv


def _dq_wide(q, k, v, do, lse2, dl, causal, window, drop_edge, no_lo):
    """The D 256 dQ walk: 64 rows of one head over 64-key tiles, S and dP
    by key halves."""
    sq, h, d = q.shape
    sk, hkv = k.shape[:2]
    group, sl2 = h // hkv, math.log2(math.e) / math.sqrt(d)
    dq = torch.zeros_like(q)
    for r0 in range(0, sq, WG_ROWS):
        r_last = min(r0 + WG_ROWS, sq) - 1
        k_end = min(r0 + WG_ROWS, sk) if causal else sk
        k_begin = max(0, r0 - window + 1) if window else 0
        rows = torch.arange(r0, r0 + WG_ROWS)
        for hh in range(h):
            qt, ot = (_rows(x[:, hh], r0, WG_ROWS) for x in (q, do))
            l2 = _rows(lse2[hh], r0, WG_ROWS)[:, None]
            d_ = _rows(dl[hh], r0, WG_ROWS)[:, None]
            acc = torch.zeros(WG_ROWS, d)
            for kt0 in range(k_begin // W_KEYS * W_KEYS, k_end, W_KEYS):
                kt, vt = (_rows(x[:, hh // group], kt0, W_KEYS)
                          for x in (k, v))
                ds = torch.exp2(qt @ kt.T * sl2 - l2) * (ot @ vt.T - d_)
                for g in range(2):                        # key halves
                    kc = kt0 + W_HALF * g
                    at_window = bool(window) and kc <= r_last - window
                    cols = slice(W_HALF * g, W_HALF * (g + 1))
                    if drop_edge and at_window:
                        ds[:, cols] = 0.0
                    elif (causal and kc + W_HALF - 1 > r0) or at_window:
                        ds[:, cols] = ds[:, cols].masked_fill(~_visible(
                            rows, torch.arange(kc, kc + W_HALF), causal,
                            window), 0.0)
                acc += sum(x @ kt for x in _parts(ds, no_lo))
            dq[r0:r_last + 1, hh] = acc[:r_last + 1 - r0] / math.sqrt(d)
    return dq


def _case(seed, sq, sk, h, hkv, d, causal, window):
    """bf16-valued q, k, v, dO (one batch row, the model's layout) and the
    forward's o (rounded to bf16) and lse, float32."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((sq, h, d)).astype(
        np.float32)).bfloat16().float() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((sk, hkv, d)).astype(
        np.float32)).bfloat16().float() for _ in range(2))
    kh, vh = (x.repeat_interleave(h // hkv, 1).transpose(0, 1)[None]
              for x in (k, v))
    qh = q.transpose(0, 1)[None]
    m = ref.attention_mask(sq, sk, causal, window, "cpu")
    s = (qh @ kh.transpose(-1, -2) / math.sqrt(d)).masked_fill(~m, -math.inf)
    lse = torch.logsumexp(s, -1)
    o = (torch.softmax(s, -1) @ vh).bfloat16().float()
    return q, k, v, do, o[0].transpose(0, 1), lse[0]


def _emulate(q, k, v, do, o, lse, causal, window, drop_edge=False,
             no_lo=False):
    """(dq, dk, dv) of the emulated kernel, rounded to bf16."""
    sq = q.shape[0]
    lse2 = torch.cat([lse * math.log2(math.e),
                      torch.full((lse.shape[0], BQ), math.inf)], 1)
    dl = torch.cat([(do * o).sum(-1).T, torch.zeros(lse.shape[0], BQ)], 1)
    lse2, dl = lse2[:, :sq + BQ], dl[:, :sq + BQ]
    args = (q, k, v, do, lse2, dl, causal, window, drop_edge, no_lo)
    dkdv, dq = (_dkdv_wide, _dq_wide) if q.shape[2] == 256 else (_dkdv, _dq)
    dk, dv = dkdv(*args)
    return [x.bfloat16().float() for x in (dq(*args), dk, dv)]


def _plain(q, k, v, do, o, lse, causal, window):
    h, hkv = q.shape[1], k.shape[1]
    g = h // hkv
    qh, oh, doh = (x.transpose(0, 1)[None] for x in (q, o, do))
    kh, vh = (x.repeat_interleave(g, 1).transpose(0, 1)[None] for x in (k, v))
    dq, dk, dv = ref.flash_attention_bwd_ref(qh, kh, vh, oh, lse[None], doh,
                                             causal=causal, window=window)
    sk, d = k.shape[0], k.shape[2]

    def per_kv(x):
        return x[0].view(hkv, g, sk, d).sum(1).transpose(0, 1)

    return dq[0].transpose(0, 1), per_kv(dk), per_kv(dv)


def _ratio(got, want) -> float:
    """Phase 24's limit ratio over dq, dk, dv."""
    ratio = 0.0
    for g, w in zip(got, want):
        lim = TOL * float(w.abs().max()) + BF16_UNIT * w.bfloat16().float().abs()
        ratio = max(ratio, float(((g - w).abs() / lim).max()))
    return ratio


@pytest.mark.parametrize("sq,sk,h,hkv,d,causal,window", [
    (300, 300, 24, 2, 128, True, 100),    # G 12, diagonal and window edge
    (257, 257, 5, 1, 64, True, 70),       # G 5: unpaired dQ slots
    (200, 200, 2, 2, 32, True, None),     # G 1, ragged causal
    (100, 300, 4, 4, 64, False, None),    # Sk > Sq, non-causal
    (333, 129, 6, 2, 64, False, None),    # Sk < Sq, one past a key tile
    (200, 200, 4, 2, 256, True, 70),      # D 256: window edge, GQA
    (77, 130, 2, 2, 256, False, None)])   # D 256: Sk != Sq, ragged
def test_emulated_schedule_holds_phase_24_limit(sq, sk, h, hkv, d, causal,
                                                window):
    """The emulated tensor-core form against the plain backward, within
    phase 24's limit."""
    x = _case(sq * 7 + h, sq, sk, h, hkv, d, causal, window)
    got = _emulate(*x, causal, window)
    ratio = _ratio(got, _plain(*x, causal, window))
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("fault", ["edge tile passed over", "no lo part"])
def test_faulty_schedules_fail_phase_24_limit(fault):
    """Passing over the tiles at the window's lower edge, or rounding P
    and dS once to bf16 with no lo part, fails the same limit."""
    sq, h, hkv, d, window = 300, 24, 2, 128, 100
    x = _case(11, sq, sq, h, hkv, d, True, window)
    got = _emulate(*x, True, window, drop_edge=fault == "edge tile passed over",
                   no_lo=fault == "no lo part")
    ratio = _ratio(got, _plain(*x, True, window))
    assert ratio > 1.0, ratio


@pytest.mark.parametrize("fault", ["edge tile passed over", "no lo part"])
def test_faulty_d256_schedules_fail_phase_24_limit(fault):
    """The same faults in the D 256 tiling fail the limit too."""
    sq, h, hkv, d, window = 200, 4, 2, 256, 70
    x = _case(13, sq, sq, h, hkv, d, True, window)
    got = _emulate(*x, True, window,
                   drop_edge=fault == "edge tile passed over",
                   no_lo=fault == "no lo part")
    ratio = _ratio(got, _plain(*x, True, window))
    assert ratio > 1.0, ratio


def test_runs_split_the_heaviest_key_tile():
    """StarCoder2-3B's training call is cut into 5 runs a key tile (64
    key tiles x 2 KV heads = 128 blocks, 640 with the runs); a call whose
    heaviest key tile has few steps is not cut."""
    assert _splits(8192, 8192, 24, 2, 4096) == 5
    assert _splits(4096, 4096, 25, 5, 1024) == 4
    assert _splits(512, 1024, 16, 16, None) == 1
    # D 256: Gemma-7B's training call fills the card with 64-key blocks
    assert _splits(4096, 4096, 16, 16, None, W_KEYS) == 1
    assert _splits(4096, 4096, 16, 2, None, W_KEYS) == 5


# ---------------------------------------------------------------- float32

F_MIN_BLOCKS, F_MIN_STEPS = 4 * 132, 2   # the float32 form's runs


def _f_tiles(d):
    """(FR rows resident, FC columns a dK / dV step, FC keys a dQ step) of
    the float32 form at head dim d (``f_rows`` / ``f_cols`` /
    ``f_dq_cols`` of its k-step class)."""
    nk = 4 if d <= 32 else 8 if d <= 64 else 16 if d <= 128 else 32
    return (32 if nk > 16 else 64), (32 if nk > 8 else 64), (
        32 if nk > 16 else 64)


def _f_splits(sq, sk, h, hkv, d, window):
    """The runs of a float32 dK / dV block's steps, as ``f_splits`` (B 1)."""
    fr, fc, _ = _f_tiles(d)
    blocks = -(-sk // fr) * hkv
    i_hi = fr - 1 + window if window and fr - 1 + window < sq else sq
    steps = h // hkv * -(-i_hi // fc)
    return max(1, min(-(-F_MIN_BLOCKS // blocks), steps // F_MIN_STEPS))


def _tf32_parts(x, one_pass):
    """x as the tensor cores read its 3xTF32 split: hi rounded to tf32 on
    its bits (half an ulp added, the low 13 bits cleared), lo = x - hi
    truncated to tf32 as the hardware reads it; hi alone for one pass."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    if one_pass:
        return hi, None
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _rz(x):
    """float64 x rounded toward zero to float32."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _tf32_ksteps(a, b, one_pass):
    """The mma k-steps of a @ b as 3xTF32: for each 8 of a's columns (b's
    rows), the exact products of its passes (lo hi, hi lo, hi hi; lo lo
    dropped), None for the lo passes of one pass."""
    ah, al = _tf32_parts(a, one_pass)
    bh, bl = _tf32_parts(b, one_pass)
    for c in range(0, a.shape[1], 8):
        x, y = ah[:, c:c + 8].double(), bh[c:c + 8].double()
        yield ((None, None) if one_pass else
               (al[:, c:c + 8].double() @ y, x @ bl[c:c + 8].double())) + (
                   x @ y,)


def _tf32_chain(a, b, one_pass, acc=None):
    """acc (zeros where None) plus a @ b in one tensor-core accumulator
    (``mma3``): each mma adds a pass's 8 products to it and rounds toward
    zero to float32 (the tensor cores' truncating accumulate), the small
    passes first."""
    if acc is None:
        acc = torch.zeros(a.shape[0], b.shape[1])
    for terms in _tf32_ksteps(a, b, one_pass):
        for x in terms:
            if x is not None:
                acc = _rz(acc.double() + x)
    return acc


def _f_gram(a, b, one_pass):
    """a b^T over the padded head dim (``f_gram``): each 32 columns (4
    k-steps) a partial from zero with an accumulator a pass
    (``mma3p``), the three added in float32, the partials in order."""
    out = torch.zeros(a.shape[0], b.shape[0])
    for c in range(0, a.shape[1], 32):
        parts = [torch.zeros_like(out) for _ in range(3)]
        for terms in _tf32_ksteps(a[:, c:c + 32], b[:, c:c + 32].T,
                                  one_pass):
            for z, x in enumerate(terms):
                if x is not None:
                    parts[z] = _rz(parts[z].double() + x)
        out += (parts[0] + parts[1]) + parts[2]
    return out


def _f_dkdv(q, k, v, do, lse, dl, causal, window, one_pass, long_chain,
            drop_run):
    sq, h, d = q.shape
    sk, hkv = k.shape[:2]
    fr, fc, _ = _f_tiles(d)
    group, sl2 = h // hkv, math.log2(math.e) / math.sqrt(d)
    splits = 1 if long_chain else _f_splits(sq, sk, h, hkv, d, window)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, sk, fr):
        t_lo = (k0 if causal else 0) // fc
        i_hi = min(sq, k0 + fr - 1 + window) if window else sq
        n_t = max(0, -(-i_hi // fc) - t_lo)
        total = group * n_t
        keys = torch.arange(k0, k0 + fr)
        for hk in range(hkv):
            kt, vt = (_rows(x[:, hk], k0, fr) for x in (k, v))
            runs = []
            for split in range(splits):
                acc_k, acc_v = torch.zeros(fr, d), torch.zeros(fr, d)
                for s in range(total * split // splits,
                               total * (split + 1) // splits):
                    hh, q0 = hk * group + s // n_t, (t_lo + s % n_t) * fc
                    qt, ot = (_rows(x[:, hh], q0, fc) for x in (q, do))
                    lt, dlt = (_rows(x[hh], q0, fc) for x in (lse, dl))
                    pt = torch.exp2(_f_gram(kt, qt, one_pass) * sl2
                                    - lt * math.log2(math.e))
                    # the sub-tiles' edge masks mask what they cover
                    vis = _visible(torch.arange(q0, q0 + fc), keys, causal,
                                   window).T & (keys < sk)[:, None]
                    pt = pt.masked_fill(~vis, 0.0)
                    dst = pt * (_f_gram(vt, ot, one_pass) - dlt)
                    if long_chain:
                        acc_v = _tf32_chain(pt, ot, one_pass, acc_v)
                        acc_k = _tf32_chain(dst, qt, one_pass, acc_k)
                    else:
                        acc_v += _tf32_chain(pt, ot, one_pass)
                        acc_k += _tf32_chain(dst, qt, one_pass)
                if split != drop_run:
                    runs.append((acc_k, acc_v))
            sum_k, sum_v = runs[0]
            for rk, rv in runs[1:]:
                sum_k, sum_v = sum_k + rk, sum_v + rv
            n = min(fr, sk - k0)
            dk[k0:k0 + n, hk] = sum_k[:n] / math.sqrt(d)
            dv[k0:k0 + n, hk] = sum_v[:n]
    return dk, dv


def _f_dq(q, k, v, do, lse, dl, causal, window, one_pass, long_chain):
    sq, h, d = q.shape
    sk, hkv = k.shape[:2]
    fr, _, fc = _f_tiles(d)
    group, sl2 = h // hkv, math.log2(math.e) / math.sqrt(d)
    dq = torch.zeros_like(q)
    for q0 in range(0, sq, fr):
        k_begin = max(0, q0 - window + 1) if window else 0
        k_end = min(q0 + fr, sk) if causal else sk
        rows = torch.arange(q0, q0 + fr)
        for hh in range(h):
            qt, ot = (_rows(x[:, hh], q0, fr) for x in (q, do))
            l2 = _rows(lse[hh], q0, fr)[:, None] * math.log2(math.e)
            dlt = _rows(dl[hh], q0, fr)[:, None]
            acc = torch.zeros(fr, d)
            for kt0 in range(k_begin // fc * fc, k_end, fc):
                kt, vt = (_rows(x[:, hh // group], kt0, fc) for x in (k, v))
                keys = torch.arange(kt0, kt0 + fc)
                vis = _visible(rows, keys, causal, window) & (keys < sk)
                p = torch.exp2(_f_gram(qt, kt, one_pass) * sl2 - l2)
                ds = p.masked_fill(~vis, 0.0) * (_f_gram(ot, vt, one_pass)
                                                 - dlt)
                acc = (_tf32_chain(ds, kt, one_pass, acc) if long_chain
                       else acc + _tf32_chain(ds, kt, one_pass))
            n = min(fr, sq - q0)
            dq[q0:q0 + n, hh] = acc[:n] / math.sqrt(d)
    return dq


def _case32(seed, sq, sk, h, hkv, d, causal, window):
    """float32 q, k, v, dO (one batch row, the model's layout) and the
    forward's o and lse (float64 rounded to float32), as the float32
    form gets them."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((sq, h, d)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((sk, hkv, d)).astype(
        np.float32)) for _ in range(2))
    kh, vh = (x.double().repeat_interleave(h // hkv, 1).transpose(0, 1)
              for x in (k, v))
    qh = q.double().transpose(0, 1)
    m = ref.attention_mask(sq, sk, causal, window, "cpu")
    s = (qh @ kh.transpose(-1, -2) / math.sqrt(d)).masked_fill(~m, -math.inf)
    lse = torch.logsumexp(s, -1)
    o = torch.softmax(s, -1) @ vh
    return q, k, v, do, o.transpose(0, 1).float(), lse.float()


def _emulate32(q, k, v, do, o, lse, causal, window, one_pass=False,
               long_chain=False, drop_run=None):
    """(dq, dk, dv) of the emulated float32 form; D = rowsum(dO o) as
    ``bwd_delta`` forms it, in float32. ``long_chain``: dV, dK and dQ
    each summed over a block's whole walk in one tensor-core accumulator
    (no step partials, no runs)."""
    dl = (do * o).sum(-1).T
    args = (q, k, v, do, lse, dl, causal, window, one_pass, long_chain)
    return [_f_dq(*args), *_f_dkdv(*args, drop_run)]


def _ratio32(got, want) -> float:
    """Phase 24's float32 limit ratio over dq, dk, dv: 1e-5 of each one's
    largest |plain|."""
    return max(float((g - w).abs().max()) / (TOL * float(w.abs().max()))
               for g, w in zip(got, want))


@pytest.mark.parametrize("sq,sk,h,hkv,d,causal,window", [
    (150, 150, 6, 2, 21, True, 40),       # D 21 (padded to 24), GQA window
    (200, 200, 4, 2, 32, True, 70),       # D 32: 64 x 64 tiles
    (130, 130, 4, 1, 64, True, None),     # D 64, G 4, S one past two tiles
    (160, 160, 12, 2, 128, True, 60),     # G 6, D 128: 64 x 32, window edge
    (100, 100, 2, 2, 256, True, 40),      # D 256: 32 x 32 tiles
    (77, 200, 2, 2, 64, False, None),     # Sk > Sq
    (150, 70, 3, 1, 128, False, None)])   # Sk < Sq
def test_emulated_f32_form_holds_phase_24_limit(sq, sk, h, hkv, d, causal,
                                               window):
    """The emulated 3xTF32 form (its tiles, per-chain partials, runs and
    their ordered sum) against the plain backward, within phase 24's
    float32 limit."""
    x = _case32(sq * 5 + d, sq, sk, h, hkv, d, causal, window)
    ratio = _ratio32(_emulate32(*x, causal, window), _plain(*x, causal,
                                                            window))
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("fault", ["one tf32 pass", "a run dropped",
                                   "one long chain"])
def test_faulty_f32_forms_fail_phase_24_limit(fault):
    """One tf32 pass (hi products only), a run's sums left out of the
    ordered sum (the call is cut into 12 runs), or dV / dK / dQ each
    summed in one truncating accumulator over a block's walk (1,152
    mma adds at G 12, S 256: 48 steps of 8 k-steps, 3 passes each)
    fails the same limit."""
    if fault == "one long chain":
        sq, h, hkv, d, window = 256, 12, 1, 64, None
    else:
        sq, h, hkv, d, window = 160, 12, 2, 128, 60
        assert _f_splits(sq, sq, h, hkv, d, window) == 12
    x = _case32(17, sq, sq, h, hkv, d, True, window)
    got = _emulate32(*x, True, window, one_pass=fault == "one tf32 pass",
                     long_chain=fault == "one long chain",
                     drop_run=1 if fault == "a run dropped" else None)
    ratio = _ratio32(got, _plain(*x, True, window))
    assert ratio > 1.0, ratio


def test_f32_runs_and_tiles():
    """The float32 form's tiles by head dim and its runs: 3 at
    StarCoder2-3B's float32 training call (128 64-key blocks x 2 KV
    heads), 4 at the REDUCED shape, none at a one-step call."""
    assert [_f_tiles(d) for d in (21, 32, 64, 128, 256)] == [
        (64, 64, 64), (64, 64, 64), (64, 64, 64), (64, 32, 64),
        (32, 32, 32)]
    assert _f_splits(8192, 8192, 24, 2, 128, 4096) == 3
    assert _f_splits(100, 100, 8, 2, 32, 64) == 4
    assert _f_splits(64, 64, 1, 1, 32, 16) == 1
