"""Plain PyTorch versions of the kernels on the port's paths (TGN training,
RWKV6, StarCoder2 and hymba serving, LM training's backwards of attention,
WKV and the selective scan, the ``ops.gru`` cell).

These mirror ``repro/kernels/ref.py`` line for line and are the semantic
ground truth of the port: the CPU executes them (``kernels/ops.py`` picks
them for CPU tensors), the tests hold them against the JAX oracles, and
``chip_smoke.py`` holds every CUDA kernel against them on the card.
"""

from __future__ import annotations

import math

import torch

__all__ = ["gru_ref", "gru_bwd_ref", "temporal_attention_ref", "segment_mean",
           "scatter_memory", "scatter_last", "flush_ref", "sample_ref",
           "sample_roles_ref", "rwkv6_ref", "rwkv6_chunked_ref", "rwkv6_subchunk_ref",
           "attention_mask", "flash_attention_probs", "flash_attention_ref",
           "flash_attention_bwd_ref", "selective_scan_ref", "rwkv6_bwd_ref",
           "rwkv6_bwd_chunked_ref", "selective_scan_bwd_ref",
           "selective_scan_bwd_scanned_ref"]


def gru_ref(x, h, wx, wh, bx, bh):
    """GRU cell. x: (B, d_in), h: (B, d_h); wx: (d_in, 3*d_h),
    wh: (d_h, 3*d_h); biases (3*d_h,). Gate order [reset | update |
    candidate], as ``repro.tig.modules.gru``."""
    gx = x @ wx + bx
    gh = h @ wh + bh
    rx, zx, nx = gx.chunk(3, dim=-1)
    rh, zh, nh = gh.chunk(3, dim=-1)
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    return (1.0 - z) * n + z * h


def gru_bwd_ref(g, x, h, wx, wh, bx, bh):
    """The GRU cell's backward: ``(dx, dh, dwx, dwh, dbx, dbh)`` for the
    output cotangent ``g`` (B, d_h), by autograd through ``gru_ref``."""
    with torch.enable_grad():
        args = [a.detach().requires_grad_() for a in (x, h, wx, wh, bx, bh)]
        return torch.autograd.grad(gru_ref(*args), args, g)


def temporal_attention_ref(q, k, v, mask):
    """Masked neighbor attention. q: (B, H, D); k, v: (B, K, H, D);
    mask: (B, K) bool -> (B, H, D). Rows with no valid neighbor give
    exactly zero context."""
    scores = torch.einsum("bhd,bkhd->bhk", q, k) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~mask[:, None, :], -1e30)
    att = torch.softmax(scores, dim=-1)
    att = torch.where(mask.any(-1)[:, None, None], att, 0.0)
    return torch.einsum("bhk,bkhd->bhd", att, v)


def segment_mean(ids, msg, n_dump: int):
    """Per-row mean of ``msg`` over the rows that share its live id.

    ids: (R,) int ids, ``n_dump`` marks padding; msg: (R, dm). Padding
    rows get zeros. Returns (R, dm)."""
    ids = ids.long()
    live = (ids < n_dump)
    sums = msg.new_zeros((n_dump + 1, msg.shape[-1])).index_add(
        0, ids, torch.where(live[:, None], msg, 0.0))
    cnt = msg.new_zeros((n_dump + 1,)).index_add(0, ids, live.to(msg.dtype))
    return (sums / cnt.clamp(min=1.0)[:, None])[ids]


def _dump_index(n_dump: int, device) -> torch.Tensor:
    """(1,) int64 index of the dump row, filled on ``device``: a tensor
    built from host data would be a host-to-device copy, which a CUDA
    graph capture refuses."""
    return torch.full((1,), n_dump, dtype=torch.int64, device=device)


def scatter_memory(mem, ids, rows):
    """``mem`` with ``rows`` written at ``ids`` and the dump row (the
    last) re-zeroed, out of place.

    Duplicate ids carry identical rows; only the first occurrence writes,
    and later ones go to the dump row. So the gradient reaches one copy of
    a row, as it does through JAX's scatter (``index_put`` alone would
    hand it to every duplicate)."""
    n_dump = mem.shape[0] - 1
    ids = ids.long()
    dup = torch.tril(ids[:, None] == ids[None, :], diagonal=-1).any(1)
    return mem.index_put((torch.where(dup, n_dump, ids),), rows
                         ).index_fill(0, _dump_index(n_dump, mem.device),
                                      0.0)


def scatter_last(last, ids, ts):
    """``last`` raised to the latest event time of each live id, with the
    dump row re-zeroed, out of place."""
    n_dump = last.shape[0] - 1
    live = ids < n_dump
    return last.scatter_reduce(0, ids.long(), torch.where(live, ts, 0.0),
                               "amax", include_self=True
                               ).index_fill(0, _dump_index(n_dump,
                                                           last.device), 0.0)


def flush_ref(ids, msg, ts, mem, last, wx, wh, bx, bh):
    """Message flush: segment-mean of the pending messages, GRU update of
    the touched memory rows, scatter of ``mem`` and ``last``.

    ids: (R,) touched rows (dump row ``mem.shape[0]-1`` = padding);
    msg: (R, dm); ts: (R,); mem: (N+1, d); last: (N+1,). Returns
    ``(mem', last', mbar)`` with ``mbar`` the (R, dm) aggregated messages.
    """
    mbar = segment_mean(ids, msg, mem.shape[0] - 1)
    s_new = gru_ref(mbar, mem[ids.long()], wx, wh, bx, bh)
    return scatter_memory(mem, ids, s_new), scatter_last(last, ids, ts), mbar


def sample_ref(indptr, nbr, t, eidx, bat, nodes, batch_of, k: int,
               window=0):
    """Temporal neighbor sampling over an exported T-CSR.

    For each queried node a branchless bisect_left over the node's
    time-sorted segment of ``bat`` finds the first event of a stream batch
    >= ``batch_of`` (events carry the key ``batch + 1``, history 0); then
    the K-wide window ``[end-(w+1)k, end-wk)`` before it is gathered, -1
    front-padded, oldest -> newest (w = ``window``).

    indptr: (N+1,) int32; nbr / t / eidx / bat: (pad + total,) arrays of
    ``ChronoNeighborIndex.device_export``; nodes: (R,) int32; batch_of and
    window: int or (R,) int32. Returns ((R, k) int32 ids, (R, k) float32
    times, (R, k) int32 edge rows).
    """
    total = nbr.shape[0]
    dev = nodes.device
    nodes = nodes.long()
    start = indptr[nodes]
    stop = indptr[nodes + 1]
    key = torch.as_tensor(batch_of, dtype=torch.int32, device=dev
                          ).broadcast_to(nodes.shape) + 1
    win = torch.as_tensor(window, dtype=torch.int32, device=dev
                          ).broadcast_to(nodes.shape)
    lo, hi = start, stop
    for _ in range(max(1, int(total).bit_length())):
        mid = (lo + hi) // 2
        v = bat[mid.clamp(max=total - 1).long()]
        active = lo < hi
        go = active & (v < key)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    idx = (lo[:, None] - (win[:, None] + 1) * k
           + torch.arange(k, dtype=torch.int32, device=dev)[None, :])
    valid = idx >= start[:, None]
    idx = idx.clamp(min=0).long()
    ids = torch.where(valid, nbr[idx], -1)
    tms = torch.where(valid, t[idx], -1.0)
    eix = torch.where(valid, eidx[idx], -1)
    return ids, tms, eix


def sample_roles_ref(indptr, nbr, t, eidx, bat, src, dst, neg, valid,
                     batch_of, k: int):
    """``sample_ref`` over a batch's 3B rows src ++ dst ++ neg, as the host
    planner fills its grids: a dead row (id < 0, or its slot not
    ``valid``) samples node 0, then its ids and edge rows are masked to -1
    (its times are left as sampled).

    src, dst, neg: (B,) int32; valid: (B,) bool; batch_of: int or (3B,)
    int32. Returns (3B, k) ids, times, edge rows.
    """
    ids3 = torch.cat([src, dst, neg])
    alive = (ids3 >= 0) & valid.repeat(3)
    clean = torch.where(alive, ids3, 0).to(torch.int32)
    nb, nt, ne = sample_ref(indptr, nbr, t, eidx, bat, clean, batch_of, k)
    return (torch.where(alive[:, None], nb, -1), nt,
            torch.where(alive[:, None], ne, -1))


def rwkv6_ref(r, k, v, w, u, *, state=None, return_state=False):
    """RWKV6 (Finch) WKV recurrence, token by token, in float32.

    r, k, w: (B, H, S, Dk); v: (B, H, S, Dv); u: (H, Dk); ``w`` is the
    per-channel decay in (0, 1); state: optional (B, H, Dk, Dv) initial
    state. Returns float32 ``o`` (B, H, S, Dv) (and the final state).

        o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                            device=r.device)
    st = state.float()
    outs = []
    for t in range(s):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]          # (B,H,Dk,Dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt,
                                 st + u[None, :, :, None] * kv))
        st = wt[..., :, None] * st + kv
    o = torch.stack(outs, dim=2)                           # (B,H,S,Dv)
    return (o, st) if return_state else o


def rwkv6_chunked_ref(r, k, v, w, u, *, state=None, chunk: int = 64,
                      return_state=False):
    """Chunked WKV6, as ``repro/kernels/ref.py:rwkv6_chunked_xla``: the
    same function as ``rwkv6_ref`` by the matmul reformulation of the TPU
    kernel (intra-chunk (C, C) scores, one state carry per chunk).

    Falls back to the token scan when ``S % chunk`` or ``S <= chunk``, and
    then returns float32; otherwise ``o`` has ``r``'s dtype. The
    log-space decays keep float32 in range only for |log w| * chunk
    below about 80."""
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    if s % chunk or s <= chunk:
        return rwkv6_ref(r, k, v, w, u, state=state,
                         return_state=return_state)
    nc = s // chunk
    rr, kk, vv, ww = (x.float().reshape(b, h, nc, chunk, -1)
                      for x in (r, k, v, w))
    u = u.float()
    lw = torch.log(torch.clamp(ww, 1e-38, 1.0))           # (B,H,NC,C,Dk)
    c = torch.cumsum(lw, dim=-2)
    c_prev = c - lw
    c_tot = c[..., -1:, :]                                 # (B,H,NC,1,Dk)
    z = 0.5 * c_tot

    r_dec = rr * torch.exp(c_prev - z)
    k_dec = kk * torch.exp(z - c)
    scores = torch.einsum("bhnid,bhnjd->bhnij", r_dec, k_dec)
    ti = torch.arange(chunk, device=r.device)
    scores = torch.where(ti[None, :] < ti[:, None], scores, 0.0)
    intra = torch.einsum("bhnij,bhnjd->bhnid", scores, vv)
    bonus = torch.sum(rr * u[None, :, None, None, :] * kk, dim=-1,
                      keepdim=True) * vv

    # inter-chunk: sequential state carry (S/C steps instead of S)
    r_in = rr * torch.exp(c_prev)                          # (B,H,NC,C,Dk)
    k_carry = kk * torch.exp(c_tot - c)
    decay_tot = torch.exp(c_tot[..., 0, :])                # (B,H,NC,Dk)
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                            device=r.device)
    st = state.float()
    inter = []
    for n in range(nc):
        inter.append(torch.einsum("bhid,bhdv->bhiv", r_in[:, :, n], st))
        st = decay_tot[:, :, n, :, None] * st + torch.einsum(
            "bhjd,bhjv->bhdv", k_carry[:, :, n], vv[:, :, n])
    inter = torch.stack(inter, dim=2)                      # (B,H,NC,C,Dv)

    o = (intra + bonus + inter).reshape(b, h, s, dv).to(r.dtype)
    return (o, st) if return_state else o


def rwkv6_subchunk_ref(r, k, v, w, u, *, state=None, chunk: int = 64,
                       sub: int = 8, return_state=False, mm=torch.matmul,
                       mm_cross=None):
    """The chunked WKV kernel's algebra (``csrc/rwkv6_scan.cu``), in
    float32: the function of ``rwkv6_ref`` for any S >= 1 and any w in
    (0, 1], with every decay factor at most 1. Shapes as ``rwkv6_ref``;
    returns float32 ``o`` (and the final state).

    Chunks of ``chunk`` tokens (a ragged last one padded with r = k = v = 0,
    w = 1), cut into sub-chunks of ``sub``. With W(i, j) = prod_{j<s<i} w_s
    the weight of key j at query i in a chunk:

    - same sub-chunk, j < i: the product chain k_j w_{j+1} ... w_{i-1}
      dotted with r_i, per element; the bonus r_j . (u k_j) on the
      diagonal;
    - key sub-chunk b before query sub-chunk a: reference points at the
      sub-chunk edges, Q_i = r_i prod_{start(a)<=s<i} w_s, K_j = k_j
      prod_{j<s<=end(b)} w_s, g(a, b) the product over the sub-chunks
      strictly between: W(i, j) = Q_i g(a, b) K_j;
    - the carried state: o += (Q_i rho_a) S_0, rho_a the product over the
      sub-chunks before a; S_C = dec S_0 + (K kappa)^T V, kappa_b over
      those after b, dec over the chunk.

    The decays are products of w (the TPU form's exp(c_{i-1} - c_j) over
    the cumulative log-decays c is the same number): no exponent, so
    nothing overflows. The cross-sub-chunk weights go through
    ``mm_cross`` (default ``mm``), the products with v and the state
    through ``mm``: the tests pass emulations of the kernel's tensor-core
    schemes."""
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    nc, ns = -(-s // chunk), chunk // sub
    pad = nc * chunk - s
    f32 = torch.float32

    def blocks(x, fill):       # (B, H, S, D) -> (B, H, NC, NS, SUB, D)
        x = torch.nn.functional.pad(x.to(f32), (0, 0, 0, pad), value=fill)
        return x.reshape(b, h, nc, ns, sub, x.shape[-1])

    rr, kk, vv = blocks(r, 0.0), blocks(k, 0.0), blocks(v, 0.0)
    ww = blocks(w, 1.0)
    u = u.to(f32)
    ones = torch.ones_like(ww[..., :1, :])
    pre = torch.cumprod(ww, dim=-2)                     # prod_{start..t}
    q_f = torch.cat([ones, pre[..., :-1, :]], dim=-2)   # prod_{start..t-1}
    k_f = torch.flip(torch.cumprod(torch.flip(ww, [-2]), dim=-2), [-2])
    k_f = torch.cat([k_f[..., 1:, :], ones], dim=-2)    # prod_{t+1..end}
    om = pre[..., -1, :]                                # (B, H, NC, NS, D)
    qq, kq = rr * q_f, kk * k_f

    one = torch.ones_like(om[..., :1, :])
    ompre = torch.cumprod(om, dim=-2)
    rho = torch.cat([one, ompre[..., :-1, :]], dim=-2)  # before a
    dec = ompre[..., -1, :]                             # (B, H, NC, D)
    kap = torch.flip(torch.cumprod(torch.flip(om, [-2]), dim=-2), [-2])
    kap = torch.cat([kap[..., 1:, :], one], dim=-2)     # after b
    # g[a, b] = prod_{b<s<a} om_s for b < a, 0 elsewhere
    g = torch.zeros(om.shape[:-2] + (ns, ns, dk), dtype=f32,
                    device=r.device)
    for kb in range(ns - 1):
        p = torch.ones_like(om[..., 0, :])
        for qa in range(kb + 1, ns):
            g[..., qa, kb, :] = p
            p = p * om[..., qa, :]

    # cross-sub-chunk weights (B, H, NC, NS_a, NS_b, SUB_i, SUB_j)
    cross = (mm_cross or mm)(qq[..., :, None, :, :] * g[..., :, :, None, :],
                             kq[..., None, :, :, :].transpose(-1, -2))
    # diagonal blocks: the product chain of key j, carried along i
    diag = torch.zeros(rr.shape[:-1] + (sub,), dtype=f32, device=r.device)
    for j in range(sub):
        p = kk[..., j, :]
        for i in range(j + 1, sub):
            diag[..., i, j] = (rr[..., i, :] * p).sum(-1)
            p = p * ww[..., i, :]
        diag[..., j, j] = (rr[..., j, :] * u[None, :, None, None, :]
                           * kk[..., j, :]).sum(-1)
    blk = torch.arange(ns, device=r.device)
    a_w = torch.where((blk[:, None] > blk[None, :])[:, :, None, None],
                      cross, 0.0)
    eye = (blk[:, None] == blk[None, :])[:, :, None, None]
    a_w = torch.where(eye, diag[..., :, None, :, :], a_w)
    # (B, H, NC, NS_a, SUB_i, NS_b, SUB_j) -> (B, H, NC, C, C)
    a_w = a_w.permute(0, 1, 2, 3, 5, 4, 6).reshape(b, h, nc, chunk, chunk)

    vc = vv.reshape(b, h, nc, chunk, dv)
    intra = mm(a_w, vc)
    r_in = (qq * rho[..., None, :]).reshape(b, h, nc, chunk, dk)
    k_c = (kq * kap[..., None, :]).reshape(b, h, nc, chunk, dk)
    st = (torch.zeros((b, h, dk, dv), dtype=f32, device=r.device)
          if state is None else state.to(f32))
    outs = []
    for n in range(nc):
        outs.append(mm(r_in[:, :, n], st) + intra[:, :, n])
        st = dec[:, :, n, :, None] * st + mm(k_c[:, :, n].transpose(-1, -2),
                                             vc[:, :, n])
    o = torch.stack(outs, dim=2).reshape(b, h, nc * chunk, dv)[:, :, :s]
    return (o, st) if return_state else o


def flash_attention_probs(q, k, *, causal=True, window=None):
    """The softmax weights of ``flash_attention_ref``: (B, H, Sq, Sk)
    float32."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float()) * (1.0 / math.sqrt(d))
    m = attention_mask(sq, sk, causal, window, q.device)
    return torch.softmax(logits.masked_fill(~m, -1e30), dim=-1)


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """Dense attention, the function flash attention computes.

    q: (B, H, Sq, D); k, v: (B, H, Sk, D), equal head counts; query i
    and key j at positions i and j; ``window``: how many tokens each
    query may look back, itself included (None: unbounded). Scores
    (scaled by 1 / sqrt(D)), softmax and the weighted sum in float32,
    masked with -1e30; the output has q's dtype."""
    att = flash_attention_probs(q, k, causal=causal, window=window)
    return torch.einsum("bhqk,bhkd->bhqd", att, v.float()).to(q.dtype)


def attention_mask(sq: int, sk: int, causal: bool, window, device):
    """(Sq, Sk) bool: which keys each query sees (j <= i where causal, i -
    window < j with a window)."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True,
                            window=None):
    """The gradients of ``flash_attention_ref`` with respect to q, k and
    v, in its (B, H, S, D) layout with equal head counts, from explicit
    formulas (FlashAttention-2's): with the scaled scores s, P = exp(s -
    lse) on the visible keys and 0 elsewhere, D = rowsum(dO o),

        dV = P^T dO,  dS = P (dO V^T - D),  dQ = dS K / sqrt(d),
        dK = dS^T Q / sqrt(d),

    all in float32 and cast to q's dtype. ``o`` is the forward's output
    and ``lse`` its rows' log-sum-exp (B, H, Sq) float32, as the kernel
    reads them (None: recomputed from the scores)."""
    sq, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    m = attention_mask(sq, k.shape[-2], causal, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if lse is None:
        lse = torch.logsumexp(s.masked_fill(~m, -torch.inf), dim=-1)
    p = torch.exp(s - lse[..., None].float()).masked_fill(~m, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def selective_scan_ref(x, dt, b, c, a, *, state=None):
    """Mamba's selective scan, the token loop of ``repro/models/ssm.py``'s
    ``step``: per token t,

        h = exp(dt_t a) h + (dt_t x_t) b_t,    y_t = c_t . h

    x, dt: (B, S, di) and b, c: (B, S, n), all in the compute dtype; a =
    -exp(a_log): (di, n) float32; state: None (zeros) or (B, di, n)
    float32. Rounded where the JAX package rounds: ``dt x`` is formed in
    the compute dtype (one bfloat16 rounding in bfloat16) and then taken
    to float32, exp(dt a) in float32 from the compute-dtype dt, and h and
    y in float32 until y is cast to x's dtype. The decays and the inputs
    of every token are formed up front (B, S, di, n), so the loop is two
    launches a token. Returns (y (B, S, di) in x's dtype, the final state
    (B, di, n) float32)."""
    bsz, s, di = x.shape
    h = (torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                     device=x.device) if state is None else state.float())
    da = torch.exp(dt.float()[..., None] * a)
    ub = (dt * x).float()[..., None] * b.float()[:, :, None, :]
    hs = []
    for t in range(s):
        h = da[:, t] * h + ub[:, t]
        hs.append(h)
    y = torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1), c.float())
    return y.to(x.dtype), h


def rwkv6_bwd_ref(r, k, v, w, u, do, *, state=None, dstate=None):
    """The gradients of ``rwkv6_ref`` in its token form, in float32, right
    for any w in (0, 1] (nothing divides by w): the plain version the
    backward kernel (``csrc/rwkv6_scan_bwd.cu``, whose algebra is
    ``rwkv6_bwd_chunked_ref``) is held to.

    Shapes as ``rwkv6_ref``; ``do``: (B, H, S, Dv) the output's
    cotangent; ``dstate``: None (zeros) or (B, H, Dk, Dv) the final
    state's. A forward loop keeps every S_{t-1}; the reverse loop carries
    G_t = dL/dS_t from G_{S-1} = ``dstate``:

        dr_t = S_{t-1} do_t + u k_t (v_t . do_t)
        dk_t = G_t v_t + u r_t (v_t . do_t)
        dv_t = G_t^T k_t + (r_t . (u k_t)) do_t
        dw_t = rowsum(G_t * S_{t-1})
        du = sum over (B, S) of r_t k_t (v_t . do_t)
        G_{t-1} = diag(w_t) G_t + r_t do_t^T

    Returns ``(dr, dk, dv, dw, du, dstate0)``: dr, dk, dv in r's dtype,
    dw (B, H, S, Dk) and du (H, Dk) float32, and d(initial state) = G_{-1}
    float32 where ``state`` was given, else None."""
    b, h, s, dk = r.shape
    dv_ = v.shape[-1]
    rf, kf, vf, wf, dof = (x.float() for x in (r, k, v, w, do))
    uf = u.float()
    st = (torch.zeros((b, h, dk, dv_), dtype=torch.float32,
                      device=r.device) if state is None else state.float())
    before = []
    for t in range(s):
        before.append(st)
        st = wf[:, :, t, :, None] * st + (kf[:, :, t, :, None]
                                          * vf[:, :, t, None, :])
    g = (torch.zeros_like(st) if dstate is None else dstate.float())
    vd = (vf * dof).sum(-1, keepdim=True)                  # (B, H, S, 1)
    ruk = (rf * uf[None, :, None, :] * kf).sum(-1, keepdim=True)
    dr, dk_, dw = (torch.empty_like(rf) for _ in range(3))
    dv = torch.empty_like(vf)
    for t in reversed(range(s)):
        rt, kt, vt, wt, dt_ = (x[:, :, t] for x in (rf, kf, vf, wf, dof))
        dr[:, :, t] = torch.einsum("bhij,bhj->bhi", before[t], dt_)
        dk_[:, :, t] = torch.einsum("bhij,bhj->bhi", g, vt)
        dv[:, :, t] = torch.einsum("bhij,bhi->bhj", g, kt)
        dw[:, :, t] = (g * before[t]).sum(-1)
        g = wt[..., :, None] * g + rt[..., :, None] * dt_[..., None, :]
    dr = dr + uf[None, :, None, :] * kf * vd
    dk_ = dk_ + uf[None, :, None, :] * rf * vd
    dv = dv + ruk * dof
    du = (rf * kf * vd).sum((0, 2))
    return (dr.to(r.dtype), dk_.to(r.dtype), dv.to(r.dtype), dw, du,
            None if state is None else g)


def selective_scan_bwd_ref(x, dt, b, c, a, dy, *, state=None, dstate=None):
    """The gradients of ``selective_scan_ref``, the plain version the
    backward kernel (``csrc/selective_scan_bwd.cu``, whose order is
    ``selective_scan_bwd_scanned_ref``) is held to: the forward's roundings
    (dt x in the compute dtype, exp(dt a) in float32), then every
    gradient in float32 until dx, ddt, db and dc are cast to the compute
    dtype once. The product dt x is rounded in the forward; its gradient
    is taken as that of the exact product (the rounding's derivative is
    1), in float32.

    Shapes as ``selective_scan_ref``; ``dy``: (B, S, di), y's cotangent;
    ``dstate``: None (zeros) or (B, di, n), the final state's. With u_t =
    dt_t x_t, the reverse loop carries g from ``dstate``:

        g <- g + c_t dy_t                (dL/dh_t)
        dc_t = sum_d dy_t h_t,   db_t = sum_d g u_t
        du_t = sum_n g b_t,   dx_t = du_t dt_t
        ddt_t = sum_n g h_{t-1} exp(dt_t a) a + du_t x_t
        da += sum_(B, t) g h_{t-1} exp(dt_t a) dt_t
        g <- exp(dt_t a) g               (dL/dh_{t-1})

    Returns ``(dx, ddt, db, dc, da, dstate0)``: dx, ddt, db, dc in the
    compute dtype, da (di, n) float32, d(initial state) float32 where
    ``state`` was given, else None."""
    bsz, s, di = x.shape
    n = a.shape[1]
    h0 = (torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
          if state is None else state.float())
    dtf, xf, bf, cf, dyf = (t.float() for t in (dt, x, b, c, dy))
    dec = torch.exp(dtf[..., None] * a)                    # (B, S, di, n)
    ut = (dt * x).float()
    ub = ut[..., None] * bf[:, :, None, :]
    hs = []
    h = h0
    for t in range(s):
        h = dec[:, t] * h + ub[:, t]
        hs.append(h)
    g = torch.zeros_like(h0) if dstate is None else dstate.float()
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(a, dtype=torch.float32)
    for t in reversed(range(s)):
        hp = hs[t - 1] if t else h0
        g = g + cf[:, t, None, :] * dyf[:, t, :, None]
        dc[:, t] = torch.einsum("bdn,bd->bn", hs[t], dyf[:, t])
        db[:, t] = torch.einsum("bdn,bd->bn", g, ut[:, t])
        du = (g * bf[:, t, None, :]).sum(-1)               # (B, di)
        dda = g * hp * dec[:, t]
        ddt[:, t] = (dda * a).sum(-1) + du * xf[:, t]
        dx[:, t] = du * dtf[:, t]
        da = da + (dda * dtf[:, t, :, None]).sum(0)
        g = dec[:, t] * g
    return (dx.to(x.dtype), ddt.to(dt.dtype), db.to(b.dtype), dc.to(c.dtype),
            da, None if state is None else g)


def rwkv6_bwd_chunked_ref(r, k, v, w, u, do, *, state=None, dstate=None,
                          chunk: int = 64, sub: int = 8, fault=None):
    """The backward kernel's algebra (``csrc/rwkv6_scan_bwd.cu``): the
    gradients of ``rwkv6_ref`` as ``rwkv6_bwd_ref`` gives them, formed
    chunk by chunk in float32, every decay factor a product of w (at most
    1), so any w in (0, 1] is in range. Arguments and returns as
    ``rwkv6_bwd_ref``.

    Chunks of ``chunk`` tokens (a ragged last one padded with r = k = v =
    do = 0, w = 1) cut into sub-chunks of ``sub``; Q'_t, K'_t the products
    of w in a sub-chunk before and after token t, omega its whole product,
    rho_a / kappa_a those of the sub-chunks before / after a, g(a, b) of
    those strictly between b < a; Rq = Q' r, Kc = K' k.

    1. Chunk summaries: U = (Kc kappa)^T V, Y = (Rq rho)^T dO, dec.
    2. A scan over the chunks: the state before each chunk, S_0 (S_0 <-
       dec S_0 + U), and the cotangent after it, G_C (G_C <- dec G_C + Y),
       whose last value is the initial state's gradient.
    3. In each chunk, at each sub-chunk a, the state at its start and the
       cotangent at its end as products,
       S_a = rho_a S_0 + sum_{b<a} (g(a, b) Kc_b)^T V_b,
       G_a = kappa_a G_C + sum_{e>a} (g(e, a) Rq_e)^T dO_e,
       then X_a = rowsum(G_a * S_a), Sdo_t = S_a do_t, Gv_t = G_a v_t and
       dvx_t = G_a^T Kc_t for its tokens, and per element, with W(i, j)
       the product of w strictly between j and i and dA(i, j) = do_i . v_j:
         dr_t = Q'_t Sdo_t + sum_{j<t} W(t, j) k_j dA(t, j) + u k_t dA(t, t)
         dk_t = K'_t Gv_t + sum_{i>t} W(i, t) r_i dA(i, t) + u r_t dA(t, t)
         dv_t = dvx_t + sum_{i>=t} A(i, t) do_i   (A the forward's weights)
         dw_t = K'_t Q'_t X_a + K'_t sum_{j<t} W(t, j) k_j Gv_j
                + Q'_t sum_{i>t} W(i, t) r_i Sdo_i
                + sum_{j<t<i} W(i, t) W(t, j) r_i k_j dA(i, j),
       the sums over the sub-chunk's tokens: dw = rowsum(G_t * S_{t-1})
       expanded about the sub-chunk's edges, with no difference of large
       terms and no division by w.

    ``fault="sub_ref"``, a faulty version for the checks: the products
    g(a, b) of the sub-chunks between two reference points dropped (taken
    as 1)."""
    import torch.nn.functional as F

    b, h, s, d = r.shape
    f32 = torch.float32
    nc, ns = -(-s // chunk), chunk // sub
    pad = nc * chunk - s

    def blocks(x, fill):       # (B, H, S, D) -> (B, H, NC, NS, SUB, D)
        x = F.pad(x.to(f32), (0, 0, 0, pad), value=fill)
        return x.reshape(b, h, nc, ns, sub, d)

    rr, kk, vv, oo = (blocks(x, 0.0) for x in (r, k, v, do))
    ww = blocks(w, 1.0)
    uf = u.to(f32)[None, :, None, None, None, :]
    ones = torch.ones_like(ww[..., :1, :])
    pre = torch.cumprod(ww, dim=-2)
    qf = torch.cat([ones, pre[..., :-1, :]], dim=-2)          # Q'_t
    suf = torch.flip(torch.cumprod(torch.flip(ww, [-2]), dim=-2), [-2])
    kf = torch.cat([suf[..., 1:, :], ones], dim=-2)           # K'_t
    om = pre[..., -1, :]                                      # (B,H,NC,NS,D)
    one = torch.ones_like(om[..., :1, :])
    ompre = torch.cumprod(om, dim=-2)
    rho = torch.cat([one, ompre[..., :-1, :]], dim=-2)
    dec = ompre[..., -1, :]                                   # (B,H,NC,D)
    kap = torch.flip(torch.cumprod(torch.flip(om, [-2]), dim=-2), [-2])
    kap = torch.cat([kap[..., 1:, :], one], dim=-2)
    g = torch.zeros(om.shape[:-2] + (ns, ns, d), dtype=f32, device=r.device)
    for kb in range(ns - 1):
        p = torch.ones_like(om[..., 0, :])
        for qa in range(kb + 1, ns):
            g[..., qa, kb, :] = 1.0 if fault == "sub_ref" else p
            p = p * om[..., qa, :]
    rq, kc = rr * qf, kk * kf

    # 1. chunk summaries
    u_sum = torch.einsum("bhnstd,bhnstc->bhndc", kc * kap[..., None, :], vv)
    y_sum = torch.einsum("bhnstd,bhnstc->bhndc", rq * rho[..., None, :], oo)
    # 2. the scan over chunks
    st = (torch.zeros((b, h, d, d), dtype=f32, device=r.device)
          if state is None else state.to(f32))
    s0 = []
    for n in range(nc):
        s0.append(st)
        st = dec[:, :, n, :, None] * st + u_sum[:, :, n]
    gt = (torch.zeros((b, h, d, d), dtype=f32, device=r.device)
          if dstate is None else dstate.to(f32))
    gc = [None] * nc
    for n in reversed(range(nc)):
        gc[n] = gt
        gt = dec[:, :, n, :, None] * gt + y_sum[:, :, n]
    s0, gc = torch.stack(s0, dim=2), torch.stack(gc, dim=2)  # (B,H,NC,D,D)

    # 3. the sub-chunks' edge states, then the chunk's gradients
    sa = rho[..., None] * s0[:, :, :, None]                   # (B,H,NC,NS,D,D)
    ga = kap[..., None] * gc[:, :, :, None]
    sa, ga = sa.clone(), ga.clone()
    for a in range(ns):
        if a > 0:
            kg = (g[..., a, :a, None, :] * kc[..., :a, :, :]).reshape(
                b, h, nc, a * sub, d)
            sa[..., a, :, :] += torch.einsum(
                "bhntd,bhntc->bhndc", kg, vv[..., :a, :, :].reshape(
                    b, h, nc, a * sub, d))
        if a < ns - 1:
            m = ns - 1 - a
            rg = (g[..., a + 1:, a, None, :] * rq[..., a + 1:, :, :]).reshape(
                b, h, nc, m * sub, d)
            ga[..., a, :, :] += torch.einsum(
                "bhntd,bhntc->bhndc", rg, oo[..., a + 1:, :, :].reshape(
                    b, h, nc, m * sub, d))
    xs = (ga * sa).sum(-1)                                    # (B,H,NC,NS,D)
    sdo = torch.einsum("bhnadc,bhnatc->bhnatd", sa, oo)
    gv = torch.einsum("bhnadc,bhnatc->bhnatd", ga, vv)
    dvx = torch.einsum("bhnadc,bhnatd->bhnatc", ga, kc)
    del sa, ga

    da_ = torch.einsum("...ic,...jc->...ij", oo, vv)          # dA(i, j)
    dad = torch.diagonal(da_, dim1=-2, dim2=-1)[..., None]    # dA(t, t)
    wm = torch.zeros(ww.shape[:-1] + (sub, d), dtype=f32, device=r.device)
    for j in range(sub):
        p = torch.ones_like(ww[..., 0, :])
        for i in range(j + 1, sub):
            wm[..., i, j, :] = p
            p = p * ww[..., i, :]
    aw = torch.einsum("...id,...ijd,...jd->...ij", rr, wm, kk)
    aw = aw + torch.diag_embed((rr * uf * kk).sum(-1))
    dr = (qf * sdo + torch.einsum("...tjd,...jd,...tj->...td", wm, kk, da_)
          + uf * kk * dad)
    dk = (kf * gv + torch.einsum("...itd,...id,...it->...td", wm, rr, da_)
          + uf * rr * dad)
    dv = dvx + torch.einsum("...it,...ic->...tc", aw, oo)
    trip = torch.zeros_like(dr)
    for t in range(1, sub - 1):
        psi = torch.einsum("...jd,...jd,...ij->...id", wm[..., t, :, :], kk,
                           da_)
        trip[..., t, :] = torch.einsum("...id,...id,...id->...d",
                                       wm[..., :, t, :], rr, psi)
    dw = (kf * qf * xs[..., None, :]
          + kf * torch.einsum("...tjd,...jd,...jd->...td", wm, kk, gv)
          + qf * torch.einsum("...itd,...id,...id->...td", wm, rr, sdo)
          + trip)
    du = (rr * kk * dad).sum((0, 2, 3, 4))

    def tokens(x):
        return x.reshape(b, h, nc * chunk, d)[:, :, :s]

    dr, dk, dv, dw = (tokens(x) for x in (dr, dk, dv, dw))
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw, du,
            None if state is None else gt)


def selective_scan_bwd_scanned_ref(x, dt, b, c, a, dy, *, state=None,
                                   dstate=None, chunk: int = 128,
                                   items: int = 16, fault=None):
    """The backward kernel's order (``csrc/selective_scan_bwd.cu``): the
    gradients of ``selective_scan_ref`` as ``selective_scan_bwd_ref``
    gives them (arguments, roundings and returns as there), formed from
    runs of ``items`` tokens, ``chunk`` tokens a chunk (a ragged tail
    padded with x = dt = dy = 0, b = c = 0: decay 1, no input).

    Per (batch, channel, state index), with a_t = exp(dt_t a) and the
    affine maps h <- a_t h + u_t b_t (forward) and gamma <- a_t (gamma +
    c_t dy_t) (the cotangent carried back from token t to t - 1):

    1. each run's pair from zero, (its decay, its state) and (its decay,
       its carry), the decay one exponential of a times the run's summed
       dt; composed over a chunk's runs into the chunk's pairs;
    2. a scan over the chunks (the chunk's decay, one exponential of a
       times its summed dt): h before each chunk, gamma after it, and the
       initial state's gradient;
    3. in each chunk, the runs' carries composed from the chunk's (h in
       order, gamma in reverse), then each run's tokens: h_t, G_t = c_t
       dy_t + gamma_t (dL/dh_t), and the gradients of
       ``selective_scan_bwd_ref`` from them.

    ``fault="run_carry"``, a faulty version for the checks: the carry
    between runs inside a chunk dropped (every run but a chunk's first
    starts h from 0, every run but its last ends gamma at 0)."""
    import torch.nn.functional as F

    bsz, s, di = x.shape
    n = a.shape[1]
    f32 = torch.float32
    nc, runs = -(-s // chunk), chunk // items
    pad = nc * chunk - s

    def blocks(z):              # (B, S, ...) -> (B, NC, R, I, ...)
        z = F.pad(z.to(f32), (0, 0, 0, pad))
        return z.reshape(bsz, nc, runs, items, z.shape[-1])

    dtf, xf, ut, dyf = (blocks(z) for z in (dt, x, dt * x, dy))
    bf, cf = blocks(b), blocks(c)
    dec = torch.exp(dtf[..., None] * a)              # (B, NC, R, I, di, n)
    ub = ut[..., None] * bf[..., None, :]
    cdy = cf[..., None, :] * dyf[..., None]
    ra = torch.exp(dtf.sum(3)[..., None] * a)        # (B, NC, R, di, n)
    zero = torch.zeros_like(ra[:, :, 0])
    hl, gl = torch.zeros_like(ra), torch.zeros_like(ra)
    for i in range(items):
        hl = dec[:, :, :, i] * hl + ub[:, :, :, i]
        gl = dec[:, :, :, items - 1 - i] * (gl + cdy[:, :, :, items - 1 - i])
    hc, gcs = zero, zero
    for j in range(runs):
        hc = ra[:, :, j] * hc + hl[:, :, j]
        gcs = ra[:, :, runs - 1 - j] * gcs + gl[:, :, runs - 1 - j]
    ac = torch.exp(dtf.sum((2, 3))[..., None] * a)   # (B, NC, di, n)

    hs = (torch.zeros((bsz, di, n), dtype=f32, device=x.device)
          if state is None else state.to(f32))
    hstart = []
    for m in range(nc):
        hstart.append(hs)
        hs = ac[:, m] * hs + hc[:, m]
    gs = (torch.zeros((bsz, di, n), dtype=f32, device=x.device)
          if dstate is None else dstate.to(f32))
    gend = [None] * nc
    for m in reversed(range(nc)):
        gend[m] = gs
        gs = ac[:, m] * gs + gcs[:, m]

    drop = fault == "run_carry"
    hb, car = [], torch.stack(hstart, 1)
    for j in range(runs):
        hb.append(car if j == 0 or not drop else zero.expand_as(car))
        car = ra[:, :, j] * hb[-1] + hl[:, :, j]
    ga, car = [None] * runs, torch.stack(gend, 1)
    for j in reversed(range(runs)):
        ga[j] = car if j == runs - 1 or not drop else zero.expand_as(car)
        car = ra[:, :, j] * ga[j] + gl[:, :, j]
    h, gam = torch.stack(hb, 2), torch.stack(ga, 2)  # (B, NC, R, di, n)

    hp, hn = [], []
    for i in range(items):
        hp.append(h)
        h = dec[:, :, :, i] * h + ub[:, :, :, i]
        hn.append(h)
    dx, ddt, db, dc = [None] * items, [None] * items, [None] * items, [
        None] * items
    da = torch.zeros_like(a, dtype=f32)
    for i in reversed(range(items)):
        gg = cdy[:, :, :, i] + gam
        dc[i] = torch.einsum("...dn,...d->...n", hn[i], dyf[:, :, :, i])
        db[i] = torch.einsum("...dn,...d->...n", gg, ut[:, :, :, i])
        du = (gg * bf[:, :, :, i, None, :]).sum(-1)
        dda = gg * hp[i] * dec[:, :, :, i]
        ddt[i] = (dda * a).sum(-1) + du * xf[:, :, :, i]
        dx[i] = du * dtf[:, :, :, i]
        da = da + (dda * dtf[:, :, :, i, :, None]).sum((0, 1, 2))
        gam = dec[:, :, :, i] * gg

    def tokens(zs):
        z = torch.stack(zs, 3)
        return z.reshape(bsz, nc * chunk, z.shape[-1])[:, :s]

    dx, ddt, db, dc = (tokens(z) for z in (dx, ddt, db, dc))
    return (dx.to(x.dtype), ddt.to(dt.dtype), db.to(b.dtype),
            dc.to(c.dtype), da, None if state is None else gs)
