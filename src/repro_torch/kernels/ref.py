"""Plain PyTorch versions of the kernels on the port's paths (TGN training,
RWKV6 and StarCoder2 serving, the ``ops.gru`` cell).

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
           "flash_attention_probs",
           "flash_attention_ref"]


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
    """The softmax weights of ``flash_attention_ref``: (B, H, S, S)
    float32."""
    s, d = q.shape[-2], q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float()) * (1.0 / math.sqrt(d))
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    m = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ki > qi - window
    return torch.softmax(logits.masked_fill(~m, -1e30), dim=-1)


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """Dense attention, the function flash attention computes.

    q, k, v: (B, H, S, D), equal head counts; ``window``: how many tokens
    each query may look back, itself included (None: unbounded). Scores
    (scaled by 1 / sqrt(D)), softmax and the weighted sum in float32,
    masked with -1e30; the output has q's dtype."""
    att = flash_attention_probs(q, k, causal=causal, window=window)
    return torch.einsum("bhqk,bhkd->bhqd", att, v.float()).to(q.dtype)
