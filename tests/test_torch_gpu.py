"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need an NVIDIA GPU and skip without one; they import nothing
of JAX, so they run on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: sampling is exact (integer ids, copied times); the flush and
the attention agree to 1e-5, float32 sums taken in another order; the
flush's grads to 1e-5 of each one's largest magnitude (the weight grads sum
every pending row through the GRU backward's 3xTF32 products). The WKV
kernel agrees with its plain version to 1e-5 of the output's largest
magnitude in float32 (sums in another order, and the chunked algebra),
plus one bfloat16 unit (2^-7 relative) where the output is bfloat16. The
GRU cell agrees to 1e-5 forward and to 1e-5 of each gradient's largest
magnitude (at least 1e-5): the weight grads sum up to 512 rows in another
order. Both WKV kernels (the chunked one for S >= 64, the sequential one
below) are held to the plain versions at every S they take, the chunked
one also at strong decays against the token scan. Flash attention agrees to 1e-5 in float32; in bfloat16 to
2^-8 |plain| + 2^-14 |P| |V|: one rounding of the output to bfloat16, and
float32 sums with P kept to 2^-17 (hi + lo bfloat16 parts) against the
plain version's weights applied to |v|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.build import KERNELS  # noqa: E402
from repro_torch.tig.models import TIGConfig, init_params  # noqa: E402
from repro_torch.tig.sampler import ChronoNeighborIndex  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _max_diff(a, b):
    return max(float((x.cpu() - y.cpu()).abs().max()) for x, y in zip(a, b))


@pytest.mark.parametrize("window", [0, 1])
def test_neighbor_sample_kernel_exact(cuda, window):
    rng = np.random.default_rng(0)
    n, e, k = 30, 150, 6
    src = rng.integers(0, 25, e)          # nodes 25..29 have no events
    dst = rng.integers(0, 25, e)
    index = ChronoNeighborIndex(src, dst, np.sort(rng.uniform(0, 10, e)),
                                np.arange(e), n, k, batch_size=10)
    tcsr = {key: torch.from_numpy(v).to(cuda)
            for key, v in index.device_export(depth=2).items()}
    nodes = torch.arange(n, dtype=torch.int32, device=cuda)
    batch_of = torch.from_numpy(
        rng.integers(0, index.num_batches + 1, n).astype(np.int32)).to(cuda)
    before = KERNELS["neighbor_sample"].launches
    got = ops.neighbor_sample(tcsr, nodes, batch_of, k, window=window)
    want = ref.sample_ref(tcsr["indptr"], tcsr["nbr"], tcsr["t"],
                          tcsr["eidx"], tcsr["bat"], nodes, batch_of, k,
                          window)
    assert KERNELS["neighbor_sample"].launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _hub_tcsr(dev, lengths, pad, seed=0):
    """A T-CSR whose node i has ``lengths[i]`` events, keys sorted with
    runs of about 60 (a hub's events per batch), front-padded by ``pad``."""
    rng = np.random.default_rng(seed)
    bat = [np.zeros(pad, np.int64)] + [
        np.sort(rng.integers(1, 2 + n // 60, n)) for n in lengths]
    total = pad + int(sum(lengths))
    ex = {"indptr": pad + np.concatenate([[0], np.cumsum(lengths)]),
          "nbr": rng.integers(0, 1000, total), "t": rng.random(total),
          "eidx": np.arange(total), "bat": np.concatenate(bat)}
    return {key: torch.from_numpy(v.astype(
        np.float32 if key == "t" else np.int32)).to(dev)
        for key, v in ex.items()}


def _sample_once(tcsr, nodes, batch_of, k, window=0):
    """The kernel's outputs (one launch, two calls bitwise equal) after
    ``sample_ref``'s, which they must equal bitwise."""
    before = KERNELS["neighbor_sample"].launches
    got = ops.neighbor_sample(tcsr, nodes, batch_of, k, window=window)
    assert KERNELS["neighbor_sample"].launches == before + 1
    again = ops.neighbor_sample(tcsr, nodes, batch_of, k, window=window)
    want = ref.sample_ref(tcsr["indptr"], tcsr["nbr"], tcsr["t"],
                          tcsr["eidx"], tcsr["bat"], nodes, batch_of, k,
                          window)
    for x, y, z in zip(got, again, want):
        assert torch.equal(x, y) and torch.equal(x, z)
    return got


def test_neighbor_sample_kernel_on_round_boundaries(cuda):
    """Segments on each side of the search's round boundaries, (TPR + 1)^r
    - 1, (TPR + 1)^r and + 1 events, each queried at every batch index
    from 0 to past its last, once with a device-scalar batch index."""
    from repro_torch.kernels.neighbor_sample import ROW_THREADS

    p = ROW_THREADS + 1
    lengths = sorted({0, 1, ROW_THREADS} | {p ** r + d for r in (1, 2, 3)
                                            for d in (-1, 0, 1)})
    tcsr = _hub_tcsr(cuda, lengths, pad=20)
    top = 3 + max(lengths) // 60
    nodes = np.repeat(np.arange(len(lengths)), top)
    batch_of = np.tile(np.arange(top), len(lengths))
    _sample_once(tcsr, torch.from_numpy(nodes.astype(np.int32)).to(cuda),
                 torch.from_numpy(batch_of.astype(np.int32)).to(cuda), 10)
    hub = torch.full((5,), len(lengths) - 1, dtype=torch.int32, device=cuda)
    _sample_once(tcsr, hub, torch.tensor(top // 2, dtype=torch.int32,
                                         device=cuda), 10)


@pytest.mark.parametrize("k", [1, 32, 64])
def test_neighbor_sample_kernel_at_wide_k(cuda, k):
    """K up to 64 with per-row windows 0 / 1 over an export of depth 2."""
    rng = np.random.default_rng(k)
    n, e = 40, 4000
    index = ChronoNeighborIndex(rng.integers(0, 30, e),
                                rng.integers(0, 30, e),
                                np.sort(rng.uniform(0, 10, e)), np.arange(e),
                                n, k, batch_size=50)
    tcsr = {key: torch.from_numpy(v).to(cuda)
            for key, v in index.device_export(depth=2).items()}
    rows = 3 * n
    nodes = torch.from_numpy(rng.integers(0, n, rows).astype(np.int32))
    batch_of = torch.from_numpy(
        rng.integers(0, index.num_batches + 2, rows).astype(np.int32))
    window = torch.from_numpy(rng.integers(0, 2, rows).astype(np.int32))
    got = _sample_once(tcsr, nodes.to(cuda), batch_of.to(cuda), k,
                       window.to(cuda))
    assert (got[0] >= 0).all(1).any() and (got[0] < 0).any()


def test_sample_roles_kernel(cuda):
    """The roles form at a batch with -1 ids and invalid slots: one launch,
    bitwise equal to ``sample_roles_ref`` and to itself."""
    rng = np.random.default_rng(1)
    n, e, b, k = 60, 3000, 200, 10
    index = ChronoNeighborIndex(rng.integers(0, 50, e),
                                rng.integers(0, 50, e),
                                np.sort(rng.uniform(0, 10, e)), np.arange(e),
                                n, k, batch_size=b)
    tcsr = {key: torch.from_numpy(v).to(cuda)
            for key, v in index.device_export().items()}
    src, dst, neg = (rng.integers(-1, n, b).astype(np.int32)
                     for _ in range(3))
    valid = rng.random(b) > 0.2
    args = [torch.from_numpy(x).to(cuda) for x in (src, dst, neg, valid)]
    for batch_of in (7, torch.tensor(7, dtype=torch.int32, device=cuda)):
        before = KERNELS["neighbor_sample"].launches
        got = ops.sample_roles(tcsr, *args, batch_of, k)
        assert KERNELS["neighbor_sample"].launches == before + 1
        again = ops.sample_roles(tcsr, *args, batch_of, k)
        want = ref.sample_roles_ref(tcsr["indptr"], tcsr["nbr"], tcsr["t"],
                                    tcsr["eidx"], tcsr["bat"], *args, 7, k)
        for x, y, z in zip(got, again, want):
            assert torch.equal(x, y) and torch.equal(x, z)
    dead = ~np.tile(valid, 3) | (np.concatenate([src, dst, neg]) < 0)
    assert (got[0].cpu().numpy()[dead] == -1).all()
    assert (got[0].cpu().numpy()[~dead] >= 0).any()


def _flush_args(dev, ids, n, dm, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = ids.shape[0]
    args = [ids.to(dev)] + [torch.randn(s, generator=gen, device=dev)
                            for s in ((r, dm), (r,), (n + 1, d), (n + 1,),
                                      (dm, 3 * d), (d, 3 * d), (3 * d,),
                                      (3 * d,))]
    args[5] *= dm ** -0.5
    args[6] *= d ** -0.5
    return args


def _grads_close(got, want, rel=1e-5):
    """Each grad within ``rel`` of its own largest magnitude (at least
    ``rel``): the weight grads sum every row through 3xTF32."""
    for a, w in zip(got, want):
        lim = rel * max(1.0, float(w.abs().max()))
        assert float((a - w).abs().max()) <= lim


def test_fused_flush_kernel_and_grads(cuda):
    ids = torch.tensor([3, 5, 3, 12, 7, 5, 5, 12, 0, 1, 2, 3] * 2,
                       dtype=torch.int32)
    args = _flush_args(cuda, ids, 12, 10, 6, 1)
    before = KERNELS["fused_flush"].launches
    got = ops.fused_flush(*[x.clone() for x in args])
    assert KERNELS["fused_flush"].launches == before + 1
    assert _max_diff(got, ref.flush_ref(*args)) < 1e-5
    # backward from the touched rows, against autograd of flush_ref; each
    # side on its own copies, as the kernel writes mem / last in place
    diff = (1, 5, 6, 7, 8)
    gen = torch.Generator(device=cuda).manual_seed(2)
    cot = [torch.randn(got[i].shape, generator=gen, device=cuda)
           for i in (0, 2)]                      # last' has no gradient
    a = [x.clone().requires_grad_(i in diff) for i, x in enumerate(args)]
    b = [x.clone().requires_grad_(i in diff) for i, x in enumerate(args)]
    bwd = KERNELS["fused_gru_bwd"].launches
    out_a, out_b = ops.fused_flush(*a), ref.flush_ref(*b)
    ga = torch.autograd.grad((out_a[0], out_a[2]), [a[i] for i in diff], cot)
    gb = torch.autograd.grad((out_b[0], out_b[2]), [b[i] for i in diff], cot)
    assert KERNELS["fused_gru_bwd"].launches == bwd + 1
    _grads_close(ga, gb)


@pytest.mark.parametrize("name", ["path-like", "heavy-duplicates",
                                  "all-padding"])
def test_fused_flush_in_place_contract(cuda, name):
    """At the TGN path's widths: the returned mem / last are the inputs,
    rows not in ids are bitwise unchanged, the dump rows are zero."""
    rng = np.random.default_rng(3)
    n, dm, d = 10_000, 616, 172
    ids = {"path-like": np.where(rng.uniform(size=400) < 0.95,
                                 rng.integers(0, 3_000, 400), n),
           "heavy-duplicates": np.where(rng.uniform(size=400) < 0.9,
                                        rng.integers(0, 5, 400), n),
           "all-padding": np.full(400, n)}[name]
    args = _flush_args(cuda, torch.from_numpy(ids.astype(np.int32)), n, dm,
                       d, 4)
    args[3][n], args[4][n] = 1.0, 1.0          # the dump row gets cleared
    # the kernel writes its own copies in place; flush_ref reads the inputs
    mine = [x.clone() for x in args]
    got = ops.fused_flush(*mine)
    assert got[0] is mine[3] and got[1] is mine[4]
    want = ref.flush_ref(*args)
    assert _max_diff(got, want) < 1e-5
    keep = torch.ones(n + 1, dtype=torch.bool, device=cuda)
    keep[args[0].long()] = False
    keep[n] = False                       # cleared, checked below
    assert torch.equal(got[0][keep], args[3][keep])
    assert torch.equal(got[1][keep], args[4][keep])
    assert float(got[0][n].abs().max()) == 0.0 and float(got[1][n]) == 0.0


def test_temporal_attn_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    b, k, h, d = 40, 10, 2, 86
    q = torch.randn((b, h, d), generator=gen, device=cuda)
    kk = torch.randn((b, k, h, d), generator=gen, device=cuda)
    v = torch.randn((b, k, h, d), generator=gen, device=cuda)
    mask = torch.rand((b, k), generator=gen, device=cuda) < 0.6
    mask[0] = False                                   # no neighbor at all
    before = (KERNELS["temporal_attn"].launches,
              KERNELS["temporal_attn_bwd"].launches)
    x = [t.clone().requires_grad_() for t in (q, kk, v)]
    y = [t.clone().requires_grad_() for t in (q, kk, v)]
    out = ops.temporal_attention(*x, mask)
    want = ref.temporal_attention_ref(*y, mask)
    assert float((out - want).abs().max().detach()) < 1e-5
    assert float(out[0].abs().max()) == 0.0
    g = torch.randn(out.shape, generator=gen, device=cuda)
    assert _max_diff(torch.autograd.grad(out, x, g),
                     torch.autograd.grad(want, y, g)) < 1e-5
    assert (KERNELS["temporal_attn"].launches,
            KERNELS["temporal_attn_bwd"].launches) == (before[0] + 1,
                                                       before[1] + 1)


def _attn_case(dev, b, kn, h, d, seed):
    """q, k, v, g and a mask like the sampler's: each row's valid slots a
    suffix of its K, an eighth of the rows without any, one row full, one
    row's mask not a suffix (a single row: full)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(s, generator=gen, device=dev)
                  for s in ((b, h, d), (b, kn, h, d), (b, kn, h, d),
                            (b, h, d)))
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, kn + 1, b) if b > 2 else np.full(b, kn)
    cnt[:b // 8] = 0
    m = np.arange(kn)[None, :] >= (kn - cnt)[:, None]
    if b > 2:
        m[b // 8] = True
        m[b // 8 + 1] = rng.uniform(size=kn) < 0.5
    return q, k, v, g, torch.from_numpy(m).to(dev)


def _attn_kernels_hold(q, k, v, g, mask):
    """Both kernels, one launch each, against the plain version and its
    autograd (1e-5); exact zeros for rows without a neighbor and masked
    slots' dk / dv; a second call bitwise equal."""
    from repro_torch.kernels.temporal_attn import (temporal_attn_bwd,
                                                    temporal_attn_fwd)

    names = ("temporal_attn", "temporal_attn_bwd")
    before = [KERNELS[n].launches for n in names]
    out = temporal_attn_fwd(q, k, v, mask)
    got = temporal_attn_bwd(g, q, k, v, mask)
    assert [KERNELS[n].launches for n in names] == [x + 1 for x in before]
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    want = ref.temporal_attention_ref(*xs, mask)
    pairs = [(out, want.detach()), *zip(got, torch.autograd.grad(want, xs,
                                                                 g))]
    assert all(_max_diff([x], [y]) <= 1e-5 for x, y in pairs if x.numel())
    none = ~mask.any(-1)
    for x in (out, *got):
        assert not bool(x[none].any())
    for x in got[1:]:
        assert not bool(x[~mask].any())
    again = [temporal_attn_fwd(q, k, v, mask),
             *temporal_attn_bwd(g, q, k, v, mask)]
    assert all(torch.equal(x, y) for x, y in zip([out, *got], again))


@pytest.mark.parametrize("b,kn,h,d", [
    (600, 10, 2, 86),       # the TGN path's shape
    (600, 1, 2, 86),
    (600, 32, 2, 86),
    (64, 64, 4, 128),       # k, v take 256 KB a row: slices of slots
    (100, 10, 3, 7),        # H * D not a multiple of 4: cp.async staging
    (1, 10, 2, 86),
    (37, 10, 2, 86),
    (5, 0, 2, 8),           # no slots at all
])
def test_temporal_attn_kernels_at_shapes(cuda, b, kn, h, d):
    _attn_kernels_hold(*_attn_case(cuda, b, kn, h, d, seed=b + kn))


def test_temporal_attn_kernels_on_misaligned_views(cuda):
    """Views 4 bytes off a 16-byte boundary take the cp.async staging."""
    q, k, v, g, mask = _attn_case(cuda, 50, 10, 2, 86, seed=3)
    q, k, v, g = (torch.cat([x.flatten(), x.new_zeros(1)])[1:].view(x.shape)
                  for x in (q, k, v, g))
    assert q.data_ptr() % 16 != 0
    _attn_kernels_hold(q, k, v, g, mask)


def test_temporal_attn_check_catches_a_dropped_slot(cuda):
    """The plain version with one row's last valid slot dropped misses the
    kernels' 1e-5 limit at the path's shape, forward and backward: the
    checks above catch a slot that was never staged."""
    q, k, v, g, mask = _attn_case(cuda, 600, 10, 2, 86, seed=610)
    row = int(mask.sum(-1).argmax())
    faulty = mask.clone()
    faulty[row, int(mask[row].nonzero()[-1])] = False
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    want = ref.temporal_attention_ref(*xs, mask)
    bad = ref.temporal_attention_ref(*ys, faulty)
    assert _max_diff([bad.detach()], [want.detach()]) > 1e-5
    assert _max_diff(torch.autograd.grad(bad, ys, g),
                     torch.autograd.grad(want, xs, g)) > 1e-5


def test_kernel_wrappers_reject_bad_arguments(cuda):
    from repro_torch.kernels.temporal_attn import temporal_attn_fwd

    q = torch.zeros((4, 2, 8), device=cuda)
    kv = torch.zeros((4, 3, 2, 8), device=cuda)
    mask = torch.ones((4, 3), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        temporal_attn_fwd(q.double(), kv, kv, mask)
    with pytest.raises(ValueError):
        temporal_attn_fwd(q, kv[:, :2], kv, mask)
    strided = torch.zeros((4, 2, 3, 8), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        temporal_attn_fwd(q, strided, kv, mask)


def test_train_single_on_card_matches_cpu(cuda):
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.train import train_single

    g = synthetic_tig("tiny")
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, n_heads=2, batch_size=50)
    p0 = init_params(torch.Generator().manual_seed(0), cfg)
    on_card = train_single(g, cfg, epochs=1, params=p0)
    on_cpu = train_single(g, cfg, epochs=1, params=p0, device="cpu")
    # float32 sums in another order, compounded over 17 AdamW steps
    assert abs(on_card.losses[0] - on_cpu.losses[0]) < 1e-4
    assert abs(on_card.val_ap - on_cpu.val_ap) < 1e-3
    assert abs(on_card.test_ap - on_cpu.test_ap) < 1e-3


def test_two_layers_on_card_match_cpu(cuda):
    """``train_single`` at ``n_layers`` 2 (the windowed nodes-form
    sampling, two attention launches a step) on the card against the CPU
    from the same params; and one graphed epoch at L = 2 against the
    eager one on the card, with the launches a step: one sampling, two
    of each attention kernel."""
    from repro_torch.optim import adamw
    from repro_torch.tig import engine
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.train import train_single

    g = synthetic_tig("tiny")
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, n_heads=2, batch_size=50,
                    n_layers=2)
    p0 = init_params(torch.Generator().manual_seed(0), cfg)
    on_card = train_single(g, cfg, epochs=1, params=p0)
    on_cpu = train_single(g, cfg, epochs=1, params=p0, device="cpu")
    assert abs(on_card.losses[0] - on_cpu.losses[0]) < 1e-4
    assert abs(on_card.val_ap - on_cpu.val_ap) < 1e-3
    assert abs(on_card.test_ap - on_cpu.test_ap) < 1e-3

    t = _tiny_epochs(cuda, "tgn", n_layers=2)
    cfg, params, state, tables = t["cfg"], t["params"], t["state"], t["tables"]
    prog, tcsr = t["train"]
    steps = prog["src"].shape[0]
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    before = {n: KERNELS[n].launches for n in TIG_KERNELS}
    graphed = engine.make_train_epoch(cfg, opt)(
        params, opt.init(params), state, prog, tables, tcsr=tcsr)
    torch.cuda.synchronize()
    assert {n: KERNELS[n].launches - before[n] for n in TIG_KERNELS} == {
        "neighbor_sample": steps, "fused_flush": steps,
        "temporal_attn": 2 * steps, "temporal_attn_bwd": 2 * steps,
        "fused_gru_bwd": steps}
    eager = engine.scan_train_epoch(params, opt.init(params), state, prog,
                                    tables, cfg=cfg, opt=opt, tcsr=tcsr)
    assert _max_diff([graphed[3]], [eager[3]]) < 1e-4
    assert _max_diff([graphed[2]["mem"]], [eager[2]["mem"]]) < 1e-4


def test_restarter_on_card_matches_cpu(cuda):
    """TIGER's restarter on the card against the CPU from the same
    params: the bank (embeddings to 1e-4, times and seen mask exactly),
    the replay memory, the fit from the same bank, target and initial
    head over 20 steps (it turns chaotic later, as between the packages:
    ``tests/test_torch_restart.py``), and ``run_protocol(warm="restart")``
    through one bundle on both (AP / AUROC to 1e-3)."""
    from repro_torch.tig.batching import make_tables
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.protocol import run_protocol, split_views
    from repro_torch.tig.restart import (collect_bank, fit_restarter,
                                         restart_memory)
    from repro_torch.tig.train import train_single
    from repro_torch.tree import tree_map

    g = synthetic_tig("tiny")
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, n_heads=2, batch_size=50)
    params = train_single(g, cfg, epochs=1, device="cpu").params
    splits = split_views(g)
    out = {}
    for dev in ("cuda", "cpu"):
        tables = {k: torch.from_numpy(v).to(dev) for k, v in
                  make_tables(g.edge_feat, g.node_feat).items()}
        p = tree_map(lambda x: x.to(dev), params)
        bank, state = collect_bank(p, cfg, splits, tables, device=dev)
        out[dev] = dict(tables=tables, params=p, bank=bank, state=state)
    bc, bp = out["cuda"]["bank"], out["cpu"]["bank"]
    assert np.array_equal(bc.seen, bp.seen) and np.array_equal(bc.t, bp.t)
    assert np.abs(bc.emb - bp.emb).max() < 1e-4
    assert _max_diff([out["cuda"]["state"]["mem"]],
                     [out["cpu"]["state"]["mem"]]) < 1e-4
    fits = {dev: fit_restarter(bp, out["cpu"]["state"], cfg,
                               out[dev]["tables"], steps=20)
            for dev in ("cuda", "cpu")}
    mems = {dev: restart_memory(fits[dev], splits.num_nodes,
                                out[dev]["tables"])["mem"].cpu()
            for dev in fits}
    scale = float(mems["cpu"].abs().max())
    assert float((mems["cuda"] - mems["cpu"]).abs().max()) <= 1e-3 * scale
    metrics = {dev: run_protocol(out[dev]["params"], cfg, splits,
                                 out[dev]["tables"], warm="restart",
                                 restarter=fits["cpu"], device=dev)
               for dev in ("cuda", "cpu")}
    for key in ("val_ap", "test_ap", "val_auc", "test_auc"):
        assert abs(metrics["cuda"][key] - metrics["cpu"][key]) < 1e-3, key


TIG_KERNELS = ("neighbor_sample", "fused_flush", "temporal_attn",
               "temporal_attn_bwd", "fused_gru_bwd")


def _tiny_epochs(dev, flavor, plan="device", n_layers=1):
    """A narrow model on ``synthetic_tig("tiny")``: the train program and
    the val program (each with its staged T-CSR under ``plan="device"``,
    exported at depth ``n_layers``), tables, params from a seed and a
    fresh state."""
    from repro_torch.tig.batching import build_batch_program, make_tables
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.models import init_state
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.train import epoch_rng

    g = synthetic_tig("tiny")
    cfg = TIGConfig(flavor=flavor, dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, n_heads=2, batch_size=50,
                    n_layers=n_layers)
    sp = split_views(g)
    out = {"cfg": cfg, "state": init_state(cfg, g.num_nodes, dev),
           "params": init_params(torch.Generator().manual_seed(0), cfg, dev),
           "tables": {k: torch.from_numpy(v).to(dev) for k, v in
                      make_tables(g.edge_feat, g.node_feat).items()}}
    hist = None
    for i, (name, view) in enumerate((("train", sp.train), ("val", sp.val))):
        index = ChronoNeighborIndex(view.src, view.dst, view.t, view.eidx,
                                    g.num_nodes, cfg.num_neighbors,
                                    cfg.batch_size, history=hist)
        # as train_single plans: the device plan continues the staged
        # index, the host plan the history
        prog, hist = build_batch_program(
            view, cfg, epoch_rng(0, 0, i + 1),
            history=None if plan == "device" else hist,
            neg_pool=sp.neg_pool,
            index=index if plan == "device" else None, plan=plan)
        out[name] = (prog, {k: torch.from_numpy(v).to(dev) for k, v in
                            index.device_export(depth=n_layers).items()}
                     if plan == "device" else None)
    return out


@pytest.mark.parametrize("flavor,plan", [(f, "device") for f in (
    "jodie", "dyrep", "tgn", "tige")] + [("tgn", "host")])
def test_graphed_epochs_match_eager(cuda, flavor, plan):
    """``make_train_epoch`` / ``make_eval_epoch`` (a captured step, replayed)
    against ``scan_train_epoch`` / ``scan_eval_stream`` (the same step,
    eager) on the card: the same kernels in the same order, so losses,
    params, memory and logits agree to 1e-4 (atomics in some of the
    library's kernels may reorder sums); the attention's key bias, whose
    gradient is float32 noise, is not compared."""
    from repro_torch.optim import adamw
    from repro_torch.tig import engine

    t = _tiny_epochs(cuda, flavor, plan)
    cfg, params, state, tables = t["cfg"], t["params"], t["state"], t["tables"]
    (prog, tcsr), (vprog, vtcsr) = t["train"], t["val"]
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    graphed = engine.make_train_epoch(cfg, opt)(
        params, opt.init(params), state, prog, tables, tcsr=tcsr)
    eager = engine.scan_train_epoch(params, opt.init(params), state, prog,
                                    tables, cfg=cfg, opt=opt, tcsr=tcsr)
    assert _max_diff([graphed[3]], [eager[3]]) < 1e-4
    for key in ("mem", "mem2", "last", "pend_raw"):
        assert _max_diff([graphed[2][key]], [eager[2][key]]) < 1e-4, key
    assert torch.equal(graphed[2]["pend_ids"], eager[2]["pend_ids"])
    for tree_g, tree_e in ((graphed[0], eager[0]),
                           (graphed[1]["mu"], eager[1]["mu"])):
        for part in tree_g:
            for name, x in _named(tree_g[part]):
                if (part, name) != ("attn", "k/b"):
                    assert _max_diff([x], [_get(tree_e[part], name)]
                                     ) < 1e-4, (part, name)
    assert int(graphed[1]["step"]) == prog["src"].shape[0]

    g_state, g_aux = engine.make_eval_epoch(cfg)(
        eager[0], eager[2], vprog, tables, tcsr=vtcsr)
    e_state, e_aux = engine.scan_eval_stream(eager[0], eager[2], vprog,
                                             tables, cfg=cfg, tcsr=vtcsr)
    for key in ("pos_logit", "neg_logit"):
        assert g_aux[key].shape == vprog["src"].shape
        assert _max_diff([g_aux[key]], [e_aux[key]]) < 1e-4
    assert _max_diff([g_state["mem"]], [e_state["mem"]]) < 1e-4


def test_graphed_eval_collects_embeddings(cuda):
    """A scoring program built with ``collect_embeddings`` captures the
    step with its (steps, B, dim) embedding outputs and replays it: the
    same logits as without, and logits and embeddings as the eager pass
    gives them, with one launch of each forward kernel a step."""
    from repro_torch.tig import engine

    t = _tiny_epochs(cuda, "tgn")
    cfg, params, state, tables = t["cfg"], t["params"], t["state"], t["tables"]
    vprog, vtcsr = t["val"]
    steps, b = vprog["src"].shape
    plain = engine.make_eval_epoch(cfg)(params, state, vprog, tables,
                                        tcsr=vtcsr)[1]
    before = {n: KERNELS[n].launches for n in TIG_KERNELS}
    _, got = engine.make_eval_epoch(cfg, collect_embeddings=True)(
        params, state, vprog, tables, tcsr=vtcsr)
    torch.cuda.synchronize()
    assert {n: KERNELS[n].launches - before[n] for n in TIG_KERNELS} == {
        "neighbor_sample": steps, "fused_flush": steps,
        "temporal_attn": steps, "temporal_attn_bwd": 0, "fused_gru_bwd": 0}
    _, want = engine.scan_eval_stream(params, state, vprog, tables, cfg=cfg,
                                      collect_embeddings=True, tcsr=vtcsr)
    for key in ("src_embed", "dst_embed"):
        assert got[key].shape == (steps, b, cfg.dim)
        assert _max_diff([got[key]], [want[key]]) < 1e-4, key
    for key in ("pos_logit", "neg_logit"):
        assert torch.equal(got[key], plain[key]), key
        assert _max_diff([got[key]], [want[key]]) < 1e-4, key


def test_prefetch_during_capture_is_bitwise(cuda):
    """The prefetch worker plans the next epochs while the main thread
    captures the epoch programs' steps: captures do not fail, and losses,
    AP and params equal serial planning's bit for bit at depth 1 and 2,
    for ``train_single`` and for ``train_sharded`` from shards."""
    import tempfile

    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.stream import write_graph_shards
    from repro_torch.tig.train import train_sharded, train_single

    g = synthetic_tig("small")
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=32,
                    dim_node=32, num_neighbors=4, n_heads=2, batch_size=50)
    p0 = init_params(torch.Generator().manual_seed(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        sh = write_graph_shards(g, d, shard_edges=777)
        for run in (
                lambda **kw: train_single(g, cfg, epochs=3, params=p0, **kw),
                lambda **kw: train_sharded(sh, cfg, epochs=3, params=p0,
                                           protocol=True, patience=3,
                                           eval_node_class=True, **kw)):
            serial = run(prefetch=False)
            for depth in (1, 2):
                got = run(depth=depth)
                assert got.losses == serial.losses, depth
                for x, y in zip(_leaves_of(got.params),
                                _leaves_of(serial.params)):
                    assert torch.equal(x, y)
                for key in ("val_ap", "test_ap"):
                    if hasattr(serial, key):
                        assert getattr(got, key) == getattr(serial, key)
                for key, v in (getattr(serial, "metrics", None)
                               or {}).items():
                    assert got.metrics[key] == v or (
                        np.isnan(v) and np.isnan(got.metrics[key])), key


def test_train_sharded_on_card_matches_cpu(cuda):
    """``train_sharded`` from shards with the protocol and node
    classification, on the card against the CPU from the same params."""
    import tempfile

    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.stream import write_graph_shards
    from repro_torch.tig.train import train_sharded

    g = synthetic_tig("tiny")
    g.labels = (g.src % 2).astype(np.int64)
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, n_heads=2, batch_size=50)
    p0 = init_params(torch.Generator().manual_seed(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        sh = write_graph_shards(g, d, shard_edges=333)
        kw = dict(epochs=2, protocol=True, eval_node_class=True, params=p0)
        on_card = train_sharded(sh, cfg, **kw)
        on_cpu = train_sharded(sh, cfg, device="cpu", **kw)
    assert np.abs(np.subtract(on_card.losses, on_cpu.losses)).max() < 1e-4
    for key in ("val_ap", "test_ap", "node_auroc"):
        assert abs(on_card.metrics[key] - on_cpu.metrics[key]) < 1e-3, key


def _tiny_pac(parts):
    """SEP parts of ``synthetic_tig("tiny")``'s train split, a narrow
    config and the JAX package's initial-params seed."""
    from repro_torch.core import sep_partition
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.graph import chronological_split

    g = synthetic_tig("tiny")
    tr = chronological_split(g)[0]
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, n_heads=2, batch_size=50)
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, parts, k=0.05)
    return g, tr, part, cfg


@pytest.mark.parametrize("plan", ["device", "host"])
def test_graphed_pac_epoch_matches_eager(cuda, plan):
    """``make_pac_epoch`` (one captured PAC step, replayed) against
    ``scan_pac_epoch`` (the same step, eager) on the card, 4 SEP parts
    shuffle-combined onto 2 devices: losses (P, steps), params and the
    devices' states bitwise equal (the TGN step sums in a fixed order),
    a second graphed call of the same shapes replays the same graph
    bitwise, and each TIG kernel launches once a lockstep step."""
    from repro_torch.core import shuffle_combine
    from repro_torch.optim import adamw
    from repro_torch.tig import distributed as td

    g, tr, part, cfg = _tiny_pac(4)
    lists = shuffle_combine(part.node_lists(), 2, np.random.default_rng(0))
    ep = td.plan_epoch(tr, lists, part.shared_nodes, cfg,
                       np.random.default_rng(1), plan=plan)
    union = td.union_plan(ep, cfg)
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    params = init_params(torch.Generator().manual_seed(0), cfg, cuda)
    fn = td.make_pac_epoch(cfg, opt)
    outs = []
    for run in (lambda: td.scan_pac_epoch(params, opt.init(params), union,
                                          cfg=cfg, opt=opt),
                lambda: fn(params, opt.init(params), union),
                lambda: fn(params, opt.init(params), union)):
        for kern in KERNELS.values():
            kern.launches = 0
        outs.append(run())
        torch.cuda.synchronize()
        n = ep.steps
        want = {"neighbor_sample": n if plan == "device" else 0,
                "fused_flush": n, "temporal_attn": n,
                "temporal_attn_bwd": n, "fused_gru_bwd": n}
        assert {k: KERNELS[k].launches for k in want} == want
    eager, first, second = outs
    assert len(fn.graphs) == 1
    assert first[3].shape == (2, ep.steps)
    for got in (first, second):
        for x, y in zip(_leaves_of(got), _leaves_of(eager)):
            assert torch.equal(x, y)


def test_pac_train_on_card_matches_cpu(cuda):
    """``pac_train`` with 2 SEP parts on 2 devices, two epochs, on the
    card against the CPU (plain versions) from the same params."""
    from repro_torch.tig import distributed as td

    g, tr, part, cfg = _tiny_pac(2)
    p0 = init_params(torch.Generator().manual_seed(0), cfg)
    kw = dict(num_devices=2, epochs=2, eval_graph=g, params=p0)
    on_card = td.pac_train(tr, part, cfg, **kw)
    on_cpu = td.pac_train(tr, part, cfg, device="cpu", **kw)
    for a, b in zip(on_card.losses, on_cpu.losses):
        assert np.abs(a - b).max() < 1e-4
    for key in ("mem", "last"):
        assert _max_diff([on_card.memory_states[key]],
                         [on_cpu.memory_states[key]]) < 1e-4
    for key in ("val_ap", "test_ap"):
        assert abs(on_card.metrics[key] - on_cpu.metrics[key]) < 1e-3


@pytest.mark.parametrize("plan", ["device", "host"])
def test_pac_mesh_world_of_one_matches_no_mesh(cuda, plan, tmp_path):
    """An NCCL world of one rank in this process holding 2 partition
    slots: ``pac_train(mesh=...)`` (the sharded plan, the gradient
    all-reduce captured with the step, the sync's collectives) bitwise
    equal to ``mesh=None`` on ``tiny``, 4 SEP parts onto 2, two epochs."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_tig_mesh
    from repro_torch.tig import distributed as td

    g, tr, part, cfg = _tiny_pac(4)
    kw = dict(num_devices=2, epochs=2, eval_graph=g, plan=plan)
    alone = td.pac_train(tr, part, cfg, **kw)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        on_mesh = td.pac_train(tr, part, cfg, mesh=make_tig_mesh(2), **kw)
    finally:
        dist.destroy_process_group()
    assert on_mesh.plan.layout == "sharded"
    for a, b in zip(on_mesh.losses, alone.losses):
        assert np.array_equal(a, b)
    for a, b in zip(_leaves_of(on_mesh.params), _leaves_of(alone.params)):
        assert torch.equal(a, b)
    for k in alone.memory_states:
        assert torch.equal(on_mesh.memory_states[k], alone.memory_states[k])
    assert on_mesh.metrics.keys() == alone.metrics.keys()
    for k, v in alone.metrics.items():
        assert on_mesh.metrics[k] == v or (np.isnan(v) and np.isnan(
            on_mesh.metrics[k])), k


def _leaves_of(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves_of(t)]
    return [tree]


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _named(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _get(tree, name):
    for k in name.split("/"):
        tree = tree[k] if isinstance(tree, dict) else tree
    return tree


def test_graphed_epoch_reuses_its_graph(cuda):
    """A second call replays the graph the first captured (no new
    capture) from the same inputs, and gives the same result: TGN's step
    has no atomic sum, so bitwise."""
    from repro_torch.optim import adamw
    from repro_torch.tig import engine

    t = _tiny_epochs(cuda, "tgn")
    cfg, params, state, tables = t["cfg"], t["params"], t["state"], t["tables"]
    prog, tcsr = t["train"]
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    fn = engine.make_train_epoch(cfg, opt)
    first = fn(params, opt.init(params), state, prog, tables, tcsr=tcsr)
    (epoch,) = fn.graphs.values()
    graph = epoch.graph
    second = fn(params, opt.init(params), state, prog, tables, tcsr=tcsr)
    assert len(fn.graphs) == 1 and epoch.graph is graph
    assert torch.equal(first[3], second[3])
    for key in ("mem", "last", "pend_raw"):
        assert torch.equal(first[2][key], second[2][key]), key
    for (name, x), (_, y) in zip(_named(first[0]), _named(second[0])):
        assert torch.equal(x, y), name
    # another stream (the val program, its own T-CSR) gets its own graph
    ev = engine.make_eval_epoch(cfg)
    vprog, vtcsr = t["val"]
    ev(first[0], first[2], vprog, tables, tcsr=vtcsr)
    ev(first[0], first[2], prog, tables, tcsr=tcsr)
    assert len(ev.graphs) >= 2


def test_graphed_launch_counts_add_up_per_replay(cuda):
    """The host counts a captured launch once; the program adds the
    capture's launches once a replay, so the counts are the launches on
    the device: one of each TIG kernel a train step, the backward ones
    only in training."""
    from repro_torch.optim import adamw
    from repro_torch.tig import engine

    t = _tiny_epochs(cuda, "tgn")
    cfg, params, state, tables = t["cfg"], t["params"], t["state"], t["tables"]
    (prog, tcsr), (vprog, vtcsr) = t["train"], t["val"]
    steps, vsteps = prog["src"].shape[0], vprog["src"].shape[0]
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    fn = engine.make_train_epoch(cfg, opt)
    before = {n: KERNELS[n].launches for n in TIG_KERNELS}
    for call in (1, 2):
        out = fn(params, opt.init(params), state, prog, tables, tcsr=tcsr)
        torch.cuda.synchronize()
        for n in TIG_KERNELS:
            assert KERNELS[n].launches - before[n] == call * steps, n
    (epoch,) = fn.graphs.values()
    assert all(epoch.per_replay[n] == 1 for n in TIG_KERNELS)
    before = {n: KERNELS[n].launches for n in TIG_KERNELS}
    engine.make_eval_epoch(cfg)(out[0], out[2], vprog, tables, tcsr=vtcsr)
    for n in TIG_KERNELS:
        want = 0 if n in ("temporal_attn_bwd", "fused_gru_bwd") else vsteps
        assert KERNELS[n].launches - before[n] == want, n


def _wkv_args(dev, b, h, s, with_state, dtype, strong=False, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = (randn(b, s, h, 64).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, s, h, 64) * 0.5
                             + (1.5 if strong else -2.0)))
    u = randn(h, 64) * 0.5
    return (r, k, v, w, u), randn(b, h, 64, 64) if with_state else None


def _assert_wkv_close(got, want):
    """1e-5 of the largest |plain| (plus one bf16 unit for a bf16 o)."""
    (got_o, got_s), (want_o, want_s) = got, want
    scale = float(want_o.float().abs().max())
    assert torch.isfinite(got_o.float()).all()
    assert torch.allclose(got_o.float(), want_o.float(), rtol=(
        2 ** -7 if got_o.dtype == torch.bfloat16 else 0.0),
        atol=1e-5 * scale)
    assert torch.allclose(got_s, want_s, rtol=0.0,
                          atol=1e-5 * float(want_s.abs().max()))


def _wkv_plain(fn, args, state):
    r, k, v, w, u = args
    o, st = fn(*(x.transpose(1, 2) for x in (r, k, v, w)), u, state=state,
               return_state=True)
    return o.transpose(1, 2), st


@pytest.mark.parametrize("s,with_state,dtype", [
    (1, True, torch.float32), (1, True, torch.bfloat16),
    (100, True, torch.bfloat16), (256, False, torch.bfloat16),
    (256, True, torch.float32), (64, True, torch.bfloat16),
    (64, False, torch.float32), (65, True, torch.bfloat16),
    (65, True, torch.float32)])
def test_rwkv6_kernel_matches_plain(cuda, s, with_state, dtype):
    """Through ``ops.rwkv6``: the chunked kernel for S >= 64, the
    sequential one below, one launch."""
    args, state = _wkv_args(cuda, 2, 3, s, with_state, dtype)
    name = "rwkv6" if s >= 64 else "rwkv6_seq"
    before = {n: KERNELS[n].launches for n in ("rwkv6", "rwkv6_seq")}
    got = ops.rwkv6(*args, state=state)
    assert {n: KERNELS[n].launches - before[n] for n in before} == {
        n: int(n == name) for n in before}
    want = _wkv_plain(ref.rwkv6_chunked_ref, args, state)
    assert got[0].dtype == want[0].dtype
    _assert_wkv_close(got, want)


@pytest.mark.parametrize("s", [1, 7, 63, 64, 100, 200])
@pytest.mark.parametrize("kernel", ["chunked", "seq"])
def test_rwkv6_both_kernels_take_any_s(cuda, kernel, s):
    """Each kernel is right at every S, whichever ``ops.rwkv6`` picks."""
    from repro_torch.kernels.rwkv6_scan import (rwkv6_chunked_fwd,
                                                rwkv6_seq_fwd)

    fn = rwkv6_chunked_fwd if kernel == "chunked" else rwkv6_seq_fwd
    args, state = _wkv_args(cuda, 2, 3, s, True, torch.bfloat16, seed=s)
    _assert_wkv_close(fn(*args, state),
                      _wkv_plain(ref.rwkv6_ref, args, state))


@pytest.mark.parametrize("s,dtype", [(320, torch.bfloat16),
                                     (330, torch.float32)])
def test_rwkv6_kernel_at_strong_decays(cuda, s, dtype):
    """|log w| * 64 far above 80: the chunked kernel stays within the
    check's bound of the token scan."""
    args, state = _wkv_args(cuda, 2, 3, s, True, dtype, strong=True)
    assert float((-torch.log(args[3])).median()) * 64 > 200
    _assert_wkv_close(ops.rwkv6(*args, state=state),
                      _wkv_plain(ref.rwkv6_ref, args, state))


def test_rwkv6_chunked_kernel_is_deterministic(cuda):
    args, state = _wkv_args(cuda, 2, 4, 640, True, torch.bfloat16)
    a, b = ops.rwkv6(*args, state=state), ops.rwkv6(*args, state=state)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _reduced_lm_on_card_matches_cpu(cuda, arch, kernel, prompt, gen):
    """A REDUCED LM in float32: ``forward`` logits to 1e-4 (``kernel``
    against its plain version, float32 sums in another order, one launch
    per layer), then ``gen`` greedy tokens after ``prompt`` prompt tokens
    identical."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.models.serve import generate
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    p_cpu = model.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    p_gpu = tree_map(lambda x: x.to(cuda), p_cpu)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 128)))
    before = KERNELS[kernel].launches
    on_card = model.forward(p_gpu, {"tokens": tokens}, cfg)
    assert KERNELS[kernel].launches == before + cfg.n_layers
    on_cpu = model.forward(p_cpu, {"tokens": tokens}, cfg, device="cpu")
    assert float((on_card.cpu() - on_cpu).abs().max()) < 1e-4
    a = generate(p_gpu, cfg, tokens[:, :prompt], gen)
    c = generate(p_cpu, cfg, tokens[:, :prompt], gen, device="cpu")
    np.testing.assert_array_equal(a.tokens, c.tokens)


def test_rwkv_generate_on_card_matches_cpu(cuda):
    _reduced_lm_on_card_matches_cpu(cuda, "rwkv6-1.6b", "rwkv6", 4, 8)


def _within(got, want, rel=1e-5):
    """|got - want| <= rel * max(1, max |want|), elementwise."""
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) <= rel * scale


@pytest.mark.parametrize("rows,d_in,d_h", [(400, 616, 172), (512, 176, 128),
                                           (37, 24, 16), (53, 37, 13),
                                           (1, 616, 172)])
def test_gru_kernels_match_plain(cuda, rows, d_in, d_h):
    """TGN's updater shape, the backward benchmark's shape, row counts
    that are not a multiple of the 32-row tile, row strides that are not a
    multiple of 16 bytes with d_h under 16, and one row."""
    gen = torch.Generator(device=cuda).manual_seed(4)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    args = [randn(rows, d_in), randn(rows, d_h),
            randn(d_in, 3 * d_h, scale=d_in ** -0.5),
            randn(d_h, 3 * d_h, scale=d_h ** -0.5), randn(3 * d_h, scale=0.1),
            randn(3 * d_h, scale=0.1)]
    g = randn(rows, d_h)
    before = (KERNELS["fused_gru"].launches,
              KERNELS["fused_gru_bwd"].launches)
    xs = [a.clone().requires_grad_() for a in args]
    out = ops.gru(*xs)
    grads = torch.autograd.grad(out, xs, g)
    assert (KERNELS["fused_gru"].launches,
            KERNELS["fused_gru_bwd"].launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert float((out - ref.gru_ref(*args)).abs().max()) < 1e-5
    for got, want in zip(grads, ref.gru_bwd_ref(g, *args)):
        assert got.shape == want.shape and _within(got, want)


def _plain_attention(q, k, v, causal, window):
    """The plain version on the CPU in float32, before its output cast,
    and |P| |V|, its weights applied to |v|; both (B, S, H, D)."""
    group = q.shape[2] // k.shape[2]
    q, k, v = (x.float().cpu().transpose(1, 2) for x in (q, k, v))
    k, v = (x.repeat_interleave(group, dim=1) for x in (k, v))
    att = ref.flash_attention_probs(q, k, causal=causal, window=window)
    return (att @ v).transpose(1, 2), (att @ v.abs()).transpose(1, 2)


@pytest.mark.parametrize("dtype,b,s,h,hkv,d,causal,window", [
    (torch.bfloat16, 1, 200, 4, 2, 128, True, 64),
    (torch.bfloat16, 2, 333, 6, 2, 128, True, None),
    (torch.bfloat16, 1, 130, 4, 1, 32, False, None),
    (torch.bfloat16, 1, 257, 8, 2, 32, True, 100),
    (torch.bfloat16, 1, 200, 4, 4, 128, False, 50),
    (torch.bfloat16, 1, 1, 4, 2, 128, True, None),
    (torch.bfloat16, 1, 17, 4, 2, 32, True, None),
    (torch.bfloat16, 1, 300, 24, 2, 128, True, 128),
    (torch.bfloat16, 1, 300, 4, 2, 128, True, 1),
    (torch.float32, 2, 77, 4, 2, 32, False, None),
    (torch.float32, 1, 77, 8, 2, 32, True, 16),
    (torch.float32, 1, 100, 4, 2, 21, True, 30),
    (torch.float32, 1, 150, 4, 2, 128, True, None)])
def test_flash_kernel_matches_plain(cuda, dtype, b, s, h, hkv, d, causal,
                                    window):
    """GQA (heads paired in a block, or not where a KV group is odd),
    sliding windows down to 1, causal and not, S within one tile and not a
    multiple of the tiles, in bfloat16; float32 at D 32, 128 and 21 (rows
    not a multiple of 16 bytes). Two calls agree bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    before = KERNELS["flash_attention"].launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert KERNELS["flash_attention"].launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal,
                                                window=window))
    want, scale = _plain_attention(q, k, v, causal, window)
    diff = (got.float().cpu() - want).abs()
    if dtype == torch.float32:
        assert float(diff.max()) < 1e-5
    else:
        # one rounding of the output, and float32 sums with P kept to
        # 2^-17 (hi + lo bf16 parts) against |P| |V|
        bound = 2 ** -8 * want.abs() + 2 ** -14 * scale
        assert bool((diff <= bound).all()), float((diff / bound).max())


def test_gru_and_flash_wrappers_reject_bad_arguments(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_gru import fused_gru_fwd

    x, h = torch.zeros((4, 6), device=cuda), torch.zeros((4, 3), device=cuda)
    wx, wh = torch.zeros((6, 9), device=cuda), torch.zeros((3, 9), device=cuda)
    bx = torch.zeros(9, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        fused_gru_fwd(x.cpu(), h, wx, wh, bx, bx)
    with pytest.raises(TypeError):
        fused_gru_fwd(x.double(), h, wx, wh, bx, bx)
    with pytest.raises(ValueError):
        fused_gru_fwd(x, h, wx[:5], wh, bx, bx)
    with pytest.raises(ValueError, match="contiguous"):
        fused_gru_fwd(x, h, torch.zeros((9, 6), device=cuda).t(), wh, bx, bx)

    q = torch.zeros((1, 8, 4, 32), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q.cpu(), kv.cpu(), kv.cpu())
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(q[..., :16].contiguous(),
                            kv[..., :16].contiguous(),
                            kv[..., :16].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, kv, torch.zeros(
            (1, 2, 8, 32), dtype=torch.bfloat16, device=cuda).transpose(1, 2))
    with pytest.raises(ValueError, match="split"):
        flash_attention_fwd(torch.zeros((1, 8, 3, 32), dtype=torch.bfloat16,
                                        device=cuda), kv, kv)


def test_starcoder2_on_card_matches_cpu(cuda):
    """56 prompt tokens and 16 generated: the ring buffer of the REDUCED
    window of 64 wraps."""
    _reduced_lm_on_card_matches_cpu(cuda, "starcoder2-3b", "flash_attention",
                                    56, 16)
