"""The port's roofline (``repro_torch.roofline``) against the JAX
package's: the byte and bubble models, ``MODEL_FLOPS`` and the configs'
parameter counts equal; the step cost counter (``OpCost``) against the
JAX cost walker (``repro.roofline.hlo_cost.analyze_hlo_text``) on the
jitted JAX counterpart of each program; each kernel scope's formula
against the walker's count of its JAX function alone; the CPU's count
equal to the ``meta`` device's; and the meta route of the kernel entry
points.

Tolerances: the models and counts are integers, so equal; FLOPs within
1e-6 relative of the walker's on GEMM-only programs and each kernel's
JAX function, 2% on the REDUCED TGN, StarCoder2 and RWKV6 training steps
(they read 0 here); the CPU's bytes within 1% of ``meta``'s.
"""

import contextlib
import dataclasses
import math
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import kernel_bytes as jkb  # noqa: E402
from repro.roofline import pipeline_bubble as jpb  # noqa: E402
from repro.roofline.hlo_cost import analyze_hlo_text  # noqa: E402
from repro.tig import batching as jbatching  # noqa: E402
from repro.tig import models as jtm  # noqa: E402
from repro.tig import train as jtrain  # noqa: E402
from repro.tig.data import synthetic_tig  # noqa: E402
from repro.tig.protocol import split_views  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.kernels import meta, ops  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.roofline import analysis, kernel_bytes as tkb  # noqa: E402
from repro_torch.roofline import pipeline_bubble as tpb  # noqa: E402
from repro_torch.roofline.op_cost import OpCost  # noqa: E402
from repro_torch.tig import models as ttm  # noqa: E402
from repro_torch.tig import train as ttrain  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TIG_SMALL = dict(dim=16, dim_time=8, dim_edge=16, dim_node=16,
                 num_neighbors=4, n_heads=2, batch_size=50)
LM_BATCH = (2, 128)            # the REDUCED LM steps' (B, S)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tests: the suite runs in
    several worker processes at once, and a torch that takes every core
    in each of them makes the workers contend for the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(x):
    """An OpBytes (or a dict / list holding them) as plain data."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x) | {"total": x.total}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _walker(fn, *args) -> float:
    return analyze_hlo_text(jax.jit(fn).lower(*args).compile().as_text()
                            ).flops


def _rel(got, want) -> float:
    return abs(got - want) / max(abs(want), 1.0)


# ------------------------------------------------- byte and bubble models

GRID = {
    "gru_bytes": [((b, di, dh), kw) for b in (1, 200, 600)
                  for di, dh in ((172, 172), (616, 172), (100, 33))
                  for kw in ({}, {"direction": "bwd"}, {"fused": False},
                             {"direction": "bwd", "fused": False})],
    "attn_bytes": [((b, k, h, d), kw) for b in (600, 3)
                   for k, h, d in ((10, 2, 86), (1, 1, 128), (7, 3, 5))
                   for kw in ({}, {"direction": "bwd"}, {"fused": False},
                              {"direction": "bwd", "fused": False})],
    "flush_bytes": [((n, rows, dm, dmem), kw) for n in (100, 10_000)
                    for rows, dm, dmem in ((400, 616, 172), (8, 33, 16))
                    for kw in ({}, {"direction": "bwd"},
                               {"fused": False},
                               {"direction": "bwd", "fused": False})],
    "step_pipeline_bytes": [((n, b, dm, dmem, k, h), kw)
                            for n, b, dm, dmem, k, h in (
                                (10_000, 200, 616, 172, 10, 2),
                                (50, 7, 33, 16, 3, 1))
                            for kw in ({}, {"n_layers": 2})],
}


@pytest.mark.parametrize("name", sorted(GRID))
@pytest.mark.parametrize("lanes", [False, True])
def test_kernel_byte_models_equal_jax(name, lanes):
    for args, kw in GRID[name]:
        got = getattr(tkb, name)(*args, lanes=lanes, **kw)
        want = getattr(jkb, name)(*args, lanes=lanes, **kw)
        assert _plain(got) == _plain(want), (name, args, kw)


def test_sampling_staging_sync_and_padding_models_equal_jax():
    for rows, k, total in ((600, 10, 150_000), (3, 1, 1), (2_400, 64, 7)):
        assert _plain(tkb.sample_bytes(rows, k, total)) == _plain(
            jkb.sample_bytes(rows, k, total))
    for args in ((525, 200, 10, 10_000, 300_000), (1, 3, 1, 5, 9)):
        assert _plain(tkb.epoch_plan_bytes(*args)) == _plain(
            jkb.epoch_plan_bytes(*args))
    for mode in ("latest", "mean"):
        for s, d, n, hosts in ((48_895, 172, 256, 1), (242, 172, 4, 2),
                               (7, 3, 1, 1), (100, 16, 8, 4)):
            assert tkb.pac_sync_bytes(s, d, n, hosts, mode=mode) == \
                jkb.pac_sync_bytes(s, d, n, hosts, mode=mode)
    for rows, events, row_b, hosts in (([3, 5, 2, 7], [40, 9, 17, 3], 21, 1),
                                       ([3, 5, 2, 7], [40, 9, 17, 3], 21, 2),
                                       ([1], [1], 4, 1)):
        assert tkb.pac_staging_bytes(rows, events, row_b, n_hosts=hosts) \
            == jkb.pac_staging_bytes(rows, events, row_b, n_hosts=hosts)
    for n in (0, 1, 7, 8, 127, 128, 129, 1000):
        assert tkb.lane_pad(n) == jkb.lane_pad(n)
        assert tkb.sublane_pad(n) == jkb.sublane_pad(n)
    with pytest.raises(AssertionError):
        tkb.pac_sync_bytes(1, 1, 2, mode="max")


def test_pipeline_bubble_equals_jax():
    for kw in ({"sync_bytes": 1e6, "staging_bytes": 3e7, "plan_s": 0.2},
               {"sync_bytes": 0.0, "staging_bytes": 0.0, "plan_s": 0.0,
                "dcn_gbps": 25.0, "h2d_gbps": 50.0}):
        assert tpb.boundary_component_seconds(**kw) == \
            jpb.boundary_component_seconds(**kw)
    for kw in ({"plan_s": 0.3, "stage_s": 0.1, "sync_s": 0.05,
                "fetch_s": 0.01, "scan_s": 0.2, "epochs": 5,
                "dispatch_s": 0.002},
               {"plan_s": 0.0, "stage_s": 0.0, "sync_s": 0.0, "fetch_s": 0.0,
                "scan_s": 1.0, "epochs": 1}):
        assert tpb.pipeline_bubble(**kw) == jpb.pipeline_bubble(**kw)
    for bad in ({"epochs": 0}, {"scan_s": -1.0}):
        kw = {"plan_s": 0.1, "stage_s": 0.1, "sync_s": 0.1, "fetch_s": 0.1,
              "scan_s": 0.1, "epochs": 2} | bad
        for mod in (tpb, jpb):
            with pytest.raises(ValueError):
                mod.pipeline_bubble(**kw)
    for mod in (tpb, jpb):
        with pytest.raises(ValueError):
            mod.boundary_component_seconds(sync_bytes=1, staging_bytes=1,
                                           plan_s=0, dcn_gbps=0)


def test_model_flops_equals_jax():
    for n, tokens in ((3_180_331_008, 8192), (1, 1), (7, 1_048_576)):
        for kind in ("train", "infer", "prefill"):
            assert analysis.MODEL_FLOPS(n, tokens, kind) == \
                janalysis.MODEL_FLOPS(n, tokens, kind)


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal_jax(arch):
    for reduced in (False, True):
        t, j = get_config(arch, reduced), jget_config(arch, reduced)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert (t.attention_free, t.sub_quadratic) == (j.attention_free,
                                                       j.sub_quadratic)


def test_report_terms_use_the_h100_peaks():
    """``analyze_step`` on a bf16 and a float32 product: the compute term
    at 989 / 67 TFLOP/s, bytes at 3.35 TB/s, the JAX report's fields."""
    a = torch.ones(64, 32, dtype=torch.bfloat16)
    b = torch.ones(32, 16, dtype=torch.bfloat16)
    r = analysis.analyze_step(torch.mm, a, b, arch="x", shape="y",
                              model_flops=2 * 64 * 32 * 16)
    assert r.hlo_flops == 2 * 64 * 32 * 16 and r.useful_ratio == 1.0
    assert r.hlo_bytes == 2 * (64 * 32 + 32 * 16 + 64 * 16)
    assert math.isclose(r.compute_s, r.hlo_flops / 989e12)
    assert math.isclose(r.memory_s, r.hlo_bytes / 3.35e12)
    assert r.dominant == "memory" and r.mesh == "h100x1" and r.chips == 1
    assert set(r.to_json()) == {f.name for f in dataclasses.fields(
        janalysis.RooflineReport)}
    r32 = analysis.analyze_step(torch.mm, a.float(), b.float(), arch="x",
                                shape="y", model_flops=0.0, dtype="float32")
    assert math.isclose(r32.compute_s, r.hlo_flops / 67e12)


# -------------------------------------------------- the counter vs walker

def test_counter_equals_walker_on_a_linear_stack():
    rng = np.random.default_rng(0)
    ws = [rng.standard_normal(s).astype(np.float32)
          for s in ((48, 64), (64, 64), (64, 10))]
    x = rng.standard_normal((33, 48)).astype(np.float32)

    def jf(x, *ws):
        for w in ws[:-1]:
            x = jax.nn.relu(x @ w)
        return x @ ws[-1]

    def tf(x, *ws):
        for w in ws[:-1]:
            x = torch.relu(x @ w)
        return x @ ws[-1]

    with OpCost() as cost:
        tf(torch.from_numpy(x), *map(torch.from_numpy, ws))
    want = _walker(jf, x, *ws)
    assert want == 2 * 33 * (48 * 64 + 64 * 64 + 64 * 10)
    assert _rel(cost.flops, want) <= 1e-6


def _count(fn, args, grad_of=()):
    ts = [torch.from_numpy(np.array(a)).requires_grad_(i in grad_of)
          for i, a in enumerate(args)]
    with OpCost() as cost:
        out = fn(*ts)
        if grad_of:
            torch.autograd.grad(out.sum(), [ts[i] for i in grad_of])
    return cost


def _walker_vg(fn, args, grad_of):
    if not grad_of:
        return _walker(fn, *args)
    return _walker(jax.value_and_grad(lambda *a: jnp.sum(fn(*a)),
                                      argnums=grad_of), *args)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _kernel_cases():
    """(name, JAX function, port entry point, args, the args to
    differentiate): each kernel's JAX counterpart as the walker sees
    it."""
    rng = np.random.default_rng(1)
    r = lambda *s: _rand(rng, *s)    # noqa: E731
    cases = [("gru", jref.gru_ref, ops.gru,
              [r(37, 24), r(37, 16), r(24, 48), r(16, 48), r(48), r(48)],
              (0, 1, 2, 3, 4, 5))]
    mask = rng.random((30, 5)) > 0.3
    cases.append(("temporal_attention", jref.temporal_attention_ref,
                  ops.temporal_attention,
                  [r(30, 2, 8), r(30, 5, 2, 8), r(30, 5, 2, 8), mask],
                  (0, 1, 2)))
    n, rows = 50, 40
    ids = rng.integers(0, n + 1, rows).astype(np.int32)

    def jflush(ids, msg, ts, mem, last, *w):
        return jref.flush_ref(ids, msg, ts, mem, last, *w)[0]

    def tflush(ids, msg, ts, mem, last, *w):
        return ops.fused_flush(ids, msg, ts, mem, last, *w)[0]

    cases.append(("fused_flush", jflush, tflush,
                  [ids, r(rows, 12), np.abs(r(rows)), r(n + 1, 8),
                   np.zeros(n + 1, np.float32), r(12, 24), r(8, 24), r(24),
                   r(24)], (1, 5, 6, 7, 8)))
    for s, window, causal in ((1024, 256, True), (512, None, True),
                              (1024, None, False)):
        cases.append((
            f"flash_attention S{s} window {window} causal {causal}",
            lambda q, k, v, c=causal, w=window: jlayers.chunked_attention(
                q, k, v, causal=c, window=w),
            lambda q, k, v, c=causal, w=window: ops.flash_attention(
                q, k, v, causal=c, window=w),
            [r(2, s, 4, 16), r(2, s, 2, 16), r(2, s, 2, 16)], (0, 1, 2)))
    for s in (128, 100):             # the chunked form; the token scan
        w = np.exp(-np.exp(0.1 * r(2, 2, s, 16) - 2)).astype(np.float32)
        cases.append((
            f"rwkv6 S{s}", jref.rwkv6_chunked_xla,
            lambda *a: ops.rwkv6(*(x.transpose(1, 2) for x in a[:4]), a[4],
                                 return_state=False),
            [r(2, 2, s, 16), r(2, 2, s, 16), r(2, 2, s, 16), w, r(2, 16)],
            (0, 1, 2, 3, 4)))
    return cases


KERNEL_CASES = _kernel_cases()


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in
                                                    KERNEL_CASES])
@pytest.mark.parametrize("grad", [False, True])
def test_kernel_formula_equals_walker_of_its_jax_function(case, grad):
    """A kernel's scope counts, forward and with its gradient, what the
    walker counts for its JAX function at the same shapes; the scope is
    the only FLOP-bearing op of the port's count."""
    name, jf, tf, args, grad_of = case
    grad_of = grad_of if grad else ()
    cost = _count(tf, args, grad_of)
    want = _walker_vg(jf, args, grad_of)
    assert _rel(cost.flops, want) <= 1e-6, (name, cost.flops, want,
                                            cost.kernels)
    scopes = sum(v[1] for v in cost.kernels.values())
    assert scopes == cost.flops
    assert set(cost.kernels) == ({name.split()[0], f"{name.split()[0]} "
                                  f"backward"} if grad else
                                 {name.split()[0]})


def test_sampling_counts_no_flops_and_its_operands():
    from repro_torch.kernels import ref as tref

    idx = np.repeat(np.arange(6), 3)
    ts = np.arange(18, dtype=np.float32)
    tcsr = {"indptr": torch.tensor([4 + 3 * i for i in range(7)],
                                   dtype=torch.int32),
            "nbr": torch.cat([torch.zeros(4, dtype=torch.int32),
                              torch.from_numpy(idx[::-1].copy()).int()]),
            "t": torch.cat([torch.zeros(4), torch.from_numpy(ts)]),
            "eidx": torch.arange(22, dtype=torch.int32),
            "bat": torch.cat([torch.zeros(4, dtype=torch.int32),
                              torch.ones(18, dtype=torch.int32)])}
    nodes = torch.tensor([0, 3, 5], dtype=torch.int32)
    with OpCost() as cost:
        got = ops.neighbor_sample(tcsr, nodes, 2, 4)
    want = tref.sample_ref(tcsr["indptr"], tcsr["nbr"], tcsr["t"],
                           tcsr["eidx"], tcsr["bat"], nodes, 2, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cost.flops == 0 and list(cost.by_op) == []
    assert cost.kernels["neighbor_sample"][2] == meta.nbytes(
        list(tcsr.values()) + [nodes] + list(want))


def test_mamba_scan_formula_equals_walker_in_mamba_apply():
    """The selective scan's formula inside mamba's layer (its JAX scan
    body has no function of its own): the port's ``mamba_apply`` counted
    against the walker's ``mamba_apply``, at S 128 (the JAX package's
    chunked, checkpointed scan) and S 40, with and without gradients."""
    cfg = jget_config("hymba-1.5b", reduced=True)
    jp = jax.tree.map(lambda x: np.asarray(x[0]), jmodel.init_params(
        jax.random.PRNGKey(0), cfg)["layers"]["ssm"])
    rng = np.random.default_rng(2)
    for s in (128, 40):
        x = _rand(rng, 2, s, cfg.d_model)
        for grad in (False, True):
            def jf(p, x):
                return jssm.mamba_apply(p, x, state=cfg.ssm_state)
            want = _walker(jax.value_and_grad(
                lambda p, x: jnp.sum(jf(p, x)), argnums=(0, 1))
                if grad else jf, jp, x)
            tp = tree_map(lambda a: a.requires_grad_(grad),
                          convert.params_from_numpy(jp))
            tx = torch.from_numpy(x).requires_grad_(grad)
            with OpCost() as cost:
                y = tssm.mamba_apply(tp, tx, state=cfg.ssm_state)
                if grad:
                    torch.autograd.grad(y.sum(), tree_leaves(tp) + [tx])
            assert _rel(cost.flops, want) <= 1e-6, (s, grad, cost.flops,
                                                    want)
            assert "selective_scan" in cost.kernels


# ------------------------------------------------------ REDUCED steps

def _lm_walker(arch: str) -> float:
    cfg = jget_config(arch, reduced=True)
    params = jmodel.init_params(jax.random.PRNGKey(0), cfg)
    opt = joptim.adamw(lr=1e-3)
    tok = jnp.zeros(LM_BATCH, jnp.int32)
    step = jax.jit(jmodel.make_train_step(cfg, opt))
    return analyze_hlo_text(step.lower(
        params, opt.init(params), {"tokens": tok, "targets": tok}
    ).compile().as_text()).flops


def _lm_count(arch: str, device: str, gen_seed: int = 0) -> tuple:
    cfg = get_config(arch, reduced=True)
    params = tmodel.init_params(torch.Generator().manual_seed(gen_seed),
                                cfg, device=device)
    opt = toptim.adamw(lr=1e-3)
    state = opt.init(params)
    tok = torch.randint(0, cfg.vocab, LM_BATCH,
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok.to(device), "targets": tok.to(device)}
    with OpCost() as cost:
        tmodel.make_train_step(cfg, opt, device=device)(params, state, batch)
    return cost, params


def _tig_inputs():
    g = synthetic_tig("tiny")
    splits = split_views(g)
    cfg = jtm.TIGConfig(**TIG_SMALL)
    batches = jbatching.build_batches(splits.train, cfg,
                                      np.random.default_rng(5),
                                      neg_pool=splits.neg_pool)
    batch = {k: v for k, v in batches[1].items() if k != "labels"}
    tables = jbatching.make_tables(g.edge_feat, g.node_feat)
    jp = jax.tree.map(np.asarray, jtm.init_params(jax.random.PRNGKey(2),
                                                  cfg))
    return g, batch, tables, jp


def _tig_walker() -> float:
    g, batch, tables, jp = _tig_inputs()
    cfg = jtm.TIGConfig(**TIG_SMALL)
    opt = joptim.adamw(1e-3)
    step = jax.jit(jtrain.make_train_step(cfg, opt))
    return analyze_hlo_text(step.lower(
        jp, opt.init(jp), jtm.init_state(cfg, g.num_nodes),
        {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in tables.items()}
    ).compile().as_text()).flops


def _tig_count(device: str):
    g, batch, tables, jp = _tig_inputs()
    cfg = ttm.TIGConfig(**TIG_SMALL)
    params = tree_map(lambda x: x.to(device), convert.params_from_numpy(jp))
    opt = toptim.adamw(1e-3)
    args = (params, opt.init(params), ttm.init_state(cfg, g.num_nodes,
                                                     device),
            {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in batch.items()},
            {k: torch.from_numpy(v).to(device) for k, v in tables.items()})
    with OpCost() as cost:
        out = ttrain.make_train_step(cfg, opt)(*args)
    return cost, out


STEPS = ("tgn", "starcoder2-3b", "rwkv6-1.6b", "hymba-1.5b")


@pytest.fixture(scope="module")
def walker_counts():
    """The walker's count of each REDUCED JAX step, jitted once."""
    return {"tgn": _tig_walker(),
            **{arch: _lm_walker(arch) for arch in STEPS[1:]}}


def _port_count(name: str, device: str):
    return _tig_count(device)[0] if name == "tgn" else \
        _lm_count(name, device)[0]


@pytest.mark.parametrize("name", STEPS)
def test_reduced_step_counts_agree_with_the_walker(name, walker_counts):
    cost = _port_count(name, "cpu")
    assert _rel(cost.flops, walker_counts[name]) <= 0.02, (
        cost.flops, walker_counts[name], cost.kernels)


def _differing_ops(a: OpCost, b: OpCost) -> dict:
    return {k: (a.by_op.get(k), b.by_op.get(k))
            for k in sorted(set(a.by_op) | set(b.by_op))
            if a.by_op.get(k) != b.by_op.get(k)}


@pytest.mark.parametrize("name", STEPS)
def test_reduced_step_counts_the_same_on_cpu_and_meta(name):
    cpu, on_meta = _port_count(name, "cpu"), _port_count(name, "meta")
    diff = _differing_ops(cpu, on_meta)
    assert cpu.flops == on_meta.flops, diff
    assert _rel(cpu.bytes, on_meta.bytes) <= 0.01, diff
    assert cpu.kernels == on_meta.kernels, diff


def test_counting_changes_no_result():
    """A step counted (its kernels run as scopes) and one not: the REDUCED
    StarCoder2 step's params bitwise; the TGN step's loss and state
    bitwise, its params to 1e-9 under SGD. Counting moves where autograd
    sums the attention's key gradients, and the key bias's gradient, zero
    in exact arithmetic (the softmax ignores a constant added to every
    score), is rounding noise (~1e-11) that comes out another way."""
    counted = _lm_count("starcoder2-3b", "cpu")[1]
    cfg = get_config("starcoder2-3b", reduced=True)
    plain = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    opt = toptim.adamw(lr=1e-3)
    tok = torch.randint(0, cfg.vocab, LM_BATCH,
                        generator=torch.Generator().manual_seed(1))
    tmodel.make_train_step(cfg, opt, device="cpu")(
        plain, opt.init(plain), {"tokens": tok, "targets": tok})
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(counted),
                                                 tree_leaves(plain)))
    g, batch, tables, jp = _tig_inputs()
    tcfg = ttm.TIGConfig(**TIG_SMALL)
    sgd = toptim.sgd(1e-3)
    runs = []
    for count in (True, False):
        params = convert.params_from_numpy(jp)
        args = (params, sgd.init(params),
                ttm.init_state(tcfg, g.num_nodes, "cpu"), batch, tables)
        with OpCost() if count else contextlib.nullcontext():
            runs.append(ttrain.make_train_step(tcfg, sgd)(*args))
    (p1, _, s1, l1), (p2, _, s2, l2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(p1), tree_leaves(p2))) <= 1e-9


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_collectives_counted_by_kind_over_a_gloo_world_of_one():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        x = torch.ones(1000)
        with OpCost() as cost:
            dist.all_reduce(x)
            dist.all_gather([torch.empty(1000)], x)
        assert cost.collective_counts["all-reduce"] == 1
        assert cost.collective_counts["all-gather"] == 1
        assert cost.collective_bytes_by_kind["all-reduce"] == 2 * 4000
        assert cost.collective_bytes_by_kind["all-gather"] == 4000
        assert cost.collective_bytes == 3 * 4000 and cost.flops == 0
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------- the meta route

def test_meta_tensors_take_the_meta_route():
    """On ``meta`` every entry point returns its kernel's shapes and
    dtypes, and a gradient flows back as empty meta tensors."""
    def m(*shape, dtype=torch.float32, grad=False):
        return torch.empty(shape, dtype=dtype, device="meta"
                           ).requires_grad_(grad)

    x, h = m(5, 7, grad=True), m(5, 4, grad=True)
    out = ops.gru(x, h, m(7, 12), m(4, 12), m(12), m(12))
    assert out.device.type == "meta" and out.shape == (5, 4)
    dx, = torch.autograd.grad(out.sum(), [x])
    assert dx.device.type == "meta" and dx.shape == x.shape
    q = m(2, 64, 4, 16, dtype=torch.bfloat16)
    o = ops.flash_attention(q, m(2, 64, 2, 16, dtype=torch.bfloat16),
                            m(2, 64, 2, 16, dtype=torch.bfloat16), window=8)
    assert (o.shape, o.dtype) == (q.shape, torch.bfloat16)
    r = m(2, 128, 2, 64, dtype=torch.bfloat16)
    o, st = ops.rwkv6(r, r, r, m(2, 128, 2, 64), m(2, 64))
    assert (o.dtype, st.shape) == (torch.bfloat16, (2, 2, 64, 64))
    assert ops.rwkv6(r[:, :100], r[:, :100], r[:, :100], m(2, 100, 2, 64),
                     m(2, 64))[0].dtype == torch.float32
    y, hs = ops.selective_scan(m(2, 9, 6), m(2, 9, 6), m(2, 9, 3),
                               m(2, 9, 3), m(6, 3))
    assert (y.shape, hs.shape) == ((2, 9, 6), (2, 6, 3))
    ids = m(4, dtype=torch.int32)
    mem, last, mbar = ops.fused_flush(ids, m(4, 5, grad=True), m(4),
                                      m(9, 3), m(9), m(5, 9, grad=True),
                                      m(3, 9), m(9), m(9))
    assert not last.requires_grad and mbar.requires_grad
    tcsr = {k: m(20, dtype=dt) for k, dt in (
        ("indptr", torch.int32), ("nbr", torch.int32), ("t", torch.float32),
        ("eidx", torch.int32), ("bat", torch.int32))}
    nb, nt, ne = ops.sample_roles(tcsr, ids, ids, ids,
                                  m(4, dtype=torch.bool), 0, 10)
    assert (nb.shape, nb.dtype, nt.dtype) == ((12, 10), torch.int32,
                                              torch.float32)
    assert ops.neighbor_sample(tcsr, ids, 0, 3)[0].shape == (4, 3)
    assert ops.temporal_attention(m(6, 2, 8), m(6, 3, 2, 8), m(6, 3, 2, 8),
                                  m(6, 3, dtype=torch.bool)).shape == (6, 2,
                                                                       8)


_META_RUN = meta.run


def test_cpu_tensors_never_reach_the_meta_route(monkeypatch):
    """The CPU's plain versions run with the meta route refused, counted
    or not, and the meta route refuses a CPU tensor."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the meta route")

    monkeypatch.setattr(meta, "run", refuse)
    args = (torch.randn(3, 4), torch.randn(3, 2), torch.randn(4, 6),
            torch.randn(2, 6), torch.zeros(6), torch.zeros(6))
    want = ops.gru(*args)
    with OpCost():
        assert torch.equal(ops.gru(*args), want)
    q = torch.randn(1, 8, 2, 4)
    assert ops.flash_attention(q, q, q).device.type == "cpu"
    with pytest.raises(ValueError, match="meta tensors only"):
        _META_RUN("gru", *args)


def test_other_devices_still_raise():
    class Elsewhere:
        device = torch.device("xla")

    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops._route(Elsewhere())
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.temporal_attention(Elsewhere(), None, None, None)
