"""The port's numpy-side and optimizer helpers against the JAX package's
on the CPU: the learning-rate schedules, ``adam`` / ``sgd`` / ``adamw``
with a schedule, ``Optimizer.apply_`` leaf by leaf, the LM token
pipeline, and the SPEED-side helpers (``graph_as_stream``,
``build_batches`` / ``unstack_batches``, the TIG single steps,
``make_pac_sync``, the ``repro_torch.tig`` names), and the LM pretraining
CLI.

Tolerances: schedules 1e-7 relative (float32 scalars, one ``cos``);
optimizer updates 1e-6 of each leaf's largest |JAX| (float32 elementwise
arithmetic, the same order of operations); the TIG step, the
``step_loss`` tests' rtol 1e-4 / atol 1e-5 (float32 sums in another
order); numpy helpers array for array.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.tig as jtig_pkg  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.tig import batching as jbatching  # noqa: E402
from repro.tig import distributed as jdist  # noqa: E402
from repro.tig import models as jm  # noqa: E402
from repro.tig import train as jtrain  # noqa: E402
from repro.tig.data import synthetic_tig  # noqa: E402
from repro.tig.protocol import split_views  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import tig as ttig_pkg  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.tig import batching as tbatching  # noqa: E402
from repro_torch.tig import distributed as tdist  # noqa: E402
from repro_torch.tig import engine  # noqa: E402
from repro_torch.tig import models as tm  # noqa: E402
from repro_torch.tig import train as ttrain  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# the module (the package's ``adamw`` is the function)
tadamw = importlib.import_module("repro_torch.optim.adamw")

SMALL = dict(dim=16, dim_time=8, dim_edge=16, dim_node=16, num_neighbors=4,
             n_heads=2, batch_size=50)
RTOL, ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return convert.params_from_numpy(tree)


# ------------------------------------------------------------ schedules

SCHEDULES = {
    "constant": ((3e-3,), {}),
    "cosine_decay": ((3e-3, 30), {"alpha": 0.1}),
    "linear_warmup_cosine": ((3e-3, 20, 40), {}),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    args, kw = SCHEDULES[name]
    full = {"constant": "constant_schedule",
            "cosine_decay": "cosine_decay_schedule"}.get(name, name)
    want_fn = getattr(joptim, full)(*args, **kw)
    got_fn = getattr(toptim, full)(*args, **kw)
    for step in range(51):
        want = np.asarray(want_fn(jnp.asarray(step, jnp.int32)))
        got = got_fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0,
                                   err_msg=f"step {step}")


# ------------------------------------------------------------ optimizers

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((7, 5)).astype(np.float32),
                  "b": rng.standard_normal((5,)).astype(np.float32)},
            "c": rng.standard_normal((3, 4, 2)).astype(np.float32)}


OPTIMIZERS = {
    "sgd": lambda o: o.sgd(0.05),
    "sgd momentum": lambda o: o.sgd(0.05, momentum=0.9),
    "sgd momentum, schedule": lambda o: o.sgd(
        o.linear_warmup_cosine(0.05, 2, 6), momentum=0.9),
    "adam": lambda o: o.adam(1e-2),
    "adamw schedule, clip": lambda o: o.adamw(
        o.linear_warmup_cosine(1e-2, 2, 6), weight_decay=0.1,
        max_grad_norm=1.0),
    "adam cosine": lambda o: o.adam(o.cosine_decay_schedule(1e-2, 5)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](toptim)
    jp, tp = _tree(0), _t(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    assert sorted(ts) == sorted(js)
    for step in range(4):
        grads = _tree(10 + step)
        jp, js = jopt.apply(grads, js, jp)
        tp, ts = topt.apply(_t(grads), ts, tp)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=0,
            atol=1e-6 * float(np.abs(b).max())), tp, _np(jp))
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9), ts, _np(js))
        assert int(ts["step"]) == int(js["step"]) == step + 1


@pytest.mark.parametrize("chunk", [1 << 26, 6])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_apply_in_place_is_bitwise_apply(name, chunk, monkeypatch):
    """``apply_`` (leaf by leaf, a leaf in slices of ``chunk`` elements)
    writes what ``apply`` returns, bit for bit, over three steps."""
    monkeypatch.setattr(tadamw, "APPLY_CHUNK", chunk)
    opt = OPTIMIZERS[name](toptim)
    p_new, p_in = _t(_tree(0)), _t(_tree(0))
    s_new, s_in = opt.init(p_new), opt.init(p_in)
    for step in range(3):
        grads = _t(_tree(20 + step))
        p_new, s_new = opt.apply(grads, s_new, p_new)
        opt.apply_(grads, s_in, p_in)
        for a, b in zip(tree_leaves(p_new) + tree_leaves(s_new),
                        tree_leaves(p_in) + tree_leaves(s_in)):
            assert torch.equal(a, b)


def test_apply_in_place_refuses_a_strided_param():
    opt = toptim.sgd(0.1)
    p = {"w": torch.zeros(4, 3).T}
    with pytest.raises(ValueError, match="contiguous"):
        opt.apply_({"w": torch.ones(3, 4)}, opt.init(p), p)


# ------------------------------------------------------------ the data

@pytest.mark.parametrize("seed", [0, 7])
def test_token_pipeline_equals_jax(seed):
    jcfg = jdata.LMDataConfig(vocab=1000, seq_len=64, global_batch=4,
                              seed=seed)
    tcfg = tdata.LMDataConfig(vocab=1000, seq_len=64, global_batch=4,
                              seed=seed)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for a, b, _ in zip(jdata.synthetic_corpus(jcfg),
                       tdata.synthetic_corpus(tcfg), range(3)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32
    for a, b, _ in zip(jdata.packed_batches(jcfg),
                       tdata.packed_batches(tcfg), range(5)):
        assert sorted(a) == sorted(b) == ["targets", "tokens"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert b[k].shape == (4, 64)
        np.testing.assert_array_equal(b["tokens"][:, 1:],
                                      b["targets"][:, :-1])


# ------------------------------------------------------------ TIG helpers

@pytest.fixture(scope="module")
def tiny():
    return synthetic_tig("tiny")


def test_graph_as_stream_equals_jax(tiny):
    js, jt = jtrain.graph_as_stream(tiny)
    ts, tt = ttrain.graph_as_stream(tiny)
    for f in dataclasses.fields(js):
        a, b = getattr(js, f.name), getattr(ts, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        else:
            assert a == b
    assert sorted(jt) == sorted(tt)
    for k in jt:
        np.testing.assert_array_equal(jt[k], tt[k])


def test_build_batches_and_unstack_equal_jax(tiny):
    stream, _ = ttrain.graph_as_stream(tiny)
    cfg = dict(SMALL)
    want, wh = jbatching.build_batches(
        stream, jm.TIGConfig(**cfg), np.random.default_rng(3),
        return_history=True)
    got, gh = tbatching.build_batches(
        stream, tm.TIGConfig(**cfg), np.random.default_rng(3),
        return_history=True)
    assert len(got) == len(want) > 1
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(np.asarray(wh.nbr), np.asarray(gh.nbr))
    # unstack inverts stack, as in the JAX package
    stacked = tbatching.stack_batches(got)
    again = tbatching.unstack_batches(stacked)
    assert all(np.array_equal(a[k], b[k])
               for a, b in zip(got, again) for k in a)
    assert len(jbatching.unstack_batches(stacked)) == len(again)


@pytest.fixture(scope="module")
def tig_step_inputs(tiny):
    splits = split_views(tiny)
    cfg = dict(SMALL)
    batches = jbatching.build_batches(splits.train, jm.TIGConfig(**cfg),
                                      np.random.default_rng(5),
                                      neg_pool=splits.neg_pool)
    tables = jbatching.make_tables(tiny.edge_feat, tiny.node_feat)
    jparams = _np(jm.init_params(jax.random.PRNGKey(2), jm.TIGConfig(**cfg)))
    return tiny, cfg, batches, tables, jparams


def test_tig_train_and_eval_steps_match_jax(tig_step_inputs):
    """Two steps of the port's eager ``make_train_step`` (AdamW) against
    the JAX package's jitted one, and one ``make_eval_step``."""
    g, cfg, batches, tables, jparams = tig_step_inputs
    jcfg, tcfg = jm.TIGConfig(**cfg), tm.TIGConfig(**cfg)
    jopt, topt = joptim.adamw(1e-3), toptim.adamw(1e-3)
    jstep, tstep = jtrain.make_train_step(jcfg, jopt), \
        ttrain.make_train_step(tcfg, topt)
    jp, tp = jparams, _t(jparams)
    js, ts = jopt.init(jp), topt.init(tp)
    jst, tst = jm.init_state(jcfg, g.num_nodes), tm.init_state(
        tcfg, g.num_nodes, "cpu")
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    for s in range(2):
        batch = {k: v for k, v in batches[s].items() if k != "labels"}
        jp, js, jst, jl = jstep(jp, js, jst, {k: jnp.asarray(v) for k, v
                                              in batch.items()}, jt)
        before = tree_map(torch.clone, tp)
        tp_new, ts, tst, tl = tstep(tp, ts, tst, batch, tables)
        # the step wrote nothing it was given
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(before),
                                                    tree_leaves(tp)))
        tp = tp_new
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL,
                                   atol=ATOL)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL), tp, _np(jp))
        for k, v in _np(jst).items():
            np.testing.assert_allclose(tst[k].numpy(), v, rtol=RTOL,
                                       atol=ATOL)
    batch = {k: v for k, v in batches[2].items() if k != "labels"}
    jst2, jaux = jtrain.make_eval_step(jcfg)(
        jp, jst, {k: jnp.asarray(v) for k, v in batch.items()}, jt)
    tst2, taux = ttrain.make_eval_step(tcfg)(tp, tst, batch, tables)
    np.testing.assert_allclose(taux["pos_logit"].numpy(),
                               np.asarray(jaux["pos_logit"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tst2["mem"].numpy(), np.asarray(jst2["mem"]),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture
def one_thread():
    """One intra-op thread: multi-threaded CPU sums are not bitwise
    reproducible from call to call."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tig_train_step_is_an_eager_epoch_step(tig_step_inputs, one_thread):
    """One ``make_train_step`` step, bit for bit the first step of the
    eager epoch (``engine.scan_train_epoch``, the CPU's path of
    ``train_single``) over the same host-plan batch."""
    g, cfg, batches, tables, jparams = tig_step_inputs
    tcfg = tm.TIGConfig(**cfg)
    opt = toptim.adamw(1e-3)
    params = _t(jparams)
    state = tm.init_state(tcfg, g.num_nodes, "cpu")
    tt = {k: torch.from_numpy(v) for k, v in tables.items()}
    p1, s1, st1, loss = ttrain.make_train_step(tcfg, opt)(
        params, opt.init(params), state, batches[0], tables)
    program = tbatching.stack_batches(batches[:1])
    p2, s2, st2, losses = engine.scan_train_epoch(
        params, opt.init(params), state, program, tt, cfg=tcfg, opt=opt,
        device="cpu")
    assert torch.equal(loss, losses[0])
    for a, b in zip(tree_leaves(p1) + tree_leaves(s1),
                    tree_leaves(p2) + tree_leaves(s2)):
        assert torch.equal(a, b)
    assert all(torch.equal(st1[k], st2[k]) for k in st1)


@pytest.mark.parametrize("mode", ["latest", "mean"])
def test_make_pac_sync_matches_jax(mode):
    rng = np.random.default_rng(6)
    p, rows, d, s = 4, 40, 6, 11
    states = {"mem": rng.standard_normal((p, rows, d)).astype(np.float32),
              "mem2": rng.standard_normal((p, rows, d)).astype(np.float32),
              "last": rng.integers(0, 4, (p, rows)).astype(np.float32)}
    shared = np.stack([rng.permutation(rows - 1)[:s]
                       for _ in range(p)]).astype(np.int32)
    want = jdist.make_pac_sync(sync_mode=mode)(
        {k: jnp.asarray(v) for k, v in states.items()}, jnp.asarray(shared))
    got = tdist.make_pac_sync(sync_mode=mode)(
        {k: torch.from_numpy(v) for k, v in states.items()}, shared)
    for k in states:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="sync_mode"):
        tdist.make_pac_sync(sync_mode="max")


def test_tig_package_names_are_the_jax_packages():
    assert ttig_pkg.__all__ == jtig_pkg.__all__
    for name in ttig_pkg.__all__:
        assert getattr(ttig_pkg, name).__name__ == name
    assert ttrain.evaluate_stream is ttrain.score_stream
    for name in ("time_scale_of", "train_classifier_head",
                 "evaluate_stream", "graph_as_stream", "make_train_step",
                 "make_eval_step"):
        assert name in ttrain.__all__ and name in jtrain.__all__


# ------------------------------------------------------------ the CLI

def test_lm_cli_trains_on_the_cpu(capsys, tmp_path):
    cli.main(["--arch", "starcoder2-3b", "--reduced", "--steps", "3",
              "--device", "cpu", "--log-every", "1", "--ckpt-dir",
              str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("starcoder2-3b (reduced): ")
    assert "seq=128, batch=8" in out[0]
    losses = [float(line.split()[3]) for line in out
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert (tmp_path / "ckpt_00000003.npz").exists()


def test_lm_cli_refuses_the_encoder_decoder():
    with pytest.raises(ValueError, match="frames"):
        cli.main(["--arch", "seamless-m4t-medium", "--reduced", "--steps",
                  "3", "--device", "cpu"])
