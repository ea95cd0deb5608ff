"""``repro_torch.tig.models.step_loss`` against ``jax.value_and_grad`` of
``repro.tig.models.step_loss``: the same params (converted with
``repro_torch.convert``), the same batches, for all four flavors at one
attention layer, over two consecutive steps so the carried state (pending
messages, memory) and its detach at the step boundary are exercised.

Tolerance rtol 1e-4 / atol 1e-5: float32 sums taken in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.tig import models as jm  # noqa: E402
from repro.tig.batching import build_batch_program  # noqa: E402
from repro.tig.batching import make_tables  # noqa: E402
from repro.tig.data import synthetic_tig  # noqa: E402
from repro.tig.protocol import split_views  # noqa: E402
from repro.tig.train import epoch_rng  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.tig import models as tm  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

SMALL = dict(dim=16, dim_time=8, dim_edge=16, dim_node=16, num_neighbors=4,
             n_heads=2, batch_size=50)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def data():
    g = synthetic_tig("tiny")
    splits = split_views(g)
    cfg = jm.TIGConfig(**SMALL)
    batches, _ = build_batch_program(splits.train, cfg, epoch_rng(0, 0, 1),
                                     neg_pool=splits.neg_pool, plan="host")
    return g, batches, make_tables(g.edge_feat, g.node_feat)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("flavor,message_fn", [
    ("jodie", "id"), ("dyrep", "id"), ("tgn", "id"), ("tige", "id"),
    ("tgn", "mlp")])
def test_step_loss_and_grads_match_jax(data, flavor, message_fn):
    g, batches, tables = data
    jcfg = jm.TIGConfig(flavor=flavor, message_fn=message_fn, dim_msg=24,
                        **SMALL)
    tcfg = tm.TIGConfig(flavor=flavor, message_fn=message_fn, dim_msg=24,
                        **SMALL)
    jparams = jm.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = convert.params_from_numpy(_np(jparams))
    jstate = jm.init_state(jcfg, g.num_nodes)
    tstate = tm.init_state(tcfg, g.num_nodes)
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    tt = {k: torch.from_numpy(v) for k, v in tables.items()}
    grad_fn = jax.value_and_grad(jm.step_loss, has_aux=True)
    for s in (0, 1):
        batch = {k: v[s] for k, v in batches.items() if k != "labels"}
        (jl, (jstate, jaux)), jg = grad_fn(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            jt, jcfg)
        tstate = {k: v.detach() for k, v in tstate.items()}
        p = tree_map(lambda x: x.detach().requires_grad_(), tparams)
        tl, (tstate, taux) = tm.step_loss(
            p, tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
            tt, tcfg)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(taux["pos_logit"].detach().numpy(),
                                   jaux["pos_logit"], rtol=RTOL, atol=ATOL)
        tg = tree_map(lambda x: np.zeros(x.shape, np.float32)
                      if x.grad is None else x.grad.numpy(), p)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=RTOL, atol=ATOL), tg, _np(jg))
        tsn = convert.state_to_numpy(tstate)
        for key, v in _np(jstate).items():
            np.testing.assert_allclose(tsn[key], v, rtol=RTOL, atol=ATOL)
    # the second step flushed the first step's messages into memory
    assert np.abs(convert.state_to_numpy(tstate)["mem"]).max() > 0


def test_init_params_keys_and_shapes_match_jax():
    for flavor in ("jodie", "dyrep", "tgn", "tige"):
        kw = dict(flavor=flavor, message_fn="mlp", n_classes=3, **SMALL)
        jp = _np(jm.init_params(jax.random.PRNGKey(0), jm.TIGConfig(**kw)))
        tp = tm.init_params(torch.Generator().manual_seed(0),
                            tm.TIGConfig(**kw))
        assert jax.tree.structure(jp) == jax.tree.structure(
            convert.params_to_numpy(tp))
        jax.tree.map(lambda a, b: (a.shape, a.dtype) == (b.shape, b.dtype)
                     or pytest.fail(f"{a.shape} {b.shape}"),
                     jp, convert.params_to_numpy(tp))


def test_convert_round_trips_every_tree():
    cfg = jm.TIGConfig(**SMALL)
    from repro.optim import adamw

    params = _np(jm.init_params(jax.random.PRNGKey(0), cfg))
    state = _np(jm.init_state(cfg, 7))
    opt_state = _np(adamw(1e-3).init(jm.init_params(jax.random.PRNGKey(0),
                                                    cfg)))
    for to_t, to_np, tree in (
            (convert.params_from_numpy, convert.params_to_numpy, params),
            (convert.state_from_numpy, convert.state_to_numpy, state),
            (convert.opt_state_from_numpy, convert.opt_state_to_numpy,
             opt_state)):
        back = to_np(to_t(tree))
        jax.tree.map(lambda a, b: (a.dtype == b.dtype
                                   and np.array_equal(a, b))
                     or pytest.fail("round trip changed a leaf"), tree, back)


def test_multi_layer_config_raises():
    """Any depth from one layer up is a model; none below."""
    with pytest.raises(ValueError, match="n_layers"):
        tm.TIGConfig(n_layers=0)
    assert tm.TIGConfig(n_layers=2).n_layers == 2
