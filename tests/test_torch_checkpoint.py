"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the
cases of ``tests/test_checkpoint.py`` on trees of tensors, and the
training trees ``{params, opt_state, state}`` of TGN restored across the
two packages in both directions, bit for bit (the 0-dim AdamW step
included)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.tig import models as jm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tig import models as tm  # noqa: E402

SMALL = dict(flavor="tgn", dim=16, dim_time=8, dim_edge=16, dim_node=16,
             num_neighbors=4, n_heads=2, batch_size=50)


def _tree(x=1.0):
    return {"params": {"w": torch.full((3, 2), x),
                       "b": torch.zeros(2)},
            "opt_state": {"mu": {"w": torch.ones(3, 2)},
                          "step": torch.tensor(7, dtype=torch.int32)},
            "state": {"mem": torch.arange(6, dtype=torch.float32)}}


def test_save_leaves_no_tmp_files(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, _tree(), metadata={"epoch": 0})
    names = sorted(os.listdir(d))
    assert names == ["ckpt_00000000.json", "ckpt_00000000.npz"]


def test_roundtrip_keeps_values_dtypes_and_the_0dim_step(tmp_path):
    d = str(tmp_path)
    tree = _tree(2.5)
    save_checkpoint(d, 4, tree)
    got = restore_checkpoint(d, 4, _tree())
    assert got["opt_state"]["step"].shape == ()
    assert got["opt_state"]["step"].dtype == torch.int32
    for key in ("params", "opt_state", "state"):
        for (k, a), b in zip(sorted(got[key].items()),
                             (tree[key][k] for k in sorted(got[key]))):
            if isinstance(a, dict):
                continue
            assert torch.equal(a, b), k
    with np.load(os.path.join(d, "ckpt_00000004.npz")) as data:
        assert sorted(data.files) == [
            "opt_state|mu|w", "opt_state|step", "params|b", "params|w",
            "state|mem"]


def test_sequences_and_numpy_leaves(tmp_path):
    d = str(tmp_path)
    tree = {"a": [np.arange(3), (np.ones(2), None)], "b": np.float32(3)}
    save_checkpoint(d, 0, tree)
    got = restore_checkpoint(d, 0, tree)
    np.testing.assert_array_equal(got["a"][0], np.arange(3))
    assert isinstance(got["a"][1], tuple) and got["a"][1][1] is None
    jgot = jck.restore_checkpoint(d, 0, tree)
    np.testing.assert_array_equal(jgot["a"][1][0], np.ones(2))


def test_latest_step_skips_truncated_npz(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, _tree(1.0))
    save_checkpoint(d, 1, _tree(2.0))
    npz1 = os.path.join(d, "ckpt_00000001.npz")
    with open(npz1, "r+b") as f:
        f.truncate(os.path.getsize(npz1) // 2)
    assert latest_step(d) == 0
    restored = restore_checkpoint(d, 0, _tree())
    assert torch.equal(restored["params"]["w"], _tree(1.0)["params"]["w"])


def test_latest_step_skips_manifestless_and_bad_manifest(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, _tree())
    np.savez(os.path.join(d, "ckpt_00000007.npz"), x=np.zeros(1))
    save_checkpoint(d, 5, _tree())
    with open(os.path.join(d, "ckpt_00000005.json"), "w") as f:
        f.write("{not json")
    assert latest_step(d) == 3


def test_latest_step_empty_and_missing_dir(tmp_path):
    assert latest_step(str(tmp_path)) is None
    assert latest_step(str(tmp_path / "nope")) is None


def test_manifest_contents(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 2, _tree(), metadata={"epoch": 2, "val_ap": 0.5})
    with open(os.path.join(d, "ckpt_00000002.json")) as f:
        manifest = json.load(f)
    assert manifest == {"step": 2, "num_arrays": 5,
                        "metadata": {"epoch": 2, "val_ap": 0.5}}


def test_subset_restore_from_superset(tmp_path):
    d = str(tmp_path)
    full = _tree(3.0)
    save_checkpoint(d, 0, full)
    sub = restore_checkpoint(d, 0, {"params": full["params"],
                                    "state": full["state"]})
    assert sorted(sub) == ["params", "state"]
    assert torch.equal(sub["params"]["w"], full["params"]["w"])


def test_missing_keys_raise_value_error_naming_them(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, {"params": _tree()["params"]})
    with pytest.raises(ValueError, match="opt_state"):
        restore_checkpoint(d, 0, _tree())
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, 1, _tree())


def test_restore_shape_mismatch(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, 0, bad)


def _training_trees():
    """TGN's {params, opt_state, state} in the JAX package's structure
    (``jax.eval_shape`` of its ``init_params`` / ``init_state`` and its
    AdamW state layout) with seeded values, and the same trees as the
    port's tensors."""
    cfg = jm.TIGConfig(**SMALL)
    rng = np.random.default_rng(3)

    def values(shapes):
        return jax.tree.map(
            lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)

    params = values(jax.eval_shape(
        lambda: jm.init_params(jax.random.PRNGKey(3), cfg)))
    state = values(jax.eval_shape(lambda: jm.init_state(cfg, 20)))
    opt_state = {"step": np.asarray(1, np.int32), "mu": values(params),
                 "nu": jax.tree.map(np.abs, values(params))}
    jtree = {"params": params, "opt_state": opt_state, "state": state}
    ttree = {"params": convert.params_from_numpy(params),
             "opt_state": convert.opt_state_from_numpy(opt_state),
             "state": convert.state_from_numpy(state)}
    return jtree, ttree


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) \
        else np.zeros_like(tree)


def _assert_same(a, b):
    """Tensor or numpy trees with equal keys, shapes, dtypes, values."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
        return
    x = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert x.shape == y.shape and x.dtype == y.dtype
    np.testing.assert_array_equal(x, y)


def test_jax_checkpoint_restores_into_the_ports_trees(tmp_path):
    jtree, ttree = _training_trees()
    assert jtree["opt_state"]["step"].shape == ()
    jck.save_checkpoint(str(tmp_path), 1, jtree)
    got = restore_checkpoint(str(tmp_path), 1, _zeros_like(ttree))
    _assert_same(got, ttree)
    assert isinstance(got["opt_state"]["step"], torch.Tensor)
    # and the port's own AdamW steps on from the restored state
    opt = adamw(lr=1e-3)
    p, o = opt.apply(got["params"], got["opt_state"], got["params"])
    assert int(o["step"]) == 2


def test_port_checkpoint_restores_into_jaxs_trees(tmp_path):
    jtree, ttree = _training_trees()
    save_checkpoint(str(tmp_path), 1, ttree, metadata={"epoch": 1})
    got = jck.restore_checkpoint(str(tmp_path), 1,
                                 jax.tree.map(np.zeros_like, jtree))
    _assert_same(got, jtree)
    assert jck.latest_step(str(tmp_path)) == 1
    # the two packages write the same keys
    jck.save_checkpoint(str(tmp_path / "jax"), 1, jtree)
    with np.load(os.path.join(tmp_path, "ckpt_00000001.npz")) as a, \
            np.load(os.path.join(tmp_path, "jax",
                                 "ckpt_00000001.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params|upd|xz|w" in a.files
    # the port's own trees have the JAX package's keys
    cfg = tm.TIGConfig(**SMALL)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    own = {"params": params, "opt_state": adamw(lr=1e-3).init(params),
           "state": tm.init_state(cfg, 20)}
    save_checkpoint(str(tmp_path / "own"), 0, own)
    with np.load(os.path.join(tmp_path, "own", "ckpt_00000000.npz")) as c:
        assert sorted(c.files) == sorted(a.files)
        assert {"opt_state|step", "opt_state|mu|upd|xz|w",
                "opt_state|nu|upd|xz|w", "state|mem"} <= set(a.files)
