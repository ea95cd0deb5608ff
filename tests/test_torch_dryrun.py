"""The port's dry run (``repro_torch.launch.dryrun``): every architecture's
program costed on the ``meta`` device with no allocation, its memory
against the figures the card's runs were planned by, the speed-tig rank
step, the CLI, and a TIG step counted the same on the CPU and on
``meta``. JAX is imported only to read the JAX dry run's settings."""

import ast
import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.tig.data import synthetic_tig  # noqa: E402
from repro_torch.tig.models import TIGConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GIB = 2 ** 30


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's tests: the suite runs in
    several worker processes at once, and a torch that takes every core
    in each of them makes the workers contend for the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_dryrun_constants() -> dict:
    """LONG_OK and ENC_LEN_DECODE of the JAX dry run, read from its source
    (importing it would set XLA_FLAGS for the rest of the process)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name):
            name = node.targets[0].id
            if name in ("LONG_OK", "ENC_LEN_DECODE"):
                out[name] = ast.literal_eval(node.value)
    return out


def test_shapes_and_long_context_policy_are_the_jax_dry_runs():
    jax_consts = _jax_dryrun_constants()
    assert dryrun.ENC_LEN_DECODE == jax_consts["ENC_LEN_DECODE"]
    # the port gates long_500k on sub_quadratic: the JAX dry run's LONG_OK
    long_ok = {a for a in list_archs() if get_config(a).sub_quadratic}
    assert long_ok == jax_consts["LONG_OK"]
    for a in sorted(set(list_archs()) - long_ok):
        assert dryrun.dryrun_one(a, "long_500k", save=False,
                                 verbose=False)["status"].startswith("skip")
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    assert all(isinstance(v, InputShape) for v in INPUT_SHAPES.values())
    # one card takes one chip's share of the JAX dry run's 256
    assert {dryrun.default_batch(s) for s in INPUT_SHAPES.values()} == {1}


def test_full_starcoder2_train_4k_on_meta():
    """The FULL StarCoder2-3B training step at train_4k in one call: every
    param and activation on ``meta``, the report filled, 6 N D over its
    counted FLOPs, 30 flash launches forward (60 with the recompute) and
    30 backward, and its float32 state 47.4 GiB."""
    out = dryrun.dryrun_one("starcoder2-3b", "train_4k", save=False,
                            verbose=False)
    cfg = get_config("starcoder2-3b")
    assert out["status"] == "ok" and out["mesh"] == "h100x1"
    assert out["chips"] == 1 and out["batch"] == 1 and out["seq"] == 4096
    assert out["model_flops"] == 6.0 * cfg.active_param_count() * 4096
    assert 0.5 < out["useful_ratio"] < 1.0
    assert out["kernels"]["flash_attention"][0] == 2 * cfg.n_layers
    assert out["kernels"]["flash_attention backward"][0] == cfg.n_layers
    assert round(out["state_bytes"] / GIB, 1) == 47.4
    assert 0 < out["saved_bytes"] < 8 * GIB and out["fits_one_card"]
    assert out["dominant"] in ("compute", "memory")
    assert out["compute_s"] == pytest.approx(out["hlo_flops"] / 989e12)
    params = dryrun.lm_state(cfg)
    assert {x.device.type for x in tree_leaves(params)} == {"meta"}


# the float32 params, grads and AdamW moments of each FULL config
# (PERF.md's memory table), GiB
STATE_GIB = [("starcoder2-3b", None, 47.4), ("rwkv6-1.6b", None, 23.6),
             ("hymba-1.5b", None, 24.8), ("gemma-7b", 8, 44.7),
             ("gemma-7b", None, 127.2), ("minitron-4b", None, 75.9),
             ("olmoe-1b-7b", None, 103.1), ("qwen2-vl-7b", None, 113.5)]


@pytest.mark.parametrize("arch,layers,gib", STATE_GIB)
def test_training_state_bytes(arch, layers, gib):
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    assert round(dryrun.train_state_bytes(cfg) / GIB, 1) == gib
    assert (dryrun.train_state_bytes(cfg) < dryrun.CARD_BYTES
            - dryrun.HEADROOM) == (gib < 78.0)


def test_prefill_and_decode_costs():
    """Prefill holds bf16 params; decode also its cache (seamless with
    ENC_LEN_DECODE frames of encoder memory); neither saves tensors."""
    pre = dryrun.dryrun_one("seamless-m4t-medium", "prefill_32k",
                            save=False, verbose=False)
    dec = dryrun.dryrun_one("seamless-m4t-medium", "decode_32k", save=False,
                            verbose=False)
    cfg = get_config("seamless-m4t-medium")
    n = sum(x.numel() for x in tree_leaves(dryrun.lm_state(cfg)))
    assert pre["state_bytes"] == 2 * n and pre["saved_bytes"] == 0
    kv = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    assert dec["state_bytes"] == 2 * n + kv * (32_768 + dryrun.ENC_LEN_DECODE)
    assert dec["model_flops"] == 2.0 * cfg.active_param_count()
    assert "flash_attention" in pre["kernels"] and not dec["kernels"]
    skipped = dryrun.dryrun_one("gemma-7b", "long_500k", save=False)
    assert skipped["status"].startswith("skipped")


def test_speed_tig_rank_step():
    """One rank's PAC step at the JAX dry run's per-chip sizes, on meta:
    the sampling, flush and attention kernels, and one gradient
    all-reduce of the flat parameter buffer."""
    out = dryrun.dryrun_speed_tig(save=False, verbose=False)
    from repro_torch.configs.speed_tig import TIG

    assert out["status"] == "ok"
    assert (out["capacity"], out["e_cap"], out["ev_cap"]) == (
        4_889_537 // 256 + 1, 4_300_999 // 256 + 256,
        2 * (4_300_999 // 256 + 256) + TIG.num_neighbors)
    assert set(out["kernels"]) >= {"sample_roles", "fused_flush",
                                   "temporal_attention"}
    n = sum(x.numel() for x in tree_leaves(
        __import__("repro_torch.tig.models", fromlist=["init_params"])
        .init_params(torch.Generator(), TIG, "meta")))
    assert out["collective_counts"]["all-reduce"] == 1
    assert out["collective_bytes"] == 2 * 4 * n
    assert out["sync_bytes_per_epoch"] > 0 and out["fits_one_card"]


def test_cli_saves_one_json_a_combination_and_fails_on_a_failure(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape",
                        "decode_32k"]) == 0
    (f,) = tmp_path.glob("*.json")
    rec = json.loads(f.read_text())
    assert f.name == "rwkv6-1.6b_decode_32k_h100x1.json"
    assert rec["status"] == "ok" and rec["arch"] == "rwkv6-1.6b"
    assert "rwkv6" in rec["kernels"]
    real = dryrun.dryrun_one

    def failing(arch, shape, **kw):
        if shape == "decode_32k":
            raise RuntimeError("boom")
        return real(arch, shape, **kw)

    monkeypatch.setattr(dryrun, "dryrun_one", failing)
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--no-save"]) == 1
    assert "1 failures" in capsys.readouterr().out


def test_tig_step_counts_the_same_on_cpu_and_meta():
    """``count_tig_step``, chip_smoke's TGN comparison, on the CPU and on
    ``meta`` copies of the same inputs: equal FLOPs and bytes."""
    g = synthetic_tig("tiny")
    cfg = TIGConfig(dim=16, dim_time=8, dim_edge=16, dim_node=16,
                    num_neighbors=4, n_heads=2, batch_size=50)
    inputs = dryrun.tig_step_inputs(g, cfg, "cpu")
    cpu = dryrun.count_tig_step(cfg, inputs, "cpu")
    on_meta = dryrun.count_tig_step(cfg, dryrun.on_meta(inputs), "meta")
    assert cpu.flops == on_meta.flops > 0
    assert cpu.bytes == on_meta.bytes
    assert set(cpu.kernels) == {"sample_roles", "fused_flush",
                                "fused_flush backward", "temporal_attention",
                                "temporal_attention backward"}
