"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the entry points run on the card
unless the caller asks for the CPU."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model, serve  # noqa: E402
from repro_torch.core import sep_partition  # noqa: E402
from repro_torch.launch import mesh, pac_cluster  # noqa: E402
from repro_torch.tig import distributed, engine, protocol, train  # noqa: E402
from repro_torch.tig import stream  # noqa: E402
from repro_torch.tig.data import synthetic_tig  # noqa: E402
from repro_torch.tig.models import TIGConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_importing_every_module_pulls_in_no_jax():
    mods = _modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) > 20
    assert {"repro_torch.roofline.kernel_bytes",
            "repro_torch.roofline.pipeline_bubble",
            "repro_torch.roofline.op_cost", "repro_torch.roofline.analysis",
            "repro_torch.kernels.meta",
            "repro_torch.launch.dryrun"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch")
     .rglob("*.py")] + ["chip_smoke.py"]))
def test_sources_name_no_jax_import(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


def test_entry_points_refuse_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = synthetic_tig("tiny")
    cfg = TIGConfig(dim=16, dim_time=8, dim_edge=16, dim_node=16,
                    num_neighbors=4, batch_size=50)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_single(g, cfg, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_single(g, cfg, epochs=1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.scan_train_epoch({}, {}, {}, {}, {}, cfg=cfg, opt=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.scan_eval_stream({}, {}, {}, {}, cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.make_train_epoch(cfg, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.make_eval_epoch(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        protocol.score_stream({}, cfg, {}, {}, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        protocol.run_protocol({}, cfg, protocol.split_views(g), {})
    with pytest.raises(RuntimeError, match="CUDA"):
        train.evaluate_params(g, cfg, {})
    part = sep_partition(g.src, g.dst, g.t, g.num_nodes, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.pac_train(g, part, cfg, num_devices=2, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.make_pac_epoch(cfg, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        pac_cluster.main(["--out", str(tmp_path / "never.npz")])
    # an NCCL group (a CPU-only torch build has no NCCL: its queries are
    # stood in for) finds no card before any collective
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_tig_mesh()
    shards = stream.write_graph_shards(g, str(tmp_path / "shards"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_sharded(shards, cfg, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_sharded(shards, cfg, epochs=1, protocol=True,
                            device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        stream.stage_device_tables(shards)
    with pytest.raises(RuntimeError, match="CUDA"):
        protocol.train_classifier_head(np.zeros((20, 4), np.float32),
                                       np.arange(20) % 2, 2)
    lm = get_config("rwkv6-1.6b", reduced=True)
    params = model.init_params(torch.Generator(), lm, device="cpu")
    cache = model.init_cache(lm, 2, device="cpu")
    tokens = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(torch.Generator(), lm)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(lm, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.forward(params, {"tokens": tokens}, lm)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.serve_step(params, cache, {"token": tokens[:, 0]}, lm)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.generate(params, lm, tokens, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--gen", "1"])
    dense = get_config("starcoder2-3b", reduced=True)
    dparams = model.init_params(torch.Generator(), dense, device="cpu")
    dcache = model.init_cache(dense, 2, 8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(dense, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.forward(dparams, {"tokens": tokens}, dense)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.serve_step(dparams, dcache, {"token": tokens[:, 0],
                                           "pos": tokens[:, 0]}, dense)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "starcoder2-3b", "--gen", "1"])


def test_hybrid_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """Hymba's entry points, and the selective scan kernel's wrapper, which
    takes CUDA tensors only (``ops.selective_scan`` sends a CPU tensor to
    the plain version instead)."""
    from repro_torch.kernels.selective_scan import selective_scan_fwd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hy = get_config("hymba-1.5b", reduced=True)
    params = model.init_params(torch.Generator(), hy, device="cpu")
    cache = model.init_cache(hy, 2, 8, device="cpu")
    tokens = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(hy, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.forward(params, {"tokens": tokens}, hy)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.serve_step(params, cache, {"token": tokens[:, 0],
                                         "pos": tokens[:, 0]}, hy)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "hymba-1.5b", "--gen", "1"])
    x = torch.zeros((1, 3, 16))
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_fwd(x, x, x[..., :8], x[..., :8], torch.zeros(16, 8))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-7b"])
def test_encdec_and_vlm_entry_points_refuse_to_run_without_a_card(
        monkeypatch, arch):
    """The encoder-decoder's ``encode`` / ``fill_enc_cache`` and both
    families' ``forward``, ``generate`` and CLI default to the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(arch, reduced=True)
    params = model.init_params(torch.Generator(), cfg, device="cpu")
    tokens = torch.zeros((2, 4), dtype=torch.int64)
    frames = torch.zeros((2, 3, cfg.d_model))
    batch = {"tokens": tokens, "frames": frames,
             "patches": frames, "positions3": torch.zeros((2, 3, 7))}
    with pytest.raises(RuntimeError, match="CUDA"):
        model.forward(params, batch, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.generate(params, cfg, tokens, 1, frames=frames)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", arch, "--gen", "1"])
    if cfg.enc_dec:
        cache = model.init_cache(cfg, 2, 8, device="cpu", enc_len=3)
        with pytest.raises(RuntimeError, match="CUDA"):
            model.encode(params, frames, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            model.fill_enc_cache(params, cache, frames, cfg)


def test_dry_run_needs_no_card(monkeypatch):
    """The dry run and the step cost counter run on ``meta`` where no card
    is: the entry points' meta route, not the card's kernels."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = dryrun.dryrun_one("hymba-1.5b", "decode_32k", save=False,
                            verbose=False)
    assert out["status"] == "ok" and out["hlo_flops"] > 0
    assert set(out["kernels"]) == {"selective_scan"}
