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
