"""The port's launchers on the CPU: ``python -m
repro_torch.launch.pac_cluster`` killed and resumed, its elastic
supervisor recovering from a lost rank over gloo, and the ``speed-tig``
CLI (``repro_torch.launch.train``) against the JAX package's.

The recovery oracle: two gloo ranks under ``--elastic`` (2 partition
slots each, 8 SEP parts, 2 epochs), original rank 1 SIGKILLed by an
injected fault at the top of epoch 1. Its supervisor marks the host lost;
rank 0's worker fails on the broken collective, and its supervisor
re-forms a one-rank world holding all 4 slots and resumes from the
epoch-0 checkpoint. The recovered run must equal, bit for bit, a
one-rank ``--resume`` from a copy of that checkpoint, and the undisturbed
one-process run within ``tests/test_torch_pac.py``'s rules (1e-4 on
losses, params and memories, 1e-3 on metrics: epoch 0 ran over two
ranks, whose average of the gradients rounds otherwise than one
process's). Every rank runs in its own session, killed with its group
past ``BOUND`` seconds.
"""

import os
import re
import shutil
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import partition_stats as jax_partition_stats  # noqa: E402
from repro.core import sep_partition as jax_sep_partition  # noqa: E402
from repro.tig.data import synthetic_tig as jax_synthetic_tig  # noqa: E402
from repro.tig.graph import chronological_split as jax_split  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BOUND = 180          # seconds a launcher run may take, then killed
TOL = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_FAULTS", "REPRO_PAC_WORKER",
                        "REPRO_PAC_ORIG_RANK")}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


def _launch(*args, procs=1, rank=0, port=None, env=None):
    """One rank of the launcher on gloo, in its own session."""
    cmd = [sys.executable, "-u", "-m", "repro_torch.launch.pac_cluster",
           "--device", "cpu", "--num-processes", str(procs),
           "--process-id", str(rank), "--coordinator",
           f"127.0.0.1:{port or _free_port()}", "--epochs", "2",
           "--parts", "8", "--seed", "0", "--timeout", "60", *args]
    return subprocess.Popen(cmd, cwd=ROOT, env=env or _env(),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _wait(procs):
    """Each run's (return code, log), every session killed past
    ``BOUND``."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=BOUND)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def _ok(runs):
    for rc, log in runs:
        assert rc == 0, log[-3000:]


def _bitwise(a, b, keys=None):
    a, b = np.load(a), np.load(b)
    assert sorted(a.files) == sorted(b.files)
    for key in keys or a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_launcher_kill_and_resume(tmp_path):
    """One gloo rank, 2 slots: ``--run-dir R --ckpt-every 1`` SIGKILLed by
    ``host_kill@epoch=1`` leaves epoch 0's checkpoint; ``--run-dir R
    --resume`` trains epoch 1 from it, bitwise the undisturbed run's
    epoch 1 and result; ``--elastic`` with no fault is bitwise the plain
    run and marks its rank done."""
    run, el = tmp_path / "run", tmp_path / "elastic"
    common = ("--local-devices", "2")
    [(rc, log)] = _wait([_launch(
        *common, "--run-dir", str(run), "--ckpt-every", "1",
        env=_env(REPRO_FAULTS="host_kill@epoch=1"))])
    assert rc == -signal.SIGKILL, log[-3000:]
    assert "FAULT_INJECTED: host_kill" in log
    assert sorted(os.listdir(run / "ckpt")) == ["ckpt_00000000.json",
                                               "ckpt_00000000.npz"]
    runs = _wait([
        _launch(*common, "--run-dir", str(run), "--resume", "--out",
                str(tmp_path / "resumed.npz")),
        _launch(*common, "--out", str(tmp_path / "plain.npz")),
        _launch(*common, "--elastic", "--run-dir", str(el), "--out",
                str(tmp_path / "elastic.npz"))])
    _ok(runs)
    assert "PAC_RESUME: step 0" in runs[0][1]
    assert "ELASTIC: attempt 0/2" in runs[2][1]
    assert (el / "done_0").exists() and not (el / "lost_0").exists()
    _bitwise(tmp_path / "elastic.npz", tmp_path / "plain.npz")
    resumed, plain = (np.load(tmp_path / f"{n}.npz")
                      for n in ("resumed", "plain"))
    assert sorted(resumed.files) == sorted(
        k for k in plain.files if k != "loss_1")
    np.testing.assert_array_equal(resumed["loss_0"], plain["loss_1"])
    for key in resumed.files:
        if key != "loss_0":
            np.testing.assert_array_equal(resumed[key], plain[key],
                                          err_msg=key)


def test_elastic_cluster_recovers_from_host_kill(tmp_path):
    run = tmp_path / "run"
    port = _free_port()
    elastic = ("--elastic", "--run-dir", str(run), "--local-devices", "2",
               "--ckpt-every", "1", "--max-restarts", "2",
               "--heartbeat-interval", "0.25", "--heartbeat-timeout", "5")
    rank0, rank1 = _wait([
        _launch(*elastic, "--out", str(tmp_path / "recovered.npz"),
                procs=2, rank=0, port=port),
        _launch(*elastic, procs=2, rank=1, port=port,
                env=_env(REPRO_FAULTS="host_kill@epoch=1,rank=1"))])
    _ok([rank0, rank1])
    assert "FAULT_INJECTED: host_kill" in rank1[1]
    assert "HOST_LOST" in rank1[1] and (run / "lost_1").exists()
    assert "PEER_LOST" in rank0[1]
    assert "survivors = [0]" in rank0[1]
    assert "PAC_RESUME: step 0" in rank0[1]
    assert (run / "done_0").exists()

    # the oracles: a one-rank resume from a copy of the epoch-0
    # checkpoint, and the undisturbed one-process run
    copy = tmp_path / "copy"
    (copy / "ckpt").mkdir(parents=True)
    for ext in ("npz", "json"):
        shutil.copy(run / "ckpt" / f"ckpt_00000000.{ext}", copy / "ckpt")
    runs = _wait([
        _launch("--local-devices", "4", "--run-dir", str(copy), "--resume",
                "--out", str(tmp_path / "one_rank.npz")),
        _launch("--local-devices", "4", "--out",
                str(tmp_path / "undisturbed.npz"))])
    _ok(runs)
    assert "PAC_RESUME: step 0" in runs[0][1]
    _bitwise(tmp_path / "recovered.npz", tmp_path / "one_rank.npz")
    rec = np.load(tmp_path / "recovered.npz")
    org = np.load(tmp_path / "undisturbed.npz")
    assert sorted(rec.files) == sorted(k for k in org.files
                                       if k != "loss_1")
    for key in rec.files:
        want = org["loss_1" if key == "loss_0" else key]
        tol = 1e-3 if key.startswith("metric_") else TOL
        np.testing.assert_allclose(rec[key], want, rtol=tol, atol=tol,
                                   err_msg=key)


# ------------------------------------------------------ the speed-tig CLI

def _lines(out: str) -> dict:
    return {line.split(":", 1)[0]: line.split(":", 1)[1].strip()
            for line in out.splitlines() if ":" in line}


@pytest.mark.parametrize("shard_map", [False, True])
def test_speed_tig_cli_on_the_cpu(capsys, shard_map):
    """``--arch speed-tig`` at ``tiny``: the dataset and SEP lines as the
    JAX CLI prints them (the SEP line's timing aside), then PAC and the
    evaluation; ``--shard-map`` over a one-process gloo group."""
    argv = ["--arch", "speed-tig", "--dataset", "tiny", "--device", "cpu",
            "--epochs", "1"] + (["--shard-map"] if shard_map else [])
    cli.main(argv)
    got = _lines(capsys.readouterr().out)
    jg = jax_synthetic_tig("tiny", seed=0)
    jtr = jax_split(jg)[0]
    jpart = jax_sep_partition(jtr.src, jtr.dst, jtr.t, jg.num_nodes, 8,
                              k=0.05)
    assert got["dataset"] == f"{jg.stats()}"

    def untimed(line):
        return re.sub(r"elapsed_s=[^,)]*", "elapsed_s=", line)

    assert untimed(got["SEP"]) == untimed(f"{jax_partition_stats(jpart)}")
    assert re.fullmatch(r"derived speedup \d+\.\d\dx, edges/device "
                        r"\[[\d, ]+\], losses \[0\.\d+\]", got["PAC"])
    ev = eval(got["eval"], {"nan": float("nan")})  # noqa: S307 — own output
    assert 0.5 < ev["val_ap"] <= 1.0 and "node_auroc" in ev


@pytest.mark.parametrize("argv,exc,match", [
    (["--arch", "seamless-m4t-medium", "--reduced", "--device", "cpu"],
     ValueError, "not ported"),
    (["--arch", "speed-tig", "--device", "cpu", "--grid-layout",
      "sharded"], SystemExit, "2"),
    (["--arch", "speed-tig"], RuntimeError, "CUDA")])
def test_speed_tig_cli_refuses(monkeypatch, argv, exc, match):
    """The encoder-decoder's pretraining is not ported to ``train_lm``
    (its batches need frames), argparse rejects ``--grid-layout`` (the
    port's ``pac_train`` has no such option), and the default device is
    the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(exc, match=match):
        cli.main(argv)
