"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file compiles on its own with ``nvcc`` into a shared
library with a plain C interface, which ``ctypes`` loads. Every exported
launcher takes raw device pointers and PyTorch's current stream as
``void*`` and returns ``cudaGetLastError()``; ``Kernel.__call__`` raises if
that is not 0 and counts the launch.

The libraries are built at first use into ``kernels/build/`` (ignored by
git), named by a hash of their sources and flags, so an edited source
rebuilds and an unchanged one loads at once. ``build_all`` starts one
``nvcc`` per source, all at the same time. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["Kernel", "KERNELS", "build_all", "library_path", "SOURCES"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("neighbor_sample.cu", "fused_flush.cu", "temporal_attn.cu",
           "rwkv6_scan.cu", "fused_gru.cu", "flash_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def library_path(source: str) -> Path:
    """Where the library of ``source`` is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source started
    together. Returns ``{source: compiler log}`` for the sources built now
    (``-Xptxas=-v`` prints registers, shared memory and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in SOURCES:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        jobs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     tmp, out)
    logs, failed = {}, []
    for src, (proc, tmp, out) in jobs.items():
        logs[src] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{src}:\n{logs[src]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.cache
def _library(source: str) -> ctypes.CDLL:
    path = library_path(source)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


@dataclasses.dataclass
class Kernel:
    """One exported CUDA launcher and its launch count.

    ``argtypes`` lists the ctypes of the launcher's arguments, stream last;
    pointers and the stream are ``c_void_p`` (a plain int would be cut to
    32 bits)."""

    name: str
    source: str
    symbol: str
    argtypes: tuple
    launches: int = 0
    _fn: object = dataclasses.field(default=None, init=False, repr=False)

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = _library(self.source).error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


P, I = ctypes.c_void_p, ctypes.c_int

KERNELS: dict[str, Kernel] = {k.name: k for k in (
    # indptr nbr t eidx bat nodes src dst neg valid b batch_of(ptr, step,
    # int) window(ptr, step, int) rows k ids_out t_out e_out stream
    Kernel("neighbor_sample", "neighbor_sample.cu", "neighbor_sample",
           (P, P, P, P, P, P, P, P, P, P, I, P, I, I, P, I, I, I, I, P, P, P,
            P)),
    # ids msg ts mem last (both updated in place) wx wh bx bh rows dm d
    # n_dump mbar h_g orow stream
    Kernel("fused_flush", "fused_flush.cu", "fused_flush",
           (P, P, P, P, P, P, P, P, P, I, I, I, I, P, P, P, P)),
    # q k v mask rows heads kn dh out stream
    Kernel("temporal_attn", "temporal_attn.cu", "temporal_attn_fwd",
           (P, P, P, P, I, I, I, I, P, P)),
    # g q k v mask rows heads kn dh dq dk dv stream
    Kernel("temporal_attn_bwd", "temporal_attn.cu", "temporal_attn_bwd",
           (P, P, P, P, P, I, I, I, I, P, P, P, P)),
    # r k v w u s0 batch heads seq in_bf16 out_bf16 o s_out stream
    Kernel("rwkv6", "rwkv6_scan.cu", "rwkv6_wkv",
           (P, P, P, P, P, P, I, I, I, I, I, P, P, P)),
    # r k v w u s0 batch heads seq in_bf16 out_bf16 o s_out stream
    Kernel("rwkv6_seq", "rwkv6_scan.cu", "rwkv6_wkv_seq",
           (P, P, P, P, P, P, I, I, I, I, I, P, P, P)),
    # x h wx wh bx bh rows d_in d_h out stream
    Kernel("fused_gru", "fused_gru.cu", "fused_gru_fwd",
           (P, P, P, P, P, P, I, I, I, P, P)),
    # g x h wx wh bx bh rows d_in d_h dgx dgh dx dh dwx dwh dbx dbh stream
    Kernel("fused_gru_bwd", "fused_gru.cu", "fused_gru_bwd",
           (P, P, P, P, P, P, P, I, I, I, P, P, P, P, P, P, P, P, P)),
    # q k v batch seq heads kv_heads head_dim causal window is_bf16 o stream
    Kernel("flash_attention", "flash_attention.cu", "flash_attention_fwd",
           (P, P, P, I, I, I, I, I, I, I, I, P, P)),
)}
