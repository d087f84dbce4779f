"""Build and bind the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), is
loaded with ctypes, and is called with pointers and the current CUDA stream
as ``c_void_p``. Every C entry point returns ``cudaGetLastError()`` after its
launch; :class:`Kernel` raises when that is not 0 and otherwise counts the
launch. Nothing is built or loaded at import time: the first launch builds
its source (or :func:`build_all` builds every source in parallel), into
``build/kernels/`` at the repository root, keyed by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["Kernel", "KERNELS", "BUILD_DIR", "build_all", "launch_counts",
           "library", "reset_launch_counts", "ptr", "stream_ptr",
           "dims_array"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(source: str) -> Path:
    # the key covers the source, the headers it may include and the flags
    src = b"".join(p.read_bytes() for p in
                   [CSRC / source, *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{key}.so"


def _start_build(source: str):
    """Start nvcc for one source; returns (Popen, tmp, final) or None when
    the library is already built."""
    out = _lib_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(source: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    _build_logs[source] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, out)


def build_all(sources: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Build every kernel source in parallel (one nvcc each, all started
    together). Returns {source: compiler output} for the sources built now
    (``-Xptxas -v`` prints each kernel's registers and shared memory)."""
    sources = list(sources or sorted({k.source for k in KERNELS.values()}))
    with _lock:
        jobs = [(s, _start_build(s)) for s in sources]
        for s, job in jobs:
            _finish_build(s, job)
    return {s: _build_logs.get(s, "") for s in sources}


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one ``csrc`` source (built on first use), for
    its entry points other than kernels."""
    return _load(source)


def _load(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            _finish_build(source, _start_build(source))
            lib = ctypes.CDLL(str(_lib_path(source)))
            lib.lca_error_string.argtypes = [_I]
            lib.lca_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


class Kernel:
    """One C entry point of a ``csrc`` source, with its launch count.

    ``launches`` is a plain integer that goes up by one for every launch the
    entry point reports as successful; nothing else changes it except
    :func:`reset_launch_counts`."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: List, replaces: str):
        # replaces: file:line of the TPU kernel this one ports
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def function(self):
        if self._fn is None:
            lib = _load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = _I
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        err = self.function()(*args)
        if err != 0:
            msg = _load(self.source).lca_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed with error "
                               f"{err} ({msg})")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {
    "flash_fwd_causal_self": Kernel(
        "flash_fwd_causal_self", "flash_fwd_sm90.cu",
        "lca_flash_fwd_causal_self",
        [_VP, _VP, _VP, _VP, _VP, _VP, _F, _F, _I, _VP],
        "long_context_attention_tpu/ops/flash.py:338"),
    "flash_fwd_static": Kernel(
        "flash_fwd_static", "flash_fwd.cu", "lca_flash_fwd_static",
        [_VP] * 6 + [_F, _F, _F, _I, _VP],
        "long_context_attention_tpu/ops/flash.py:475"),
    "flash_fwd_pos": Kernel(
        "flash_fwd_pos", "flash_fwd_sm90.cu", "lca_flash_fwd_pos",
        [_VP] * 8 + [_F, _F, _F, _I, _VP],
        "long_context_attention_tpu/ops/flash.py:696"),
    # the sage entries share one C signature: q8, qs, k8, ks, v8, vs, out,
    # lse, dims, stream
    "sage_fwd_tri": Kernel(
        "sage_fwd_tri", "flash_fwd.cu", "lca_sage_fwd_tri", [_VP] * 10,
        "long_context_attention_tpu/ops/sage.py:186"),
    "sage_fwd_pos": Kernel(
        "sage_fwd_pos", "flash_fwd.cu", "lca_sage_fwd_pos", [_VP] * 10,
        "long_context_attention_tpu/ops/sage.py:246"),
    "sage_fwd_rect": Kernel(
        "sage_fwd_rect", "flash_fwd.cu", "lca_sage_fwd_rect", [_VP] * 10,
        "long_context_attention_tpu/ops/sage.py:223"),
    # the backward entries share one C signature: q, k, v, dout, lse, delta,
    # dq, dk, dv (null where unused), dims, scale, stream
    "flash_bwd_dq": Kernel(
        "flash_bwd_dq", "flash_bwd.cu", "lca_flash_bwd_dq",
        [_VP] * 10 + [_F, _VP],
        "long_context_attention_tpu/ops/flash.py:1089"),
    "flash_bwd_dkv": Kernel(
        "flash_bwd_dkv", "flash_bwd_sm90.cu", "lca_flash_bwd_dkv",
        [_VP] * 10 + [_F, _VP],
        "long_context_attention_tpu/ops/flash.py:1174"),
    "flash_bwd_fused": Kernel(
        "flash_bwd_fused", "flash_bwd_sm90.cu", "lca_flash_bwd_fused",
        [_VP] * 10 + [_F, _VP],
        "long_context_attention_tpu/ops/flash.py:1291"),
    # the sparse entries share one C signature: q, k, v, dout, lse, delta,
    # out (B9b: dq), out_lse, dk, dv (null where unused), the CSR walk
    # (ptr, entries), dims, qfold, scale, stream
    "sparse_fwd": Kernel(
        "sparse_fwd", "sparse.cu", "lca_sparse_fwd",
        [_VP] * 13 + [_F, _F, _VP],
        "long_context_attention_tpu/ops/sparse.py:314"),
    "sparse_bwd_dq": Kernel(
        "sparse_bwd_dq", "sparse.cu", "lca_sparse_bwd_dq",
        [_VP] * 13 + [_F, _F, _VP],
        "long_context_attention_tpu/ops/sparse.py:469"),
    "sparse_bwd_dkv": Kernel(
        "sparse_bwd_dkv", "sparse.cu", "lca_sparse_bwd_dkv",
        [_VP] * 13 + [_F, _F, _VP],
        "long_context_attention_tpu/ops/sparse.py:516"),
    "cache_append": Kernel(
        "cache_append", "cache_append.cu", "lca_cache_append",
        [_VP] * 11,
        "long_context_attention_tpu/ops/decode.py:40"),
    "decode_attention": Kernel(
        "decode_attention", "decode_attention.cu", "lca_decode_attention",
        [_VP] * 12 + [_F, _F, _I, _VP],
        "long_context_attention_tpu/ops/decode.py:296"),
}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def ptr(t) -> Optional[int]:
    """A tensor's device address for ctypes (None for an absent operand)."""
    return None if t is None else t.data_ptr()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def dims_array(values: Sequence[int]):
    """Host int64 array of shapes, strides and flags for a C entry point."""
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])
