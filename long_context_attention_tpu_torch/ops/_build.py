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

The sources are written for head dim 128. The serving and training paths'
six sources (B1 and B3, B6, both B7 kernels, B2a, B2b and B5) also build a
second library each with ``-DLCA_HEAD_DIM=64``, named ``"<source>:d64"``
(:func:`lib_name`): its entry points are kernels of their own,
``<name>_d64`` in :data:`KERNELS`, each with its own launch count.
:func:`kernel` picks an entry point's kernel by head dim and raises
``NotImplementedError`` naming the head dims it takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Kernel", "KERNELS", "QUANT_PASSES", "BUILD_DIR", "build_all",
           "build_seconds", "head_dims", "kernel", "launch_counts",
           "lib_name", "library", "reset_launch_counts", "ptr",
           "stream_ptr", "dims_array"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FEAT = [_VP, _VP, _VP, _F]  # csrc/sm90.cuh LCA_FEAT_ARGS

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_build_logs: Dict[str, str] = {}
_build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def lib_name(source: str, head_dim: int = 128) -> str:
    """The name of a source's library at a head dim: the source itself at
    128, ``"<source>:d<head_dim>"`` for the build with that head dim."""
    return source if head_dim == 128 else f"{source}:d{head_dim}"


def _split(lib: str):
    """(source, nvcc flags) of a library name."""
    source, _, dim = lib.partition(":d")
    return source, NVCC_FLAGS + ([f"-DLCA_HEAD_DIM={int(dim)}"] if dim
                                 else [])


def _lib_path(lib: str) -> Path:
    # the key covers the source, the headers it may include and the flags
    source, flags = _split(lib)
    src = b"".join(p.read_bytes() for p in
                   [CSRC / source, *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()[:12]
    tag = lib.partition(":")[2]  # "d64" for a head dim 64 build
    stem = Path(source).stem + (f"-{tag}" if tag else "")
    return BUILD_DIR / f"{stem}-{key}.so"


def _start_build(lib: str):
    """Start nvcc for one library; returns (Popen, tmp, final) or None when
    the library is already built."""
    out = _lib_path(lib)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    source, flags = _split(lib)
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish_build(source: str, job) -> None:
    if job is None:
        return
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    _build_seconds[source] = time.perf_counter() - t0
    _build_logs[source] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, out)


def build_all(sources: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Build libraries in parallel (one nvcc each, all started together):
    ``sources`` names them (:func:`lib_name`), by default every kernel's.
    Returns {library: compiler output} for the libraries built now
    (``-Xptxas -v`` prints each kernel's registers and shared memory)."""
    sources = list(sources or sorted({k.lib for k in KERNELS.values()}))
    with _lock:
        jobs = [(s, _start_build(s)) for s in sources]
        # each compiler's output drained in its own thread, so a build's
        # seconds end when its nvcc does
        with ThreadPoolExecutor(max(len(jobs), 1)) as pool:
            done = [pool.submit(_finish_build, s, job) for s, job in jobs]
        for f in done:
            f.result()  # a failed build raises here
    return {s: _build_logs.get(s, "") for s in sources}


def build_seconds() -> Dict[str, float]:
    """Wall seconds of each library's nvcc run in this process."""
    return dict(_build_seconds)


def library(source: str, head_dim: int = 128) -> ctypes.CDLL:
    """The loaded library of one ``csrc`` source at a head dim (built on
    first use), for its entry points other than kernels."""
    return _load(lib_name(source, head_dim))


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
                 argtypes: List, replaces: str, head_dim: int = 128):
        # replaces: file:line of the TPU kernel this one ports (of the
        # JAX function, for the QUANT_PASSES)
        self.name = name
        self.source = source
        self.head_dim = head_dim
        self.lib = lib_name(source, head_dim)
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def function(self):
        if self._fn is None:
            lib = _load(self.lib)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = _I
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        err = self.function()(*args)
        if err != 0:
            msg = _load(self.lib).lca_error_string(err).decode()
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
        "flash_fwd_static", "flash_fwd_sm90.cu", "lca_flash_fwd_static",
        [_VP] * 6 + [_F, _F, _F, _I, _VP],
        "long_context_attention_tpu/ops/flash.py:475"),
    # B3, B2a and B2b take the features' operands last: q segment ids, kv
    # segment ids, ALiBi slopes (null when off) and the dropout's 1 / (1 - p)
    "flash_fwd_pos": Kernel(
        "flash_fwd_pos", "flash_fwd_sm90.cu", "lca_flash_fwd_pos",
        [_VP] * 8 + [_F, _F, _F, _I, _VP] + _FEAT,
        "long_context_attention_tpu/ops/flash.py:696"),
    # the sage entries share one C signature: q8, qs, k8, ks, v8, vs, out,
    # lse, the pv_int8 table (null for the bf16 PV), dims, stream; each
    # kernel's _pv8 entry is its pv_int8 form (the int8 PV product). B8c is
    # B8b's kernel over a maskless descriptor.
    "sage_fwd_tri": Kernel(
        "sage_fwd_tri", "sage_fwd_sm90.cu", "lca_sage_fwd_tri", [_VP] * 11,
        "long_context_attention_tpu/ops/sage.py:186"),
    "sage_fwd_tri_pv8": Kernel(
        "sage_fwd_tri_pv8", "sage_fwd_sm90.cu", "lca_sage_fwd_tri_pv8",
        [_VP] * 11,
        "long_context_attention_tpu/ops/sage.py:186"),
    "sage_fwd_pos": Kernel(
        "sage_fwd_pos", "sage_fwd_sm90.cu", "lca_sage_fwd_pos", [_VP] * 11,
        "long_context_attention_tpu/ops/sage.py:246"),
    "sage_fwd_pos_pv8": Kernel(
        "sage_fwd_pos_pv8", "sage_fwd_sm90.cu", "lca_sage_fwd_pos_pv8",
        [_VP] * 11,
        "long_context_attention_tpu/ops/sage.py:246"),
    "sage_fwd_rect": Kernel(
        "sage_fwd_rect", "sage_fwd_sm90.cu", "lca_sage_fwd_rect", [_VP] * 11,
        "long_context_attention_tpu/ops/sage.py:223"),
    "sage_fwd_rect_pv8": Kernel(
        "sage_fwd_rect_pv8", "sage_fwd_sm90.cu", "lca_sage_fwd_rect_pv8",
        [_VP] * 11,
        "long_context_attention_tpu/ops/sage.py:223"),
    # sage's quantization pass, the port's counterpart of an XLA fusion (no
    # Pallas kernel): ``replaces`` names the JAX quantizer it computes.
    # k, v, k_mean, k8, ks, v8, vs, dims, stream
    "sage_quant_kv": Kernel(
        "sage_quant_kv", "sage_quant.cu", "lca_sage_quant_kv", [_VP] * 9,
        "long_context_attention_tpu/ops/sage.py:92"),
    # q, k_mean, q8, qs, shift, dims, qfold, scale, stream
    "sage_quant_q": Kernel(
        "sage_quant_q", "sage_quant.cu", "lca_sage_quant_q",
        [_VP] * 6 + [_F, _F, _VP],
        "long_context_attention_tpu/ops/sage.py:83"),
    # the backward entries share one C signature: q, k, v, dout, lse, delta,
    # dq, dk, dv (null where unused), dims, scale, softcap, stream. B2a runs
    # on the dq pipeline of B9b, B2b and B5 on one wgmma/TMA pipeline
    "flash_bwd_dq": Kernel(
        "flash_bwd_dq", "flash_dq_sm90.cu", "lca_flash_bwd_dq",
        [_VP] * 10 + [_F, _F, _VP] + _FEAT,
        "long_context_attention_tpu/ops/flash.py:1089"),
    # (B2b also takes a multi-chunk descriptor's kv tile order, after the
    # stream)
    "flash_bwd_dkv": Kernel(
        "flash_bwd_dkv", "flash_bwd_sm90.cu", "lca_flash_bwd_dkv",
        [_VP] * 10 + [_F, _F, _VP, _VP] + _FEAT,
        "long_context_attention_tpu/ops/flash.py:1174"),
    "flash_bwd_fused": Kernel(
        "flash_bwd_fused", "flash_bwd_sm90.cu", "lca_flash_bwd_fused",
        [_VP] * 10 + [_F, _F, _VP],
        "long_context_attention_tpu/ops/flash.py:1291"),
    # the sparse entries share one C signature: q, k, v, dout, lse, delta,
    # two outputs (B9a: out and lse; B9b: dq and null; B9c: dk and dv), the
    # CSR walk (ptr, entries), the items, the blocks' schedule (ptr, work),
    # dims, then the floats (B9a, B9b: qfold, scale; B9c: scale), stream.
    # B9a runs on the forward pipeline of B1 and B3, B9b on the dq pipeline,
    # B9c on B2b's pipeline.
    "sparse_fwd": Kernel(
        "sparse_fwd", "flash_fwd_sm90.cu", "lca_sparse_fwd",
        [_VP] * 14 + [_F, _F, _VP],
        "long_context_attention_tpu/ops/sparse.py:314"),
    "sparse_bwd_dq": Kernel(
        "sparse_bwd_dq", "flash_dq_sm90.cu", "lca_sparse_bwd_dq",
        [_VP] * 14 + [_F, _F, _VP],
        "long_context_attention_tpu/ops/sparse.py:469"),
    "sparse_bwd_dkv": Kernel(
        "sparse_bwd_dkv", "flash_bwd_sm90.cu", "lca_sparse_bwd_dkv",
        [_VP] * 14 + [_F, _VP],
        "long_context_attention_tpu/ops/sparse.py:516"),
    # B6 takes one int64 argument array (csrc/cache_append.cu Arg: the
    # kind, the cache's and the new rows' pointers, strides and shapes;
    # ops/decode.py fills it) and the stream
    "cache_append": Kernel(
        "cache_append", "cache_append.cu", "lca_cache_append",
        [_VP, _VP],
        "long_context_attention_tpu/ops/decode.py:40"),
    # q, q scales, k, v, scales (2), lengths, page table (or null), the
    # split partials (2), out, lse, dims, then scale, softcap, safe, stream,
    # the ALiBi row slopes and a sequence-sharded cache's first columns and
    # sink ends (each or null)
    "decode_attention": Kernel(
        "decode_attention", "decode_attention.cu", "lca_decode_attention",
        [_VP] * 13 + [_F, _F, _I, _VP, _VP, _VP, _VP],
        "long_context_attention_tpu/ops/decode.py:296"),
    # B7's multi-token form (decode_attention_core routes a call by shape,
    # decode_route): the runs of more than 8 query rows per kv head on
    # wgmma, with decode_attention's C signature
    "decode_run": Kernel(
        "decode_run", "decode_run_sm90.cu", "lca_decode_run",
        [_VP] * 13 + [_F, _F, _I, _VP, _VP, _VP, _VP],
        "long_context_attention_tpu/ops/decode.py:296"),
}


# the entry points built at head dim 64 too (the serving path's: B1, B3,
# B6 and both B7 kernels; the training path's: B2a, B2b and B5), as kernels
# of their own named <name>_d64
HEAD_DIM_64 = ("flash_fwd_causal_self", "flash_fwd_pos", "cache_append",
               "decode_attention", "decode_run", "flash_bwd_dq",
               "flash_bwd_dkv", "flash_bwd_fused")
for _name in HEAD_DIM_64:
    _k = KERNELS[_name]
    KERNELS[f"{_name}_d64"] = Kernel(f"{_name}_d64", _k.source, _k.symbol,
                                     _k.argtypes, _k.replaces, head_dim=64)

# kernels that port no Pallas kernel but an XLA fusion of the JAX package
QUANT_PASSES = ("sage_quant_kv", "sage_quant_q")


def head_dims(name: str) -> Tuple[int, ...]:
    """The head dims entry point ``name`` has a kernel for."""
    return (64, 128) if name in HEAD_DIM_64 else (128,)


def kernel(name: str, head_dim: int, what: Optional[str] = None) -> Kernel:
    """Entry point ``name``'s kernel at ``head_dim``; raises
    ``NotImplementedError`` naming the head dims it takes (``what``: the
    kernel's name in the message, by default ``name``)."""
    dims = head_dims(name)
    if head_dim not in dims:
        raise NotImplementedError(
            f"the {what or name} kernel takes head_dim "
            f"{' or '.join(map(str, dims))}, got d={head_dim}")
    return KERNELS[name if head_dim == 128 else f"{name}_d{head_dim}"]

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
