"""The native host core of the paged scheduler, loaded with ctypes.

Counterpart of ``long_context_attention_tpu/serving/native.py``.
``csrc/lca_host.cc`` holds the scheduler's host-side hot path, the page
free list and the prefix cache's content LRU with refcounts and admission
dry runs, behind a C ABI. This module builds it with ``g++`` at first use
into ``build/host/`` at the repository root (keyed by a hash of the source
and the flags; a temporary file, then an atomic rename, so parallel
builders race safely), loads it, and wraps it as drop-in replacements for
``serving.continuous._PageAllocator`` and
``serving.prefix_cache.PrefixPageAllocator``: the same methods, and the
same decisions bit for bit (page ids, hit counts, eviction order).

When ``g++`` is missing or the build fails, :func:`load` returns None and
the engines use the Python allocators (``native_runtime=None``), or raise
(``native_runtime=True``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

__all__ = ["load", "native_available", "library_path",
           "NativePageAllocator", "NativePrefixPageAllocator"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "lca_host.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_P32, _KEYS = ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p
# (restype, argtypes) of each C entry point
_SIGNATURES = {
    "lca_alloc_new": (_VP, [_I32, _I32]),
    "lca_alloc_free": (None, [_VP]),
    "lca_available": (_I64, [_VP, _I32]),
    "lca_take_basic": (_I32, [_VP, _I32, _I32, _P32]),
    "lca_take_extra": (_I32, [_VP, _I32, _I32, _P32]),
    "lca_release_pages": (_I32, [_VP, _I32, _P32, _I32]),
    "lca_lookup": (_I64, [_VP, _KEYS, _I32]),
    "lca_can_take": (_I32, [_VP, _I32, _KEYS, _I32, _I32]),
    "lca_release_row": (None, [_VP, _I32]),
    "lca_take_prefix": (_I64, [_VP, _I32, _KEYS, _I32, _I32, _P32]),
    "lca_register": (None, [_VP, _KEYS, _P32, _I32]),
    "lca_hit_pages": (_I64, [_VP]),
    "lca_evictions": (_I64, [_VP]),
}


def library_path() -> Path:
    """Where the built library lives: ``build/host/lca_host-<key>.so``, the
    key a hash of the source and the flags."""
    key = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lca_host-{key}.so"


def compile_to(out: Path) -> bool:
    """Compile ``csrc/lca_host.cc`` into ``out`` through a temporary file
    beside it and an atomic rename. False when g++ is missing or fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None when it cannot be
    built or loaded."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not compile_to(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            # a library built on another machine: build it here
            if not compile_to(so):
                return None
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                return None
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return _lib


def native_available() -> bool:
    return load() is not None


def _pack_keys(hashes: Sequence[bytes]) -> bytes:
    for h in hashes:
        if len(h) != 16:
            raise ValueError("prefix keys must be 16-byte digests")
    return b"".join(hashes)


def _pages(need: int):
    return (ctypes.c_int32 * max(need, 1))()


class _Handle:
    """Owns one C allocator object (freed with the wrapper)."""

    def __init__(self, pool_pages: int, prefix_mode: bool):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("the native host core is unavailable (the g++ "
                               "build of csrc/lca_host.cc failed)")
        self._h = self._lib.lca_alloc_new(pool_pages, int(prefix_mode))

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.lca_alloc_free(h)
            self._h = None


class NativePageAllocator(_Handle):
    """Drop-in for ``serving.continuous._PageAllocator`` (the free list,
    with the windowed rows' growth and release)."""

    def __init__(self, pool_pages: int):
        super().__init__(pool_pages, prefix_mode=False)

    def available(self, bi: int) -> int:
        return int(self._lib.lca_available(self._h, bi))

    def take(self, bi: int, need: int) -> List[int]:
        out = _pages(need)
        rc = self._lib.lca_take_basic(self._h, bi, need, out)
        assert rc == 0, (need, "pool exhausted")
        return list(out[:need])

    def take_extra(self, bi: int, need: int) -> List[int]:
        out = _pages(need)
        if self._lib.lca_take_extra(self._h, bi, need, out) != 0:
            raise RuntimeError(
                f"page pool exhausted: row {bi} needs {need} growth pages")
        return list(out[:need])

    def release_pages(self, bi: int, pages: List[int]) -> None:
        """Free given pages of a running row, in the given order; raises
        ValueError, with nothing freed, when any page is not the row's."""
        if not pages:
            return
        arr = (ctypes.c_int32 * len(pages))(*pages)
        if self._lib.lca_release_pages(self._h, bi, arr, len(pages)) != 0:
            raise ValueError(f"release_pages: a page not owned by row {bi} "
                             f"(double release?)")


class NativePrefixPageAllocator(_Handle):
    """Drop-in for ``serving.prefix_cache.PrefixPageAllocator``."""

    def __init__(self, pool_pages: int):
        super().__init__(pool_pages, prefix_mode=True)

    def lookup(self, hashes: Sequence[bytes]) -> int:
        return int(self._lib.lca_lookup(self._h, _pack_keys(hashes),
                                        len(hashes)))

    def can_take(self, bi: int, hashes: Sequence[bytes],
                 span_pages: int) -> bool:
        return bool(self._lib.lca_can_take(
            self._h, bi, _pack_keys(hashes), len(hashes), span_pages))

    def release_row(self, bi: int) -> None:
        self._lib.lca_release_row(self._h, bi)

    def take(self, bi: int, hashes: Sequence[bytes],
             span_pages: int) -> Tuple[List[int], int]:
        out = _pages(span_pages)
        hits = int(self._lib.lca_take_prefix(
            self._h, bi, _pack_keys(hashes), len(hashes), span_pages, out))
        assert hits >= 0, ("pool exhausted: no free or evictable pages "
                           "(the caller gates on can_take)")
        return list(out[:span_pages]), hits

    def register(self, hashes: Sequence[bytes],
                 pages: Sequence[int]) -> None:
        n = min(len(hashes), len(pages))
        arr = (ctypes.c_int32 * max(n, 1))(*pages[:n])
        self._lib.lca_register(self._h, _pack_keys(hashes[:n]), arr, n)

    @property
    def hit_pages(self) -> int:
        return int(self._lib.lca_hit_pages(self._h))

    @property
    def evictions(self) -> int:
        return int(self._lib.lca_evictions(self._h))
