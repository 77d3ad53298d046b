"""ctypes binding of the repo's native frame loader (``cpp/vos_loader.cc``),
port of ``e_osvos_tpu/data/native.py``: libjpeg/libpng decoding and a
threaded prefetch pool.

The shared library is built at first use with ``make -C cpp`` (g++ with
libjpeg and libpng). Where that fails, ``available()`` is False and the
callers decode with PIL: decoding is host work, and the two decode the
repo's synthetic JPEGs to the same bytes. A failed build is tried once a
process; ``error`` then says why.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CPP = os.path.join(_REPO, "cpp")
_SO = os.path.join(_CPP, "libvos_loader.so")

_lib: Optional[ctypes.CDLL] = None
error: Optional[str] = None  # why the library is unavailable

_INT_P = ctypes.POINTER(ctypes.c_int)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    decode_args = [ctypes.c_char_p, ctypes.c_void_p, _INT_P, _INT_P]
    for fn in (lib.vos_decode_jpeg, lib.vos_decode_png_indexed):
        fn.restype = ctypes.c_int
        fn.argtypes = decode_args
    lib.vos_loader_create.restype = ctypes.c_void_p
    lib.vos_loader_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.vos_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.vos_loader_submit_cap.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_long]
    lib.vos_loader_wait.restype = ctypes.c_int
    lib.vos_loader_wait.argtypes = [ctypes.c_void_p, ctypes.c_int, _INT_P,
                                    _INT_P]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, error
    if _lib is not None or error is not None:
        return _lib
    try:
        if not os.path.exists(_SO):
            subprocess.run(["make", "-C", _CPP], check=True,
                           capture_output=True, timeout=120)
        _lib = _bind(ctypes.CDLL(_SO))
    except subprocess.CalledProcessError as e:
        error = f"make -C cpp failed: {e.stderr.decode(errors='replace')[-500:]}"
    except (OSError, subprocess.SubprocessError) as e:
        error = f"{type(e).__name__}: {e}"
    return _lib


def available() -> bool:
    return _load() is not None


def _decode(kind: int, path: str, channels: Tuple[int, ...]) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    fn = lib.vos_decode_jpeg if kind == 0 else lib.vos_decode_png_indexed
    h, w = ctypes.c_int(), ctypes.c_int()
    if fn(path.encode(), None, ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"native probe failed for {path}")
    out = np.empty((h.value, w.value) + channels, np.uint8)
    rc = fn(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    return out


def decode_jpeg(path: str) -> np.ndarray:
    """JPEG → RGB uint8 [H,W,3] via libjpeg."""
    return _decode(0, path, (3,))


def decode_png_indexed(path: str) -> np.ndarray:
    """Indexed PNG → uint8 id map [H,W] via libpng (palette indices are the
    object ids)."""
    return _decode(1, path, ())


class PrefetchLoader:
    """Threaded native prefetcher: submit frame paths into slots, decode in
    the pool's threads, collect by slot.

    Buffers are preallocated per slot at ``max_hw``; a frame larger than its
    slot fails rather than overflowing, a smaller one comes back as a view
    of its true (h, w)."""

    def __init__(self, num_threads: int = 4, num_slots: int = 16,
                 max_hw: Tuple[int, int] = (1080, 1920)):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._handle = lib.vos_loader_create(num_threads, num_slots)
        self.num_slots = num_slots
        self._bufs = [np.empty(tuple(max_hw) + (3,), np.uint8)
                      for _ in range(num_slots)]
        self._kinds: List[int] = [0] * num_slots

    def submit(self, slot: int, path: str, kind: int = 0) -> None:
        """kind: 0 = JPEG RGB, 1 = indexed PNG (label)."""
        buf = self._bufs[slot]
        self._kinds[slot] = kind
        self._lib.vos_loader_submit_cap(
            self._handle, path.encode(), buf.ctypes.data_as(ctypes.c_void_p),
            kind, slot, buf.nbytes)

    def wait(self, slot: int) -> np.ndarray:
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.vos_loader_wait(self._handle, slot, ctypes.byref(h),
                                       ctypes.byref(w))
        if rc != 1:
            raise IOError(f"prefetch slot {slot} failed ({rc})")
        buf = self._bufs[slot]
        if self._kinds[slot] == 0:
            return buf[:h.value, :w.value]
        return buf.reshape(-1)[:h.value * w.value].reshape(h.value, w.value)

    def close(self) -> None:
        if self._handle:
            self._lib.vos_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
