"""ctypes bindings for the native depth-IO library (counterpart of native/).

Builds `src/depthio.cpp` with g++ and zlib on first use (cached under
`_build/`); `available()` reports whether the shared library could be
produced, so callers can fall back to the pure-Python codec
(utils/pngio.py), and `build_error()` says why it could not.

    raw = read_png16("depth/000000.png")            # uint16 [H,W]
    for frame in prefetch_frames(paths, load_side, depth_scale): ...
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "depthio.cpp")
_SO = os.path.join(_DIR, "_build", "libdepthio.so")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> str | None:
    """Compile the library into a temporary name, then rename it into place
    (processes that build at once never load a half-written file). Returns
    the compiler's complaint, or None."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp, "-lz"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:   # no g++, too slow
        return str(e)
    if r.returncode != 0:
        return r.stderr[-2000:]
    os.replace(tmp, _SO)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        ):
            err = _build()
            if err is not None:
                _build_error = err
                return None
        lib = ctypes.CDLL(_SO)
        lib.dio_read_png16.restype = ctypes.c_int
        lib.dio_read_png16.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.dio_png_dims.restype = ctypes.c_int
        lib.dio_png_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.dio_loader_create.restype = ctypes.c_void_p
        lib.dio_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.dio_loader_next.restype = ctypes.c_int
        lib.dio_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.dio_loader_destroy.restype = None
        lib.dio_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def png_dims(path: str) -> tuple[int, int]:
    """(height, width) from a PNG's header."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native depthio unavailable: {_build_error}")
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    rc = lib.dio_png_dims(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"dio_png_dims({path}) -> {rc}")
    return h.value, w.value


def read_png16(path: str) -> np.ndarray:
    """Decode a grayscale PNG (8 or 16 bit) to uint16 [H,W]."""
    lib = _load()
    h, w = png_dims(path)
    out = np.empty((h, w), np.uint16)
    hh = ctypes.c_int32()
    ww = ctypes.c_int32()
    rc = lib.dio_read_png16(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.size, ctypes.byref(hh), ctypes.byref(ww),
    )
    if rc != 0:
        raise IOError(f"dio_read_png16({path}) -> {rc}")
    return out


class PrefetchLoader:
    """In-order frame stream decoded ahead by a C++ thread pool."""

    def __init__(self, paths: list[str], n_threads: int = 4, ahead: int = 8):
        self._handle = None
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native depthio unavailable: {_build_error}")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.dio_loader_create(
            arr, len(self._paths), n_threads, ahead
        )
        if not self._handle:
            raise RuntimeError("dio_loader_create failed")
        # the largest frame sizes the output buffer
        h = ctypes.c_int32()
        w = ctypes.c_int32()
        cap = 0
        for p in self._paths:
            if lib.dio_png_dims(p, ctypes.byref(h), ctypes.byref(w)) == 0:
                cap = max(cap, h.value * w.value)
        self._cap = max(cap, 1)

    def __iter__(self):
        h = ctypes.c_int32()
        w = ctypes.c_int32()
        buf = np.empty(self._cap, np.uint16)
        while True:
            rc = self._lib.dio_loader_next(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                buf.size, ctypes.byref(h), ctypes.byref(w),
            )
            if rc == 1:
                return
            if rc != 0:
                raise IOError(f"dio_loader_next -> {rc}")
            yield buf[: h.value * w.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._handle:
            self._lib.dio_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def prefetch_frames(depth_files: list[str], load_side, depth_scale: float):
    """RecordedFrames in order, their depths decoded ahead by the pool;
    `load_side(i)` gives frame i's (pose_gt, hand_base, hand_q, rgb)."""
    from ..datasets.sequence import RecordedFrame

    with PrefetchLoader(depth_files) as loader:
        for i, raw in enumerate(loader):
            pose_gt, hand_base, hand_q, rgb = load_side(i)
            yield RecordedFrame(
                depth=raw.astype(np.float32) * depth_scale,
                pose_gt=pose_gt, hand_base=hand_base, hand_q=hand_q, index=i,
                rgb=rgb,
            )
