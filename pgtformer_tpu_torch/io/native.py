"""ctypes bindings for the native video I/O shim (io/native/videoio.cc).

The library is built at first use with ``g++`` and ``pkg-config`` from the
port's own source into ``build/native/libvideoio.so`` at the root of the
checkout, and rebuilt while it is older than the source.  Each build
compiles to a name of its own and moves it into place with ``os.replace``,
so processes that build at once each load a whole library.  A missing
toolchain or missing libav headers raise `NativeVideoUnavailable` (with
the compiler's message); callers catch it and use the OpenCV path in
io/video.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "videoio.cc"
LIBRARY = Path(__file__).resolve().parents[2] / "build" / "native" / "libvideoio.so"
PKG_CONFIG_MODULES = ("libavformat", "libavcodec", "libavutil", "libswscale")


class NativeVideoUnavailable(RuntimeError):
    pass


_lib = None
_lock = threading.Lock()


def _stale() -> bool:
    return (not LIBRARY.exists()
            or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime)


def _run(cmd) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeVideoUnavailable(f"{cmd[0]}: {e}") from e
    if res.returncode != 0:
        raise NativeVideoUnavailable(
            f"{' '.join(cmd[:2])} failed (exit {res.returncode}):\n{res.stderr}")
    return res.stdout


def build() -> Path:
    """Compile videoio.cc into LIBRARY; raises NativeVideoUnavailable."""
    flags = _run(["pkg-config", "--cflags", "--libs", *PKG_CONFIG_MODULES]).split()
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"libvideoio.{os.getpid()}.{threading.get_ident()}.tmp.so")
    try:
        _run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17", str(SOURCE), "-o", str(tmp),
              *flags, "-lpthread"])
        os.replace(tmp, LIBRARY)
    finally:
        tmp.unlink(missing_ok=True)
    return LIBRARY


def load_library():
    """The loaded shim, built first if LIBRARY is missing or older than
    SOURCE; raises NativeVideoUnavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        try:
            lib = ctypes.CDLL(str(LIBRARY))
        except OSError as e:      # e.g. the libav runtime it was linked to is gone
            raise NativeVideoUnavailable(f"cannot load {LIBRARY}: {e}") from e
        lib.vr_open.restype = ctypes.c_void_p
        lib.vr_open.argtypes = [ctypes.c_char_p]
        lib.vr_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.POINTER(ctypes.c_int64)]
        lib.vr_read.restype = ctypes.c_int
        lib.vr_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.vr_close.argtypes = [ctypes.c_void_p]
        lib.vw_open.restype = ctypes.c_void_p
        lib.vw_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_double]
        lib.vw_open2.restype = ctypes.c_void_p
        lib.vw_open2.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_double, ctypes.c_char_p]
        lib.vw_write.restype = ctypes.c_int
        lib.vw_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.vw_write_yuv420.restype = ctypes.c_int
        lib.vw_write_yuv420.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint8)] * 3
        lib.vw_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeVideoReader:
    """Streaming RGB24 reader backed by the C++ decode thread."""

    def __init__(self, path: str):
        lib = load_library()
        self._lib = lib
        self._h = lib.vr_open(path.encode())
        if not self._h:
            raise IOError(f"native reader: cannot open {path}")
        w, h = ctypes.c_int(), ctypes.c_int()
        fps, n = ctypes.c_double(), ctypes.c_int64()
        lib.vr_info(self._h, ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps),
                    ctypes.byref(n))
        self.width, self.height = w.value, h.value
        self.fps = fps.value or 25.0
        self.frame_count = n.value

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            buf = np.empty((self.height, self.width, 3), np.uint8)
            if not self._lib.vr_read(self._h, _ptr(buf)):
                break
            yield buf

    def close(self):
        if self._h:
            self._lib.vr_close(self._h)
            self._h = None


class NativeVideoWriter:
    """codec: 'auto' (libx265 -> libx264 -> mpeg4), 'libx265' (the
    reference's output format: CRF 18, hvc1 tag), 'libx264', or 'mpeg4'; an
    optional ':preset=<name>' suffix (e.g. 'libx265:preset=superfast')
    overrides the encoder speed preset, and an optional trailing
    ':params=k=v,k=v' passes extra encoder private options (appended to
    x265-params for libx265, commas become ':').  An explicitly requested
    codec that the libav build lacks raises (no silent substitution)."""

    supports_yuv420 = True

    def __init__(self, path: str, fps: float, size_hw: Tuple[int, int],
                 codec: str = "auto"):
        lib = load_library()
        self._lib = lib
        h, w = size_hw
        self.width, self.height = w, h
        self._h = lib.vw_open2(path.encode(), w, h, float(fps), codec.encode())
        if not self._h:
            raise IOError(
                f"native writer: cannot open {path} with codec={codec!r} "
                "(an explicitly requested encoder that is unavailable fails "
                "rather than silently substituting another)")

    def write(self, rgb_frame: np.ndarray):
        f = np.ascontiguousarray(rgb_frame, np.uint8)
        if self._lib.vw_write(self._h, _ptr(f)) != 0:
            raise IOError("native writer: encode failed")

    def write_yuv420(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Pre-converted planes: y [H, W], u/v [H/2, W/2] uint8 (the device
        does the BT.601 conversion and 2x2 chroma subsampling; pipeline.py)."""
        y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
        if self._lib.vw_write_yuv420(self._h, _ptr(y), _ptr(u), _ptr(v)) != 0:
            raise IOError("native writer: yuv encode failed")

    def close(self):
        if self._h:
            self._lib.vw_close(self._h)
            self._h = None
