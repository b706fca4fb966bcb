"""Python binding for the native IO runtime (native/io_runtime.cpp) via
ctypes, with a pure-python thread fallback.

Usage:
    with FramePrefetcher(seq.image_paths, width, height) as pf:
        for idx, img in pf:            # img: float32 (H, W) numpy
            ...
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import tempfile
import threading

import numpy as np

_LIB = None
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def _load_native():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = os.path.abspath(os.path.join(_NATIVE_DIR, "libgfslam_io.so"))
    if not os.path.exists(so):
        # Build under a private name and rename it into place, so processes
        # that build at once never load a half-written library.
        build = os.path.join(_NATIVE_DIR, "build.sh")
        tmp = None
        try:
            fd, tmp = tempfile.mkstemp(prefix=".libgfslam_io.", suffix=".so",
                                       dir=os.path.dirname(so))
            os.close(fd)
            subprocess.run(["sh", build, tmp], check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.io_decode_gray.restype = ctypes.c_int
    lib.io_decode_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.io_prefetcher_create.restype = ctypes.c_void_p
    lib.io_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.io_prefetcher_next.restype = ctypes.c_int
    lib.io_prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.io_prefetcher_destroy.restype = None
    lib.io_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load_native() is not None


def decode_gray(path: str) -> np.ndarray | None:
    """One-shot native decode; None if native lib unavailable or failed."""
    lib = _load_native()
    if lib is None:
        return None
    cap = 8192 * 8192
    buf = np.empty(cap, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.io_decode_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap, ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        return None
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class FramePrefetcher:
    """Ordered multi-threaded frame prefetch; native C++ when available."""

    def __init__(self, paths: list[str], width: int, height: int,
                 queue_depth: int = 8, n_threads: int = 2):
        self.paths = paths
        self.width = width
        self.height = height
        self.queue_depth = queue_depth
        self.n_threads = n_threads
        self._lib = _load_native()
        self._handle = None
        self._py_queue: queue.Queue | None = None
        self._py_thread = None

    def __enter__(self):
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._paths_keepalive = arr
            self._handle = self._lib.io_prefetcher_create(
                arr, len(self.paths), self.width, self.height,
                self.queue_depth, self.n_threads,
            )
        else:
            self._py_queue = queue.Queue(maxsize=self.queue_depth)

            def worker():
                for i, p in enumerate(self.paths):
                    try:
                        import cv2

                        img = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32)
                    except Exception:
                        img = None
                    self._py_queue.put((i, img))
                self._py_queue.put((-1, None))

            self._py_thread = threading.Thread(target=worker, daemon=True)
            self._py_thread.start()
        return self

    def __iter__(self):
        if self._handle is not None:
            buf = np.empty(self.height * self.width, np.float32)
            ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            while True:
                rc = self._lib.io_prefetcher_next(self._handle, ptr)
                if rc == -1:
                    return
                if rc < -1:
                    raise IOError(f"failed to decode frame {-(rc + 2)}")
                yield rc, buf.reshape(self.height, self.width).copy()
        else:
            while True:
                i, img = self._py_queue.get()
                if i < 0:
                    return
                yield i, img

    def __exit__(self, *exc):
        if self._handle is not None:
            self._lib.io_prefetcher_destroy(self._handle)
            self._handle = None
        return False
