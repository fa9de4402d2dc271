"""ctypes bridge to the port's native TUM frame loader (`csrc/tum_loader.cpp`).

A copy of `supersurfel_fusion_tpu/io/native_loader.py` for the port's own
loader source, which inflates PNG data itself and so needs no compression
library: g++ builds it, linking only pthread, into the port's git-ignored
`_build/` directory, keyed by the source and flags' hash. It exposes:

* `decode_pair`: synchronous PNG pair decode (drop-in for the PIL path);
* `PrefetchingLoader`: a background thread pool decoding frames ahead of
  the SLAM loop, so host PNG decoding overlaps the device's work. Each
  frame is handed out once: asking again for a frame already served
  raises IOError.

Without a C++ compiler the build raises ImportError, and the runner falls
back to decoding with PIL (`io/tum.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tum_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
LIBS = ["-lpthread"]

_lib = None


def build_command(cxx: str, out: str) -> List[str]:
    """The compiler's argument list that builds the loader into `out`."""
    return [cxx, *CXX_FLAGS, "-o", out, str(SOURCE), *LIBS]


def build_library() -> Path:
    """Compile the loader into `_build/` unless the library for this source
    and these flags exists (written to a temporary name, then renamed)."""
    if not SOURCE.exists():
        raise ImportError(f"native loader source missing: {SOURCE}")
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise ImportError("no C++ compiler (g++) for the native loader")
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()
    out = BUILD_DIR / f"libtum_loader_{key[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".libtum_",
                               suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(build_command(cxx, tmp), capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise ImportError(f"native loader build failed: {proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.tum_decode_pair.restype = ctypes.c_int
    lib.tum_decode_pair.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.tum_prefetcher_create.restype = ctypes.c_void_p
    lib.tum_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.tum_prefetcher_get.restype = ctypes.c_int
    lib.tum_prefetcher_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.tum_prefetcher_destroy.restype = None
    lib.tum_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def decode_pair(rgb_path: str, depth_path: str, width: int = 640,
                height: int = 480) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one (rgb, depth16) PNG pair natively."""
    lib = _load()
    rgb = np.empty((height, width, 3), np.uint8)
    depth = np.empty((height, width), np.uint16)
    ok = lib.tum_decode_pair(
        rgb_path.encode(), depth_path.encode(),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        width, height,
    )
    if not ok:
        raise IOError(f"native decode failed: {rgb_path} / {depth_path}")
    return rgb, depth


class PrefetchingLoader:
    """Decode-ahead loader over associated (rgb, depth) file pairs."""

    def __init__(self, pairs: List[Tuple[str, str]], width: int = 640,
                 height: int = 480, n_threads: int = 3, lookahead: int = 8):
        self._lib = _load()
        self.width, self.height = width, height
        self.n = len(pairs)
        self._rgb_paths = [p[0].encode() for p in pairs]
        self._depth_paths = [p[1].encode() for p in pairs]
        rgb_arr = (ctypes.c_char_p * self.n)(*self._rgb_paths)
        dep_arr = (ctypes.c_char_p * self.n)(*self._depth_paths)
        self._handle = self._lib.tum_prefetcher_create(
            rgb_arr, dep_arr, self.n, n_threads, lookahead
        )

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        depth = np.empty((self.height, self.width), np.uint16)
        ok = self._lib.tum_prefetcher_get(
            self._handle, idx,
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            self.width, self.height,
        )
        if ok < 0:
            raise IOError(f"frame {idx} is out of range or was already "
                          f"served (each frame is handed out once)")
        if not ok:
            raise IOError(f"native prefetch failed at frame {idx}")
        return rgb, depth

    def close(self):
        if self._handle:
            self._lib.tum_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
