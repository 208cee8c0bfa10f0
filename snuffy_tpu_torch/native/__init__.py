"""ctypes binding of the pyramidal TIFF slide reader (`slide_reader.cpp`).

The port's copy of the reader in `snuffy_tpu/native`. It is host code (no
kernel): g++ builds it with libtiff at first use into
`build/snuffy_tpu_torch/libslide_reader-<hash>.so` at the repository root,
never beside the source. Callers check `available()`, which is false when
the compiler or libtiff is missing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "slide_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "snuffy_tpu_torch"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17",
             "-I/usr/include/x86_64-linux-gnu")


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """Build (first use) and bind the reader; None when it cannot build."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"libslide_reader-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), "-ltiff"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    p, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.slide_open.restype = p
    lib.slide_open.argtypes = [ctypes.c_char_p]
    lib.slide_level_count.restype = i
    lib.slide_level_count.argtypes = [p]
    lib.slide_level_dimensions.restype = None
    lib.slide_level_dimensions.argtypes = [
        p, i, ctypes.POINTER(u32), ctypes.POINTER(u32)]
    lib.slide_level_downsample.restype = ctypes.c_double
    lib.slide_level_downsample.argtypes = [p, i]
    lib.slide_read_region.restype = i
    lib.slide_read_region.argtypes = [
        p, i, u32, u32, u32, u32, ctypes.POINTER(ctypes.c_uint8)]
    lib.slide_close.restype = None
    lib.slide_close.argtypes = [p]
    return lib


def available() -> bool:
    return get_lib() is not None


class NativeSlide:
    """Pyramidal TIFF reader: level_count, level_dimensions,
    level_downsample and RGB read_region, as the tiler needs them."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native slide reader unavailable")
        self._lib = lib
        self._h = lib.slide_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open slide {path}")

    @property
    def level_count(self) -> int:
        return self._lib.slide_level_count(self._h)

    def _check_level(self, level: int) -> None:
        if not 0 <= level < self.level_count:
            raise IndexError(f"level {level} of {self.level_count}")

    def level_dimensions(self, level: int) -> Tuple[int, int]:
        self._check_level(level)
        w, h = ctypes.c_uint32(), ctypes.c_uint32()
        self._lib.slide_level_dimensions(self._h, level, ctypes.byref(w),
                                         ctypes.byref(h))
        return int(w.value), int(h.value)

    def level_downsample(self, level: int) -> float:
        self._check_level(level)
        return float(self._lib.slide_level_downsample(self._h, level))

    def read_region(self, level: int, x: int, y: int, w: int, h: int
                    ) -> np.ndarray:
        self._check_level(level)
        out = np.zeros((h, w, 3), np.uint8)
        rc = self._lib.slide_read_region(
            self._h, level, x, y, w, h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise IOError(f"slide_read_region failed rc={rc}")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.slide_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
