"""ctypes binding of the slide reader and JPEG codec (`slide_reader.cpp`).

The port's copy of the slide half of `snuffy_tpu/native`, with the same
names and return shapes: `NativeSlide` (levels, `spacing_um`,
`read_region`, the grid block reads `read_grid` and `read_grid_scaled`,
`scaled_grid_ok`, and a mask's label plane: `read_label_region`,
`page_spacing_um`), `write_tiled_tiff` and `write_tiled_tiff_gray`, plus
`write_jpeg`, `decode_jpeg`, `edge_energy` and the bag loaders' CSV
parser `parse_bag_csv_fast`.
It is host code (no kernel): g++ builds it at first use into
`build/snuffy_tpu_torch/libslide_reader-<hash>.so` at the repository
root, never beside the source; the hash covers the source, its header,
the flags and the libraries it links.

It links libtiff (`.so.6`) and libjpeg (ABI 62, `.so.62`) and includes
neither header: `codec_abi.h` declares what it calls. The libraries are
the system's when the dynamic loader finds them by soname, else the
copies a Pillow wheel bundles in `pillow.libs/` on `sys.path` (linked by
path, with that directory as the run path; Pillow itself is never
imported). A build or a library that fails raises RuntimeError with the
reason; `available()` says whether the build works.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "slide_reader.cpp"
HEADER = SOURCE.with_name("codec_abi.h")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "snuffy_tpu_torch"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
SONAMES = ("libtiff.so.6", "libjpeg.so.62")


def bundled_codec_libraries() -> Optional[List[str]]:
    """g++ arguments that link the libtiff.so.6 and libjpeg.so.62 of the
    first `pillow.libs` on sys.path that holds both, or None. The run path
    goes in as DT_RPATH, which the loader also applies to those libraries'
    own bundled dependencies (libzstd, liblzma, ...)."""
    for entry in sys.path:
        libs = os.path.join(entry or ".", "pillow.libs")
        found = [sorted(glob.glob(os.path.join(libs, pattern)))
                 for pattern in ("libtiff-*.so.6*", "libjpeg-*.so.62*")]
        if all(found):
            return [f"-L{libs}", f"-Wl,-rpath,{libs}",
                    "-Wl,--disable-new-dtags",
                    *(f"-l:{os.path.basename(f[0])}" for f in found)]
    return None


def find_codec_libraries() -> List[str]:
    """g++ arguments that link libtiff.so.6 and libjpeg.so.62: by soname
    when the loader finds both, else Pillow's bundled copies. Raises
    RuntimeError when neither has them."""
    try:
        for soname in SONAMES:
            ctypes.CDLL(soname)
        return [f"-l:{soname}" for soname in SONAMES]
    except OSError:
        pass
    bundled = bundled_codec_libraries()
    if bundled is None:
        raise RuntimeError(
            f"no {' and '.join(SONAMES)}: the dynamic loader does not find "
            "them and no pillow.libs on sys.path holds them")
    return bundled


@functools.lru_cache(maxsize=None)
def build(libs: Optional[Tuple[str, ...]] = None
          ) -> Tuple[Optional[ctypes.CDLL], str]:
    """(library, "") or (None, why it failed), linked with `libs` (g++
    arguments; default `find_codec_libraries()`); once a process."""
    if libs is None:
        try:
            libs = tuple(find_codec_libraries())
        except RuntimeError as e:
            return None, str(e)
    digest = hashlib.sha256(
        SOURCE.read_bytes() + HEADER.read_bytes()
        + " ".join(GXX_FLAGS + tuple(libs)).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"libslide_reader-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *libs]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=120)
        except subprocess.CalledProcessError as e:
            tmp.unlink(missing_ok=True)
            return None, f"{' '.join(cmd)} failed:\n{e.stderr}"
        except (OSError, subprocess.SubprocessError) as e:
            tmp.unlink(missing_ok=True)
            return None, f"{' '.join(cmd)}: {e}"
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        return None, f"cannot load {out}: {e}"
    _declare(lib)
    return lib, ""


def _declare(lib: ctypes.CDLL) -> None:
    p, i, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_float)
    u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(f32)
    for name, res, args in (
        ("slide_open", p, [ctypes.c_char_p]),
        ("slide_level_count", i, [p]),
        ("slide_level_dimensions", None,
         [p, i, ctypes.POINTER(u32), ctypes.POINTER(u32)]),
        ("slide_level_downsample", ctypes.c_double, [p, i]),
        ("slide_spacing_um", ctypes.c_double, [p]),
        ("slide_page_spacing_um", ctypes.c_double, [p, i]),
        ("slide_read_region", i, [p, i, u32, u32, u32, u32, u8p]),
        ("slide_read_label_region", i, [p, i, u32, u32, u32, u32, u8p]),
        ("slide_read_grid", i, [p, i, u32, u32, u32, u32, u8p, f32p]),
        ("slide_grid_jpeg_scaled_ok", i, [p, i, u32]),
        ("slide_read_grid_jpeg_scaled", i,
         [p, i, u32, u32, u32, u32, u32, u8p, f32p]),
        ("slide_close", None, [p]),
        ("tile_edge_energy_rgb", f32, [u8p, u32]),
        ("tiff_write_tiled_rgb", i,
         [ctypes.c_char_p, u8p, u32, u32, u32, i, i]),
        ("tiff_write_tiled_gray", i,
         [ctypes.c_char_p, u8p, u32, u32, u32, i, ctypes.c_double]),
        ("jpeg_write_rgb", i, [ctypes.c_char_p, u8p, i, i, i]),
        ("jpeg_decode_rgb", i,
         [ctypes.c_char_p, u8p, u32, u32, ctypes.POINTER(u32),
          ctypes.POINTER(u32)]),
        ("parse_float_csv", i,
         [ctypes.c_char_p, ctypes.c_long, f32p, i, i, ctypes.POINTER(i), i]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def get_lib() -> ctypes.CDLL:
    """The reader, built at first use; RuntimeError when it cannot be."""
    lib, why = build()
    if lib is None:
        raise RuntimeError(f"native slide reader unavailable: {why}")
    return lib


def available() -> bool:
    return build()[0] is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeSlide:
    """Pyramidal TIFF reader: level_count, level_dimensions,
    level_downsample, spacing_um, RGB read_region, the grid block reads of
    the streaming slide path, and a mask's label plane."""

    def __init__(self, path: str):
        self.path = path
        self._lib = get_lib()
        self._h = self._lib.slide_open(path.encode())
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

    @property
    def spacing_um(self) -> float:
        """Level-0 µm per pixel from the first page's resolution tags (0
        when it has none)."""
        return float(self._lib.slide_spacing_um(self._h))

    def page_spacing_um(self, level: int) -> float:
        """µm per pixel from that page's own resolution tags (0 when it has
        none)."""
        self._check_level(level)
        return float(self._lib.slide_page_spacing_um(self._h, level))

    def read_region(self, level: int, x: int, y: int, w: int, h: int
                    ) -> np.ndarray:
        self._check_level(level)
        out = np.zeros((h, w, 3), np.uint8)
        rc = self._lib.slide_read_region(self._h, level, x, y, w, h, _u8(out))
        if rc != 0:
            raise IOError(f"slide_read_region failed rc={rc}")
        return out

    def read_label_region(self, level: int, x: int, y: int, w: int, h: int
                          ) -> np.ndarray:
        """An (h, w) uint8 region of a label mask: the class id, which a
        gray page holds in its one sample and an RGB page in red."""
        self._check_level(level)
        out = np.zeros((h, w), np.uint8)
        rc = self._lib.slide_read_label_region(self._h, level, x, y, w, h,
                                               _u8(out))
        if rc != 0:
            raise IOError(f"slide_read_label_region failed rc={rc}")
        return out

    def read_grid(self, level: int, read: int, n_cols: int, n_rows: int,
                  row0: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """An (n_rows, n_cols) block of grid tiles from grid row `row0` in
        one call → ((n_rows·n_cols, read, read, 3) uint8 tiles in row-scan
        order, (n_rows·n_cols,) f32 edge energies). The C call releases
        the GIL (ctypes.CDLL), so a reader thread overlaps it."""
        self._check_level(level)
        n = n_rows * n_cols
        tiles = np.empty((n, read, read, 3), np.uint8)
        energy = np.empty((n,), np.float32)
        rc = self._lib.slide_read_grid(self._h, level, read, row0, n_cols,
                                       n_rows, _u8(tiles), _f32(energy))
        if rc != 0:
            raise IOError(f"slide_read_grid failed rc={rc}")
        return tiles, energy

    @staticmethod
    def scale_num_for(read: int, out_side: int) -> Optional[int]:
        """The libjpeg scale numerator M (denominator 8) that decodes a
        `read`² JPEG tile straight at `out_side`², or None when out_side
        is not an exact M/8 fraction of read (256→224 gives M=7)."""
        if read <= 0 or not (0 < out_side <= 2 * read):
            return None
        num = out_side * 8
        if num % read:
            return None
        m = num // read
        return m if 1 <= m <= 16 and (read * m + 7) // 8 == out_side else None

    def scaled_grid_ok(self, level: int, read: int, out_side: int) -> bool:
        """True iff read_grid_scaled can serve this level: JPEG-tiled with
        side `read`, and out_side an exact M/8 scale of it."""
        self._check_level(level)
        return (self.scale_num_for(read, out_side) is not None
                and bool(self._lib.slide_grid_jpeg_scaled_ok(
                    self._h, level, read)))

    def read_grid_scaled(self, level: int, read: int, n_cols: int,
                         n_rows: int, row0: int, out_side: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """read_grid with libjpeg's M/8 scaled IDCT: each tile's raw JPEG
        bytes and the level's JPEGTables decode straight at out_side², and
        the energies are taken at that size."""
        self._check_level(level)
        m = self.scale_num_for(read, out_side)
        if m is None:
            raise ValueError(f"{out_side} is not an M/8 scale of {read}")
        n = n_rows * n_cols
        tiles = np.empty((n, out_side, out_side, 3), np.uint8)
        energy = np.empty((n,), np.float32)
        rc = self._lib.slide_read_grid_jpeg_scaled(
            self._h, level, read, row0, n_cols, n_rows, m, _u8(tiles),
            _f32(energy))
        if rc != 0:
            raise IOError(f"slide_read_grid_jpeg_scaled failed rc={rc}")
        return tiles, energy

    def close(self) -> None:
        if self._h:
            self._lib.slide_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _rgb(arr: np.ndarray) -> np.ndarray:
    """A C-contiguous (H, W, 3) uint8 copy or view; other shapes raise."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"an (H, W, 3) image, not {arr.shape}")
    return arr


def write_tiled_tiff(path: str, levels: Sequence[np.ndarray], tile: int = 256,
                     jpeg_quality: int = 75) -> None:
    """A tiled pyramidal TIFF from (H, W, 3) uint8 levels, level 0 first;
    JPEG tiles at `jpeg_quality`, or uncompressed when it is 0."""
    lib = get_lib()
    for i, arr in enumerate(levels):
        arr = _rgb(arr)
        rc = lib.tiff_write_tiled_rgb(path.encode(), _u8(arr), arr.shape[1],
                                      arr.shape[0], tile, 1 if i else 0,
                                      jpeg_quality)
        if rc != 0:
            raise IOError(f"tiff_write_tiled_rgb failed rc={rc}")


def write_tiled_tiff_gray(path: str, levels: Sequence[np.ndarray],
                          tile: int = 64, spacing_um: float = 0.0) -> None:
    """A multi-page single-channel label TIFF from (H, W) uint8 levels,
    level 0 first: lossless and tiled, as Camelyon16's mask TIFFs are.
    With spacing_um > 0 each page carries resolution tags of spacing_um ×
    (that page's own downsample)."""
    lib = get_lib()
    w0 = None
    for i, arr in enumerate(levels):
        arr = np.ascontiguousarray(arr, np.uint8)
        if arr.ndim != 2:
            raise ValueError(f"a gray level is (H, W), not {arr.shape}")
        if w0 is None:
            w0 = arr.shape[1]
        res_per_cm = 0.0
        if spacing_um > 0:
            res_per_cm = 10_000.0 / (spacing_um * (w0 / arr.shape[1]))
        rc = lib.tiff_write_tiled_gray(path.encode(), _u8(arr), arr.shape[1],
                                       arr.shape[0], tile, 1 if i else 0,
                                       res_per_cm)
        if rc != 0:
            raise IOError(f"tiff_write_tiled_gray failed rc={rc}")


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 75) -> None:
    """An (H, W, 3) uint8 image as a baseline JPEG (libjpeg defaults)."""
    rgb = _rgb(rgb)
    rc = get_lib().jpeg_write_rgb(path.encode(), _u8(rgb), rgb.shape[1],
                                  rgb.shape[0], quality)
    if rc != 0:
        raise IOError(f"jpeg_write_rgb({path}) failed rc={rc}")


def decode_jpeg(path: str, size_hint: int = 256) -> np.ndarray:
    """A JPEG file → (H, W, 3) uint8 RGB, as PIL's
    `Image.open(path).convert("RGB")` gives it (libjpeg's ISLOW IDCT and
    fancy upsampling; grayscale replicated). CMYK raises ValueError. A
    first buffer of size_hint² pixels; a larger image decodes on a second
    call into a buffer of its size."""
    lib = get_lib()
    w, h = ctypes.c_uint32(), ctypes.c_uint32()

    def decode(cap_w, cap_h):
        out = np.empty((cap_h, cap_w, 3), np.uint8)
        rc = lib.jpeg_decode_rgb(path.encode(), _u8(out), cap_w, cap_h,
                                 ctypes.byref(w), ctypes.byref(h))
        return out, rc

    out, rc = decode(size_hint, size_hint)
    if rc == -14:                      # larger than the first buffer
        out, rc = decode(w.value, h.value)
    if rc == -15:
        raise ValueError(f"{path}: CMYK JPEGs are not decoded")
    if rc != 0:
        raise IOError(f"jpeg_decode_rgb({path}) failed rc={rc}")
    if out.shape[:2] == (h.value, w.value):
        return out
    return out.reshape(-1)[:h.value * w.value * 3].reshape(
        h.value, w.value, 3).copy()


def edge_energy(tile: np.ndarray) -> float:
    """The C reader's edge energy of one (n, n, 3) uint8 tile (the exact
    mean of the integer Laplacian, rounded once to f32)."""
    tile = _rgb(tile)
    if tile.shape[0] != tile.shape[1]:
        raise ValueError(f"edge_energy takes a square tile, not "
                         f"{tile.shape}")
    return float(get_lib().tile_edge_energy_rgb(_u8(tile), tile.shape[0]))


def parse_bag_csv_fast(path: str, max_rows: int = 65536) -> np.ndarray:
    """A feature CSV with a header row → float32 (rows, cols), parsed by
    strtof as `snuffy_tpu.native.parse_bag_csv_fast` parses it. A file of
    more than `max_rows` rows, or a row wider than the header, raises
    ValueError (the JAX copy returns the first max_rows rows)."""
    lib = get_lib()
    with open(path, "rb") as f:
        data = f.read()  # bytes keep a NUL past their end for strtof
    newline = data.find(b"\n")
    width = len(data[:newline if newline >= 0 else len(data)].split(b","))
    bound = min(data.count(b"\n") + 1, max_rows)
    out = np.zeros((bound, width), np.float32)
    n_cols = ctypes.c_int()
    rows = lib.parse_float_csv(data, len(data), _f32(out), bound, width,
                               ctypes.byref(n_cols), 1)
    if rows > max_rows:
        raise ValueError(f"{path}: {rows} rows, over the cap of {max_rows}")
    if n_cols.value > width:
        raise ValueError(f"{path}: a row of {n_cols.value} cells under a "
                         f"header of {width}")
    return np.ascontiguousarray(out[:rows, :n_cols.value])
