"""Camelyon16 FROC evaluation, ASAP-free.

The port's copy of `snuffy_tpu/eval/froc.py` (the reference's modified
challenge evaluator, reference froc.py:67-307, 395-511). Masks are read
through the port's libtiff reader (`NativeMaskReader`) or held in memory
(`ArrayMaskReader`); there is no PIL reader, and a mask path whose reader
cannot be built raises with the reason. skimage is replaced by
scipy.ndimage and closed-form region moments. The math is the
reference's:

  evaluation mask (froc.py:67-128):
    tumor label 2 → euclidean distance transform → dilate by
    75 µm/(spacing·2) pixels → fill holes → 8-connected labeling →
    ITC = region with major axis < (200+75) µm / level-spacing
  TP/FP assignment (froc.py:133-190): per detection, mask hit label;
    label 0 → FP, ITC label → dropped, else max prob per tumor region.
  curve (froc.py:242-281): thresholds = all distinct probs; FP/slide and
    sensitivity per threshold (+ the trailing 0,0 point).
  score (froc.py:284-307): mean sensitivity at FP/WSI ∈
    {0.25, 0.5, 1, 2, 4, 8} via bisect on the reversed curve.

`EvalMaskCache` keeps one npz per (mask path, level, include_itcs): the
mask file's stamp (mtime, size) is stored inside and a mismatch recomputes
and overwrites it, and a failed write leaves no temporary file.
`save_results` writes pandas' CSV bytes with the csv module; `plot_froc`
imports matplotlib when it is called.
"""

from __future__ import annotations

import bisect
import csv
import hashlib
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import scipy.ndimage

TUMOR_LABEL = 2
DILATION_DISTANCE_UM = 75.0
ITC_DIAMETER_UM = 200.0
TARGET_FPS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)
EIGHT_CONNECTED = np.ones((3, 3), dtype=int)


# ------------------------------------------------------------- mask readers


@dataclass
class MaskLevel:
    """One pyramid level of a mask: the label image plus its geometry."""

    array: np.ndarray       # (H, W) uint8 label image
    downsample: float       # level-0 pixels per pixel at this level
    spacing_um: float       # level-0 µm per pixel


class ArrayMaskReader:
    """In-memory masks (tests / precomputed numpy pyramids)."""

    def __init__(self, levels: Dict[int, MaskLevel]):
        self.levels = levels

    def read(self, level: int) -> MaskLevel:
        return self.levels[level]


class NativeMaskReader:
    """Multi-page TIFF mask through the port's libtiff reader, the ASAP
    `MultiResolutionImageReader` counterpart (reference froc.py:93-106):
    downsample = getLevelDownsample (the width ratio of the actual pages),
    spacing = getSpacing()[0] (the level-0 resolution tags, else
    `default_spacing_um`: 0.243 µm for Camelyon16's scanners). A level
    past the last page is the last page subsampled by 2 per level."""

    def __init__(self, path: str, default_spacing_um: float = 0.243):
        from snuffy_tpu_torch.native import NativeSlide

        self.path = path
        self._slide = NativeSlide(path)
        self.default_spacing_um = default_spacing_um

    def read(self, level: int) -> MaskLevel:
        s = self._slide
        n_levels = s.level_count
        if level < n_levels:
            w, h = s.level_dimensions(level)
            arr = s.read_label_region(level, 0, 0, w, h)
            down = s.level_downsample(level)
        else:
            w, h = s.level_dimensions(n_levels - 1)
            arr = s.read_label_region(n_levels - 1, 0, 0, w, h)
            extra = 2 ** (level - (n_levels - 1))
            arr = arr[::extra, ::extra]
            down = s.level_downsample(n_levels - 1) * extra
        spacing = s.spacing_um or self.default_spacing_um
        return MaskLevel(arr.astype(np.uint8), float(down), float(spacing))

    def close(self):
        self._slide.close()


def open_mask(path_or_reader):
    """A reader (anything with `read(level)`) as it is, or a mask path
    through `NativeMaskReader`. A reader that cannot be built raises
    RuntimeError with the reason."""
    if hasattr(path_or_reader, "read"):
        return path_or_reader
    return NativeMaskReader(path_or_reader)


# ------------------------------------------------------ region measurements


def major_axis_lengths(label_image: np.ndarray, n_labels: int) -> np.ndarray:
    """skimage regionprops major_axis_length, closed-form: 4·√λmax of the
    per-region central second-moment covariance."""
    out = np.zeros(n_labels + 1)
    if n_labels == 0:
        return out
    rows, cols = np.nonzero(label_image)
    labs = label_image[rows, cols]
    for lab in range(1, n_labels + 1):
        sel = labs == lab
        r, c = rows[sel].astype(np.float64), cols[sel].astype(np.float64)
        if r.size == 0:
            continue
        mu20 = r.var()
        mu02 = c.var()
        mu11 = ((r - r.mean()) * (c - c.mean())).mean()
        common = np.sqrt(4 * mu11**2 + (mu20 - mu02) ** 2)
        lam_max = (mu20 + mu02) / 2 + common / 2
        out[lab] = 4.0 * np.sqrt(lam_max)
    return out


# ------------------------------------------------------------------ pieces


def compute_evaluation_mask(
    mask, level: int, include_itcs: bool
) -> Tuple[np.ndarray, Set[int]]:
    """Reference froc.py:67-128 on a MaskReader."""
    reader = open_mask(mask)
    lvl = reader.read(level)
    negative = np.not_equal(lvl.array, TUMOR_LABEL)
    distance = scipy.ndimage.distance_transform_edt(negative)
    level_spacing = lvl.spacing_um * lvl.downsample
    threshold_px = DILATION_DISTANCE_UM / (level_spacing * 2.0)
    binary = np.less(distance, threshold_px)
    filled = scipy.ndimage.binary_fill_holes(binary)
    labeled, n_labels = scipy.ndimage.label(filled, structure=EIGHT_CONNECTED)

    if include_itcs:
        itc_labels: Set[int] = set()
    else:
        itc_threshold = (ITC_DIAMETER_UM + DILATION_DISTANCE_UM) / level_spacing
        lengths = major_axis_lengths(labeled, n_labels)
        itc_labels = {
            lab for lab in range(1, n_labels + 1)
            if lengths[lab] < itc_threshold
        }
    return labeled, itc_labels


def scale_detections(
    detections: Sequence[Tuple[float, float, float]], downsample: float
) -> List[Tuple[float, int, int]]:
    """(prob, x, y) level-0 coords → (prob, row, col) at the mask level
    (reference froc.py:397-430: note the x/y → row/col swap)."""
    return [
        (p, round(y / downsample), round(x / downsample))
        for p, x, y in detections
    ]


def compute_probabilities(
    detection_items: Sequence[Tuple[float, int, int]],
    evaluation_mask: Optional[np.ndarray],
    itc_labels: Set[int],
) -> Tuple[List[float], List[float], int]:
    """Reference froc.py:133-190."""
    if evaluation_mask is not None:
        max_label = int(evaluation_mask.max())
        fp_probs: List[float] = []
        tp_probs = [0.0] * (max_label + 1)
        h, w = evaluation_mask.shape
        for prob, row, col in detection_items:
            if not (0 <= row < h and 0 <= col < w):
                fp_probs.append(prob)
                continue
            hit = int(evaluation_mask[row, col])
            if hit == 0:
                fp_probs.append(prob)
            elif hit not in itc_labels:
                if tp_probs[hit] < prob:
                    tp_probs[hit] = prob
        number_of_tumors = max_label - len(itc_labels)
    else:
        fp_probs = [prob for prob, _, _ in detection_items]
        tp_probs = [0.0]
        number_of_tumors = 0
    return fp_probs, tp_probs[1:], number_of_tumors


def compute_froc(froc_data: Dict[str, dict]):
    """Reference froc.py:242-281. Returns (avg FP/slide, sensitivities,
    thresholds)."""
    fps = [p for item in froc_data.values() for p in item["fp"]]
    tps = [p for item in froc_data.values() for p in item["tp"]]
    all_probs = sorted(set(fps + tps) - {0.0})
    image_count = len(froc_data)
    total_tumors = sum(item["count"] for item in froc_data.values())
    fps_arr = np.asarray(fps, np.float64)
    tps_arr = np.asarray(tps, np.float64)

    total_fps = [int((fps_arr >= t).sum()) for t in all_probs] + [0]
    total_tps = [int((tps_arr >= t).sum()) for t in all_probs] + [0]
    avg_fps = [c / image_count for c in total_fps]
    sens = [c / max(total_tumors, 1) for c in total_tps]
    return avg_fps, sens, all_probs


def compute_score(average_fps: List[float], sensitivities: List[float]) -> float:
    """Mean sensitivity at the six challenge FP rates (froc.py:284-307)."""
    fps_r = list(reversed(average_fps))
    sens_r = list(reversed(sensitivities))
    n = len(sens_r)
    total = sum(
        sens_r[min(bisect.bisect_left(fps_r, t), n - 1)] for t in TARGET_FPS
    )
    return total / len(TARGET_FPS)


# --------------------------------------------------------------- full runs

Stamp = Optional[Tuple[int, int]]
CacheEntry = Tuple[np.ndarray, Set[int], float]


class EvalMaskCache:
    """Evaluation masks kept across FROC sweeps.

    The reference meant to cache (froc.py:450-451 sets a `use_cache`
    global that nothing reads). The distance transform, dilation and
    labeling of a tumour mask depend only on (mask file, level,
    include_itcs) and dominate a bulk evaluation, yet repeat across every
    run and epoch scored against one test set. Entries hold (labeled mask,
    ITC labels, downsample), keyed in memory by the file's stamp (mtime,
    size) too. With `directory` each (path, level, include_itcs) has one
    npz there that stores the stamp it was computed from: a file whose
    stamp differs (a mask exported again) is recomputed and its npz
    overwritten, so the directory never holds stale entries beside fresh
    ones. The npz is written to a temporary name and renamed; the
    temporary file is removed if the write fails.
    """

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._mem: Dict[Tuple[str, int, bool, Stamp], CacheEntry] = {}

    def _npz_path(self, path: str, level: int, include_itcs: bool
                  ) -> Optional[str]:
        if not self.directory:
            return None
        h = hashlib.sha1(repr((path, level, include_itcs)).encode())
        return os.path.join(self.directory,
                            f"evalmask_{h.hexdigest()[:16]}.npz")

    @staticmethod
    def _load(npz: str, stamp: Stamp) -> Optional[CacheEntry]:
        """The npz's entry if it was computed from a file of this stamp."""
        try:
            with np.load(npz) as data:
                stored = tuple(int(v) for v in data["stamp"])
                if stored != (stamp if stamp is not None else (-1, -1)):
                    return None
                return (data["mask"], set(int(v) for v in data["itcs"]),
                        float(data["downsample"]))
        except Exception:
            return None   # absent, truncated or of another layout

    @staticmethod
    def _store(npz: str, stamp: Stamp, entry: CacheEntry) -> None:
        # np.savez appends .npz to a name without it
        tmp = f"{npz}.{os.getpid()}.tmp.npz"
        try:
            np.savez_compressed(
                tmp, mask=entry[0],
                itcs=np.asarray(sorted(entry[1]), np.int64),
                downsample=np.float64(entry[2]),
                stamp=np.asarray(stamp if stamp is not None else (-1, -1),
                                 np.int64),
            )
            os.replace(tmp, npz)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def get(self, path_or_reader, level: int, include_itcs: bool
            ) -> CacheEntry:
        """→ (evaluation mask, itc label set, downsample at `level`)."""
        path = (getattr(path_or_reader, "path", None)
                or (path_or_reader if isinstance(path_or_reader, str)
                    else None))
        if path is None:   # an in-memory reader has no key: not cached
            reader = open_mask(path_or_reader)
            ev, itcs = compute_evaluation_mask(reader, level, include_itcs)
            return ev, itcs, reader.read(level).downsample
        try:
            st = os.stat(path)
            stamp: Stamp = (int(st.st_mtime_ns), int(st.st_size))
        except OSError:
            stamp = None
        key = (path, level, include_itcs, stamp)
        if key in self._mem:
            return self._mem[key]
        npz = self._npz_path(path, level, include_itcs)
        entry = self._load(npz, stamp) if npz else None
        if entry is None:
            reader = open_mask(path_or_reader)
            ev, itcs = compute_evaluation_mask(reader, level, include_itcs)
            entry = (ev, itcs, reader.read(level).downsample)
            if npz:
                self._store(npz, stamp, entry)
        self._mem[key] = entry
        return entry


def froc_for_slides(
    detections_per_slide: Dict[str, Sequence[Tuple[float, float, float]]],
    mask_for_slide,
    slide_types: Dict[str, str],
    evaluation_mask_level: int = 5,
    include_itcs: bool = False,
    mask_cache: Optional[EvalMaskCache] = None,
) -> Tuple[float, List[float], List[float]]:
    """In-memory FROC over many slides (the reference's
    mp_computeFROC_list_no_cache, froc.py:447-511).

    detections_per_slide: slide → [(prob, x, y) at level 0].
    mask_for_slide: slide → MaskReader | path | None (normal slides).
    slide_types: slide → 'tumor' | 'normal'.
    mask_cache: optional EvalMaskCache reused across calls/sweeps.
    Returns (challenge_score, avg_fps, sensitivities).
    """
    froc_data = {}
    for slide, dets in detections_per_slide.items():
        if slide_types.get(slide, "tumor") == "tumor":
            src = mask_for_slide(slide)
            if mask_cache is not None:
                ev_mask, itcs, down = mask_cache.get(
                    src, evaluation_mask_level, include_itcs)
            else:
                mask = open_mask(src)
                ev_mask, itcs = compute_evaluation_mask(
                    mask, evaluation_mask_level, include_itcs
                )
                down = mask.read(evaluation_mask_level).downsample
            items = scale_detections(dets, down)
        else:
            ev_mask, itcs = None, set()
            items = [(p, int(y), int(x)) for p, x, y in dets]
        fp, tp, count = compute_probabilities(items, ev_mask, itcs)
        froc_data[slide] = {"fp": fp, "tp": tp, "count": count}

    avg_fps, sens, _ = compute_froc(froc_data)
    return compute_score(avg_fps, sens), avg_fps, sens


def save_results(path: str, average_fps, sensitivities):
    """The curve as pandas' `DataFrame({...}).to_csv(path, index=False)`
    writes it."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["Average FP Counts", "Overall Sensitivities"])
        w.writerows(zip(average_fps, sensitivities))


def plot_froc(average_fps, sensitivities, path: str, plot_prefix: str = ""):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(average_fps, sensitivities, marker="o", markersize=2)
    ax.set_xlabel("Average false positives per image")
    ax.set_ylabel("Sensitivity")
    ax.set_title(f"{plot_prefix} FROC")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=150)
    plt.close(fig)
