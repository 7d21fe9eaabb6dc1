"""The numbers that decide ``correct``: what the timed path produced against
what the plain reference works out from the same inputs.

Detections are matched image by image, greedily by IoU (at least
``MATCH_IOU``).  A detection without a partner can only be sound when it sits
at the confidence threshold, where a rounding moves it across; so an
unmatched one is scored by how far its score lies above the threshold
(``miss``), a matched pair by the gaps of its score, box and vertices (the
widest over all pairs, and the median pair's).
Training readings compare norms leaf by leaf, each gap against the larger of
the reference leaf's norm and the median leaf's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MATCH_IOU = 0.5


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from ``seed``."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([int(seed), 7])
        self.items: List = []
        self.seen = 0

    def offer(self, make) -> None:
        """Offer the next item; ``make()`` builds it only if it is kept."""
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = make()
        self.seen += 1


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix of xyxy boxes a [n, 4] and b [m, 4]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=-1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=-1)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def match(got_boxes: np.ndarray, want_boxes: np.ndarray) -> List[Tuple[int, int]]:
    """Greedy one-to-one pairs (i of got, j of want), highest IoU first."""
    iou = box_iou(got_boxes, want_boxes)
    pairs = []
    while iou.size and iou.max() >= MATCH_IOU:
        i, j = np.unravel_index(np.argmax(iou), iou.shape)
        pairs.append((int(i), int(j)))
        iou[i, :] = -1
        iou[:, j] = -1
    return pairs


class DetectionGaps:
    """Running maxima of the detection numbers over many images."""

    def __init__(self, threshold: float):
        self.threshold = threshold
        self.miss = 0.0  # largest score above threshold of an unmatched detection
        self.score = 0.0  # largest |score gap| of a matched pair
        self.box = 0.0  # largest box-coordinate gap / the reference box's longer side
        self.verts = 0.0  # largest vertex distance / the reference box's longer side
        self.verts_box = 0.0  # the box gap of the pair with the largest vertex distance
        self.pncc = 0.0  # largest mean |uint8 gap| of a PNCC map
        self.images = 0
        self.pairs = 0
        self.box_gaps: List[float] = []  # per matched pair, for the medians
        self.verts_gaps: List[float] = []

    def add(self, got_boxes, got_scores, want_boxes, want_scores,
            got_verts: Optional[Dict[int, np.ndarray]] = None,
            want_verts: Optional[np.ndarray] = None) -> List[Tuple[int, int]]:
        """One image; ``got_verts`` maps a got index to its vertices, which
        are compared with ``want_verts`` [m, V, 3] of the partner."""
        pairs = match(got_boxes, want_boxes)
        self.images += 1
        self.pairs += len(pairs)
        got_left = set(range(len(got_boxes))) - {i for i, _ in pairs}
        want_left = set(range(len(want_boxes))) - {j for _, j in pairs}
        for s in [got_scores[i] for i in got_left] + [want_scores[j] for j in want_left]:
            self.miss = max(self.miss, float(s) - self.threshold)
        for i, j in pairs:
            side = max(float(np.max(want_boxes[j, 2:] - want_boxes[j, :2])), 1.0)
            self.score = max(self.score, abs(float(got_scores[i]) - float(want_scores[j])))
            self.box_gaps.append(float(np.max(np.abs(got_boxes[i] - want_boxes[j]))) / side)
            self.box = max(self.box, self.box_gaps[-1])
            if got_verts is not None and i in got_verts:
                d = np.linalg.norm(np.asarray(got_verts[i], np.float64)
                                   - np.asarray(want_verts[j], np.float64), axis=-1)
                self.verts_gaps.append(float(d.max()) / side)
                if self.verts_gaps[-1] > self.verts:
                    self.verts, self.verts_box = self.verts_gaps[-1], self.box_gaps[-1]
        return pairs

    def numbers(self) -> Dict[str, float]:
        """The widest gaps, and the median pair's box and vertex gaps
        (``verts_box`` is no gap of its own: the box gap of the pair whose
        vertices lie farthest apart)."""
        median = lambda x: float(np.median(x)) if x else 0.0  # noqa: E731
        return {"miss": self.miss, "score": self.score, "box": self.box,
                "verts": self.verts, "verts_box": self.verts_box, "pncc": self.pncc,
                "box_median": median(self.box_gaps), "verts_median": median(self.verts_gaps)}

    def add_pncc(self, got: np.ndarray, want: np.ndarray) -> None:
        gap = np.abs(got.astype(np.int16) - want.astype(np.int16)).mean()
        self.pncc = max(self.pncc, float(gap))


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             keep: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    """(largest |got - want| / max(want, median of want), its leaf) over the
    leaves ``keep`` (all by default)."""
    names = list(keep) if keep is not None else list(want)
    median = float(np.median([want[n] for n in names])) if names else 0.0
    worst, at = 0.0, ""
    for n in names:
        gap = abs(got[n] - want[n]) / max(want[n], median, 1e-30)
        if gap > worst:
            worst, at = gap, n
    return worst, at


def median_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                    keep: Sequence[str]) -> float:
    """The median over the leaves ``keep`` of |got - want| / want."""
    return float(np.median([abs(got[n] - want[n]) / max(want[n], 1e-30) for n in keep]))


def moving_leaves(first_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference first gradient is not nought to rounding: a
    norm of at least a thousandth of the median leaf's."""
    median = float(np.median(list(first_grad.values())))
    return [n for n, g in first_grad.items() if g >= 1e-3 * median]
