"""What decides ``correct``: which images and pixels of a run are checked,
and how far the program's pixels may lie from the plain reference's.

A run keeps a reservoir sample of its window's images, drawn from the run's
seed; in each kept image it checks patches of pixels, half at random places
and half straddling a corner of the block grid (where the reconstruction's
block quirks and the per-block seeds meet). The reference traces every
sample that reaches a checked pixel (the patch and its halo of R pixels,
every sweep) and reconstructs those pixels; the program's image is read at
the same pixels.

A pixel's gap is max over channels |program - reference| divided by
max(max over channels |reference|, GAP_FLOOR); NaN counts as infinite. Two
numbers are compared with their limits (``limits/<workload>.json``):
``bad_px_pct``, the share of checked pixels whose gap passes BAD_GAP, and
``median_gap``, the median gap.
"""

from __future__ import annotations

import random

import numpy as np
import torch

import reference

PATCH = 8
GAP_FLOOR = 1e-2
BAD_GAP = 1e-3
COMPARED = ("bad_px_pct", "median_gap")


class Reservoir:
    """A uniform sample of ``k`` of the window's images (algorithm R),
    drawn from the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n, self.kept = k, random.Random(f"{seed}:images"), 0, []

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.kept[j] = item
        self.n += 1


def patch_corners(seed: int, index: int, width: int, height: int, block: int, n: int):
    """``n`` top-left corners of PATCH x PATCH patches of image ``index``:
    the even ones at random, the odd ones centred on a random interior
    corner of the block grid (at random where the image is one block)."""
    rng = np.random.default_rng([seed % 2**64, 3, index])
    nbx, nby = -(-width // block), -(-height // block)
    out = []
    for k in range(n):
        if k % 2 and (nbx > 1 or nby > 1):
            cx = int(rng.integers(1, nbx)) * block if nbx > 1 else int(rng.integers(0, width))
            cy = int(rng.integers(1, nby)) * block if nby > 1 else int(rng.integers(0, height))
            x0, y0 = cx - PATCH // 2, cy - PATCH // 2
        else:
            x0 = int(rng.integers(0, width - PATCH + 1))
            y0 = int(rng.integers(0, height - PATCH + 1))
        out.append((min(max(x0, 0), width - PATCH), min(max(y0, 0), height - PATCH)))
    return out


def program_pixels(image: np.ndarray, corners) -> np.ndarray:
    return np.stack([image[y0:y0 + PATCH, x0:x0 + PATCH] for x0, y0 in corners])


def reference_pixels(ref, raw, job: dict, corners) -> np.ndarray:
    px = reference.image_pixels(ref, raw, job, corners, PATCH)
    return px.to(torch.float32).cpu().numpy()


def gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    got = np.asarray(got, np.float64).reshape(-1, 3)
    want = np.asarray(want, np.float64).reshape(-1, 3)
    g = np.abs(got - want).max(1) / np.maximum(np.abs(want).max(1), GAP_FLOOR)
    return np.where(np.isnan(g), np.inf, g)


def readings(all_gaps: np.ndarray) -> dict:
    """The compared numbers of a run's checked pixels."""
    g = np.asarray(all_gaps, np.float64)
    if g.size == 0:
        return {"bad_px_pct": float("inf"), "median_gap": float("inf")}
    return {"bad_px_pct": float(100.0 * np.mean(g > BAD_GAP)), "median_gap": float(np.median(g))}


def within(read: dict, limits: dict) -> bool:
    return all(read[k] <= limits[k] for k in COMPARED)
