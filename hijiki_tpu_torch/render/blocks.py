"""Block/sweep scheduling and the deterministic seed schedule.

Port of ``hijiki_tpu/render/blocks.py``. The reference's
``ImageBlockGenerator`` (``src/main.rs:619-682``) raster-scans the image in
``block_size`` tiles, one sweep per sample, with a random u32 seed per block
and a random subpixel offset per sweep. The exact structure is kept
(per-pixel seed = block_seed + lx + ly * clipped block width,
``shader/render.glsl:156-157``), with everything derived from one user seed
through numpy's PCG so renders are reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hijiki_tpu_torch.ops.rng import MASK32


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class SweepSchedule:
    """Host-side randomness for one sweep."""

    sweep: int
    sample_offset: np.ndarray  # (2,) f32 in [0,1)
    block_seeds: np.ndarray  # (nby, nbx) u32


class BlockScheduler:
    """Deterministic replacement for the reference's OS-entropy seeding."""

    def __init__(self, width: int, height: int, block_size: int, seed: int):
        if block_size & 63:
            # same constraint as the reference (src/main.rs:633)
            raise ValueError("block_size must be a multiple of 64")
        self.width = width
        self.height = height
        self.block_size = block_size
        self.nbx = cdiv(width, block_size)
        self.nby = cdiv(height, block_size)
        # numpy 2.x rejects out-of-range ints in np.uint64(x): wrap explicitly
        self._rng = np.random.default_rng(np.uint64(int(seed) & (2**64 - 1)))

    def sweep(self, sweep_index: int) -> SweepSchedule:
        offset = self._rng.random(2, dtype=np.float32)
        seeds = self._rng.integers(
            0, 1 << 32, size=(self.nby, self.nbx), dtype=np.uint32
        )
        return SweepSchedule(sweep_index, offset, seeds)


def upload(array: np.ndarray, device=None) -> torch.Tensor:
    """A host array on ``device``; to a card from pinned memory,
    asynchronously: a pageable upload would wait for every kernel queued
    before it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def per_pixel_seeds_device(width, height, block_size, block_seeds, device=None, row0=0):
    """Expand the (..., nby, nbx) block seeds to (..., H, W) per-pixel seeds
    on ``device`` (the tensor twin of ``per_pixel_seeds``; leading dims, such
    as a chained chunk's sweeps, expand in the same few ops). Returns an
    int64 tensor holding u32 values (see ``ops/rng.py``).

    ``row0``: the seeds of pixel rows row0 .. row0 + height of the frame
    whose block seeds these are (a multi-device band), the very values the
    whole frame gives those rows; only the block rows they touch are
    uploaded."""
    B = block_size
    r0 = row0 // B
    bs = np.asarray(block_seeds, dtype=np.uint32)[..., r0:cdiv(row0 + height, B), :]
    bs = upload(bs.astype(np.int64), device)
    base = bs.repeat_interleave(B, dim=-2).repeat_interleave(B, dim=-1)
    base = base[..., row0 - r0 * B:row0 - r0 * B + height, :width]
    y = torch.arange(row0, row0 + height, device=base.device).view(-1, 1)
    x = torch.arange(width, device=base.device).view(1, -1)
    bx = x // B
    lx = x - bx * B
    ly = y - (y // B) * B
    clip_w = torch.clamp_max(width - bx * B, B)
    return (base + lx + ly * clip_w) & MASK32


def per_pixel_seeds(width, height, block_size, block_seeds):
    """Per-pixel RNG seeds for a sweep (numpy, host side):
    seed = block_seed + lx + ly * block_width_clipped."""
    block_seeds = np.asarray(block_seeds, dtype=np.uint32)
    y, x = np.mgrid[0:height, 0:width]
    bx, by = x // block_size, y // block_size
    lx, ly = x - bx * block_size, y - by * block_size
    bw = np.minimum(block_size, width - bx * block_size)
    with np.errstate(over="ignore"):
        return (
            block_seeds[by, bx]
            + lx.astype(np.uint32)
            + ly.astype(np.uint32) * bw.astype(np.uint32)
        )
