"""The renderer driver: sweeps, film, overflow invariant, metrics.

Port of ``hijiki_tpu/render/renderer.py`` for the mega driver at
``chain_sweeps=1`` (the reference's ``src/main.rs:1143-1355`` loop): each
sweep traces every pixel once through ``ops.megakernel.render_waves``,
reconstructs it with the radius-2 bilateral filter and adds the
(rgb*weight, weight) delta to the film; normalization happens at save time.

Not ported yet (``RenderConfig`` refuses them at non-default values): the
sync and wavefront drivers, chained sweeps, lane sorting, fixed albedo,
previews, checkpoints and the TPU packet/walker knobs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from hijiki_tpu_torch.ops.megakernel import mega_scene, render_waves
from hijiki_tpu_torch.ops.rng import to_bits
from hijiki_tpu_torch.render.blocks import BlockScheduler, per_pixel_seeds_device
from hijiki_tpu_torch.render.pallas_reconstruct import reconstruct
from hijiki_tpu_torch.render.reconstruct import normalize_film
from hijiki_tpu_torch.scene.compile import CompiledScene
from hijiki_tpu_torch.utils.exr import write_exr


@dataclass(frozen=True)
class RenderConfig:
    """The reference CLI's options (``src/main.rs:1426-1456``) with the field
    names of ``hijiki_tpu.render.renderer.RenderConfig``."""

    width: int = 800
    height: int = 600
    spp: int = 64
    block_size: int = 128
    seed: int = 0
    use_bvh: bool = True
    max_bounces: int = 1000
    reconstruction_radius: int = 2
    reconstruction_stddev: float = 0.5
    preview_interval: int = 0
    preview_path: str = "/tmp/hijiki_preview.png"
    leaf_size: int = 1
    driver: str = "mega"
    wavefront_lanes: int = 1 << 18
    sort_lanes: bool = False
    traversal: str = ""
    fixed_albedo: bool = False
    live_preview: int = 0
    mega_packet: int = 0
    mega_groups: int = 0
    chain_sweeps: int = 0
    spec_resolve: int = 0
    mega_trunk: int = 0
    mega_window: int = 0
    mega_chain_cap: int = 0
    mega_shadow: int = 0
    # wavefront phase-capacity shrink factors; () = render_waves' defaults
    phase_shrink: tuple = ()


# fields whose non-default values select code that is not ported yet
_NOT_PORTED = (
    "reconstruction_radius", "preview_interval", "leaf_size", "wavefront_lanes",
    "sort_lanes", "traversal", "fixed_albedo", "live_preview", "mega_packet",
    "mega_groups", "spec_resolve", "mega_trunk", "mega_window",
    "mega_chain_cap", "mega_shadow",
)


def check_config(c: RenderConfig) -> None:
    if c.driver != "mega":
        raise NotImplementedError(f"driver {c.driver!r} is not ported yet (only 'mega')")
    if c.chain_sweeps not in (0, 1):
        raise NotImplementedError("chained sweeps (chain_sweeps > 1) are not ported yet")
    defaults = RenderConfig()
    for f in _NOT_PORTED:
        if getattr(c, f) != getattr(defaults, f):
            raise NotImplementedError(f"RenderConfig.{f}={getattr(c, f)!r} is not ported yet")


def render_sweep(
    ms,
    block_seeds,
    sample_offset,
    *,
    width: int,
    height: int,
    block_size: int,
    max_bounces: int,
    stddev: float,
    phase_shrink: tuple = (),
):
    """Trace + reconstruct one full-image sweep; returns (film_delta, stats)."""
    dev = ms.rows.device
    H, W = height, width
    seeds = to_bits(per_pixel_seeds_device(W, H, block_size, block_seeds, dev).reshape(-1))
    so = torch.as_tensor(np.asarray(sample_offset, np.float32))
    y = torch.arange(H, dtype=torch.float32, device=dev).view(-1, 1).expand(H, W)
    x = torch.arange(W, dtype=torch.float32, device=dev).view(1, -1).expand(H, W)
    px = (x + float(so[0])).reshape(-1)
    py = (y + float(so[1])).reshape(-1)
    total, normal, depth, _, overflow, segs, rows, _ = render_waves(
        ms, px, py, seeds, max_bounces=max_bounces,
        **({"phase_shrink": phase_shrink} if phase_shrink else {}),
    )
    total = total.reshape(H, W, 3).contiguous()
    delta = reconstruct(
        total, normal.reshape(H, W, 3).contiguous(), so,
        block_size=block_size, stddev=stddev,
    )
    stats = dict(
        # paths dropped by phase-capacity overflow (0 = unbiased)
        wave_overflow=overflow,
        mean_radiance=total.mean(),
        mean_depth=depth.mean(),
        # total path segments (closest-hit casts)
        path_segments=segs.sum(),
        # trace-table rows visited, summed over paths (per-thread walks: not
        # comparable with the TPU's per-packet row unions)
        rows_visited=rows.sum(),
    )
    return delta, stats


class Renderer:
    """Progressive sweep renderer over a compiled scene on ``device``."""

    def __init__(self, compiled: CompiledScene, config: RenderConfig, device="cuda"):
        check_config(config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda') needs a CUDA device")
        self.config = config
        self.scene = mega_scene(compiled, config.width, config.height, self.device)
        self.scheduler = BlockScheduler(
            config.width, config.height, config.block_size, config.seed
        )
        self.film = torch.zeros(
            (config.height, config.width, 4), dtype=torch.float32, device=self.device
        )
        self.sweeps_done = 0
        self.metrics: dict = {}
        self._last_stats = None

    def _run_sweep(self, block_seeds, offset, phase_shrink):
        c = self.config
        return render_sweep(
            self.scene, block_seeds, offset,
            width=c.width, height=c.height, block_size=c.block_size,
            max_bounces=c.max_bounces, stddev=c.reconstruction_stddev,
            phase_shrink=phase_shrink,
        )

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def render(self, progress: Optional[Callable[[int, int], None]] = None):
        """Run the remaining sweeps."""
        c = self.config
        start = time.monotonic()
        sweep_marks = []
        resume_start = self.sweeps_done
        # overflow == 0 is an INVARIANT: each sweep's inputs and overflow
        # counter are recorded; if any path was dropped by a phase-capacity
        # truncation, every recorded sweep is re-rendered at full capacity
        # (phase_shrink 1, which cannot overflow) with the SAME seeds, so the
        # film is always the unbiased estimate. Settled once after the loop
        # (one host sync, never per sweep).
        film_start = self.film
        records, counters = [], []
        ps = tuple(c.phase_shrink or ())
        while self.sweeps_done < c.spp:
            sched = self.scheduler.sweep(self.sweeps_done)
            delta, stats = self._run_sweep(sched.block_seeds, sched.sample_offset, ps)
            self._last_stats = stats
            records.append((sched.block_seeds, sched.sample_offset))
            counters.append(stats["wave_overflow"])
            self.film = self.film + delta
            self.sweeps_done += 1
            if progress is not None:
                progress(self.sweeps_done, c.spp)
            sweep_marks.append(time.monotonic() - start)
        seen = int(torch.stack(counters).sum()) if counters else 0
        if seen:
            import warnings

            warnings.warn(
                f"{seen} paths exceeded wavefront phase capacity; re-rendering "
                "these sweeps at full capacity (phase_shrink=1) with the same seeds"
            )
            film = film_start
            for bs, off in records:
                delta, stats = self._run_sweep(bs, off, (1,) * 8)
                self._last_stats = stats
                film = film + delta
            self.film = film
        self._sync()
        elapsed = time.monotonic() - start
        sweeps_traced = self.sweeps_done - resume_start
        primary_rays = c.width * c.height * sweeps_traced
        rate = primary_rays / elapsed if elapsed > 0 else 0.0
        self.metrics = dict(
            render_seconds=elapsed,
            primary_rays=primary_rays,
            rays_per_second=rate,
            mrays_per_second=rate / 1e6,
            spp_per_second=sweeps_traced / elapsed if elapsed > 0 else 0.0,
            sweep_marks=sweep_marks,
            chain_chunk_sweeps=1,
        )
        if self._last_stats is not None:
            st = self._last_stats
            self.metrics["wave_overflow"] = 0 if seen else int(st["wave_overflow"])
            self.metrics["overflow_retried"] = seen
            segs = float(st["path_segments"])
            if segs > 0:
                self.metrics["path_segments_last_sweep"] = segs
                self.metrics["mean_path_length"] = segs / (c.width * c.height)
            rows = float(st["rows_visited"])
            if rows > 0:
                self.metrics["rows_visited_last_sweep"] = rows
                self.metrics["mrows_per_second"] = (
                    rows * sweeps_traced / elapsed / 1e6 if elapsed > 0 else 0.0
                )
        return self.metrics

    def image(self) -> np.ndarray:
        """Normalized (H, W, 3) float RGB."""
        return normalize_film(self.film).cpu().numpy()

    def save_exr(self, path: str) -> None:
        write_exr(path, self.image())
