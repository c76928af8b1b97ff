"""The renderer driver: sweeps and chained chunks, film, overflow invariant,
checkpoint/resume, previews, metrics, span tracing.

Port of ``hijiki_tpu/render/renderer.py`` (the reference's
``src/main.rs:1143-1355`` loop) with its three drivers, which compute the
same estimator from the same seeds:

* ``mega`` (the port's default, the card's fast path): the megakernel.
  The sweeps of a render go in chunks: a chunk of S > 1 sweeps traces
  every pixel's S samples in one chained launch
  (``ops.megakernel.render_waves_chained``), a chunk of one sweep through
  ``render_waves``;
* ``sync`` (the JAX package's default): the bulk-synchronous integrator
  (``ops/integrate.py``), one sweep per chunk;
* ``wavefront``: the regenerating lane pool (``render/wavefront.py``).

Each sweep is reconstructed with the bilateral filter (K3 at radius 2
without an albedo AOV, whatever the driver; ``reconstruct_sweep``
otherwise); a chunk's (rgb*weight, weight) deltas are summed in sweep
order and the sum is added to the film; normalization happens at read
time.

``sort_lanes`` sorts the wavefront driver's lane pool, and the mega
driver's paths inside every launch (the lane-sorted kernels, K7); neither
changes a film. The TPU's packet/walker knobs are accepted and read by
nothing (the per-thread walk has no packet): their resolvers return what
JAX's return off the TPU.

``render_sweep`` and ``render_sweeps_chained`` take the port's form (a
``RenderConfig``) or JAX's keyword form; each JAX form builds the config
and runs the port's one implementation.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from hijiki_tpu_torch.ops.camera import camera_rays
from hijiki_tpu_torch.ops.integrate import TRAVERSALS, integrate
from hijiki_tpu_torch.ops.megakernel import (
    CHAIN_SWEEPS_CUDA, MegaScene, mega_scene, render_waves, render_waves_chained, scene_of,
)
from hijiki_tpu_torch.ops.rng import as_state, seed_rng, to_bits
from hijiki_tpu_torch.render.blocks import BlockScheduler, per_pixel_seeds_device, upload
from hijiki_tpu_torch.render.pallas_reconstruct import reconstruct
from hijiki_tpu_torch.render.reconstruct import normalize_film, reconstruct_sweep
from hijiki_tpu_torch.render.wavefront import render_wavefront
from hijiki_tpu_torch.scene.compile import CompiledScene, to_device
from hijiki_tpu_torch.utils.exr import write_exr, write_png
from hijiki_tpu_torch.utils.tracing import maybe_span


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
    # sweeps between PNG previews; 0 = off
    preview_interval: int = 0
    preview_path: str = "/tmp/hijiki_preview.png"
    leaf_size: int = 1
    # "mega" (the port's default), "sync" (the JAX package's default) or
    # "wavefront"
    driver: str = "mega"
    wavefront_lanes: int = 1 << 18
    # coherence-sort the lanes between bounces: the wavefront driver's pool,
    # or each tile of the mega driver's launches (the lane-sorted kernels;
    # chaining is then off). The film is the same bit for bit.
    sort_lanes: bool = False
    # sync/wavefront traversal: "" = "rows" (or "brute" without use_bvh);
    # "rows" and "packet" walk the trace rows (K6 on a card), "bvh" and
    # "brute" are plain torch
    traversal: str = ""
    # populate the albedo AOV at the first hit (sync and unchained mega),
    # activating the reconstruction's albedo feature term
    fixed_albedo: bool = False
    # live terminal preview every N sweeps; 0 = off
    live_preview: int = 0
    # the TPU walker's schedule knobs (packet width, cursor groups, the
    # pipelined winner resolve, the HBM walk's trunk cache and row window):
    # accepted (check_config: resolve_mega_packet's one check); the
    # per-thread walk has no packet, so any value gives the same film bit
    # for bit
    mega_packet: int = 0
    mega_groups: int = 0
    # sweeps per chained launch: 1 = off, 0 = auto (CHAIN_SWEEPS_CUDA on a
    # CUDA device, off on the CPU); estimator-exact per (pixel, sweep)
    chain_sweeps: int = 0
    spec_resolve: int = 0
    mega_trunk: int = 0
    mega_window: int = 0
    # in-kernel bounce cap of a chained launch before a path parks for the
    # compaction phases; 0 = render_waves_chained's default (8)
    mega_chain_cap: int = 0
    # the dedicated any-hit shadow table for the mega driver's NEE walks
    # (CompiledScene.shadow_rows_mega): 0 = auto (off, as JAX's
    # resolve_shadow_tbl resolves it), 1 = on, -1 = off; the film is the
    # same either way
    mega_shadow: int = 0
    # wavefront phase-capacity shrink factors; () = the drivers' defaults
    phase_shrink: tuple = ()


DRIVERS = ("sync", "wavefront", "mega")

# fields that change an accumulated film: a resumed render must match them
_CHECKPOINT_FIXED = (
    "width", "height", "block_size", "seed", "use_bvh", "max_bounces", "driver",
    "reconstruction_radius", "reconstruction_stddev", "fixed_albedo",
)


def check_config(c: RenderConfig) -> None:
    if c.driver not in DRIVERS:
        raise ValueError(f"unknown driver {c.driver!r} (one of {', '.join(DRIVERS)})")
    if c.traversal and c.traversal not in TRAVERSALS:
        raise ValueError(f"unknown traversal {c.traversal!r} (one of {', '.join(TRAVERSALS)})")
    resolve_mega_packet(c.mega_packet, c.sort_lanes)


# The TPU walker's knobs schedule the TPU's packet walk; the port's
# per-thread walk has no packet, so it accepts them and reads none. The one
# check they carry off the TPU is JAX's resolve_mega_packet's
# (hijiki_tpu/render/renderer.py:534): the lane sort pins 128-lane packets.
# JAX's HIJIKI_* environment overrides select TPU walker experiments the
# per-thread walk has no counterpart of, so they are not read.


def resolve_mega_packet(requested: int, sort_lanes: bool = False) -> int:
    """Lanes a traversal cursor as JAX resolves them off the TPU: 0 = auto,
    128. The lane sort pins 128 and refuses another explicit width, with
    JAX's message."""
    if sort_lanes:
        if requested and requested != 128:
            raise ValueError(
                f"sort_lanes requires 128-lane packets, got mega_packet={requested} "
                "(the in-kernel bitonic lane sort only supports one-VREG packets); "
                "drop --mega-packet or set it to 128"
            )
        return 128
    return requested or 128


def chain_chunk_size(remaining: int, chain: int) -> int:
    """Prefer a chunk size that divides ``remaining`` (any divisor in
    [chain/2, chain]), so every chunk of a render has the same S; otherwise
    ``chain`` with a shorter tail chunk."""
    remaining = max(remaining, 1)
    if remaining % chain:
        for s in range(chain - 1, max(chain // 2 - 1, 1), -1):
            if remaining % s == 0:
                return s
    return chain


def resolve_chain_sweeps(config: RenderConfig, table_hbm=False, sweeps_done: int = 0, *,
                         device=None) -> int:
    """Sweeps per chained launch. 0 = auto: CHAIN_SWEEPS_CUDA (through
    ``chain_chunk_size``) for the mega driver on a CUDA device, 1 (off) on
    the CPU, where the twins gain nothing from chaining, and on JAX's HBM
    table path (``table_hbm``). Chaining needs the mega driver with the
    radius-2 reconstruction, parity albedo and no lane sort;
    HIJIKI_CHAIN_SWEEPS overrides the auto choice.

    JAX's form is ``(config, table_hbm, sweeps_done)``; the port's passes
    the device second (a ``torch.device`` or a name) or as ``device=``.
    Without a device the port's entry points run on the card, so JAX's
    form resolves the card's default (8 sweeps a launch), where JAX on a
    non-TPU backend resolves 1."""
    if isinstance(table_hbm, (str, torch.device)):
        device, table_hbm = table_hbm, False
    c = config
    eligible = (
        c.driver == "mega"
        and c.reconstruction_radius == 2
        and not c.fixed_albedo
        and not c.sort_lanes
    )
    requested = c.chain_sweeps
    env = os.environ.get("HIJIKI_CHAIN_SWEEPS")
    if not requested and env:
        requested = int(env)
    if requested:
        if requested > 1 and not eligible:
            raise ValueError(
                "chain_sweeps > 1 needs the mega driver with radius-2 "
                "reconstruction, parity albedo, and no --sort-lanes"
            )
        return requested
    if not eligible or table_hbm or torch.device(device or "cuda").type != "cuda":
        return 1
    return chain_chunk_size(c.spp - sweeps_done, CHAIN_SWEEPS_CUDA)


def resolve_shadow_tbl(requested: int, table_hbm: bool = False, scene=None) -> bool:
    """Whether the mega driver's shadow walks take the dedicated any-hit
    table (JAX's ``resolve_shadow_tbl``, hijiki_tpu/render/renderer.py:
    671-689, whose ``table_hbm`` and ``scene`` it reads no more than JAX
    does): 0 = auto, which is off; > 0 on (the scene must have one); < 0
    off. HIJIKI_SHADOW_TBL overrides the auto choice."""
    if requested:
        return requested > 0
    env = os.environ.get("HIJIKI_SHADOW_TBL")
    if env:
        return int(env) > 0
    return False


# The resolvers of the TPU walker's knobs, with JAX's signatures and what
# JAX's return off the TPU (hijiki_tpu/render/renderer.py:588-710), less
# the HIJIKI_* overrides. The per-thread walk reads none of the values: any
# of them gives the same film bit for bit.

# JAX's VMEM budget of the HBM walk's trunk cache (resolve_mega_trunk)
MEGA_TRUNK_BYTES = 12 << 20


def resolve_spec_resolve(requested: int, table_hbm: bool = False) -> bool:
    """The pipelined winner resolve: 0 = auto, on for HBM-streamed tables
    only; 1 on, -1 off."""
    if requested:
        return requested > 0
    return table_hbm


def resolve_mega_groups(requested: int, packet: int, table_hbm: bool) -> int:
    """Independent cursor groups a packet: 0 = auto, 2 on JAX's HBM path
    when the packet holds two 128-lane groups, else 1."""
    if requested:
        return requested
    if table_hbm:
        return 2 if packet % (2 * 128) == 0 else 1
    return 1


def resolve_mega_trunk(requested: int, table_hbm: bool, scene) -> int:
    """Trunk-cache rows of JAX's HBM walk: 0 off the HBM path; there 0 =
    auto (off), N > 0 the first N rows, -1 off."""
    if not table_hbm:
        return 0
    return max(requested, 0)


def resolve_mega_window(requested: int, table_hbm: bool) -> int:
    """Row-window height of JAX's HBM walk: 1 off the HBM path; there 0 =
    auto (1), h >= 1 the height."""
    if not table_hbm:
        return 1
    return max(requested, 1)


def _pixel_grid(width, height, device, row0=0):
    y = torch.arange(row0, row0 + height, dtype=torch.float32, device=device)
    y = y.view(-1, 1).expand(height, width)
    x = torch.arange(width, dtype=torch.float32, device=device).view(1, -1).expand(height, width)
    return x.reshape(-1), y.reshape(-1)


def chunk_inputs(width, height, block_size, block_seeds, offsets, device, row0=0):
    """The mega driver's inputs of S sweeps over pixel rows row0 .. row0 +
    height of the frame whose block seeds ``block_seeds`` (S, nby, nbx) are:
    jittered pixel coordinates pxs, pys (S, N) f32 and seeds (S, N) int32
    u32 bits, built in a few batched ops over S (per-sweep ops would leave
    the card idle while the host enqueues them)."""
    x, y = _pixel_grid(width, height, device, row0)
    offs_d = upload(np.asarray(offsets, np.float32), device)
    seeds = per_pixel_seeds_device(width, height, block_size, block_seeds, device, row0)
    return x + offs_d[:, 0:1], y + offs_d[:, 1:2], to_bits(seeds.reshape(len(offsets), -1))


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _scene_device(scene, inputs=None) -> torch.device:
    """Where a JAX-form call runs: on its inputs' device when they are
    tensors, else on its scene's, else on the card."""
    if isinstance(inputs, torch.Tensor):
        return inputs.device
    if isinstance(scene, MegaScene):
        return scene.rows.device
    rows = scene.trace_rows_mega
    return rows.device if isinstance(rows, torch.Tensor) else torch.device("cuda")


def _sweep_config(*, width: int, height: int, block_size: int, use_bvh: bool, max_bounces: int,
                  radius: int, stddev: float, leaf_size: int, driver: str = "sync",
                  wavefront_lanes: int = 1 << 18, sort_lanes: bool = False, traversal: str = "",
                  fixed_albedo: bool = False, mega_packet: int = 128, mega_groups: int = 1,
                  mega_table_hbm: bool = False, mega_spec_resolve: bool = False,
                  mega_trunk: int = 0, mega_window: int = 1, mega_shadow_tbl: bool = False,
                  chain_cap: int = 0) -> RenderConfig:
    """The ``RenderConfig`` of JAX's keyword form of ``render_sweep`` (and,
    with ``chain_cap``, of ``render_sweeps_chained``). The walker knobs are
    taken as resolved; ``mega_table_hbm`` schedules JAX's HBM walk and
    nothing here."""
    c = RenderConfig(
        width=width, height=height, block_size=block_size, use_bvh=use_bvh,
        max_bounces=max_bounces, reconstruction_radius=radius,
        reconstruction_stddev=stddev, leaf_size=leaf_size, driver=driver,
        wavefront_lanes=wavefront_lanes, sort_lanes=sort_lanes, traversal=traversal,
        fixed_albedo=fixed_albedo, mega_packet=mega_packet, mega_groups=mega_groups,
        spec_resolve=1 if mega_spec_resolve else -1, mega_trunk=mega_trunk,
        mega_window=mega_window, mega_shadow=1 if mega_shadow_tbl else -1,
        mega_chain_cap=chain_cap,
    )
    check_config(c)
    return c


def render_sweep(scene, pixel_seeds, sample_offset, config: RenderConfig = None,
                 phase_shrink: tuple = (), *, width: int = None, height: int = None,
                 block_size: int = None, use_bvh: bool = None, max_bounces: int = None,
                 radius: int = None, stddev: float = None, leaf_size: int = None,
                 driver: str = "sync", wavefront_lanes: int = 1 << 18, sort_lanes: bool = False,
                 traversal: str = "", fixed_albedo: bool = False, mega_packet: int = 128,
                 mega_groups: int = 1, mega_table_hbm: bool = False,
                 mega_spec_resolve: bool = False, mega_trunk: int = 0, mega_window: int = 1,
                 mega_shadow_tbl: bool = False, seeds_from_blocks: bool = False,
                 interpret: bool = False):
    """Trace + reconstruct one full-image sweep with ``config.driver``.
    Returns (film_delta, stats).

    The port's form passes ``config``: ``scene`` is a ``MegaScene`` for the
    mega driver and a device ``CompiledScene`` (``to_device``) for the
    others, and ``pixel_seeds`` the scheduler's (bh, bw) block seeds, which
    are expanded on the device. JAX's form passes JAX's keywords from
    ``width`` to ``mega_shadow_tbl`` in place of ``config`` (the first
    eight are required; ``driver`` defaults to JAX's ``sync``): ``scene``
    is any ``CompiledScene`` (the mega driver bakes it once, ``scene_of``),
    and ``pixel_seeds`` the (H, W) per-pixel seeds, or the block seeds
    with ``seeds_from_blocks``. It runs on the pixel seeds' device when
    they are a tensor, else on the scene's, else on the card;
    ``interpret`` routes nothing."""
    required = dict(width=width, height=height, block_size=block_size, use_bvh=use_bvh,
                    max_bounces=max_bounces, radius=radius, stddev=stddev, leaf_size=leaf_size)
    if config is not None:
        given = sorted(k for k, v in required.items() if v is not None)
        if given:
            raise TypeError(f"render_sweep: config= and JAX's keywords {given} together")
        c = config
        dev = scene.rows.device if c.driver == "mega" else scene.trace_rows.device
        seeds = per_pixel_seeds_device(c.width, c.height, c.block_size, pixel_seeds, dev)
        return _render_sweep(scene, seeds.reshape(-1), sample_offset, c, phase_shrink)
    missing = sorted(k for k, v in required.items() if v is None)
    if missing:
        raise TypeError(f"render_sweep: JAX's form needs {missing} (or the port's config=)")
    c = _sweep_config(
        **required, driver=driver, wavefront_lanes=wavefront_lanes, sort_lanes=sort_lanes,
        traversal=traversal, fixed_albedo=fixed_albedo, mega_packet=mega_packet,
        mega_groups=mega_groups, mega_table_hbm=mega_table_hbm,
        mega_spec_resolve=mega_spec_resolve, mega_trunk=mega_trunk, mega_window=mega_window,
        mega_shadow_tbl=mega_shadow_tbl,
    )
    dev = _scene_device(scene, pixel_seeds)
    if c.driver == "mega":
        scene = scene_of(scene, c.width, c.height, dev)
    elif not isinstance(scene.trace_rows, torch.Tensor):
        scene = to_device(scene, dev)
    if seeds_from_blocks:
        seeds = per_pixel_seeds_device(c.width, c.height, c.block_size, _host(pixel_seeds), dev)
    else:
        seeds = as_state(pixel_seeds, dev)
    return _render_sweep(scene, seeds.reshape(-1), sample_offset, c, phase_shrink)


def _render_sweep(scene, seeds, sample_offset, config: RenderConfig, phase_shrink: tuple):
    """``render_sweep`` on the device's (H*W,) per-pixel seeds (int64
    tensor of u32 values)."""
    c = config
    H, W, driver, max_bounces = c.height, c.width, c.driver, c.max_bounces
    dev = seeds.device
    so = _host(sample_offset).astype(np.float32)
    x, y = _pixel_grid(W, H, dev)
    px, py = x + float(so[0]), y + float(so[1])
    traversal = c.traversal or ("rows" if c.use_bvh else "brute")
    albedo = None  # None = the reference's always-zero albedo AOV
    zero = torch.zeros((), device=dev)
    iterations = None
    if driver == "mega":
        total, normal, depth, _, overflow, segs, rows, alb = render_waves(
            scene, px, py, to_bits(seeds), max_bounces=max_bounces, lane_sort=c.sort_lanes,
            shadow_tbl=resolve_shadow_tbl(c.mega_shadow),
            **({"phase_shrink": phase_shrink} if phase_shrink else {}),
        )
        if c.fixed_albedo:
            albedo = alb.reshape(H, W, 3)
        # total path segments (closest-hit casts); trace-table rows visited,
        # summed over paths (per-thread walks: not comparable with the
        # TPU's per-packet row unions)
        path_segments, rows_visited = segs.sum(), rows.sum()
    elif driver == "wavefront":
        lanes = min(c.wavefront_lanes, H * W)
        imgs = render_wavefront(
            scene, torch.stack([px, py], -1), seeds, (W, H), num_lanes=lanes,
            max_iters=max_bounces * max(1, H * W // lanes) + 64,
            max_path_bounces=max_bounces, traversal=traversal, leaf_size=c.leaf_size,
            sort_lanes=c.sort_lanes,
        )
        total, normal, depth, iterations = imgs.color, imgs.normal, imgs.depth, imgs.iterations
        overflow, path_segments, rows_visited = zero.long(), zero, zero
    else:
        o, d, tmin, tmax = camera_rays(scene.cam_position, scene.cam_rotation, scene.cam_fov,
                                       torch.stack([px, py], -1), (W, H))
        out = integrate(scene, o, d, tmin, tmax, seed_rng(seeds), max_bounces=max_bounces,
                        use_bvh=c.use_bvh, leaf_size=c.leaf_size, traversal=traversal,
                        albedo_aov=c.fixed_albedo)
        if c.fixed_albedo:
            albedo = out.albedo.reshape(H, W, 3)
        total, normal, depth, iterations = out.total, out.normal, out.depth, out.iterations
        overflow, path_segments, rows_visited = zero.long(), zero, zero
    total = total.reshape(H, W, 3).contiguous()
    normal = normal.reshape(H, W, 3).contiguous()
    if c.reconstruction_radius == 2 and albedo is None:
        delta = reconstruct(total, normal, so, block_size=c.block_size,
                            stddev=c.reconstruction_stddev)
    else:
        delta = reconstruct_sweep(
            total, normal, torch.zeros_like(total) if albedo is None else albedo, so,
            block_size=c.block_size, radius=c.reconstruction_radius,
            stddev=c.reconstruction_stddev,
        )
    stats = dict(
        # paths dropped by phase-capacity overflow (0 = unbiased)
        wave_overflow=overflow,
        mean_radiance=total.mean(),
        mean_depth=depth.mean(),
        path_segments=path_segments,
        rows_visited=rows_visited,
    )
    if iterations is not None:
        # bounce iterations of the sync loop / the wavefront pool
        stats["iterations"] = iterations
    return delta, stats


def _chained_config(*, width: int, height: int, block_size: int, max_bounces: int,
                    stddev: float, chain_cap: int = 8, mega_packet: int = 128,
                    mega_groups: int = 1, mega_table_hbm: bool = False,
                    mega_spec_resolve: bool = False, mega_trunk: int = 0, mega_window: int = 1,
                    mega_shadow_tbl: bool = False, interpret: bool = False) -> RenderConfig:
    """The ``RenderConfig`` of JAX's ``render_sweeps_chained`` keywords (its
    ``_render_sweeps_chained_jit``'s; ``phase_shrink`` is the port's
    parameter of that name)."""
    return _sweep_config(
        width=width, height=height, block_size=block_size, use_bvh=True,
        max_bounces=max_bounces, radius=2, stddev=stddev, leaf_size=1, driver="mega",
        mega_packet=mega_packet, mega_groups=mega_groups, mega_table_hbm=mega_table_hbm,
        mega_spec_resolve=mega_spec_resolve, mega_trunk=mega_trunk, mega_window=mega_window,
        mega_shadow_tbl=mega_shadow_tbl, chain_cap=chain_cap,
    )


def render_sweeps_chained(scene, block_seeds, sample_offsets, config: RenderConfig = None,
                          phase_shrink: tuple = (), **static_kwargs):
    """Trace S sweeps in one chained launch (``render_waves_chained``) and
    reconstruct each with its own jitter. ``block_seeds`` (S, bh, bw) u32,
    ``sample_offsets`` (S, 2) f32. Returns (film_delta (H, W, 4): the S
    sweeps' deltas summed in sweep order, stats: per-sweep averages).

    The port's form passes a ``MegaScene`` and ``config``; JAX's passes
    any ``CompiledScene`` (baked once, ``scene_of``) and JAX's static
    keywords (``_chained_config``) in place of ``config``, and runs on the
    scene's device (the card for a numpy scene)."""
    if config is None:
        config = _chained_config(**static_kwargs)
        scene = scene_of(scene, config.width, config.height, _scene_device(scene))
    elif static_kwargs:
        raise TypeError(f"render_sweeps_chained: config= and JAX's keywords "
                        f"{sorted(static_kwargs)} together")
    ms, c = scene, config
    H, W = c.height, c.width
    S = len(block_seeds)
    offs = _host(sample_offsets).astype(np.float32)
    pxs, pys, seeds = chunk_inputs(W, H, c.block_size, _host(block_seeds), offs, ms.rows.device)
    t, n, dep, _, overflow, segs, rows, _ = render_waves_chained(
        ms, pxs, pys, seeds, max_bounces=c.max_bounces,
        shadow_tbl=resolve_shadow_tbl(c.mega_shadow),
        **({"chain_cap": c.mega_chain_cap} if c.mega_chain_cap else {}),
        **({"phase_shrink": phase_shrink} if phase_shrink else {}),
    )
    # one K3 launch reconstructs the S sweeps and sums them in sweep order
    delta = reconstruct(t.reshape(S, H, W, 3), n.reshape(S, H, W, 3), offs,
                        block_size=c.block_size, stddev=c.reconstruction_stddev)
    stats = dict(
        wave_overflow=overflow,
        mean_radiance=t.mean(),
        mean_depth=dep.mean(),
        # per-sweep averages, so the metrics stay sweep-denominated; the
        # rows counter is per thread here (the TPU's is per packet and is
        # divided by 8*packet too)
        path_segments=segs.sum() / S,
        rows_visited=rows.sum() / S,
    )
    return delta, stats


class Renderer:
    """Progressive renderer over a compiled scene on ``device``."""

    def __init__(self, compiled: CompiledScene, config: RenderConfig, device="cuda"):
        check_config(config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda') needs a CUDA device")
        self.config = config
        if config.driver == "mega":
            self.scene = mega_scene(compiled, config.width, config.height, self.device)
        else:
            self.scene = to_device(compiled, self.device)
        self.scheduler = BlockScheduler(
            config.width, config.height, config.block_size, config.seed
        )
        self.film = torch.zeros(
            (config.height, config.width, 4), dtype=torch.float32, device=self.device
        )
        self.sweeps_done = 0
        self.metrics: dict = {}
        self._last_stats = None
        # chunks are pending settlement (save_checkpoint settles them first)
        self._rendering = False
        # optional host-span tracing (utils/tracing.SpanTracer; CLI
        # --trace-json): chunk dispatches, overflow check, film sync,
        # retries, checkpoint saves. None = no-op.
        self.tracer = None

    def _run_chunk(self, kind, block_seeds, offsets, phase_shrink):
        """One chunk: ("chained", (S, bh, bw) seeds, (S, 2) offsets) or
        ("sweep", (bh, bw) seeds, (2,) offset). Returns (delta, stats)."""
        run = render_sweeps_chained if kind == "chained" else render_sweep
        return run(self.scene, block_seeds, offsets, self.config, phase_shrink)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # What a render call traces and how its film accumulates. The
    # multi-device renderers (parallel/multichip.py) and the host stride
    # (parallel/multihost.py) override these.

    def _todo(self) -> list:
        """The sweeps this render call traces, in order."""
        return list(range(self.sweeps_done, self.config.spp))

    def _schedule(self, sweep: int):
        """The seeds and jitter of ``sweep`` (the scheduler draws in order)."""
        return self.scheduler.sweep(sweep)

    def _total(self) -> int:
        """The sweeps of the whole render (the progress callback's total)."""
        return self.config.spp

    def _chain(self) -> int:
        return resolve_chain_sweeps(self.config, sweeps_done=self.sweeps_done, device=self.device)

    def _snapshot(self):
        """The film as it stands, to rebuild from (an overflow retry)."""
        return self.film

    def _restore(self, snapshot) -> None:
        self.film = snapshot

    def _accumulate(self, delta) -> None:
        self.film = self.film + delta

    def render(self, progress: Optional[Callable[[int, int], None]] = None):
        """Run the remaining sweeps (all of them unless resumed)."""
        c = self.config
        start = time.monotonic()
        sweep_marks = []
        resume_start = self.sweeps_done
        todo = self._todo()
        chain = self._chain()
        ps = tuple(c.phase_shrink or ())
        # overflow == 0 is an INVARIANT: each chunk's inputs and overflow
        # counter are recorded; if any path was dropped by a phase-capacity
        # truncation, the pending chunks are re-rendered at full capacity
        # (phase_shrink 1, which cannot overflow) with the SAME seeds, so the
        # film is always the unbiased estimate. Settled once after the loop
        # (one host sync, never per chunk) and before any mid-render
        # checkpoint (save_checkpoint), so a checkpoint never holds a biased
        # film.
        self._ovf_film_start = self._snapshot()
        self._ovf_records: list = []
        self._ovf_counters: list = []
        self._ovf_retried_total = 0
        self._rendering = True
        i = 0
        while i < len(todo):
            n_chunk = min(chain, len(todo) - i) if chain > 1 else 1
            ids = todo[i:i + n_chunk]
            if n_chunk > 1:
                # one chained launch traces n_chunk sweeps; their deltas are
                # summed in sweep order before the film add
                scheds = [self._schedule(si) for si in ids]
                rec = ("chained", np.stack([sc.block_seeds for sc in scheds]),
                       np.stack([sc.sample_offset for sc in scheds]))
                span = maybe_span(self.tracer, "dispatch chained chunk",
                                  sweeps=f"{ids[0]}..{ids[-1]}")
            else:
                sched = self._schedule(ids[0])
                rec = ("sweep", sched.block_seeds, sched.sample_offset)
                span = maybe_span(self.tracer, "dispatch sweep", sweep=ids[0])
            with span:
                delta, stats = self._run_chunk(*rec, ps)
            self._last_stats = stats
            self._ovf_records.append(rec)
            self._ovf_counters.append(stats["wave_overflow"])
            self._accumulate(delta)
            i += n_chunk
            prev_done = self.sweeps_done
            self.sweeps_done += n_chunk
            done = self.sweeps_done
            if progress is not None:
                progress(done, self._total())
            # interval CROSSINGS, not modulo: a chunk advances sweeps_done by
            # n_chunk, so "done % interval == 0" could skip every preview
            if c.preview_interval and (
                prev_done // c.preview_interval != done // c.preview_interval
            ):
                self.save_png(c.preview_path)
            if c.live_preview and prev_done // c.live_preview != done // c.live_preview:
                self._term_preview().update(self.image(), f"{done}/{self._total()} sweeps")
            sweep_marks.append(time.monotonic() - start)
        with maybe_span(self.tracer, "overflow check (host sync)") as sp:
            self._settle_overflow()
            sp["overflow"] = self._ovf_retried_total
        seen = self._ovf_retried_total
        self._rendering = False
        with maybe_span(self.tracer, "film ready"):
            self._sync()
        elapsed = time.monotonic() - start
        # only the sweeps traced in THIS call (after a resume the loop starts
        # at resume_start)
        sweeps_traced = self.sweeps_done - resume_start
        primary_rays = c.width * c.height * sweeps_traced
        rate = primary_rays / elapsed if elapsed > 0 else 0.0
        self.metrics = dict(
            render_seconds=elapsed,
            primary_rays=primary_rays,
            rays_per_second=rate,
            mrays_per_second=rate / 1e6,
            spp_per_second=sweeps_traced / elapsed if elapsed > 0 else 0.0,
            # one mark per chunk (host clock at dispatch)
            sweep_marks=sweep_marks,
            chain_chunk_sweeps=chain if chain > 1 else 1,
        )
        if self._last_stats is not None:
            st = self._last_stats
            # the overflow of the film as accumulated: 0 when nothing dropped
            # and after a full-capacity re-render; overflow_retried says how
            # many paths the discarded attempts dropped
            self.metrics["wave_overflow"] = 0 if seen else int(st["wave_overflow"])
            self.metrics["overflow_retried"] = seen
            segs = float(st["path_segments"])
            if segs > 0:
                self.metrics["path_segments_last_sweep"] = segs
                self.metrics["mean_path_length"] = segs / (c.width * c.height)
            if "iterations" in st:
                self.metrics["iterations_last_sweep"] = int(st["iterations"])
            rows = float(st["rows_visited"])
            if rows > 0:
                self.metrics["rows_visited_last_sweep"] = rows
                # sweeps traced in this call (the JAX renderer multiplies by
                # c.spp, which overstates the rate after a resume)
                self.metrics["mrows_per_second"] = (
                    rows * sweeps_traced / elapsed / 1e6 if elapsed > 0 else 0.0
                )
        if self.tracer is not None:
            self.tracer.counter(
                "throughput",
                mrays_per_s=self.metrics["mrays_per_second"],
                spp_per_s=self.metrics["spp_per_second"],
            )
        return self.metrics

    def _settle_overflow(self) -> int:
        """Enforce overflow == 0 on the pending chunks: one host read sums
        their counters; if any path was dropped, the film is rebuilt from the
        recorded seeds at full capacity (phase_shrink 1). Runs at the end of
        render() and before a mid-render checkpoint; resets the pending
        state."""
        counters = self._ovf_counters
        if not counters:
            return 0
        seen = int(torch.stack(counters).sum())
        if seen:
            self._restore(self._ovf_film_start)
            self._rerender(self._ovf_records, seen)
            self._ovf_retried_total += seen
        self._ovf_film_start = self._snapshot()
        self._ovf_records = []
        self._ovf_counters = []
        return seen

    def _rerender(self, records, seen: int) -> None:
        """Trace every recorded chunk ((kind, seeds, offsets), as
        ``_run_chunk`` takes it) again at full capacity (phase_shrink 1,
        which cannot overflow) with the same seeds, adding each delta to
        the film as it stands (the caller has set it back): ``seen``
        dropped paths make the film unbiased again."""
        import warnings

        warnings.warn(
            f"{seen} paths exceeded wavefront phase capacity; re-rendering "
            "every pending chunk at full capacity (phase_shrink=1) with the "
            "same seeds, so the film stays unbiased"
        )
        for kind, a, b in records:
            with maybe_span(self.tracer, "retry chunk (full capacity)", kind=kind):
                delta, stats = self._run_chunk(kind, a, b, (1,) * 8)
            self._last_stats = stats
            self._accumulate(delta)

    def _term_preview(self):
        if not hasattr(self, "_term_preview_obj"):
            from hijiki_tpu_torch.utils.term_preview import TerminalPreview

            self._term_preview_obj = TerminalPreview()
        return self._term_preview_obj

    def image(self) -> np.ndarray:
        """Normalized (H, W, 3) float RGB."""
        return normalize_film(self.film).cpu().numpy()

    def save_exr(self, path: str) -> None:
        write_exr(path, self.image())

    def save_png(self, path: str) -> None:
        write_png(path, self.image())

    # --- checkpoint / resume ---

    def save_checkpoint(self, path: str) -> None:
        """Save the film, the sweep cursor and the config as npz at ``path``.
        A mid-render save (from the progress callback) settles pending
        overflow first, so the saved film is never biased."""
        if self._rendering:
            self._settle_overflow()
        with maybe_span(self.tracer, "checkpoint save", path=path):
            with open(path, "wb") as f:  # np.savez(path) would append ".npz"
                np.savez(
                    f,
                    film=self.film.cpu().numpy(),
                    sweeps_done=self.sweeps_done,
                    config=json.dumps(dataclasses.asdict(self.config)),
                )

    @classmethod
    def resume_checkpoint(
        cls,
        compiled: CompiledScene,
        path: str,
        config: "RenderConfig | None" = None,
        device="cuda",
        **kwargs,
    ) -> "Renderer":
        """Resume a checkpointed render. ``config`` may override the saved
        one (a higher spp renders the extra sweeps), but the fields that
        shape the accumulated film (``_CHECKPOINT_FIXED``) must match. The
        checkpoint holds the whole film, so a render saved by one renderer
        class (or device count) resumes in another; ``kwargs`` go to
        ``cls`` (``num_devices``, ``devices``, ``host_id``, ...)."""
        data = np.load(path, allow_pickle=False)
        saved = json.loads(str(data["config"]))
        saved["phase_shrink"] = tuple(saved.get("phase_shrink") or ())  # JSON gave a list
        ckpt_config = RenderConfig(**saved)
        if config is not None:
            for f in _CHECKPOINT_FIXED:
                a, b = getattr(config, f), getattr(ckpt_config, f)
                if a != b:
                    raise ValueError(
                        f"checkpoint resume: {f}={a!r} conflicts with the "
                        f"checkpointed render's {f}={b!r}"
                    )
        r = cls(compiled, config or ckpt_config, device=device, **kwargs)
        r._resume(torch.from_numpy(data["film"]), int(data["sweeps_done"]))
        return r

    def _resume(self, film, sweeps_done: int) -> None:
        self.film = film.to(self.device)
        self.sweeps_done = sweeps_done
        # replay the scheduler so the remaining sweeps get the seeds they
        # would have had uninterrupted
        for s in range(sweeps_done):
            self.scheduler.sweep(s)
