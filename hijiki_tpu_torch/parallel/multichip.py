"""Multi-device rendering: one process over a list of ``torch.device``s.

Port of ``hijiki_tpu/parallel/multichip.py``. JAX shards a sweep over a
1-D device mesh from one controller; here one process drives a list of
devices, each with its own copy of the scene and its own stream, and the
list may name one device twice (two bands on one card, the counterpart of
the tests' virtual 8-device CPU mesh). Sample accumulation is associative
addition, and each path is traced alone, so a sharded film equals the
single-device film up to the order of its float sums. Two layouts:

* ``MultiChipRenderer`` (the sync driver): each sweep's static block list,
  padded with dummy blocks to a multiple of the device count, is split into
  contiguous shares; each device traces its blocks through
  ``ops/integrate.py`` (``rows``/``packet`` walk with K6 on a card) and
  reconstructs them into a full-size partial film whose unrendered pixels
  carry sample weight 0; the partials are summed into the film.
* ``MegaMultiChipRenderer`` (the mega driver): the frame splits into row
  bands, one a device; each band traces its pixels with ``render_waves``
  (K1, K2) or, chained, ``render_waves_chained`` (K4, K2), and
  reconstructs them with K3 on a canvas extended by one block above and
  below, at sample weight 0 there. A sample splats at most R rows beyond
  its band, into pixels whose center features the reference zeroes
  anyway ("spill"), so each band's R-row edge strips are exact and are
  added into its neighbours' bands; only those O(R W) strips cross
  devices. Each band's film stays on its device and is concatenated once,
  at readback.

Both ride ``Renderer.render``: the same chunk loop, chain policy
(``resolve_chain_sweeps``), previews, checkpoints and overflow invariant.
``Renderer._settle_overflow``, like JAX's ``settle_mega_overflow`` (here
too, over a renderer's list of sweeps), makes one host read of the chunks'
summed counters (every band's), and on any drop every recorded chunk is
traced again at full capacity on every band (``Renderer._rerender``).
JAX's function forms, ``make_sharded_sweep`` and
``make_sharded_mega_sweep``, take a list of devices in place of a mesh and
run the classes' one share and band implementation. Per-sweep RNG comes
from the same host schedule as the single device, so the device count
never changes the estimate. No band falls back to the CPU: a failed build
or launch raises.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from hijiki_tpu_torch.ops.camera import camera_rays
from hijiki_tpu_torch.ops.integrate import integrate
from hijiki_tpu_torch.ops.megakernel import (
    _seed_bits, mega_scene, render_waves, render_waves_chained,
)
from hijiki_tpu_torch.ops.rng import MASK32, seed_rng
from hijiki_tpu_torch.render.blocks import upload
from hijiki_tpu_torch.render.pallas_reconstruct import R as RADIUS, reconstruct
from hijiki_tpu_torch.render.reconstruct import reconstruct_sweep
from hijiki_tpu_torch.render.renderer import (
    RenderConfig, Renderer, chunk_inputs, resolve_shadow_tbl,
)
from hijiki_tpu_torch.scene.compile import CompiledScene, to_device
from hijiki_tpu_torch.utils.tracing import maybe_span


def resolve_devices(num_devices: Optional[int] = None, devices=None, device="cuda") -> list:
    """The devices to render on: ``devices`` as given (a name may repeat),
    else the first ``num_devices`` CUDA devices (all of them for None or 0;
    more than ``torch.cuda.device_count()`` raises), or ``num_devices``
    entries of the CPU for ``device="cpu"``."""
    if devices is None:
        device = torch.device(device)
        if device.type == "cuda":
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            n = num_devices or count
            if not 0 < n <= count:
                raise ValueError(f"{n or 'all'} CUDA devices asked for, {count} present")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [device] * (num_devices or 1)
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("devices: an empty list")
    for d in devices:
        if d.type == "cuda":
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if (d.index or 0) >= count:
                raise ValueError(f"{d} asked for, {count} CUDA devices present")
    return [torch.device("cuda", d.index or 0) if d.type == "cuda" else d for d in devices]


def _sync_config(*, width: int, height: int, block_size: int, use_bvh: bool, max_bounces: int,
                 radius: int, stddev: float, leaf_size: int) -> RenderConfig:
    """The ``RenderConfig`` of JAX's ``trace_blocks``/``make_sharded_sweep``
    keywords."""
    return RenderConfig(width=width, height=height, block_size=block_size, use_bvh=use_bvh,
                        max_bounces=max_bounces, reconstruction_radius=radius,
                        reconstruction_stddev=stddev, leaf_size=leaf_size, driver="sync")


def trace_blocks(scene, origins, dims, seeds, sample_offset, config: RenderConfig = None,
                 **jax_kwargs):
    """Trace k blocks (block_size^2 lanes each) of one sweep and
    reconstruct them into a full-size partial film delta (H, W, 4): the
    unit each device runs. ``scene``: a device ``CompiledScene``; origins,
    dims (k, 2) int block origins (x, y) and clipped dims (w, h), a dummy
    block at (W, H); seeds (k,) u32 block seeds. Returns (delta, bounce
    iterations).

    JAX's keyword form passes ``width``, ``height``, ``block_size``,
    ``use_bvh``, ``max_bounces``, ``radius``, ``stddev`` and ``leaf_size``
    (``_sync_config``) in place of ``config`` and returns the delta alone,
    as JAX's does."""
    if config is None:
        return _trace_blocks(scene, origins, dims, seeds, sample_offset,
                             _sync_config(**jax_kwargs))[0]
    if jax_kwargs:
        raise TypeError(f"trace_blocks: config= and JAX's keywords {sorted(jax_kwargs)} together")
    return _trace_blocks(scene, origins, dims, seeds, sample_offset, config)


def _trace_blocks(scene, origins, dims, seeds, sample_offset, config: RenderConfig):
    c = config
    dev = scene.trace_rows.device
    H, W, B = c.height, c.width, c.block_size
    k = len(origins)
    org = upload(np.asarray(origins, np.int64), dev)
    clip_w = upload(np.asarray(dims, np.int64)[:, 0], dev)
    ly = torch.arange(B, device=dev).view(1, B, 1)
    lx = torch.arange(B, device=dev).view(1, 1, B)
    gx, gy = torch.broadcast_tensors(org[:, 0, None, None] + lx, org[:, 1, None, None] + ly)
    # per-pixel seed = block_seed + lx + ly * clipped block width
    # (render.glsl:156-157)
    bs = upload(np.asarray(seeds, np.uint32).astype(np.int64), dev)
    state = seed_rng(((bs[:, None, None] + lx + ly * clip_w[:, None, None]) & MASK32).reshape(-1))
    so = np.asarray(sample_offset, np.float32)
    px = torch.stack([gx.float() + float(so[0]), gy.float() + float(so[1])], -1).reshape(-1, 2)
    o, d, tmin, tmax = camera_rays(scene.cam_position, scene.cam_rotation, scene.cam_fov, px,
                                   (W, H))
    out = integrate(scene, o, d, tmin, tmax, state, max_bounces=c.max_bounces,
                    use_bvh=c.use_bvh, leaf_size=c.leaf_size,
                    traversal=c.traversal or ("rows" if c.use_bvh else "brute"),
                    albedo_aov=c.fixed_albedo)

    # the tiles into a canvas padded by a block (it absorbs the dummy blocks
    # at (W, H) and edge blocks' overdraw), then cropped
    flat = (gy * (W + B) + gx).reshape(-1)

    def scatter(tiles):
        canvas = tiles.new_zeros(((H + B) * (W + B), tiles.shape[-1]))
        canvas[flat] = tiles
        return canvas.view(H + B, W + B, -1)[:H, :W].contiguous()

    color, normal = scatter(out.total), scatter(out.normal)
    ones = scatter(torch.ones((k * B * B, 1), device=dev))[..., 0].contiguous()
    if c.reconstruction_radius == 2 and not c.fixed_albedo:
        delta = reconstruct(color, normal, so, block_size=B, stddev=c.reconstruction_stddev,
                            sample_weight=ones)
    else:
        delta = reconstruct_sweep(color, normal, scatter(out.albedo), so, block_size=B,
                                  radius=c.reconstruction_radius,
                                  stddev=c.reconstruction_stddev, sample_weight=ones)
    return delta, out.iterations


# a side stream a (device, band), one set a process: a renderer made after
# another takes over its streams, and with them the memory the caching
# allocator keeps for them (a fresh stream's first allocations go to
# cudaMalloc, which waits for the card)
_STREAMS: dict = {}


def _band_stream(device, band: int):
    key = (device.index, band)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device)
    return _STREAMS[key]


class _MultiDevice(Renderer):
    """What both layouts share: the device list, a stream a band, the
    synchronisation of every device, the device count in the metrics."""

    def __init__(self, compiled: CompiledScene, config: RenderConfig, devices: list):
        self.devices = devices
        self.n_dev = len(devices)
        super().__init__(compiled, config, device=devices[0])
        self._streams = [_band_stream(d, i) if d.type == "cuda" else None
                         for i, d in enumerate(devices)]

    def _on(self, i: int):
        """Band i's context: its device, and its own stream, which first
        waits for what that device's current stream has queued (the film,
        and the reads of the band's last outputs, whose memory it reuses)."""
        s = self._streams[i]
        if s is None:
            return contextlib.nullcontext()
        d = self.devices[i]
        s.wait_stream(torch.cuda.current_stream(d))
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(d))
        stack.enter_context(torch.cuda.stream(s))
        return stack

    def _join(self) -> None:
        """Each device's current stream waits for its bands' streams."""
        for d, s in zip(self.devices, self._streams):
            if s is not None:
                torch.cuda.current_stream(d).wait_stream(s)

    def _sync(self):
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def render(self, progress=None):
        m = super().render(progress)
        m["devices"] = self.n_dev
        return m


class MultiChipRenderer(_MultiDevice):
    """The sync driver with each sweep's blocks sharded over devices. The
    ``wavefront`` driver traces the same estimator through the sync
    integrator here, as in JAX; the mega driver has
    ``MegaMultiChipRenderer``."""

    def __init__(self, compiled: CompiledScene, config: RenderConfig,
                 num_devices: Optional[int] = None, devices=None, device="cuda"):
        if config.driver == "mega":
            raise ValueError("MultiChipRenderer traces the sync driver; the mega driver "
                             "shards with MegaMultiChipRenderer")
        super().__init__(compiled, config, resolve_devices(num_devices, devices, device))
        self.scenes = [self.scene] + [to_device(compiled, d) for d in self.devices[1:]]
        c = config
        # the static block list (origins, clipped dims), padded to a
        # multiple of the device count with dummy blocks at (W, H)
        ox, oy = np.meshgrid(np.arange(0, c.width, c.block_size),
                             np.arange(0, c.height, c.block_size))
        origins = np.stack([ox.ravel(), oy.ravel()], axis=-1).astype(np.int32)
        dims = np.stack([np.minimum(c.block_size, c.width - origins[:, 0]),
                         np.minimum(c.block_size, c.height - origins[:, 1])],
                        axis=-1).astype(np.int32)
        self.n_real_blocks = origins.shape[0]
        pad = (-origins.shape[0]) % self.n_dev
        if pad:
            origins = np.concatenate([origins, np.tile([[c.width, c.height]], (pad, 1))])
            dims = np.concatenate([dims, np.ones((pad, 2), np.int32)])
        self.block_origins = origins.astype(np.int32)
        self.block_dims = dims

    def _chain(self) -> int:
        return 1

    def _run_chunk(self, kind, block_seeds, sample_offset, phase_shrink):
        """One sweep of the static block list (its seeds padded with 0 for
        the dummy blocks)."""
        seeds = np.asarray(block_seeds, np.uint32).reshape(-1)
        seeds = np.concatenate([seeds, np.zeros(len(self.block_origins) - len(seeds), np.uint32)])
        return self._run_shares(self.block_origins, self.block_dims, seeds, sample_offset)

    def _run_shares(self, origins, dims, seeds, sample_offset):
        """Each device traces its contiguous share of the blocks (k a
        multiple of the device count); the partial films are summed on the
        first device. Returns (delta, stats)."""
        k = len(origins) // self.n_dev
        deltas, iterations = [], []
        for i, scene in enumerate(self.scenes):
            share = slice(i * k, (i + 1) * k)
            with self._on(i):
                delta, it = _trace_blocks(scene, origins[share], dims[share], seeds[share],
                                          sample_offset, self.config)
            deltas.append(delta)
            iterations.append(it)
        self._join()
        delta = deltas[0]
        for d in deltas[1:]:
            delta = delta + d.to(self.device, non_blocking=True)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        # the sync integrator drops no path and counts no segments
        return delta, dict(wave_overflow=zero, path_segments=zero, rows_visited=zero,
                           iterations=max(iterations))


class MegaMultiChipRenderer(_MultiDevice):
    """The mega driver with the frame sharded in row bands, one a device."""

    def __init__(self, compiled: CompiledScene, config: RenderConfig,
                 num_devices: Optional[int] = None, devices=None, device="cuda",
                 interpret: Optional[bool] = None):
        # interpret: JAX's choice of the TPU interpreter; the devices decide
        c = config
        if c.driver != "mega":
            raise ValueError("MegaMultiChipRenderer renders with the mega driver "
                             f"(config.driver={c.driver!r})")
        if c.reconstruction_radius != 2 or c.fixed_albedo:
            raise ValueError("MegaMultiChipRenderer reconstructs with K3: radius 2, no albedo")
        devices = resolve_devices(num_devices, devices, device)
        if c.height % len(devices):
            raise ValueError("height must divide evenly into device bands")
        self.band = c.height // len(devices)
        if self.band % c.block_size:
            # reconstruction blocks must not straddle bands: the filter reads
            # a block's center features from the band that owns it
            raise ValueError(
                f"band height {self.band} must be a multiple of block_size {c.block_size}"
            )
        super().__init__(compiled, config, devices)
        self.scenes = [self.scene] + [mega_scene(compiled, c.width, c.height, d)
                                      for d in self.devices[1:]]
        B = c.block_size
        # the band canvas' sample weight: 1 on the band's rows, 0 on the
        # block of padding above and below (it holds no samples)
        self._weights = [F.pad(torch.ones((self.band, c.width), device=d), (0, 0, B, B))
                         for d in self.devices]

    # the film: a band a device, concatenated at readback
    @property
    def film(self):
        return torch.cat([f.to(self.device) for f in self._bands])

    @film.setter
    def film(self, value):
        b = self.band
        self._bands = [value[i * b:(i + 1) * b].to(d).contiguous()
                       for i, d in enumerate(self.devices)]

    def _snapshot(self):
        return list(self._bands)

    def _restore(self, snapshot) -> None:
        self._bands = list(snapshot)

    def _accumulate(self, delta) -> None:
        self._bands = [f + d for f, d in zip(self._bands, delta)]

    def _run_chunk(self, kind, block_seeds, offsets, phase_shrink):
        """One chunk on every band: ("sweep", (bh, bw) seeds, (2,) offset)
        or ("chained", (S, bh, bw), (S, 2)), each band's inputs expanded on
        its device (``_run_bands``)."""
        c = self.config
        if kind == "sweep":
            block_seeds, offsets = np.asarray(block_seeds)[None], np.asarray(offsets)[None]
        offs = np.asarray(offsets, np.float32)
        return self._run_bands(
            lambda i: chunk_inputs(c.width, self.band, c.block_size, block_seeds, offs,
                                   self.devices[i], row0=i * self.band),
            offs, phase_shrink)

    def _run_bands(self, inputs, offs, phase_shrink):
        """S sweeps on every band: ``inputs(i)`` gives band i's pxs, pys (S,
        band * W) f32 and seeds (S, band * W) int32 u32 bits on its device;
        one sweep is traced by render_waves, S > 1 by one
        render_waves_chained; each band's S sweeps reconstructed in one K3
        launch on its extended canvas, then the halo exchange. Returns (the
        bands' deltas, stats with the overflow summed over bands)."""
        c = self.config
        B, band, W = c.block_size, self.band, c.width
        S = len(offs)
        kw = dict(max_bounces=c.max_bounces, shadow_tbl=resolve_shadow_tbl(c.mega_shadow),
                  **({"phase_shrink": phase_shrink} if phase_shrink else {}))
        if S > 1 and c.mega_chain_cap:
            kw["chain_cap"] = c.mega_chain_cap
        exts, ovfs, segs, rows = [], [], [], []
        for i, ms in enumerate(self.scenes):
            with self._on(i):
                pxs, pys, seeds = inputs(i)
                if S == 1:
                    out = render_waves(ms, pxs[0], pys[0], seeds[0], lane_sort=c.sort_lanes, **kw)
                else:
                    out = render_waves_chained(ms, pxs, pys, seeds, **kw)
                pad = lambda a: F.pad(a.reshape(S, band, W, 3), (0, 0, 0, 0, B, B))
                exts.append(reconstruct(pad(out[0]), pad(out[1]), offs, block_size=B,
                                        stddev=c.reconstruction_stddev,
                                        sample_weight=self._weights[i]))
                ovfs.append(out[4])
                segs.append(out[5].sum() / S)
                rows.append(out[6].sum() / S)
        self._join()
        to0 = lambda ts: sum(t.to(self.device, non_blocking=True) for t in ts)
        return self._exchange(exts), dict(wave_overflow=to0(ovfs), path_segments=to0(segs),
                                          rows_visited=to0(rows))

    def _exchange(self, exts):
        """Each band's own rows of its (band + 2B, W, 4) canvas delta (the
        sum over a chunk's sweeps: strips add, so a chained chunk pays one
        exchange), with its neighbours' R-row spill strips added: the strip
        below the band above, the strip above the band below. The first
        band's upper strip and the last band's lower one lie outside the
        frame and are dropped, as the full-frame filter clips them."""
        B, band, R = self.config.block_size, self.band, RADIUS
        own = [e[B:B + band] for e in exts]
        for i, d in enumerate(self.devices):
            if i > 0:
                own[i][:R] += exts[i - 1][B + band:B + band + R].to(d, non_blocking=True)
            if i + 1 < self.n_dev:
                own[i][band - R:] += exts[i + 1][B - R:B].to(d, non_blocking=True)
        return own


# ----------------------------------------------------------------------------
# JAX's function forms: a sweep function over a device list
# ----------------------------------------------------------------------------
# JAX builds a shard_map'ed function over a Mesh; here the first argument is
# the list of devices (None: every visible CUDA device; a name may repeat),
# since the port imports no jax. Each function runs the renderer classes'
# one implementation of a share or a band (_run_shares, _run_bands) on a
# renderer it builds once, and is called with JAX's arguments, the scene it
# was made for first.


def _check_scene(made_for, scene) -> None:
    if scene is not made_for:
        raise ValueError("the sweep function was made for another scene object")


def make_sharded_sweep(devices, scene: CompiledScene, **kwargs):
    """JAX's ``make_sharded_sweep``: the sync driver's sweep over
    ``devices``. ``kwargs``: ``trace_blocks``' JAX keywords. Returns
    ``fn(scene, origins, dims, seeds, sample_offset)``, which traces the
    blocks (their count a multiple of the device count; contiguous shares,
    one a device) and returns the assembled (H, W, 4) delta on the first
    device, as JAX's returns its film (the sync integrator drops no path,
    so there is no overflow to sum)."""
    r = MultiChipRenderer(scene, _sync_config(**kwargs), devices=resolve_devices(None, devices))

    def sweep(scene_, origins, dims, seeds, sample_offset):
        _check_scene(scene, scene_)
        origins, dims = np.asarray(origins, np.int32), np.asarray(dims, np.int32)
        if len(origins) % r.n_dev:
            raise ValueError(f"{len(origins)} blocks do not shard over {r.n_dev} devices")
        return r._run_shares(origins, dims, np.asarray(seeds, np.uint32),
                             np.asarray(sample_offset, np.float32))[0]

    return sweep


def make_sharded_mega_sweep(devices, scene: CompiledScene, *, width: int, height: int,
                            block_size: int, max_bounces: int, stddev: float,
                            interpret: bool = False, packet: int = 128, groups: int = 1,
                            table_in_hbm: bool = False, trunk_rows: int = 0,
                            shadow_tbl: bool = False, phase_shrink: tuple = (),
                            n_sweeps: int = 1, seeds_from_blocks: bool = False,
                            chain_cap: int = 8):
    """JAX's ``make_sharded_mega_sweep``: the mega driver's row bands over
    ``devices``, one a device (``height`` divisible by their count, a band
    a multiple of ``block_size``). Returns, with ``seeds_from_blocks``,
    ``fn(scene, block_seeds (S, bh, bw), sample_offsets (S, 2))`` (S =
    ``n_sweeps``; S > 1 chains them, capped at ``chain_cap``), else
    ``fn(scene, px, py, seeds (H * W,), sample_offset (2,))``; either gives
    (the assembled (H, W, 4) delta on the first device, the overflow summed
    over the bands). The walker kwargs are accepted as ``render_waves``
    accepts them; ``interpret`` routes nothing."""
    config = RenderConfig(
        width=width, height=height, block_size=block_size, max_bounces=max_bounces,
        reconstruction_stddev=stddev, driver="mega", mega_packet=packet, mega_groups=groups,
        mega_trunk=trunk_rows, mega_shadow=1 if shadow_tbl else -1, mega_chain_cap=chain_cap,
    )
    r = MegaMultiChipRenderer(scene, config, devices=resolve_devices(None, devices))
    band = r.band
    ps = tuple(phase_shrink or ())

    def assemble(out):
        deltas, stats = out
        return torch.cat([d.to(r.device) for d in deltas]), stats["wave_overflow"]

    def from_blocks(scene_, block_seeds, sample_offsets):
        _check_scene(scene, scene_)
        bs = np.asarray(block_seeds, np.uint32).reshape((n_sweeps,) + np.shape(block_seeds)[-2:])
        offs = np.asarray(sample_offsets, np.float32).reshape(n_sweeps, 2)
        return assemble(r._run_bands(
            lambda i: chunk_inputs(width, band, block_size, bs, offs, r.devices[i],
                                   row0=i * band),
            offs, ps))

    def from_pixels(scene_, px, py, seeds, sample_offset):
        _check_scene(scene, scene_)
        px, py = torch.as_tensor(px, dtype=torch.float32), torch.as_tensor(py, dtype=torch.float32)
        seeds = torch.as_tensor(np.asarray(seeds, np.uint32).view(np.int32)) \
            if not isinstance(seeds, torch.Tensor) else _seed_bits(seeds)
        n = band * width

        def inputs(i):
            part = slice(i * n, (i + 1) * n)
            return tuple(a[part].to(r.devices[i]).contiguous()[None] for a in (px, py, seeds))

        offs = np.asarray(sample_offset, np.float32).reshape(1, 2)
        return assemble(r._run_bands(inputs, offs, ps))

    return from_blocks if seeds_from_blocks else from_pixels


def settle_mega_overflow(renderer, scheds, ovfs, film_start, tracer=None) -> int:
    """JAX's ``settle_mega_overflow``: one host read sums the sweeps'
    overflow counters ``ovfs``; if any path was dropped, ``renderer``'s
    film restarts at ``film_start`` and every schedule of ``scheds`` is
    traced again, a sweep a chunk, at full capacity (phase_shrink 1) with
    the same seeds (``Renderer._rerender``, which ``Renderer.render``'s own
    settle runs too). Returns the number of dropped paths (0 = no
    retry)."""
    with maybe_span(tracer, "overflow check (host sync)") as sp:
        seen = int(torch.stack([o.to(ovfs[0].device) for o in ovfs]).sum()) if ovfs else 0
        sp["overflow"] = seen
    if seen:
        renderer.film = film_start
        renderer._rerender([("sweep", s.block_seeds, s.sample_offset) for s in scheds], seen)
    return seen
