"""Regenerating wavefront driver: stream compaction by path regeneration.

Port of ``hijiki_tpu/render/wavefront.py``. A fixed pool of lanes runs the
sync driver's ``bounce_step`` over a queue of (pixel, sample) items: when a
lane's path ends, its results are scattered to the item's slot and the lane
is reloaded with the queue's next camera ray, so occupancy stays near full
instead of decaying with the Russian-roulette tail. Optionally, lanes are
sorted between bounces by (direction octant, origin cell), dead lanes
first (``torch.argsort(stable=True)``, the counterpart of the JAX
package's XLA argsort).

Each item consumes exactly the RNG stream of its own seed, whatever lane or
iteration runs it, so the film equals the sync driver's up to summation
order. The loop runs on the host: one device read per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hijiki_tpu_torch.ops import rng
from hijiki_tpu_torch.ops.camera import camera_rays
from hijiki_tpu_torch.ops.integrate import bounce_step, make_intersectors


class WavefrontImages(NamedTuple):
    color: torch.Tensor  # (Q,3) per-queue-item radiance
    normal: torch.Tensor  # (Q,3)
    depth: torch.Tensor  # (Q,)
    iterations: int = 0


def render_wavefront(
    scene,
    pixel_xy,  # (Q,2) f32: sample positions (pixel + jitter), queue order
    seeds,  # (Q,) int64 holding u32: per-item RNG seeds
    image_dim,  # (width, height) for the camera model
    *,
    num_lanes: int,
    max_iters: int = 4096,
    max_path_bounces: int = 1000,
    traversal: str = "rows",
    leaf_size: int = 1,
    sort_lanes: bool = False,
) -> WavefrontImages:
    """Trace every queue item to completion with a regenerating lane pool."""
    f32 = torch.float32
    dev = pixel_xy.device
    Q, L = pixel_xy.shape[0], num_lanes
    image_dim = torch.as_tensor(image_dim, dtype=f32).to(dev)  # once, not per refill
    intersect, occluded = make_intersectors(scene, traversal, leaf_size)

    lanes = dict(
        bounce=torch.zeros(L, dtype=torch.int32, device=dev),
        o=torch.zeros((L, 3), dtype=f32, device=dev),
        d=torch.ones((L, 3), dtype=f32, device=dev),
        tmin=torch.zeros(L, dtype=f32, device=dev),
        tmax=torch.zeros(L, dtype=f32, device=dev),
        state=torch.zeros(L, dtype=torch.int64, device=dev),
        total=torch.zeros((L, 3), dtype=f32, device=dev),
        throughput=torch.zeros((L, 3), dtype=f32, device=dev),
        extinction=torch.zeros((L, 3), dtype=f32, device=dev),
        was_discrete=torch.zeros(L, dtype=torch.bool, device=dev),
        alive=torch.zeros(L, dtype=torch.bool, device=dev),
        depth=torch.zeros(L, dtype=f32, device=dev),
        normal=torch.zeros((L, 3), dtype=f32, device=dev),
    )
    item = torch.full((L,), -1, dtype=torch.int64, device=dev)  # queue item per lane
    queue_head = torch.zeros((), dtype=torch.int64, device=dev)
    # one trash row past the Q items: JAX's scatter-add with mode="drop"
    # discards updates at index Q, which torch would refuse
    out_color = torch.zeros((Q + 1, 3), dtype=f32, device=dev)
    out_normal = torch.zeros((Q + 1, 3), dtype=f32, device=dev)
    out_depth = torch.zeros(Q + 1, dtype=f32, device=dev)

    def flush(flush_mask):
        """Scatter finished lanes' results to their queue items."""
        tgt = torch.where(flush_mask & (item >= 0), item, Q)
        out_color.index_add_(0, tgt, lanes["total"])
        out_normal.index_add_(0, tgt, lanes["normal"])
        out_depth.index_add_(0, tgt, lanes["depth"])

    root_min = scene.bvh_aabb_min[0]
    root_span = torch.clamp_min(scene.bvh_aabb_max[0] - root_min, 1e-6)

    iteration = 0
    while iteration < max_iters and bool((queue_head < Q) | lanes["alive"].any()):
        # flush lanes that ended last iteration; a flushed lane forgets its
        # item unless it is refilled below
        flush(~lanes["alive"])
        item = torch.where(lanes["alive"], item, -1)

        # refill dead lanes from the queue
        dead = ~lanes["alive"]
        rank = torch.cumsum(dead.long(), 0) - 1
        fetch = queue_head + rank
        take = dead & (fetch < Q)
        fetch_c = torch.clamp(fetch, 0, Q - 1)
        o, d, tmin, tmax = camera_rays(scene.cam_position, scene.cam_rotation, scene.cam_fov,
                                       pixel_xy[fetch_c], image_dim)
        st = rng.seed_rng(seeds[fetch_c])
        t3 = take[..., None]
        lanes = dict(
            bounce=torch.where(take, 0, lanes["bounce"]),
            o=torch.where(t3, o, lanes["o"]),
            d=torch.where(t3, d, lanes["d"]),
            tmin=torch.where(take, tmin, lanes["tmin"]),
            tmax=torch.where(take, tmax, lanes["tmax"]),
            state=torch.where(take, st, lanes["state"]),
            total=torch.where(t3, 0.0, lanes["total"]),
            throughput=torch.where(t3, 1.0, lanes["throughput"]),
            extinction=torch.where(t3, 0.0, lanes["extinction"]),
            was_discrete=lanes["was_discrete"] | take,
            alive=lanes["alive"] | take,
            depth=torch.where(take, 0.0, lanes["depth"]),
            normal=torch.where(t3, 0.0, lanes["normal"]),
        )
        item = torch.where(take, fetch, item)
        queue_head = queue_head + take.sum()

        if sort_lanes:
            # dead lanes first, live lanes by (origin cell, direction octant)
            lo, ld = lanes["o"], lanes["d"]
            octant = (ld[:, 0] > 0).long() + 2 * (ld[:, 1] > 0).long() + 4 * (ld[:, 2] > 0).long()
            q = torch.clamp(((lo - root_min) / root_span * 8.0).to(torch.int32), 0, 7).long()
            cell = q[:, 0] + 8 * q[:, 1] + 64 * q[:, 2]
            key = torch.where(lanes["alive"], 1 + octant + 8 * cell, 0)
            order = torch.argsort(key, stable=True)
            lanes = {k: v[order] for k, v in lanes.items()}
            item = item[order]

        lanes = bounce_step(scene, lanes, intersect, occluded)
        # per-path depth cap, the sync driver's max_bounces
        lanes["alive"] = lanes["alive"] & (lanes["bounce"] < max_path_bounces)
        iteration += 1

    # final flush of lanes that ended on the last iteration
    flush(~lanes["alive"] & (item >= 0))
    return WavefrontImages(color=out_color[:Q], normal=out_normal[:Q], depth=out_depth[:Q],
                           iterations=iteration)
