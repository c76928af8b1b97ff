"""The bulk-synchronous path integrator (the sync driver).

Port of ``hijiki_tpu/ops/integrate.py`` (the reference megakernel's
``integrateRay``, ``shader/render.glsl:81-146``): the whole ray batch
advances bounce-synchronously through batched stages — closest hit, AOV
record, Beer-Lambert attenuation, emissive accumulation, next-event
estimation with an any-hit shadow ray, BSDF sampling, Russian roulette —
with per-lane live masks. The estimator is the reference's:

* emitter radiance only after a discrete bounce (``wasDiscrete``),
* NEE for diffuse/checkerboard hits with the backface/eps gates,
* Russian roulette after bounce 3 with q = min(0.99, max throughput),
* per-path RNG consumption predicated as the reference's divergent
  execution consumes it.

The loop runs on the host: one ``any(alive)`` read per bounce is its only
device sync (``bounce_step`` reads nothing back; ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold it to that on a card). Closest and any hit come
from ``make_intersectors``: ``rows`` and ``packet`` walk the trace rows (K6
on a CUDA tensor), ``bvh`` and ``brute`` are plain torch.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from hijiki_tpu_torch.ops import rng
from hijiki_tpu_torch.ops.bsdf import base_color, eval_bsdf, sample_bsdf, select_row, split_handle
from hijiki_tpu_torch.ops.emitter import sample_emitter
from hijiki_tpu_torch.ops.intersect import (
    M_EPS,
    dot,
    gather,
    intersect_brute,
    intersect_bvh,
    intersect_rows,
    norm,
    occluded_brute,
    occluded_bvh,
    occluded_rows,
    populate_intersection,
)
from hijiki_tpu_torch.ops.pallas_traverse import intersect_packets, occluded_packets
from hijiki_tpu_torch.scene.model import TAG_DIFFUSE, TAG_DIFFUSECBOARD, TAG_EMISSIVE

TRAVERSALS = ("rows", "bvh", "brute", "packet")


class RenderOutputs(NamedTuple):
    """Per-lane AOVs (the 3 output layers of render.glsl:172-174), the final
    RNG state, and the bounce iterations the loop ran."""

    total: torch.Tensor  # (N,3) radiance
    normal: torch.Tensor  # (N,3) first-hit shading normal
    depth: torch.Tensor  # (N,) first-hit t
    albedo: torch.Tensor  # (N,3) zero unless albedo_aov (reference quirk)
    state: torch.Tensor  # (N,) final RNG state (int64 holding u32)
    iterations: int = 0


def make_intersectors(scene, traversal: str, leaf_size: int = 1):
    """(closest_hit, any_hit) functions for the traversal backend; both take
    (o, d, tmin, tmax, active=None)."""
    if traversal == "rows":
        return partial(intersect_rows, scene=scene), partial(occluded_rows, scene=scene)
    if traversal == "bvh":
        return (partial(intersect_bvh, scene=scene, leaf_size=leaf_size),
                partial(occluded_bvh, scene=scene, leaf_size=leaf_size))
    if traversal == "brute":
        return partial(intersect_brute, scene=scene), partial(occluded_brute, scene=scene)
    if traversal == "packet":
        return partial(intersect_packets, scene=scene), partial(occluded_packets, scene=scene)
    raise ValueError(f"unknown traversal {traversal!r} (one of {', '.join(TRAVERSALS)})")


def bounce_step(scene, s: dict, intersect, occluded, albedo_aov: bool = False) -> dict:
    """One bounce over the lane batch; ``s`` holds per-lane state including
    a per-lane ``bounce`` counter (the sync and wavefront drivers share this
    body). Returns the updated state dict."""
    alive = s["alive"]
    hit = intersect(s["o"], s["d"], s["tmin"], s["tmax"], alive)
    its = populate_intersection(s["o"], s["d"], hit, scene)
    found = alive & hit.valid

    first = (s["bounce"] == 0) & found
    depth = torch.where(first, hit.t, s["depth"])
    normal = torch.where(first[..., None], its.n, s["normal"])

    if hit.tag is not None:
        tag, idx = hit.tag, hit.midx  # returned with the hit (packet walk)
    else:
        tag, idx = split_handle(
            gather(scene.materials, torch.clamp_max(its.shape_id, scene.num_shapes - 1)))

    if albedo_aov:
        albedo = torch.where(first[..., None], base_color(scene, tag, idx, its), s["albedo"])

    # Beer-Lambert volumetric extinction (render.glsl:111-112)
    dist = norm(its.p - s["o"])
    throughput = torch.where(
        found[..., None], s["throughput"] * torch.exp(-s["extinction"] * dist[..., None]),
        s["throughput"],
    )

    # emissive hit, only after a discrete bounce (render.glsl:114-116)
    power = select_row(scene.emissive_power, idx)
    em = found & (tag == TAG_EMISSIVE) & s["was_discrete"]
    total = torch.where(em[..., None], s["total"] + throughput * power, s["total"])

    # NEE for diffuse-ish lanes (render.glsl:117-126)
    dif = found & ((tag == TAG_DIFFUSE) | (tag == TAG_DIFFUSECBOARD))
    new_state, es = sample_emitter(scene, s["state"], its.p, dif)
    gate = dif & (norm(es.importance) > M_EPS) & (dot(es.shadow_d, its.n) > 0.0)
    occ = occluded(es.shadow_o, es.shadow_d, es.shadow_tmin, es.shadow_tmax, gate)
    contrib = throughput * eval_bsdf(scene, tag, idx, es.shadow_d, its) * es.importance
    total = torch.where((gate & ~occ)[..., None], total + contrib, total)

    # BSDF sampling (render.glsl:128-133)
    new_state, wo, weight, extinction = sample_bsdf(
        scene, tag, idx, s["d"], its, new_state, s["extinction"], found
    )
    throughput = torch.where(found[..., None], throughput * weight, throughput)
    new_o = torch.where(found[..., None], its.p, s["o"])
    new_d = torch.where(found[..., None], wo, s["d"])
    new_tmin = torch.where(found, 2.0 * M_EPS, s["tmin"])
    new_tmax = torch.where(found, float("inf"), s["tmax"])
    was_discrete = torch.where(
        found, (tag != TAG_DIFFUSE) & (tag != TAG_DIFFUSECBOARD), s["was_discrete"]
    )

    # Russian roulette after bounce 3 (render.glsl:137-144)
    rr = found & (s["bounce"] > 3)
    state_rr, u_rr = rng.rand_uniform_float(new_state)
    new_state = torch.where(rr, state_rr, new_state)
    q = torch.clamp_max(throughput.amax(-1), 0.99)
    kill = rr & (u_rr > q)
    throughput = torch.where((rr & ~kill)[..., None], throughput / q[..., None], throughput)

    out = dict(s)
    out.update(
        bounce=s["bounce"] + 1, o=new_o, d=new_d, tmin=new_tmin, tmax=new_tmax,
        state=new_state, total=total, throughput=throughput, extinction=extinction,
        was_discrete=was_discrete, alive=found & ~kill, depth=depth, normal=normal,
    )
    if albedo_aov:
        out["albedo"] = albedo
    return out


def start_lanes(o, d, tmin, tmax, state) -> dict:
    """The per-lane state ``bounce_step`` advances, for camera rays o, d
    (N, 3), tmin, tmax (N,) and RNG states (N,) int64 holding u32."""
    f32 = torch.float32
    dev = state.device
    n = state.shape[0]
    return dict(
        bounce=torch.zeros(n, dtype=torch.int32, device=dev),
        o=o, d=d, tmin=tmin, tmax=tmax, state=state,
        total=torch.zeros((n, 3), dtype=f32, device=dev),
        throughput=torch.ones((n, 3), dtype=f32, device=dev),
        extinction=torch.zeros((n, 3), dtype=f32, device=dev),
        was_discrete=torch.ones(n, dtype=torch.bool, device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        depth=torch.zeros(n, dtype=f32, device=dev),
        normal=torch.zeros((n, 3), dtype=f32, device=dev),
        albedo=torch.zeros((n, 3), dtype=f32, device=dev),
    )


def integrate(
    scene,
    o,
    d,
    tmin,
    tmax,
    state,
    *,
    max_bounces: int = 1000,
    use_bvh: bool = True,
    leaf_size: int = 1,
    traversal: str = "rows",
    albedo_aov: bool = False,
) -> RenderOutputs:
    """Trace a batch of rays (o, d (N,3), tmin, tmax (N,), RNG state (N,)
    int64 holding u32) to completion. ``use_bvh=False`` forces "brute" (the
    reference's A/B switch, ``src/main.rs:1432-1434``). Dead lanes never
    change, so the loop stops at the first bounce where none is alive."""
    if not use_bvh:
        traversal = "brute"
    intersect, occluded = make_intersectors(scene, traversal, leaf_size)
    s = start_lanes(o, d, tmin, tmax, state)
    iteration = 0
    while iteration < max_bounces and bool(s["alive"].any()):
        s = bounce_step(scene, s, intersect, occluded, albedo_aov=albedo_aov)
        iteration += 1
    return RenderOutputs(total=s["total"], normal=s["normal"], depth=s["depth"],
                         albedo=s["albedo"], state=s["state"], iterations=iteration)
