"""K6, the trace-row walk, its wrapper and its plain twin.

Counterpart of ``hijiki_tpu/ops/pallas_traverse.py`` (same module name, so
the two are easy to pair). ``traverse_packets`` walks rays over the classic
(R, 32) f32 trace-row table (``scene.compile.build_trace_rows``) to their
closest hit, or to any hit with ``any_hit``:

* on a CUDA tensor it launches ``csrc/traverse.cu`` (K6, the counterpart
  of ``_traverse_kernel``; see the note there): one thread per ray, a ray
  that walks nothing writing its miss before it reads o or d;
* on a CPU tensor it runs ``traverse_plain``, the lockstep torch walk that
  computes, lane by lane, what one CUDA thread computes.

The sync and wavefront drivers reach it through ``intersect_rows``/
``occluded_rows`` (``ops/intersect.py``) and ``intersect_packets``/
``occluded_packets``, so ``traversal="rows"`` and ``"packet"`` both run K6
on the card.

Per ray, the walk starts at row 0 with ``best_t`` = the ray's own tmax and
takes row ``cur``, then ``cur + 1`` (an interior row whose box the ray
enters) or the exit pointer in column 10; a prim row's hit is accepted when
it lies in [tmin, best_t] and ``t < best_t``. Any-hit stops at the first
accept; with ``inclusive`` it accepts the prim test's own ``t <= tmax``
(JAX's ``occluded_rows``; ``occluded_rows`` here), without it the strict
``t < tmax`` of the Pallas kernel (``occluded_packets``). A ray whose tmax < tmin (or with a NaN bound) can accept nothing
and does not walk. The TPU kernel walked 128-ray packets that descend when
any ray's slab test passes; a packet visits a superset of each ray's rows
and accepts per ray, so its closest hits are the same, and its any-hit
answer (slot >= 0) is too. Any N is accepted (the TPU kernel needed a
multiple of 1024).
"""

from __future__ import annotations

import torch

from hijiki_tpu_torch.ops.intersect import M_EPS, NEG_BIG, Hit, gather
from hijiki_tpu_torch.ops.megakernel import _check, check_rows_aligned

# output channels of the walk, (OUT_CH, N) f32
OUT_CH = 7  # best_t, slot+1 (0 = miss), u, v, tag, midx, rows visited
# the TPU kernel's rays a packet (one cursor); the CUDA walk has none, and
# the TPU's tile of SUBLANES packets (its SUBLANES and TILE) is not carried
PACKET = 128
# the row kinds the walk's prim test tells apart (scene.compile)
KIND_SPHERE = 0
KIND_TRIANGLE = 2

# launches of the CUDA kernel (CPU twin calls are not counted)
LAUNCHES = {"traverse": 0}


def _check_mode(any_hit: bool, inclusive: bool) -> None:
    if inclusive and not any_hit:
        raise ValueError("inclusive acceptance is an any-hit mode")


def traverse_plain(rows, o, d, tmin, tmax, *, any_hit: bool = False, inclusive: bool = False):
    """The plain twin of K6 (any device): a lockstep walk over the lanes
    still walking, which are compacted as lanes finish. Returns the
    (OUT_CH, N) f32 buffer the kernel writes. ``inclusive`` (any hit only):
    accept the prim test's own t <= tmax, not the strict t < tmax."""
    _check_mode(any_hit, inclusive)
    n, R = o.shape[0], rows.shape[0]
    out = torch.zeros((OUT_CH, n), dtype=torch.float32, device=o.device)
    out[0] = tmax
    lane = torch.nonzero(tmax >= tmin)[:, 0]
    if lane.numel() == 0:
        return out
    ox, oy, oz = (o[lane, k] for k in range(3))
    dx, dy, dz = (d[lane, k] for k in range(3))
    tmn = tmin[lane]
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    tox, toy, toz = -ox * ix, -oy * iy, -oz * iz
    best = tmax[lane]
    zero = torch.zeros_like(best)
    slot1, bu, bv, btag, bmidx, nit = (zero.clone() for _ in range(6))
    cur = torch.zeros(lane.shape, dtype=torch.int64, device=o.device)
    per_lane = [ox, oy, oz, dx, dy, dz, tmn, ix, iy, iz, tox, toy, toz]
    while True:
        act = cur < R
        m = int(act.sum())
        if m == 0:
            break
        if 4 * m <= act.numel():
            # compact: write finished lanes back, keep the walking ones
            done = ~act
            out[:, lane[done]] = torch.stack([best, slot1, bu, bv, btag, bmidx, nit])[:, done]
            state = [lane, cur, best, slot1, bu, bv, btag, bmidx, nit] + per_lane
            state = [x[act] for x in state]
            lane, cur, best, slot1, bu, bv, btag, bmidx, nit = state[:9]
            per_lane = state[9:]
            ox, oy, oz, dx, dy, dz, tmn, ix, iy, iz, tox, toy, toz = per_lane
            act = torch.ones_like(act[:m])
        r = rows[torch.clamp_max(cur, R - 1)]
        v0x, v0y, v0z = r[:, 0], r[:, 1], r[:, 2]
        v1x, v1y, v1z = r[:, 3], r[:, 4], r[:, 5]
        v2x, v2y, v2z = r[:, 6], r[:, 7], r[:, 8]
        kind = r[:, 9]
        is_prim = kind >= 0.0
        # interior rows: the slab test (scene.glsl:118-130)
        ax, bx = v0x * ix + tox, v1x * ix + tox
        ay, by = v0y * iy + toy, v1y * iy + toy
        az, bz = v0z * iz + toz, v1z * iz + toz
        t0 = torch.maximum(torch.maximum(torch.minimum(ax, bx), torch.minimum(ay, by)),
                           torch.minimum(az, bz))
        t1 = torch.minimum(torch.minimum(torch.maximum(ax, bx), torch.maximum(ay, by)),
                           torch.maximum(az, bz))
        slab = (t0 < t1 + M_EPS) & (t0 < best) & (t1 > tmn)
        # prim rows: the unified test (ops.intersect.intersect_unified)
        nx = v1y * v2z - v1z * v2y
        ny = v1z * v2x - v1x * v2z
        nz = v1x * v2y - v1y * v2x
        rx, ry, rz = ox - v0x, oy - v0y, oz - v0z
        qx = ry * dz - rz * dy
        qy = rz * dx - rx * dz
        qz = rx * dy - ry * dx
        dd = 1.0 / (dx * nx + dy * ny + dz * nz)
        u = -dd * (qx * v2x + qy * v2y + qz * v2z)
        v = dd * (qx * v1x + qy * v1y + qz * v1z)
        t_pq = -dd * (nx * rx + ny * ry + nz * rz)
        is_tri = kind == 2.0
        in_tri = (u >= 0) & (v >= 0) & (u + v <= 1.0)
        in_quad = (u >= 0) & (u <= 1.0) & (v >= 0) & (v <= 1.0)
        ok_pq = torch.where(is_tri, in_tri, in_quad) & (tmn <= t_pq) & (t_pq <= best)
        radius = v1x
        sb = 2.0 * (dx * rx + dy * ry + dz * rz)
        sc = (rx * rx + ry * ry + rz * rz) - radius * radius
        disc = sb * sb - 4.0 * sc
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        st0 = -0.5 * (sb + sq)
        st1 = -0.5 * (sb - sq)
        ok0 = (tmn <= st0) & (st0 <= best)
        ok1 = (tmn <= st1) & (st1 <= best)
        is_sphere = kind == 0.0
        phit = torch.where(is_sphere, (disc >= 0.0) & (ok0 | ok1), ok_pq)
        pt = torch.where(is_sphere, torch.where(ok0, st0, st1), t_pq)
        accept = act & is_prim & phit
        if not inclusive:
            accept = accept & (pt < best)
        best = torch.where(accept, pt, best)
        slot1 = torch.where(accept, r[:, 11] + 1.0, slot1)
        bu = torch.where(accept, torch.where(is_sphere, 0.0, u), bu)
        bv = torch.where(accept, torch.where(is_sphere, 0.0, v), bv)
        btag = torch.where(accept, r[:, 12], btag)
        bmidx = torch.where(accept, r[:, 13], bmidx)
        nit = nit + act.to(torch.float32)
        nxt = torch.where(is_prim | ~slab, r[:, 10].long(), cur + 1)
        if any_hit:
            nxt = torch.where(accept, R, nxt)
        cur = torch.where(act, nxt, cur)
    out[:, lane] = torch.stack([best, slot1, bu, bv, btag, bmidx, nit])
    return out


def traverse(rows, o, d, tmin, tmax, *, any_hit: bool = False, inclusive: bool = False):
    """The walk of ``N`` rays (o, d (N, 3), tmin, tmax (N,), f32) over the
    trace rows ``rows`` (R, 32) f32, 16-byte aligned: K6 on a CUDA tensor,
    ``traverse_plain`` on a CPU tensor. Returns the (OUT_CH, N) f32 buffer."""
    if o.device.type != "cuda":
        return traverse_plain(rows, o, d, tmin, tmax, any_hit=any_hit, inclusive=inclusive)
    from hijiki_tpu_torch.utils.build import load_library

    _check_mode(any_hit, inclusive)
    n, dev = o.shape[0], o.device
    _check("rows", rows, torch.float32, (rows.shape[0], 32), dev)
    check_rows_aligned(rows)
    for name, t, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("tmin", tmin, (n,)),
                           ("tmax", tmax, (n,))):
        _check(name, t, torch.float32, shape, dev)
    out = torch.empty((OUT_CH, n), dtype=torch.float32, device=dev)
    if n:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load_library().traverse(
            rows.data_ptr(), rows.shape[0], o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), n, int(any_hit), int(inclusive), out.data_ptr(), stream,
        )
        LAUNCHES["traverse"] += 1
        if rc != 0:
            raise RuntimeError(f"traverse launch failed: CUDA error {rc}")
    return out


def pad_rows_table(rows):
    """JAX's ``pad_rows_table``: the trace rows as f32, zero-padded to a
    multiple of 8 rows (the TPU's VMEM tiling; the walk reads any count)."""
    rows = torch.as_tensor(rows)
    R, W = rows.shape
    R_pad = -(-R // 8) * 8
    if R_pad == R:
        return rows.to(torch.float32)
    out = rows.new_zeros((R_pad, W), dtype=torch.float32)
    out[:R] = rows
    return out


def traverse_packets(rows, o, d, tmin, tmax, *, any_hit: bool = False, interpret: bool = False,
                     inclusive: bool = False):
    """``traverse_packets`` of the JAX package: rays o, d (N, 3), tmin, tmax
    (N,) against the trace rows. Returns (best_t, slot, u, v, tag, midx),
    slot = -1 where missed (any N). ``interpret`` (the TPU's interpreter)
    routes nothing: the inputs' device does."""
    out = traverse(rows.contiguous(), o.contiguous(), d.contiguous(), tmin.contiguous(),
                   tmax.contiguous(), any_hit=any_hit, inclusive=inclusive)
    i32 = torch.int32
    return out[0], out[1].to(i32) - 1, out[2], out[3], out[4].to(i32), out[5].to(i32)


def intersect_packets(o, d, tmin, tmax, active=None, *, scene) -> Hit:
    """Closest hit with the material returned from the winning row; inactive
    lanes get tmax = -3e38 (f32-finite "-inf") and walk nothing."""
    if active is not None:
        tmax = torch.where(active, tmax, NEG_BIG)
    best_t, slot, u, v, tag, midx = traverse_packets(scene.trace_rows, o, d, tmin, tmax)
    valid = slot >= 0
    slot = torch.clamp_min(slot, 0)
    return Hit(valid=valid, t=best_t, prim_slot=slot,
               shape_id=gather(scene.prim_shape_id, slot), u=u, v=v, tag=tag, midx=midx)


def occluded_packets(o, d, tmin, tmax, active=None, *, scene):
    """Any hit (early exit per ray at the first accept)."""
    if active is not None:
        tmax = torch.where(active, tmax, NEG_BIG)
    return traverse_packets(scene.trace_rows, o, d, tmin, tmax, any_hit=True)[1] >= 0
