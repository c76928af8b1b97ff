"""Scene compiler: Scene -> CompiledScene (SoA arrays + BVH).

Port of ``hijiki_tpu/scene/compile.py`` (the reference's ``Scene::compile``,
``src/main.rs:172-358``), producing the same arrays bit for bit: shapes
split into type-sorted SoA arrays (spheres, quads, triangles), materials
packed into u32 tagged handles ``(tag << 24) | per_type_index``
(``src/main.rs:45, 251-276``), per-shape handles ordered
spheres->quads->triangles (``src/main.rs:278-287``), and a uniform-pdf
emitter table with reference-exact pick thresholds (``src/main.rs:289-307``).
The compiled scene is a plain dataclass of numpy arrays plus the static
bakes; ``to_device`` turns the arrays into tensors.

For traversal, all primitives are flattened into unified records (a, b, c
vectors + kind) in BVH order and threaded into the trace-row table the
megakernel walks (``build_trace_rows``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np

from hijiki_tpu_torch.accel.bvh import build_bvh, collapse_bvh, order_children_by_area
from hijiki_tpu_torch.scene.model import (
    Camera,
    Dielectric,
    Diffuse,
    DiffuseCheckerboard,
    Emissive,
    MATERIAL_TAG_SHIFT,
    Mirror,
    Quad,
    Scene,
    Sphere,
    TAG_EMISSIVE,
    Triangle,
    material_handle,
)

KIND_SPHERE = 0
KIND_QUAD = 1
KIND_TRIANGLE = 2


def _pad_rows(a: np.ndarray, min_rows: int = 1) -> np.ndarray:
    """Pad a (possibly empty) array to at least min_rows rows of zeros so
    device-side gathers never see zero-length arrays."""
    if a.shape[0] >= min_rows:
        return a
    pad = np.zeros((min_rows - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


@dataclass(frozen=True)
class CompiledScene:
    """Compiled scene: numpy arrays plus the static bakes (plain dataclass;
    ``to_device`` turns the arrays into tensors)."""

    # Camera
    cam_position: Any  # (3,) f32
    cam_rotation: Any  # (4,) f32 quaternion (x,y,z,w)
    cam_fov: Any  # () f32, horizontal fov in degrees

    # Type-sorted shape SoA (reference global shape order: spheres,quads,tris)
    sphere_pos_radius: Any  # (S',4) f32
    quad_origin: Any  # (Q',3) f32
    quad_edge1: Any  # (Q',3)
    quad_edge2: Any  # (Q',3)
    tri_indices: Any  # (T',3) i32 into vertex arrays
    vtx_positions: Any  # (V',3) f32
    vtx_normals: Any  # (V',3) f32
    vtx_uvs: Any  # (V',2) f32

    # Per-shape material handles, global shape order (src/main.rs:278-287)
    materials: Any  # (S+Q+T,) u32

    # Emitter table (src/main.rs:289-307)
    emitter_shape: Any  # (E',) i32 global shape index
    emitter_pdf: Any  # (E',) f32
    emitter_cdf: Any  # (E',) f32

    # Per-type material data tables
    diffuse_color: Any  # (D',3) f32
    cb_color1: Any  # (C',3) f32
    cb_color2: Any  # (C',3) f32
    cb_scale: Any  # (C',2) f32 (scale_u, scale_v)
    dielectric_ext_eta: Any  # (L',4) f32 (extinction rgb, eta_ratio)
    emissive_power: Any  # (M',3) f32

    # Threaded BVH over all shapes (hijiki_tpu.accel.bvh layout)
    bvh_aabb_min: Any  # (N,3) f32
    bvh_aabb_max: Any  # (N,3) f32
    bvh_first: Any  # (N,) i32
    bvh_count: Any  # (N,) i32
    bvh_exit: Any  # (N,) i32

    # Unified primitive records in BVH-reordered order
    prim_a: Any  # (P,3) f32: sphere center / quad origin / tri vertex 0
    prim_b: Any  # (P,3) f32: (radius,0,0) / edge1 / edge ab
    prim_c: Any  # (P,3) f32: 0 / edge2 / edge ac
    prim_kind: Any  # (P,) i32
    prim_shape_id: Any  # (P,) i32 global shape index (materials/emitters key)
    prim_tri: Any  # (P,3) i32 vertex indices (zeros for non-triangles)

    # Merged threaded trace table: the whole BVH as one uniform row stream so
    # a traversal step is a single gather (see build_trace_rows below).
    trace_rows: Any  # (R,32) f32
    # Megakernel twin of trace_rows: triangle-only when the scene's analytic
    # prims (spheres/quads) are few enough to bake into the kernel; otherwise
    # the same array as trace_rows.
    trace_rows_mega: Any = None

    # Static metadata
    num_spheres: int = 0
    num_quads: int = 0
    num_triangles: int = 0
    num_emitters: int = 0
    num_bvh_nodes: int = 0
    num_prims: int = 0

    # Static per-emitter metadata (host ints) enabling gather-free statically
    # unrolled emitter sampling when the emitter count is small: shape kind
    # (KIND_*), index into the per-type shape arrays, and the emissive
    # material's table index (src/main.rs:289-307 equivalents).
    emitter_kind_static: tuple = (
    )
    emitter_local_static: tuple = (
    )
    emitter_midx_static: tuple = (
    )

    # Fully-baked scene constants for the Pallas megakernel: camera, emitter
    # geometry/power/pdf/cdf, and material parameter tables as nested tuples
    # of python floats. Baking makes them compile-time immediates inside the
    # kernel (zero memory traffic, no gathers); the scene is static per
    # render, so this matches the reference's own specialize-at-compile-time
    # philosophy (its shaders are recompiled per scene with injected macros,
    # src/main.rs:769-783).
    camera_static: tuple = ()
    bbox_static: tuple = ()
    # Baked analytic prims for the megakernel: per prim
    # (kind, mat_tag, mat_idx, a.xyz, b.xyz, c.xyz) as python floats
    analytic_bake_static: tuple = (
    )
    emitter_bake_static: tuple = (
    )
    material_bake_static: tuple = (
    )
    # trace_rows_mega holds this many independently-flattened copies of the
    # tree (8 = one per ray-direction octant with near-to-far child order,
    # 1 = a single area-ordered table). Each copy is rows/ntab rows; exit
    # pointers are absolute into the concatenated array.
    mega_num_tables_static: int = 1
    # Prims per packed trace row (1 SLIM, 3, 4, 12; build_packed_trace_rows);
    # 0 = classic unpacked 32-wide rows. A packed trace_rows_mega is the
    # walk table(s) (ntab * mega_tbl_rows_static rows) followed by the
    # slot-indexed payload section (mega_pay_rows_static rows).
    mega_packed_static: int = 0
    # True = trace_rows_mega is triangle-only (analytic prims, if any, are
    # baked into analytic_bake_static); False = mixed-kind rows. Pure-
    # triangle scenes (zero analytic prims) are analytic-mode with an empty
    # bake — the kernel receives analytic=None only for mixed tables.
    mega_analytic_mode_static: bool = False
    mega_tbl_rows_static: int = 0
    mega_pay_rows_static: int = 0
    # Shadow-visibility boxes (scene/lightvis.py): world-space AABBs proven
    # to see the emitters unoccluded; NEE shadow rays originating inside
    # any box skip the any-hit walk exactly. Packed flat as
    # (K, x0,y0,z0,x1,y1,z1, ... K times). () = nothing proven / disabled.
    shadow_vis_static: tuple = ()
    # Dedicated any-hit shadow table: one payload-free PACKED3 flattening
    # of the triangles (classic analytic-mode tables only; else None).
    shadow_rows_mega: Any = None
    shadow_tbl_rows_static: int = 0

    @property
    def num_shapes(self) -> int:
        return self.num_spheres + self.num_quads + self.num_triangles

    @property
    def mega_tbl_rows(self) -> int:
        """Rows per traversal table inside trace_rows_mega."""
        if self.mega_tbl_rows_static:
            return self.mega_tbl_rows_static
        return self.trace_rows_mega.shape[0] // self.mega_num_tables_static


TRACE_ROW_WIDTH = 32


def build_trace_rows(
    bvh, prim_a, prim_b, prim_c, prim_kind, prim_tag, prim_midx, prim_payload
) -> np.ndarray:
    """Flatten the threaded BVH + reordered primitives into one uniform row
    stream for single-gather lockstep traversal.

    Each row is TRACE_ROW_WIDTH f32 (ints stored as exact small-int floats):
      cols 0-2   v0: aabb_min (interior) or prim a
      cols 3-5   v1: aabb_max (interior) or prim b
      cols 6-8   v2: prim c (zeros for interior)
      col  9     kind: -1 interior (AABB test) else primitive kind
      col  10    exit row: next row if the AABB test fails / after a prim test
      col  11    prim slot (BVH order) or -1
      col  12    material tag (prim rows)
      col  13    material per-type index (prim rows)
      cols 14-28 shading payload (prim rows): triangles carry the vertex data
                 barycentric shading needs (n0,n1,n2 then uv0,uv1,uv2);
                 spheres carry (center, radius); quads carry (edge1, edge2)
      cols 29-31 precomputed plane normal v1 x v2 (quad/triangle rows)

    Embedding material handle + shading payload in the row lets the traversal
    kernels return everything shading needs with the hit — no per-lane
    gathers anywhere in the bounce (TPU gathers in device loops are
    unreliable; see docs/PERF_NOTES.md).

    Interior rows jump to ``cur+1`` on AABB hit (preorder left child) and to
    ``exit`` on miss — the reference's stackless walk
    (``shader/scene.glsl:117-131``). A leaf with count prims becomes count
    consecutive primitive rows threaded by exit pointers (row k exits to k+1,
    the last to the leaf's exit), so multi-prim leaves need no special case.
    Leaf rows are tested unconditionally, exactly like the reference's leaves.
    """
    n_nodes = bvh.aabb_min.shape[0]
    counts = bvh.count.astype(np.int64)
    rows_per_node = np.where(counts > 0, counts, 1)
    row_start = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(rows_per_node, out=row_start[1:])
    total = int(row_start[-1])
    # exit pointers live in an f32 column: row indices past 2^24 are no
    # longer exactly representable and traversal would silently corrupt
    assert total < 2**24, (
        f"trace table has {total} rows; f32 exit pointers are exact only "
        "below 2^24 — split the scene or raise leaf_size"
    )

    rows = np.zeros((total, TRACE_ROW_WIDTH), dtype=np.float32)
    is_leaf = counts > 0
    exit_rows = row_start[np.minimum(bvh.exit.astype(np.int64), n_nodes)]

    # interior rows (fully vectorized — a python per-node loop costs ~10s at
    # 100k prims)
    int_r = row_start[:-1][~is_leaf]
    rows[int_r, 0:3] = bvh.aabb_min[~is_leaf]
    rows[int_r, 3:6] = bvh.aabb_max[~is_leaf]
    rows[int_r, 9] = -1.0
    rows[int_r, 10] = exit_rows[~is_leaf]
    rows[int_r, 11] = -1.0

    # primitive rows: expand each leaf into `count` consecutive rows
    leaf_nodes = np.nonzero(is_leaf)[0]
    if leaf_nodes.size:
        leaf_counts = counts[leaf_nodes]
        node_rep = np.repeat(leaf_nodes, leaf_counts)  # owning node per row
        # k = index within the leaf run
        ends = np.cumsum(leaf_counts)
        k = np.arange(int(ends[-1]), dtype=np.int64) - np.repeat(
            ends - leaf_counts, leaf_counts
        )
        r = row_start[node_rep] + k
        slot = bvh.first[node_rep].astype(np.int64) + k
        rows[r, 0:3] = prim_a[slot]
        rows[r, 3:6] = prim_b[slot]
        rows[r, 6:9] = prim_c[slot]
        rows[r, 9] = prim_kind[slot]
        last = k + 1 == np.repeat(leaf_counts, leaf_counts)
        rows[r, 10] = np.where(last, exit_rows[node_rep], r + 1)
        rows[r, 11] = slot
        rows[r, 12] = prim_tag[slot]
        rows[r, 13] = prim_midx[slot]
        rows[r, 14 : 14 + 15] = prim_payload[slot]
        # cols 29-31: precomputed plane normal v1 x v2 for the quad/triangle
        # test (unused by spheres/interiors) so the traversal kernel skips
        # the per-step cross product
        rows[r, 29:32] = np.cross(prim_b[slot], prim_c[slot])
    return rows


# Largest table the megakernel can stage in VMEM (the renderer streams
# bigger tables from HBM via the walker's DMA mode). Sized against the
# measured scoped-VMEM high water on v5e: the chained walker's non-table
# scratch is ~55.6 MiB of the 64 MiB limit at the default
# packet/chain/groups config (a 100k-tri, 18.5 MiB table OOM'd the Mosaic
# compile at 74.12 MiB — CLI verify, round 2 tail), so tables past 8 MiB
# cannot actually co-reside and must stream. HBM streaming at this band
# runs the measured PACKED4 + G=2 stack (docs/PERF_NOTES.md §9z).
MEGA_VMEM_TABLE_BYTES = 8 << 20
def build_octant_trace_tables(bvh, prim_args) -> np.ndarray:
    """Concatenate 8 flattenings of the same tree, one per ray-direction
    octant with near-to-far child ordering (ordered stackless traversal; see
    accel.bvh.order_children_octant). Exit pointers are rebased to absolute
    rows; every table has identical row count (same nodes, same leaf runs).

    Traversal picks table ``oct`` by starting at row ``oct * R`` and walking
    while ``cur < (oct+1) * R``.
    """
    from hijiki_tpu_torch.accel.bvh import order_children_octant

    tables = []
    R = None
    for octant in range(8):
        rows_o = build_trace_rows(order_children_octant(bvh, octant), *prim_args)
        if R is None:
            R = rows_o.shape[0]
            # rebased absolute pointers reach 8*R; they must stay f32-exact
            assert 8 * R < 2**24, (
                f"octant tables need {8 * R} rows; f32 exit pointers are "
                "exact only below 2^24 — use octant_tables='never'"
            )
        assert rows_o.shape[0] == R, "octant flattenings must agree in size"
        rows_o[:, 10] += np.float32(octant * R)  # absolute exit pointers
        tables.append(rows_o)
    return np.concatenate(tables, axis=0)


# --- packed leaf rows (megakernel, analytic mode only) ---------------------
# A packed trace row carries up to PACKED_N triangles tested in ONE walker
# iteration (the walker pays its fixed per-iteration cost — slab vote,
# cursor logic, fetch — once per PACKED_N prims instead of once per prim).
# Row layout, PACKED_ROW_WIDTH f32 wide:
#   cols 0-2 / 3-5   aabb min/max (interior rows)
#   col  9           -1 interior, +1 packed-prim row
#   col  10          exit row
#   prim k in 0..PACKED_N-1 at base B = PACKED_BASE + PACKED_STRIDE*k:
#     B..B+2  v0   B+3..B+5  edge1   B+6..B+8  edge2
#     B+9..B+11  plane normal edge1 x edge2
#     B+12  slot (payload-row index; shading data lives in the payload
#           section appended after the walk tables — see
#           build_packed_trace_rows)
# Leaves with fewer than a multiple of PACKED_N prims pad by repeating the
# last prim: with the walker's strict-< earliest-wins accept, a duplicate
# can never beat its original, so padding is exact.
PACKED_ROW_WIDTH = 64
PACKED_N = 4
PACKED_BASE = 12
PACKED_STRIDE = 13

# The 3-prim variant keeps the ORIGINAL 32-col row width — the walk-probe
# attribution (PERF_NOTES §9s) showed per-iteration cost is fetch-width-
# bound, not ALU-bound: 64-wide rows cost ~+20%/iteration while the whole
# prim test costs ~4%. Layout (prim rows; interiors unchanged):
#   prim0 v0/v1/v2 at cols 0-8 (exactly the unpacked layout)
#   prim1 at cols 11-19, prim2 at cols 20-28
#   col 29 = slot of prim0; slots are CONSECUTIVE (slot_k = slot0 + k)
#   col 9 kind flag, col 10 exit as always
# Plane normals are recomputed in-kernel (f32 cross — bitwise-identical to
# the numpy f32 bake); short leaves pad with degenerate all-zero triangles
# (NaN t can never win the strict-min tournament).
PACKED3_N = 3
PACKED3_BASES = (0, 11, 20)
PACKED3_SLOT_COL = 29

# The 12-prim variant fills the HBM DMA width exactly. Mosaic DMA row slices
# are 128-lane aligned, so HBM-streamed rows are padded to 128 cols no matter
# the format — a 64-wide PACKED4 row wastes half of every 512 B row DMA.
# With in-kernel normal recompute (vector ALU per iteration is nearly free,
# docs/PERF_NOTES.md §9s) and consecutive slots, 12 triangles fit:
#   prim0 v0/v1/v2 at cols 0-8 (exactly the unpacked layout)
#   col 9 kind flag, col 10 exit (as always)
#   prim k at PACKED12_BASES[k] (9 cols each: v0, edge1, edge2)
#   col 110 = slot of prim0; slots are CONSECUTIVE (slot_k = slot0 + k)
# Short leaves pad with degenerate all-zero triangles (NaN t never wins the
# strict-min tournament).
PACKED12_N = 12
PACKED12_BASES = (0,) + tuple(11 + 9 * k for k in range(11))
PACKED12_SLOT_COL = 110
PACKED12_ROW_WIDTH = 128

# The 1-prim SLIM format halves the row to 16 cols — the walk reads only
# cols 0-10 (+ slot): interior aabb at 0-5 or prim v0/v1/v2 at 0-8, kind
# at 9, exit at 10, payload slot at 11; the plane normal is recomputed
# in-kernel and the 18-float payload (kind/tag/midx + 15 shading floats)
# lives in TWO consecutive 16-wide pay rows per prim (row0: kind, tag,
# midx, pay0-11; row1: pay12-14).
SLIM_ROW_WIDTH = 16
SLIM_SLOT_COL = 11
SLIM_PAY_STRIDE = 2


def build_packed_trace_rows(bvh, prim_a, prim_b, prim_c, prim_kind, prim_tag,
                            prim_midx, prim_payload, nper=PACKED_N):
    """Flatten a (triangle-only) threaded BVH into packed trace rows plus a
    slot-indexed payload table.

    Returns ``(rows (R, PACKED_ROW_WIDTH) f32, pay (P, PACKED_ROW_WIDTH)
    f32)``. Payload rows: col 0 kind, col 1 material tag, col 2 material
    index, cols 3-17 the 15-float shading payload (build_trace_rows cols
    14-28). The caller appends ``pay`` after the walk table(s); the
    megakernel's winner-resolve loop fetches payload by slot from there.

    Same traversal semantics as ``build_trace_rows`` (reference walk:
    ``shader/scene.glsl:99-133``): a leaf of count prims becomes
    ceil(count / PACKED_N) consecutive packed rows threaded by exit
    pointers. Within a row the walker takes the strict-min-t hit with
    earliest-prim tie-break, which is exactly the sequential per-prim
    walk's outcome.
    """
    assert nper in (1, PACKED3_N, PACKED_N, PACKED12_N)
    if nper == 1:
        width = SLIM_ROW_WIDTH
    elif nper == PACKED3_N:
        width = TRACE_ROW_WIDTH
    elif nper == PACKED12_N:
        width = PACKED12_ROW_WIDTH
    else:
        width = PACKED_ROW_WIDTH
    n_nodes = bvh.aabb_min.shape[0]
    counts = bvh.count.astype(np.int64)
    packs_per_leaf = np.where(counts > 0, -(-counts // nper), 0)
    rows_per_node = np.where(counts > 0, packs_per_leaf, 1)
    row_start = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(rows_per_node, out=row_start[1:])
    total = int(row_start[-1])
    n_prims = prim_a.shape[0]
    assert total < 2**24 and n_prims < 2**24, (
        "packed trace table exceeds f32 exact-integer indexing"
    )

    rows = np.zeros((total, width), dtype=np.float32)
    is_leaf = counts > 0
    exit_rows = row_start[np.minimum(bvh.exit.astype(np.int64), n_nodes)]

    int_r = row_start[:-1][~is_leaf]
    rows[int_r, 0:3] = bvh.aabb_min[~is_leaf]
    rows[int_r, 3:6] = bvh.aabb_max[~is_leaf]
    rows[int_r, 9] = -1.0
    rows[int_r, 10] = exit_rows[~is_leaf]

    leaf_nodes = np.nonzero(is_leaf)[0]
    if leaf_nodes.size:
        leaf_packs = packs_per_leaf[leaf_nodes]
        node_rep = np.repeat(leaf_nodes, leaf_packs)  # owning node per row
        ends = np.cumsum(leaf_packs)
        j = np.arange(int(ends[-1]), dtype=np.int64) - np.repeat(
            ends - leaf_packs, leaf_packs
        )  # pack index within the leaf
        r = row_start[node_rep] + j
        rows[r, 9] = 1.0
        last = j + 1 == np.repeat(leaf_packs, leaf_packs)
        rows[r, 10] = np.where(last, exit_rows[node_rep], r + 1)
        if nper == 1:
            slot = bvh.first[node_rep].astype(np.int64) + j
            rows[r, 0:3] = prim_a[slot]
            rows[r, 3:6] = prim_b[slot]
            rows[r, 6:9] = prim_c[slot]
            rows[r, SLIM_SLOT_COL] = slot
        elif nper in (PACKED3_N, PACKED12_N):
            # consecutive slots from one base col; tails pad with
            # degenerate all-zero triangles (never hit, NaN t never wins)
            bases = PACKED3_BASES if nper == PACKED3_N else PACKED12_BASES
            slot_col = PACKED3_SLOT_COL if nper == PACKED3_N else PACKED12_SLOT_COL
            rows[r, slot_col] = bvh.first[node_rep] + j * nper
            for k in range(nper):
                slot = bvh.first[node_rep].astype(np.int64) + j * nper + k
                valid = j * nper + k < counts[node_rep]
                B = bases[k]
                sl = slot[valid]
                rv = r[valid]
                rows[rv, B : B + 3] = prim_a[sl]
                rows[rv, B + 3 : B + 6] = prim_b[sl]
                rows[rv, B + 6 : B + 9] = prim_c[sl]
        else:
            normals = np.cross(prim_b, prim_c).astype(np.float32)
            for k in range(nper):
                # prim k of each pack; short tails repeat the last prim
                slot = bvh.first[node_rep].astype(np.int64) + np.minimum(
                    j * nper + k, counts[node_rep] - 1
                )
                B = PACKED_BASE + PACKED_STRIDE * k
                rows[r, B : B + 3] = prim_a[slot]
                rows[r, B + 3 : B + 6] = prim_b[slot]
                rows[r, B + 6 : B + 9] = prim_c[slot]
                rows[r, B + 9 : B + 12] = normals[slot]
                rows[r, B + 12] = slot

    assert np.all(prim_kind == KIND_TRIANGLE), (
        "packed trace rows are triangle-only (analytic prims are baked)"
    )
    if nper == 1:
        # SLIM: 18 payload floats across SLIM_PAY_STRIDE consecutive rows
        pay = np.zeros((n_prims * SLIM_PAY_STRIDE, width), dtype=np.float32)
        pay[0::2, 0] = prim_kind
        pay[0::2, 1] = prim_tag
        pay[0::2, 2] = prim_midx
        pay[0::2, 3:15] = prim_payload[:, :12]
        pay[1::2, 0:3] = prim_payload[:, 12:15]
        return rows, pay
    pay = np.zeros((n_prims, width), dtype=np.float32)
    pay[:, 0] = prim_kind
    pay[:, 1] = prim_tag
    pay[:, 2] = prim_midx
    pay[:, 3:18] = prim_payload
    return rows, pay


def build_packed_octant_tables(bvh, prim_args, nper=PACKED_N):
    """8 packed flattenings (one per ray-direction octant, near-to-far child
    order) with absolute exit pointers, plus the shared payload table (slots
    are octant-invariant: all flattenings index the same prim order)."""
    from hijiki_tpu_torch.accel.bvh import order_children_octant

    tables = []
    R = None
    pay = None
    for octant in range(8):
        rows_o, pay_o = build_packed_trace_rows(
            order_children_octant(bvh, octant), *prim_args, nper=nper
        )
        if R is None:
            R, pay = rows_o.shape[0], pay_o
            assert 8 * R < 2**24, (
                "packed octant tables exceed f32 exact-integer indexing"
            )
        assert rows_o.shape[0] == R, "octant flattenings must agree in size"
        rows_o[:, 10] += np.float32(octant * R)
        tables.append(rows_o)
    return np.concatenate(tables, axis=0), pay



def emitter_pick_thresholds(pdf: np.ndarray) -> np.ndarray:
    """Reference-exact emitter-pick thresholds (shader/scene.glsl:57-64).

    The reference scans ``r = u; r -= pdf_i; pick first i with r < 0``
    (fallback emitter 0 when the chain never goes negative). The chain
    ``r_i(u) = fl(...fl(u - pdf_0)... - pdf_i)`` is monotone in u, so
    "picked at or before i" is exactly ``u < C_i`` where C_i is the
    smallest f32 with ``r_i(C_i) >= 0``. A plain f32 cumsum is NOT that
    threshold — the partial sums round differently from the subtraction
    chain (e.g. three equal pdfs 0.33333334 cumsum to exactly 1.0 while
    the chain at u = 1.0 ends at -6e-8) — so cdf-compare pickers diverge
    from the reference for ~2^-32 of draws. Binary-search the exact
    thresholds instead; every ``u < cdf_e`` consumer (ops/emitter.py,
    ops/oracle.py, the megakernel's baked bins) is then bit-equivalent
    to the reference scan, fallback included.
    """
    E = len(pdf)
    pdf = np.asarray(pdf, np.float32)

    def chains_ge0(u: np.ndarray) -> np.ndarray:
        # r_i(u[i]) >= 0 for every i at once: element i accumulates the f32
        # subtraction chain pdf[0..i] (elementwise f32 subtract == the scalar
        # np.float32 chain bit-for-bit). One O(E^2) vectorized pass replaces
        # the per-(i, probe) scalar re-walk, which was O(E^2 * ~60 probes)
        # in interpreted Python — minutes at a few thousand emitters.
        r = u.astype(np.float32).copy()
        for j in range(E):
            r[j:] -= pdf[j]
        return r >= 0

    lo = np.zeros(E, np.float32)
    hi = np.full(E, 2.0, np.float32)
    ge_lo = chains_ge0(lo)  # True: picked-at-or-before-i is empty -> lo
    out = np.where(ge_lo, lo, hi)
    active = ~ge_lo & chains_ge0(hi)
    # (chain negative even at u=2 -> out stays hi: everything picks <= i)
    while active.any():
        mid = ((lo.astype(np.float64) + hi.astype(np.float64)) / 2.0).astype(
            np.float32
        )
        done = active & ((mid == lo) | (mid == hi))
        out[done] = hi[done]
        active &= ~done
        ge = chains_ge0(mid)
        hi = np.where(active & ge, mid, hi)
        lo = np.where(active & ~ge, mid, lo)
    return out


def compile_scene(
    scene: Scene, leaf_size: int = 1, collapse: int = 1, octant_tables: str = "auto",
    packed_leaf="auto", shadow_vis_boxes: bool = True,
) -> CompiledScene:
    """Compile a Scene to numpy arrays + baked statics.

    The same compiler as ``hijiki_tpu.scene.compile.compile_scene``, with
    its defaults (the BVH builder's too: native where g++ builds it, else
    numpy).

    ``shadow_vis_boxes``: run the shadow-visibility proof sweep
    (``scene/lightvis.py``; only the megakernel's NEE walk reads the boxes).
    The sweep costs seconds on a first compile and is cached on disk by
    scene content; pass False to skip it.

    ``packed_leaf``: the megakernel's trace-row format. 0 = classic 32-column
    rows; N > 0 = leaves of N triangles packed into one row
    (``build_packed_trace_rows``: 1 the 16-column SLIM rows, 2-3 the 32-column
    PACKED3 rows, 4 the 64-column PACKED4 rows, 5+ the 128-column PACKED12
    rows); "auto" = PACKED4 exactly when the classic table would pass
    ``MEGA_VMEM_TABLE_BYTES`` (about 43,690 triangles), classic otherwise.
    A classic analytic-mode table also gets the dedicated PACKED3 any-hit
    shadow table (``shadow_rows_mega``).
    """
    spheres: list[tuple[Sphere, int]] = []
    quads: list[tuple[Quad, int]] = []
    tris: list[tuple[Triangle, int]] = []
    for shape, mat in scene.objects:
        if isinstance(shape, Sphere):
            spheres.append((shape, mat))
        elif isinstance(shape, Quad):
            quads.append((shape, mat))
        elif isinstance(shape, Triangle):
            tris.append((shape, mat))
        else:
            raise TypeError(f"unknown shape {shape!r}")

    bulk_tris = np.ascontiguousarray(scene.bulk_tris, dtype=np.int32).reshape(-1, 3)
    bulk_mats = np.ascontiguousarray(scene.bulk_tri_mats, dtype=np.int64).reshape(-1)
    NB = bulk_tris.shape[0]
    S, Q, T = len(spheres), len(quads), len(tris) + NB
    num_shapes = S + Q + T
    if num_shapes == 0:
        raise ValueError("scene has no shapes")

    positions = np.asarray(scene.positions, dtype=np.float32).reshape(-1, 3)
    normals = np.asarray(scene.normals, dtype=np.float32).reshape(-1, 3)
    uvs = np.asarray(scene.uvs, dtype=np.float32).reshape(-1, 2)

    # --- material packing (src/main.rs:251-276) ---
    diffuse, cb1, cb2, cbs, diel, emis = [], [], [], [], [], []
    handles = []
    for mat in scene.materials:
        if isinstance(mat, Diffuse):
            handles.append(material_handle(mat.tag, len(diffuse)))
            diffuse.append(mat.color)
        elif isinstance(mat, DiffuseCheckerboard):
            handles.append(material_handle(mat.tag, len(cb1)))
            cb1.append(mat.color1)
            cb2.append(mat.color2)
            cbs.append((mat.scale_u, mat.scale_v))
        elif isinstance(mat, Mirror):
            handles.append(material_handle(mat.tag, 0))  # no data (src/main.rs:262-264)
        elif isinstance(mat, Dielectric):
            handles.append(material_handle(mat.tag, len(diel)))
            diel.append(tuple(mat.extinction) + (mat.eta_ratio,))
        elif isinstance(mat, Emissive):
            handles.append(material_handle(mat.tag, len(emis)))
            emis.append(mat.power)
        else:
            raise TypeError(f"unknown material {mat!r}")

    # Per-shape handles in global shape order (src/main.rs:278-287);
    # bulk triangles follow the listed Triangle objects.
    handles_np = np.asarray(handles, dtype=np.uint32).reshape(-1)
    shape_mats = np.concatenate(
        [
            np.array(
                [handles[m] for _, m in spheres]
                + [handles[m] for _, m in quads]
                + [handles[m] for _, m in tris],
                dtype=np.uint32,
            ).reshape(-1),
            handles_np[bulk_mats] if NB else np.zeros(0, np.uint32),
        ]
    ).reshape(num_shapes)

    # --- emitter table (src/main.rs:289-307) ---
    em_shape = np.nonzero((shape_mats >> MATERIAL_TAG_SHIFT) == TAG_EMISSIVE)[0]
    E = len(em_shape)
    em_pdf = np.full(E, 1.0 / E if E else 0.0, dtype=np.float32)
    em_cdf = emitter_pick_thresholds(em_pdf)

    # --- shape SoA ---
    sphere_pr = np.array(
        [list(s.position) + [s.radius] for s, _ in spheres], dtype=np.float32
    ).reshape(S, 4)
    quad_o = np.array([q.origin for q, _ in quads], dtype=np.float32).reshape(Q, 3)
    quad_e1 = np.array([q.edge1 for q, _ in quads], dtype=np.float32).reshape(Q, 3)
    quad_e2 = np.array([q.edge2 for q, _ in quads], dtype=np.float32).reshape(Q, 3)
    tri_idx = np.concatenate(
        [
            np.array([t.indices for t, _ in tris], dtype=np.int32).reshape(-1, 3),
            bulk_tris,
        ]
    ).reshape(T, 3)

    # --- unified primitive records in global shape order ---
    a = np.zeros((num_shapes, 3), dtype=np.float32)
    b = np.zeros((num_shapes, 3), dtype=np.float32)
    c = np.zeros((num_shapes, 3), dtype=np.float32)
    kind = np.empty(num_shapes, dtype=np.int32)
    ptri = np.zeros((num_shapes, 3), dtype=np.int32)
    if S:
        a[:S] = sphere_pr[:, :3]
        b[:S, 0] = sphere_pr[:, 3]
        kind[:S] = KIND_SPHERE
    if Q:
        a[S : S + Q] = quad_o
        b[S : S + Q] = quad_e1
        c[S : S + Q] = quad_e2
        kind[S : S + Q] = KIND_QUAD
    if T:
        v0 = positions[tri_idx[:, 0]]
        a[S + Q :] = v0
        b[S + Q :] = positions[tri_idx[:, 1]] - v0
        c[S + Q :] = positions[tri_idx[:, 2]] - v0
        kind[S + Q :] = KIND_TRIANGLE
        ptri[S + Q :] = tri_idx

    # --- per-shape AABBs (reference impls: src/shape.rs:13-20,47-54; triangle
    # AABB over its three vertices src/main.rs:72-79) ---
    aabb_min = np.empty((num_shapes, 3), dtype=np.float32)
    aabb_max = np.empty((num_shapes, 3), dtype=np.float32)
    if S:
        aabb_min[:S] = sphere_pr[:, :3] - sphere_pr[:, 3:4]
        aabb_max[:S] = sphere_pr[:, :3] + sphere_pr[:, 3:4]
    if Q:
        corners = np.stack(
            [quad_o, quad_o + quad_e1, quad_o + quad_e2, quad_o + quad_e1 + quad_e2]
        )
        aabb_min[S : S + Q] = corners.min(axis=0)
        aabb_max[S : S + Q] = corners.max(axis=0)
    if T:
        tv = positions[tri_idx]  # (T,3,3)
        aabb_min[S + Q :] = tv.min(axis=1)
        aabb_max[S + Q :] = tv.max(axis=1)

    # per-prim shading payload (see build_trace_rows cols 14-28)
    payload = np.zeros((num_shapes, 15), dtype=np.float32)
    if S:
        payload[:S, 0:3] = sphere_pr[:, :3]
        payload[:S, 3] = sphere_pr[:, 3]
    if Q:
        payload[S : S + Q, 0:3] = quad_e1
        payload[S : S + Q, 3:6] = quad_e2
    if T:
        payload[S + Q :, 0:3] = normals[tri_idx[:, 0]]
        payload[S + Q :, 3:6] = normals[tri_idx[:, 1]]
        payload[S + Q :, 6:9] = normals[tri_idx[:, 2]]
        payload[S + Q :, 9:11] = uvs[tri_idx[:, 0]]
        payload[S + Q :, 11:13] = uvs[tri_idx[:, 1]]
        payload[S + Q :, 13:15] = uvs[tri_idx[:, 2]]

    # shadow-visibility boxes (scene/lightvis.py): regions provably
    # unoccluded toward the whole emitter set; NEE shadow rays from them
    # skip the any-hit walk (estimator-exact — see the module's soundness
    # argument)
    shadow_vis = ()
    if shadow_vis_boxes:
        from hijiki_tpu_torch.scene.lightvis import build_shadow_vis_boxes

        shadow_vis = build_shadow_vis_boxes(
            aabb_min, aabb_max, kind, a, b, c, em_shape,
            KIND_SPHERE, KIND_QUAD, KIND_TRIANGLE,
        ) or ()

    bvh = build_bvh(aabb_min, aabb_max, leaf_size=leaf_size)
    if collapse:
        # widen to 4-ary: interior rows dominate packet-walk visits (~83% on
        # cbox) and packets descend most of them, so the skipped levels'
        # culling doesn't pay for its row visits
        bvh = collapse_bvh(bvh, rounds=collapse)
    bvh = order_children_by_area(bvh)
    order = bvh.prim_order  # reordered slot -> global shape index
    mats_by_order = shape_mats[order]
    trace_rows = build_trace_rows(
        bvh,
        a[order],
        b[order],
        c[order],
        kind[order],
        mats_by_order >> MATERIAL_TAG_SHIFT,
        mats_by_order & ((1 << MATERIAL_TAG_SHIFT) - 1),
        payload[order],
    )

    # --- megakernel specialization: with few analytic prims (spheres/quads),
    # bake them as compile-time immediates tested once before the walk, and
    # give the walker a triangle-only table — the in-loop sphere branch
    # (~14 ops/row-visit) disappears and analytic hits pre-tighten best_t,
    # culling the tree walk. The full trace_rows stays for the XLA drivers.
    NA = S + Q
    midx_mask = (1 << MATERIAL_TAG_SHIFT) - 1
    mega_num_tables = 1
    mega_packed = 0  # prims per packed row (0 = unpacked)

    mega_tbl_rows = 0  # 0 = derive as rows // ntab (unpacked, no pay section)
    mega_pay_rows = 0
    shadow_rows_mega = None  # dedicated any-hit table (analytic VMEM scenes)
    shadow_tbl_rows = 0

    def want_octants(
        base_rows: int,
        row_width: int = TRACE_ROW_WIDTH,
        pay_rows: int = 0,
    ) -> bool:
        if octant_tables == "never":
            return False
        if 8 * base_rows >= 2**24:
            # rebased exit pointers would leave f32's exact-integer range
            return False
        if octant_tables == "always":
            return True
        # the FINAL table (8 walk copies + the shared slot-indexed payload
        # section for packed formats) must fit the megakernel's VMEM
        # staging limit — the renderer's HBM-streaming trigger is the total
        # trace_rows_mega.nbytes (renderer.py aliases MEGA_VMEM_TABLE_BYTES).
        # Gating on the walk section alone would build octant sets whose
        # payload pushes the total over the limit and silently flips a
        # VMEM-resident scene into HBM streaming — where octants measured
        # only +4% at 8x the footprint (the round-2 bench regression's
        # mechanism). Opt in with octant_tables='always'.
        total = (8 * base_rows + pay_rows) * row_width * 4
        return total <= MEGA_VMEM_TABLE_BYTES

    # analytic specialization: up to 8 analytic prims (spheres/quads) baked
    # as compile-time immediates, the walk table triangle-only. NA == 0
    # (pure-triangle scenes, e.g. plain cbox) qualifies with an empty bake —
    # the walker still drops the sphere/quad branch and packing applies.
    mega_analytic_mode = False
    if NA <= 8:
        mega_analytic_mode = True
        analytic = []
        for sh in range(NA):
            analytic.append(
                (
                    float(kind[sh]),
                    float(int(shape_mats[sh]) >> MATERIAL_TAG_SHIFT),
                    float(int(shape_mats[sh]) & midx_mask),
                )
                + tuple(float(x) for x in a[sh])
                + tuple(float(x) for x in b[sh])
                + tuple(float(x) for x in c[sh])
            )
        analytic_bake = tuple(analytic)
        if T:
            if packed_leaf == "auto":
                # JAX's rule: pack (PACKED4) iff the classic table would
                # pass MEGA_VMEM_TABLE_BYTES, estimated at 1.5 rows a
                # triangle (the collapsed tree's measured ratio)
                est_unpacked = 3 * T // 2 * TRACE_ROW_WIDTH * 4
                use_packed = PACKED_N if est_unpacked > MEGA_VMEM_TABLE_BYTES else 0
            else:
                use_packed = int(packed_leaf)
            tri_bvh = build_bvh(
                aabb_min[NA:], aabb_max[NA:],
                leaf_size=use_packed if use_packed > 0 else leaf_size,
            )
            if collapse:
                tri_bvh = collapse_bvh(tri_bvh, rounds=collapse)
            tri_bvh = order_children_by_area(tri_bvh)
            tri_order = tri_bvh.prim_order + NA  # back to global shape ids
            tri_mats = shape_mats[tri_order]
            tri_prim_args = (
                a[tri_order],
                b[tri_order],
                c[tri_order],
                kind[tri_order],
                tri_mats >> MATERIAL_TAG_SHIFT,
                tri_mats & midx_mask,
                payload[tri_order],
            )
            if use_packed > 0:
                # packed leaf rows: nper prims per walk step; the shading
                # payload in a slot-indexed section appended after the walk
                # table(s). leaf 1 -> the 16-wide SLIM format; leaf 2-3 ->
                # the 32-wide PACKED3 format; leaf 4 -> the 64-wide format;
                # leaf >= 5 -> the 128-wide 12-prim format.
                if use_packed == 1:
                    nper, width = 1, SLIM_ROW_WIDTH
                elif use_packed <= PACKED3_N:
                    nper, width = PACKED3_N, TRACE_ROW_WIDTH
                elif use_packed == PACKED_N:
                    nper, width = PACKED_N, PACKED_ROW_WIDTH
                else:
                    nper, width = PACKED12_N, PACKED12_ROW_WIDTH
                walk, pay = build_packed_trace_rows(
                    tri_bvh, *tri_prim_args, nper=nper
                )
                Rp = walk.shape[0]
                if want_octants(Rp, width, pay_rows=pay.shape[0]):
                    walk, pay = build_packed_octant_tables(
                        tri_bvh, tri_prim_args, nper=nper
                    )
                    mega_num_tables = 8
                trace_rows_mega = np.concatenate([walk, pay], axis=0)
                mega_packed = nper
                mega_tbl_rows = Rp
                mega_pay_rows = pay.shape[0]
            else:
                trace_rows_mega = build_trace_rows(tri_bvh, *tri_prim_args)
                if want_octants(trace_rows_mega.shape[0]):
                    trace_rows_mega = build_octant_trace_tables(
                        tri_bvh, tri_prim_args
                    )
                    mega_num_tables = 8
                # the dedicated any-hit shadow table: a single PACKED3
                # flattening over a leaf-3 rebuild of the same triangles,
                # 3 prims a 32-wide row, no payload and no octant set
                # (ordering along the ray does not prune a bounded any-hit
                # query); ~0.55 rows a triangle
                sh_bvh = build_bvh(
                    aabb_min[NA:], aabb_max[NA:], leaf_size=PACKED3_N
                )
                if collapse:
                    sh_bvh = collapse_bvh(sh_bvh, rounds=collapse)
                sh_bvh = order_children_by_area(sh_bvh)
                sh_order = sh_bvh.prim_order + NA
                sh_mats = shape_mats[sh_order]
                shadow_rows_mega, _sh_pay = build_packed_trace_rows(
                    sh_bvh,
                    a[sh_order],
                    b[sh_order],
                    c[sh_order],
                    kind[sh_order],
                    sh_mats >> MATERIAL_TAG_SHIFT,
                    sh_mats & midx_mask,
                    payload[sh_order],
                    nper=PACKED3_N,
                )
                shadow_tbl_rows = shadow_rows_mega.shape[0]
        else:
            # all-analytic scene: one inert interior row (never hit, exits)
            trace_rows_mega = np.zeros((1, TRACE_ROW_WIDTH), dtype=np.float32)
            trace_rows_mega[0, 9] = -1.0
            trace_rows_mega[0, 10] = 1.0
    else:
        analytic_bake = ()
        trace_rows_mega = trace_rows
        if want_octants(trace_rows.shape[0]):
            trace_rows_mega = build_octant_trace_tables(
                bvh,
                (
                    a[order],
                    b[order],
                    c[order],
                    kind[order],
                    mats_by_order >> MATERIAL_TAG_SHIFT,
                    mats_by_order & midx_mask,
                    payload[order],
                ),
            )
            mega_num_tables = 8

    # static per-emitter metadata for gather-free unrolled emitter sampling
    em_kind, em_local, em_midx = [], [], []
    em_bake = []
    emissive_np = np.asarray(emis, dtype=np.float32).reshape(-1, 3)
    for ei, sh in enumerate(em_shape.tolist()):
        midx = int(shape_mats[sh]) & ((1 << MATERIAL_TAG_SHIFT) - 1)
        power = tuple(float(x) for x in emissive_np[midx])
        pdf = float(em_pdf[ei]) if E else 0.0
        cdf_v = float(em_cdf[ei]) if E else 0.0
        if sh < S:
            em_kind.append(KIND_SPHERE)
            em_local.append(int(sh))
            geom = tuple(float(x) for x in sphere_pr[sh]) + (0.0,) * 14
        elif sh < S + Q:
            em_kind.append(KIND_QUAD)
            li = int(sh) - S
            em_local.append(li)
            geom = (
                tuple(float(x) for x in quad_o[li])
                + tuple(float(x) for x in quad_e1[li])
                + tuple(float(x) for x in quad_e2[li])
                + (0.0,) * 9
            )
        else:
            em_kind.append(KIND_TRIANGLE)
            li = int(sh) - S - Q
            em_local.append(li)
            tri = tri_idx[li]
            geom = (
                tuple(float(x) for x in positions[tri[0]])
                + tuple(float(x) for x in positions[tri[1]])
                + tuple(float(x) for x in positions[tri[2]])
                + tuple(float(x) for x in normals[tri[0]])
                + tuple(float(x) for x in normals[tri[1]])
                + tuple(float(x) for x in normals[tri[2]])
            )
        em_midx.append(midx)
        em_bake.append((em_kind[-1], pdf, cdf_v) + power + geom)

    cam: Camera = scene.camera
    camera_static = (
        tuple(float(x) for x in np.asarray(cam.position).reshape(3))
        + tuple(float(x) for x in np.asarray(cam.rotation).reshape(4))
        + (float(cam.fov),)
    )
    material_bake = (
        tuple(tuple(float(x) for x in row) for row in np.asarray(diffuse, np.float32).reshape(-1, 3)),
        tuple(
            tuple(float(x) for x in c1) + (float(sc[0]),) + tuple(float(x) for x in c2) + (float(sc[1]),)
            for c1, c2, sc in zip(
                np.asarray(cb1, np.float32).reshape(-1, 3),
                np.asarray(cb2, np.float32).reshape(-1, 3),
                np.asarray(cbs, np.float32).reshape(-1, 2),
            )
        ),
        tuple(tuple(float(x) for x in row) for row in np.asarray(diel, np.float32).reshape(-1, 4)),
        tuple(tuple(float(x) for x in row) for row in emissive_np),
    )

    return CompiledScene(
        cam_position=np.asarray(cam.position, dtype=np.float32).reshape(3),
        cam_rotation=np.asarray(cam.rotation, dtype=np.float32).reshape(4),
        cam_fov=np.float32(cam.fov),
        sphere_pos_radius=_pad_rows(sphere_pr),
        quad_origin=_pad_rows(quad_o),
        quad_edge1=_pad_rows(quad_e1),
        quad_edge2=_pad_rows(quad_e2),
        tri_indices=_pad_rows(tri_idx),
        vtx_positions=_pad_rows(positions),
        vtx_normals=_pad_rows(normals),
        vtx_uvs=_pad_rows(uvs),
        materials=shape_mats,
        emitter_shape=_pad_rows(em_shape.astype(np.int32)),
        emitter_pdf=_pad_rows(em_pdf),
        emitter_cdf=_pad_rows(em_cdf),
        diffuse_color=_pad_rows(np.asarray(diffuse, dtype=np.float32).reshape(-1, 3)),
        cb_color1=_pad_rows(np.asarray(cb1, dtype=np.float32).reshape(-1, 3)),
        cb_color2=_pad_rows(np.asarray(cb2, dtype=np.float32).reshape(-1, 3)),
        cb_scale=_pad_rows(np.asarray(cbs, dtype=np.float32).reshape(-1, 2)),
        dielectric_ext_eta=_pad_rows(np.asarray(diel, dtype=np.float32).reshape(-1, 4)),
        emissive_power=_pad_rows(np.asarray(emis, dtype=np.float32).reshape(-1, 3)),
        bvh_aabb_min=bvh.aabb_min,
        bvh_aabb_max=bvh.aabb_max,
        bvh_first=bvh.first,
        bvh_count=bvh.count,
        bvh_exit=bvh.exit,
        prim_a=a[order],
        prim_b=b[order],
        prim_c=c[order],
        prim_kind=kind[order],
        prim_shape_id=order.astype(np.int32),
        prim_tri=ptri[order],
        trace_rows=trace_rows,
        trace_rows_mega=trace_rows_mega,
        analytic_bake_static=analytic_bake,
        num_spheres=S,
        num_quads=Q,
        num_triangles=T,
        num_emitters=E,
        num_bvh_nodes=bvh.num_nodes,
        num_prims=num_shapes,
        emitter_kind_static=tuple(em_kind),
        emitter_local_static=tuple(em_local),
        emitter_midx_static=tuple(em_midx),
        camera_static=camera_static,
        bbox_static=tuple(float(x) for x in bvh.aabb_min[0])
        + tuple(float(x) for x in bvh.aabb_max[0]),
        emitter_bake_static=tuple(em_bake),
        material_bake_static=material_bake,
        mega_num_tables_static=mega_num_tables,
        mega_analytic_mode_static=mega_analytic_mode,
        mega_packed_static=mega_packed,
        mega_tbl_rows_static=mega_tbl_rows,
        mega_pay_rows_static=mega_pay_rows,
        shadow_vis_static=shadow_vis,
        shadow_rows_mega=shadow_rows_mega,
        shadow_tbl_rows_static=shadow_tbl_rows,
    )




_INT_DTYPES = {np.dtype(np.uint32): np.int64}


def to_device(cs: CompiledScene, device) -> CompiledScene:
    """Copy of ``cs`` with every array field (numpy scalars such as
    ``cam_fov`` included) as a torch tensor on ``device`` (uint32 fields
    widen to int64: torch has few uint32 operators)."""
    import torch

    def conv(v):
        if isinstance(v, (np.ndarray, np.generic)):
            v = np.asarray(v)
            v = v.astype(_INT_DTYPES.get(v.dtype, v.dtype), copy=False)
            return torch.from_numpy(np.ascontiguousarray(v)).to(device)
        return v

    return dataclasses.replace(
        cs,
        **{f.name: conv(getattr(cs, f.name)) for f in dataclasses.fields(cs)},
    )


def scene_to_device(cs: CompiledScene, device=None) -> CompiledScene:
    """JAX's ``scene_to_device``: ``to_device(cs, device)``, on the card
    unless the caller names another device (the CPU, as the tests do)."""
    return to_device(cs, "cuda" if device is None else device)


def from_reference(arrays: dict, statics: dict) -> CompiledScene:
    """Build the port's CompiledScene from ``hijiki_tpu``'s compile output.

    ``arrays`` maps field names to numpy arrays (the reference's jax arrays
    converted with ``np.asarray``; ``shadow_rows_mega`` among them when the
    reference built one), ``statics`` maps the static fields to their
    values (the packed-format, table-size and shadow-visibility bakes
    included), so both packages can be fed one compiled scene."""
    names = {f.name for f in dataclasses.fields(CompiledScene)}
    kw = {k: np.asarray(v) for k, v in arrays.items() if k in names}
    kw.update({k: v for k, v in statics.items() if k in names})
    return CompiledScene(**kw)
