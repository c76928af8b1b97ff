"""The path-tracing megakernel on Hopper, its plain twin, and the phased driver.

Port of ``hijiki_tpu/ops/pallas_megakernel.py``:

* ``render_waves`` traces every path of a sweep with a camera launch
  (K1 ``mk_start``, the counterpart of ``_megakernel_start``) up to
  ``phase_bounces[0]``, then compacts and sorts the survivors with plain
  torch ops and resumes them (K2 ``mk_resume``, ``_megakernel_resume``) at
  the later caps;
* ``render_waves_chained`` traces S sweeps in one chained camera launch
  (K4 ``mk_start_chained``, ``_megakernel_start_chained``) that respawns a
  lane on its pixel's next sample and parks paths at ``chain_cap``, then
  resumes the parked paths through the same compaction phases;
* ``render_tiles`` traces whole paths in one launch (K5 ``mk_tiles``,
  ``_megakernel``/``_megakernel_body``).

Each entry takes the port's baked ``MegaScene`` (``mega_scene``) or JAX's
call form: a ``CompiledScene`` (numpy or tensor fields) with ``width`` and
``height`` and the TPU walker's kwargs (``interpret``, ``packet``,
``prefetch``, ``spec``, ``spec_resolve``, ``table_in_hbm``, ``groups``,
``group_octant``, ``trunk_rows``, ``hbm_window``), which schedule the
TPU's packet walk and leave every output here as the default call's
(``_check_walker``). The scene is baked once per (scene object, size,
device) and the bake cached (``scene_of``, counted in ``BAKES``). A call
runs on its inputs' device; a scene on another device raises.

Every launch walks any trace-row format of ``scene/compile.py`` (the
classic rows, SLIM, PACKED3/4/12: ``_packed_test``), skips the shadow walk
of a lane inside a shadow-visibility box and, when asked, walks shadow rays
over the dedicated PACKED3 table (``launch_scene``: JAX's ``shadow_vis`` and
``shadow_tbl``).

With ``shadow_cache=True`` (JAX's option of that name: ``_anyhit_pretest``
and the ``srow`` carry of ``_bounce_loop``) each path carries the row that
occluded its last shadow ray, and the next shadow ray tests that row with
the walk's own accept before it walks: a verified hit answers the any-hit
query, a wrong prediction walks as before. Exact: every output but the
``rows`` counter (which counts the tested row) is the cache-off launch's,
bit for bit. The prediction lives with its path (``srow`` in the twin's
state dict, a register or stash word in the kernels), never in the packed
state: it starts at -1 with every camera start, respawn and resume and
moves with its path through the lane sort (``launch_scene``).
``render_waves(shadow_skip_all=True)`` is JAX's performance probe: every
shadow walk is skipped with visibility 1 (a biased image).

With ``lane_sort=True`` (the mega driver's ``--sort-lanes``; JAX's
``_lane_sort`` with ``pallas_sort.py::sort_tile_by_key``, K7) the camera
and resume launches of ``render_waves`` and the single launch of
``render_tiles`` sort each tile of ``SORT_TILE`` paths between bounces by
(dead last, direction octant, origin cell) and restore lane order at the
end (``mk_start_sorted``, ``mk_resume_sorted``, ``mk_tiles_sorted``). A pure
permutation of whole paths: every output equals the unsorted launch's bit
for bit, so only ``lane_order=True``, which also returns the order each
tile's last sort left, shows the sort itself. The chained launch never
sorts (nor does JAX's).

On a CUDA tensor the launches run the hand-written kernels of
``csrc/megakernel.cu`` (a path a thread at a time, the stackless walk over
the trace rows; K1, K4 and K5 persistent, the sorted launches a block's
paths in lockstep; K2 a path a warp where few paths go on, its tail mode;
see the notes there). On a CPU tensor they run the
plain twin below: a vectorized per-lane transcription of ``_camera_init``,
``_bounce_loop`` (with its chain block), ``_analytic_pretest``, the walk
and ``_resolve_winners`` that computes, lane by lane, what one CUDA thread
computes. Differences to the TPU kernel, all per-lane semantics of the
same estimator:

* each lane walks its own cursor (the TPU walks packets that descend when
  any lane's slab test passes) and picks the octant table by its own
  direction signs (the TPU votes per packet): the same closest hit up to
  the t-tie class;
* the ``rows`` counter counts the rows this lane visited (closest walk,
  winner fetch, shadow walk), not packet unions, and a dead lane's
  ``bounce`` stops where it died (the TPU tile loop keeps counting);
* ``lax.rsqrt`` is ``1 / sqrt`` here and in the kernel;
* the chained launch also writes a flushed sample's final RNG state to its
  RNG-pool slot (the TPU kernel leaves it 0), so ``render_waves_chained``
  returns per sweep the RNG states that separate sweeps return.

State layout: ``(N_STATE, N)`` f32, lane-major, channels ``_STATE_CH``, plus
the RNG as an ``(N,)`` int32 tensor of the u32 bits, which the kernels read
as ``uint32_t``. The twin computes in int64-held u32 values (``ops/rng.py``:
CPU torch has no uint32 shifts) and converts at its own boundary.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from hijiki_tpu_torch.ops.rng import from_bits, to_bits, wang_hash, xorshift
from hijiki_tpu_torch.ops.sort import sort_tiles_plain
from hijiki_tpu_torch.scene.compile import (
    PACKED3_BASES,
    PACKED3_SLOT_COL,
    PACKED12_BASES,
    PACKED12_SLOT_COL,
    PACKED_BASE,
    PACKED_N,
    PACKED_STRIDE,
    SLIM_PAY_STRIDE,
    SLIM_SLOT_COL,
    CompiledScene,
)

M_EPS = 1e-4
M_PI = 3.1415926535897932384626433832795
BIG = 3.0e38  # f32-finite stand-in for the reference's 1e100 -> inf tmax
# capacity granule of the compaction phases: the TPU kernel's tile of
# SUBLANES x PACKET lanes, kept so phase capacities and overflow counts
# match it
SUBLANES = 8
# the TPU's packet (lanes sharing one traversal cursor): the default of the
# render entries' ``packet`` kwarg, which the per-thread walk does not read
PACKET = 128
TILE = SUBLANES * PACKET

KIND_SPHERE = 0.0
KIND_QUAD = 1.0
KIND_TRIANGLE = 2.0
TAG_DIFFUSE = 0.0
TAG_DIFFUSECBOARD = 1.0
TAG_MIRROR = 2.0
TAG_DIELECTRIC = 3.0
TAG_EMISSIVE = 4.0

# f32 state-pack channel order (ints stored as exact small floats)
_STATE_CH = [
    "alive", "bounce", "ox", "oy", "oz", "dx", "dy", "dz", "tmin",
    "tr", "tg", "tb", "er", "eg", "eb", "Lr", "Lg", "Lb", "wd",
    "depth", "n1", "n2", "n3", "rows", "ar", "ag", "ab", "segs",
    "samp",
]
N_STATE = len(_STATE_CH)
# result-channel order of the (12, N) result buffer
_RESULT_CH = tuple(
    _STATE_CH.index(ch)
    for ch in (
        "Lr", "Lg", "Lb", "n1", "n2", "n3",
        "depth", "segs", "rows", "ar", "ag", "ab",
    )
)

# per-sweep channels the chained launch flushes as samples finish, in
# _RESULT_CH order: Lr,Lg,Lb, n1,n2,n3, depth, segs, rows, ar,ag,ab
CHAIN_OUT_CH = len(_RESULT_CH)
# lanes of one lane-sort tile: a block of the sorted kernels
# (csrc/megakernel.cu kSortTile, which must equal it: the order record
# differs otherwise; the TPU's tile was 1024 lanes, and any tile gives the
# same outputs)
SORT_TILE = 256
# the lane-sort key of a dead path: after every live one
_DEAD_KEY = 1 << 20
# render_tiles' result channels: Lr,Lg,Lb, n1,n2,n3, depth
_TILE_CH = tuple(_STATE_CH.index(ch) for ch in ("Lr", "Lg", "Lb", "n1", "n2", "n3", "depth"))
# sweeps per chained launch when chaining is auto on a CUDA device (the
# counterpart of the TPU's CHAIN_SWEEPS_TPU)
CHAIN_SWEEPS_CUDA = 8

# launches of each hand-written kernel (CUDA tensors only; the CPU twin is
# not counted), by C entry; a launch with the occlusion cache counts under
# its entry's name + "_cache" (its kCache instantiation). Read and reset by
# chip_smoke.py to prove the main path ran through the kernels. An unsorted
# K2 call launches the thread mode (mk_resume) and the tail mode
# (mk_resume_tail), of which one returns at once (csrc/megakernel.cu, the
# note at K2), after the survivor scan (mk_resume_scan) where the caller
# hands it no count; the word that the mode that ran writes is K2's record
# (RESUME_LOG).
_ENTRIES = ("mk_start", "mk_resume", "mk_start_chained", "mk_tiles",
            "mk_start_sorted", "mk_resume_sorted", "mk_tiles_sorted", "mk_resume_tail")
LAUNCHES = {name + tag: 0 for tag in ("", "_cache") for name in _ENTRIES}
LAUNCHES["mk_resume_scan"] = 0

# K2's modes (megakernel_resume's ``mode``): "auto", the card picks by the
# count of the launch's going paths (resume_threshold); "thread", one path
# a thread; "tail", one path a warp. Only tests and tools force a mode.
RESUME_MODES = ("auto", "thread", "tail")
# the word the mode that ran writes at work[1] (csrc/megakernel.cu kModeThread, kModeTail)
RESUME_MODE_WORDS = {1: "thread", 2: "tail"}
# None, or a list to which every unsorted K2 launch on the card appends
# (lanes, cap, threshold, its work[:2] on the card: the going paths' count
# it read and the word of the mode that ran), read after a render
# (chip_smoke.py)
RESUME_LOG = None

_f32 = np.float32
# layout of one baked analytic prim / emitter in the constants buffer
ANALYTIC_STRIDE = 16
EMITTER_STRIDE = 28


def _f(x) -> float:
    """Round a python float to the nearest f32 (as ``f32(x)`` in a kernel)."""
    return float(_f32(x))


@dataclass
class MegaScene:
    """Everything the megakernel reads, for one scene at one image size.

    ``rows`` is the trace table on ``device``; ``consts`` packs the baked
    analytic prims, emitters and material tables as f32 (the TPU kernel
    baked them as compile-time immediates). Each derived constant is
    computed here in double precision and rounded to f32 exactly where the
    TPU kernel's python-float arithmetic did.
    """

    rows: torch.Tensor  # (total_rows, row width) f32
    consts: torch.Tensor  # flat f32, layout below
    total_rows: int
    tbl_rows: int  # rows of one walk table (one of ntab octant tables)
    ntab: int
    analytic_mode: bool
    analytic: np.ndarray  # (NA, 16) f32
    emitters: np.ndarray  # (E, 28) f32
    diffuse: np.ndarray  # (nd, 3) f32
    cboard: np.ndarray  # (ncb, 8) f32
    diel: np.ndarray  # (ndl, 4) f32
    emissive: np.ndarray  # (nem, 3) f32
    cam: np.ndarray  # (15,) f32: c.xyz, R (row-major 3x3), halfW, halfH, scale
    root_min: torch.Tensor  # (3,) f32 BVH root box (compaction sort key)
    root_max: torch.Tensor
    # lane-sort key (_lane_sort): f32(box min) and f32(4 / box span) per
    # axis, from the scene box in double, as the TPU kernel baked them
    sort_lo: tuple
    sort_scale: tuple
    # _RESULT_CH on the device: indexing a CUDA tensor with a Python list
    # uploads the list from pageable memory, which synchronizes the stream
    # and stalls the host until every queued kernel has finished
    result_ch: torch.Tensor
    # the trace-row format: prims a packed row (1 SLIM, 3, 4, 12), 0 for
    # the classic rows; a packed table's payload section starts at row
    # pay_base = ntab * tbl_rows and holds n_pay rows (winners encode from
    # n_pay, as the classic ones from total_rows)
    packed: int = 0
    pay_base: int = 0
    n_pay: int = 0
    # the shadow-visibility boxes (K, 6) f32: x0,y0,z0, x1,y1,z1
    boxes: np.ndarray = None
    # the dedicated any-hit shadow table (PACKED3 rows) and its row count
    shadow_rows: torch.Tensor = None
    shadow_n: int = 0
    # what a launch reads (render_*'s shadow_vis and shadow_tbl, as JAX's):
    # the boxes, the dedicated shadow table; the shadow-ray occlusion cache
    # and the skip-all probe (shadow_cache, shadow_skip_all)
    shadow_vis: bool = True
    shadow_tbl: bool = False
    shadow_cache: bool = False
    shadow_skip_all: bool = False
    # the image size the camera constants were baked for
    width: int = 0
    height: int = 0

    @property
    def n_analytic(self) -> int:
        return self.analytic.shape[0]

    @property
    def nbox(self) -> int:
        """Boxes a launch tests (0 with shadow_vis off)."""
        return self.boxes.shape[0] if self.shadow_vis else 0


def _analytic_rows(bake) -> np.ndarray:
    """(kind, tag, midx, a, b, c, d0..d3): d0 = f32(r*r) for spheres, d0..2 =
    f32(edge1 x edge2) for quads — the double-precision bakes of
    ``_analytic_pretest``."""
    out = np.zeros((len(bake), ANALYTIC_STRIDE), np.float32)
    for k, e in enumerate(bake):
        out[k, :12] = e[:12]
        g = e[3:12]
        if e[0] == KIND_SPHERE:
            out[k, 12] = _f(g[3] * g[3])
        else:
            v1, v2 = g[3:6], g[6:9]
            out[k, 12] = _f(v1[1] * v2[2] - v1[2] * v2[1])
            out[k, 13] = _f(v1[2] * v2[0] - v1[0] * v2[2])
            out[k, 14] = _f(v1[0] * v2[1] - v1[1] * v2[0])
    return out


def _emitter_rows(bake) -> np.ndarray:
    """(kind, em_pdf, cdf, power3, geometry18, area_pdf, quad normal3)."""
    out = np.zeros((len(bake), EMITTER_STRIDE), np.float32)
    for e, b in enumerate(bake):
        out[e, :24] = b[:24]
        g = b[6:]
        if b[0] == 2:  # triangle (shapes/triangle.glsl:81-102)
            pa, pb, pc = g[0:3], g[3:6], g[6:9]
            ab = [pb[i] - pa[i] for i in range(3)]
            ac = [pc[i] - pa[i] for i in range(3)]
            cr = (
                ab[1] * ac[2] - ab[2] * ac[1],
                ab[2] * ac[0] - ab[0] * ac[2],
                ab[0] * ac[1] - ab[1] * ac[0],
            )
            area = 0.5 * math.sqrt(cr[0] ** 2 + cr[1] ** 2 + cr[2] ** 2)
            out[e, 24] = _f(1.0 / area)
        elif b[0] == 1:  # quad (shapes/quad.glsl:34-45)
            e1, e2 = g[3:6], g[6:9]
            cr = (
                e1[1] * e2[2] - e1[2] * e2[1],
                e1[2] * e2[0] - e1[0] * e2[2],
                e1[0] * e2[1] - e1[1] * e2[0],
            )
            area = math.sqrt(cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2])
            out[e, 24] = _f(1.0 / area)
            out[e, 25:28] = [_f(c / area) for c in cr]
        else:  # sphere (shapes/sphere.glsl:54-62)
            rr = g[3]
            out[e, 24] = _f(1.0 / (rr * rr * 4.0 * M_PI))
    return out


def _camera_consts(camera_static, width, height) -> np.ndarray:
    """``_camera_ray``'s bake: the quaternion as a rotation matrix and the
    pixel scale, in double, each rounded to f32."""
    cx, cy, cz, qx, qy, qz, qw, fov = camera_static
    R = (
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw),
        2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw),
        2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy),
    )
    scale = math.tan(math.radians(0.5 * fov)) / (0.5 * width)
    return np.asarray(
        (cx, cy, cz) + R + (0.5 * width, 0.5 * height, scale), np.float32
    )


def _lane_sort_consts(bbox) -> tuple:
    """``_lane_sort``'s bakes (pallas_megakernel.py:2013-2019): f32 of each
    box min, and f32(4 / span) with span = max(max - min, 1e-6) in double."""
    lo = tuple(_f(bbox[a]) for a in range(3))
    scale = tuple(_f(4.0 / max(bbox[a + 3] - bbox[a], 1e-6)) for a in range(3))
    return lo, scale


def _table(rows, ncols) -> np.ndarray:
    return np.asarray(rows, np.float32).reshape(-1, ncols)


# the first column of each prim of a packed row, and the slot column of
# the formats whose slots run consecutively from one column
_PACKED_BASES = {
    1: (0,),
    3: PACKED3_BASES,
    4: tuple(PACKED_BASE + PACKED_STRIDE * k for k in range(PACKED_N)),
    12: PACKED12_BASES,
}
_SLOT_COL = {1: SLIM_SLOT_COL, 3: PACKED3_SLOT_COL, 12: PACKED12_SLOT_COL}


def mega_scene(cs: CompiledScene, width: int, height: int, device) -> MegaScene:
    """Bake ``cs`` (numpy or tensor fields) for the megakernel on ``device``:
    its trace rows in any format, its shadow-visibility boxes and its
    dedicated shadow table (read as ``shadow_vis``/``shadow_tbl`` ask)."""
    packed = int(cs.mega_packed_static)
    if packed and packed not in _PACKED_BASES:
        raise ValueError(f"unknown packed trace-row format {packed}")
    diffuse, cb, diel, emis = cs.material_bake_static
    analytic = _analytic_rows(
        cs.analytic_bake_static if cs.mega_analytic_mode_static else ()
    )
    emitters = _emitter_rows(cs.emitter_bake_static)
    tabs = dict(
        diffuse=_table(diffuse, 3), cboard=_table(cb, 8),
        diel=_table(diel, 4), emissive=_table(emis, 3),
    )
    cam = _camera_consts(cs.camera_static, width, height)
    sort_lo, sort_scale = _lane_sort_consts(cs.bbox_static)
    vis = tuple(cs.shadow_vis_static or ())
    nbox = int(vis[0]) if vis else 0
    # f32(x0) of each bound, as the TPU kernel rounds its python floats
    boxes = np.asarray(vis[1:1 + 6 * nbox], np.float32).reshape(nbox, 6)
    consts = np.concatenate(
        [cam, analytic.ravel(), emitters.ravel()]
        + [tabs[k].ravel() for k in ("diffuse", "cboard", "diel", "emissive")]
        + [np.asarray(sort_lo + sort_scale, np.float32), boxes.ravel()]
    ).astype(np.float32)
    rows = torch.as_tensor(np.asarray(_cpu(cs.trace_rows_mega), np.float32))
    ntab = cs.mega_num_tables_static
    tbl_rows = cs.mega_tbl_rows_static if packed else rows.shape[0] // ntab
    shadow = cs.shadow_rows_mega
    if shadow is not None:
        shadow = torch.as_tensor(np.asarray(_cpu(shadow), np.float32)).to(device).contiguous()
    bmin = np.asarray(_cpu(cs.bvh_aabb_min), np.float32)[0]
    bmax = np.asarray(_cpu(cs.bvh_aabb_max), np.float32)[0]
    return MegaScene(
        rows=rows.to(device).contiguous(),
        consts=torch.from_numpy(consts).to(device),
        total_rows=rows.shape[0],
        tbl_rows=tbl_rows,
        ntab=ntab,
        analytic_mode=bool(cs.mega_analytic_mode_static),
        analytic=analytic,
        emitters=emitters,
        cam=cam,
        root_min=torch.from_numpy(bmin).to(device),
        root_max=torch.from_numpy(bmax).to(device),
        sort_lo=sort_lo,
        sort_scale=sort_scale,
        result_ch=torch.tensor(_RESULT_CH, device=device),
        packed=packed,
        pay_base=ntab * tbl_rows if packed else 0,
        n_pay=int(cs.mega_pay_rows_static) if packed else 0,
        boxes=boxes,
        shadow_rows=shadow,
        shadow_n=int(cs.shadow_tbl_rows_static) if shadow is not None else 0,
        width=int(width),
        height=int(height),
        **tabs,
    )


def launch_scene(ms: MegaScene, shadow_vis: bool = True, shadow_tbl: bool = False,
                 shadow_cache: bool = False, shadow_skip_all: bool = False) -> MegaScene:
    """``ms`` as a launch of ``render_*(shadow_vis=, shadow_tbl=,
    shadow_cache=, shadow_skip_all=)`` reads it (JAX's options of the same
    names): ``shadow_vis`` lets NEE skip the shadow walk of a lane whose
    origin lies in a proven box, ``shadow_tbl`` sends the shadow walks to
    the dedicated table (``_check_shadow_tbl``: the scene must have one),
    ``shadow_cache`` tests each path's predicted occluder row first. None of
    them changes the film, RNG or hit records; the ``rows`` counter moves.
    ``shadow_skip_all`` (``render_waves`` only, as JAX's): a performance
    probe only, biased image: every shadow walk is skipped, visible."""
    if shadow_tbl and ms.shadow_rows is None:
        raise ValueError(
            "shadow_tbl requires a scene compiled with a dedicated shadow table "
            "(compile_scene builds it for classic analytic-mode tables)"
        )
    if shadow_tbl and shadow_cache:
        raise ValueError(
            "shadow_cache predicts MAIN-table rows; it cannot be combined with the "
            "dedicated shadow table"
        )
    if shadow_cache and shadow_skip_all:
        raise ValueError("shadow_skip_all cannot be combined with shadow_cache")
    return dataclasses.replace(ms, shadow_vis=bool(shadow_vis), shadow_tbl=bool(shadow_tbl),
                               shadow_cache=bool(shadow_cache),
                               shadow_skip_all=bool(shadow_skip_all))


def _cpu(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else a


# bakes of the JAX call form (a CompiledScene passed to a render entry),
# one a (scene object, width, height, device): id(scene) -> (a weak
# reference to the scene, {(width, height, device): MegaScene}). A
# CompiledScene is a frozen dataclass with array fields, so it cannot be
# hashed; the weak reference, checked with ``is``, keeps a recycled id from
# returning another scene's bake, and its callback drops the entry.
_BAKED: dict = {}
# bakes made (the MegaScene form bakes nothing); read and reset by
# chip_smoke.py and the tests to show that a repeated call bakes nothing
BAKES = {"mega_scene": 0}


def _forget(key):
    def drop(ref):
        if _BAKED.get(key, (None,))[0] is ref:
            del _BAKED[key]
    return drop


def _check_scene_device(cs, device) -> None:
    """A scene whose tables live on another device than the inputs raises:
    nothing moves quietly (numpy tables are uploaded by the bake)."""
    for name in ("trace_rows_mega", "shadow_rows_mega", "bvh_aabb_min", "bvh_aabb_max"):
        t = getattr(cs, name, None)
        if isinstance(t, torch.Tensor) and t.device != device:
            raise ValueError(f"the scene's {name} lies on {t.device}, the inputs on {device}")


def scene_of(scene, width=None, height=None, device=None) -> MegaScene:
    """The ``MegaScene`` a render entry reads. A ``MegaScene`` is taken as
    it is: ``width``/``height``, if given, must be its bake's, and its
    tables must lie on ``device``. A ``CompiledScene`` (numpy or tensor
    fields; ``width`` and ``height`` required) is baked with ``mega_scene``
    once per (scene object, width, height, device) and the bake cached, so
    a caller of the JAX form that renders sweep after sweep bakes once."""
    device = None if device is None else torch.device(device)
    if isinstance(scene, MegaScene):
        for name, want, have in (("width", width, scene.width), ("height", height, scene.height)):
            if want is not None and int(want) != have:
                raise ValueError(f"{name}={want}: the MegaScene was baked for {name} {have}")
        if device is not None and scene.rows.device != device:
            raise ValueError(f"the MegaScene lies on {scene.rows.device}, the inputs on {device}")
        return scene
    if width is None or height is None:
        raise TypeError("a CompiledScene needs width= and height= (the camera's bake)")
    device = device or torch.device("cuda")
    _check_scene_device(scene, device)
    entry = _BAKED.get(id(scene))
    if entry is None or entry[0]() is not scene:
        entry = _BAKED[id(scene)] = (weakref.ref(scene, _forget(id(scene))), {})
    key = (int(width), int(height), device)
    ms = entry[1].get(key)
    if ms is None:
        ms = entry[1][key] = mega_scene(scene, width, height, device)
        BAKES["mega_scene"] += 1
    return ms


def _seed_bits(seeds):
    """Per-path seeds as the kernels read them: int32 tensors of the u32
    bits (JAX's uint32 seeds are viewed so)."""
    return seeds.view(torch.int32) if seeds.dtype == torch.uint32 else seeds


def _check_walker(lane_sort, packet, shadow_tbl, ms, table_in_hbm, shadow_cache) -> None:
    """The raises of JAX's walker kwargs that concern the request itself:
    the lane sort's one-VREG packet and ``_check_shadow_tbl``. The TPU's
    layout rules (``_check_groups``, ``_clamp_trunk``, a ray count a
    multiple of 8 * packet) do not carry over: each thread walks alone, so
    ``packet``, ``prefetch``, ``spec``, ``spec_resolve``, ``table_in_hbm``,
    ``groups``, ``group_octant``, ``trunk_rows`` and ``hbm_window`` leave
    every output as the default call's, bit for bit, and ``interpret``
    never routes a call (the inputs' device does)."""
    if lane_sort and packet != PACKET:
        raise ValueError(
            f"lane_sort requires 128-lane packets, got packet={packet} (the in-kernel "
            "bitonic lane sort only supports one-VREG packets)"
        )
    if shadow_tbl and ms.shadow_rows is not None and table_in_hbm:
        raise ValueError(
            "shadow_tbl is VMEM-only (HBM-streamed scenes keep the shared-table shadow walk)"
        )


# ----------------------------------------------------------------------------
# the plain twin: RNG and math helpers
# ----------------------------------------------------------------------------
# Every operation below is one f32 operation in the same order as the TPU
# kernel and as csrc/megakernel.cu. Division by a python number is avoided
# on purpose (torch's CUDA division by a CPU scalar multiplies by its
# reciprocal, which rounds differently).


def _u32_to_f32(s):
    """float(u32) as ``_u32_to_f32`` computes it in the TPU kernel: the bits
    as int32, converted, then +2^32 when negative (not the direct u32 cast,
    which may round 1 ULP differently for values >= 2^31)."""
    i = torch.where(s >= 2**31, s - 2**32, s)
    fv = i.to(torch.float32)
    return torch.where(i < 0, fv + 4294967296.0, fv)


def _randf(s):
    s = xorshift(s)
    return s, _u32_to_f32(s) * (1.0 / 4294967296.0)


def _atan_poly(z):
    """atan(z) for |z| <= 1, minimax odd polynomial (~1e-5 abs error)."""
    t = z * z
    p = _f(0.0208351) * t - _f(0.0851330)
    p = p * t + _f(0.1801410)
    p = p * t - _f(0.3302995)
    p = p * t + _f(0.9998660)
    return z * p


def _atan2(y, x):
    """The TPU kernel's polynomial atan2 (feeds only the sphere UV); (0, 0)
    yields NaN like GLSL's undefined atan(0, 0)."""
    ax, ay = torch.abs(x), torch.abs(y)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    r = _atan_poly(num / den)
    r = torch.where(swap, _f(0.5 * M_PI) - r, r)
    r = torch.where(x < 0, _f(M_PI) - r, r)
    return torch.where(y < 0, -r, r)


def _asin(x):
    return _atan2(x, torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0)))


def _rsqrt(x):
    """``lax.rsqrt`` as 1 / sqrt (IEEE division and square root, as in the
    CUDA kernel, which avoids the approximate ``rsqrtf``)."""
    return 1.0 / torch.sqrt(x)


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _select_row(midx, table, ncols, default=0.0):
    """``_bake_select``: row ``midx`` of a small baked table, ``default``
    where midx is past its end."""
    outs = [torch.full_like(midx, default) for _ in range(ncols)]
    for k in range(table.shape[0]):
        sel = midx == float(k)
        for j in range(ncols):
            outs[j] = torch.where(sel, float(table[k, j]), outs[j])
    return outs


def _octant_base(ms, dx, dy, dz):
    """Table base of each lane: the octant table of its own direction signs
    (the TPU kernel votes one per packet)."""
    if ms.ntab == 1:
        return torch.zeros(dx.shape, dtype=torch.int64, device=dx.device)
    oct_ = (dx > 0).long() + 2 * (dy > 0).long() + 4 * (dz > 0).long()
    return oct_ * ms.tbl_rows


# ----------------------------------------------------------------------------
# the plain twin: walks
# ----------------------------------------------------------------------------


def _analytic_test(a, o, d, tmin, best_t):
    """One baked analytic prim against all lanes -> (phit, pt, pu, pv)."""
    ox, oy, oz = o
    dx, dy, dz = d
    if a[0] == KIND_SPHERE:
        rx, ry, rz = ox - float(a[3]), oy - float(a[4]), oz - float(a[5])
        sb = 2.0 * _dot(dx, dy, dz, rx, ry, rz)
        sc = _dot(rx, ry, rz, rx, ry, rz) - float(a[12])
        disc = sb * sb - 4.0 * sc
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        st0 = -0.5 * (sb + sq)
        st1 = -0.5 * (sb - sq)
        ok0 = (tmin <= st0) & (st0 <= best_t)
        ok1 = (tmin <= st1) & (st1 <= best_t)
        pt = torch.where(ok0, st0, st1)
        phit = (disc >= 0.0) & (ok0 | ok1)
        zero = torch.zeros_like(pt)
        return phit, pt, zero, zero
    n0, n1, n2 = float(a[12]), float(a[13]), float(a[14])
    rx, ry, rz = ox - float(a[3]), oy - float(a[4]), oz - float(a[5])
    qx = ry * dz - rz * dy
    qy = rz * dx - rx * dz
    qz = rx * dy - ry * dx
    dd = 1.0 / (dx * n0 + dy * n1 + dz * n2)
    pu = -dd * (qx * float(a[9]) + qy * float(a[10]) + qz * float(a[11]))
    pv = dd * (qx * float(a[6]) + qy * float(a[7]) + qz * float(a[8]))
    pt = -dd * (n0 * rx + n1 * ry + n2 * rz)
    phit = (pu >= 0) & (pu <= 1.0) & (pv >= 0) & (pv <= 1.0)
    phit = phit & (tmin <= pt) & (pt <= best_t)
    return phit, pt, pu, pv


def _prim_test(ms, r, o, d, tmin, best_t):
    """Test the prim rows ``r`` (n, 32) against their lanes (``_prim_test``
    with classic rows; analytic tables hold triangles only)."""
    ox, oy, oz = o
    dx, dy, dz = d
    col = lambda j: r[:, j]
    v0x, v0y, v0z = col(0), col(1), col(2)
    v1x, v1y, v1z = col(3), col(4), col(5)
    v2x, v2y, v2z = col(6), col(7), col(8)
    nx, ny, nz = col(29), col(30), col(31)
    rx, ry, rz = ox - v0x, oy - v0y, oz - v0z
    qx = ry * dz - rz * dy
    qy = rz * dx - rx * dz
    qz = rx * dy - ry * dx
    dd = 1.0 / (dx * nx + dy * ny + dz * nz)
    u = -dd * (qx * v2x + qy * v2y + qz * v2z)
    v = dd * (qx * v1x + qy * v1y + qz * v1z)
    t_pq = -dd * (nx * rx + ny * ry + nz * rz)
    in_tri = (u >= 0) & (v >= 0) & (u + v <= 1.0)
    if ms.analytic_mode:
        return in_tri & (tmin <= t_pq), t_pq, u, v
    kind = col(9)
    is_tri = kind == KIND_TRIANGLE
    in_quad = (u >= 0) & (u <= 1.0) & (v >= 0) & (v <= 1.0)
    ok_pq = (is_tri & in_tri) | (~is_tri & in_quad)
    ok_pq = ok_pq & (tmin <= t_pq) & (t_pq <= best_t)
    radius = v1x
    sb = 2.0 * _dot(dx, dy, dz, rx, ry, rz)
    sc = _dot(rx, ry, rz, rx, ry, rz) - radius * radius
    disc = sb * sb - 4.0 * sc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    st0 = -0.5 * (sb + sq)
    st1 = -0.5 * (sb - sq)
    ok0 = (tmin <= st0) & (st0 <= best_t)
    ok1 = (tmin <= st1) & (st1 <= best_t)
    t_s = torch.where(ok0, st0, st1)
    ok_s = (disc >= 0.0) & (ok0 | ok1)
    is_sphere = kind == KIND_SPHERE
    phit = torch.where(is_sphere, ok_s, ok_pq)
    pt = torch.where(is_sphere, t_s, t_pq)
    pu = torch.where(is_sphere, 0.0, u)
    pv = torch.where(is_sphere, 0.0, v)
    return phit, pt, pu, pv


def _packed_test(fmt, r, o, d, tmin):
    """``_prim_test`` on packed rows ``r`` (n, width): every prim of the row
    against its lane, reduced by the strict-min-t tournament in which the
    earliest prim wins a tie (what the sequential walk over the same leaf
    accepts). Normals recomputed for formats 1, 3 and 12, baked for 4. A pad
    (a duplicate in format 4, a zero triangle in 3 and 12) never wins.
    Returns (hit, t, u, v, payload slot as f32; garbage where no hit).

    The row's prims are tested at once, as a (n, prims) axis (``r`` may
    carry trailing dimensions that broadcast against ``o``, ``d``): the same
    f32 operations per prim as one at a time, a few launches a row step."""
    ox, oy, oz = (x.unsqueeze(1) for x in o)
    dx, dy, dz = (x.unsqueeze(1) for x in d)
    tmin = tmin.unsqueeze(1) if torch.is_tensor(tmin) else tmin
    ncol = 13 if fmt == 4 else 9  # v0, edge1, edge2 (and a baked normal, the slot)
    g = r[:, [[B + j for j in range(ncol)] for B in _PACKED_BASES[fmt]]]
    col = lambda j: g[:, :, j]  # (n, prims, ...)
    v0x, v0y, v0z = col(0), col(1), col(2)
    v1x, v1y, v1z = col(3), col(4), col(5)
    v2x, v2y, v2z = col(6), col(7), col(8)
    if fmt == 4:
        nx, ny, nz = col(9), col(10), col(11)
    else:
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
    t = -dd * (nx * rx + ny * ry + nz * rz)
    phit = (u >= 0) & (v >= 0) & (u + v <= 1.0) & (tmin <= t)
    bhit, bt, bu, bv = phit[:, 0], t[:, 0], u[:, 0], v[:, 0]
    bsl = col(12)[:, 0] if fmt == 4 else torch.zeros_like(bt)
    for k in range(1, t.shape[1]):
        better = phit[:, k] & (~bhit | (t[:, k] < bt))
        bt = torch.where(better, t[:, k], bt)
        bu = torch.where(better, u[:, k], bu)
        bv = torch.where(better, v[:, k], bv)
        bsl = torch.where(better, col(12)[:, k] if fmt == 4 else float(k), bsl)
        bhit = bhit | phit[:, k]
    if fmt == 1:
        bsl = r[:, _SLOT_COL[1]]
    elif fmt != 4:  # consecutive slots from prim 0's
        bsl = r[:, _SLOT_COL[fmt]] + bsl
    return bhit, bt, bu, bv, bsl


def _walk(ms, o, d, tmin, tmax, any_hit, best, shadow=False):
    """Per-lane stackless walk of the trace rows from each lane's octant
    table: row ``cur``, then ``cur + 1`` (interior row whose box the ray
    enters) or the exit pointer in column 10. ``best`` holds the analytic
    pretest's result and is updated in place; a packed table's winner is
    its payload slot; an any-hit walk sets ``best["row"]``, where present,
    to the accepting row. ``shadow``: walk the dedicated shadow table (one
    PACKED3 table, any hit) instead. Returns the rows visited.

    Whenever the lanes that finished are half or more of those the walk
    carries, their results go back to the full-size outputs and the walk
    goes on with the others: each lane's steps are its own, so the results
    are the same bit for bit, at fewer lanes a step."""
    dx, dy, dz = d
    # the slab test's per-axis terms as (n, 3): inv = 1 / d, to = -o * inv
    # (x, y, z in columns, the same f32 operations as axis by axis)
    inv = 1.0 / torch.stack(d, 1)
    to = -torch.stack(o, 1) * inv
    if shadow:
        rows, fmt, n_rows = ms.shadow_rows, 3, ms.shadow_n
        base = torch.zeros(dx.shape, dtype=torch.int64, device=dx.device)
        end = base + n_rows
    else:
        rows, fmt, n_rows = ms.rows, ms.packed, ms.total_rows
        base = _octant_base(ms, dx, dy, dz)
        end = base + ms.tbl_rows
    # lanes that can accept nothing (tmax < 0) or already hit do not walk
    done = ~(tmax >= 0.0)
    if any_hit:
        done = done | best["hit"]
    # the lanes the walk carries, and their state ("b" + a key of best)
    w = dict(ox=o[0], oy=o[1], oz=o[2], dx=dx, dy=dy, dz=dz, inv=inv, to=to, tmin=tmin,
             tmax=tmax, end=end, cur=torch.where(done, end, base),
             nit=torch.zeros(dx.shape, dtype=torch.float32, device=dx.device),
             **{"b" + k: v for k, v in best.items()})
    outs = ["nit"] + ["b" + k for k in best]
    res, idx = {}, None  # the full-size results; w's lanes among them (None: all)

    def put_back():
        for k in outs:
            res[k] = w[k] if idx is None else res[k].index_put((idx,), w[k])

    while True:
        act = w["cur"] < w["end"]
        n_act = int(act.sum())
        if n_act == 0:
            break
        if 2 * n_act <= act.numel():
            put_back()
            keep = torch.nonzero(act).flatten()
            idx = keep if idx is None else idx[keep]
            w = {k: v[keep] for k, v in w.items()}
            act = act[keep]
        o, d = (w["ox"], w["oy"], w["oz"]), (w["dx"], w["dy"], w["dz"])
        cur, end, tmin, tmax = w["cur"], w["end"], w["tmin"], w["tmax"]
        r = rows[torch.clamp_max(cur, n_rows - 1)]
        is_prim = r[:, 9] >= 0.0
        nexit = r[:, 10].long()
        best_t = tmax if any_hit else w["bt"]
        # the box's near (columns 0-2) and far (3-5) planes along the ray;
        # t0, t1: max of the per-axis minima, min of the maxima (exact, NaN
        # propagating, in any order)
        lo = r[:, 0:3] * w["inv"] + w["to"]
        hi = r[:, 3:6] * w["inv"] + w["to"]
        t0 = torch.amax(torch.minimum(lo, hi), 1)
        t1 = torch.amin(torch.maximum(lo, hi), 1)
        slab = (t0 < t1 + _f(M_EPS)) & (t0 < best_t) & (t1 > tmin)
        if fmt:
            phit, pt, pu, pv, slot = _packed_test(fmt, r, o, d, tmin)
        else:
            phit, pt, pu, pv = _prim_test(ms, r, o, d, tmin, best_t)
        accept = act & is_prim & phit & (pt < best_t)
        nxt = torch.where(~is_prim & slab, cur + 1, nexit)
        if any_hit:
            w["bhit"] = w["bhit"] | accept
            if "brow" in w:
                w["brow"] = torch.where(accept, cur, w["brow"])
            nxt = torch.where(accept, end, nxt)
        else:
            w["bt"] = torch.where(accept, pt, w["bt"])
            w["bu"] = torch.where(accept, pu, w["bu"])
            w["bv"] = torch.where(accept, pv, w["bv"])
            w["bwrow"] = torch.where(accept, slot.long() if fmt else cur, w["bwrow"])
        w["cur"] = torch.where(act, nxt, cur)
        w["nit"] = w["nit"] + act.to(torch.float32)
        _count_rows("interior", act & ~is_prim)
        _count_rows(fmt, act & is_prim)
    put_back()
    for k in best:
        best[k] = res["b" + k]
    return res["nit"]


def _trace_closest(ms, o, d, tmin, tmax):
    """Closest hit: analytic pretest, walk, winner resolve (a packed
    table's winner from its payload row: col 0 kind, 1 tag, 2 midx, 3-17 the
    payload; SLIM's spans two rows). Returns a dict with t, u, v, hitf,
    kind, tag, midx, pay (15 tensors) and nit."""
    enc = ms.n_pay if ms.packed else ms.total_rows
    NA = ms.n_analytic
    best = dict(
        t=tmax.clone(),
        u=torch.zeros_like(tmax),
        v=torch.zeros_like(tmax),
        wrow=torch.full(tmax.shape, enc + NA, dtype=torch.int64, device=tmax.device),
    )
    for k in range(NA):
        phit, pt, pu, pv = _analytic_test(ms.analytic[k], o, d, tmin, best["t"])
        acc = phit & (pt < best["t"])
        best["t"] = torch.where(acc, pt, best["t"])
        best["u"] = torch.where(acc, pu, best["u"])
        best["v"] = torch.where(acc, pv, best["v"])
        best["wrow"] = torch.where(acc, enc + k, best["wrow"])
    nit = _walk(ms, o, d, tmin, tmax, False, best)
    wrow = best["wrow"]
    tab = wrow < enc
    _count_rows("resolve", tab)
    zero = torch.zeros_like(tmax)
    if ms.packed:
        stride = SLIM_PAY_STRIDE if ms.packed == 1 else 1
        at = ms.pay_base + torch.clamp_max(wrow, (enc - 1) // stride) * stride
        r = ms.rows[at]
        r2 = ms.rows[at + 1] if ms.packed == 1 else None
        kind = torch.where(tab, r[:, 0], zero)
        tag, midx = r[:, 1], r[:, 2]
        pay = [torch.where(tab, r2[:, j - 12] if j >= 12 and r2 is not None else r[:, 3 + j], zero)
               for j in range(15)]
    else:
        r = ms.rows[torch.clamp_max(wrow, enc - 1)]
        kind = torch.where(tab, r[:, 9], zero)
        tag, midx = r[:, 12], r[:, 13]
        is_tri = kind == KIND_TRIANGLE
        pay = []
        for j in range(15):
            geo = r[:, j] if j < 9 else zero
            pay.append(torch.where(tab, torch.where(is_tri, r[:, 14 + j], geo), zero))
    out = dict(
        t=best["t"], u=best["u"], v=best["v"],
        hitf=wrow < enc + NA,
        kind=kind,
        tag=torch.where(tab, tag, zero),
        midx=torch.where(tab, midx, zero),
        nit=nit + tab.to(torch.float32),
    )
    for k in range(NA):
        a = ms.analytic[k]
        sel = wrow == enc + k
        for name, c in (("kind", 0), ("tag", 1), ("midx", 2)):
            out[name] = torch.where(sel, float(a[c]), out[name])
        for j in range(9):
            pay[j] = torch.where(sel, float(a[3 + j]), pay[j])
    out["pay"] = pay
    return out


def _row_occludes(ms, pred, o, d, tmin, tmax):
    """The occlusion cache's pretest (``_anyhit_pretest``): whether row
    ``pred`` of the main table occludes (tmin, tmax), by the walk's own
    accept (``_prim_test`` with best_t = tmax, or any prim of a packed row:
    the tournament's min t below tmax)."""
    r = ms.rows[torch.clamp(pred, 0, ms.total_rows - 1)]
    if ms.packed:
        phit, pt, _, _, _ = _packed_test(ms.packed, r, o, d, tmin)
    else:
        phit, pt, _, _ = _prim_test(ms, r, o, d, tmin, tmax)
    return phit & (pt < tmax)


# the rows the twin visited since reset_row_kinds(), summed on the lanes'
# device: "interior" rows, per walked table format (0 classic, 1 SLIM, 3
# PACKED3: the shadow table's too, 4 PACKED4, 12 PACKED12) its prim rows,
# the occlusion cache's tested rows included, and "resolve": the closest
# hit's winner row read to shade it (no test). They sum to the ``rows``
# counter, so a kernel's rows split as its plain version's do
_ROW_KINDS = {}


def reset_row_kinds() -> None:
    _ROW_KINDS.clear()


def row_kinds() -> dict:
    """{"interior": rows, format: prim rows, ...} the twin visited since
    ``reset_row_kinds`` (the kernels, bit-equal to the twin on every path's
    rows, split none)."""
    return {k: int(v) for k, v in _ROW_KINDS.items()}


def _count_rows(kind, mask) -> None:
    _ROW_KINDS[kind] = mask.sum() + _ROW_KINDS.get(kind, 0)


# the twin's occlusion-cache pretests since reset_pretest_counts(), summed
# on the lanes' device: lanes that tested a predicted row ("tried") and
# lanes whose row verified, answered without a walk ("verified")
_PRETESTS = {}


def reset_pretest_counts() -> None:
    _PRETESTS.clear()


def pretest_counts() -> tuple:
    """(tried, verified): the twin's occlusion-cache pretests since
    ``reset_pretest_counts`` (the kernels, bit-equal to the twin on every
    path's rows, count none)."""
    return tuple(int(_PRETESTS[k]) if k in _PRETESTS else 0 for k in ("tried", "verified"))


def _trace_any(ms, o, d, tmin, tmax, pred=None):
    """Any hit in (tmin, tmax), over the dedicated shadow table when the
    launch reads it: returns (hit bool, rows visited, the row that answered).
    ``pred`` (the occlusion cache): each lane's predicted row (-1: none),
    tested after the analytic prims and before the walk (a row visited);
    the row that answered is the verified one or where the walk accepted,
    -1 where an analytic prim or nothing occluded (None without ``pred``)."""
    best = dict(hit=torch.zeros(tmax.shape, dtype=torch.bool, device=tmax.device))
    for k in range(ms.n_analytic):
        bt = torch.where(best["hit"], tmin, tmax)
        phit, pt, _, _ = _analytic_test(ms.analytic[k], o, d, tmin, bt)
        best["hit"] = best["hit"] | (phit & (pt < bt))
    pre = None
    if pred is not None:
        tried = ~best["hit"] & (pred >= 0) & (pred < ms.total_rows)
        verified = tried & _row_occludes(ms, pred, o, d, tmin, tmax)
        best["hit"] = best["hit"] | verified
        best["row"] = torch.where(verified, pred, -1)
        pre = tried.to(torch.float32)
        for k, m in (("tried", tried), ("verified", verified)):
            _PRETESTS[k] = m.sum() + _PRETESTS.get(k, 0)
        _count_rows(ms.packed, tried)
    nit = _walk(ms, o, d, tmin, tmax, True, best, shadow=ms.shadow_tbl)
    if pre is not None:
        nit = pre + nit
    return best["hit"], nit, best.get("row")


def _proven(ms, hx, hy, hz):
    """Lanes whose NEE origin lies in a shadow-visibility box (closed f32
    compares), or None when the launch tests no box."""
    proven = None
    for b in ms.boxes[: ms.nbox]:
        x0, y0, z0, x1, y1, z1 = (float(x) for x in b)
        inb = (hx >= x0) & (hx <= x1) & (hy >= y0) & (hy <= y1) & (hz >= z0) & (hz <= z1)
        proven = inb if proven is None else proven | inb
    return proven


# ----------------------------------------------------------------------------
# the plain twin: camera, one bounce, the bounce loop
# ----------------------------------------------------------------------------


def _camera_ray(ms, px, py):
    """``_camera_ray``: jittered pinhole direction from the baked matrix."""
    c = [float(x) for x in ms.cam]
    R = c[3:12]
    half_w, half_h, scale = c[12], c[13], c[14]
    lx = (px - half_w) * scale
    ly = -(py - half_h) * scale
    dxu = R[0] * lx + R[1] * ly - R[2]
    dyu = R[3] * lx + R[4] * ly - R[5]
    dzu = R[6] * lx + R[7] * ly - R[8]
    inv_len = _rsqrt(dxu * dxu + dyu * dyu + dzu * dzu)
    return dxu * inv_len, dyu * inv_len, dzu * inv_len


def _camera_init(ms, px, py, seeds):
    """Initial path state (``_camera_init``): dict of per-lane tensors."""
    ndx, ndy, ndz = _camera_ray(ms, px, py)
    zero = torch.zeros_like(px)
    one = torch.ones_like(px)
    s = {ch: zero for ch in _STATE_CH}
    s.update(
        alive=one, bounce=zero, segs=px * 0.0, samp=px * 0.0,
        ox=torch.full_like(px, float(ms.cam[0])),
        oy=torch.full_like(px, float(ms.cam[1])),
        oz=torch.full_like(px, float(ms.cam[2])),
        dx=ndx, dy=ndy, dz=ndz,
        tmin=torch.full_like(px, _f(M_EPS)),
        tr=one, tg=one, tb=one, wd=one,
    )
    s["state"] = wang_hash(seeds)
    return _with_pred(ms, s)


def _with_pred(ms, s):
    """``s`` with each path's occlusion-cache prediction at -1 (``srow``,
    int64), when the launch runs the cache."""
    if ms.shadow_cache:
        s["srow"] = torch.full(s["alive"].shape, -1, dtype=torch.int64,
                               device=s["alive"].device)
    return s


def _checkerboard(c1r, c1g, c1b, su, c2r, c2g, c2b, sv, uvx, uvy):
    """materials/diffusecb.glsl:6-13."""
    stx = 0.5 * uvx / su
    sty = 0.5 * uvy / sv
    stx = stx - torch.floor(stx)
    sty = sty - torch.floor(sty)
    flip = (stx < 0.5) ^ (sty < 0.5)
    return (
        torch.where(flip, c2r, c1r),
        torch.where(flip, c2g, c1g),
        torch.where(flip, c2b, c1b),
    )


def _sample_emitters(ms, u_pick, eu1, eu2):
    """Threshold emitter pick (scene.glsl:57-64: first e with u < cdf_e,
    fallback emitter 0) and the picked emitter's point sample."""
    W = torch.where
    sel_out = None
    for e in range(ms.emitters.shape[0]):
        b = [float(x) for x in ms.emitters[e]]
        g = b[6:24]
        if b[0] == 2:  # triangle
            pa, pb, pc = g[0:3], g[3:6], g[6:9]
            na, nb, nc = g[9:12], g[12:15], g[15:18]
            lu = W(eu1 + eu2 > 1.0, 1.0 - eu2, eu1)
            lv = eu2
            lw = 1.0 - lu - lv
            cp = [pa[i] * lu + pb[i] * lv + pc[i] * lw for i in range(3)]
            cn = [na[i] * lu + nb[i] * lv + nc[i] * lw for i in range(3)]
            inv = _rsqrt(torch.clamp_min(_dot(*cn, *cn), _f(1e-30)))
            cn = [x * inv for x in cn]
        elif b[0] == 1:  # quad
            qo, e1, e2 = g[0:3], g[3:6], g[6:9]
            cn = [torch.full_like(u_pick, b[25 + i]) for i in range(3)]
            cp = [qo[i] + eu1 * e1[i] + eu2 * e2[i] for i in range(3)]
        else:  # sphere
            z = 2.0 * eu1 - 1.0
            theta = _f(2.0 * M_PI) * eu2
            rxy = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
            cn = [rxy * torch.cos(theta), rxy * torch.sin(theta), z]
            cp = [g[i] + g[3] * cn[i] for i in range(3)]
        vals = cp + cn + [torch.full_like(u_pick, b[24])] + [
            torch.full_like(u_pick, b[i]) for i in (3, 4, 5, 1)
        ]
        if sel_out is None:
            sel_out = vals
        else:
            sel = (u_pick >= float(ms.emitters[e - 1, 2])) & (u_pick < b[2])
            sel_out = [W(sel, v, s) for v, s in zip(vals, sel_out)]
    return sel_out  # px,py,pz, nx,ny,nz, area_pdf, pwr,pwg,pwb, em_pdf


def _bounce(ms, s):
    """One bounce of every lane in ``s`` (all alive and under their cap):
    the body of ``_bounce_loop``. Returns the new state dict."""
    W = torch.where
    f32 = torch.float32
    ox, oy, oz = s["ox"], s["oy"], s["oz"]
    dx, dy, dz = s["dx"], s["dy"], s["dz"]
    h = _trace_closest(ms, (ox, oy, oz), (dx, dy, dz), s["tmin"],
                       torch.full_like(ox, BIG))
    found = h["hitf"]
    t, kind, tag, midx = h["t"], h["kind"], h["tag"], h["midx"]
    u, v, pay = h["u"], h["v"], h["pay"]
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz

    # ---- shading frame (scalarized populate_intersection) ----
    is_s = kind == KIND_SPHERE
    is_q = kind == KIND_QUAD
    sr_inv = 1.0 / W(is_s, pay[3], 1.0)
    snx, sny, snz = (hx - pay[0]) * sr_inv, (hy - pay[1]) * sr_inv, (hz - pay[2]) * sr_inv
    st_len = _rsqrt(torch.clamp_min(snz * snz + snx * snx, _f(1e-30)))
    stx, stz = -snz * st_len, snx * st_len
    sbx, sby, sbz = sny * stz, snz * stx - snx * stz, -sny * stx
    s_uvx = 0.5 + _atan2(snz, snx) * _f(1.0 / (2.0 * M_PI))
    s_uvx = W(torch.isnan(s_uvx), 0.0, s_uvx)
    s_uvy = 0.5 + _asin(torch.clamp(sny, -1.0, 1.0)) * _f(1.0 / M_PI)

    q1l = _rsqrt(torch.clamp_min(_dot(pay[3], pay[4], pay[5], pay[3], pay[4], pay[5]), _f(1e-30)))
    qtx, qty, qtz = pay[3] * q1l, pay[4] * q1l, pay[5] * q1l
    q2l = _rsqrt(torch.clamp_min(_dot(pay[6], pay[7], pay[8], pay[6], pay[7], pay[8]), _f(1e-30)))
    qbx, qby, qbz = pay[6] * q2l, pay[7] * q2l, pay[8] * q2l
    qnx, qny, qnz = qty * qbz - qtz * qby, qtz * qbx - qtx * qbz, qtx * qby - qty * qbx

    lam0 = 1.0 - u - v
    tnx = pay[0] * lam0 + pay[3] * u + pay[6] * v
    tny = pay[1] * lam0 + pay[4] * u + pay[7] * v
    tnz = pay[2] * lam0 + pay[5] * u + pay[8] * v
    tn_inv = _rsqrt(torch.clamp_min(_dot(tnx, tny, tnz, tnx, tny, tnz), _f(1e-30)))
    tnx, tny, tnz = tnx * tn_inv, tny * tn_inv, tnz * tn_inv
    t_uvx = pay[9] * lam0 + pay[11] * u + pay[13] * v
    t_uvy = pay[10] * lam0 + pay[12] * u + pay[14] * v
    use_y = torch.abs(tnx) > torch.abs(tny)
    ttx = W(use_y, -tnz, 0.0)
    tty = W(use_y, 0.0, tnz)
    ttz = W(use_y, tnx, -tny)
    tt_inv = _rsqrt(torch.clamp_min(_dot(ttx, tty, ttz, ttx, tty, ttz), _f(1e-30)))
    ttx, tty, ttz = ttx * tt_inv, tty * tt_inv, ttz * tt_inv
    tbx, tby, tbz = tny * ttz - tnz * tty, tnz * ttx - tnx * ttz, tnx * tty - tny * ttx

    sel3 = lambda a_s, a_q, a_t: W(is_s, a_s, W(is_q, a_q, a_t))
    nx, ny, nz = sel3(snx, qnx, tnx), sel3(sny, qny, tny), sel3(snz, qnz, tnz)
    fx, fy, fz = sel3(stx, qtx, ttx), sel3(torch.zeros_like(stx), qty, tty), sel3(stz, qtz, ttz)
    bx_, by_, bz_ = sel3(sbx, qbx, tbx), sel3(sby, qby, tby), sel3(sbz, qbz, tbz)
    uvx, uvy = sel3(s_uvx, u, t_uvx), sel3(s_uvy, v, t_uvy)

    first = (s["bounce"] == 0) & found
    out = dict(s)
    out["depth"] = W(first, t, s["depth"])
    out["n1"], out["n2"], out["n3"] = (W(first, c, s[k]) for c, k in ((nx, "n1"), (ny, "n2"), (nz, "n3")))

    # Beer-Lambert (render.glsl:111-112)
    ddx, ddy, ddz = hx - ox, hy - oy, hz - oz
    dist = torch.sqrt(_dot(ddx, ddy, ddz, ddx, ddy, ddz))
    tr = W(found, s["tr"] * torch.exp(-s["er"] * dist), s["tr"])
    tg = W(found, s["tg"] * torch.exp(-s["eg"] * dist), s["tg"])
    tb = W(found, s["tb"] * torch.exp(-s["eb"] * dist), s["tb"])

    # emissive accumulation (render.glsl:114-116)
    pw = _select_row(midx, ms.emissive, 3)
    em = found & (tag == TAG_EMISSIVE) & (s["wd"] > 0)
    Lr = W(em, s["Lr"] + tr * pw[0], s["Lr"])
    Lg = W(em, s["Lg"] + tg * pw[1], s["Lg"])
    Lb = W(em, s["Lb"] + tb * pw[2], s["Lb"])

    # ---- NEE (render.glsl:117-126, scene.glsl:54-89) ----
    dif = found & ((tag == TAG_DIFFUSE) | (tag == TAG_DIFFUSECBOARD))
    st = s["state"]
    st1, u_pick = _randf(st)
    st2, eu1 = _randf(st1)
    st3, eu2 = _randf(st2)
    new_state = W(dif, st3, st)
    epx, epy, epz, enx, eny, enz, epdf, epwr, epwg, epwb, em_pdf = _sample_emitters(
        ms, u_pick, eu1, eu2
    )
    svx, svy, svz = epx - hx, epy - hy, epz - hz
    sdist = torch.sqrt(_dot(svx, svy, svz, svx, svy, svz))
    sd_inv = 1.0 / sdist
    sdx, sdy, sdz = svx * sd_inv, svy * sd_inv, svz * sd_inv
    cos_theta = -_dot(sdx, sdy, sdz, enx, eny, enz)
    pdf = em_pdf * epdf * sdist * sdist / cos_theta
    inv_pdf = W(cos_theta < 0.0, 0.0, 1.0 / pdf)
    impr, impg, impb = epwr * inv_pdf, epwg * inv_pdf, epwb * inv_pdf
    imp_len = torch.sqrt(_dot(impr, impg, impb, impr, impg, impb))
    gate = dif & (imp_len > _f(M_EPS)) & (_dot(sdx, sdy, sdz, nx, ny, nz) > 0)
    # a lane in a proven box skips its walk: visible (_bounce_loop
    # :2360-2378); skip-all skips every walk (:2380-2385)
    proven = _proven(ms, hx, hy, hz)
    walk_gate = torch.zeros_like(gate) if ms.shadow_skip_all else gate
    walk_gate = walk_gate if proven is None else walk_gate & ~proven
    occluded, nit_s, orow = _trace_any(
        ms, (hx, hy, hz), (sdx, sdy, sdz),
        torch.full_like(sdist, _f(2.0 * M_EPS)),
        W(walk_gate, sdist - _f(M_EPS), -1.0),
        W(walk_gate, s["srow"], -1) if ms.shadow_cache else None,
    )
    if ms.shadow_cache:  # a gated path predicts the row that answered it
        out["srow"] = W(gate, orow, s["srow"])

    # eval BSDF for NEE (material.glsl:18-30)
    dcol = _select_row(midx, ms.diffuse, 3)
    if ms.cboard.shape[0]:
        cbr, cbg, cbb = _checkerboard(*_select_row(midx, ms.cboard, 8), uvx, uvy)
    else:
        cbr = cbg = cbb = torch.zeros_like(midx)
    cosw = _dot(sdx, sdy, sdz, nx, ny, nz)
    is_dif = tag == TAG_DIFFUSE
    is_cb = tag == TAG_DIFFUSECBOARD
    fa = found & (s["bounce"] == 0)
    for ch, dc, cc in (("ar", dcol[0], cbr), ("ag", dcol[1], cbg), ("ab", dcol[2], cbb)):
        out[ch] = W(fa, W(is_dif, dc, W(is_cb, cc, 0.0)), s[ch])
    add = gate & ~occluded
    inv_pi = _f(1.0 / M_PI)
    Lr = W(add, Lr + tr * (cosw * W(is_dif, dcol[0], cbr) * inv_pi) * impr, Lr)
    Lg = W(add, Lg + tg * (cosw * W(is_dif, dcol[1], cbg) * inv_pi) * impg, Lg)
    Lb = W(add, Lb + tb * (cosw * W(is_dif, dcol[2], cbb) * inv_pi) * impb, Lb)

    # ---- BSDF sampling (material.glsl:33-91) ----
    stA, bu1 = _randf(new_state)
    stB, bu2 = _randf(stA)
    rad = torch.sqrt(bu1)
    th = _f(2.0 * M_PI) * bu2
    hlx, hly = rad * torch.cos(th), rad * torch.sin(th)
    hlz = torch.sqrt(torch.clamp_min(1.0 - bu1, 0.0))
    wdf = [f * hlx + b * hly + n * hlz for f, b, n in ((fx, bx_, nx), (fy, by_, ny), (fz, bz_, nz))]

    din = _dot(dx, dy, dz, nx, ny, nz)
    wm = [dc - 2.0 * din * n for dc, n in ((dx, nx), (dy, ny), (dz, nz))]

    # dielectric (material.glsl:50-87 verbatim, incl. quirks)
    if ms.diel.shape[0]:
        ext_r, ext_g, ext_b, eta0 = _select_row(midx, ms.diel, 4)
    else:
        ext_r = ext_g = ext_b = torch.zeros_like(midx)
        eta0 = torch.ones_like(midx)
    eta_inv0 = 1.0 / eta0
    cos_i0 = -din
    flip = cos_i0 < 0.0
    eta = W(flip, eta_inv0, eta0)
    # inside-hit etaInv = fl(1/fl(1/eta)), the reference's double reciprocal
    eta_inv = W(flip, 1.0 / eta_inv0, eta_inv0)
    nnx, nny, nnz = W(flip, -nx, nx), W(flip, -ny, ny), W(flip, -nz, nz)
    cos_i = W(flip, -cos_i0, cos_i0)
    kk = 1.0 - eta_inv * eta_inv * (1.0 - cos_i * cos_i)
    tir = kk <= 0.0
    cos_o = torch.sqrt(torch.clamp_min(kk, 0.0))
    rho_par = (eta * cos_i - cos_o) / (eta * cos_i + cos_o)
    rho_orth = (cos_i - eta * cos_o) / (cos_i + eta * cos_o)
    f_r = 0.5 * (rho_par * rho_par + rho_orth * rho_orth)
    choose_reflect = bu1 < f_r
    dinn = _dot(dx, dy, dz, nnx, nny, nnz)
    refl = tir | choose_reflect
    wdl = [
        W(refl, dc - 2.0 * dinn * n, eta_inv * (dc - dinn * n) - cos_o * n)
        for dc, n in ((dx, nnx), (dy, nny), (dz, nnz))
    ]
    inside0 = cos_i0 > 0.0
    refracted = ~tir & ~choose_reflect
    inside_final = refracted ^ inside0

    is_mir = tag == TAG_MIRROR
    is_dl = tag == TAG_DIELECTRIC
    difish = is_dif | is_cb
    wo = [
        W(difish, a, W(is_mir, b, W(is_dl, c, dc)))
        for a, b, c, dc in zip(wdf, wm, wdl, (dx, dy, dz))
    ]
    spec_w = W(is_mir | is_dl, 1.0, 0.0)
    wr_ = W(is_dif, dcol[0], W(is_cb, cbr, spec_w))
    wg_ = W(is_dif, dcol[1], W(is_cb, cbg, spec_w))
    wb_ = W(is_dif, dcol[2], W(is_cb, cbb, spec_w))
    set_ext = is_dl & found & inside_final
    out["er"] = W(set_ext, ext_r, s["er"])
    out["eg"] = W(set_ext, ext_g, s["eg"])
    out["eb"] = W(set_ext, ext_b, s["eb"])

    consumed2 = found & difish
    consumed1 = found & is_dl & ~tir
    new_state = W(consumed2, stB, W(consumed1, stA, new_state))

    tr, tg, tb = W(found, tr * wr_, tr), W(found, tg * wg_, tg), W(found, tb * wb_, tb)
    out["ox"], out["oy"], out["oz"] = W(found, hx, ox), W(found, hy, oy), W(found, hz, oz)
    out["dx"], out["dy"], out["dz"] = W(found, wo[0], dx), W(found, wo[1], dy), W(found, wo[2], dz)
    out["tmin"] = W(found, _f(2.0 * M_EPS), s["tmin"])
    out["wd"] = W(found, (~difish).to(f32), s["wd"])

    # Russian roulette (render.glsl:137-144)
    rr = found & (s["bounce"] > 3)
    stC, u_rr = _randf(new_state)
    out["state"] = W(rr, stC, new_state)
    q = torch.minimum(torch.full_like(tr, _f(0.99)), torch.maximum(tr, torch.maximum(tg, tb)))
    kill = rr & (u_rr > q)
    keepq = rr & ~kill
    out["tr"], out["tg"], out["tb"] = W(keepq, tr / q, tr), W(keepq, tg / q, tg), W(keepq, tb / q, tb)
    out["Lr"], out["Lg"], out["Lb"] = Lr, Lg, Lb
    out["alive"] = (found & ~kill).to(f32)
    out["bounce"] = s["bounce"] + 1.0
    out["segs"] = s["segs"] + 1.0
    out["rows"] = s["rows"] + h["nit"] + nit_s
    return out


def _grid_cell(x):
    """``clip(int32(x), 0, 3)`` as XLA computes it (a saturating cast, NaN
    -> 0), clamped in float before the cast as the kernel does."""
    return torch.where(torch.isnan(x), 0.0, torch.clamp(x, 0.0, 3.0)).to(torch.int32)


def lane_sort_key(ms, s):
    """``_lane_sort``'s key of each lane: octant + 8 * (qx + 4 * (qy + 4 *
    qz)) for a live path (q: the origin's cell of a 4x4x4 grid over the
    scene box), 1 << 20 for a dead one. int32."""
    q = [_grid_cell((s[o] - ms.sort_lo[a]) * ms.sort_scale[a])
         for a, o in enumerate(("ox", "oy", "oz"))]
    octant = ((s["dx"] > 0).to(torch.int32) + 2 * (s["dy"] > 0).to(torch.int32)
              + 4 * (s["dz"] > 0).to(torch.int32))
    key = octant + 8 * (q[0] + 4 * (q[1] + 4 * q[2]))
    return torch.where(s["alive"] > 0, key, _DEAD_KEY)


def _lane_sort(ms, s, tiles):
    """Permute the paths of each ``SORT_TILE``-lane tile listed in ``tiles``
    by ``lane_sort_key`` (``sort_tiles_plain`` on every state channel, the
    RNG and the path id); the other tiles stay as they are."""
    key = lane_sort_key(ms, s).view(-1, SORT_TILE)[tiles]
    pred = [s["srow"].to(torch.int32)] if "srow" in s else []
    chans = torch.stack([s[ch].view(torch.int32) for ch in _STATE_CH]
                        + [to_bits(s["state"]), s["pid"]] + pred)
    chans = chans.view(len(chans), -1, SORT_TILE)
    chans[:, tiles] = sort_tiles_plain(key, chans[:, tiles])[1]
    out = chans.view(len(chans), -1)
    new = {ch: out[i].view(torch.float32) for i, ch in enumerate(_STATE_CH)}
    new["state"] = from_bits(out[N_STATE])
    new["pid"] = out[N_STATE + 1]
    if pred:  # the prediction moves with its path
        new["srow"] = out[N_STATE + 2].long()
    return new


def _bounce_loop(ms, s, cap, lane_sort=False):
    """Bounce every lane while it is alive and under ``cap`` bounces. Each
    pass runs one bounce of the lanes still going (per-lane semantics).

    With ``lane_sort`` the lanes are padded with dead paths to whole tiles,
    and each pass in which a tile had a lane going ends with ``_lane_sort``
    of that tile (the sorted kernels loop per block, JAX per tile). At the
    end ``order`` records the permutation of each tile's last sort, (2, N)
    int32: the path id at each lane and its key; then the lanes go back to
    their own order."""
    s = dict(s)
    n = s["alive"].shape[0]
    if lane_sort:
        pad = (-n) % SORT_TILE
        s = {k: torch.cat([v, v.new_zeros(pad)]) for k, v in s.items()}  # alive 0
        if "srow" in s:
            s["srow"][n:] = -1
        s["pid"] = torch.arange(n + pad, dtype=torch.int32, device=s["alive"].device)
    while True:
        go = (s["alive"] > 0) & (s["bounce"] < cap)
        idx = torch.nonzero(go).flatten()
        if idx.numel() == 0:
            break
        sub = _bounce(ms, {k: v[idx] for k, v in s.items() if k != "pid"})
        for k in sub:
            s[k] = s[k].index_put((idx,), sub[k])
        if lane_sort:
            s = _lane_sort(ms, s, torch.nonzero(go.view(-1, SORT_TILE).any(1)).flatten())
    if lane_sort:
        order = torch.stack([s["pid"], lane_sort_key(ms, s)])[:, :n]
        pid = s.pop("pid").long()
        s = {k: torch.empty_like(v).index_put_((pid,), v)[:n] for k, v in s.items()}
        s["order"] = order
    return s


def _pack(s):
    return torch.stack([s[ch] for ch in _STATE_CH]), to_bits(s["state"])


def _unpack(st, rng):
    s = {ch: st[i] for i, ch in enumerate(_STATE_CH)}
    s["state"] = from_bits(rng)
    return s


def megakernel_start_chained_plain(ms: MegaScene, pxs, pys, seeds, cap: int):
    """The plain twin of K4 (any device): the chain block of
    ``_bounce_loop`` (pallas_megakernel.py:2618-2681) in lockstep. Bounce the
    lanes that are going; then, per lane whose sample has stopped, park it
    (still alive at ``cap``) or flush it (dead), and respawn the lane on its
    pixel's next sample. Returns what ``megakernel_start_chained`` does."""
    S, n = pxs.shape
    dev = pxs.device
    pool = torch.zeros((N_STATE, S * n), dtype=torch.float32, device=dev)
    pool_rng = torch.zeros(S * n, dtype=torch.int32, device=dev)
    chain_out = torch.zeros((CHAIN_OUT_CH, S * n), dtype=torch.float32, device=dev)
    s = _camera_init(ms, pxs[0], pys[0], from_bits(seeds[0]))
    done = torch.zeros(n, dtype=torch.bool, device=dev)  # all samples traced
    while True:
        going = ~done & (s["alive"] > 0) & (s["bounce"] < cap)
        idx = torch.nonzero(~done & ~going).flatten()
        if idx.numel():
            samp = s["samp"][idx].long()
            slot = samp * n + idx
            st, rng = _pack({k: v[idx] for k, v in s.items()})
            parked = st[0] > 0
            pool[:, slot[parked]] = st[:, parked]
            chain_out[:, slot[~parked]] = st[list(_RESULT_CH)][:, ~parked]
            pool_rng[slot] = rng
            more = samp < S - 1
            lanes, nxt = idx[more], samp[more] + 1
            fresh = _camera_init(ms, pxs[nxt, lanes], pys[nxt, lanes], from_bits(seeds[nxt, lanes]))
            fresh["samp"] = nxt.to(torch.float32)
            for k in s:
                s[k] = s[k].index_put((lanes,), fresh[k])
            done = done.index_put((idx[~more],), torch.ones((), dtype=torch.bool, device=dev))
            continue  # the respawned lanes are going now
        gidx = torch.nonzero(going).flatten()
        if gidx.numel() == 0:
            return pool, pool_rng, chain_out
        sub = _bounce(ms, {k: v[gidx] for k, v in s.items()})
        for k in s:
            s[k] = s[k].index_put((gidx,), sub[k])


# ----------------------------------------------------------------------------
# kernel wrappers: CUDA tensor -> hand-written kernel, CPU tensor -> twin
# ----------------------------------------------------------------------------


def _scene_args(ms):
    """The scene's arguments of a C entry after its rows and constants
    pointers (csrc/walk.cuh SCENE_ARGS): the table's sizes and the bakes'
    counts (the first 10, which is all a build before the packed formats
    takes), the packed format, the payload rows, the boxes a launch tests,
    the dedicated shadow table (a null pointer when not read; the 15 a
    build before the cache takes), the occlusion cache and skip-all."""
    shadow = ms.shadow_rows if ms.shadow_tbl else None
    return (
        ms.total_rows, ms.tbl_rows, ms.ntab, int(ms.analytic_mode),
        ms.n_analytic, ms.emitters.shape[0], ms.diffuse.shape[0],
        ms.cboard.shape[0], ms.diel.shape[0], ms.emissive.shape[0],
        ms.packed, ms.n_pay, ms.nbox,
        None if shadow is None else shadow.data_ptr(), 0 if shadow is None else ms.shadow_n,
        int(ms.shadow_cache), int(ms.shadow_skip_all),
    )


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor on {device}")


def check_rows_aligned(rows, shadow=None):
    """The walk reads a trace row's columns four at a time (128-bit loads,
    csrc/walk.cuh): the table, and the dedicated shadow table it walks, must
    start on a 16-byte boundary."""
    for t in (rows, shadow):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the trace rows must start on a 16-byte boundary (a fresh tensor does)")


def _launch(fn_name, ms, ins, ints, outs, persistent=False, extra=()):
    """Run the C entry ``fn_name`` of csrc/megakernel.cu on the current
    stream: scene, input pointers, ``ints``, output pointers (None: a null
    pointer), for the ``persistent`` K1, K4 and K5 their work counter zeroed
    on the stream, ``extra`` (a tensor as its pointer, an int or None as
    it is: K2's work buffer, count and threshold), then the stream. The
    first int is the lane count; nothing launches for 0 lanes. Returns the
    outputs that are not None."""
    from hijiki_tpu_torch.utils.build import load_library

    if ints[0]:
        check_rows_aligned(ms.rows, ms.shadow_rows if ms.shadow_tbl else None)
        lib = load_library()
        stream = torch.cuda.current_stream(ms.rows.device).cuda_stream
        counter = [torch.zeros(1, dtype=torch.int32, device=ms.rows.device)] if persistent else []
        rc = getattr(lib, fn_name)(
            ms.rows.data_ptr(), ms.consts.data_ptr(), *_scene_args(ms),
            *[t.data_ptr() for t in ins], *ints,
            *[None if t is None else t.data_ptr() for t in outs],
            *[t.data_ptr() for t in counter],
            *[a.data_ptr() if torch.is_tensor(a) else a for a in extra], stream,
        )
        LAUNCHES[fn_name + ("_cache" if ms.shadow_cache else "")] += 1
        if rc != 0:
            raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")
    return tuple(t for t in outs if t is not None)


def _check_camera_inputs(ms, px, py, seeds, shape):
    dev = ms.rows.device
    _check("px", px, torch.float32, shape, dev)
    _check("py", py, torch.float32, shape, dev)
    _check("seeds", seeds, torch.int32, shape, dev)


def _check_lane_order(lane_sort, lane_order):
    if lane_order and not lane_sort:
        raise ValueError("lane_order records the lane sort: it needs lane_sort=True")


def _entry(name, lane_sort, lane_order, n, dev):
    """(C entry, extra outputs) of a K1/K2/K5 launch: the unsorted entry, or
    the sorted one with its order record ((2, n) int32, or None when not
    asked for)."""
    _check_lane_order(lane_sort, lane_order)
    if not lane_sort:
        return name, []
    order = torch.empty((2, n), dtype=torch.int32, device=dev) if lane_order else None
    return name + "_sorted", [order]


def _with_order(out, s, lane_order):
    return (*out, s["order"]) if lane_order else out


def megakernel_start(ms: MegaScene, px, py, seeds, cap: int, lane_sort: bool = False,
                     lane_order: bool = False):
    """Camera launch (K1, replaces ``_megakernel_start``): raygen and
    bounces up to ``cap``. px/py (N,) f32, seeds (N,) int32 u32 bits.
    Returns (state (N_STATE, N) f32, rng (N,) int32 bits). The kernel is
    persistent, as K4 is: its threads take paths from a work counter and
    bounce them one bounce at a time.

    ``lane_sort``: the lane-sorted variant (K7 inside, ``mk_start_sorted``).
    ``lane_order`` (with ``lane_sort``) appends the permutation of each
    tile's last sort, before lane order is restored: (2, N) int32, the path
    id at each lane and its ``lane_sort_key``. The outputs do not show the
    sort, this does. The occlusion cache and skip-all run where ``ms`` has
    them on (``launch_scene``)."""
    n = px.shape[0]
    if px.device.type == "cuda":
        _check_camera_inputs(ms, px, py, seeds, (n,))
        dev = ms.rows.device
        name, extra = _entry("mk_start", lane_sort, lane_order, n, dev)
        st = torch.empty((N_STATE, n), dtype=torch.float32, device=dev)
        rng = torch.empty(n, dtype=torch.int32, device=dev)
        return _launch(name, ms, [px, py, seeds], [n, cap], [st, rng, *extra],
                       persistent=not lane_sort)
    return megakernel_start_plain(ms, px, py, seeds, cap, lane_sort, lane_order)


def megakernel_start_plain(ms: MegaScene, px, py, seeds, cap: int, lane_sort: bool = False,
                           lane_order: bool = False):
    """The plain twin of K1 (any device)."""
    _check_lane_order(lane_sort, lane_order)
    s = _bounce_loop(ms, _camera_init(ms, px, py, from_bits(seeds)), cap, lane_sort)
    return _with_order(_pack(s), s, lane_order)


def resume_threshold(mode: str, n: int, tail_warps: int) -> int:
    """K2's threshold ``thr`` for ``mode`` (``RESUME_MODES``) on ``n``
    lanes: the tail mode runs where the launch's going paths number at most
    thr, the thread mode above it. "auto": ``tail_warps``, the warps the
    tail mode holds resident on the card (every survivor then has a warp
    at once); "thread": -1; "tail": n."""
    if mode == "auto":
        return tail_warps
    if mode == "thread":
        return -1
    if mode == "tail":
        return n
    raise ValueError(f"mode must be one of {RESUME_MODES}, not {mode!r}")


def resume_mode(count: int, thr: int) -> str:
    """The mode K2 runs with ``count`` going paths and threshold ``thr``."""
    return "tail" if count <= thr else "thread"


_TAIL_WARPS = {}


def format_of(ms: MegaScene) -> str:
    """The key of ``KERNEL_FORMATS`` whose instantiation a launch on
    ``ms`` runs (csrc/megakernel.cu fmt_index)."""
    want = (ms.packed, bool(ms.shadow_tbl) and ms.packed == 0, bool(ms.shadow_cache))
    return next(k for k, v in KERNEL_FORMATS.items() if v == want)


def tail_warps(ms: MegaScene) -> int:
    """The warps K2's tail mode (``mk_resume_tail``, the instantiation of
    ``ms``'s format) holds resident on the card: its resident warps an SM
    times the SMs, asked of the loaded library once per format and device
    (a dictionary lookup after: K2's host time is on the render's path)."""
    from hijiki_tpu_torch.utils.build import load_library

    lib = load_library()
    key = (id(lib), ms.rows.get_device(), ms.packed, bool(ms.shadow_tbl), bool(ms.shadow_cache))
    warps = _TAIL_WARPS.get(key)
    if warps is None:
        occ = occupancy("mk_resume_tail", lib, format_of(ms))
        warps = _TAIL_WARPS[key] = occ["warps_per_sm"] * occ["sms"]
    return warps


def _check_survivors(survivors, dev) -> None:
    """The compaction's count of alive lanes as mk_resume reads it: a
    one-element int64 tensor on ``dev``."""
    if not (torch.is_tensor(survivors) and survivors.dtype == torch.int64
            and survivors.numel() == 1 and survivors.get_device() == dev.index):
        raise ValueError(f"survivors: expected a one-element int64 tensor on {dev}")


# a device's two ints that K2 writes its count and mode's word to where no
# one reads them (RESUME_LOG off): one buffer, written by every such launch
_WORK_WORDS = {}


def resume_survivors(st, cap: int, thr: int):
    """K2's work buffer for the state ``st`` at ``cap`` and threshold
    ``thr``: (2 + min(n, max(thr, 0)),) int32, [0] the count of the lanes
    still going (alive, bounce < cap), [1] 0 (the word of the mode that
    runs, which K2 writes), then the going lanes, as many as the list holds.
    On the card the survivor scan (``mk_resume_scan``) fills it on the
    stream, with no host read, the lanes in no particular order; on the CPU
    its plain version, the lanes ascending."""
    if st.device.type != "cuda":
        return resume_survivors_plain(st, cap, thr)
    from hijiki_tpu_torch.utils.build import load_library

    n = st.shape[1]
    work = torch.empty(2 + min(n, max(thr, 0)), dtype=torch.int32, device=st.device)
    work[:2].zero_()
    if n:
        stream = torch.cuda.current_stream(st.device).cuda_stream
        rc = load_library().mk_resume_scan(st.data_ptr(), n, cap, thr, work.data_ptr(), stream)
        LAUNCHES["mk_resume_scan"] += 1
        if rc != 0:
            raise RuntimeError(f"mk_resume_scan launch failed: CUDA error {rc}")
    return work


def resume_survivors_plain(st, cap: int, thr: int):
    """The plain version of ``resume_survivors`` (any device)."""
    n = st.shape[1]
    list_cap = min(n, max(thr, 0))
    going = (st[0] > 0) & (st[1] < cap)
    work = torch.zeros(2 + list_cap, dtype=torch.int32, device=st.device)
    work[0] = going.sum()
    lanes = torch.nonzero(going).flatten()[:list_cap]
    work[2:2 + lanes.numel()] = lanes.to(torch.int32)
    return work


def megakernel_resume(ms: MegaScene, st, rng, cap: int, lane_sort: bool = False,
                      lane_order: bool = False, mode: str = "auto", survivors=None):
    """Resume launch (K2, replaces ``_megakernel_resume``): continue the
    paths of a packed state up to ``cap`` bounces (``lane_sort``,
    ``lane_order``, ``ms``'s cache: as for ``megakernel_start``,
    ``mk_resume_sorted``; a resumed path's prediction starts at -1).

    On the card the unsorted launch runs in one of two modes, chosen on the
    device from the count of its going paths: one path a thread, or, where
    no more paths go on than the tail mode holds warps resident
    (``tail_warps``), one path a warp (csrc/megakernel.cu, the note at
    K2). Both give the same outputs bit for bit. The count is the survivor
    scan's (``resume_survivors``), or, with ``survivors`` (a one-element
    int64 tensor on the device: the compaction phases' count of alive
    lanes, which they put first), min(survivors, N) with no scan; a count
    that is wrong for the state costs time only. ``mode``
    (``RESUME_MODES``, tests and tools only) forces a mode; the sorted
    launch has one mode and reads no ``survivors``."""
    n = st.shape[1]
    if mode not in RESUME_MODES or (lane_sort and mode != "auto"):
        raise ValueError(f"mode must be one of {RESUME_MODES} (\"auto\" with lane_sort), not {mode!r}")
    if st.device.type == "cuda":
        dev = ms.rows.device
        _check("state", st, torch.float32, (N_STATE, n), dev)
        _check("rng", rng, torch.int32, (n,), dev)
        name, extra = _entry("mk_resume", lane_sort, lane_order, n, dev)
        st_out = torch.empty((N_STATE, n), dtype=torch.float32, device=dev)
        rng_out = torch.empty(n, dtype=torch.int32, device=dev)
        if lane_sort:
            return _launch(name, ms, [st, rng], [n, cap], [st_out, rng_out, *extra])
        thr = resume_threshold(mode, n, tail_warps(ms) if mode == "auto" and n else 0)
        if survivors is None:
            work = resume_survivors(st, cap, thr)
        else:  # the kernel writes the count and the mode's word
            _check_survivors(survivors, dev)
            work = (torch.empty(2, dtype=torch.int32, device=dev) if RESUME_LOG is not None
                    else _WORK_WORDS.get(dev.index))
            if work is None:
                work = _WORK_WORDS[dev.index] = torch.empty(2, dtype=torch.int32, device=dev)
        out = _launch(name, ms, [st, rng], [n, cap], [st_out, rng_out], extra=(work, survivors, thr))
        if n:
            LAUNCHES["mk_resume_tail" + ("_cache" if ms.shadow_cache else "")] += 1
            if RESUME_LOG is not None:
                RESUME_LOG.append((n, cap, thr, work[:2]))
        return out
    return megakernel_resume_plain(ms, st, rng, cap, lane_sort, lane_order)


def megakernel_resume_plain(ms: MegaScene, st, rng, cap: int, lane_sort: bool = False,
                            lane_order: bool = False):
    """The plain twin of K2 (any device)."""
    _check_lane_order(lane_sort, lane_order)
    s = _bounce_loop(ms, _with_pred(ms, _unpack(st, rng)), cap, lane_sort)
    return _with_order(_pack(s), s, lane_order)


def megakernel_start_chained(ms: MegaScene, pxs, pys, seeds, cap: int):
    """Chained camera launch (K4, replaces ``_megakernel_start_chained``):
    each lane traces its pixel's S sweep samples in turn, parking a path
    that is still alive at ``cap`` bounces and flushing one that died.
    pxs/pys (S, N) f32, seeds (S, N) int32 u32 bits. Returns (pool
    (N_STATE, S*N) f32, pool RNG (S*N,) int32 bits, flush buffer
    (CHAIN_OUT_CH, S*N) f32), slot ``samp * N + lane``; a slot's pool
    state is all zero unless its sample parked, its flush column all zero
    unless it finished.

    The kernel is persistent: its threads take slots from a work counter in
    slot order and bounce them one bounce at a time. ``ms``'s cache: as for
    ``megakernel_start`` (a respawned slot's prediction starts at -1)."""
    S, n = pxs.shape
    if pxs.device.type == "cuda":
        _check_camera_inputs(ms, pxs, pys, seeds, (S, n))
        dev = ms.rows.device
        # zeroed: an empty pool slot must read alive = 0, and a parked
        # sample's flush column 0 until its resume commits it (the RNG pool
        # is written for every slot)
        pool = torch.zeros((N_STATE, S * n), dtype=torch.float32, device=dev)
        pool_rng = torch.empty(S * n, dtype=torch.int32, device=dev)
        chain_out = torch.zeros((CHAIN_OUT_CH, S * n), dtype=torch.float32, device=dev)
        return _launch("mk_start_chained", ms, [pxs, pys, seeds], [n, S, cap],
                       [pool, pool_rng, chain_out], persistent=True)
    return megakernel_start_chained_plain(ms, pxs, pys, seeds, cap)


def chained_segs(pool, chain_out, nsamp: int):
    """The bounces each slot's path ran in a chained launch (K4's outputs),
    (nsamp, N): a parked slot's pool ``segs`` or a flushed slot's flush
    ``segs`` (the other is 0)."""
    segs = _STATE_CH.index("segs")  # pool channel 27, flush channel 7
    return (pool[segs] + chain_out[_RESULT_CH.index(segs)]).view(nsamp, -1)


def warp_iterations(segs, warp: int = 32) -> dict:
    """Warp-bounces of a chained launch's slots ``segs`` (nsamp, N; N padded
    with 0 to whole warps of ``warp`` consecutive lanes), the mean over
    warps of what each loop would cost: ``sum_max``, the sum over samples of
    the warp's longest path (a loop of whole samples per thread, whose warp
    waits for its slowest lane each sample); ``max_sum``, the warp's longest
    per-lane sum over samples (a lane respawning alone); ``sum_mean``, the
    sum over samples of the mean path (perfect packing). sum_max >= max_sum
    >= sum_mean."""
    segs = segs.double()
    segs = torch.cat([segs, segs.new_zeros(segs.shape[0], (-segs.shape[1]) % warp)], 1)
    w = segs.view(segs.shape[0], -1, warp)
    return {"sum_max": float(w.amax(2).sum(0).mean()),
            "max_sum": float(w.sum(0).amax(1).mean()),
            "sum_mean": float(w.mean(2).sum(0).mean())}


# mk_occupancy's kernel numbers (csrc/megakernel.cu)
_OCCUPANCY_OF = {"mk_start": 0, "mk_resume": 1, "mk_start_chained": 2, "mk_tiles": 3,
                 "mk_start_sorted": 4, "mk_resume_sorted": 5, "mk_tiles_sorted": 6,
                 "mk_resume_tail": 7}
# each kernel's instantiations, in mk_occupancy's (fmt_index's) order: the
# trace-row format, whether shadow rays walk the dedicated shadow table, and
# whether the occlusion cache runs (kFmt, kSh, kCache)
KERNEL_FORMATS = {"classic": (0, False, False), "slim": (1, False, False),
                  "packed3": (3, False, False), "packed4": (4, False, False),
                  "packed12": (12, False, False), "shadow_tbl": (0, True, False),
                  "classic_cache": (0, False, True), "slim_cache": (1, False, True),
                  "packed3_cache": (3, False, True), "packed4_cache": (4, False, True),
                  "packed12_cache": (12, False, True)}


def occupancy(name: str, lib=None, fmt: str = "classic") -> dict:
    """What the card makes of the megakernel ``name`` (a key of
    ``_OCCUPANCY_OF``: K1, K2, K4, K5, the sorted K1/K2/K5 and K2's tail
    mode) as built for the format ``fmt`` (a key of ``KERNEL_FORMATS``;
    ``lib``: another build's library, or the loaded one; default the
    package's): registers a thread, local-memory bytes a thread (its stack
    frame, spills included), spill-store bytes a thread (ptxas' report of
    the package's build; None for another library), threads a block,
    resident blocks and warps an SM at the kernel's launch (a sorted kernel
    with its dynamic shared memory), and SMs (a persistent kernel, K1, K4
    or K5, launches blocks_per_sm x sms blocks at most)."""
    import ctypes

    from hijiki_tpu_torch.utils.build import build, load_library, spill_stores

    packed, sh, cache = KERNEL_FORMATS[fmt]
    spill = None
    if lib is None:
        report = build()[2]
        spill = (spill_stores(report, f"{name}_kernel",
                              f"ILi{packed}ELb{int(sh)}ELb{int(cache)}E")
                 if report else None)
    out = (ctypes.c_int * 5)()
    lib = lib if lib is not None else load_library()
    which = _OCCUPANCY_OF[name] + 8 * list(KERNEL_FORMATS).index(fmt)
    rc = lib.mk_occupancy(which, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"mk_occupancy({name}, {fmt}) failed: CUDA error {rc}")
    regs, per_sm, threads, sms, local = out
    return {"registers": regs, "local_bytes": local, "spill_bytes": spill, "threads": threads,
            "warps_per_sm": per_sm * threads // 32, "blocks_per_sm": per_sm, "sms": sms}


def megakernel_tiles(ms: MegaScene, px, py, seeds, cap: int, lane_sort: bool = False,
                     lane_order: bool = False):
    """Single-launch render (K5, replaces ``_megakernel``/
    ``_megakernel_body``): raygen and bounces up to ``cap``, keeping only
    the result (``lane_sort``, ``lane_order``, ``ms``'s cache: as for
    ``megakernel_start``, ``mk_tiles_sorted``). Returns (out (7, N) f32:
    Lr,Lg,Lb, n1,n2,n3, depth; rng (N,) int32 bits). The kernel is
    persistent, as K1 is: its threads take paths from a work counter and
    bounce them one bounce at a time."""
    n = px.shape[0]
    if px.device.type == "cuda":
        _check_camera_inputs(ms, px, py, seeds, (n,))
        dev = ms.rows.device
        name, extra = _entry("mk_tiles", lane_sort, lane_order, n, dev)
        out = torch.empty((len(_TILE_CH), n), dtype=torch.float32, device=dev)
        rng = torch.empty(n, dtype=torch.int32, device=dev)
        return _launch(name, ms, [px, py, seeds], [n, cap], [out, rng, *extra],
                       persistent=not lane_sort)
    return megakernel_tiles_plain(ms, px, py, seeds, cap, lane_sort, lane_order)


def megakernel_tiles_plain(ms: MegaScene, px, py, seeds, cap: int, lane_sort: bool = False,
                           lane_order: bool = False):
    """The plain twin of K5 (any device)."""
    st, rng, *order = megakernel_start_plain(ms, px, py, seeds, cap, lane_sort, lane_order)
    return (st[list(_TILE_CH)], rng, *order)


# ----------------------------------------------------------------------------
# drivers
# ----------------------------------------------------------------------------


def render_tiles(scene, px, py, seeds, *, width: int = None, height: int = None,
                 max_bounces: int = 1000, lane_sort: bool = False, interpret: bool = False,
                 packet: int = PACKET, prefetch: bool = True, spec: bool = True,
                 spec_resolve: bool = False, shadow_cache: bool = False,
                 shadow_vis: bool = True, table_in_hbm: bool = False, groups: int = 1,
                 group_octant: bool = True, trunk_rows: int = 0, hbm_window: int = 1,
                 shadow_tbl: bool = False):
    """Whole paths in one launch to ``max_bounces`` (``render_tiles``).
    ``scene``: a ``MegaScene``, or a ``CompiledScene`` with ``width`` and
    ``height`` (JAX's form; ``scene_of`` bakes it once). The inputs' device
    decides where it runs. ``lane_sort``: sort each tile's paths between
    bounces (any N: the kernel and the plain version pad the last tile with
    dead paths). ``shadow_vis``, ``shadow_tbl``, ``shadow_cache``: as JAX's
    (``launch_scene``); the TPU walker's kwargs as ``_check_walker`` says.
    Returns (total (N,3), normal (N,3), depth (N,), state (N,))."""
    ms = scene_of(scene, width, height, px.device)
    _check_walker(lane_sort, packet, shadow_tbl, ms, table_in_hbm, shadow_cache)
    ms = launch_scene(ms, shadow_vis, shadow_tbl, shadow_cache)
    out, rng = megakernel_tiles(ms, px, py, _seed_bits(seeds), max_bounces, lane_sort)
    return out[0:3].T, out[3:6].T, out[6], rng


def _phase_caps(max_bounces, phase_bounces, phase_shrink):
    """``render_waves``' cap normalization: clamp, pair each cap with its
    shrink, drop resume phases that cannot trace further."""
    caps = [min(c, max_bounces) for c in list(phase_bounces) + [max_bounces]]
    shrinks = list(phase_shrink) + [4] * (len(caps) - 1 - len(phase_shrink))
    inc = []
    for c, s in zip(caps[1:], shrinks):
        if c > caps[0] and (not inc or c > inc[-1][0]):
            inc.append((c, s))
    return [caps[0]] + [c for c, _ in inc], [s for _, s in inc]


def _chain_caps(max_bounces, cap0, phase_bounces, phase_shrink):
    """``render_waves_chained``' cap normalization (pallas_megakernel.py:
    3534-3546): clamp FIRST, pair each cap with ITS shrink, then keep only
    caps above the in-kernel cap ``cap0`` that increase. Unlike
    ``_phase_caps`` every entry, the last (``max_bounces``) included, is a
    resume cap; none left means the parked paths are already final."""
    raw = [min(c, max_bounces) for c in phase_bounces] + [max_bounces]
    shr = list(phase_shrink) + [4] * (len(raw) - len(phase_shrink))
    kept = []
    for c, s in zip(raw, shr):
        if c > cap0 and (not kept or c > kept[-1][0]):
            kept.append((c, s))
    return [c for c, _ in kept], [s for _, s in kept]


def _commit(res, res_state, orig, out, rngf):
    """Scatter finished results ``out`` (the ``_RESULT_CH`` channels) and
    RNG states to their slots. ``res``/``res_state`` carry one trash column
    past the slots: JAX's ``res.at[:, orig].set`` drops updates whose
    ``orig`` is out of bounds (empty pool slots point there), where torch's
    ``index_put`` raises on the CPU and device-asserts on CUDA, so such
    updates land in the trash column instead."""
    res[:, orig] = out
    res_state[orig] = rngf


def _with_trash_column(res, res_state):
    return (torch.cat([res, res.new_zeros((res.shape[0], 1))], 1),
            torch.cat([res_state, res_state.new_zeros(1)]))


def _run_compaction_phases(ms, caps, shrinks, flat, rngf, orig, res, res_state,
                           lane_sort=False):
    """The survivor phases: compact + coherence-sort the alive lanes, resume
    at each cap (lane-sorted resumes with ``lane_sort``), scatter the
    results into ``res``/``res_state`` at ``orig`` (``_commit``: both carry
    a trash column at index ``n``, where ``orig`` points for slots that must
    not commit). Shared by render_waves (orig = lane) and
    render_waves_chained (orig = samp * N + lane). Returns (res, res_state,
    overflow tensor)."""
    dev = flat.device
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    n_lanes = flat.shape[1]
    root_min = ms.root_min
    root_span = torch.clamp_min(ms.root_max - root_min, 1e-6)
    for pi, cap in enumerate(caps):
        n_next = max(TILE, -(-(n_lanes // shrinks[pi]) // TILE) * TILE)
        alive = flat[0] > 0
        alive_i = alive.long()
        n_alive = alive_i.sum()
        overflow = overflow + torch.clamp_min(n_alive - n_next, 0)
        if n_lanes > 65536:
            # stable partition: survivors keep their order
            rank_alive = torch.cumsum(alive_i, 0) - 1
            rank_dead = torch.cumsum(1 - alive_i, 0) - 1 + n_alive
            pos = torch.where(alive, rank_alive, rank_dead)
            inv = torch.empty_like(pos).scatter_(0, pos, torch.arange(n_lanes, device=dev))
            order = inv[:n_next]
        else:
            # small survivor sets: full coherence sort (origin cell + octant)
            q = [
                torch.clamp(((flat[2 + a] - root_min[a]) / root_span[a] * 8).to(torch.int32), 0, 7)
                for a in range(3)
            ]
            octant = (flat[5] > 0).int() + 2 * (flat[6] > 0).int() + 4 * (flat[7] > 0).int()
            key = torch.where(alive, octant + 8 * (q[0] + 8 * (q[1] + 8 * q[2])), 1 << 20)
            order = torch.argsort(key, stable=True)[:n_next]
        flat, rngf, orig = flat[:, order].contiguous(), rngf[order].contiguous(), orig[order]
        # the alive lanes come first: K2 counts min(n_alive, n_next) going
        # paths there (no survivor scan, no host read)
        flat, rngf = megakernel_resume(ms, flat, rngf, cap, lane_sort=lane_sort, survivors=n_alive)
        _commit(res, res_state, orig, flat.index_select(0, ms.result_ch), rngf)
        n_lanes = n_next
    return res, res_state, overflow


def render_waves(
    scene,
    px,
    py,
    seeds,
    *,
    width: int = None,
    height: int = None,
    max_bounces: int = 1000,
    phase_bounces: tuple = (5, 12, 48),
    phase_shrink: tuple = (2, 4, 4),
    lane_sort: bool = False,
    interpret: bool = False,
    packet: int = PACKET,
    prefetch: bool = True,
    spec: bool = True,
    spec_resolve: bool = False,
    shadow_cache: bool = False,
    shadow_vis: bool = True,
    shadow_skip_all: bool = False,
    table_in_hbm: bool = False,
    groups: int = 1,
    group_octant: bool = True,
    trunk_rows: int = 0,
    hbm_window: int = 1,
    shadow_tbl: bool = False,
):
    """Phased wavefront render (``render_waves``) of a ``MegaScene``, or of
    a ``CompiledScene`` with ``width`` and ``height`` (JAX's form, baked
    once by ``scene_of``; the TPU walker's kwargs as ``_check_walker``
    says), on the inputs' device: a camera launch to
    ``phase_bounces[0]``, then compaction phases that resume the survivors
    at the later caps, the last one to ``max_bounces``. Survivor capacity
    after phase k is N / phase_shrink[k]; paths beyond it are dropped and
    counted in ``overflow`` (the renderer re-renders such sweeps).
    ``lane_sort``: every launch sorts its tiles' paths between bounces
    (K7); the outputs are the same bit for bit. ``shadow_vis``,
    ``shadow_tbl``, ``shadow_cache``: as JAX's (``launch_scene``).
    ``shadow_skip_all``: JAX's performance probe only, biased image: every
    shadow walk is skipped with visibility 1 (not with ``shadow_cache``).

    Returns (total (N,3), normal (N,3), depth (N,), state (N,), overflow (),
    segs (N,), rows (N,), albedo (N,3)).
    """
    ms = scene_of(scene, width, height, px.device)
    _check_walker(lane_sort, packet, shadow_tbl, ms, table_in_hbm, shadow_cache)
    ms = launch_scene(ms, shadow_vis, shadow_tbl, shadow_cache, shadow_skip_all)
    seeds = _seed_bits(seeds)
    n_req = px.shape[0]
    pad = (-n_req) % TILE
    if pad:
        # dummy rays (duplicates of ray 0), dropped from the results
        px = torch.cat([px, px[:1].expand(pad)])
        py = torch.cat([py, py[:1].expand(pad)])
        seeds = torch.cat([seeds, torch.zeros(pad, dtype=seeds.dtype, device=seeds.device)])
    n = px.shape[0]
    caps, shrinks = _phase_caps(max_bounces, phase_bounces, phase_shrink)
    flat, rngf = megakernel_start(ms, px.contiguous(), py.contiguous(), seeds.contiguous(), caps[0],
                                  lane_sort=lane_sort)
    res, res_state = _with_trash_column(flat.index_select(0, ms.result_ch), rngf)
    orig = torch.arange(n, device=px.device)
    res, res_state, overflow = _run_compaction_phases(
        ms, caps[1:], shrinks, flat, rngf, orig, res, res_state, lane_sort
    )
    res = res[:, :n_req]
    return (
        res[0:3].T, res[3:6].T, res[6], res_state[:n_req], overflow,
        res[7], res[8], res[9:12].T,
    )


def render_waves_chained(
    scene,
    pxs,
    pys,
    seeds,
    *,
    width: int = None,
    height: int = None,
    max_bounces: int = 1000,
    chain_cap: int = 8,
    phase_bounces: tuple = (48,),
    phase_shrink: tuple = (4,),
    interpret: bool = False,
    packet: int = PACKET,
    prefetch: bool = True,
    spec: bool = True,
    spec_resolve: bool = False,
    shadow_cache: bool = False,
    shadow_vis: bool = True,
    table_in_hbm: bool = False,
    groups: int = 1,
    group_octant: bool = True,
    trunk_rows: int = 0,
    hbm_window: int = 1,
    shadow_tbl: bool = False,
):
    """Chained phased render (``render_waves_chained``) of a ``MegaScene``,
    or of a ``CompiledScene`` with ``width`` and ``height`` (JAX's form, as
    ``render_waves``), on the inputs' device: S sweep samples per
    pixel in ONE chained camera launch (K4) that respawns a dead path's lane
    on the pixel's next sample and parks paths still alive at
    ``min(chain_cap, max_bounces)`` bounces in an (N_STATE, S*N) pool; the
    compaction phases then resume the parked paths (unchained K2) at the
    ``phase_bounces`` caps and ``max_bounces``. pxs/pys (S, N) f32, seeds
    (S, N) int32 u32 bits.

    Per sample exactly what S separate ``render_waves`` sweeps compute (each
    thread walks alone), as long as nothing overflows. ``shadow_vis``,
    ``shadow_tbl``, ``shadow_cache``: as JAX's (``launch_scene``).

    Returns per-sweep images: total (S,N,3), normal (S,N,3), depth (S,N),
    state (S,N) (the sample's final RNG), overflow (), segs (S,N), rows (N,)
    (summed over the S samples), albedo (S,N,3).
    """
    ms = scene_of(scene, width, height, pxs.device)
    _check_walker(False, packet, shadow_tbl, ms, table_in_hbm, shadow_cache)
    ms = launch_scene(ms, shadow_vis, shadow_tbl, shadow_cache)
    seeds = _seed_bits(seeds)
    S, n_req = pxs.shape
    if S < 2:
        raise ValueError("render_waves_chained needs >= 2 sweeps; use render_waves")
    pad = (-n_req) % TILE
    if pad:
        # dummy lanes: copies of each sweep's first column, dropped below
        padf = lambda a: torch.cat([a, a[:, :1].expand(S, pad)], 1)
        pxs, pys, seeds = padf(pxs), padf(pys), padf(seeds)
    n = pxs.shape[1]
    cap0 = min(chain_cap, max_bounces)
    flat, rngf, chain_out = megakernel_start_chained(
        ms, pxs.contiguous(), pys.contiguous(), seeds.contiguous(), cap0
    )
    res, res_state = _with_trash_column(chain_out, rngf)
    # only parked paths commit; an empty pool slot (its sample finished in
    # the chained launch and was flushed) points at the trash column
    orig = torch.where(
        flat[0] > 0, torch.arange(S * n, device=flat.device), S * n
    )
    caps, shrinks = _chain_caps(max_bounces, cap0, phase_bounces, phase_shrink)
    if caps:
        res, res_state, overflow = _run_compaction_phases(
            ms, caps, shrinks, flat, rngf, orig, res, res_state
        )
    else:
        # max_bounces <= chain_cap: every parked path has traced its whole
        # budget, so its pool state is final; commit it directly (a resume
        # phase would only add a capacity cut that could drop samples)
        _commit(res, res_state, orig, flat.index_select(0, ms.result_ch), rngf)
        overflow = torch.zeros((), dtype=torch.int64, device=flat.device)

    def per_sweep(ch):
        return res[ch, : S * n].reshape(S, n)[:, :n_req]

    total = torch.stack([per_sweep(0), per_sweep(1), per_sweep(2)], -1)
    normal = torch.stack([per_sweep(3), per_sweep(4), per_sweep(5)], -1)
    albedo = torch.stack([per_sweep(9), per_sweep(10), per_sweep(11)], -1)
    state = res_state[: S * n].reshape(S, n)[:, :n_req]
    return (total, normal, per_sweep(6), state, overflow, per_sweep(7),
            per_sweep(8).sum(0), albedo)


# ----------------------------------------------------------------------------
# state carried across from the TPU kernel's layout
# ----------------------------------------------------------------------------


def state_from_reference(st, rng, device="cpu"):
    """The JAX kernel's (T, N_STATE, 8, P) f32 state and (T, 1, 8, P) u32
    RNG -> the port's (N_STATE, N) f32 and (N,) int32 bits (lane order
    kept)."""
    st = np.array(st, np.float32)
    n = st.shape[0] * st.shape[2] * st.shape[3]
    flat = np.moveaxis(st, 1, 0).reshape(N_STATE, n)
    r = np.array(rng, np.uint32).reshape(n).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(flat)).to(device), torch.from_numpy(r).to(device)


def state_to_reference(st, rng, packet: int = 128):
    """Inverse of ``state_from_reference`` (numpy arrays, 8 x ``packet``
    lane tiles)."""
    st = st.detach().cpu().numpy().astype(np.float32)
    n = st.shape[1]
    t = n // (8 * packet)
    out = np.moveaxis(st.reshape(N_STATE, t, 8, packet), 0, 1)
    r = rng.detach().cpu().numpy().view(np.uint32).reshape(t, 1, 8, packet)
    return np.ascontiguousarray(out), r
