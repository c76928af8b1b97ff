"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases, each printing as it goes and the seconds the one before took (all
of them once more before the kernel report); any failure exits non-zero:

1. device: a CUDA card must be present (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles hijiki_tpu_torch/csrc/*.cu with nvcc, one process per
   source (seconds printed);
3. K3, the reconstruction kernel, against its plain twin on the card at
   1024x1024 and at 1024 x 1000 (a width that is no multiple of the block),
   numpy-seeded inputs with NaN pixels: rtol 1e-5, atol 1e-6 (expf ULPs);
3b. the native loaders: meshbox.obj and meshbox_small.obj through the
   native OBJ parser (backend="native": a failed g++ build fails the run)
   held array for array to the Python parser, and meshbox + spheres
   compiled with the native BVH builder held to the numpy builder's
   compile, every array equal (so again for (p)'s 100,384-triangle
   compile); the seconds of each load, compile and its BVH builds;
4. quick gates on the full meshbox + spheres at 64x64, max_bounces 24,
   each kernel against its twin on the card with the final RNG state
   bit-equal on >= 99.5% of paths and radiance within rtol/atol 2e-3 on
   those: K1 (cap 5), K2 (resume to 24), K5 (single launch), K4 (S = 3
   chained samples, chain cap 8); K5 equal to K1 at cap max_bounces on
   every channel; render_waves equal to render_tiles on every RNG state;
   render_waves_chained bit-equal per sweep to 3 separate render_waves;
   K6 (the trace-row walk), closest and any hit, bit-equal to its twin on
   every output of 64x64 camera rays and 64x64 random rays (inactive
   lanes, finite and infinite tmax), and its strict and inclusive any-hit
   modes bit-equal to the twin with tmax at each ray's closest-hit t, where
   some ray must tell the two modes apart; K8 (sort_tiles, the block sort alone)
   bit-equal to its plain version on 1,024 tiles of numpy-seeded keys
   (random, heavy ties with dead keys, all equal, sorted, reversed) and 31
   channels; the lane-sorted K1/K2/K5 (K7 inside) against their plain
   versions with the bounds above, and bit-equal to the unsorted kernels on
   every output channel (NaN included) and RNG state; since the outputs
   cannot show the sort, each also returns its order record (the path id
   at each lane after its tile's last sort, and that path's key), which
   must equal the sorted plain version's bit for bit, move some path off
   its lane and hold lane_sort_key of each path's written state
   (order_mismatch); once more on a K2 input whose lanes alive at the cap
   have NaN, +-inf, +-1e30, box-bound and outside origins;
4b. the trace-row formats: K1 (cap 5), K2 (resume to 8), K5 (to 8) and
   K4 (2 samples, chain cap 8) bit-equal to their twins on meshbox_small +
   spheres compiled with packed_leaf 1 (SLIM), 3, 4 and 12 (octant tables)
   at 128x128, and on the meshbox with the dedicated shadow table and
   without the shadow-visibility boxes at 64x64 (phase 4 ran them with the
   boxes, JAX's default compile); the sorted K1/K2/K5 bit-equal to the
   unsorted kernels on each; K1 with the boxes and with the shadow table
   bit-equal to K1 without the boxes but for fewer rows visited;
4c. the shadow-ray occlusion cache on classic rows (boxes on, 64x64, and
   off), SLIM, PACKED3, PACKED4 and PACKED12 (128x128): K1 (cap 5), K2
   (to 8), K5 (to 8) and K4 (2 samples, cap 8) with the cache on
   (mk.launch_scene(shadow_cache=True)) bit-equal to their cache-on twins
   on every output, rows included, and to the cache-off kernels on every
   output but rows; the twins count the predictions they tested and those
   that verified (answered without a walk): a configuration on which none
   verified fails; the sorted K1/K2/K5 with the
   cache bit-equal to the unsorted ones, their order records the cache-off
   kernels' (the cache moves no key); shadow_tbl and shadow_skip_all each
   with shadow_cache raise;
   render_waves(shadow_skip_all=True)'s K1/K2 calls bit-equal to their
   twins, whose shadow walks visit no row; phases 4-4c launch the kernels
   here and hand every plain version to the twin workers (gate_twin, held
   as phase 6 holds its calls: the bounds above and bit for bit, order
   records included), collected once paths (n) and (r), which are not
   timed, have run beside them, before the first timed path;
5. the paths, each driven with the launch counts set to 0 just before and
   read just after, each with a finite film, mean > 0, overflow 0 and
   every kernel of the path launched, in the order (n), (r), then (a) to
   (f), (g), (j), (s), and the sorted (g), (m) and (h) while phase 6's
   twins run:
   (a) the chained slice: Renderer(device="cuda") at 1024x1024, 8 spp,
       max_bounces 1000, chaining on auto (8 sweeps per launch: K4, K2,
       and one K3 launch a chunk), EXR written and read back, peak device
       memory;
   (b) the unchained slice (chain_sweeps=1: K1, K2, K3), its film equal
       to (a)'s within rtol 1e-5 / atol 1e-6 (the order of the film adds);
   (i) the lane-sorted slice: Renderer(sort_lanes=True) at 1024x1024, 8
       spp (chaining off by rule: the sorted K1 and K2, K3), its film
       bit-equal to (b)'s;
   (a0) (a) without the shadow-visibility boxes (the configuration before them)
       and (o) (a) with the dedicated shadow table (mega_shadow=1): each
       film bit-equal to (a)'s;
   (p) the 2-level 4-to-1 split of meshbox + spheres (100,384 triangles,
       scene/bigscene.py), compiled by auto (PACKED4) and as classic rows
       at leaf 4 (the same tree), compile seconds and table bytes printed,
       and compiled by auto with the numpy BVH builder: every array equal;
       the two films bit-equal; then 3 fresh renders each of (a), (a0),
       (o) and the two (p) in turns: warm Mrays/s, medians, rows visited;
   (c) the overflow retry at 256x256, 8 spp, chain cap 2, phase_shrink
       (9999,): paths drop and are re-rendered; the film bit-equal to the
       same render at phase_shrink (1,)*8;
   (d) checkpoint and resume at 256x256: saved at sweep 4 of 8 from the
       progress callback, resumed in a new Renderer: film bit-equal to the
       uninterrupted render;
   (e) the single-launch render_tiles (K5) over the 1024x1024 frame, then
       lane-sorted (the sorted K5), bit-equal to it;
   (q) the occlusion cache: render_waves_chained(shadow_cache=True) over
       one chunk of 8 1024x1024 sweeps, max_bounces 1000 (K4 and K2 with
       the cache), and render_waves / render_tiles with it over (e)'s frame
       (K1, K5): every output but rows bit-equal to the calls without the
       cache (render_tiles: to (e)), rows beside rows; then warm Mrays/s of
       the chunk, 3 calls with and 3 without the cache in turns, medians;
   (f) the sync slice: Renderer(driver="sync", use_bvh=True) at 1024x1024,
       8 spp, max_bounces 1000 (K6 for every closest and shadow walk, K3;
       no megakernel), EXR round trip, peak device memory; then one
       1024x1024 sweep through the sync integrator (K6) and through the
       mega driver's render_waves on the same seeds and jitter: final RNG
       state bit-equal and radiance within 2e-3 on >= 99.5% of paths, and
       (f)'s film mean within 1e-3 relative of (a)'s;
   (g) the wavefront slice at 1024x1024, 2^18 lanes, the first
       WAVEFRONT_SWEEPS sweeps: its film against (f)'s film after the same
       sweeps within rtol 1e-4 / atol 2e-4 (JAX's bound); a sort_lanes
       variant at 256x256 against the sync driver there;
   (h) fixed albedo (sync, 256x256); the packet traversal's film equal to
       rows' bit for bit (256x256); bvh and brute at 64x64 on
       meshbox_small against rows (RNG bit-equal on >= 99.5% of paths); the
       CLI at 64x64 on the card with every walker knob (--mega-packet,
       --mega-groups, --spec-resolve, --mega-trunk, --mega-window) and
       --profile-dir: its EXR bit-equal to the default command's, and the
       torch.profiler trace written;
   (j) K8 alone: sort_tiles on 1,024 tiles (1M lanes) x 31 channels;
   (l) multi-device, the mega driver: MegaMultiChipRenderer over
       [cuda:0, cuda:0] (two row bands of 512 rows, each on its own stream)
       at (a)'s configuration, chained (K4, K2 and the weighted K3 a band,
       no unweighted K3), its film against (a)'s at rtol 1e-4 / atol 1e-5
       with the largest error, the pixels that differ and how many of them
       lie within R rows of the seam; then 3 fresh renders each of (a) and
       (l) in turns, their warm Mrays/s and medians;
   (m) multi-device, the sync driver: MultiChipRenderer over the same two
       entries at 1024x1024, 1 spp (K6 and the weighted K3, no megakernel),
       against (f)'s film after its first sweep at rtol 5e-4 / atol 5e-5;
   (n) multi-host: MultiHostMegaRenderer in two processes sharing the card,
       joined over gloo through a file:// store, 256x256, 4 spp, each its
       stride of the sweeps on one band; both ranks' merged films bit-equal
       and held to the single 256x256 film at rtol 1e-4 / atol 1e-5; the
       launches are the two processes' own, reported by them;
   (r) the oracle gate at equal seeds: meshbox + spheres (JAX's default
       compile), 64x64, the 64 sweeps of BlockScheduler(64, 64, 64, seed
       0) as tools/oracle_mse.py draws them, max_bounces 1000, through the
       native scalar oracle (ops/oracle_native.py: every primitive by brute
       force, one sweep a job in the twin workers, the films summed in
       sweep order) and on the card through render_waves_chained (K4 +
       K2, 8 sweeps a call), render_waves (K1 + K2, every sweep's paths in
       one call) and the sync integrator with the rows traversal (K6; and
       once more from the megakernel's camera, the oracle's, in place of
       camera_rays'), each driver's per-lane radiance before any
       reconstruction: for the pairs oracle-chained, oracle-unchained,
       oracle-sync, chained-sync and oracle-sync_mega_camera the
       raw MSE, the divergent pixels (per-pixel MSE > 1e-6) and the trimmed
       MSE without them (tools/oracle_mse.py's readings); oracle-chained or
       oracle-sync at raw MSE >= 1e-4 (BASELINE.json), more than 1% of the
       pixels divergent or a trimmed MSE > 1e-8 fails the run;
   (s) the JAX package's call forms at 64x64: render_waves_chained and
       render_waves (3 sweeps, three times in turns) on a scene_to_device
       scene with non-default walker kwargs (packet 1024, groups 4,
       table_in_hbm, hbm_window 4, trunk_rows 64, spec_resolve, no
       prefetch) bit-equal to the MegaScene form, one bake over all the
       calls (mk.BAKES), the JAX form's host milliseconds beside the
       MegaScene form's; reconstruct_pallas bit-equal to reconstruct (K3);
       sort_tile_by_key (K8 on one (8,128) tile, an int32 and an f32
       channel) bit-equal to the plain network; make_sharded_mega_sweep
       over [cuda:0, cuda:0] (64x128, 2 chained sweeps) bit-equal to the
       two-band renderer's chunk;
6. the kernels at the main path's shapes: one chained chunk (8 x 1M slots)
   and one unchained sweep again, recording the inputs of every K4, K1 and
   K2 call (K4 to cap 8; its parked paths resumed at capacity 2M to cap 48,
   then to 1000; K1 to cap 5 and K2 to caps 12, 48, 1000), and so (p)'s
   chunk on its 100,384-triangle PACKED4 table and (q)'s chunk and the
   sweep with the occlusion cache; every recorded call, K5 on the
   unchained sweep's 1M-path frame to 1000 (with the cache too), and the
   sweep's K1/K2 calls and K5 through the sorted kernels with their order
   records, through its plain version, held to the phase-4 bounds and
   bit-equal on every output (rows included; the order records bit-equal
   to the sorted plain versions'): the plain versions run in TWIN_WORKERS
   processes at once, each a Python loop of small launches that leaves
   the card mostly idle alone (while this process runs the sorted (g),
   (m) and (h)); then each call timed through the kernel;
   the registers, local
   (spill) bytes, resident warps an SM and launch blocks of K4, K1 and K5
   (persistent), K2 and the sorted K1/K2/K5 (mk_occupancy),
   and the warp-iteration ratios of the chunk's K4 (mk.warp_iterations of
   its segs); K5 timed beside
   its tail floor (K5 on the frame's 32 paths of the most bounces, one
   warp: the longest chain, which no schedule shortens), K3 on a sweep
   to its bound, and on the chained chunk's 8 sweeps in one launch as path
   (a) runs it: to its bound against the plain version, bit-equal to its 8
   one-sweep launches summed in sweep order, timed; K3's weighted mode on
   a band's chunk as (l) launches it (8 x 768 x 1024: 512 rows between
   128 rows of padding at weight 0) to K3's bound against its plain
   version, bit-equal to its one-sweep launches summed, at weight 1
   bit-equal to the unweighted kernel, timed beside the unweighted chunk;
   K6's calls of one 1024x1024 sync sweep (K6_CALLS): the first bounce's
   closest walk (1M rays), its shadow any-hit walk and the closest walks of
   bounces 9, 30 and 200, each replayed through the kernel and the twin,
   bit-equal, and timed
   (plus K6's device time over the calls of that sweep's first
   K6_PROFILE_BOUNCES bounces, from torch.profiler, beside their summed
   bound from their walking rays and rows visited, summed on the device,
   and a check that three bounces
   of the sync integrator make no device sync under
   torch.cuda.set_sync_debug_mode("error"));
   every K1 and K2 call of the unchained sweep and K5 on the frame timed
   through the sorted kernel too (bit-equal to the unsorted kernel, timed
   beside it; held to their sorted plain versions above); K8 at 1M lanes x
   31 channels,
   bit-equal to
   its plain version, timed beside torch.sort(stable=True) + gather; each
   trace-row format (classic with and without the boxes and with the
   shadow table, 1, 3, 4, 12) on the meshbox: its chained chunk and
   unchained sweep recorded and replayed through K4, K1 and K2, and K5
   over the frame, timed with rows visited and bound, each call's rows
   split by kind by its plain version on the host on every 251st lane (in
   the twin workers); (p)'s chained chunk
   (8 x 1M slots) timed; the chained chunk's and the unchained sweep's
   recorded calls, and K5 over the frame, through the cache-on kernels
   beside the cache-off ones (in turns), every output but rows bit-equal,
   with ms, rows and bound; the sweep's K1/K2 calls with skip-all beside
   them: the shadow walk's share of their time and rows; (q)'s own
   cache-on calls timed;
7. probes: K9/K10/K11 vs plain, then timed (hijiki_tpu_torch/probes/): each
   of walk_ablate (K10a), walk_isolate (K10b, on the classic rows, their
   16-column copy and the SLIM, PACKED3, PACKED4, PACKED12 tables), latency_chain and
   staged_chase (K11a), alu_issue, dtype_elementwise (f32, bf16, bf16x2)
   and dtype_slab (f32, bf16; rows 8 and 1024) (K11b) bit-equal to its plain
   version at 4096 threads (every mode and variant) and at 1M threads with
   a short trip count (timed there beside the plain version); K9
   (reconstruct_old) against its plain version at 1024x1024 and 1000x1024,
   block 128, with NaN pixels, to K3's bound (rtol 1e-5, atol 1e-6), and
   against K3 (the differing pixels counted); then (k) a short run of each
   probe's main() (the walker probes at one warp per SM and at 1M threads,
   slope timings; ab_reconstruct's A/B and in-stream modes; the issue and
   dtype probes; walk_probe's main on the unpacked and packed tables and
   its widths mode), launches counted as a path's.

The line before the last is the kernel report {"kernels": [...]}, whose
errors and times come from phase 6 (K3's: the chained chunk's launch;
its error also from phase 3) and
whose launch counts come from phase 5 (K4, K2, K3 from path (a), K1 from
(b), K5 and the sorted K5 from (e), K6 from (f), the sorted K1+K2 from (i),
K8 from (j), K3's weighted mode from (l), the cache-on K1, K2, K4, K5
(``name+cache``: every number from (q)'s own calls at the main path's
shapes) from (q), the probes
from (k), K10b on each packed table as ``walk_isolate_<table>``); K1, K2, K4
and K5 also name the formats they were held on (``formats``) and their
time and bound per format (``ms_by_format``); each entry
has its bound (bound_ms: the
larger of the bytes this run's data needs at 3.35 TB/s and its f32
operations at 67 TFLOP/s, counted from this run's row-visit counters, each
row at its kind's operations as the call's plain version splits its rows
(ROW_OPS an interior row, PRIM_ROW_OPS a prim row of its format, none the
winner's row read to shade; the split from the full-size plain versions
of phase 6, and per format from every 251st lane); a K2 resume counts every lane's alive flag and the state
of its live lanes only, a K6 walk the o and d of the rays that walk and
the six outputs of the TPU kernel's contract; a sorted kernel the work of
its unsorted twin, the sort touching no device memory; K8 its key and
channels read and written once) and library_ms null (no PyTorch call
computes a BVH walk, a path trace or the feature-weighted bilateral
stencil), except K8's: torch.sort(stable=True) + gather, which orders ties
otherwise; a probe's bound is its inputs and outputs once against its
counted f32 operations (PROBE_OPS; K10b's visited rows at their kinds'
operations, as its plain version splits them), and its library_ms null (no
PyTorch call runs a dependent chain of loads or a fixed-trip walk). Each
entry also has bound_unfused_ms: the same bound with the operations at the
unfused f32 issue rate that K11b measured under --fmad=false (33.5 T ops/s).
Phase 7 reads the SASS of every packed walk of K10b, K1 and K4
(walk_probe.check_packed_loads): its 128-bit and narrower loads, and no
local memory in its walk loops. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SCENE = os.path.join(HERE, "scenes", "meshbox", "meshbox.obj")
SCENE_SMALL = os.path.join(HERE, "scenes", "meshbox", "meshbox_small.obj")
# sweeps of the wavefront slice (g), compared with the sync film after as many
# (2: its film is the sync film's bit for bit after any number of sweeps, and
# each sweep costs ~5 s of the smoke's time)
WAVEFRONT_SWEEPS = 2

# roofline of one H100 SXM (published peaks): HBM bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the f32 issue rate of unfused operations (the kernels build with
# --fmad=false, so a multiply and an add issue apart): K11b's alu_issue
# measured it on the H100 (PERF.md); each bound is also given at it
F32_UNFUSED_OPS_PER_S = 33.5e12
# f32 operations counted per trace row a walk visits: the interior row's
# slab test (12 mul/add, 10 min/max, 1 add, 3 compares), the cheapest row
ROW_OPS = 26
# a prim row's f32 operations by its table's format (0 classic, 1 SLIM, 3
# PACKED3, 4 PACKED4, 12 PACKED12): 41 a triangle test (3 sub, 9 for the
# cross product, 6 for the denominator and its reciprocal, 6 each for u, v
# and t, 7 compares and u + v), 9 more where the row recomputes the plane
# normal (SLIM, PACKED3, PACKED12), times the prims a row. The megakernels'
# bounds charge a visited row at its kind's ops, split as their plain
# versions' walks split (mk.row_kinds); a winner's row read to shade it
# ("resolve") and shading are not counted, so the bound stays a lower one
PRIM_ROW_OPS = {0: 41, 1: 50, 3: 150, 4: 164, 12: 600}
# f32 operations per pixel and tap of the R = 2 reconstruction (feature
# distance, weight, NaN test, 4 accumulations)
TAP_OPS = 25
# f32 operations a thread-step of each probe: walk_ablate's full body (the
# slab test's ROW_OPS, the triangle test's 41: 3 sub, 9 for the cross
# product, 6 for the denominator and its reciprocal, 6 each for u, v and t,
# 7 compares and the sum u + v; the counter's add), latency_chain's fetch
# (one add) and chain (6 mul, 10 min/max, a compare, an add), and
# staged_chase's add a cursor and step (8 a warp-step, counted a thread as
# 8/32); walk_isolate charges a visited row at its kind's ops (row_ops), as
# the megakernels' bounds do
PROBE_OPS = {"walk_ablate": ROW_OPS + 41 + 1, "fetch": 1, "chain": 18, "staged": 8 / 32}
# K9's f32 operations a pixel and tap: K3's TAP_OPS and the spatial weight
# it recomputes (the offsets 4, their squares and sum 3, the scale 1, the
# exp 1, the offset 1; an exp counted as one operation, as TAP_OPS counts
# it). K11b's counts a thread-trip are the probes' own (OPS_PER_ROUND,
# EW_OPS, SLAB_OPS; a bf16 op counted as an f32 one)
K9_TAP_OPS = TAP_OPS + 10
# threads of the probes' full-width runs: one per path of a 1024x1024 sweep
PROBE_THREADS = 1 << 20
# phases 4b and 4c (each format, with and without the occlusion cache): the
# cap K2 resumes to and K5 traces to, and the chained samples of K4 (phase
# 4 holds the classic rows at cap 24 and 3 samples; the twins' Python passes
# cost ~0.2 s a bounce a format)
GATE_CAP = 8
GATE_SAMPLES = 2
# processes that run phase 6's plain versions at the main path's shapes,
# all at once: each is a Python loop of small launches (one bounce, one
# walk step at a time), so one process leaves the card mostly idle
TWIN_WORKERS = 7
# the per-format bound's split of rows by kind: each format's calls through
# their plain versions on the host, on every SPLIT_STRIDE-th lane (4,178 of
# a 1M sweep; a prime, so the lanes of a row-major frame spread over its
# columns)
SPLIT_STRIDE = 251
# K6's calls of one sync sweep replayed in phase 6 (two a bounce: closest,
# then shadow): bounce 1's closest and shadow walks, the closest walks of
# bounces 9, 30 and 200
K6_CALLS = (0, 1, 16, 58, 398)
# bounces of that sweep whose K6 launches torch.profiler times (the whole
# sweep, ~500 bounces of host-bound launches, took ~60 s under the profiler)
K6_PROFILE_BOUNCES = 16
# phase (r), the oracle gate: meshbox + spheres at ORACLE_SIDE², ORACLE_SPP
# sweeps of BlockScheduler(ORACLE_SIDE, ORACLE_SIDE, ORACLE_BLOCK, seed 0).
# The bar: raw MSE below BASELINE.json's gate, at most BAR_DIVERGENT of the
# pixels divergent (per-pixel MSE > DIVERGENT_PX), the rest within
# BAR_TRIMMED (docs/PARITY.md:130-134 read 2.165e-07 raw and 17 of 4096
# divergent for the JAX mega driver at 64² x 4096 spp; both scale ~1/spp)
ORACLE_SIDE = 64
ORACLE_SPP = 64
ORACLE_BLOCK = 64
BAR_MSE = 1e-4
BAR_DIVERGENT = 0.01
BAR_TRIMMED = 1e-8
DIVERGENT_PX = 1e-6


# path (n): the host stride in two processes sharing the card
HOSTS_CFG = dict(width=256, height=256, spp=4, max_bounces=1000, block_size=128, use_bvh=True,
                 driver="mega")
HOST_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

here, rank, store, out, cfg = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
sys.path.insert(0, here)
dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank)
from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.parallel.multihost import MultiHostMegaRenderer
from hijiki_tpu_torch.render import pallas_reconstruct as prc
from hijiki_tpu_torch.render.renderer import RenderConfig
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene

scene = load_obj_scene(f"{here}/scenes/meshbox/meshbox.obj")
scene.put_cbox_spheres()
r = MultiHostMegaRenderer(compile_scene(scene), RenderConfig(**json.loads(cfg)))
for d in (mk.LAUNCHES, prc.LAUNCHES):
    for k in d:
        d[k] = 0
m = r.render()
torch.cuda.synchronize()
launches = {**mk.LAUNCHES, **prc.LAUNCHES}
np.save(f"{out}.{rank}.npy", r.merged_film().cpu().numpy())
dist.destroy_process_group()
print(json.dumps(dict(rank=rank, host_id=r.host_id, num_hosts=r.num_hosts, sweeps=r.sweep_ids,
                      devices=m["devices"], launches=launches)), flush=True)
"""


def two_process_render(out_dir: str):
    """Path (n): MultiHostMegaRenderer in two processes on the card, joined
    over gloo through a file:// store (the rank and world size given, no
    network); each renders its stride of the sweeps on its one band and
    gathers the merged film. Returns (the merged film, which both ranks
    must hold bit for bit, the launches summed over the two processes)."""
    import numpy as np

    script = os.path.join(out_dir, "host_worker.py")
    with open(script, "w") as f:
        f.write(HOST_WORKER)
    store, out = os.path.join(out_dir, "hosts.store"), os.path.join(out_dir, "hosts")
    for path in (store, out + ".0.npy", out + ".1.npy"):
        if os.path.exists(path):
            os.remove(path)
    procs = [subprocess.Popen([sys.executable, script, HERE, str(rank), store, out,
                               json.dumps(HOSTS_CFG)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:  # no process outlives the phase
            p.kill()
            p.wait()
    counts = {}
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"(n) rank {rank} exited {p.returncode}:\n{log[-3000:]}")
        rec = json.loads(log.strip().splitlines()[-1])
        print(f"(n) rank {rank}: host {rec['host_id']} of {rec['num_hosts']}, sweeps "
              f"{rec['sweeps']}, {rec['devices']} band(s)")
        if (rec["host_id"], rec["num_hosts"]) != (rank, 2):
            fail(f"(n) rank {rank} took the topology {rec['host_id']} of {rec['num_hosts']}")
        for k, v in rec["launches"].items():
            counts[k] = counts.get(k, 0) + v
    m0, m1 = np.load(out + ".0.npy"), np.load(out + ".1.npy")
    if not np.array_equal(m0, m1):
        fail("(n) the two ranks hold different merged films")
    return m0, counts


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def equal_seed_inputs(side: int, spp: int, seed: int):
    """(per-pixel seeds (spp, side²) u32, sweep offsets (spp, 2) f32): the
    sweeps of ``BlockScheduler(side, side, 64, seed)``, drawn sweep by sweep
    as tools/oracle_mse.py draws them for its oracle and its drivers."""
    import numpy as np

    from hijiki_tpu_torch.render.blocks import BlockScheduler, per_pixel_seeds

    sched = BlockScheduler(side, side, ORACLE_BLOCK, seed)
    seeds, offsets = [], []
    for si in range(spp):
        s = sched.sweep(si)
        seeds.append(np.asarray(per_pixel_seeds(side, side, ORACLE_BLOCK, s.block_seeds)).reshape(-1))
        offsets.append(np.asarray(s.sample_offset, np.float32))
    return np.stack(seeds).astype(np.uint32), np.stack(offsets)


def oracle_sweep(cs, seeds, offset, side: int):
    """One sweep of the native scalar oracle: ((side, side, 3) f64 radiance,
    its seconds). Numpy and the host library only, so a worker that holds a
    CUDA context never touches the card here."""
    from hijiki_tpu_torch.ops.oracle_native import render_oracle_native

    t0 = time.monotonic()
    film = render_oracle_native(cs, seeds[None], offset[None], side, side)
    return film, time.monotonic() - t0


def in_sweep_order(films):
    """The mean of per-sweep films, summed in sweep order (the same film
    whatever process rendered which sweep, and when)."""
    acc = films[0].copy()
    for f in films[1:]:
        acc += f
    return acc / len(films)


def oracle_film(cs, seeds, offsets, side: int):
    """The oracle's mean film (side, side, 3) f64 over the sweeps of
    ``seeds``/``offsets``, each sweep alone, in this process."""
    from hijiki_tpu_torch.ops.oracle import host_scene

    cs = host_scene(cs)
    return in_sweep_order([oracle_sweep(cs, sd, of, side)[0] for sd, of in zip(seeds, offsets)])


def driver_films(cs, seeds, offsets, side: int, device, chain: int = 8):
    """Mean radiance films (side, side, 3) f64, before any reconstruction,
    of three drivers on ``device`` with the oracle's seeds and sweep
    offsets: "chained" (render_waves_chained, ``chain`` sweeps a call: K4
    and K2 on a card), "unchained" (render_waves over every sweep's paths
    in one call: K1 and K2), "sync" (the sync integrator with the ``rows``
    traversal over the same paths: K6) and "sync_mega_camera" (the same
    from the megakernel's camera, the baked matrix that the oracle's
    camera shares, in place of camera_rays' quaternion rotation: what the
    sync driver's own camera adds). Fails on overflow."""
    import numpy as np
    import torch

    from hijiki_tpu_torch.ops import megakernel as mk
    from hijiki_tpu_torch.ops.camera import camera_rays
    from hijiki_tpu_torch.ops.integrate import integrate
    from hijiki_tpu_torch.ops.rng import from_bits, seed_rng
    from hijiki_tpu_torch.scene.compile import to_device

    spp, n = seeds.shape
    y, x = np.mgrid[0:side, 0:side].astype(np.float32)
    px = torch.from_numpy(np.stack([x.reshape(-1) + o[0] for o in offsets])).to(device)
    py = torch.from_numpy(np.stack([y.reshape(-1) + o[1] for o in offsets])).to(device)
    sd = torch.from_numpy(seeds.view(np.int32)).to(device)  # the u32 bits
    ms = mk.mega_scene(cs, side, side, device)
    totals = {"chained": []}
    for s0 in range(0, spp, chain):
        out = mk.render_waves_chained(ms, px[s0:s0 + chain].contiguous(),
                                      py[s0:s0 + chain].contiguous(),
                                      sd[s0:s0 + chain].contiguous(), max_bounces=1000)
        if int(out[4]) != 0:
            fail(f"(r) render_waves_chained overflowed ({int(out[4])} paths)")
        totals["chained"].append(out[0])
    totals["chained"] = torch.cat(totals["chained"])
    out = mk.render_waves(ms, px.reshape(-1), py.reshape(-1), sd.reshape(-1), max_bounces=1000)
    if int(out[4]) != 0:
        fail(f"(r) render_waves overflowed ({int(out[4])} paths)")
    totals["unchained"] = out[0]
    csd = to_device(cs, device)
    o, d, tmin, tmax = camera_rays(csd.cam_position, csd.cam_rotation, csd.cam_fov,
                                   torch.stack([px.reshape(-1), py.reshape(-1)], -1), (side, side))
    totals["sync"] = integrate(csd, o, d, tmin, tmax, seed_rng(from_bits(sd.reshape(-1))),
                               max_bounces=1000, traversal="rows").total
    d_mega = torch.stack(mk._camera_ray(ms, px.reshape(-1), py.reshape(-1)), -1)
    totals["sync_mega_camera"] = integrate(csd, o, d_mega, tmin, tmax,
                                           seed_rng(from_bits(sd.reshape(-1))),
                                           max_bounces=1000, traversal="rows").total
    return {k: v.reshape(spp, side, side, 3).cpu().numpy().astype(np.float64).sum(0) / spp
            for k, v in totals.items()}


def readings(a, b) -> tuple:
    """(raw MSE, divergent pixels, trimmed MSE) of two mean films, as
    tools/oracle_mse.py reports them: a pixel is divergent where its MSE
    over the channels passes DIVERGENT_PX (a sampling decision taken
    otherwise, far above f32 noise); the trimmed MSE leaves those out."""
    err = ((a - b) ** 2).mean(axis=-1)
    tie = err > DIVERGENT_PX
    return float(err.mean()), int(tie.sum()), float(err[~tie].mean()) if (~tie).any() else 0.0


def breaks_bar(r, n_px: int) -> str:
    """"" where the readings ``r`` meet the equal-seed bar, else why not."""
    mse, n_div, trimmed = r
    why = []
    if not mse < BAR_MSE:
        why.append(f"raw MSE {mse:.3e} >= {BAR_MSE:g}")
    if n_div > BAR_DIVERGENT * n_px:
        why.append(f"{n_div} divergent pixels > {BAR_DIVERGENT:.0%} of {n_px}")
    if trimmed > BAR_TRIMMED:
        why.append(f"trimmed MSE {trimmed:.3e} > {BAR_TRIMMED:g}")
    return "; ".join(why)


_START = time.monotonic()
# (name, seconds since the start) of each phase begun, for the phase
# seconds printed before the kernel report
_PHASES = []


def phase(name: str) -> None:
    """Print the phase's name, the seconds since the script started and the
    seconds the phase before took."""
    now = time.monotonic() - _START
    took = f"; the phase before took {now - _PHASES[-1][1]:.1f} s" if _PHASES else ""
    _PHASES.append((name, now))
    print(f"== {name} (at {now:.1f} s{took})", flush=True)


def phase_seconds() -> None:
    """Print the seconds of every phase so far, the last one included."""
    now = time.monotonic() - _START
    ends = [t for _, t in _PHASES[1:]] + [now]
    print("phase seconds: " + "; ".join(f"{name.split(':')[0]} {end - t:.1f}"
                                         for (name, t), end in zip(_PHASES, ends))
          + f"; total {now:.1f} s", flush=True)


def timed(fn, reps: int = 1, warm: bool = True):
    """(mean milliseconds of ``fn`` over ``reps`` back-to-back runs between
    two CUDA events, the last run's result); ``warm`` runs it once before."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def check_k3(name: str, got, want) -> float:
    """K3 against its twin: rtol 1e-5, atol 1e-6 (expf ULPs); returns the
    max abs error."""
    import numpy as np

    g, w = got.cpu().numpy(), want.cpu().numpy()
    if not np.allclose(g, w, rtol=1e-5, atol=1e-6, equal_nan=False):
        bad = ~np.isclose(g, w, rtol=1e-5, atol=1e-6)
        fail(f"{name}: {bad.sum()} values outside rtol 1e-5/atol 1e-6, "
             f"max err {np.nanmax(np.abs(g - w))}")
    err = float(np.abs(g - w).max())
    print(f"{name}: max abs err {err:.3e} (finite: {np.isfinite(g).all()})")
    return err


def agree_paths(name, grng, wrng, gl, wl, bit_note="") -> float:
    """Final RNG state bit-equal on >= 99.5% of paths and radiance (P, 3)
    within rtol/atol 2e-3 on those (the JAX suite's megakernel bounds);
    returns the radiance max abs error on those paths."""
    import numpy as np

    same = (grng == wrng).cpu().numpy()
    gl, wl = gl.cpu().numpy(), wl.cpu().numpy()
    close = np.isclose(gl, wl, rtol=2e-3, atol=2e-3).all(-1)
    err = float(np.abs(gl - wl)[same].max()) if same.any() else float("inf")
    print(f"{name}: RNG equal on {same.mean():.4%} of paths, radiance max abs err "
          f"{err:.3e} on those{bit_note}")
    if same.mean() < 0.995 or not close[same].all():
        fail(f"{name} disagrees with its twin")
    return err


def agree(name: str, got, want) -> float:
    """K1/K2: (state, rng) against the twin's."""
    (gst, grng), (wst, wrng) = got, want
    note = f", state bit-equal on {(gst == wst).all(0).float().mean().item():.4%}"
    return agree_paths(name, grng, wrng, gst[15:18].T, wst[15:18].T, note)


def agree_chained(name: str, got, want) -> float:
    """K4: (pool, pool RNG, flush buffer) against the twin's; a slot's
    radiance is its flushed value plus its parked one (the other is 0)."""
    (gp, grng, gco), (wp, wrng, wco) = got, want
    note = (f", pool bit-equal on {(gp == wp).all(0).float().mean().item():.4%}, "
            f"flush buffer on {(gco == wco).all(0).float().mean().item():.4%} of slots; "
            f"{int((gp[0] > 0).sum())} of {gp.shape[1]} slots parked")
    return agree_paths(name, grng, wrng, (gco[0:3] + gp[15:18]).T, (wco[0:3] + wp[15:18]).T, note)


def agree_tiles(name: str, got, want) -> float:
    """K5: (7-channel result, rng) against the twin's."""
    (go, grng), (wo, wrng) = got, want
    note = f", result bit-equal on {(go == wo).all(0).float().mean().item():.4%}"
    return agree_paths(name, grng, wrng, go[0:3].T, wo[0:3].T, note)


def bit_equal(got, want) -> bool:
    """Every tensor of ``got`` equal to ``want``'s bit for bit (int32 views:
    NaN equals NaN of the same bits)."""
    import torch

    def b(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    return all(torch.equal(b(g), b(w)) for g, w in zip(got, want))


def order_mismatch(mk, ms, got, want) -> str:
    """What is wrong with a sorted launch's order record (the last entry of
    ``got``: the path id at each lane after its tile's last sort, and that
    path's key), or "" if nothing: it must equal the sorted plain version's
    (``want``'s) bit for bit, move some path off its own lane, and, for
    K1/K2, hold at each lane lane_sort_key of the state the kernel wrote for
    that path (a padded path's key: dead). The outputs cannot show the sort;
    this does."""
    import torch

    order = got[-1]
    lane = torch.arange(order.shape[1], device=order.device)
    if not torch.equal(order, want[-1]):
        return f"order differs from the plain version's on {int((order != want[-1]).any(0).sum())} lanes"
    if torch.equal(order[0], lane.to(order.dtype)):
        return "no lane holds another lane's path: nothing was sorted"
    if got[0].shape[0] == mk.N_STATE:
        key = mk.lane_sort_key(ms, mk._unpack(got[0], got[1]))
        key = torch.cat([key, key.new_full(((-key.numel()) % mk.SORT_TILE,), 1 << 20)])
        if not torch.equal(order[1], key[order[0].long()]):
            return "a recorded key differs from lane_sort_key of its path's state"
    return ""


def check_order(label, mk, ms, got, want) -> None:
    """Fail unless ``got``'s order record passes ``order_mismatch``."""
    import torch

    why = order_mismatch(mk, ms, got, want)
    if why:
        fail(f"{label}: {why}")
    pid = got[-1][0]
    moved = float((pid != torch.arange(pid.numel(), dtype=pid.dtype, device=pid.device)).float().mean())
    print(f"{label}: order of the last sort bit-equal to the plain version's, "
          f"{moved:.2%} of lanes hold another lane's path")


def key_test_state(st, stuck, cap, lo, hi, seed):
    """A K2 input whose ``stuck`` lanes are alive at ``cap`` bounces (no
    bounce moves them, the sort keys them as they are), with origins that
    test the key: NaN, +-inf, +-1e30, the scene box's bounds and points
    outside it; directions with 0 and -0.0 components."""
    import numpy as np
    import torch

    st = st.clone()
    g = np.random.default_rng(seed)
    m = int(stuck.sum())
    o = lo - 0.5 * (hi - lo) + 2.0 * (hi - lo) * g.random((m, 3))
    special = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30], np.float32)
    for a in range(3):
        o[a::5, a] = special[g.integers(0, len(special), len(o[a::5]))]
        o[1 + a::7, a] = lo[a]
        o[2 + a::9, a] = hi[a]
    d = g.standard_normal((m, 3))
    d[::4, 0] = 0.0
    d[1::6, 1] = -0.0
    st[0, stuck] = 1.0
    st[1, stuck] = float(cap)
    st[2:5, stuck] = torch.from_numpy(o.T.astype(np.float32)).to(st.device)
    st[5:8, stuck] = torch.from_numpy(d.T.astype(np.float32)).to(st.device)
    return st


CHECKS = {"mk_start": agree, "mk_resume": agree, "mk_start_chained": agree_chained,
          "mk_tiles": agree_tiles}


def same_scene(a, b) -> str:
    """"" where two loads of one OBJ (``a`` the Python parser's Triangle
    objects, ``b`` the native parser's bulk triangles) hold the same arrays
    and materials, else the first that differs."""
    import numpy as np

    for name in ("positions", "normals", "uvs"):
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            return name
    tris, mats = a.triangles()
    if not (np.array_equal(tris, b.bulk_tris) and np.array_equal(mats, b.bulk_tri_mats)):
        return "triangles"
    return "" if [repr(m) for m in a.materials] == [repr(m) for m in b.materials] else "materials"


def same_compiled(a, b) -> str:
    """"" where two compiled scenes hold equal fields (arrays bit for bit,
    statics by value), else the first that differs."""
    import dataclasses

    import numpy as np

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if x is None or y is None or x.dtype != y.dtype or not np.array_equal(x, y):
                return f.name
        elif x != y:
            return f.name
    return ""


def compile_with(scene, backend: str, **kw):
    """(compile_scene(scene, **kw) with build_bvh(backend=``backend``) for
    every tree, its seconds, the seconds of its BVH builds)"""
    from hijiki_tpu_torch.accel.bvh import build_bvh
    from hijiki_tpu_torch.scene import compile as sc

    spent = [0.0]

    def timed_build(mn, mx, leaf_size=1):
        t0 = time.monotonic()
        out = build_bvh(mn, mx, leaf_size, backend=backend)
        spent[0] += time.monotonic() - t0
        return out

    sc.build_bvh = timed_build
    t0 = time.monotonic()
    try:
        cs = sc.compile_scene(scene, **kw)
    finally:
        sc.build_bvh = build_bvh
    return cs, time.monotonic() - t0, spent[0]


def _twin_init() -> None:
    """A twin worker's start: its CUDA context, made before any job."""
    import torch

    torch.zeros(1, device="cuda")


def twin_job(label, name, sc, args, kw, got):
    """In a twin worker: the plain version of the megakernel entry ``name``
    (``mk_start`` -> ``megakernel_start_plain``, ...) on ``sc`` and ``args``
    (``kw``: lane_sort and lane_order), timed on the card, held to the
    kernel's outputs ``got`` with the phase-4 bounds and bit for bit, and
    with ``lane_order`` its order record checked as check_order does.
    Returns (the plain version's ms, its max abs error, what it printed,
    "" or why it failed, the occlusion-cache pretests (tried, verified) it
    made, its rows visited by kind: mk.row_kinds)."""
    import contextlib
    import io

    from hijiki_tpu_torch.ops import megakernel as mk

    buf = io.StringIO()
    t_p = err = None
    try:
        with contextlib.redirect_stdout(buf):
            mk.reset_pretest_counts()
            mk.reset_row_kinds()
            fn = getattr(mk, f"megakernel_{name[3:]}_plain")
            t_p, want = timed(lambda: fn(sc, *args, **kw), reps=1, warm=False)
            n = len(got) - 1 if kw.get("lane_order") else len(got)
            err = CHECKS[name](label, got[:n], want[:n])
            if not bit_equal(got[:n], want[:n]):
                fail(f"{label}: the kernel's outputs differ from its plain version's bit for bit")
            if kw.get("lane_order"):
                check_order(label, mk, sc, got, want)
            pre, kinds = mk.pretest_counts(), mk.row_kinds()
    except SystemExit:
        return t_p, err, buf.getvalue(), "failed", (0, 0), {}
    return t_p, err, buf.getvalue(), "", pre, kinds


def collect_twins(jobs, futures) -> list:
    """The results of ``jobs`` (label, entry, scene, args, kw, the kernel's
    outputs), submitted to the twin workers as ``futures`` (``twin_job``),
    in order: prints what each printed and fails at the first that failed.
    The caller keeps ``jobs`` (the tensors the workers read) until then.
    Returns [(plain ms, max abs err, pretests, rows by kind)]."""
    out = []
    for job, fut in zip(jobs, futures):
        t_p, err, text, why, pre, kinds = fut.result()
        print(text, end="", flush=True)
        if why:
            fail(f"{job[0]}: its plain version {why}")
        out.append((t_p, err, pre, kinds))
    return out


def row_ops(kinds: dict) -> float:
    """f32 operations a visited row, averaged over a plain version's rows by
    kind (``mk.row_kinds``): ROW_OPS an interior row, PRIM_ROW_OPS a prim
    row of its format, none a winner's row read to shade."""
    rows = sum(kinds.values())
    ops = sum(n * (ROW_OPS if k == "interior" else 0 if k == "resolve" else PRIM_ROW_OPS[k])
              for k, n in kinds.items())
    return ops / rows if rows else ROW_OPS


def row_split(name, sc, args) -> dict:
    """In a twin worker, on the host: the plain version of the megakernel
    entry ``name`` on ``sc`` and ``args`` (a CPU scene and CPU tensors);
    returns its rows visited by kind (mk.row_kinds)."""
    import torch

    from hijiki_tpu_torch.ops import megakernel as mk

    torch.set_num_threads(1)
    mk.reset_row_kinds()
    getattr(mk, f"megakernel_{name[3:]}_plain")(sc, *args)
    return mk.row_kinds()


def lanes_of(name, args, stride: int):
    """A megakernel call's positional arguments on every ``stride``-th lane
    (a path's lane is a column of K2's state and of K4's (S, N) inputs)."""
    if name == "mk_resume":
        st, rng, cap = args
        return st[:, ::stride].contiguous(), rng[::stride].contiguous(), cap
    *lanes, cap = args
    return (*(a[..., ::stride].contiguous() for a in lanes), cap)


def record_calls(mk, names, run):
    """Run ``run`` with the megakernel wrappers of the C entries ``names``
    (``mk_start`` -> ``mk.megakernel_start``, ...) recording: returns
    [(name, cloned positional args)] of every call, in order."""
    import torch

    real = {name: getattr(mk, f"megakernel_{name[3:]}") for name in names}
    calls = []

    def recorder(name):
        def call(ms_, *args, **kw):
            calls.append((name, tuple(a.clone() if torch.is_tensor(a) else a for a in args)))
            return real[name](ms_, *args, **kw)
        return call

    for name in names:
        setattr(mk, f"megakernel_{name[3:]}", recorder(name))
    try:
        run()
    finally:
        for name in names:
            setattr(mk, f"megakernel_{name[3:]}", real[name])
    return calls


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and f32
    operations over the f32 peak (or over ``ops_per_s``)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k6_bytes_ops(args, got):
    """(bytes, f32 operations) of one K6 call: the table once, every
    ray's tmin and tmax, o and d of the rays that walk (tmax >= tmin;
    the others return their tmax and a miss without reading them), the
    six outputs of the TPU kernel's contract per ray (the seventh, rows
    visited, is the port's own counter), ROW_OPS per visited row."""
    rows, o, d, tmin, tmax = args
    walking = int((tmax >= tmin).sum())
    nb = (nbytes(rows, tmin, tmax) + walking * (o.shape[1] + d.shape[1]) * o.element_size()
          + 6 * o.shape[0] * got.element_size())
    return nb, float(got[6].sum()) * ROW_OPS


def k11b_same(same, dev, pvi, pvd, n, it) -> None:
    """The K11b bodies at ``n`` threads, ``it`` trips, bit-equal to their
    plain versions on the card: alu_issue at every K, dtype_elementwise in
    f32, bf16 and bf16x2 at 1 and 8 chains (bf16x2 also equal to bf16), and
    dtype_slab in f32 and bf16 at rows 8 and 1024 of 1024 lanes."""
    import torch

    x = torch.from_numpy(pvi.x_of(n)).to(dev)
    for k in pvi.KERNEL_KS:
        same(f"alu_issue K={k} ({n} threads)", "alu_issue", pvi.alu_issue(x, it, k),
             pvi.alu_issue_plain(x, it, k))
    for chains in (1, 8):
        for v in pvd.VARIANTS:
            xe = pvd.ew_input(chains, n, "f32" if v == "f32" else "bf16").to(dev)
            got = pvd.dtype_elementwise(xe, it, v)
            same(f"dtype_elementwise {v} chains={chains} ({n} elements)", "dtype_elementwise",
                 got, pvd.ew_plain(xe, it))
            if v == "bf16x2":
                same("dtype_elementwise bf16x2 against bf16", "dtype_elementwise", got,
                     pvd.dtype_elementwise(xe, it, "bf16"))
    for rows in pvd.SLAB_ROWS:
        sx, srow = (t.to(dev) for t in pvd.slab_input(rows, 1024))
        for v in pvd.SLAB_VARIANTS:
            same(f"dtype_slab {v} ({rows}, 1024)", "dtype_slab", pvd.dtype_slab(sx, srow, it, v),
                 pvd.slab_plain(sx, srow, it, v))


def probe_checks(dev, pab, pwk, pcl, pga, pvi, pvd, compiled) -> dict:
    """Phase 7's untimed half: the probe kernels (K10a, K10b, K11a, K11b)
    bit-equal to their plain versions at 4096 threads, every mode.
    ``compiled``: {packed_leaf: the meshbox + spheres compiled so} for
    K10b's tables. Returns what the timed half (probe_phase) reads."""
    import numpy as np
    import torch

    phase("probes: K10/K11 at 4096 threads vs plain (untimed, beside phase 6's twins)")
    # K10b's tables: the classic rows (ms, which K10a walks too), their
    # 16-column copy, and the packed tables of packed_leaf 1, 3, 4, 12
    # (walk_isolate_packed_kernel)
    tables, cs = pwk.load_tables(SCENE, dev, pwk.TABLES, compiled=compiled)
    ms = tables["w32"][0]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    packed = [t for t in pwk.TABLES if pwk.TABLES[t]]  # slim, pack3, pack4, pack12
    err = dict(walk_ablate=0.0, walk_isolate=0.0, latency_chain=0.0, staged_chase=0.0,
               reconstruct_old=0.0, alu_issue=0.0, dtype_elementwise=0.0, dtype_slab=0.0,
               **{f"walk_isolate_{t}": 0.0 for t in packed})

    def same(label, key, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not bit_equal(got, want):
            fail(f"{label}: the kernel differs from its plain version")
        err[key] = max([err[key]] + [float((g - w).abs().nan_to_num(0.0).max()) for g, w in zip(got, want)])

    n = 64 * 64
    o, d = pwk.ray_set("random", cs, n, dev)
    for name, cfg in pab.VARIANTS.items():
        for g in (1, 32):
            same(f"walk_ablate {name} G={g}", "walk_ablate", pab.walk_ablate(ms.rows, o, d, 40, cfg, g),
                 pab.walk_ablate_plain(ms.rows, o, d, 40, cfg, g))
    for rays in ("camera", "random"):
        o, d = pwk.ray_set(rays, cs, n, dev, frame=64)
        for table, (ms_t, rows_t) in tables.items():
            key = "walk_isolate" if table in ("w32", "w16") else f"walk_isolate_{table}"
            for test in (True, False):
                for g in (1, 32):
                    same(f"walk_isolate {rays} {table} test={test} G={g}", key,
                         pwk.walk_isolate(ms_t, rows_t, o, d, test=test, group=g, iters=2),
                         pwk.walk_isolate_plain(ms_t, rows_t, o, d, test=test, group=g))
    it = 50
    x, xv = T(pcl.x_of(n)), T(pcl.x_of(n, scale=0.4))
    ftbl = T(pcl.fetch_table())
    ctbl, xc = T(pcl.chain_table()[0]), T(pcl.x_of(n) + np.float32(0.5))
    gtbl, gidx = (T(a) for a in pga.gather_inputs(n, 4))
    chains = [(f"alu k={k}", lambda k=k: pcl.alu(x, it, k), lambda k=k: pcl.alu_plain(x, it, k))
              for k in (8, 16, 32)]
    chains += [(f"vote G={g}", lambda g=g: pcl.vote(xv, it, g), lambda g=g: pcl.vote_plain(xv, it, g))
               for g in (1, 32)]
    chains += [(f"fetch {m} h={h}", lambda m=m, h=h: pcl.fetch(ftbl, n, it, m, h),
                lambda m=m, h=h: pcl.fetch_plain(ftbl, n, it, m, h))
               for m, h in (("indep", 1), ("indep", 2), ("chase", 1))]
    chains += [(f"chain G={g}", lambda g=g: pcl.chain(ctbl, xc, it, g),
                lambda g=g: pcl.chain_plain(ctbl, xc, it, g)) for g in (1, 32)]
    chains += [(f"gather {m}", lambda m=m: pga.gather(gtbl, gidx, it, m),
                lambda m=m: pga.gather_plain(gtbl, gidx, it, m)) for m in pga.MODES]
    for label, kern, plain in chains:
        same(f"latency_chain {label}", "latency_chain", kern(), plain())
    dma_cases = [(m, h) for m in ("indep", "chase", "sharedsem") for h in (1, 2, 4)]
    for mode, h in dma_cases + [("sharedsem+noclamp", 1), ("dedup", 1)]:
        dtbl = T(pcl.dma_table(65536, height=h))
        same(f"staged_chase {mode} h={h}", "staged_chase", pcl.staged_chase(dtbl, 128, it, mode, h),
             pcl.staged_plain(dtbl, 128, it, mode, h))
    dtbl = T(pcl.dma_table(65536, height=2))
    for g, spec in ((1, False), (2, False), (4, False), (1, True), (2, True), (4, True)):
        same(f"staged_chase multi G={g} spec={spec}", "staged_chase",
             pcl.staged_chase(dtbl, 128, it, "multi", nchains=g, spec=spec),
             pcl.staged_multi_plain(dtbl, 128, it, g, spec))
    print(f"probes at {n} threads: every kernel bit-equal to its plain version (walk_ablate: 11 "
          "variants x G 1, 32; walk_isolate: w32/w16/slim/pack3/pack4/pack12 x test/notest x G 1, "
          "32 x camera/random rays; latency_chain: alu, vote, fetch, chain, gather; staged_chase: "
          "indep, chase, sharedsem at heights 1, 2, 4, sharedsem+noclamp, dedup, 6 multi)",
          flush=True)
    k11b_same(same, dev, pvi, pvd, n, it=6)
    print(f"K11b at {n} threads: alu_issue (K 1, 2, 4, 8, 16), dtype_elementwise (f32, bf16, "
          "bf16x2; 1 and 8 chains) and dtype_slab (f32, bf16; rows 8 and 1024) bit-equal to "
          "their plain versions", flush=True)
    return dict(T=T, cs=cs, dtbl=dtbl, err=err, ftbl=ftbl, ms=ms, packed=packed, same=same,
                tables=tables)


def probe_phase(checked, dev, drive, pab, pwk, pcl, pga, pk9, pvi, pvd) -> list:
    """Phase 7's timed half, on a quiet card: the probe kernels at 1M
    threads with a short trip count (timed beside the plain version), K9
    against its plain version and K3; then (k) a short run of each probe's
    main(), whose launches are counted as a path's. ``checked``: what
    probe_checks returned. Returns the probes' entries of the kernel
    report."""
    from hijiki_tpu_torch.render.pallas_reconstruct import reconstruct as k3_reconstruct

    phase("probes: K9/K10/K11 at 1M threads vs plain, timed")
    t_phase = time.monotonic()
    T, cs, dtbl, err, ftbl, ms, packed, same, tables = (
        checked[k] for k in ("T", "cs", "dtbl", "err", "ftbl", "ms", "packed", "same", "tables"))

    # 1M threads, a short trip count: agreement, times and bounds
    N = PROBE_THREADS
    full = {}
    ro, rd = pwk.ray_set("random", cs, N, dev)
    co, cd = pwk.ray_set("camera", cs, N, dev)
    kinds = {}  # K10b's rows by kind, as its plain version splits them (mk.row_kinds)

    def split_walk(key, plain):
        from hijiki_tpu_torch.ops import megakernel as mk

        mk.reset_row_kinds()
        out = plain()
        kinds[key] = mk.row_kinds()
        return out

    runs = [
        ("walk_ablate", "full, G=1, 1M random rays, 16 steps",
         lambda: pab.walk_ablate(ms.rows, ro, rd, 16, {}, 1),
         lambda: pab.walk_ablate_plain(ms.rows, ro, rd, 16, {}, 1),
         lambda got: (nbytes(ms.rows, ro, rd, got), N * 16 * PROBE_OPS["walk_ablate"])),
        ("walk_isolate", "w32, G=1, 1024x1024 camera rays, one walk",
         lambda: pwk.walk_isolate(ms, ms.rows, co, cd),
         lambda: split_walk("walk_isolate", lambda: pwk.walk_isolate_plain(ms, ms.rows, co, cd)),
         lambda got: (nbytes(ms.rows, ms.consts, co, cd, *got),
                      float(got[1].sum()) * row_ops(kinds["walk_isolate"]))),
    ] + [
        (f"walk_isolate_{t}", f"{t} ({tuple(tables[t][1].shape)} rows), G=1, 1024x1024 camera rays, "
         "one walk",
         lambda t=t: pwk.walk_isolate(tables[t][0], tables[t][1], co, cd),
         lambda t=t: split_walk(f"walk_isolate_{t}", lambda: pwk.walk_isolate_plain(
             tables[t][0], tables[t][1], co, cd)),
         lambda got, t=t: (nbytes(tables[t][1], tables[t][0].consts, co, cd, *got),
                           float(got[1].sum()) * row_ops(kinds[f"walk_isolate_{t}"])))
        for t in packed
    ] + [
        ("latency_chain", "fetch chase, 1M threads, 16 steps",
         lambda: pcl.fetch(ftbl, N, 16, "chase"),
         lambda: pcl.fetch_plain(ftbl, N, 16, "chase"),
         lambda got: (nbytes(ftbl, got), N * 16 * PROBE_OPS["fetch"])),
        ("staged_chase", "chase, 32768 warps (1M threads), 8 steps",
         lambda: pcl.staged_chase(dtbl, N // 32, 8, "chase"),
         lambda: pcl.staged_plain(dtbl, N // 32, 8, "chase"),
         lambda got: (nbytes(dtbl, got), N * 8 * PROBE_OPS["staged"])),
    ]
    k11b_same(same, dev, pvi, pvd, N, it=4)
    xi = T(pvi.x_of(N))
    xe = pvd.ew_input(8, N, "f32").to(dev)
    sx, srow = (t.to(dev) for t in pvd.slab_input(1024, 1024))
    runs += [
        ("alu_issue", "K=8, 1M threads, 64 trips",
         lambda: pvi.alu_issue(xi, 64, 8), lambda: pvi.alu_issue_plain(xi, 64, 8),
         lambda got: (nbytes(xi, got), N * 64 * (pvi.OPS_PER_ROUND * 8 + 1))),
        ("dtype_elementwise", "f32, 8 chains, 1M threads, 64 trips",
         lambda: pvd.dtype_elementwise(xe, 64, "f32"), lambda: pvd.ew_plain(xe, 64),
         lambda got: (nbytes(xe, got), N * 64 * 8 * pvd.EW_OPS)),
        ("dtype_slab", "f32, (1024, 1024), 64 trips",
         lambda: pvd.dtype_slab(sx, srow, 64, "f32"), lambda: pvd.slab_plain(sx, srow, 64, "f32"),
         lambda got: (nbytes(sx, srow, got), N * 64 * pvd.SLAB_OPS)),
    ]
    for key, label, kern, plain, work in runs:
        t_k, got = timed(kern, reps=3)
        t_p, want = timed(plain, reps=1, warm=False)
        same(f"{key} ({label})", key, got, want)
        b_ms, b_by = bound(*work(got))
        full[key] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                         bound_unfused_ms=bound(*work(got), F32_UNFUSED_OPS_PER_S)[0])
        split = (f"; rows by kind {kinds[key]}, {row_ops(kinds[key]):.3f} ops a row"
                 if key in kinds else "")
        print(f"{key} ({label}): bit-equal to its plain version; {t_k:.3f} ms, plain {t_p:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}; {full[key]['bound_unfused_ms']:.4f} at the unfused "
              f"rate){split}", flush=True)
    # the redesigned probes (K10a on the render walk's row step, staged_chase
    # with float4 stores): ptxas' registers and spill stores of the timed
    # instantiation, the warps an SM holds at the timed launch's block; and
    # every K10a instantiation's SASS loads rows with 128-bit loads only
    from hijiki_tpu_torch.utils import build

    report = build.build()[2]
    for key, kernel, targs, blocks, block in (
            ("walk_ablate", "walk_ablate_kernel", "ILi63ELi1E",
             pab.walk_ablate(ms.rows, ro, rd, 1, {}, 1, occupancy=True), pab.FULL_BLOCK),
            ("staged_chase", "staged_chase_kernel", "ILi1E",
             pcl.staged_chase(dtbl, N // 32, 1, "chase", occupancy=True), 32)):
        regs, spill = build.ptxas_of(report, kernel, targs)
        print(f"{key} ({kernel}<{targs}>): {regs} registers, {spill} bytes spilled, "
              f"{blocks * block // 32} warps an SM in blocks of {block}; {full[key]['ms']:.4f} ms, "
              f"bound {full[key]['bound_ms']:.4f} ms ({full[key]['bound_by']})", flush=True)
        if spill:
            fail(f"{key}: {spill} bytes spilled")
    try:
        loads = pab.check_row_loads()
    except RuntimeError as e:
        fail(str(e))
    print(f"walk_ablate: all {len(loads)} instantiations load rows with 128-bit loads only "
          "(SASS: no fewer LDG.E.128 than the source's float4 loads, no narrower LDG in a loop)",
          flush=True)
    # every packed walk's loads (walk.cuh walk_packed, packed_test) in K10b,
    # K1 and K4, and their registers and spills
    try:
        packed_loads = pwk.check_packed_loads()
    except RuntimeError as e:
        fail(str(e))
    for (kernel, targs), (wide, narrow, local, local_all) in packed_loads.items():
        regs, spill = build.ptxas_of(report, kernel, targs)
        print(f"  {kernel}<{targs}>: {wide} LDG.E.128, {narrow} narrower LDG and "
              f"{local} LDL/STL in its walk loops ({local_all} LDL/STL in all); {regs} registers, "
              f"{spill} bytes spilled", flush=True)
    print(f"walk_packed: all {len(packed_loads)} packed instantiations of K10b, K1 and K4 hold no "
          "LDL/STL in their walk loops", flush=True)

    # K9 against its plain version (K3's bound) and against K3, then timed
    for H, W in ((1024, 1024), (1000, 1024)):
        color, normal, so = pk9.inputs(W, H, dev)
        color[3, 5, 1] = float("nan")
        normal[H // 2, 10, 2] = float("nan")
        planes = pk9.planes_of(color, normal)
        kern = lambda: pk9.reconstruct_old_planes(planes, H, so, block_size=128)
        plain = lambda: pk9.reconstruct_old_plain(planes, H, so, block_size=128)
        t_k, got = timed(kern, reps=20)
        t_p, want = timed(plain, reps=1, warm=False)
        err["reconstruct_old"] = max(err["reconstruct_old"], check_k3(f"K9 {H}x{W}", got, want))
        t_3, k3 = timed(lambda: k3_reconstruct(color, normal, so, block_size=128), reps=20)
        e3 = check_k3(f"K9 against K3 {H}x{W}", got, k3)
        print(f"K9 {H}x{W}: {pk9.differing_pixels(got, k3)} of {H * W} pixels differ from K3 "
              f"(max |diff| {e3:.3e}); K9 {t_k:.4f} ms, K3 {t_3:.4f} ms (mean of 20), plain "
              f"{t_p:.3f} ms", flush=True)
        if (H, W) == (1024, 1024):
            # each pixel's 7 planes in and 4 channels out, once; K9_TAP_OPS a tap
            k9_work = (nbytes(planes, got), H * W * 25 * K9_TAP_OPS)
            b_ms, b_by = bound(*k9_work)
            full["reconstruct_old"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                                           bound_unfused_ms=bound(*k9_work, F32_UNFUSED_OPS_PER_S)[0])
            print(f"reconstruct_old (1024x1024, block 128): bound {b_ms:.4f} ms ({b_by})",
                  flush=True)

    out_dir = os.path.join(HERE, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)

    def short_mains():
        j = lambda name: ["--json", os.path.join(out_dir, f"probe_{name}.json")]
        pab.main(["0", "1024", "full", "noprefetch", "--rays", "random", "camera"] + j("ablate"))
        pwk.main(["--variants", "unpacked", "packed", "--rays", "camera"] + j("walk"))
        pwk.main(["widths", "1024"] + j("widths"))
        pcl.main(["fetch"] + j("fetch"))
        pcl.main(["dma", "--rows", "65536", "262144"] + j("dma"))
        pga.main(j("gather"))
        pk9.main(["1024"] + j("ab"))
        pk9.main(["instream", "1024"] + j("instream"))
        pvi.main(j("issue"))
        pvd.main(j("dtype"))

    _, counts_k = drive("(k) probes: short runs of each probe's main(), one warp per SM and 1M "
                        "threads", short_mains)
    for k in err:
        if counts_k[k] <= 0:
            fail(f"(k) the probes did not launch {k}")
    print(f"(k) launches {{{', '.join(f'{k!r}: {counts_k[k]}' for k in err)}}}; phase 7 took "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)
    src = "hijiki_tpu_torch/csrc/"
    replaces = dict(walk_ablate="tools/ablate_walker.py:187", walk_isolate="tools/walk_probe.py:84",
                    **{f"walk_isolate_{t}": "tools/walk_probe.py:84 (main :246, main_widths :192)"
                       for t in packed},
                    latency_chain="tools/chain_latency_probe.py:233",
                    staged_chase="tools/chain_latency_probe.py:508",
                    reconstruct_old="tools/ab_reconstruct.py:135",
                    alu_issue="tools/vpu_issue_probe.py:75",
                    dtype_elementwise="tools/vpu_dtype_probe.py:124",
                    dtype_slab="tools/vpu_dtype_probe.py:91")
    sources = dict(walk_ablate="probe_walk.cu", walk_isolate="probe_walk.cu",
                   **{f"walk_isolate_{t}": "probe_walk.cu" for t in packed},
                   latency_chain="probe_latency.cu", staged_chase="probe_latency.cu",
                   reconstruct_old="reconstruct_old.cu", alu_issue="probe_alu.cu",
                   dtype_elementwise="probe_alu.cu", dtype_slab="probe_alu.cu")
    return [dict(name=k, route="cuda", source=src + sources[k],
                 replaces=replaces[k], launches=counts_k[k], max_abs_err=err[k],
                 ms=full[k]["ms"], plain_ms=full[k]["plain_ms"], bound_ms=full[k]["bound_ms"],
                 bound_by=full[k]["bound_by"], library_ms=None,
                 bound_unfused_ms=full[k]["bound_unfused_ms"]) for k in err]


def main() -> int:
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F

        from hijiki_tpu_torch.ops import megakernel as mk
        from hijiki_tpu_torch.ops import pallas_megakernel as pmk
        from hijiki_tpu_torch.ops import pallas_sort as psort
        from hijiki_tpu_torch.ops import pallas_traverse as pt
        from hijiki_tpu_torch.ops import sort as srt
        from hijiki_tpu_torch.ops.camera import camera_rays
        from hijiki_tpu_torch.ops.integrate import (
            bounce_step, integrate, make_intersectors, start_lanes,
        )
        from hijiki_tpu_torch.ops.rng import from_bits, seed_rng
        from hijiki_tpu_torch.parallel.multichip import (
            MegaMultiChipRenderer, MultiChipRenderer, make_sharded_mega_sweep,
        )
        from hijiki_tpu_torch.probes import ablate_walker as pab
        from hijiki_tpu_torch.probes import chain_latency_probe as pcl
        from hijiki_tpu_torch.probes import gather_probe as pga
        from hijiki_tpu_torch.probes import walk_probe as pwk
        from hijiki_tpu_torch.probes import ab_reconstruct as pk9
        from hijiki_tpu_torch.probes import vpu_dtype_probe as pvd
        from hijiki_tpu_torch.probes import vpu_issue_probe as pvi
        from hijiki_tpu_torch.render import pallas_reconstruct as prc
        from hijiki_tpu_torch.render.reconstruct import reconstruct_sweep
        from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
        from hijiki_tpu_torch.scene.compile import compile_scene, scene_to_device, to_device
        from hijiki_tpu_torch.scene.obj import load_obj_scene
        from hijiki_tpu_torch.utils import build
        from hijiki_tpu_torch.utils.exr import read_exr
    except ImportError as e:
        fail(f"the port is not importable from {HERE}: {e}")
    if not os.path.exists(SCENE):
        fail(f"scene {SCENE} missing")

    # ---- 1. device ----
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    phase("build")
    path, secs, report = build.build()
    print(f"built {path.relative_to(HERE)} in {secs:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    build.load_library()
    # phase 6's twin workers, started now so that they reach the card while
    # phases 3-5 run (idle until phase 6, which shuts them down; on a
    # failure before that, at exit)
    import atexit
    import concurrent.futures
    import torch.multiprocessing

    twin_pool = concurrent.futures.ProcessPoolExecutor(
        TWIN_WORKERS, mp_context=torch.multiprocessing.get_context("spawn"), initializer=_twin_init)
    atexit.register(twin_pool.shutdown, cancel_futures=True)
    for _ in range(TWIN_WORKERS):
        twin_pool.submit(os.getpid)
    # the plain versions of phases 4-4c run in the twin workers while this
    # process launches the kernels and checks them against each other;
    # collect_gates waits for them all at the end of phase 4c, before any
    # path is timed
    gate_jobs = []

    def gate_twin(label, name, sc, args, got, kw=None, group=None):
        """Hold ``got``, the outputs of the megakernel entry ``name`` on
        ``sc`` and ``args``, to its plain version in a twin worker
        (twin_job: the phase-4 bounds and bit for bit, with lane_order the
        order record as check_order holds it); the tensors stay referenced
        here until collect_gates has the result. ``group``: what the
        result counts towards (a 4b format, a 4c configuration)."""
        job = (label, name, sc, args, kw or {}, got)
        gate_jobs.append((job, group, twin_pool.submit(twin_job, *job)))

    def collect_gates() -> list:
        """Every gate twin's result, in submission order (collect_twins);
        returns [(entry, group, max abs err, (pretests tried, verified))]."""
        res = collect_twins([j for j, _, _ in gate_jobs], [f for _, _, f in gate_jobs])
        out = [(j[1], group, err, pre) for (j, group, _), (_, err, pre, _) in zip(gate_jobs, res)]
        gate_jobs.clear()
        return out

    # ---- 3. K3 against its twin ----
    phase("K3 reconstruct vs twin")
    rng = np.random.default_rng(1234)
    k3_err = 0.0
    for H, W in ((1024, 1024), (1024, 1000)):
        color = rng.random((H, W, 3), dtype=np.float32) * 2.0
        color[rng.random((H, W)) < 1e-3] = np.nan
        normal = rng.standard_normal((H, W, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        so = rng.random(2, dtype=np.float32)
        c = torch.from_numpy(color).to(dev)
        n = torch.from_numpy(normal).to(dev)
        got = prc.reconstruct(c, n, so, block_size=128)
        want = reconstruct_sweep(c, n, torch.zeros_like(c), so, block_size=128)
        k3_err = max(k3_err, check_k3(f"K3 {H}x{W}", got, want))

    # ---- 3b. the native loaders: the OBJ parser and the BVH builder ----
    phase("loaders: the native OBJ parser and BVH builder against python and numpy")
    for path in (SCENE, SCENE_SMALL):
        t0 = time.monotonic()
        nat = load_obj_scene(path, backend="native")  # no fallback: a failed g++ fails here
        t_nat = time.monotonic() - t0
        t0 = time.monotonic()
        why = same_scene(load_obj_scene(path, backend="python"), nat)
        t_py = time.monotonic() - t0
        if why:
            fail(f"{os.path.basename(path)}: the native parser's {why} differ from the Python parser's")
        print(f"{os.path.basename(path)}: {nat.bulk_tris.shape[0]} triangles, native parser "
              f"{t_nat:.4f} s (its g++ build included on the first), Python parser {t_py:.4f} s; "
              f"equal arrays and materials", flush=True)
    scene = load_obj_scene(SCENE, backend="native")
    scene.put_cbox_spheres()
    cs, t_cn, t_bn = compile_with(scene, "native")
    cs_np, t_cp, t_bp = compile_with(scene, "numpy")
    why = same_compiled(cs, cs_np)
    if why:
        fail(f"meshbox + spheres: the native builder's compiled {why} differs from the numpy builder's")
    print(f"meshbox + spheres compiled with the native BVH builder in {t_cn:.3f} s (builds "
          f"{t_bn:.4f} s), with the numpy builder in {t_cp:.3f} s (builds {t_bp:.4f} s): every "
          f"array equal", flush=True)
    del cs_np

    # ---- 4. quick gates: every megakernel launch against the twin ----
    phase("K1/K2/K4/K5 megakernel vs twin, 64x64")
    print(f"scene: {cs.num_triangles} triangles, {cs.num_spheres} spheres, "
          f"{cs.trace_rows_mega.shape[0]} trace rows, {cs.mega_num_tables_static} table(s)")
    S = 64
    ms_small = mk.mega_scene(cs, S, S, dev)
    frame = np.random.default_rng(99)
    y, x = np.mgrid[0:S, 0:S]
    jit = frame.random((3, 2), dtype=np.float32)
    pxs = torch.from_numpy(np.stack([(x + j[0]).ravel() for j in jit]).astype(np.float32)).to(dev)
    pys = torch.from_numpy(np.stack([(y + j[1]).ravel() for j in jit]).astype(np.float32)).to(dev)
    sds = frame.integers(0, 1 << 32, size=(3, S * S), dtype=np.uint32)
    sds = torch.from_numpy(sds.view(np.int32)).to(dev)  # the u32 bits
    px, py, seeds = pxs[0].contiguous(), pys[0].contiguous(), sds[0].contiguous()

    k1 = mk.megakernel_start(ms_small, px, py, seeds, 5)
    gate_twin("K1 (cap 5)", "mk_start", ms_small, (px, py, seeds, 5), k1)
    st0, rng0 = k1
    gate_twin("K2 (resume to 24)", "mk_resume", ms_small, (st0, rng0, 24),
              mk.megakernel_resume(ms_small, st0, rng0, 24))
    k5 = mk.megakernel_tiles(ms_small, px, py, seeds, 24)
    gate_twin("K5 (single launch to 24)", "mk_tiles", ms_small, (px, py, seeds, 24), k5)
    k1_full = mk.megakernel_start(ms_small, px, py, seeds, 24)
    if not (torch.equal(k5[0], k1_full[0][list(mk._TILE_CH)]) and torch.equal(k5[1], k1_full[1])):
        fail("K5 and K1 at cap max_bounces disagree")
    print("K5 == K1 at cap max_bounces on every channel and RNG state")
    gate_twin("K4 (3 samples, cap 8)", "mk_start_chained", ms_small, (pxs, pys, sds, 8),
              mk.megakernel_start_chained(ms_small, pxs, pys, sds, 8))
    full = mk.render_tiles(ms_small, px, py, seeds, max_bounces=24)
    waves = mk.render_waves(ms_small, px, py, seeds, max_bounces=24, phase_bounces=(5, 12))
    if not torch.equal(full[3], waves[3]):
        fail("render_waves (phases) and render_tiles (one launch) disagree on RNG states")
    print("render_waves == render_tiles on every RNG state")
    ch = mk.render_waves_chained(ms_small, pxs, pys, sds, max_bounces=24, chain_cap=8)
    if int(ch[4]) != 0:
        fail("render_waves_chained overflowed at 64x64")
    for s in range(3):
        ref = mk.render_waves(ms_small, pxs[s].contiguous(), pys[s].contiguous(),
                              sds[s].contiguous(), max_bounces=24)
        for i in (0, 1, 2, 3, 5, 7):
            if not torch.equal(ch[i][s], ref[i]):
                fail(f"render_waves_chained output {i} of sweep {s} differs from render_waves")
    print("render_waves_chained == 3 separate render_waves, bit for bit per sweep "
          "(total, normal, depth, RNG, segs, albedo)")

    phase("K6 trace-row walk vs twin, 64x64")
    csd = to_device(cs, dev)
    cam = camera_rays(csd.cam_position, csd.cam_rotation, csd.cam_fov, torch.stack([px, py], -1),
                      (S, S))
    gen = np.random.default_rng(7)
    lo, hi = (b[0].cpu().numpy() for b in (csd.bvh_aabb_min, csd.bvh_aabb_max))
    rdir = gen.standard_normal((S * S, 3)).astype(np.float32)
    rdir /= np.linalg.norm(rdir, axis=-1, keepdims=True)
    rtmax = np.full(S * S, np.inf, np.float32)
    rtmax[1::5] = gen.random(S * S, dtype=np.float32)[1::5] * 2.0  # finite shadow-like tmax
    rtmax[::7] = -3.0e38  # inactive lanes, as intersect_rows marks them
    rand_rays = [torch.from_numpy(a).to(dev) for a in (
        (lo + (hi - lo) * gen.random((S * S, 3))).astype(np.float32), rdir,
        np.full(S * S, 1e-4, np.float32), rtmax)]
    for label, rays in (("camera", [c.contiguous() for c in cam]), ("random", rand_rays)):
        for any_hit in (False, True):
            got = pt.traverse(csd.trace_rows, *rays, any_hit=any_hit)
            want = pt.traverse_plain(csd.trace_rows, *rays, any_hit=any_hit)
            if not torch.equal(got, want):
                fail(f"K6 ({label} rays, any_hit={any_hit}) differs from its twin")
            print(f"K6 {label} rays, any_hit={any_hit}: bit-equal to the twin on all 7 outputs of "
                  f"{S * S} rays; {float((got[1] > 0).float().mean()):.4f} hit, "
                  f"{float(got[6].mean()):.2f} rows visited per ray")
        # a hit at exactly tmax: tmax at each hitting ray's closest t
        closest = pt.traverse(csd.trace_rows, *rays)
        at = rays[:3] + [torch.where(closest[1] > 0, closest[0], rays[3])]
        occ = {}
        for inclusive in (False, True):
            got = pt.traverse(csd.trace_rows, *at, any_hit=True, inclusive=inclusive)
            want = pt.traverse_plain(csd.trace_rows, *at, any_hit=True, inclusive=inclusive)
            if not torch.equal(got, want):
                fail(f"K6 ({label} rays, tmax at the closest hit, inclusive={inclusive}) "
                     "differs from its twin")
            occ[inclusive] = got[1] > 0
        if not bool((occ[True] & ~occ[False]).any()):
            fail(f"K6 ({label} rays, tmax at the closest hit): no ray tells the strict any-hit "
                 "from the inclusive one")
        print(f"K6 {label} rays, tmax = the closest hit's t: strict and inclusive any-hit each "
              f"bit-equal to the twin; occluded {int(occ[False].sum())} strict, "
              f"{int(occ[True].sum())} inclusive of {int((closest[1] > 0).sum())} hitting rays")

    phase("K8 sort_tiles vs plain; K7: the sorted K1/K2/K5 vs plain and vs unsorted, 64x64")
    gen = np.random.default_rng(8)
    n8 = srt.TILE

    def key_set(t):
        kind = t % 5
        if kind == 0:
            return gen.integers(0, 5000, n8)
        if kind == 1:  # heavy ties with dead keys, the shape of the lane-sort key
            k = gen.integers(0, 8, n8)
            k[gen.random(n8) < 0.3] = 1 << 20
            return k
        if kind == 2:
            return np.full(n8, 7)
        k = np.sort(gen.integers(0, 5000, n8))
        return k if kind == 3 else k[::-1]

    T8, C8 = 1024, mk.N_STATE + 2
    key8 = torch.from_numpy(np.stack([key_set(t) for t in range(T8)]).astype(np.int32)).to(dev)
    ch8 = torch.from_numpy(gen.integers(-2**31, 2**31 - 1, (C8, T8, n8)).astype(np.int32)).to(dev)
    got8 = srt.sort_tiles(key8, ch8)
    if not bit_equal(got8, srt.sort_tiles_plain(key8, ch8)):
        fail("K8 sort_tiles differs from its plain version")
    print(f"K8 sort_tiles: {T8} tiles x {n8} lanes x {C8} channels bit-equal to the plain version "
          "(random, ties with dead keys, all equal, sorted, reversed)")
    for name, entry, args, un in (("K1", "mk_start", (px, py, seeds, 5), k1),
                                  ("K2", "mk_resume", (st0, rng0, 24), None),
                                  ("K5", "mk_tiles", (px, py, seeds, 24), k5)):
        real_fn = getattr(mk, f"megakernel_{entry[3:]}")
        got = real_fn(ms_small, *args, lane_sort=True, lane_order=True)
        gate_twin(f"{name} sorted (cap {args[-1]})", entry, ms_small, args, got,
                  dict(lane_sort=True, lane_order=True))
        if not bit_equal(got[:2], real_fn(ms_small, *args) if un is None else un):
            fail(f"the sorted {name} differs from the unsorted kernel")
    print("sorted K1/K2/K5 == the unsorted kernels bit for bit on every channel (segs, rows "
          "included) and RNG state")
    stuck = torch.arange(S * S, device=dev) % 3 == 0
    bb = np.asarray(cs.bbox_static, np.float64)
    st_key = key_test_state(st0, stuck, 8, bb[:3], bb[3:], 17)  # the others resume from 5 to 8
    got = mk.megakernel_resume(ms_small, st_key, rng0, 8, lane_sort=True, lane_order=True)
    check_order("K2 sorted, a third of the lanes alive at the cap with NaN, inf, 1e30, box-bound "
                "and outside origins", mk, ms_small, got,
                mk.megakernel_resume_plain(ms_small, st_key, rng0, 8, lane_sort=True, lane_order=True))
    if not bit_equal(got[:2], mk.megakernel_resume(ms_small, st_key, rng0, 8)):
        fail("the sorted K2 differs from the unsorted kernel on the key-test state")

    # ---- 4b. the trace-row formats, the boxes and the shadow table ----
    phase("K1/K2/K4/K5 vs twin on each packed format (meshbox_small, 128x128), with the "
          "shadow table and without the boxes (meshbox, 64x64)")
    small_scene = load_obj_scene(SCENE_SMALL)
    small_scene.put_cbox_spheres()
    fmt_err = {k: 0.0 for k in ("mk_start", "mk_resume", "mk_tiles", "mk_start_chained")}
    # the formats each kernel was held to its twin on (phase 4: classic rows
    # with the boxes of JAX's default compile)
    held = {k: ["classic+boxes"] for k in fmt_err}

    # the configurations phase 4c runs the occlusion cache on: {label:
    # (launch scene, its inputs)}
    cache_cfgs = {"classic+boxes": (ms_small, (px, py, seeds, pxs, pys, sds))}

    def hold_formats(label, ms_f, fpx, fpy, fseeds, fpxs, fpys, fsds):
        """K1 (cap 5), K2 (resume to GATE_CAP), K5 (to GATE_CAP), K4
        (GATE_SAMPLES samples, chain cap 8) against their twins (bit for
        bit), the sorted K1/K2/K5 bit-equal to the unsorted kernels; keeps
        the configuration for phase 4c and returns K1's output."""
        fpxs, fpys, fsds = fpxs[:GATE_SAMPLES], fpys[:GATE_SAMPLES], fsds[:GATE_SAMPLES]
        f1 = mk.megakernel_start(ms_f, fpx, fpy, fseeds, 5)
        runs = (("mk_start", (fpx, fpy, fseeds, 5), f1),
                ("mk_resume", (*f1, GATE_CAP), None),
                ("mk_tiles", (fpx, fpy, fseeds, GATE_CAP), None),
                ("mk_start_chained", (fpxs, fpys, fsds, 8), None))
        outs = []
        for name, args, got in runs:
            got = getattr(mk, f"megakernel_{name[3:]}")(ms_f, *args) if got is None else got
            gate_twin(f"{label} {name}", name, ms_f, args, got, group=("4b", label))
            outs.append(got)
            held[name].append(label)
        for fn, args, un in ((mk.megakernel_start, (fpx, fpy, fseeds, 5), f1),
                             (mk.megakernel_resume, (*f1, GATE_CAP), outs[1]),
                             (mk.megakernel_tiles, (fpx, fpy, fseeds, GATE_CAP), outs[2])):
            if not bit_equal(fn(ms_f, *args, lane_sort=True), un):
                fail(f"{label}: the sorted {fn.__name__} differs from the unsorted kernel")
        print(f"{label}: the sorted K1/K2/K5 bit-equal to the unsorted kernels", flush=True)
        if not ms_f.shadow_tbl:
            cache_cfgs[label] = (ms_f, (fpx, fpy, fseeds, fpxs, fpys, fsds))
        return f1

    F_ = 128
    fy, fx = np.mgrid[0:F_, 0:F_]
    fpxs = torch.from_numpy(np.stack([(fx + j[0]).ravel() for j in jit]).astype(np.float32)).to(dev)
    fpys = torch.from_numpy(np.stack([(fy + j[1]).ravel() for j in jit]).astype(np.float32)).to(dev)
    fsds = torch.from_numpy(frame.integers(0, 1 << 32, size=(3, F_ * F_), dtype=np.uint32)
                            .view(np.int32)).to(dev)
    fpx, fpy, fseeds = fpxs[0].contiguous(), fpys[0].contiguous(), fsds[0].contiguous()
    for fmt, label in ((1, "slim"), (3, "packed3"), (4, "packed4"), (12, "packed12")):
        cs_f = compile_scene(small_scene, packed_leaf=fmt)
        if cs_f.mega_packed_static != fmt or cs_f.mega_num_tables_static != 8:
            fail(f"meshbox_small at packed_leaf={fmt}: format {cs_f.mega_packed_static}, "
                 f"{cs_f.mega_num_tables_static} tables")
        print(f"{label}: {tuple(cs_f.trace_rows_mega.shape)} rows (8 walk tables of "
              f"{cs_f.mega_tbl_rows_static} + {cs_f.mega_pay_rows_static} payload rows)")
        hold_formats(label, mk.mega_scene(cs_f, F_, F_, dev), fpx, fpy, fseeds, fpxs, fpys, fsds)
    ms_tbl = mk.launch_scene(ms_small, shadow_tbl=True)
    print(f"shadow_tbl: meshbox's dedicated table, {ms_tbl.shadow_n} PACKED3 rows")
    t1 = hold_formats("shadow_tbl", ms_tbl, px, py, seeds, pxs, pys, sds)
    off = mk.megakernel_start(mk.launch_scene(ms_small, shadow_vis=False), px, py, seeds, 5)
    keep = [i for i in range(mk.N_STATE) if i != mk._STATE_CH.index("rows")]
    for label, got in (("shadow_tbl", t1), ("boxes", k1)):
        if not (bit_equal([got[0][keep], got[1]], [off[0][keep], off[1]])
                and float(got[0][23].sum()) < float(off[0][23].sum())):
            fail(f"K1 with {label}: not bit-equal to K1 without the boxes but for fewer rows")
    print(f"K1 (cap 5) rows visited at 64x64: {float(off[0][23].sum()):.0f} without the boxes, "
          f"{float(k1[0][23].sum()):.0f} with them, {float(t1[0][23].sum()):.0f} with them and the "
          "shadow table; every other channel and the RNG bit-equal")
    hold_formats("noboxes", mk.launch_scene(ms_small, shadow_vis=False), px, py, seeds, pxs, pys, sds)

    # ---- 4c. the shadow-ray occlusion cache and the skip-all probe ----
    phase("4c: K1/K2/K4/K5 with the occlusion cache vs their cache-on twins and vs the "
          "cache-off kernels, on classic (boxes on, off), SLIM, PACKED3/4/12; skip-all")
    rows_ch = mk._STATE_CH.index("rows")
    keep = [i for i in range(mk.N_STATE) if i != rows_ch]
    cache_err = {k: 0.0 for k in fmt_err}
    cache_moved = {}  # config: paths whose K1 rows the cache moved

    def but_rows(name, out):
        """A launch's outputs without its rows counter (state channel 23;
        K4: pool channel 23 and flush channel 8); K5 has none."""
        if name in ("mk_start", "mk_resume"):
            return [out[0][keep], out[1]]
        if name == "mk_start_chained":
            return [out[0][keep], out[1], out[2][[c for c in range(mk.CHAIN_OUT_CH) if c != 8]]]
        return list(out)

    for label, (ms_off, (fpx, fpy, fseeds, fpxs, fpys, fsds)) in cache_cfgs.items():
        ms_f = mk.launch_scene(ms_off, ms_off.shadow_vis, shadow_cache=True)
        off1 = mk.megakernel_start(ms_off, fpx, fpy, fseeds, 5)
        on1 = mk.megakernel_start(ms_f, fpx, fpy, fseeds, 5)
        calls = (("mk_start", (fpx, fpy, fseeds, 5), off1, on1),
                 ("mk_resume", (*on1, GATE_CAP), None, None),
                 ("mk_tiles", (fpx, fpy, fseeds, GATE_CAP), None, None),
                 ("mk_start_chained", (fpxs[:GATE_SAMPLES], fpys[:GATE_SAMPLES],
                                       fsds[:GATE_SAMPLES], 8), None, None))
        outs = {}
        for name, args, off, on in calls:
            kern = getattr(mk, f"megakernel_{name[3:]}")
            on = kern(ms_f, *args) if on is None else on
            off = kern(ms_off, *args) if off is None else off
            gate_twin(f"4c {label} {name} cache on", name, ms_f, args, on, group=("4c", label))
            if not bit_equal(but_rows(name, on), but_rows(name, off)):
                fail(f"4c {label} {name}: the cache-on kernel differs from the cache-off one "
                     "beyond the rows counter")
            outs[name] = on
            if name in ("mk_start", "mk_resume"):  # paths whose rows the cache moved
                cache_moved[label] = (cache_moved.get(label, 0)
                                      + int((on[0][rows_ch] != off[0][rows_ch]).sum()))
        for fn, args, name in ((mk.megakernel_start, (fpx, fpy, fseeds, 5), "mk_start"),
                               (mk.megakernel_resume, (*on1, GATE_CAP), "mk_resume"),
                               (mk.megakernel_tiles, (fpx, fpy, fseeds, GATE_CAP), "mk_tiles")):
            got = fn(ms_f, *args, lane_sort=True, lane_order=True)
            if not bit_equal(got[:2], outs[name]):
                fail(f"4c {label}: the sorted {name} with the cache differs from the unsorted one")
            # the cache moves no path's key, so the order record is the
            # cache-off kernel's (phase 4 held that one to the sorted plain
            # version on the classic rows, tests/test_torch_cuda.py on each
            # format)
            if not torch.equal(got[2], fn(ms_off, *args, lane_sort=True, lane_order=True)[2]):
                fail(f"4c {label}: the sorted {name}'s order record with the cache differs from "
                     "the one without")
        print(f"4c {label}: K1/K2/K4/K5 with the cache bit-equal to the cache-off kernels but "
              f"for rows (K1's and K2's rows moved on {cache_moved[label]} of {2 * fpx.numel()} "
              f"paths; K1 {float(on1[0][rows_ch].sum()):.0f} against "
              f"{float(off1[0][rows_ch].sum()):.0f}); the sorted K1/K2/K5 with the cache bit-equal "
              "to the unsorted ones, their order records the cache-off kernels'", flush=True)
        for name in cache_err:
            held[name].append(f"{label}+cache")
    for what, call in (
            ("shadow_tbl with shadow_cache", lambda: mk.render_tiles(
                ms_small, px, py, seeds, max_bounces=4, shadow_tbl=True, shadow_cache=True)),
            ("shadow_skip_all with shadow_cache", lambda: mk.render_waves(
                ms_small, px, py, seeds, max_bounces=4, shadow_cache=True, shadow_skip_all=True))):
        try:
            call()
        except ValueError as e:
            print(f"4c {what}: ValueError ({e})")
        else:
            fail(f"4c {what} did not raise")
    # skip-all: render_waves' K1/K2 calls replayed through their twins
    ms_skip = mk.launch_scene(ms_small, shadow_skip_all=True)
    skip_calls = record_calls(mk, ("mk_start", "mk_resume"), lambda: mk.render_waves(
        ms_small, px, py, seeds, max_bounces=24, shadow_skip_all=True))
    real_any, shadow_nit = mk._trace_any, []

    def counted_any(*a, **kw):
        hit, nit, row = real_any(*a, **kw)
        shadow_nit.append(float(nit.max()) if nit.numel() else 0.0)
        return hit, nit, row

    mk._trace_any = counted_any
    try:
        for name, args in skip_calls:
            got = getattr(mk, f"megakernel_{name[3:]}")(ms_skip, *args)
            want = getattr(mk, f"megakernel_{name[3:]}_plain")(ms_skip, *args)
            if not bit_equal(got, want):
                fail(f"4c skip-all {name}: the kernel differs from its twin")
    finally:
        mk._trace_any = real_any
    if max(shadow_nit) != 0.0:
        fail("4c skip-all: a shadow walk visited a row")
    print(f"4c render_waves(shadow_skip_all=True) at {S}x{S}: its {len(skip_calls)} K1/K2 calls "
          "bit-equal to their twins, every shadow walk 0 rows", flush=True)

    # ---- 5. the paths ----
    def drive(label, fn):
        """Run one path with every launch count set to 0 just before;
        returns (its result, the counts just after)."""
        phase(label)
        counters = (mk.LAUNCHES, prc.LAUNCHES, pt.LAUNCHES, srt.LAUNCHES, pab.LAUNCHES,
                    pwk.LAUNCHES, pcl.LAUNCHES, pk9.LAUNCHES, pvi.LAUNCHES, pvd.LAUNCHES)
        for d in counters:
            for k in d:
                d[k] = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for d in counters for k, v in d.items()}

    def check_render(name, r, metrics, counts, kernels):
        film = r.film.cpu().numpy()
        print(f"{name}: {metrics['render_seconds']:.4f} s, {metrics['mrays_per_second']:.4f} Mrays/s, "
              f"{metrics['spp_per_second']:.3f} spp/s, chunk {metrics['chain_chunk_sweeps']} sweeps, "
              f"mean path {metrics.get('mean_path_length', 0):.3f} segments, overflow "
              f"{metrics['wave_overflow']} (retried {metrics['overflow_retried']}), launches {counts}")
        if not np.isfinite(film).all():
            fail(f"{name}: film has non-finite values")
        if not r.image().mean() > 0:
            fail(f"{name}: mean radiance is not > 0")
        if metrics["wave_overflow"] != 0:
            fail(f"{name}: overflow != 0")
        for k in kernels:
            if counts[k] <= 0:
                fail(f"{name}: kernel {k} was not launched by this path")

    # (n) and (r) run while the twin workers finish the gates of phases
    # 4-4c (neither is timed; (r) queues its oracle sweeps behind them);
    # the gates are collected before the first timed path
    out_dir = os.path.join(HERE, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    phase("(n) two processes on cuda:0 over gloo: MultiHostMegaRenderer 256x256, 4 spp")
    merged, counts_n = two_process_render(out_dir)
    rn = Renderer(cs, RenderConfig(**HOSTS_CFG), device="cuda")
    rn.render()
    fn = rn.film.cpu().numpy()
    print(f"(n) merged film against the single 256x256 film: max abs err "
          f"{np.abs(merged - fn).max():.3e}; launches in the two processes {counts_n}")
    if not np.isfinite(merged).all() or not np.allclose(merged, fn, rtol=1e-4, atol=1e-5):
        fail("(n) the merged film differs from the single one beyond rtol 1e-4 / atol 1e-5")
    for k in ("mk_start", "mk_resume", "reconstruct_weighted"):
        if counts_n[k] <= 0:
            fail(f"(n) the two processes did not launch {k}")

    # ---- (r) the oracle gate at equal seeds ----
    # the native scalar oracle (every primitive by brute force: no trace
    # row, box or cache of the kernels') on the twin workers' CPUs, one
    # sweep a job, while the card renders the same seeds and jitter through
    # the chained (K4 + K2), unchained (K1 + K2) and sync (K6) drivers
    from hijiki_tpu_torch.ops.oracle import host_scene
    from hijiki_tpu_torch.ops.oracle_native import load_library as oracle_library

    if oracle_library() is None:
        fail("(r) the native oracle did not build (g++)")
    r_seeds, r_offs = equal_seed_inputs(ORACLE_SIDE, ORACLE_SPP, 0)
    t_r = time.monotonic()
    cs_host = host_scene(cs)
    r_jobs = [twin_pool.submit(oracle_sweep, cs_host, sd, of, ORACLE_SIDE)
              for sd, of in zip(r_seeds, r_offs)]
    r_films, counts_r = drive(
        f"(r) the oracle gate: {ORACLE_SIDE}x{ORACLE_SIDE}, {ORACLE_SPP} sweeps of seed 0, "
        "max_bounces 1000: the chained, unchained and sync drivers against the native oracle",
        lambda: driver_films(cs, r_seeds, r_offs, ORACLE_SIDE, dev))
    t_drivers = time.monotonic() - t_r
    r_out = [j.result() for j in r_jobs]
    r_films["oracle"] = in_sweep_order([f for f, _ in r_out])
    print(f"(r) drivers {t_drivers:.1f} s on the card; the oracle's {ORACLE_SPP} sweeps "
          f"{sum(t for _, t in r_out):.1f} s of CPU in {TWIN_WORKERS} processes, "
          f"{time.monotonic() - t_r:.1f} s of wall in all; launches {counts_r}", flush=True)
    for k in ("mk_start_chained", "mk_resume", "mk_start", "traverse"):
        if counts_r[k] <= 0:
            fail(f"(r): kernel {k} was not launched")
    for name, film in r_films.items():
        if not (np.isfinite(film).all() and film.mean() > 0):
            fail(f"(r) the {name} film is not finite with a mean > 0")
    n_px = ORACLE_SIDE * ORACLE_SIDE
    for a, b in (("oracle", "chained"), ("oracle", "unchained"), ("oracle", "sync"),
                 ("chained", "sync"), ("oracle", "sync_mega_camera")):
        r = readings(r_films[a], r_films[b])
        why = breaks_bar(r, n_px)
        print(f"(r) {a}-{b}: raw MSE {r[0]:.6e}, divergent pixels {r[1]}/{n_px} (per-pixel "
              f"MSE > {DIVERGENT_PX:g}), trimmed MSE {r[2]:.6e}: "
              f"{'meets the bar' if not why else 'breaks the bar: ' + why}", flush=True)
        if why and (a, b) in (("oracle", "chained"), ("oracle", "sync")):
            fail(f"(r) {a}-{b} breaks the equal-seed bar: {why}")
    del r_films, r_out, cs_host

    # the plain versions of phases 4-4c, run meanwhile in the twin workers
    phase("the gates of phases 4-4c: their plain versions collected from the twin workers")
    t_gates = time.monotonic()
    gates = collect_gates()
    pre_of = {}
    for name, group, err, pre in gates:
        if group and group[0] == "4b":
            fmt_err[name] = max(fmt_err[name], err)
        elif group:
            cache_err[name] = max(cache_err[name], err)
            pre_of[group[1]] = tuple(a + b for a, b in zip(pre_of.get(group[1], (0, 0)), pre))
    # predictions the cache-on twins (held to the kernels bit for bit, rows
    # included) tested, and those that verified: answered without a walk
    for cfg in cache_cfgs:
        tried, verified = pre_of.get(cfg, (0, 0))
        if verified <= 0:
            fail(f"4c {cfg}: none of the {tried} predictions tested verified: the cache never "
                 "answered a shadow ray")
        print(f"4c {cfg}: the cache-on twins tested {tried} predictions, {verified} verified")
    print(f"phases 4-4c: {len(gates)} plain versions in {TWIN_WORKERS} twin workers, "
          f"{time.monotonic() - t_gates:.1f} s waited for after (n) and (r)", flush=True)

    slice_cfg = dict(width=1024, height=1024, spp=8, max_bounces=1000, block_size=128,
                     use_bvh=True, driver="mega")
    ra = Renderer(cs, RenderConfig(**slice_cfg), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ma, counts_a = drive("(a) chained slice: Renderer(device='cuda') 1024x1024, 8 spp, "
                         "chaining auto", ra.render)
    peak = torch.cuda.max_memory_allocated()
    check_render("(a) chained", ra, ma, counts_a, ("mk_start_chained", "mk_resume", "reconstruct"))
    if ma["chain_chunk_sweeps"] != mk.CHAIN_SWEEPS_CUDA:
        fail(f"auto chaining resolved to {ma['chain_chunk_sweeps']} sweeps, not {mk.CHAIN_SWEEPS_CUDA}")
    if counts_a["reconstruct"] != -(-slice_cfg["spp"] // mk.CHAIN_SWEEPS_CUDA):
        fail(f"(a) launched K3 {counts_a['reconstruct']} times, not once a chained chunk")
    print(f"(a) peak device memory {peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated)")
    exr = os.path.join(out_dir, "slice.exr")
    ra.save_exr(exr)
    img = ra.image()
    back = read_exr(exr)
    if back.shape != (1024, 1024, 3) or not np.array_equal(back, img.astype(np.float32)):
        fail("EXR round trip changed the image")
    print(f"EXR written and read back: mean {float(back.mean()):.5f}")

    rb = Renderer(cs, RenderConfig(**slice_cfg, chain_sweeps=1), device="cuda")
    mb, counts_b = drive("(b) unchained slice: chain_sweeps=1, 1024x1024, 8 spp", rb.render)
    check_render("(b) unchained", rb, mb, counts_b, ("mk_start", "mk_resume", "reconstruct"))
    fa, fb = ra.film.cpu().numpy(), rb.film.cpu().numpy()
    if not np.allclose(fa, fb, rtol=1e-5, atol=1e-6):
        fail(f"chained and unchained films differ: max abs {np.abs(fa - fb).max():.3e}")
    print(f"(a) vs (b) films: max abs diff {np.abs(fa - fb).max():.3e} (rtol 1e-5 / atol 1e-6)")

    ri = Renderer(cs, RenderConfig(**slice_cfg, sort_lanes=True), device="cuda")
    mi, counts_i = drive("(i) lane-sorted slice: sort_lanes=True, 1024x1024, 8 spp", ri.render)
    check_render("(i) sorted", ri, mi, counts_i, ("mk_start_sorted", "mk_resume_sorted", "reconstruct"))
    if mi["chain_chunk_sweeps"] != 1 or counts_i["mk_start"] or counts_i["mk_resume"]:
        fail("(i) the sorted slice chained or launched an unsorted megakernel")
    if not torch.equal(ri.film, rb.film):
        fail("(i) the lane-sorted film differs from the unsorted film (b)")
    print(f"(i) film == (b)'s bit for bit; {mi['render_seconds'] / 8:.4f} s per sweep against (b)'s "
          f"{mb['render_seconds'] / 8:.4f} s")

    # (a0) (a)'s scene without the boxes; (o) (a)
    # with the dedicated shadow table. Each film bit-equal to (a)'s.
    cs0 = compile_scene(scene, shadow_vis_boxes=False)
    ra0 = Renderer(cs0, RenderConfig(**slice_cfg), device="cuda")
    ma0, counts_a0 = drive("(a0) (a) without the shadow-visibility boxes: 1024x1024, 8 spp",
                           ra0.render)
    check_render("(a0) no boxes", ra0, ma0, counts_a0, ("mk_start_chained", "mk_resume", "reconstruct"))
    ro = Renderer(cs, RenderConfig(**slice_cfg, mega_shadow=1), device="cuda")
    mo, counts_o = drive("(o) (a) with the dedicated shadow table (mega_shadow=1): 1024x1024, 8 spp",
                         ro.render)
    check_render("(o) shadow table", ro, mo, counts_o, ("mk_start_chained", "mk_resume", "reconstruct"))
    for name, r_ in (("(a0)", ra0), ("(o)", ro)):
        if not torch.equal(r_.film, ra.film):
            fail(f"{name}'s film differs from (a)'s")
    print("(a0) and (o) films == (a)'s bit for bit")

    # (p) the 2-level split meshbox + spheres (100,384 triangles): JAX's
    # default compile packs it (PACKED4); held bit for bit to the same
    # scene compiled classic at leaf 4 (the same tree)
    from hijiki_tpu_torch.scene.bigscene import split_scene

    big = split_scene(scene, 2)
    compiled_big = {}
    for key, kw in (("(p) PACKED4", {}), ("(p) classic leaf 4", dict(packed_leaf=0, leaf_size=4))):
        cb, secs_c, secs_b = compile_with(big, "native", **kw)
        print(f"{key}: the native BVH builder's builds {secs_b:.3f} s of the compile", flush=True)
        tb_bytes = cb.trace_rows_mega.nbytes + (cb.shadow_rows_mega.nbytes
                                                if cb.shadow_rows_mega is not None else 0)
        print(f"{key}: {cb.num_triangles} triangles compiled in {secs_c:.1f} s; format "
              f"{cb.mega_packed_static}, {tuple(cb.trace_rows_mega.shape)} trace rows, "
              f"{cb.mega_num_tables_static} table(s), {tb_bytes / 2**20:.2f} MiB of tables "
              f"(the shadow table's {0 if cb.shadow_rows_mega is None else cb.shadow_rows_mega.shape[0]} "
              f"rows included), {int(cb.shadow_vis_static[0]) if cb.shadow_vis_static else 0} boxes",
              flush=True)
        compiled_big[key] = cb
    if compiled_big["(p) PACKED4"].mega_packed_static != 4 or big.bulk_tris.shape[0] != 100384:
        fail("(p): the split scene is not 100,384 triangles compiled PACKED4 by auto")
    # the smoke's largest compile through the numpy builder: the same arrays
    cb_np, secs_c, secs_b = compile_with(big, "numpy")
    why = same_compiled(compiled_big["(p) PACKED4"], cb_np)
    if why:
        fail(f"(p): the native builder's compiled {why} differs from the numpy builder's")
    print(f"(p) PACKED4 compiled with the numpy BVH builder in {secs_c:.1f} s (builds "
          f"{secs_b:.3f} s): every array equal to the native builder's compile", flush=True)
    del cb_np
    renders_p = {}
    for key, cb in compiled_big.items():
        rp_ = Renderer(cb, RenderConfig(**slice_cfg), device="cuda")
        mp_, counts_p = drive(f"{key}: 1024x1024, 8 spp, chaining auto", rp_.render)
        check_render(key, rp_, mp_, counts_p, ("mk_start_chained", "mk_resume", "reconstruct"))
        renders_p[key] = rp_
    if not torch.equal(renders_p["(p) PACKED4"].film, renders_p["(p) classic leaf 4"].film):
        fail("(p): the PACKED4 film differs from the classic leaf-4 film")
    print("(p) PACKED4 film == the classic leaf-4 film bit for bit")

    # warm Mrays/s and rows of (a), (a0), (o), (p): fresh renderers in turns
    warm_cfgs = {"(a)": (cs, {}), "(a0)": (cs0, {}), "(o)": (cs, dict(mega_shadow=1)),
                 "(p) PACKED4": (compiled_big["(p) PACKED4"], {}),
                 "(p) classic leaf 4": (compiled_big["(p) classic leaf 4"], {})}
    warm_pr = {k: [] for k in warm_cfgs}
    for _ in range(3):
        for key, (c_, kw) in warm_cfgs.items():
            m_ = Renderer(c_, RenderConfig(**slice_cfg, **kw), device="cuda").render()
            # a chunk's rows_visited is its per-sweep mean: times the sweeps
            warm_pr[key].append((m_["mrays_per_second"],
                                 m_["rows_visited_last_sweep"] * slice_cfg["spp"]))
    for key, v in warm_pr.items():
        rates = [x[0] for x in v]
        print(f"warm {key}: median {float(np.median(rates)):.3f} Mrays/s "
              f"({', '.join(f'{x:.3f}' for x in rates)}), rows visited {v[0][1]:.6e} a render",
              flush=True)
    del renders_p, ra0, ro

    small = dict(width=256, height=256, spp=8, max_bounces=1000, block_size=128, driver="mega")
    rc_ = Renderer(cs, RenderConfig(**small, mega_chain_cap=2, phase_shrink=(9999,)), device="cuda")
    import warnings

    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        mc, counts_c = drive("(c) overflow retry: 256x256, 8 spp, chain cap 2, "
                             "phase_shrink (9999,)", rc_.render)
    check_render("(c) retry", rc_, mc, counts_c, ("mk_start_chained", "mk_resume", "reconstruct"))
    if mc["overflow_retried"] <= 0:
        fail("(c) the pathological capacity dropped no path: the retry was not exercised")
    rc_ref = Renderer(cs, RenderConfig(**small, mega_chain_cap=2, phase_shrink=(1,) * 8),
                      device="cuda")
    rc_ref.render()
    if not torch.equal(rc_.film, rc_ref.film):
        fail("(c) the retried film differs from the full-capacity render")
    print("(c) retried film == the full-capacity render, bit for bit")

    ck = os.path.join(out_dir, "resume.npz")
    ck_cfg = RenderConfig(**small, chain_sweeps=4)
    rd = Renderer(cs, ck_cfg, device="cuda")

    def save_at_4(done, total):
        if done == 4:
            rd.save_checkpoint(ck)

    def checkpoint_and_resume():
        m1 = rd.render(progress=save_at_4)
        resumed = Renderer.resume_checkpoint(cs, ck, ck_cfg, device="cuda")
        return m1, resumed, resumed.render()

    (md, rd2, md2), counts_d = drive("(d) checkpoint at sweep 4 of 8 and resume, 256x256",
                                     checkpoint_and_resume)
    check_render("(d) resumed", rd2, md2, counts_d, ("mk_start_chained", "mk_resume", "reconstruct"))
    if rd2.sweeps_done != 8 or md2["primary_rays"] != 256 * 256 * 4:
        fail("(d) the resumed render did not trace sweeps 4..7")
    if not torch.equal(rd2.film, rd.film):
        fail("(d) the resumed film differs from the uninterrupted render")
    print("(d) resumed film == the uninterrupted render, bit for bit")

    # (l) the mega driver on two row bands of the one card, each on its own
    # stream: K4/K2 per band, the weighted K3 on its extended canvas
    bands = [dev, dev]
    rl = MegaMultiChipRenderer(cs, RenderConfig(**slice_cfg), devices=bands)
    ml, counts_l = drive("(l) two row bands on cuda:0: MegaMultiChipRenderer 1024x1024, 8 spp, "
                         "chaining auto", rl.render)
    check_render("(l) bands", rl, ml, counts_l,
                 ("mk_start_chained", "mk_resume", "reconstruct_weighted"))
    if counts_l["reconstruct"] or ml["devices"] != 2:
        fail("(l) the bands launched the unweighted K3, or did not run on two devices")
    fl = rl.film.cpu().numpy()
    band, R = slice_cfg["height"] // 2, prc.R
    diff = (fl != fa).any(-1)
    near_seam = diff[band - R:band + R].sum()
    print(f"(l) against (a)'s film: max abs err {np.abs(fl - fa).max():.3e}, {int(diff.sum())} "
          f"pixels differ, {int(near_seam)} of them within {R} rows of the seam (rows "
          f"{band - R}..{band + R - 1})")
    if not np.allclose(fl, fa, rtol=1e-4, atol=1e-5):
        fail("(l) the banded film differs from the single film beyond rtol 1e-4 / atol 1e-5")
    # warm rates in this process: fresh renderers in turns, (a) then (l)
    warm = {"(a)": [], "(l)": []}
    for _ in range(3):
        for key, make in (("(a)", lambda: Renderer(cs, RenderConfig(**slice_cfg), device="cuda")),
                          ("(l)", lambda: MegaMultiChipRenderer(cs, RenderConfig(**slice_cfg),
                                                                devices=bands))):
            warm[key].append(make().render()["mrays_per_second"])
    print("warm Mrays/s, 3 renders each in turns: " + "; ".join(
        f"{k} median {float(np.median(v)):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
        for k, v in warm.items()), flush=True)

    H = W = 1024
    yy = torch.arange(H, dtype=torch.float32, device=dev).view(-1, 1).expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev).view(1, -1).expand(H, W)

    def frame_of(sched):
        from hijiki_tpu_torch.ops.rng import to_bits
        from hijiki_tpu_torch.render.blocks import per_pixel_seeds_device

        so = np.asarray(sched.sample_offset, np.float32)
        return ((xx + float(so[0])).reshape(-1).contiguous(),
                (yy + float(so[1])).reshape(-1).contiguous(),
                to_bits(per_pixel_seeds_device(W, H, 128, sched.block_seeds, dev).reshape(-1)),
                so)

    ms = ra.scene
    tpx, tpy, tseeds, _ = frame_of(ra.scheduler.sweep(slice_cfg["spp"]))
    te, counts_e = drive("(e) render_tiles (single launch) over the 1024x1024 frame",
                         lambda: mk.render_tiles(ms, tpx, tpy, tseeds, max_bounces=1000))
    tot = te[0].cpu().numpy()
    print(f"(e) render_tiles: mean radiance {tot.mean():.5f}, launches {counts_e}")
    if not np.isfinite(tot).all() or not tot.mean() > 0 or counts_e["mk_tiles"] <= 0:
        fail("(e) render_tiles: non-finite or dark result, or K5 not launched")
    tes, counts_es = drive("(e) render_tiles lane-sorted over the 1024x1024 frame",
                           lambda: mk.render_tiles(ms, tpx, tpy, tseeds, max_bounces=1000,
                                                   lane_sort=True))
    if counts_es["mk_tiles_sorted"] <= 0 or not bit_equal(tes, te):
        fail("(e) the sorted K5 was not launched or differs from render_tiles")
    print(f"(e) sorted render_tiles == render_tiles bit for bit, launches {counts_es}")

    # (q) the occlusion cache on the chained slice's chunk: render_waves_chained
    # (K4 and K2 with the cache) at (a)'s configuration, one chunk of 8 sweeps,
    # against the same call without it; render_waves and render_tiles with it
    # on one sweep of the frame (K1, K2, K5 with the cache)
    qframes = [frame_of(ra.scheduler.sweep(slice_cfg["spp"] + 40 + s))
               for s in range(mk.CHAIN_SWEEPS_CUDA)]
    qpx, qpy, qseeds = (torch.stack([f[i] for f in qframes]) for i in range(3))

    def cached_paths():
        return (mk.render_waves_chained(ms, qpx, qpy, qseeds, max_bounces=1000, shadow_cache=True),
                mk.render_waves(ms, tpx, tpy, tseeds, max_bounces=1000, shadow_cache=True),
                mk.render_tiles(ms, tpx, tpy, tseeds, max_bounces=1000, shadow_cache=True))

    (tq, wq, eq), counts_q = drive("(q) render_waves_chained(shadow_cache=True) 1024x1024, 8 sweeps, "
                                   "max_bounces 1000, and render_waves, render_tiles with it, one sweep",
                                   cached_paths)
    for k in ("mk_start_chained_cache", "mk_resume_cache", "mk_start_cache", "mk_tiles_cache"):
        if counts_q[k] <= 0:
            fail(f"(q) the cache-on kernel {k} was not launched")
    if any(counts_q[k] for k in mk.LAUNCHES if not k.endswith("_cache")):
        fail(f"(q) a cache-off megakernel was launched: {counts_q}")
    tq_off = mk.render_waves_chained(ms, qpx, qpy, qseeds, max_bounces=1000)
    wq_off = mk.render_waves(ms, tpx, tpy, tseeds, max_bounces=1000)
    for i in (0, 1, 2, 3, 4, 5, 7):  # all but rows (6)
        if not bit_equal([tq[i]], [tq_off[i]]) or not bit_equal([wq[i]], [wq_off[i]]):
            fail(f"(q) output {i} with the cache differs from the one without")
    if not bit_equal(eq, te):
        fail("(q) render_tiles with the cache differs from (e)")
    q_rows = (float(tq[6].sum()), float(tq_off[6].sum()))
    print(f"(q) films, RNG, depth, normals, albedo, segs bit-equal to the calls without the "
          f"cache; rows {q_rows[0]:.6e} against {q_rows[1]:.6e} ({q_rows[0] / q_rows[1] - 1:+.5%}); "
          f"launches {counts_q}")
    q_rays = qpx.numel()
    warm_q = {"cache on": [], "cache off": []}
    for _ in range(3):
        for key, on in (("cache on", True), ("cache off", False)):
            torch.cuda.synchronize()
            t_q = time.monotonic()
            mk.render_waves_chained(ms, qpx, qpy, qseeds, max_bounces=1000, shadow_cache=on)
            torch.cuda.synchronize()
            warm_q[key].append(q_rays / (time.monotonic() - t_q) / 1e6)
    print("(q) warm Mrays/s of the chunk, 3 calls each in turns: " + "; ".join(
        f"{k} median {float(np.median(v)):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
        for k, v in warm_q.items()), flush=True)
    del tq, wq, eq, tq_off, wq_off

    sync_cfg = dict(slice_cfg, driver="sync")
    rf = Renderer(cs, RenderConfig(**sync_cfg), device="cuda")
    snap = {}

    def keep_film(done, total):
        if done == 1:
            snap["first"] = rf.film.clone()
        if done == WAVEFRONT_SWEEPS:
            snap["film"] = rf.film.clone()

    torch.cuda.reset_peak_memory_stats()
    mf, counts_f = drive("(f) sync slice: Renderer(driver='sync', use_bvh=True) 1024x1024, 8 spp",
                         lambda: rf.render(progress=keep_film))
    peak_f = torch.cuda.max_memory_allocated()
    check_render("(f) sync", rf, mf, counts_f, ("traverse", "reconstruct"))
    if any(counts_f[k] for k in mk.LAUNCHES):
        fail(f"(f) the sync slice launched a megakernel: {counts_f}")
    print(f"(f) {mf['render_seconds'] / 8:.4f} s per sweep, {mf['iterations_last_sweep']} bounces "
          f"in the last sweep, peak device memory {peak_f / 2**20:.1f} MiB "
          "(torch.cuda.max_memory_allocated)")
    rf.save_exr(exr)
    if not np.array_equal(read_exr(exr), rf.image().astype(np.float32)):
        fail("(f) EXR round trip changed the image")
    fmean, amean = float(rf.film[..., :3].mean()), float(ra.film[..., :3].mean())
    print(f"(f) film mean {fmean:.6f} against the mega slice's {amean:.6f}: "
          f"rel diff {abs(fmean - amean) / amean:.3e}")
    if abs(fmean - amean) > 1e-3 * amean:
        fail("(f) the sync and mega films' means differ by more than 1e-3 relative")

    # one sweep, path by path: the sync integrator (K6) and the megakernel
    xpx, xpy, xseeds, _ = frame_of(ra.scheduler.sweep(slice_cfg["spp"] + 20))
    xo, xd, xtmin, xtmax = camera_rays(csd.cam_position, csd.cam_rotation, csd.cam_fov,
                                       torch.stack([xpx, xpy], -1), (W, H))
    xs = integrate(csd, xo, xd, xtmin, xtmax, seed_rng(from_bits(xseeds)), max_bounces=1000)
    xm = mk.render_waves(ms, xpx, xpy, xseeds, max_bounces=1000)
    same = (xs.state == from_bits(xm[3])).cpu().numpy()
    close = np.isclose(xs.total.cpu().numpy(), xm[0].cpu().numpy(), rtol=2e-3, atol=2e-3).all(-1)
    print(f"(f) one 1024x1024 sweep, sync (K6) against mega (render_waves), same seeds: RNG equal on "
          f"{same.mean():.4%} of paths, RNG equal and radiance within 2e-3 on "
          f"{(same & close).mean():.4%}; {xs.iterations} sync bounces")
    if (same & close).mean() < 0.995:
        fail("(f) the sync and mega drivers disagree on more than 0.5% of paths")

    wf_cfg = dict(slice_cfg, driver="wavefront", spp=WAVEFRONT_SWEEPS)
    rg = Renderer(cs, RenderConfig(**wf_cfg), device="cuda")
    mg, counts_g = drive(f"(g) wavefront slice: 1024x1024, {1 << 18} lanes, "
                         f"{WAVEFRONT_SWEEPS} sweeps", rg.render)
    check_render("(g) wavefront", rg, mg, counts_g, ("traverse", "reconstruct"))
    fg, fs = rg.film.cpu().numpy(), snap["film"].cpu().numpy()
    print(f"(g) {mg['render_seconds'] / WAVEFRONT_SWEEPS:.4f} s per sweep, "
          f"{mg['iterations_last_sweep']} pool iterations in the last sweep; film against the sync "
          f"film of the same sweeps: max abs diff {np.abs(fg - fs).max():.3e}, "
          f"bit-equal {np.array_equal(fg, fs)}")
    if not np.allclose(fg, fs, rtol=1e-4, atol=2e-4):
        fail("(g) the wavefront film differs from the sync film beyond rtol 1e-4 / atol 2e-4")

    _, counts_j = drive("(j) K8 alone: sort_tiles, 1M lanes x 31 channels",
                        lambda: srt.sort_tiles(key8, ch8))
    if counts_j["sort_tiles"] <= 0:
        fail("(j) sort_tiles was not launched")

    # (s) the JAX package's call forms at small shapes: each bit-equal to
    # the port's own form on the same inputs
    def jax_forms():
        cs_s = scene_to_device(cs, dev)
        walker = dict(packet=1024, groups=4, table_in_hbm=True, hbm_window=4, trunk_rows=64,
                      spec_resolve=True, prefetch=False)
        mk.BAKES["mega_scene"] = 0
        t0 = time.monotonic()
        jc = pmk.render_waves_chained(cs_s, pxs, pys, sds, width=S, height=S, max_bounces=1000,
                                      **walker)
        t_bake = time.monotonic() - t0
        if not bit_equal(jc, mk.render_waves_chained(ms_small, pxs, pys, sds, max_bounces=1000)):
            fail("(s) render_waves_chained's JAX form differs from the MegaScene form")
        def wall_ms(fn):
            """(host milliseconds of ``fn`` to its last kernel's end, its result)"""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0), out

        t_jax, t_ms = [], []
        for rep in range(3):
            for s_ in range(pxs.shape[0]):
                args = (pxs[s_].contiguous(), pys[s_].contiguous(), sds[s_].contiguous())
                t_j, jw = wall_ms(lambda: pmk.render_waves(cs_s, *args, width=S, height=S,
                                                           max_bounces=1000, **walker))
                t_m, mw = wall_ms(lambda: mk.render_waves(ms_small, *args, max_bounces=1000))
                if not bit_equal(jw, mw):
                    fail(f"(s) render_waves' JAX form differs from the MegaScene form "
                         f"(sweep {s_})")
                t_jax.append(t_j)
                t_ms.append(t_m)
        if mk.BAKES["mega_scene"] != 1:
            fail(f"(s) the JAX form baked {mk.BAKES['mega_scene']} times over its calls, not once")
        # what the JAX form adds to a call on the host: the cached bake's
        # lookup and the walker check
        t0 = time.perf_counter()
        for _ in range(1000):
            ms_s = mk.scene_of(cs_s, S, S, dev)
            mk._check_walker(False, 1024, False, ms_s, True, False)
        t_lookup = 1e3 * (time.perf_counter() - t0)
        print(f"(s) render_waves_chained and 9 x render_waves on a scene_to_device scene with "
              f"{walker}: bit-equal to the MegaScene form; 1 bake (the first call "
              f"{1e3 * t_bake:.3f} ms, bake included); render_waves to its last kernel's end, "
              f"host clock, median of 9 in turns: JAX form {float(np.median(t_jax)):.3f} ms, "
              f"MegaScene form {float(np.median(t_ms)):.3f} ms; the bake's lookup and the "
              f"walker check {t_lookup:.2f} us a call (mean of 1000)", flush=True)
        so = torch.tensor([0.25, 0.75])
        t_, n_ = jc[0][0].reshape(S, S, 3).contiguous(), jc[1][0].reshape(S, S, 3).contiguous()
        if not torch.equal(prc.reconstruct_pallas(t_, n_, so, block_size=64, interpret=True),
                           prc.reconstruct(t_, n_, so, block_size=64)):
            fail("(s) reconstruct_pallas differs from reconstruct")
        gen = np.random.default_rng(16)
        key = torch.from_numpy(gen.integers(0, 64, (8, 128)).astype(np.int32)).to(dev)
        chans = [torch.from_numpy(gen.integers(-2**31, 2**31 - 1, (8, 128)).astype(np.int32)).to(dev),
                 torch.from_numpy(gen.standard_normal((8, 128)).astype(np.float32)).to(dev)]
        skey, sch = psort.sort_tile_by_key(key, chans)
        wkey, wch = srt.sort_tiles_plain(key.reshape(1, -1),
                                         torch.stack([c.view(torch.int32) for c in chans])
                                         .reshape(2, 1, -1))
        if not (torch.equal(skey.reshape(1, -1), wkey)
                and bit_equal([c.reshape(1, -1) for c in sch], list(wch))
                and sch[1].dtype == torch.float32):
            fail("(s) sort_tile_by_key (K8) differs from its plain version")
        print("(s) reconstruct_pallas == reconstruct (K3); sort_tile_by_key (K8) on an (8,128) "
              "tile with an int32 and an f32 channel bit-equal to the plain network", flush=True)
        band_cfg = RenderConfig(width=S, height=2 * S, block_size=64, max_bounces=1000,
                                driver="mega", mega_chain_cap=8)
        fn = make_sharded_mega_sweep([dev, dev], cs_s, width=S, height=2 * S, block_size=64,
                                     max_bounces=1000, stddev=0.5, n_sweeps=2,
                                     seeds_from_blocks=True, packet=1024, groups=4,
                                     table_in_hbm=True, trunk_rows=64)
        rr = MegaMultiChipRenderer(cs_s, band_cfg, devices=[dev, dev])
        scheds = [rr.scheduler.sweep(k) for k in range(2)]
        bs = np.stack([k.block_seeds for k in scheds])
        offs = np.stack([k.sample_offset for k in scheds])
        delta, ovf = fn(cs_s, bs, offs)
        bands, st = rr._run_chunk("chained", bs, offs, ())
        if not (torch.equal(delta, torch.cat(bands)) and int(ovf) == int(st["wave_overflow"])):
            fail("(s) make_sharded_mega_sweep([cuda:0, cuda:0]) differs from the two-band "
                 "renderer's chunk")
        print(f"(s) make_sharded_mega_sweep([cuda:0, cuda:0]) ({S}x{2 * S}, 2 chained sweeps): "
              f"its assembled delta == the two-band renderer's chunk bit for bit, overflow "
              f"{int(ovf)}", flush=True)

    _, counts_s = drive("(s) JAX call forms: render_waves_chained/render_waves on a "
                        "scene_to_device scene with non-default walker kwargs, "
                        "reconstruct_pallas, sort_tile_by_key, make_sharded_mega_sweep",
                        jax_forms)
    print(f"(s) launches {counts_s}", flush=True)
    for k in ("mk_start_chained", "mk_resume", "mk_start", "reconstruct", "reconstruct_weighted",
              "sort_tiles"):
        if counts_s[k] <= 0:
            fail(f"(s): kernel {k} was not launched")

    # ---- 6. each kernel at the main path's shapes: agreement and time ----
    phase(f"kernels vs twins at the main path's shapes: the calls recorded, their twins in "
          f"{TWIN_WORKERS} processes at once")
    print(f"device memory: {torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB reserved by the caching allocator")
    real = {"mk_start": mk.megakernel_start, "mk_resume": mk.megakernel_resume,
            "mk_start_chained": mk.megakernel_start_chained, "mk_tiles": mk.megakernel_tiles}

    def work(name, args, got, scene=None, per_row=ROW_OPS):
        """(bytes, f32 operations) of one megakernel call: the table once
        (the dedicated shadow table too where the launch reads it),
        ``per_row`` operations per trace row the call's paths visited
        (state channel 23 / flush channel 8 count them; row_ops of the
        plain version's split, ROW_OPS without one), and its inputs and
        outputs once. K2
        passes a lane that is not alive through unchanged, so a resume
        counts every lane's alive flag and the state and RNG of the live
        lanes, read and written. ``scene``: the launch's MegaScene (default
        the slice's)."""
        sc = ms if scene is None else scene
        table = nbytes(sc.rows, sc.consts) + (nbytes(sc.shadow_rows) if sc.shadow_tbl else 0)
        rows = got[0][23].sum()
        if name == "mk_resume":
            st, rng_in = args[0], args[1]
            rows = rows - st[23].sum()
            live = int((st[0] > 0).sum())
            lane_bytes = st.shape[0] * st.element_size() + rng_in.element_size()
            return (table + st.shape[1] * st.element_size() + 2 * live * lane_bytes,
                    float(rows) * per_row)
        if name == "mk_start_chained":
            rows = rows + got[2][8].sum()
        tensors = [a for a in args if torch.is_tensor(a)] + list(got)
        return table + nbytes(*tensors), float(rows) * per_row

    def label_of(tag, name, args):
        lanes = "x".join(str(d) for d in args[-2].shape)  # the seeds or the RNG
        return f"{tag} {name} ({lanes} lanes, cap {args[-1]})"

    # the recorded calls: (a)'s chained chunk (8 x 1M slots), the unchained
    # sweep, (p)'s chunk on its 100,384-triangle PACKED4 table, and (q)'s
    # chunk and the sweep with the occlusion cache
    scheds = [ra.scheduler.sweep(slice_cfg["spp"] + 1 + s) for s in range(mk.CHAIN_SWEEPS_CUDA)]
    frames = [frame_of(sc) for sc in scheds]
    cpx, cpy, cseeds = (torch.stack([f[i] for f in frames]) for i in range(3))
    chunk_res = []
    chunk_calls = record_calls(mk, real, lambda: chunk_res.append(
        mk.render_waves_chained(ms, cpx, cpy, cseeds, max_bounces=1000)))
    upx, upy, useeds, uso = frame_of(ra.scheduler.sweep(slice_cfg["spp"] + 1 + mk.CHAIN_SWEEPS_CUDA))
    sweep_out = []
    sweep_calls = record_calls(mk, real, lambda: sweep_out.append(
        mk.render_waves(ms, upx, upy, useeds, max_bounces=1000)))
    ms_p = mk.mega_scene(compiled_big["(p) PACKED4"], W, H, dev)
    p_calls = record_calls(mk, real, lambda: mk.render_waves_chained(
        ms_p, cpx, cpy, cseeds, max_bounces=1000))
    ms_q = mk.launch_scene(ms, shadow_cache=True)
    qc_calls = record_calls(mk, real, lambda: mk.render_waves_chained(
        ms, qpx, qpy, qseeds, max_bounces=1000, shadow_cache=True))
    qs_calls = record_calls(mk, real, lambda: mk.render_waves(
        ms, upx, upy, useeds, max_bounces=1000, shadow_cache=True))
    k5_args = (upx, upy, useeds, 1000)
    sorted_kw = dict(lane_sort=True, lane_order=True)
    # every call through its plain version, on the card in the twin
    # workers, all in flight at once (the longest first): the kernel's
    # outputs held to the plain version's with the phase-4 bounds and bit
    # for bit, rows included; the sorted calls' order records too
    groups = (("(p) PACKED4 chained chunk:", ms_p, p_calls, {}),
              ("(q) cache on, chained chunk:", ms_q, qc_calls, {}),
              ("chained chunk:", ms, chunk_calls, {}),
              ("K5", ms, [("mk_tiles", k5_args)], {}),
              ("K5 sorted", ms, [("mk_tiles", k5_args)], sorted_kw),
              ("(q) cache on, K5", ms_q, [("mk_tiles", k5_args)], {}),
              ("K7 sorted", ms, sweep_calls, sorted_kw),
              ("(q) cache on, unchained sweep:", ms_q, qs_calls, {}),
              ("unchained sweep:", ms, sweep_calls, {}))
    jobs = [(label_of(tag, name, args), name, sc, args, kw, real[name](sc, *args, **kw))
            for tag, sc, calls, kw in groups for name, args in calls]
    # the twins run while this process traces the small untimed paths
    # (the sorted wavefront, (m), (h)); only then is any kernel timed
    t_twins = time.monotonic()
    twin_futures = [twin_pool.submit(twin_job, *job) for job in jobs]
    small_sync = dict(width=256, height=256, spp=1, max_bounces=1000, block_size=128)
    rs = Renderer(cs, RenderConfig(**small_sync, driver="sync"), device="cuda")
    rs.render()
    rw = Renderer(cs, RenderConfig(**small_sync, driver="wavefront", wavefront_lanes=1 << 14,
                                   sort_lanes=True), device="cuda")
    _, counts_gs = drive("(g) sorted wavefront, 256x256, 16384 lanes", rw.render)
    if not np.allclose(rw.film.cpu().numpy(), rs.film.cpu().numpy(), rtol=1e-4, atol=2e-4):
        fail("(g) the sorted wavefront film differs from the sync film")
    print(f"(g) sorted wavefront == sync at 256x256 (bit-equal {torch.equal(rw.film, rs.film)}), "
          f"launches {counts_gs}")

    rm = MultiChipRenderer(cs, RenderConfig(**dict(sync_cfg, spp=1)), devices=bands)
    mm, counts_m = drive("(m) the sync driver's blocks over two entries of cuda:0: "
                         "MultiChipRenderer 1024x1024, 1 spp", rm.render)
    check_render("(m) sync blocks", rm, mm, counts_m, ("traverse", "reconstruct_weighted"))
    if any(counts_m[k] for k in mk.LAUNCHES) or counts_m["reconstruct"]:
        fail(f"(m) the sharded sync sweep launched a megakernel or the unweighted K3: {counts_m}")
    fm, f1 = rm.film.cpu().numpy(), snap["first"].cpu().numpy()
    print(f"(m) against (f)'s film after its first sweep: max abs err {np.abs(fm - f1).max():.3e}, "
          f"{int((fm != f1).any(-1).sum())} pixels differ; {mm['render_seconds']:.3f} s against "
          f"(f)'s {mf['render_seconds'] / 8:.3f} s a sweep")
    if not np.allclose(fm, f1, rtol=5e-4, atol=5e-5):
        fail("(m) the sharded sync film differs from the single one beyond rtol 5e-4 / atol 5e-5")

    rh = Renderer(cs, RenderConfig(**small_sync, driver="sync", fixed_albedo=True), device="cuda")
    _, counts_h = drive("(h) fixed albedo (sync, 256x256), packet traversal, bvh and brute",
                        rh.render)
    if not np.isfinite(rh.image()).all() or torch.equal(rh.film, rs.film):
        fail("(h) fixed albedo: a non-finite film, or no albedo term")
    rp = Renderer(cs, RenderConfig(**small_sync, driver="sync", traversal="packet"), device="cuda")
    rp.render()
    if not torch.equal(rp.film, rs.film):
        fail("(h) the packet traversal's film differs from rows'")
    print(f"(h) fixed albedo film finite (launches {counts_h}); packet film == rows film, bit for bit")
    css = to_device(compile_scene(small_scene), dev)
    so_ = camera_rays(css.cam_position, css.cam_rotation, css.cam_fov,
                      torch.stack([px, py], -1), (S, S))
    by_trav = {tr: integrate(css, *so_, seed_rng(from_bits(seeds)), max_bounces=1000, traversal=tr)
               for tr in ("rows", "bvh", "brute")}
    for tr in ("bvh", "brute"):
        eq = (by_trav[tr].state == by_trav["rows"].state).float().mean().item()
        print(f"(h) {tr} against rows, 64x64 meshbox_small: RNG equal on {eq:.4%} of paths")
        if eq < 0.995:
            fail(f"(h) {tr} disagrees with rows")
    # the CLI on the card with every walker knob and --profile-dir against
    # the default command: the same EXR bit for bit, and a trace
    from hijiki_tpu_torch import cli

    cli_base = [SCENE_SMALL, "--put-cbox-spheres", "--use-bvh", "--driver", "mega", "-w", "64",
                "-H", "64", "-s", "2", "--max-bounces", "1000"]
    prof_dir = os.path.join(out_dir, "profile")
    knobs = ["--mega-packet", "256", "--mega-groups", "4", "--spec-resolve", "1", "--mega-trunk",
             "4096", "--mega-window", "2", "--profile-dir", prof_dir]
    for argv in ([*cli_base, "-o", os.path.join(out_dir, "cli_plain.exr")],
                 [*cli_base, *knobs, "-o", os.path.join(out_dir, "cli_knobs.exr")]):
        if cli.main(argv) != 0:
            fail(f"(h) the CLI exited non-zero: {' '.join(argv[1:])}")
    same_exr = np.array_equal(read_exr(os.path.join(out_dir, "cli_knobs.exr")).view(np.int32),
                              read_exr(os.path.join(out_dir, "cli_plain.exr")).view(np.int32))
    trace = os.path.join(prof_dir, "trace.json")
    if not same_exr or not os.path.getsize(trace):
        fail("(h) the CLI with the walker knobs wrote another EXR, or --profile-dir no trace")
    with open(trace) as f:
        cuda_events = f.read().count('"cat": "kernel"')
    print(f"(h) CLI at 64x64 on the card: every walker knob set and --profile-dir, the EXR "
          f"bit-equal to the default command's; {trace} holds {cuda_events} kernel events",
          flush=True)

    # the trace-row formats compiled (the per-format timings and K10b's
    # tables read them) and the probes' untimed checks, while the twins run
    fmt_cs = {0: cs}
    for pl_ in (1, 3, 4, 12):
        fmt_cs[pl_] = compile_scene(scene, packed_leaf=pl_)
    probes_checked = probe_checks(dev, pab, pwk, pcl, pga, pvi, pvd, fmt_cs)

    phase("kernels vs twins at the main path's shapes: the twins collected")
    twin_out = collect_twins(jobs, twin_futures)
    twin_of = {job[0]: res for job, res in zip(jobs, twin_out)}
    print(f"{len(jobs)} plain versions at the main path's shapes, {TWIN_WORKERS} at a time: "
          f"{time.monotonic() - t_twins:.1f} s (each one's ms measured with the others sharing "
          f"the card); summed {sum(r[0] for r in twin_out) / 1e3:.1f} s", flush=True)
    q_pre = [r[2] for (label, *_), r in zip(jobs, twin_out) if label.startswith("(q)")]
    q_tried, q_verified = (sum(p[i] for p in q_pre) for i in range(2))
    print(f"(q) the cache-on plain versions tested {q_tried} predictions at the main path's "
          f"shapes, {q_verified} verified ({q_verified / max(q_tried, 1):.4%})", flush=True)
    del jobs

    def replay(tag, calls, scene=None):
        """Each call through the kernel, timed (mean of 3), beside its plain
        version's time and error from the twin workers; returns per kernel
        its times, the plain version's, its error, its work, and its last
        call's outputs."""
        sc = ms if scene is None else scene
        ms_of, plain_of, err_of, work_of, out_of = {}, {}, {}, {}, {}
        for name, args in calls:
            label = label_of(tag, name, args)
            t_k, got = timed(lambda: real[name](sc, *args), reps=3)
            t_p, err, _, kinds = twin_of[label]
            err_of[name] = max(err_of.get(name, 0.0), err)
            ms_of.setdefault(name, []).append(t_k)
            plain_of.setdefault(name, []).append(t_p)
            work_of.setdefault(name, []).append(work(name, args, got, sc, row_ops(kinds)))
            out_of[name] = got
            b_ms, b_by = bound(*work_of[name][-1])
            print(f"{label}: {t_k:.3f} ms, twin {t_p:.3f} ms, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
        return ms_of, plain_of, err_of, work_of, out_of

    c_ms, c_plain, c_err, c_work, c_out = replay("chained chunk:", chunk_calls)
    t_zero, _ = timed(lambda: (torch.zeros((mk.N_STATE, cpx.numel()), device=dev),
                               torch.zeros((mk.CHAIN_OUT_CH, cpx.numel()), device=dev)), reps=5)
    print(f"K4's zeroed pool + flush buffer ({cpx.numel()} slots): {t_zero:.3f} ms per chunk")
    for name in ("mk_start_chained", "mk_start", "mk_tiles", "mk_resume", "mk_start_sorted",
                 "mk_resume_sorted", "mk_tiles_sorted"):
        occ = mk.occupancy(name)
        launch = (f"at most {occ['blocks_per_sm'] * occ['sms']} blocks a launch (persistent)"
                  if name in ("mk_start_chained", "mk_start", "mk_tiles")
                  else f"a block per {occ['threads']} lanes")
        print(f"{name}: {occ['registers']} registers, {occ['spill_bytes']} bytes spilled, "
              f"{occ['local_bytes']} bytes of local memory, {occ['warps_per_sm']} resident warps an SM, "
              f"{launch}")
        # the other formats' instantiations: registers / spill bytes / warps
        others = {f: mk.occupancy(name, fmt=f) for f in mk.KERNEL_FORMATS if f != "classic"}
        print(f"  {name} by format (registers/spill bytes/warps an SM): " + ", ".join(
            f"{f} {o['registers']}/{o['spill_bytes']}/{o['warps_per_sm']}" for f, o in others.items()))
    pool, _, chain_out = c_out.pop("mk_start_chained")
    wi = mk.warp_iterations(mk.chained_segs(pool, chain_out, cpx.shape[0]))
    print("K4's chunk, warp-bounces a warp of 32 consecutive lanes: whole samples a thread "
          f"(sum of max) {wi['sum_max']:.4f}, per-lane respawn (max of sums) {wi['max_sum']:.4f}, "
          f"perfect packing (sum of means) {wi['sum_mean']:.4f}; ratios "
          f"{wi['sum_max'] / wi['sum_mean']:.4f} / {wi['max_sum'] / wi['sum_mean']:.4f}")
    del pool, chain_out, c_out

    u_ms, u_plain, u_err, u_work, _ = replay("unchained sweep:", sweep_calls)

    # K5 over the same frame to cap 1000, against its plain version (above)
    t_k5, got = timed(lambda: mk.megakernel_tiles(ms, *k5_args), reps=3)
    t_k5p, k5_err, _, k5_kinds = twin_of[label_of("K5", "mk_tiles", k5_args)]
    # K5 traces K1's paths at cap max_bounces: K1's row counter counts K5's
    # rows, its bounce counter (segs) picks the tail floor's 32 longest paths
    k5_state = mk.megakernel_start(ms, upx, upy, useeds, 1000)[0]
    k5_rows = float(k5_state[23].sum())
    k5_work = (nbytes(upx, upy, useeds, *got, ms.rows, ms.consts), k5_rows * row_ops(k5_kinds))
    top = torch.argsort(k5_state[27], descending=True)[:32]
    tail = [a[top].contiguous() for a in (upx, upy, useeds)]
    t_floor, _ = timed(lambda: mk.megakernel_tiles(ms, *tail, 1000), reps=3)
    print(f"K5 mk_tiles ({upx.numel()} lanes to 1000): {t_k5:.3f} ms, tail floor {t_floor:.3f} ms "
          f"(the 32 paths of the most bounces, {int(k5_state[27][top].min())}-"
          f"{int(k5_state[27][top].max())}, alone), twin {t_k5p:.3f} ms, "
          f"bound {bound(*k5_work)[0]:.4f} ms ({bound(*k5_work)[1]})")
    del k5_state

    # K7: the sweep's K1/K2 calls through the sorted kernels
    phase("K7 (the sorted K1/K2/K5) and K8 at the main path's shapes")
    k7_ms, k7_unsorted, k7_plain, k7_err = [], [], [], 0.0

    def max_diff(got, want) -> float:
        """largest |got - want| over every value (NaN = NaN, bits as ints)"""
        return max(float((g.nan_to_num(0.0) - w.nan_to_num(0.0)).abs().max()) if g.is_floating_point()
                   else float((g.long() - w.long()).abs().max()) for g, w in zip(got, want))

    for name, args in sweep_calls:
        t_u, want = timed(lambda: real[name](ms, *args), reps=3)
        t_s, got = timed(lambda: real[name](ms, *args, lane_sort=True), reps=3)
        label = label_of("K7 sorted", name, args)
        if not bit_equal(got, want):
            fail(f"{label} differs from the unsorted kernel")
        rec = real[name](ms, *args, **sorted_kw)
        if not bit_equal(rec[:2], got):
            fail(f"{label}: the launch with the order record differs from the one without")
        # against its sorted plain version, order record included (above)
        t_p, err = twin_of[label][:2]
        k7_err = max(k7_err, err)
        k7_ms.append(t_s)
        k7_unsorted.append(t_u)
        k7_plain.append(t_p)
        print(f"{label}: {t_s:.3f} ms against {t_u:.3f} ms unsorted (bit-equal), plain {t_p:.3f} ms",
              flush=True)
    t_k5s, got = timed(lambda: mk.megakernel_tiles(ms, *k5_args, lane_sort=True), reps=3)
    t_k5u, want = timed(lambda: mk.megakernel_tiles(ms, *k5_args), reps=3)
    if not bit_equal(got, want):
        fail("K5 sorted differs from K5 on the 1M-path frame")
    rec = mk.megakernel_tiles(ms, *k5_args, **sorted_kw)
    if not bit_equal(rec[:2], got):
        fail("K5 sorted: the launch with the order record differs from the one without")
    t_k5sp, k5s_err = twin_of[label_of("K5 sorted", "mk_tiles", k5_args)][:2]
    print(f"K5 sorted ({upx.numel()} paths to 1000): {t_k5s:.3f} ms against {t_k5u:.3f} ms unsorted "
          f"(bit-equal), plain {t_k5sp:.3f} ms")
    del rec

    # K8 at the size of a 1M-path state: the kernel, its plain version, the library call
    t_k8, got = timed(lambda: srt.sort_tiles(key8, ch8), reps=10)
    t_k8p, want = timed(lambda: srt.sort_tiles_plain(key8, ch8), reps=1, warm=False)
    if not bit_equal(got, want):
        fail("K8 at 1M lanes differs from its plain version")
    k8_err = max_diff(got, want)
    t_k8lib, _ = timed(lambda: torch.gather(
        ch8, 2, torch.sort(key8, dim=1, stable=True).indices.expand(C8, T8, n8)), reps=10)
    k8_work = (nbytes(key8, ch8, *got), 0.0)
    print(f"K8 sort_tiles ({T8} x {n8} lanes, {C8} channels): {t_k8:.4f} ms, plain {t_k8p:.3f} ms, "
          f"torch.sort+gather {t_k8lib:.4f} ms, bound {bound(*k8_work)[0]:.4f} ms ({bound(*k8_work)[1]})")
    print(f"per unchained sweep, sorted: K1 {k7_ms[0]:.3f} ms + K2 "
          f"{' + '.join(f'{t:.3f}' for t in k7_ms[1:])} ms; unsorted in the same replay: K1 "
          f"{k7_unsorted[0]:.3f} ms + K2 {' + '.join(f'{t:.3f}' for t in k7_unsorted[1:])} ms")

    phase("K3 at the main path's shapes")
    total = sweep_out[0][0].reshape(H, W, 3).contiguous()
    normal = sweep_out[0][1].reshape(H, W, 3).contiguous()
    t_k3s, got = timed(lambda: prc.reconstruct(total, normal, uso, block_size=128), reps=20)
    t_k3sp, want = timed(lambda: reconstruct_sweep(total, normal, torch.zeros_like(total), uso,
                                                   block_size=128), reps=1, warm=False)
    k3_err = max(k3_err, check_k3("K3 on the sweep's radiance (1024x1024)", got, want))
    k3s_work = (nbytes(total, normal, got), H * W * 25 * TAP_OPS)
    print(f"K3 reconstruct, one sweep (1024x1024, device time of 20 back-to-back launches): "
          f"{t_k3s:.4f} ms, twin {t_k3sp:.3f} ms, bound {bound(*k3s_work)[0]:.4f} ms "
          f"({bound(*k3s_work)[1]})")
    # K3 as path (a) launches it: the chained chunk's 8 sweeps in one launch
    S3 = cpx.shape[0]
    ctot = chunk_res[0][0].reshape(S3, H, W, 3).contiguous()
    cnrm = chunk_res[0][1].reshape(S3, H, W, 3).contiguous()
    coffs = np.stack([f[3] for f in frames]).astype(np.float32)
    del chunk_res
    t_k3, got = timed(lambda: prc.reconstruct(ctot, cnrm, coffs, block_size=128), reps=10)
    t_k3p, want = timed(lambda: prc.reconstruct_plain(ctot, cnrm, coffs, block_size=128),
                        reps=1, warm=False)
    k3_err = max(k3_err, check_k3(f"K3 on the chained chunk ({S3} x 1024x1024, one launch)",
                                  got, want))
    k3_sum = None
    for s in range(S3):
        d = prc.reconstruct(ctot[s], cnrm[s], coffs[s], block_size=128)
        k3_sum = d if k3_sum is None else k3_sum + d
    if not bit_equal([got], [k3_sum]):
        fail("K3's chunk launch differs from its one-sweep launches summed in sweep order")
    k3_work = (nbytes(ctot, cnrm, got), S3 * H * W * 25 * TAP_OPS)
    print(f"K3 reconstruct, the chained chunk ({S3} sweeps, one launch, mean of 10): {t_k3:.4f} ms, "
          f"bit-equal to its {S3} one-sweep launches summed in sweep order; twin {t_k3p:.3f} ms, "
          f"bound {bound(*k3_work)[0]:.4f} ms ({bound(*k3_work)[1]})")
    # K3's weighted mode as path (l) launches it: a band's chunk (the upper
    # 512 rows of the 8 sweeps) on its canvas padded by a block above and
    # below, weight 0 there
    Bk, bnd = 128, H // 2
    wtot, wnrm = (F.pad(a[:, :bnd], (0, 0, 0, 0, Bk, Bk)) for a in (ctot, cnrm))
    wgt = F.pad(torch.ones((bnd, W), device=dev), (0, 0, Bk, Bk))
    t_k3w, got = timed(lambda: prc.reconstruct(wtot, wnrm, coffs, block_size=128,
                                               sample_weight=wgt), reps=10)
    t_k3wp, want = timed(lambda: prc.reconstruct_plain(wtot, wnrm, coffs, block_size=128,
                                                       sample_weight=wgt), reps=1, warm=False)
    k3w_err = check_k3(f"K3 weighted on a band's chunk ({S3} x {bnd + 2 * Bk}x{W}, one launch)",
                       got, want)
    k3w_sum = None
    for s in range(S3):
        d = prc.reconstruct(wtot[s], wnrm[s], coffs[s], block_size=128, sample_weight=wgt)
        k3w_sum = d if k3w_sum is None else k3w_sum + d
    if not bit_equal([got], [k3w_sum]):
        fail("K3 weighted: the chunk launch differs from its one-sweep launches summed")
    ones = torch.ones((H, W), device=dev)
    if not bit_equal([prc.reconstruct(ctot, cnrm, coffs, block_size=128, sample_weight=ones)],
                     [prc.reconstruct(ctot, cnrm, coffs, block_size=128)]):
        fail("K3 weighted at weight 1 differs from the unweighted kernel")
    k3w_work = (nbytes(wtot, wnrm, wgt, got), S3 * (bnd + 2 * Bk) * W * 25 * TAP_OPS)
    print(f"K3 weighted, a band's chunk ({S3} sweeps, one launch, mean of 10): {t_k3w:.4f} ms "
          f"beside the unweighted 1024x1024 chunk's {t_k3:.4f} ms; bit-equal to its {S3} "
          f"one-sweep launches summed, at weight 1 bit-equal to the unweighted kernel; plain "
          f"{t_k3wp:.3f} ms, bound {bound(*k3w_work)[0]:.4f} ms ({bound(*k3w_work)[1]})")
    del ctot, cnrm, k3_sum, wtot, wnrm, k3w_sum

    # K6: the device time of the calls of one 1024x1024 sync sweep's first
    # K6_PROFILE_BOUNCES bounces, from torch.profiler (CUDA events around
    # each call would add the host's launch latency: the loop is
    # host-bound); the first bounce's closest and shadow walks and the
    # closest walks of bounces 9, 30 and 200 recorded and replayed through
    # the kernel and the twin
    from torch.profiler import ProfilerActivity, profile

    phase("K6 at the main path's shapes: a 1024x1024 sync sweep, its first "
          f"{K6_PROFILE_BOUNCES} bounces under torch.profiler")
    real_traverse = pt.traverse
    window = 2 * K6_PROFILE_BOUNCES  # two calls a bounce: closest, shadow
    k6_calls, n_calls = [], [0]
    # the window's K6 work, summed on the device (no host read per call):
    # walking rays, rows visited, and on the host lanes and table bytes
    k6_walking = torch.zeros((), dtype=torch.int64, device=dev)
    k6_rows = torch.zeros((), dtype=torch.float64, device=dev)
    k6_lanes, k6_table = [0], [0]
    prof = profile(activities=[ProfilerActivity.CUDA])

    def traverse_recorded(rows, o, d, tmin, tmax, **mode):
        if n_calls[0] in K6_CALLS:
            k6_calls.append((n_calls[0], (rows, o.clone(), d.clone(), tmin.clone(), tmax.clone()),
                             mode))
        if n_calls[0] == window:
            torch.cuda.synchronize()
            prof.stop()
        n_calls[0] += 1
        out = real_traverse(rows, o, d, tmin, tmax, **mode)
        if n_calls[0] <= window:
            k6_walking.add_((tmax >= tmin).sum())
            k6_rows.add_(out[6].sum(dtype=torch.float64))
            k6_lanes[0] += o.shape[0]
            k6_table[0] += nbytes(rows)
        return out

    kpx, kpy, kseeds, _ = frame_of(ra.scheduler.sweep(slice_cfg["spp"] + 21))
    ko, kd, ktmin, ktmax = camera_rays(csd.cam_position, csd.cam_rotation, csd.cam_fov,
                                       torch.stack([kpx, kpy], -1), (W, H))
    pt.traverse = traverse_recorded
    try:
        prof.start()
        ksweep = integrate(csd, ko, kd, ktmin, ktmax, seed_rng(from_bits(kseeds)),
                           max_bounces=1000)
        torch.cuda.synchronize()
    finally:
        pt.traverse = real_traverse
    if n_calls[0] <= window:
        fail(f"K6: the sync sweep ended within the profiled {K6_PROFILE_BOUNCES} bounces")
    k6_events = [e for e in prof.key_averages() if "traverse_kernel" in e.key]
    k6_sweep_ms = sum(getattr(e, "self_device_time_total", 0) for e in k6_events) / 1e3
    k6_sweep_n = sum(e.count for e in k6_events)
    # the window's summed bound: every call's table, tmin and tmax, the o
    # and d of its walking rays, six outputs a lane, ROW_OPS a visited row
    walking_all, rows_all = int(k6_walking), float(k6_rows)
    sweep_work = (k6_table[0] + 8 * k6_lanes[0] + 24 * walking_all + 24 * k6_lanes[0],
                  rows_all * ROW_OPS)
    k6_sweep_bound = bound(*sweep_work)
    print(f"K6 in one sync sweep ({n_calls[0]} launches over {ksweep.iterations} bounces), its "
          f"first {window} launches ({K6_PROFILE_BOUNCES} bounces): {k6_sweep_ms:.3f} ms of device "
          f"time in all ({k6_sweep_n} kernels in the profile); {walking_all} of {k6_lanes[0]} lanes "
          f"walked, {rows_all / 1e6:.3f} M rows visited; summed bound {k6_sweep_bound[0]:.4f} ms "
          f"({k6_sweep_bound[1]}), so launches x gap {k6_sweep_ms - k6_sweep_bound[0]:.3f} ms")
    if k6_sweep_n != window or not k6_sweep_ms > 0:
        fail("the profiler did not see every K6 launch of the window")

    lanes = start_lanes(ko, kd, ktmin, ktmax, seed_rng(from_bits(kseeds)))
    isect, occl = make_intersectors(csd, "rows")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            lanes = bounce_step(csd, lanes, isect, occl)
    except RuntimeError as e:
        fail(f"bounce_step synchronized with the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("three sync bounces (1M lanes) made no device sync under set_sync_debug_mode('error')")

    k6_ms, k6_plain, k6_work, k6_err = [], [], [], 0.0
    for idx, args, mode in k6_calls:
        t_k, got = timed(lambda: pt.traverse(*args, **mode), reps=5)
        t_p, want = timed(lambda: pt.traverse_plain(*args, **mode), reps=1, warm=False)
        kind = "closest" if not mode.get("any_hit") else (
            "inclusive any-hit" if mode.get("inclusive") else "any-hit")
        label = (f"K6 call {idx} ({kind}, bounce {idx // 2 + 1}, "
                 f"{int((args[4] >= args[3]).sum())} of {args[1].shape[0]} rays walking)")
        if not bit_equal([got], [want]):
            fail(f"{label}: the kernel differs from its twin")
        k6_err = max(k6_err, float((got - want).abs().nan_to_num(0.0).max()))
        k6_ms.append(t_k)
        k6_plain.append(t_p)
        k6_work.append(k6_bytes_ops(args, got))
        print(f"{label}: bit-equal on all 7 outputs; {float(got[6].sum()) / 1e6:.3f} M rows "
              f"visited, {int(got[6].max())} by the longest walk; {t_k:.4f} ms, twin {t_p:.3f} ms, "
              f"bound {bound(*k6_work[-1])[0]:.4f} ms ({bound(*k6_work[-1])[1]})", flush=True)
    if [c[0] for c in k6_calls] != list(K6_CALLS):
        fail(f"K6 replay: the sync sweep did not reach bounce {K6_CALLS[-1] // 2 + 1}")
    print(f"per chained chunk: K4 {sum(c_ms['mk_start_chained']):.3f} ms + K2 "
          f"{' + '.join(f'{t:.3f}' for t in c_ms['mk_resume'])} ms; per unchained sweep: K1 "
          f"{sum(u_ms['mk_start']):.3f} ms + K2 {' + '.join(f'{t:.3f}' for t in u_ms['mk_resume'])} ms")

    def summed(works):
        """bound of a list of calls: summed bytes and summed operations (and
        at the unfused issue rate)"""
        work = (sum(w[0] for w in works), sum(w[1] for w in works))
        b_ms, b_by = bound(*work)
        return dict(bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    bound_unfused_ms=bound(*work, F32_UNFUSED_OPS_PER_S)[0])

    # the occlusion cache and skip-all at the main path's shapes: the chained
    # chunk's and the unchained sweep's recorded calls through the cache-on
    # kernels (and the sweep's through skip-all), each beside the cache-off
    # kernel on the same inputs, timed in turns (off, on, on, off: means of
    # 3), every output but rows bit-equal; K5 over the frame likewise. Then
    # (q)'s own cache-on calls, timed beside their plain versions (above)
    phase("the occlusion cache and skip-all at the main path's shapes")
    ms_skip = mk.launch_scene(ms, shadow_skip_all=True)

    def in_turns(fn_a, fn_b):
        """(ms of a, ms of b, a's outputs, b's outputs): a, b, b, a, means"""
        ta1, out_a = timed(fn_a, reps=3)
        tb1, out_b = timed(fn_b, reps=3)
        tb2, _ = timed(fn_b, reps=3, warm=False)
        ta2, _ = timed(fn_a, reps=3, warm=False)
        return (ta1 + ta2) / 2, (tb1 + tb2) / 2, out_a, out_b

    def rows_of(name, args, out):
        return work(name, args, out)[1] / ROW_OPS

    for tag, calls in (("chained chunk:", chunk_calls), ("unchained sweep:", sweep_calls)):
        for name, args in calls:
            t_off, t_on, off, on = in_turns(lambda: real[name](ms, *args),
                                            lambda: real[name](ms_q, *args))
            label = label_of(tag, name, args)
            if not bit_equal(but_rows(name, on), but_rows(name, off)):
                fail(f"{label} with the cache differs from the cache-off kernel beyond rows")
            w_on = work(name, args, on, per_row=row_ops(twin_of[label][3]))
            line = (f"{label}: cache on {t_on:.3f} ms, off {t_off:.3f} ms ({t_on / t_off - 1:+.2%}); "
                    f"rows {rows_of(name, args, on):.6e} against {rows_of(name, args, off):.6e}; bound "
                    f"{bound(*w_on)[0]:.4f} ms ({bound(*w_on)[1]})")
            if tag == "unchained sweep:":
                t_off2, t_sk, _, sk = in_turns(lambda: real[name](ms, *args),
                                               lambda: real[name](ms_skip, *args))
                line += (f"; skip-all {t_sk:.3f} ms against {t_off2:.3f} ms, rows "
                         f"{rows_of(name, args, sk):.6e}: the shadow walk's share "
                         f"{1 - t_sk / t_off2:.2%} of the time, "
                         f"{1 - rows_of(name, args, sk) / rows_of(name, args, off):.2%} of the rows")
            print(line, flush=True)
    t5_off, t5_on, off5, on5 = in_turns(lambda: mk.megakernel_tiles(ms, *k5_args),
                                        lambda: mk.megakernel_tiles(ms_q, *k5_args))
    if not bit_equal(on5, off5):
        fail("K5 with the cache differs from K5 without it")
    rows5 = float(mk.megakernel_start(ms_q, upx, upy, useeds, 1000)[0][23].sum())
    t_k5cp, k5c_err, _, k5c_kinds = twin_of[label_of("(q) cache on, K5", "mk_tiles", k5_args)]
    k5c_work = (nbytes(upx, upy, useeds, *on5, ms.rows, ms.consts), rows5 * row_ops(k5c_kinds))
    print(f"K5 over the frame to 1000: cache on {t5_on:.3f} ms, off {t5_off:.3f} ms "
          f"({t5_on / t5_off - 1:+.2%}), bit-equal; rows {rows5:.6e} against {k5_rows:.6e}; bound "
          f"{bound(*k5c_work)[0]:.4f} ms; the cache-on plain version {t_k5cp:.3f} ms", flush=True)
    del off5, on5
    qc_ms, qc_plain, qc_err, qc_work, _ = replay("(q) cache on, chained chunk:", qc_calls, ms_q)
    qs_ms, qs_plain, qs_err, qs_work, _ = replay("(q) cache on, unchained sweep:", qs_calls, ms_q)

    # the formats at the main path's shapes: meshbox + spheres compiled
    # with each packed_leaf (and classic with the boxes, without them, with
    # the dedicated shadow table); each format's chained chunk (K4 to cap 8
    # and its K2 resumes) and unchained sweep (K1 to cap 5, K2 to 12, 48,
    # 1000) recorded and replayed through the kernels, and K5 over the frame
    # to 1000, each timed (mean of 3) beside its rows visited and its bound
    # (the classic rows' plain-version times are the calls above). First
    # every format's calls are recorded and each call's plain version runs
    # on the host in the twin workers, on every SPLIT_STRIDE-th lane of its
    # inputs: its rows by kind give the call's operations a row (row_ops);
    # then, the workers done, the timing
    phase("K1/K2/K4/K5 per trace-row format at the main path's shapes")
    fmt_ms, fmt_bound, fmt_calls, split_jobs = {}, {}, {}, []
    for label, pl_, vis, tbl in (("classic+boxes", 0, True, False), ("classic", 0, False, False),
                                 ("shadow_tbl", 0, True, True), ("slim", 1, True, False),
                                 ("packed3", 3, True, False), ("packed4", 4, True, False),
                                 ("packed12", 12, True, False)):
        cs_f = fmt_cs[pl_]
        ms_f = mk.launch_scene(mk.mega_scene(cs_f, W, H, dev), shadow_vis=vis, shadow_tbl=tbl)
        opts = dict(shadow_vis=vis, shadow_tbl=tbl)
        calls_f = record_calls(mk, real, lambda: mk.render_waves_chained(
            ms_f, cpx, cpy, cseeds, max_bounces=1000, **opts))
        calls_f += record_calls(mk, real, lambda: mk.render_waves(
            ms_f, upx, upy, useeds, max_bounces=1000, **opts))
        calls_f.append(("mk_tiles", k5_args))
        fmt_calls[label] = (cs_f, ms_f, tbl, calls_f)
        ms_host = mk.launch_scene(mk.mega_scene(cs_f, W, H, "cpu"), shadow_vis=vis, shadow_tbl=tbl)
        for name, args in calls_f:
            sub = [a.cpu() if torch.is_tensor(a) else a for a in lanes_of(name, args, SPLIT_STRIDE)]
            split_jobs.append(twin_pool.submit(row_split, name, ms_host, sub))
    t_split = time.monotonic()
    split_ops = [row_ops(f.result()) for f in split_jobs]
    twin_pool.shutdown()
    print(f"{len(split_jobs)} plain versions on the host on every {SPLIT_STRIDE}th lane of each "
          f"format's calls, for their rows by kind: {time.monotonic() - t_split:.1f} s after the "
          f"last was recorded", flush=True)
    for label, (cs_f, ms_f, tbl, calls_f) in fmt_calls.items():
        times, works = {}, {}
        per_row = [split_ops.pop(0) for _ in calls_f]
        for (name, args), ops in zip(calls_f[:-1], per_row):
            t_k, got = timed(lambda: real[name](ms_f, *args), reps=3)
            times.setdefault(name, []).append(t_k)
            works.setdefault(name, []).append(work(name, args, got, ms_f, ops))
        t5, got5 = timed(lambda: mk.megakernel_tiles(ms_f, upx, upy, useeds, 1000), reps=3)
        rows5 = float(mk.megakernel_start(ms_f, upx, upy, useeds, 1000)[0][23].sum())
        table = nbytes(ms_f.rows, ms_f.consts) + (nbytes(ms_f.shadow_rows) if tbl else 0)
        works["mk_tiles"] = [(table + nbytes(upx, upy, useeds, *got5), rows5 * per_row[-1])]
        times["mk_tiles"] = [t5]
        sweep_k2 = " + ".join(f"{t:.3f}" for t in times["mk_resume"][-3:])
        # K2 as the report counts it: the chunk's resumes (the sweep's 3 follow)
        times["mk_resume"], works["mk_resume"] = times["mk_resume"][:-3], works["mk_resume"][:-3]
        fmt_ms[label] = {k: sum(v) for k, v in times.items()}
        fmt_bound[label] = {k: summed(v)["bound_ms"] for k, v in works.items()}
        k4_rows = works["mk_start_chained"][0][1] / per_row[0]
        k1_ops = per_row[[n for n, _ in calls_f].index("mk_start")]
        print(f"{label} ({tuple(cs_f.trace_rows_mega.shape)} rows, {ms_f.ntab} table(s), "
              f"{ms_f.nbox} boxes{', shadow table' if tbl else ''}): chunk K4 "
              f"{times['mk_start_chained'][0]:.3f} ms + K2 "
              f"{' + '.join(f'{t:.3f}' for t in times['mk_resume'])} ms "
              f"(K4 rows {k4_rows:.6e} at {per_row[0]:.3f} ops a row, bound "
              f"{fmt_bound[label]['mk_start_chained']:.4f} ms); sweep "
              f"K1 {times['mk_start'][0]:.3f} ms ({k1_ops:.3f} ops a row) + K2 {sweep_k2} ms; "
              f"K5 to 1000 {t5:.3f} ms (rows {rows5:.6e} at {per_row[-1]:.3f} ops a row, bound "
              f"{fmt_bound[label]['mk_tiles']:.4f} ms)", flush=True)
        del got5
    del fmt_calls, split_jobs

    # (p)'s chained chunk (the 100,384-triangle PACKED4 table) as path (p)
    # launches it, 8 x 1M slots: every K4 and K2 call timed beside its plain
    # version (above)
    _, _, p_err, _, _ = replay("(p) PACKED4 chained chunk:", p_calls, ms_p)
    for name in ("mk_start_chained", "mk_resume"):
        if name not in p_err:
            fail(f"(p) PACKED4 chained chunk: no {name} call recorded")
        fmt_err[name] = max(fmt_err[name], p_err[name])
        held[name].append("(p) packed4, 100,384 triangles, 8 x 1M slots")
    del ms_p, p_calls

    probe_entries = probe_phase(probes_checked, dev, drive, pab, pwk, pcl, pga, pk9, pvi, pvd)

    def by_format(name):
        """{format: [ms, bound ms]} of a kernel at the main path's shapes"""
        return {f: [fmt_ms[f][name], fmt_bound[f][name]] for f in fmt_ms}

    src = "hijiki_tpu_torch/csrc/"
    mkpy = "hijiki_tpu/ops/pallas_megakernel.py"
    kernels = [
        dict(name="mk_start", route="cuda", source=src + "megakernel.cu",
             replaces=f"{mkpy}:3000", launches=counts_b["mk_start"],
             max_abs_err=max(u_err["mk_start"], fmt_err["mk_start"]), ms=sum(u_ms["mk_start"]),
             plain_ms=sum(u_plain["mk_start"]), **summed(u_work["mk_start"]),
             formats=held["mk_start"], ms_by_format=by_format("mk_start")),
        dict(name="mk_resume", route="cuda", source=src + "megakernel.cu",
             replaces=f"{mkpy}:3041", launches=counts_a["mk_resume"],
             max_abs_err=max(c_err["mk_resume"], u_err["mk_resume"], fmt_err["mk_resume"]),
             ms=sum(c_ms["mk_resume"]), plain_ms=sum(c_plain["mk_resume"]),
             **summed(c_work["mk_resume"]),
             formats=held["mk_resume"], ms_by_format=by_format("mk_resume")),
        dict(name="mk_start_chained", route="cuda", source=src + "megakernel.cu",
             replaces=f"{mkpy}:3015", launches=counts_a["mk_start_chained"],
             max_abs_err=max(c_err["mk_start_chained"], fmt_err["mk_start_chained"]),
             ms=sum(c_ms["mk_start_chained"]),
             plain_ms=sum(c_plain["mk_start_chained"]), **summed(c_work["mk_start_chained"]),
             formats=held["mk_start_chained"], ms_by_format=by_format("mk_start_chained")),
        dict(name="mk_tiles", route="cuda", source=src + "megakernel.cu",
             replaces=f"{mkpy}:2778", launches=counts_e["mk_tiles"],
             max_abs_err=max(k5_err, fmt_err["mk_tiles"]), ms=t_k5, plain_ms=t_k5p,
             **summed([k5_work]), formats=held["mk_tiles"], ms_by_format=by_format("mk_tiles")),
        dict(name="reconstruct", route="cuda", source=src + "reconstruct.cu",
             replaces="hijiki_tpu/render/pallas_reconstruct.py:42",
             launches=counts_a["reconstruct"], max_abs_err=k3_err, ms=t_k3, plain_ms=t_k3p,
             **summed([k3_work])),
        dict(name="reconstruct_weighted", route="cuda", source=src + "reconstruct.cu",
             replaces="hijiki_tpu/render/pallas_reconstruct.py:42",
             launches=counts_l["reconstruct_weighted"], max_abs_err=k3w_err, ms=t_k3w,
             plain_ms=t_k3wp, **summed([k3w_work])),
        dict(name="traverse", route="cuda", source=src + "traverse.cu",
             replaces="hijiki_tpu/ops/pallas_traverse.py:41", launches=counts_f["traverse"],
             max_abs_err=k6_err, ms=sum(k6_ms), plain_ms=sum(k6_plain), **summed(k6_work)),
        # K7 inside the sorted K1/K2 of path (i): the error against the
        # sorted plain version (the order record bit-equal to it, the
        # outputs bit-equal to the unsorted kernels'); the bound is the
        # unsorted calls' work
        dict(name="mk_start_sorted+mk_resume_sorted", route="cuda",
             source=src + "megakernel.cu", replaces="hijiki_tpu/ops/pallas_sort.py:51",
             launches=counts_i["mk_start_sorted"] + counts_i["mk_resume_sorted"],
             max_abs_err=k7_err, ms=sum(k7_ms), plain_ms=sum(k7_plain),
             **summed(u_work["mk_start"] + u_work["mk_resume"])),
        dict(name="mk_tiles_sorted", route="cuda", source=src + "megakernel.cu",
             replaces="hijiki_tpu/ops/pallas_sort.py:51", launches=counts_es["mk_tiles_sorted"],
             max_abs_err=k5s_err, ms=t_k5s, plain_ms=t_k5sp, **summed([k5_work])),
        dict(name="sort_tiles", route="cuda", source=src + "sort.cu",
             replaces="tests/test_megakernel.py:337", launches=counts_j["sort_tiles"],
             max_abs_err=k8_err, ms=t_k8, plain_ms=t_k8p, **dict(summed([k8_work]), library_ms=t_k8lib)),
    ]
    # the occlusion cache's instantiations (kCache) of K1, K2, K4, K5:
    # launches from path (q); ms, plain_ms, the error and the bound from
    # (q)'s own calls at the main path's shapes (phase 6: K1 the sweep's, K2
    # the chained chunk's resumes, K4 the chunk's, K5 the frame's), each held
    # bit for bit to its cache-on plain version there (rows included) and
    # at the phase-4c gates (the error: the larger); against the cache-off
    # kernels every output but rows is bit-equal (phases 4c and 6)
    cache_of = {"mk_start": (qs_ms["mk_start"], qs_plain["mk_start"], qs_err["mk_start"],
                             qs_work["mk_start"]),
                "mk_resume": (qc_ms["mk_resume"], qc_plain["mk_resume"],
                              max(qc_err["mk_resume"], qs_err["mk_resume"]), qc_work["mk_resume"]),
                "mk_start_chained": (qc_ms["mk_start_chained"], qc_plain["mk_start_chained"],
                                     qc_err["mk_start_chained"], qc_work["mk_start_chained"]),
                "mk_tiles": ([t5_on], [t_k5cp], k5c_err, [k5c_work])}
    for name, line in (("mk_start", 3000), ("mk_resume", 3041), ("mk_start_chained", 3015),
                       ("mk_tiles", 2778)):
        t_on, t_plain, err, works = cache_of[name]
        kernels.append(dict(
            name=f"{name}+cache", route="cuda", source=src + "megakernel.cu",
            replaces=f"{mkpy}:{line} (shadow_cache, _anyhit_pretest :1700)",
            launches=counts_q[f"{name}_cache"], max_abs_err=max(err, cache_err[name]),
            ms=sum(t_on), plain_ms=sum(t_plain), **summed(works),
            formats=["classic+boxes+cache, 1024x1024"] + [f"{c}+cache" for c in cache_cfgs]))
    kernels += probe_entries
    phase_seconds()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.monotonic()
    rc = main()
    print(f"# total {time.monotonic() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
