"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases, each printing as it goes; any failure exits non-zero:

1. device: a CUDA card must be present (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles hijiki_tpu_torch/csrc/*.cu with nvcc, one process per
   source (seconds printed);
3. K3, the reconstruction kernel, against its plain twin on the card at
   1024x1024 and at 1024 x 1000 (a width that is no multiple of the block),
   numpy-seeded inputs with NaN pixels: rtol 1e-5, atol 1e-6 (expf ULPs);
4. quick gates on the full meshbox + spheres at 64x64, max_bounces 24,
   each kernel against its twin on the card with the final RNG state
   bit-equal on >= 99.5% of paths and radiance within rtol/atol 2e-3 on
   those: K1 (cap 5), K2 (resume to 24), K5 (single launch), K4 (S = 3
   chained samples, chain cap 8); K5 equal to K1 at cap max_bounces on
   every channel; render_waves equal to render_tiles on every RNG state;
   render_waves_chained bit-equal per sweep to 3 separate render_waves;
   K6 (the trace-row walk), closest and any hit, bit-equal to its twin on
   every output of 64x64 camera rays and 64x64 random rays (inactive
   lanes, finite and infinite tmax); K8 (sort_tiles, the block sort alone)
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
5. the paths, each driven with the launch counts set to 0 just before and
   read just after, each with a finite film, mean > 0, overflow 0 and
   every kernel of the path launched:
   (a) the chained slice: Renderer(device="cuda") at 1024x1024, 8 spp,
       max_bounces 1000, chaining on auto (8 sweeps per launch: K4, K2,
       K3), EXR written and read back, peak device memory;
   (b) the unchained slice (chain_sweeps=1: K1, K2, K3), its film equal
       to (a)'s within rtol 1e-5 / atol 1e-6 (the order of the film adds);
   (i) the lane-sorted slice: Renderer(sort_lanes=True) at 1024x1024, 8
       spp (chaining off by rule: the sorted K1 and K2, K3), its film
       bit-equal to (b)'s;
   (c) the overflow retry at 256x256, 8 spp, chain cap 2, phase_shrink
       (9999,): paths drop and are re-rendered; the film bit-equal to the
       same render at phase_shrink (1,)*8;
   (d) checkpoint and resume at 256x256: saved at sweep 4 of 8 from the
       progress callback, resumed in a new Renderer: film bit-equal to the
       uninterrupted render;
   (e) the single-launch render_tiles (K5) over the 1024x1024 frame, then
       lane-sorted (the sorted K5), bit-equal to it;
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
       meshbox_small against rows (RNG bit-equal on >= 99.5% of paths);
   (j) K8 alone: sort_tiles on 1,024 tiles (1M lanes) x 31 channels;
6. the kernels at the main path's shapes: one chained chunk (8 x 1M slots)
   and one unchained sweep again, recording the inputs of every K4, K1 and
   K2 call (K4 to cap 8; its parked paths resumed at capacity 2M to cap 48,
   then to 1000; K1 to cap 5 and K2 to caps 12, 48, 1000), each call
   replayed through the kernel and through the twin, held to the phase-4
   bounds and timed; K5 on the 1M-path frame and K3 on a sweep likewise;
   K6's calls of one 1024x1024 sync sweep: the first bounce's closest walk
   (1M rays), its shadow any-hit walk and the closest walk of bounce 9,
   each replayed through the kernel and the twin, bit-equal, and timed
   (plus K6's device time over every call of that sweep, from
   torch.profiler, and a check that three bounces of the sync integrator
   make no device sync under torch.cuda.set_sync_debug_mode("error"));
   every K1 and K2 call of the unchained sweep replayed through the sorted
   kernel too (bit-equal to the unsorted kernel, held to its sorted plain
   version with the phase-4 bounds and its order record bit-equal to the
   plain version's, and timed beside the unsorted one), K5 sorted on the
   frame likewise; K8 at 1M lanes x 31 channels, bit-equal to
   its plain version, timed beside torch.sort(stable=True) + gather;
7. probes: K10/K11a vs plain, then timed (hijiki_tpu_torch/probes/): each
   of walk_ablate (K10a), walk_isolate (K10b), latency_chain and
   staged_chase (K11a) bit-equal to its plain version at 4096 threads
   (every mode and variant) and at 1M threads with a short trip count
   (timed there beside the plain version); then (k) a short run of each
   probe's main() at one warp per SM and at 1M threads (slope timings,
   launches counted as a path's).

The line before the last is the kernel report {"kernels": [...]}, whose
errors and times come from phase 6 (K3's error also from phase 3) and
whose launch counts come from phase 5 (K4, K2, K3 from path (a), K1 from
(b), K5 and the sorted K5 from (e), K6 from (f), the sorted K1+K2 from (i),
K8 from (j), the probes from (k)); each entry has its bound (bound_ms: the
larger of the bytes this run's data needs at 3.35 TB/s and its f32
operations at 67 TFLOP/s, counted from this run's row-visit counters at
ROW_OPS per row; a K2 resume counts every lane's alive flag and the state
of its live lanes only, a K6 walk the o and d of the rays that walk and
the six outputs of the TPU kernel's contract; a sorted kernel the work of
its unsorted twin, the sort touching no device memory; K8 its key and
channels read and written once) and library_ms null (no PyTorch call
computes a BVH walk, a path trace or the feature-weighted bilateral
stencil), except K8's: torch.sort(stable=True) + gather, which orders ties
otherwise; a probe's bound is its inputs and outputs once against its
counted f32 operations (PROBE_OPS), and its library_ms null (no PyTorch call
runs a dependent chain of loads or a fixed-trip walk). The last line is
{"ok": true, "device": {...}}.
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
WAVEFRONT_SWEEPS = 8

# roofline of one H100 SXM (published peaks): HBM bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations counted per trace row a walk visits: the interior row's
# slab test (12 mul/add, 10 min/max, 1 add, 3 compares), the cheapest row;
# prim rows and shading are not counted, so the bound is a lower one
ROW_OPS = 26
# f32 operations per pixel and tap of the R = 2 reconstruction (feature
# distance, weight, NaN test, 4 accumulations)
TAP_OPS = 25
# f32 operations a thread-step of each probe: walk_ablate's full body (the
# slab test's ROW_OPS, the triangle test's 41: 3 sub, 9 for the cross
# product, 6 for the denominator and its reciprocal, 6 each for u, v and t,
# 7 compares and the sum u + v; the counter's add), latency_chain's fetch
# (one add) and chain (6 mul, 10 min/max, a compare, an add), and
# staged_chase's add a cursor and step (8 a warp-step, counted a thread as
# 8/32); walk_isolate counts ROW_OPS a row visited, as K6 does
PROBE_OPS = {"walk_ablate": ROW_OPS + 41 + 1, "fetch": 1, "chain": 18, "staged": 8 / 32}
# threads of the probes' full-width runs: one per path of a 1024x1024 sweep
PROBE_THREADS = 1 << 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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


def bound(nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and f32
    operations over the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
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


def probe_phase(dev, drive, pab, pwk, pcl, pga) -> list:
    """Phase 7: the probe kernels (K10a, K10b, K11a) bit-equal to their plain
    versions at 4096 threads, every mode, and at 1M threads with a short
    trip count (timed beside the plain version); then (k) a short run of
    each probe's main(), whose launches are counted as a path's. Returns
    the probes' entries of the kernel report."""
    import numpy as np
    import torch

    phase("probes: K10/K11a vs plain, then timed")
    t_phase = time.monotonic()
    ms, cs = pwk.load_scene(SCENE, dev)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    err = dict(walk_ablate=0.0, walk_isolate=0.0, latency_chain=0.0, staged_chase=0.0)

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
    tables = {32: ms.rows, 16: pwk.w16_rows(ms.rows).contiguous()}
    for rays in ("camera", "random"):
        o, d = pwk.ray_set(rays, cs, n, dev, frame=64)
        for name, (w, test) in pwk.VARIANTS.items():
            for g in (1, 32):
                same(f"walk_isolate {rays} {name} G={g}", "walk_isolate",
                     pwk.walk_isolate(ms, tables[w], o, d, test=test, group=g, iters=2),
                     pwk.walk_isolate_plain(ms, tables[w], o, d, test=test, group=g))
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
    for mode, h in (("indep", 1), ("indep", 2), ("indep", 4), ("chase", 1), ("sharedsem", 1),
                    ("sharedsem+noclamp", 1), ("dedup", 1)):
        dtbl = T(pcl.dma_table(65536, height=h))
        same(f"staged_chase {mode} h={h}", "staged_chase", pcl.staged_chase(dtbl, 128, it, mode, h),
             pcl.staged_plain(dtbl, 128, it, mode, h))
    dtbl = T(pcl.dma_table(65536, height=2))
    for g, spec in ((1, False), (2, False), (4, False), (1, True), (2, True), (4, True)):
        same(f"staged_chase multi G={g} spec={spec}", "staged_chase",
             pcl.staged_chase(dtbl, 128, it, "multi", nchains=g, spec=spec),
             pcl.staged_multi_plain(dtbl, 128, it, g, spec))
    print(f"probes at {n} threads: every kernel bit-equal to its plain version (walk_ablate: 11 "
          "variants x G 1, 32; walk_isolate: w32/w16 x test/notest x G 1, 32 x camera/random "
          "rays; latency_chain: alu, vote, fetch, chain, gather; staged_chase: 7 dma modes, 6 "
          "multi)", flush=True)

    # 1M threads, a short trip count: agreement, times and bounds
    N = PROBE_THREADS
    full = {}
    ro, rd = pwk.ray_set("random", cs, N, dev)
    co, cd = pwk.ray_set("camera", cs, N, dev)
    runs = [
        ("walk_ablate", "full, G=1, 1M random rays, 16 steps",
         lambda: pab.walk_ablate(ms.rows, ro, rd, 16, {}, 1),
         lambda: pab.walk_ablate_plain(ms.rows, ro, rd, 16, {}, 1),
         lambda got: (nbytes(ms.rows, ro, rd, got), N * 16 * PROBE_OPS["walk_ablate"])),
        ("walk_isolate", "w32, G=1, 1024x1024 camera rays, one walk",
         lambda: pwk.walk_isolate(ms, ms.rows, co, cd),
         lambda: pwk.walk_isolate_plain(ms, ms.rows, co, cd),
         lambda got: (nbytes(ms.rows, ms.consts, co, cd, *got), float(got[1].sum()) * ROW_OPS)),
        ("latency_chain", "fetch chase, 1M threads, 16 steps",
         lambda: pcl.fetch(ftbl, N, 16, "chase"),
         lambda: pcl.fetch_plain(ftbl, N, 16, "chase"),
         lambda got: (nbytes(ftbl, got), N * 16 * PROBE_OPS["fetch"])),
        ("staged_chase", "chase, 32768 warps (1M threads), 8 steps",
         lambda: pcl.staged_chase(dtbl, N // 32, 8, "chase"),
         lambda: pcl.staged_plain(dtbl, N // 32, 8, "chase"),
         lambda got: (nbytes(dtbl, got), N * 8 * PROBE_OPS["staged"])),
    ]
    for key, label, kern, plain, work in runs:
        t_k, got = timed(kern, reps=3)
        t_p, want = timed(plain, reps=1, warm=False)
        same(f"{key} ({label})", key, got, want)
        b_ms, b_by = bound(*work(got))
        full[key] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
        print(f"{key} ({label}): bit-equal to its plain version; {t_k:.3f} ms, plain {t_p:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)

    out_dir = os.path.join(HERE, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)

    def short_mains():
        j = lambda name: ["--json", os.path.join(out_dir, f"probe_{name}.json")]
        pab.main(["0", "1024", "full", "noprefetch", "--rays", "random", "camera"] + j("ablate"))
        pwk.main(["--variants", "w32", "w32-notest"] + j("walk"))
        pcl.main(["fetch"] + j("fetch"))
        pcl.main(["dma", "--rows", "65536", "262144"] + j("dma"))
        pga.main(j("gather"))

    _, counts_k = drive("(k) probes: short runs of each probe's main(), one warp per SM and 1M "
                        "threads", short_mains)
    for k in err:
        if counts_k[k] <= 0:
            fail(f"(k) the probes did not launch {k}")
    print(f"(k) launches {{{', '.join(f'{k!r}: {counts_k[k]}' for k in err)}}}; phase 7 took "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)
    src = "hijiki_tpu_torch/csrc/"
    replaces = dict(walk_ablate="tools/ablate_walker.py:187", walk_isolate="tools/walk_probe.py:84",
                    latency_chain="tools/chain_latency_probe.py:233",
                    staged_chase="tools/chain_latency_probe.py:508")
    return [dict(name=k, route="cuda", source=src + ("probe_walk.cu" if k.startswith("walk")
                                                     else "probe_latency.cu"),
                 replaces=replaces[k], launches=counts_k[k], max_abs_err=err[k],
                 ms=full[k]["ms"], plain_ms=full[k]["plain_ms"], bound_ms=full[k]["bound_ms"],
                 bound_by=full[k]["bound_by"], library_ms=None) for k in err]


def main() -> int:
    try:
        import numpy as np
        import torch

        from hijiki_tpu_torch.ops import megakernel as mk
        from hijiki_tpu_torch.ops import pallas_traverse as pt
        from hijiki_tpu_torch.ops import sort as srt
        from hijiki_tpu_torch.ops.camera import camera_rays
        from hijiki_tpu_torch.ops.integrate import (
            bounce_step, integrate, make_intersectors, start_lanes,
        )
        from hijiki_tpu_torch.ops.rng import from_bits, seed_rng
        from hijiki_tpu_torch.probes import ablate_walker as pab
        from hijiki_tpu_torch.probes import chain_latency_probe as pcl
        from hijiki_tpu_torch.probes import gather_probe as pga
        from hijiki_tpu_torch.probes import walk_probe as pwk
        from hijiki_tpu_torch.render import pallas_reconstruct as prc
        from hijiki_tpu_torch.render.reconstruct import reconstruct_sweep
        from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
        from hijiki_tpu_torch.scene.compile import compile_scene, to_device
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

    # ---- 4. quick gates: every megakernel launch against the twin ----
    phase("K1/K2/K4/K5 megakernel vs twin, 64x64")
    scene = load_obj_scene(SCENE)
    scene.put_cbox_spheres()
    cs = compile_scene(scene)
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
    agree("K1 (cap 5)", k1, mk.megakernel_start_plain(ms_small, px, py, seeds, 5))
    st0, rng0 = k1
    agree("K2 (resume to 24)", mk.megakernel_resume(ms_small, st0, rng0, 24),
          mk.megakernel_resume_plain(ms_small, st0, rng0, 24))
    k5 = mk.megakernel_tiles(ms_small, px, py, seeds, 24)
    agree_tiles("K5 (single launch to 24)", k5, mk.megakernel_tiles_plain(ms_small, px, py, seeds, 24))
    k1_full = mk.megakernel_start(ms_small, px, py, seeds, 24)
    if not (torch.equal(k5[0], k1_full[0][list(mk._TILE_CH)]) and torch.equal(k5[1], k1_full[1])):
        fail("K5 and K1 at cap max_bounces disagree")
    print("K5 == K1 at cap max_bounces on every channel and RNG state")
    agree_chained("K4 (3 samples, cap 8)", mk.megakernel_start_chained(ms_small, pxs, pys, sds, 8),
                  mk.megakernel_start_chained_plain(ms_small, pxs, pys, sds, 8))
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
    for name, args, un in (("K1", (px, py, seeds, 5), k1), ("K2", (st0, rng0, 24), None),
                           ("K5", (px, py, seeds, 24), k5)):
        real_fn, plain_fn, check_fn = {
            "K1": (mk.megakernel_start, mk.megakernel_start_plain, agree),
            "K2": (mk.megakernel_resume, mk.megakernel_resume_plain, agree),
            "K5": (mk.megakernel_tiles, mk.megakernel_tiles_plain, agree_tiles)}[name]
        label = f"{name} sorted (cap {args[-1]})"
        got = real_fn(ms_small, *args, lane_sort=True, lane_order=True)
        want = plain_fn(ms_small, *args, lane_sort=True, lane_order=True)
        check_fn(label, got[:2], want[:2])
        check_order(label, mk, ms_small, got, want)
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

    # ---- 5. the paths ----
    def drive(label, fn):
        """Run one path with every launch count set to 0 just before;
        returns (its result, the counts just after)."""
        phase(label)
        counters = (mk.LAUNCHES, prc.LAUNCHES, pt.LAUNCHES, srt.LAUNCHES, pab.LAUNCHES,
                    pwk.LAUNCHES, pcl.LAUNCHES)
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
    print(f"(a) peak device memory {peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated)")
    out_dir = os.path.join(HERE, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
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

    sync_cfg = dict(slice_cfg, driver="sync")
    rf = Renderer(cs, RenderConfig(**sync_cfg), device="cuda")
    snap = {}

    def keep_film(done, total):
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
    small_scene = load_obj_scene(SCENE_SMALL)
    small_scene.put_cbox_spheres()
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

    _, counts_j = drive("(j) K8 alone: sort_tiles, 1M lanes x 31 channels",
                        lambda: srt.sort_tiles(key8, ch8))
    if counts_j["sort_tiles"] <= 0:
        fail("(j) sort_tiles was not launched")

    # ---- 6. each kernel at the main path's shapes: agreement and time ----
    phase("kernels vs twins at the main path's shapes")
    real = {"mk_start": mk.megakernel_start, "mk_resume": mk.megakernel_resume,
            "mk_start_chained": mk.megakernel_start_chained}
    plain = {"mk_start": mk.megakernel_start_plain, "mk_resume": mk.megakernel_resume_plain,
             "mk_start_chained": mk.megakernel_start_chained_plain}
    check = {"mk_start": agree, "mk_resume": agree, "mk_start_chained": agree_chained}

    def work(name, args, got):
        """(bytes, f32 operations) of one megakernel call: the table once,
        ROW_OPS per trace row the call's paths visited (state channel 23 /
        flush channel 8 count them), and its inputs and outputs once. K2
        passes a lane that is not alive through unchanged, so a resume
        counts every lane's alive flag and the state and RNG of the live
        lanes, read and written."""
        table = nbytes(ms.rows, ms.consts)
        rows = got[0][23].sum()
        if name == "mk_resume":
            st, rng_in = args[0], args[1]
            rows = rows - st[23].sum()
            live = int((st[0] > 0).sum())
            lane_bytes = st.shape[0] * st.element_size() + rng_in.element_size()
            return (table + st.shape[1] * st.element_size() + 2 * live * lane_bytes,
                    float(rows) * ROW_OPS)
        if name == "mk_start_chained":
            rows = rows + got[2][8].sum()
        tensors = [a for a in args if torch.is_tensor(a)] + list(got)
        return table + nbytes(*tensors), float(rows) * ROW_OPS

    def replay(tag, calls):
        ms_of, plain_of, err_of, work_of = {}, {}, {}, {}
        for name, args in calls:
            t_k, got = timed(lambda: real[name](ms, *args), reps=3)
            t_p, want = timed(lambda: plain[name](ms, *args), reps=1, warm=False)
            lanes = "x".join(str(d) for d in args[-2].shape)  # the seeds or the RNG
            label = f"{tag} {name} ({lanes} lanes, cap {args[-1]})"
            err_of[name] = max(err_of.get(name, 0.0), check[name](label, got, want))
            ms_of.setdefault(name, []).append(t_k)
            plain_of.setdefault(name, []).append(t_p)
            work_of.setdefault(name, []).append(work(name, args, got))
            b_ms, b_by = bound(*work_of[name][-1])
            print(f"{label}: {t_k:.3f} ms, twin {t_p:.3f} ms, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
        return ms_of, plain_of, err_of, work_of

    scheds = [ra.scheduler.sweep(slice_cfg["spp"] + 1 + s) for s in range(mk.CHAIN_SWEEPS_CUDA)]
    frames = [frame_of(sc) for sc in scheds]
    cpx, cpy, cseeds = (torch.stack([f[i] for f in frames]) for i in range(3))
    chunk_calls = record_calls(mk, real, lambda: mk.render_waves_chained(ms, cpx, cpy, cseeds, max_bounces=1000))
    c_ms, c_plain, c_err, c_work = replay("chained chunk:", chunk_calls)
    t_zero, _ = timed(lambda: (torch.zeros((mk.N_STATE, cpx.numel()), device=dev),
                               torch.zeros((mk.CHAIN_OUT_CH, cpx.numel()), device=dev)), reps=5)
    print(f"K4's zeroed pool + flush buffer ({cpx.numel()} slots): {t_zero:.3f} ms per chunk")

    upx, upy, useeds, uso = frame_of(ra.scheduler.sweep(slice_cfg["spp"] + 1 + mk.CHAIN_SWEEPS_CUDA))
    sweep_out = []
    sweep_calls = record_calls(mk, real, lambda: sweep_out.append(
        mk.render_waves(ms, upx, upy, useeds, max_bounces=1000)))
    u_ms, u_plain, u_err, u_work = replay("unchained sweep:", sweep_calls)

    t_k5, got = timed(lambda: mk.megakernel_tiles(ms, upx, upy, useeds, 1000), reps=3)
    t_k5p, want = timed(lambda: mk.megakernel_tiles_plain(ms, upx, upy, useeds, 1000),
                        reps=1, warm=False)
    k5_err = agree_tiles(f"K5 mk_tiles ({upx.numel()} lanes, cap 1000)", got, want)
    # K5 traces K1's paths at cap max_bounces: K1's row counter counts K5's rows
    k5_rows = float(mk.megakernel_start(ms, upx, upy, useeds, 1000)[0][23].sum())
    k5_work = (nbytes(upx, upy, useeds, *got, ms.rows, ms.consts), k5_rows * ROW_OPS)
    print(f"K5 mk_tiles ({upx.numel()} lanes to 1000): {t_k5:.3f} ms, twin {t_k5p:.3f} ms, "
          f"bound {bound(*k5_work)[0]:.4f} ms ({bound(*k5_work)[1]})")

    # K7: the sweep's K1/K2 calls through the sorted kernels
    k7_ms, k7_unsorted, k7_plain, k7_err = [], [], [], 0.0

    def max_diff(got, want) -> float:
        """largest |got - want| over every value (NaN = NaN, bits as ints)"""
        return max(float((g.nan_to_num(0.0) - w.nan_to_num(0.0)).abs().max()) if g.is_floating_point()
                   else float((g.long() - w.long()).abs().max()) for g, w in zip(got, want))

    for name, args in sweep_calls:
        t_u, want = timed(lambda: real[name](ms, *args), reps=3)
        t_s, got = timed(lambda: real[name](ms, *args, lane_sort=True), reps=3)
        label = f"K7 sorted {name} ({args[-2].numel()} lanes, cap {args[-1]})"
        if not bit_equal(got, want):
            fail(f"{label} differs from the unsorted kernel")
        t_p, pl_out = timed(lambda: plain[name](ms, *args, lane_sort=True, lane_order=True),
                            reps=1, warm=False)
        k7_err = max(k7_err, agree(f"{label} vs its plain version", got, pl_out[:2]))
        rec = real[name](ms, *args, lane_sort=True, lane_order=True)
        if not bit_equal(rec[:2], got):
            fail(f"{label}: the launch with the order record differs from the one without")
        check_order(label, mk, ms, rec, pl_out)
        k7_ms.append(t_s)
        k7_unsorted.append(t_u)
        k7_plain.append(t_p)
        print(f"{label}: {t_s:.3f} ms against {t_u:.3f} ms unsorted (bit-equal), plain {t_p:.3f} ms",
              flush=True)
    t_k5s, got = timed(lambda: mk.megakernel_tiles(ms, upx, upy, useeds, 1000, lane_sort=True), reps=3)
    t_k5u, want = timed(lambda: mk.megakernel_tiles(ms, upx, upy, useeds, 1000), reps=3)
    if not bit_equal(got, want):
        fail("K5 sorted differs from K5 on the 1M-path frame")
    t_k5sp, pl_out = timed(lambda: mk.megakernel_tiles_plain(ms, upx, upy, useeds, 1000, lane_sort=True,
                                                             lane_order=True), reps=1, warm=False)
    k5s_err = agree_tiles("K5 sorted vs its plain version (1M paths to 1000)", got, pl_out[:2])
    rec = mk.megakernel_tiles(ms, upx, upy, useeds, 1000, lane_sort=True, lane_order=True)
    if not bit_equal(rec[:2], got):
        fail("K5 sorted: the launch with the order record differs from the one without")
    check_order("K5 sorted (1M paths to 1000)", mk, ms, rec, pl_out)
    print(f"K5 sorted ({upx.numel()} paths to 1000): {t_k5s:.3f} ms against {t_k5u:.3f} ms unsorted "
          f"(bit-equal), plain {t_k5sp:.3f} ms")

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

    total = sweep_out[0][0].reshape(H, W, 3).contiguous()
    normal = sweep_out[0][1].reshape(H, W, 3).contiguous()
    t_k3, got = timed(lambda: prc.reconstruct(total, normal, uso, block_size=128), reps=20)
    t_k3p, want = timed(lambda: reconstruct_sweep(total, normal, torch.zeros_like(total), uso,
                                                  block_size=128), reps=1, warm=False)
    k3_err = max(k3_err, check_k3("K3 on the sweep's radiance (1024x1024)", got, want))
    k3_work = (nbytes(total, normal, got), H * W * 25 * TAP_OPS)
    print(f"K3 reconstruct (1024x1024, device time of 20 back-to-back launches): "
          f"{t_k3:.3f} ms, twin {t_k3p:.3f} ms, bound {bound(*k3_work)[0]:.4f} ms "
          f"({bound(*k3_work)[1]})")

    # K6: the device time of every call of one 1024x1024 sync sweep, from
    # torch.profiler (CUDA events around each call would add the host's
    # launch latency: the loop is host-bound); the first bounce's closest
    # and shadow walks and bounce 9's closest walk recorded and replayed
    # through the kernel and the twin
    from torch.profiler import ProfilerActivity, profile

    real_traverse = pt.traverse
    k6_calls, n_calls = [], [0]

    def traverse_recorded(rows, o, d, tmin, tmax, *, any_hit=False):
        if n_calls[0] in (0, 1, 16):
            k6_calls.append((n_calls[0], (rows, o.clone(), d.clone(), tmin.clone(), tmax.clone()),
                             any_hit))
        n_calls[0] += 1
        return real_traverse(rows, o, d, tmin, tmax, any_hit=any_hit)

    kpx, kpy, kseeds, _ = frame_of(ra.scheduler.sweep(slice_cfg["spp"] + 21))
    ko, kd, ktmin, ktmax = camera_rays(csd.cam_position, csd.cam_rotation, csd.cam_fov,
                                       torch.stack([kpx, kpy], -1), (W, H))
    pt.traverse = traverse_recorded
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ksweep = integrate(csd, ko, kd, ktmin, ktmax, seed_rng(from_bits(kseeds)),
                               max_bounces=1000)
            torch.cuda.synchronize()
    finally:
        pt.traverse = real_traverse
    k6_events = [e for e in prof.key_averages() if "traverse_kernel" in e.key]
    k6_sweep_ms = sum(getattr(e, "self_device_time_total", 0) for e in k6_events) / 1e3
    k6_sweep_n = sum(e.count for e in k6_events)
    print(f"K6 in one sync sweep: {n_calls[0]} launches over {ksweep.iterations} bounces, "
          f"{k6_sweep_ms:.3f} ms of device time in all ({k6_sweep_n} kernels in the profile)")
    if k6_sweep_n != n_calls[0] or not k6_sweep_ms > 0:
        fail("the profiler did not see every K6 launch of the sweep")

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
    for idx, args, any_hit in k6_calls:
        t_k, got = timed(lambda: pt.traverse(*args, any_hit=any_hit), reps=5)
        t_p, want = timed(lambda: pt.traverse_plain(*args, any_hit=any_hit), reps=1, warm=False)
        label = (f"K6 call {idx} ({'any-hit' if any_hit else 'closest'}, bounce {idx // 2 + 1}, "
                 f"{int((args[4] >= args[3]).sum())} of {args[1].shape[0]} rays walking)")
        if not torch.equal(got, want):
            fail(f"{label}: the kernel differs from its twin")
        k6_err = max(k6_err, float((got - want).abs().nan_to_num(0.0).max()))
        k6_ms.append(t_k)
        k6_plain.append(t_p)
        k6_work.append(k6_bytes_ops(args, got))
        print(f"{label}: bit-equal on all 7 outputs; {float(got[6].sum()) / 1e6:.3f} M rows "
              f"visited; {t_k:.3f} ms, twin {t_p:.3f} ms, bound {bound(*k6_work[-1])[0]:.4f} ms "
              f"({bound(*k6_work[-1])[1]})", flush=True)
    if [c[0] for c in k6_calls] != [0, 1, 16]:
        fail("K6 replay: the sync sweep did not reach bounce 9")
    print(f"per chained chunk: K4 {sum(c_ms['mk_start_chained']):.3f} ms + K2 "
          f"{' + '.join(f'{t:.3f}' for t in c_ms['mk_resume'])} ms; per unchained sweep: K1 "
          f"{sum(u_ms['mk_start']):.3f} ms + K2 {' + '.join(f'{t:.3f}' for t in u_ms['mk_resume'])} ms")

    def summed(works):
        """bound of a list of calls: summed bytes and summed operations"""
        b_ms, b_by = bound(sum(w[0] for w in works), sum(w[1] for w in works))
        return dict(bound_ms=b_ms, bound_by=b_by, library_ms=None)

    probe_entries = probe_phase(dev, drive, pab, pwk, pcl, pga)

    src = "hijiki_tpu_torch/csrc/"
    mkpy = "hijiki_tpu/ops/pallas_megakernel.py"
    kernels = [
        dict(name="mk_start", route="cuda", source=src + "megakernel.cu",
             replaces=f"{mkpy}:3000", launches=counts_b["mk_start"],
             max_abs_err=u_err["mk_start"], ms=sum(u_ms["mk_start"]),
             plain_ms=sum(u_plain["mk_start"]), **summed(u_work["mk_start"])),
        dict(name="mk_resume", route="cuda", source=src + "megakernel.cu",
             replaces=f"{mkpy}:3041", launches=counts_a["mk_resume"],
             max_abs_err=max(c_err["mk_resume"], u_err["mk_resume"]),
             ms=sum(c_ms["mk_resume"]), plain_ms=sum(c_plain["mk_resume"]),
             **summed(c_work["mk_resume"])),
        dict(name="mk_start_chained", route="cuda", source=src + "megakernel.cu",
             replaces=f"{mkpy}:3015", launches=counts_a["mk_start_chained"],
             max_abs_err=c_err["mk_start_chained"], ms=sum(c_ms["mk_start_chained"]),
             plain_ms=sum(c_plain["mk_start_chained"]), **summed(c_work["mk_start_chained"])),
        dict(name="mk_tiles", route="cuda", source=src + "megakernel.cu",
             replaces=f"{mkpy}:2778", launches=counts_e["mk_tiles"],
             max_abs_err=k5_err, ms=t_k5, plain_ms=t_k5p, **summed([k5_work])),
        dict(name="reconstruct", route="cuda", source=src + "reconstruct.cu",
             replaces="hijiki_tpu/render/pallas_reconstruct.py:42",
             launches=counts_a["reconstruct"], max_abs_err=k3_err, ms=t_k3, plain_ms=t_k3p,
             **summed([k3_work])),
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
    ] + probe_entries
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
