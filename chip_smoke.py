"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases, each printing as it goes; any failure exits non-zero:

1. device: a CUDA card must be present (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles hijiki_tpu_torch/csrc/*.cu with nvcc (seconds printed);
3. K3, the reconstruction kernel, against its plain twin on the card at
   1024x1024 and at 1024 x 1000 (a width that is no multiple of the block),
   numpy-seeded inputs with NaN pixels: rtol 1e-5, atol 1e-6 (expf ULPs);
4. K1/K2, the megakernel's camera and resume launches, against the twin on
   the card, as a quick first gate: 64x64 paths on the full meshbox +
   spheres, max_bounces 24; final RNG state bit-equal on >= 99.5% of paths
   and radiance within rtol/atol 2e-3 on those;
5. the slice: Renderer(driver="mega", device="cuda") at 1024x1024, 8 spp,
   max_bounces 1000: finite film, mean radiance > 0, overflow 0, every
   kernel launched (counts reset just before the render), EXR written and
   read back;
6. one sweep of the slice again, recording the inputs of each K1/K2 call
   (1M lanes to cap 5; the compacted survivors to caps 12, 48 and 1000):
   every call replayed through the kernel and through the twin, held to
   the phase-4 bounds and timed; K3 likewise on the sweep's radiance.

The line before the last is the kernel report {"kernels": [...]}, whose
errors and times come from phase 6 (K3's error also from phase 3); the
last line is {"ok": true, "device": {...}}.
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


def agree(name: str, got, want) -> float:
    """K1/K2 against the twin: final RNG state bit-equal on >= 99.5% of
    paths and radiance within rtol/atol 2e-3 on those (the JAX suite's
    megakernel bounds); returns the radiance max abs error on those paths."""
    import numpy as np

    (gst, grng), (wst, wrng) = got, want
    same = (grng == wrng).cpu().numpy()
    gl, wl = gst[15:18].T.cpu().numpy(), wst[15:18].T.cpu().numpy()
    close = np.isclose(gl, wl, rtol=2e-3, atol=2e-3).all(-1)
    err = float(np.abs(gl - wl)[same].max()) if same.any() else float("inf")
    print(f"{name}: RNG equal on {same.mean():.4%} of paths, radiance max abs err "
          f"{err:.3e} on those, state bit-equal on {(gst == wst).all(0).float().mean().item():.4%}")
    if same.mean() < 0.995 or not close[same].all():
        fail(f"{name} disagrees with its twin")
    return err


def main() -> int:
    try:
        import numpy as np
        import torch

        from hijiki_tpu_torch.ops import megakernel as mk
        from hijiki_tpu_torch.render import pallas_reconstruct as prc
        from hijiki_tpu_torch.render.reconstruct import reconstruct_sweep
        from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
        from hijiki_tpu_torch.scene.compile import compile_scene
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
        if "registers" in line or "spill" in line:
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

    # ---- 4. K1/K2 against the twin ----
    phase("K1/K2 megakernel vs twin")
    scene = load_obj_scene(SCENE)
    scene.put_cbox_spheres()
    cs = compile_scene(scene)
    print(f"scene: {cs.num_triangles} triangles, {cs.num_spheres} spheres, "
          f"{cs.trace_rows_mega.shape[0]} trace rows, {cs.mega_num_tables_static} table(s)")
    S = 64
    ms_small = mk.mega_scene(cs, S, S, dev)
    y, x = np.mgrid[0:S, 0:S]
    px = torch.from_numpy((x + 0.37).ravel().astype(np.float32)).to(dev)
    py = torch.from_numpy((y + 0.61).ravel().astype(np.float32)).to(dev)
    seeds = (np.arange(S * S) * 2654435761 % (1 << 32)).astype(np.uint32)
    seeds = torch.from_numpy(seeds.view(np.int32)).to(dev)  # the u32 bits

    k1 = mk.megakernel_start(ms_small, px, py, seeds, 5)
    agree("K1 (cap 5)", k1, mk.megakernel_start_plain(ms_small, px, py, seeds, 5))
    st0, rng0 = k1
    agree("K2 (resume to 24)", mk.megakernel_resume(ms_small, st0, rng0, 24),
          mk.megakernel_resume_plain(ms_small, st0, rng0, 24))
    full = mk.render_tiles(ms_small, px, py, seeds, max_bounces=24)
    waves = mk.render_waves(ms_small, px, py, seeds, max_bounces=24, phase_bounces=(5, 12))
    if not torch.equal(full[3], waves[3]):
        fail("render_waves (phases) and render_tiles (one launch) disagree on RNG states")
    print("render_waves == render_tiles on every RNG state")

    # ---- 5. the slice ----
    phase("slice: Renderer(driver='mega', device='cuda') 1024x1024, 8 spp")
    cfg = RenderConfig(width=1024, height=1024, spp=8, max_bounces=1000, block_size=128,
                       use_bvh=True, driver="mega")
    r = Renderer(cs, cfg, device="cuda")
    for d in (mk.LAUNCHES, prc.LAUNCHES):
        for k in d:
            d[k] = 0
    metrics = r.render()
    launches = {**mk.LAUNCHES, **prc.LAUNCHES}
    film = r.film.cpu().numpy()
    img = r.image()
    print(f"render: {metrics['render_seconds']:.3f} s, {metrics['mrays_per_second']:.4f} Mrays/s, "
          f"{metrics['spp_per_second']:.3f} spp/s, mean path {metrics.get('mean_path_length', 0):.3f} "
          f"segments, overflow {metrics['wave_overflow']}, launches {launches}")
    if not np.isfinite(film).all():
        fail("film has non-finite values")
    if not img.mean() > 0:
        fail("mean radiance is not > 0")
    if metrics["wave_overflow"] != 0:
        fail("overflow != 0")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched by the main path")
    out_dir = os.path.join(HERE, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    exr = os.path.join(out_dir, "slice.exr")
    r.save_exr(exr)
    back = read_exr(exr)
    if back.shape != (1024, 1024, 3) or not np.array_equal(back, img.astype(np.float32)):
        fail("EXR round trip changed the image")
    print(f"EXR written and read back: mean {float(back.mean()):.5f}")

    # ---- 6. each kernel at the main path's shapes: agreement and time ----
    # One sweep of the slice again, recording the inputs of every K1/K2 call
    # render_waves makes (1M lanes to cap 5, then the compacted survivors to
    # caps 12, 48 and 1000); each call is then replayed through the kernel
    # and through its twin, held to the phase-4 bounds and timed.
    phase("kernels vs twins at the main path's shapes, one sweep")
    from hijiki_tpu_torch.ops.rng import to_bits
    from hijiki_tpu_torch.render.blocks import per_pixel_seeds_device

    sched = r.scheduler.sweep(cfg.spp)
    H = W = 1024
    so = torch.as_tensor(sched.sample_offset)
    yy = torch.arange(H, dtype=torch.float32, device=dev).view(-1, 1).expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev).view(1, -1).expand(H, W)
    spx = (xx + float(so[0])).reshape(-1).contiguous()
    spy = (yy + float(so[1])).reshape(-1).contiguous()
    sseeds = to_bits(per_pixel_seeds_device(W, H, 128, sched.block_seeds, dev).reshape(-1))
    ms = r.scene
    real = {"mk_start": mk.megakernel_start, "mk_resume": mk.megakernel_resume}
    plain = {"mk_start": mk.megakernel_start_plain, "mk_resume": mk.megakernel_resume_plain}
    calls = []

    def recorder(name):
        def call(ms_, *args):
            calls.append((name, tuple(a.clone() if torch.is_tensor(a) else a for a in args)))
            return real[name](ms_, *args)
        return call

    mk.megakernel_start, mk.megakernel_resume = recorder("mk_start"), recorder("mk_resume")
    try:
        tw = mk.render_waves(ms, spx, spy, sseeds, max_bounces=cfg.max_bounces)
    finally:
        mk.megakernel_start, mk.megakernel_resume = real["mk_start"], real["mk_resume"]
    ms_of = {"mk_start": 0.0, "mk_resume": 0.0}
    plain_ms_of = {"mk_start": 0.0, "mk_resume": 0.0}
    err_of = {"mk_start": 0.0, "mk_resume": 0.0}
    for name, args in calls:
        t_k, got = timed(lambda: real[name](ms, *args), reps=3)
        t_p, want = timed(lambda: plain[name](ms, *args), reps=1, warm=False)
        label = f"{name} ({args[-2].shape[-1]} lanes, cap {args[-1]})"
        err_of[name] = max(err_of[name], agree(label, got, want))
        ms_of[name] += t_k
        plain_ms_of[name] += t_p
        print(f"{label}: {t_k:.3f} ms, twin {t_p:.3f} ms")
    total = tw[0].reshape(H, W, 3).contiguous()
    normal = tw[1].reshape(H, W, 3).contiguous()
    t_k3, got = timed(lambda: prc.reconstruct(total, normal, so, block_size=128), reps=20)
    t_k3p, want = timed(lambda: reconstruct_sweep(total, normal, torch.zeros_like(total), so,
                                                  block_size=128), reps=1, warm=False)
    k3_err = max(k3_err, check_k3("K3 on the sweep's radiance (1024x1024)", got, want))
    print(f"K3 reconstruct (1024x1024, device time of 20 back-to-back launches): "
          f"{t_k3:.3f} ms, twin {t_k3p:.3f} ms")

    src = "hijiki_tpu_torch/csrc/"
    kernels = [
        dict(name="mk_start", route="cuda", source=src + "megakernel.cu",
             replaces="hijiki_tpu/ops/pallas_megakernel.py:3000", launches=launches["mk_start"],
             max_abs_err=err_of["mk_start"], ms=ms_of["mk_start"],
             plain_ms=plain_ms_of["mk_start"]),
        dict(name="mk_resume", route="cuda", source=src + "megakernel.cu",
             replaces="hijiki_tpu/ops/pallas_megakernel.py:3041", launches=launches["mk_resume"],
             max_abs_err=err_of["mk_resume"], ms=ms_of["mk_resume"],
             plain_ms=plain_ms_of["mk_resume"]),
        dict(name="reconstruct", route="cuda", source=src + "reconstruct.cu",
             replaces="hijiki_tpu/render/pallas_reconstruct.py:42", launches=launches["reconstruct"],
             max_abs_err=k3_err, ms=t_k3, plain_ms=t_k3p),
    ]
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
