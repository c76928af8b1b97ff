"""Profile the PyTorch/CUDA port's slice on the card: where a sweep's time
goes (kernels by name, host gaps) and the device's busy share.

    python tools/profile_torch_slice.py [--size 1024] [--spp 8] [--trace out.json]

Renders the meshbox (+ cbox spheres) once to warm up, then renders again
under torch.profiler (CPU + CUDA activities) and prints device time by
kernel, the sum of device kernel time, the wall time and their ratio.
Needs a CUDA card; imports only the port.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    scene = load_obj_scene(os.path.join(HERE, "..", "scenes", "meshbox", "meshbox.obj"))
    scene.put_cbox_spheres()
    cs = compile_scene(scene)
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp)
    Renderer(cs, cfg, device="cuda").render()  # warm-up: build, caches, allocator
    r = Renderer(cs, cfg, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        m = r.render()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = prof.key_averages()
    # device-side events only (kernels, memcpy/memset): CPU ops also carry
    # the device time of the kernels they launched, which would count twice
    rows = sorted(
        (e for e in events if str(e.device_type).endswith("CUDA")),
        key=lambda e: -getattr(e, "self_device_time_total", 0),
    )
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in rows)
    print(f"render {m['render_seconds']:.4f} s ({m['mrays_per_second']:.3f} Mrays/s); profiled wall {wall:.4f} s")
    print(f"{'device us':>12} {'calls':>7}  name")
    for e in rows[:20]:
        print(f"{getattr(e, 'self_device_time_total', 0):12.1f} {e.count:7d}  {e.key[:90]}")
    print(f"device busy {busy_us / 1e6:.4f} s of {wall:.4f} s wall: busy share {busy_us / 1e6 / wall:.3f}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
