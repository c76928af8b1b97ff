"""Profile the PyTorch/CUDA port's slice on the card: where a sweep's time
goes (kernels by name, host gaps) and the device's busy share.

    python tools/profile_torch_slice.py [--driver mega|sync|wavefront] [--size 1024]
                                        [--spp 8] [--chain-sweeps 0] [--sort-lanes]
                                        [--bands 1] [--trace out.json]

Renders the meshbox (+ cbox spheres) once to warm up, then renders again
under torch.profiler (CPU + CUDA activities) and prints device time by
kernel, per render and per chunk (a chained launch of S sweeps, or one
sweep), the device time grouped into the hand-written kernels (K1-K5 the
megakernel launches, K3 reconstruct, K6 traverse) and everything else (the
torch ops), the sum of device time, the wall time, their ratio (the busy
share), the device-to-host and host-to-device copies (each host read of a
device value is one and waits for the device) and the peak device memory. ``--chain-sweeps`` (mega driver): 0 =
auto (chained, 8 sweeps per launch, on a card), 1 = unchained, S = S
sweeps. ``--sort-lanes``: the lane-sorted launches (K7 inside K1/K2; the
mega driver then runs unchained). ``--bands N`` (mega driver): N row bands
on the one card, a stream each (``MegaMultiChipRenderer`` over N entries of
cuda:0); their kernels may overlap, so the device time of the kernels'
union is printed beside their sum. Needs a CUDA card; imports only the
port.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

# kernel-name fragments of the hand-written kernels, in report order; a
# kernel counts in the first group one of whose fragments its name holds
# (the sorted kernels are their own, or, in older trees, K1/K2/K5 templates
# on <true>); the megakernels' instantiations for each trace-row format,
# mk_start_kernel<0, false> and the like (demangled), count in their
# kernel's group
GROUPS = (("K6 traverse", ("traverse_kernel",)), ("K3 reconstruct", ("reconstruct_kernel",)),
          ("K4 mk_start_chained", ("mk_start_chained_kernel",)),
          ("K7 in K1 mk_start_sorted", ("mk_start_sorted_kernel", "mk_start_kernel<true>")),
          ("K7 in K2 mk_resume_sorted", ("mk_resume_sorted_kernel", "mk_resume_kernel<true>")),
          ("K7 in K5 mk_tiles_sorted", ("mk_tiles_sorted_kernel", "mk_tiles_kernel<true>")),
          ("K1 mk_start", ("mk_start_kernel",)), ("K2 mk_resume", ("mk_resume_kernel",)),
          ("K5 mk_tiles", ("mk_tiles_kernel",)))


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--driver", choices=["mega", "sync", "wavefront"], default="mega")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--chain-sweeps", type=int, default=0,
                   help="sweeps per chained launch: 0 = auto, 1 = unchained")
    p.add_argument("--sort-lanes", action="store_true",
                   help="lane-sorted megakernel launches (K7; unchained)")
    p.add_argument("--bands", type=int, default=1,
                   help="mega driver: row bands on the one card, a stream each")
    p.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    scene = load_obj_scene(os.path.join(HERE, "..", "scenes", "meshbox", "meshbox.obj"))
    scene.put_cbox_spheres()
    cs = compile_scene(scene)
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp, driver=args.driver,
                       chain_sweeps=args.chain_sweeps, sort_lanes=args.sort_lanes)
    if args.bands > 1:
        from hijiki_tpu_torch.parallel.multichip import MegaMultiChipRenderer

        make = lambda: MegaMultiChipRenderer(cs, cfg, devices=["cuda:0"] * args.bands)
    else:
        make = lambda: Renderer(cs, cfg, device="cuda")
    make().render()  # warm-up: build, caches, allocator
    r = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    chunks = len(m["sweep_marks"])
    print(f"render {m['render_seconds']:.4f} s ({m['mrays_per_second']:.3f} Mrays/s), "
          f"{chunks} chunks of {m['chain_chunk_sweeps']} sweeps; profiled wall {wall:.4f} s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"{'device us':>12} {'per chunk':>10} {'calls':>7}  name")
    for e in rows[:20]:
        t = getattr(e, "self_device_time_total", 0)
        print(f"{t:12.1f} {t / chunks:10.1f} {e.count:7d}  {e.key[:90]}")
    left = busy_us
    group_of = {id(e): next((label for label, frags in GROUPS if any(f in e.key for f in frags)), None)
                for e in rows}
    for label, _ in GROUPS:
        mine = [e for e in rows if group_of[id(e)] == label]
        t = sum(getattr(e, "self_device_time_total", 0) for e in mine)
        n = sum(e.count for e in mine)
        if n:
            left -= t
            print(f"{label}: {t / 1e3 / chunks:.3f} ms per chunk ({n} launches in the render)")
    print(f"torch ops and copies: {left / 1e3 / chunks:.3f} ms per chunk")
    # each device-to-host copy is a host read that waits for the device
    for kind in ("DtoH", "HtoD"):
        n = sum(e.count for e in rows if e.key.startswith(f"Memcpy {kind}"))
        print(f"Memcpy {kind}: {n} copies in the render ({n / chunks:.1f} per chunk)")
    if "iterations_last_sweep" in m:
        print(f"{m['iterations_last_sweep']} bounce iterations in the last sweep")
    print(f"device busy {busy_us / 1e6:.4f} s of {wall:.4f} s wall: busy share {busy_us / 1e6 / wall:.3f}; "
          f"per chunk {busy_us / 1e3 / chunks:.3f} ms busy, {(wall * 1e6 - busy_us) / 1e3 / chunks:.3f} ms idle")
    # the union of the device events' intervals: kernels on two streams
    # that run at once count once
    union, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if str(e.device_type).endswith("CUDA")):
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    print(f"device busy (union of intervals) {union / 1e6:.4f} s: busy share {union / 1e6 / wall:.3f}, "
          f"overlap {(busy_us - union) / 1e3 / chunks:.3f} ms per chunk")
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
