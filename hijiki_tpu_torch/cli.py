"""Command-line interface of the PyTorch/CUDA port — the flags of
``hijiki_tpu/cli.py`` that the ported drivers run, plus ``--device``.

Usage:
    python -m hijiki_tpu_torch.cli scene.obj --put-cbox-spheres --use-bvh \\
        --driver mega -w 1024 -H 1024 -s 8 -o out.exr

The port's default driver is ``mega`` (the card's fast path); the JAX
package's is ``sync``. All three compute the same estimator. ``--devices
N`` shards each sweep over N devices (``parallel/multichip.py``: row bands
for the mega driver, blocks otherwise): the first N cards, or N virtual
devices with ``--device cpu``. The TPU walker's knobs (``--mega-packet``,
``--mega-groups``, ``--spec-resolve``, ``--mega-trunk``,
``--mega-window``) are accepted (``--sort-lanes`` with a packet other than
128 raises JAX's ValueError); the per-thread walk has no packet and gives
the same image whatever their values.
``--profile-dir`` writes a torch.profiler trace of the render.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# --platform names the device as JAX names its platform
PLATFORM_DEVICE = {"cpu": "cpu", "gpu": "cuda"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hijiki-tpu-torch", description="Path tracer, PyTorch/CUDA port"
    )
    p.add_argument(
        "scene",
        help="The scene to render: an OBJ file, or builtin:<name> "
        "(cornell, cornell-spheres, cornell-glass)",
    )
    p.add_argument("--put-cbox-spheres", action="store_true",
                   help="Add a mirror and a checkerboard sphere to the scene")
    p.add_argument("--put-dielectric-sphere", action="store_true",
                   help="Add a clear glass sphere (the reference's commented-out variant)")
    p.add_argument("--use-bvh", action="store_true",
                   help="Use a BVH to optimize intersections: the sync and wavefront drivers "
                   "walk the trace rows (the CUDA kernel on a card), else test every "
                   "primitive; the mega driver always walks")
    p.add_argument("-w", "--width", type=int, default=800)
    p.add_argument("-H", "--height", type=int, default=600)
    p.add_argument("-s", "--sample-count", type=int, default=64)
    p.add_argument("--present-interval", type=int, default=0,
                   help="Write a PNG preview every N sweeps (0 = off)")
    p.add_argument("-o", "--output-image", default="output.exr")
    p.add_argument("--preview-image", default="preview.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument(
        "--packed-leaf",
        default="auto",
        help="Megakernel trace-row format: auto (pack 4-prim 64-col rows for scenes "
        "whose classic table passes 8 MiB, classic rows otherwise), 0 = classic, "
        "1 = SLIM 16-col rows, 2-3 = 32-col 3-prim rows, 4 = 64-col 4-prim rows, "
        "5+ = 128-col 12-prim rows (scene/compile.py packed_leaf)",
    )
    p.add_argument("--mega-packet", type=int, default=0,
                   help="Megakernel packet width (lanes per traversal cursor of the TPU's "
                   "packet walk); 0 = auto. The per-thread walk has no packet: the same "
                   "image at any value")
    p.add_argument("--mega-groups", type=int, default=0,
                   help="Independent cursor groups per megakernel tile (the TPU's grouped "
                   "walker); 0 = auto; the same image at any value")
    p.add_argument("--spec-resolve", type=int, default=0,
                   help="Pipelined winner-resolve loop (bitwise-equal outputs); 0 = auto, "
                   "1 = on, -1 = off")
    p.add_argument("--mega-trunk", type=int, default=0,
                   help="VMEM trunk cache rows for HBM-streamed trace tables (bitwise-equal "
                   "outputs; the port streams no table and reads none); 0 = auto, "
                   "-1 = off, N = first N rows")
    p.add_argument("--mega-window", type=int, default=0,
                   help="h-row window DMA for HBM-streamed trace tables (bitwise-equal "
                   "outputs; the port streams no table and reads none); 0 = auto "
                   "(off), 1 = off, h > 1 = window height")
    p.add_argument(
        "--mega-shadow",
        type=int,
        default=0,
        help="Dedicated any-hit shadow table for the megakernel's NEE walk (the same "
        "image; fewer shadow row visits): 0 = auto (off), 1 = on, -1 = off",
    )
    p.add_argument("--max-bounces", type=int, default=1000)
    p.add_argument("--metrics-json", default=None,
                   help="Write render metrics as one JSON object to this path ('-' for stdout)")
    p.add_argument("--checkpoint", default=None,
                   help="Checkpoint file to write, and to resume from if it exists")
    p.add_argument("--checkpoint-interval", type=int, default=0,
                   help="Sweeps between checkpoints")
    p.add_argument("--driver", choices=["sync", "wavefront", "mega"], default="mega",
                   help="Execution driver: mega (the megakernel, default), sync "
                   "(bulk-synchronous, the JAX package's default) or wavefront "
                   "(regenerating lane pool)")
    p.add_argument("--sort-lanes", action="store_true",
                   help="Coherence-sort the lanes between bounces: the wavefront driver's "
                   "pool, or each tile of the mega driver's launches (unchained); the "
                   "image is the same")
    p.add_argument("--fixed-albedo", action="store_true",
                   help="Populate the albedo AOV (the reference declares it but never "
                   "assigns it), activating the reconstruction's albedo feature term; "
                   "sync/mega drivers; default off = reference parity")
    p.add_argument("--live-preview", type=int, default=0,
                   help="Redraw a live ANSI preview in the terminal every N sweeps; 0 = off")
    p.add_argument("--chain-sweeps", type=int, default=0,
                   help="Sweep samples chained per megakernel launch (in-kernel lane "
                   "respawn); 1 = off, 0 = auto (8 on a CUDA device, off on the CPU)")
    p.add_argument("--trace-json", default=None,
                   help="Write a Chrome-trace timeline of the driver loop (chunk "
                   "dispatches, film sync, overflow retries, checkpoint saves) to "
                   "this path; load in chrome://tracing or ui.perfetto.dev")
    p.add_argument("--profile-dir", default=None,
                   help="Write a torch.profiler trace of the render (CPU and, on a card, "
                   "CUDA activity; a Chrome trace, trace.json) to this directory")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the CUDA kernels) or cpu (their plain twins)")
    p.add_argument("--platform", default=None, choices=("cpu", "gpu", "tpu"),
                   help="An alias of --device: cpu, or gpu (= cuda); tpu is the JAX "
                   "package's platform")
    p.add_argument("--devices", type=int, default=1,
                   help="Shard each sweep over this many devices: row bands (mega driver) "
                   "or blocks (sync, wavefront); the first N CUDA cards, or N virtual "
                   "devices with --device cpu")
    return p


def profiled_render(renderer, progress, out_dir: str) -> dict:
    """``renderer.render`` under torch.profiler (CPU activity, and CUDA
    activity on a card); the Chrome trace goes to ``out_dir``/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if renderer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        metrics = renderer.render(progress=progress)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"\nProfile: {path}")
    return metrics


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.fixed_albedo and args.driver == "wavefront":
        print("--fixed-albedo requires the sync or mega driver", file=sys.stderr)
        return 2
    if args.platform == "tpu":
        print("--platform tpu: the port runs on CUDA cards or the CPU; the TPU is the "
              "JAX package's (python -m hijiki_tpu.cli)", file=sys.stderr)
        return 2
    if args.platform:
        args.device = PLATFORM_DEVICE[args.platform]

    from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene

    t0 = time.monotonic()
    if args.scene.startswith("builtin:"):
        from hijiki_tpu_torch.scene.presets import load_preset

        scene = load_preset(args.scene[len("builtin:"):])
    else:
        scene = load_obj_scene(args.scene)
    if args.put_cbox_spheres:
        scene.put_cbox_spheres()
    if args.put_dielectric_sphere:
        scene.put_dielectric_sphere()
    packed_leaf = args.packed_leaf
    if packed_leaf != "auto":
        packed_leaf = int(packed_leaf)
    compiled = compile_scene(scene, packed_leaf=packed_leaf)
    print(
        f"Compiled scene: {compiled.num_spheres} spheres, {compiled.num_quads} quads, "
        f"{compiled.num_triangles} triangles, {compiled.num_emitters} emitters, "
        f"{compiled.num_bvh_nodes} BVH nodes ({time.monotonic()-t0:.2f}s)"
    )
    config = RenderConfig(
        width=args.width,
        height=args.height,
        spp=args.sample_count,
        block_size=args.block_size,
        seed=args.seed,
        use_bvh=args.use_bvh,
        max_bounces=args.max_bounces,
        preview_interval=args.present_interval,
        preview_path=args.preview_image,
        driver=args.driver,
        sort_lanes=args.sort_lanes,
        fixed_albedo=args.fixed_albedo,
        chain_sweeps=args.chain_sweeps,
        live_preview=args.live_preview,
        mega_shadow=args.mega_shadow,
        mega_packet=args.mega_packet,
        mega_groups=args.mega_groups,
        spec_resolve=args.spec_resolve,
        mega_trunk=args.mega_trunk,
        mega_window=args.mega_window,
    )
    cls, kwargs = Renderer, {}
    if args.devices > 1:
        from hijiki_tpu_torch.parallel.multichip import MegaMultiChipRenderer, MultiChipRenderer

        cls = MegaMultiChipRenderer if args.driver == "mega" else MultiChipRenderer
        kwargs = dict(num_devices=args.devices)
    if args.checkpoint and os.path.exists(args.checkpoint):
        # the checkpoint holds the whole film and the sweep cursor, so it
        # resumes across device counts
        renderer = cls.resume_checkpoint(compiled, args.checkpoint, config, device=args.device,
                                         **kwargs)
        print(f"Resumed from {args.checkpoint} at sweep {renderer.sweeps_done}")
    else:
        renderer = cls(compiled, config, device=args.device, **kwargs)
    print("Starting to render...")
    if args.trace_json:
        from hijiki_tpu_torch.utils.tracing import SpanTracer

        renderer.tracer = SpanTracer()
    last_ckpt = [renderer.sweeps_done]

    def progress(done, total):
        sys.stdout.write(f"\rRendering... {100.0 * done / total:5.1f}% ({done}/{total} sweeps)")
        sys.stdout.flush()
        if (
            args.checkpoint
            and args.checkpoint_interval
            and done - last_ckpt[0] >= args.checkpoint_interval
        ):
            renderer.save_checkpoint(args.checkpoint)
            last_ckpt[0] = done

    # on Ctrl-C, save the partial render (the reference saves the image when
    # its preview window closes mid-render, src/main.rs:1349-1352) and a
    # resumable checkpoint
    interrupted = False
    try:
        if args.profile_dir:
            metrics = profiled_render(renderer, progress, args.profile_dir)
        else:
            metrics = renderer.render(progress=progress)
    except KeyboardInterrupt:
        interrupted = True
        metrics = renderer.metrics or dict(
            primary_rays=0, render_seconds=0.0, mrays_per_second=0.0, spp_per_second=0.0
        )
        print(f"\nInterrupted at sweep {renderer.sweeps_done}; saving partial render")
    print()
    if not interrupted:
        print(
            f"Integrated {metrics['primary_rays']} rays in {metrics['render_seconds']:.3f}s "
            f"({metrics['mrays_per_second']:.3f} Mrays/s, "
            f"{metrics['spp_per_second']:.2f} spp/s) on {args.device}"
            + (f" x {args.devices} devices" if args.devices > 1 else "")
        )
        if "mean_path_length" in metrics:
            print(f"Mean path length {metrics['mean_path_length']:.2f} segments/sample")
    if args.trace_json and renderer.tracer is not None:
        renderer.tracer.write(args.trace_json)
        print(f"Trace: {args.trace_json}")
    if args.metrics_json:
        payload = dict(
            metrics={k: (list(map(float, v)) if isinstance(v, list) else float(v))
                     for k, v in metrics.items()},
            sweeps_done=renderer.sweeps_done,
            interrupted=interrupted,
            device=args.device,
            devices=args.devices,
            config=dict(width=args.width, height=args.height, spp=args.sample_count,
                        seed=args.seed, driver=args.driver, block_size=args.block_size,
                        max_bounces=args.max_bounces, use_bvh=args.use_bvh,
                        sort_lanes=args.sort_lanes, fixed_albedo=args.fixed_albedo),
        )
        if args.metrics_json == "-":
            print(json.dumps(payload))
        else:
            with open(args.metrics_json, "w") as f:
                json.dump(payload, f, indent=1)
            print(f"Metrics: {args.metrics_json}")
    if renderer.sweeps_done > 0:
        renderer.save_exr(args.output_image)
        print(f"Wrote {args.output_image}")
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)
        print(f"Checkpoint at sweep {renderer.sweeps_done}: {args.checkpoint}")
    return 130 if interrupted else 0


if __name__ == "__main__":
    sys.exit(main())
