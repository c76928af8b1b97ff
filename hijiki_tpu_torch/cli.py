"""Command-line interface of the PyTorch/CUDA port — the subset of
``hijiki_tpu/cli.py`` that the ported mega driver runs, plus ``--device``.

Usage:
    python -m hijiki_tpu_torch.cli scene.obj --put-cbox-spheres --use-bvh \\
        --driver mega -w 1024 -H 1024 -s 8 -o out.exr

Flags of ``hijiki_tpu.cli`` that are not ported yet are refused with an
error that says so.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# hijiki_tpu.cli flags the port does not have yet (any value is refused)
NOT_PORTED = (
    "--put-dielectric-sphere", "--present-interval", "--preview-image",
    "--packed-leaf", "--checkpoint", "--checkpoint-interval", "--sort-lanes",
    "--fixed-albedo", "--live-preview", "--mega-packet", "--mega-groups",
    "--chain-sweeps", "--spec-resolve", "--mega-trunk", "--mega-window",
    "--mega-shadow", "--profile-dir", "--trace-json", "--devices", "--platform",
)


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
    p.add_argument("--use-bvh", action="store_true",
                   help="Use a BVH to optimize intersections (the mega driver always does)")
    p.add_argument("-w", "--width", type=int, default=800)
    p.add_argument("-H", "--height", type=int, default=600)
    p.add_argument("-s", "--sample-count", type=int, default=64)
    p.add_argument("-o", "--output-image", default="output.exr")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument("--max-bounces", type=int, default=1000)
    p.add_argument("--driver", choices=["mega"], default="mega",
                   help="Execution driver (only the megakernel driver is ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the CUDA kernels) or cpu (their plain twins)")
    p.add_argument("--metrics-json", default=None,
                   help="Write render metrics as one JSON object to this path ('-' for stdout)")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for a in argv:
        if a.split("=")[0] in NOT_PORTED:
            print(f"{a.split('=')[0]}: not ported yet", file=sys.stderr)
            return 2
    args = build_parser().parse_args(argv)

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
    compiled = compile_scene(scene)
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
        driver=args.driver,
    )
    renderer = Renderer(compiled, config, device=args.device)
    print("Starting to render...")

    def progress(done, total):
        sys.stdout.write(f"\rRendering... {100.0 * done / total:5.1f}% ({done}/{total} sweeps)")
        sys.stdout.flush()

    metrics = renderer.render(progress=progress)
    print()
    print(
        f"Integrated {metrics['primary_rays']} rays in {metrics['render_seconds']:.3f}s "
        f"({metrics['mrays_per_second']:.3f} Mrays/s, "
        f"{metrics['spp_per_second']:.2f} spp/s) on {args.device}"
    )
    if "mean_path_length" in metrics:
        print(f"Mean path length {metrics['mean_path_length']:.2f} segments/sample")
    if args.metrics_json:
        payload = dict(
            metrics={k: (list(map(float, v)) if isinstance(v, list) else float(v))
                     for k, v in metrics.items()},
            sweeps_done=renderer.sweeps_done,
            device=args.device,
            config=dict(width=args.width, height=args.height, spp=args.sample_count,
                        seed=args.seed, driver=args.driver, block_size=args.block_size,
                        max_bounces=args.max_bounces),
        )
        if args.metrics_json == "-":
            print(json.dumps(payload))
        else:
            with open(args.metrics_json, "w") as f:
                json.dump(payload, f, indent=1)
            print(f"Metrics: {args.metrics_json}")
    renderer.save_exr(args.output_image)
    print(f"Wrote {args.output_image}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
