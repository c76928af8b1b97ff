"""K9: the pre-hoisting reconstruction stencil, timed beside K3 on the H100.

Counterpart of tools/ab_reconstruct.py. ``reconstruct_old`` is the round-2
R = 2 bilateral stencil (_old_kernel, :37-116) that recomputes its spatial
weight and its block-splat masks at each of the 25 taps; K3
(render/pallas_reconstruct.py, csrc/reconstruct.cu) is the hoisted one the
render runs. Timing the two on the same inputs shows what the per-tap
arithmetic costs.

* ``reconstruct_old_plain``: the plain PyTorch version (any device), tap by
  tap in the tool's order and association;
* ``reconstruct_old``: the tool's signature; builds the (7, Hp, W) planes
  with torch ops as the tool does, then launches csrc/reconstruct_old.cu
  on a CUDA tensor (counted in ``LAUNCHES``) or runs the plain version on
  a CPU one. The kernel stages K3's halo tile and divides by the block
  size B through the multiplier and shift ``divisor_constants`` gives, as
  the tool's static B compiled to; its taps recompute what K3 hoists.

Usage (the tool's arguments):

    python -m hijiki_tpu_torch.probes.ab_reconstruct [W] [--device cuda|cpu] [--json out.json]
    python -m hijiki_tpu_torch.probes.ab_reconstruct instream [W]

The default mode prints whether K9 and K3 are bit-equal (and how many
pixels differ), then each launch's time by CUDA events. ``instream``
chains k = 1 and k = 17 K3 launches, each on the previous output's rgb,
and times the slope. On the card the tool's strip variants s8-s64 (TPU
VMEM blockings of K3) are K3 itself, which has no strip.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hijiki_tpu_torch.probes import call, card, device_of, dump, parser

R = 2
STRIP = 8  # the tool's row strip: the planes are padded to a multiple
SO = (0.37, 0.61)
BLOCK = 128
REPS = 20
K_HI = 17

# launches of the CUDA kernel (CPU calls of the plain version are not counted)
LAUNCHES = {"reconstruct_old": 0}


def constants(stddev: float = 0.5) -> tuple[float, float]:
    """(gauss_fac, curve_offset) as the f32 values the tool's kernel uses:
    curve_offset is math.exp in double, rounded to f32."""
    gauss_fac = -1.0 / (2.0 * stddev * stddev)
    return float(np.float32(gauss_fac)), float(np.float32(math.exp(gauss_fac * R * R)))


def divisor_constants(B: int) -> tuple[int, int]:
    """K9's constants for dividing by the block size B >= 1, a compiler's
    for a constant divisor: (m, s) with s = ceil(log2 B) and m =
    ceil(2^(31 + s) / B) < 2^32, so that n // B == mulhi(2n, m) >> s (the
    high 32 bits of the 64-bit product, then a shift) for every 0 <= n <
    2^31: m B exceeds 2^(31 + s) by e < B <= 2^s, and n e < 2^(31 + s)."""
    if B < 1:
        raise ValueError(f"block size {B}: the splat blocks need B >= 1")
    s = (B - 1).bit_length()
    return -(-(1 << (31 + s)) // B), s


def planes_of(color, normal):
    """The tool's (7, Hp, W) planes: r, g, b times the weight 1, the weight,
    nx, ny, nz, rows zero-padded to a multiple of 8."""
    H, W = color.shape[0], color.shape[1]
    wch = torch.ones((H, W), dtype=torch.float32, device=color.device)
    planes = torch.stack([color[..., 0] * wch, color[..., 1] * wch, color[..., 2] * wch, wch,
                          normal[..., 0], normal[..., 1], normal[..., 2]])
    hp = -(-H // STRIP) * STRIP
    if hp != H:
        planes = torch.nn.functional.pad(planes, (0, 0, 0, hp - H))
    return planes.contiguous()


def reconstruct_old_plain(planes, H: int, sample_offset, *, block_size: int,
                          stddev: float = 0.5):
    """_old_kernel on the planes, as torch ops: returns (H, W, 4)."""
    f32 = torch.float32
    dev = planes.device
    W, B = planes.shape[2], block_size
    gauss_fac, curve = (torch.tensor(c, dtype=f32) for c in constants(stddev))
    so = torch.as_tensor(sample_offset, dtype=f32).cpu()
    pl = torch.nn.functional.pad(planes[:, :H], (R, R, R, R))  # zero outside the image
    py = torch.arange(H, device=dev).view(-1, 1)
    px = torch.arange(W, device=dev).view(1, -1)
    nc = planes[4:7, :H]
    acc = torch.zeros((4, H, W), dtype=f32, device=dev)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            offx = (torch.tensor(float(dx), dtype=f32) + so[0]) - 0.5
            offy = (torch.tensor(float(dy), dtype=f32) + so[1]) - 0.5
            w_sp = float(torch.exp(gauss_fac * (offx * offx + offy * offy)) - curve)
            qx, qy = px + dx, py + dy
            in_img = (qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)
            ox = torch.div(qx, B, rounding_mode="floor") * B
            oy = torch.div(qy, B, rounding_mode="floor") * B
            dw = torch.clamp_max(W - ox, B)
            dh = torch.clamp_max(H - oy, B)
            lx, ly = px - ox, py - oy
            in_splat = (lx >= 0) & (ly >= 0) & (lx < dw + R) & (ly < dh + R)
            center_valid = (lx < dw) & (ly < dh)
            q = pl[:, R + dy : R + dy + H, R + dx : R + dx + W]
            dn = [q[4 + k] - torch.where(center_valid, nc[k], 0.0) for k in range(3)]
            w = w_sp * torch.exp(-2.0 * (dn[0] * dn[0] + dn[1] * dn[1] + dn[2] * dn[2]))
            c = w * q[0:4]
            valid = (w_sp >= 0.0) & in_img & in_splat & ~torch.isnan(c).any(0)
            acc = acc + torch.where(valid, c, 0.0)
    return acc.permute(1, 2, 0).contiguous()


def reconstruct_old_planes(planes, H: int, sample_offset, *, block_size: int,
                           stddev: float = 0.5):
    """K9 on the tool's planes: the kernel on a CUDA tensor, the plain
    version on a CPU one. Returns (H, W, 4) f32."""
    if planes.device.type != "cuda":
        return reconstruct_old_plain(planes, H, sample_offset, block_size=block_size,
                                     stddev=stddev)
    from hijiki_tpu_torch.probes import check

    hp, W = planes.shape[1], planes.shape[2]
    check("planes", planes, torch.float32, (7, hp, W), planes.device)
    if hp % STRIP or not H <= hp < H + STRIP:
        raise ValueError(f"planes: {hp} rows is not {H} padded to a multiple of {STRIP}")
    if max(W, H) + block_size >= 1 << 30:
        raise ValueError(f"reconstruct_old: {W}x{H} at block {block_size} is past the divisor "
                         "constants' range (2^30)")
    so_x, so_y = torch.as_tensor(sample_offset, dtype=torch.float32).cpu().tolist()
    gauss_fac, curve = constants(stddev)
    out = torch.empty((H, W, 4), dtype=torch.float32, device=planes.device)
    call("reconstruct_old", planes, hp, H, W, block_size, *divisor_constants(block_size), so_x,
         so_y, gauss_fac, curve, out)
    LAUNCHES["reconstruct_old"] += 1
    return out


def reconstruct_old(color, normal, sample_offset, *, block_size: int, stddev: float = 0.5):
    """The tool's reconstruct_old: (H, W, 3) color and normal, the (2,)
    sample offset; returns the (H, W, 4) film delta."""
    return reconstruct_old_planes(planes_of(color, normal), color.shape[0], sample_offset,
                                  block_size=block_size, stddev=stddev)


def inputs(W: int, H: int, dev) -> tuple:
    """The tool's inputs: color uniform [0, 1), normal uniform [-1, 1)
    (numpy seed 0), the sample offset (0.37, 0.61)."""
    rng = np.random.default_rng(0)
    color = torch.from_numpy(rng.random((H, W, 3), np.float32)).to(dev)
    normal = torch.from_numpy(rng.random((H, W, 3), np.float32) * 2 - 1).to(dev)
    return color, normal, torch.tensor(SO, dtype=torch.float32)


def differing_pixels(a, b) -> int:
    """Pixels whose four channels are not bit for bit the same."""
    return int((a.view(torch.int32) != b.view(torch.int32)).any(-1).sum())


def tap_loop(code, loops) -> dict:
    """K9's SASS (``sass_functions``): its instructions, run-time integer
    divisions (one MUFU.RCP each; K9 has no float division), expf
    (MUFU.EX2, two a tap), loads from device and shared memory; and its tap
    loop (the shortest loop of the most MUFU.EX2, else the function) over
    its taps."""
    count = lambda ops, *pre: sum(1 for op, _ in ops if op.startswith(pre))
    s0, e0 = max(loops, key=lambda lp: (count(code[lp[0]:lp[1] + 1], "MUFU.EX2"), lp[0] - lp[1]),
                 default=(0, len(code) - 1))
    body = code[s0:e0 + 1] if count(code[s0:e0 + 1], "MUFU.EX2") else code
    taps = max(1, count(body, "MUFU.EX2") // 2)
    return {"instructions": len(code), "MUFU.RCP": count(code, "MUFU.RCP"),
            "MUFU.EX2": count(code, "MUFU.EX2"), "LDG": count(code, "LDG"),
            "LDS": count(code, "LDS"), "tap_loop_instructions": len(body), "tap_loop_taps": taps,
            "per_tap": len(body) / taps, "tap_loop_RCP": count(body, "MUFU.RCP"),
            "tap_loop_LDG": count(body, "LDG"), "tap_loop_LDS": count(body, "LDS")}


def check_tap_divisions(lib=None) -> dict:
    """K9's SASS (cuobjdump of the kernel library ``lib``, the package's
    build by default): no run-time integer division (no MUFU.RCP) and a tap
    loop of one tap (two MUFU.EX2) that reads shared memory, not device
    memory. Returns ``tap_loop``'s counts; raises RuntimeError otherwise."""
    from hijiki_tpu_torch import probes

    found = list(probes.sass_functions("reconstruct_old_kernel", lib).values())
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} reconstruct_old_kernel functions in the SASS, not 1")
    got = tap_loop(*found[0][:2])
    bad = [what for what, fails in (
        (f"{got['MUFU.RCP']} MUFU.RCP (a run-time division)", got["MUFU.RCP"]),
        (f"a tap loop of {got['tap_loop_taps']} taps", got["tap_loop_taps"] != 1),
        (f"{got['tap_loop_LDG']} LDG in the tap loop", got["tap_loop_LDG"]),
        (f"{got['tap_loop_LDS']} LDS in the tap loop", not got["tap_loop_LDS"])) if fails]
    if bad:
        raise RuntimeError("reconstruct_old_kernel: " + ", ".join(bad))
    return got


def chain_k3(color, normal, so, k: int):
    """k K3 launches, each on the previous output's rgb (the tool's _chain_k
    without its final sum); the rgb copy (``.contiguous()``, which K3
    needs) runs between launches."""
    from hijiki_tpu_torch.render.pallas_reconstruct import reconstruct

    c = color
    for _ in range(k):
        c = reconstruct(c, normal, so, block_size=BLOCK)[..., :3].contiguous()
    return c


def ab(W: int, dev) -> dict:
    """The default mode: K9 against K3, bits and times."""
    from hijiki_tpu_torch.probes import timing
    from hijiki_tpu_torch.render.pallas_reconstruct import reconstruct

    color, normal, so = inputs(W, W, dev)
    planes = planes_of(color, normal)
    old = reconstruct_old_planes(planes, W, so, block_size=BLOCK)
    new = reconstruct(color, normal, so, block_size=BLOCK)
    res = dict(mode="ab", width=W, bit_equal=bool(torch.equal(old.view(torch.int32),
                                                             new.view(torch.int32))),
               differing_pixels=differing_pixels(old, new),
               max_abs_diff=float((old - new).abs().max()))
    print(f"K9 (old) against K3 at {W}x{W}, block {BLOCK}: bitwise equal {res['bit_equal']}, "
          f"{res['differing_pixels']} of {W * W} pixels differ, max |diff| "
          f"{res['max_abs_diff']:.3e}")
    if dev.type != "cuda":
        print("plain versions on the CPU (not timed)")
        return res
    fns = {"old": lambda: reconstruct_old_planes(planes, W, so, block_size=BLOCK),
           "K3": lambda: reconstruct(color, normal, so, block_size=BLOCK)}
    for name, fn in fns.items():
        fn()
        ts = [timing.event_ms(fn) for _ in range(REPS)]
        res[f"{name}_ms_min"], res[f"{name}_ms_mean"] = min(ts), sum(ts) / len(ts)
    print(f"old: min {res['old_ms_min']:.4f} ms, mean {res['old_ms_mean']:.4f} ms of {REPS}")
    print(f"K3:  min {res['K3_ms_min']:.4f} ms, mean {res['K3_ms_mean']:.4f} ms of {REPS}; "
          f"old / K3 {res['old_ms_min'] / res['K3_ms_min']:.3f}x (min)")
    print("s8-s64: the tool's strip variants are TPU VMEM blockings of K3; on the card "
          "they are K3 itself (no strip), timed above")
    return res


def instream(W: int, dev, k_hi: int = K_HI) -> dict:
    """k = 1 and k = k_hi chained K3 launches; the slope is one launch plus
    its rgb copy (the copy's own time is measured and subtracted too)."""
    from hijiki_tpu_torch.probes import timing

    color, normal, so = inputs(W, W, dev)
    if dev.type != "cuda":
        out = chain_k3(color, normal, so, 3)
        print(f"in-stream: 3 chained K3 plain versions on the CPU (not timed), "
              f"sum {float(out.sum()):.6e}")
        return dict(mode="instream", width=W)
    t1 = timing.best_ms(lambda: chain_k3(color, normal, so, 1))
    tk = timing.best_ms(lambda: chain_k3(color, normal, so, k_hi))
    per = (tk - t1) / (k_hi - 1)
    film = torch.empty((W, W, 4), dtype=torch.float32, device=dev)
    copy = timing.best_ms(lambda: film[..., :3].contiguous())
    res = dict(mode="instream", width=W, k_hi=k_hi, k1_ms=t1, k_hi_ms=tk, per_launch_ms=per,
               copy_ms=copy, kernel_ms=per - copy)
    print(f"in-stream: k=1 {t1:.4f} ms, k={k_hi} {tk:.4f} ms -> {per:.4f} ms a launch "
          f"= {W * W / per / 1e3:.1f} Mpix/s; the slope includes the .contiguous() rgb "
          f"copy between launches ({copy:.4f} ms alone): K3 alone {per - copy:.4f} ms")
    return res


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("args", nargs="*", help="[W] or instream [W] (default W 1024)")
    args = ap.parse_args(argv)
    dev = device_of(args)
    rest = list(args.args)
    mode = "instream" if rest[:1] == ["instream"] else "ab"
    rest = rest[1:] if mode == "instream" else rest
    W = int(rest[0]) if rest else 1024
    if dev.type == "cuda":
        print(f"# {card()}", flush=True)
    res = instream(W, dev) if mode == "instream" else ab(W, dev)
    dump(args, [res])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
