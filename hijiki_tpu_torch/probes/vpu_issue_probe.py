"""K11b: the ALU issue rate of the H100, a loop of K rounds of ALU ops.

Counterpart of tools/vpu_issue_probe.py. Each element carries four
independent chains a, b, c, d; each trip adds f = f32(i) * 1e-9 and runs K
rounds of the tool's mix (mul/add, min, compare and select, max, abs: 14
ops a round by the tool's conservative count) with no memory traffic in
the loop. The slope over two trip counts (probes/timing.py) gives ns per
trip, at one warp per SM and at 1M threads (``occupancies``); the marginal
cost between the two largest K cancels the loop's own overhead.

* ``alu_issue_plain``: the plain PyTorch version (any device);
* ``alu_issue``: csrc/probe_alu.cu on a CUDA tensor (counted in
  ``LAUNCHES``), the plain version on a CPU one.

The report gives ns per trip, ns per op (a thread's), the marginal ns per
op, and lane-ops per clock per SM at the SM clock nvidia-smi reads during
the run; beside the tool's 14 ops a round it prints the instructions a
round of the compiled loop (``cuobjdump -sass``; on the card abs is an
operand modifier and a select may fuse with its compare).

Usage (the tool's ``--ks``):

    python -m hijiki_tpu_torch.probes.vpu_issue_probe [--ks=2,4,8,16] [--device cuda|cpu]
        [--json out.json]
"""

from __future__ import annotations

import numpy as np
import torch

from hijiki_tpu_torch.probes import (call, card, check, device_of, dump, f32, occupancies,
                                     parser, sass_loop, sm_clock_during)

OPS_PER_ROUND = 14  # the tool's conservative count of a round
KS = (2, 4, 8, 16)
KERNEL_KS = (1, 2, 4, 8, 16)  # the rounds csrc/probe_alu.cu instantiates
TOOL_TRIPS = (200_000, 400_000)

# launches of the CUDA kernel (CPU calls of the plain version are not counted)
LAUNCHES = {"alu_issue": 0}


def x_of(n: int) -> np.ndarray:
    """The tool's input: uniform [0, 1) f32 from numpy seed 0 (its (8, 1024)
    block is the first 8192 elements)."""
    return np.random.default_rng(0).random(n, np.float32)


def alu_issue_plain(x, iters: int, k: int):
    """make_kernel's body on (n,) f32: returns a + b + c + d."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    a = x.clone()
    b = a * f32(1.0001) + 0.25
    c = a * f32(0.9999) - 0.125
    d = a + 0.5
    for i in range(iters):
        f = float(np.float32(i) * np.float32(1e-9))
        for _ in range(k):
            a = a * f32(1.000001) + f
            b = torch.minimum(b + 0.75, a)
            c = torch.where(c > a, c * 0.5, c + 0.125)
            d = d + c * f32(0.000001)
            a = torch.maximum(a, zero)
            b = b * f32(0.999999)
            c = torch.abs(c - b)
            d = torch.minimum(d, zero + 8192.0)
    return a + b + c + d


def alu_issue(x, iters: int, k: int, *, block: int = 128, occupancy: bool = False):
    """K rounds a trip on (n,) f32 ``x``: the kernel on a CUDA tensor, the
    plain version on a CPU one. ``occupancy``: launch nothing, return the
    blocks one SM holds."""
    if x.device.type != "cuda":
        return alu_issue_plain(x, iters, k)
    if k not in KERNEL_KS:
        raise ValueError(f"alu_issue runs K in {KERNEL_KS} (got {k})")
    n = x.numel()
    check("x", x, torch.float32, (n,), x.device)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    args = (k, x, n, iters, block, out)
    if occupancy:
        return call("alu_issue", *args, occupancy=True)
    call("alu_issue", *args)
    LAUNCHES["alu_issue"] += 1
    return out


def sass_per_round() -> dict:
    """Instructions a round of the compiled loop: the loop of K = 16 less
    the loop of K = 8, over 8 rounds, by opcode (empty without cuobjdump)."""
    loops = sass_loop("alu_issue_kernel")
    by_k = {}
    for name, counts in loops.items():
        for k in (8, 16):
            if f"ILi{k}E" in name:
                by_k[k] = counts
    if len(by_k) < 2:
        return {}
    ops = set(by_k[8]) | set(by_k[16])
    return {op: (by_k[16].get(op, 0) - by_k[8].get(op, 0)) / 8 for op in sorted(ops)
            if by_k[16].get(op, 0) != by_k[8].get(op, 0)}


def main(argv=None) -> int:
    from hijiki_tpu_torch.probes import timing

    ap = parser(__doc__)
    ap.add_argument("--ks", default=",".join(map(str, KS)),
                    help="rounds a trip, comma-separated (the tool's 2,4,8,16)")
    args = ap.parse_args(argv)
    dev = device_of(args)
    ks = tuple(int(k) for k in args.ks.split(","))
    if dev.type != "cuda":
        x = torch.from_numpy(x_of(8 * 1024))
        for k in ks:
            out = alu_issue(x, 20, k)
            print(f"K={k:2d}: plain version on the CPU (not timed), sum {float(out.sum()):.6e}")
        return 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"# {card()}; {sms} SMs; the tool's trips {TOOL_TRIPS[0]}/{TOOL_TRIPS[1]} "
          f"(one 8192-element block on the TPU) would run for minutes over 1M threads: "
          f"the trips here are calibrated", flush=True)
    per_round = sass_per_round()
    sass_n = sum(per_round.values()) if per_round else None
    print(f"SASS a round (cuobjdump, K=16 less K=8): "
          f"{sass_n if sass_n is not None else 'not measured'} instructions "
          f"{per_round} against the tool's {OPS_PER_ROUND}", flush=True)
    results = []
    for occ, threads, block in occupancies(dev):
        x = torch.from_numpy(x_of(threads)).to(dev)
        rows = []
        for k in ks:
            run = lambda it, k=k, **kw: alu_issue(x, it, k, block=block, **kw)
            res, mhz, max_mhz = sm_clock_during(lambda: timing.slope(run))
            ops = OPS_PER_ROUND * k
            res.update(occupancy=occ, threads=threads, block=block, k=k, sm_mhz=mhz,
                       max_sm_mhz=max_mhz, ns_per_trip=res["ns_per_iter"],
                       ns_per_op=res["ns_per_iter"] / ops, sass_per_round=sass_n)
            line = (f"{occ:4s} K={k:2d} ({ops:3d} ops a trip) lo {res['lo']} hi {res['hi']}: "
                    f"{res['ns_per_trip']:9.3f} ns/trip, {res['ns_per_op']:.4f} ns/op")
            if mhz:
                lane_ops = threads * ops / (res["ns_per_trip"] * 1e-9) / (sms * mhz * 1e6)
                res["lane_ops_per_clock_per_sm"] = lane_ops
                line += f"; {lane_ops:.2f} lane-ops/clock/SM at {mhz:.0f} MHz (max {max_mhz:.0f})"
            print(line, flush=True)
            rows.append(res)
            results.append(res)
        if len(rows) >= 2:
            a, b = rows[-2], rows[-1]
            ns = (b["ns_per_trip"] - a["ns_per_trip"]) / (OPS_PER_ROUND * (b["k"] - a["k"]))
            mar = dict(occupancy=occ, marginal=True, k_a=a["k"], k_b=b["k"], ns_per_op=ns)
            line = f"{occ:4s} marginal K={a['k']}->{b['k']}: {ns:.4f} ns/op (a thread's)"
            mhz = b["sm_mhz"]
            if mhz:
                mar["lane_ops_per_clock_per_sm"] = threads / (ns * 1e-9) / (sms * mhz * 1e6)
                line += f", {mar['lane_ops_per_clock_per_sm']:.2f} lane-ops/clock/SM"
                if sass_n:
                    mar["lane_instr_per_clock_per_sm"] = (
                        mar["lane_ops_per_clock_per_sm"] * sass_n / OPS_PER_ROUND)
                    line += (f" ({mar['lane_instr_per_clock_per_sm']:.2f} lane-instructions "
                             f"at {sass_n} a round)")
            print(line, flush=True)
            results.append(mar)
    dump(args, results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
