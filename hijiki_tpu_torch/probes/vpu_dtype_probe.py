"""K11b: does the H100 issue bf16 elementwise ops faster than f32?

Counterpart of tools/vpu_dtype_probe.py, two bodies (csrc/probe_alu.cu):

* ``dtype_elementwise`` (_kernel, :103-118): ``chains`` independent chains
  x = (x * c1 + 0.125) * c2 per element, in f32, in bf16 (one element a
  thread) and in packed bf16x2 (two adjacent elements a thread); the two
  bf16 variants compute the same values bit for bit. Run at one warp per
  SM and at 1M threads (``occupancies``); bf16x2 runs the same threads on
  twice the elements.
* ``dtype_slab`` (_slab_kernel, :38-87): the walker's slab-test mix in the
  probed type (6 multiply-adds, 10 min/max), the casts to f32, the compares,
  an ``any`` vote across the P lanes of a row and the select of best_t and
  the vote count in f32, at the tool's (8, P) and at (1024, P), P = 1024,
  in f32 and bf16. A thread holds L lanes of its row and a row spans W
  warps (``slab_split``: L = 8, W = 4 at P = 1024); the row's vote is one
  ``__any_sync`` where W = 1, else a reduction on a named barrier of the
  row's W warps.

Each ``*_plain`` function is the plain PyTorch version (any device), every
op rounded to the probed type as torch's bf16 ops round. The wrappers
launch the kernel on a CUDA tensor (counted in ``LAUNCHES``) and run the
plain version on a CPU one. The trip counts are calibrated (probes/timing.py)
and printed beside the tool's 400k/1.2M (elementwise) and 100k/300k (slab).

Usage (the tool's arguments):

    python -m hijiki_tpu_torch.probes.vpu_dtype_probe [P] [chains] [--device cuda|cpu]
        [--json out.json]
"""

from __future__ import annotations

import numpy as np
import torch

from hijiki_tpu_torch.probes import (call, card, check, device_of, dump, f32, occupancies,
                                     parser, sass_loop, sm_clock_during)

SUBLANES = 8
VARIANTS = {"f32": 0, "bf16": 1, "bf16x2": 2}
SLAB_VARIANTS = {"f32": 0, "bf16": 1}
CHAINS = (1, 2, 4, 8, 16)  # the chain counts csrc/probe_alu.cu instantiates
C1, C2 = 1.0009765625, 0.9990234375  # exact in bf16
EPS = f32(1e-4)
SLAB_ROWS = (SUBLANES, 1024)
TOOL_TRIPS = (400_000, 1_200_000)
TOOL_SLAB_TRIPS = (100_000, 300_000)
# ops a trip: elementwise 3 a chain (mul, add, mul); the slab body's 6
# multiply-adds (12), 10 min/max, the add and 3 compares, the select's mul
# and the count's add
EW_OPS = 3
SLAB_OPS = 12 + 10 + 1 + 3 + 1 + 1

# dtype_slab's lanes a thread (csrc/probe_alu.cu instantiates these), the
# most warps a row may span, and the splits the wrapper takes, in order of
# preference (the card's measurements, PERF.md §6: more lanes a thread
# spread the trip's fixed instructions)
SLAB_LANES = (1, 2, 4, 8, 16, 32)
SLAB_MAX_WARPS = 8
SLAB_PREFERRED = (8, 4, 2, 1)
# a dtype_slab trip loop's least slab arithmetic a lane, by the probed
# type's Ops: f32 12 FMUL/FADD (6 multiply-adds under --fmad=false) and 10
# FMNMX; bf16 ptxas packs the pairs: 6 HMUL2/HADD2, and 4 HMNMX2 beside 2
# three-way VHMNMX (a one-lane loop's SASS, PERF.md §6)
SLAB_ARITH = {"F32Ops": {"FMUL+FADD": 12, "FMNMX": 10},
              "Bf16Ops": {"HMUL2+HADD2": 6, "HMNMX2": 4}}

# launches of the CUDA kernels (CPU calls of the plain versions are not counted)
LAUNCHES = {"dtype_elementwise": 0, "dtype_slab": 0}


def ew_input(chains: int, n: int, dtype: str) -> torch.Tensor:
    """The tool's input: uniform [0.5, 1) (numpy seed 0), (chains, n) in
    f32 or bf16 (bf16x2 takes the bf16 one); its (chains, 8, P) is n = 8P.
    bf16 rounds through f32, as jnp.asarray(a, bfloat16) does."""
    a = np.random.default_rng(0).uniform(0.5, 1.0, (chains, n)).astype(np.float32)
    x = torch.from_numpy(a)
    return x if dtype == "f32" else x.to(torch.bfloat16)


def slab_input(rows: int = SUBLANES, P: int = 1024) -> tuple:
    """The tool's slab inputs (numpy seed 1): x (6, rows, P) uniform [0.5,
    1.5) f32 (inverse directions, then offsets) and row (rows, 32) uniform
    [-1, 1) f32."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0.5, 1.5, (6, rows, P)).astype(np.float32)
    row = rng.uniform(-1, 1, (rows, 32)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(row)


# --------------------------------------------------------- plain versions --

def ew_plain(x, iters: int):
    """_kernel on x (chains, n) f32 or bf16: every op in x's type; out the
    chains' final values in f32, summed in chain order."""
    xs = list(x)
    for _ in range(iters):
        xs = [(v * C1 + 0.125) * C2 for v in xs]
    acc = xs[0].float()
    for v in xs[1:]:
        acc = acc + v.float()
    return acc


def slab_plain(x, row, iters: int, dtype: str):
    """_slab_kernel on x (6, rows, P) and row (rows, 32) f32: the slab mix
    in ``dtype`` (f32 or bf16), the rest in f32. Out (rows, P) f32."""
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    inv = [x[k].to(dt) for k in range(3)]
    tof = [x[3 + k].to(dt) for k in range(3)]
    col = [row[:, j : j + 1].to(dt) for j in range(6)]
    acc = (x[0] * 0.0)[:, :1]
    best_t = x[0] * 0.0 + 1e6
    ax, bx = col[0] * inv[0] + tof[0], col[3] * inv[0] + tof[0]
    ay, by = col[1] * inv[1] + tof[1], col[4] * inv[1] + tof[1]
    az, bz = col[2] * inv[2] + tof[2], col[5] * inv[2] + tof[2]
    t0 = torch.maximum(torch.maximum(torch.minimum(ax, bx), torch.minimum(ay, by)),
                       torch.minimum(az, bz)).float()
    t1 = torch.minimum(torch.minimum(torch.maximum(ax, bx), torch.maximum(ay, by)),
                       torch.maximum(az, bz)).float()
    for _ in range(iters):  # the slab values do not change from trip to trip
        slab = (t0 < t1 + EPS) & (t0 < best_t) & (t1 > EPS)
        vote = slab.any(1, keepdim=True)
        best_t = torch.where(slab, best_t * f32(0.9999), best_t)
        acc = acc + torch.where(vote, 1.0, 0.0)
    return acc.expand_as(best_t) + best_t


# ----------------------------------------------------------------- wrappers --

def dtype_elementwise(x, iters: int, variant: str, *, block: int = 128,
                      occupancy: bool = False):
    """``chains`` chains a trip on x (chains, n): f32 for ``f32``, bf16 for
    ``bf16`` and ``bf16x2`` (n even). Out (n,) f32: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    if x.device.type != "cuda":
        return ew_plain(x, iters)
    chains, n = x.shape
    dt = torch.float32 if variant == "f32" else torch.bfloat16
    check("x", x, dt, (chains, n), x.device)
    if chains not in CHAINS or (variant == "bf16x2" and n % 2):
        raise ValueError(f"dtype_elementwise runs chains in {CHAINS} and an even n for "
                         f"bf16x2 (got {chains}, {n})")
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    args = (VARIANTS[variant], chains, x, n, iters, block, out)
    if occupancy:
        return call("dtype_elementwise", *args, occupancy=True)
    call("dtype_elementwise", *args)
    LAUNCHES["dtype_elementwise"] += 1
    return out


def slab_split(P: int, lanes: int | None = None) -> tuple[int, int]:
    """(lanes a thread, warps a row) of dtype_slab on rows of P lanes: the
    first of SLAB_PREFERRED that divides P / 32 into at most SLAB_MAX_WARPS
    warps, else 8 lanes a thread (the last warp's spare lanes idle), or the
    given ``lanes``. Raises ValueError where P is no multiple of 32 up to
    1024 or the lanes are not instantiated or span too many warps."""
    if P < 32 or P > 1024 or P % 32:
        raise ValueError(f"dtype_slab runs rows of P lanes, P a multiple of 32 up to 1024 "
                         f"(got {P})")
    n32 = P // 32
    if lanes is None:
        lanes = next((n for n in SLAB_PREFERRED if n32 % n == 0 and n32 // n <= SLAB_MAX_WARPS),
                     SLAB_PREFERRED[0])
    warps = -(-n32 // lanes)
    if lanes not in SLAB_LANES or warps > SLAB_MAX_WARPS:
        raise ValueError(f"dtype_slab: {lanes} lanes a thread give {warps} warps a row of {P} "
                         f"lanes (lanes in {SLAB_LANES}, at most {SLAB_MAX_WARPS} warps)")
    return lanes, warps


def dtype_slab(x, row, iters: int, variant: str, *, occupancy: bool = False):
    """The slab body on x (6, rows, P) and row (rows, 32) f32, ``variant``
    f32 or bf16; rows split as ``slab_split(P)``. Out (rows, P) f32."""
    if x.device.type != "cuda":
        return slab_plain(x, row, iters, variant)
    _, rows, P = x.shape
    check("x", x, torch.float32, (6, rows, P), x.device)
    check("row", row, torch.float32, (rows, 32), x.device)
    lanes, _ = slab_split(P)
    out = torch.empty((rows, P), dtype=torch.float32, device=x.device)
    args = (SLAB_VARIANTS[variant], x, row, rows, P, iters, lanes, out)
    if occupancy:
        return call("dtype_slab", *args, occupancy=True)
    call("dtype_slab", *args)
    LAUNCHES["dtype_slab"] += 1
    return out


# ---------------------------------------------------------------- the probes --

def sass_counts() -> dict:
    """Instructions of each compiled body's trip loop by opcode (empty
    without cuobjdump): the elementwise kernels at the chain count the
    caller asks for, the slab kernels."""
    out = {}
    for name, counts in sass_loop("_kernel").items():
        if "ew_" in name or "dtype_slab" in name:
            out[name] = counts
    return out


def slab_loop(code, loops) -> dict:
    """A dtype_slab instantiation's trip loop (its longest loop, from
    ``sass_functions``): its instructions, barriers (BAR, with the barrier
    each names), votes, shared loads and slab arithmetic by SLAB_ARITH's
    kinds."""
    start, end = max(loops, key=lambda lp: lp[1] - lp[0], default=(0, -1))
    body = code[start:end + 1]
    count = lambda *pre: sum(1 for op, _ in body if op.startswith(pre))
    return {"instructions": len(body), "BAR": count("BAR"), "VOTE": count("VOTE"),
            "LDS": count("LDS"), "FMUL+FADD": count("FMUL", "FADD"), "FMNMX": count("FMNMX"),
            "HMUL2+HADD2": count("HMUL2", "HADD2"), "HMNMX2": count("HMNMX2"),
            "barriers": sorted({rest.split(",")[0].strip() for op, rest in body
                                if op.startswith("BAR")})}


def check_slab_loops(lib=None) -> dict:
    """Every dtype_slab instantiation's SASS trip loop (cuobjdump of the
    kernel library ``lib``, the package's build by default): no barrier 0
    (the block's, which __syncthreads_or reduces on), a one-warp row's loop
    no barrier at all and a vote, and the slab arithmetic of each of its L
    lanes (SLAB_ARITH) every trip. Returns {(Ops, L, one warp): slab_loop};
    raises RuntimeError naming what fails, or where an instantiation of
    SLAB_LANES is missing."""
    import re

    from hijiki_tpu_torch import probes

    out, bad = {}, []
    for name, (code, loops, _) in probes.sass_functions("dtype_slab_kernel", lib).items():
        m = re.search(r"dtype_slab_kernelI\w*?(F32Ops|Bf16Ops)ELi(\d+)ELb([01])E", name)
        if not m:
            continue
        ops, lanes, one = m.group(1), int(m.group(2)), m.group(3) == "1"
        counts = slab_loop(code, loops)
        out[(ops, lanes, one)] = counts
        what = f"dtype_slab_kernel<{ops}, {lanes}, {str(one).lower()}>"
        if any(b in ("0x0", "0") for b in counts["barriers"]):
            bad.append(f"{what}: its trip loop waits on barrier 0, the whole block's")
        if one and (counts["BAR"] or not counts["VOTE"]):
            bad.append(f"{what}: a one-warp row's loop holds {counts['BAR']} BAR and "
                       f"{counts['VOTE']} VOTE")
        for kind, per_lane in SLAB_ARITH[ops].items():
            if counts[kind] < per_lane * lanes:
                bad.append(f"{what}: {counts[kind]} {kind} in its trip loop, fewer than "
                           f"{per_lane} x {lanes} lanes")
    want = {(ops, n, one) for ops in SLAB_ARITH for n in SLAB_LANES for one in (False, True)}
    if out.keys() != want:
        bad.append(f"{len(out)} dtype_slab instantiations, not the {len(want)} of {SLAB_LANES} "
                   "lanes x 2 types x 2 votes")
    if bad:
        raise RuntimeError("; ".join(bad))
    return out


def main(argv=None) -> int:
    from hijiki_tpu_torch.probes import timing

    ap = parser(__doc__)
    ap.add_argument("P", nargs="?", type=int, default=1024, help="lanes a slab row (1024)")
    ap.add_argument("chains", nargs="?", type=int, default=8, help="elementwise chains (8)")
    args = ap.parse_args(argv)
    dev = device_of(args)
    P, chains = args.P, args.chains
    if dev.type != "cuda":
        n = SUBLANES * P
        for v in VARIANTS:
            out = dtype_elementwise(ew_input(chains, n, "f32" if v == "f32" else "bf16"), 20, v)
            print(f"elementwise {v:6s}: plain version on the CPU (not timed), "
                  f"sum {float(out.sum()):.6e}")
        x, row = slab_input(SUBLANES, P)
        for v in SLAB_VARIANTS:
            out = dtype_slab(x, row, 20, v)
            print(f"slab {v:4s} (8, {P}): plain version on the CPU (not timed), "
                  f"sum {float(out.sum()):.6e}")
        return 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"# {card()}; {sms} SMs; P={P} chains={chains}; the tool's trips "
          f"{TOOL_TRIPS[0]}/{TOOL_TRIPS[1]} (elementwise), {TOOL_SLAB_TRIPS[0]}/"
          f"{TOOL_SLAB_TRIPS[1]} (slab); here calibrated", flush=True)
    for name, counts in sass_counts().items():
        if "ew_" in name and f"ILi{chains}E" not in name:
            continue
        print(f"SASS trip loop {name}: {sum(counts.values())} instructions {counts}", flush=True)
    results = []

    def timed(label, run, elems, ops, **meta):
        res, mhz, max_mhz = sm_clock_during(lambda: timing.slope(run))
        res.update(meta, label=label, sm_mhz=mhz, max_sm_mhz=max_mhz, elements=elems)
        line = (f"{label:34s} lo {res['lo']} hi {res['hi']}: {res['ns_per_iter']:10.3f} ns/trip")
        if mhz:
            res["elem_ops_per_clock_per_sm"] = (elems * ops / (res["ns_per_iter"] * 1e-9)
                                                / (sms * mhz * 1e6))
            line += (f", {res['elem_ops_per_clock_per_sm']:.2f} element-ops/clock/SM at "
                     f"{mhz:.0f} MHz (max {max_mhz:.0f})")
        print(line, flush=True)
        results.append(res)

    for occ, threads, block in occupancies(dev):
        for v in VARIANTS:
            n = 2 * threads if v == "bf16x2" else threads
            x = ew_input(chains, n, "f32" if v == "f32" else "bf16").to(dev)
            run = lambda it, x=x, v=v, **kw: dtype_elementwise(x, it, v, block=block, **kw)
            timed(f"elementwise {v:6s} {occ:4s} ({n} elements)", run, n, EW_OPS * chains,
                  body="elementwise", variant=v, occupancy=occ, threads=threads, chains=chains)
    lanes, warps = slab_split(P)
    print(f"slab rows of {P} lanes: {lanes} lanes a thread, {warps} warps a row", flush=True)
    for rows in SLAB_ROWS:
        x, row = (t.to(dev) for t in slab_input(rows, P))
        for v in SLAB_VARIANTS:
            run = lambda it, x=x, row=row, v=v, **kw: dtype_slab(x, row, it, v, **kw)
            timed(f"slab {v:4s} ({rows}, {P})", run, rows * P, SLAB_OPS, body="slab",
                  variant=v, rows=rows, P=P)
    dump(args, results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
