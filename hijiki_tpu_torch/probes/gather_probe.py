"""K11a: the per-lane gather chain on the H100.

Counterpart of tools/gather_probe.py (``_kernel``/``build``, pallas_call at
:85): a fixed-trip chain idx -> table value -> idx per element over a
(K, 8, 128) f32 table, run by the gather modes of ``latency_chain``
(csrc/probe_latency.cu), which stages the table in shared memory once a
persistent block (blocks of ``GATHER_BLOCK`` threads but at one warp per
SM: two an SM at K <= 16, one at K = 32, whose table takes 128 KB).
Modes:

* ``const``: no load (v = tbl[0, 0, 0] + idx), the loop's own cost;
* ``gather1``: entry idx & 1023 of tile 0;
* ``gatherK``: entry idx & 1023 of tile (idx >> 10) & (K - 1).

The kernel gathers entry e = idx & 1023, one dependent shared-memory load a
step: what the probe means to measure. The TPU kernel's two
take_along_axis calls (gather_probe.py:59-60) read tbl[r[i, l[i, j]],
l[i, j]] with r = e // 128, l = e % 128 instead: ``gather_plain`` keeps
both, ``order="tpu"`` (held to JAX by the tests) and ``order="entry"``
(the kernel's).

Usage (the tool's arguments):

    python -m hijiki_tpu_torch.probes.gather_probe [iters] [K] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from hijiki_tpu_torch.probes import card, device_of, dump, occupancies, parser
from hijiki_tpu_torch.probes.chain_latency_probe import latency_chain

MODES = ("const", "gather1", "gatherK")
# threads a block of the gather kernel: the most an SM holds at every K
# (two blocks of 2 x K x 4 KB up to K = 16, one of 128 KB at K = 32), so
# each SM stages the table at most twice
GATHER_BLOCK = 1024


def gather_inputs(n: int, K: int, seed: int = 0):
    """The tool's table (K, 8, 128) of integers 1..6 as f32 and n indices in
    [0, K * 1024) as i32 (its (8, 128) block is n = 1024)."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(1, 7, (K, 8, 128)).astype(np.float32)
    idx = rng.integers(0, K * 1024, n).astype(np.int32)
    return tbl, idx


def gather_plain(tbl, idx, iters: int, mode: str, order: str = "entry"):
    """The chain over tbl (K, 8, 128) f32 from idx (n,) i32: v = the
    entry's value (``mode``), idx <- (idx + int(v) + i) & (K 1024 - 1),
    acc += v. Returns (2, n) f32: acc, idx. ``order="tpu"`` reads the TPU
    kernel's lane order (n a multiple of 1024)."""
    K = tbl.shape[0]
    flat = tbl.reshape(-1)
    mask = K * 1024 - 1
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    idx = idx.to(torch.int64)
    for i in range(iters):
        if mode == "const":
            v = flat[0] + idx.to(torch.float32)
        else:
            e = idx & 1023
            tile = (idx >> 10) & (K - 1) if mode == "gatherK" else torch.zeros_like(idx)
            if order == "tpu":  # take_along_axis over sublanes, then lanes
                r, l = (e // 128).reshape(-1, 8, 128), (e % 128).reshape(-1, 8, 128)
                e = (torch.gather(r, 2, l) * 128 + l).reshape(-1)
            v = flat[tile * 1024 + e]
        idx = (idx + v.to(torch.int32).to(torch.int64) + i) & mask
        acc = acc + v
    return torch.stack([acc, idx.to(torch.float32)])


def gather(tbl, idx, iters: int, mode: str, block: int = GATHER_BLOCK, **kw):
    """The gather chain: the kernel on CUDA tensors (``block`` threads a
    persistent block), ``gather_plain`` (entry order) on CPU ones. Out (2,
    n) f32."""
    return latency_chain(f"gather_{mode}" if mode == "const" else mode, device=idx.device,
                         tbl=tbl, idx=idx, n=idx.numel(), iters=iters, p0=tbl.shape[0],
                         block=block, plain=lambda: gather_plain(tbl, idx, iters, mode), **kw)


def main(argv=None) -> int:
    from hijiki_tpu_torch.probes import timing

    ap = parser(__doc__)
    ap.add_argument("iters", nargs="?", type=int, default=None)
    ap.add_argument("K", nargs="?", type=int, default=4)
    args = ap.parse_args(argv)
    dev = device_of(args)
    results = []
    if dev.type != "cuda":
        tbl, idx = (torch.from_numpy(a) for a in gather_inputs(1024, args.K))
        for mode in MODES:
            out = gather(tbl, idx, args.iters or 20, mode)
            print(f"{mode:8s}: plain version on the CPU (not timed), sums "
                  f"{float(out[0].sum()):.6e} {float(out[1].sum()):.6e}")
        return 0
    print(f"# {card()}", flush=True)
    for occ, threads, block in occupancies(dev):
        block = GATHER_BLOCK if occ == "full" else block
        tbl, idx = (torch.from_numpy(a).to(dev) for a in gather_inputs(threads, args.K))
        for mode in MODES:
            run = lambda it, **kw: gather(tbl, idx, it, mode, block=block, **kw)
            res = timing.slope(run, lo=args.iters, hi=None if args.iters is None else 3 * args.iters)
            res.update(probe="gather", mode=mode, K=args.K, occupancy=occ, threads=threads,
                       block=block, blocks_per_sm=run(1, occupancy=True))
            print(f"{occ:4s} {mode:8s} K={args.K} slope {res['ns_per_iter']:8.3f} ns/iter "
                  f"(lo {res['t_lo_ms']:.3f} ms hi {res['t_hi_ms']:.3f} ms)", flush=True)
            results.append(res)
    dump(args, results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
