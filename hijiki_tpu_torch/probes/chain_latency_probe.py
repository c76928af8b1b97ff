"""K11a: the walker's serial-chain latencies on the H100.

Counterpart of tools/chain_latency_probe.py. Each mode times one link of
the walker's dependency chain (vote -> cursor select -> row load -> slab
test -> vote) with the slope harness (probes/timing.py), at one warp per SM
(the exposed latency) and at 1M threads (the throughput):

* ``latency_chain`` (csrc/probe_latency.cu) runs ``alu`` (make_alu, :116),
  ``vote`` (make_vote, :153), ``fetch`` (make_fetch, :193), ``chain``
  (make_chain, :260) and gather_probe.py's gather modes;
* ``staged_chase`` runs ``dma`` (make_dma, :430) and ``dmag``
  (make_dma_multi, :330): rows copied from global into shared memory with
  cp.async, the GPU's counterpart of the TPU's HBM -> VMEM DMA (Hopper's
  bulk copy on mbarriers read 2.5x slower on the chase: PERF.md).

Each ``*_plain`` function is the plain version of one mode (any device)
and computes what the JAX tool's kernel computes, element for element,
from the same inputs: the tool's (8, W) block is the first 8 x W elements
here, and a vote or chain group of ``group`` elements is a row of W when
group = W. The kernel takes group 1 or 32 (32: a warp); each thread
carries its own chain (or its group's). The wrappers (``latency_chain``,
``staged_chase``) launch the kernel on a CUDA tensor and the plain version
on a CPU one. The ``*_table`` functions make the tool's tables.

Usage (the tool's argument):

    python -m hijiki_tpu_torch.probes.chain_latency_probe [alu|vote|fetch|chain|dma|dmag|all]
        [--rows 65536 262144] [--table tool|cycle] [--device cuda|cpu] [--json out.json]
"""

from __future__ import annotations

import numpy as np
import torch

from hijiki_tpu_torch.probes import call, card, check, device_of, dump, f32, occupancies, parser

SUBLANES = 8
MODES = {"alu": 0, "vote": 1, "fetch_indep": 2, "fetch_chase": 3, "chain": 4,
         "gather_const": 5, "gather1": 6, "gatherK": 7}
STAGE_MODES = {"indep": 0, "chase": 1, "sharedsem": 2, "sharedsem+noclamp": 3,
               "dedup": 4, "multi": 5}
ROW_F = 128  # floats a staged row
# staged_chase's modes that read a cursor's rows unclamped: a cursor kept in
# [0, rows) reads past the table at a height above 1
UNCLAMPED = ("sharedsem+noclamp", "dedup")

# launches of the CUDA kernels (CPU calls of the plain versions are not counted)
LAUNCHES = {"latency_chain": 0, "staged_chase": 0}


# ---------------------------------------------------------------- tables --

def fetch_table(rows: int = 4096, ncols: int = 128, height: int = 1) -> np.ndarray:
    """make_fetch's table: uniform [0, 1) with column 10 a row index in
    [0, rows - 2)."""
    rng = np.random.default_rng(0)
    tbl = rng.random((rows, ncols), np.float32)
    tbl[:, 10] = rng.integers(0, rows - 2, rows).astype(np.float32)
    return tbl


def chain_table(rows: int = 4096, ncols: int = 128, width: int = 1024):
    """make_chain's table (column 10 in [0, rows - 1)) and its x (8, width)."""
    rng = np.random.default_rng(0)
    tbl = rng.random((rows, ncols), np.float32)
    tbl[:, 10] = rng.integers(0, rows - 1, rows).astype(np.float32)
    x = rng.random((SUBLANES, width), np.float32) + 0.5
    return tbl, x


def dma_table(rows: int = 65536, ncols: int = 128, height: int = 1) -> np.ndarray:
    """make_dma's table (column 10 in [0, rows - height)); make_dma_multi's
    is dma_table(rows, height=2)."""
    rng = np.random.default_rng(0)
    tbl = rng.random((rows, ncols), np.float32)
    tbl[:, 10] = rng.integers(0, rows - height, rows).astype(np.float32)
    return tbl


def cycle_table(rows: int, ncols: int = 128, seed: int = 0) -> np.ndarray:
    """A table like the tool's whose column 10 links every row into one
    random cycle (Sattolo's shuffle). The tool's tables draw column 10 at
    random, a random mapping, so a chase falls into a cycle of about
    sqrt(pi rows / 8) rows (40 of 4096) and stays in the SM's L1; a chase
    over this table visits every row before it repeats, so it measures the
    L2 (a table under 50 MB) or HBM (above) round trip."""
    rng = np.random.default_rng(seed)
    tbl = rng.random((rows, ncols), np.float32)
    order = rng.permutation(rows)
    tbl[order, 10] = np.roll(order, -1).astype(np.float32)
    return tbl


def x_of(n: int, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    """make_alu's / make_vote's input: uniform [0, 1) (times ``scale``)."""
    return (np.random.default_rng(seed).random(n, np.float32) * np.float32(scale)).astype(np.float32)


# --------------------------------------------------------- plain versions --

def alu_plain(x, iters: int, k: int):
    """make_alu: k dependent ops a step, a = a * f32(1.000001) + f32(i) * f32(1e-12)."""
    a = x.clone()
    c = f32(1.000001)
    for i in range(iters):
        f = float(np.float32(i) * np.float32(1e-12))
        for _ in range(k // 2):
            a = a * c + f
    return a


def vote_plain(x, iters: int, group: int):
    """make_vote: v carried per group; y = x (v + 1) + f; descend = any(y > .5)."""
    xg = x.reshape(-1, group)
    v = torch.zeros((xg.shape[0], 1), dtype=x.dtype, device=x.device)
    for i in range(iters):
        f = float(np.float32(i) * np.float32(1e-9))
        y = xg * (v + 1.0) + f
        s = (y > 0.5).any(1, keepdim=True)
        v = torch.where(s, v * 0.5, v + 0.25)
    return (v + xg).reshape(-1)


def fetch_plain(tbl, n: int, iters: int, mode: str, height: int = 1):
    """make_fetch: element (b, j, c) of the (blocks, 8, ncols) output adds
    column c of row min(cur, rows - h) + j % h of cursor 8b + j // h
    (cursors start at 7 * their index) and ends with its own cursor 8b + j;
    ``indep`` cursors step by 131 (wrapped), ``chase`` ones take column 10
    of their row (height 1)."""
    rows, ncols = tbl.shape
    if mode == "chase" and height != 1:
        raise ValueError("chase runs at height 1")
    dev = tbl.device
    e = torch.arange(n, device=dev)
    s, c = e // ncols, e % ncols
    b, j = s // SUBLANES, s % SUBLANES
    read, own = SUBLANES * b + j // height, SUBLANES * b + j
    nch = int(own.max()) + 1 if n else 0
    cur = (torch.arange(nch, device=dev) * 7) % rows
    acc = torch.zeros(n, dtype=torch.float32, device=dev)
    flat = tbl.reshape(-1)
    for _ in range(iters):
        start = torch.clamp_max(cur, rows - height)
        row = start[read] + j % height
        acc = acc + flat[row * ncols + c]
        if mode == "chase":
            cur = tbl[start, 10].long()
        else:
            cur = torch.where(cur + 131 < rows, cur + 131, cur - (rows - 131))
    return acc + cur[own].to(torch.float32)


def chain_plain(tbl, x, iters: int, group: int):
    """make_chain: per group a cursor (starting at 5 x the group index), its
    row, a descend flag: cur <- exit (col 10) or cur + 1 (wrapped), load,
    slab min/max over the row's 6 box values times x, vote any(t0 < t1),
    acc += the group's first t0; out x + acc + cur."""
    rows = tbl.shape[0]
    xg = x.reshape(-1, group)
    ng = xg.shape[0]
    cur = (torch.arange(ng, device=x.device) * 5) % rows
    r = tbl[torch.clamp_max(cur, rows - 1)]
    desc = torch.zeros(ng, dtype=torch.bool, device=x.device)
    acc = torch.zeros(ng, dtype=torch.float32, device=x.device)
    for _ in range(iters):
        nxt = torch.where(desc, cur + 1, r[:, 10].long())
        cur = torch.where(nxt < rows, nxt, nxt - rows)
        r = tbl[torch.clamp_max(cur, rows - 1)]
        col = lambda k: r[:, k : k + 1] * xg
        ax, bx, ay, by, az, bz = col(0), col(3), col(1), col(4), col(2), col(5)
        t0 = torch.maximum(torch.maximum(torch.minimum(ax, bx), torch.minimum(ay, by)),
                           torch.minimum(az, bz))
        t1 = torch.minimum(torch.minimum(torch.maximum(ax, bx), torch.maximum(ay, by)),
                           torch.maximum(az, bz))
        desc = (t0 < t1).any(1)
        acc = acc + t0[:, 0]
    return ((xg + acc[:, None]) + cur.to(torch.float32)[:, None]).reshape(-1)


def staged_plain(tbl, nblk: int, iters: int, mode: str, height: int = 1):
    """make_dma: 8 cursors a block (starting at 97 x their index), each step
    the first 8 rows of the cursors' h-row slices (clamped to rows - h but
    for ``sharedsem+noclamp`` and ``dedup``; ``dedup`` reads cursor 0's
    row for all 8): acc += column 0; ``chase`` cursors take column 10,
    the others step by 997 (wrapped). Out (nblk, 8, 128): acc + cursor."""
    rows = tbl.shape[0]
    dev = tbl.device
    clamp = mode not in ("sharedsem+noclamp", "dedup")
    cur = ((torch.arange(nblk, device=dev)[:, None] * SUBLANES
            + torch.arange(SUBLANES, device=dev)) * 97) % rows
    acc = torch.zeros((nblk, SUBLANES), dtype=torch.float32, device=dev)
    k = torch.arange(SUBLANES, device=dev)
    for _ in range(iters):
        if mode == "dedup":
            row = cur[:, :1].expand(nblk, SUBLANES)
        else:
            src = torch.clamp_max(cur, rows - height) if clamp else cur
            row = src[:, k // height] + k % height
        acc = acc + tbl[row, 0]
        if mode == "chase":
            cur = tbl[row, 10].long()
        else:
            cur = torch.where(cur + 997 < rows, cur + 997, cur - (rows - 997))
    return (acc + cur.to(torch.float32))[:, :, None].expand(nblk, SUBLANES, ROW_F).contiguous()


def staged_multi_plain(tbl, nblk: int, iters: int, nchains: int, spec: bool):
    """make_dma_multi: ``nchains`` pointer chases of 8 equal cursors a block
    (chain g starts at 97 (g + 1)); with ``spec`` both candidates (col 10
    and + 1) are in flight and the row's parity picks one. Out (nblk, 8,
    128): the chains' acc summed in order, plus chain 0's cursor."""
    rows = tbl.shape[0]
    dev = tbl.device
    b = torch.arange(nblk, device=dev)
    cur = [(97 * (g + 1) + SUBLANES * 97 * b) % rows for g in range(nchains)]
    slot0 = [torch.clamp_max(c, rows - 1) for c in cur]
    slot1 = list(slot0)
    acc = [torch.zeros(nblk, dtype=torch.float32, device=dev) for _ in range(nchains)]
    for _ in range(iters):
        for g in range(nchains):
            r = tbl[slot0[g]]
            if spec:
                r1 = tbl[slot1[g]]
                r = torch.where(((r[:, 0].long() & 1) > 0)[:, None], r1, r)
            acc[g] = acc[g] + r[:, 0]
            chase = r[:, 10].long()
            slot0[g] = torch.clamp_max(chase, rows - 1)
            slot1[g] = torch.clamp_max(torch.where(chase + 1 < rows, chase + 1, 0), rows - 1)
            cur[g] = chase
    tot = acc[0]
    for g in range(1, nchains):
        tot = tot + acc[g]
    val = tot + cur[0].to(torch.float32)
    return val[:, None, None].expand(nblk, SUBLANES, ROW_F).contiguous()


# ----------------------------------------------------------------- wrappers --

def latency_chain(mode: str, *, device, x=None, tbl=None, idx=None, n: int, iters: int,
                  p0: int = 0, group: int = 1, block: int = 128, occupancy: bool = False,
                  plain=None):
    """``latency_chain`` in ``mode`` (MODES): on a CUDA ``device`` the
    kernel, given x (n,) f32 (alu, vote, chain), tbl f32 (fetch, chain:
    (rows, ncols); gather: (K, 8, 128)), idx (n,) i32 (gather); p0: alu ops
    a step, fetch height or gather K; group 1 or 32 (vote, chain). Out
    (n,) f32, gather (2, n). On the CPU it returns ``plain()``.
    ``occupancy``: launch nothing, return the blocks an SM holds."""
    if device.type != "cuda":
        return plain()
    if group not in (1, 32) or n % group or (group == 32 and block % 32):
        raise ValueError(f"the kernel takes group 1 or 32 dividing n and block (got {group})")
    if x is not None:
        check("x", x, torch.float32, (n,), device)
    if idx is not None:
        check("idx", idx, torch.int32, (n,), device)
    rows = ncols = 0
    if tbl is not None:
        rows, ncols = tbl.shape[0], tbl[0].numel()
        check("tbl", tbl, torch.float32, tuple(tbl.shape), device)
        if mode in ("fetch_chase", "chain") and ncols < 11:
            raise ValueError("the table needs column 10 (the next cursor)")
    if mode.startswith("gather") and (p0 < 1 or p0 > 32 or p0 & (p0 - 1)):
        raise ValueError(f"gather K must be a power of two up to 32 (got {p0})")
    if mode == "alu" and p0 not in (8, 16, 32):
        raise ValueError(f"alu runs 8, 16 or 32 ops a step (got {p0})")
    if mode == "fetch_chase" and p0 != 1:
        raise ValueError("chase runs at height 1")
    shape = (2, n) if mode.startswith("gather") else (n,)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    args = (MODES[mode], group, tbl, rows, ncols, x, idx, n, iters, p0, block, out)
    if occupancy:
        return call("latency_chain", *args, occupancy=True)
    call("latency_chain", *args)
    LAUNCHES["latency_chain"] += 1
    return out


def alu(x, iters, k, **kw):
    return latency_chain("alu", device=x.device, x=x, n=x.numel(), iters=iters, p0=k,
                         plain=lambda: alu_plain(x, iters, k), **kw)


def vote(x, iters, group, **kw):
    return latency_chain("vote", device=x.device, x=x, n=x.numel(), iters=iters, group=group,
                         plain=lambda: vote_plain(x, iters, group), **kw)


def fetch(tbl, n, iters, mode, height=1, **kw):
    return latency_chain(f"fetch_{mode}", device=tbl.device, tbl=tbl, n=n, iters=iters,
                         p0=height, plain=lambda: fetch_plain(tbl, n, iters, mode, height), **kw)


def chain(tbl, x, iters, group, **kw):
    return latency_chain("chain", device=x.device, x=x, tbl=tbl, n=x.numel(), iters=iters,
                         group=group, plain=lambda: chain_plain(tbl, x, iters, group), **kw)


def staged_chase(tbl, nblk: int, iters: int, mode: str, height: int = 1, nchains: int = 1,
                 spec: bool = False, *, block: int = 32, occupancy: bool = False):
    """Launch ``staged_chase`` (a warp per block of 8 cursors, ``block``
    threads a block) on a CUDA table (rows, 128) f32 that starts on a
    16-byte boundary (cp.async's): ``mode`` a STAGE_MODES key (``multi``:
    ``nchains`` chains, ``spec``). Out (nblk, 8, 128) f32. On a CPU table it
    runs the plain version."""
    if mode in UNCLAMPED and height != 1:
        raise ValueError(f"staged_chase {mode} reads its cursors unclamped: height 1 only")
    if tbl.device.type != "cuda":
        if mode == "multi":
            return staged_multi_plain(tbl, nblk, iters, nchains, spec)
        return staged_plain(tbl, nblk, iters, mode, height)
    dev = tbl.device
    rows = tbl.shape[0]
    check("tbl", tbl, torch.float32, (rows, ROW_F), dev)
    if tbl.data_ptr() % 16:
        raise ValueError("staged_chase: the table must start on a 16-byte boundary (it is "
                         "copied 16 bytes a lane; a fresh tensor does)")
    if block % 32 or height not in (1, 2, 4) or nchains not in (1, 2, 4):
        raise ValueError(f"staged_chase: block a multiple of 32, height and nchains in "
                         f"(1, 2, 4) (got {block}, {height}, {nchains})")
    out = torch.empty((nblk, SUBLANES, ROW_F), dtype=torch.float32, device=dev)
    args = (STAGE_MODES[mode], tbl, rows, nblk, iters, height, nchains, int(spec), block, out)
    if occupancy:
        return call("staged_chase", *args, occupancy=True)
    call("staged_chase", *args)
    LAUNCHES["staged_chase"] += 1
    return out


# ---------------------------------------------------------------- the probes --

def configs(which: str, rows_list=None, table: str = "tool") -> list[dict]:
    """The tool's probe_* lists: one dict per timed configuration; fetch at
    4096 rows and dma/dmag at 65536 (the tool's) and 262144 (beyond the 50
    MB L2) unless ``rows_list`` is given; ``table`` tool or cycle."""
    out = []
    if which in ("alu", "all"):
        out += [dict(probe="alu", k=k) for k in (8, 16, 32)]
    if which in ("vote", "all"):
        out += [dict(probe="vote", group=g) for g in (1, 32)]
    if which in ("fetch", "all"):
        out += [dict(probe="fetch", mode=m, height=h, rows=rows) for rows in rows_list or [4096]
                for m, h in (("indep", 1), ("indep", 2), ("chase", 1))]
    if which in ("chain", "all"):
        out += [dict(probe="chain", group=g) for g in (1, 32)]
    if which in ("dma", "all"):
        for rows in rows_list or [65536, 262144]:
            out += [dict(probe="dma", mode=m, height=h, rows=rows) for m, h in
                    (("indep", 1), ("indep", 2), ("indep", 4), ("chase", 1), ("sharedsem", 1),
                     ("sharedsem+noclamp", 1), ("dedup", 1))]
    if which in ("dmag", "all"):
        for rows in rows_list or [65536, 262144]:
            out += [dict(probe="dmag", nchains=g, spec=s, rows=rows) for g, s in
                    ((1, False), (2, False), (4, False), (1, True), (2, True))]
    return [dict(c, table=table) for c in out]


def runner(cfg: dict, threads: int, block: int, dev, tables: dict):
    """(run(iters, **kw), label, chains a step) of one configuration at
    ``threads`` threads in blocks of ``block``; ``tables`` caches the inputs
    on ``dev`` across configurations."""

    def cached(key, make):
        if key not in tables:
            tables[key] = torch.from_numpy(make()).to(dev)
        return tables[key]

    p = cfg["probe"]
    if p in ("alu", "vote"):
        x = cached(("x", p, threads), lambda: x_of(threads, scale=1.0 if p == "alu" else 0.4))
        if p == "alu":
            fn = lambda it, **kw: alu(x, it, cfg["k"], block=block, **kw)
            return fn, f"alu k={cfg['k']:2d}", cfg["k"]
        fn = lambda it, **kw: vote(x, it, cfg["group"], block=block, **kw)
        return fn, f"vote G={cfg['group']:2d}", 1
    if p == "chain":
        tbl = cached(("chain",), lambda: chain_table()[0])
        x = cached(("x", "chain", threads), lambda: x_of(threads) + np.float32(0.5))
        fn = lambda it, **kw: chain(tbl, x, it, cfg["group"], block=block, **kw)
        return fn, f"chain G={cfg['group']:2d}", 1
    rows, cyc = cfg["rows"], cfg["table"] == "cycle"
    tail = f"rows={rows}{' cycle' * cyc}"
    if p == "fetch":
        tbl = cached(("fetch", rows, cyc), lambda: cycle_table(rows) if cyc else fetch_table(rows))
        fn = lambda it, **kw: fetch(tbl, threads, it, cfg["mode"], cfg["height"], block=block, **kw)
        return fn, f"fetch {cfg['mode']:5s} h={cfg['height']} {tail}", 1
    h = cfg.get("height", 2)  # dmag: make_dma_multi's table
    tbl = cached(("dma", rows, h, cyc), lambda: cycle_table(rows) if cyc else dma_table(rows, height=h))
    nblk = max(1, threads // 32)
    if p == "dma":
        fn = lambda it, **kw: staged_chase(tbl, nblk, it, cfg["mode"], h, block=32, **kw)
        return fn, f"dma {cfg['mode']:17s} h={h} {tail}", 1
    fn = lambda it, **kw: staged_chase(tbl, nblk, it, "multi", nchains=cfg["nchains"],
                                       spec=cfg["spec"], block=32, **kw)
    return fn, f"dmag G={cfg['nchains']} spec={int(cfg['spec'])} {tail}", cfg["nchains"]


def main(argv=None) -> int:
    from hijiki_tpu_torch.probes import timing

    ap = parser(__doc__)
    ap.add_argument("which", nargs="?", default="all",
                    choices=("alu", "vote", "fetch", "chain", "dma", "dmag", "all"))
    ap.add_argument("--rows", type=int, nargs="+", default=None,
                    help="table rows of fetch, dma and dmag (default: fetch 4096, dma and "
                         "dmag 65536, the tool's, 32 MB: in L2, and 262144, beyond the 50 MB L2)")
    ap.add_argument("--table", default="tool", choices=("tool", "cycle"),
                    help="tool: the JAX tool's tables (random exit pointers); cycle: one "
                         "cycle through every row (cycle_table)")
    args = ap.parse_args(argv)
    dev = device_of(args)
    cfgs = configs(args.which, args.rows, args.table)
    tables, results = {}, []
    if dev.type != "cuda":
        for cfg in cfgs:
            cfg = dict(cfg, rows=min(cfg.get("rows", 4096), 4096))
            run, label, _ = runner(cfg, 1024, 128, dev, tables)
            out = run(20)
            print(f"{label}: plain version on the CPU (not timed), sum {float(out.sum()):.6e}")
        return 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"# {card()}; {sms} SMs", flush=True)
    warp_ns = {}
    for occ, threads, block in occupancies(dev):
        for cfg in cfgs:
            run, label, per = runner(cfg, threads, block, dev, tables)
            res = timing.slope(run)
            bps = run(1, occupancy=True)
            res.update(cfg, label=label, occupancy=occ, threads=threads, block=block,
                       blocks_per_sm=bps, resident_warps=bps * block // 32)
            line = (f"{occ:4s} {label:34s} lo {res['t_lo_ms']:8.3f} ms hi {res['t_hi_ms']:8.3f} ms "
                    f"slope {res['ns_per_iter']:9.3f} ns/iter")
            if per > 1:
                line += f" ({res['ns_per_iter'] / per:.3f} ns a {'op' if cfg['probe'] == 'alu' else 'chain step'})"
            if occ == "warp":
                warp_ns[label] = res["ns_per_iter"]
            elif label in warp_ns:
                warps = threads // 32
                res["little"] = timing.little(warp_ns[label], res["ns_per_iter"], warps, sms,
                                              min(res["resident_warps"], warps // sms or 1))
                line += (f"; {res['resident_warps']} warps/SM resident, Little's-law share "
                         f"{res['little']:.3f}")
            print(line, flush=True)
            results.append(res)
    dump(args, results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
