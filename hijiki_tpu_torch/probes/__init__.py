"""Probes of what bounds the per-thread walk on the H100.

The port of the JAX round's probes (K9, K10, K11 in PERF.md) as
hand-written CUDA kernels, each module beside its JAX tool:

* ``ablate_walker``: K10a ``walk_ablate`` (``csrc/probe_walk.cu``), the
  fixed-trip walker body with switchable parts (tools/ablate_walker.py);
* ``walk_probe``: K10b ``walk_isolate`` (``csrc/probe_walk.cu``), the real
  walk on camera or random rays (tools/walk_probe.py);
* ``chain_latency_probe``: K11a ``latency_chain`` (alu, vote, fetch, chain)
  and ``staged_chase`` (dma, dmag) (``csrc/probe_latency.cu``;
  tools/chain_latency_probe.py);
* ``gather_probe``: the gather modes of ``latency_chain``
  (tools/gather_probe.py);
* ``ab_reconstruct``: K9 ``reconstruct_old`` (``csrc/reconstruct_old.cu``),
  the pre-hoisting reconstruction stencil timed beside K3
  (tools/ab_reconstruct.py);
* ``vpu_issue_probe``: K11b ``alu_issue`` (``csrc/probe_alu.cu``), the ALU
  issue rate (tools/vpu_issue_probe.py);
* ``vpu_dtype_probe``: K11b ``dtype_elementwise`` and ``dtype_slab``
  (``csrc/probe_alu.cu``), f32 against bf16 and packed bf16x2
  (tools/vpu_dtype_probe.py).

Each module holds the plain PyTorch version of its kernel (any device; the
CPU tests hold it to the JAX tool in interpret mode), the wrapper that
launches the kernel on a CUDA tensor and counts the launch in its
``LAUNCHES``, and a ``main()`` with the JAX tool's arguments plus
``--device`` (``cuda`` by default; without a card that is an error, and
``--device cpu`` runs the plain version, untimed). On the card every probe
runs at both occupancies (``occupancies``), and the walk probes at both
group widths (``GROUPS``). ``timing.py`` is the slope harness. Run, for
example,

    python -m hijiki_tpu_torch.probes.chain_latency_probe fetch
    python -m hijiki_tpu_torch.probes.ablate_walker --device cpu 20 128 full

Nothing here imports jax, hijiki_tpu or tools/.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

import torch

from hijiki_tpu_torch.ops.megakernel import _check as check  # noqa: F401 (the probes' input check)
from hijiki_tpu_torch.ops.megakernel import _f as f32  # noqa: F401 (x rounded to f32)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
SCENE = os.path.join(REPO, "scenes", "meshbox", "meshbox.obj")
# threads of the main path's sweep: one per path of a 1024x1024 frame
FULL_THREADS = 1 << 20
FULL_BLOCK = 128
# rays a cursor of the walk probes: a thread alone (the port's design) and a
# warp (the TPU's packet, 32 lanes wide)
GROUPS = (1, 32)


def call(fn_name: str, *args, occupancy: bool = False) -> int:
    """Run the C entry ``fn_name`` of the kernel library on the current
    stream. ``args`` are its arguments up to the ``occ`` pointer (tensors
    pass their data pointer, None a null pointer). ``occupancy``: launch
    nothing and return the blocks of the call's shape one SM holds at once;
    else launch and return 0. Raises on a CUDA error."""
    from hijiki_tpu_torch.utils.build import load_library

    lib = load_library()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    occ = ctypes.c_int(0)
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, fn_name)(*conv, ctypes.byref(occ) if occupancy else None, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc}")
    return occ.value if occupancy else 0


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: launch and time the kernel (needs a card); "
                         "cpu: run the plain version once, untimed")
    ap.add_argument("--json", default=None, help="also write the results to this file")
    return ap


def device_of(args) -> torch.device:
    """The device the caller asked for. No card and no ``--device cpu`` is an
    error, never a fallback."""
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("error: no CUDA card (torch.cuda.is_available() is False); "
                     "pass --device cpu to run the plain versions")
        return torch.device("cuda")
    return torch.device("cpu")


def occupancies(dev: torch.device, per_thread: int = 1) -> list[tuple[str, int, int]]:
    """(name, elements, block) of the two occupancies on the card: one warp
    per SM (grid = SM count, 32 threads a block, each holding
    ``per_thread`` elements; the exposed latency), then the main path's 1M
    elements in blocks of 128 (the throughput). Their ratio against the
    resident warps is the Little's-law share."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return [("warp", sms * 32 * per_thread, 32), ("full", FULL_THREADS, FULL_BLOCK)]


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(0)


def dump(args, results: list) -> None:
    if args.json:
        import json

        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


def sm_clock_during(fn) -> tuple:
    """Run ``fn()`` while nvidia-smi samples the SM clock every 100 ms.
    Returns (fn's result, the median sampled MHz, the card's max SM MHz);
    the clocks are None where nvidia-smi is missing or sampled nothing."""
    import subprocess

    try:
        proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                                 "--format=csv,noheader,nounits", "-lms", "100"],
                                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return fn(), None, None
    try:
        res = fn()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    samples = []
    for line in out.splitlines():
        try:
            samples.append(tuple(float(v) for v in line.split(",")[:2]))
        except ValueError:
            continue
    if not samples:
        return res, None, None
    cur = sorted(c for c, _ in samples)
    return res, cur[len(cur) // 2], max(m for _, m in samples)


# cuobjdump's SASS of each kernel library read, by (path, mtime, size)
_SASS_TEXT = {}


def sass_functions(kernel: str, lib=None) -> dict:
    """The SASS of each kernel function whose mangled name contains
    ``kernel``, from ``cuobjdump -sass`` of the kernel library ``lib`` (a
    path; the package's build by default): {mangled name: ([(opcode, the
    rest of the line), ...], [loop, ...], the function's cuobjdump text)}, a
    loop being the (start, end) indices of a branch target and the backward
    branch that reaches it. Empty where cuobjdump is missing. A library's
    dump is taken once a process."""
    import re
    import shutil
    import subprocess

    from hijiki_tpu_torch.utils.build import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    path = str(lib or build()[0])
    stat = os.stat(path)
    key = (path, stat.st_mtime_ns, stat.st_size)
    if key not in _SASS_TEXT:  # one cuobjdump a library: the checks each read it
        _SASS_TEXT[key] = subprocess.run([tool, "-sass", path], capture_output=True,
                                         text=True, timeout=300).stdout
    text = _SASS_TEXT[key]
    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        if kernel not in name:
            continue
        labels, code = {}, []  # label -> index of its first instruction; (addr, op, rest)
        pending = []
        for line in chunk.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                pending.append(m.group(1))
                continue
            m = ins.search(line)
            if m:
                for lab in pending:
                    labels[lab] = len(code)
                pending = []
                code.append((int(m.group(1), 16), m.group(2), m.group(3)))
        addr_at = {a: i for i, (a, _, _) in enumerate(code)}
        loops = []
        for j, (_, op, rest) in enumerate(code):
            if not op.startswith("BRA"):
                continue
            m = re.search(r"(\.L_x_\d+)", rest)
            start = labels.get(m.group(1)) if m else None
            if start is None:
                m = re.search(r"(0x[0-9a-f]+)", rest)
                start = addr_at.get(int(m.group(1), 16)) if m else None
            if start is not None and start <= j:
                loops.append((start, j))
        out[name] = ([(op, rest) for _, op, rest in code], loops, chunk)
    return out


def op_counts(ops) -> dict:
    """{opcode: count} of a list of (opcode, rest) instructions."""
    counts = {}
    for op, _ in ops:
        counts[op] = counts.get(op, 0) + 1
    return counts


def sass_loop(kernel: str) -> dict:
    """The instructions of the longest loop of each kernel function whose
    mangled name contains ``kernel`` (``sass_functions``): {mangled name:
    {opcode: count}}."""
    out = {}
    for name, (code, loops, _) in sass_functions(kernel).items():
        start, end = max(loops, key=lambda lp: lp[1] - lp[0], default=(0, -1))
        out[name] = op_counts(code[start : end + 1])
    return out
