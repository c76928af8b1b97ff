"""Probes of what bounds the per-thread walk on the H100.

The port of the JAX round's walker-cost probes (K10, K11a in PERF.md) as
hand-written CUDA kernels, each module beside its JAX tool:

* ``ablate_walker``: K10a ``walk_ablate`` (``csrc/probe_walk.cu``), the
  fixed-trip walker body with switchable parts (tools/ablate_walker.py);
* ``walk_probe``: K10b ``walk_isolate`` (``csrc/probe_walk.cu``), the real
  walk on camera or random rays (tools/walk_probe.py);
* ``chain_latency_probe``: K11a ``latency_chain`` (alu, vote, fetch, chain)
  and ``staged_chase`` (dma, dmag) (``csrc/probe_latency.cu``;
  tools/chain_latency_probe.py);
* ``gather_probe``: the gather modes of ``latency_chain``
  (tools/gather_probe.py).

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


def occupancies(dev: torch.device) -> list[tuple[str, int, int]]:
    """(name, threads, block) of the two occupancies on the card: one warp
    per SM (grid = SM count, 32 threads a block; the exposed latency), then
    the main path's 1M threads in blocks of 128 (the throughput). Their ratio
    against the resident warps is the Little's-law share."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return [("warp", sms * 32, 32), ("full", FULL_THREADS, FULL_BLOCK)]


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
