"""The bilateral reconstruction kernel (K3) and its wrapper.

Counterpart of ``hijiki_tpu/render/pallas_reconstruct.py`` (same module
name, so the two are easy to pair). ``reconstruct`` takes one sweep's
(H, W, 3) radiance and first-hit normals and returns the (H, W, 4) film
delta of the reference's R = 2 filter (``shader/reconstruction.glsl``):

* on a CUDA tensor it launches ``csrc/reconstruct.cu`` (see the note there);
* on a CPU tensor it runs the plain twin, ``render/reconstruct.py::
  reconstruct_sweep`` with the reference's zero albedo.

The kernel computes the 25 spatial weights itself, with the twin's f32
operations (``spatial_weights``), so the two differ only by ``expf``
rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from hijiki_tpu_torch.render.reconstruct import reconstruct_sweep

R = 2  # RECONSTRUCTION_RADIUS (src/main.rs:1284)

# launches of the CUDA kernel (CPU twin calls are not counted)
LAUNCHES = {"reconstruct": 0}


def reconstruct(color, normal, sample_offset, *, block_size: int, stddev: float = 0.5):
    """Radius-2 reconstruction of one sweep; returns the (H, W, 4) delta."""
    if color.device.type != "cuda":
        return reconstruct_sweep(
            color, normal, torch.zeros_like(color), sample_offset,
            block_size=block_size, radius=R, stddev=stddev,
        )
    from hijiki_tpu_torch.utils.build import load_library

    H, W = color.shape[0], color.shape[1]
    for name, t in (("color", color), ("normal", normal)):
        if t.dtype != torch.float32 or tuple(t.shape) != (H, W, 3) or t.device != color.device:
            raise ValueError(f"{name}: expected f32 ({H}, {W}, 3) on {color.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    so_x, so_y = torch.as_tensor(sample_offset, dtype=torch.float32).cpu().tolist()
    gauss_fac = float(np.float32(-1.0 / (2.0 * stddev * stddev)))
    out = torch.empty((H, W, 4), dtype=torch.float32, device=color.device)
    lib = load_library()
    stream = torch.cuda.current_stream(color.device).cuda_stream
    rc = lib.reconstruct(
        color.data_ptr(), normal.data_ptr(), so_x, so_y, gauss_fac,
        H, W, block_size, out.data_ptr(), stream,
    )
    LAUNCHES["reconstruct"] += 1
    if rc != 0:
        raise RuntimeError(f"reconstruct launch failed: CUDA error {rc}")
    return out
