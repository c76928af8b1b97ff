"""The bilateral reconstruction kernel (K3) and its wrapper.

Counterpart of ``hijiki_tpu/render/pallas_reconstruct.py`` (same module
name, so the two are easy to pair; ``reconstruct_pallas`` is JAX's call
form). ``reconstruct`` takes S sweeps'
(S, H, W, 3) radiance and first-hit normals and their (S, 2) sample
offsets (or one sweep's (H, W, 3) and (2,)) and returns the (H, W, 4) film
delta of the reference's R = 2 filter (``shader/reconstruction.glsl``),
the S sweeps' deltas summed in sweep order (total = a_0, then
total = total + a_s, as JAX's renderer sums a chained chunk):

* on a CUDA tensor it launches ``csrc/reconstruct.cu`` once (see the note
  there);
* on a CPU tensor it runs the plain twin, ``render/reconstruct.py::
  reconstruct_sweep`` with the reference's zero albedo, sweep by sweep.

``sample_weight`` ((H, W) f32, shared by the S sweeps; the Pallas kernel's
argument of that name) weights each sample: the multi-device bands give
their canvas' padding weight 0. With it the wrapper launches the kernel's
weighted mode (``reconstruct_weighted``, counted apart); without it the
unweighted kernel, unchanged.

The kernel computes the spatial weights itself, with the twin's f32
operations (``spatial_weights``), so the two differ only by ``expf``
rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from hijiki_tpu_torch.render.reconstruct import reconstruct_sweep

R = 2  # RECONSTRUCTION_RADIUS (src/main.rs:1284)
# rows of one grid step of the Pallas kernel: the TPU's tiling, which
# ``reconstruct_pallas`` accepts and the CUDA kernel does not read
STRIP = 8

# launches of the CUDA kernel, unweighted and weighted (CPU twin calls are
# not counted)
LAUNCHES = {"reconstruct": 0, "reconstruct_weighted": 0}


def reconstruct_plain(color, normal, sample_offset, *, block_size: int, stddev: float = 0.5,
                      sample_weight=None):
    """The plain version of ``reconstruct`` (any device): ``reconstruct_sweep``
    of each sweep, summed in sweep order."""
    if color.dim() == 3:
        color, normal, sample_offset = color[None], normal[None], [sample_offset]
    delta = None
    for c, n, so in zip(color, normal, sample_offset):
        d = reconstruct_sweep(c, n, torch.zeros_like(c), so, block_size=block_size,
                              radius=R, stddev=stddev, sample_weight=sample_weight)
        delta = d if delta is None else delta + d
    return delta


def reconstruct(color, normal, sample_offset, *, block_size: int, stddev: float = 0.5,
                sample_weight=None):
    """Radius-2 reconstruction of S sweeps ((S, H, W, 3) inputs, (S, 2)
    offsets) or one ((H, W, 3), (2,)), each sample weighted by
    ``sample_weight`` ((H, W), default 1); returns the (H, W, 4) delta."""
    if color.device.type != "cuda":
        return reconstruct_plain(color, normal, sample_offset, block_size=block_size,
                                 stddev=stddev, sample_weight=sample_weight)
    from hijiki_tpu_torch.utils.build import load_library

    shape = tuple(color.shape)
    if len(shape) not in (3, 4) or shape[-1] != 3:
        raise ValueError(f"color: expected (H, W, 3) or (S, H, W, 3), got {shape}")
    S = shape[0] if len(shape) == 4 else 1
    H, W = shape[-3], shape[-2]
    for name, t in (("color", color), ("normal", normal)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != color.device:
            raise ValueError(f"{name}: expected f32 {shape} on {color.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    offs = torch.as_tensor(sample_offset, dtype=torch.float32).cpu().numpy().reshape(-1)
    if offs.shape != (2 * S,):
        raise ValueError(f"sample_offset: expected {S} offsets of 2, got {offs.size} values")
    if block_size < 1:
        raise ValueError(f"block_size: expected >= 1, got {block_size}")
    weight = () if sample_weight is None else (sample_weight.data_ptr(),)
    if weight:
        w = sample_weight
        if w.dtype != torch.float32 or tuple(w.shape) != (H, W) or w.device != color.device:
            raise ValueError(f"sample_weight: expected f32 {(H, W)} on {color.device}")
        if not w.is_contiguous():
            raise ValueError("sample_weight: expected a contiguous tensor")
    gauss_fac = float(np.float32(-1.0 / (2.0 * stddev * stddev)))
    out = torch.empty((H, W, 4), dtype=torch.float32, device=color.device)
    if H * W:
        name = "reconstruct_weighted" if weight else "reconstruct"
        lib = load_library()
        stream = torch.cuda.current_stream(color.device).cuda_stream
        rc = getattr(lib, name)(
            color.data_ptr(), normal.data_ptr(), *weight, offs.ctypes.data, S, gauss_fac,
            H, W, block_size, out.data_ptr(), stream,
        )
        LAUNCHES[name] += 1
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def reconstruct_pallas(color, normal, sample_offset, sample_weight=None, *, block_size: int,
                       stddev: float = 0.5, interpret: bool = False, strip: int = STRIP):
    """JAX's call form of K3: one sweep's (H, W, 3) radiance and normals,
    its (2,) offset and an optional (H, W) sample weight -> the (H, W, 4)
    delta of ``reconstruct`` (K3, or ``reconstruct_weighted`` with a
    weight, on a CUDA tensor; the plain version on a CPU one). ``strip``
    tiles the TPU's grid and ``interpret`` picks the TPU's interpreter:
    neither changes what runs here, which the inputs' device decides."""
    if sample_weight is not None:
        sample_weight = sample_weight.to(torch.float32).contiguous()
    return reconstruct(color.contiguous(), normal.contiguous(), sample_offset,
                       block_size=block_size, stddev=stddev, sample_weight=sample_weight)
