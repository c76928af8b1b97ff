"""Counter-free per-lane RNG: xorshift32 state + Thomas Wang hash seeding.

Port of ``hijiki_tpu/ops/rng.py`` (the reference's ``shader/rand.glsl:1-50``)
onto torch tensors. Each ray/path carries an explicit 32-bit state; every
helper is a pure function ``state -> (state', value)``.

Torch's CPU ``uint32`` has no ``<<``, ``>>`` or ``+``, so a state here is an
``int64`` tensor holding the unsigned 32-bit value (always masked back into
[0, 2^32)). Bit for bit the same stream as the reference; the CUDA kernels
use native ``uint32_t``.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# 2 * pi as the f32 GLSL literal `2*M_PI` evaluates to.
_TWO_PI = float(np.float32(2.0) * np.float32(3.1415926535897932384626433832795))


def as_state(x, device=None) -> torch.Tensor:
    """Any u32 array (numpy, tensor) -> int64 tensor holding the u32 values."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.to(torch.int64)
        return (x.to(torch.int64) & MASK32).to(device or x.device)
    arr = np.asarray(x, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(arr).to(device or "cpu")


def to_bits(state: torch.Tensor) -> torch.Tensor:
    """int64-held u32 values -> int32 tensor of the same 32 bits (the
    kernels' ``uint32_t``; the cast keeps the low 32 bits)."""
    return state.to(torch.int32)


def from_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 tensor holding the u32 values (inverse of
    ``to_bits``)."""
    return bits.to(torch.int64) & MASK32


def wang_hash(seed: torch.Tensor) -> torch.Tensor:
    """Thomas Wang's integer hash; reference ``shader/rand.glsl:9-16``."""
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & MASK32
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & MASK32
    return seed ^ (seed >> 15)


def seed_rng(seed: torch.Tensor) -> torch.Tensor:
    """``seedRng``: initial state = wang_hash(seed)."""
    return wang_hash(seed)


def xorshift(s: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step (``shader/rand.glsl:2-7``)."""
    s = s ^ ((s << 13) & MASK32)
    s = s ^ (s >> 17)
    return s ^ ((s << 5) & MASK32)


def rand_uint(state: torch.Tensor):
    """xorshift32 step; returns (new_state, new_state)."""
    state = xorshift(state)
    return state, state


def uint_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """``randUniformFloat``: float(u32) * 2^-32, rounded to nearest f32 like
    GLSL's float(uint) (so 0xFFFFFFFF yields exactly 1.0)."""
    return bits.to(torch.float32) * (1.0 / 4294967296.0)


def rand_uniform_float(state: torch.Tensor):
    state, bits = rand_uint(state)
    return state, uint_to_unit_float(bits)


def rand_cos_hemisphere(state: torch.Tensor):
    """Cosine-weighted hemisphere sample around +z (``shader/rand.glsl:22-30``),
    two draws (u then v)."""
    state, u = rand_uniform_float(state)
    state, v = rand_uniform_float(state)
    r = torch.sqrt(u)
    theta = _TWO_PI * v
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = torch.sqrt(torch.clamp_min(1.0 - u, 0.0))
    return state, (x, y, z)


def rand_uniform_sphere(state: torch.Tensor):
    """Uniform direction on the unit sphere (``shader/rand.glsl:32-40``)."""
    state, u = rand_uniform_float(state)
    state, v = rand_uniform_float(state)
    z = 2.0 * u - 1.0
    theta = _TWO_PI * v
    r = torch.sqrt(1.0 - z * z)
    return state, (r * torch.cos(theta), r * torch.sin(theta), z)


def rand_barycentric(state: torch.Tensor):
    """Uniform barycentric coordinates (``shader/rand.glsl:42-50``), with the
    reference's fold quirk: when u + v > 1 it sets u = 1 - v and then
    v = 1 - u with the *new* u, so v ends unchanged."""
    state, u = rand_uniform_float(state)
    state, v = rand_uniform_float(state)
    over = u + v > 1.0
    new_u = 1.0 - v
    new_v = 1.0 - new_u  # == v, faithfully mirroring the quirk
    u = torch.where(over, new_u, u)
    v = torch.where(over, new_v, v)
    return state, (u, v, 1.0 - u - v)
