"""Bitonic sort of lane tiles by an int32 key: K7's network and K8's launch.

Port of ``hijiki_tpu/ops/pallas_sort.py::sort_tile_by_key``, which sorts
the 1024 flat lanes (``sublane * 128 + lane``) of an (8,128) tile by a key
and applies the same permutation to every payload channel. The network is
the TPU kernel's, stage for stage, with its pair-consistent keep rule on
ties, so the permutation is the TPU's bit for bit (``torch.sort`` would
order ties otherwise).

* ``sort_tiles`` (K8) sorts T tiles of 1024 lanes: on a CUDA tensor it
  launches ``csrc/sort.cu::sort_tiles`` (one block of 1024 threads per
  tile, the channels copied into shared memory in batches, the first ones
  while the keys sort), on a CPU tensor it runs ``sort_tiles_plain``.
* Inside the megakernel the same network runs as ``csrc/sort.cuh``
  (K7, the lane-sorted K1/K2/K5); the megakernel's plain version sorts with
  ``sort_tiles_plain`` between bounces (``ops/megakernel.py::_lane_sort``).

f32 and u32 channels ride as their int32 bits (``.view(torch.int32)``).
"""

from __future__ import annotations

import torch

# lanes of one tile of the standalone launch: the TPU kernel's (8, 128)
TILE = 1024

# launches of the hand-written kernel (CUDA tensors only); read and reset
# by chip_smoke.py
LAUNCHES = {"sort_tiles": 0}


def _stages(n: int):
    """(k, j) of the bitonic network over n lanes, in order."""
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            yield k, j
            j //= 2
        k *= 2


def bitonic_order(key):
    """Sort each row of ``key`` (T, L) int32, L a power of two, with the TPU
    kernel's network. Returns (sorted key, source lane of each sorted
    entry), both (T, L)."""
    L = key.shape[-1]
    lane = torch.arange(L, device=key.device)
    src = lane.expand(key.shape)
    for k, j in _stages(L):
        partner = lane ^ j
        pkey, psrc = key[:, partner], src[:, partner]
        bit0 = (lane & j) == 0
        ascending = (lane & k) == 0  # all of the tile at k == L
        bigger = key > pkey
        equal = key == pkey
        keep_self = (bit0 & ~bigger) | (~bit0 & (bigger | equal))
        swap = ascending ^ keep_self
        key = torch.where(swap, pkey, key)
        src = torch.where(swap, psrc, src)
    return key, src


def sort_tiles_plain(key, channels):
    """The plain version (any device): key (T, L) int32, channels (C, T, L)
    int32. Returns (sorted key (T, L), permuted channels (C, T, L))."""
    skey, src = bitonic_order(key)
    return skey, torch.gather(channels, 2, src.expand(channels.shape))


def sort_tiles(key, channels):
    """K8: sort T tiles of ``TILE`` lanes. key (T, TILE) int32, channels
    (C, T, TILE) int32 (f32/u32 as ``.view(torch.int32)``). Returns
    (sorted key, permuted channels)."""
    if key.device.type != "cuda":
        return sort_tiles_plain(key, channels)
    T = key.shape[0]
    C = channels.shape[0]
    for name, t, shape in (("key", key, (T, TILE)), ("channels", channels, (C, T, TILE))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected int32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != key.device or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor on {key.device}")
    if channels.data_ptr() % 16:  # the kernel copies each channel's tile 16 bytes at a time
        raise ValueError("channels: expected a tensor that starts on a 16-byte boundary")
    from hijiki_tpu_torch.utils.build import load_library

    key_out = torch.empty_like(key)
    out = torch.empty_like(channels)
    if T:
        stream = torch.cuda.current_stream(key.device).cuda_stream
        rc = load_library().sort_tiles(key.data_ptr(), channels.data_ptr(), T, C,
                                       key_out.data_ptr(), out.data_ptr(), stream)
        LAUNCHES["sort_tiles"] += 1
        if rc != 0:
            raise RuntimeError(f"sort_tiles launch failed: CUDA error {rc}")
    return key_out, out
