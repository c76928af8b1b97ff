"""The JAX package's ``ops/pallas_sort.py``: sort one (8,128) lane tile.

``sort_tile_by_key`` takes JAX's call form, one (SUBLANES, PACKET) tile
and a list of channels, views the tile as one ``TILE`` of 1024 flat lanes
(``sublane * 128 + lane``) and sorts it with K8 (``ops/sort.py::
sort_tiles``: ``csrc/sort.cu`` on a CUDA tensor, the plain network on a
CPU one). The network is the TPU kernel's, so the permutation, ties
included, is the TPU's bit for bit. Inside the megakernel the same network
runs as K7 (``csrc/sort.cuh``).

Not carried over: the ``i32`` alias of a jnp dtype.
"""

from __future__ import annotations

import torch

from hijiki_tpu_torch.ops.sort import TILE, sort_tiles

SUBLANES = 8
PACKET = 128
assert SUBLANES * PACKET == TILE

_BITS = (torch.int32, torch.uint32, torch.float32)


def sort_tile_by_key(key, channels):
    """Sort the 1024 flat lanes of an (8,128) tile ascending by ``key``.

    key: (8,128) int32 tensor; channels: a list of (8,128) int32, uint32 or
    float32 tensors on its device, permuted alongside the key. Returns
    (sorted_key, sorted_channels) with each channel's dtype restored."""
    shape = (SUBLANES, PACKET)
    if key.dtype != torch.int32 or tuple(key.shape) != shape:
        raise ValueError(f"key: expected int32 {shape}, got {key.dtype} {tuple(key.shape)}")
    for i, c in enumerate(channels):
        if c.dtype not in _BITS or tuple(c.shape) != shape or c.device != key.device:
            raise ValueError(f"channels[{i}]: expected an int32, uint32 or float32 {shape} "
                             f"tensor on {key.device}, got {c.dtype} {tuple(c.shape)} on {c.device}")
    if channels:
        big = torch.stack([c.contiguous().view(torch.int32) for c in channels]).reshape(-1, 1, TILE)
    else:
        big = torch.empty((0, 1, TILE), dtype=torch.int32, device=key.device)
    skey, out = sort_tiles(key.contiguous().reshape(1, TILE), big)
    return skey.reshape(shape), [o.reshape(shape).view(c.dtype) for o, c in zip(out, channels)]
