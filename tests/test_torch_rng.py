"""The port's RNG (int64-held u32 xorshift32 / Wang hash) against
hijiki_tpu.ops.rng, bit for bit, and its float conversions."""

import numpy as np
import pytest
import torch

from hijiki_tpu.ops import rng as jrng
from hijiki_tpu_torch.ops import rng as trng
from hijiki_tpu_torch.ops.megakernel import _randf, _u32_to_f32


def _seeds(seed, n=4096):
    r = np.random.default_rng(seed)
    s = r.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    s[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]  # edges of the u32 range
    return s


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_wang_hash_and_xorshift_bitexact(seed):
    s = _seeds(seed)
    want = jrng.seed_rng(s)
    got = trng.seed_rng(trng.as_state(s))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    st_j, st_t = want, got
    for _ in range(8):  # a stream of draws stays bit-equal
        st_j, bits_j = jrng.rand_uint(st_j)
        st_t, bits_t = trng.rand_uint(st_t)
        np.testing.assert_array_equal(bits_t.numpy().astype(np.uint32), bits_j)
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF


@pytest.mark.parametrize("warp", ["rand_uniform_float", "rand_cos_hemisphere",
                                  "rand_uniform_sphere", "rand_barycentric"])
def test_warps_match(warp):
    s = jrng.seed_rng(_seeds(3))
    st_j, vj = getattr(jrng, warp)(s, np)
    st_t, vt = getattr(trng, warp)(trng.as_state(s))
    np.testing.assert_array_equal(st_t.numpy().astype(np.uint32), st_j)
    vj = vj if isinstance(vj, tuple) else (vj,)
    vt = vt if isinstance(vt, tuple) else (vt,)
    for a, b in zip(vj, vt):
        # uniform floats and the barycentric fold are exact; sqrt/cos/sin
        # warps agree to f32 rounding of the transcendental functions
        np.testing.assert_allclose(b.numpy(), np.asarray(a, np.float32), rtol=1e-6, atol=1e-7)
    if warp in ("rand_uniform_float", "rand_barycentric"):
        for a, b in zip(vj, vt):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a, np.float32))


def test_barycentric_fold_quirk_keeps_v():
    s = trng.as_state(jrng.seed_rng(_seeds(5)))
    _, (u, v, _w) = trng.rand_barycentric(s)
    st1, ua = trng.rand_uniform_float(s)
    _, va = trng.rand_uniform_float(st1)
    over = ua + va > 1.0
    # v is "folded" with the already-updated u: v = 1 - (1 - v), which is v
    # up to f32 rounding, never the textbook 1 - u
    torch.testing.assert_close(v, torch.where(over, 1.0 - (1.0 - va), va), rtol=0, atol=0)
    torch.testing.assert_close(u[over], 1.0 - va[over], rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 9])
def test_megakernel_u32_to_f32_bitcast_path(seed):
    """The megakernel's float conversion: int32 reinterpret, +2^32 when
    negative (PARITY.md:54), computed here exactly as the TPU kernel does."""
    s = _seeds(seed).astype(np.uint32)
    i = s.view(np.int32)
    want = np.where(i < 0, i.astype(np.float32) + np.float32(4294967296.0), i.astype(np.float32))
    got = _u32_to_f32(torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    st, f = _randf(torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(st.numpy().astype(np.uint32), jrng.rand_uint(s)[0])
    assert float(f.min()) >= 0.0 and float(f.max()) <= 1.0
