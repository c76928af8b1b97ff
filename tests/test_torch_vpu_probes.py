"""K11b, the ALU issue and dtype probes of the port
(hijiki_tpu_torch/probes/vpu_issue_probe.py, vpu_dtype_probe.py), against
the JAX tools they replace (tools/vpu_issue_probe.py, tools/
vpu_dtype_probe.py), in interpret mode on the CPU.

The tools' make_fn and make_slab_fn return only a sum, so each test builds
the tool's pallas_call around its own kernel body (make_kernel, _kernel,
_slab_kernel) and compares the whole (8, P) output.

Tolerances, measured on the CPU: bit-equal where both sides round every
op. That holds for every bf16 body (XLA's bf16 in interpret mode rounds
each op to bf16, as torch's bf16 ops do) and for the f32 slab body (its
multiply-adds feed only min/max and compares here). XLA's CPU backend
contracts a * c + f into an FMA where the plain version, like the kernels
built with --fmad=false, rounds twice: the issue mix differs on 33-44% of
the elements, by at most 2.7e-6 relative (K = 4, 12 trips; rtol 5e-6), and
the f32 elementwise chain on 24% of them, by at most 2.4e-7 relative (rtol
5e-7).
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hijiki_tpu_torch.probes import vpu_dtype_probe as D
from hijiki_tpu_torch.probes import vpu_issue_probe as I
from torch_port_helpers import REPO

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

ITERS = 12
P = 128


def _call(body, out_shape):
    from jax.experimental import pallas as pl

    return pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
                          interpret=True)


def _bits_equal(got, want):
    got = np.asarray(got, np.float32).reshape(-1)
    want = np.asarray(want, np.float32).reshape(-1)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_issue_matches_jax(k):
    import vpu_issue_probe as tool

    x = I.x_of(8 * 1024)
    want = np.asarray(_call(tool.make_kernel(ITERS, k), (8, 1024))(jnp.asarray(x.reshape(8, 1024))))
    got = I.alu_issue(torch.from_numpy(x), ITERS, k).numpy()
    assert np.array_equal(x.reshape(8, 1024), np.random.default_rng(0).random((8, 1024), np.float32))
    np.testing.assert_allclose(got, want.reshape(-1), rtol=5e-6, atol=0)
    assert (got == want.reshape(-1)).mean() > 0.4
    assert I.LAUNCHES["alu_issue"] == 0


@pytest.mark.parametrize("variant", ["f32", "bf16", "bf16x2"])
@pytest.mark.parametrize("chains", [2, 8])
def test_elementwise_matches_jax(variant, chains):
    """Each variant computes the tool's values in its type; bf16x2 the
    tool's bf16 ones (its packed lane layout is a card test)."""
    import vpu_dtype_probe as tool

    dtype = "f32" if variant == "f32" else "bf16"
    dt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    xs = jnp.asarray(np.random.default_rng(0).uniform(0.5, 1.0, (chains, 8, P)), dt)
    body = functools.partial(tool._kernel, iters=ITERS, chains=chains, dtype=dt)
    want = np.asarray(_call(body, (8, P))(xs)).reshape(-1)
    x = D.ew_input(chains, 8 * P, dtype)
    assert np.array_equal(x.float().numpy(), np.asarray(xs.astype(jnp.float32)).reshape(chains, -1))
    got = D.dtype_elementwise(x, ITERS, variant).numpy()
    if dtype == "bf16":
        _bits_equal(got, want)
    else:  # XLA's FMA
        np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)


# (lanes, iters, dtype): the tool's P and, since the kernel maps a row onto
# L lanes a thread of W warps, one warp a row (P = 32) and a row of three
# (P = 96), at the tool's 8 rows
SLAB_CASES = ([pytest.param(P, iters, dtype, id=f"{iters}-{dtype}")
               for iters in (1, ITERS) for dtype in ("f32", "bf16")]
              + [pytest.param(lanes, ITERS, dtype, id=f"P{lanes}-{ITERS}-{dtype}")
                 for lanes in (32, 96) for dtype in ("f32", "bf16")])


@pytest.mark.parametrize("lanes,iters,dtype", SLAB_CASES)
def test_slab_matches_jax(lanes, iters, dtype):
    import vpu_dtype_probe as tool

    dt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    x, row = D.slab_input(8, lanes)
    rng = np.random.default_rng(1)
    assert np.array_equal(x.numpy(), rng.uniform(0.5, 1.5, (6, 8, lanes)).astype(np.float32))
    body = functools.partial(tool._slab_kernel, iters=iters, dtype=dt)
    want = _call(body, (8, lanes))(jnp.asarray(x.numpy()), jnp.asarray(row.numpy()))
    got = D.dtype_slab(x, row, iters, dtype)
    _bits_equal(got, want)
    assert D.LAUNCHES["dtype_slab"] == 0


@pytest.mark.parametrize("P,split", [(32, (1, 1)), (64, (2, 1)), (96, (1, 3)), (128, (4, 1)),
                                     (256, (8, 1)), (384, (4, 3)), (992, (8, 4)), (1024, (8, 4))])
def test_slab_split(P, split):
    """A row of P lanes as (lanes a thread, warps a row): the most lanes of
    SLAB_PREFERRED that divide it into at most SLAB_MAX_WARPS warps, else 8
    lanes a thread with spare lanes (P = 992); never a barrier of more than
    8 warps, and every lane held."""
    lanes, warps = D.slab_split(P)
    assert (lanes, warps) == split
    assert warps <= D.SLAB_MAX_WARPS and 32 * warps * lanes >= P > 32 * warps * lanes - 32 * warps
    assert D.slab_split(P, 32 if P <= 1024 else 8) == (32, 1)


@pytest.mark.parametrize("P,lanes", [(16, None), (1056, None), (100, None), (1024, 2), (1024, 3),
                                     (64, 64)])
def test_slab_split_refuses(P, lanes):
    """P no multiple of 32 up to 1024, lanes not instantiated or spanning
    more than SLAB_MAX_WARPS warps: refused before any launch."""
    with pytest.raises(ValueError):
        D.slab_split(P, lanes)


def _slab_sass(counts):
    """sass_functions' form for every dtype_slab instantiation: a trip loop
    of the given opcode counts ({(Ops, lanes, one warp): {opcode: n}}),
    else a clean loop: the arithmetic of SLAB_ARITH a lane, a vote (one
    warp) or a named barrier in a register."""
    out = {}
    for ops in D.SLAB_ARITH:
        for lanes in D.SLAB_LANES:
            for one in (False, True):
                arith = {"F32Ops": {"FMUL": 6, "FADD": 8, "FMNMX": 10},
                         "Bf16Ops": {"HMUL2.BF16_V2": 3, "HADD2.BF16_V2": 3, "HMNMX2.BF16_V2": 4}}
                ops_n = {op: n * lanes for op, n in arith[ops].items()}
                ops_n.update({"LDS": 6, "VOTE.ANY" if one else "BAR.RED.OR.DEFER_BLOCKING": 1})
                ops_n.update(counts.get((ops, lanes, one), {}))
                code = [("MOV", "")] + [(op, " R4, R5, P0 " if op.startswith("BAR") else " R0 ")
                                        for op, n in ops_n.items() for _ in range(n)]
                code += [("BRA", ""), ("EXIT", "")]
                name = (f"_ZN12_GLOBAL__N_117dtype_slab_kernelINS_{len(ops)}{ops}ELi{lanes}"
                        f"ELb{int(one)}EEEvPKfS3_iiiiiPf")
                out[name] = (code, [(1, len(code) - 2)], "")
    return out


@pytest.mark.parametrize("case", ["clean", "barrier0", "hoisted", "bar_one_warp", "missing"])
def test_check_slab_loops(monkeypatch, case):
    """check_slab_loops passes trip loops that hold each lane's slab
    arithmetic and no barrier 0, and names an instantiation whose loop waits
    on the block's barrier 0 (where __syncthreads_or reduces), holds less
    arithmetic than its lanes (hoisted), or, with one warp a row, holds a
    barrier; and a missing instantiation."""
    import hijiki_tpu_torch.probes as probes

    key = ("F32Ops", 8, False)
    edits = {"clean": {}, "barrier0": {key: {"BAR.RED.OR.DEFER_BLOCKING": 0, "BAR.SYNC0": 1}},
             "hoisted": {key: {"FMNMX": 79}}, "bar_one_warp": {("Bf16Ops", 1, True): {"BAR.SYNC": 1}}}
    fake = _slab_sass(edits.get(case, {}))
    if case == "barrier0":  # the barrier operand 0x0: the block's
        name = next(n for n in fake if "F32OpsELi8ELb0E" in n)
        code, loops, text = fake[name]
        fake[name] = ([(op, " 0x0 " if op == "BAR.SYNC0" else rest) for op, rest in code], loops, text)
    if case == "missing":
        del fake[next(n for n in fake if "Bf16OpsELi32ELb1E" in n)]
    monkeypatch.setattr(probes, "sass_functions", lambda kernel, lib=None: fake)
    if case == "clean":
        got = D.check_slab_loops()
        assert len(got) == 2 * 2 * len(D.SLAB_LANES) and got[key]["FMNMX"] == 80
        return
    what = {"barrier0": "barrier 0", "hoisted": "79 FMNMX", "bar_one_warp": "1 BAR",
            "missing": "23 dtype_slab instantiations"}[case]
    with pytest.raises(RuntimeError, match=what):
        D.check_slab_loops()


def test_slab_dtypes_differ_and_bounds():
    """bf16 rounds the slab values, so the dtypes' outputs differ somewhere;
    an output is the vote count (at most the trips) plus best_t, which starts
    at 1e6 and shrinks by 0.9999 a passing trip; no trip leaves 1e6."""
    x, row = D.slab_input(16, 64)
    a = D.dtype_slab(x, row, ITERS, "f32")
    b = D.dtype_slab(x, row, ITERS, "bf16")
    assert a.shape == (16, 64) and not torch.equal(a, b)
    for out in (a, b):
        assert (out >= 1e6 * 0.9999 ** ITERS * (1 - 1e-6)).all() and (out <= 1e6 + ITERS).all()
    assert (D.dtype_slab(x, row, 0, "f32") == 1e6).all()


@pytest.mark.parametrize("module,argv", [
    ("vpu_issue_probe", ["--device", "cpu", "--ks=1,2"]),
    ("vpu_dtype_probe", ["--device", "cpu", "64", "2"]),
])
def test_main_on_cpu(module, argv, capsys):
    import importlib

    mod = importlib.import_module(f"hijiki_tpu_torch.probes.{module}")
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "plain version on the CPU (not timed)" in out and "ns/trip" not in out


@pytest.mark.parametrize("module", ["vpu_issue_probe", "vpu_dtype_probe"])
def test_main_without_card_is_an_error(module):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", f"hijiki_tpu_torch.probes.{module}"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA card" in r.stderr and "ns/trip" not in r.stdout
