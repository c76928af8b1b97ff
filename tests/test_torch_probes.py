"""The walker-cost probes of the port (hijiki_tpu_torch/probes/) against the
JAX tools they replace, run in interpret mode on the CPU.

Each plain version gets the JAX tool's own inputs (numpy-seeded tables,
rays and indices) and must compute its kernel's outputs. ``pallas_call`` is
patched to interpret mode inside each test only (monkeypatch of the tool
module's ``pl``), the tools are imported from tools/ as
tests/test_tools_smoke.py does, and their make_*/run_variant/build
functions are called, never their main().

Tolerances, measured on the CPU: bit-equal where both sides round every
op. XLA on the CPU contracts a * c + f into an FMA (the plain version,
like the kernels built with --fmad=false, rounds twice), which shows in:
alu (at most 1.49e-6 absolute, on 6-8 of 1024 elements); the ablation's
nocount output plane (2.4e-7 on 8 of 2048 lanes: t/u rounded otherwise,
masked in the other variants by the +iters of the counter); walk_probe's t
(at most 3.28e-5 relative, on 96 of 1024 camera rays at 32x32, every hit
and miss the same).
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hijiki_tpu_torch.probes import ablate_walker as A
from hijiki_tpu_torch.probes import chain_latency_probe as C
from hijiki_tpu_torch.probes import gather_probe as G
from hijiki_tpu_torch.probes import walk_probe as W
from torch_port_helpers import MESHBOX_SMALL, REPO, port_scene

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

ITERS = 24
T = torch.from_numpy


def _interpret(monkeypatch, name):
    """The tool module ``name`` with its pallas_call in interpret mode."""
    import importlib

    mod = importlib.import_module(name)
    monkeypatch.setattr(mod.pl, "pallas_call", functools.partial(mod.pl.pallas_call, interpret=True))
    return mod


def _bits_equal(got, want):
    got = np.asarray(got, np.float32).reshape(-1)
    want = np.asarray(want, np.float32).reshape(-1)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@functools.lru_cache(maxsize=1)
def _jax_scene():
    from hijiki_tpu.scene.compile import compile_scene
    from hijiki_tpu.scene.obj import load_obj_scene

    scene = load_obj_scene(MESHBOX_SMALL)
    scene.put_cbox_spheres()
    return compile_scene(scene)


# ------------------------------------------------------------------ K10a --

@pytest.mark.parametrize("variant", list(A.VARIANTS))
def test_ablate_walker_matches_jax(monkeypatch, variant):
    aw = _interpret(monkeypatch, "ablate_walker")
    cs = _jax_scene()
    rows = np.asarray(cs.trace_rows_mega)
    assert rows.shape == (3736, 32)
    o, d = A.tool_rays(1, 128)
    cfg = dict(A.VARIANTS[variant], iters=ITERS, rows=rows.shape[0])
    want = A.lanes_of(np.asarray(aw.run_variant(jnp.asarray(rows), jnp.asarray(o), jnp.asarray(d),
                                                cfg, 1, 128)))
    got = A.walk_ablate(T(rows), T(A.lanes_of(o)), T(A.lanes_of(d)), ITERS, A.VARIANTS[variant], 128)
    got = got.numpy()
    if variant == "nocount":  # XLA's FMA in the prim test shows in t/u
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
        assert (got != want).mean() <= 0.01
    else:
        _bits_equal(got, want)
    # the outputs tell the variants apart (the tool's stale-binary check),
    # but for noprefetch, which changes the time and not the walk: the
    # prefetched row is the one the cursor then takes
    if variant not in ("full", "noprefetch"):
        full = A.walk_ablate_plain(T(rows), T(A.lanes_of(o)), T(A.lanes_of(d)), ITERS, {}, 128)
        assert not torch.equal(full, torch.from_numpy(got))


@pytest.mark.parametrize("variant", ["full", "noreduce", "noprefetch", "onlyloop"])
def test_ablate_group_one_and_layouts(variant):
    """At group 1 noreduce is full (a ray votes alone); lanes_of keeps each
    block's rays in order; the wrapper takes the plain version on the CPU."""
    rows = T(np.asarray(_jax_scene().trace_rows_mega))
    o, d = A.tool_rays(2, 64)
    lo, ld = T(A.lanes_of(o)), T(A.lanes_of(d))
    assert torch.equal(lo.reshape(3, 2, 8, 64).permute(1, 0, 2, 3), T(o))
    got = A.walk_ablate(rows, lo, ld, 8, A.VARIANTS[variant], 1)
    assert got.shape == (2, 1024) and torch.isfinite(got).all()
    if variant == "noreduce":
        assert torch.equal(got, A.walk_ablate(rows, lo, ld, 8, {}, 1))
    assert A.LAUNCHES["walk_ablate"] == 0


def test_variant_flags_match_the_kernel_switch():
    """The flag bits of the VARIANTS entries are the cases csrc/probe_walk.cu
    instantiates."""
    src = open(os.path.join(REPO, "hijiki_tpu_torch", "csrc", "probe_walk.cu")).read()
    for name, cfg in A.VARIANTS.items():
        flags = A.variant_flags(cfg)
        if not cfg.get("fetch", True):  # prefetch is moot without fetch
            flags |= 2
        assert f"ABLATE_CASE({flags})" in src and f"// {name}" in src, name


# ------------------------------------------------------------------ K10b --

@pytest.mark.parametrize("width", [32, 16])
@pytest.mark.parametrize("test", [True, False], ids=["test", "notest"])
def test_walk_probe_matches_jax(monkeypatch, width, test):
    import hijiki_tpu.ops.pallas_megakernel as mk
    from hijiki_tpu.scene.compile import scene_to_device

    wp = _interpret(monkeypatch, "walk_probe")
    monkeypatch.setattr(wp, "P", 128)  # one tile of 8 x 128 rays
    monkeypatch.setattr(mk, "_prim_test", mk._prim_test)  # restored after the test
    monkeypatch.setattr(mk, "_resolve_winners", mk._resolve_winners)
    cs = scene_to_device(_jax_scene())
    if width == 16:
        cs = scene_to_device(wp.make_w16_scene(cs))
        wp.patch_normals_at_11()
        # the tool's main_widths: no resolve (the 16-wide table has no payload)
        mk._resolve_winners = lambda rows_ref, total_rows, analytic, final, **kw: final
    if not test:
        wp.patch_no_test()
    o, d = wp.camera_rays_np(cs, 32, 32)
    want_t, _ = wp.make_runner(cs, 4)(o, d)
    ms = port_ms()
    rows = W.w16_rows(ms.rows) if width == 16 else ms.rows
    o, d = T(np.asarray(o)), T(np.asarray(d))
    got_t, got_n = W.walk_isolate(ms, rows, o, d, test=test)
    want_t = np.asarray(want_t).reshape(-1)
    np.testing.assert_array_equal(got_t.numpy() > 1e30, want_t > 1e30)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=5e-5)
    # the packet walk visits more rows and finds the same hits
    pk_t, pk_n = W.walk_isolate(ms, rows, o, d, test=test, group=32)
    assert torch.equal(pk_t, got_t)
    assert (pk_n >= got_n).all() and pk_n.mean() > got_n.mean()


@functools.lru_cache(maxsize=1)
def port_ms():
    from hijiki_tpu_torch.ops import megakernel as pmk

    return pmk.mega_scene(port_scene(_jax_scene()), 32, 32, "cpu")


def test_walk_probe_group_one_is_the_render_walk():
    """Group 1 is ops/megakernel.py's own walk (t and rows visited) on random
    rays; the 16-column table gives the same t."""
    from hijiki_tpu_torch.ops import megakernel as pmk

    ms = port_ms()
    cs = port_scene(_jax_scene())
    o, d = W.ray_set("random", cs, 512, "cpu")
    t, nit = W.walk_isolate(ms, ms.rows, o, d)
    ref = pmk._trace_closest(ms, tuple(o), tuple(d), torch.full((512,), np.float32(1e-4)),
                             torch.full((512,), np.float32(3e38)))
    assert torch.equal(t, ref["t"])
    # _trace_closest also counts the winner's row fetch (a table hit: the
    # analytic table holds triangles, kind 2)
    assert torch.equal(nit, ref["nit"] - (ref["hitf"] & (ref["kind"] == 2.0)).float())
    t16, _ = W.walk_isolate(ms, W.w16_rows(ms.rows), o, d)
    assert torch.equal(t16, t)


# ------------------------------------------------------------------ K11a --

@pytest.mark.parametrize("k", [8, 16, 32])
def test_alu_matches_jax(monkeypatch, k):
    clp = _interpret(monkeypatch, "chain_latency_probe")
    f, (x,) = clp.make_alu(ITERS, k_ops=k, width=128)
    want = np.asarray(f(x)).reshape(-1)
    got = C.alu(T(np.asarray(x)).reshape(-1), ITERS, k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)  # XLA's FMA
    assert (got != want).mean() <= 0.02


@pytest.mark.parametrize("width", [128, 256])
def test_vote_matches_jax(monkeypatch, width):
    clp = _interpret(monkeypatch, "chain_latency_probe")
    f, (x,) = clp.make_vote(ITERS, width=width)
    _bits_equal(C.vote(T(np.asarray(x)).reshape(-1), ITERS, width), f(x))


@pytest.mark.parametrize("mode,height", [("indep", 1), ("indep", 2), ("chase", 1)])
def test_fetch_matches_jax(monkeypatch, mode, height):
    clp = _interpret(monkeypatch, "chain_latency_probe")
    f, (tbl,) = clp.make_fetch(ITERS, mode=mode, rows=4096, height=height)
    _bits_equal(C.fetch(T(np.asarray(tbl)), 8 * 128, ITERS, mode, height), f(tbl))
    assert np.array_equal(C.fetch_table(4096), np.asarray(tbl))


@pytest.mark.parametrize("width", [128, 256])
def test_chain_matches_jax(monkeypatch, width):
    clp = _interpret(monkeypatch, "chain_latency_probe")
    f, (tbl, x) = clp.make_chain(ITERS, width=width, rows=4096)
    got = C.chain(T(np.asarray(tbl)), T(np.asarray(x)).reshape(-1), ITERS, width)
    _bits_equal(got, f(tbl, x))


@pytest.mark.parametrize("mode,height", [("indep", 1), ("indep", 2), ("indep", 4), ("chase", 1),
                                         ("sharedsem", 1), ("sharedsem+noclamp", 1), ("dedup", 1)])
def test_dma_matches_jax(monkeypatch, mode, height):
    clp = _interpret(monkeypatch, "chain_latency_probe")
    f, (tbl,) = clp.make_dma(ITERS, mode=mode, rows=4096, height=height)
    _bits_equal(C.staged_chase(T(np.asarray(tbl)), 1, ITERS, mode, height)[0], f(tbl))
    assert np.array_equal(C.dma_table(4096, height=height), np.asarray(tbl))


@pytest.mark.parametrize("mode", ["sharedsem+noclamp", "dedup"])
def test_staged_chase_refuses_unclamped_heights(mode):
    """An unclamped cursor reads past the table's end above height 1 (the
    tool keeps it in bounds only at height 1): the wrapper refuses it on
    any device, before the kernel or the plain version runs."""
    tbl = T(C.dma_table(4096, height=2))
    with pytest.raises(ValueError, match="height 1"):
        C.staged_chase(tbl, 4, 2, mode, 2)


@pytest.mark.parametrize("nchains,spec", [(1, False), (2, False), (4, False), (1, True), (2, True)])
def test_dma_multi_matches_jax(monkeypatch, nchains, spec):
    clp = _interpret(monkeypatch, "chain_latency_probe")
    f, (tbl,) = clp.make_dma_multi(ITERS, nchains=nchains, rows=4096, spec=spec)
    got = C.staged_chase(T(np.asarray(tbl)), 1, ITERS, "multi", nchains=nchains, spec=spec)
    _bits_equal(got[0], f(tbl))


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("mode", list(G.MODES))
def test_gather_matches_jax(monkeypatch, mode, K):
    gp = _interpret(monkeypatch, "gather_probe")
    tbl, idx = G.gather_inputs(1024, K)
    want = gp.build(ITERS, mode, K)(jnp.asarray(tbl), jnp.asarray(idx.reshape(8, 128)))
    tpu = G.gather_plain(T(tbl), T(idx), ITERS, mode, order="tpu")
    _bits_equal(tpu, want)
    entry = G.gather(T(tbl), T(idx), ITERS, mode)  # the kernel's order
    if mode == "const":
        assert torch.equal(entry, tpu)
    else:  # the TPU's two take_along_axis read another entry (ROADMAP Queue 3)
        assert not torch.equal(entry, tpu)


@pytest.mark.parametrize("mode,n,ncols,aligned,block,resident,want", [
    # fetch: a float4 a thread on a table of ncols % 4 == 0 that starts on a
    # 16-byte boundary (a warp a 128-column row); n not a multiple of 4 or
    # of the block rounds up
    ("fetch_chase", 1 << 20, 128, True, 128, None, ("row4", 4, 1 << 18)),
    ("fetch_indep", 4059, 128, True, 128, None, ("row4", 4, 1015)),
    ("fetch_indep", 4096, 64, True, 32, None, ("row4", 4, 1024)),
    # a column a thread: ncols off a multiple of 4, a table off a 16-byte boundary
    ("fetch_chase", 4096, 130, True, 128, None, ("column", 1, 4096)),
    ("fetch_indep", 4059, 128, False, 128, None, ("column", 1, 4059)),
    # chain: three float4s a row where ncols >= 12, % 4 == 0, aligned
    ("chain", 4096, 128, True, 128, None, ("row4", 1, 4096)),
    ("chain", 4096, 8, True, 128, None, ("column", 1, 4096)),
    ("chain", 4096, 130, True, 128, None, ("column", 1, 4096)),
    ("chain", 4096, 128, False, 128, None, ("column", 1, 4096)),
    # gather: the persistent grid, at most the card's resident blocks
    ("gatherK", 300001, 1024, True, 1024, 132, ("column", 1, 132 * 1024)),
    ("gather1", 1000, 1024, True, 128, 1716, ("column", 1, 1024)),
    ("gather_const", 4224, 1024, True, 32, 1716, ("column", 1, 4224)),
    ("gatherK", 5000, 1024, True, 128, None, ("column", 1, 5120)),
    # alu, vote: a column a thread
    ("alu", 4096, 0, True, 128, None, ("column", 1, 4096)),
    ("vote", 4096, 0, True, 128, None, ("column", 1, 4096)),
])
def test_latency_chain_launch_geometry(mode, n, ncols, aligned, block, resident, want):
    """The wrapper's launch of latency_chain (chain_latency_probe.geometry,
    what the C entry is handed): its layout, elements a thread and threads,
    given the table's columns and alignment."""
    layout, per, threads = C.geometry(mode, n, ncols, aligned, block, resident)
    assert (layout, per, threads) == (C.LAYOUTS[want[0]], want[1], want[2])
    if mode.startswith("gather"):  # whole blocks, none without an element
        assert threads % block == 0 and threads < n + block
    else:  # every element held, no thread without one
        assert per * threads >= n > per * (threads - 1)


def test_staged_chase_is_the_fetch_chain():
    """The staged copy changes the memory path, not the values: the indep
    and chase modes add column 0 of the rows a fetch chain with the same
    start and step would read."""
    tbl = T(C.dma_table(4096))
    got = C.staged_chase(tbl, 2, ITERS, "chase")[:, :, 0]
    cur = (torch.arange(16) * 97) % 4096
    acc = torch.zeros(16)
    for _ in range(ITERS):
        acc = acc + tbl[cur, 0]
        cur = tbl[cur, 10].long()
    assert torch.equal(got.reshape(-1), acc + cur.float())


def test_cycle_table_is_one_cycle():
    """cycle_table's exit pointers visit every row before they repeat (the
    tool's random pointers fall into a short cycle: a chase stays in L1)."""
    tbl = C.cycle_table(4096)
    cur, seen = 0, set()
    for _ in range(4096):
        seen.add(cur)
        cur = int(tbl[cur, 10])
    assert len(seen) == 4096 and cur == 0
    tool = C.fetch_table(4096)
    cur, seen = 0, []
    while cur not in seen:
        seen.append(cur)
        cur = int(tool[cur, 10])
    assert len(seen) - seen.index(cur) < 400


@pytest.mark.parametrize("cost_ns,cold", [(100.0, 1.0), (45.0, 2.0), (7000.0, 1.0)])
def test_slope_harness_cancels_fixed_costs(monkeypatch, cost_ns, cold):
    """The slope of a run whose time is a fixed cost plus a cost a step is
    that cost a step, with lo's launch at least MIN_MS even when the
    calibration runs were cold (``cold`` times slower than warm ones)."""
    from hijiki_tpu_torch.probes import timing

    def run(it):  # milliseconds of a launch of `it` steps
        calibrating = it % 64 == 0 and (it // 64) & (it // 64 - 1) == 0
        return 0.05 + it * cost_ns * 1e-6 * (cold if calibrating else 1.0)

    monkeypatch.setattr(timing, "best_ms", lambda fn, reps=timing.REPS: fn())
    res = timing.slope(run)
    assert res["hi"] == 3 * res["lo"] and res["t_lo_ms"] >= timing.MIN_MS
    assert res["t_hi_ms"] <= 50.0 and abs(res["ns_per_iter"] - cost_ns) < 1e-6 * cost_ns


# ------------------------------------------------------------ main() glue --

@pytest.mark.parametrize("module,argv", [
    ("ablate_walker", ["--device", "cpu", "12", "128", "full", "noprefetch"]),
    ("walk_probe", ["--device", "cpu", "16"]),
    ("chain_latency_probe", ["--device", "cpu", "all"]),
    ("gather_probe", ["--device", "cpu", "12", "4"]),
])
def test_probe_main_on_cpu(module, argv, capsys):
    import importlib

    mod = importlib.import_module(f"hijiki_tpu_torch.probes.{module}")
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "plain version on the CPU (not timed)" in out and "ns/iter" not in out


@pytest.mark.parametrize("module", ["ablate_walker", "walk_probe", "chain_latency_probe",
                                    "gather_probe"])
def test_probe_main_without_card_is_an_error(module):
    """No card and no --device cpu: an error exit, never a CPU fallback (the
    card, if any, hidden from the child)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", f"hijiki_tpu_torch.probes.{module}"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA card" in r.stderr and "ns/iter" not in r.stdout


def test_probes_import_no_jax_and_no_tools():
    """The probes and chip_smoke.py import neither jax, hijiki_tpu nor a
    module of tools/, in an interpreter where importing jax fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None  # any import of jax raises\n"
        "import hijiki_tpu_torch.probes.ablate_walker, hijiki_tpu_torch.probes.walk_probe\n"
        "import hijiki_tpu_torch.probes.chain_latency_probe, hijiki_tpu_torch.probes.gather_probe\n"
        "import hijiki_tpu_torch.probes.ab_reconstruct, hijiki_tpu_torch.probes.vpu_issue_probe\n"
        "import hijiki_tpu_torch.probes.vpu_dtype_probe\n"
        "import hijiki_tpu_torch.probes.timing, chip_smoke\n"
        "bad = [m for m in sys.modules if m.startswith(('hijiki_tpu.', 'jax.')) or m in (\n"
        "    'hijiki_tpu', 'ablate_walker', 'walk_probe', 'chain_latency_probe', 'gather_probe',\n"
        "    'ab_reconstruct', 'vpu_issue_probe', 'vpu_dtype_probe')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
