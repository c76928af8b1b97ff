"""The harness on the CPU: cells found by name, the result line, the
window's arithmetic, the trace's reduction and the import guard."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_common import BENCH, ROOT, SEED, TINY, WORKLOAD

import harness  # noqa: E402
import check  # noqa: E402
import peaks  # noqa: E402
from trace_reduce import Trace  # noqa: E402

SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(workload):
    cell = harness.Cell(workload)
    assert cell.config["name"] == cell.cell["config"]
    for key in ("width", "height", "spp", "block_size", "max_bounces", "check"):
        assert key in cell.traffic
    assert set(check.COMPARED) <= set(cell.limits)
    assert [m["name"] for m, _ in cell.readers()] == [
        m["name"] for m in SPEC["per_layer"] if workload in m.get("workloads", [workload])]
    assert [m["name"] for m in cell.end_to_end] == [m["name"] for m in SPEC["end_to_end"]]


@pytest.fixture(scope="module")
def tiny_runs():
    return {trace: harness.run(WORKLOAD, SEED, 0.5, trace, device="cpu", traffic=TINY)
            for trace in (False, True)}


@pytest.mark.parametrize("trace", [False, True])
def test_result_has_the_contract_keys(tiny_runs, trace):
    res = tiny_runs[trace]
    extra = ["breakdown"] if trace else []
    assert list(res) == CONTRACT_KEYS + extra + ["checks"]  # the compared numbers last
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(check.COMPARED)
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    names = set(res["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"setup.kernels_s", "setup.scene_s", "renderer.dispatch_ms_per_image",
                "renderer.overflow_paths_per_image", "device.idle_pct"} <= names
    else:
        assert names == {"mrays_per_s", "image_p95_ms", "setup_s"}  # no card: no peak memory
    json.dumps(res)


def test_rate_is_all_work_over_the_whole_window_and_the_tail_sees_a_stall():
    t = {"width": 800, "height": 600, "spp": 64}
    jobs = [{"seconds": 0.1} for _ in range(37)] + [{"seconds": 1.0} for _ in range(3)]
    window_s = sum(j["seconds"] for j in jobs)
    m = harness.window_metrics(jobs, window_s, t)
    assert m["mrays_per_s"] == pytest.approx(40 * 800 * 600 * 64 / 6.7 / 1e6)
    # the best image's rate would hide the stalls; the window's rate does not
    assert m["mrays_per_s"] < 0.6 * 800 * 600 * 64 / 0.1 / 1e6
    assert m["image_p95_ms"] == pytest.approx(1000.0)  # 3 of 40 stalled: past the 95th
    assert harness.p95([1, 2, 3, 4]) == 4 and harness.p95(list(range(1, 101))) == 95


def canned_trace():
    dev = [("void mk_start_chained_kernel<0, false, false>(Args)", 0, 100),
           ("void mk_resume_kernel<0, false, false>(Args)", 120, 150),
           ("void mk_resume_tail_kernel<0, false, false>(Args)", 150, 200),
           ("void reconstruct_kernel<false>(Args)", 210, 220),
           ("void at::native::elementwise_kernel<128, 4>(Args)", 215, 230),
           ("Memcpy DtoH (Device -> Pinned)", 300, 310),
           # a copy and a fill beside K4, on another stream
           ("Memcpy HtoD (Pageable -> Device)", 20, 30), ("Memset (Device)", 40, 45)]
    host = [("job: render()", 0, 250), ("dispatch chained chunk", 0, 90), ("job: image()", 250, 320)]
    return Trace(dev, host, 0, 400)


def test_trace_groups_union_and_idle_gaps():
    tr = canned_trace()
    assert tr.busy_ns() == 100 + 80 + 20 + 10  # the overlap counts once
    assert tr.gaps() == [(100, 20), (200, 10), (230, 70), (310, 90)]
    bd = tr.breakdown()
    assert [k for k, _ in bd["idle_gaps"]] == ["job: render()", "job: image()"]
    assert [v for _, v in bd["idle_gaps"]] == pytest.approx([100e-9, 90e-9])
    assert bd["device_ops"][0] == ["void mk_start_chained_kernel<0, false, false>(Args)", 100e-9]
    facts = {"trace": tr, "primary_rays": 1e6, "images": 1, "device_kind": peaks.DEFAULT,
             "traffic": {"width": 100, "height": 10, "spp": 8}, "jobs": [], "setup": {}}
    read = {m: r(facts) for (m, r) in [(m["name"], r) for m, r in harness.Cell(WORKLOAD).readers()]
            if m.startswith(("mega.", "device.", "kernels.", "image.", "upload."))}
    assert read["mega.trace_ms_per_mray"] == pytest.approx(180e-9 * 1e3)
    # the elementwise kernel alone: copies and fills are not torch ops
    assert read["mega.torch_ops_ms_per_mray"] == pytest.approx(15e-9 * 1e3)
    assert read["upload.h2d_ms_per_image"] == pytest.approx(10e-9 * 1e3)
    assert read["device.idle_pct"] == pytest.approx(100 * (1 - 210 / 400))
    assert read["image.copy_ms_per_image"] == pytest.approx(10e-9 * 1e3)
    bound = peaks.k3_bound_s(1000, 8, 1)
    assert read["kernels.k3_roofline_pct"] == pytest.approx(100 * bound / 10e-9)


def test_k3_bound_from_shapes():
    # 800 x 600, 64 sweeps in 8 launches: per launch 8 x 480,000 x 625 f32
    # ops at 67 TFLOP/s against 480,000 x (8 x 24 + 16) bytes at 3.35 TB/s
    ops = 8 * 480_000 * 625 / 67e12
    nbytes = 480_000 * (8 * 24 + 16) / 3.35e12
    assert ops > nbytes
    assert peaks.k3_bound_s(480_000, 64, 8) == pytest.approx(8 * ops)
    # one sweep a launch of 1920 x 1080: bound by bytes
    px = 1920 * 1080
    assert peaks.k3_bound_s(px, 1, 1) == pytest.approx(max(px * 625 / 67e12, px * 40 / 3.35e12))


def test_forbidden_names_compare_whole_top_level_names():
    names = ["hijiki_tpu_torch", "hijiki_tpu_torch.ops.megakernel", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["hijiki_tpu.ops", "jax"]) == ["hijiki_tpu", "jax"]


def _modules_after(code: str) -> list:
    prog = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n{code}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, timeout=600,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules_after("import reference, check, scene_input, trace_reduce, peaks")
    assert not {"hijiki_tpu", "hijiki_tpu_torch", "jax", "jaxlib", "flax"} & set(mods)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _modules_after(
        f"import harness\nharness.run({WORKLOAD!r}, 7, 0.2, False, device='cpu', traffic={TINY!r})")
    assert "hijiki_tpu_torch" in mods
    assert not {"hijiki_tpu", "jax", "jaxlib", "flax"} & set(mods)


def test_no_card_means_no_result(capsys):
    assert harness.main(["--workload", WORKLOAD, "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_a_directory_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOAD, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
