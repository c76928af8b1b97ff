"""Span tracing, the terminal preview and the chain resolvers of
hijiki_tpu_torch (pure logic and CPU renders; tests/test_tracing.py and
tests/test_resolvers.py:17-51 of the JAX package)."""

import collections
import importlib.util
import io
import json
import pathlib
import threading
import time

import numpy as np
import pytest

from hijiki_tpu_torch.render.renderer import (
    RenderConfig, Renderer, chain_chunk_size, resolve_chain_sweeps,
)
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from hijiki_tpu_torch.utils.term_preview import TerminalPreview, render_ansi
from hijiki_tpu_torch.utils import tracing
from hijiki_tpu_torch.utils.tracing import SpanTracer, maybe_span
from torch_port_helpers import MESHBOX_SMALL, frame_inputs


def test_span_tracer_basic(tmp_path):
    tr = SpanTracer()
    before = time.time_ns()
    with tr.span("outer", foo=1) as extra:
        with tr.span("inner"):
            pass
        extra["late"] = 42
    tr.counter("rate", mrays=1.5)
    after = time.time_ns()
    path = tmp_path / "trace.json"
    tr.write(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in evs] == ["inner", "outer", "rate"]
    assert evs[1]["ph"] == "X" and evs[1]["dur"] >= evs[0]["dur"]
    assert evs[1]["args"] == {"foo": 1, "late": 42}
    assert evs[2]["ph"] == "C" and evs[2]["args"]["mrays"] == 1.5
    # µs on the Unix epoch (the profiler's clock for host events), in order
    slack_us = 1e3
    assert before / 1e3 - slack_us <= evs[1]["ts"] <= evs[0]["ts"] <= evs[2]["ts"]
    assert evs[2]["ts"] <= after / 1e3 + slack_us
    # no instant marks: the spans and counters carry what one would
    assert not hasattr(tr, "instant")


def test_maybe_span_none_is_noop():
    with maybe_span(None, "anything") as extra:
        extra["ignored"] = 1


def test_renderer_emits_spans():
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    cfg = RenderConfig(width=32, height=32, spp=3, block_size=64, seed=3, max_bounces=4,
                       chain_sweeps=2)
    r = Renderer(compile_scene(s), cfg, device="cpu")
    r.tracer = SpanTracer()
    r.render()
    evs = r.tracer.events
    names = [e["name"] for e in evs]
    # a chained chunk of 2, a tail sweep, the overflow sync, the film sync,
    # inside the render span, which ends last and carries the rate
    assert names == ["dispatch chained chunk", "dispatch sweep",
                     "overflow check (host sync)", "film ready", "render"]
    assert evs[0]["args"]["sweeps"] == "0..1" and evs[1]["args"]["sweep"] == 2
    assert evs[2]["args"]["overflow"] == 0
    top = evs[4]["args"]
    assert top["mrays_per_s"] == pytest.approx(r.metrics["mrays_per_second"])
    assert (top["chunks"], top["sweeps"], top["overflow"]) == (2, 3, 0)
    for k in ("path_segments", "rows_visited", "phase_paths"):
        assert top[k] == r.metrics[k]
    # no counter track: the render span's args carry the rate
    assert all(e["ph"] == "X" for e in evs)
    # the CUDA events' device ms are a card's; none on the CPU
    assert all("device_ms" not in e["args"] for e in evs)


def test_span_starts_on_the_profilers_clock():
    """A span opened inside a torch.profiler range agrees with the range on
    the clock, to within 1 ms: the range starts between the tracer's
    reading just before it opened and the span's start, and the span ends
    before the range does (a delay between the two widens the bracket, so
    the check holds under any load)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = SpanTracer()
    before = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            name = f"clock range {i}"
            before[name] = tr.now_ns()
            with record_function(name), tr.span(name):
                time.sleep(0.002)
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name() in before}
    assert len(ranges) == 3
    ms = 1e6
    for e in tr.events:
        r0, r1 = ranges[e["name"]]
        s0, s1 = e["ts"] * 1e3, (e["ts"] + e["dur"]) * 1e3
        assert before[e["name"]] - ms <= r0 <= s0 + ms, e["name"]
        assert s1 <= r1 + ms, e["name"]


def test_span_ids_parents_and_render_ids():
    """Every span has its own id and the id of the innermost span open on
    its thread as its parent; the spans of one render carry its render id,
    the image read none."""
    r = Renderer(_port_scene(), RenderConfig(width=32, height=32, spp=3, block_size=64, seed=3,
                                             max_bounces=4, chain_sweeps=2), device="cpu")
    r.tracer = SpanTracer()
    r.render()
    r.image()
    # a span on another thread takes no parent from this one's open span
    other = []
    with r.tracer.span("render"):
        t = threading.Thread(target=lambda: other.append(_one_span(r.tracer)))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    evs = r.tracer.events
    ids = [e["id"] for e in evs]
    assert len(set(ids)) == len(ids)
    by = {e["id"]: e for e in evs}
    renders = [e for e in evs if e["name"] == "render"]
    top = renders[0]
    assert top["parent"] is None and top["render"] == top["id"]
    end = top["ts"] + top["dur"]
    inside = [e for e in evs if top["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end and e is not top]
    assert [e["name"] for e in inside] == ["dispatch chained chunk", "dispatch sweep",
                                           "overflow check (host sync)", "film ready"]
    assert all(e["parent"] == top["id"] and e["render"] == top["id"] for e in inside)
    image = next(e for e in evs if e["name"] == "image")
    assert image["parent"] is None and image["render"] is None
    kids = [e for e in evs if e["parent"] == image["id"]]
    assert [e["name"] for e in kids] == ["normalize film", "copy to host"]
    assert all(by[e["parent"]]["name"] == "image" and e["render"] is None for e in kids)
    lone = by[other[0]]
    assert lone["parent"] is None and lone["render"] is None


def _one_span(tracer):
    with tracer.span("other thread"):
        pass
    return next(e["id"] for e in tracer.events if e["name"] == "other thread")


def _port_scene():
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    return compile_scene(s)


def _spy_chunks(monkeypatch):
    """Record each chunk's (sweeps, phase_shrink, stats) as the renderer
    runs it."""
    chunks = []
    run = Renderer._run_chunk

    def spy(self, kind, block_seeds, offsets, phase_shrink):
        delta, stats = run(self, kind, block_seeds, offsets, phase_shrink)
        chunks.append((len(block_seeds) if kind == "chained" else 1, phase_shrink, stats))
        return delta, stats

    monkeypatch.setattr(Renderer, "_run_chunk", spy)
    return chunks


def test_render_totals_equal_the_sum_of_the_chunks(monkeypatch):
    """The render's path segments and rows are its chunks' per-sweep stats
    times their sweeps, summed; its survivors by phase are the chunks',
    aligned at the last phase (the max_bounces resume); Mrows/s is the
    total over the render's time; JAX's keys keep the last chunk's
    per-sweep values."""
    chunks = _spy_chunks(monkeypatch)
    cfg = RenderConfig(width=32, height=32, spp=3, block_size=64, seed=3, max_bounces=64,
                       chain_sweeps=2)
    m = Renderer(_port_scene(), cfg, device="cpu").render()
    assert [n for n, _, _ in chunks] == [2, 1]
    assert m["path_segments"] == sum(float(st["path_segments"]) * n for n, _, st in chunks) > 0
    assert m["rows_visited"] == sum(float(st["rows_visited"]) * n for n, _, st in chunks) > 0
    # the chained chunk resumes at caps 48 and 64, the sweep at 12, 48, 64
    ch, sw = [[int(v) for v in st["work"][2:]] for _, _, st in chunks]
    assert len(ch) == 2 and len(sw) == 3
    assert m["phase_paths"] == [sw[0], ch[0] + sw[1], ch[1] + sw[2]]
    assert sw[0] > 0
    assert m["mrows_per_second"] == pytest.approx(m["rows_visited"] / m["render_seconds"] / 1e6)
    last = chunks[-1][2]
    assert m["rows_visited_last_sweep"] == float(last["rows_visited"])
    assert m["path_segments_last_sweep"] == float(last["path_segments"])
    assert "retry_rows_visited" not in m


def test_overflow_retries_are_counted_apart(monkeypatch):
    """A render whose phases overflow traces its chunks again at full
    capacity: the retries' work goes to the retry_ keys, the first
    attempts' to the render's own."""
    chunks = _spy_chunks(monkeypatch)
    cfg = RenderConfig(width=32, height=32, spp=2, block_size=64, seed=11, max_bounces=16,
                       mega_chain_cap=2, phase_shrink=(9999,), chain_sweeps=2)
    r = Renderer(_port_scene(), cfg, device="cpu")
    r.tracer = SpanTracer()
    with pytest.warns(UserWarning, match="phase capacity"):
        m = r.render()
    assert m["overflow_retried"] > 0
    first = [(n, st) for n, ps, st in chunks if ps == (9999,)]
    retry = [(n, st) for n, ps, st in chunks if ps == (1,) * 8]
    assert len(first) == len(retry) == 1
    assert m["rows_visited"] == sum(float(st["rows_visited"]) * n for n, st in first)
    assert m["retry_rows_visited"] == sum(float(st["rows_visited"]) * n for n, st in retry)
    assert m["retry_rows_visited"] > m["rows_visited"]  # the first attempt dropped paths
    assert m["mrows_per_second"] == pytest.approx(
        (m["rows_visited"] + m["retry_rows_visited"]) / m["render_seconds"] / 1e6)
    top = next(e for e in r.tracer.events if e["name"] == "render")["args"]
    assert top["retry_rows_visited"] == m["retry_rows_visited"]
    assert [e["parent"] for e in r.tracer.events if e["name"] == "retry chunk (full capacity)"] == [
        next(e["id"] for e in r.tracer.events if e["name"] == "overflow check (host sync)")]


@pytest.mark.parametrize("chained", [False, True])
def test_phase_paths_count_the_alive_lanes(monkeypatch, chained):
    """Each compaction phase's count is the plain count of the alive lanes
    that its K2 launch receives (full capacity, so none is cut)."""
    import torch

    from hijiki_tpu_torch.ops import megakernel as mk

    seen = []
    resume = mk.megakernel_resume

    def spy(ms, st, rng, cap, *args, **kw):
        seen.append(int((st[0] > 0).sum()))
        return resume(ms, st, rng, cap, *args, **kw)

    monkeypatch.setattr(mk, "megakernel_resume", spy)
    W = H = 32
    ms = mk.mega_scene(_port_scene(), W, H, "cpu")
    px, py, seeds = (torch.from_numpy(a) for a in frame_inputs(W, H, 0.5, 0.5, 747796405))
    seeds = seeds.to(torch.int64)
    counts = []
    if chained:
        S = 2
        out = mk.render_waves_chained(ms, px.expand(S, -1), py.expand(S, -1),
                                      torch.stack([seeds, seeds ^ 0x5bd1e995]), max_bounces=64,
                                      chain_cap=2, phase_bounces=(5,), phase_shrink=(1, 1),
                                      phase_paths=counts)
    else:
        out = mk.render_waves(ms, px, py, seeds, max_bounces=64, phase_bounces=(2, 5),
                              phase_shrink=(1, 1, 1), phase_paths=counts)
    assert int(out[4]) == 0
    assert [int(c) for c in counts] == seen
    assert len(seen) == 2 and seen[0] > seen[1] > 0


def test_spans_from_many_threads_keep_ids_parents_and_the_record():
    """Threads (more than the cores) nest spans at once on tracers of their
    own and a shared one, with the interpreter switching threads often:
    every id is unique, every parent is the span that enclosed it on its
    own thread, and the record and each tracer hold every event."""
    import os
    import sys

    n_threads, n_spans = 2 * (os.cpu_count() or 4), 50
    shared = SpanTracer()
    t0 = time.time_ns()
    start = threading.Barrier(n_threads)

    def work(k):
        own = SpanTracer()
        start.wait(timeout=30)
        for i in range(n_spans):
            tr = own if i % 2 else shared
            with tr.span("outer", k=k, i=i), tr.span("inner", k=k, i=i):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    evs = [e for e in tracing.recent(t0, time.time_ns()) if e["name"] in ("outer", "inner")]
    assert len(evs) == 2 * n_threads * n_spans
    assert len({e["id"] for e in evs}) == len(evs)
    assert len(shared.events) == n_threads * n_spans
    outer = {(e["args"]["k"], e["args"]["i"]): e["id"] for e in evs if e["name"] == "outer"}
    for e in evs:
        want = None if e["name"] == "outer" else outer[e["args"]["k"], e["args"]["i"]]
        assert e["parent"] == want and e["render"] is None


def test_untraced_render_records_nothing_and_the_record_is_bounded():
    t0 = time.time_ns()
    r = Renderer(_port_scene(), RenderConfig(width=32, height=32, spp=2, block_size=64, seed=3,
                                             max_bounces=4, chain_sweeps=2), device="cpu")
    r.render()
    r.image()
    assert tracing.recent(t0, time.time_ns()) == []
    assert r.tracer is None and "rows_visited" in r.metrics
    # the record keeps the last RECORD_SIZE events of every tracer
    tr = SpanTracer()
    t1 = time.time_ns()
    for i in range(tracing.RECORD_SIZE + 10):
        tr.counter("bounded", i=i)
    evs = tracing.recent(t1 - 10**9, time.time_ns() + 10**9)
    assert len(evs) == tracing.RECORD_SIZE
    assert evs[0]["args"]["i"] == 10 and evs[-1]["args"]["i"] == tracing.RECORD_SIZE + 9
    # a window selects by the events' times
    mid = evs[len(evs) // 2]["ts"] * 1e3
    assert 0 < len(tracing.recent(t1 - 10**9, mid)) < len(evs)


# the benchmark's readers of the render record: a canned profiler Trace of
# a 1 ms window and canned spans, one render and one image read inside it
# and a render after it
CANNED_WINDOW = (1_000_000, 2_000_000)
CANNED_RECORD = [
    {"name": "render", "ph": "X", "ts": 1_050.0, "dur": 600.0,
     "args": {"rows_visited": 900, "retry_rows_visited": 100, "phase_paths": [30, 7]}},
    {"name": "image", "ph": "X", "ts": 1_750.0, "dur": 150.0, "args": {}},
    {"name": "render", "ph": "X", "ts": 2_500.0, "dur": 100.0,
     "args": {"rows_visited": 10**6, "phase_paths": [1000, 1000]}},
]
CANNED_DEVICE = [("void mk_start_chained_kernel<0, false, false>(Args)", 1_100_000, 1_500_000),
                 ("void mk_resume_tail_kernel<0, false, false>(Args)", 1_550_000, 1_600_000),
                 ("Memcpy DtoH (Device -> Pageable)", 1_800_000, 1_850_000)]
# idle gaps: [1.00, 1.10), [1.50, 1.55), [1.60, 1.80), [1.85, 2.00) ms; the
# render span [1.05, 1.65) covers 0.05 + 0.05 + 0.05 ms of them, the image
# span [1.75, 1.90) 0.05 + 0.05
CANNED_READS = {
    "mega.rows_per_ray": (900 + 100) / 500,
    "mega.trace_ns_per_row": 450_000 / 1000,
    "mega.tail_paths_per_image": 7,
    "renderer.idle_ms_per_image": 0.15,
    "image.idle_ms_per_image": 0.10,
}


@pytest.mark.parametrize("name", sorted(CANNED_READS))
def test_benchmark_reader_of_the_render_record(monkeypatch, name):
    bench = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
    monkeypatch.syspath_prepend(str(bench))
    from trace_reduce import Trace

    def reader(metric):
        spec = importlib.util.spec_from_file_location(
            "canned_" + metric.replace(".", "_"), bench / "metrics" / f"{metric}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    tr = Trace(CANNED_DEVICE, [], *CANNED_WINDOW)
    run = {"trace": tr, "images": 1, "primary_rays": 500}
    monkeypatch.setattr(tracing, "_RECORD", collections.deque(CANNED_RECORD))
    assert reader(name)(run) == pytest.approx(CANNED_READS[name])
    if name == "mega.trace_ns_per_row":
        # rows a ray times ns a row is the trace's ms a Mray
        want = reader("mega.trace_ms_per_mray")(run)
        assert reader("mega.rows_per_ray")(run) * reader(name)(run) == pytest.approx(want)
    # no such span in the window: no reading
    monkeypatch.setattr(tracing, "_RECORD", collections.deque(CANNED_RECORD[2:]))
    assert reader(name)(run) is None


@pytest.mark.parametrize("remaining,chain,want", [
    (64, 8, 8), (8, 8, 8), (100, 8, 5), (12, 8, 6), (10, 8, 5), (28, 8, 7),
    (97, 8, 8), (9, 8, 8), (0, 8, 8), (1, 8, 8),
])
def test_chain_chunk_size(remaining, chain, want):
    assert chain_chunk_size(remaining, chain) == want


def test_resolve_chain_sweeps(monkeypatch):
    monkeypatch.delenv("HIJIKI_CHAIN_SWEEPS", raising=False)
    mega = RenderConfig(spp=12)
    # auto: chained on a CUDA device (8, cut to a divisor of the remaining
    # sweeps), off on the CPU
    assert resolve_chain_sweeps(mega, "cuda") == 6
    assert resolve_chain_sweeps(mega, "cuda", sweeps_done=4) == 8
    assert resolve_chain_sweeps(mega, "cpu") == 1
    assert resolve_chain_sweeps(RenderConfig(chain_sweeps=3), "cpu") == 3
    # chaining needs the mega driver with radius 2, parity albedo, no sort
    with pytest.raises(ValueError, match="chain_sweeps"):
        resolve_chain_sweeps(RenderConfig(driver="sync", chain_sweeps=4), "cuda")
    assert resolve_chain_sweeps(RenderConfig(driver="sync", chain_sweeps=1), "cuda") == 1
    assert resolve_chain_sweeps(RenderConfig(driver="sync"), "cuda") == 1
    monkeypatch.setenv("HIJIKI_CHAIN_SWEEPS", "3")
    assert resolve_chain_sweeps(RenderConfig(), "cpu") == 3
    assert resolve_chain_sweeps(RenderConfig(chain_sweeps=1), "cuda") == 1  # explicit wins
    monkeypatch.setenv("HIJIKI_CHAIN_SWEEPS", "2")
    with pytest.raises(ValueError):
        resolve_chain_sweeps(RenderConfig(sort_lanes=True), "cpu")


def test_term_preview_draws_half_blocks():
    img = np.zeros((5, 4, 3), np.float32)
    img[0, 0] = 1.0
    s = render_ansi(img, max_cols=10, max_rows=10)
    lines = s.split("\n")
    assert len(lines) == 3 and lines[0].count("▀") == 4  # 5 rows padded to 6
    assert lines[0].startswith("\x1b[38;2;255;255;255m\x1b[48;2;0;0;0m")
    out = io.StringIO()
    tp = TerminalPreview(stream=out, enabled=True)
    tp.update(img, "1/2 sweeps")
    tp.update(img, "2/2 sweeps")
    assert "\x1b[4F" in out.getvalue() and out.getvalue().endswith("2/2 sweeps\n")
    quiet = io.StringIO()
    TerminalPreview(stream=quiet).update(img)  # not a TTY: draws nothing
    assert quiet.getvalue() == ""
