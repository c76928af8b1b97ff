"""Span tracing, the terminal preview and the chain resolvers of
hijiki_tpu_torch (pure logic and CPU renders; tests/test_tracing.py and
tests/test_resolvers.py:17-51 of the JAX package)."""

import io
import json

import numpy as np
import pytest

from hijiki_tpu_torch.render.renderer import (
    RenderConfig, Renderer, chain_chunk_size, resolve_chain_sweeps,
)
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from hijiki_tpu_torch.utils.term_preview import TerminalPreview, render_ansi
from hijiki_tpu_torch.utils.tracing import SpanTracer, maybe_span
from torch_port_helpers import MESHBOX_SMALL


def test_span_tracer_basic(tmp_path):
    tr = SpanTracer()
    with tr.span("outer", foo=1) as extra:
        with tr.span("inner"):
            pass
        extra["late"] = 42
    tr.instant("marker", note="x")
    tr.counter("rate", mrays=1.5)
    path = tmp_path / "trace.json"
    tr.write(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in evs] == ["inner", "outer", "marker", "rate"]
    assert evs[1]["ph"] == "X" and evs[1]["dur"] >= evs[0]["dur"]
    assert evs[1]["args"] == {"foo": 1, "late": 42}
    assert evs[3]["ph"] == "C" and evs[3]["args"]["mrays"] == 1.5


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
    # the throughput counter
    assert names == ["dispatch chained chunk", "dispatch sweep",
                     "overflow check (host sync)", "film ready", "throughput"]
    assert evs[0]["args"]["sweeps"] == "0..1" and evs[1]["args"]["sweep"] == 2
    assert evs[2]["args"]["overflow"] == 0
    assert evs[4]["args"]["mrays_per_s"] == pytest.approx(r.metrics["mrays_per_second"])


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
