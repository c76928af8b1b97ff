"""Live terminal preview: ANSI truecolor half-block rendering.

Port of ``hijiki_tpu/utils/term_preview.py`` (numpy). The reference opens a
winit window and blits the progressive framebuffer every
``present_interval`` blocks (``src/main.rs:1006-1141``); on a headless host
the live view draws the current film into the terminal instead: each
character cell shows two vertical pixels via the upper-half block glyph
(▀) with independent foreground/background 24-bit colors. Callers pass the
normalized image (``shader/preview.glsl:11``).

Pure ANSI: works in any truecolor terminal, draws nothing when the stream
is not a TTY.
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np

from hijiki_tpu_torch.utils.exr import tonemap_srgb


def _tonemap(rgb: np.ndarray) -> np.ndarray:
    """Same display transform as the PNG previews (utils/exr.write_png)."""
    return (tonemap_srgb(rgb) * 255.0 + 0.5).astype(np.uint8)


def render_ansi(rgb: np.ndarray, max_cols: int = 0, max_rows: int = 0) -> str:
    """Render an (H,W,3) float image to an ANSI half-block string."""
    if max_cols <= 0 or max_rows <= 0:
        size = shutil.get_terminal_size((100, 40))
        max_cols = max_cols or max(20, size.columns - 2)
        max_rows = max_rows or max(10, size.lines - 4)
    h, w = rgb.shape[:2]
    # each text row shows 2 image rows; fit inside (max_rows*2, max_cols)
    scale = max(1, -(-w // max_cols), -(-h // (2 * max_rows)))
    img = _tonemap(rgb[::scale, ::scale])
    if img.shape[0] % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
    top = img[0::2]
    bot = img[1::2]
    lines = []
    for tr, br in zip(top, bot):
        parts = []
        for (r1, g1, b1), (r2, g2, b2) in zip(tr, br):
            parts.append(
                f"\x1b[38;2;{r1};{g1};{b1}m\x1b[48;2;{r2};{g2};{b2}m▀"
            )
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


class TerminalPreview:
    """Progressive in-place terminal preview (cursor-rewind redraws)."""

    def __init__(self, stream=None, enabled: "bool | None" = None):
        self.stream = stream if stream is not None else sys.stderr
        if enabled is None:
            enabled = (
                hasattr(self.stream, "isatty")
                and self.stream.isatty()
                and os.environ.get("TERM", "dumb") != "dumb"
            )
        self.enabled = enabled
        self._last_lines = 0

    def update(self, rgb: np.ndarray, status: str = "") -> None:
        if not self.enabled:
            return
        frame = render_ansi(rgb)
        n = frame.count("\n") + 1 + (1 if status else 0)
        out = ""
        if self._last_lines:
            out += f"\x1b[{self._last_lines}F"  # rewind to frame start
        out += frame + "\x1b[0m\n"
        if status:
            out += f"\x1b[2K{status}\n"
        self.stream.write(out)
        self.stream.flush()
        self._last_lines = n

    def close(self) -> None:
        self._last_lines = 0
