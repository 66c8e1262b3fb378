"""Interactive registration viewer (port of kss_icp_tpu/viz/interactive.py,
numpy only) — terminal equivalent of the reference's GLUT window.

The reference ships an interactive OpenGL viewer: `View.h:1-22` declares
the GLUT callbacks and `Main_KSS_ICP.cpp:1-14` documents the loop ("Main
View ... Show Result"), with the SGI trackball (`trackball.{h,cpp}`)
mapping mouse drags to rotations. An accelerator host has no display
server, so this module re-creates the interactive loop for the place its
user actually has: the terminal. Frames come from the same headless z-buffer
renderer the gallery uses (`viz/render.py`), the same re-derived
quaternion trackball (`viz/trackball.py`) accumulates rotations, and
ANSI truecolor half-block cells (each character = two vertical pixels
via the upper-half-block glyph) put real shaded 3D point clouds in any
modern terminal.

Keys (the reference viewer's mouse vocabulary, keyboard-mapped):
  arrows     rotate (trackball drag in the pressed direction)
  + / -      zoom in / out
  space      auto-spin one step
  r          reset pose
  q / Esc    quit

`InteractiveViewer` is pure state + frame generation (testable without a
TTY); `run_interactive` owns the terminal (raw mode, alternate screen).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, Tuple

import numpy as np

from kss_icp_torch.viz.render import DEFAULT_COLORS, render_clouds
from kss_icp_torch.viz.trackball import Trackball

_DRAG = 0.12         # arrow-key drag distance in trackball coordinates
_ZOOM_STEP = 1.2


class InteractiveViewer:
    """Viewer state machine: key events in, rendered frames out."""

    def __init__(
        self,
        clouds: Sequence[np.ndarray],
        colors: Sequence[Tuple[int, int, int]] = DEFAULT_COLORS,
        size: Tuple[int, int] = (160, 120),
    ):
        self.clouds = [np.asarray(c, np.float32) for c in clouds]
        self.colors = colors
        self.size = size
        self.trackball = Trackball()
        self.zoom = 1.0
        self.running = True
        self.frames_rendered = 0

    # -- events ----------------------------------------------------------
    def handle_key(self, key: str) -> None:
        """Apply one key event. `key` uses symbolic names for arrows
        ("up"/"down"/"left"/"right") and single characters otherwise."""
        if key in ("q", "\x1b"):
            self.running = False
        elif key == "left":
            self.trackball.drag(_DRAG, 0.0, 0.0, 0.0)
        elif key == "right":
            self.trackball.drag(0.0, 0.0, _DRAG, 0.0)
        elif key == "up":
            self.trackball.drag(0.0, 0.0, 0.0, _DRAG)
        elif key == "down":
            self.trackball.drag(0.0, _DRAG, 0.0, 0.0)
        elif key == "+":
            self.zoom = min(self.zoom * _ZOOM_STEP, 20.0)
        elif key == "-":
            self.zoom = max(self.zoom / _ZOOM_STEP, 0.05)
        elif key == " ":
            self.trackball.drag(0.0, 0.0, 0.35, 0.08)
        elif key == "r":
            self.trackball = Trackball()
            self.zoom = 1.0

    # -- frames ----------------------------------------------------------
    def frame(self) -> np.ndarray:
        """Render the current pose to an (H, W, 3) uint8 image."""
        self.frames_rendered += 1
        return render_clouds(
            [c * self.zoom for c in self.clouds],
            rotation=self.trackball.rotation,
            size=self.size,
            colors=self.colors,
        )

    def ansi_frame(self) -> str:
        """The current frame as ANSI truecolor half-block text (W x H/2
        character cells)."""
        return image_to_ansi(self.frame())


def image_to_ansi(img: np.ndarray) -> str:
    """Encode an (H, W, 3) uint8 image as ANSI 24-bit half-block rows:
    each character cell shows two vertical pixels (fg = upper, bg =
    lower) via U+2580 UPPER HALF BLOCK."""
    h = img.shape[0] - (img.shape[0] % 2)
    top = img[0:h:2]
    bot = img[1:h:2]
    rows = []
    for tr, br in zip(top, bot):
        cells = []
        prev = None
        for (r1, g1, b1), (r2, g2, b2) in zip(tr, br):
            code = (r1, g1, b1, r2, g2, b2)
            if code != prev:
                cells.append(
                    f"\x1b[38;2;{r1};{g1};{b1}m\x1b[48;2;{r2};{g2};{b2}m")
                prev = code
            cells.append("▀")
        cells.append("\x1b[0m")
        rows.append("".join(cells))
    return "\n".join(rows)


def _read_key(stdin) -> Optional[str]:
    ch = stdin.read(1)
    if not ch:
        return None
    if ch == "\x1b":                       # escape sequence or bare Esc
        seq = stdin.read(2)
        return {"[A": "up", "[B": "down", "[C": "right",
                "[D": "left"}.get(seq, "\x1b")
    return ch


def run_interactive(
    clouds: Sequence[np.ndarray],
    colors: Sequence[Tuple[int, int, int]] = DEFAULT_COLORS,
    out=None,
) -> int:
    """Own the terminal and run the viewer loop (blocking reads — the
    frame only re-renders on input, so an idle viewer costs nothing)."""
    import os
    import termios
    import tty

    out = out or sys.stdout
    try:
        cols, lines = os.get_terminal_size()
    except OSError:
        cols, lines = 100, 40
    # Half-block cells: width = cols px, height = 2*(lines-2) px.
    size = (max(cols - 2, 20), max(2 * (lines - 3), 20))

    viewer = InteractiveViewer(clouds, colors=colors, size=size)
    # Piped stdin (CI, scripted drives): skip raw mode and the alternate
    # screen, consume keys from the pipe until EOF — the same loop,
    # headlessly drivable.
    is_tty = sys.stdin.isatty()
    fd = sys.stdin.fileno() if is_tty else None
    old = termios.tcgetattr(fd) if is_tty else None
    if is_tty:
        out.write("\x1b[?1049h\x1b[?25l")  # alt screen, hide cursor
    try:
        if is_tty:
            tty.setcbreak(fd)
        while viewer.running:
            if is_tty:
                out.write("\x1b[H")
            out.write(viewer.ansi_frame())
            out.write("\n\x1b[0m arrows rotate | +/- zoom | space spin | "
                      "r reset | q quit \n")
            out.flush()
            key = _read_key(sys.stdin)
            if key is None:
                break
            viewer.handle_key(key)
    finally:
        if is_tty:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
            out.write("\x1b[?25h\x1b[?1049l")
            out.flush()
    return 0
