"""Interactive terminal display backend.

The reference blits frames into an SDL2 window and polls keyboard/mouse
events (upstream ``src/simulation.rs``; SURVEY.md §3.2).  On a headless
host the equivalent interactive surface is the terminal: frames are drawn
with ANSI truecolor half-block glyphs (two pixels per character cell, '▀'
with foreground = top pixel / background = bottom pixel) and keys are read
from the tty in raw mode without blocking the render loop.

Controls (same bindings as viewer.simulation.Simulation.handle_keys):
  w/a/s/d/q/e  move   j/l yaw   i/k pitch   u/o roll
  n/m w-yaw    ,/. w-pitch (4D scenes)      x quit
  mouse drag   look (xterm SGR mouse reporting — the reference's SDL2
               mouse-look, SURVEY §2.1 Cameras, over a plain tty)

A copy of ``euclider_tpu/viewer/terminal.py`` (numpy and the standard
library only); ``run_interactive`` drives this package's
``viewer.simulation.Simulation``.  ``tests/test_torch_viewer.py`` holds the
strings, the parsed input and the snapshots equal to the JAX package's.
"""
from __future__ import annotations

import re
import select
import shutil
import sys
from typing import List, Optional, Tuple

import numpy as np

ESC = "\x1b"

# xterm mouse reporting: 1002 = button-event (drag) tracking, 1006 = SGR
# extended coordinates (ESC[<b;x;yM / m)
MOUSE_ON = f"{ESC}[?1002h{ESC}[?1006h"
MOUSE_OFF = f"{ESC}[?1006l{ESC}[?1002l"
_SGR_MOUSE = re.compile(r"\x1b\[<(\d+);(\d+);(\d+)([Mm])")


class MouseParser:
    """Split raw tty input into plain keys and mouse-drag deltas.

    Feeds on the byte stream of a terminal with SGR mouse reporting on:
    press (button 0-2, final 'M') anchors the drag, motion events (bit 32)
    yield (dx, dy) cell deltas, release ('m') ends it.  Everything that is
    not an SGR mouse sequence passes through as key input."""

    def __init__(self):
        self._anchor = None

    def parse(self, data: str) -> Tuple[str, List[Tuple[int, int]]]:
        moves: List[Tuple[int, int]] = []

        def eat(m: "re.Match") -> str:
            b, x, y, kind = (int(m.group(1)), int(m.group(2)),
                             int(m.group(3)), m.group(4))
            if kind == "m":                      # release
                self._anchor = None
            elif b & 32:                         # drag motion
                if self._anchor is not None:
                    moves.append((x - self._anchor[0], y - self._anchor[1]))
                self._anchor = (x, y)
            elif b & 3 != 3:                     # press (button 0/1/2)
                self._anchor = (x, y)
            return ""

        keys = _SGR_MOUSE.sub(eat, data)
        return keys, moves


def frame_to_ansi(img: np.ndarray, cols: Optional[int] = None,
                  rows: Optional[int] = None) -> str:
    """Render an [H, W, 3] float image as ANSI truecolor half-blocks.

    Downsamples (nearest) to the terminal size; two image rows per text row.
    """
    if cols is None or rows is None:
        ts = shutil.get_terminal_size((100, 40))
        cols = cols or ts.columns
        rows = rows or max(ts.lines - 2, 4)
    H, W = img.shape[:2]
    tw = min(cols, W)
    th = min(rows * 2, H)
    yi = np.linspace(0, H - 1, th).astype(int)
    xi = np.linspace(0, W - 1, tw).astype(int)
    small = (np.clip(img[yi][:, xi], 0.0, 1.0) * 255).astype(np.uint8)
    if th % 2:
        small = small[:-1]
    top = small[0::2]
    bot = small[1::2]
    lines = []
    for r in range(top.shape[0]):
        parts = []
        prev_fg = prev_bg = None
        for c in range(tw):
            fg = tuple(int(v) for v in top[r, c])
            bg = tuple(int(v) for v in bot[r, c])
            seq = ""
            if fg != prev_fg:
                seq += f"{ESC}[38;2;{fg[0]};{fg[1]};{fg[2]}m"
                prev_fg = fg
            if bg != prev_bg:
                seq += f"{ESC}[48;2;{bg[0]};{bg[1]};{bg[2]}m"
                prev_bg = bg
            parts.append(seq + "▀")
        lines.append("".join(parts) + f"{ESC}[0m")
    return "\n".join(lines)


class _RawTTY:
    """Raw-mode stdin context; no-op when stdin is not a tty."""

    def __enter__(self):
        self.enabled = sys.stdin.isatty()
        if self.enabled:
            import termios
            import tty

            self.fd = sys.stdin.fileno()
            self.saved = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import termios

            termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def pending_keys(self) -> str:
        if not self.enabled:
            return ""
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            keys.append(sys.stdin.read(1))
        return "".join(keys)


def run_interactive(sim, max_frames: Optional[int] = None,
                    out=sys.stdout) -> int:
    """Drive a viewer.simulation.Simulation interactively in the terminal.

    Returns the number of frames displayed.  ``max_frames`` bounds the loop
    for scripted/test runs; interactive sessions quit on 'x' or Ctrl-C.
    """
    frames = 0
    mouse = MouseParser()
    out.write(f"{ESC}[2J")  # clear once
    try:
        with _RawTTY() as tty_in:
            if tty_in.enabled:
                out.write(MOUSE_ON)
            while max_frames is None or frames < max_frames:
                keys, moves = mouse.parse(tty_in.pending_keys())
                if "x" in keys or "\x03" in keys:
                    break
                if keys:
                    sim.handle_keys(keys)
                for du, dv in moves:
                    sim.mouse_look(du, dv)
                img = sim.step(frames)
                out.write(f"{ESC}[H" + frame_to_ansi(img))
                out.write(f"\n{ESC}[0m{sim.fps:5.1f} fps | wasdqe move, "
                          f"jl/ik/uo look, drag look, nm/,. 4D, x quit\n")
                out.flush()
                frames += 1
    except KeyboardInterrupt:
        pass
    finally:
        if sys.stdin.isatty():
            out.write(MOUSE_OFF)
        out.write(f"{ESC}[0m\n")
        out.flush()
    return frames


def save_ansi(img: np.ndarray, path: str, cols: int = 120,
              rows: int = 40) -> None:
    """Write a one-frame ANSI snapshot (cat-able preview artifact)."""
    with open(path, "w") as f:
        f.write(frame_to_ansi(img, cols, rows) + f"{ESC}[0m\n")
