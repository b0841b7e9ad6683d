"""The simulation / interaction loop (reference: Simulation::start,
``src/simulation.rs``; SURVEY.md §3.2), on the card.

The reference's per-frame loop is: poll events -> camera.update -> render ->
blit to an SDL2 window.  Here frames render on the card (``backend="cuda"``:
the forward kernel ``csrc/trace_fwd.cu``; ``"torch"``: the plain version,
on ``device``, the CPU in the tests) and **reach the host double-buffered**:
frame i's render runs while frame i - 1 is copied into one of two pinned
host buffers on a copy stream of its own, ordered after that frame's render
by an event, so ``step`` returns frame i - 1 without waiting for frame i.
Nothing on the way synchronises the device: the camera goes up through a
pinned buffer too, and the host waits only on the copy event of the frame
it returns.  Display sinks are pluggable; the headless default writes PNGs.
Input comes from a key-event callback (an interactive terminal or GUI can
feed the same Simulation object).

Controls mirror euclider: WASD+QE translation, mouse-look yaw/pitch, and
the 4D extra rotations (w_yaw / w_pitch) for 4D scenes.

Port of ``euclider_tpu/viewer/simulation.py`` with the same semantics
(``handle_keys``, ``mouse_look``, ``step``, ``flush``, ``run``, ``fps``,
``time`` / ``time_step`` and ``render_orbit``); its ``np.asarray`` of the
previous frame's device array becomes the pinned buffers.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models import camera as camctl
from ..scene.compile import (CameraParams, camera_to_torch, compile_camera,
                             compile_scene, tables_to_torch)

KEY_STEP = 0.25
LOOK_STEP = 0.05
BACKENDS = ("cuda", "torch")


class Simulation:
    """Per-frame loop driving camera + renderer + double-buffered host
    gather.

    On a CUDA device the array ``step`` returns is one of the two pinned
    host buffers: it holds its frame until the next call of ``step``
    (copy it to keep it); ``flush`` returns a copy."""

    def __init__(self, scene, H: int = 360, W: int = 640,
                 backend: str = "cuda", device="cuda",
                 on_frame: Optional[Callable[[np.ndarray, int], None]] = None):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        self.device = torch.device(device)
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError("the cuda backend renders on a CUDA device, got "
                             f"{self.device}")
        self.scene = scene
        self.static, tables = compile_scene(scene)
        self.tables = tables_to_torch(tables, self.device)
        self.cam = compile_camera(scene.camera)   # numpy, host side
        self.H, self.W = H, W
        self.backend = backend
        self.on_frame = on_frame
        self.frame_times: List[float] = []
        self.time = 0.0          # scene time handed to the renderer
        self.time_step = 0.0     # per-frame increment (animated materials)
        self._render = self._make_render()
        self._pending = None     # the frame in flight: (buffer, copy event)
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._host = [torch.empty((H, W, 3), dtype=torch.float32,
                                      pin_memory=True) for _ in range(2)]
            self._slot = 0

    def _make_render(self):
        if self.backend == "cuda":
            from ..ops.cuda_kernel import render_image_cuda as render
        else:
            from ..ops.trace import render_image as render
        return lambda cam, t: render(self.static, self.tables, cam, self.H,
                                     self.W, t)

    def _device_camera(self, cam: CameraParams) -> CameraParams:
        """The numpy camera on the device; on a CUDA device through a
        pinned buffer, without synchronising."""
        if self.device.type != "cuda":
            return camera_to_torch(cam, self.device)
        row = torch.from_numpy(np.concatenate(
            [np.asarray(v, np.float32).reshape(-1) for v in cam])
        ).pin_memory().to(self.device, non_blocking=True)
        return CameraParams(row[0:4], row[4:8], row[8:12], row[12:16],
                            row[16])

    def _gather(self, frame: torch.Tensor):
        """Start frame's way to the host -> what ``_wait`` takes.  On a CUDA
        device: a copy into the next pinned buffer on the copy stream,
        after the render (an event on the current stream)."""
        if self.device.type != "cuda":
            return frame, None
        host = self._host[self._slot]
        self._slot ^= 1
        rendered = torch.cuda.Event()
        rendered.record(torch.cuda.current_stream(self.device))
        self._copy_stream.wait_event(rendered)
        with torch.cuda.stream(self._copy_stream):
            host.copy_(frame, non_blocking=True)
        frame.record_stream(self._copy_stream)
        copied = torch.cuda.Event()
        copied.record(self._copy_stream)
        return host, copied

    @staticmethod
    def _wait(pending) -> np.ndarray:
        frame, copied = pending
        if copied is not None:
            copied.synchronize()
        return frame.numpy()

    # -- input handling (the camera.update of the reference) ----------------
    def handle_keys(self, keys: str) -> None:
        """Apply a batch of key presses: 'w a s d q e' move, 'jl' yaw,
        'ik' pitch, 'uo' roll, 'nm' w-yaw, ',.' w-pitch."""
        dx = dy = dz = 0.0
        yaw = pitch = roll = w_yaw = w_pitch = 0.0
        for k in keys:
            if k == "w":
                dz += KEY_STEP
            elif k == "s":
                dz -= KEY_STEP
            elif k == "a":
                dx -= KEY_STEP
            elif k == "d":
                dx += KEY_STEP
            elif k == "q":
                dy -= KEY_STEP
            elif k == "e":
                dy += KEY_STEP
            elif k == "j":
                yaw -= LOOK_STEP
            elif k == "l":
                yaw += LOOK_STEP
            elif k == "i":
                pitch += LOOK_STEP
            elif k == "k":
                pitch -= LOOK_STEP
            elif k == "u":
                roll -= LOOK_STEP
            elif k == "o":
                roll += LOOK_STEP
            elif k == "n":
                w_yaw -= LOOK_STEP
            elif k == "m":
                w_yaw += LOOK_STEP
            elif k == ",":
                w_pitch -= LOOK_STEP
            elif k == ".":
                w_pitch += LOOK_STEP
        if dx or dy or dz:
            self.cam = camctl.translate(self.cam, dx, dy, dz)
        if yaw or pitch or roll or w_yaw or w_pitch:
            self.cam = camctl.rotate(self.cam, yaw, pitch, roll,
                                     w_yaw, w_pitch)

    def mouse_look(self, du: float, dv: float) -> None:
        self.cam = camctl.rotate(self.cam, yaw=du * LOOK_STEP,
                                 pitch=-dv * LOOK_STEP)

    # -- frame loop ---------------------------------------------------------
    def step(self, frame_idx: int = 0) -> np.ndarray:
        """Dispatch frame i and return frame i - 1 (frame 0 on the first
        call): double-buffered host gather."""
        t0 = time.perf_counter()
        frame = self._render(self._device_camera(self.cam), self.time)
        self.time += self.time_step
        prev = self._pending
        self._pending = self._gather(frame)
        img = self._wait(prev if prev is not None else self._pending)
        self.frame_times.append(time.perf_counter() - t0)
        if self.on_frame is not None:
            self.on_frame(img, frame_idx)
        return img

    def flush(self) -> np.ndarray:
        """Gather the last in-flight frame (a copy of its buffer)."""
        if self._pending is None:
            raise RuntimeError("no frame in flight")
        img = np.array(self._wait(self._pending))
        self._pending = None
        return img

    def run(self, n_frames: int,
            script: Optional[Callable[["Simulation", int], None]] = None):
        """Run the loop n_frames times; `script` plays the role of the event
        poll (it may call handle_keys / mouse_look)."""
        for i in range(n_frames):
            if script is not None:
                script(self, i)
            self.step(i)
        return self.flush()

    @property
    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return 1.0 / (sum(self.frame_times) / len(self.frame_times))


def render_orbit(scene, H, W, n_frames: int, out_pattern: str,
                 backend: str = "cuda", radius: Optional[float] = None,
                 device="cuda"):
    """Offline orbit animation -> PNG sequence (out.png -> out_0000.png...).

    As the reference's: the camera orbits its first sphere (else (0, 0, -4))
    by 2 pi / n_frames a frame, keeping its distance (``radius`` is
    accepted and unused there too), and PNG i holds what ``step(i)``
    returns, frame i - 1 (frame 0 for the first two)."""
    from ..cli import save_png
    from ..scene import ir

    base = out_pattern[:-4] if out_pattern.endswith(".png") else out_pattern
    center = (0.0, 0.0, -4.0)
    for e in scene.entities:
        if isinstance(e.shape, ir.Sphere):
            center = e.shape.center[:3]
            break

    paths = []
    sim = Simulation(scene, H, W, backend, device)
    for i in range(n_frames):
        sim.cam = camctl.orbit(sim.cam, center, 2 * np.pi / n_frames * (i > 0))
        img = sim.step(i)
        p = f"{base}_{i:04d}.png"
        save_png(img, p)
        paths.append(p)
    return paths
