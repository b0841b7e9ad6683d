"""Faults planted in the program, for the check's own tests and for the
readings that set its limits: each breaks the timed path underneath the
harness, which runs on unchanged and has to come out not correct.

    with faults.planted("half", "view"):
        record = loops.view.run(cell)      # record.correct is False

The viewer (``view`` cells): ``stale``, a step that returns the frame
before the one it owes; ``half``, half of the frame's rows never
rendered; ``altered``, eight rows of the frame altered where it is
produced; ``one_buffer``, those eight rows altered in every second frame
only, the frames that pass through one of the viewer's two pinned
buffers.  One card, so no exchange between cards to leave out."""
from __future__ import annotations

import contextlib

VIEW = ("stale", "half", "altered", "one_buffer")


def _view(name, stack):
    import numpy as np
    from euclider_tpu_torch.viewer.simulation import Simulation

    if name == "stale":
        step = Simulation.step

        def stale(self, frame_idx=0):
            img = np.array(step(self, frame_idx))
            before = getattr(self, "_stale", img)
            self._stale = img
            return before
        stack.enter_context(_patch(Simulation, "step", stale))
        return
    if name not in VIEW:
        raise ValueError(f"no view fault {name!r}: one of {VIEW}")
    make = Simulation._make_render

    def broken(self):
        render = make(self)
        made = [0]

        def wrong(cam, t):
            frame = render(cam, t)
            h = frame.shape[0]
            made[0] += 1
            if name == "half":
                frame[h // 2:] = 0.0
            elif name == "altered" or made[0] % 2:
                frame[h // 2:h // 2 + 8] += 0.25
            return frame
        return wrong
    stack.enter_context(_patch(Simulation, "_make_render", broken))


@contextlib.contextmanager
def _patch(owner, attr, value):
    old = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, old)


@contextlib.contextmanager
def planted(name: str, kind: str):
    """Plant fault ``name`` of a ``kind`` cell for the length of the
    block; only ``view`` cells have faults here."""
    if kind != "view":
        raise ValueError(f"no faults for {kind!r} cells")
    with contextlib.ExitStack() as stack:
        _view(name, stack)
        yield
