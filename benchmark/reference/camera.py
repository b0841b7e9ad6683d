"""The orbit of the viewer cells' camera.

Frozen copy of ``look_at`` and ``orbit`` of
``euclider_tpu_torch/models/camera.py`` at commit ee5cc13d71e7, on the
reference's own ``CameraParams``.  Never edited to follow the program."""
from __future__ import annotations

import numpy as np

from .scene.compile import CameraParams


def look_at(position, target, up=(0.0, 1.0, 0.0, 0.0),
            fov_deg: float = 60.0) -> CameraParams:
    pos = np.zeros(4)
    pos[:len(position)] = position
    tgt = np.zeros(4)
    tgt[:len(target)] = target
    upv = np.zeros(4)
    upv[:len(up)] = up
    f = tgt - pos
    f /= np.linalg.norm(f)
    r = upv - np.dot(upv, f) * f
    # right = orthonormal to f and up, in their 3-space
    u = r / max(np.linalg.norm(r), 1e-20)
    # build right via Gram-Schmidt from a non-parallel axis
    for cand in np.eye(4):
        rr = cand - np.dot(cand, f) * f - np.dot(cand, u) * u
        n = np.linalg.norm(rr)
        if n > 1e-6:
            r = rr / n
            break
    t = np.tan(np.deg2rad(fov_deg) * 0.5)
    # ensure right-handedness in 3D: right x up ~ forward
    if abs(f[3]) < 1e-12 and abs(u[3]) < 1e-12 and abs(r[3]) < 1e-12:
        cr = np.cross(f[:3], u[:3])
        r = np.concatenate([cr / np.linalg.norm(cr), [0.0]]) * -1.0
        r = -r
    return CameraParams(pos.astype(np.float32), f.astype(np.float32),
                        u.astype(np.float32), r.astype(np.float32),
                        np.float32(t))


def orbit(cam: CameraParams, center, angle: float) -> CameraParams:
    """Orbit the camera around a center in the world xz-plane, re-aiming."""
    pos = np.asarray(cam.position, np.float64)
    up = np.asarray(cam.up, np.float64)
    c = np.zeros(4)
    c[:len(center)] = center
    rel = pos - c
    rot = rel.copy()
    ca, sa = np.cos(angle), np.sin(angle)
    rot[0] = ca * rel[0] + sa * rel[2]
    rot[2] = -sa * rel[0] + ca * rel[2]
    new_pos = c + rot
    return look_at(new_pos, c, up=tuple(up),
                   fov_deg=float(np.rad2deg(
                       2 * np.arctan(float(cam.tan_half_fov)))))
