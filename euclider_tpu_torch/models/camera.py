"""Free-flight camera model: functional pose updates, 3D + 4D.

Reference parity: euclider's d3/d4 cameras (SURVEY.md §2.1 'Cameras') —
mouse-look yaw/pitch, WASD translation in the camera frame, and the 4D
camera's extra rotation controls.  In 4D a 'rotation' is a rotation in the
plane spanned by two frame vectors; yaw = rotate(forward, right),
pitch = rotate(forward, up), and the extra 4D controls rotate frame vectors
with the hidden w-axis direction.

All updates are pure functions CameraParams -> CameraParams (numpy, host
side) — the render path re-orthonormalises the frame, so drift is benign.

A copy of ``euclider_tpu/models/camera.py`` on this package's own
``scene.compile.CameraParams`` (importing the JAX package's module would
import jax); ``tests/test_torch_viewer.py`` holds the two equal to the bit.
"""
from __future__ import annotations

import numpy as np

from ..scene.compile import CameraParams


def _np(cam: CameraParams):
    return (np.asarray(cam.position, np.float64),
            np.asarray(cam.forward, np.float64),
            np.asarray(cam.up, np.float64),
            np.asarray(cam.right, np.float64))


def _mk(cam, pos, fwd, up, right) -> CameraParams:
    return CameraParams(pos.astype(np.float32), fwd.astype(np.float32),
                        up.astype(np.float32), right.astype(np.float32),
                        cam.tan_half_fov)


def _wdir(fwd, up, right):
    """The frame's hidden fourth direction (Gram-Schmidt residual of e_w)."""
    basis = [fwd / np.linalg.norm(fwd)]
    for v in (right, up):
        u = v - sum(np.dot(v, b) * b for b in basis)
        basis.append(u / max(np.linalg.norm(u), 1e-20))
    cand = np.array([0.0, 0.0, 0.0, 1.0])
    u = cand - sum(np.dot(cand, b) * b for b in basis)
    n = np.linalg.norm(u)
    if n < 1e-9:  # frame already spans e_w strangely; fall back to e_z
        cand = np.array([0.0, 0.0, 1.0, 0.0])
        u = cand - sum(np.dot(cand, b) * b for b in basis)
        n = np.linalg.norm(u)
    return u / max(n, 1e-20)


def _rot_plane(v, a, b, angle):
    """Rotate v in the plane spanned by orthonormal a, b."""
    ca = np.dot(v, a)
    cb = np.dot(v, b)
    c, s = np.cos(angle), np.sin(angle)
    return v + (ca * (c - 1) - cb * s) * a + (ca * s + cb * (c - 1)) * b


def translate(cam: CameraParams, dx=0.0, dy=0.0, dz=0.0) -> CameraParams:
    """Move in the camera frame: +dz forward, +dx right, +dy up (WASD+QE)."""
    pos, fwd, up, right = _np(cam)
    pos = pos + dz * fwd + dx * right + dy * up
    return _mk(cam, pos, fwd, up, right)


def rotate(cam: CameraParams, yaw=0.0, pitch=0.0, roll=0.0,
           w_yaw=0.0, w_pitch=0.0) -> CameraParams:
    """Mouse-look + 4D extra rotations.

    yaw: forward<->right; pitch: forward<->up; roll: right<->up;
    w_yaw: forward<->w; w_pitch: up<->w (no-ops for 3D scenes where every
    basis vector has w=0 and angles are 0).
    """
    pos, fwd, up, right = _np(cam)
    f = fwd / np.linalg.norm(fwd)
    r = right - np.dot(right, f) * f
    r /= max(np.linalg.norm(r), 1e-20)
    u = up - np.dot(up, f) * f - np.dot(up, r) * r
    u /= max(np.linalg.norm(u), 1e-20)

    for a, b, ang in ((f, r, yaw), (f, u, pitch), (r, u, roll)):
        if ang:
            na = _rot_plane(a, a, b, ang)
            nb = _rot_plane(b, a, b, ang)
            a[:], b[:] = na, nb
    if w_yaw or w_pitch:
        w = _wdir(f, u, r)
        if w_yaw:
            nf = _rot_plane(f, f, w, w_yaw)
            w = _rot_plane(w, f, w, w_yaw)
            f = nf
        if w_pitch:
            nu = _rot_plane(u, u, w, w_pitch)
            u = nu
    return _mk(cam, pos, f, u, r)


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
    pos, fwd, up, right = _np(cam)
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
