"""The march-bisect probe P1: the march and its backward (K4) on one tile.

Port of ``tools/march_bisect.py::kernel``, which the JAX package uses to run
its march custom VJP (``ops/pallas_vjp.py::make_march_ckpt``) stage by
stage on one (8, 128) tile of rays in config5's warp material: config5 at
``max_depth`` 1 and ``march_steps`` 23, material 1 (the warp) on every
lane, step 0.06 (the material's), scene time 0.25.  Each stage returns the
tool's output tile:

- ``fwd``: ``p.x + dvec.y + u + v + n.z`` of the march's end (the crossing
  point, the direction of the crossing step, the hit leaf's unoriented
  normal and UV; the origin and the initial direction where no boundary
  was crossed);
- ``vjp`` and ``finish``: ``val + d org.x + sum(d shape_vec)`` with ``val``
  as ``fwd`` and the VJP under cotangent 1 on every lane; the sum is over
  the whole tile and is added to every lane;
- ``loop``: the same with ``val = dvec.y``: the cotangent reaches only the
  direction.

``march_probe_plain`` is the plain version: autograd through the port's
march (``ops/march.py``: ``march_init``, ``make_march_body``,
``march_finish``; ``ops/trace.py``: ``warp_mask``, ``make_accel``).
``csrc/probe_march.cu`` is the kernel: one thread-block cluster, a lane a
thread, whose tile-wide sum ``tile_sum`` spells out.  It runs the device
code of the render and its backward (trace_common.cuh ``march``, ``surface_at``;
trace_adj.cuh ``march_replay``, ``march_reverse`` and its step adjoint,
``surface_uv_adj``, ``leaf_normal_adj``):
``vjp`` and ``loop`` rebuild the steps backwards as K4 does, ``finish``
walks a stored tape of every step's state back with the same step
adjoint.  ``march_probe`` runs the kernel on CUDA tables and the plain
version on CPU tables.

Two tiles: ``tool_tile``, the tool's (origins at 0.001 x the lane's column
and row, direction (0.1, -0.05, -1): no lane reaches a boundary within
23 x 0.06 units), and ``crossing_tile``, seeded origins 1.25-1.55 units
from the warp sphere's centre and seeded unit directions, so that the
bisection and its adjoint run on a share of the lanes.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from . import march as M
from . import trace as T
from . import vec as V

STAGES = ("fwd", "vjp", "finish", "loop")
TH, TW = 8, 128
SCENE = "config5_warp_portal"
MAX_DEPTH = 1
MARCH_STEPS = 23
WARP_MAT = 1         # config5's warp material
TIME = 0.25
TAPE_STEPS = 32      # csrc/probe_march.cu: the finish stage's tape
THREADS = 128        # csrc/probe_march.cu: lanes a block of the cluster
MAX_LANES = 1024     # lanes a launch: a cluster of 8 blocks
WARP_CENTRE = (0.0, 0.2, -5.0)   # config5's warp sphere
CROSS_R = (1.25, 1.55)           # the crossing tile's origin radii
CROSS_SEED = 11
RTOL = 1e-5          # kernel vs plain, of max(max |ref|, 1): every lane
MAX_FLIPPED = 0.01   # whose march agrees; the share that may differ

LAUNCHES = 0         # launches of probe_march made by march_probe_cuda


class ProbeOut(NamedTuple):
    """A stage's output tile, and each lane's march: the steps it walked
    and the entity it crossed (-1: none); dsv the tile's sum(d shape_vec)
    (0 for fwd)."""

    out: torch.Tensor
    steps: torch.Tensor
    ent: torch.Tensor
    dsv: torch.Tensor


def probe_scene(device="cpu"):
    """The tool's scene: config5 at max_depth 1 and 23 march steps ->
    (static, tables on device)."""
    from ..scene.compile import compile_scene, tables_to_torch
    from ..scene.library import get_scene
    sc = get_scene(SCENE)
    sc = replace(sc, settings=replace(sc.settings, max_depth=MAX_DEPTH,
                                      march_steps=MARCH_STEPS))
    static, tables = compile_scene(sc)
    assert static.mat_kinds[WARP_MAT] == "warp", static.mat_kinds
    return static, tables_to_torch(tables, device)


def tool_tile(device="cpu"):
    """tools/march_bisect.py's tile -> (org, d), [TH, TW, 4] float32:
    org = (0.001 column, 0.001 row, 0, 0) as the tool rounds it (iota x
    0.01 x 0.1 in float32), d = (0.1, -0.05, -1, 0)."""
    yi = np.arange(TH, dtype=np.float32)[:, None] * np.float32(0.01)
    xi = np.arange(TW, dtype=np.float32)[None, :] * np.float32(0.01)
    org = np.zeros((TH, TW, 4), np.float32)
    org[..., 0] = xi * np.float32(0.1)
    org[..., 1] = yi * np.float32(0.1)
    d = np.broadcast_to(np.asarray((0.1, -0.05, -1.0, 0.0), np.float32),
                        (TH, TW, 4)).copy()
    return torch.from_numpy(org).to(device), torch.from_numpy(d).to(device)


def crossing_tile(device="cpu", seed=CROSS_SEED):
    """A tile whose rays cross: origins at the warp sphere's centre plus a
    seeded unit vector times a radius uniform in CROSS_R, seeded unit
    directions (normalised normal draws) -> (org, d), [TH, TW, 4]."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(TH, TW, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = rng.uniform(*CROSS_R, size=(TH, TW, 1))
    d = rng.normal(size=(TH, TW, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    org = np.zeros((TH, TW, 4), np.float32)
    org[..., :3] = np.asarray(WARP_CENTRE) + u * r
    d4 = np.zeros((TH, TW, 4), np.float32)
    d4[..., :3] = d
    return torch.from_numpy(org).to(device), torch.from_numpy(d4).to(device)


def compare(ref: ProbeOut, got: ProbeOut) -> dict:
    """A stage against another's (the kernel's against the plain
    version's): the largest difference over the lanes whose march agrees
    (same steps, same entity), its limit RTOL * max(max |ref|, 1), the
    lanes whose march differs ("flipped"; at most MAX_FLIPPED of the tile
    passes), the share of lanes that cross, and both tiles' sum(d
    shape_vec)."""
    same = (ref.steps == got.steps) & (ref.ent == got.ent)
    err = (ref.out - got.out).abs()[same]
    return {"max_err": float(err.max()) if err.numel() else 0.0,
            "limit": RTOL * max(float(ref.out.abs().max()), 1.0),
            "flipped": int((~same).sum()),
            "crossed": float((got.ent >= 0).float().mean()),
            "dsv": float(got.dsv), "plain_dsv": float(ref.dsv)}


def passes(res: dict, lanes: int) -> bool:
    """compare's result within its limits."""
    return (res["max_err"] <= res["limit"]
            and res["flipped"] <= MAX_FLIPPED * lanes)


def tile_sum(parts, threads: int = THREADS) -> torch.Tensor:
    """The tile's sum(d shape_vec) from its lanes' parts [n], in the
    kernel's fixed order for blocks of ``threads`` lanes (lane i in block
    i // threads): each warp's 32 lanes as __shfl_down_sync's tree sums
    them (offsets 16, 8, 4, 2, 1; lane 0's value), each block's warps in
    order from 0, then the blocks in order from 0 -> 0-dim float32, on
    the CPU."""
    p = parts.detach().reshape(-1).to("cpu", torch.float32)
    blocks = -(-p.numel() // threads)
    v = torch.cat([p, p.new_zeros(blocks * threads - p.numel())])
    v = v.reshape(blocks, threads // 32, 32)
    for o in (16, 8, 4, 2, 1):
        v = torch.cat([v[..., :32 - o] + v[..., o:], v[..., 32 - o:]], -1)
    total = torch.zeros((), dtype=torch.float32)
    for b in range(blocks):
        block = torch.zeros((), dtype=torch.float32)
        for w in range(threads // 32):
            block = block + v[b, w, 0]
        total = total + block
    return total


def march_probe_plain(static, tables, org, d, stage: str) -> ProbeOut:
    """The stage by autograd through the plain march -> ProbeOut."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} is not one of {STAGES}")
    shape = org.shape[:-1]
    mat = torch.full(shape, WARP_MAT, dtype=torch.int64, device=org.device)
    with torch.enable_grad():
        sv = tables.shape_vec.detach().requires_grad_(True)
        tbl = tables._replace(shape_vec=sv)
        o = V.from_array(org)
        ox = o.x.detach().requires_grad_(True)
        o = V.Vec(ox, o.y, o.z, o.w)
        dv = V.from_array(d)
        wm = T.warp_mask(static, mat)
        h = T.warp_step(static, tbl, mat)
        carry = M.march_init(static, tbl, o, dv, wm)
        body = M.make_march_body(static, tbl,
                                 T.make_accel(static, tbl, mat, TIME), h)
        for _ in range(static.march_steps):
            carry = body(carry)
        hit, p, dvec, ent, n, u, v = M.march_finish(static, tbl, o, carry)
        if stage == "loop":
            val = p.x * 0.0 + dvec.y     # the cotangent reaches dvec only
        else:
            val = p.x + dvec.y + u + v + n.z
        steps = torch.round(carry[8] / h).to(torch.int32)
        ent = torch.where(hit, ent, -1).to(torch.int32)
        if stage == "fwd":
            return ProbeOut(val.detach(), steps, ent,
                            torch.zeros((), device=org.device))
        # the loop stage's val does not depend on shape_vec at all: the
        # sides that pick the crossing step are discrete
        dsv, dox = torch.autograd.grad(val, (sv, ox), torch.ones_like(val),
                                       allow_unused=True,
                                       materialize_grads=True)
    dsv = dsv.sum()
    return ProbeOut((val + dox + dsv).detach(), steps, ent, dsv)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """euclider_probe_march of library ``name`` (cuda_kernel.library: a
    marching scene of more entities than the default build's takes a
    wider one), built and loaded once."""
    from . import cuda_kernel as CK
    fn = ctypes.CDLL(CK.build((name,))[name]).euclider_probe_march
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, ctypes.c_float, p, i, i, p, p, i, p, p, p, p, p,
                   i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _empty_entry():
    from . import cuda_kernel as CK
    fn = ctypes.CDLL(CK.build(("probe_march",))["probe_march"]
                     ).euclider_probe_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def empty_cuda(device) -> None:
    """One launch of csrc/probe_march.cu's empty kernel (one warp) on
    the CUDA device: the floor of any one-tile launch, timed beside P1."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"empty_cuda takes a CUDA device, got {device}")
    rc = _empty_entry()(device.index or 0,
                        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_empty launch failed: cudaError {rc}")


def march_probe_cuda(static, tables, org, d, stage: str,
                     check=None) -> ProbeOut:
    """The stage through csrc/probe_march.cu -> ProbeOut; CUDA tensors
    only, at most MAX_LANES lanes (one cluster).  ``check``, a CUDA float32
    tensor of 2 n elements or None: the kernel writes each lane's share of
    sum(d shape_vec) into its first n and the tile's sum each lane added
    into its last n.  Raises ValueError, before any launch, for a scene
    that does not take the kernel's build (the march and the attractor
    field: no expression material, no CSG, cylinder, perlin or texture)
    or marches more than TAPE_STEPS steps."""
    global LAUNCHES
    from . import cuda_kernel as CK
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} is not one of {STAGES}")
    device = tables.surf_color.device
    if device.type != "cuda" or org.device != device or d.device != device:
        raise ValueError("march_probe_cuda takes CUDA tensors, got tables "
                         f"on {device}, rays on {org.device} and {d.device}")
    if (not CK.marches(static) or CK.has_expr(static)
            or CK.has_shapes(static)
            or static.mat_kinds[WARP_MAT] != "warp"):
        raise ValueError("probe_march takes a scene whose material "
                         f"{WARP_MAT} is an attractor, without expressions "
                         "or shapes beyond spheres and planes")
    if static.march_steps > TAPE_STEPS:
        raise ValueError(f"{static.march_steps} march steps; probe_march's "
                         f"tape holds {TAPE_STEPS}")
    if org.shape != d.shape or org.shape[-1] != 4:
        raise ValueError(f"rays of shapes {tuple(org.shape)} and "
                         f"{tuple(d.shape)}; expected [..., 4] each")
    floats = CK._check_tables(static, tables, device)
    iptr, fptr, params, _ints = CK.scene_args(static, floats, device,
                                              CK.tex_shapes(tables))
    cam = torch.zeros(24, dtype=torch.float32, device=device)
    cam[17] = TIME
    org = org.detach().to(torch.float32).contiguous()
    d = d.detach().to(torch.float32).contiguous()
    shape = org.shape[:-1]
    n = org.numel() // 4
    if not 1 <= n <= MAX_LANES:
        raise ValueError(f"{n} lanes; probe_march takes 1 to {MAX_LANES}")
    if check is not None and (check.device != device
                              or check.dtype != torch.float32
                              or not check.is_contiguous()
                              or check.numel() != 2 * n):
        raise ValueError(f"check must be a contiguous float32 tensor of "
                         f"{2 * n} elements on {device}")
    out = torch.empty(shape, dtype=torch.float32, device=device)
    steps = torch.empty(shape, dtype=torch.int32, device=device)
    ent = torch.empty(shape, dtype=torch.int32, device=device)
    dsv = torch.empty((), dtype=torch.float32, device=device)
    rc = _entry(CK.library("probe_march", static))(
        iptr, fptr, params, static.t_max, cam.data_ptr(),
        STAGES.index(stage), WARP_MAT, org.data_ptr(), d.data_ptr(), n,
        out.data_ptr(), steps.data_ptr(), ent.data_ptr(), dsv.data_ptr(),
        None if check is None else check.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_march launch failed: cudaError {rc}")
    LAUNCHES += 1
    return ProbeOut(out, steps, ent, dsv)


def march_probe(static, tables, org, d, stage: str) -> ProbeOut:
    """The stage: the kernel for CUDA tables, the plain version for CPU
    ones."""
    if tables.surf_color.device.type == "cuda":
        return march_probe_cuda(static, tables, org, d, stage)
    return march_probe_plain(static, tables, org, d, stage)
