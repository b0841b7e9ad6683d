"""The forward render as a hand-written CUDA kernel (``csrc/trace_fwd.cu``),
and the build of every CUDA source of the package.

Counterpart of ``euclider_tpu/ops/pallas_kernel.py`` (``_kernel`` launched
by ``render_image_pallas``).  Each source is compiled with nvcc for
``sm_90a`` into a shared library with a plain C entry point, on first use,
into ``euclider_tpu_torch/build/`` (rebuilt when the source, the shared
headers or the flags change), and called through ctypes on PyTorch's
current stream.  Every library is compiled without FMA contraction
(``-fmad=false``): each operation rounds as the plain version's separate
torch operations do (trace_common.cuh).  The trace kernels (the forward,
the tape backward and the segmented backward) are compiled twice: their
``_shapes`` libraries hold the builds for scenes with CSG, cylinders,
perlin or textures.

Five capacities of the kernels are compile-time parameters of each build
(trace_common.cuh): the DFS stack's slots, the shape nodes of one entity,
the VM instructions of one expression material, the entities of a
marching scene and the backward's march checkpoints.  A scene within
today's values takes the default build; a scene past one takes, built at
first use, the build whose capacity is the next power of two that holds
it (``capacities``; its library name lists the capacities it raises), so
that a handful of builds serves every size and the default builds stay
as they were.

The scene is passed as data: ``encode_scene`` flattens the static topology
into int32 arrays (the node encoding of ``oracle/native_oracle.py``, shape
trees in post-order, so the kernel and the C++ oracle read one scene
encoding, and the expression materials' programs of ``scene/expr.py`` with
the operand index of every instruction, for the kernels' VM), and the float
tables go in as the device tensors of ``tables_to_torch``, the textures'
texels back to back in one buffer.  Tables, textures and the camera of
any floating dtype are cast to float32 copies on the tables' device, as
the Pallas kernel casts them (``pallas_kernel._table_views``,
``_pack_camera``), and the kernels compute in float32.  Only textures of
2^31 floats or more together (the kernels index the texel buffer with
int32) raise ``ValueError`` before any launch, and a launch the card has
not the memory for ``MemoryError``; nothing is approximated or cut.  Its
plain version is ``ops/trace.render_image``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from ..oracle.native_oracle import SURF_KINDS, _encode_exprs, _encode_nodes
from ..scene import expr as E

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = {"trace_fwd": os.path.join(CSRC, "trace_fwd.cu"),
           "trace_bwd": os.path.join(CSRC, "trace_bwd.cu"),
           "trace_seg": os.path.join(CSRC, "trace_seg.cu"),
           "probe_rev": os.path.join(CSRC, "probe_rev.cu"),
           "probe_mosaic": os.path.join(CSRC, "probe_mosaic.cu"),
           "probe_march": os.path.join(CSRC, "probe_march.cu")}
SOURCES.update({f"{k}_shapes": SOURCES[k] for k in ("trace_fwd", "trace_bwd",
                                                     "trace_seg")})
HEADERS = (os.path.join(CSRC, "trace_common.cuh"),
           os.path.join(CSRC, "trace_adj.cuh"),
           os.path.join(CSRC, "probe_cluster.cuh"))
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")
# the _shapes libraries' builds (trace_common.cuh BUILD_SHAPES)
SHAPES_FLAGS = ("-DTRACE_SHAPES_BUILDS",)
# The capacities of a build (trace_common.cuh): name -> (the default
# build's, the macro that sets it).  slots: the DFS stack's (max_depth + 1
# a scene); nodes: shape nodes of one entity (membership's bits); expr: VM
# instructions of one material's four programs; entities: entities of a
# scene that marches (the side masks' bits and the side table); ckpts: the
# backward's march checkpoints, one every MARCH_CB steps.
CAPACITIES = {"slots": (16, "TRACE_MAX_SLOTS"),
              "nodes": (32, "TRACE_MAX_NODES"),
              "expr": (128, "TRACE_MAX_EXPR"),
              "entities": (32, "TRACE_MAX_MARCH_ENTITIES"),
              "ckpts": (32, "TRACE_MAX_MARCH_CK")}
# the capacities each source's code reads; its library takes only those
SOURCE_CAPACITIES = {"trace_fwd": ("slots", "nodes", "expr", "entities"),
                     "trace_bwd": tuple(CAPACITIES),
                     "trace_seg": tuple(CAPACITIES),
                     "probe_march": ("entities",)}
MARCH_CB = 16      # march steps a checkpoint (trace_common.cuh)
# how a material's rays travel (trace_common.cuh MAT_*)
MAT_MARCH = {"warp": 1, "expr": 2}

LAUNCHES = 0       # kernel launches made by render_image_cuda
PTXAS = {}         # name -> ptxas's resource lines of the build made here

# float tables the kernels read, in their argument order
FLOAT_FIELDS = ("shape_vec", "shape_sc", "mat_ior", "surf_color",
                "surf_color2", "surf_refl", "surf_fresnel", "surf_uv_scale",
                "background", "mat_warp_center", "mat_warp_strength",
                "mat_warp_step", "portal_lin", "portal_tr", "mat_expr_params")


def _source(name: str) -> str:
    """The source name of library ``name``: SOURCES' key, its capacities
    (``+nodes64`` ...) cut off."""
    return name.split("+")[0]


def capacity_flags(name: str) -> tuple:
    """The -D flags of library ``name``'s capacities: one for each
    ``+<capacity><value>`` part of its name."""
    flags = []
    for part in name.split("+")[1:]:
        cap = part.rstrip("0123456789")
        flags.append(f"-D{CAPACITIES[cap][1]}={int(part[len(cap):])}")
    return tuple(flags)


def _flags(name: str) -> tuple:
    return (NVCC_FLAGS
            + (SHAPES_FLAGS if _source(name).endswith("_shapes") else ())
            + capacity_flags(name))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _library(name: str) -> str:
    """Path of the library built from SOURCES[name].  Its name carries a
    hash of the source, the shared headers and the flags, so an edit to any
    of them builds anew and never loads a stale library."""
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in (SOURCES[_source(name)],) + HEADERS:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=tuple(SOURCES)) -> dict:
    """Compile the named libraries (SOURCES' keys, or ``library``'s names
    of wider builds) that are not built yet, one nvcc process each, all
    started together; returns {name: library path}.  Raises with nvcc's
    message when a build fails."""
    libs = {n: _library(n) for n in names}
    todo = {n: lib for n, lib in libs.items() if not os.path.exists(lib)}
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, lib in todo.items():
            tmp = f"{lib[:-3]}-tmp{os.getpid()}.so"
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *_flags(n), "-o", tmp, SOURCES[_source(n)]],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errors = []
        for n, (tmp, proc) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {SOURCES[n]}:\n{err}")
            else:
                os.replace(tmp, todo[n])
                PTXAS[n] = [line.strip() for line in err.splitlines()
                            if any(k in line for k in (
                                "entry function", "Used", "stack frame"))]
        if errors:
            raise RuntimeError("\n".join(errors))
    return libs


@functools.lru_cache(maxsize=256)
def library(kernel: str, static) -> str:
    """The library of ``kernel`` ('trace_fwd', 'trace_bwd', 'trace_seg' or
    'probe_march') that holds the build ``static`` takes: its _shapes
    library where the scene has shapes beyond spheres and planes, with
    each capacity the scene needs past the default build's
    (``capacities``) appended as ``+<capacity><value>``."""
    name = f"{kernel}_shapes" if (kernel != "probe_march"
                                  and has_shapes(static)) else kernel
    caps = dict(capacities(static))
    return name + "".join(f"+{k}{caps[k]}" for k in SOURCE_CAPACITIES[kernel]
                          if k in caps)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def needs(static) -> dict:
    """What the scene asks of each capacity (CAPACITIES): max_depth + 1
    stack slots, the shape nodes of its largest entity, the VM
    instructions of its longest expression material, and, where it
    marches, its entities and ceil(march_steps / MARCH_CB) checkpoints."""
    root = _encode_nodes(static)[0]
    exprs = [len(expr_program([E.to_postfix(a)
                               for a in static.mat_exprs[m]])[0])
             for m, kind in enumerate(static.mat_kinds) if kind == "expr"]
    march = marches(static)
    return {"slots": static.max_depth + 1,
            "nodes": int(np.diff(np.concatenate([[-1], root])).max()),
            "expr": max(exprs, default=0),
            "entities": len(static.entities) if march else 0,
            "ckpts": -(-static.march_steps // MARCH_CB) if march else 0}


@functools.lru_cache(maxsize=256)
def capacities(static) -> tuple:
    """The capacities the scene needs past the default build's, each the
    next power of two that holds it -> ((name, value), ...) in CAPACITIES
    order; () for a scene the default builds hold."""
    return tuple((k, _pow2(n)) for k, n in needs(static).items()
                 if n > CAPACITIES[k][0])


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The forward kernel's C entry point in library ``name``, built and
    loaded once per process."""
    fn = ctypes.CDLL(build((name,))[name]).euclider_trace_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p]
                   + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def expr_program(programs):
    """The kernels' VM program of one expression material's four components
    (trace_common.cuh vm_eval) from their postfix programs, four ``(ops,
    vals)`` pairs of ``scene/expr.py::to_postfix`` -> (code [L, 4] int32,
    ends): instruction i is (op, a, b, c); ``ends[k]`` is one past
    component k's last instruction, which computes its value.

    Each postfix program is replayed on a stack of instruction indices, so
    a and b are the indices of the instructions that computed an
    operation's operands (0 where it has fewer; a is the variable index of
    OP_VAR), and c is the float32 bits of OP_CONST's value or OP_POWI's
    exponent.  A subexpression that
    ``eval_ast`` computes in Python floats (constants joined by + - * and
    unary minus, and integer powers of those) is folded here in float64, as
    Python does it, and becomes one constant: the kernel then rounds it to
    float32 where the plain version does."""
    name = {v: k for k, v in E.OPS.items()}
    arity = {"neg": 1, "powi": 1, "add": 2, "sub": 2, "mul": 2, "div": 2,
             "powf": 2, "min": 2, "max": 2, "atan2": 2}
    py = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
          "mul": lambda a, b: a * b}
    code, ends = [], []

    def emit(op, a=0, b=0, c=0):
        code.append((E.OPS[op], a, b, c))
        return len(code) - 1

    def index(item):        # an operand as an instruction index
        kind, v = item
        if kind == "ins":
            return v
        return emit("const", c=int(np.asarray(v, np.float32).view(np.int32)))

    for ops, vals in programs:
        stack = []          # ("py", float) or ("ins", index)
        for op, val in zip(ops, vals):
            op = name[int(op)]
            if op == "const":
                stack.append(("py", val))
            elif op == "var":
                stack.append(("ins", emit("var", int(val))))
            elif arity.get(op, 1) == 2:
                b, a = stack.pop(), stack.pop()
                if op in py and a[0] == b[0] == "py":
                    stack.append(("py", py[op](a[1], b[1])))
                else:
                    stack.append(("ins", emit(op, index(a), index(b))))
            else:
                a = stack.pop()
                n = int(val)
                if a[0] == "py" and op == "neg":
                    stack.append(("py", -a[1]))
                elif a[0] == "py" and op == "powi" and n > 0:
                    acc = a[1]
                    for _ in range(n - 1):
                        acc = acc * a[1]
                    stack.append(("py", acc))
                else:
                    stack.append(("ins", emit(op, index(a),
                                              c=n if op == "powi" else 0)))
        top, = stack
        assert index(top) == len(code) - 1   # the root comes last
        ends.append(len(code))
    return np.asarray(code, np.int32).reshape(-1, 4), tuple(ends)


def has_shapes(static) -> bool:
    """The scene has a CSG node, a cylinder, or a perlin or texture surface:
    the kernels take a build with them (BUILD_SHAPES)."""
    return (any(e.shape[0] not in ("sphere", "halfspace", "hyperplane")
                for e in static.entities)
            or any(k in ("perlin", "texture") for k in static.surf_kinds))


def encode_scene(static):
    """Flatten ``static`` into the kernels' int32 arrays.

    Returns ``(ints, offsets)``: one int32 array holding ent_root, ent_mat,
    ent_surf, ent_portal (-1 for none), node_kind, node_row, surf_kind,
    mat_warp (MAT_MARCH: 1 for an attractor, 2 for an expression, 0 for a
    material that does not march), expr_off (the start of material m's
    component program c at 4 m + c, 4 M + 1 entries), expr_code (the
    materials' ``expr_program`` instructions, 4 ints each), node_cstart,
    node_ccount and child_idx (a composite's children), ent_first (the first
    node of each entity's post-order range, which ends at ent_root),
    and surf_aux (per surface two ints: a perlin surface's octaves and its
    seed times 974711 mod 2^32, as bits; a texture surface's texture id)
    back to back, and the start of each.  ``scene_args`` appends tex_info,
    from the tables: per texture its offset in the texel buffer, its height
    and width.  Any scene encodes: ``library`` picks the build whose
    capacities hold it."""
    ent_root, node_kind, node_row, cstart, ccount, child = _encode_nodes(
        static)
    ent_first = np.concatenate([[0], ent_root[:-1] + 1]).astype(np.int32)
    ents = static.entities
    perlin = static.surf_perlin or (None,) * len(static.surf_kinds)
    surf_aux = np.zeros((len(static.surf_kinds), 2), np.int64)
    for s, kind in enumerate(static.surf_kinds):
        if kind == "perlin":
            octaves, seed = perlin[s]
            surf_aux[s] = octaves, (seed * 974711) & 0xFFFFFFFF
        elif kind == "texture":
            surf_aux[s, 0] = static.surf_texture[s]
    surf_aux = surf_aux.astype(np.uint32).view(np.int32).reshape(-1)
    eops, evals, eoff = _encode_exprs(static)
    expr_off, expr_code = [0], []
    for m, kind in enumerate(static.mat_kinds):
        ends = (0, 0, 0, 0)
        if kind == "expr":
            spans = [slice(eoff[4 * m + c], eoff[4 * m + c + 1])
                     for c in range(4)]
            code, ends = expr_program([(eops[sp], evals[sp])
                                       for sp in spans])
            expr_code.append(code.reshape(-1))
        base = expr_off[-1]
        expr_off.extend(base + e for e in ends)
    parts = [ent_root,
             np.asarray([e.material for e in ents], np.int32),
             np.asarray([e.surface for e in ents], np.int32),
             np.asarray([-1 if e.portal is None else e.portal for e in ents],
                        np.int32),
             node_kind, node_row,
             np.asarray([SURF_KINDS[k] for k in static.surf_kinds], np.int32),
             np.asarray([MAT_MARCH.get(k, 0) for k in static.mat_kinds],
                        np.int32),
             np.asarray(expr_off, np.int32),
             np.concatenate(expr_code + [np.zeros(0, np.int32)]),
             cstart, ccount, child, ent_first, surf_aux]
    offsets = np.cumsum([0] + [len(p) for p in parts[:-1]])
    return np.concatenate(parts).astype(np.int32), tuple(int(o) for o in offsets)


@functools.lru_cache(maxsize=64)
def _scene_ints(static, tex_shapes, device: torch.device):
    """encode_scene's arrays and tex_info on the device: one int32 tensor,
    and the start of each array."""
    ints, offsets = encode_scene(static)
    info, off = [], 0
    for th, tw, _ in tex_shapes:
        info.extend((off, th, tw))
        off += th * tw * 3
    tex_info = np.asarray(info or [0, 1, 1], np.int32)
    offsets = offsets + (len(ints),)
    return torch.from_numpy(np.concatenate([ints, tex_info])).to(device), \
        offsets


def has_expr(static) -> bool:
    """A material is an expression: the kernels take their VM build."""
    return "expr" in static.mat_kinds


def marches(static) -> bool:
    """A material marches or an entity is a portal: the kernels take a
    build with the march and the teleport, else the straight one."""
    return static.has_warp or static.has_portal


def scene_args(static, floats, device, tex_shapes):
    """The kernels' scene arguments (trace_common.cuh make_scene): host
    arrays of the int32 arrays' and the float tables' device pointers (the
    texel buffer last, ``tex_shapes`` the textures' shapes), the int
    parameters, and the device int32 tensor they point into (keep it alive
    across the launch).  march_steps goes in as 0 when no material marches
    and no entity is a portal: the kernels then run their build without the
    march and the teleport; the next parameters are 1 when a material is an
    expression, for the build with the VM, and when the scene has CSG,
    cylinders, perlin or textures, for the build with them."""
    ints, offsets = _scene_ints(static, tuple(tex_shapes), device)
    iptr = (ctypes.c_void_p * len(offsets))(
        *(ints.data_ptr() + 4 * o for o in offsets))
    fptr = (ctypes.c_void_p * len(floats))(*(t.data_ptr() for t in floats))
    params = (ctypes.c_int * 8)(len(static.entities), static.ambient,
                                static.max_depth, static.max_nodes,
                                static.dim,
                                static.march_steps if marches(static) else 0,
                                int(has_expr(static)),
                                int(has_shapes(static)))
    return iptr, fptr, params, ints


def _pack_camera(cam, time, y0, device) -> torch.Tensor:
    """The 24-float camera row of pallas_kernel._pack_camera: position,
    forward, up, right, tan_half_fov, time, y0, then padding; every field
    cast to float32 on ``device`` whatever its dtype, as the Pallas kernel
    casts it (differentiable: autograd maps the row's cotangent back to
    each field in its own dtype)."""
    def f32(x, n):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32).reshape(n)
        return torch.full((n,), float(x), dtype=torch.float32, device=device)

    return torch.cat([f32(cam.position, 4), f32(cam.forward, 4),
                      f32(cam.up, 4), f32(cam.right, 4),
                      f32(cam.tan_half_fov, 1), f32(time, 1), f32(y0, 1),
                      torch.zeros(5, dtype=torch.float32, device=device)])


def float32_on(t, device, what: str) -> torch.Tensor:
    """``t`` as the kernels read it: a contiguous float32 tensor on
    ``device``, cast by a differentiable ``.to`` from any floating dtype
    (itself when it is one already), as ``pallas_kernel._table_views``
    casts every table.  Raises ``ValueError`` for a tensor on another
    device or of a dtype that is not floating."""
    if t.device != device or not t.is_floating_point():
        raise ValueError(f"{what}: the CUDA kernel takes a floating dtype "
                         f"on {device}, got {t.dtype} on {t.device}")
    return t.to(torch.float32).contiguous()


def texel_buffer(tables, device) -> torch.Tensor:
    """The textures' texels back to back in float32, the kernels' last
    float table (one zero when the scene has none).  Raises ``ValueError``
    for a texture that is not [h, w, 3] of a floating dtype on ``device``,
    and for textures of 2^31 floats or more together."""
    for i, t in enumerate(tables.textures):
        if t.dim() != 3 or t.shape[2] != 3 or min(t.shape[:2]) < 1:
            raise ValueError(f"texture {i}: shape {tuple(t.shape)} is not "
                             "[h, w, 3]")
    if sum(t.numel() for t in tables.textures) >= 2 ** 31:
        raise ValueError("the textures hold 2^31 floats or more; the CUDA "
                         "kernels index them with int32")
    if not tables.textures:
        return torch.zeros(1, dtype=torch.float32, device=device)
    return torch.cat([float32_on(t, device, f"texture {i}").reshape(-1)
                      for i, t in enumerate(tables.textures)])


def _check_tables(static, tables, device):
    """The float tables in FLOAT_FIELDS order, checked and cast to float32
    (``float32_on``), then the texel buffer (``texel_buffer``)."""
    n_tex = 1 + max((t for k, t in zip(static.surf_kinds, static.surf_texture)
                     if k == "texture"), default=-1)
    if len(tables.textures) < n_tex:
        raise ValueError(f"tables hold {len(tables.textures)} textures; the "
                         f"scene reads {n_tex}")
    S = tables.shape_vec.shape[0]
    M, U = len(static.mat_kinds), len(static.surf_kinds)
    P = tables.portal_tr.shape[0]
    n_portals = 1 + max((e.portal for e in static.entities
                         if e.portal is not None), default=-1)
    if P < n_portals:
        raise ValueError(f"tables.portal_tr has {P} rows; the scene has "
                         f"{n_portals} portals")
    expect = {"shape_vec": (S, 4), "shape_sc": (S,), "mat_ior": (M,),
              "surf_color": (U, 4), "surf_color2": (U, 4),
              "surf_refl": (U,), "surf_fresnel": (U,), "surf_uv_scale": (U,),
              "background": (3,), "mat_warp_center": (M, 4),
              "mat_warp_strength": (M,), "mat_warp_step": (M,),
              "portal_lin": (P, 4, 4), "portal_tr": (P, 4),
              "mat_expr_params": (M, 8)}
    out = []
    for name in FLOAT_FIELDS:
        t = getattr(tables, name)
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"tables.{name}: shape {tuple(t.shape)} does "
                             f"not match the scene's {expect[name]}")
        out.append(float32_on(t, device, f"tables.{name}"))
    return out + [texel_buffer(tables, device)]


def launch_forward(static, floats, cam_row, H: int, W: int, rows: int,
                   tex_shapes) -> torch.Tensor:
    """Launch trace_fwd on the slab with checked float tables (in
    FLOAT_FIELDS order, then the texel buffer of textures of ``tex_shapes``)
    and a camera row -> [rows, W, 3]."""
    global LAUNCHES
    device = cam_row.device
    iptr, fptr, params, _ints = scene_args(static, floats, device,
                                           tex_shapes)
    out = torch.empty((rows, W, 3), dtype=torch.float32, device=device)
    rc = _entry(library("trace_fwd", static))(
        iptr, fptr, params, static.t_max, camera_ptr(cam_row), H, W, rows,
        out.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    check_launch("trace_fwd", rc)
    LAUNCHES += 1
    return out


def camera_ptr(cam_row) -> int:
    """The device address of a 24-float camera row (``_pack_camera``),
    which the kernels read as ``const float*``: raises ``TypeError`` for
    a row of any other dtype, shape or layout."""
    if (cam_row.dtype != torch.float32 or cam_row.shape != (24,)
            or not cam_row.is_contiguous()):
        raise TypeError(f"camera row: the kernels read 24 contiguous "
                        f"float32, got {tuple(cam_row.shape)} {cam_row.dtype}")
    return cam_row.data_ptr()


CUDA_ERROR_MEMORY = 2   # cudaErrorMemoryAllocation


def check_launch(kernel: str, rc: int) -> None:
    """Raise for a launch's nonzero cudaError: ``MemoryError`` where the
    card had not the memory for it (a wide build's local arrays over the
    threads a launch keeps in flight), else ``RuntimeError``."""
    if rc == CUDA_ERROR_MEMORY:
        raise MemoryError(f"{kernel} launch failed: the device has not the "
                          f"memory for it (cudaError {rc})")
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def render_image_cuda(static, tables, cam, H: int, W: int, time=0.0,
                      y0: int = 0, rows: int | None = None) -> torch.Tensor:
    """Render rows [y0, y0 + rows) of the H x W frame with the CUDA kernel
    -> [rows or H, W, 3] float32 on the tables' device.

    Tables, textures and camera of any floating dtype are cast to float32,
    as ``render_image_pallas`` casts them, and the frame is float32 as
    that one's is: float64 tables render the bits of the same tables cast
    to float32.  A float64 render on the card is ``ops.trace.render_image``.
    Takes CUDA tensors only: on any other device it raises, and it never
    falls back to the plain version."""
    device = tables.surf_color.device
    if device.type != "cuda":
        raise ValueError("render_image_cuda takes tables on a CUDA device, "
                         f"got {device}; ops.trace.render_image is the plain "
                         "version")
    floats = _check_tables(static, tables, device)
    cam_row = _pack_camera(cam, time, y0, device)
    return launch_forward(static, floats, cam_row, H, W,
                          H if rows is None else rows, tex_shapes(tables))


def tex_shapes(tables):
    """The textures' shapes, as scene_args takes them."""
    return tuple(tuple(t.shape) for t in tables.textures)
