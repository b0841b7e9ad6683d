"""The least time of a frame or a training step on one H100: the
benchmark's yardstick for the kernels' share of their roofline.

Frozen copy of ``chip_smoke.py``'s ``bound``, ``side_ops``, ``field_ops``
and their operation constants, and of
``euclider_tpu_torch/ops/cuda_kernel.py::expr_program`` (as
``vm_program``), at commit ee5cc13d71e7, on the benchmark's own plain
reference (``benchmark/reference``).  Never edited to follow the program.

The least time is the larger of two: the FP32 operations the work needs
over the FP32 peak, and the bytes it must move over the HBM bandwidth.
The operations count the camera ray, every straight node's nearest-hit
test over every leaf of every entity, every live march step with its
field and its side tests over every entity, one bisection a marched node,
and the cheapest shading of every node; for each node that hits an entity,
the membership probe of a composite and the octaves of a perlin surface or
the bilinear sample of a texture.  A backward (a training step) counts
them twice, its forward sweep and the recompute of its reverse sweep, and
no adjoint arithmetic.  The bytes are 12 a pixel (the image out, or the
target in) and the textures once.
"""
from __future__ import annotations

import numpy as np

from .reference.ops import geometry as G
from .reference.scene import expr as E

# H100 SXM published peaks (NVIDIA H100 datasheet): FP32 outside the
# tensor cores and HBM bandwidth, at the full 700 W power limit
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# FP32 operations of the kernels' code (trace_common.cuh), counted as one
# per add, multiply, compare-free select, sqrt, rsqrt, divide, sine, pow
# or floor:
CAMERA_OPS = 125          # camera_ray: 4 normalize, 3 projections, NDC
# nearest(): one leaf's roots
TEST_OPS = {"sphere": 25, "halfspace": 16, "hyperplane": 16, "cylinder": 70}
MISS_OPS = 6              # the cheapest shading: w * background
MARCH_STEP_OPS = 47       # march_step: the field (18), v + h a, normalize, x + h v
ATTRACTOR_OPS = 18        # the attractor field of march_step
# leaf_member() / side(): one leaf; a bare hyperplane's side is a
# half-space test, inside a composite it is free
SIDE_OPS = {"sphere": 12, "halfspace": 8, "hyperplane": 8, "cylinder": 27}
BISECT_OPS = 240          # bisect(): 10 halvings of lerp + side, one entity
PROBE_POINT_OPS = 9       # csg_flips(): t -+ PROBE and o + t d, per point
PERLIN_OCTAVE_OPS = 45    # perlin_sum(): one octave (scale, floor, fraction,
                          # 4 gradient dots, 2 fades, 3 lerps, the sum)
TEXTURE_OPS = 39          # tex_cell() and 3 channels of bilinear()


def vm_program(programs):
    """The kernels' VM program of one expression material's four components
    from their postfix programs (``to_postfix``) -> code [L, 4] int32:
    instruction i is (op, a, b, c).  Constants joined by + - * and unary
    minus, and integer powers of them, fold into one constant."""
    name = {v: k for k, v in E.OPS.items()}
    arity = {"neg": 1, "powi": 1, "add": 2, "sub": 2, "mul": 2, "div": 2,
             "powf": 2, "min": 2, "max": 2, "atan2": 2}
    py = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
          "mul": lambda a, b: a * b}
    code = []

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
        index(top)
    return np.asarray(code, np.int32).reshape(-1, 4)


def side_ops(node):
    """Operations of member() or side() on a shape: its leaves' tests."""
    if G.is_primitive(node):
        return SIDE_OPS[node[0]]
    return sum(0 if leaf[0] == "hyperplane" else SIDE_OPS[leaf[0]]
               for leaf in G.leaves(node))


def field_ops(static):
    """Operations of the cheapest field a march step of this scene
    evaluates: the attractor's, or an expression material's VM program,
    one per instruction that computes (constants and variables are free,
    an integer power counts its multiplications and, for a negative
    exponent, its division)."""
    ops = []
    for m, kind in enumerate(static.mat_kinds):
        if kind == "warp":
            ops.append(ATTRACTOR_OPS)
        elif kind == "expr":
            code = vm_program([E.to_postfix(a) for a in static.mat_exprs[m]])
            ops.append(sum(max(abs(n) - 1 + (n < 0), 0) if op == E.OPS["powi"]
                           else int(op not in (E.OPS["const"], E.OPS["var"]))
                           for op, _, _, n in code.tolist()))
    return min(ops, default=ATTRACTOR_OPS)


def bound(static, nodes, backward, steps=0, marches=0, hits=(),
          tex_bytes=0, pixels=0):
    """Least time in ms of the work of ``pixels`` pixels whose counts are
    ``nodes`` (ray-tree nodes shaded), ``steps`` (live march steps),
    ``marches`` (marched nodes) and ``hits`` (nodes that hit each entity)
    -> (ms, "operations" or "bytes", operations)."""
    test = sum(TEST_OPS[leaf[0]] for e in static.entities
               for leaf in G.leaves(e.shape))
    side = sum(side_ops(e.shape) for e in static.entities)
    step = MARCH_STEP_OPS - ATTRACTOR_OPS + field_ops(static)
    ops = (pixels * CAMERA_OPS + nodes * MISS_OPS + (nodes - marches) * test
           + steps * (step + side) + marches * BISECT_OPS)
    perlin = static.surf_perlin or (None,) * len(static.surf_kinds)
    for e, n in zip(static.entities, hits):
        if not G.is_primitive(e.shape):
            ops += n * 2 * (PROBE_POINT_OPS + side_ops(e.shape))
        kind = static.surf_kinds[e.surface]
        if kind == "perlin":
            ops += n * perlin[e.surface][0] * PERLIN_OCTAVE_OPS
        elif kind == "texture":
            ops += n * TEXTURE_OPS
    if backward:
        ops *= 2
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = (pixels * 12 + tex_bytes) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes"), ops
