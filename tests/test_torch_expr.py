"""Expression space in the torch port against the JAX package.

The expression library (scene/expr.py::torch_lib against jax_lib, values and
gradients), the expression field of ops/trace.py::make_accel, the plain
render of config6 and of a time-dependent expression scene, the plain
backward's gradients (mat_expr_params and the scene time included), and the
CUDA kernels' encoding of the expression programs (replayed by a Python VM)
are held against their JAX counterparts on seeded inputs.  The plain
versions are what the CUDA kernels' expression VM (csrc/trace_common.cuh,
csrc/trace_bwd.cu) is held against on the card (tests/test_torch_cuda.py,
chip_smoke.py).  The lax renders and the jax.vjp leaves of the scenes are
stored (tests/jax_refs.py).
"""
import filecmp
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euclider_tpu as et
from euclider_tpu.ops import trace as jtrace
from euclider_tpu.ops.vec import Vec as JVec
from euclider_tpu.scene import expr as JE
from euclider_tpu.scene import ir

import euclider_tpu_torch as ett
from euclider_tpu_torch.ops import cuda_kernel, mathx, trace
from euclider_tpu_torch.ops.vec import Vec
from euclider_tpu_torch.ops.vjp import FLOAT_FIELDS, vjp_blocked
from euclider_tpu_torch.oracle.native_oracle import render_native
from euclider_tpu_torch.scene import expr as TE
from euclider_tpu_torch.utils.validate import assert_oracle_match

import jax_refs
from conftest import assert_images_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens.npz")
FUNCS1 = ("sin", "cos", "tanh", "exp", "log", "sqrt", "abs", "floor", "sign",
          "atan", "asin", "acos")
FUNCS2 = ("min", "max", "atan2", "div")


def tiny_expr_scene(ax="p0 * sin(p1 * z)", ay="0", march=96, ir=ir):
    """tests/test_expr_space.py::_tiny_expr_scene, built with the scene IR
    ``ir`` (the JAX package's by default): an expression sphere in front of
    a smooth hyperplane wall (on uniform and checker surfaces the
    expression's gradients are zero almost everywhere)."""
    region = ir.Entity(ir.Sphere((0, 0, -4), 1.8),
                       material=ir.ExprSpace(ax=ax, ay=ay, step=0.06,
                                             params=(0.5, 2.0)),
                       surface=ir.UniformSurface((0, 0, 0, 0.0)))
    wall = ir.Entity(ir.Hyperplane((0, 0, 1), -8.0),
                     surface=ir.SmoothSurface(uv_scale=0.5))
    return ir.Scene(dim=3, entities=(region, wall),
                    settings=ir.RenderSettings(max_depth=3,
                                               march_steps=march,
                                               background=(0.1, 0.1, 0.2)))


def compiled(sc):
    """(static, numpy tables, numpy camera, torch tables, torch camera)."""
    static, tables = et.compile_scene(sc)
    cam = et.compile_camera(sc.camera)
    return (static, tables, cam, ett.tables_to_torch(tables, "cpu"),
            ett.camera_to_torch(cam, "cpu"))


def lib_inputs(seed, n=96):
    """Seeded float32 inputs with the points where the libraries' rules
    differ from the textbook: zero, the guards' edges (+-1, 0), a value
    past every domain, and (second argument) ties with the first."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    x[:10] = [0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 1e-30, -0.0, 3.0]
    y = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    y[:5] = x[:5]
    y[10:13] = 0.0
    return x, y


# --- the function library --------------------------------------------------------

@pytest.mark.parametrize("name", FUNCS1 + FUNCS2)
def test_torch_lib_matches_jax_lib(name):
    """torch_lib(safe=True) against jax_lib(safe=True): values and
    gradients within 1e-6 (relative above 1), out-of-domain inputs, zero
    and ties included: abs and the polynomials differentiate |x| as
    select(x >= 0, 1, -1), min and max split a tie."""
    x, y = lib_inputs(0)
    args = (x,) if name in FUNCS1 else (x, y)
    jf = JE.jax_lib(safe=True)[name]
    ref, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in args))
    ref_g = vjp(jnp.ones_like(ref))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = TE.torch_lib(safe=True)[name](*targs)
    got_g = torch.autograd.grad(got.sum(), targs)
    for a, b in [(ref, got)] + list(zip(ref_g, got_g)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-6, atol=1e-6)
    assert np.isfinite(np.asarray(ref_g[0])).all()


def test_abs_gradient_at_zero_is_jax_s():
    """jax differentiates |x| at 0 as 1, where torch.abs gives 0: the
    port's mathx.abs (and so mathx.atan at 0) follows jax."""
    assert float(jax.grad(jnp.abs)(0.0)) == 1.0
    x = torch.zeros((), requires_grad=True)
    assert float(torch.autograd.grad(mathx.abs(x), x)[0]) == 1.0
    assert float(torch.autograd.grad(mathx.atan(x), x)[0]) == pytest.approx(
        float(jax.grad(lambda v: JE.jax_lib()["atan"](v))(0.0)), abs=1e-7)


EXPRESSIONS = (
    "p0 * sin(p1 * y + p1 * z)",
    "atan2(p0*sin(x+y*z), max(1, x^3 + (y+(z+w))))",
    "0.1*3 + x*2^3 - -(0.5*0.2) + (0.1*3)^2",
    "x^-2 + y^0 + z^1 - t^3",
    "sqrt(x) + log(y) + asin(z) + acos(w) + x/(y-y) + 1/(t-t)",
    "min(x, y) * max(z, w) + floor(x) * sign(y) + abs(z) + tanh(w) "
    "+ exp(-x) + cos(t) + atan(p1)",
    "(x*x + 1)^p0 + 2^y + 7",
)


def expr_env(seed, n=64):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.0, 2.0, (4, n)).astype(np.float32)
    pos[:, :3] = [[0.0, 1.0, -1.0]] * 4
    prm = np.asarray([0.6, 3.0, -0.7, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    return pos, prm, np.float32(0.4)


@pytest.mark.parametrize("src", EXPRESSIONS)
def test_eval_ast_torch_matches_jax(src):
    """eval_ast with torch_lib(safe=True) against jax_lib(safe=True):
    powers (integer, negative, zero, float), folded constants, every
    guard; values and the gradients with respect to the position, p0..p7
    and t within 1e-6 (relative above 1)."""
    ast = TE.parse(src)
    pos, prm, tm = expr_env(1)

    def jf(pos, prm, tm):
        env = {v: pos[i] for i, v in enumerate("xyzw")}
        env.update({f"p{i}": prm[i] for i in range(8)}, t=tm)
        return jnp.broadcast_to(JE.eval_ast(ast, env, JE.jax_lib(safe=True)),
                                pos.shape[1:])

    ref, vjp = jax.vjp(jf, jnp.asarray(pos), jnp.asarray(prm),
                       jnp.asarray(tm))
    ref_g = vjp(jnp.ones_like(ref))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (pos, prm, np.asarray(tm))]
    env = {v: leaves[0][i] for i, v in enumerate("xyzw")}
    env.update({f"p{i}": leaves[1][i] for i in range(8)}, t=leaves[2])
    got = torch.as_tensor(TE.eval_ast(ast, env, TE.torch_lib(safe=True)))
    got = got.expand(pos.shape[1:])
    got_g = torch.autograd.grad(got.sum(), leaves, allow_unused=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(ref_g, got_g):
        b = np.zeros_like(np.asarray(a)) if b is None else b.numpy()
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-6)
    assert np.isfinite(np.asarray(ref)).all()


@pytest.mark.parametrize("src", ["x / 3", "3 / x", "x^-2"])
def test_unguarded_division_divides_by_a_tensor(src, monkeypatch):
    """eval_ast with a library without a guarded div (torch_lib(safe=
    False)) never divides a tensor by a Python number, nor a number by a
    tensor: on the card torch computes those as a product with a rounded
    reciprocal, where the kernels and jax divide.  The quotient is the
    float64 one within 1e-6 relative.  ("x^-2" as the AST of a negative
    integer literal exponent, which the parser writes as a negation.)"""
    kinds = []
    div, rdiv = torch.Tensor.__truediv__, torch.Tensor.__rtruediv__

    def spy(fn):
        def f(a, b):
            kinds.append(type(b))
            return fn(a, b)
        return f

    monkeypatch.setattr(torch.Tensor, "__truediv__", spy(div))
    monkeypatch.setattr(torch.Tensor, "__rtruediv__", spy(rdiv))
    x = torch.linspace(0.3, 7.0, 97)
    ast = (("pow", ("var", "x"), ("num", -2.0)) if src == "x^-2"
           else TE.parse(src))
    got = TE.eval_ast(ast, {"x": x}, TE.torch_lib())
    monkeypatch.undo()
    assert kinds and all(k is torch.Tensor for k in kinds), kinds
    x64 = x.double()
    ref = {"x / 3": x64 / 3, "3 / x": 3 / x64, "x^-2": 1 / (x64 * x64)}[src]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6)


def test_make_accel_matches_jax():
    """The expression half of make_accel at scene time 0.3, on seeded
    positions of which one in five lies in the ambient material: the field
    within 1e-6, and its VJP with respect to the position, mat_expr_params
    and the time."""
    sc = tiny_expr_scene(ax="p0 * sin(p1 * z + t)", ay="p0 * x * 0.5")
    static, tables, _, ttables, _ = compiled(sc)
    rng = np.random.default_rng(3)
    pos = (rng.uniform(-1.5, 1.5, (4, 200))
           + np.asarray([[0.0], [0.0], [-4.0], [0.0]])).astype(np.float32)
    pos[3] = 0.0
    mats = np.full(200, static.entities[0].material, np.int32)
    mats[::5] = static.ambient
    jt = jax.tree.map(jnp.asarray, tables)

    def jf(pos, ep, tm):
        a = jtrace.make_accel(static, jt._replace(mat_expr_params=ep),
                              jnp.asarray(mats), tm)(JVec(*pos))
        return jnp.stack(list(a))

    ref, vjp = jax.vjp(jf, jnp.asarray(pos),
                       jnp.asarray(tables.mat_expr_params, jnp.float32),
                       jnp.float32(0.3))
    cot = rng.normal(size=ref.shape).astype(np.float32)
    ref_g = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(pos).requires_grad_(True),
              ttables.mat_expr_params.clone().requires_grad_(True),
              torch.tensor(0.3, requires_grad=True)]
    got = torch.stack(list(trace.make_accel(
        static, ttables._replace(mat_expr_params=leaves[1]),
        torch.from_numpy(mats), leaves[2])(Vec(*leaves[0]))))
    got_g = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(ref_g, got_g):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    assert float(np.abs(np.asarray(ref_g[2]))) > 0


# --- the plain render -----------------------------------------------------------

@jax_refs.stored("expr.lax", ["config6_expr_space"])
def config6_ref(name):
    """The jit'd lax render of config6 at 16 x 128."""
    sc = et.get_scene(name)
    static, tables, cam, _, _ = compiled(sc)
    return ({"scene": sc, "H": 16, "W": 128},
            lambda: {"rgb": et.render_image_jit(static, tables, cam, 16,
                                                128)})


def test_plain_config6_matches_lax(compiled_scenes):
    """The rule of tests/test_torch_trace.py at its shapes (16 x 128, the
    jit shape tests/test_expr_space.py renders config6 at)."""
    _, static, tables, cam = compiled_scenes["config6_expr_space"]
    ref = config6_ref.load("config6_expr_space")["rgb"]
    got = trace.render_image(static, ett.tables_to_torch(tables, "cpu"),
                             ett.camera_to_torch(cam, "cpu"), 16, 128)
    assert got.shape == (16, 128, 3) and got.dtype == torch.float32
    assert_images_close(ref, got.numpy(), atol=1e-5, max_bad_frac=0.002,
                        msg="torch-vs-lax config6")


def test_plain_config6_matches_golden(compiled_scenes):
    _, static, tables, cam = compiled_scenes["config6_expr_space"]
    gold = np.load(GOLDENS)["config6_expr_space"]
    got = trace.render_image(static, ett.tables_to_torch(tables, "cpu"),
                             ett.camera_to_torch(cam, "cpu"), 48, 64)
    err = np.abs(got.numpy() - gold).max(axis=-1)
    bad = (err > 2e-3).mean()
    assert bad <= 0.01, (f"{bad:.4f} of pixels beyond 2e-3 from the golden "
                         f"(max {err.max():.2e})")


def test_plain_config6_passes_oracle_gate(compiled_scenes):
    _, static, tables, cam = compiled_scenes["config6_expr_space"]
    inputs = (static, ett.tables_to_torch(tables, "cpu"),
              ett.camera_to_torch(cam, "cpu"))
    gold = np.load(GOLDENS)["config6_expr_space"]
    assert np.abs(render_native(*inputs, 48, 64) - gold).max() <= 1e-6
    assert assert_oracle_match(*inputs, trace.render_image, h=48, w=128,
                               label="config6_expr_space") >= 0.99


@jax_refs.stored("expr.time", [0.0, 1.5])
def time_ref(tm):
    """tests/test_expr_space.py::test_scene_time_plumbs_to_expressions'
    scene and shapes: the jit'd lax render at scene time ``tm``."""
    sc = tiny_expr_scene(ax="p0 * sin(p1 * z + t)")
    static, tables, cam, _, _ = compiled(sc)
    return ({"scene": sc, "H": 12, "W": 16, "time": tm},
            lambda: {"rgb": et.render_image_jit(static, tables, cam, 12, 16,
                                                False, tm)})


@pytest.mark.parametrize("tm", [0.0, 1.5])
def test_render_time_matches_lax(tm):
    """The port's render at scene time 0 and 1.5 against lax within 1e-5,
    and time animates the field."""
    sc = tiny_expr_scene(ax="p0 * sin(p1 * z + t)")
    static, tables, cam, ttables, tcam = compiled(sc)
    ref = time_ref.load(tm)["rgb"]
    got = trace.render_image(static, ttables, tcam, 12, 16, tm).numpy()
    assert_images_close(ref, got, atol=1e-5, msg=f"torch-vs-lax t={tm}")
    other = trace.render_image(static, ttables, tcam, 12, 16, 1.5 - tm)
    assert np.abs(got - other.numpy()).max() > 1e-3


# --- gradients ----------------------------------------------------------------

def vjp_case():
    """The smooth-wall expression scene at scene time 0.3 (8 x 12, 24 march
    steps) -> (scene, compiled, H, W, time, cotangent)."""
    sc = tiny_expr_scene(ax="p0 * sin(p1 * z + t)", march=24)
    H, W = 8, 12
    g = np.random.default_rng(5).normal(size=(H, W, 3)).astype(np.float32)
    return sc, compiled(sc), H, W, 0.3, g


@jax_refs.stored("expr.vjp", ["tiny_expr"])
def vjp_ref(_):
    """jit'd jax.vjp of the lax render of vjp_case's scene."""
    sc, (static, tables, cam, _, _), H, W, tm, g = vjp_case()

    def run():
        t32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tables)

        @jax.jit
        def jvjp(t, c, tm, g):
            return jax.vjp(lambda t, c, tm: et.render_image(
                static, t, c, H, W, True, tm), t, c, tm)[1](g)

        return jax_refs.leaves(*jvjp(t32, cam, jnp.float32(tm),
                                     jnp.asarray(g)))
    return ({"scene": sc, "H": H, "W": W, "time": tm, "seed": 5,
             "cotangent": g}, run)


def test_vjp_matches_jax():
    """vjp_blocked against jit'd jax.vjp of the lax render on the smooth-wall
    expression scene at scene time 0.3 (8 x 12, 24 march steps): every leaf
    within 1e-3 * max(max |ref|, 1) (tests/test_gradients.py's rule),
    mat_expr_params and the time's gradient included, both nonzero."""
    _, (static, _, _, ttables, tcam), H, W, tm, g = vjp_case()
    ref = vjp_ref.load("tiny_expr")
    got = jax_refs.leaves(*vjp_blocked(static, ttables, tcam, H, W,
                                       torch.from_numpy(g), time=tm))
    assert sorted(ref) == sorted(got)
    for k, b in got.items():
        a, b = np.asarray(ref[k], np.float64), np.asarray(b, np.float64)
        tol = 1e-3 * max(np.abs(a).max(), 1.0)
        assert np.abs(a - b).max() <= tol, (k, np.abs(a - b).max(), tol)
    assert np.abs(ref["mat_expr_params"]).max() > 1e-3
    assert abs(float(ref["time"])) > 1e-3


def test_loss_fn_differentiates_the_scene_time():
    """The trainer's loss ('torch' backend) gives a scene time that
    requires grad the plain backward's gradient under the MSE cotangent."""
    from euclider_tpu_torch.train.inverse import InverseParams, make_loss_fn
    sc = tiny_expr_scene(ax="p0 * sin(p1 * z + t)", march=24)
    static, _, _, ttables, tcam = compiled(sc)
    target = torch.from_numpy(np.random.default_rng(6).uniform(
        size=(8, 12, 3)).astype(np.float32))
    tm = torch.tensor(0.3, requires_grad=True)
    loss = make_loss_fn(static, 8, 12, "torch")(InverseParams(ttables, tcam),
                                                target, tm)
    g_tm, = torch.autograd.grad(loss, tm)
    img = trace.render_image(static, ttables, tcam, 8, 12, 0.3)
    ref = vjp_blocked(static, ttables, tcam, 8, 12,
                      2.0 * (img - target) / img.numel(), time=0.3)[2]
    assert float(ref) != 0.0
    assert abs(float(g_tm) - float(ref)) <= 1e-5 * abs(float(ref))


def test_partial_domain_expr_gradients_finite():
    """tests/test_expr_space.py::test_partial_domain_expr_gradients_finite
    in the port: a sqrt field whose domain (z <= -1) excludes the camera,
    where the rays outside the material sit, leaves every gradient of the
    plain backward finite (the safe library's double where)."""
    sc = tiny_expr_scene(ax="p0 * sqrt(-z - 1.0)", march=48)
    static, _, _, ttables, tcam = compiled(sc)
    g = torch.full((8, 12, 3), 1.0 / (8 * 12 * 3))
    gt, gc, gtm = vjp_blocked(static, ttables, tcam, 8, 12, g)
    for k in FLOAT_FIELDS:
        assert bool(torch.isfinite(getattr(gt, k)).all()), k
    assert all(bool(torch.isfinite(v).all()) for v in gc)
    assert bool(torch.isfinite(gtm))
    assert float(gt.mat_expr_params.abs().sum()) > 0


# --- the kernels' encoding ------------------------------------------------------

def replay(code, ends, pos, prm, tm):
    """A Python VM over cuda_kernel.expr_program's instructions with the
    arithmetic of trace_common.cuh vm_eval (float32 torch operations) ->
    the four components."""
    name = {v: k for k, v in TE.OPS.items()}
    lib = TE.torch_lib(safe=True)
    val = []
    for op, a, b, c in code.tolist():
        op = name[op]
        if op == "const":
            r = torch.tensor(np.int32(c).view(np.float32))
        elif op == "var":
            r = pos[a] if a < 4 else prm[a - 4] if a < 12 else tm
        elif op == "neg":
            r = -val[a]
        elif op == "powi":
            r = torch.ones_like(val[a]) if c == 0 else val[a]
            for _ in range(abs(c) - 1):
                r = r * val[a]
            r = lib["div"](1.0, r) if c < 0 else r
        elif op == "powf":
            r = lib["exp"](val[b] * lib["log"](val[a]))
        elif op in ("add", "sub", "mul"):
            r = {"add": torch.add, "sub": torch.sub,
                 "mul": torch.mul}[op](val[a], val[b])
        elif op in FUNCS2:
            r = lib[op](val[a], val[b])
        else:
            r = lib[op](val[a])
        val.append(r)
    return [val[e - 1] for e in ends]


@pytest.mark.parametrize("src", EXPRESSIONS)
def test_expr_program_replays_eval_ast(src):
    """The kernels' program of an expression (its postfix program with the
    operand indices of the replayed stack, Python-float constants folded as
    eval_ast folds them), replayed by a Python VM, gives eval_ast's value
    under torch_lib(safe=True) within 1e-6; every operand precedes its
    instruction (b is 0 for a unary one, so the VM reads it blindly) and
    each component ends in its root."""
    ast = TE.parse(src)
    code, ends = cuda_kernel.expr_program(
        [TE.to_postfix(a) for a in (ast, ast, TE.parse("0"), ast)])
    assert code.shape[1] == 4 and ends[-1] == len(code)
    binary = {TE.OPS[k] for k in ("add", "sub", "mul", "div", "powf", "min",
                                  "max", "atan2")}
    for i, (op, a, b, _) in enumerate(code.tolist()):
        if op not in (TE.OPS["const"], TE.OPS["var"]):
            assert 0 <= a < i and 0 <= b < i
            assert op in binary or b == 0
    pos, prm, tm = (torch.from_numpy(np.asarray(a))
                    for a in expr_env(2))
    env = {v: pos[i] for i, v in enumerate("xyzw")}
    env.update({f"p{i}": prm[i] for i in range(8)}, t=tm)
    ref = torch.as_tensor(TE.eval_ast(ast, env, TE.torch_lib(safe=True)))
    got = replay(code, ends, pos, prm, tm)
    for comp in (got[0], got[1], got[3]):
        np.testing.assert_allclose(comp.expand(pos.shape[1:]).numpy(),
                                   ref.expand(pos.shape[1:]).numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert float(got[2]) == 0.0


def test_encoder_takes_config6_and_refuses_a_long_program(compiled_scenes):
    """config6 takes the default builds; a program past their 128 VM
    instructions, once refused, encodes whole and takes the builds of
    the next power of two."""
    _, static, _, _ = compiled_scenes["config6_expr_space"]
    ints, offsets = cuda_kernel.encode_scene(static)
    m = static.mat_kinds.index("expr")
    mat_warp = ints[offsets[7]:offsets[8]]
    assert mat_warp[m] == cuda_kernel.MAT_MARCH["expr"]
    assert cuda_kernel.capacities(static) == ()
    long = tiny_expr_scene(ax=" + ".join(["x"] * 70), ir=ett.ir)
    static, _ = ett.compile_scene(long)
    ints, offsets = cuda_kernel.encode_scene(static)
    n = (offsets[10] - offsets[9]) // 4       # expr_code: 4 ints each
    assert n == cuda_kernel.needs(static)["expr"] > 128
    assert cuda_kernel.capacities(static) == (("expr", 256),)
    assert cuda_kernel.library("trace_bwd", static) == "trace_bwd+expr256"


def test_oracle_source_is_the_jax_package_s():
    """The port builds its own copy of the C++ oracle; it stays identical
    to the JAX package's, the ground truth both are held to."""
    port = os.path.join(ROOT, "euclider_tpu_torch", "oracle", "native",
                        "oracle.cpp")
    ref = os.path.join(ROOT, "euclider_tpu", "oracle", "native",
                       "oracle.cpp")
    assert filecmp.cmp(port, ref, shallow=False)
    from euclider_tpu_torch.oracle import native_oracle
    assert os.path.samefile(native_oracle._SRC, port)
    static, _, _, ttables, tcam = compiled(tiny_expr_scene())
    assert math.isfinite(float(render_native(static, ttables, tcam, 4,
                                             4).sum()))
