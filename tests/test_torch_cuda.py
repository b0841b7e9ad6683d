"""The CUDA kernels (csrc/trace_fwd.cu, csrc/trace_bwd.cu, csrc/trace_seg.cu,
csrc/probe_rev.cu, csrc/probe_mosaic.cu, csrc/probe_march.cu) against their
plain torch versions (ops/trace.py, ops/vjp.py, ops/probes.py,
ops/march_probe.py), and the viewer's frame loop (viewer/simulation.py)
through the forward kernel.

The card tests carry the ``cuda`` marker and skip without a CUDA device.
This file imports neither jax nor the JAX package, so on the card (which has
no jax) it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

chip_smoke.py makes the same comparison at 1280x720.
"""
from dataclasses import replace

import pytest
import torch

import euclider_tpu_torch as ett
from euclider_tpu_torch.ops import cuda_kernel, trace

# 16 rows x 256 columns: ragged against the kernel's 32x8 blocks on neither
# axis; the slab cases below are ragged on both
H, W = 16, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def warp_gradient_scene():
    """tests/test_gradients.py::test_grad_warp_strength's scene: a warp
    sphere in front of a smooth hyperplane wall."""
    from euclider_tpu_torch.scene import ir
    region = ir.Entity(ir.Sphere((0, 0, -4), 1.8),
                       material=ir.WarpSpace(center=(0, 0, -4), strength=0.4,
                                             step=0.05),
                       surface=ir.UniformSurface((0, 0, 0, 0.0)))
    wall = ir.Entity(ir.Hyperplane((0, 0, 1), -8.0),
                     surface=ir.SmoothSurface(uv_scale=0.5))
    return ir.Scene(dim=3, entities=(region, wall),
                    settings=ir.RenderSettings(max_depth=3, march_steps=200,
                                               background=(0.1, 0.1, 0.2)))


def expr_gradient_scene():
    """tests/test_expr_space.py::_tiny_expr_scene with a time-dependent
    field: an expression sphere in front of a smooth hyperplane wall."""
    from euclider_tpu_torch.scene import ir
    region = ir.Entity(ir.Sphere((0, 0, -4), 1.8),
                       material=ir.ExprSpace(ax="p0 * sin(p1 * z + t)",
                                             ay="0", step=0.06,
                                             params=(0.5, 2.0)),
                       surface=ir.UniformSurface((0, 0, 0, 0.0)))
    wall = ir.Entity(ir.Hyperplane((0, 0, 1), -8.0),
                     surface=ir.SmoothSurface(uv_scale=0.5))
    return ir.Scene(dim=3, entities=(region, wall),
                    settings=ir.RenderSettings(max_depth=3, march_steps=96,
                                               background=(0.1, 0.1, 0.2)))


def cylinder_scene(smooth=False):
    """tests/test_cylinder.py::_cyl_scene: a cylinder pillar, a sphere bored
    out by a cylinder (CSG difference) and a floor; ``smooth`` puts smooth
    surfaces on all three (the geometry's gradient is zero on the checker
    and uniform ones)."""
    from euclider_tpu_torch.scene import ir

    def surf(smooth_scale, other):
        return ir.SmoothSurface(uv_scale=smooth_scale) if smooth else other

    pillar = ir.Entity(ir.Cylinder((1.2, 0.0, -5.0), (0.0, 1.0, 0.0), 0.5),
                       surface=surf(3.0, ir.CheckerSurface(uv_scale=3.0)))
    bored = ir.Csg("difference", (
        ir.Sphere((-1.2, 0.0, -4.5), 1.0),
        ir.Cylinder((-1.2, 0.0, -4.5), (0.0, 0.0, 1.0), 0.45)))
    ring = ir.Entity(bored, surface=surf(2.0, ir.UniformSurface(
        (0.8, 0.5, 0.2, 1.0), reflectivity=0.1)))
    floor = ir.Entity(ir.HalfSpace((0.0, -1.0, 0.0), 1.2),
                      surface=surf(0.8, ir.CheckerSurface(uv_scale=0.8)))
    return ir.Scene(dim=3, entities=(pillar, ring, floor),
                    camera=ir.Camera(position=(0.0, 0.4, 1.0),
                                     forward=(0.0, -0.12, -1.0)),
                    settings=ir.RenderSettings(max_depth=3,
                                               background=(0.05, 0.06, 0.1)))


def spheres_scene(n=44):
    """chip_smoke.py's spheres48 with ``n`` small spheres: config2's floor
    and three spheres and n small spheres on the floor behind them, each
    with its own uniform surface (every other one reflective).  At n = 44:
    48 entities, 797 parameters, past the march's 32 entities and a
    thread's 159 gradient entries."""
    from euclider_tpu_torch.scene import ir
    sc = ett.get_scene("config2_mirror_glass")
    balls = tuple(ir.Entity(
        ir.Sphere((-3.0 + 0.6 * (i % 11), -0.82, -6.5 - 0.9 * (i // 11)),
                  0.18),
        surface=ir.UniformSurface(
            (0.2 + 0.15 * (i % 5), 0.3 + 0.25 * (i % 3), 0.9 - 0.1 * (i % 7),
             1.0), reflectivity=0.3 if i % 2 else 0.0),
        name=f"ball{i}") for i in range(n))
    return replace(sc, name="spheres48", entities=sc.entities + balls)


def deep_scene(smooth=False):
    """chip_smoke.py's config2_deep: config2 at max_depth 8 and max_nodes
    255, past the tape kernel's 63 nodes; ``smooth`` gives the floor a
    smooth surface, so that the geometry gets gradients too."""
    from euclider_tpu_torch.scene import ir
    sc = ett.get_scene("config2_mirror_glass")
    if smooth:
        sc = replace(sc, entities=tuple(
            replace(e, surface=ir.SmoothSurface(uv_scale=1.0,
                                                reflectivity=0.25))
            if e.name == "floor" else e for e in sc.entities))
    return replace(sc, name="config2_deep", settings=replace(
        sc.settings, max_depth=8, max_nodes=255))


def warp32_scene(n=30):
    """A marching scene at the march's 32-entity cap: a warp sphere, a
    smooth wall and n = 30 small spheres, each with its own uniform
    surface, on a ring inside the warp region, so that marched rays cross
    the ring's spheres (the last one is entity 31, the side mask's top
    bit)."""
    import math
    from euclider_tpu_torch.scene import ir
    region = ir.Entity(ir.Sphere((0, 0, -4), 1.8),
                       material=ir.WarpSpace(center=(0, 0, -4), strength=0.4,
                                             step=0.05),
                       surface=ir.UniformSurface((0, 0, 0, 0.0)))
    wall = ir.Entity(ir.Hyperplane((0, 0, 1), -8.0),
                     surface=ir.SmoothSurface(uv_scale=0.5))
    balls = tuple(ir.Entity(
        ir.Sphere((1.1 * math.cos(2 * math.pi * i / n),
                   1.1 * math.sin(2 * math.pi * i / n), -4.0), 0.2),
        surface=ir.UniformSurface((0.2 + 0.6 * i / n, 0.5, 0.8 - 0.6 * i / n,
                                   1.0)),
        name=f"ball{i}") for i in range(n))
    return ir.Scene(dim=3, name="warp32", entities=(region, wall) + balls,
                    settings=ir.RenderSettings(max_depth=3, march_steps=200,
                                               background=(0.1, 0.1, 0.2)))


def config7_smooth():
    """chip_smoke.py's config7_smooth: config7 (4D, warped space, portals)
    with smooth surfaces on the marker, the backdrop and the floor; on its
    uniform and checker surfaces the warp's gradient is zero."""
    from euclider_tpu_torch.scene import ir
    sc = ett.get_scene("config7_warp4d")
    return replace(sc, name="config7_smooth", entities=tuple(
        replace(e, surface=ir.SmoothSurface(uv_scale=0.8))
        if e.name in ("portal_marker4d", "backdrop_hypersphere", "floor")
        else e for e in sc.entities))


# the scenes past the kernels' old fixed limits (tools/limit_scenes.py):
# each takes a wider build, but config3_strips (textures past 16,384 texels
# on a side) the default one
LIMIT_SCENES = ["config2_d24", "config2_d24_deep", "csg48", "config6_long",
                "config5_crowd", "config5_fine", "config3_strips"]


def scene_on(name, device, **settings):
    from euclider_tpu_torch.tools import limit_scenes
    sc = {"warp_gradient_scene": warp_gradient_scene,
          "expr_gradient_scene": expr_gradient_scene,
          "cylinder_test": cylinder_scene,
          "cylinder_smooth": lambda: cylinder_scene(True),
          "config7_smooth": config7_smooth,
          "spheres48": spheres_scene,
          "warp32": warp32_scene,
          "config2_deep": deep_scene,
          "config2_deep_smooth": lambda: deep_scene(True),
          **{n: (lambda n=n: limit_scenes.get_scene(n))
             for n in LIMIT_SCENES}}.get(
              name, lambda: ett.get_scene(name))()
    if settings:
        sc = replace(sc, settings=replace(sc.settings, **settings))
    static, tables = ett.compile_scene(sc)
    return (static, ett.tables_to_torch(tables, device),
            ett.camera_to_torch(ett.compile_camera(sc.camera), device))


def test_encoder_refuses_a_tree_deeper_than_the_stack():
    """The default build's stack holds max_depth + 1 <= 16 slots; a deeper
    tree, once refused, encodes and takes the builds of 32 slots (the next
    power of two), each kernel's library named for them, while config2
    itself keeps the default builds."""
    sc = ett.get_scene("config2_mirror_glass")
    slots = cuda_kernel.CAPACITIES["slots"][0]
    static, _ = ett.compile_scene(replace(sc, settings=replace(
        sc.settings, max_depth=slots)))
    cuda_kernel.encode_scene(static)
    assert cuda_kernel.needs(static)["slots"] == slots + 1
    assert cuda_kernel.capacities(static) == (("slots", 2 * slots),)
    for kernel in ("trace_fwd", "trace_bwd", "trace_seg"):
        name = cuda_kernel.library(kernel, static)
        assert name == f"{kernel}+slots{2 * slots}"
        assert cuda_kernel.capacity_flags(name) == (
            f"-DTRACE_MAX_SLOTS={2 * slots}",)
    static, _ = ett.compile_scene(sc)
    assert cuda_kernel.capacities(static) == ()
    assert cuda_kernel.library("trace_bwd", static) == "trace_bwd"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["config1_sphere_room",
                                  "config2_mirror_glass",
                                  "config3_csg_textured",
                                  "config4_hypersphere",
                                  "config5_warp_portal",
                                  "config6_expr_space",
                                  "config7_warp4d",
                                  "perlin_probe",
                                  "cylinder_test",
                                  "warp32", *LIMIT_SCENES])
def test_kernel_matches_plain(cuda, name):
    static, tables, cam = scene_on(name, cuda)
    before = cuda_kernel.LAUNCHES
    got = cuda_kernel.render_image_cuda(static, tables, cam, H, W)
    ref = trace.render_image(static, tables, cam, H, W)
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES == before + 1
    assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
    # every library is built without FMA contraction, so each operation
    # rounds as the plain version's: the same frame to the bit
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["config5_warp_portal", "config7_warp4d"])
def test_marching_kernel_renders_to_the_bit(cuda, name):
    """config5 and config7 at 1280 x 720 through the builds that march,
    launched in blocks of 8 x 32 threads (warps of 8 x 4 pixels) with the
    side table in shared memory: the plain version's frame to the bit."""
    static, tables, cam = scene_on(name, cuda)
    got = cuda_kernel.render_image_cuda(static, tables, cam, 720, 1280)
    ref = trace.render_image(static, tables, cam, 720, 1280)
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("y0, rows", [(0, 5), (5, 7), (9, 7)])
def test_kernel_row_slab(cuda, y0, rows):
    static, tables, cam = scene_on("config2_mirror_glass", cuda)
    full = cuda_kernel.render_image_cuda(static, tables, cam, H, W - 3)
    slab = cuda_kernel.render_image_cuda(static, tables, cam, H, W - 3,
                                         y0=y0, rows=rows)
    assert slab.shape == (rows, W - 3, 3)
    torch.testing.assert_close(slab, full[y0:y0 + rows], rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_depth_cap(cuda):
    """A truncated tree (max_nodes below the full tree) is cut exactly where
    the plain version cuts it."""
    static, tables, cam = scene_on("config2_mirror_glass", cuda, max_nodes=5)
    got = cuda_kernel.render_image_cuda(static, tables, cam, H, W)
    ref = trace.render_image(static, tables, cam, H, W)
    bad = ((got - ref).abs().amax(dim=-1) > 1e-4).float().mean()
    assert float(bad) <= 1e-3


# --- the backward kernel (csrc/trace_bwd.cu) --------------------------------

BH, BW = 48, 64     # ragged against the 32x8 blocks on neither axis


def grads_close(ref, got, rtol=1e-3):
    """tests/test_gradients.py::_assert_grads_close on (d_tables, d_cam):
    per leaf, max |diff| <= rtol * max(max |ref|, 1)."""
    pairs = [(getattr(ref[0], k), getattr(got[0], k))
             for k in cuda_kernel.FLOAT_FIELDS]
    pairs += list(zip(ref[0].textures, got[0].textures))
    pairs += list(zip(ref[1], got[1]))
    for a, b in pairs:
        a, b = a.double().cpu(), b.double().cpu()
        tol = rtol * max(float(a.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= tol


def cotangent(shape, seed, device):
    import numpy as np
    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(g).to(device)


def off_seams(g, static, tables, cam, time=0.0):
    """g, zero where the comparison would measure float32 noise: where the
    kernel's and the plain forward take different branches, and within a
    pixel of an image seam (second difference above 0.02), where per-pixel
    gradients such as dt/dr ~ 1/sqrt(disc) amplify a rounding without
    bound (chip_smoke.py phase 6 holds the frame to the same rule)."""
    H, W = g.shape[:2]
    k1 = cuda_kernel.render_image_cuda(static, tables, cam, H, W, time)
    img = trace.render_image(static, tables, cam, H, W, time)
    d2x = (img[:, 2:] + img[:, :-2] - 2 * img[:, 1:-1]).abs().amax(-1)
    d2y = (img[2:] + img[:-2] - 2 * img[1:-1]).abs().amax(-1)
    m = (k1 - img).abs().amax(-1) > 1e-4
    m[:, 1:-1] |= d2x > 0.02
    m[1:-1] |= d2y > 0.02
    m = torch.nn.functional.max_pool2d(m[None, None].float(), 3, 1, 1)[0, 0]
    return g * (m == 0)[..., None]


# (H, W, y0, rows): the frame and its rows [y0, y0 + rows) that a case
# differentiates, else the BH x BW frame: config7's across its warp region,
# at a size where the warp's gradient outlives the seams' mask (at 48 x 64
# every pixel it reaches is masked)
VJP_SLABS = {"config7_warp4d": (180, 320, 72, 16),
             "config7_smooth": (180, 320, 72, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["grad_probe", "config2_mirror_glass",
                                  "warp_gradient_scene",
                                  "config5_warp_portal",
                                  "config3_csg_textured", "perlin_probe",
                                  "cylinder_smooth", "config4_hypersphere",
                                  "config7_warp4d", "config7_smooth",
                                  *LIMIT_SCENES])
def test_vjp_kernel_matches_plain(cuda, name):
    """The 4D scenes too: config4 on the frame, config7 (and config7 with
    smooth surfaces, whose warp parameters get a nonzero gradient) on a
    slab whose rays march; and the scenes past the old fixed limits, each
    through its wider build (config2_d24_deep through the segmented
    kernels)."""
    from euclider_tpu_torch.ops import cuda_bwd, vjp
    static, tables, cam = scene_on(name, cuda)
    fh, fw, y0, rows = VJP_SLABS.get(name, (BH, BW, 0, BH))
    g = off_seams(cotangent((fh, fw, 3), 0, cuda), static, tables,
                  cam)[y0:y0 + rows]
    before = cuda_bwd.LAUNCHES + cuda_bwd.SEG_LAUNCHES
    got = cuda_bwd.vjp_cuda(static, tables, cam, fh, fw, g, y0=y0,
                            rows=rows)
    ref = vjp.vjp_blocked(static, tables, cam, fh, fw, g, y0=y0, rows=rows)
    torch.cuda.synchronize()
    assert cuda_bwd.LAUNCHES + cuda_bwd.SEG_LAUNCHES == before + 1
    grads_close(ref, got)
    if name == "config7_smooth":
        assert float(ref[0].mat_warp_strength.abs().max()) > 0
        assert float(got[0].mat_warp_strength.abs().max()) > 0


@pytest.mark.cuda
def test_fused_step_matches_unfused(cuda):
    """train_step_cuda against the forward kernel + MSE + vjp_cuda."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on("grad_probe", cuda)
    target = cotangent((BH, BW, 3), 1, cuda).sigmoid()
    loss, gt, gc, _ = cuda_bwd.train_step_cuda(static, tables, cam, target,
                                               BH, BW)
    img = cuda_kernel.render_image_cuda(static, tables, cam, BH, BW)
    ref_loss = torch.mean((img - target) ** 2)
    g = 2.0 * (img - target) / img.numel()
    ref = cuda_bwd.vjp_cuda(static, tables, cam, BH, BW, g)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * float(ref_loss)
    grads_close(ref[:2], (gt, gc))


@pytest.mark.cuda
def test_fused_step_matches_unfused_on_a_marching_scene(cuda):
    """train_step_cuda against the forward kernel + MSE + vjp_cuda on the
    warp gradient scene: the march backward (K4) in both modes."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on("warp_gradient_scene", cuda)
    target = cotangent((BH, BW, 3), 4, cuda).sigmoid()
    before = cuda_bwd.LAUNCHES
    loss, gt, gc, _ = cuda_bwd.train_step_cuda(static, tables, cam, target,
                                               BH, BW)
    img = cuda_kernel.render_image_cuda(static, tables, cam, BH, BW)
    ref_loss = torch.mean((img - target) ** 2)
    ref = cuda_bwd.vjp_cuda(static, tables, cam, BH, BW,
                            2.0 * (img - target) / img.numel())
    assert cuda_bwd.LAUNCHES == before + 2
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * float(ref_loss)
    assert float(gt.mat_warp_strength.abs().max()) > 0
    grads_close(ref[:2], (gt, gc))


@pytest.mark.cuda
def test_vjp_kernel_matches_plain_through_an_expression(cuda):
    """vjp_cuda against the plain backward on the expression gradient scene
    at scene time 0.3: the expression VM's adjoint inside K4, with
    mat_expr_params' and the time's gradients nonzero; the time's within
    the same rule."""
    from euclider_tpu_torch.ops import cuda_bwd, vjp
    static, tables, cam = scene_on("expr_gradient_scene", cuda)
    g = off_seams(cotangent((BH, BW, 3), 5, cuda), static, tables, cam, 0.3)
    got = cuda_bwd.vjp_cuda(static, tables, cam, BH, BW, g, time=0.3)
    ref = vjp.vjp_blocked(static, tables, cam, BH, BW, g, time=0.3)
    grads_close(ref, got)
    assert float(ref[0].mat_expr_params.abs().max()) > 0
    assert abs(float(ref[2])) > 0
    assert abs(float(got[2]) - float(ref[2])) <= 1e-3 * max(
        abs(float(ref[2])), 1.0)


@pytest.mark.cuda
def test_texture_gradient_matches_plain(cuda):
    """The texels' gradient of vjp_cuda (summed by atomics in its own
    buffer) against the plain backward on config3 at 360 x 640, where the
    textured blob is wide enough to hold pixels off its seams (at 144 x 256
    every one of them lies within a pixel of a texel edge of the texture's
    checker); and the fused step's against the unfused one."""
    from euclider_tpu_torch.ops import cuda_bwd, vjp
    static, tables, cam = scene_on("config3_csg_textured", cuda)
    h, w = 360, 640
    g = off_seams(cotangent((h, w, 3), 8, cuda), static, tables, cam)
    got = cuda_bwd.vjp_cuda(static, tables, cam, h, w, g)
    ref = vjp.vjp_blocked(static, tables, cam, h, w, g)
    assert float(ref[0].textures[0].abs().max()) > 0
    grads_close(ref, got)
    target = cotangent((h, w, 3), 9, cuda).sigmoid()
    loss, gt, gc, _ = cuda_bwd.train_step_cuda(static, tables, cam, target,
                                               h, w)
    img = cuda_kernel.render_image_cuda(static, tables, cam, h, w)
    ref = cuda_bwd.vjp_cuda(static, tables, cam, h, w,
                            2.0 * (img - target) / img.numel())
    assert float(gt.textures[0].abs().max()) > 0
    grads_close(ref[:2], (gt, gc))


@pytest.mark.cuda
def test_fused_step_matches_unfused_on_config6(cuda):
    """One fused training step of config6 against the forward kernel + MSE
    + vjp_cuda: the expression VM in both modes of trace_bwd."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on("config6_expr_space", cuda)
    target = cotangent((BH, BW, 3), 6, cuda).sigmoid()
    loss, gt, gc, _ = cuda_bwd.train_step_cuda(static, tables, cam, target,
                                               BH, BW)
    img = cuda_kernel.render_image_cuda(static, tables, cam, BH, BW)
    ref_loss = torch.mean((img - target) ** 2)
    ref = cuda_bwd.vjp_cuda(static, tables, cam, BH, BW,
                            2.0 * (img - target) / img.numel())
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * float(ref_loss)
    grads_close(ref[:2], (gt, gc))


@pytest.mark.cuda
def test_loss_fn_differentiates_the_scene_time(cuda):
    """The 'cuda' backend's loss gives the scene time the gradient the
    fused step (train_step_cuda, 'cuda-fused') returns: both through the
    backward kernel's camera-row slot."""
    from euclider_tpu_torch.ops import cuda_bwd
    from euclider_tpu_torch.train.inverse import InverseParams, make_loss_fn
    static, tables, cam = scene_on("expr_gradient_scene", cuda)
    target = cotangent((BH, BW, 3), 7, cuda).sigmoid()
    tm = torch.tensor(0.3, device=cuda, requires_grad=True)
    loss = make_loss_fn(static, BH, BW, "cuda")(InverseParams(tables, cam),
                                                target, tm)
    g_tm, = torch.autograd.grad(loss, tm)
    d_time = cuda_bwd.train_step_cuda(static, tables, cam, target, BH, BW,
                                      0.3)[3]
    assert float(d_time) != 0.0
    assert abs(float(g_tm) - float(d_time)) <= 1e-3 * max(
        abs(float(d_time)), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 1000])
def test_probe_rev_matches_plain(cuda, n):
    """csrc/probe_rev.cu against rev_march_plain on the probe's (8, 128)
    tile and on its first 1000 elements (the cluster's last block part
    empty): dx and dw within 1e-5 relative; a second launch gives the same
    bits."""
    from euclider_tpu_torch.ops import probes
    x = (cotangent((8, 128), 7, cuda) * 0.8).reshape(-1)[:n]
    g = cotangent((8, 128), 8, cuda).reshape(-1)[:n]
    before = probes.LAUNCHES
    dx, dw = probes.rev_march_vjp(x, 1.1, g)
    pdx, pdw = probes.rev_march_plain(x, 1.1, g)
    torch.cuda.synchronize()
    assert probes.LAUNCHES == before + 1
    assert float((dx - pdx).abs().max()) <= 1e-5 * float(pdx.abs().max())
    assert abs(float(dw) - float(pdw)) <= 1e-5 * abs(float(pdw))
    dx2, dw2 = probes.rev_march_vjp(x, 1.1, g)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.cuda
def test_vjp_kernel_row_slabs_sum_to_the_frame(cuda):
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on("grad_probe", cuda)
    g = cotangent((BH, BW - 3, 3), 2, cuda)
    whole = cuda_bwd.vjp_cuda(static, tables, cam, BH, BW - 3, g)
    parts = [cuda_bwd.vjp_cuda(static, tables, cam, BH, BW - 3,
                               g[y0:y0 + r], y0=y0, rows=r)
             for y0, r in ((0, 13), (13, 20), (33, 15))]
    summed = (whole[0]._replace(**{
                  k: sum(getattr(p[0], k) for p in parts)
                  for k in cuda_kernel.FLOAT_FIELDS}),
              type(whole[1])(*(sum(c) for c in zip(*(p[1] for p in parts)))))
    # the slabs' sums reassociate float32 sums over thousands of pixels
    # (measured 3.05e-5 on a leaf of magnitude 1.01 on the H100): the JAX
    # package's own rule for reassociated sums, 1e-3 relative
    grads_close(whole[:2], summed)


@pytest.mark.cuda
def test_render_image_diff_backward_is_the_kernel(cuda):
    """autograd through render_image_diff runs both kernels and gives
    vjp_cuda's gradients, camera included."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on("grad_probe", cuda)
    g = cotangent((BH, BW, 3), 3, cuda)
    leaves = [getattr(tables, k).clone().requires_grad_(True)
              for k in cuda_kernel.FLOAT_FIELDS]
    cam_l = [v.clone().requires_grad_(True) for v in cam]
    f0, b0 = cuda_kernel.LAUNCHES, cuda_bwd.LAUNCHES
    img = cuda_bwd.render_image_diff(
        static, tables._replace(**dict(zip(cuda_kernel.FLOAT_FIELDS, leaves))),
        type(cam)(*cam_l), BH, BW)
    grads = torch.autograd.grad(img, leaves + cam_l, g)
    assert (cuda_kernel.LAUNCHES, cuda_bwd.LAUNCHES) == (f0 + 1, b0 + 1)
    ref = cuda_bwd.vjp_cuda(static, tables, cam, BH, BW, g)
    n = len(cuda_kernel.FLOAT_FIELDS)
    grads_close(ref[:2], (ref[0]._replace(**dict(zip(
        cuda_kernel.FLOAT_FIELDS, grads[:n]))), type(cam)(*grads[n:])),
        rtol=1e-6)


def flat_grads(d_tables, d_cam, d_time):
    """A gradient's leaves (tables, camera, time) as one vector."""
    return torch.cat([getattr(d_tables, k).reshape(-1)
                      for k in cuda_kernel.FLOAT_FIELDS]
                     + [c.reshape(-1) for c in d_cam] + [d_time.reshape(-1)])


@pytest.mark.cuda
@pytest.mark.parametrize("name, acc", [("config2_mirror_glass", "shared"),
                                       ("config6_expr_space", "local")])
def test_backward_kernel_is_deterministic(cuda, name, acc):
    """Two launches of vjp_cuda, and of train_step_cuda, at 180 x 320 give
    bit-identical gradients and loss: each block sums its threads' vectors
    in a fixed order, and a second kernel the blocks' in a fixed order;
    these scenes have no texture and no entry past MAX_PARAMS, the only
    sums by atomics.  The launches take the configuration chosen by size:
    config2's gradient vectors in shared memory, config6's (142 entries, a
    build with the VM) in local memory."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on(name, cuda)
    h, w = 180, 320
    g = cotangent((h, w, 3), 11, cuda)
    target = cotangent((h, w, 3), 12, cuda).sigmoid()
    a, b = (flat_grads(*cuda_bwd.vjp_cuda(static, tables, cam, h, w, g))
            for _ in range(2))
    assert torch.equal(a, b)
    cfg = cuda_bwd.launch_config(static, tables)
    assert cfg["grad_storage"] == acc, cfg
    (la, *ga), (lb, *gb) = (cuda_bwd.train_step_cuda(static, tables, cam,
                                                     target, h, w)
                            for _ in range(2))
    assert torch.equal(la, lb)
    assert torch.equal(flat_grads(*ga), flat_grads(*gb))


# --- the segmented backward (K6, K7) and the lifted caps -------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name,h,w", [
    ("config2_mirror_glass", BH, BW), ("warp_gradient_scene", BH, BW),
    ("expr_gradient_scene", BH, BW), ("config3_csg_textured", BH, BW),
    ("config2_mirror_glass", 37, 45), ("warp_gradient_scene", 37, 45)])
def test_segmented_kernels_match_the_tape_kernel(cuda, name, h, w):
    """K6/K7 (chunks of 2 trips) against trace_bwd under the same cotangent
    and target in both modes, on the straight, march, VM and shapes builds,
    and at 37 x 45, ragged against K6's 32 x 8 blocks (straight) and its
    8 x 32 blocks (the march build) on both axes: the same device code,
    each kernel contracted into FMAs by nvcc on its own outside the shapes
    builds (-fmad=false), so within 1e-4 relative (the march build moved
    the camera's gradient by 1.4e-5 of its magnitude on the H100)."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on(name, cuda)
    tm = 0.3 if name == "expr_gradient_scene" else 0.0
    g = cotangent((h, w, 3), 5, cuda)
    s0 = cuda_bwd.SEG_LAUNCHES
    tape = cuda_bwd.vjp_cuda(static, tables, cam, h, w, g, tm,
                             backward="tape")
    seg = cuda_bwd.vjp_cuda(static, tables, cam, h, w, g, tm,
                            backward="segmented", chunk_trips=2)
    assert cuda_bwd.SEG_LAUNCHES == s0 + 1
    grads_close(tape[:2], seg[:2], rtol=1e-4)
    assert abs(float(tape[2]) - float(seg[2])) <= 1e-4 * max(
        abs(float(tape[2])), 1.0)
    target = cotangent((h, w, 3), 6, cuda).sigmoid()
    lt, *tape = cuda_bwd.train_step_cuda(static, tables, cam, target, h, w,
                                         tm, backward="tape")
    ls, *seg = cuda_bwd.train_step_cuda(static, tables, cam, target, h, w,
                                        tm, backward="segmented",
                                        chunk_trips=2)
    assert abs(float(ls) - float(lt)) <= 1e-5 * float(lt)
    grads_close(tape[:2], seg[:2], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_trips", [16, 21])
def test_segmented_kernels_match_the_tape_kernel_in_long_chunks(cuda,
                                                                chunk_trips):
    """K6/K7 on config2 at chunk_trips 16 (the default: its 62 trips in
    chunks of 16, 16, 16 and 14) and 21 (21, 21 and 20) against trace_bwd
    under the same cotangent, within chip_smoke.py's 1e-5 relative."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on("config2_mirror_glass", cuda)
    g = cotangent((BH, BW, 3), 7, cuda)
    tape = cuda_bwd.vjp_cuda(static, tables, cam, BH, BW, g, backward="tape")
    seg = cuda_bwd.vjp_cuda(static, tables, cam, BH, BW, g,
                            backward="segmented", chunk_trips=chunk_trips)
    grads_close(tape[:2], seg[:2], rtol=1e-5)


@pytest.mark.cuda
def test_segmented_kernels_are_deterministic(cuda):
    """Two launches of K6/K7 on config2 at 180 x 320, vjp and fused, give
    bit-identical gradients and loss (the tape kernel's fixed-order sums;
    config2 has no texture and no entry past MAX_PARAMS)."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on("config2_mirror_glass", cuda)
    h, w = 180, 320
    g = cotangent((h, w, 3), 13, cuda)
    target = cotangent((h, w, 3), 14, cuda).sigmoid()
    a, b = (flat_grads(*cuda_bwd.vjp_cuda(static, tables, cam, h, w, g,
                                          backward="segmented"))
            for _ in range(2))
    assert torch.equal(a, b)
    (la, *ga), (lb, *gb) = (cuda_bwd.train_step_cuda(
        static, tables, cam, target, h, w, backward="segmented")
        for _ in range(2))
    assert torch.equal(la, lb)
    assert torch.equal(flat_grads(*ga), flat_grads(*gb))


@pytest.mark.cuda
def test_deep_scene_takes_the_segmented_kernels(cuda):
    """A tree past the tape's 63 nodes (config2 at max_depth 8, max_nodes
    255, a smooth floor): vjp_cuda's 'auto' launches K6/K7 and not
    trace_bwd, and agrees with the plain backward; the tape refuses it."""
    from euclider_tpu_torch.ops import cuda_bwd, vjp
    static, tables, cam = scene_on("config2_deep_smooth", cuda)
    g = off_seams(cotangent((BH, BW, 3), 7, cuda), static, tables, cam)
    b0, s0 = cuda_bwd.LAUNCHES, cuda_bwd.SEG_LAUNCHES
    got = cuda_bwd.vjp_cuda(static, tables, cam, BH, BW, g)
    torch.cuda.synchronize()
    assert (cuda_bwd.LAUNCHES, cuda_bwd.SEG_LAUNCHES) == (b0, s0 + 1)
    grads_close(vjp.vjp_blocked(static, tables, cam, BH, BW, g), got)
    with pytest.raises(ValueError, match="tape kernel"):
        cuda_bwd.vjp_cuda(static, tables, cam, BH, BW, g, backward="tape")


@pytest.mark.cuda
def test_render_image_diff_routes_a_deep_scene(cuda):
    """autograd through render_image_diff on the deep scene runs the forward
    kernel and K6/K7, and gives vjp_cuda's gradients."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on("config2_deep_smooth", cuda)
    g = cotangent((BH, BW, 3), 8, cuda)
    leaves = [getattr(tables, k).clone().requires_grad_(True)
              for k in cuda_kernel.FLOAT_FIELDS]
    f0, s0 = cuda_kernel.LAUNCHES, cuda_bwd.SEG_LAUNCHES
    img = cuda_bwd.render_image_diff(
        static, tables._replace(**dict(zip(cuda_kernel.FLOAT_FIELDS, leaves))),
        cam, BH, BW)
    grads = torch.autograd.grad(img, leaves, g)
    assert (cuda_kernel.LAUNCHES, cuda_bwd.SEG_LAUNCHES) == (f0 + 1, s0 + 1)
    ref = cuda_bwd.vjp_cuda(static, tables, cam, BH, BW, g)
    for k, got in zip(cuda_kernel.FLOAT_FIELDS, grads):
        a = getattr(ref[0], k)
        assert float((a - got).abs().max()) <= 1e-6 * max(
            float(a.abs().max()), 1.0)


@pytest.mark.cuda
def test_kernels_past_the_entity_and_parameter_caps(cuda):
    """48 entities and 797 parameters (spheres48): the forward kernel
    against the plain render, vjp_cuda against the plain backward (the
    entries from the 160th on summed by atomics) and the fused step against
    the forward kernel + MSE + vjp_cuda."""
    from euclider_tpu_torch.ops import cuda_bwd, vjp
    static, tables, cam = scene_on("spheres48", cuda)
    assert len(static.entities) == 48
    got = cuda_kernel.render_image_cuda(static, tables, cam, BH, BW)
    ref = trace.render_image(static, tables, cam, BH, BW)
    assert float(((got - ref).abs().amax(-1) > 1e-4).float().mean()) <= 1e-3
    g = off_seams(cotangent((BH, BW, 3), 9, cuda), static, tables, cam)
    grads_close(vjp.vjp_blocked(static, tables, cam, BH, BW, g),
                cuda_bwd.vjp_cuda(static, tables, cam, BH, BW, g))
    target = cotangent((BH, BW, 3), 10, cuda).sigmoid()
    loss, gt, gc, _ = cuda_bwd.train_step_cuda(static, tables, cam, target,
                                               BH, BW)
    ref_loss = torch.mean((got - target) ** 2)
    ref = cuda_bwd.vjp_cuda(static, tables, cam, BH, BW,
                            2.0 * (got - target) / got.numel())
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * float(ref_loss)
    grads_close(ref[:2], (gt, gc))


MOSAIC_CASES = {   # tools/mosaic_probe.py's seeds, scales and w
    "ckpt": (0, 1, 1.0, 0.7), "nested": (3, 4, 0.3, 0.9),
    "gated": (5, 6, 0.3, 0.8), "gated_dead": (5, 6, 0.3, 0.8)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ckpt", "ckpt_1000", "cond+1", "cond-1",
                                  "cond+1_1000", "cond-1_1000", "cond+1_1",
                                  "cond-1_1", "nested", "nested_1000",
                                  "gated", "gated_dead", "gated_1000",
                                  "gated_dead_1000"])
def test_mosaic_probe_kernels_match_plain(cuda, case):
    """csrc/probe_mosaic.cu's kernels against the plain versions on the
    mosaic tool's tiles: within 1e-5 relative (P3 1e-6), one launch each;
    P3 in both branches, also on the tile's first 1000 elements and on one
    element alone, P5 also on a dead tile; P2, P4 and P5 (P5 live and
    dead) also on the tile's first 1000 elements (their cluster's last
    block part empty); every probe's second launch gives the same bits
    (P3's branch and P2's, P4's and P5's dw summed in a fixed order)."""
    head, _, tail = case.rpartition("_")
    n = int(tail) if head and tail.isdigit() else None
    case = head if n is not None else case
    from euclider_tpu_torch.ops import probes as P
    if case.startswith("cond"):
        shift = 1.0 if case == "cond+1" else -1.0
        x = cotangent((8, 128), 2, cuda) + shift
        g = cotangent((8, 128), 3, cuda)
        if n is not None:
            x, g = x.reshape(-1)[:n], g.reshape(-1)[:n]
        name, w, extra = "probe_cond", None, ()
        fn = lambda x, w, g: P.cond_vjp(x, g)  # noqa: E731
        ref = P.cond_plain(x, g)
        before = P.MOSAIC_LAUNCHES[name]
        got = fn(x, w, g)
        rtol = 1e-6
    else:
        sx, sg, scale, w = MOSAIC_CASES[case]
        x = cotangent((8, 128), sx, cuda) * scale
        g = cotangent((8, 128), sg, cuda)
        if n is not None:
            x, g = x.reshape(-1)[:n], g.reshape(-1)[:n]
        act = torch.zeros_like(x) if case == "gated_dead" else None
        name, fn, plain = {
            "ckpt": ("probe_ckpt", P.ckpt_scratch_vjp, P.ckpt_scratch_plain),
            "nested": ("probe_nested", P.nested_march_vjp,
                       P.nested_march_plain),
            "gated": ("probe_gated", P.gated_march_vjp, P.gated_march_plain),
            "gated_dead": ("probe_gated", P.gated_march_vjp,
                           P.gated_march_plain)}[case]
        extra = () if act is None else (act,)
        ref = plain(x, w, g, *extra)
        before = P.MOSAIC_LAUNCHES[name]
        got = fn(x, w, g, *extra)
        rtol = 1e-5
    torch.cuda.synchronize()
    assert P.MOSAIC_LAUNCHES[name] == before + 1
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= rtol * max(
            float(b.abs().max()), 1e-30), (case, a, b)
    again = fn(x, w, g, *extra)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# units in the last place by which a probe's dx may differ from the plain
# version's on the live tile, and on how many of its 1024 elements:
# measured on the H100, the same for the first designs' two trips summed
# (P4 62 elements, up to 3 units; P5 9 elements, up to 2)
DX_ULPS = {"nested": (3, 62), "gated": (2, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nested", "gated", "gated_dead"])
def test_probe_dx_is_one_trip_doubled(cuda, case):
    """P4 and P5 run one trip of their outer VJP and double it (every trip
    has the same inputs): the dx of each is the plain version's, one trip
    of autograd doubled, to the bit on P5's dead tile; on the live tiles to
    the bit but where PyTorch's own backward kernels round otherwise, by
    at most the units in the last place measured (DX_ULPS), and no
    further."""
    from euclider_tpu_torch.ops import probes as P
    sx, sg, scale, w = MOSAIC_CASES[case]
    x = cotangent((8, 128), sx, cuda) * scale
    g = cotangent((8, 128), sg, cuda)
    if case == "nested":
        dx, _ = P.nested_march_cuda(x, w, g)
        pdx, _ = P.nested_march_plain(x, w, g)
    else:
        act = torch.zeros_like(x) if case == "gated_dead" else None
        dx, _ = P.gated_march_cuda(x, w, g, act)
        pdx, _ = P.gated_march_plain(x, w, g, act)
    if case == "gated_dead":
        assert torch.equal(dx, pdx), float((dx - pdx).abs().max())
    else:
        assert bool((torch.sign(dx) == torch.sign(pdx)).all())
        ulps = (dx.view(torch.int32) - pdx.view(torch.int32)).abs()
        most, count = DX_ULPS[case]
        assert int(ulps.max()) <= most and int((ulps > 0).sum()) <= count, \
            (case, int(ulps.max()), int((ulps > 0).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["ckpt", "nested", "gated", "rev"])
def test_cluster_probe_kernels_refuse_more_than_a_cluster(cuda, probe):
    """P2, P4, P5 and P6 on 1025 elements, one more than a cluster holds:
    a ValueError before any launch, no other launch shape."""
    from euclider_tpu_torch.ops import probes as P
    x = torch.zeros(P.MAX_LANES + 1, device=cuda)
    before = (dict(P.MOSAIC_LAUNCHES), P.LAUNCHES)
    call = {"ckpt": lambda: P.ckpt_scratch_cuda(x, 0.7, x),
            "nested": lambda: P.nested_march_cuda(x, 0.9, x),
            "gated": lambda: P.gated_march_cuda(x, 0.8, x),
            "rev": lambda: P.rev_march_cuda(x, 1.1, x)}[probe]
    with pytest.raises(ValueError, match="one cluster"):
        call()
    assert (dict(P.MOSAIC_LAUNCHES), P.LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("tile", ["tool", "crossing"])
@pytest.mark.parametrize("stage", ["fwd", "vjp", "finish", "loop"])
def test_march_probe_kernel_matches_plain(cuda, stage, tile):
    """csrc/probe_march.cu against march_probe_plain on the tool's and the
    crossing tile: every lane whose march agrees within
    1e-5 * max(max |ref|, 1), at most 1% of lanes marching otherwise, one
    launch; vjp (K4's rebuild) against finish (a stored tape) within 1e-5
    relative."""
    from euclider_tpu_torch.ops import march_probe as MP
    static, tables = MP.probe_scene(cuda)
    org, d = MP.tool_tile(cuda) if tile == "tool" else MP.crossing_tile(cuda)
    before = MP.LAUNCHES
    got = MP.march_probe(static, tables, org, d, stage)
    ref = MP.march_probe_plain(static, tables, org, d, stage)
    torch.cuda.synchronize()
    assert MP.LAUNCHES == before + 1
    res = MP.compare(ref, got)
    assert MP.passes(res, got.out.numel()), res
    if stage == "vjp":
        tape = MP.march_probe(static, tables, org, d, "finish")
        assert float((got.out - tape.out).abs().max()) <= 1e-5 * float(
            tape.out.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["vjp", "finish", "loop"])
def test_march_probe_kernel_sums_the_tile_in_a_fixed_order(cuda, stage):
    """P1's cluster on the crossing tile: two launches give the same bits
    (output and sum(d shape_vec)); every lane added the same sum, which is
    the lanes' shares summed in march_probe.tile_sum's order to the bit;
    a ragged launch of 300 lanes (3 blocks, the last one part empty)
    agrees with the plain version on them."""
    from euclider_tpu_torch.ops import march_probe as MP
    static, tables = MP.probe_scene(cuda)
    org, d = MP.crossing_tile(cuda)
    n = org.numel() // 4
    checks = [torch.empty(2 * n, device=cuda) for _ in range(2)]
    a, b = (MP.march_probe_cuda(static, tables, org, d, stage, check=c)
            for c in checks)
    torch.cuda.synchronize()
    assert torch.equal(a.out, b.out) and torch.equal(a.dsv, b.dsv)
    assert torch.equal(checks[0], checks[1])
    assert bool((checks[0][n:] == a.dsv).all())
    assert torch.equal(MP.tile_sum(checks[0][:n]), a.dsv.cpu())
    o3, d3 = (t.reshape(-1, 4)[:300] for t in (org, d))
    got = MP.march_probe_cuda(static, tables, o3, d3, stage)
    res = MP.compare(MP.march_probe_plain(static, tables, o3, d3, stage), got)
    assert MP.passes(res, 300), res


@pytest.mark.cuda
def test_march_probe_kernel_refuses_more_than_a_cluster(cuda):
    """More lanes than one cluster holds raise before any launch."""
    from euclider_tpu_torch.ops import march_probe as MP
    static, tables = MP.probe_scene(cuda)
    org = torch.zeros((MP.MAX_LANES + 1, 4), device=cuda)
    before = MP.LAUNCHES
    with pytest.raises(ValueError, match="lanes"):
        MP.march_probe_cuda(static, tables, org, org, "fwd")
    assert MP.LAUNCHES == before


def test_probe_wrappers_refuse_cpu_tensors():
    """probe_mosaic's and probe_march's wrappers raise on CPU tensors
    before any launch."""
    from euclider_tpu_torch.ops import march_probe as MP
    from euclider_tpu_torch.ops import probes as P
    x = torch.zeros((8, 128))
    before = (dict(P.MOSAIC_LAUNCHES), MP.LAUNCHES)
    for call in (lambda: P.ckpt_scratch_cuda(x, 0.7, x),
                 lambda: P.cond_cuda(x, x),
                 lambda: P.nested_march_cuda(x, 0.9, x),
                 lambda: P.gated_march_cuda(x, 0.8, x)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    static, tables = MP.probe_scene()
    org, d = MP.tool_tile()
    with pytest.raises(ValueError, match="CUDA"):
        MP.march_probe_cuda(static, tables, org, d, "fwd")
    with pytest.raises(ValueError, match="CUDA"):
        MP.empty_cuda("cpu")
    assert (dict(P.MOSAIC_LAUNCHES), MP.LAUNCHES) == before


def test_probe_rev_kernel_refuses_cpu_tensors():
    from euclider_tpu_torch.ops import probes
    before = probes.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        probes.rev_march_cuda(torch.zeros(8, 128), 1.1, torch.zeros(8, 128))
    assert probes.LAUNCHES == before


@pytest.mark.parametrize("n", [0, 1025])
def test_cluster_probe_wrappers_refuse_what_a_cluster_does_not_hold(n):
    """P5's and P6's wrappers refuse an empty tile and one of more than
    MAX_LANES elements before anything else, so before any launch."""
    from euclider_tpu_torch.ops import probes as P
    x = torch.zeros(n)
    before = (dict(P.MOSAIC_LAUNCHES), P.LAUNCHES)
    for call in (lambda: P.gated_march_cuda(x, 0.8, x),
                 lambda: P.rev_march_cuda(x, 1.1, x)):
        with pytest.raises(ValueError, match="one cluster"):
            call()
    assert (dict(P.MOSAIC_LAUNCHES), P.LAUNCHES) == before


@pytest.mark.parametrize("n", [0, 1025])
@pytest.mark.parametrize("probe", ["ckpt", "nested", "cond"])
def test_mosaic_cluster_wrappers_refuse_what_a_cluster_does_not_hold(probe,
                                                                     n):
    """P2's and P4's wrappers, one cluster each like P5's, and P3's, one
    block of up to MAX_LANES threads, refuse an empty tile and one of more
    than MAX_LANES elements before they look at the device, so before any
    launch and with no other launch shape."""
    from euclider_tpu_torch.ops import probes as P
    x = torch.zeros(n)
    before = dict(P.MOSAIC_LAUNCHES)
    call = {"ckpt": lambda: P.ckpt_scratch_cuda(x, 0.7, x),
            "nested": lambda: P.nested_march_cuda(x, 0.9, x),
            "cond": lambda: P.cond_cuda(x, x)}[probe]
    with pytest.raises(ValueError,
                       match="one block" if probe == "cond" else "one cluster"):
        call()
    assert dict(P.MOSAIC_LAUNCHES) == before


@pytest.mark.cuda
def test_viewer_frame_loop_is_the_kernel(cuda):
    """viewer/simulation.py on the card, config1 at 64x128: a scripted run
    of 6 frames launches trace_fwd once a frame without synchronising the
    device (torch's sync debug mode), step(i) returns frame i - 1, and the
    flushed frame is render_image_cuda's at the final camera to the bit."""
    import warnings

    import numpy as np
    from euclider_tpu_torch.viewer.simulation import Simulation
    sim = Simulation(ett.get_scene("config1_sphere_room"), 64, 128,
                     backend="cuda", device=cuda)
    first = sim.step(0).copy()
    assert np.array_equal(sim.step(1), first)

    def script(s, i):
        s.handle_keys("wl" if i % 2 else "i")
    before = cuda_kernel.LAUNCHES
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            last = sim.run(6, script)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert cuda_kernel.LAUNCHES == before + 6
    assert not [w for w in caught
                if "called a synchronizing" in str(w.message)]
    ref = cuda_kernel.render_image_cuda(
        sim.static, sim.tables, ett.camera_to_torch(sim.cam, cuda), 64, 128)
    assert np.array_equal(last, ref.cpu().numpy())
    assert np.abs(last - first).max() > 1e-3


def test_backward_wrappers_refuse_cpu_tensors():
    from euclider_tpu_torch.ops import cuda_bwd
    sc = ett.get_scene("grad_probe")
    static, tables = ett.compile_scene(sc)
    tables = ett.tables_to_torch(tables, "cpu")
    cam = ett.camera_to_torch(ett.compile_camera(sc.camera), "cpu")
    before = cuda_bwd.LAUNCHES
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_bwd.vjp_cuda(static, tables, cam, 8, 16, torch.zeros(8, 16, 3))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_bwd.train_step_cuda(static, tables, cam, torch.zeros(8, 16, 3),
                                 8, 16)
    assert cuda_bwd.LAUNCHES == before


@pytest.mark.cuda
def test_sharded_path_at_world_size_one_over_nccl(cuda):
    """parallel/ and train/inverse.py's mesh on a process group of one rank
    over NCCL: the sharded render and gather, and the sharded fused and
    unfused value and grad, are their unsharded counterparts' bits."""
    import socket

    import torch.distributed as dist

    from euclider_tpu_torch.ops import cuda_bwd
    from euclider_tpu_torch.parallel import distributed as D
    from euclider_tpu_torch.parallel.mesh import (gather_frame, make_mesh,
                                                  render_image_sharded)
    from euclider_tpu_torch.train.inverse import (InverseParams,
                                                  make_fused_value_and_grad,
                                                  shard_target)
    from euclider_tpu_torch.utils.tree import leaves, unflatten
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert D.initialize("cuda", f"tcp://127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh()
        static, tables, cam = scene_on("grad_probe", cuda)
        params = InverseParams(tables, cam)
        target = cotangent((BH, BW, 3), 1, cuda).sigmoid()
        ref = cuda_kernel.render_image_cuda(static, tables, cam, BH, BW)
        slab = render_image_sharded(static, tables, cam, BH, BW, mesh)
        assert torch.equal(slab, ref) and torch.equal(
            gather_frame(slab, mesh), ref)
        loss, gt, gc, _ = cuda_bwd.train_step_cuda(static, tables, cam,
                                                   target, BH, BW)
        got = make_fused_value_and_grad(static, BH, BW, "cuda-fused", mesh)(
            params, shard_target(target, mesh))
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves(got), leaves((loss, (gt, gc)))))
        xs = [t.clone().requires_grad_(True) for t in leaves(params)]
        p = unflatten(params, xs)
        ref_loss = torch.mean((cuda_bwd.render_image_diff(
            static, p.tables, p.cam, BH, BW) - target) ** 2)
        ref_g = torch.autograd.grad(ref_loss, xs, allow_unused=True)
        got = make_fused_value_and_grad(static, BH, BW, "cuda", mesh)(
            params, shard_target(target, mesh))
        assert torch.equal(got[0], ref_loss.detach())
        assert all(torch.equal(a, torch.zeros_like(x) if b is None else b)
                   for a, x, b in zip(leaves(got[1]), xs, ref_g))
    finally:
        dist.destroy_process_group()


# --- float64 inputs, cast to float32 as the Pallas kernels cast them ------

FH, FW = 720, 1280         # chip_smoke.py's frame
DTYPE_SCENES = ["grad_probe", "config3_csg_textured"]


def as_float64(tables, cam):
    """The tables (textures too) and the camera cast to float64."""
    return (tables._replace(**{k: v.double() for k, v in tables._asdict()
                               .items() if k != "textures"},
                            textures=tuple(t.double()
                                           for t in tables.textures)),
            type(cam)(*(v.double() for v in cam)))


def assert_float32_run(got, ref, static, tables):
    """Gradient leaves of float64 primals (got) against the float32 run's
    (ref): float64, the same bits but for the texels', which the kernels
    sum by atomicAdd in no fixed order (held to the 1e-3 * max(max |ref|,
    1) rule); the scene has no entry from MAX_PARAMS (160) on, the other
    sums by atomics."""
    from euclider_tpu_torch.ops import cuda_bwd
    floats = cuda_kernel._check_tables(static, tables, tables.surf_color
                                       .device)
    assert cuda_bwd.grad_layout(static, floats)[1] <= 160
    n_tex = len(tables.textures)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == torch.float64 and b.dtype == torch.float32
        assert a.shape == b.shape
        if n_tex and len(cuda_kernel.FLOAT_FIELDS) <= i < len(
                cuda_kernel.FLOAT_FIELDS) + n_tex:
            tol = 1e-3 * max(float(b.abs().max()), 1.0)
            assert float((a - b.double()).abs().max()) <= tol
        else:
            assert torch.equal(a, b.double()), i


def grad_leaves(d_tables, d_cam, d_time=None):
    return ([getattr(d_tables, k) for k in cuda_kernel.FLOAT_FIELDS]
            + list(d_tables.textures) + list(d_cam)
            + ([d_time.reshape(1)] if d_time is not None else []))


@pytest.mark.cuda
@pytest.mark.parametrize("name", DTYPE_SCENES)
def test_float64_tables_render_the_float32_bits(cuda, name):
    """float64 tables and camera through render_image_cuda (and the
    top-level render_image) at 1280x720: the float32 run's frame to the
    bit, in float32; a float64 camera with float32 tables: the float32
    camera's frame."""
    static, tables, cam = scene_on(name, cuda)
    t64, c64 = as_float64(tables, cam)
    ref = cuda_kernel.render_image_cuda(static, tables, cam, FH, FW)
    before = cuda_kernel.LAUNCHES
    got = cuda_kernel.render_image_cuda(static, t64, c64, FH, FW)
    top = ett.render_image(static, t64, c64, FH, FW)
    mixed = cuda_kernel.render_image_cuda(static, tables, c64, FH, FW)
    assert cuda_kernel.LAUNCHES == before + 3
    for img in (got, top, mixed):
        assert img.dtype == torch.float32 and torch.equal(img, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", DTYPE_SCENES)
def test_float64_gradients_are_the_float32_run(cuda, name):
    """vjp_cuda and train_step_cuda of float64 tables, camera and time at
    1280x720: every gradient in float64, the float32 run's values
    (assert_float32_run), the loss float32 and the same."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on(name, cuda)
    t64, c64 = as_float64(tables, cam)
    time64 = torch.tensor(0.0, dtype=torch.float64, device=cuda)
    g = cotangent((FH, FW, 3), 5, cuda)
    ref = cuda_bwd.vjp_cuda(static, tables, cam, FH, FW, g)
    got = cuda_bwd.vjp_cuda(static, t64, c64, FH, FW, g, time=time64)
    assert_float32_run(grad_leaves(*got), grad_leaves(*ref), static, tables)
    target = cotangent((FH, FW, 3), 6, cuda).sigmoid()
    ref = cuda_bwd.train_step_cuda(static, tables, cam, target, FH, FW)
    got = cuda_bwd.train_step_cuda(static, t64, c64, target.double(), FH, FW,
                                   time=time64)
    assert got[0].dtype == torch.float32 and torch.equal(got[0], ref[0])
    assert_float32_run(grad_leaves(*got[1:]), grad_leaves(*ref[1:]), static,
                       tables)


@pytest.mark.cuda
@pytest.mark.parametrize("name", DTYPE_SCENES)
def test_render_image_diff_hands_float64_leaves_float64_gradients(cuda,
                                                                  name):
    """autograd through render_image_diff of float64 leaves (tables,
    textures, camera) at 1280x720: a float32 frame, the float32 run's
    bits, and each leaf's gradient in float64 with the float32 leaves'
    values."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = scene_on(name, cuda)
    g = cotangent((FH, FW, 3), 8, cuda)
    runs = []
    for t, c in ((tables, cam), as_float64(tables, cam)):
        tl = [getattr(t, k).clone().requires_grad_(True)
              for k in cuda_kernel.FLOAT_FIELDS]
        texs = [x.clone().requires_grad_(True) for x in t.textures]
        cl = [v.clone().requires_grad_(True) for v in c]
        img = cuda_bwd.render_image_diff(
            static, t._replace(**dict(zip(cuda_kernel.FLOAT_FIELDS, tl)),
                               textures=tuple(texs)), type(c)(*cl), FH, FW)
        assert img.dtype == torch.float32
        grads = torch.autograd.grad(img, tl + texs + cl, g,
                                    allow_unused=True)
        runs.append((img, [torch.zeros_like(x) if d is None else d
                           for x, d in zip(tl + texs + cl, grads)]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert_float32_run(runs[1][1], runs[0][1], static, tables)
