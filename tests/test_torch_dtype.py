"""The CUDA kernels' wrappers take every input the Pallas kernels take:
tables, textures and cameras of any floating dtype, cast to float32 as
``euclider_tpu/ops/pallas_kernel.py`` casts them (``_pack_camera``,
``_table_views``), with the gradients handed back in the primals' dtypes
(``_grads_from_rows``).  Run on the CPU with no kernel launched: the
camera row, the tables the kernels read and the gradients cut from their
flat vector, each against the JAX package's own function on the same
numpy inputs where it has one; the JAX side renders nothing.
"""
import numpy as np
import pytest
import torch

import euclider_tpu_torch as ett
from euclider_tpu.ops import pallas_kernel as PK
from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel
from euclider_tpu_torch.ops.cuda_kernel import FLOAT_FIELDS

CPU = torch.device("cpu")
# the JAX kernel's 15 fixed views (pallas_kernel._table_views), in order
VIEWS = ("shape_vec", "shape_sc", "mat_ior", "mat_warp_center",
         "mat_warp_strength", "mat_warp_step", "mat_expr_params",
         "surf_color", "surf_color2", "surf_refl", "surf_fresnel",
         "surf_uv_scale", "portal_lin", "portal_tr", "background")


def bits(a):
    """A float32 array's bits, so that -0.0 and 0.0 differ."""
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def inputs(compiled_scenes, name, dtype):
    """The JAX package's compiled scene: (static, numpy tables and camera
    cast to ``dtype``, the port's torch tables and camera in it)."""
    _, static, tables, cam = compiled_scenes[name]
    tables = ett.cast_tables(tables, dtype)
    cam = ett.cast_camera(cam, dtype)
    tdtype = {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    return (static, tables, cam, ett.tables_to_torch(tables, CPU, tdtype),
            ett.camera_to_torch(cam, CPU, tdtype))


@pytest.mark.parametrize("name", ["grad_probe", "config4_hypersphere",
                                  "config6_expr_space"])
def test_pack_camera_casts_every_field(compiled_scenes, name):
    """A float64 camera packs to the float32 camera's row, bit for bit,
    and to pallas_kernel._pack_camera's row of the same numpy camera; so
    does a float64 tensor time.  (Before the cast, a float64 camera made
    a float64 row, whose bytes the kernels read as 24 floats.)"""
    _, _, cam, _, c64 = inputs(compiled_scenes, name, np.float64)
    c32 = ett.camera_to_torch(ett.cast_camera(cam, np.float32), CPU)
    for time in (0.3, torch.tensor(0.3, dtype=torch.float64)):
        row = cuda_kernel._pack_camera(c64, time, 5, CPU)
        assert row.dtype == torch.float32 and row.shape == (24,)
        assert row.is_contiguous()
        ref = cuda_kernel._pack_camera(c32, 0.3, 5, CPU)
        assert np.array_equal(bits(row.numpy()), bits(ref.numpy()))
        jax_row = np.asarray(PK._pack_camera(cam, 0.3, 5.0)).reshape(24)
        assert np.array_equal(bits(row.numpy()), bits(jax_row))
        assert cuda_kernel.camera_ptr(row) == row.data_ptr()


def test_camera_ptr_refuses_a_row_the_kernels_would_misread():
    """The launch sites take the row's address only for 24 contiguous
    float32: a float64 row (the old fault) raises instead."""
    row = torch.zeros(24, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        cuda_kernel.camera_ptr(row)
    with pytest.raises(TypeError, match="float32"):
        cuda_kernel.camera_ptr(torch.zeros(48)[::2])


@pytest.mark.parametrize("name", ["config3_csg_textured",
                                  "config5_warp_portal",
                                  "config6_expr_space"])
def test_check_tables_casts_as_the_pallas_kernel(compiled_scenes, name):
    """_check_tables of float64 tables and textures: float32 tensors, the
    bits of each table cast, and of the JAX kernel's 15 fixed views of the
    same numpy tables (reshaped); the texel buffer the textures cast,
    back to back (the JAX kernel's packed textures, laid out again)."""
    static, tables, _, t64, _ = inputs(compiled_scenes, name, np.float64)
    floats = cuda_kernel._check_tables(static, t64, CPU)
    assert len(floats) == len(FLOAT_FIELDS) + 1
    assert all(f.dtype == torch.float32 and f.is_contiguous()
               for f in floats)
    got = dict(zip(FLOAT_FIELDS, floats))
    for k in FLOAT_FIELDS:
        assert torch.equal(got[k], getattr(t64, k).to(torch.float32)), k
    views = PK._table_views(tables)
    assert len(views) == PK.N_FIXED_VIEWS + len(tables.textures)
    for k, v in zip(VIEWS, views):
        assert np.array_equal(bits(got[k].numpy().reshape(-1)),
                              bits(np.asarray(v).reshape(-1))), k
    texels = [np.stack([np.asarray(v)[c * t.shape[1]:(c + 1) * t.shape[1]].T
                        for c in range(3)], -1)
              for v, t in zip(views[PK.N_FIXED_VIEWS:], tables.textures)]
    ref = np.concatenate([t.reshape(-1) for t in texels] + [np.zeros(
        0 if texels else 1, np.float32)])
    assert np.array_equal(bits(floats[-1].numpy()), bits(ref))


def random_flat(static, floats, seed):
    """A seeded flat gradient vector and texel gradient in the kernels'
    layout (cuda_bwd.grad_layout)."""
    rng = np.random.default_rng(seed)
    _, n = cuda_bwd.grad_layout(static, floats)
    flat = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    gtex = torch.from_numpy(rng.normal(size=floats[-1].numel()).astype(
        np.float32))
    return flat, gtex


@pytest.mark.parametrize("name", ["config3_csg_textured",
                                  "config5_warp_portal",
                                  "config6_expr_space"])
def test_grads_come_back_in_the_primals_dtypes(compiled_scenes, name):
    """cuda_bwd._grads of float64 primals: every table's, texture's and
    camera field's gradient, and a float64 tensor time's, in float64 with
    the float32 vector's values, which float32 primals get as they are;
    the loss stays float32 (pallas_kernel._grads_from_rows)."""
    static, _, _, t64, c64 = inputs(compiled_scenes, name, np.float64)
    _, _, _, t32, c32 = inputs(compiled_scenes, name, np.float32)
    floats = cuda_kernel._check_tables(static, t64, CPU)
    flat, gtex = random_flat(static, floats, 7)
    time64 = torch.tensor(0.3, dtype=torch.float64)
    g64 = cuda_bwd._grads(static, t64, c64, time64, flat, gtex, floats)
    g32 = cuda_bwd._grads(static, t32, c32, 0.3, flat, gtex, floats)
    for d64, d32 in zip(leaves(*g64[:3]), leaves(*g32[:3])):
        assert d64.dtype == torch.float64 and d32.dtype == torch.float32
        assert d64.shape == d32.shape
        assert torch.equal(d64, d32.double())
    assert g64[3].dtype == g32[3].dtype == torch.float32
    assert float(g64[3]) == float(flat[-1])
    # mixed: float64 tables with a float32 camera and a float time
    mixed = cuda_bwd._grads(static, t64, c32, 0.3, flat, gtex, floats)
    assert all(d.dtype == torch.float64 for d in leaves(mixed[0]))
    assert all(d.dtype == torch.float32 for d in mixed[1])
    assert mixed[2].dtype == torch.float32


def leaves(d_tables, d_cam=(), d_time=None):
    out = [getattr(d_tables, k) for k in FLOAT_FIELDS]
    out += list(d_tables.textures) + list(d_cam)
    return out + ([d_time.reshape(1)] if d_time is not None else [])


def test_the_cast_is_part_of_the_autograd_graph(compiled_scenes):
    """What render_image_diff hands RenderImageFn: the float32 tables and
    camera row, cast by differentiable ops, so that autograd maps a
    cotangent of them back to float64 leaves in float64."""
    static, _, _, t64, c64 = inputs(compiled_scenes, "config3_csg_textured",
                                    np.float64)
    tl = [getattr(t64, k).clone().requires_grad_(True) for k in FLOAT_FIELDS]
    texs = [t.clone().requires_grad_(True) for t in t64.textures]
    cl = [v.clone().requires_grad_(True) for v in c64]
    tables = t64._replace(**dict(zip(FLOAT_FIELDS, tl)), textures=tuple(texs))
    floats = cuda_kernel._check_tables(static, tables, CPU)
    row = cuda_kernel._pack_camera(type(c64)(*cl), 0.0, 0, CPU)
    outs = floats + [row]
    cot = [torch.full_like(o, 0.5) for o in outs]
    grads = torch.autograd.grad(outs, tl + texs + cl, cot, allow_unused=True)
    for leaf, g in zip(tl + texs + cl, grads):
        assert g is not None and g.dtype == torch.float64
        assert g.shape == leaf.shape
        assert bool((g == 0.5).all())


def test_an_int_table_still_raises(compiled_scenes):
    """The cast takes floating dtypes only: an int table, an int texture
    or a table on another device raises ValueError before any launch."""
    static, _, _, t32, _ = inputs(compiled_scenes, "config3_csg_textured",
                                  np.float32)
    bad = t32._replace(shape_sc=t32.shape_sc.to(torch.int32))
    with pytest.raises(ValueError, match="shape_sc"):
        cuda_kernel._check_tables(static, bad, CPU)
    bad = t32._replace(textures=(t32.textures[0].to(torch.int64),))
    with pytest.raises(ValueError, match="texture 0"):
        cuda_kernel._check_tables(static, bad, CPU)
    bad = t32._replace(mat_ior=t32.mat_ior.to("meta"))
    with pytest.raises(ValueError, match="mat_ior"):
        cuda_kernel._check_tables(static, bad, CPU)


def test_only_the_int32_texel_buffer_limits_the_textures():
    """No texture side is refused: a strip of 40,961 texels takes the
    buffer whole; textures of 2^31 floats or more together (meta tensors,
    nothing allocated) raise, as the kernels index them with int32."""
    from types import SimpleNamespace
    wide = torch.rand(2, 40961, 3, dtype=torch.float64)
    buf = cuda_kernel.texel_buffer(SimpleNamespace(textures=(wide,)), CPU)
    assert buf.dtype == torch.float32
    assert torch.equal(buf, wide.reshape(-1).float())
    big = torch.empty((2 ** 15, 2 ** 14, 3), device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        cuda_kernel.texel_buffer(SimpleNamespace(textures=(big, big)), CPU)
