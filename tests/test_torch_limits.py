"""The scenes past the CUDA kernels' old fixed limits, on the CPU.

Each scene of euclider_tpu_torch/tools/limit_scenes.py passes one of the
six limits the kernels once refused (a stack of more than 16 slots, an
entity of more than 32 shape nodes, an expression of more than 128 VM
instructions, a marching scene of more than 32 entities, a march of more
than 512 steps in the backward, a texture of more than 16,384 texels on a
side); csg80 and config5_crowd72 pass 64 nodes and 64 marching entities,
past the C++ oracle's reach.  For each, on rows [8, 12) of its 32 x 24
frame (limit_scenes.SLAB):

  - the slab passes the old limit, by the plain render's own counts, and
    the kernels take a build whose capacity holds the scene (config3_strips,
    past the texture side, the default build: no capacity holds a side);
  - the port's plain trace against the JAX package's lax trace, within
    1e-5 on every pixel;
  - the kernels' device code (tools/kernel_harness.py, g++, in the build of
    the scene's capacities) against the plain version, forward and
    backward, as tests/test_torch_harness.py holds the library scenes: the
    tape route, and the segmented route for config2_d24_deep.

The lax reference is stored (``limits.slab`` in tests/jax_refs.npz,
written by tests/make_jax_refs.py): op by op it takes 10 to 145 s a scene,
and the JAX package is frozen.  Two scenes re-derive it live.  The port
traces the JAX package's own camera rays: each package's rays differ from
the other's by an ulp, which a grazing hit on csg48's knobs or a chain of 20
internal reflections in config2_d24's glass amplifies past 1e-5 (csg48:
13 of 128 pixels, up to 9.0e-5, where each casts its own rays; 6e-8 on
the same rays).  The rays themselves are held within 1e-6.
"""
import shutil

import numpy as np
import pytest
import torch

import euclider_tpu_torch as ett
from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel, trace
from euclider_tpu_torch.ops.vec import Vec
from euclider_tpu_torch.tools import kernel_harness as KH
from euclider_tpu_torch.tools import limit_scenes as LS

import jax_refs

H, W, Y0, ROWS = LS.SLAB
NAMES = tuple(LS.BUILDERS)
# the capacity each scene's limit is
CAPACITY = {"stack": "slots", "membership": "nodes", "vm": "expr",
            "side mask": "entities", "march checkpoints": "ckpts"}


def load(name):
    sc = LS.get_scene(name)
    static, tables = ett.compile_scene(sc)
    return (static, ett.tables_to_torch(tables, "cpu"),
            ett.camera_to_torch(ett.compile_camera(sc.camera), "cpu"))


@jax_refs.stored("limits.slab", NAMES)
def slab_ref(name):
    """The JAX package's camera rays of the scene's slab and its lax
    colour of them, op by op (``jax.disable_jit``: the port's tests hold
    against the op-by-op lax render, whose arithmetic is XLA's operation by
    operation): ``org`` and ``dir`` [rows, W, 4], ``rgb`` [rows, W, 3]."""
    sc = LS.get_scene(name)

    def run():
        import jax
        import jax.numpy as jnp
        import euclider_tpu as et
        from euclider_tpu.ops import trace as jtrace
        from euclider_tpu.scene import jsonio as jax_jsonio
        from euclider_tpu_torch.scene import jsonio
        jsc = jax_jsonio.scene_from_dict(jsonio.scene_to_dict(sc))
        static, tables = et.compile_scene(jsc)
        cam = et.compile_camera(jsc.camera)
        yi, xi = np.mgrid[Y0:Y0 + ROWS, 0:W].astype(np.float32)
        with jax.disable_jit():
            org, d = jtrace.camera_rays(cam, jnp.asarray(xi),
                                        jnp.asarray(yi), W, H)
            rgb = jtrace.trace_batch(static, tables, org, d)
        stack = lambda v: np.stack([np.asarray(c, np.float32) for c in v],
                                   -1)
        return {"org": stack(org), "dir": stack(d), "rgb": stack(rgb)}
    return {"scene": sc, "slab": LS.SLAB}, run


@pytest.fixture(scope="module")
def harness():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return KH


@pytest.mark.parametrize("name", NAMES)
def test_slab_passes_the_old_limit(name):
    """The slab's pixels pass the scene's old limit (a stack held more
    than 16 branches, a march ran past 512 steps, the CSG body or the
    expression region is reached, an entity past the 32nd is crossed by
    the march, a texel past the 16,384th of a side is sampled), and every
    kernel takes a build whose capacity holds the scene, encode_scene and
    route taking it as they take any other; past the texture side, every
    texture is sampled there, the default builds take the scene and
    _check_tables its texel buffer whole."""
    static, tables, cam = load(name)
    rec = LS.passed(name, static, tables, cam, H, W, Y0, ROWS)
    assert LS.is_passed(rec), rec
    if LS.LIMIT[name] == "texture side":
        assert all(n > 0 for n in rec["by_texture"]), rec
        assert all(max(t.shape[:2]) > LS.OLD_TEX_SIDE
                   for t in tables.textures)
        assert cuda_kernel.capacities(static) == ()
        assert cuda_kernel.library("trace_bwd", static) == "trace_bwd_shapes"
        buf = cuda_kernel._check_tables(static, tables, torch.device("cpu"))
        assert torch.equal(buf[-1], torch.cat([t.reshape(-1)
                                               for t in tables.textures]))
        return
    cap = CAPACITY[LS.LIMIT[name]]
    need = cuda_kernel.needs(static)[cap]
    default = cuda_kernel.CAPACITIES[cap][0]
    assert need > default, (cap, need)
    got = dict(cuda_kernel.capacities(static))
    assert set(got) == {cap} and need <= got[cap] < 2 * need, got
    cuda_kernel.encode_scene(static)
    kind = cuda_bwd.route(static)
    assert kind == ("segmented" if static.max_nodes > cuda_bwd.MAX_TAPE
                    else "tape")
    for kernel in ("trace_fwd", "trace_bwd" if kind == "tape"
                   else "trace_seg"):
        lib = cuda_kernel.library(kernel, static)
        assert lib.endswith(f"+{cap}{got[cap]}") or (
            cap not in cuda_kernel.SOURCE_CAPACITIES[kernel]), lib


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_lax(name):
    """The port's plain trace of the JAX package's camera rays of the slab
    against the JAX package's lax trace of them: within 1e-5 on every
    pixel; the port's own rays within 1e-6 of the JAX package's."""
    refs = slab_ref.load(name)
    static, tables, cam = load(name)
    org, d = (Vec(*(torch.from_numpy(refs[k][..., i].copy())
                    for i in range(4))) for k in ("org", "dir"))
    got = torch.stack(trace.trace_batch(static, tables, org, d), -1).numpy()
    ref = refs["rgb"]
    assert got.shape == ref.shape == (ROWS, W, 3)
    err = np.abs(got - ref).max()
    assert err <= 1e-5, err
    yi = torch.arange(Y0, Y0 + ROWS, dtype=torch.float32)[:, None].expand(
        ROWS, W)
    xi = torch.arange(W, dtype=torch.float32)[None, :].expand(ROWS, W)
    po, pd = trace.camera_rays(cam, xi, yi, W, H)
    for k, v in (("org", po), ("dir", pd)):
        mine = torch.stack(tuple(v), -1).numpy()
        assert np.abs(mine - refs[k]).max() <= 1e-6, k


@pytest.mark.parametrize("name", ["config6_long", "config2_d24"])
def test_lax_reference_is_the_jax_render(name):
    """The stored reference is the JAX package's op-by-op lax render of
    the slab, to the bit (the two scenes whose live render is cheapest)."""
    jax_refs.assert_live_is_stored(slab_ref, name)


@pytest.mark.parametrize("name", NAMES)
def test_device_code_matches_plain(harness, name):
    """Forward exact, every leaf's gradient within 1e-3 * max(max |ref|,
    1) under a seeded cotangent (tests/test_torch_harness.py's rule), in
    the build of the scene's capacities: the tape kernel, or for
    config2_d24_deep (255 nodes) K6 then K7 in chunks of 16 trips."""
    static = load(name)[0]
    chunk = 16 if cuda_bwd.route(static) == "segmented" else None
    out = harness.compare(LS.get_scene(name), H, W, chunk_trips=chunk,
                          y0=Y0, rows=ROWS)
    assert out["caps"] == dict(cuda_kernel.capacities(static)), out
    assert out["fwd_bad"] == 0 and out["fwd_max"] <= 1e-6, out
    assert out["bwd_worst"] <= 1.0, out


def test_device_code_without_the_side_table(harness):
    """A build of more marching entities than a block's side table takes
    (2048 > 1024: each side test reads its row from the scene's arrays,
    over 64 words of side mask) renders and differentiates config5_crowd
    as the plain version does."""
    out = harness.compare(LS.get_scene("config5_crowd"), H, W,
                          caps={"entities": 2048}, y0=Y0, rows=ROWS)
    assert out["caps"] == {"entities": 2048}, out
    assert out["fwd_bad"] == 0 and out["fwd_max"] <= 1e-6, out
    assert out["bwd_worst"] <= 1.0, out


def test_march_probe_device_code_past_32_entities(harness):
    """probe_march.cu (P1), which shares the side mask, in its build of 64
    entities: every stage on the crossing tile of config5_crowd cut to the
    probe's depth and 23 march steps (45 entities; the warp region, whose
    boundary the crossing lanes cross, is the 41st) against
    march_probe_plain, by tests/test_torch_harness.py's rule."""
    from dataclasses import replace
    from euclider_tpu_torch.ops import march_probe as MP
    sc = LS.get_scene("config5_crowd")
    sc = replace(sc, settings=replace(sc.settings, max_depth=MP.MAX_DEPTH,
                                      march_steps=MP.MARCH_STEPS))
    static, t = ett.compile_scene(sc)
    tables = ett.tables_to_torch(t, "cpu")
    assert static.mat_kinds[MP.WARP_MAT] == "warp"
    assert cuda_kernel.library("probe_march", static) == \
        "probe_march+entities64"
    org, d = MP.crossing_tile()
    for stage in MP.STAGES:
        out = MP.compare(MP.march_probe_plain(static, tables, org, d, stage),
                         harness.march_probe(static, tables, org, d, stage))
        assert out["flipped"] == 0 and out["max_err"] <= out["limit"], out
        assert out["crossed"] > 0.25, out
