"""The probes P1-P5 of the torch port against the JAX tools' kernels.

P2-P5 (ops/probes.py: ckpt_scratch_vjp, cond_vjp, nested_march_vjp,
gated_march_vjp) against tools/mosaic_probe.py's _ckpt_kernel,
_cond_kernel, _nested_kernel and _gated_kernel run through
pl.pallas_call(interpret=True) on the tool's seeded inputs, at the tool's
tolerances; P5 also on a dead tile, against make_gated_march's own VJP.
P1 (ops/march_probe.py) against the body of tools/march_bisect.py's
kernel, rebuilt here from the same euclider_tpu functions with the rays as
inputs, in interpret mode, for every stage on the tool's tile (whose tile
sums are the tool's printed ones) and on the crossing tile.  Then the two
entry points, euclider_tpu_torch.tools.mosaic_probe and .march_bisect,
with --device cpu.  The kernels are held against these plain versions by
tests/test_torch_harness.py (their device code on the CPU) and
tests/test_torch_cuda.py (on the card, which also holds the wrappers'
refusal of CPU tensors).  Each JAX reference of P2-P5 is computed once
per module; P1's tool kernel tiles and the JAX package's march of each
lane are stored (tests/jax_refs.py), and the fwd stage's tiles are
re-derived live.
"""
import os
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import euclider_tpu as et
from euclider_tpu.ops import march as JM
from euclider_tpu.ops import trace as JT
from euclider_tpu.ops.pallas_kernel import _table_views, _unpack_tables
from euclider_tpu.ops.pallas_vjp import make_march_ckpt
from euclider_tpu.ops.vec import Vec as JVec

from euclider_tpu_torch.ops import march_probe as MP
from euclider_tpu_torch.ops import probes as PR
from euclider_tpu_torch.tools import march_bisect, mosaic_probe

import jax_refs

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")
TH, TW = 8, 128
VMEM, SMEM = pltpu.VMEM, pltpu.SMEM
# what tools/march_bisect.py STAGE --interpret prints as the tile's sum
TOOL_SUMS = {"fwd": "13.8240", "vjp": "1037.8240", "finish": "1037.8240",
             "loop": "-51.2000"}


def _spec(space):
    return pl.BlockSpec(memory_space=space)


# --- P2-P5 -------------------------------------------------------------------

@pytest.fixture(scope="module")
def mp():
    sys.path.insert(0, TOOLS)
    import mosaic_probe as tool
    assert (tool.K, tool.C, tool.N_STEPS, tool.CB) == (PR.K, PR.C,
                                                       PR.N_STEPS, PR.CB)
    return tool


def _vjp_call(kernel, x, w, g):
    """A tool kernel of inputs (x, w, g) and outputs (dx, dw) in
    interpret mode -> numpy (dx, dw)."""
    dx, dw = pl.pallas_call(
        kernel, in_specs=[_spec(VMEM), _spec(SMEM), _spec(VMEM)],
        out_specs=[_spec(VMEM), _spec(SMEM)],
        out_shape=[jax.ShapeDtypeStruct((TH, TW), jnp.float32),
                   jax.ShapeDtypeStruct((1, 1), jnp.float32)],
        interpret=True)(x, np.full((1, 1), w, np.float32), g)
    return np.asarray(dx), np.float32(dw[0, 0])


def _dead_gated_kernel(tool):
    """_gated_kernel with act all zero: make_gated_march's dead branches in
    its forward and its backward."""
    def kernel(x_ref, w_ref, g_ref, dx_ref, dw_ref):
        x, w, g = x_ref[:], w_ref[0, 0], g_ref[:]
        gm = tool.make_gated_march(PR.N_STEPS, PR.CB)

        def outer(x, w):
            y = gm(w, x * 1.2, x * 0.5, jnp.zeros_like(x))
            return jnp.cos(y) + y * 0.25

        def body(j, acc):
            _, vjp = jax.vjp(outer, x, w)
            dxj, dwj = vjp(g)
            return acc[0] + dxj, acc[1] + dwj

        dx, dw = jax.lax.fori_loop(0, PR.TRIPS, body, (jnp.zeros_like(x),
                                                       jnp.float32(0.0)))
        dx_ref[:] = dx
        dw_ref[0, 0] = dw
    return kernel


def _normal(seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=(TH, TW)) * scale
            + shift).astype(np.float32)


@pytest.fixture(scope="module")
def mosaic_refs(mp):
    """Each tool kernel on the tool's inputs -> {case: (inputs, outputs,
    tolerance, port function)}."""
    from functools import partial
    refs = {}
    x, g = _normal(0), _normal(1)
    refs["ckpt"] = ((x, 0.7, g), _vjp_call(partial(mp._ckpt_kernel, None),
                                           x, 0.7, g),
                    1e-5, PR.ckpt_scratch_vjp)
    rng = np.random.default_rng(2)          # probe_cond's draws, in order
    for shift in (1.0, -1.0):
        x = (rng.normal(size=(TH, TW)) + shift).astype(np.float32)
        g = rng.normal(size=(TH, TW)).astype(np.float32)
        out = pl.pallas_call(
            mp._cond_kernel, in_specs=[_spec(VMEM)] * 2,
            out_specs=[_spec(VMEM)] * 2,
            out_shape=[jax.ShapeDtypeStruct((TH, TW), jnp.float32)] * 2,
            interpret=True)(x, g)
        refs[f"cond{shift:+.0f}"] = ((x, g), tuple(np.asarray(o) for o in out),
                                     1e-6, PR.cond_vjp)
    x, g = _normal(3, 0.3), _normal(4)
    refs["nested"] = ((x, 0.9, g), _vjp_call(mp._nested_kernel, x, 0.9, g),
                      1e-4, PR.nested_march_vjp)
    x, g = _normal(5, 0.3), _normal(6)
    refs["gated"] = ((x, 0.8, g), _vjp_call(mp._gated_kernel, x, 0.8, g),
                     1e-4, PR.gated_march_vjp)
    refs["gated_dead"] = ((x, 0.8, g, np.zeros_like(x)),
                          _vjp_call(_dead_gated_kernel(mp), x, 0.8, g), 1e-4,
                          PR.gated_march_vjp)
    return refs


def _torch(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("case", ["ckpt", "cond+1", "cond-1", "nested",
                                  "gated", "gated_dead"])
def test_mosaic_plain_matches_the_tool_kernel(mosaic_refs, case):
    """The plain version against the tool's kernel at the tool's tolerance
    (tools/mosaic_probe.py:582-586): the largest difference of dx (and y),
    and dw's difference relative to max(|dw|, 1)."""
    inputs, ref, tol, fn = mosaic_refs[case]
    got = [o.numpy() for o in fn(*(_torch(a) for a in inputs))]
    if case.startswith("cond"):
        assert bool(inputs[0].sum() > 0) == (case == "cond+1")
        err = max(np.abs(got[0] - ref[0]).max(), np.abs(got[1] - ref[1]).max())
    else:
        err = max(np.abs(got[0] - ref[0]).max(),
                  abs(float(got[1]) - float(ref[1])) / max(abs(float(ref[1])),
                                                           1.0))
    assert err < tol, (case, err)
    if case == "gated_dead":      # the dead tile: dx = 2 * 1.2 g (0.25 - sin)
        assert float(got[1]) == 0.0


# --- P1 ----------------------------------------------------------------------

def _march_kernel(stage, static, n_views):
    """tools/march_bisect.py:52-108, the kernel of one stage, with the rays
    (org.x, .y, .z, .w, d.x, .y, .z, .w) as input tiles."""
    def kernel(*refs):
        vs = tuple(r[:] for r in refs[:n_views])
        tbl = _unpack_tables(vs)
        org = JVec(*(r[:] for r in refs[n_views:n_views + 4]))
        d = JVec(*(r[:] for r in refs[n_views + 4:n_views + 8]))
        out_ref = refs[n_views + 8]
        mat = jnp.zeros((TH, TW), jnp.int32)
        wm = JT.warp_mask(static, mat + 1)     # material 1 is the warp
        h = jnp.full((TH, TW), 0.06, jnp.float32)
        tm = jnp.float32(0.25)
        impl = make_march_ckpt(static, 5)

        if stage == "fwd":
            hit, p, dvec, ent, n, u, v = impl(static, tbl, tm, mat + 1,
                                              org, d, h, wm)
            out_ref[:] = p.x + dvec.y + u + v + n.z
            return

        if stage == "finish":
            def f(vs2, orgx):
                tbl2 = _unpack_tables(vs2)
                o2 = JVec(orgx, org.y, org.z, org.w)
                carry = JM.march_init(static, tbl2, o2, d, wm)
                accel = JT.make_accel(static, tbl2, mat + 1, tm)
                body0 = JM.make_march_body(static, tbl2, accel, h)
                carry = jax.lax.fori_loop(0, 23, lambda i, c: body0(c),
                                          carry)
                hit, p, dvec, ent, n, u, v = JM.march_finish(static, tbl2,
                                                             o2, carry)
                return p.x + dvec.y + u + v + n.z

            val, vjp = jax.vjp(f, vs, org.x)
            dvs, dox = vjp(jnp.ones_like(val))
            out_ref[:] = val + dox + dvs[0].sum()
            return

        def f(vs2, orgx):
            tbl2 = _unpack_tables(vs2)
            o2 = JVec(orgx, org.y, org.z, org.w)
            hit, p, dvec, ent, n, u, v = impl(static, tbl2, tm, mat + 1,
                                              o2, d, h, wm)
            if stage == "loop":
                return p.x * 0.0 + dvec.y    # cotangent only into dvec
            return p.x + dvec.y + u + v + n.z

        val, vjp = jax.vjp(f, vs, org.x)
        dvs, dox = vjp(jnp.ones_like(val))
        out_ref[:] = val + dox + dvs[0].sum()
    return kernel


def march_scene():
    """The tool's scene in the JAX package's IR: config5 at max_depth 1 and
    23 march steps (MP.probe_scene)."""
    sc = et.get_scene(MP.SCENE)
    return replace(sc, settings=replace(sc.settings, max_depth=MP.MAX_DEPTH,
                                        march_steps=MP.MARCH_STEPS))


def tiles():
    """The tool's and the crossing tile's rays, (org, d) as numpy
    [TH, TW, 4] arrays."""
    return {"tool": tuple(a.numpy() for a in MP.tool_tile()),
            "crossing": tuple(a.numpy() for a in MP.crossing_tile())}


def tile_inputs():
    return {f"{t}.{k}": a for t, rays in tiles().items()
            for k, a in zip(("org", "dir"), rays)}


@jax_refs.stored("probes.march", MP.STAGES)
def march_ref(stage):
    """The rebuilt tool kernel's output tile of the stage, on each tile
    (``tool``, ``crossing``) through one compile."""
    sc = march_scene()

    def run():
        static, tables = et.compile_scene(sc)
        views = _table_views(jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float32), tables))
        call = jax.jit(pl.pallas_call(
            _march_kernel(stage, static, len(views)),
            in_specs=[_spec(VMEM)] * (len(views) + 8),
            out_specs=_spec(VMEM),
            out_shape=jax.ShapeDtypeStruct((TH, TW), jnp.float32),
            interpret=True))
        return {t: call(*views, *(a[..., k] for a in rays for k in range(4)))
                for t, rays in tiles().items()}
    return {"scene": sc, "stage": stage, **tile_inputs()}, run


@jax_refs.stored("probes.lanes", ["tool", "crossing"])
def lanes_ref(tile):
    """Each lane's march by the JAX package's plain march: ``steps`` and
    the ``entity`` it crossed, or -1."""
    sc = march_scene()

    def run():
        static, tables = et.compile_scene(sc)
        org, d = tiles()[tile]
        o = JVec(*(jnp.asarray(org[..., k]) for k in range(4)))
        dd = JVec(*(jnp.asarray(d[..., k]) for k in range(4)))
        mat = jnp.ones((TH, TW), jnp.int32)
        carry = JM.march_init(static, tables, o, dd,
                              JT.warp_mask(static, mat))
        body = JM.make_march_body(static, tables,
                                  JT.make_accel(static, tables, mat, 0.25),
                                  jnp.float32(0.06))
        for _ in range(MP.MARCH_STEPS):
            carry = body(carry)
        hit, _, _, ent, _, _, _ = JM.march_finish(static, tables, o, carry)
        return {"steps": np.asarray(jnp.round(
                    carry[8] / jnp.float32(0.06))).astype(int),
                "entity": np.where(np.asarray(hit) != 0, np.asarray(ent),
                                   -1)}
    return {"scene": sc, "tile": tile, **tile_inputs()}, run


@pytest.fixture(scope="module")
def port_scene():
    return MP.probe_scene()


def _port(port_scene, tile, stage):
    static, tables = port_scene
    org, d = MP.tool_tile() if tile == "tool" else MP.crossing_tile()
    return MP.march_probe(static, tables, org, d, stage)


@pytest.mark.parametrize("tile", ["tool", "crossing"])
@pytest.mark.parametrize("stage", MP.STAGES)
def test_march_plain_matches_the_tool_kernel(port_scene, stage, tile):
    """Every lane within 1e-5 * max(max |ref|, 1) on the tool's tile and
    1e-4 * max(max |ref|, 1) on the crossing tile, leaving out the lanes
    whose march crossed at another step or another entity (at most 1% of
    the tile; counted)."""
    ref = march_ref.load(stage)[tile]
    got = _port(port_scene, tile, stage)
    lanes = lanes_ref.load(tile)
    steps, ent = lanes["steps"], lanes["entity"]
    same = (got.steps.numpy() == steps) & (got.ent.numpy() == ent)
    assert (~same).sum() <= 0.01 * same.size, (~same).sum()
    rtol = 1e-5 if tile == "tool" else 1e-4
    err = np.abs(got.out.numpy() - ref)[same].max()
    assert err <= rtol * max(np.abs(ref).max(), 1.0), (err, (~same).sum())


@pytest.mark.parametrize("stage", MP.STAGES)
def test_march_tool_tile_sums(port_scene, stage):
    """The rebuilt kernel is the tool's: its tile sums are the ones
    tools/march_bisect.py STAGE --interpret prints, and so are the port's."""
    assert f"{march_ref.load(stage)['tool'].sum():.4f}" == TOOL_SUMS[stage]
    got = _port(port_scene, "tool", stage)
    assert f"{got.out.numpy().sum():.4f}" == TOOL_SUMS[stage]


def test_tool_kernel_reference_is_the_jax_kernel():
    """The stored tiles are the rebuilt tool kernel's, to the bit (the fwd
    stage, the cheapest), and so are the lanes' marches."""
    jax_refs.assert_live_is_stored(march_ref, "fwd")
    jax_refs.assert_live_is_stored(lanes_ref, "crossing")


def test_crossing_tile_crosses(port_scene):
    """On the crossing tile between 25% and 75% of the lanes cross a
    boundary within 23 steps, in the port and in the JAX package, and the
    normal makes sum(d shape_vec) nonzero; on the tool's tile no lane
    crosses and it is zero."""
    got = _port(port_scene, "crossing", "vjp")
    share = float((got.ent >= 0).float().mean())
    assert 0.25 <= share < 0.75, share
    assert share == float((lanes_ref.load("crossing")["entity"] >= 0).mean())
    assert abs(float(got.dsv)) > 1.0, float(got.dsv)
    tool = _port(port_scene, "tool", "vjp")
    assert int((tool.ent >= 0).sum()) == 0 and float(tool.dsv) == 0.0


def test_march_vjp_equals_finish_in_the_plain_version(port_scene):
    """The plain version differentiates one march for both stages."""
    a = _port(port_scene, "crossing", "vjp")
    b = _port(port_scene, "crossing", "finish")
    assert torch.equal(a.out, b.out)


# --- the entry points ---------------------------------------------------------

def test_mosaic_probe_tool_on_the_cpu(capsys):
    """python -m euclider_tpu_torch.tools.mosaic_probe --device cpu: the
    plain versions of P2-P6 against their own references, each OK."""
    assert mosaic_probe.main(["--device", "cpu"]) == 0
    verdicts = {line.split()[0]: line.split()[1]
                for line in capsys.readouterr().out.splitlines()
                if line.split()[0] in mosaic_probe.NAMES}
    assert verdicts == dict.fromkeys(mosaic_probe.NAMES, "OK"), verdicts


@pytest.mark.parametrize("tile", ["tool", "crossing"])
def test_march_bisect_tool_on_the_cpu(capsys, tile):
    """python -m euclider_tpu_torch.tools.march_bisect STAGE --device cpu
    prints the tool's line (on the tool's tile, the tool's sum)."""
    for stage in MP.STAGES:
        assert march_bisect.main([stage, "--tile", tile, "--device",
                                  "cpu"]) == 0
        out = capsys.readouterr().out
        assert f"{stage}: ok, finite=True, sum=" in out
        if tile == "tool":
            assert f"sum={TOOL_SUMS[stage]}" in out
