"""Writes tests/limit_refs.npz: the JAX package's lax render of a slab of
each scene of euclider_tpu_torch/tools/limit_scenes.py, the reference that
tests/test_torch_limits.py holds the port's plain render to.

    JAX_PLATFORMS=cpu python tests/make_limit_refs.py    # about 10 minutes
    JAX_PLATFORMS=cpu python tests/make_limit_refs.py NAME ...

Named scenes are rendered and written into the existing file, whose other
scenes' arrays are kept as they are; with no name every scene is.

For each scene, rows [y0, y0 + rows) of its H x W frame (limit_scenes.SLAB):
the JAX package's camera rays of the slab (``<name>/org``, ``<name>/dir``,
[rows, W, 4] float32) and ``trace_batch``'s colour of them (``<name>/rgb``,
[rows, W, 3]), both run op by op (``jax.disable_jit``: the port's tests
hold against the op-by-op lax render, whose arithmetic is XLA's operation
by operation), and a hash of the scene's JSON (``<name>/scene``), which the
tests check so that a changed scene cannot meet a stale reference.  Live,
these renders take 10 to 145 s a scene on a CPU; the JAX package is frozen,
so they never change.
"""
import hashlib
import json
import os
import sys

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "limit_refs.npz")


def scene_hash(sc) -> str:
    from euclider_tpu_torch.scene import jsonio
    return hashlib.sha256(json.dumps(jsonio.scene_to_dict(sc),
                                     sort_keys=True).encode()).hexdigest()


def lax_slab(name):
    """The JAX package's camera rays and lax colour of the scene's slab,
    op by op -> (org [rows, W, 4], dir [rows, W, 4], rgb [rows, W, 3])."""
    import jax
    import jax.numpy as jnp
    import euclider_tpu as et
    from euclider_tpu.ops import trace as jtrace
    from euclider_tpu.scene import jsonio as jax_jsonio
    from euclider_tpu_torch.scene import jsonio
    from euclider_tpu_torch.tools import limit_scenes as LS
    H, W, y0, rows = LS.SLAB
    sc = jax_jsonio.scene_from_dict(jsonio.scene_to_dict(LS.get_scene(name)))
    static, tables = et.compile_scene(sc)
    cam = et.compile_camera(sc.camera)
    yi, xi = np.mgrid[y0:y0 + rows, 0:W].astype(np.float32)
    with jax.disable_jit():
        org, d = jtrace.camera_rays(cam, jnp.asarray(xi), jnp.asarray(yi),
                                    W, H)
        rgb = jtrace.trace_batch(static, tables, org, d)
    stack = lambda v: np.stack([np.asarray(c, np.float32) for c in v], -1)
    return stack(org), stack(d), stack(rgb)


def main(names=None) -> int:
    from euclider_tpu_torch.tools import limit_scenes as LS
    out = {}
    if names and os.path.exists(OUT):
        with np.load(OUT) as f:
            out = dict(f)
    for name in names or LS.BUILDERS:
        org, d, rgb = lax_slab(name)
        out.update({f"{name}/org": org, f"{name}/dir": d,
                    f"{name}/rgb": rgb,
                    f"{name}/scene": np.asarray(scene_hash(
                        LS.get_scene(name)))})
        print(name, rgb.shape, flush=True)
    np.savez_compressed(OUT, **out)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    sys.exit(main(sys.argv[1:]))
