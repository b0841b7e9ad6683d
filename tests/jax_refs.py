"""Stored outputs of the JAX package that the port's tests hold the port to.

The JAX package is frozen, so its renders, ``jax.vjp`` leaves, optax steps
and Pallas tool kernels on a test's inputs never change; recomputed live
they took most of the port's test time (op by op or jit'd on a CPU, 10 to
145 s a case).  A test module registers each such reference with
``@stored(key, params)`` on a function of one parameter that returns the
case's inputs (a dict: the scene, H x W, a cotangent or its seed, ...) and
a function that computes the reference live (a dict of numpy arrays).
``tests/make_jax_refs.py`` runs every registered live function and writes
``tests/jax_refs.npz``; the tests read it through ``<function>.load``,
which fails with "rerun tests/make_jax_refs.py" when the case's hash is not
the stored one.  The hash covers the case's inputs and the source of the
code under tests/ that computes it: the registered function and every
function of a test module that it names, directly or through those.  One
test of each kind of reference (vjp, lax render, train step, Pallas tool
kernel) re-derives its cheapest case live through ``<function>.live`` and
compares it to the bit.
"""
import functools
import hashlib
import inspect
import json
import os
import types

import numpy as np

from euclider_tpu_torch.ops.vjp import FLOAT_FIELDS

TESTS = os.path.dirname(os.path.abspath(__file__))
REFS = os.path.join(TESTS, "jax_refs.npz")
CASES = {}    # key -> the registered function


def case_name(key, param) -> str:
    return f"{key}/{param}"


def scene_hash(sc) -> str:
    """sha256 of the scene's JSON, of either package's scene IR (the two
    write the same JSON: tests/test_torch_scene.py)."""
    if type(sc).__module__.startswith("euclider_tpu_torch."):
        from euclider_tpu_torch.scene import jsonio
    else:
        from euclider_tpu.scene import jsonio
    return hashlib.sha256(json.dumps(jsonio.scene_to_dict(sc),
                                     sort_keys=True).encode()).hexdigest()


def _names(code):
    """The global and attribute names a code object and its nested
    functions use."""
    yield from code.co_names
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            yield from _names(c)


def _in_tests(obj) -> bool:
    return os.path.dirname(os.path.abspath(
        getattr(obj, "__file__", None) or obj.__code__.co_filename)) == TESTS


def code_sources(fn) -> list:
    """The source of ``fn`` and of every function of a module under tests/
    that it names, directly or through those (a name looked up in the
    function's module, or in a module under tests/ that it names)."""
    out, seen, todo = [], set(), [fn]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        out.append(inspect.getsource(f))
        names = set(_names(f.__code__))
        scopes = [f.__globals__] + [
            vars(m) for m in map(f.__globals__.get, names)
            if isinstance(m, types.ModuleType) and hasattr(m, "__file__")
            and _in_tests(m)]
        todo.extend(g for scope in scopes for g in map(scope.get, names)
                    if inspect.isfunction(g) and _in_tests(g))
    return sorted(out)


def case_hash(fn, inputs: dict) -> str:
    """sha256 of a case's inputs and of its code (``code_sources``): the
    scene (``inputs["scene"]``) by ``scene_hash``, an array by its dtype,
    shape and bytes, anything else by its JSON."""
    h = hashlib.sha256()
    for src in code_sources(fn):
        h.update(src.encode())
    for k in sorted(inputs):
        v = inputs[k]
        if k == "scene":
            v = scene_hash(v)
        elif isinstance(v, np.ndarray):
            v = f"{v.dtype}{v.shape}" + hashlib.sha256(
                np.ascontiguousarray(v).tobytes()).hexdigest()
        h.update(json.dumps([k, v], sort_keys=True).encode())
    return h.hexdigest()


@functools.lru_cache(maxsize=1)
def _stored() -> dict:
    with np.load(REFS) as f:
        return dict(f)


def load(key, param) -> dict:
    """The stored arrays of one case, after checking its hash."""
    inputs, _ = CASES[key](param)
    name = case_name(key, param)
    refs = _stored()
    assert f"{name}/hash" in refs and str(refs[f"{name}/hash"]) == \
        case_hash(CASES[key], inputs), (
            f"tests/jax_refs.npz is stale for {name} (its inputs or its "
            f"code changed): rerun tests/make_jax_refs.py {key}")
    return {k[len(name) + 1:]: v for k, v in refs.items()
            if k.startswith(name + "/") and k != f"{name}/hash"}


def live(key, param) -> dict:
    """The case's reference computed now by the JAX package."""
    _, run = CASES[key](param)
    return {k: np.asarray(v) for k, v in run().items()}


def stored(key, params):
    """Registers ``fn(param) -> (inputs, live)`` under ``key`` for each of
    ``params``, and gives it ``load(param)`` and ``live(param)``."""
    def register(fn):
        assert key not in CASES, key
        CASES[key] = fn
        fn.params = tuple(params)
        fn.load = functools.partial(load, key)
        fn.live = functools.partial(live, key)
        return fn
    return register


def assert_live_is_stored(fn, param):
    """The live reference of one case equals the stored one to the bit."""
    got, ref = fn.live(param), fn.load(param)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(
            got[k], ref[k], equal_nan=True), k


def leaves(d_tables, d_cam, d_time=None) -> dict:
    """A render's gradient leaves by name, of the JAX package's vjp or the
    port's: the float tables, the texels (``textures[i]``), the camera
    (``cam.<field>``) and, if given, the scene time (``time``)."""
    out = {k: np.asarray(getattr(d_tables, k)) for k in FLOAT_FIELDS}
    out.update((f"textures[{i}]", np.asarray(t))
               for i, t in enumerate(d_tables.textures))
    out.update((f"cam.{k}", np.asarray(v)) for k, v in zip(d_cam._fields,
                                                             d_cam))
    if d_time is not None:
        out["time"] = np.asarray(d_time)
    return out
