"""Writes tests/jax_refs.npz: the JAX package's outputs that the port's
tests hold the port to (tests/jax_refs.py).

    python tests/make_jax_refs.py              # every case, about 15 minutes
    python tests/make_jax_refs.py KEY ...      # the cases of these keys

Named keys are recomputed and written into the existing file, whose other
cases are kept as they are.  Each case ``<key>/<param>`` stores its arrays
as ``<key>/<param>/<name>`` and the hash of its inputs and code as
``<key>/<param>/hash``.  Every tests/test_torch_*.py module is imported, so
that each registers its cases.  The process sets up JAX as tests/conftest.py
does, so the arrays are the ones the tests' own runs compute.
"""
import glob
import importlib
import os
import sys
import time

import numpy as np


def main(keys=None) -> int:
    import conftest  # noqa: F401  (the tests' JAX settings, before any use)
    import jax_refs
    for path in sorted(glob.glob(os.path.join(jax_refs.TESTS,
                                              "test_torch_*.py"))):
        importlib.import_module(os.path.basename(path)[:-3])
    unknown = set(keys or ()) - set(jax_refs.CASES)
    if unknown:
        raise SystemExit(f"unknown keys {sorted(unknown)}; the keys are "
                         f"{sorted(jax_refs.CASES)}")
    out = {}
    if keys and os.path.exists(jax_refs.REFS):
        with np.load(jax_refs.REFS) as f:
            out = {k: v for k, v in f.items()
                   if k.split("/", 1)[0] not in keys}
    for key in keys or jax_refs.CASES:
        fn = jax_refs.CASES[key]
        for param in fn.params:
            name = jax_refs.case_name(key, param)
            t0 = time.perf_counter()
            inputs, run = fn(param)
            for k, v in run().items():
                out[f"{name}/{k}"] = np.asarray(v)
            out[f"{name}/hash"] = np.asarray(jax_refs.case_hash(fn, inputs))
            print(f"{name} {time.perf_counter() - t0:.1f} s", flush=True)
    np.savez_compressed(jax_refs.REFS, **out)
    return 0


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    sys.exit(main(sys.argv[1:]))
