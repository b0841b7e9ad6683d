"""The torch port's jax-free scene front end equals the JAX package's.

euclider_tpu_torch carries its own copy of the numpy front end (ir, expr,
compile, library, jsonio) because the CUDA machine has no jax.  These tests
hold the copy equal to the reference for every library scene and every
committed scene file, and check that the weights-carry functions move the
numpy tables onto a torch device without changing a bit.
"""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from euclider_tpu.scene import jsonio as jax_jsonio
from euclider_tpu.scene.compile import compile_camera as jax_compile_camera
from euclider_tpu.scene.compile import compile_scene as jax_compile_scene
from euclider_tpu.scene.library import BUILDERS

import euclider_tpu_torch as ett
from euclider_tpu_torch.scene import jsonio
from euclider_tpu_torch.scene.library import BUILDERS as PORT_BUILDERS

SCENE_FILES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes",
    "*.json")))


def assert_compiled_equal(port, ref):
    (st, tb, cam), (rst, rtb, rcam) = port, ref
    assert dataclasses.asdict(st) == dataclasses.asdict(rst)
    assert st.has_warp == rst.has_warp and st.has_portal == rst.has_portal
    assert tb._fields == rtb._fields
    for name, a, b in zip(tb._fields, tb, rtb):
        if name == "textures":
            assert len(a) == len(b)
            for ta, tb_ in zip(a, b):
                assert ta.dtype == tb_.dtype and np.array_equal(ta, tb_)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    for a, b in zip(cam, rcam):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)


def test_library_names_match():
    assert sorted(PORT_BUILDERS) == sorted(BUILDERS)
    assert ett.ACCEPTANCE


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_compile_scene_matches_jax(name):
    sc, ref = ett.get_scene(name), BUILDERS[name]()
    assert_compiled_equal(
        (*ett.compile_scene(sc), ett.compile_camera(sc.camera)),
        (*jax_compile_scene(ref), jax_compile_camera(ref.camera)))


@pytest.mark.parametrize("path", SCENE_FILES,
                         ids=[os.path.basename(p) for p in SCENE_FILES])
def test_scene_file_matches_jax(path):
    sc, ref = jsonio.load_scene(path), jax_jsonio.load_scene(path)
    assert_compiled_equal(
        (*ett.compile_scene(sc), ett.compile_camera(sc.camera)),
        (*jax_compile_scene(ref), jax_compile_camera(ref.camera)))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_tables_to_torch_round_trips_jax_tables(name):
    ref = BUILDERS[name]()
    _, tables = jax_compile_scene(ref)
    cam = jax_compile_camera(ref.camera)
    dev = torch.device("cpu")
    tt = ett.tables_to_torch(tables, dev)
    ct = ett.camera_to_torch(cam, dev)
    assert type(tt).__name__ == "SceneTables" and tt._fields == tables._fields
    for name_, a, b in zip(tables._fields, tt, tables):
        pairs = zip(a, b) if name_ == "textures" else [(a, b)]
        for ta, nb in pairs:
            assert isinstance(ta, torch.Tensor) and ta.device == dev
            assert ta.dtype == torch.float32
            assert np.array_equal(ta.numpy(), nb), name_
    for ta, nb in zip(ct, cam):
        assert ta.device == dev and ta.dtype == torch.float32
        assert np.array_equal(ta.numpy(), nb)
    # a copy, not a view: the numpy tables stay untouched
    tt.shape_sc.add_(1.0)
    assert not np.array_equal(tt.shape_sc.numpy(), tables.shape_sc)
