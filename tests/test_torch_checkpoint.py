"""utils/checkpointing.py: the port of euclider_tpu/utils/checkpointing.py
(``torch.save`` of the leaves, ``torch.load(..., weights_only=True)``), and
the checkpoint the trainer (train/fit.py) writes.

Round trips are to the bit; the leaves are stored in the order
``jax.tree.leaves`` gives for the JAX package's same structure (no jit
needed to take it).
"""
import jax
import numpy as np
import pytest
import torch

import euclider_tpu as et
from euclider_tpu.train.inverse import InverseParams as JaxInverseParams

import euclider_tpu_torch as ett
from euclider_tpu_torch.train import fit
from euclider_tpu_torch.train.inverse import InverseParams
from euclider_tpu_torch.utils import checkpointing
from euclider_tpu_torch.utils.tree import leaves, unflatten


def _params(name):
    sc = ett.get_scene(name)
    static, tables = ett.compile_scene(sc)
    return InverseParams(ett.tables_to_torch(tables, "cpu"),
                         ett.camera_to_torch(ett.compile_camera(sc.camera),
                                             "cpu"))


def _same(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        for x, y in zip(la, lb))


@pytest.mark.parametrize("name", ["grad_probe", "config3_csg_textured"])
def test_round_trip_is_bit_exact(tmp_path, name):
    params = _params(name)
    g = torch.Generator().manual_seed(0)
    moved = unflatten(params, [t + torch.rand(t.shape, generator=g)
                               for t in leaves(params)])
    path = checkpointing.save(str(tmp_path / "ckpt"), moved)
    assert path == str(tmp_path / "ckpt.pt")
    back = checkpointing.restore(str(tmp_path / "ckpt"), params)
    assert _same(back, moved)
    assert type(back.tables) is type(params.tables)
    assert type(back.cam) is type(params.cam)
    assert len(back.tables.textures) == len(params.tables.textures)
    if name == "config3_csg_textured":
        assert len(back.tables.textures) == 1


def test_restore_follows_like_dtypes_and_refuses_other_trees(tmp_path):
    params = _params("grad_probe")
    checkpointing.save(str(tmp_path / "c"), params)
    like64 = unflatten(params, [t.double() for t in leaves(params)])
    back = checkpointing.restore(str(tmp_path / "c"), like64)
    assert all(t.dtype == torch.float64 for t in leaves(back))
    assert all(torch.equal(a.double(), b) for a, b in
               zip(leaves(params), leaves(back)))
    with pytest.raises(ValueError, match="leaves"):
        checkpointing.restore(str(tmp_path / "c"), params.cam)
    with pytest.raises(ValueError, match="shape"):
        checkpointing.restore(str(tmp_path / "c"), params._replace(
            cam=params.cam._replace(position=torch.zeros(3))))


@pytest.mark.parametrize("name", ["grad_probe", "config3_csg_textured"])
def test_leaf_order_is_jax_tree_leaves(tmp_path, name):
    sc = et.get_scene(name)
    static, tables = et.compile_scene(sc)
    ref = jax.tree.leaves(JaxInverseParams(tables,
                                           et.compile_camera(sc.camera)))
    params = _params(name)
    path = checkpointing.save(str(tmp_path / "c"), params)
    saved = torch.load(path, weights_only=True)
    assert len(saved) == len(ref) == len(leaves(params))
    for a, b in zip(saved, ref):
        assert np.array_equal(a.numpy(), np.asarray(b, np.float32))


def test_dict_and_tuple_trees(tmp_path):
    """Dicts by sorted key, None no leaf, as jax.tree.leaves; the dict's own
    key order survives; a leaf that is no tensor is refused."""
    g = torch.Generator().manual_seed(1)
    tree = {"b": torch.rand(3, generator=g),
            "a": (torch.rand(2, generator=g), None,
                  torch.rand((), generator=g, dtype=torch.float64)),
            "c": [torch.arange(4)]}
    ref = jax.tree.leaves({k: jax.tree.map(lambda t: t.numpy(), v)
                           for k, v in tree.items()})
    assert all(np.array_equal(a.numpy(), b)
               for a, b in zip(leaves(tree), ref))
    checkpointing.save(str(tmp_path / "m"), tree)
    back = checkpointing.restore(str(tmp_path / "m"), tree)
    assert list(back) == ["b", "a", "c"] and back["a"][1] is None
    assert _same(back, tree) and back["c"][0].dtype == torch.int64
    with pytest.raises(TypeError, match="not a tensor"):
        checkpointing.save(str(tmp_path / "n"), {"x": 2.5})


def test_fit_writes_a_checkpoint_that_restores(tmp_path, capsys):
    out = fit.main(["--scene", "config1_sphere_room", "--device", "cpu",
                    "--backend", "torch", "--size", "16x8", "--steps", "1",
                    "--checkpoint", str(tmp_path / "fit")])
    assert out["restored"] and out["checkpoint"] == str(tmp_path / "fit.pt")
    back = checkpointing.restore(str(tmp_path / "fit"), out["params"])
    assert _same(back, out["params"])
    assert "restores to the parameters' bits: True" in capsys.readouterr().out
