"""The port's sharding rules against the JAX package's.

For every leaf of every config's train state, of its decode cache and of
its batch at every shape, on the (16, 16), (2, 16, 16) and (4, 2) meshes
with both ``act_shard`` modes, ``AxisRules.spec`` of the port equals
JAX's ``PartitionSpec`` (JAX's rules are called with a stand-in mesh that
has only ``axis_names`` and ``devices.shape``, which is all its ``spec``
reads).  Then the layouts built on those specs, on an abstract mesh.
"""
import types

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.parallel import sharding as jshd
from repro.parallel import steps as jst
from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported
from repro_torch.configs import get_config as torch_config
from repro_torch.models import api as tapi
from repro_torch.parallel import sharding as tshd
from repro_torch.parallel import steps as tst
from repro_torch.parallel.comm import AbstractMesh
from repro_torch.tree import leaves

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (4, 2): ("data", "model")}


def _standin(shape, axes):
    return types.SimpleNamespace(axis_names=axes,
                                 devices=types.SimpleNamespace(shape=shape))


def _jax_leaves(tree):
    import jax
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: hasattr(
        x, "axes"))


def _spec_pairs(arch):
    """(JAX ParamSpec, port ParamSpec) of every leaf of the state, every
    supported shape's cache and every shape's batch."""
    jc, tc = jax_config(arch), torch_config(arch)
    trees = [(jst.train_state_spec(jc), tst.train_state_spec(tc))]
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        trees.append((japi.input_spec(jc, jshape), tapi.input_spec(tc, shape)))
        if shape.kind == "decode" and cell_supported(tc, shape)[0]:
            trees.append((japi.cache_spec(jc, jshape),
                          tapi.cache_spec(tc, shape)))
    for j, t in trees:
        jl, tl = _jax_leaves(j), leaves(t)
        assert len(jl) == len(tl)
        yield from zip(jl, tl)


@pytest.mark.parametrize("act_shard", ["seq", "batch2d"])
@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax(arch, mesh_shape, act_shard):
    axes = MESHES[mesh_shape]
    multi = "pod" in axes
    jr = jshd.default_rules(multi_pod=multi, act_shard=act_shard)
    tr = tshd.default_rules(multi_pod=multi, act_shard=act_shard)
    jmesh, tmesh = _standin(mesh_shape, axes), AbstractMesh(mesh_shape, axes)
    n = 0
    for js, ts in _spec_pairs(arch):
        assert tuple(js.shape) == tuple(ts.shape)
        assert tuple(js.axes) == tuple(ts.axes)
        want = tuple(jr.spec(js.axes, shape=js.shape, mesh=jmesh))
        assert tuple(tr.spec(ts.axes, shape=ts.shape, mesh=tmesh)) == want, \
            (ts.axes, ts.shape)
        # the JAX stand-in is read the same way by the port's rules
        assert tuple(tr.spec(ts.axes, shape=ts.shape, mesh=jmesh)) == want
        n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ["glm4_9b", "llava_next_mistral_7b",
                                  "whisper_medium"])
def test_batch_axes_equal_jax(arch):
    for name, shape in SHAPES.items():
        assert tst.batch_axes(torch_config(arch), shape) == \
            jst.batch_axes(jax_config(arch), JSHAPES[name])


def test_spec_without_shape_or_mesh_keeps_the_table():
    for multi in (False, True):
        jr = jshd.default_rules(multi_pod=multi)
        tr = tshd.default_rules(multi_pod=multi)
        for axes in (("batch", "embed", None), ("kv_seq", "kv", "heads"),
                     ("layers", "vocab"), ("experts", "mlp", "act_embed")):
            assert tuple(tr.spec(axes)) == tuple(jr.spec(axes))
    assert tr.get("nope") is None and tr.get(None) is None


def test_layouts_cut_and_join_blocks():
    """Block shapes, the copies of a block, placements, and the blocks of
    every coordinate tiling the whole leaf in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((4, 2), ("data", "model"))
    rules = tshd.default_rules()
    lay = tshd.Layout(mesh, rules, ("embed", "mlp"), (8, 6))
    assert lay.local_shape == (2, 3) and lay.copies == 1
    assert lay.placements == (Shard(0), Shard(1))
    rep = tshd.Layout(mesh, rules, ("embed",), (6,))   # 6 % 4 != 0
    assert tuple(rep.spec) == (None,) and rep.copies == 8
    assert rep.placements == (Replicate(), Replicate())
    batch = tshd.Layout(mesh, tshd.default_rules(act_shard="batch2d"),
                        ("batch", None), (8, 3))
    assert tuple(batch.spec) == (("data", "model"), None)
    assert batch.local_shape == (1, 3)
    x = torch.arange(48.0).reshape(8, 6)
    blocks = {}
    for d in range(4):
        for m in range(2):
            mesh.get_coordinate = lambda d=d, m=m: [d, m]
            blocks[d, m] = lay.shard(x)
    whole = torch.cat([torch.cat([blocks[d, m] for m in range(2)], 1)
                       for d in range(4)], 0)
    assert torch.equal(whole, x)
    assert tshd.rows_axes(("batch", "seq", "act_embed")) == ("batch", None,
                                                             None)


def test_abstract_state_is_the_blocks():
    cfg = torch_config("glm4_9b").reduced()
    mesh = AbstractMesh((4, 2), ("data", "model"))
    rules = tshd.default_rules()
    state = tst.abstract_state(cfg, mesh, rules)
    lays = tst.state_layouts(cfg, mesh, rules)
    for t, lay in zip(leaves(state), leaves(lays), strict=True):
        assert t.device.type == "meta"
        assert tuple(t.shape) == lay.local_shape
        # the blocks of a leaf tile it, each held by `copies` devices
        assert t.numel() * (mesh.size() // lay.copies) == \
            int(np.prod(lay.shape))


def test_constrain_is_the_identity_and_checks_the_mesh():
    x = torch.zeros(4, 8)
    assert tshd.constrain(x, "batch", "embed") is x
    mesh = AbstractMesh((4, 2), ("data", "model"))
    with tshd.use_mesh(mesh, tshd.default_rules()):
        assert tshd.active()[0] is mesh
        assert tshd.constrain(x, "batch", "embed") is x
    with tshd.use_mesh(AbstractMesh((2,), ("stage",)),
                       tshd.default_rules()):
        with pytest.raises(KeyError):
            tshd.constrain(x, "batch", "embed")
    assert tshd.active() is None
