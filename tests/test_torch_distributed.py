"""The port's sharding rules, meshes, collectives, elastic planning and
batch placement (``repro_torch.distributed``, ``launch/mesh.py``,
``data/sharding.py``) against the reference's.

* ``ShardingRules.spec`` equals the reference's ``PartitionSpec`` entries
  for every logical axis, alone and in pairs, under the default rules, the
  serving rules and whisper-base's overrides, on every mesh's axes;
  ``DEFAULT_RULES`` and ``SERVING_OVERRIDES`` are the reference's;
* ``Model.param_axes()`` equals the reference's for every architecture
  (with ConSmax's learned parameters too), built on the meta device;
* ``plan_mesh``, ``survivors_after_failure`` and ``batch_axes`` equal the
  reference's; ``reshard_tree`` / ``shard_batch`` give each device its
  block; the collectives gather and sum in shard order.
"""

import itertools
import types

import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import smoke_config as jsmoke
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.data import sharding as jdata
from repro.distributed import elastic as jel
from repro.distributed import sharding as jsh
from repro.models.model import Model as JModel
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.data import sharding as tdata
from repro_torch.distributed import collectives as col
from repro_torch.distributed import elastic as tel
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model import Model

CPU = torch.device("cpu")
AXES = [None] + sorted(jsh.DEFAULT_RULES)
MESH_AXES = [("model",), ("data", "model"), ("pod", "data", "model"), ("data",), None]


def _names(axes):
    return None if axes is None else types.SimpleNamespace(axis_names=axes)


def _entries(spec):
    """A spec's entries as a PartitionSpec compares them: a one-name tuple
    is that name (this JAX's ``PartitionSpec`` stores it so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def test_rules_tables_equal_reference():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert tsh.SERVING_OVERRIDES == jsh.SERVING_OVERRIDES


@pytest.mark.parametrize("overrides", [(), (("heads", None), ("kv_heads", None)),
                                       (("mlp", ["pod", "model"]),)])
@pytest.mark.parametrize("serving", [False, True])
def test_spec_equals_reference(overrides, serving):
    jr, tr = jsh.ShardingRules(overrides), tsh.ShardingRules(overrides)
    if serving:
        jr, tr = jsh.serving_rules(jr), tsh.serving_rules(tr)
    for name in AXES:
        assert tr.mesh_axes(name) == jr.mesh_axes(name)
    for axes in MESH_AXES:
        for pair in itertools.product(AXES, repeat=2):
            assert _entries(tr.spec(pair, _names(axes))) == \
                _entries(jr.spec(pair, _names(axes))), pair
        for one in AXES:
            assert _entries(tr.spec((one,), _names(axes))) == \
                _entries(jr.spec((one,), _names(axes)))
    with pytest.raises(KeyError, match="unknown logical axis"):
        tr.mesh_axes("nope")


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_param_axes_equal_reference(arch):
    assert sorted(ARCHS) == sorted(JARCHS)
    for kind in (None, "consmax"):
        jcfg, tcfg = jsmoke(arch), smoke_config(arch)
        if kind:
            jcfg, tcfg = jcfg.with_softmax(JSpec(kind)), tcfg.with_softmax(SoftmaxSpec(kind))
        assert Model(tcfg, device="cpu").param_axes() == JModel(jcfg).param_axes()


def test_plan_mesh_and_survivors_equal_reference():
    for n, mp, pods in itertools.product((16, 32, 48, 64, 96, 256, 512, 520), (8, 16),
                                         (True, False)):
        assert tel.plan_mesh(n, mp, pods) == jel.plan_mesh(n, mp, pods)
    with pytest.raises(ValueError, match="cannot host model_parallel=16"):
        tel.plan_mesh(8)
    for shape, names in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
                         ((4,), ("data",))):
        jm = types.SimpleNamespace(devices=np.empty(shape), axis_names=names)
        tm = tmesh.Mesh(None, names, shape)
        for failed in (0, 1, 3, 17, 600):
            assert tel.survivors_after_failure(tm, failed) == \
                jel.survivors_after_failure(jm, failed)
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16,
                                                                "model": 16}
    assert tel.make_elastic_mesh(512).shape == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.make_host_mesh("cpu").shape == {"data": 1, "model": 1}


def test_batch_axes_and_shard_batch():
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 9, (4, 6)), "positions": rng.integers(0, 9, (3, 4, 6)),
             "frames": rng.normal(size=(4, 5, 2)).astype(np.float32)}
    assert tdata.batch_axes(batch) == jdata.batch_axes(batch)
    mesh = tmesh.Mesh(np.array([CPU] * 4, dtype=object).reshape(2, 2), ("data", "model"))
    parts = tdata.shard_batch(batch, mesh, tsh.ShardingRules())
    assert len(parts) == 4 and parts.devices == [CPU] * 4
    for i, part in enumerate(parts):
        row = i // 2       # the data coordinate; the model axis holds copies
        assert np.array_equal(part["tokens"].numpy(), batch["tokens"][2 * row:2 * row + 2])
        assert np.array_equal(part["positions"].numpy(),
                              batch["positions"][:, 2 * row:2 * row + 2])


def test_reshard_tree_gives_each_device_its_block():
    mesh = tmesh.Mesh(np.array([CPU] * 4, dtype=object).reshape(2, 2), ("data", "model"))
    w = torch.arange(8 * 6.).reshape(8, 6)
    rules = tsh.ShardingRules((("embed", "data"),))
    parts = tel.reshard_tree({"w": w}, {"w": ("embed", "mlp")}, mesh, rules)
    for i, part in enumerate(parts):
        d, m = divmod(i, 2)
        assert torch.equal(part["w"], w[4 * d:4 * d + 4, 3 * m:3 * m + 3])
    with pytest.raises(ValueError, match="does not split"):
        tel.reshard_tree({"w": w[:, :5]}, {"w": ("embed", "mlp")}, mesh, rules)


def test_collectives_in_shard_order():
    xs = col.Shards(torch.full((2, 3), float(i)) for i in range(4))
    assert torch.equal(col.all_gather(xs, 1), torch.cat(list(xs), 1))
    assert torch.equal(col.ring_all_gather(xs, 0), torch.cat(list(xs), 0))
    trees = [{"a": x, "b": {"c": 2 * x}} for x in xs]
    s = col.psum_tree(trees)
    assert torch.equal(s["a"], torch.full((2, 3), 6.)) and torch.equal(s["b"]["c"],
                                                                        torch.full((2, 3), 12.))
    assert torch.equal(col.pmean_tree(trees)["a"], torch.full((2, 3), 1.5))
    rs = col.reduce_scatter_mean([x.repeat(2, 1) for x in xs], 0)
    assert [r.shape for r in rs] == [(1, 3)] * 4
    assert all(torch.equal(r, torch.full((1, 3), 1.5)) for r in rs)
    # a sum in shard order: f32 values whose order matters
    vals = col.Shards(torch.tensor([v]) for v in (1e8, 1.0, -1e8, 1.0))
    # in f32, 1e8 + 1 rounds to 1e8: shard order gives ((1e8 + 1) - 1e8) + 1 = 1
    assert col.psum_tree(list(vals)).item() == 1.0
