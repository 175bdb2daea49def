"""The port's checkpoints against the reference's format: a checkpoint either
package writes restores bitwise into the other (the same directories,
manifest and ``/``-joined tree paths), a reference run resumes in the port,
and the checkpointer and manager keep the reference's retention, crash and
resume behaviour (``tests/test_checkpoint.py``'s cases on the port).

Bound of the resumed step: the restored state is bitwise the saved one,
so the third step differs from the reference's only by the f32 arithmetic
of one step (smoke olmo-1b, f32 compute): loss within 1e-5 relative, the
updated parameters within 2.2 lr at most and 2e-5 in mean (an entry whose
gradient is near zero may take Adam's step the other way).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from repro.checkpoint import checkpointer as jckpt
from repro.configs.registry import smoke_config as jsmoke
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.data.synthetic import family_batch
from repro.models.model import Model as JModel
from repro.training.optimizer import AdamW as JAdamW, cosine_schedule as jcos
from repro.training.step import init_state as jinit, make_train_step as jmake
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.convert import train_state_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec as TSpec
from repro_torch.models.model import Model as TModel
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.step import init_state, make_train_step

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    """The reference's olmo-1b smoke model and two jitted int steps from
    its init state (grad compression on: the residual is a subtree), and
    the port's model and step on the same schedule."""
    jm = JModel(jsmoke("olmo-1b", softmax=JSpec("int")), dtype=jnp.float32)
    tm = TModel(tsmoke("olmo-1b", softmax=TSpec("int")), dtype=torch.float32, device="cpu")
    jopt, topt = JAdamW(lr=jcos(1e-2, 2, 10)), AdamW(lr=cosine_schedule(1e-2, 2, 10))
    jstep = jax.jit(jmake(jm, jopt, grad_compress=True))
    tstep = make_train_step(tm, topt, grad_compress=True)
    batches = [family_batch(tm.cfg, 2, 32, seed=i) for i in range(3)]
    states = [jinit(jm, jopt, jax.random.PRNGKey(0), grad_compress=True)]
    for b in batches:
        states.append(jstep(states[-1], {k: jnp.asarray(v) for k, v in b.items()})[0])
    return jm, tm, jopt, topt, tstep, batches, states


def _pairs(jtree, ttree):
    """(key, reference leaf, port leaf) over every leaf, by the reference's
    tree paths."""
    flat, _ = jtu.tree_flatten_with_path(jtree)
    out = []
    for path, leaf in flat:
        node = ttree
        for p in path:
            node = getattr(node, p.name) if hasattr(p, "name") else node[p.key]
        out.append(("/".join(str(getattr(p, "name", getattr(p, "key", p))) for p in path),
                    np.asarray(leaf), node))
    return out


def _template(tm, topt):
    return init_state(tm, topt, grad_compress=True)


def test_reference_checkpoint_restores_into_port_bitwise(setup, tmp_path):
    jm, tm, jopt, topt, *_, states = setup
    jckpt.save(str(tmp_path), 2, states[2], extra={"by": "reference"})
    got, step, extra = ckpt.restore(str(tmp_path), _template(tm, topt))
    assert step == 2 and extra == {"by": "reference"}
    pairs = _pairs(states[2], got)
    assert {k.split("/")[0] for k, *_ in pairs} == {"params", "opt", "error_fb"}
    for key, want, leaf in pairs:
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu", key
        assert leaf.numpy().dtype == want.dtype, key
        np.testing.assert_array_equal(leaf.numpy(), want, err_msg=key)
    assert got.opt.step.dtype == torch.int32 and int(got.opt.step) == 2


def test_port_checkpoint_restores_into_reference_bitwise(setup, tmp_path):
    jm, tm, jopt, topt, tstep, batches, states = setup
    state = train_state_from_numpy(jax.tree.map(np.asarray, states[1]), tm.cfg, "cpu")
    state, _ = tstep(state, batches[1])
    path = ckpt.save(str(tmp_path), 2, state, extra={"by": "port"})
    assert os.path.basename(path) == "step_000000002"
    assert sorted(os.listdir(path)) == ["manifest.json", "shard_p0.npz"]
    template = jinit(jm, jopt, jax.random.PRNGKey(1), grad_compress=True)
    got, step, extra = jckpt.restore(str(tmp_path), template)
    assert step == 2 and extra == {"by": "port"}
    for key, leaf, want in _pairs(got, state):
        np.testing.assert_array_equal(np.asarray(leaf), want.numpy(), err_msg=key)


def test_reference_run_resumes_in_port(setup, tmp_path):
    """Two reference steps, saved; the port restores them and takes the
    third on the same batch as the reference's third."""
    jm, tm, jopt, topt, tstep, batches, states = setup
    jckpt.save(str(tmp_path), 2, states[2])
    mgr = CheckpointManager(str(tmp_path), interval=1)
    state, nxt = mgr.restore_or_init(lambda: _template(tm, topt))
    assert nxt == 3
    state, met = tstep(state, batches[2])
    want = states[3]
    assert int(state.opt.step) == int(want.opt.step) == 3
    lr = float(jopt.lr(jnp.int32(3)))
    for key, j, t in _pairs(want.params, state.params):
        d = np.abs(t.numpy() - j)
        assert d.max() <= 2.2 * lr and d.mean() <= 2e-5, (key, d.max(), d.mean())


@pytest.fixture
def tree():
    rng = np.random.default_rng(0)
    return {"params": {"w": torch.as_tensor(rng.normal(0, 1, (8, 8)), dtype=torch.float32),
                       "b": torch.as_tensor(rng.normal(0, 1, (8,)), dtype=torch.float32)},
            "step": torch.tensor(7, dtype=torch.int32),
            "nested": [torch.arange(4), {"x": torch.ones((2, 2))}]}


def test_roundtrip_exact(tmp_path, tree):
    ckpt.save(str(tmp_path), 10, tree, extra={"k": "v"})
    restored, step, extra = ckpt.restore(str(tmp_path), tree)
    assert step == 10 and extra == {"k": "v"}
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7
    assert torch.equal(restored["nested"][1]["x"], torch.ones((2, 2)))
    with pytest.raises(TypeError, match="bf16"):
        ckpt.save(str(tmp_path), 11, {"w": torch.ones(2, dtype=torch.bfloat16)})


def test_latest_and_retention(tmp_path, tree):
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, tree)
    assert ckpt.latest_step(str(tmp_path)) == 4
    ckpt.cleanup(str(tmp_path), keep=2)
    assert sorted(int(d[5:]) for d in os.listdir(tmp_path)) == [3, 4]


def test_crash_leaves_tmp_only(tmp_path, tree):
    ckpt.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_000000002.tmp")      # a dead writer's
    assert ckpt.latest_step(str(tmp_path)) == 1
    ckpt.cleanup(str(tmp_path), keep=3)
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_shape_mismatch_rejected(tmp_path, tree):
    ckpt.save(str(tmp_path), 1, tree)
    bad = dict(tree, params={"w": torch.zeros((4, 4)), "b": tree["params"]["b"]})
    with pytest.raises(ValueError, match="params/w"):
        ckpt.restore(str(tmp_path), bad)
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(str(tmp_path), dict(tree, extra_leaf=torch.zeros(1)))


def test_manager_auto_resume(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), interval=5, keep=2)
    assert mgr.maybe_save(3, tree) is None            # off schedule
    assert mgr.maybe_save(5, tree) is not None
    state, nxt = mgr.restore_or_init(lambda: tree)
    assert nxt == 6 and torch.equal(state["params"]["b"], tree["params"]["b"])
    mgr2 = CheckpointManager(str(tmp_path / "fresh"), interval=5)
    state, nxt = mgr2.restore_or_init(lambda: {"a": torch.zeros(1)})
    assert nxt == 0
