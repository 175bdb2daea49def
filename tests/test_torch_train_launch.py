"""The port's launchers with training: ``repro_torch.launch.train`` trains,
checkpoints and auto-resumes (also from a checkpoint the reference wrote),
and ``repro_torch.launch.serve`` warm-trains before it serves (its default,
``--warm-steps 120``, cut here by the flag alone) or serves a restored
checkpoint. Each runs in-process on the CPU at the smoke size."""

import os

import numpy as np
import pytest
import torch

import jax

from repro.checkpoint import checkpointer as jckpt
from repro.configs.registry import smoke_config as jsmoke
from repro.models.model import Model as JModel
from repro.training.optimizer import AdamW as JAdamW, constant_schedule as jconst
from repro.training.step import init_state as jinit
from repro_torch.configs.registry import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.launch import serve, train
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine

torch.set_num_threads(2)

TRAIN = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32", "--ckpt-every", "2"]


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "run")
    state, start, losses = train.main(TRAIN + ["--steps", "3", "--ckpt-dir", d])
    assert start == 0 and sorted(losses) == [0, 1, 2]
    assert all(np.isfinite(v) for v in losses.values())
    # saves at steps 0 and 2 (every 2) and the final one, labelled --steps
    assert sorted(os.listdir(d)) == ["step_000000000", "step_000000002", "step_000000003"]
    assert int(state.opt.step) == 3 and state.params["embed"]["w"].dtype == torch.float32
    state, start, losses = train.main(TRAIN + ["--steps", "5", "--ckpt-dir", d])
    assert start == 4 and sorted(losses) == [4] and int(state.opt.step) == 4
    assert "auto-resumed at step 4" in capsys.readouterr().out
    assert "step_000000005" in os.listdir(d)


def test_train_launcher_resumes_a_reference_checkpoint(tmp_path, capsys):
    """The reference's TrainState (olmo-1b smoke, grad compression on),
    saved by the reference's checkpointer, is where the port's launcher
    resumes."""
    jm = JModel(jsmoke("olmo-1b"))
    jstate = jinit(jm, JAdamW(lr=jconst(1e-3)), jax.random.PRNGKey(3), grad_compress=True)
    jckpt.save(str(tmp_path), 5, jstate)
    state, start, losses = train.main(TRAIN + ["--steps", "7", "--grad-compress",
                                               "--ckpt-dir", str(tmp_path)])
    assert start == 6 and sorted(losses) == [6] and int(state.opt.step) == 1
    assert state.error_fb is not None
    assert "auto-resumed at step 6" in capsys.readouterr().out


def test_train_launcher_production_mesh_names_item_14():
    """``--production-mesh`` raises naming the sharded-training item (23),
    which took it over from item 14 (tensor-parallel serving, done)."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 23"):
        train.main(TRAIN + ["--steps", "1", "--production-mesh"])


def test_serve_launcher_warm_trains_by_default(capsys):
    """The default run (llama2-7b smoke, ``int``, batch generate) with only
    the warm-up count cut: it trains through the ``int`` spec it serves."""
    assert serve.build_parser().parse_args([]).warm_steps == 120
    res = serve.main(["--device", "cpu", "--warm-steps", "3"])
    out = capsys.readouterr().out
    assert "warm-trained 3 steps (softmax int)" in out
    assert res.tokens.shape == (4, 8 + 24) and res.cost.cycles > 0


def test_serve_launcher_warm_trains_against_fp_for_the_kernel(capsys):
    """``int_pallas`` (the kernel has no backward) warm-trains against fp
    and then serves through its kernels' plain versions here."""
    rep = serve.main(["--arch", "olmo-1b", "--device", "cpu", "--warm-steps", "2",
                      "--softmax", "int_pallas", "--continuous", "--paged",
                      "--kernel", "pallas", "--requests", "2", "--max-new", "4"])
    assert "warm-trained 2 steps (softmax fp)" in capsys.readouterr().out
    assert len(rep.results) == 2 and rep.cost.cycles > 0


def test_serve_launcher_serves_a_reference_checkpoint(tmp_path, capsys):
    """``--ckpt-dir`` with a checkpoint the reference wrote: the launcher
    serves its master weights cast to bf16, the same tokens as an engine
    built on the reference's parameters through the converter."""
    jm = JModel(jsmoke("olmo-1b"))
    jstate = jinit(jm, JAdamW(lr=jconst(1e-3)), jax.random.PRNGKey(5))
    jckpt.save(str(tmp_path), 9, jstate)
    res = serve.main(["--arch", "olmo-1b", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                      "--batch", "2", "--max-new", "3"])
    assert "restored step 9 from" in capsys.readouterr().out
    cfg = smoke_config("olmo-1b", softmax=SoftmaxSpec("int", PrecisionConfig(M=6, N=16)))
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), cfg, "cpu")
    eng = Engine(Model(cfg, device="cpu"), params, max_new=3)
    prompts = SyntheticCorpus(cfg.vocab, seed=1234).sample(2, 8, seed=777)[:, :8]
    np.testing.assert_array_equal(res.tokens, eng.generate(prompts, mode="fused").tokens)
