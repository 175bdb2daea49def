"""The port stands alone: no JAX, nothing of the reference package, and no
silent move to the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.launch import serve
from repro_torch.models.model import Model

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax|import repro\.|import repro\s*$|from repro\.|from repro import)",
    re.MULTILINE)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not FORBIDDEN.findall(path.read_text()), path


def test_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.launch.serve, repro_torch.convert\n"
            "import repro_torch.kernels.int_softmax.ops\n"
            "import repro_torch.kernels.paged_attention.ops, repro_torch.backends.paged_kernel\n"
            "import repro_torch.serving.engine, repro_torch.serving.options\n"
            "import repro_torch.serving.scheduler, repro_torch.models.kv_cache\n"
            "import repro_torch.models.moe, repro_torch.configs.dbrx_132b\n"
            "import repro_torch.configs.deepseek_v2_236b, repro_torch.configs.deepseek_7b\n"
            "import repro_torch.models.ssm, repro_torch.models.hybrid\n"
            "import repro_torch.configs.mamba2_780m, repro_torch.configs.hymba_1_5b\n"
            "import repro_torch.configs.whisper_base, repro_torch.configs.qwen2_vl_7b\n"
            "import repro_torch.training.step, repro_torch.training.loss\n"
            "import repro_torch.training.optimizer, repro_torch.training.grad_compression\n"
            "import repro_torch.checkpoint.checkpointer, repro_torch.checkpoint.manager\n"
            "import repro_torch.data.packing, repro_torch.distributed.straggler\n"
            "import repro_torch.launch.train, repro_torch.launch.mesh\n"
            "import repro_torch.serving.sharded, repro_torch.models.tensor_parallel\n"
            "import repro_torch.distributed.sharding, repro_torch.distributed.collectives\n"
            "import repro_torch.distributed.elastic, repro_torch.data.sharding\n"
            "import repro_torch.configs.qwen2_5_32b\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_the_card():
    """Without a card, an entry point called without device='cpu' raises;
    with one, it would run there."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(smoke_config("olmo-1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "olmo-1b", "--warm-steps", "0"])


@pytest.mark.parametrize("flag", [["--shards", "2"],
                                  ["--continuous", "--paged", "--preemption", "--shards", "2"]])
def test_later_slice_flags_name_roadmap_item(flag, capsys):
    """``--shards`` (ported: tensor-parallel serving) is a usage error before
    anything is trained or restored when it cannot run as asked: without
    ``--continuous``, or with more shards than visible devices and no
    ``--shards-on-one-device`` (the error names that flag: no shard goes
    on a shared device unasked)."""
    args = ["--arch", "olmo-1b", "--warm-steps", "0", "--device", "cpu"] + flag
    with pytest.raises(SystemExit):
        serve.main(args)
    err = capsys.readouterr().err
    assert ("requires --continuous" in err if "--continuous" not in flag
            else "--shards-on-one-device" in err)


def test_item_13_flags_no_longer_raise(tmp_path, capsys):
    """``--warm-steps`` trains and ``--ckpt-dir`` goes to the checkpoint:
    an empty directory holds none to restore."""
    args = ["--arch", "olmo-1b", "--device", "cpu", "--max-new", "2", "--batch", "1"]
    serve.main(args + ["--warm-steps", "1"])
    assert "warm-trained 1 steps" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        serve.main(args + ["--ckpt-dir", str(tmp_path)])


def test_serve_softmax_flag_runs(capsys):
    """``--serve-softmax`` (item 12) serves the variant with the model's
    params; without ``--continuous`` it is a usage error, as in the
    reference."""
    rep = serve.main(["--arch", "olmo-1b", "--warm-steps", "0", "--device", "cpu",
                      "--continuous", "--serve-softmax", "fp", "--requests", "2",
                      "--max-new", "4"])
    assert rep.softmax_kind == "fp" and len(rep.results) == 2
    with pytest.raises(SystemExit):
        serve.main(["--arch", "olmo-1b", "--warm-steps", "0", "--device", "cpu",
                    "--serve-softmax", "fp"])


def test_speculative_with_shards_still_names_item_14(capsys):
    """Speculative serving over shards (item 14, ported) runs from the
    launcher with the shards on the CPU."""
    args = ["--arch", "olmo-1b", "--warm-steps", "0", "--device", "cpu", "--continuous",
            "--paged", "--speculative", "--shards", "2", "--shards-on-one-device",
            "--requests", "3", "--max-new", "4"]
    rep = serve.main(args)
    assert rep.speculative and len(rep.results) == 3
    assert "2 shards on one device" in capsys.readouterr().out


def test_launcher_speculative_serve_prints_draft_verify_split(capsys):
    rep = serve.main(["--arch", "olmo-1b", "--smoke", "--continuous", "--paged",
                      "--speculative", "--draft-k", "3", "--softmax", "int_pallas",
                      "--warm-steps", "0", "--device", "cpu", "--requests", "4",
                      "--max-new", "8"])
    out = capsys.readouterr().out
    assert rep.speculative and rep.draft_k == 3 and rep.drafted_tokens > 0
    assert "speculative k=3 (acceptance" in out and "verify phase: CostReport" in out
    assert rep.cost_verify.cycles > 0 and rep.cost_draft.cycles == 0


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
def test_moe_entry_points_default_to_the_card(arch):
    """The MoE models (item 11) run on the card unless the caller passes the
    CPU, as the dense ones."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(smoke_config(arch))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", arch, "--warm-steps", "0"])


def test_serve_cli_runs_on_cpu_when_asked():
    res = serve.main(["--arch", "olmo-1b", "--softmax", "int_pallas", "--warm-steps", "0",
                      "--device", "cpu", "--batch", "2", "--max-new", "3"])
    assert res.tokens.shape == (2, 11) and np.all(res.tokens >= 0)
    assert res.cost.backend == "int_pallas" and res.cost.cycles > 0
