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


@pytest.mark.parametrize("flag", [["--continuous", "--speculative"], ["--warm-steps", "5"],
                                  ["--ckpt-dir", "x"], ["--shards", "2"],
                                  ["--continuous", "--paged", "--prefill-chunk", "8",
                                   "--speculative"],
                                  ["--continuous", "--paged", "--preemption", "--shards", "2"],
                                  ["--continuous", "--paged", "--kv-quant", "--speculative"],
                                  ["--serve-softmax", "fp"]])
def test_later_slice_flags_name_roadmap_item(flag):
    args = ["--arch", "olmo-1b", "--warm-steps", "0", "--device", "cpu"] + flag
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        serve.main(args)


def test_serve_cli_runs_on_cpu_when_asked():
    res = serve.main(["--arch", "olmo-1b", "--softmax", "int_pallas", "--warm-steps", "0",
                      "--device", "cpu", "--batch", "2", "--max-new", "3"])
    assert res.tokens.shape == (2, 11) and np.all(res.tokens >= 0)
    assert res.cost.backend == "int_pallas" and res.cost.cycles > 0
