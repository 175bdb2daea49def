"""llama2-7b, the paper's own model and the launcher's default ``--arch``:
the port's config equals the reference's, its smoke config's logits agree
with the reference's at the same (converted) weights within
``tests/test_torch_model.py``'s bounds, and its full width counts 6.74 B
parameters on the meta device."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.models.model import Model as JModel
from repro_torch.configs.registry import get_config, smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec as TSpec
from repro_torch.models.model import Model as TModel

torch.set_num_threads(2)

ATOL = {"fp": 1e-4, "int_pallas": 1e-2}     # tests/test_torch_model.py


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "softmax"}


def test_llama2_config_is_the_reference_config():
    assert _fields(get_config("llama2-7b")) == _fields(jget("llama2-7b"))
    assert _fields(tsmoke("llama2-7b")) == _fields(jsmoke("llama2-7b"))


@pytest.mark.parametrize("kind", list(ATOL))
def test_llama2_smoke_logits_match_reference(kind):
    jm = JModel(jsmoke("llama2-7b", softmax=JSpec(kind)), dtype=jnp.float32)
    jp = jm.init_split(jax.random.PRNGKey(0))[0]
    tcfg = tsmoke("llama2-7b", softmax=TSpec(kind))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    tm = TModel(tcfg, dtype=torch.float32, device="cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    jl, _ = jm.train_logits(jp, {"tokens": jnp.asarray(tokens)})
    tl, _ = tm.train_logits(tp, {"tokens": torch.as_tensor(tokens, dtype=torch.long)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL[kind])
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, cache_len=16)
    tl, _ = tm.prefill(tp, {"tokens": torch.as_tensor(tokens, dtype=torch.long)}, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL[kind])


def test_llama2_full_width_parameter_count_on_meta():
    cfg = get_config("llama2-7b")
    params = TModel(cfg, device="meta").init(torch.Generator())

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        assert tree.device.type == "meta"
        return tree.numel()

    n = count(params)
    assert round(n / 1e9, 2) == 6.74, n
    assert abs(n - cfg.param_count()) < 1e-5 * n
