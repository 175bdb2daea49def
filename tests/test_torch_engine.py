"""The port's ``Engine.generate`` and samplers.

* fused == eager, bitwise, inside the port (greedy, stochastic, EOS);
* greedy tokens equal the reference's ``Engine.generate(mode="eager")`` at
  smoke size with ``int_pallas`` on the reference's own parameters;
* ``report_cost=True`` equals the reference's CostReport exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jsmoke
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.models.model import Model as JModel
from repro.serving.engine import Engine as JEngine
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec as TSpec
from repro_torch.models.model import Model as TModel
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import make_sampler

torch.set_num_threads(2)


def _prompts(b=2, p=8, vocab=512, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, p)).astype(np.int32)


@pytest.fixture(scope="module")
def port_model():
    tcfg = tsmoke("olmo-1b", softmax=TSpec("int_pallas"))
    m = TModel(tcfg, dtype=torch.float32, device="cpu")
    return m, m.init(torch.Generator("cpu").manual_seed(0))


@pytest.mark.parametrize("sampler,kw,eos", [
    ("greedy", {}, None),
    ("temperature", {"temp": 0.8, "top_k": 20}, None),
    ("top_p", {"p": 0.9}, None),
    ("greedy", {}, "first"),
])
def test_fused_equals_eager(port_model, sampler, kw, eos):
    m, params = port_model
    prompts = _prompts()
    eos_id = None
    if eos == "first":   # the first token greedy emits for row 0: EOS early
        eos_id = int(Engine(m, params, max_new=1).generate(prompts).tokens[0, -1])
    eng = Engine(m, params, max_new=8, sampler=sampler, eos_id=eos_id, **kw)
    fused = eng.generate(prompts, generator=torch.Generator().manual_seed(7))
    eager = eng.generate(prompts, generator=torch.Generator().manual_seed(7),
                         mode="eager")
    np.testing.assert_array_equal(fused.tokens, eager.tokens)
    assert torch.equal(fused.logits, eager.logits)
    if eos_id is not None:
        np.testing.assert_array_equal(fused.done, eager.done)
        assert fused.done[0] and (fused.tokens[0, 8:] == eos_id).all()


@pytest.fixture(scope="module")
def pair():
    jcfg = jsmoke("olmo-1b", softmax=JSpec("int_pallas"))
    tcfg = tsmoke("olmo-1b", softmax=TSpec("int_pallas"))
    jm = JModel(jcfg, dtype=jnp.float32)
    jp = jm.init_split(jax.random.PRNGKey(0))[0]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    return (JEngine(jm, jp, max_new=8),
            Engine(TModel(tcfg, dtype=torch.float32, device="cpu"), tp, max_new=8))


def test_greedy_tokens_and_cost_equal_reference(pair):
    jeng, teng = pair
    prompts = _prompts()
    ref = jeng.generate(prompts, mode="eager", report_cost=True)
    got = teng.generate(prompts, report_cost=True)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.cost.backend == "int_pallas"
    assert dataclasses.astuple(got.cost) == dataclasses.astuple(ref.cost)


@pytest.mark.parametrize("b,p,n_new,cache_len", [(1, 64, 3, None), (3, 5, 1, 12)])
def test_meter_equals_reference(pair, b, p, n_new, cache_len):
    """Metering alone (no generation) across chunked prefill (p=64 >
    attn_chunk), a single-token generation and a pinned cache length."""
    jeng, teng = pair
    cl = cache_len or p + n_new
    tokens = _prompts(b, p)
    jbatch = {"tokens": jnp.asarray(tokens)}
    jcache = jax.eval_shape(lambda: jeng.model.prefill(jeng.params, jbatch, cl))[1]
    ref = jeng.meter_request(jbatch, cl, jcache, n_new)
    tbatch = {"tokens": torch.as_tensor(tokens, dtype=torch.long)}
    _, tcache = teng.model.prefill(teng.params, tbatch, cl)
    got = teng.meter_request(tbatch, cl, tcache, n_new)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)


def test_generate_validation(port_model):
    m, params = port_model
    eng = Engine(m, params, max_new=4)
    with pytest.raises(ValueError, match="mode"):
        eng.generate(_prompts(), mode="scan")
    with pytest.raises(ValueError, match="eager-only"):
        eng.generate(_prompts(), max_new=2)
    with pytest.raises(ValueError, match="cache_len"):
        eng.generate(_prompts(), cache_len=5)
    assert eng.generate(_prompts(), mode="eager", max_new=2).tokens.shape == (2, 10)


def test_top_k_keeps_exactly_k_on_ties():
    """Lower index wins ties: exactly k tokens survive."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 3.0, 0.0]])
    g = torch.Generator().manual_seed(0)
    seen = {int(make_sampler("temperature", top_k=2)(logits, g)) for _ in range(200)}
    assert seen == {1, 2}


def test_top_p_keeps_top_token():
    logits = torch.tensor([[0.0, 9.0, 1.0]])
    g = torch.Generator().manual_seed(0)
    assert {int(make_sampler("top_p", p=0.5)(logits, g)) for _ in range(50)} == {1}


def test_make_sampler_validates_kwargs():
    with pytest.raises(ValueError, match="unexpected options"):
        make_sampler("greedy", top_k=8)
    with pytest.raises(ValueError, match="unknown sampler"):
        make_sampler("beam")
    with pytest.raises(ValueError, match="callable"):
        make_sampler(lambda logits, g: logits.argmax(-1), temp=1.0)
