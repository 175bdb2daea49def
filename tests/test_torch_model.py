"""The port's dense model (olmo-1b smoke: 3 layers, d 128) against the
reference, on the reference's own ``Model.init(PRNGKey(0))`` parameters
carried over by ``repro_torch.convert``.

Both sides compute in f32. Float matmuls and the f32 transcendental
functions (rope's pow/cos/sin, exp) round differently in XLA and torch,
which moves scores and logits by ~1e-6 (logits here are below ~1).

* ``fp``: logits within 1e-4 absolute.
* ``int`` / ``int_pallas``: a score that lands within an ulp of a rounding
  boundary of the M-bit grid can quantize to the neighbouring code on one
  side only. The 16-token ``train_logits`` case below has one such score
  (x/S = -3.4999974 in XLA, -3.5000007 in torch, layer 1), which moves
  later logits by up to 5.4e-3. The bound for the int kinds is therefore
  1e-2; the prefill and decode cases see no flipped code and stay within
  1e-6.

Greedy tokens must be equal at every decode step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jsmoke
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.models.model import Model as JModel
from repro_torch.configs.registry import get_config, smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec as TSpec
from repro_torch.models.kv_cache import cache_zeros
from repro_torch.models.model import Model as TModel

torch.set_num_threads(2)

ATOL = {"fp": 1e-4, "int": 1e-2, "int_pallas": 1e-2}
KINDS = list(ATOL)


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    kind = request.param
    jcfg = jsmoke("olmo-1b", softmax=JSpec(kind))
    tcfg = tsmoke("olmo-1b", softmax=TSpec(kind))
    jm = JModel(jcfg, dtype=jnp.float32)
    jp = jm.init_split(jax.random.PRNGKey(0))[0]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    return jm, jp, TModel(tcfg, dtype=torch.float32, device="cpu"), tp, ATOL[kind]


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(j, t, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def test_prefill_and_decode_steps(pair):
    jm, jp, tm, tp, atol = pair
    prompts = _tokens(2, 8, jm.cfg.vocab)
    jl, jc = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, {"tokens": jnp.asarray(prompts)}, cache_len=16)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(prompts, dtype=torch.long)}, 16)
    assert tl.shape == (2, 1, jm.cfg.vocab) and tl.dtype == torch.float32
    assert tc["k"].shape == tuple(jc["k"].shape)
    _close(jl, tl, atol)
    dec = jax.jit(jm.decode_step)
    for t in range(8):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), tok)
        jl, jc = dec(jp, jc, {"token": jnp.asarray(tok[:, None])}, jnp.int32(8 + t))
        tl, tc = tm.decode_step(
            tp, tc, {"token": torch.as_tensor(tok[:, None], dtype=torch.long)}, 8 + t)
        _close(jl, tl, atol)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=0, atol=atol)


def test_chunked_prefill_and_train_logits(pair):
    """Prompt 64 > attn_chunk 32: the query-chunked path; and the
    whole-sequence train_logits path."""
    jm, jp, tm, tp, atol = pair
    prompts = _tokens(1, 64, jm.cfg.vocab, seed=1)
    jl, _ = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, {"tokens": jnp.asarray(prompts)}, cache_len=64)
    tl, _ = tm.prefill(tp, {"tokens": torch.as_tensor(prompts, dtype=torch.long)}, 64)
    _close(jl, tl, atol)
    jlog, _ = jax.jit(jm.train_logits)(jp, {"tokens": jnp.asarray(prompts[:, :16])})
    tlog, _ = tm.train_logits(tp, {"tokens": torch.as_tensor(prompts[:, :16], dtype=torch.long)})
    _close(jlog, tlog, atol)


def test_train_logits_pair_matches_reference_structure(pair):
    """``train_logits`` returns ``(logits, aux)`` as the reference does (its
    training step unpacks the pair): aux a 0-dim f32 zero for the dense
    family, logits of the reference's shape and dtype."""
    jm, jp, tm, tp, _ = pair
    tokens = _tokens(2, 8, jm.cfg.vocab, seed=3)
    jout = jax.jit(jm.train_logits)(jp, {"tokens": jnp.asarray(tokens)})
    tout = tm.train_logits(tp, {"tokens": torch.as_tensor(tokens, dtype=torch.long)})
    assert isinstance(tout, tuple) and len(tout) == len(jout) == 2
    (jlog, jaux), (tlog, taux) = jout, tout
    assert tuple(tlog.shape) == tuple(jlog.shape)
    assert str(tlog.dtype).split(".")[-1] == str(jlog.dtype)
    assert taux.shape == () == jnp.shape(jaux)
    assert taux.dtype == torch.float32 and str(jnp.asarray(jaux).dtype) == "float32"
    assert float(taux) == float(jaux) == 0.0


def test_per_row_decode_positions_match_scalar(pair):
    """decode_step with a [B] position vector writes and masks like the
    scalar path (the continuous-batching form of the step)."""
    jm, jp, tm, tp, atol = pair
    prompts = _tokens(2, 8, jm.cfg.vocab, seed=2)
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long)}
    tok = {"token": torch.as_tensor(prompts[:, :1], dtype=torch.long)}
    _, c1 = tm.prefill(tp, batch, 12)
    _, c2 = tm.prefill(tp, batch, 12)
    l1, c1 = tm.decode_step(tp, c1, tok, 8)
    l2, c2 = tm.decode_step(tp, c2, tok, torch.tensor([8, 8]))
    assert torch.equal(l1, l2) and torch.equal(c1["k"], c2["k"])


def test_cache_zeros_layout():
    cfg = tsmoke("olmo-1b")
    c = cache_zeros(cfg, batch=2, cache_len=16, device="cpu")
    assert c["k"].shape == (3, 2, 16, 4, 32) and c["k"].dtype == torch.bfloat16


def test_unported_arch_names_roadmap_item():
    """No reference architecture is left unported: qwen2.5-32b, the last one,
    resolves (its fields are held against the reference's in
    ``test_torch_sharded_serving.py``), and a name outside the registry
    raises with the list of the available ones."""
    assert get_config("qwen2.5-32b").n_layers == 64
    with pytest.raises(KeyError, match="available"):
        get_config("qwen3-1t")


def test_init_is_seeded():
    m = TModel(tsmoke("olmo-1b"), device="cpu")
    a = m.init(torch.Generator("cpu").manual_seed(3))
    b = m.init(torch.Generator("cpu").manual_seed(3))
    wa, wb = a["stack"]["layers"]["attn"]["wq"]["w"], b["stack"]["layers"]["attn"]["wq"]["w"]
    assert wa.dtype == torch.bfloat16 and wa.shape == (3, 128, 128)
    assert torch.equal(wa, wb)
