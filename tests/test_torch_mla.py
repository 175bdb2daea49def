"""The port's MLA model (minicpm3-4b smoke: 3 layers, d 128, 4 heads, q_lora
64, kv_lora 64, nope 32 + rope 16, v 32) against the reference, and the
port's own MLA invariants.

* Against the reference, on its own ``Model.init(PRNGKey(0))`` parameters
  carried over by ``repro_torch.convert``, f32 compute on both sides (XLA
  and torch round f32 matmuls and transcendentals differently, ~1e-6 here):
  prefill logits and 8 contiguous decode steps within 1e-4 for ``fp`` and
  1e-2 for the integer kinds (a score within an ulp of a rounding boundary
  of the M-bit grid may quantize to the neighbouring code on one side
  only; ``tests/test_torch_model.py`` has such a case), with equal greedy
  tokens; CostReports equal exactly.
* Inside the port, bitwise (bf16 compute): paged decode (gather) ==
  contiguous decode; fused (K4's plain version) == gather, logits and
  every cache leaf; ``prefill_tail`` == the tail slice of a whole prefill;
  ``Engine.serve`` == ``Engine.generate(mode="eager")`` per request.
* Greedy tokens of the port's serve equal the reference's serve on a trace
  where the reference's serve equals its own eager (asserted first).
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
from repro.serving import scheduler as jsch
from repro.serving.engine import Engine as JEngine
from repro.serving.options import ServeOptions as JOptions
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.models import attention as tatt
from repro_torch.models.model import Model
from repro_torch.serving import scheduler as tsch
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions

torch.set_num_threads(2)

ARCH = "minicpm3-4b"
ATOL = {"fp": 1e-4, "int": 1e-2, "int_pallas": 1e-2}


@pytest.fixture(scope="module", params=list(ATOL))
def pair(request):
    kind = request.param
    jm = JModel(jsmoke(ARCH, softmax=JSpec(kind)), dtype=jnp.float32)
    jp = jm.init_split(jax.random.PRNGKey(0))[0]
    tcfg = tsmoke(ARCH, softmax=SoftmaxSpec(kind))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    return jm, jp, Model(tcfg, dtype=torch.float32, device="cpu"), tp, ATOL[kind]


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
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    _close(jl, tl, atol)
    dec = jax.jit(jm.decode_step)
    for t in range(8):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), tok)
        jl, jc = dec(jp, jc, {"token": jnp.asarray(tok[:, None])}, jnp.int32(8 + t))
        tl, tc = tm.decode_step(
            tp, tc, {"token": torch.as_tensor(tok[:, None], dtype=torch.long)}, 8 + t)
        _close(jl, tl, atol)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=0, atol=atol)


def test_chunked_prefill_train_logits_and_cost(pair):
    """Prompt 64 > attn_chunk 32 (the query-chunked path), the
    whole-sequence ``train_logits``, and ``generate``'s CostReport."""
    jm, jp, tm, tp, atol = pair
    prompts = _tokens(1, 64, jm.cfg.vocab, seed=1)
    jl, _ = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, {"tokens": jnp.asarray(prompts)}, cache_len=64)
    tl, _ = tm.prefill(tp, {"tokens": torch.as_tensor(prompts, dtype=torch.long)}, 64)
    _close(jl, tl, atol)
    jlog = jax.jit(jm.train_logits)(jp, {"tokens": jnp.asarray(prompts[:, :16])})[0]
    tlog, _ = tm.train_logits(tp, {"tokens": torch.as_tensor(prompts[:, :16], dtype=torch.long)})
    _close(jlog, tlog, atol)
    short = prompts[:, :6].repeat(2, axis=0)
    ref = JEngine(jm, jp, max_new=4).generate(short, mode="eager", report_cost=True)
    got = Engine(tm, tp, max_new=4).generate(short, report_cost=True)
    np.testing.assert_array_equal(got.tokens, np.asarray(ref.tokens))
    assert dataclasses.astuple(got.cost) == dataclasses.astuple(ref.cost)


# ------------------------------------------------------------ in the port, bitwise


def test_train_logits_pair_matches_reference_structure(pair):
    """The MLA model's ``train_logits`` returns ``(logits, aux)`` as the
    reference does, aux a 0-dim f32 zero."""
    jm, jp, tm, tp, _ = pair
    tokens = _tokens(1, 8, jm.cfg.vocab, seed=3)
    jlog, jaux = jax.jit(jm.train_logits)(jp, {"tokens": jnp.asarray(tokens)})
    out = tm.train_logits(tp, {"tokens": torch.as_tensor(tokens, dtype=torch.long)})
    assert isinstance(out, tuple) and len(out) == 2
    tlog, taux = out
    assert tuple(tlog.shape) == tuple(jlog.shape)
    assert taux.shape == () == jnp.shape(jaux) and taux.dtype == torch.float32
    assert float(taux) == float(jaux) == 0.0


@pytest.fixture(scope="module")
def port():
    cfg = tsmoke(ARCH, softmax=SoftmaxSpec("int_pallas"))
    m = Model(cfg, dtype=torch.bfloat16, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _variant(m, kind):
    return Model(m.cfg.with_softmax(SoftmaxSpec(kind)), dtype=torch.bfloat16, device="cpu")


def _paged_from_contiguous(cache, bs, perm):
    """The same cache contents in a paged pool with shuffled blocks."""
    L, b, c = cache["c_kv"].shape[:3]
    nlog = c // bs
    nb = b * nlog + 3
    out = {"table": torch.full((L, b, nlog), nb, dtype=torch.int32)}
    for k in ("c_kv", "k_rope"):
        pool = torch.zeros((L, nb, bs) + cache[k].shape[3:], dtype=cache[k].dtype)
        for s in range(b):
            for j in range(nlog):
                pool[:, perm[s * nlog + j]] = cache[k][:, s, j * bs:(j + 1) * bs]
        out[k] = pool
    for s in range(b):
        out["table"][:, s] = torch.as_tensor(perm[s * nlog:(s + 1) * nlog])
    return out


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def test_paged_and_fused_decode_equal_contiguous(port):
    """Four decode steps at per-slot positions (one slot parked at
    ``cache_len``) through a paged pool with shuffled blocks: the gather
    path (``int_pallas``) gives the contiguous path's logits and cache
    contents, and the fused path (``int_pallas_paged``: K4's plain version
    on the CPU) gives the gather path's logits and every cache leaf, bit
    for bit."""
    m, params = port
    fused = _variant(m, "int_pallas_paged")
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, m.cfg.vocab, (3, 6)))
    _, cont = m.prefill(params, {"tokens": tokens}, cache_len=16)
    cont = {k: v.to(torch.bfloat16) for k, v in cont.items()}
    gathered = _paged_from_contiguous(cont, 4, rng.permutation(3 * 4 + 3))
    through_k4 = _clone(gathered)
    pos = torch.tensor([6, 9, 16], dtype=torch.int32)
    for step in range(4):
        tok = torch.as_tensor(rng.integers(0, m.cfg.vocab, (3, 1)))
        lc, _ = m.decode_step(params, cont, {"token": tok}, pos)
        lg, _ = m.decode_step(params, gathered, {"token": tok}, pos)
        lf, _ = fused.decode_step(params, through_k4, {"token": tok}, pos)
        assert torch.equal(lc[:2], lg[:2]), step
        assert torch.equal(lg, lf), step
        for k in gathered:
            assert torch.equal(gathered[k], through_k4[k]), (step, k)
        pos = pos + torch.tensor([1, 1, 0], dtype=torch.int32)
    for k in ("c_kv", "k_rope"):
        back = tatt.paged_gather(gathered[k][0], gathered["table"][0])
        assert torch.equal(back[:2, :13], cont[k][0, :2, :13]), k


@pytest.mark.parametrize("s", [4, 7, 12])
def test_prefill_tail_equals_whole_prefill(port, s):
    m, params = port
    tokens = torch.as_tensor(np.random.default_rng(s).integers(0, m.cfg.vocab, (1, 15)))
    lw, whole = m.prefill(params, {"tokens": tokens}, cache_len=15)
    prefix = {k: v[:, :, :s].to(torch.bfloat16) for k, v in whole.items()}
    lt, tail = m.prefill_tail(params, {"tokens": tokens[:, s:]}, prefix, s)
    assert torch.equal(lt, lw)
    for k in ("c_kv", "k_rope"):
        assert torch.equal(tail[k], whole[k][:, :, s:15]), k


LAYOUTS = {
    "contiguous": dict(),
    "paged": dict(paged=True, block_size=4),
    "paged+share": dict(paged=True, block_size=4, prefix_share=True),
}


@pytest.mark.parametrize("layout,kernel", [("contiguous", "jnp"), ("paged", "jnp"),
                                           ("paged", "pallas"), ("paged+share", "jnp"),
                                           ("paged+share", "pallas")])
def test_serve_equals_eager(port, layout, kernel):
    m, params = port
    eng = Engine(m, params, max_new=8)
    reqs = tsch.shared_prefix_trace(6, m.cfg.vocab, prefix_len=9, seed=1,
                                    suffix_lens=(2, 4, 7), max_new_range=(4, 7),
                                    arrival_spacing=1.0)
    rep = eng.serve(reqs, ServeOptions(slots=2, cache_len=32, kernel=kernel,
                                       **LAYOUTS[layout]))
    for r in reqs:
        ref = eng.generate(r.prompt[None], generator=torch.Generator().manual_seed(r.seed),
                           mode="eager", max_new=r.max_new, cache_len=rep.cache_len)
        np.testing.assert_array_equal(rep.by_rid()[r.rid].tokens, ref.tokens[0],
                                      err_msg=str(r.rid))
    assert rep.leaked_blocks == 0
    if layout == "paged+share":
        assert rep.shared_prefill_tokens > 0


def test_copy_on_write_on_the_latent_pool(port):
    """An identical twin prompt shares all its latent blocks and copies the
    boundary block on its forced tail write (both pool leaves); serve still
    equals eager."""
    m, params = port
    rng = np.random.default_rng(3)
    common = rng.integers(0, m.cfg.vocab, (8,), dtype=np.int32)
    reqs = [tsch.Request(rid=0, prompt=common.copy(), max_new=5, seed=11),
            tsch.Request(rid=1, prompt=common.copy(), max_new=5, seed=22)]
    eng = Engine(m, params, max_new=5)
    rep = eng.serve(reqs, ServeOptions(slots=2, cache_len=16, paged=True, block_size=4,
                                       prefix_share=True, kernel="pallas"))
    assert rep.cow_copies >= 1 and rep.by_rid()[1].shared_prefix == 7
    assert rep.leaked_blocks == 0
    for r in reqs:
        ref = eng.generate(r.prompt[None], generator=torch.Generator().manual_seed(r.seed),
                           mode="eager", max_new=r.max_new, cache_len=rep.cache_len)
        np.testing.assert_array_equal(rep.by_rid()[r.rid].tokens, ref.tokens[0])


# ------------------------------------------------------------ serve vs the reference


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
def test_serve_matches_reference(kernel):
    kw = dict(slots=2, cache_len=32, paged=True, block_size=4, prefix_share=True)
    jm = JModel(jsmoke(ARCH, softmax=JSpec("int_pallas")), dtype=jnp.float32)
    jp = jm.init_split(jax.random.PRNGKey(0))[0]
    tcfg = tsmoke(ARCH, softmax=SoftmaxSpec("int_pallas"))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    jeng = JEngine(jm, jp, max_new=8)
    teng = Engine(Model(tcfg, dtype=torch.float32, device="cpu"), tp, max_new=8)
    # seed 1: on seeds 0, 2 and 4 of this trace the reference's serve differs
    # from its own eager on this jax (ROADMAP.md's caution), on 1, 3, 5 not
    jreqs = jsch.shared_prefix_trace(6, tcfg.vocab, prefix_len=9, seed=1,
                                     suffix_lens=(2, 4, 7), max_new_range=(4, 6),
                                     arrival_spacing=1.0)
    jrep = jeng.serve(jreqs, options=JOptions(kernel=kernel, report_cost=True, **kw))
    # precondition: the reference's own serve equals its eager on this trace
    for r, res in zip(jreqs, jrep.results):
        ref = jeng.generate(r.prompt[None], key=jax.random.PRNGKey(r.seed), mode="eager",
                            max_new=r.max_new, cache_len=jrep.cache_len)
        assert np.array_equal(res.tokens, ref.tokens[0]), ("precondition", r.rid)
    reqs = [tsch.Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new,
                         arrival=r.arrival, seed=r.seed) for r in jreqs]
    rep = teng.serve(reqs, ServeOptions(kernel=kernel, report_cost=True, **kw))
    for a, b in zip(rep.results, jrep.results):
        assert a.rid == b.rid and a.shared_prefix == b.shared_prefix
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.rid))
        assert dataclasses.astuple(a.cost) == dataclasses.astuple(b.cost), a.rid
    assert dataclasses.astuple(rep.cost) == dataclasses.astuple(jrep.cost)
    assert teng._last_alloc.state_signature() == jeng._last_alloc.state_signature()
    assert (rep.steps, rep.prefill_tokens, rep.shared_prefill_tokens, rep.leaked_blocks) == \
        (jrep.steps, jrep.prefill_tokens, jrep.shared_prefill_tokens, jrep.leaked_blocks)
    assert rep.shared_prefill_tokens > 0


def test_launcher_serves_minicpm3_on_cpu():
    from repro_torch.launch import serve

    rep = serve.main(["--arch", ARCH, "--smoke", "--continuous", "--paged",
                      "--prefix-share", "--kernel", "pallas", "--softmax", "int_pallas",
                      "--warm-steps", "0", "--device", "cpu", "--requests", "4",
                      "--max-new", "4"])
    assert len(rep.results) == 4 and rep.paged and rep.leaked_blocks == 0
    assert rep.cost.backend == "int_pallas" and rep.cost.cycles > 0
    res = serve.main(["--arch", ARCH, "--smoke", "--softmax", "int_pallas",
                      "--warm-steps", "0", "--device", "cpu", "--max-new", "4"])
    assert res.tokens.shape == (4, 12) and res.cost.cycles > 0
