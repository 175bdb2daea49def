"""The port's training stack (loss, AdamW, schedules, gradient compression,
the train step, remat, packing) against the reference, on the reference's
own ``Model.init(PRNGKey(0))`` parameters carried over by
``repro_torch.convert`` as f32 master weights.

Bounds (stated before the comparison, from the dtype):

* loss, schedules, AdamW on the same numpy grads and state: within 1e-6
  (f32 arithmetic in another order: a few ulps).
* A train step computed in f32 (smoke configs, 2 x 32 tokens): loss and
  grad norm within 1e-5 relative; every gradient leaf within 1e-4 of the
  reference's in relative L2 norm (XLA and torch sum the products in
  other orders; the integer kinds can move an Alg.-1 code at an ulp, which
  the norm bound still covers at smoke size). The gradients are read from
  the first moment after the step, ``m = (1 - b1) * clipped g`` on both
  sides (one jitted reference step a case: its compile dominates the
  time). Updated parameters: Adam's first step is sign-like, so an entry
  whose gradient is near zero can flip by up to 2 lr; the largest
  difference must stay below 2.2 lr and the mean below 2e-5 (0.4 % of
  the step's lr).
* The same step computed in bf16 from f32 masters (the card's training
  setup): loss within 1e-4 relative, grad norm within 5e-3 relative, every
  gradient leaf within 5e-2 in relative L2 norm (bf16 products rounded in
  other orders), updated parameters below 2.2 lr at most and 2e-4 in mean.
* Under ``int`` the query and key projections get exactly zero gradient in
  both packages (Alg. 1's rounding passes none to the scores).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from repro.configs.registry import smoke_config as jsmoke
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.data.packing import pack_documents as jpack
from repro.data.synthetic import family_batch
from repro.models.model import Model as JModel
from repro.training import optimizer as jopt
from repro.training.grad_compression import compress as jcompress
from repro.training.loss import softmax_xent as jxent
from repro.training.step import init_state as jinit, make_train_step as jmake
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.convert import train_state_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec as TSpec
from repro_torch.data.packing import pack_documents as tpack
from repro_torch.models.model import Model as TModel
from repro_torch.training import optimizer as topt
from repro_torch.training.grad_compression import compress, decompress, init_error_feedback
from repro_torch.training.loss import IGNORE, perplexity, softmax_xent
from repro_torch.training.step import make_grad_fn, make_train_step

torch.set_num_threads(2)

PEAK, WARM, TOTAL = 1e-2, 2, 10
LR1 = 5e-3                       # the cosine schedule's lr at step 1


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _get(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _leaves(jtree, ttree):
    """(key, reference leaf, port leaf) for every leaf of a params tree."""
    flat, _ = jtu.tree_flatten_with_path(jtree)
    return [("/".join(str(p.key) for p in path), np.asarray(leaf),
             _get(ttree, path).detach().numpy()) for path, leaf in flat]


def _pair(arch, kind, dtype="float32", **overrides):
    jcfg = jsmoke(arch, softmax=JSpec(kind))
    tcfg = tsmoke(arch, softmax=TSpec(kind))
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        tcfg = dataclasses.replace(tcfg, **overrides)
    jm = JModel(jcfg, dtype=getattr(jnp, dtype))
    tm = TModel(tcfg, dtype=getattr(torch, dtype), device="cpu")
    return jm, tm


def _ref_step(jm, batch, microbatches=0, grad_compress=False):
    """The reference's jitted step from its init state."""
    opt = jopt.AdamW(lr=jopt.cosine_schedule(PEAK, WARM, TOTAL))
    state = jinit(jm, opt, jax.random.PRNGKey(0), grad_compress=grad_compress)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new, met = jax.jit(jmake(jm, opt, grad_compress=grad_compress,
                             microbatches=microbatches))(state, jb)
    return state, new, met


def _port_step(tm, jstate, batch, microbatches=0, grad_compress=False):
    opt = topt.AdamW(lr=topt.cosine_schedule(PEAK, WARM, TOTAL))
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tm.cfg, "cpu")
    new, met = make_train_step(tm, opt, grad_compress=grad_compress,
                               microbatches=microbatches)(state, batch)
    return state, new, met


BOUNDS = {"float32": dict(loss=1e-5, gnorm=1e-5, grad=1e-4, upd_mean=2e-5),
          "bfloat16": dict(loss=1e-4, gnorm=5e-3, grad=5e-2, upd_mean=2e-4)}


def _check_step(jm, tm, batch, dtype="float32", grad=None, **kw):
    b = dict(BOUNDS[dtype], **({} if grad is None else {"grad": grad}))
    jstate, jnew, jmet = _ref_step(jm, batch, **kw)
    tstate, tnew, tmet = _port_step(tm, jstate, batch, **kw)
    jgrads, tgrads = jnew.opt.m, tnew.opt.m         # (1 - b1) * clipped g
    for k in ("loss", "aux_loss", "accuracy", "lr"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= b["loss"] * max(1.0, abs(float(jmet[k]))), k
    assert abs(float(tmet["grad_norm"]) / float(jmet["grad_norm"]) - 1) <= b["gnorm"]
    zero = []
    for key, jg, tg in _leaves(jgrads, tgrads):
        assert tg.shape == jg.shape and tg.dtype == np.float32, key
        if not np.any(jg):
            zero.append(key)
            assert not np.any(tg), key          # zero in both packages
            continue
        rel = np.linalg.norm(tg - jg) / np.linalg.norm(jg)
        assert rel <= b["grad"], (key, rel)
    assert int(tnew.opt.step) == int(jnew.opt.step) == 1
    for key, jp, tp in _leaves(jnew.params, tnew.params):
        d = np.abs(tp - jp)
        assert d.max() <= 2.2 * LR1 and d.mean() <= b["upd_mean"], (key, d.max(), d.mean())
    return zero, tnew, jnew, tmet


def _batch(cfg, b=2, s=32, seed=0):
    return family_batch(cfg, b, s, seed=seed)


# ------------------------------------------------------------------ loss, optimizer


@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_softmax_xent_against_reference(z_loss):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (2, 16, 64)).astype(np.float32)
    labels = rng.integers(0, 64, (2, 16)).astype(np.int32)
    labels[0, :5] = IGNORE
    labels[1, 3] = np.argmax(logits[1, 3])          # one right prediction
    jl, jm = jxent(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss)
    tl, tm = softmax_xent(_t(logits), _t(labels), z_loss=z_loss)
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert float(tm["accuracy"]) == float(jm["accuracy"]) > 0
    assert int(tm["tokens"]) == int(jm["tokens"]) == 27
    np.testing.assert_allclose(float(perplexity(_t(logits), _t(labels))),
                               float(jnp.exp(jxent(jnp.asarray(logits),
                                                   jnp.asarray(labels), 0.0)[0])),
                               rtol=1e-6)


def test_schedules_against_reference():
    jc, tc = jopt.cosine_schedule(3e-3, 10, 100), topt.cosine_schedule(3e-3, 10, 100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        j = float(jc(jnp.int32(s)))
        t = float(tc(torch.tensor(s, dtype=torch.int32)))
        assert abs(t - j) <= 1e-6 * 3e-3, s
    assert float(topt.constant_schedule(1e-3)(torch.tensor(7, dtype=torch.int32))) == \
        float(jopt.constant_schedule(1e-3)(jnp.int32(7)))


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_against_reference(clip):
    """Three updates from the same numpy grads: params, m, v and the global
    norm within 1e-6 of the reference's (relative to each leaf's scale)."""
    rng = np.random.default_rng(1)
    params = {"a": {"w": rng.normal(0, 1, (8, 16)).astype(np.float32)},
              "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    jo = jopt.AdamW(lr=jopt.cosine_schedule(1e-2, 2, 10), clip_norm=clip)
    to = topt.AdamW(lr=topt.cosine_schedule(1e-2, 2, 10), clip_norm=clip)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(_t, params)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda x: rng.normal(0, 2, x.shape).astype(np.float32), params)
        jp, js, jn = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tn = to.update(jax.tree.map(_t, g), ts, tp)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        assert float(topt.global_norm(jax.tree.map(_t, g))) == pytest.approx(
            float(jopt.global_norm(g)), rel=1e-6)
        for jt, tt in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            for key, a, b in _leaves(jt, tt):
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * max(1, np.abs(a).max()))
    assert int(ts.step) == 3 and ts.step.dtype == torch.int32


def test_grad_compression_error_feedback():
    """payload.float() + new residual == grads + residual, bitwise, as the
    reference's pair; the residual carries the cast's error forward."""
    rng = np.random.default_rng(2)
    g = {"w": rng.normal(0, 1e-3, (64, 64)).astype(np.float32)}
    ef = init_error_feedback(jax.tree.map(_t, g))
    jef = jax.tree.map(jnp.zeros_like, g)
    for _ in range(5):
        tg = jax.tree.map(_t, g)
        payload, new_e = compress(tg, ef)
        assert payload["w"].dtype == torch.bfloat16
        assert torch.equal(decompress(payload)["w"] + new_e["w"], tg["w"] + ef["w"])
        jpay, jef = jcompress(jax.tree.map(jnp.asarray, g), jef)
        np.testing.assert_array_equal(payload["w"].float().numpy(),
                                      np.asarray(jpay["w"], np.float32))
        np.testing.assert_array_equal(new_e["w"].numpy(), np.asarray(jef["w"]))
        ef = new_e


# --------------------------------------------------------------------- train step


@pytest.mark.parametrize("kind", ["fp", "int", "int_ste"])
def test_train_step_olmo_against_reference(kind):
    jm, tm = _pair("olmo-1b", kind)
    zero, *_ = _check_step(jm, tm, _batch(tm.cfg))
    qk = sorted(k for k in zero if k.endswith(("wq/w", "wk/w")))
    # Alg. 1's rounding gives the scores no gradient; the STE and fp do
    assert qk == (["stack/layers/attn/wk/w", "stack/layers/attn/wq/w"]
                  if kind == "int" else [])


@pytest.mark.parametrize("kind", ["fp", "int"])
def test_train_step_bf16_compute_from_f32_masters(kind):
    """The card's setup: f32 masters, bf16 compute (the weights cast at
    each use, the tied embedding's two uses summed in f32)."""
    jm, tm = _pair("olmo-1b", kind, "bfloat16")
    zero, *_ = _check_step(jm, tm, _batch(tm.cfg), "bfloat16")
    assert ("stack/layers/attn/wq/w" in zero) == (kind == "int")


FAMILIES = [("minicpm3-4b", "int"), ("dbrx-132b", "fp"), ("mamba2-780m", "fp"), ("hymba-1.5b", "int"), ("whisper-base", "fp"),
            ("qwen2-vl-7b", "int")]


@pytest.mark.parametrize("arch,kind", FAMILIES, ids=[a for a, _ in FAMILIES])
def test_train_step_family_against_reference(arch, kind):
    """One step of each other family: MLA (its query and key paths get zero
    under int), MoE with its aux loss, SSM, hybrid (5 layers: global
    attention at 0, 2 and 4, a window layer between each), encoder-decoder
    (frames) and M-RoPE ([3, B, S] positions)."""
    jm, tm = _pair(arch, kind, **({"n_layers": 5} if arch == "hymba-1.5b" else {}))
    zero, _, _, met = _check_step(jm, tm, _batch(tm.cfg))
    assert (float(met["aux_loss"]) > 0) == (tm.cfg.family == "moe")
    if arch == "minicpm3-4b":
        assert {"stack/layers/attn/wdq/w", "stack/layers/attn/wuq/w",
                "stack/layers/attn/wuk/w", "stack/layers/attn/wkr/w"} <= set(zero)


def test_microbatches_and_compression_against_reference():
    """qwen2-vl-7b: microbatches=2 splits M-RoPE's [3, B, S] positions
    along B, as the reference's rule; with grad_compress the step equals
    the reference's too, within one bf16 ulp (2^-8 relative) of the
    payload where the two sides' f32 gradients round to neighbouring bf16
    values, and the residual is non-zero."""
    jm, tm = _pair("qwen2-vl-7b", "fp")
    batch = _batch(tm.cfg, b=4, s=16)
    _check_step(jm, tm, batch, microbatches=2)
    _, tnew, jnew, _ = _check_step(jm, tm, batch, grad=2 ** -8, grad_compress=True)
    assert any(t.abs().max() > 0 for t in jax.tree.leaves(tnew.error_fb))


def test_microbatches_equal_whole_batch():
    """microbatches=2 against 1 on the port alone: the averaged gradients
    within 1e-5 in relative norm, the metrics within 1e-6."""
    _, tm = _pair("olmo-1b", "int")
    params = tm.init(dtype=torch.float32)
    batch = _batch(tm.cfg, b=4, s=32, seed=3)
    g1, m1 = make_grad_fn(tm)(params, batch)
    g2, m2 = make_grad_fn(tm, microbatches=2)(params, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-6 * float(m1["loss"])
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        assert torch.linalg.norm(a - b) <= 1e-5 * max(torch.linalg.norm(a), 1e-30)
    with pytest.raises(ValueError, match="cannot microbatch"):
        make_grad_fn(tm, microbatches=3)(params, batch)


@pytest.mark.parametrize("arch", ["olmo-1b", "dbrx-132b"])
def test_remat_modes_give_equal_grads(arch):
    """remat "full" / "dots" / "none": the same gradients, bitwise (the
    recomputed forward is the forward), and the AP meter records a step's
    softmaxes once whatever the mode."""
    from repro_torch.backends import telemetry
    grads, costs = {}, {}
    for mode in ("none", "full", "dots"):
        _, tm = _pair(arch, "int", remat=mode)
        params = tm.init(dtype=torch.float32)
        with telemetry.collect() as acc:
            grads[mode], _ = make_grad_fn(tm)(params, _batch(tm.cfg, seed=4))
        costs[mode] = acc.total()
    for mode in ("full", "dots"):
        for a, b in zip(jax.tree.leaves(grads["none"]), jax.tree.leaves(grads[mode])):
            assert torch.equal(a, b), mode
        assert costs[mode] == costs["none"] and costs[mode].cycles > 0


def test_consmax_smx_leaves_are_trained():
    """ConSmax's learnable beta / gamma are f32 leaves the step updates, as
    the reference's (its STE backward gives them gradients)."""
    jm, tm = _pair("olmo-1b", "consmax")
    zero, tnew, _, _ = _check_step(jm, tm, _batch(tm.cfg))
    smx = tnew.params["stack"]["layers"]["attn"]["smx"]
    assert smx["beta"].dtype == torch.float32 and not any("smx" in k for k in zero)
    beta0 = tm.cfg.softmax.backend().cfg.beta
    assert torch.any(smx["beta"] != beta0)


def test_non_differentiable_backend_refuses_to_train():
    _, tm = _pair("olmo-1b", "int_pallas")
    with pytest.raises(ValueError, match="cannot be differentiated"):
        make_grad_fn(tm)


def test_pack_documents_against_reference():
    rng = np.random.default_rng(5)
    docs = [rng.integers(1, 100, n).astype(np.int32) for n in (3, 17, 40, 1, 9, 33)]
    for seq in (8, 16, 33):
        j, t = jpack(docs, seq), tpack(docs, seq)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(t[k], j[k])
        assert (t["labels"] == IGNORE).any()


# --------------------------------------------------------------------- loss curves


def loss_curves(jm, tm, batch, lr, steps):
    """The loss of each of ``steps`` steps on one repeated ``batch``, the
    reference's jitted step and the port's, both from the reference's init
    (carried over by the converter) under the train launchers' AdamW and
    schedule: ``cosine_schedule(lr, max(steps // 10, 1), steps)``."""
    warm = max(steps // 10, 1)
    jo = jopt.AdamW(lr=jopt.cosine_schedule(lr, warm, steps))
    to = topt.AdamW(lr=topt.cosine_schedule(lr, warm, steps))
    jstate = jinit(jm, jo, jax.random.PRNGKey(0))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tm.cfg, "cpu")
    jstep, jb = jax.jit(jmake(jm, jo)), {k: jnp.asarray(v) for k, v in batch.items()}
    jl, tl = [], []
    for _ in range(steps):
        jstate, met = jstep(jstate, jb)
        jl.append(float(met["loss"]))
    del jstate, jstep
    tstep = make_train_step(tm, to)
    for _ in range(steps):
        tstate, met = tstep(tstate, batch)
        tl.append(float(met["loss"]))
    return jl, tl


@pytest.mark.parametrize("kind,bound", [("fp", 1e-5), ("int", 1e-3)])
def test_loss_curve_follows_reference_at_launcher_lr(kind, bound):
    """8 steps at the train launchers' default lr 1e-2 on one repeated
    batch, f32: every step's loss within ``bound`` relative of the
    reference's. Under fp the bound is one step's (1e-5): f32 arithmetic
    in another order. Under ``int`` it is 1e-3: Alg. 1's codes are
    integers, so a score an ulp away can move a code by one, and Adam's
    sign-like update of a near-zero gradient carries that into the later
    steps."""
    jm, tm = _pair("olmo-1b", kind)
    jl, tl = loss_curves(jm, tm, _batch(tm.cfg, b=4, s=32, seed=6), 1e-2, 8)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    for step, (j, t) in enumerate(zip(jl, tl)):
        assert abs(t - j) <= bound * abs(j), (step, jl, tl)


if __name__ == "__main__":
    # The launchers' lr 1e-2 at full width: olmo-1b at its published widths
    # and 1 layer, bf16 compute from f32 masters, remat "full", ``int``, the
    # training phase's batch (8 x 512 of SyntheticCorpus(vocab, seed=1234))
    # repeated for 8 steps; prints both packages' loss curves.
    #   PYTHONPATH=src python tests/test_torch_training.py [lr]
    import sys
    import time

    from repro.configs.registry import get_config as jget
    from repro_torch.configs.registry import get_config as tget
    from repro_torch.data.synthetic import SyntheticCorpus

    lr = float(sys.argv[1]) if len(sys.argv) > 1 else 1e-2
    torch.set_num_threads(8)
    jcfg = dataclasses.replace(jget("olmo-1b", softmax=JSpec("int")), n_layers=1)
    tcfg = dataclasses.replace(tget("olmo-1b", softmax=TSpec("int")), n_layers=1)
    assert jcfg.remat == tcfg.remat == "full"
    batch = SyntheticCorpus(tcfg.vocab, seed=1234).batch(8, 512, seed=0)
    t0 = time.perf_counter()
    jl, tl = loss_curves(JModel(jcfg, dtype=jnp.bfloat16),
                         TModel(tcfg, dtype=torch.bfloat16, device="cpu"), batch, lr, 8)
    print(f"olmo-1b, 1 layer at d_model {tcfg.d_model}, vocab {tcfg.vocab}, bf16 compute, "
          f"int, lr {lr:g}, batch 8 x 512 repeated ({time.perf_counter() - t0:.0f} s on the CPU)")
    print("reference losses", [round(v, 4) for v in jl])
    print("port losses     ", [round(v, 4) for v in tl])
    print("largest |port - reference|", max(abs(a - b) for a, b in zip(jl, tl)))
