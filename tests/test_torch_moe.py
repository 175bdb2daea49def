"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` at both smoke widths (dbrx-132b: 4 experts, top-2,
d 128, ``d_ff_expert`` 128; deepseek-v2-236b: the same with one shared
expert), f32 on both sides, the reference's own ``moe_init`` parameters.

* Routing exactly: capacity, every assignment's target (expert * C + slot,
  or the sentinel E * C of a drop) and the drop positions, wherever the
  k-th and (k+1)-th router probabilities are more than 1e-6 apart
  (asserted of the seeded data first: XLA and torch may round a
  probability an ulp apart, which could swap experts only at a near tie).
* ``y`` within 1e-5 (f32 products over d 128 and f 128 summed in another
  order; the outputs are O(1)), the combine weights within 1e-6, aux within
  1e-6; also at ``capacity_factor=0.25``, where assignments drop.
* ``capacity()`` over a range of group sizes; ``scatter_combine`` and
  ``expert_tp`` equal to ``gather``.
* ``"a2a"`` (per-segment capacity) against the reference's
  ``_moe_apply_a2a``: the dispatched expert rows bitwise equal (every
  (segment, expert) slot and every drop), f32 outputs within 1e-5 and aux
  within 1e-6, at 4 and 16 segments, with and without drops, with shared
  experts; its ``S * k % n`` fallback to the gather function; bf16 within
  the gather test's bound; ``expert_tp``'s parameter axes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.models import moe as jmoe
from repro.models.layers import Ctx as JCtx, split_tree
from repro_torch.configs.registry import get_config as tget, smoke_config as tsmoke
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Ctx

torch.set_num_threads(2)

ARCHS = ["dbrx-132b", "deepseek-v2-236b"]
Y_ATOL = 1e-5
W_ATOL = 1e-6
AUX_ATOL = 1e-6
MARGIN = 1e-6


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "softmax"}


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    arch = request.param
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    jp = split_tree(jmoe.moe_init(jax.random.PRNGKey(0), jcfg))[0]
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    x = np.random.default_rng(1).standard_normal((3, 20, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _margins(tp, x, cfg):
    """Per token, the gap between the k-th and (k+1)-th router
    probability."""
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"]["w"], -1)
    top = torch.sort(probs, -1, descending=True).values
    return (top[..., cfg.moe_top_k - 1] - top[..., cfg.moe_top_k]).numpy()


def _both(jcfg, tcfg, jp, tp, x, **over):
    jcfg, tcfg = dataclasses.replace(jcfg, **over), dataclasses.replace(tcfg, **over)
    j_route = jmoe._route(jp, jnp.asarray(x), jcfg, JCtx(dtype=jnp.float32))
    t_route = tmoe._route(tp, torch.from_numpy(x), tcfg, Ctx(dtype=torch.float32))
    j_out = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, JCtx(dtype=jnp.float32))
    t_out = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, Ctx(dtype=torch.float32))
    return j_route, t_route, j_out, t_out


def test_configs_are_the_reference_configs():
    for arch in ARCHS:
        assert _fields(tget(arch)) == _fields(jget(arch))
        assert _fields(tsmoke(arch)) == _fields(jsmoke(arch))
    cfg = tsmoke("deepseek-v2-236b")
    assert (cfg.n_layers, cfg.n_dense_prefix, cfg.n_experts, cfg.moe_top_k,
            cfg.n_shared_experts) == (3, 1, 4, 2, 1)


@pytest.mark.parametrize("factor", [1.25, 0.25], ids=["no_drop", "drops"])
def test_routing_output_and_aux_match_reference(layer, factor):
    jcfg, tcfg, jp, tp, x = layer
    margins = _margins(tp, x, tcfg)
    assert margins.min() > MARGIN, "seeded data with a near tie in its top-k"
    (jc, jt, jw, jaux_r), (tc, tt, tw, taux_r), (jy, jaux), (ty, taux) = _both(
        jcfg, tcfg, jp, tp, x, capacity_factor=factor)
    assert tc == jc
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    sentinel = tcfg.n_experts * tc
    dropped = tt.numpy() == sentinel
    np.testing.assert_array_equal(dropped, np.asarray(jt) == sentinel)
    if factor < 1:
        assert dropped.sum() > 0 and np.all(tw.numpy()[dropped] == 0)
    else:
        assert dropped.sum() < dropped.size // 20
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=W_ATOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=Y_ATOL)
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL
    assert abs(float(taux_r) - float(jaux_r)) <= AUX_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    for s in list(range(1, 70)) + [128, 500, 512, 2048, 4096]:
        assert tmoe.capacity(tcfg, s) == jmoe.capacity(jcfg, s), s
    # a decode step and a verify block of 5 get the same C (4) at full width
    assert tmoe.capacity(tcfg, 1) == tmoe.capacity(tcfg, 5) == 4


@pytest.mark.parametrize("impl", ["scatter_combine", "expert_tp"])
def test_other_impls_compute_gather(layer, impl):
    _, tcfg, _, tp, x = layer
    xt = torch.from_numpy(x)
    for factor in (1.25, 0.25):
        cfg = dataclasses.replace(tcfg, capacity_factor=factor)
        y, aux = tmoe.moe_apply(tp, xt, cfg, Ctx(dtype=torch.float32))
        y2, aux2 = tmoe.moe_apply(tp, xt, dataclasses.replace(cfg, moe_impl=impl),
                                  Ctx(dtype=torch.float32))
        assert torch.equal(y, y2) and torch.equal(aux, aux2)


def test_reference_impls_agree_with_the_port(layer):
    """The reference's own scatter_combine against the port (one function
    for every one-device impl)."""
    jcfg, tcfg, jp, tp, x = layer
    jy, _ = jmoe.moe_apply(jp, jnp.asarray(x), dataclasses.replace(
        jcfg, moe_impl="scatter_combine"), JCtx(dtype=jnp.float32))
    ty, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, Ctx(dtype=torch.float32))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=Y_ATOL)


def test_a2a_names_item_14(layer):
    """``"a2a"`` where the default 16 segments do not divide the S * k = 40
    assignments of the smoke layer's rows: the reference falls back to
    ``scatter_combine`` and the port to its gather code, which give the
    same outputs (within ``Y_ATOL``) and aux."""
    jcfg, tcfg, jp, tp, x = layer
    jc, tc = (dataclasses.replace(c, moe_impl="a2a") for c in (jcfg, tcfg))
    assert (x.shape[1] * tc.moe_top_k) % tc.moe_a2a_segments and tmoe.groups(tc, 20)[0] == 1
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jc, JCtx(dtype=jnp.float32))
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tc, Ctx(dtype=torch.float32))
    gy, gaux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, Ctx(dtype=torch.float32))
    assert torch.equal(ty, gy) and torch.equal(taux, gaux)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=Y_ATOL)
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL


# the reference's own a2a case (tests/test_models_smoke.py::
# test_moe_a2a_equivalence): 8 experts, top-2, one shared expert
A2A_CFG = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
               d_ff=64, vocab=64, n_experts=8, moe_top_k=2, d_ff_expert=64,
               capacity_factor=16.0, n_shared_experts=1, moe_impl="a2a",
               moe_a2a_segments=4)


def _a2a_pair(**over):
    from repro.configs.base import ModelConfig as JConfig
    from repro_torch.configs.base import ModelConfig as TConfig

    jcfg, tcfg = JConfig(**dict(A2A_CFG, **over)), TConfig(**dict(A2A_CFG, **over))
    jp = split_tree(jmoe.moe_init(jax.random.PRNGKey(0), jcfg))[0]
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    return jcfg, tcfg, jp, tp


def _dispatched(jp, tp, x, jcfg, tcfg, monkeypatch):
    """Each side's outputs, aux and the rows it dispatched to the experts,
    as [B, E, n * C, d] (the reference's buffer; the port's [E, B * n * C,
    d] reshaped): a slot holds its token's row, an empty slot zeros."""
    seen = {}

    def spy(p, buf, cfg, ctx):
        seen["ref"] = np.asarray(buf)
        return experts_ffn(p, buf, cfg, ctx)

    experts_ffn = jmoe._experts_ffn
    monkeypatch.setattr(jmoe, "_experts_ffn", spy)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, JCtx(dtype=jnp.float32))

    def experts(buf):
        seen["port"] = buf.clone()
        return tmoe._experts_ffn(tp, buf, tcfg, Ctx(dtype=torch.float32))

    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, Ctx(dtype=torch.float32),
                              experts=experts)
    b, e = x.shape[0], tcfg.n_experts
    port = seen["port"].reshape(e, b, -1, x.shape[-1]).transpose(0, 1).numpy()
    return (jy, jaux), (ty, taux), seen["ref"].reshape(port.shape), port


@pytest.mark.parametrize("segments", [4, 16])
@pytest.mark.parametrize("factor", [16.0, 1.0], ids=["no_drop", "drops"])
def test_a2a_matches_reference(segments, factor, monkeypatch):
    """The reference's a2a case at capacity 16 (nothing drops: a2a equals
    gather, as its test holds; 16 tokens a row) and at capacity 1.0
    (segments of 32 assignments drop, and the per-segment bound differs
    from gather's per-sequence one), over 4 and 16 segments: the
    dispatched rows bitwise equal, y within the reference's test's limits
    (1e-5 / 1e-6), aux within ``AUX_ATOL``."""
    jcfg, tcfg, jp, tp = _a2a_pair(moe_a2a_segments=segments, capacity_factor=factor)
    s = 16 if factor > 1 else 16 * segments
    x = np.random.default_rng(1).normal(0, 1, (2, s, 32)).astype(np.float32)
    g, c = tmoe.groups(tcfg, s)
    assert g == segments and c == tmoe.segment_capacity(tcfg, 2 * s // segments)
    (jy, jaux), (ty, taux), ref_buf, port_buf = _dispatched(jp, tp, x, jcfg, tcfg,
                                                            monkeypatch)
    np.testing.assert_array_equal(port_buf, ref_buf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL
    gy, gaux = tmoe.moe_apply(tp, torch.from_numpy(x), dataclasses.replace(
        tcfg, moe_impl="gather"), Ctx(dtype=torch.float32))
    assert torch.equal(gaux, taux)
    # rows each segment's slots could not take: zero at capacity 16
    kept = (np.abs(port_buf).sum(-1) > 0).sum()
    if factor > 1:
        assert kept == x.shape[0] * s * tcfg.moe_top_k
        np.testing.assert_allclose(ty.numpy(), gy.numpy(), rtol=1e-5, atol=1e-6)
    else:
        assert kept < x.shape[0] * s * tcfg.moe_top_k
        assert (ty - gy).abs().max().item() > 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_a2a_smoke_layers_match_reference(arch, monkeypatch):
    """Both smoke layers (deepseek-v2's with its shared expert) on rows of
    128 tokens (S * k = 256: the 16 default segments divide it), with
    drops at capacity 1.0: the dispatched rows bitwise, y and aux within
    the gather test's limits, the seeded data's top-k margins clear."""
    jcfg = dataclasses.replace(jsmoke(arch), moe_impl="a2a", capacity_factor=1.0)
    tcfg = dataclasses.replace(tsmoke(arch), moe_impl="a2a", capacity_factor=1.0)
    jp = split_tree(jmoe.moe_init(jax.random.PRNGKey(0), jcfg))[0]
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    x = np.random.default_rng(2).standard_normal((2, 128, jcfg.d_model)).astype(np.float32)
    assert _margins(tp, x, tcfg).min() > MARGIN
    assert tmoe.groups(tcfg, 128) == (16, 4)
    (jy, jaux), (ty, taux), ref_buf, port_buf = _dispatched(jp, tp, x, jcfg, tcfg,
                                                            monkeypatch)
    np.testing.assert_array_equal(port_buf, ref_buf)
    assert (np.abs(port_buf).sum(-1) > 0).sum() < 2 * 128 * tcfg.moe_top_k  # drops
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=Y_ATOL)
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL


def test_a2a_bf16_close_to_reference():
    """bf16 on both sides, 16 segments, capacity 16: the outputs within the
    bf16 gather test's bound (max 2^-4, RMS 0.01)."""
    jcfg, tcfg, jp, tp = _a2a_pair(moe_a2a_segments=16)
    x = np.random.default_rng(3).normal(0, 1, (2, 16, 32)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jy, _ = jmoe.moe_apply(jp, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jcfg,
                           JCtx(dtype=jnp.bfloat16))
    ty, _ = tmoe.moe_apply(jax.tree.map(lambda t: t.to(torch.bfloat16), tp), xb, tcfg,
                           Ctx(dtype=torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    d = np.abs(np.asarray(jy.astype(jnp.float32)) - ty.float().numpy())
    assert float(d.max()) <= 0.0625 and float(np.sqrt((d ** 2).mean())) <= 0.01


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["gather", "expert_tp", "a2a"])
def test_expert_axes_follow_moe_impl(arch, impl):
    """``Model.param_axes()`` labels the expert leaves as the reference's
    ``_expert_w``: by ``experts`` (EP), or every expert's hidden by
    ``mlp`` under ``expert_tp``."""
    from repro.models.model import Model as JModel
    from repro_torch.models.model import Model

    jcfg = dataclasses.replace(jsmoke(arch), moe_impl=impl)
    tcfg = dataclasses.replace(tsmoke(arch), moe_impl=impl)
    got = Model(tcfg, device="cpu").param_axes()
    assert got == JModel(jcfg).param_axes()
    want = ("stacked", None, "embed", "mlp") if impl == "expert_tp" else \
        ("stacked", "experts", "embed", "expert_mlp")
    assert got["stack"]["layers"]["ffn"]["gate"]["w"] == want


def test_ties_go_to_the_lower_expert():
    """Equal router probabilities: the lower expert index first, as
    ``jax.lax.top_k``."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    w, i = tmoe._top_k(probs, 2)
    jw, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i.tolist() == [[1, 2], [0, 1]] and torch.equal(w, torch.from_numpy(np.array(jw)))


def test_bf16_layer_close_to_reference(layer):
    """bf16 compute on both sides (the serving dtype): the experts equal
    wherever the top-k margin exceeds 1e-2 (a bf16 router product may move a
    probability by ~1e-3), the outputs within a few bf16 ulps of O(1)
    values (max 2^-4, RMS 0.01)."""
    jcfg, tcfg, jp, tp, x = layer
    tpb = jax.tree.map(lambda t: t.to(torch.bfloat16), tp)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    jy, _ = jmoe.moe_apply(jp, jx, jcfg, JCtx(dtype=jnp.bfloat16))
    ty, _ = tmoe.moe_apply(tpb, xb, tcfg, Ctx(dtype=torch.bfloat16))
    jc, jt, _, _ = jmoe._route(jp, jx, jcfg, JCtx(dtype=jnp.bfloat16))
    tc, tt, _, _ = tmoe._route(tpb, xb, tcfg, Ctx(dtype=torch.bfloat16))
    kept = (np.asarray(jt) < jc * jcfg.n_experts) & (tt.numpy() < tc * tcfg.n_experts)
    wide = np.repeat(_margins(tp, x, tcfg) > 1e-2, tcfg.moe_top_k, axis=-1) & kept
    assert wide.mean() > 0.5
    np.testing.assert_array_equal((tt.numpy() // tc)[wide], (np.asarray(jt) // jc)[wide])
    d = np.abs(np.asarray(jy.astype(jnp.float32)) - ty.float().numpy())
    assert float(d.max()) <= 0.0625 and float(np.sqrt((d ** 2).mean())) <= 0.01
