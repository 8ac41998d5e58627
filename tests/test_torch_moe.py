"""The port's MoE layer against the JAX package (``repro.layers.moe``):
capacity, routing (top-k order on ties included), dispatch with capacity
drops, the layer's output, reduced qwen3-moe through the model entry points
and both engines.

``reduced()`` raises ``capacity_factor`` to 8 so that no token drops at
smoke scale; the real configs run at 1.25. The layer and the engines are
therefore also held at 1.25 (passed to both sides), on inputs whose tokens
route alike (a shared component plus noise, or repeated prompt tokens), so
that experts overflow: the tests assert that drops occurred.

Tolerance: atol 2e-5, rtol 2e-4 on fp32 outputs and logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.layers import moe as jmoe
from repro.models import get_model as j_get_model
from repro.runtime import BatchingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.layers import moe
from repro_torch.models import Model
from repro_torch.runtime import BatchingEngine, make_paged_serve_step
from torch_parity import TOL, family_pair, greedy, serve_logs

torch.set_num_threads(1)

ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")


def _moe_cfg(arch, factor=None):
    c = j_reduced(j_get_config(arch)).moe
    return c if factor is None else dataclasses.replace(
        c, capacity_factor=factor)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch):
    """Full and reduced configs, the real factor and the reduced one."""
    for c in (j_get_config(arch).moe, _moe_cfg(arch), _moe_cfg(arch, 1.25)):
        for n in (1, 3, 8, 17, 64, 127, 600, 1024, 1200, 4096):
            assert moe.capacity(n, c) == jmoe.capacity(n, c), (c, n)


def _layer(arch, factor):
    """JAX MoE params (reduced widths, d_model 128) and the same carried
    into the port."""
    c = _moe_cfg(arch, factor)
    jcfg = j_reduced(j_get_config(arch))
    jopts = jmoe.MoEOpts(cfg=c, act=jcfg.act, norm_topk=c.norm_topk)
    opts = moe.MoEOpts(cfg=c, act=jcfg.act, norm_topk=c.norm_topk)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), 128, jopts)
    cfg = reduced(get_config(arch))
    tp = params_from_numpy({"moe": jax.tree.map(np.asarray, jp)},
                           cfg.replace(param_dtype="float32"))["moe"]
    return jopts, jp, opts, tp


def _routed_alike(b, s, seed):
    """(b, s, 128) inputs whose tokens share one component: the router
    sends most of them to the same experts."""
    rng = np.random.default_rng(seed)
    common = rng.standard_normal((1, 1, 128))
    return (common + 0.5 * rng.standard_normal((b, s, 128))) \
        .astype(np.float32)


@pytest.mark.parametrize("factor", [None, 1.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, factor):
    """The layer at the reduced factor (8: no drops) and at the configs'
    own 1.25 (drops asserted); deepseek adds 2 shared experts and
    ``norm_topk=False``. The port's routing equals ``jax.lax.top_k`` of the
    reference's probabilities."""
    jopts, jp, opts, tp = _layer(arch, factor)
    x = _routed_alike(2, 64, seed=1)
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jopts)
    ty, taux = moe.moe_forward(tp, torch.from_numpy(x), opts)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=1e-6)
    xf = torch.from_numpy(x).reshape(1, 128, 128)
    _, _, expert, pos, C, _ = moe.route(tp, xf, opts)
    jprobs = jax.nn.softmax(jnp.einsum("dtc,ce->dte", jnp.asarray(
        xf.numpy()), jp["router"]), axis=-1)
    _, jexpert = jax.lax.top_k(jprobs, opts.cfg.top_k)
    assert np.array_equal(expert.numpy(), np.asarray(jexpert))
    drops = int((pos >= C).sum())
    if factor is None:
        assert drops == 0
    else:
        assert drops > 0, "no assignment dropped: the test holds nothing"


@pytest.mark.parametrize("case", ["all_tied", "two_tied_on_top"])
def test_topk_order_on_ties(case):
    """Exactly tied router probabilities: the lower expert index comes
    first, as ``jax.lax.top_k`` orders them (``torch.topk`` does not
    promise it). At capacity 1.25 the order decides which assignment is
    dropped, so the outputs are compared too."""
    jopts, jp, opts, tp = _layer("qwen3-moe-30b-a3b", 1.25)
    router = np.zeros((128, 8), np.float32)
    if case == "two_tied_on_top":
        col = np.random.default_rng(2).standard_normal(128)
        router[:, 2] = router[:, 5] = col
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = _routed_alike(1, 32, seed=3)
    x = np.abs(x) if case == "two_tied_on_top" else x
    if case == "two_tied_on_top":      # x . col > 0: experts 2 and 5 lead
        x = x * np.sign(router[:, 2])[None, None]
    _, _, expert, pos, C, _ = moe.route(tp, torch.from_numpy(x), opts)
    first = (0, 1) if case == "all_tied" else (2, 5)
    assert (expert.numpy()[..., :2] == np.array(first)).all()
    jprobs = jax.nn.softmax(jnp.einsum("dtc,ce->dte", jnp.asarray(x),
                                       jp["router"]), axis=-1)
    assert np.array_equal(expert.numpy(),
                          np.asarray(jax.lax.top_k(jprobs, 2)[1]))
    assert int((pos >= C).sum()) > 0
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jopts)
    ty, taux = moe.moe_forward(tp, torch.from_numpy(x), opts)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=1e-6)


def test_router_stays_fp32_under_bf16_params():
    """``params_from_numpy`` keeps the router in fp32 whatever
    ``param_dtype`` is, as the reference's ``init_moe`` makes it; the
    expert weights take ``param_dtype``."""
    cfg = reduced(get_config("qwen3-moe-30b-a3b")).replace(
        param_dtype="bfloat16")
    jmodel = j_get_model(j_reduced(j_get_config("qwen3-moe-30b-a3b")))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    p = params_from_numpy(tree, cfg)["stages"][0]["moe"]
    assert p["router"].dtype == torch.float32
    assert p["wg"].dtype == p["wd"].dtype == torch.bfloat16
    own = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert own["stages"][0]["moe"]["router"].dtype == torch.float32


@pytest.fixture(scope="module")
def qwen():
    return family_pair("qwen3-moe-30b-a3b")


def test_qwen3_moe_prefill_then_decode_matches_reference(qwen):
    jmodel, jparams, cfg, params = qwen
    model = Model(cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)) \
        .astype(np.int32)
    jh, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 64)
    th, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 64)
    jl, tl = jmodel.logits(jparams, jh), model.logits(params, th)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt, near = greedy(jl[:, -1], tl[:, -1])
    pos = np.full((2,), 40, np.int32)
    for _ in range(6):
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(nxt[:, None]),
                               jnp.asarray(pos))
        tl, tc = model.decode(params, tc, torch.tensor(nxt[:, None]),
                              torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt, n = greedy(jl[:, 0], tl[:, 0])
        near += n
        pos = pos + 1
    assert near <= 2, f"{near} of 14 greedy steps below the margin"


def test_qwen3_moe_paged_decode_matches_reference(qwen):
    """24 steps through a paged pool: two rows on shuffled pages, one row
    inactive (pos -1; it still routes and takes expert capacity)."""
    jmodel, jparams, cfg, params = qwen
    model = Model(cfg, device="cpu")
    ps, n_pages, nb, B = 4, 24, 6, 3
    jpool = jmodel.make_paged_caches(n_pages, ps)
    tpool = model.make_paged_caches(n_pages, ps)
    step = make_paged_serve_step(model)
    pages = np.random.default_rng(1).permutation(np.arange(1, n_pages))
    bt = np.zeros((B, nb), np.int32)
    bt[0], bt[2] = pages[:nb], pages[nb:2 * nb]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, B) \
        .astype(np.int32)
    near = 0
    for t in range(24):
        pos = np.array([t, -1, t], np.int32)
        jl, jpool = jmodel.decode_paged(jparams, jpool,
                                        jnp.asarray(toks[:, None]),
                                        jnp.asarray(pos), jnp.asarray(bt))
        tl, tpool = step(params, tpool, torch.tensor(toks[:, None]),
                         torch.from_numpy(pos), torch.from_numpy(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        toks, n = greedy(jl[:, 0], tl[:, 0])
        near += n
    assert near <= 4, f"{near} of {B * 24} greedy steps below the margin"


# (prompt, seed, tenant, new tokens): prompts of 2 (decode-step prefill) to
# 50 tokens (a 64-token bucket); the last two are one token repeated, so
# that at capacity 1.25 their prefill overflows the experts it routes to
SPEC = [(2, 1, "a", 5), (9, 2, "b", 6), (23, 3, "a", 7), (50, 4, "b", 5),
        ([7] * 40, 0, "a", 6), ([11] * 30, 0, "b", 4)]


@pytest.mark.parametrize("factor", [None, 1.25])
@pytest.mark.parametrize("paged", [False, True])
def test_qwen3_moe_engine_token_logs_match_reference(qwen, paged, factor,
                                                     monkeypatch):
    """Both engines, 3 slots: padded prefill buckets and idle decode rows
    take expert capacity on both sides, and the token logs are equal. At
    1.25 the run must have dropped assignments."""
    jmodel, jparams, cfg, params = qwen
    jm, model = jmodel.model, Model(cfg, device="cpu")
    if factor is not None:
        moe_cfg = dataclasses.replace(cfg.moe, capacity_factor=factor)
        jm = type(jm)(jm.cfg.replace(moe=dataclasses.replace(
            jm.cfg.moe, capacity_factor=factor)))
        model = Model(cfg.replace(moe=moe_cfg), device="cpu")
    drops = []
    route = moe.route

    def counting(*a, **kw):
        out = route(*a, **kw)
        drops.append(int((out[3] >= out[4]).sum()))
        return out

    monkeypatch.setattr(moe, "route", counting)
    kw = dict(n_slots=3, max_len=96)
    if paged:
        kw.update(paged=True, page_size=16)
    j_logs = serve_logs(JEngine(jm, jparams, **kw), SPEC, cfg.vocab_size)
    t_logs = serve_logs(BatchingEngine(model, params, **kw), SPEC,
                        cfg.vocab_size)
    assert t_logs == j_logs
    assert (sum(drops) > 0) == (factor is not None)
