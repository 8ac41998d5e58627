"""The port's MLA layer (``repro_torch.layers.mla``) against the JAX
package's, and reduced deepseek-v2-lite (MLA + MoE with 2 shared experts
and a dense first layer) through the model entry points and the dense
engine; the engine's layout repairs for MLA caches.

The reference's ``init_mla`` sets ``kv_norm`` to 0 and applies it with
``rms_norm(..., plus_one=False)``: a fresh layer's latent, values and output
are exactly 0 (asserted below on both packages), so its own
``test_layers.py::test_mla_absorbed_decode_equals_expanded`` compares zeros.
Parity here runs with ``kv_norm`` around 1 on both sides; the mirror of that
test runs both ways.

Tolerance: atol 2e-5, rtol 2e-4 on fp32 outputs and logits (1e-4 / 1e-3,
the reference's own, in the absorbed-against-expanded mirror).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig
from repro.layers import mla as jmla
from repro.runtime import BatchingEngine as JEngine
from repro_torch.layers import mla
from repro_torch.models import Model
from repro_torch.runtime import BatchingEngine
from torch_parity import TOL, family_pair, greedy, serve_logs

torch.set_num_threads(1)

# deepseek's reduced() MLA widths
MCFG = MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                 v_head_dim=32)


def _layer(kv_norm):
    """JAX MLA params (4 heads, d_model 128) with ``kv_norm`` "zero" (the
    reference's init) or "one" (around 1), and the same as port tensors."""
    jopts = jmla.MLAOpts(n_heads=4, cfg=MCFG)
    opts = mla.MLAOpts(n_heads=4, cfg=MCFG)
    jp = jmla.init_mla(jax.random.PRNGKey(0), 128, jopts)
    if kv_norm == "one":
        jp["kv_norm"] = jnp.asarray(1.0 + 0.1 * np.random.default_rng(0)
                                    .standard_normal(64), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jopts, jp, opts, tp


def _x(b, s, seed):
    x = np.random.default_rng(seed).standard_normal((b, s, 128))
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    return x.astype(np.float32), pos


@pytest.mark.parametrize("S", [512, 40])
def test_mla_forward_matches_reference(S):
    """S = 512 takes the 256-query chunked branch, S = 40 the whole one."""
    jopts, jp, opts, tp = _layer("one")
    x, pos = _x(1, S, seed=1)
    jy, (jc, jr) = jmla.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                    jopts)
    ty, (tc, tr) = mla.mla_forward(tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), opts)
    assert float(np.abs(np.asarray(jy)).max()) > 0.1
    for t, j in ((ty, jy), (tc, jc), (tr, jr)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_mla_decode_matches_reference():
    """A prefill of 20 into a 24-row ring cache, then 6 absorbed decode
    steps (past the ring's end); output and cache against the
    reference."""
    jopts, jp, opts, tp = _layer("one")
    x, pos = _x(2, 26, seed=2)
    _, (jc, jr) = jmla.mla_forward(jp, jnp.asarray(x[:, :20]),
                                   jnp.asarray(pos[:, :20]), jopts)
    jcache = jmla.fill_mla_cache(jmla.init_mla_cache(2, 24, jopts,
                                                     jnp.float32),
                                 jc, jr, jnp.asarray(pos[:, :20]))
    tcache = mla.init_mla_cache(2, 24, opts, torch.float32)
    _, (tc, tr) = mla.mla_forward(tp, torch.from_numpy(x[:, :20]),
                                  torch.from_numpy(pos[:, :20]), opts)
    mla.fill_mla_cache(tcache, tc, tr, torch.from_numpy(pos[:, :20]))
    for t in range(20, 26):
        jy, jcache = jmla.mla_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                     jnp.asarray(pos[:, t:t + 1]), jcache,
                                     jopts)
        ty, tcache = mla.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                    torch.from_numpy(pos[:, t:t + 1]),
                                    tcache, opts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for k in ("c_kv", "k_rope", "pos"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)


@pytest.mark.parametrize("kv_norm", ["zero", "one"])
def test_mla_absorbed_decode_equals_expanded(kv_norm):
    """Mirror of the reference's test on the port: the compressed-cache
    absorbed decode equals the expanded form. With the reference's zero
    ``kv_norm`` both are 0; with it around 1 they are not."""
    _, _, opts, tp = _layer(kv_norm)
    x, pos = _x(2, 9, seed=1)
    x, pos = torch.from_numpy(x), torch.from_numpy(pos)
    y_full, (c_kv, k_rope) = mla.mla_forward(tp, x, pos, opts)
    cache = mla.init_mla_cache(2, 16, opts, x.dtype)
    mla.fill_mla_cache(cache, c_kv[:, :8], k_rope[:, :8], pos[:, :8])
    y_dec, _ = mla.mla_decode(tp, x[:, 8:9], pos[:, 8:9], cache, opts)
    np.testing.assert_allclose(y_dec[:, 0].numpy(), y_full[:, 8].numpy(),
                               atol=1e-4, rtol=1e-3)
    assert (float(y_full.abs().max()) == 0.0) == (kv_norm == "zero")


def test_fresh_mla_layer_outputs_exactly_zero():
    """The reference limitation, on both packages: a freshly initialised
    layer's latent and output are exactly 0 (its rope key is not)."""
    jopts, jp, opts, _ = _layer("zero")
    tp = mla.init_mla(torch.Generator().manual_seed(0), 128, opts)
    x, pos = _x(2, 12, seed=4)
    jy, (jc, jr) = jmla.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                    jopts)
    ty, (tc, tr) = mla.mla_forward(tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), opts)
    assert not np.asarray(jy).any() and not np.asarray(jc).any()
    assert not ty.any() and not tc.any()
    assert np.asarray(jr).any() and tr.any()


@pytest.fixture(scope="module")
def deepseek():
    return family_pair("deepseek-v2-lite-16b")


def test_deepseek_prefill_then_decode_matches_reference(deepseek):
    jmodel, jparams, cfg, params = deepseek
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
    for j, t in zip(jax.tree.leaves(jc), (leaf for st in tc
                                          for leaf in st.values())):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


SPEC = [(2, 1, "a", 5), (9, 2, "b", 6), (23, 3, "a", 7), (50, 4, "b", 5),
        (37, 5, "a", 4)]


def test_deepseek_dense_engine_token_logs_match_reference(deepseek):
    """3 slots over MLA latent caches (no ``"k"`` leaf): the engine sizes
    its prefill buckets from every cache leaf, as the reference does, and
    the token logs are equal."""
    jmodel, jparams, cfg, params = deepseek
    kw = dict(n_slots=3, max_len=96)
    engine = BatchingEngine(Model(cfg, device="cpu"), params, **kw)
    assert engine._min_cache_len == 96
    j_logs = serve_logs(JEngine(jmodel.model, jparams, **kw), SPEC,
                        cfg.vocab_size)
    assert serve_logs(engine, SPEC, cfg.vocab_size) == j_logs


def test_min_cache_len_spans_every_cache_leaf():
    """The shortest cache length over every leaf with a length axis: MLA
    latents (no ``"k"`` leaf), and gemma3's windowed K/V rows."""
    from repro_torch.configs import get_config, reduced
    for arch, need in (("deepseek-v2-lite-16b", 80), ("gemma3-1b", 32)):
        cfg = reduced(get_config(arch))
        model = Model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        assert BatchingEngine(model, params, n_slots=2,
                              max_len=80)._min_cache_len == need


def test_paged_engine_refuses_mla_before_allocating(deepseek, monkeypatch):
    """``paged=True`` with an MLA model is refused with the reference's
    message before any cache is allocated."""
    jmodel, jparams, cfg, params = deepseek
    model = Model(cfg, device="cpu")

    def no_alloc(*a, **kw):
        raise AssertionError("paged caches allocated before the refusal")

    monkeypatch.setattr(Model, "make_paged_caches", no_alloc)
    msgs = []
    for engine, m, p in ((JEngine, jmodel.model, jparams),
                         (BatchingEngine, model, params)):
        with pytest.raises(ValueError, match="MLA latents are not paged") \
                as e:
            engine(m, p, paged=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
