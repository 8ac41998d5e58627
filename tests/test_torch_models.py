"""Port model against the JAX package: the reduced smollm-135m fixture of
tests/test_paged.py (fp32), JAX-initialised weights carried across by
``repro_torch.interop``; prefill, decode and paged-decode logits and greedy
tokens. The same for reduced mamba2-370m (fp32) through the serve-step
factories, on the plain chunked path (``kernel_force="ref"``) and on the
default path (the SSD kernel's sequential plain version on the CPU). Also:
every config admitted, decode against prefill for every family (the
reference's decode-against-forward test mirrored), the stage plans, and the
layouts, engines and devices the port refuses.

Tolerance: atol 2e-5, rtol 2e-4 on fp32 logits where both sides run the
same algorithm; atol 5e-4, rtol 5e-3 (the reference's SSD tolerance) where
the port's sequential SSD meets the reference's chunked one. Greedy tokens
must be identical; every step here has a top-2 logit margin far above that
tolerance (asserted), so no step needs the reference's token fed in.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import get_model as j_get_model
from repro.runtime.serve import BatchingEngine as JBatchingEngine
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.models.stages import plan_stages
from repro_torch.runtime import (BatchingEngine, make_paged_serve_step,
                                 make_prefill_step, make_serve_step)
from torch_parity import with_norms_near_one

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-4)
SSD_TOL = dict(atol=5e-4, rtol=5e-3)
MARGIN = 1e-3


@pytest.fixture(scope="module")
def pair():
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    model = Model(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return jmodel, jparams, model, params


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _margin(logits):
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def test_prefill_then_decode_matches_reference(pair):
    jmodel, jparams, model, params = pair
    toks = _tokens(model.cfg, 2, 24, seed=0)
    max_len = 48
    jh, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
    th, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           max_len)
    jl = jmodel.logits(jparams, jh)
    tl = model.logits(params, th)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
    assert np.array_equal(nxt, tl[:, -1].argmax(-1).numpy())
    pos = np.full((2,), 24, np.int32)
    for step in range(6):
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(nxt[:, None]),
                               jnp.asarray(pos))
        tl, tc = model.decode(params, tc, torch.tensor(nxt[:, None]),
                              torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert _margin(jl) > MARGIN
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)
        assert np.array_equal(nxt, tl[:, 0].argmax(-1).numpy())
        pos = pos + 1


def test_decode_paged_matches_reference(pair):
    """Token-at-a-time decode through a paged pool (the paged serve step):
    two rows on shuffled pages, one row inactive (pos -1, the mean of the
    null page's V rows on both sides), block tables padded with the null
    page."""
    jmodel, jparams, model, params = pair
    ps, n_pages, nb, B = 4, 24, 6, 3
    jpool = jmodel.make_paged_caches(n_pages, ps)
    tpool = model.make_paged_caches(n_pages, ps)
    step = make_paged_serve_step(model)
    rng = np.random.default_rng(1)
    pages = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, nb), np.int32)
    bt[0], bt[2, :3] = pages[:nb], pages[nb:nb + 3]
    toks = _tokens(model.cfg, B, 1, seed=2)[:, 0]
    for t in range(12):
        pos = np.array([t, -1, t if t < 12 else -1], np.int32)
        jl, jpool = jmodel.decode_paged(jparams, jpool,
                                        jnp.asarray(toks[:, None]),
                                        jnp.asarray(pos), jnp.asarray(bt))
        tl, tpool = step(params, tpool, torch.tensor(toks[:, None]),
                         torch.from_numpy(pos), torch.from_numpy(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert _margin(jl) > MARGIN
        toks = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)
        assert np.array_equal(toks, tl[:, 0].argmax(-1).numpy())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_is_admitted(arch):
    """Every family the JAX package serves builds on the port."""
    model = Model(reduced(get_config(arch)), device="cpu")
    assert model.cfg.name == get_config(arch).name


B, S = 2, 32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_prefill(arch):
    """Mirror of tests/test_models.py::test_decode_matches_forward on the
    port, which has no training forward: the decode of token S-1 after a
    prefill of S-1 tokens gives the logits of the last position of a
    prefill over all S (whisper: 16 decoder tokens over 48 frames; llava:
    its patches first), at the reference's 2e-4. The port's own seeded
    init, with MLA ``kv_norm`` and SSM gate norms set to 1 (zero by the
    reference's init, which zeroes those layers' outputs)."""
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    m = Model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    params = m.init(gen)
    for st in params.get("stages", ()):             # whisper has none
        for site in (st,) if isinstance(st, dict) else st:
            if "kv_norm" in site.get("attn", {}):
                site["attn"]["kv_norm"].fill_(1.0)
            if "ssm" in site:
                site["ssm"]["norm"].fill_(1.0)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         dtype=torch.int32)
    if cfg.family == "audio":
        frames = torch.randn((B, 48, cfg.d_model), generator=gen) * 0.1
        h, _ = m.prefill(params, {"frames": frames, "tokens": toks[:, :16]},
                         0)
        full = m.logits(params, h)[:, 15]
        _, caches = m.prefill(params, {"frames": frames,
                                       "tokens": toks[:, :15]}, 0)
        pos = 15
        last = toks[:, 15:16]
    else:
        batch = {"tokens": toks}
        if cfg.n_patches:
            batch["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model),
                                           generator=gen) * 0.1
        max_len = S + cfg.n_patches + 8
        h, _ = m.prefill(params, batch, max_len)
        full = m.logits(params, h)[:, -1]
        _, caches = m.prefill(params, dict(batch, tokens=toks[:, :S - 1]),
                              max_len)
        pos = S - 1 + cfg.n_patches
        last = toks[:, S - 1:S]
    d, _ = m.decode(params, caches, last,
                    torch.full((B,), pos, dtype=torch.int32))
    err = float((d[:, 0] - full).abs().max())
    assert err < 2e-4, f"{arch}: decode/prefill mismatch {err}"


def test_pattern_stage_plan_structures():
    """Mirror of tests/test_models.py's: gemma3 (5L+1G)*4+2L, gemma2 pairs,
    zamba2 shared, deepseek's dense first layer."""
    g3 = plan_stages(get_config("gemma3-1b"))
    assert [s.kind for s in g3] == ["pattern", "run"]
    assert g3[0].repeats == 4 and len(g3[0].sites) == 6
    assert g3[1].repeats == 2
    g2 = plan_stages(get_config("gemma2-9b"))
    assert g2[0].kind == "pattern" and g2[0].repeats == 21
    z = plan_stages(get_config("zamba2-7b"))
    assert z[0].kind == "pattern" and z[0].repeats == 13
    assert z[1].kind == "run" and z[1].repeats == 3
    ds = plan_stages(get_config("deepseek-v2-lite-16b"))
    assert ds[0].repeats == 1 and ds[1].repeats == 26
    assert sum(s.repeats * len(s.sites) for s in ds) == 27


def test_model_defaults_to_cuda():
    """The entry point runs on the card unless asked for the CPU, and
    refuses the default where CUDA is absent."""
    cfg = reduced(get_config("smollm-135m"))
    if torch.cuda.is_available():
        assert Model(cfg).dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(cfg)


# ---------------------------------------------------------------------------
# mamba2 (pure SSM)
# ---------------------------------------------------------------------------

def _force(cfg, force):
    return cfg.replace(geometry=dataclasses.replace(cfg.geometry,
                                                    kernel_force=force))


@pytest.fixture(scope="module")
def ssm_pair():
    jcfg = j_reduced(j_get_config("mamba2-370m")).replace(dtype="float32")
    jmodel = j_get_model(jcfg)
    tree = with_norms_near_one(
        jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
        np.random.default_rng(0))
    jparams = jax.tree.map(jnp.asarray, tree)
    cfg = reduced(get_config("mamba2-370m")).replace(dtype="float32")
    return jmodel, jparams, cfg, params_from_numpy(tree, cfg)


@pytest.mark.parametrize("force", ["ref", ""])
def test_ssm_prefill_then_decode_matches_reference(ssm_pair, force):
    """Through the serve-step factories (the port's SSM entry point)."""
    jmodel, jparams, cfg, params = ssm_pair
    model = Model(_force(cfg, force), device="cpu")
    tol = TOL if force == "ref" else SSD_TOL
    prefill = make_prefill_step(model, 48)
    step = make_serve_step(model)
    toks = _tokens(cfg, 2, 24, seed=3)
    jh, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 48)
    th, tc = prefill(params, {"tokens": torch.from_numpy(toks)})
    jl = jmodel.logits(jparams, jh)
    tl = model.logits(params, th)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    assert _margin(jl[:, -1]) > MARGIN
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
    assert np.array_equal(nxt, tl[:, -1].argmax(-1).numpy())
    pos = np.full((2,), 24, np.int32)
    for _ in range(6):
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(nxt[:, None]),
                               jnp.asarray(pos))
        tl, tc = step(params, tc, torch.tensor(nxt[:, None]),
                      torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        for jv, tv in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
        assert _margin(jl) > MARGIN
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)
        assert np.array_equal(nxt, tl[:, 0].argmax(-1).numpy())
        pos = pos + 1


def test_ssm_decode_matches_forward(ssm_pair):
    """Prefill of S-1 tokens + one decode step gives the logits of a
    prefill over all S (the port's teacher-forced forward), as
    tests/test_models.py checks for the reference."""
    _, _, cfg, params = ssm_pair
    model = Model(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 32, seed=4))
    h, _ = model.prefill(params, {"tokens": toks}, 40)
    full = model.logits(params, h)[:, -1]
    _, caches = model.prefill(params, {"tokens": toks[:, :-1]}, 40)
    d, _ = model.decode(params, caches, toks[:, -1:],
                        torch.full((2,), 31, dtype=torch.int32))
    assert float((d[:, 0] - full).abs().max()) < 2e-4


def test_ssm_paged_caches_and_engine_refused(ssm_pair):
    """No paged form and no BatchingEngine for SSM models, in either
    package; both engines refuse in the same words, naming
    ``jit_serve_step`` (which serves mamba2 in both packages)."""
    jmodel, jparams, cfg, params = ssm_pair
    model = Model(cfg, device="cpu")
    for make in (lambda: jmodel.make_paged_caches(8, 4),
                 lambda: model.make_paged_caches(8, 4)):
        with pytest.raises(ValueError, match="attention-family"):
            make()
    msgs = []
    for engine, m, p in ((JBatchingEngine, jmodel, jparams),
                         (BatchingEngine, model, params)):
        with pytest.raises(ValueError, match="attention-family") as e:
            engine(m, p)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[1] == ("BatchingEngine supports attention-family models; "
                       "use jit_serve_step for SSM archs")


def test_ssm_short_prompt_refused(ssm_pair):
    _, _, cfg, params = ssm_pair
    model = Model(cfg, device="cpu")
    with pytest.raises(ValueError, match="d_conv-1"):
        model.prefill(params, {"tokens": torch.zeros((1, 2),
                                                     dtype=torch.int32)}, 8)

