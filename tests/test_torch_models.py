"""Port model against the JAX package: the reduced smollm-135m fixture of
tests/test_paged.py (fp32), JAX-initialised weights carried across by
``repro_torch.interop``; prefill, decode and paged-decode logits and greedy
tokens. Also: families and devices the port refuses.

Tolerance: atol 2e-5, rtol 2e-4 on fp32 logits. Greedy tokens must be
identical; every step here has a top-2 logit margin far above that
tolerance (asserted), so no step needs the reference's token fed in.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import get_model as j_get_model
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-4)
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
    """Token-at-a-time decode through a paged pool: two rows on shuffled
    pages, one row inactive (pos -1, the mean of the null page's V rows on
    both sides), block tables padded with the null page."""
    jmodel, jparams, model, params = pair
    ps, n_pages, nb, B = 4, 24, 6, 3
    jpool = jmodel.make_paged_caches(n_pages, ps)
    tpool = model.make_paged_caches(n_pages, ps)
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
        tl, tpool = model.decode_paged(params, tpool,
                                       torch.tensor(toks[:, None]),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert _margin(jl) > MARGIN
        toks = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)
        assert np.array_equal(toks, tl[:, 0].argmax(-1).numpy())


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b",
                                  "mamba2-370m", "zamba2-7b", "whisper-tiny",
                                  "llava-next-34b"])
def test_unported_families_refuse(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(reduced(get_config(arch)), device="cpu")


def test_model_defaults_to_cuda():
    """The entry point runs on the card unless asked for the CPU, and
    refuses the default where CUDA is absent."""
    cfg = reduced(get_config("smollm-135m"))
    if torch.cuda.is_available():
        assert Model(cfg).dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(cfg)
