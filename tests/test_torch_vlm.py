"""The VLM family (llava-next-34b: precomputed patch embeddings prepended
to the token embeddings, GQA 56/8 at full width) on the port against the
JAX package at reduced size (16 patches): prefill and decode logits with
patches, and the text-only engines' token logs (the reference's engine
serves text).

Tolerance: atol 2e-5, rtol 2e-4 on fp32 logits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import BatchingEngine as JEngine
from repro_torch.models import Model
from repro_torch.runtime import BatchingEngine
from torch_parity import TOL, family_pair, greedy, serve_logs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def llava():
    return family_pair("llava-next-34b")


def test_prefill_with_patches_then_decode_matches_reference(llava):
    """16 patches + 24 tokens, then 6 decode steps at positions past the
    patches."""
    jmodel, jparams, cfg, params = llava
    assert cfg.n_patches == 16
    m = Model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    patches = (rng.standard_normal((2, 16, cfg.d_model)) * 0.1) \
        .astype(np.float32)
    jh, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                      "patches": jnp.asarray(patches)}, 64)
    th, tc = m.prefill(params, {"tokens": torch.from_numpy(toks),
                                "patches": torch.from_numpy(patches)}, 64)
    assert th.shape[1] == 40
    jl, tl = jmodel.logits(jparams, jh), m.logits(params, th)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt, near = greedy(jl[:, -1], tl[:, -1])
    pos = np.full((2,), 40, np.int32)
    for _ in range(6):
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(nxt[:, None]),
                               jnp.asarray(pos))
        tl, tc = m.decode(params, tc, torch.tensor(nxt[:, None]),
                          torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt, n = greedy(jl[:, 0], tl[:, 0])
        near += n
        pos = pos + 1
    assert near <= 2, f"{near} of 14 greedy steps below the margin"


SPEC = [(2, 1, "a", 5), (9, 2, "b", 6), (23, 3, "a", 7), (50, 4, "b", 5),
        (37, 5, "a", 4)]


@pytest.mark.parametrize("paged", [False, True])
def test_text_engine_token_logs_match_reference(llava, paged):
    jmodel, jparams, cfg, params = llava
    kw = dict(n_slots=3, max_len=96)
    if paged:
        kw.update(paged=True, page_size=16)
    j_logs = serve_logs(JEngine(jmodel.model, jparams, **kw), SPEC,
                        cfg.vocab_size)
    t_logs = serve_logs(BatchingEngine(Model(cfg, device="cpu"), params,
                                       **kw), SPEC, cfg.vocab_size)
    assert t_logs == j_logs
