"""Port against the JAX package for the dense families whose head dims the
attention kernels now take: phi3-mini-3.8b (96), gemma3-1b and gemma2-9b
(256). JAX-initialised weights are carried across by
``repro_torch.interop``; both sides run on the CPU (the port's kernels take
their plain versions there, the reference its einsum path).

What the families add over smollm: gemma's qk-norm, post-norms, embedding
scale, GELU-tanh, attention and final logit softcaps, ``query_scale``, the
local/global pattern with two rope thetas and a sliding window (32 at
``reduced()`` size, so 40-token prompts pass it), phi3's untied head.

* ``reduced()`` configs (head dim 32) in fp32: prefill, decode and
  paged-decode logits;
* the same at 3 layers with ``head_dim`` set on both sides to the family's
  own (96, 256), so the plain paths are held at the dims the kernels take;
* dense and paged ``BatchingEngine`` token logs for reduced gemma3-1b.

Tolerance: atol 2e-5, rtol 2e-4 on fp32 logits (the reference's fp32 kernel
tolerance; both sides run the same algorithm). Every step feeds both sides
the reference's greedy token; the port's argmax must equal it wherever the
reference's top-2 margin exceeds 1e-3, and the steps below that margin are
counted and must be few.
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
from repro.runtime import BatchingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.runtime import BatchingEngine, make_paged_serve_step
from torch_parity import MARGIN, TOL, Jitted, greedy, serve_logs

torch.set_num_threads(1)

ARCHS = ("phi3-mini-3.8b", "gemma3-1b", "gemma2-9b")
HEAD_DIM = {"phi3-mini-3.8b": 96, "gemma3-1b": 256, "gemma2-9b": 256}


def _pair(arch, head_dim=0, n_layers=0):
    """(JAX model (decode jitted), JAX params, port model on the CPU, port
    params)."""
    kw = dict(dtype="float32")
    if head_dim:
        kw.update(head_dim=head_dim, n_layers=n_layers)
    jcfg = j_reduced(j_get_config(arch)).replace(**kw)
    cfg = reduced(get_config(arch)).replace(**kw)
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return Jitted(jmodel), jparams, Model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch, own_head_dim):
        key = (arch, own_head_dim)
        if key not in cache:
            cache[key] = _pair(arch, HEAD_DIM[arch], 3) if own_head_dim \
                else _pair(arch)
        return cache[key]
    return get


def _tokens(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("own_head_dim", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(pairs, arch, own_head_dim):
    """A 40-token prefill (past the reduced window of 32) and 8 decode
    steps, the local layers' caches ring-buffered at the window."""
    jmodel, jparams, model, params = pairs(arch, own_head_dim)
    assert model.cfg.resolved_head_dim == (HEAD_DIM[arch] if own_head_dim
                                           else 32)
    toks = _tokens(model.cfg.vocab_size, 2, 40, seed=0)
    max_len = 64
    jh, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
    th, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           max_len)
    jl = jmodel.logits(jparams, jh)
    tl = model.logits(params, th)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt, near = greedy(jl[:, -1], tl[:, -1])
    pos = np.full((2,), 40, np.int32)
    for _ in range(8):
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(nxt[:, None]),
                               jnp.asarray(pos))
        tl, tc = model.decode(params, tc, torch.tensor(nxt[:, None]),
                              torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt, n = greedy(jl[:, 0], tl[:, 0])
        near += n
        pos = pos + 1
    assert near <= 2, f"{near} of 18 greedy steps below the margin"


@pytest.mark.parametrize("own_head_dim", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_paged_matches_reference(pairs, arch, own_head_dim):
    """Token-at-a-time decode through a paged pool for 40 steps (past the
    window): two rows on shuffled pages, one row inactive (pos -1: the mean
    of the null page's V rows on both sides), block tables padded with the
    null page."""
    jmodel, jparams, model, params = pairs(arch, own_head_dim)
    ps, n_pages, nb, B, steps = 4, 32, 10, 3, 40
    jpool = jmodel.make_paged_caches(n_pages, ps)
    tpool = model.make_paged_caches(n_pages, ps)
    step = make_paged_serve_step(model)
    rng = np.random.default_rng(1)
    pages = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, nb), np.int32)
    bt[0], bt[2] = pages[:nb], pages[nb:2 * nb]
    toks = _tokens(model.cfg.vocab_size, B, 1, seed=2)[:, 0]
    near = 0
    for t in range(steps):
        pos = np.array([t, -1, t], np.int32)
        jl, jpool = jmodel.decode_paged(jparams, jpool,
                                        jnp.asarray(toks[:, None]),
                                        jnp.asarray(pos), jnp.asarray(bt))
        tl, tpool = step(params, tpool, torch.tensor(toks[:, None]),
                         torch.from_numpy(pos), torch.from_numpy(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        toks, n = greedy(jl[:, 0], tl[:, 0])
        near += n
    assert near <= 4, f"{near} of {B * steps} greedy steps below the margin"


# name -> [(prompt len, seed, tenant, max_new_tokens)]; prompts of 40-70
# tokens pass the reduced window of 32; the last two share their prompt
GEMMA3_SPEC = [(5, 1, "a", 6), (17, 2, "b", 6), (40, 3, "a", 8),
               (70, 4, "b", 6), (45, 5, "a", 5), (45, 5, "a", 7)]


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=n).tolist()


@pytest.mark.parametrize("paged", [False, True])
def test_gemma3_engine_token_logs_match_reference(pairs, paged):
    """reduced gemma3-1b (5 local : 1 global, window 32, qk-norm) through
    both engines, dense rows (local layers' rows clamped to the window) and
    paged, 3 slots: the token logs are equal. The premise is asserted: a
    teacher-forced reference forward over each prompt and its output has a
    top-2 margin above MARGIN at every generated position."""
    jmodel, jparams, model, params = pairs("gemma3-1b", False)
    kw = dict(n_slots=3, max_len=96)
    if paged:
        kw.update(paged=True, page_size=16)
    vocab = model.cfg.vocab_size
    j_logs = serve_logs(JEngine(jmodel.model, jparams, **kw),
                        GEMMA3_SPEC, vocab)
    t_logs = serve_logs(BatchingEngine(model, params, **kw),
                        GEMMA3_SPEC, vocab)
    width = 96
    seqs = np.zeros((len(GEMMA3_SPEC), width), np.int32)
    for i, ((n, seed, _, _), out) in enumerate(zip(GEMMA3_SPEC, j_logs)):
        seq = _prompt(vocab, n, seed) + out
        seqs[i, :len(seq)] = seq
    h, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(seqs)})
    logits = np.asarray(jmodel.logits(jparams, h), np.float64)
    for i, ((n, _, _, _), out) in enumerate(zip(GEMMA3_SPEC, j_logs)):
        top2 = np.sort(logits[i, n - 1:n - 1 + len(out)], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
    assert t_logs == j_logs


def test_family_features_reach_the_port():
    """The reduced configs keep the features these tests are for."""
    g3 = reduced(get_config("gemma3-1b"))
    g2 = reduced(get_config("gemma2-9b"))
    phi = reduced(get_config("phi3-mini-3.8b"))
    assert g3.qk_norm and g3.post_norm and g3.embed_scale and g3.act == "gelu"
    assert g3.rope_local_theta and g3.window == 32 and len(g3.pattern) == 6
    assert g2.attn_softcap == 50.0 and g2.final_softcap == 30.0
    assert g2.query_scale and g2.n_heads // g2.n_kv_heads == 2
    assert not phi.tie_embeddings and phi.n_kv_heads == 2
    assert dataclasses.replace(g3, head_dim=256).resolved_head_dim == 256
