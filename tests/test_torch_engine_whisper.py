"""Whisper through the port's dense ``BatchingEngine``, held against the
JAX package's engine: the token logs of the same seeded weights and
prompts, the audio self-cache that ``Model.make_caches`` gives (pos 0, as
the reference's zero-filled tree), and the reference's own limitation
mirrored: a context of ``PREFILL_MIN_TOKENS`` or more tokens goes to the
engine's prefill, which has no encoder frames, and fails with
``KeyError: 'frames'`` in both packages.

Weights: reduced whisper-tiny in fp32, the JAX init carried across
(``torch_parity.family_pair``). Logs are compared exactly; the reference's
top-2 margin at every generated step is asserted (``MARGIN``) from its own
decode logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import BatchingEngine as JBatchingEngine
from repro_torch.models import Model
from repro_torch.runtime import BatchingEngine
from torch_parity import MARGIN, family_pair

torch.set_num_threads(1)

# contexts (prompt less its last token) of 3 and 1 tokens: both below
# PREFILL_MIN_TOKENS, so they run through the decode step
PROMPTS = ([3, 5, 7, 9], [11, 2])
NEW_TOKENS = 4
ENC_LEN = 16                        # the engine's max_len: cross K/V length


@pytest.fixture(scope="module")
def whisper():
    return family_pair("whisper-tiny")


def _logs(engine, prompts):
    reqs = [engine.submit(list(p), max_new_tokens=NEW_TOKENS)
            for p in prompts]
    engine.run_until_idle()
    return [list(r.out_tokens) for r in reqs]


def _jax_margins(jmodel, jparams, prompts, outs):
    """Teacher-forced greedy replay of each stream through the reference's
    decode from its own ``make_caches`` (what its engine runs, one slot at
    a time): every generated token has a top-2 margin above MARGIN."""
    for p, out in zip(prompts, outs):
        caches = jmodel.make_caches(1, ENC_LEN)
        seq = list(p) + list(out)
        for i in range(len(seq) - 1):
            logits, caches = jmodel.decode(
                jparams, caches, jnp.asarray([[seq[i]]], jnp.int32),
                jnp.asarray([i], jnp.int32))
            if i >= len(p) - 1:
                row = np.sort(np.asarray(logits[0, 0], np.float64))
                assert row[-1] - row[-2] > MARGIN
                assert int(np.argmax(np.asarray(logits[0, 0]))) == seq[i + 1]


def test_dense_engine_logs_match_reference(whisper):
    jmodel, jparams, cfg, params = whisper
    jeng = JBatchingEngine(jmodel.model, jparams, n_slots=2, max_len=ENC_LEN)
    want = _logs(jeng, PROMPTS)
    eng = BatchingEngine(Model(cfg, device="cpu"), params, n_slots=2,
                         max_len=ENC_LEN)
    got = _logs(eng, PROMPTS)
    assert got == want
    _jax_margins(jmodel, jparams, PROMPTS, want)


def test_make_caches_gives_self_pos_zero(whisper):
    """The audio tree of ``Model.make_caches`` equals the reference's
    zero-filled one (self-cache ``pos`` 0), leaf for leaf; the prefill's
    caches keep ``pos`` -1 past the prompt, as the reference's."""
    jmodel, jparams, cfg, params = whisper
    m = Model(cfg, device="cpu")
    got = m.make_caches(2, ENC_LEN)
    want = jmodel.make_caches(2, ENC_LEN)
    assert sorted(got) == sorted(want) == ["cross_k", "cross_v", "self"]
    for k in want["self"]:
        np.testing.assert_array_equal(got["self"][k].numpy(),
                                      np.asarray(want["self"][k]))
    assert int(got["self"]["pos"].abs().max()) == 0
    for k in ("cross_k", "cross_v"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    frames = np.zeros((1, 8, cfg.d_model), np.float32)
    toks = np.asarray([[1, 2, 3]], np.int32)
    _, pc = m.prefill(params, {"frames": torch.from_numpy(frames),
                               "tokens": torch.from_numpy(toks)}, 0)
    _, jpc = jmodel.prefill(jparams, {"frames": jnp.asarray(frames),
                                      "tokens": jnp.asarray(toks)}, 0)
    np.testing.assert_array_equal(pc["self"]["pos"].numpy(),
                                  np.asarray(jpc["self"]["pos"]))
    assert int(pc["self"]["pos"][0, 0, -1]) == -1


def test_engine_cache_walk_spans_the_audio_tree(whisper):
    """The shortest cache length the engine clamps prefill padding to is
    taken over every leaf of the audio tree, as the reference's: the cross
    K/V (encoder length) as well as the self-attention cache."""
    jmodel, jparams, cfg, params = whisper
    for enc_len in (ENC_LEN, 1024):
        jeng = JBatchingEngine(jmodel.model, jparams, n_slots=2,
                               max_len=enc_len)
        eng = BatchingEngine(Model(cfg, device="cpu"), params, n_slots=2,
                             max_len=enc_len)
        assert eng._min_cache_len == jeng._min_cache_len


@pytest.mark.parametrize("n_prompt", [5, 9])
def test_long_context_fails_like_reference(whisper, n_prompt):
    """A context of PREFILL_MIN_TOKENS or more reaches the engine's prefill,
    which passes tokens only: both packages raise KeyError('frames')."""
    jmodel, jparams, cfg, params = whisper
    prompt = list(range(1, n_prompt + 1))
    assert n_prompt - 1 >= BatchingEngine.PREFILL_MIN_TOKENS \
        == JBatchingEngine.PREFILL_MIN_TOKENS
    jeng = JBatchingEngine(jmodel.model, jparams, n_slots=2, max_len=ENC_LEN)
    jeng.submit(prompt, max_new_tokens=2)
    with pytest.raises(KeyError) as jerr:
        jeng.step()
    eng = BatchingEngine(Model(cfg, device="cpu"), params, n_slots=2,
                         max_len=ENC_LEN)
    eng.submit(prompt, max_new_tokens=2)
    with pytest.raises(KeyError) as err:
        eng.step()
    assert err.value.args == jerr.value.args == ("frames",)
