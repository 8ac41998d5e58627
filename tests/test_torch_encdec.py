"""The whisper encoder-decoder on the port (``repro_torch.models.encdec``):
the three tests of tests/test_encdec.py mirrored (the port has no training
``forward``: its ``decoder_forward`` over the encoder's output is the
teacher-forcing reference), then the encoder, the prefill (hidden, self-
attention caches, cross K/V) and 4 decode steps against the JAX package,
and the paged refusals.

Tolerance: atol 2e-5, rtol 2e-4 on fp32 (the mirrors keep the reference's
2e-4 on logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jencdec
from repro_torch.models import Model
from repro_torch.models.encdec import DEC_MAX_LEN, decoder_forward, encode
from torch_parity import TOL, family_pair, greedy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def whisper():
    jmodel, jparams, cfg, params = family_pair("whisper-tiny")
    frames = (np.random.default_rng(1).standard_normal((2, 40, cfg.d_model))
              * 0.1).astype(np.float32)
    return jmodel, jparams, cfg, params, frames


def test_encoder_is_causal_free(whisper):
    """Changing the last frame changes the first encoder output (the
    encoder is bidirectional)."""
    _, _, cfg, params, frames = whisper
    f = torch.from_numpy(frames)
    e1 = encode(cfg, params, f)
    f2 = f.clone()
    f2[:, -1] += 1.0
    e2 = encode(cfg, params, f2)
    assert float((e1[:, 0] - e2[:, 0]).abs().max()) > 1e-6


def test_multi_step_decode_matches_teacher_forcing(whisper):
    _, _, cfg, params, frames = whisper
    m = Model(cfg, device="cpu")
    f = torch.from_numpy(frames)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    with torch.no_grad():
        h = decoder_forward(cfg, params, toks, encode(cfg, params, f))
    tf_logits = m.logits(params, h)
    _, caches = m.prefill(params, {"frames": f, "tokens": toks[:, :8]}, 0)
    for i in range(8, 12):
        logits, caches = m.decode(params, caches, toks[:, i:i + 1],
                                  torch.full((2,), i, dtype=torch.int32))
        err = float((logits[:, 0] - tf_logits[:, i]).abs().max())
        assert err < 2e-4, (i, err)


def test_cross_kv_cache_matches_encoder(whisper):
    _, _, cfg, params, frames = whisper
    m = Model(cfg, device="cpu")
    _, caches = m.prefill(params, {"frames": torch.from_numpy(frames),
                                   "tokens": torch.zeros((2, 4),
                                                         dtype=torch.int32)},
                          0)
    assert caches["cross_k"].shape[0] == cfg.n_layers
    assert caches["cross_k"].shape[2] == frames.shape[1]
    assert caches["self"]["k"].shape[2] == DEC_MAX_LEN


def test_encode_prefill_decode_match_reference(whisper):
    """``encode``, ``Model.prefill`` (hidden, the self-attention caches and
    the cross K/V) and 4 greedy decode steps against the JAX package."""
    jmodel, jparams, cfg, params, frames = whisper
    m = Model(cfg, device="cpu")
    np.testing.assert_allclose(
        encode(cfg, params, torch.from_numpy(frames)).numpy(),
        np.asarray(jencdec.encode(jmodel.cfg, jparams, jnp.asarray(frames))),
        **TOL)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 10)) \
        .astype(np.int32)
    jh, jc = jmodel.prefill(jparams, {"frames": jnp.asarray(frames),
                                      "tokens": jnp.asarray(toks)}, 0)
    th, tc = m.prefill(params, {"frames": torch.from_numpy(frames),
                                "tokens": torch.from_numpy(toks)}, 0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    for k in ("k", "v", "pos"):
        np.testing.assert_allclose(tc["self"][k].numpy(),
                                   np.asarray(jc["self"][k]), **TOL)
    jl = jmodel.logits(jparams, jh)
    tl = m.logits(params, th)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt, near = greedy(jl[:, -1], tl[:, -1])
    pos = np.full((2,), 10, np.int32)
    for _ in range(4):
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(nxt[:, None]),
                               jnp.asarray(pos))
        tl, tc = m.decode(params, tc, torch.tensor(nxt[:, None]),
                          torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt, n = greedy(jl[:, 0], tl[:, 0])
        near += n
        pos = pos + 1
    assert near <= 2, f"{near} of 10 greedy steps below the margin"
    np.testing.assert_allclose(tc["self"]["k"].numpy(),
                               np.asarray(jc["self"]["k"]), **TOL)


def test_paged_refusals_match_reference(whisper):
    """No paged form for the encoder-decoder, with the reference's
    messages."""
    jmodel, jparams, cfg, params, _ = whisper
    m = Model(cfg, device="cpu")
    tok, pos, bt = np.zeros((2, 1), np.int32), np.zeros(2, np.int32), \
        np.zeros((2, 4), np.int32)
    cases = ((lambda: jmodel.make_paged_caches(8, 4),
              lambda: m.make_paged_caches(8, 4)),
             (lambda: jmodel.model.decode_paged(jparams, None, tok, pos, bt),
              lambda: m.decode_paged(params, None, torch.from_numpy(tok),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(bt))))
    for ref, ours in cases:
        with pytest.raises(ValueError) as e_ref:
            ref()
        with pytest.raises(ValueError) as e_ours:
            ours()
        assert str(e_ours.value) == str(e_ref.value)
        assert "decoder-only LMs" in str(e_ours.value)
