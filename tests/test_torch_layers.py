"""Port layers against the JAX package on the same weights and inputs
(numpy seeds): norms, rope, MLP, full-sequence attention (flash path,
chunked and unchunked einsum paths) and cached decode in both cache layouts,
fp32 and int8 (``kv_quant``).

Tolerance: atol 2e-5, rtol 2e-4 in float32. Decode compares every row: an
inactive paged row (pos -1) has no valid key and returns the mean of the
swept V rows on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jattn
from repro.layers.mlp import mlp_forward as j_mlp
from repro.layers.norms import rms_norm as j_rms
from repro.layers.rope import apply_rope as j_rope
from repro_torch.layers import attention as tattn
from repro_torch.layers.mlp import mlp_forward as t_mlp
from repro_torch.layers.norms import rms_norm as t_rms
from repro_torch.layers.rope import apply_rope as t_rope

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-4)
D_MODEL = 64


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _opts(mod, **kw):
    base = dict(n_heads=4, n_kv_heads=2, head_dim=32)
    base.update(kw)
    return mod.AttnOpts(**base)


def _attn_params(seed=0):
    rng = _rng(seed)
    s = D_MODEL ** -0.5
    return {"wq": _normal(rng, (D_MODEL, 2, 2, 32), s),
            "wk": _normal(rng, (D_MODEL, 2, 32), s),
            "wv": _normal(rng, (D_MODEL, 2, 32), s),
            "wo": _normal(rng, (2, 2, 32, D_MODEL), s)}


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_norm_rope_mlp_match_reference():
    rng = _rng(1)
    x = _normal(rng, (2, 7, D_MODEL))
    w = _normal(rng, (D_MODEL,), 0.1)
    _close(t_rms(_t(x), _t(w)), j_rms(x, w))
    xh = _normal(rng, (2, 7, 3, 32))
    pos = np.tile(np.arange(7, dtype=np.int32)[None] + 5, (2, 1))
    _close(t_rope(_t(xh), _t(pos), 10000.0), j_rope(xh, pos, 10000.0))
    p = {"wg": _normal(rng, (D_MODEL, 96), 0.1),
         "wu": _normal(rng, (D_MODEL, 96), 0.1),
         "wd": _normal(rng, (96, D_MODEL), 0.1)}
    for act in ("silu", "gelu"):
        _close(t_mlp(_t(p), _t(x), act), j_mlp(p, x, act))


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("path", ["flash", "chunked", "unchunked"])
def test_attn_forward_matches_reference(window, path):
    """flash: inference forward (plain flash version on the CPU); chunked /
    unchunked: an autograd-recording forward takes the einsum path, chunked
    when S is a multiple of q_chunk above it."""
    S = 64 if path != "unchunked" else 40
    p = _attn_params()
    x = _normal(_rng(2), (2, S, D_MODEL))
    pos = np.tile(np.arange(S, dtype=np.int32)[None], (2, 1))
    y_j, (k_j, _) = jattn.attn_forward(p, x, pos,
                                       _opts(jattn, window=window, q_chunk=16))
    tp = _t(p)
    if path != "flash":
        for w in tp.values():
            w.requires_grad_(True)
    y_t, (k_t, _) = tattn.attn_forward(tp, _t(x), _t(pos),
                                       _opts(tattn, window=window,
                                             q_chunk=16))
    _close(y_t, y_j)
    _close(k_t, k_j)


def _cache_setup(quant, seed=3):
    """A dense cache filled by prefill on both sides, then one decode step
    at per-row positions (row 1 shorter: its later slots stay empty)."""
    B, L, P = 2, 32, 20
    p = _attn_params(seed)
    x = _normal(_rng(seed + 1), (B, P, D_MODEL))
    pos = np.tile(np.arange(P, dtype=np.int32)[None], (B, 1))
    xd = _normal(_rng(seed + 2), (B, 1, D_MODEL))
    dpos = np.array([[P], [7]], np.int32)
    return p, x, pos, xd, dpos, B, L


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 8])
def test_attn_decode_matches_reference(quant, window):
    p, x, pos, xd, dpos, B, L = _cache_setup(quant)
    jo, to = _opts(jattn, window=window), _opts(tattn, window=window)
    _, (k, v) = jattn.attn_forward(p, x, pos, jo)
    jc = jattn.fill_kv_cache(
        jattn.init_kv_cache(B, L, jo, jnp.float32, quant=quant), k, v, pos)
    tc = tattn.init_kv_cache(B, L, to, torch.float32, quant=quant)
    _, (tk, tv) = tattn.attn_forward(_t(p), _t(x), _t(pos), to)
    tattn.fill_kv_cache(tc, tk, tv, _t(pos))
    for name in jc:
        _close(tc[name].float(), jnp.asarray(jc[name], jnp.float32))
    y_j, jc = jattn.attn_decode(p, xd, dpos, jc, jo)
    y_t, tc = tattn.attn_decode(_t(p), _t(xd), _t(dpos), tc, to)
    _close(y_t, y_j)
    for name in jc:
        _close(tc[name].float(), jnp.asarray(jc[name], jnp.float32))


@pytest.mark.parametrize("quant", [False, True])
def test_attn_decode_paged_matches_reference(quant):
    """Four rows over a shuffled 4-token page pool: two active rows with
    history written token by token, one inactive row (pos -1), one active
    row at position 0. Every row must match; the pools must match."""
    rng = _rng(4)
    p = _attn_params(5)
    ps, n_pages, nb, B = 4, 16, 4, 4
    jo, to = _opts(jattn), _opts(tattn)
    jpool = jattn.init_paged_kv_pool(n_pages, ps, jo, jnp.float32,
                                     quant=quant)
    tpool = tattn.init_paged_kv_pool(n_pages, ps, to, torch.float32,
                                     quant=quant)
    bt = np.zeros((B, nb), np.int32)
    pages = rng.permutation(np.arange(1, n_pages))
    bt[0, :3], bt[1, :2], bt[3, :1] = pages[:3], pages[3:5], pages[5:6]
    lens = [11, 6, -1, 0]
    steps = max(lens) + 1
    for t in range(steps):
        pos = np.array([[t if 0 <= t <= n else -1] for n in lens], np.int32)
        xd = _normal(rng, (B, 1, D_MODEL))
        y_j, jpool = jattn.attn_decode_paged(p, xd, pos, jpool, bt, jo)
        y_t, tpool = tattn.attn_decode_paged(_t(p), _t(xd), _t(pos), tpool,
                                             _t(bt), to)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    live = np.unique(bt[bt > 0])
    for name in jpool:
        _close(tpool[name][live].float(),
               jnp.asarray(jpool[name], jnp.float32)[live])
