"""Attention at the shapes the decode and flash kernels now take, on the CPU,
against the JAX package: reduced qwen3-moe with the shape of Qwen3-235B-
A22B's heads cut to size (16 query heads over 1 kv head, a group of 16:
past the 8 a decode block holds, so the kernel runs it in chunks), and a
second case at head dim 264 (past the widths compiled exactly; the kernel
built for 384 reads it in place). Weights go JAX -> numpy -> torch
(``interop.params_from_numpy``). Held: fp32 logits of a prefill and six
decode steps, dense and paged; the greedy token logs of the dense and paged
``BatchingEngine`` equal to the JAX engine's. On the CPU the wrappers take
the kernels' plain versions; tests/test_torch_cuda.py holds the kernels
against them on the card at these shapes.

Also ``kernel_force``: ``"kernel"`` (the reference's "force the kernel")
raises on a tensor off the card, naming it; ``"interpret"`` raises, naming
the missing interpreter.

Tolerance: atol 2e-5, rtol 2e-4 on fp32 logits (tests/torch_parity.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import BatchingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import decode_attention as tda
from repro_torch.layers import attention
from repro_torch.models import Model
from repro_torch.runtime import BatchingEngine, make_paged_serve_step
from torch_parity import TOL, family_pair, greedy, serve_logs

torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
# (n_heads, n_kv_heads, head_dim): the 235B model's group of 16 on one kv
# head at the reduced width; the reduced heads at head dim 264
CASES = {"g16": dict(n_heads=16, n_kv_heads=1),
         "d264": dict(head_dim=264)}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return request.param, family_pair(ARCH, **CASES[request.param])


def test_case_shapes_need_the_new_kernel_shapes(pair):
    """Each case is past an old cap: g 16 runs in two chunks of 8, D 264 on
    the 384 build (unpadded)."""
    name, (_, _, cfg, _) = pair
    g, d = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    if name == "g16":
        assert g == 16 and tda.head_chunks(g, d) == (8, 2)
    else:
        assert d == 264 and tda.padded_head_dim("decode_attention", d) == 384


def test_prefill_then_decode_matches_reference(pair):
    _, (jmodel, jparams, cfg, params) = pair
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


def test_paged_decode_matches_reference(pair):
    """16 steps through a paged pool: two rows on shuffled pages, one row
    inactive (pos -1)."""
    _, (jmodel, jparams, cfg, params) = pair
    model = Model(cfg, device="cpu")
    ps, n_pages, nb, B = 4, 16, 4, 3
    jpool = jmodel.make_paged_caches(n_pages, ps)
    tpool = model.make_paged_caches(n_pages, ps)
    step = make_paged_serve_step(model)
    pages = np.random.default_rng(1).permutation(np.arange(1, n_pages))
    bt = np.zeros((B, nb), np.int32)
    bt[0], bt[2] = pages[:nb], pages[nb:2 * nb]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, B) \
        .astype(np.int32)
    near = 0
    for t in range(16):
        pos = np.array([t, -1, t], np.int32)
        jl, jpool = jmodel.decode_paged(jparams, jpool,
                                        jnp.asarray(toks[:, None]),
                                        jnp.asarray(pos), jnp.asarray(bt))
        tl, tpool = step(params, tpool, torch.tensor(toks[:, None]),
                         torch.from_numpy(pos), torch.from_numpy(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        toks, n = greedy(jl[:, 0], tl[:, 0])
        near += n
    assert near <= 4, f"{near} of {B * 16} greedy steps below the margin"


# (prompt, seed, tenant, new tokens): a decode-step prefill (2 tokens) to
# a 64-token bucket
SPEC = [(2, 1, "a", 5), (9, 2, "b", 6), (23, 3, "a", 7), (50, 4, "b", 5)]


@pytest.mark.parametrize("paged", [False, True])
def test_engine_token_logs_match_reference(pair, paged):
    """Both engines, 3 slots, four requests: the port's token logs equal
    the JAX engine's."""
    _, (jmodel, jparams, cfg, params) = pair
    kw = dict(n_slots=3, max_len=96)
    if paged:
        kw.update(paged=True, page_size=16)
    j_logs = serve_logs(JEngine(jmodel.model, jparams, **kw), SPEC,
                        cfg.vocab_size)
    t_logs = serve_logs(BatchingEngine(Model(cfg, device="cpu"), params,
                                       **kw), SPEC, cfg.vocab_size)
    assert t_logs == j_logs


# ---------------------------------------------------------------------------
# kernel_force
# ---------------------------------------------------------------------------

def _forced(cfg, force):
    return cfg.replace(geometry=dataclasses.replace(cfg.geometry,
                                                    kernel_force=force))


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m"])
def test_kernel_force_kernel_raises_off_the_card(arch):
    """"kernel" asks for the CUDA kernel: a prefill on CPU tensors raises,
    naming the card, in attention and in the SSM layer alike; the default
    and "ref" run the plain versions there."""
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    with torch.no_grad():
        for force in ("", "ref"):
            Model(_forced(cfg, force), device="cpu").prefill(params, toks, 16)
        with pytest.raises(ValueError, match="need a card.*on cpu"):
            Model(_forced(cfg, "kernel"), device="cpu").prefill(params, toks,
                                                                16)


def test_kernel_force_modes():
    """"kernel" takes the kernel path (not the plain one) on a tensor that
    may hold it: a CUDA tensor, or a meta tensor (admission's shape check,
    which launches nothing); "interpret" raises: no interpreter runs the
    CUDA sources; any other mode raises naming the three it knows."""
    opts = attention.AttnOpts(n_heads=4, n_kv_heads=2, head_dim=32,
                              kernel_force="kernel")
    assert attention._plain(opts, torch.empty(2, device="meta")) is False
    assert attention._plain(opts) is False
    with pytest.raises(ValueError, match="kernel_force 'kernel'"):
        attention._plain(opts, torch.zeros(2))
    assert attention._plain(dataclasses.replace(opts, kernel_force="ref"),
                            torch.zeros(2)) is True
    with pytest.raises(ValueError, match="no interpreter"):
        attention._plain(dataclasses.replace(opts, kernel_force="interpret"))
    with pytest.raises(ValueError, match="'kernel' and 'ref'"):
        attention._plain(dataclasses.replace(opts, kernel_force="pallas"))
