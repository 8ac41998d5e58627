"""Shared helper of the port's runtime parity tests (not a test module).

Token logs of the port and of the JAX package are compared exactly. The
premise is asserted, not assumed: one teacher-forced JAX forward over each
prompt plus its generated tokens shows a top-2 logit margin above
``MARGIN`` at every generated position, far above the fp32 drift between
the two implementations (see tests/test_torch_models.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

MARGIN = 1e-3


@functools.partial(jax.jit, static_argnums=0)
def _teacher_forced_logits(jmodel, jparams, tokens):
    h, _ = jmodel.forward(jparams, {"tokens": tokens})
    return jmodel.logits(jparams, h)


def assert_margins(jmodel, jparams, prompts, outs, width):
    """One batched causal forward over every prompt + its output, zero-
    padded at the tail to ``width`` (the padding cannot reach earlier
    positions); every generated position's top-2 margin exceeds MARGIN."""
    seqs = np.zeros((len(prompts), width), np.int32)
    for i, (p, out) in enumerate(zip(prompts, outs)):
        seq = list(p) + list(out)
        seqs[i, :len(seq)] = seq
    logits = np.asarray(_teacher_forced_logits(jmodel, jparams,
                                               jnp.asarray(seqs)), np.float64)
    for i, (p, out) in enumerate(zip(prompts, outs)):
        n = len(p)
        top2 = np.sort(logits[i, n - 1:n - 1 + len(out)], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN, \
            f"sequence {i}: a top-2 margin at or below {MARGIN}"


# ---------------------------------------------------------------------------
# The families of the eighth slice (MoE, MLA, hybrid, encoder-decoder, VLM)
# ---------------------------------------------------------------------------

TOL = dict(atol=2e-5, rtol=2e-4)


def with_norms_near_one(tree, rng):
    """The reference's init sets an MLA layer's ``kv_norm`` and an SSM
    block's gate norm to 0, and both are applied with
    ``rms_norm(..., plus_one=False)``: the MLA latent (hence its keys,
    values and output) and the SSM block's output are then exactly 0. Give
    them weights around 1 so that the layers show in the logits."""
    if isinstance(tree, dict):
        return {k: (1.0 + 0.1 * rng.standard_normal(v.shape))
                .astype(np.float32)
                if k == "kv_norm" or (k == "norm" and "in_proj" in tree)
                else with_norms_near_one(v, rng) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(with_norms_near_one(v, rng) for v in tree)
    return tree


class Jitted:
    """The reference model with its decode entry points jitted once (eager
    JAX takes seconds a step)."""

    def __init__(self, jmodel):
        self.model = jmodel
        self.decode = jax.jit(jmodel.decode)
        self.decode_paged = jax.jit(jmodel.decode_paged)

    def __getattr__(self, name):
        return getattr(self.model, name)


def family_pair(arch, norms=True, **replace):
    """Reduced ``arch`` in fp32 (``replace`` applied on both sides):
    (the JAX model with jitted decode, its params, the port's config, the
    same params carried into the port). ``norms``: MLA ``kv_norm`` and SSM
    gate norms around 1 on both sides (``with_norms_near_one``)."""
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models import get_model as j_get_model
    from repro_torch.configs import get_config, reduced
    from repro_torch.interop import params_from_numpy
    kw = dict(dtype="float32", **replace)
    jmodel = j_get_model(j_reduced(j_get_config(arch)).replace(**kw))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    if norms:
        tree = with_norms_near_one(tree, np.random.default_rng(0))
    cfg = reduced(get_config(arch)).replace(**kw)
    return (Jitted(jmodel), jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, cfg))


def greedy(jl, tl, margin=MARGIN):
    """The reference's greedy tokens from its logits ``jl``; the port's
    (``tl``) must agree wherever the reference's top-2 margin exceeds
    ``margin``. Returns (tokens, count of rows below the margin)."""
    jl = np.asarray(jl, np.float64)
    top2 = np.sort(jl, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > margin
    nxt = jl.argmax(-1)
    assert np.array_equal(nxt[clear], tl.argmax(-1).numpy()[clear])
    return nxt.astype(np.int32), int((~clear).sum())


def serve_logs(engine, spec, vocab):
    """Serve ``spec`` [(prompt len or token list, seed, tenant, new tokens)]
    to completion; returns the token logs in submission order. An int
    prompt is that many seeded tokens; a list is taken as it is."""
    reqs = []
    for n, seed, tenant, new in spec:
        prompt = n if isinstance(n, list) else \
            np.random.default_rng(seed).integers(0, vocab, size=n).tolist()
        reqs.append(engine.submit(prompt, max_new_tokens=new, tenant=tenant))
    for _ in range(2000):
        engine.step()
        if engine.idle():
            break
    assert engine.idle()
    return [r.out_tokens for r in reqs]


# ---------------------------------------------------------------------------
# Training (the tenth slice)
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 32


def train_batch(cfg, seed=1):
    """A seeded numpy batch at the reference's keys (``api.py``'s
    train_input_specs): tokens and labels; ``patches`` for a VLM (S
    covers patches and tokens); ``frames`` for the audio family (its
    decoder takes S/2 tokens)."""
    rng = np.random.default_rng(seed)
    ints = lambda n: rng.integers(0, cfg.vocab_size, (TRAIN_B, n)) \
        .astype(np.int32)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
                    (TRAIN_B, TRAIN_S, cfg.d_model)).astype(np.float32),
                "tokens": ints(TRAIN_S // 2), "labels": ints(TRAIN_S // 2)}
    n = TRAIN_S - cfg.n_patches
    batch = {"tokens": ints(n), "labels": ints(n)}
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal(
            (TRAIN_B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def train_chunk(cfg):
    """The loss chunk: 16; 8 for the VLM, whose labels (16 tokens) are
    shorter than h (16 patches + 16 tokens): a chunk must divide h's
    positions and fit the labels (the reference's slicing;
    tests/test_torch_train_parts.py)."""
    return 8 if cfg.n_patches else 16


def router_margins(monkeypatch, jmodel, jparams, batch):
    """The reference's fp32 router probabilities at every MoE layer of one
    forward over ``batch``: each token's top-k margin (the k-th sorted
    probability less the (k+1)-th), read out of the layers' scan with
    ``jax.debug.callback``."""
    from repro.models import stages
    out = []
    real = stages.moe_forward

    def watched(p, x, opts):
        logits = jnp.einsum("tc,ce->te", x.reshape(-1, x.shape[-1])
                            .astype(jnp.float32), p["router"])
        top = jax.lax.top_k(jax.nn.softmax(logits, -1), opts.cfg.top_k + 1)[0]
        jax.debug.callback(lambda m: out.append(np.asarray(m)),
                           top[:, -2] - top[:, -1])
        return real(p, x, opts)

    monkeypatch.setattr(stages, "moe_forward", watched)
    jmodel.forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.setattr(stages, "moe_forward", real)
    return out


def check_step0_gradients(arch, monkeypatch):
    """Reduced ``arch`` in fp32, the JAX init carried across with MLA
    ``kv_norm`` and SSM gate norms near 1 (else those gradients are zero
    against zero): ``make_loss_fn``'s loss, xent and aux within rtol 1e-5
    of the reference's, every gradient leaf within rtol 1e-4 / atol 1e-5
    x that leaf's max |g|, leaf for leaf in the reference's order; every
    leaf's gradient is nonzero at these norms (the card's train_families
    phase gates on the same)."""
    from repro.runtime.train import TrainOpts as JTrainOpts
    from repro.runtime.train import make_loss_fn as j_make_loss_fn
    from repro_torch.models import get_model
    from repro_torch.runtime.train import (TrainOpts, _value_and_grad,
                                           make_loss_fn)
    from repro_torch.tree import flatten
    import torch
    jmodel, jparams, cfg, params = family_pair(arch)
    jmodel = jmodel.model
    batch = train_batch(cfg)
    if cfg.moe is not None:
        margins = router_margins(monkeypatch, jmodel, jparams, batch)
        n_moe = cfg.n_layers - cfg.moe.first_k_dense
        assert len(margins) == n_moe
        assert min(float(m.min()) for m in margins) > 1e-5, \
            "a router near-tie: pick other inputs"
    chunk = train_chunk(cfg)
    (jl, jm), jg = jax.value_and_grad(
        j_make_loss_fn(jmodel, JTrainOpts(loss_chunk=chunk)),
        has_aux=True)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm, tg = _value_and_grad(
        make_loss_fn(get_model(cfg, device="cpu"),
                     TrainOpts(loss_chunk=chunk)),
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    for got, want in ((tl, jl), (tm["xent"], jm["xent"]),
                      (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    if cfg.moe is not None:
        assert float(tm["aux"]) > 0
    ref, mine = jax.tree.leaves(jg), flatten(tg)[0]
    assert len(ref) == len(mine)
    for i, (a, b) in enumerate(zip(ref, mine)):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), i
        assert np.abs(a).max() > 0, f"gradient leaf {i} is zero"
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(a).max()),
                                   err_msg=f"gradient leaf {i}")
