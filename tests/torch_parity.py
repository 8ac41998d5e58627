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
