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
