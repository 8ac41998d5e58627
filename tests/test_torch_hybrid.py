"""The hybrid family (zamba2-7b: a Mamba2 backbone with one shared
attention+MLP block applied at every 6th site) on the port against the JAX
package: the stage plan, the shared block's parameter tree, reduced zamba2
through the serve-step factories (the entry point of SSM archs: the engine
refuses them, in both packages).

The reference's init sets each SSM block's gate norm to 0, which zeroes the
block's output (``rms_norm(..., plus_one=False)``); the parity runs set it
to about 1 on both sides (``torch_parity.with_norms_near_one``).

Tolerance: atol 2e-5, rtol 2e-4 on fp32 logits on the plain chunked SSD
(``kernel_force="ref"``), where both sides run the same algorithm; atol
5e-4, rtol 5e-3 (the reference's SSD tolerance) on the default path, where
the port's sequential SSD (the kernel's plain version) meets the
reference's chunked one.
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
from repro.models.stages import plan_stages as j_plan_stages
from repro.runtime import BatchingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model
from repro_torch.models.stages import plan_stages
from repro_torch.runtime import (BatchingEngine, make_prefill_step,
                                 make_serve_step)
from torch_parity import TOL, family_pair, greedy

torch.set_num_threads(1)

ARCH = "zamba2-7b"
SSD_TOL = dict(atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_zamba2_plan_equals_reference(size):
    """13 repeats of [5 x ssm, shared_attn] and a run of 3 ssm sites at full
    depth (81 layers); the same structure at reduced depth."""
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    if size == "reduced":
        cfg, jcfg = reduced(cfg), j_reduced(jcfg)
    ours, ref = plan_stages(cfg), j_plan_stages(jcfg)
    assert [dataclasses.asdict(s) for s in ours] == \
        [dataclasses.asdict(s) for s in ref]
    shared = [s for st in ours for s in st.sites if s.mixer == "shared_attn"]
    assert shared and all(s.mlp == "dense" for s in shared)


def _tree(node):
    """Nesting with leaves replaced by their shapes."""
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_tree(v) for v in node)
    return tuple(node.shape)


def test_shared_block_param_tree_equals_reference():
    """The port's own seeded init lays its parameters out as the
    reference's: ``params["shared"]`` (norm1, norm2, attn, mlp), and an
    empty dict at every shared_attn site of the stages."""
    jm = j_get_model(j_reduced(j_get_config(ARCH)))
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = Model(reduced(get_config(ARCH)), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert _tree(params) == _tree(jp)
    assert sorted(params["shared"]) == ["attn", "mlp", "norm1", "norm2"]
    assert params["stages"][0][5] == {}


@pytest.fixture(scope="module")
def zamba():
    return family_pair(ARCH)


def _force(cfg, force):
    return cfg.replace(geometry=dataclasses.replace(cfg.geometry,
                                                    kernel_force=force))


@pytest.mark.parametrize("force", ["ref", ""])
def test_zamba2_prefill_then_decode_matches_reference(zamba, force):
    """Through the serve-step factories: a 40-token prefill, then 6 decode
    steps; logits and every cache leaf (SSM states, conv tails, the shared
    sites' K/V) against the reference."""
    jmodel, jparams, cfg, params = zamba
    model = Model(_force(cfg, force), device="cpu")
    tol = TOL if force == "ref" else SSD_TOL
    prefill, step = make_prefill_step(model, 64), make_serve_step(model)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40)) \
        .astype(np.int32)
    jh, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 64)
    th, tc = prefill(params, {"tokens": torch.from_numpy(toks)})
    jl, tl = jmodel.logits(jparams, jh), model.logits(params, th)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    nxt, near = greedy(jl[:, -1], tl[:, -1])
    pos = np.full((2,), 40, np.int32)
    for _ in range(6):
        jl, jc = jmodel.decode(jparams, jc, jnp.asarray(nxt[:, None]),
                               jnp.asarray(pos))
        tl, tc = step(params, tc, torch.tensor(nxt[:, None]),
                      torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        nxt, n = greedy(jl[:, 0], tl[:, 0])
        near += n
        pos = pos + 1
    assert near <= 2, f"{near} of 14 greedy steps below the margin"
    j_leaves = jax.tree.leaves(jc)
    t_leaves = [leaf for st in tc for site in
                ((st,) if isinstance(st, dict) else st)
                for _, leaf in sorted(site.items())]
    assert len(j_leaves) == len(t_leaves)
    for j, t in zip(j_leaves, t_leaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def test_engine_refuses_zamba2(zamba):
    """Both engines refuse the hybrid (it has SSM state), naming their own
    SSM entry points."""
    jmodel, jparams, cfg, params = zamba
    lead = "BatchingEngine supports attention-family models; use "
    for engine, m, p in ((JEngine, jmodel.model, jparams),
                         (BatchingEngine, Model(cfg, device="cpu"), params)):
        with pytest.raises(ValueError, match="attention-family") as e:
            engine(m, p)
        assert str(e.value).startswith(lead)
    for make in (lambda: jmodel.make_paged_caches(8, 4),
                 lambda: Model(cfg, device="cpu").make_paged_caches(8, 4)):
        with pytest.raises(ValueError, match="SSM state and MLA latents"):
            make()
