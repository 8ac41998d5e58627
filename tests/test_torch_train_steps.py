"""Training steps in sequence and checkpoints, the port against the JAX
package: reduced smollm-135m over 5 steps of ``make_train_step`` (losses
within 1e-3 relative each step), microbatches and remat against the plain
step, reduced qwen3-moe over 2 steps with its load-balance aux loss, and
the checkpoint cases of tests/test_fault_tolerance.py (bit-exact restart
on the CPU, keep-k and atomicity, the structure-mismatch refusal) plus the
port's ``save`` of a carried-over state against the reference's ``save``
of the original: the same leaf files.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.ckpt import save as j_save
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import DataConfig as JDataConfig
from repro.data import DataPipeline as JDataPipeline
from repro.models import get_model as j_get_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import TrainOpts as JTrainOpts
from repro.runtime import init_train_state as j_init_train_state
from repro.runtime import make_train_step as j_make_train_step
from repro_torch.ckpt import available_steps, restore, save
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.interop import train_state_from_numpy
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainOpts, make_train_step
from repro_torch.tree import flatten

torch.set_num_threads(1)

OPT = dict(lr=2e-3, warmup_steps=2, total_steps=40)


def _setup(arch, opts_kw=None, **replace):
    """Both packages' reduced ``arch`` (fp32, vocab 256), the JAX train
    state, the port's state carried across with ``train_state_from_numpy``,
    and the reference's data pipeline (B 4, S 32)."""
    kw = dict(dtype="float32", vocab_size=256, **replace)
    jmodel = j_get_model(j_reduced(j_get_config(arch)).replace(**kw))
    cfg = reduced(get_config(arch)).replace(**kw)
    jopts = JTrainOpts(opt=JAdamWConfig(**OPT), loss_chunk=16,
                       **(opts_kw or {}))
    jstate = j_init_train_state(jmodel, jax.random.PRNGKey(0), jopts)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg)
    data = JDataPipeline(JDataConfig(vocab_size=256, seq_len=32,
                                     batch_size=4))
    return jmodel, jopts, jstate, get_model(cfg, device="cpu"), state, data


def _run(step, state, data, steps, start=0):
    losses = []
    for i in range(start, start + steps):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    return state, losses, m


def test_train_steps_match_reference():
    """5 steps of reduced smollm: every step's loss within 1e-3 relative of
    the reference's jitted step; the metrics carry the same keys; the
    parameters and moments after 5 steps agree with the reference's."""
    jmodel, jopts, jstate, model, state, data = _setup("smollm-135m")
    jstate, jl, jm = _run(jax.jit(j_make_train_step(jmodel, jopts)),
                          jstate, data, 5)
    opts = TrainOpts(opt=AdamWConfig(**OPT), loss_chunk=16)
    state, tl, tm = _run(make_train_step(model, opts), state, data, 5)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
    assert set(tm) == set(jm) == {"loss", "xent", "aux", "grad_norm", "lr"}
    assert all(v.dim() == 0 for v in tm.values())
    assert int(state["step"]) == 5 and int(state["opt_state"]["count"]) == 5
    for a, b in zip(jax.tree.leaves(jstate), flatten(state)[0]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("variant", ["microbatches", "remat"])
def test_micro_and_remat_equal_the_plain_step(variant):
    """One step from the same state and batch: remat recomputes each layer
    in the backward pass (bit-exact on the CPU); two microbatches average
    two halves' gradients (fp32 summation order only: the metrics within
    rtol 1e-6; the moments, linear in the gradient and its square, within
    rtol 1e-5 / atol 1e-6 x the leaf's max, since an element whose two
    halves nearly cancel keeps only the leaf's rounding, not its own. The
    parameters are not compared: Adam's first step divides g by |g| +
    1e-8, so an element whose gradient is near 1e-8 turns that rounding
    into an O(1) change of its step)."""
    _, _, _, model, state, data = _setup("smollm-135m")
    base = dict(opt=AdamWConfig(**OPT), loss_chunk=16)
    plain = make_train_step(model, TrainOpts(**base))
    other = make_train_step(model, TrainOpts(
        **base, **({"microbatches": 2} if variant == "microbatches"
                   else {"remat": True})))
    batch = data.batch_at(0)
    s0, m0 = plain(state, batch)
    s1, m1 = other(state, batch)
    if variant == "remat":
        for a, b in zip(flatten((s0, m0))[0], flatten((s1, m1))[0]):
            assert torch.equal(a, b)
        return
    for k in ("loss", "xent", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6)
    for a, b in zip(flatten(s0["opt_state"])[0],
                    flatten(s1["opt_state"])[0]):
        np.testing.assert_allclose(
            b.numpy(), a.numpy(), rtol=1e-5,
            atol=1e-6 * float(a.abs().max()))


def test_moe_train_steps_match_reference():
    """2 steps of reduced qwen3-moe: losses within 1e-3 relative of the
    reference's, the aux loss nonzero on both sides and within 1e-3."""
    jmodel, jopts, jstate, model, state, data = _setup("qwen3-moe-30b-a3b")
    jstate, jl, jm = _run(jax.jit(j_make_train_step(jmodel, jopts)),
                          jstate, data, 2)
    state, tl, tm = _run(make_train_step(model, TrainOpts(
        opt=AdamWConfig(**OPT), loss_chunk=16)), state, data, 2)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert float(tm["aux"]) > 0 and float(jm["aux"]) > 0
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-3)


# ---------------------------------------------------------------------------
# Checkpoints (tests/test_fault_tolerance.py)
# ---------------------------------------------------------------------------

def _port_setup():
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32",
                                                     vocab_size=256)
    model = get_model(cfg, device="cpu")
    opts = TrainOpts(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=50), loss_chunk=16)
    from repro_torch.runtime import init_train_state
    state = init_train_state(model, torch.Generator().manual_seed(0), opts)
    dp = DataPipeline(DataConfig(vocab_size=256, seq_len=32, batch_size=4))
    return state, make_train_step(model, opts), dp


def test_checkpoint_restart_bitexact(tmp_path):
    """Train 6 steps straight vs 3 + crash + restore + 3: identical
    state."""
    d = str(tmp_path / "ckpt")
    state, step, dp = _port_setup()
    sa = state
    for i in range(6):
        sa, _ = step(sa, dp.batch_at(i))
    sb = state
    for i in range(3):
        sb, _ = step(sb, dp.batch_at(i))
    save(sb, d, step=3)
    del sb
    like = flatten(state)
    meta = [t.to("meta") for t in like[0]]
    from repro_torch.tree import unflatten
    restored, at = restore(d, unflatten(like[1], meta), device="cpu")
    assert at == 3
    for i in range(3, 6):
        restored, _ = step(restored, dp.batch_at(i))
    for a, b in zip(flatten(sa)[0], flatten(restored)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_keep_k_and_atomicity(tmp_path):
    d = str(tmp_path / "ckpt")
    state = {"w": torch.arange(8.0)}
    for s in range(5):
        save({"w": torch.arange(8.0) + s}, d, step=s, keep=2)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a torn write
    assert available_steps(d) == [3, 4]
    got, s = restore(d, state)
    assert s == 4
    np.testing.assert_allclose(got["w"].numpy(), np.arange(8.0) + 4)


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    d = str(tmp_path / "ckpt")
    save({"w": torch.ones(4)}, d, step=0)
    with pytest.raises(ValueError, match="architecture mismatch"):
        restore(d, {"w": torch.ones(4), "extra": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        restore(d, {"w": torch.ones(5)})


def test_save_writes_the_reference_leaf_files(tmp_path):
    """The port's ``save`` of a carried-over train state (with residuals)
    against the reference's ``save`` of the original: the same n_leaves,
    shapes and dtypes in the manifest and equal leaf arrays (``treedef``
    is a JAX string and is not compared); ``save_async`` writes the
    same."""
    from repro_torch.ckpt import save_async
    jmodel, jopts, jstate, model, state, data = _setup(
        "zamba2-7b", opts_kw=dict(compress_grads=True))
    jstate = dict(jstate, step=jnp.asarray(7, jnp.int32))
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                   model.cfg)
    j_save(jstate, str(tmp_path / "ref"), step=7)
    save(state, str(tmp_path / "port"), step=7)
    save_async(state, str(tmp_path / "async"), step=7).join(timeout=60)
    ref = tmp_path / "ref" / "step_00000007"
    for mine in (tmp_path / "port" / "step_00000007",
                 tmp_path / "async" / "step_00000007"):
        a, b = (json.loads((p / "manifest.json").read_text())
                for p in (ref, mine))
        for k in ("step", "n_leaves", "shapes", "dtypes", "extra"):
            assert a[k] == b[k], k
        for i in range(a["n_leaves"]):
            x, y = (np.load(p / f"leaf_{i}.npy") for p in (ref, mine))
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
