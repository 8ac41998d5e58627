"""``examples/train_smollm_torch.py`` on the CPU against the reference's
``examples/train_smollm.py``, both at the reference's reduced width
(6 layers, d 256, vocab 2048) on the same initial state (the reference's
``PRNGKey(0)`` train state carried over) and the same batches:

- ``--steps 60 --seq 4 --batch 1``: the smallest sequence and batch at
  which the reference's own ``assert losses[-1] < losses[0]`` holds for
  the straight run and for the restart below (``--seq 2`` fails it), and
  60 steps to save at step 50 and train ten more after the restart;
- every step's loss within 1e-4 relative of the reference loop's (its
  jitted step's metrics, read through a wrapped ``jax.jit``), and what it
  prints equal but for the losses, times and rates;
- a rerun with the same ``--ckpt-dir`` restores step 50 in both packages
  and trains steps 50-59: the port's losses equal its straight run's bit
  for bit and the reference's restart within 1e-4 relative.
"""
import re

import jax
import numpy as np
import pytest
import torch

from examples_parity import captured, mask, port_example, reference_main

torch.set_num_threads(1)

STEPS, SEQ, BATCH, SAVED_AT = 60, 4, 1, 50
ARGV = ["--steps", str(STEPS), "--seq", str(SEQ), "--batch", str(BATCH)]


class _RecordingJax:
    """``jax`` for the reference example, whose ``jax.jit`` step also
    records every step's loss as a float."""

    def __init__(self, losses):
        self.losses = losses

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        step = jax.jit(fn)

        def recorded(*a):
            state, metrics = step(*a)
            self.losses.append(float(metrics["loss"]))
            return state, metrics
        return recorded


def _no_losses(text):
    return re.sub(r"(loss |first5 |last5 )(\[[^\]]*\]|[\d.]+)", r"\1#",
                  mask(text))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.models import get_model
    from repro.optim import AdamWConfig
    from repro.runtime import TrainOpts, init_train_state
    from repro_torch.interop import train_state_from_numpy
    ex = port_example("train_smollm")
    cfg = ex.config(False)
    opts = TrainOpts(opt=AdamWConfig(lr=3e-3, warmup_steps=20,
                                     total_steps=STEPS), loss_chunk=64)
    js = jax.tree.map(np.asarray, init_train_state(
        get_model(cfg), jax.random.PRNGKey(0), opts))
    tdir = tmp_path_factory.mktemp("port_ckpt")
    jdir = tmp_path_factory.mktemp("reference_ckpt")
    out = {}
    for run in ("straight", "restart"):
        res, printed = captured(
            ex.main, ARGV + ["--device", "cpu", "--ckpt-dir", str(tdir)],
            state=train_state_from_numpy(js, cfg))
        losses = []
        want = reference_main("train_smollm", ARGV + ["--ckpt-dir", str(jdir)],
                              patch={"jax": _RecordingJax(losses)})
        out[run] = dict(res=res, printed=printed, ref_printed=want,
                        ref_losses=losses)
    return out


@pytest.mark.parametrize("run", ("straight", "restart"))
def test_losses_track_the_reference(runs, run):
    r = runs[run]
    start = 0 if run == "straight" else SAVED_AT
    assert r["res"]["start"] == start
    assert len(r["res"]["losses"]) == len(r["ref_losses"]) == STEPS - start
    np.testing.assert_allclose(r["res"]["losses"], r["ref_losses"],
                               rtol=1e-4)
    assert _no_losses(r["printed"]) == _no_losses(r["ref_printed"])
    if run == "straight":
        assert f"step   {SAVED_AT}  loss" in r["printed"]
    else:
        assert f"restored checkpoint at step {SAVED_AT}" in r["printed"]


def test_restart_continues_the_run(runs):
    straight = runs["straight"]["res"]["losses"]
    assert runs["restart"]["res"]["losses"] == straight[SAVED_AT:]
