"""End-to-end training through the port (tests/test_system.py's RAaaS story
mirrored): a tenant trains a reduced model through the hypervisor's batch
scheduler with checkpoints, its node dies mid-run, the job is requeued,
the node sweep marks the node dead, and the job resumes from the last
checkpoint on the surviving node. The JAX package runs the same story in
the same test from the same initial state (carried across with
``train_state_from_numpy``); its 15 losses and the port's agree within
1e-3 relative. Plus the port's launcher, ``repro_torch.launch.train``:
its loss falls, a run cut after a checkpoint and resumed from
``--ckpt-dir`` ends in the same state bit for bit as an uninterrupted
run, and it refuses a device mesh.
"""
import json

import numpy as np
import pytest
import torch

import jax

from repro.ckpt import restore as j_restore
from repro.ckpt import save as j_save
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import ClusterSpec as JClusterSpec
from repro.core import Hypervisor as JHypervisor
from repro.core import MonitorConfig as JMonitorConfig
from repro.data import DataConfig, DataPipeline
from repro.models import get_model as j_get_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import TrainOpts as JTrainOpts
from repro.runtime import init_train_state as j_init_train_state
from repro.runtime import make_train_step as j_make_train_step
from repro_torch.ckpt import restore, save
from repro_torch.configs import get_config, reduced
from repro_torch.core import ClusterSpec, Hypervisor, MonitorConfig
from repro_torch.interop import train_state_from_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainOpts, make_train_step

torch.set_num_threads(1)


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


def _failover_story(hv, clock, train_job, losses):
    """The reference test's sequence, asserted on either package."""
    job = hv.scheduler.submit("tenant", 4,
                              run=lambda s: train_job(s, crash_at=5))
    hv.scheduler.run_pending()            # crashes mid-run, requeued
    assert job.state.value == "requeued"
    assert len(losses) == 5

    # the node that hosted it dies entirely; node-1 keeps heartbeating
    for n in hv.db.nodes:
        hv.monitor.heartbeat(n)
    clock.t = 15.0
    hv.monitor.heartbeat("node-1")
    clock.t = 20.0
    hv.handle_failures()
    assert not hv.db.nodes["node-0"].alive
    assert hv.db.nodes["node-1"].alive

    job.run = lambda s: train_job(s)      # resume (no crash this time)
    hv.scheduler.run_pending()
    assert job.state.value == "done"
    assert len(losses) == 15
    assert losses[-1] < losses[0]


def test_raas_training_with_failover_matches_reference(tmp_path):
    kw = dict(dtype="float32", vocab_size=256)
    jmodel = j_get_model(j_reduced(j_get_config("smollm-135m")).replace(**kw))
    cfg = reduced(get_config("smollm-135m")).replace(**kw)
    jopts = JTrainOpts(opt=JAdamWConfig(lr=2e-3, warmup_steps=2,
                                        total_steps=40), loss_chunk=16)
    opts = TrainOpts(opt=AdamWConfig(lr=2e-3, warmup_steps=2,
                                     total_steps=40), loss_chunk=16)
    data = DataPipeline(DataConfig(vocab_size=256, seq_len=32, batch_size=4))
    j_init = j_init_train_state(jmodel, jax.random.PRNGKey(0), jopts)
    runs = {}
    for pkg in ("jax", "port"):
        clock, losses = Clock(), []
        ckpt_dir = str(tmp_path / pkg)
        if pkg == "jax":
            hv = JHypervisor(JClusterSpec(n_nodes=2, devices_per_node=1),
                             JMonitorConfig(heartbeat_deadline_s=10),
                             clock=clock)
            step = jax.jit(j_make_train_step(jmodel, jopts))
            init = lambda: j_init
            load = lambda: j_restore(ckpt_dir, jax.eval_shape(init))
            store = j_save
        else:
            hv = Hypervisor(ClusterSpec(n_nodes=2, devices_per_node=1),
                            MonitorConfig(heartbeat_deadline_s=10),
                            clock=clock, device="cpu")
            step = make_train_step(get_model(cfg, device="cpu"), opts)
            init = lambda: train_state_from_numpy(
                jax.tree.map(np.asarray, j_init), cfg)
            load = lambda: restore(ckpt_dir, init())
            store = save

        def train_job(slice_id, crash_at=None, step=step, init=init,
                      load=load, store=store, losses=losses,
                      ckpt_dir=ckpt_dir):
            try:
                state, start = load()
            except FileNotFoundError:
                state, start = init(), 0
            for i in range(start, start + 10):
                if crash_at is not None and i == crash_at:
                    raise RuntimeError("node lost")
                state, m = step(state, data.batch_at(i))
                losses.append(float(m["loss"]))
                store(state, ckpt_dir, step=i + 1, keep=2)
            return float(losses[-1])

        _failover_story(hv, clock, train_job, losses)
        runs[pkg] = losses
    np.testing.assert_allclose(runs["port"], runs["jax"], rtol=1e-3)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

ARGS = ["--arch", "smollm-135m", "--reduce", "--device", "cpu",
        "--batch", "4", "--seq", "32"]


def test_launcher_loss_falls(capsys):
    losses = launch_train.main(ARGS + ["--steps", "20"])
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    out = capsys.readouterr().out
    assert "step   20 loss" in out and "gnorm" in out and "tok/s" in out


def test_launcher_resume_is_bitexact(tmp_path, monkeypatch, capsys):
    """50 steps straight (checkpoints at 25 and 50) against a run that
    dies at step 30 and a second run that resumes from step 25: both end
    in the same step-50 checkpoint, leaf for leaf and bit for bit."""
    straight, cut = str(tmp_path / "a"), str(tmp_path / "b")
    run = ARGS + ["--steps", "50"]
    launch_train.main(run + ["--ckpt-dir", straight])
    real = launch_train.DataPipeline.batch_at

    def dies_at_30(self, step):
        if step == 30:
            raise RuntimeError("node lost")
        return real(self, step)

    monkeypatch.setattr(launch_train.DataPipeline, "batch_at", dies_at_30)
    with pytest.raises(RuntimeError, match="node lost"):
        launch_train.main(run + ["--ckpt-dir", cut])
    monkeypatch.setattr(launch_train.DataPipeline, "batch_at", real)
    resumed = launch_train.main(run + ["--ckpt-dir", cut])
    assert len(resumed) == 25
    assert "resumed from step 25" in capsys.readouterr().out
    a, b = (tmp_path / d / "step_00000050" for d in ("a", "b"))
    n = json.loads((a / "manifest.json").read_text())["n_leaves"]
    for i in range(n):
        x, y = (np.load(p / f"leaf_{i}.npy") for p in (a, b))
        assert x.dtype == y.dtype and np.array_equal(x, y), f"leaf {i}"


@pytest.mark.parametrize("flag", ["--data", "--model"])
def test_launcher_refuses_a_mesh(flag):
    """A mesh larger than the world: the reference's own refusal
    (``make_host_mesh``: 2 devices needed, 1 exists)."""
    with pytest.raises(ValueError, match="^need 2 devices, have 1$"):
        launch_train.main(ARGS + ["--steps", "1", flag, "2"])
