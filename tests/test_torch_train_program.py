"""The training program (the reference's ``jax.jit(make_train_step(...))``
with its state donated): the in-place steps and ``train_program`` /
``dp_train_program`` on the CPU, where the program runs the very step that
the card captures, eagerly.

- the in-place step and the program against the functional
  ``make_train_step``, bit for bit over 5 steps (losses, metrics, every
  state leaf): reduced smollm-135m plain, with 2 microbatches and with
  remat, qwen3-moe (its aux loss nonzero), mamba2, whisper and llava;
  every state leaf keeps its address, ``step`` and ``count`` advance;
- the in-place AdamW against the reference's ``adamw_update`` over 20
  steps (rtol 1e-6, as tests/test_torch_train_parts.py);
- the program against the JAX package's ``make_train_step`` over 5 steps
  (losses within 1e-3 relative, as tests/test_torch_train_steps.py);
- the batch buffers keep their addresses whether a batch arrives as
  numpy arrays or as tensors at new addresses, one set a batch shape;
- a save and restore of an in-place state restarts bit-exact;
- on 2 gloo ranks the in-place DP step (``dp_train_program``) equals the
  functional ``make_dp_train_step`` bit for bit, compressed and not, and
  the functional step leaves its input state as it was.
"""
import datetime
import multiprocessing
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import DataConfig as JDataConfig
from repro.data import DataPipeline as JDataPipeline
from repro.models import get_model as j_get_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as j_adamw_update
from repro.optim import init_opt_state as j_init_opt_state
from repro.runtime import TrainOpts as JTrainOpts
from repro.runtime import init_train_state as j_init_train_state
from repro.runtime import make_train_step as j_make_train_step
from repro_torch.ckpt import restore, save
from repro_torch.configs import get_config, reduced
from repro_torch.interop import train_state_from_numpy
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig, adamw_update_, init_opt_state
from repro_torch.runtime import (TrainOpts, init_train_state,
                                 make_inplace_train_step, make_train_step,
                                 train_program)
from repro_torch.tree import flatten, tree_map
from torch_parity import train_batch, train_chunk

torch.set_num_threads(1)

OPT = dict(lr=2e-3, warmup_steps=2, total_steps=40)
STEPS = 5
# (case id, arch, TrainOpts overrides)
CASES = (("smollm", "smollm-135m", {}),
         ("smollm_micro2", "smollm-135m", {"microbatches": 2}),
         ("smollm_remat", "smollm-135m", {"remat": True}),
         ("qwen3moe", "qwen3-moe-30b-a3b", {}),
         ("mamba2", "mamba2-370m", {}),
         ("whisper", "whisper-tiny", {}),
         ("llava", "llava-next-34b", {}))


def _norms_to_one(tree):
    """SSM gate norms and MLA ``kv_norm`` at 1 (the init's 0 zeroes those
    layers' outputs and gradients)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, torch.Tensor) and (
                    k == "kv_norm" or (k == "norm" and "in_proj" in tree)):
                v.fill_(1.0)
            else:
                _norms_to_one(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _norms_to_one(v)


def _port(arch, **opts_kw):
    """The port's reduced ``arch`` in fp32 on the CPU, its TrainOpts and a
    seeded state (norms at 1)."""
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    model = get_model(cfg, device="cpu")
    opts = TrainOpts(opt=AdamWConfig(**OPT), loss_chunk=train_chunk(cfg),
                     **opts_kw)
    state = init_train_state(model, torch.Generator().manual_seed(0), opts)
    _norms_to_one(state["params"])
    return cfg, model, opts, state


def _clone(tree):
    return tree_map(torch.clone, tree)


@pytest.mark.parametrize("runner", ["inplace_step", "program"])
@pytest.mark.parametrize("case,arch,opts_kw", CASES,
                         ids=[c[0] for c in CASES])
def test_inplace_step_equals_make_train_step(case, arch, opts_kw, runner):
    """5 steps of the functional step and of the in-place one (or the
    program) from one state on one seeded batch a step: every metric and,
    after the 5 steps, every state leaf equal bit for bit; the in-place
    state's leaves are the caller's tensors at their addresses, and its
    ``step`` and ``count`` read 5."""
    cfg, model, opts, state = _port(arch, **opts_kw)
    ref = make_train_step(model, opts)
    step = train_program(model, opts) if runner == "program" \
        else make_inplace_train_step(model, opts)
    mine = _clone(state)
    leaves = flatten(mine)[0]
    ptrs = [t.data_ptr() for t in leaves]
    kept = []
    for i in range(STEPS):
        batch = train_batch(cfg, seed=i)
        state, want = ref(state, batch)
        got_state, got = step(mine, batch)
        assert all(a is b for a, b in zip(flatten(got_state)[0], leaves))
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        kept.append(got["loss"])
    if cfg.moe is not None:
        assert float(got["aux"]) > 0
    assert [t.data_ptr() for t in flatten(mine)[0]] == ptrs
    assert int(mine["step"]) == int(mine["opt_state"]["count"]) == STEPS
    for i, (a, b) in enumerate(zip(flatten(state)[0], flatten(mine)[0])):
        assert a.dtype == b.dtype and torch.equal(a, b), f"leaf {i}"
    # the metrics a caller keeps are its own: each step's loss as it was
    assert len({id(x) for x in kept}) == STEPS


def _grad_tree(rng):
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "blk": ({"a": rng.standard_normal(32).astype(np.float32)},
                    {"a": rng.standard_normal(32).astype(np.float32)}),
            "b": rng.standard_normal(5).astype(np.float32)}


def test_inplace_adamw_matches_reference_over_20_steps():
    """The in-place update of seeded gradients through warmup and into the
    cosine decay against the reference's ``adamw_update`` (unclipped, as
    tests/test_torch_train_parts.py holds the functional one, rtol 1e-6);
    every leaf and ``count`` keep their tensors."""
    from repro.optim.adamw import AdamWConfig as JCfg
    kw = dict(lr=1e-2, warmup_steps=5, total_steps=30, clip_norm=1e9)
    jcfg, cfg = JCfg(**kw), AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = _grad_tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    jopt, topt = j_init_opt_state(jp), init_opt_state(tp)
    tensors = flatten((tp, topt))[0]
    for _ in range(20):
        g = _grad_tree(rng)
        jp, jopt, jm = j_adamw_update(jcfg, jax.tree.map(jnp.asarray, g),
                                      jopt, jp)
        tm = adamw_update_(cfg, tree_map(torch.from_numpy, g), topt, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert all(a is b for a, b in zip(flatten((tp, topt))[0], tensors))
    for jtree, ttree in ((jp, tp), (jopt["mu"], topt["mu"]),
                         (jopt["nu"], topt["nu"])):
        for a, b in zip(jax.tree.leaves(jtree), flatten(ttree)[0]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    assert int(topt["count"]) == int(jopt["count"]) == 20


@pytest.mark.parametrize("opts_kw", [{}, {"microbatches": 2}],
                         ids=["plain", "micro2"])
def test_program_matches_reference_train_step(opts_kw):
    """5 steps of reduced smollm through ``train_program`` against the JAX
    package's jitted ``make_train_step`` from the same state: every
    step's loss within 1e-3 relative, the loss falls."""
    kw = dict(dtype="float32", vocab_size=256)
    jmodel = j_get_model(j_reduced(j_get_config("smollm-135m"))
                         .replace(**kw))
    cfg = reduced(get_config("smollm-135m")).replace(**kw)
    jopts = JTrainOpts(opt=JAdamWConfig(**OPT), loss_chunk=16, **opts_kw)
    jstate = j_init_train_state(jmodel, jax.random.PRNGKey(0), jopts)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg)
    data = JDataPipeline(JDataConfig(vocab_size=256, seq_len=32,
                                     batch_size=4))
    jstep = jax.jit(j_make_train_step(jmodel, jopts))
    program = train_program(get_model(cfg, device="cpu"), TrainOpts(
        opt=AdamWConfig(**OPT), loss_chunk=16, **opts_kw))
    jl, tl = [], []
    for i in range(STEPS):
        jstate, jm = jstep(jstate, data.batch_at(i))
        state, tm = program(state, data.batch_at(i))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


def test_batch_buffers_keep_their_addresses():
    """A batch as numpy arrays, then as tensors at new addresses, lands in
    the same buffers (their contents the batch's); another shape gets its
    own set, and the first shape's set comes back for its next batch."""
    cfg, model, opts, _ = _port("smollm-135m")
    program = train_program(model, opts)
    first = program.into_buffers(train_batch(cfg, seed=0))
    ptrs = {k: v.data_ptr() for k, v in first.items()}
    for seed in range(1, 5):            # numpy and tensors in turn
        batch = train_batch(cfg, seed=seed)
        arrive = batch if seed % 2 else {k: torch.from_numpy(v.copy())
                                         for k, v in batch.items()}
        got = program.into_buffers(arrive)
        assert {k: v.data_ptr() for k, v in got.items()} == ptrs
        for k, v in batch.items():
            assert np.array_equal(got[k].numpy(), v)
    other = program.into_buffers({k: v[:1] for k, v in
                                  train_batch(cfg, seed=9).items()})
    assert not set(v.data_ptr() for v in other.values()) & set(ptrs.values())
    back = program.into_buffers(train_batch(cfg, seed=10))
    assert {k: v.data_ptr() for k, v in back.items()} == ptrs


def test_inplace_restart_bitexact(tmp_path):
    """The program over 6 steps straight against 3 steps, a ``save``, a
    ``restore`` into a fresh state and 3 more: every leaf bit for bit
    equal (the restored state is what the program binds next)."""
    d = str(tmp_path / "ckpt")
    cfg, model, opts, state = _port("smollm-135m")
    program = train_program(model, opts)
    sa, sb = _clone(state), _clone(state)
    for i in range(6):
        sa, _ = program(sa, train_batch(cfg, seed=i))
    for i in range(3):
        sb, _ = program(sb, train_batch(cfg, seed=i))
    save(sb, d, step=3)
    del sb
    restored, at = restore(d, _clone(state))
    assert at == 3
    for i in range(at, 6):
        restored, _ = program(restored, train_batch(cfg, seed=i))
    for a, b in zip(flatten(sa)[0], flatten(restored)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The in-place data-parallel step on 2 gloo ranks
# ---------------------------------------------------------------------------

WORLD = 2
DP_STEPS = 4
DEADLINE_S = 240


def dp_rank(rank: int, world: int, init_file: str, out_dir: str):
    """One rank (a spawned process): for compressed and not, the
    functional ``make_dp_train_step`` and ``dp_train_program`` from one
    seeded state over ``DP_STEPS`` global batches; writes what differs to
    ``<out_dir>/rank<r>.npz``."""
    import torch.distributed as dist
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.runtime import dp_train_program, make_dp_train_step
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        data = DataPipeline(DataConfig(vocab_size=256, seq_len=32,
                                       batch_size=4))
        for compress in (False, True):
            cfg = reduced(get_config("smollm-135m")).replace(
                dtype="float32", vocab_size=256)
            model = get_model(cfg, device="cpu")
            opts = TrainOpts(opt=AdamWConfig(**OPT), loss_chunk=16,
                             compress_grads=compress)
            state = init_train_state(model, torch.Generator().manual_seed(0),
                                     opts)
            mine = _clone(state)
            ptrs = [t.data_ptr() for t in flatten(mine)[0]]
            ref, program = make_dp_train_step(model, None, opts), \
                dp_train_program(model, None, opts)
            tag = "compressed" if compress else "uncompressed"
            bad, losses = [], []
            for i in range(DP_STEPS):
                before = _clone(state)
                state_next, want = ref(state, data.batch_at(i))
                bad += [f"input leaf {j} changed at step {i}" for j, (a, b)
                        in enumerate(zip(flatten(before)[0],
                                         flatten(state)[0]))
                        if not torch.equal(a, b)]
                state = state_next
                _, got = program(mine, data.batch_at(i))
                bad += [f"metric {k} at step {i}" for k in want
                        if not torch.equal(got[k], want[k])]
                losses.append(float(got["loss"]))
            bad += [f"leaf {j}" for j, (a, b) in enumerate(
                zip(flatten(state)[0], flatten(mine)[0]))
                if not torch.equal(a, b)]
            if [t.data_ptr() for t in flatten(mine)[0]] != ptrs:
                bad.append("a state leaf moved")
            if compress and "residuals" not in mine:
                bad.append("no residuals")
            out[f"{tag}_bad"] = np.array(bad, dtype=str)
            out[f"{tag}_losses"] = np.array(losses)
            out[f"{tag}_steps"] = np.array(
                [int(mine["step"]), int(mine["opt_state"]["count"])])
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_inplace_dp_step_equals_make_dp_train_step(tmp_path):
    """2 gloo ranks, 4 steps, the fp32 all-reduce and the int8 all-gather
    with error feedback: the in-place program's metrics and every state
    leaf (the residuals too) equal the functional step's bit for bit on
    each rank, the state keeps its addresses, ``step`` and ``count`` read
    4, and the functional step never writes its input state."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(
        r, WORLD, str(tmp_path / "rendezvous"), str(tmp_path)))
        for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
    assert not hung, "a rank hung"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    runs = [np.load(tmp_path / f"rank{r}.npz") for r in range(WORLD)]
    for tag in ("uncompressed", "compressed"):
        for r, run in enumerate(runs):
            assert run[f"{tag}_bad"].size == 0, (tag, r, run[f"{tag}_bad"])
            assert list(run[f"{tag}_steps"]) == [DP_STEPS, DP_STEPS]
        # the ranks agree on the averaged loss, which falls
        np.testing.assert_array_equal(runs[0][f"{tag}_losses"],
                                      runs[1][f"{tag}_losses"])
        assert runs[0][f"{tag}_losses"][-1] < runs[0][f"{tag}_losses"][0]
