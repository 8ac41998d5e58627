"""The RC2F shells' programs on the CPU against the JAX package's shells.

On the card a ``FusedShell`` cycle is one CUDA graph of every resident core
and a ``SpatialShell`` slot one graph of its core, bound to fixed block and
register buffers; the CPU runs the same binding eagerly. The same seeded
numpy blocks go through the JAX shells (the batched matmul through its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
through the port's with ``device="cpu"``, over cycles that write the
registers, feed a tail block of 32 after full blocks of 64, hot-swap slot
2 and unload every slot to park the shell. Checked besides the outputs:
every block and register buffer keeps its ``data_ptr()`` across cycles,
one set a block shape; the cycle binds one graph key a (slot set, block
shape); registers upload only after a write; the outputs a cycle returned
stay as they were after the next.

Tolerances: the batched matmul at ``tests/test_kernels.py``'s fp32
tolerances (atol 2e-5, rtol 2e-4); the axpy and register cores exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.rc2f as jrc2f
import repro_torch.rc2f as trc2f
from repro.kernels import ops as jops
from repro_torch.core import graphs
from repro_torch.kernels import launches
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-4)
G, TAIL, S = 64, 32, 16
CPU = torch.device("cpu")


def t_mm(a, b):
    return (tops.matmul_batched(a, b),)


def j_mm(a, b):
    return (jops.matmul_batched(a, b, force="interpret"),)


def axpy(a, b):
    return a * 2.0 + b


def regs_core(a, b, ucs):
    """Reads two registers of its slot's ucs (no product feeds a sum: XLA
    would fuse the two into one rounding)."""
    return (a + b + ucs["r2"]) * ucs["r1"]


def regs_core_v2(a, b, ucs):
    return (b - a) * ucs["r3"]


def _spec(rc2f, g):
    st = rc2f.StreamSpec((g, S, S))
    return rc2f.CoreSpec(f"b{g}", (st, st), (st,))


# the cycles: (block rows, {slot: {register: value}} written before the
# cycle, slot 2's core swapped in before it or None)
CYCLES = [(G, {2: {"r1": 3, "r2": -1}}, None),
          (G, {2: {"r1": -2}}, None),
          (TAIL, {2: {"r2": 7}}, None),
          (G, {}, None),
          (TAIL, {2: {"r1": 5}}, None),
          (G, {2: {"r3": 4}}, "v2"),
          (TAIL, {2: {"r3": -3}}, None),
          (G, {}, None)]


def _blocks(seed):
    rng = np.random.default_rng(seed)
    return [{slot: tuple(rng.standard_normal((g, S, S)).astype(np.float32)
                         for _ in range(2)) for slot in range(4)}
            for g, _, _ in CYCLES]


def _cores(mod):
    mm = j_mm if mod is jrc2f else t_mm
    return {0: mm, 1: axpy, 2: regs_core, 3: mm}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fused_run(mod, blocks, watch=None):
    """The cycles through ``mod``'s FusedShell; per cycle the outputs by
    slot as numpy, then the unload to empty; returns (outputs, gcs)."""
    shell = mod.FusedShell(4) if mod is jrc2f \
        else mod.FusedShell(4, device="cpu")
    for slot, core in _cores(mod).items():
        shell.load(slot, core, _spec(mod, G), f"tenant{slot}")
    outs = []
    for c, (g, writes, swap) in enumerate(CYCLES):
        if swap:
            shell.load(2, regs_core_v2, _spec(mod, G), "tenant2-v2")
        for slot, regs in writes.items():
            for r, v in regs.items():
                shell.slots[slot].ucs.write(r, v)
        got = shell.run_cycle(blocks[c])
        outs.append({s: [_np(x) for x in o] for s, o in got.items()})
        if watch is not None:
            watch(shell, c, got)
    for slot in range(4):
        shell.unload(slot)
    assert shell.active_slots() == [] and shell.run_cycle({}) == {}
    return outs, shell.gcs.snapshot()


def _assert_outputs(got, ref):
    for c, (o, r) in enumerate(zip(got, ref)):
        assert sorted(o) == sorted(r) == [0, 1, 2, 3]
        for slot in o:
            for x, y in zip(o[slot], r[slot]):
                assert x.shape == y.shape and x.dtype == y.dtype
                if slot in (0, 3):                  # the batched matmul
                    np.testing.assert_allclose(x, y, **TOL)
                else:                               # axpy, register cores
                    np.testing.assert_array_equal(x, y)


def _addresses(shell):
    """Every slot's buffers: {slot: (register buffer, {block shape: its
    buffers' data_ptr()})}."""
    return {i: (s.regs.buf.data_ptr(),
                {sig[1]: [b.data_ptr() for b in bs.bufs]
                 for sig, bs in s.blocks.sets.items()})
            for i, s in enumerate(shell.slots) if s.core_fn is not None}


def test_fused_shell_program_against_the_reference():
    blocks = _blocks(30)
    ref, jgcs = _fused_run(jrc2f, blocks)
    seen, shapes, keys, programs, kept, uploads = {}, {}, {}, [], [], []

    def watch(shell, c, got):
        g, _, swap = CYCLES[c]
        addr = _addresses(shell)
        for slot, (reg, sets) in addr.items():
            fresh = swap is not None and slot == 2
            if fresh:
                shapes[slot] = set()
            shapes.setdefault(slot, set()).add(g)
            assert len(sets) == len(shapes[slot])   # one set a block shape
            if slot in seen and not fresh:          # the same buffers
                assert reg == seen[slot][0]
                assert all(sets[k] == v for k, v in seen[slot][1].items())
            seen[slot] = (reg, sets)
        # the program's arguments are the buffers themselves
        regs, bound = shell.bound
        for k, slot in enumerate(shell.active_slots()):
            assert regs[k] is shell.slots[slot].regs.views
            sig = tuple((tuple(x.shape), x.dtype) for x in bound[k])
            assert [x.data_ptr() for x in bound[k]] == addr[slot][1][sig]
        # one binding key a (loaded slot set, block shape)
        assert shell.program.__name__ == "rc2f_cycle_" + "_".join(
            f"{i}b{G}" for i in range(4))
        if shell.program not in programs:
            programs.append(shell.program)
        _, key = graphs.binding(shell.bound, CPU)
        keys.setdefault((programs.index(shell.program), g), set()).add(key)
        # a returned output is a copy: no buffer's address
        ptrs = {p for _, sets in addr.values() for v in sets.values()
                for p in v}
        assert all(x.data_ptr() not in ptrs for o in got.values() for x in o)
        kept.append((got, {s: [x.clone() for x in o]
                           for s, o in got.items()}))
        uploads.append(shell.slots[2].regs.uploads)

    launches.reset()
    got, gcs = _fused_run(trc2f, blocks, watch)
    assert all(v == 0 for v in launches.values())     # CPU: plain versions
    _assert_outputs(got, ref)
    assert gcs == jgcs and gcs["clock_enable"] == 0 \
        and gcs["active_mask"] == 0 and gcs["step_counter"] == len(CYCLES) + 1
    # the outputs of every cycle are as they were returned
    for out, copy in kept:
        for s in out:
            for x, y in zip(out[s], copy[s]):
                assert torch.equal(x, y)
    # two programs (before and after the swap), each one key a shape
    assert sorted(keys) == [(0, TAIL), (0, G), (1, TAIL), (1, G)]
    assert all(len(k) == 1 for k in keys.values())
    # registers upload after a write only (a swap brings a fresh ucs)
    assert uploads == [1, 2, 3, 3, 4, 1, 2, 2]


def test_fused_shell_swap_keeps_the_other_slots_buffers():
    """A hot swap of slot 2 rebuilds the program; slots 0, 1 and 3 keep
    their buffers and their outputs, slot 2 computes the new core."""
    rng = np.random.default_rng(31)
    a, b = (rng.standard_normal((G, S, S)).astype(np.float32)
            for _ in range(2))
    shell = trc2f.FusedShell(4, device="cpu")
    for slot, core in _cores(trc2f).items():
        shell.load(slot, core, _spec(trc2f, G))
    inputs = {s: (a, b) for s in range(4)}
    before = shell.run_cycle(inputs)
    addr = _addresses(shell)
    program = shell.program
    shell.load(2, axpy, _spec(trc2f, G))
    after = shell.run_cycle(inputs)
    assert shell.program is not program
    new = _addresses(shell)
    for s in (0, 1, 3):
        assert new[s] == addr[s]
        assert torch.equal(after[s][0], before[s][0])
    np.testing.assert_array_equal(after[2][0].numpy(), a * 2.0 + b)
    assert shell.counts() == dict(captures=0, replays=0, capture_ms=[],
                                  graph_bytes=[])


def test_spatial_shell_slots_against_the_reference_and_the_fused_cycle():
    blocks = _blocks(32)
    ref, _ = _fused_run(jrc2f, blocks)
    jshell = jrc2f.SpatialShell(n_slots=4)
    shell = trc2f.SpatialShell(n_slots=4, device="cpu")
    for mod, sh in ((jrc2f, jshell), (trc2f, shell)):
        for slot, core in _cores(mod).items():
            sh.load(slot, core, _spec(mod, G), f"tenant{slot}")
    first = {}
    for c, (g, writes, swap) in enumerate(CYCLES):
        for mod, sh in ((jrc2f, jshell), (trc2f, shell)):
            if swap:
                sh.load(2, regs_core_v2, _spec(mod, G), "tenant2-v2")
            for slot, regs in writes.items():
                for r, v in regs.items():
                    sh.slots[slot].ucs.write(r, v)
        jgot = {s: jshell.run(s, *blocks[c][s]) for s in range(4)}
        got = {s: shell.run(s, *blocks[c][s]) for s in range(4)}
        shell.join()
        for s in range(4):
            x, y = got[s][0].numpy(), np.asarray(jgot[s][0])
            if s in (0, 3):
                np.testing.assert_allclose(x, y, **TOL)
            else:
                np.testing.assert_array_equal(x, y)
            # a slot's cycle equals the fused shell's on the same blocks
            np.testing.assert_array_equal(x, ref[c][s][0])
            slot = shell.slots[s]
            ptrs = (slot.regs.buf.data_ptr(),
                    {k[1]: [b.data_ptr() for b in v.bufs]
                     for k, v in slot.blocks.sets.items()})
            if s in first and not (swap and s == 2):
                assert ptrs[0] == first[s][0]
                assert all(ptrs[1][k] == v for k, v in first[s][1].items())
            first[s] = ptrs
    assert all(len(first[s][1]) == 2 for s in (0, 1, 3))
    assert shell.gcs.snapshot() == jshell.gcs.snapshot()


def test_compile_core_on_the_cpu_is_the_eager_core():
    """``device="cpu"``: the eager shell-convention core, equal to the
    reference's jitted core on the same registers and blocks; on the card
    (the default) a graph program, and without CUDA the default raises;
    ``donate_inputs`` raises."""
    rng = np.random.default_rng(33)
    a, b = (rng.standard_normal((TAIL, S, S)).astype(np.float32)
            for _ in range(2))
    ucs = trc2f.make_ucs()
    ucs.write("r1", 4)
    ucs.write("r2", -9)
    core = trc2f.compile_core(regs_core, _spec(trc2f, TAIL), device="cpu")
    assert not isinstance(core, graphs.GraphProgram)
    assert core.__name__ == f"rc2f_core_b{TAIL}"
    regs = trc2f.control.RegisterFile(ucs, "cpu")
    assert regs.refresh() and not regs.refresh()
    (out,) = core(regs.views, torch.from_numpy(a), torch.from_numpy(b))
    jcore = jrc2f.compile_core(regs_core, _spec(jrc2f, TAIL))
    (jout,) = jcore({k: jnp.asarray(v, jnp.int32)
                     for k, v in ucs.snapshot().items()}, a, b)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    if torch.cuda.is_available():
        assert isinstance(trc2f.compile_core(regs_core, _spec(trc2f, TAIL)),
                          graphs.GraphProgram)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trc2f.compile_core(regs_core, _spec(trc2f, TAIL))
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="donate"):
            trc2f.compile_core(axpy, _spec(trc2f, G), donate_inputs=True,
                               device=device)


def test_register_file_views_and_device_registers():
    """A register file's views are the dict a core sees, at fixed
    addresses; ``device_registers`` keeps the reference's semantics."""
    ucs = trc2f.make_ucs()
    regs = trc2f.control.RegisterFile(ucs, "cpu")
    views = dict(regs.views)
    ptrs = {k: v.data_ptr() for k, v in views.items()}
    assert list(views) == [f"r{i}" for i in range(trc2f.control.UCS_SIZE)]
    assert regs.refresh() and regs.uploads == 1
    ucs.write("r5", 11)
    ucs.write("r0", -1)
    assert regs.refresh() and not regs.refresh() and regs.uploads == 2
    assert {k: int(v) for k, v in regs.views.items()} == ucs.snapshot()
    assert all(regs.views[k] is views[k] and views[k].data_ptr() == p
               for k, p in ptrs.items())
    assert ucs.versioned() == (ucs.writes, ucs.snapshot())
    fresh = trc2f.control.device_registers(ucs, "cpu")
    assert {k: int(v) for k, v in fresh.items()} == ucs.snapshot()
    assert all(v.dtype == torch.int32 for v in fresh.values())
