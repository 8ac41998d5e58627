"""Port RC2F dataplane against the JAX package: the cases of
tests/test_rc2f.py (FIFO order/count property, config spaces, shell
co-residency and partial reconfiguration, the paper's Table II/III link
model), and the slice end to end at a small size on the CPU: RAaaS sessions
deploy the streaming-matmul core through admission and ``program_slice``
and stream G-blocks through ``StreamFIFO`` into a ``FusedShell`` (and a
``SpatialShell``), every output block held against the reference's
``jnp.einsum`` core on the same numpy blocks.

Tolerance: atol/rtol 1e-4 on float32 products (16-term sums; the
reference's own tolerance for the paper sizes); shell outputs of
elementwise cores are compared exactly.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jcore
import repro.rc2f as jrc2f
import repro_torch.core as tcore
import repro_torch.rc2f as trc2f
from repro_torch.kernels import launches, ops

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# FIFOs
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 1000), min_size=1, max_size=50),
       st.integers(1, 4))
def test_fifo_preserves_order_and_count(items, depth):
    arrays = [np.full((4,), v, np.int32) for v in items]
    outs = []
    for fifo in (jrc2f.StreamFIFO(depth=depth),
                 trc2f.StreamFIFO(depth=depth, device="cpu")):
        fifo.feed(iter(arrays))
        outs.append([int(_np(x)[0]) for x in fifo])
        assert fifo.items_in == len(items)
        assert fifo.bytes_in == 16 * len(items)
    assert outs[0] == outs[1] == items


def test_fifo_hands_over_cpu_tensors_and_raises_producer_errors():
    fifo = trc2f.StreamFIFO(depth=2, device="cpu")
    fifo.feed(iter([(np.ones((2, 2), np.float32), np.zeros(3, np.int32))]))
    a, b = fifo.get()
    assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
    assert b.dtype == torch.int32
    with pytest.raises(StopIteration):
        fifo.get()

    def broken():
        yield np.ones(2)
        raise ValueError("source failed")

    fifo = trc2f.StreamFIFO(depth=2, device="cpu").feed(broken())
    fifo.get()
    with pytest.raises(RuntimeError, match="producer failed"):
        fifo.get(timeout=10)


def test_output_fifo_roundtrip():
    for out in (jrc2f.OutputFIFO(depth=4), trc2f.OutputFIFO(depth=4)):
        out.put({"y": np.arange(6.0)})
        got = out.get()
        np.testing.assert_array_equal(got["y"], np.arange(6.0))
        assert out.bytes_out == 48
    out = trc2f.OutputFIFO(depth=1)
    out.put((torch.arange(3, dtype=torch.float32),))
    got = out.get()
    assert isinstance(got[0], np.ndarray) and out.bytes_out == 12


# ---------------------------------------------------------------------------
# Config spaces
# ---------------------------------------------------------------------------

def test_gcs_defaults_and_rw():
    for rc2f in (jrc2f, trc2f):
        gcs = rc2f.make_gcs()
        assert gcs.read("magic") == 0x5C3E
        assert gcs.read("n_slots") == 4
        gcs.write("step_counter", 7)
        assert gcs.read("step_counter") == 7
        with pytest.raises(KeyError):
            gcs.write("nonexistent", 1)
    regs = trc2f.control.device_registers(gcs, "cpu")
    assert set(regs) == set(gcs.snapshot())
    assert regs["step_counter"].dtype == torch.int32
    assert int(regs["step_counter"]) == 7
    assert int(regs["magic"]) == 0x5C3E


# ---------------------------------------------------------------------------
# Shell
# ---------------------------------------------------------------------------

def _spec(rc2f):
    return rc2f.CoreSpec("t", (rc2f.StreamSpec((8, 8)),
                               rc2f.StreamSpec((8, 8))),
                         (rc2f.StreamSpec((8, 8)),))


def _shell(rc2f, n):
    return rc2f.FusedShell(n) if rc2f is jrc2f \
        else rc2f.FusedShell(n, device="cpu")


def _isolated(rc2f):
    shell = _shell(rc2f, 4)
    shell.load(0, lambda a, b: a @ b, _spec(rc2f), "alice")
    shell.load(3, lambda a, b: a + b, _spec(rc2f), "bob")
    assert shell.active_slots() == [0, 3]
    assert shell.gcs.read("active_mask") == 0b1001
    eye = np.eye(8, dtype=np.float32)
    ones = np.ones((8, 8), np.float32)
    outs = shell.run_cycle({0: (eye, ones), 3: (ones, ones)})
    assert np.allclose(_np(outs[0][0]), ones)
    assert np.allclose(_np(outs[3][0]), 2 * ones)
    return outs, shell.gcs.snapshot()


def test_fused_shell_isolated_cores():
    (jo, jg), (to, tg) = _isolated(jrc2f), _isolated(trc2f)
    assert jg == tg
    for s in (0, 3):
        np.testing.assert_array_equal(_np(to[s][0]), _np(jo[s][0]))


def _pr_keeps_others(rc2f):
    shell = _shell(rc2f, 2)
    shell.load(0, lambda a, b: a @ b, _spec(rc2f))
    shell.load(1, lambda a, b: a - b, _spec(rc2f))
    ones = np.ones((8, 8), np.float32)
    o1 = shell.run_cycle({0: (ones, ones), 1: (ones, ones)})
    shell.load(0, lambda a, b: a * 3 + b * 0, _spec(rc2f))
    o2 = shell.run_cycle({0: (ones, ones), 1: (ones, ones)})
    assert np.allclose(_np(o2[1][0]), _np(o1[1][0]))
    assert np.allclose(_np(o2[0][0]), 3 * ones)
    return [_np(o[s][0]) for o in (o1, o2) for s in (0, 1)], \
        shell.gcs.snapshot()


def test_fused_shell_partial_reconfig_keeps_others():
    """PR of slot 0 must not disturb slot 1 (paper's PR region isolation)."""
    (jo, jg), (to, tg) = _pr_keeps_others(jrc2f), _pr_keeps_others(trc2f)
    assert jg == tg
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b, a)


def test_shell_park_on_empty():
    for rc2f in (jrc2f, trc2f):
        shell = _shell(rc2f, 2)
        shell.load(0, lambda a, b: a, _spec(rc2f))
        assert shell.gcs.read("clock_enable") == 1
        shell.unload(0)
        assert shell.gcs.read("clock_enable") == 0        # energy policy
        assert shell.gcs.read("active_mask") == 0


def test_shell_rejects_wrong_slots():
    for rc2f in (jrc2f, trc2f):
        shell = _shell(rc2f, 2)
        shell.load(0, lambda a, b: a, _spec(rc2f))
        with pytest.raises(ValueError):
            shell.run_cycle({1: (np.ones((8, 8), np.float32),) * 2})


def test_core_api_meta_avals_and_no_donation():
    """StreamSpec.aval is an empty meta tensor; a core that asks for ``ucs``
    sees its registers; donate_inputs (no torch counterpart) raises."""
    spec = trc2f.CoreSpec("x", (trc2f.StreamSpec((4, 16, 16), "bfloat16"),),
                          (trc2f.StreamSpec((4, 16, 16), "bfloat16"),))
    (aval,) = spec.example_inputs()
    assert aval.device.type == "meta" and aval.dtype == torch.bfloat16
    assert tuple(aval.shape) == (4, 16, 16)
    core = trc2f.compile_core(lambda a, ucs: a + ucs["r3"], spec,
                              device="cpu")
    ucs = trc2f.make_ucs()
    ucs.write("r3", 5)
    (out,) = core(trc2f.control.device_registers(ucs, "cpu"),
                  torch.zeros(2))
    assert out.tolist() == [5.0, 5.0]
    with pytest.raises(ValueError, match="donate"):
        trc2f.compile_core(lambda a: a, spec, donate_inputs=True)


# ---------------------------------------------------------------------------
# Link contention model vs paper Table II/III
# ---------------------------------------------------------------------------

def test_link_contention_matches_paper_table2():
    """Table II: FIFO throughput 798 -> 397 -> 196 MB/s for 1/2/4 vFPGAs."""
    for rc2f in (jrc2f, trc2f):
        link = rc2f.SharedLink(bandwidth_bytes_s=798e6)
        assert abs(link.per_stream_throughput(1) / 1e6 - 798) < 1
        assert abs(link.per_stream_throughput(2) / 1e6 - 399) < 3
        assert abs(link.per_stream_throughput(4) / 1e6 - 199.5) < 4
    assert trc2f.PCIE_LINK_BYTES_S == jrc2f.PCIE_LINK_BYTES_S == 800e6


def test_core_throughput_matches_paper_table3():
    """Table III 16x16: one core compute-bound at 509 MB/s; 2 cores
    link-bound at ~398; 4 cores ~198. 32x32: compute-bound at 279 even
    with 2 cores (277 measured)."""
    for rc2f in (jrc2f, trc2f):
        link = rc2f.SharedLink(bandwidth_bytes_s=800e6)
        c16 = 509e6
        assert rc2f.core_throughput(c16, link, 1) == pytest.approx(509e6)
        assert rc2f.core_throughput(c16, link, 2) == \
            pytest.approx(400e6, rel=0.01)
        assert rc2f.core_throughput(c16, link, 4) == \
            pytest.approx(200e6, rel=0.02)
        c32 = 279e6
        assert rc2f.core_throughput(c32, link, 1) == pytest.approx(279e6)
        assert rc2f.core_throughput(c32, link, 2) == pytest.approx(279e6)


@settings(max_examples=40, deadline=None)
@given(st.floats(1e6, 1e10), st.integers(1, 4), st.integers(1, 4))
def test_throughput_monotone_in_contention(rate, n1, n2):
    link = trc2f.SharedLink()
    t1 = trc2f.core_throughput(rate, link, min(n1, n2))
    t2 = trc2f.core_throughput(rate, link, max(n1, n2))
    assert t1 >= t2
    assert t2 <= rate
    jl = jrc2f.SharedLink()
    assert (t1, t2) == (jrc2f.core_throughput(rate, jl, min(n1, n2)),
                        jrc2f.core_throughput(rate, jl, max(n1, n2)))


# ---------------------------------------------------------------------------
# The slice end to end: RAaaS -> admission -> program_slice -> FIFO -> shell
# ---------------------------------------------------------------------------

S, G, CYCLES = 16, 8, 3


def _t_core(a, b):
    return (ops.matmul_batched(a, b),)


def _j_core(a, b):
    return (jnp.einsum("gij,gjk->gik", a, b),)


def _stream(n, seed=0):
    """CYCLES blocks of G (S, S) float32 pairs for each of n cores."""
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal((G, S, S)).astype(np.float32),
              rng.standard_normal((G, S, S)).astype(np.float32))
             for _ in range(CYCLES)] for _ in range(n)]


def _deploy(core, rc2f, mod, n, **kw):
    """n RAaaS tenants deploy ``fn`` (the first configures cold, the rest
    and a second deploy of tenant 0 swap in from the program cache)."""
    hv = mod.Hypervisor(mod.ClusterSpec(n_nodes=2, devices_per_node=2),
                        clock=FakeClock(), **kw)
    spec = rc2f.CoreSpec(f"mm{S}", (rc2f.StreamSpec((G, S, S)),) * 2,
                         (rc2f.StreamSpec((G, S, S)),))
    sessions = [mod.RAaaSSession(hv, f"tenant{i}") for i in range(n)]
    entries = [s.deploy_core(core, spec.example_inputs(), f"mm{S}")
               for s in sessions]
    sessions[0].deploy_core(core, spec.example_inputs(), f"mm{S}")
    return hv, spec, sessions, entries


def _hv_record(hv, n):
    return dict(
        log=[{k: v for k, v in e.items() if k not in ("fingerprint",
                                                      "seconds")}
             for e in hv.log],
        status=hv.status(),
        usage={f"tenant{i}": hv.admission.usage(f"tenant{i}")
               for i in range(n)})


@pytest.mark.parametrize("n", [1, 2, 4])
def test_raas_slice_end_to_end(n):
    blocks = _stream(n, seed=n)
    # reference: the same tenants and core (jnp.einsum) in the JAX shell
    jhv, jspec, jsess, jent = _deploy(_j_core, jrc2f, jcore, n)
    jshell = jrc2f.FusedShell(4)      # a JAX executable cannot be re-jitted
    for i in range(n):
        jshell.load(i, _j_core, jspec, f"tenant{i}")
    ref = [[None] * CYCLES for _ in range(n)]
    for c in range(CYCLES):
        outs = jshell.run_cycle({i: blocks[i][c] for i in range(n)})
        for i in range(n):
            ref[i][c] = np.asarray(outs[i][0])

    hv, spec, sess, ent = _deploy(_t_core, trc2f, tcore, n, device="cpu")
    hits = [e["cache_hit"] for e in hv.log if e["kind"] == "program"]
    assert hits == [False] + [True] * n
    rec = _hv_record(hv, n)
    assert rec == _hv_record(jhv, n)
    shell = trc2f.FusedShell(4, device="cpu")
    for i, e in enumerate(ent):
        shell.load(i, e.compiled, spec, f"tenant{i}")
    fifos = [trc2f.StreamFIFO(depth=2, device="cpu").feed(iter(blocks[i]))
             for i in range(n)]
    sink = [trc2f.OutputFIFO(depth=CYCLES) for _ in range(n)]
    launches.reset()
    for _ in range(CYCLES):
        outs = shell.run_cycle({i: fifos[i].get() for i in range(n)})
        for i in range(n):
            sink[i].put(outs[i])
    assert all(v == 0 for v in launches.values())   # CPU: plain versions
    for i in range(n):
        assert fifos[i].items_in == CYCLES
        for c in range(CYCLES):
            (got,) = sink[i].get()
            np.testing.assert_allclose(got, ref[i][c], **TOL)
    assert shell.gcs.read("step_counter") == CYCLES == \
        jshell.gcs.read("step_counter")
    assert shell.gcs.snapshot() == jshell.gcs.snapshot()
    for s in sess:
        s.close()
    for s in jsess:
        s.close()
    assert json.loads(hv.db.to_json())["devices"].keys() == \
        json.loads(jhv.db.to_json())["devices"].keys()
    assert hv.status() == jhv.status()


def test_raas_slice_spatial_shell():
    """The same deployed cores, one per slot of a SpatialShell."""
    n = 4
    blocks = _stream(n, seed=7)
    hv, spec, sess, ent = _deploy(_t_core, trc2f, tcore, n, device="cpu")
    shell = trc2f.SpatialShell(n_slots=4, device="cpu")
    for i, e in enumerate(ent):
        shell.load(i, e.compiled, spec, f"tenant{i}")
    assert shell.gcs.read("active_mask") == 0b1111
    for c in range(CYCLES):
        outs = [shell.run(i, *blocks[i][c]) for i in range(n)]
        shell.join()
        for i in range(n):
            ref = _j_core(*blocks[i][c])[0]
            np.testing.assert_allclose(outs[i][0].numpy(), np.asarray(ref),
                                       **TOL)
