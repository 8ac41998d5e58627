"""The port's auto-tuner (``repro_torch.tuning``) on the Hopper design
space, mirroring tests/test_tuning.py: the registry pinned to the kernel
wrappers and CUDA sources, design-space legality, the cost model's prunes
and per-class divergence, tuned-config persistence in the ProgramCache,
the parts held against the reference (fingerprints, device classes, byte
accounting), and the bit-exactness matrix: every geometry the tuner emits
(and an autotuned fleet) serves token logs equal to the JAX package's
default-geometry fleet, dense and paged, lockstep and event-driven.

Weights: reduced smollm-135m in fp32, the JAX init carried across
(``params_from_numpy``); logs compared exactly.
"""
import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.base import GeometryConfig as JGeometryConfig
from repro.core import ClusterSpec as JClusterSpec
from repro.core import Hypervisor as JHypervisor
from repro.models import get_model as j_get_model
from repro.runtime import EventLoop as JEventLoop
from repro.runtime import GatewayFleet as JGatewayFleet
from repro.tuning import cost_model as jcost
from repro.tuning import device_class as j_device_class
from repro.tuning import model_fingerprint as j_model_fingerprint
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.configs.base import GeometryConfig
from repro_torch.core import ClusterSpec, Hypervisor, ProgramCache
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import mamba2_chunk as ssd
from repro_torch.kernels import registry as kreg
from repro_torch.kernels import stream_matmul as mm
from repro_torch.models import Model
from repro_torch.runtime import EventLoop, GatewayFleet
from repro_torch.tuning import (TunedConfig, candidate_cost, device_class,
                                enumerate_candidates, legal_reason,
                                model_fingerprint, profile_for_speed,
                                prune_reason, resolve_tuned, tune)
from repro_torch.tuning import cost_model
from repro_torch.tuning.cost_model import DeviceProfile

torch.set_num_threads(1)

CSRC = Path(da.__file__).resolve().parent / "csrc"


@pytest.fixture(scope="module")
def jax_model():
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jmodel = j_get_model(jcfg)
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def served_model(jax_model):
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jax_model[1]), cfg)
    return cfg, Model(cfg, device="cpu"), params


# ---------------------------------------------------------------------------
# The registry pinned to the wrappers, the CUDA sources and the defaults
# ---------------------------------------------------------------------------

def _constexprs(name):
    """A source's namespace-level ``constexpr int kX = n[, kY = m];``."""
    src = (CSRC / f"{name}.cu").read_text()
    return {k: int(v) for line in re.findall(r"^constexpr int ([^;]+);", src,
                                             flags=re.M)
            for k, v in re.findall(r"(k\w+) = (\d+)", line)}


def test_registry_pinned_to_wrappers_and_sources():
    assert kreg.HEAD_DIMS == da.HEAD_DIMS
    assert (kreg.CHUNK_HEADS, kreg.WIDE_CHUNK_HEADS,
            kreg.MAX_PADDED_HEAD_DIM) == \
        (da.CHUNK_HEADS, da.WIDE_CHUNK_HEADS, da.MAX_PADDED_HEAD_DIM)
    assert (kreg.MIN_SPLIT_ROWS, kreg.SPLIT_WAVES, kreg.MAX_SPLITS) == \
        (da.MIN_SPLIT_ROWS, da.SPLIT_WAVES, da.MAX_SPLITS)
    assert kreg.STATE_DIMS == ssd.STATE_DIMS
    assert kreg.SSD_CHUNK == ssd.SSD_CHUNK
    assert kreg.MM_TILE == mm.MM_TILE
    assert kreg.MM_BK == {str(k).replace("torch.", ""): v
                          for k, v in mm.MM_BK.items()}
    dec = _constexprs("decode_attention")
    assert (dec["kWarps"], dec["kLoads"], dec["kMergeThreads"],
            dec["kChunkHeads"], dec["kWideHeads"], dec["kExactMaxD"],
            dec["kMaxSplits"]) == \
        (kreg.DECODE_WARPS, kreg.DECODE_LOADS, kreg.DECODE_MERGE_THREADS,
         kreg.CHUNK_HEADS, kreg.WIDE_CHUNK_HEADS, kreg.MAX_PADDED_HEAD_DIM,
         kreg.MAX_SPLITS)
    fl = _constexprs("flash_attention")
    assert (fl["kBQ"], fl["kStages"], fl["kExactMaxD"]) == \
        (kreg.FLASH_BQ, kreg.FLASH_STAGES, kreg.MAX_PADDED_HEAD_DIM)
    mmc = _constexprs("stream_matmul")
    assert mmc["kMmBM"] == mmc["kMmBN"] == kreg.MM_TILE
    assert _constexprs("ssd_chunk_scan")["kChunk"] == kreg.SSD_CHUNK
    # the head-dim rule is the wrappers' own, up to the largest width
    for d in range(8, kreg.HEAD_DIMS[-1] + 16, 8):
        try:
            want = da.padded_head_dim("x", d)
        except ValueError:
            want = None
        assert kreg.padded_head_dim(d) == want, d
        assert (kreg.check_head_dim(d) is None) == (want is not None), d
    assert kreg.padded_head_dim(60) is None
    assert kreg.padded_head_dim(264) == 384
    assert kreg.padded_head_dim(520) is None


def test_geometry_defaults_pinned_to_registry():
    """``TunedConfig`` defaults are the registry's; the copied
    ``GeometryConfig`` stays the reference's, field for field (its TPU
    block fields are copied and unread by the port)."""
    t = TunedConfig()
    assert t.page_size == kreg.PAGE_SIZE_DEFAULT
    assert t.n_slots == kreg.SLOTS_DEFAULT
    assert t.prefill_chunk == kreg.PREFILL_CHUNK_DEFAULT
    assert dataclasses.asdict(GeometryConfig()) == \
        dataclasses.asdict(JGeometryConfig())
    assert [f.name for f in dataclasses.fields(TunedConfig)] == \
        ["page_size", "n_slots", "prefill_chunk"]


def test_kernel_footprints_fit_the_card():
    """Shared memory a block of every kernel instantiation (every head dim,
    state dim, dtype and block shape the sources build) within the H100's
    limits; the largest (fp32 flash at D 256, 195 KB) close to them."""
    fp = kreg.kernel_footprints()
    assert len(fp) >= 60
    for name, nbytes in fp.items():
        assert kreg.check_smem(name, nbytes) is None, name
    assert fp["flash/D256/float32"] == (64 + 2 * 2 * 1 * 32) * 260 * 4
    assert fp["flash/D64/bfloat16"] == 72 * 1024
    assert fp["mm/bfloat16"] == 96 * 1024
    assert max(fp.values()) == fp["flash/D256/float32"] \
        <= kreg.SMEM_PER_BLOCK
    assert kreg.check_smem("flash/x", kreg.SMEM_PER_BLOCK + 1) is not None
    assert kreg.check_smem("decode_split/x", 48 * 1024 + 4) is not None


# ---------------------------------------------------------------------------
# Design space
# ---------------------------------------------------------------------------

def test_enumerated_candidates_are_legal():
    """Every candidate the sweep yields satisfies the registry's rules; the
    shipped default is in the space; dense sweeps slots x chunks, paged
    adds page sizes."""
    for paged in (False, True):
        cands = list(enumerate_candidates(max_len=2048, head_dim=64,
                                          paged=paged))
        assert len(cands) == 12 * (4 if paged else 1)
        for c in cands:
            assert legal_reason(c, max_len=2048, head_dim=64,
                                paged=paged) is None
        assert TunedConfig() in cands
        assert len(set(cands)) == len(cands)


def test_illegal_geometry_is_rejected():
    assert legal_reason(TunedConfig(page_size=48), max_len=2048,
                        head_dim=64, paged=True) is not None
    assert legal_reason(TunedConfig(), max_len=2048, head_dim=60,
                        paged=False) is not None   # no kernel takes D 60
    assert legal_reason(TunedConfig(), max_len=2048, head_dim=520,
                        paged=False) is not None   # past the largest
    assert "up to 512" in legal_reason(TunedConfig(), max_len=2048,
                                       head_dim=520, paged=False)
    assert legal_reason(TunedConfig(n_slots=4096), max_len=2048,
                        head_dim=64, paged=False) is not None
    assert legal_reason(TunedConfig(prefill_chunk=0), max_len=2048,
                        head_dim=64, paged=False) is not None
    # dense engines ignore the page size; D 80 runs padded to 96, D 264
    # in place on the 384 build
    assert legal_reason(TunedConfig(page_size=48), max_len=2048,
                        head_dim=80, paged=False) is None
    assert legal_reason(TunedConfig(), max_len=2048, head_dim=264,
                        paged=False) is None


# Qwen3-235B-A22B's heads (64 over 4: g 16), MQA (Falcon-7B: 71 over 1 at D
# 64), and D 264 past the old 256 limit (g 4)
WIDE_SHAPES = [(64, 4, 128), (71, 1, 64), (16, 4, 264)]


@pytest.mark.parametrize("heads", WIDE_SHAPES)
@pytest.mark.parametrize("paged", [False, True])
def test_wide_groups_and_head_dims_get_the_reference_candidates(heads,
                                                                paged):
    """Every candidate the reference's sweep finds legal at this head dim,
    projected on the port's axes (page size, slots, prefill chunk), is a
    candidate of the port's sweep, and nothing else; the port's tuner then
    picks an unpruned winner for qwen3-moe at these heads."""
    from repro.tuning.space import enumerate_candidates as j_enumerate
    hq, hkv, d = heads
    ref = {(c.page_size, c.n_slots, c.prefill_chunk)
           for c in j_enumerate(max_len=2048, head_dim=d, paged=paged)}
    port = {(c.page_size, c.n_slots, c.prefill_chunk)
            for c in enumerate_candidates(max_len=2048, head_dim=d,
                                          paged=paged)}
    assert port and port == ref
    cfg = get_config("qwen3-moe-30b-a3b").replace(
        n_heads=hq, n_kv_heads=hkv, head_dim=d, max_seq_len=2048)
    assert kreg.check_group(hq, hkv) is None
    assert kreg.check_head_dim(d) is None
    res = tune(cfg, profile_for_speed(1.0), max_len=2048, paged=paged)
    assert legal_reason(res.best, max_len=2048, head_dim=d,
                        paged=paged) is None
    assert res.table[0][1].pruned is None


# ---------------------------------------------------------------------------
# Cost model: hard pruning, the port's regime, per-class divergence
# ---------------------------------------------------------------------------

def test_prune_on_smem_and_hbm():
    cfg = get_config("smollm-135m")
    tiny_smem = DeviceProfile("tiny-smem", 1.0, 1e12, 1e11,
                              smem_bytes=1024, hbm_bytes=80 * 2 ** 30)
    r = prune_reason(TunedConfig(), cfg, tiny_smem, max_len=2048,
                     paged=False)
    assert r is not None and r.startswith("SMEM")
    tiny_hbm = DeviceProfile("tiny-hbm", 1.0, 1e12, 1e11,
                             smem_bytes=kreg.SMEM_PER_BLOCK, hbm_bytes=1024)
    r = prune_reason(TunedConfig(), cfg, tiny_hbm, max_len=2048,
                     paged=False)
    assert r is not None and r.startswith("HBM")
    ok = profile_for_speed(1.0)
    assert prune_reason(TunedConfig(), cfg, ok, max_len=2048,
                        paged=False) is None
    pruned = candidate_cost(TunedConfig(), cfg, tiny_smem, max_len=2048,
                            paged=False)
    assert pruned.pruned is not None \
        and pruned.us_per_token == float("inf")
    # 500 MB: the weights (269 MB) and a pool of 4 slots x 2048 (189 MB)
    # fit, a pool of 8 does not
    mid = DeviceProfile("mid", 1.0, 1e12, 1e11,
                        smem_bytes=kreg.SMEM_PER_BLOCK, hbm_bytes=500_000_000)
    rep = tune(cfg, mid, max_len=2048, paged=False)
    assert rep.prune_census == {"HBM": 4} == {"HBM": rep.n_pruned}
    assert rep.best.n_slots == 4


def test_small_class_gets_half_memory():
    fast, slow = profile_for_speed(1.0), profile_for_speed(0.25)
    assert slow.hbm_bytes == fast.hbm_bytes // 2 == 40 * 2 ** 30
    assert slow.smem_bytes == fast.smem_bytes == kreg.SMEM_PER_BLOCK
    assert (fast.sm_count, slow.sm_count) == (132, 33)
    assert slow.hbm_bw == fast.hbm_bw / 4 and slow.flops == fast.flops / 4
    assert slow.launch_host_s == fast.launch_host_s    # the host's, fixed


def test_launch_count_and_sweep_grid():
    """The host term counts the eager step's device ops from the config
    (2569 for smollm-135m, the chip profile's count); the decode grid is
    ``split_plan``'s on the class's SMs."""
    cfg = get_config("smollm-135m")
    assert cost_model.step_launches(cfg) == 2569
    c = candidate_cost(TunedConfig(n_slots=8), cfg, profile_for_speed(1.0),
                       max_len=2048, paged=False)
    assert c.terms["launches"] == 2569
    assert c.terms["decode_host_us"] == pytest.approx(
        2569 * cost_model.LAUNCH_HOST_S * 1e6)
    for speed, ps in ((1.0, 16), (0.25, 64)):
        prof = profile_for_speed(speed)
        cand = TunedConfig(n_slots=8, page_size=ps)
        g = cost_model.sweep_plan(cfg, cand, prof, max_len=2048, paged=True)
        assert (g["n_split"], g["split_rows"]) == \
            da.split_plan(8 * cfg.n_kv_heads, 2048, prof.sm_count, unit=ps)
        assert g["split_rows"] % ps == 0 and 0 < g["wave_eff"] <= 1


def test_tuner_beats_default_and_classes_diverge():
    """The sweep finds geometry better than the shipped default on both
    classes; on a paged pool the two classes get different page sizes (the
    fragmentation a big page wastes costs a slow part more than the block-
    table uploads a small page adds)."""
    for arch in ("smollm-135m", "gemma3-1b"):
        cfg = get_config(arch)
        fast = tune(cfg, profile_for_speed(1.0), max_len=2048, paged=True)
        slow = tune(cfg, profile_for_speed(0.25), max_len=2048, paged=True)
        assert fast.win > 1.0 and slow.win > 1.0
        assert fast.best != slow.best
        assert fast.best.page_size > slow.best.page_size


def test_tune_is_deterministic():
    cfg = get_config("smollm-135m")
    a = tune(cfg, profile_for_speed(0.25), max_len=2048, paged=True)
    b = tune(cfg, profile_for_speed(0.25), max_len=2048, paged=True)
    assert a.best == b.best
    assert [c.geometry_key() for c, _ in a.table] \
        == [c.geometry_key() for c, _ in b.table]


def test_measure_hook_reranks_the_modeled_top_k():
    cfg = get_config("smollm-135m")
    prof = profile_for_speed(1.0)
    modeled = tune(cfg, prof, max_len=2048, paged=True, top_k=4)
    last = modeled.table[-1][0]
    seen = []

    def measure(cand):
        seen.append(cand)
        return 0.0 if cand == last else 1.0

    got = tune(cfg, prof, max_len=2048, paged=True, top_k=4,
               measure=measure)
    assert got.best == last and set(seen) == {c for c, _ in modeled.table}
    assert [c for c, _ in got.table] == [c for c, _ in modeled.table]


# ---------------------------------------------------------------------------
# Held against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_fingerprint_class_and_bytes_equal_reference(arch):
    assert ARCH_IDS == J_ARCH_IDS
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                      (reduced(get_config(arch)),
                       j_reduced(j_get_config(arch)))):
        for max_len, paged in ((2048, False), (2048, True), (64, True)):
            assert model_fingerprint(cfg, max_len, paged) == \
                j_model_fingerprint(jcfg, max_len, paged)
        assert cost_model.kv_bytes_per_pos(cfg) == \
            jcost.kv_bytes_per_pos(jcfg)
        assert cost_model._param_bytes(cfg) == jcost._param_bytes(jcfg)
    for speed in (1.0, 0.25, 0.5, 2.0):
        assert device_class(speed) == j_device_class(speed)


# ---------------------------------------------------------------------------
# Persistence: ProgramCache tuned-config store
# ---------------------------------------------------------------------------

def test_tuned_store_roundtrip(tmp_path):
    pc = ProgramCache()
    cfg = TunedConfig(page_size=64, n_slots=8)
    pc.put_tuned("fp0", "c1.00x", cfg.to_dict())
    pc.put_tuned("fp0", "c0.25x", TunedConfig(page_size=8).to_dict())
    assert TunedConfig.from_dict(pc.get_tuned("fp0", "c1.00x")) == cfg
    path = str(tmp_path / "tuned.json")
    pc.save_tuned(path)
    pc2 = ProgramCache()
    assert pc2.load_tuned(path) == 2
    assert pc2.tuned_configs() == pc.tuned_configs()
    assert pc2.get_tuned("fp0", "c9.99x") is None
    # a record with extra (e.g. the reference's block) fields loads
    rec = dict(cfg.to_dict(), decode_block_k=512)
    assert TunedConfig.from_dict(rec) == cfg


def test_resolve_tuned_prefers_persisted_winner():
    """resolve_tuned is a store lookup first — a pre-seeded (restored)
    winner is honored verbatim, no re-sweep."""
    cfg = get_config("smollm-135m")
    pc = ProgramCache()
    fp = model_fingerprint(cfg, 2048, False)
    seeded = TunedConfig(page_size=8, n_slots=2)
    pc.put_tuned(fp, device_class(1.0), seeded.to_dict())
    assert resolve_tuned(pc, cfg, 1.0, max_len=2048, paged=False) == seeded
    # an unseen class tunes once, then hits the store
    first = resolve_tuned(pc, cfg, 0.25, max_len=2048, paged=False)
    assert pc.get_tuned(fp, device_class(0.25)) == first.to_dict()
    assert first == tune(cfg, profile_for_speed(0.25), max_len=2048,
                         paged=False).best
    assert resolve_tuned(pc, cfg, 0.25, max_len=2048, paged=False) == first


# ---------------------------------------------------------------------------
# Bit-exactness matrix: every geometry the tuner emits (and an autotuned
# fleet) serves the JAX package's default-geometry token logs
# ---------------------------------------------------------------------------

def _tuner_winner_geometries():
    """Distinct winners across (class, mode) for the served arch."""
    cfg = get_config("smollm-135m")
    geoms = {}
    for paged in (False, True):
        for speed in (1.0, 0.25):
            best = tune(cfg, profile_for_speed(speed), max_len=2048,
                        paged=paged).best
            geoms[best.geometry_key()] = best
    return sorted(geoms.items()) + [("autotune", None)]


def _drive(fleet, ev, cfg, spread=False):
    """Three tenants, a 6-token prompt and 8 new tokens each; ``spread``
    moves tenant c (queued, nothing in flight) to the other device, so
    that both device classes serve."""
    rng = np.random.default_rng(0)
    reqs = {}
    for t in ("a", "b", "c"):
        fleet.open_session(t, slots=1)
        prompt = rng.integers(0, cfg.vocab_size, size=6).tolist()
        reqs[t] = fleet.submit(t, prompt, max_new_tokens=8)
    if spread:
        hv = fleet.hv
        dst = next(d for d in sorted(hv.db.devices)
                   if d != fleet.device_of("c"))
        hv.migrate_slice(fleet.session("c").slice_id, target_device=dst,
                         reason="ops")
        assert fleet.device_of("c") == dst
    for _ in range(400):
        fleet.step() if ev is None else ev.run_ticks(1)
        if all(r.done.is_set() for r in reqs.values()):
            break
    assert all(r.done.is_set() for r in reqs.values())
    fleet.verify_invariants()
    return {t: list(r.out_tokens) for t, r in reqs.items()}


_JAX_LOGS = {}


def _jax_default_logs(jax_model, cfg, paged, loop):
    """The reference's fleet at its default geometry (4 slots, page 8) on
    two device classes: three tenants' token logs."""
    key = (paged, loop)
    if key not in _JAX_LOGS:
        jmodel, jparams = jax_model
        hv = JHypervisor(JClusterSpec(n_nodes=1, devices_per_node=2,
                                      device_speeds=(1.0, 0.25)))
        fleet = JGatewayFleet(hv, jmodel, jparams, n_slots=4, max_len=64,
                              paged=paged, page_size=8)
        try:
            _JAX_LOGS[key] = _drive(
                fleet, JEventLoop(fleet) if loop == "event" else None, cfg)
        finally:
            fleet.close()
    return _JAX_LOGS[key]


@pytest.mark.parametrize("loop", ["lockstep", "event"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize(("gkey", "tuned"), _tuner_winner_geometries(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_tuned_geometry_is_bit_exact(jax_model, served_model, gkey, tuned,
                                     paged, loop):
    cfg, model, params = served_model
    want = _jax_default_logs(jax_model, cfg, paged, loop)
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=2,
                                device_speeds=(1.0, 0.25)), device="cpu")
    if tuned is None:
        fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64,
                             paged=paged, page_size=8, autotune=True)
        ev = EventLoop(fleet) if loop == "event" else None
    else:
        fleet = GatewayFleet(hv, model, params, n_slots=tuned.n_slots,
                             max_len=64, paged=paged,
                             page_size=min(tuned.page_size, 64))
        ev = EventLoop(fleet, prefill_chunk=tuned.prefill_chunk) \
            if loop == "event" else None
    chunks = []
    if ev is not None:
        step_engine = fleet.step_engine
        fleet.step_engine = lambda dev, prefill_chunk=None: (
            chunks.append((dev, prefill_chunk)),
            step_engine(dev, prefill_chunk))[1]
    try:
        got = _drive(fleet, ev, cfg, spread=tuned is None)
        if tuned is None:
            # each class bound its resolve_tuned winner through the store
            fp = model_fingerprint(cfg, 64, paged)
            for dev, eng in fleet._engines.items():
                speed = hv.db.devices[dev].speed
                win = tune(cfg, profile_for_speed(speed), max_len=64,
                           paged=paged).best
                assert hv.reconfig.cache.get_tuned(
                    fp, device_class(speed)) == win.to_dict()
                assert eng.n_slots == win.n_slots
                if paged:
                    assert eng.page_size == win.page_size
                assert fleet.prefill_chunk_for(dev, 4) == win.prefill_chunk
                assert all(c == win.prefill_chunk for d, c in chunks
                           if d == dev)
            assert len(fleet._engines) == 2
        else:
            assert all(c == tuned.prefill_chunk for _, c in chunks)
        assert ev is None or chunks
    finally:
        fleet.close()
    assert got == want, f"geometry {gkey} diverged under {loop}"
