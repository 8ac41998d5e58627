"""The reference's property tests of the page pool
(``tests/test_pool_properties.py``) on the port, with the same constants:
random alloc / grow / share-COW / free / cancel sequences must never leak a
page, never double-free, and keep ``free + referenced == total`` (with
per-tenant accounting and the prefix cache consistent) after EVERY
operation; the zero-on-free property holds after every operation; and the
pool's policy cases (scrub off, the COW last holder, cross-tenant
prompts, the keyed tenant salt).

The walk runs two ways. As in the reference, over the port's
``PagePoolManager`` with the device pool modeled as a per-page dirty bit.
And over the port's paged ``BatchingEngine`` itself: pages the walk
writes are written in the engine's torch pools, ``take_scrub`` is drained
by the engine's own scrub (``_flush_scrub``), and the property is read
from the pools' contents — every free page not queued for scrub reads as
init state (K/V 0, pos -1), and at teardown ``assert_free_pages_zeroed``
reads the whole free list clean.

Parity: the walk's pool statistics after every operation, and the tenant
salts, equal the JAX package's pool (``repro.runtime.paged``).
"""
import random
import sys

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.runtime.paged import PagePoolManager as JPagePoolManager
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model
from repro_torch.runtime import BatchingEngine
from repro_torch.runtime.adversary import assert_free_pages_zeroed
from repro_torch.runtime.paged import PagePoolManager
from repro_torch.runtime.serve import _site_caches

torch.set_num_threads(1)

N_SLOTS = 4
MAX_BLOCKS = 6
PAGE_SIZE = 4
N_PAGES = 14                       # 13 usable: forces exhaustion regularly
TENANTS = ("alice", "bob")


def _random_context(rng):
    """Token contexts drawn from a tiny alphabet so prefix collisions (and
    therefore sharing + COW) actually happen."""
    n = rng.randrange(1, MAX_BLOCKS * PAGE_SIZE)
    return [rng.randrange(4) for _ in range(n)]


class _HostPool:
    """The reference's model of the device pool: one dirty bit a page."""

    def __init__(self, pool):
        self.pool = pool
        self.dirty = [False] * N_PAGES

    def write(self, pid):
        self.dirty[pid] = True

    def flush(self):
        for pid in self.pool.take_scrub():
            self.dirty[pid] = False

    def reads_clean(self, pid):
        return not self.dirty[pid]


class _EnginePool(_HostPool):
    """The port's engine: writes land in its torch pools, the scrub is the
    engine's own, and cleanliness is read from the pools' contents."""

    def __init__(self, engine):
        super().__init__(engine.pool)
        self.engine = engine

    def write(self, pid):
        super().write(pid)
        for site in _site_caches(self.engine.caches):
            for name, leaf in site.items():
                leaf[:, pid] = 5 if name == "pos" else 3

    def flush(self):
        pids = list(self.pool._pending_scrub)
        self.engine._flush_scrub()
        assert self.pool.scrub_pending == 0
        for pid in pids:
            self.dirty[pid] = False

    def reads_clean(self, pid):
        clean = all(bool((leaf[:, pid] == (-1 if name == "pos" else 0))
                         .all())
                    for site in _site_caches(self.engine.caches)
                    for name, leaf in site.items())
        assert clean == super().reads_clean(pid), pid
        return clean


def _engine():
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return BatchingEngine(model, params, n_slots=N_SLOTS,
                          max_len=MAX_BLOCKS * PAGE_SIZE, paged=True,
                          page_size=PAGE_SIZE, cache_pages=N_PAGES)


def _assert_scrub_invariant(pool, dev):
    """Freed pages are scrubbed: no free-list page may be dirty unless its
    scrub is still queued."""
    pending = set(pool._pending_scrub)
    for pid in pool._free:
        assert dev.reads_clean(pid) or pid in pending, \
            f"free page {pid} holds stale content with no scrub queued"


def _random_walk(seed: int, n_ops: int = 120, engine=None, pool=None,
                 trace=None):
    rng = random.Random(seed)
    if engine is not None:
        pool = engine.pool
        dev = _EnginePool(engine)
    else:
        pool = pool or PagePoolManager(N_PAGES, PAGE_SIZE, N_SLOTS,
                                       MAX_BLOCKS)
        dev = _HostPool(pool)
    no_pages = sys.modules[type(pool).__module__].NoPagesError
    occupied = {}                  # slot -> tenant
    for _ in range(n_ops):
        op = rng.choice(("admit", "admit", "grow", "cow", "release",
                         "double_release"))
        if op == "admit":
            free_slots = [s for s in range(N_SLOTS) if s not in occupied]
            if not free_slots:
                continue
            slot, tenant = rng.choice(free_slots), rng.choice(TENANTS)
            toks = _random_context(rng)
            dev.flush()                  # engine scrubs before allocating
            if pool.pages_needed(tenant, toks) > pool.free_pages:
                free_before = pool.free_pages
                with pytest.raises(no_pages):
                    pool.admit(slot, tenant, toks)
                assert pool.free_pages == free_before
            else:
                plan = pool.admit(slot, tenant, toks)
                for pid in plan.blocks:
                    dev.write(pid)       # prefill writes K/V here
                occupied[slot] = tenant
        elif op == "grow" and occupied:
            slot = rng.choice(sorted(occupied))
            if pool.free_pages >= 1 \
                    and len(pool.slot_blocks(slot)) < MAX_BLOCKS:
                dev.flush()
                dev.write(pool.grow(slot, occupied[slot]))
        elif op == "cow" and occupied:
            slot = rng.choice(sorted(occupied))
            shared = [b for b in range(len(pool.slot_blocks(slot)))
                      if pool.is_shared(slot, b)]
            if shared and pool.free_pages >= 1:
                dev.flush()
                src, dst = pool.cow(slot, rng.choice(shared),
                                    occupied[slot])
                assert src != dst
                dev.write(dst)           # the COW copy lands here
            elif pool.slot_blocks(slot):
                pool.touch_write(slot, len(pool.slot_blocks(slot)) - 1)
        elif op == "release" and occupied:
            slot = rng.choice(sorted(occupied))
            pool.release_slot(slot)
            del occupied[slot]
        elif op == "double_release":
            free_slots = [s for s in range(N_SLOTS) if s not in occupied]
            if free_slots:
                before = pool.free_pages
                pool.release_slot(rng.choice(free_slots))
                assert pool.free_pages == before
        pool.verify()
        _assert_scrub_invariant(pool, dev)
        if trace is not None:
            trace.append(pool.stats())
    for slot in list(occupied):
        pool.release_slot(slot)
    pool.verify()
    dev.flush()
    assert pool.used_pages == 0
    assert pool.free_pages == pool.total_pages
    assert pool.pages_by_tenant() == {}
    assert not any(dev.dirty[1:]), \
        f"pages {[p for p in range(1, N_PAGES) if dev.dirty[p]]} " \
        "left unscrubbed"
    if engine is not None:
        assert assert_free_pages_zeroed(engine) == pool.total_pages


@pytest.mark.parametrize("seed", range(10))
def test_pool_random_walk_seeded(seed):
    _random_walk(seed)


@given(st.integers(min_value=0, max_value=2**32 - 1))
@settings(max_examples=30, deadline=None)
def test_pool_random_walk_hypothesis(seed):
    _random_walk(seed)


@pytest.mark.parametrize("seed", range(10))
def test_engine_random_walk_seeded(seed):
    _random_walk(seed, engine=_engine())


@given(st.integers(min_value=0, max_value=2**32 - 1))
@settings(max_examples=30, deadline=None)
def test_engine_random_walk_hypothesis(seed):
    _random_walk(seed, engine=_engine())


@pytest.mark.parametrize("seed", range(5))
def test_random_walk_stats_equal_reference(seed):
    """The same walk over the JAX package's pool (host-only, no JAX) and
    the port's: identical statistics after every operation."""
    got, ref = [], []
    _random_walk(seed, trace=got)
    _random_walk(seed, pool=JPagePoolManager(N_PAGES, PAGE_SIZE, N_SLOTS,
                                             MAX_BLOCKS), trace=ref)
    assert got == ref and len(got) > 60


def test_scrub_off_queues_nothing():
    pool = PagePoolManager(N_PAGES, PAGE_SIZE, N_SLOTS, MAX_BLOCKS,
                           scrub_on_free=False)
    pool.admit(0, "alice", list(range(9)))
    pool.release_slot(0)
    assert pool.scrub_pending == 0
    assert pool.take_scrub() == []
    pool.verify()


def test_cow_last_holder_takes_free_path():
    pool = PagePoolManager(N_PAGES, PAGE_SIZE, N_SLOTS, MAX_BLOCKS)
    toks = [1, 2, 3, 0, 1, 2, 3, 0, 2]      # two full blocks + one block
    a = pool.admit(0, "alice", toks)
    b = pool.admit(1, "alice", toks)        # shares both full blocks
    assert a.blocks[:2] == b.blocks[:2]
    assert b.matched_pages >= 2
    shared_pid = pool.slot_blocks(1)[0]
    assert pool.is_shared(1, 0)
    pool.release_slot(0)
    pool.verify()
    assert not pool.is_shared(1, 0)
    pool.take_scrub()      # the engine flushes before any allocation
    src, dst = pool.cow(1, 0, "alice")
    assert src == shared_pid and dst != src
    pool.verify()
    assert shared_pid not in pool.slot_blocks(1)
    pool.release_slot(1)
    pool.verify()
    assert pool.used_pages == 0
    assert shared_pid in pool.take_scrub()
    pool.verify()


def test_cross_tenant_prompts_never_share_pages():
    pool = PagePoolManager(N_PAGES, PAGE_SIZE, N_SLOTS, MAX_BLOCKS)
    toks = [3, 1, 2, 0, 1, 3, 2, 1, 0, 2]
    pool.admit(0, "alice", toks)
    b = pool.admit(1, "bob", toks)
    assert b.matched_pages == 0, "cross-tenant prefix match"
    assert not set(pool.slot_blocks(0)) & set(pool.slot_blocks(1)), \
        "tenants share a physical page for the same prompt"
    c = pool.admit(2, "alice", toks)
    assert c.matched_pages > 0
    assert set(pool.slot_blocks(2)) & set(pool.slot_blocks(0))
    pool.verify()


def test_tenant_salt_is_keyed_and_distinct():
    s_alice = PagePoolManager._chain_seed("alice")
    s_bob = PagePoolManager._chain_seed("bob")
    assert s_alice != s_bob
    assert s_alice == PagePoolManager._chain_seed("alice")
    assert PagePoolManager._chain_step(s_alice, [1, 2, 3]) != \
        PagePoolManager._chain_step(s_bob, [1, 2, 3])
    # the same keyed digest as the reference's pool
    assert s_alice == JPagePoolManager._chain_seed("alice")
    assert PagePoolManager._chain_step(s_bob, [1, 2, 3]) == \
        JPagePoolManager._chain_step(s_bob, [1, 2, 3])
