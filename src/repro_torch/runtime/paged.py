"""Host-side page accounting for the paged KV-cache pool.

The device holds one shared page pool per layer (``models.stages.
init_paged_cache``); this module owns everything the pool needs a host
brain for: the free list, per-slot block tables, page refcounts,
copy-on-write arbitration, the tenant-scoped prefix cache, and per-tenant
page accounting (the enforcement point for the vSlice/admission
``max_cache_pages_per_tenant`` quota).

Page 0 is reserved as the null/scratch page: unused block-table entries
point at it and inactive batch rows write their discarded k/v there with
pos -1, so a gather through any block table never sees a valid-looking
stale position.

Prefix sharing is content-addressed and strictly intra-tenant: block j of
a context is keyed by a keyed-BLAKE2b hash chain over its token values,
seeded with a per-tenant salt, so two concurrent requests of one tenant
with a common prompt prefix share physical pages by refcount — while two
*different* tenants' identical prompts produce unrelated keys (no
cross-tenant hash-collision probe; Python's builtin ``hash`` is neither
collision-resistant nor stable across processes). A partially filled
tail page is shared on an exact-content match and copy-on-written the
moment a branch writes into it; registrations die with their pages
(sharing is among temporally overlapping requests — there is no retained
cache to evict).

Zero-on-free: with ``scrub_on_free`` (the default) every page whose
refcount drops to zero is queued for a device-side scrub. The pool is
host-only, so it never touches device memory itself — the engine drains
``take_scrub()`` and runs one batched, jitted zeroing kernel before its
next allocation point. ``_alloc_one`` refuses to hand out a page whose
scrub is still pending: a missed flush fails loudly instead of leaking
the previous tenant's KV values (or, worse, scrubbing the new tenant's).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.lifecycle import sanitizer


class NoPagesError(RuntimeError):
    """Internal guard: the engine must pre-check ``pages_needed`` /
    ``free_pages`` before allocating, so user traffic queues instead of
    ever seeing this."""


def default_pool_pages(n_slots: int, max_blocks: int) -> int:
    """Default pool size: dense-equivalent capacity (one full-length row
    per slot) plus the reserved null page. The single source for every
    layer that sizes or grants against the default pool (engine, fleet)."""
    return n_slots * max_blocks + 1


@dataclasses.dataclass
class AdmitPlan:
    """What the engine must still do after pages were assigned to a slot."""
    blocks: List[int]          # full page-id list for the slot's block table
    write_start: int           # first block index this request must write
    skip_prefill: bool         # every written position was prefix-shared
    matched_pages: int         # pages reused from the prefix cache

    @property
    def write_pages(self) -> List[int]:
        return self.blocks[self.write_start:]


class PagePoolManager:
    """Free list + block tables + refcounts + prefix cache for one engine."""

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_blocks: int, scrub_on_free: bool = True):
        if n_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_blocks = max_blocks
        # LIFO free list: recently freed pages are re-used first (their
        # content is hottest in any cache hierarchy)
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._ref = np.zeros((n_pages,), np.int32)
        self._ref[0] = 1                       # null page: never allocated
        self._owner: Dict[int, str] = {}       # page -> charging tenant
        self._tenant_pages: Dict[str, int] = {}
        self.block_tables = np.zeros((n_slots, max_blocks), np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._prefix: Dict[Hashable, int] = {}       # content key -> page
        self._page_key: Dict[int, Hashable] = {}     # page -> its key
        self.prefix_hits = 0
        self.cow_copies = 0
        # zero-on-free policy: freed pages queue here until the engine
        # drains take_scrub() into one batched device-side zeroing
        self.scrub_on_free = scrub_on_free
        self._pending_scrub: List[int] = []
        self.pages_scrubbed = 0
        # bumped on every block-table mutation: the engine keys its cached
        # device copy of the tables on this, so steady-state decode skips
        # the per-step host->device re-upload
        self.version = 0
        self._san = sanitizer.scope()   # namespaces this pool's page keys

    # ---------------- occupancy ----------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def total_pages(self) -> int:
        """Allocatable pages (page 0 excluded)."""
        return self.n_pages - 1

    @property
    def used_pages(self) -> int:
        return self.total_pages - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_pages / max(1, self.total_pages)

    def tenant_pages(self, tenant: str) -> int:
        return self._tenant_pages.get(tenant, 0)

    def pages_by_tenant(self) -> Dict[str, int]:
        return {t: n for t, n in self._tenant_pages.items() if n}

    def slot_blocks(self, slot: int) -> List[int]:
        return self._slot_pages[slot]

    # ---------------- page lifecycle ----------------
    def _alloc_one(self, tenant: str) -> int:
        if not self._free:
            raise NoPagesError("page pool exhausted")
        pid = self._free.pop()
        assert pid not in self._pending_scrub, \
            f"page {pid} reallocated before its zero-on-free scrub was " \
            f"flushed — the caller must drain take_scrub() before allocating"
        sanitizer.emit("page", (self._san, pid), "alloc")
        self._ref[pid] = 1
        self._owner[pid] = tenant
        self._tenant_pages[tenant] = self._tenant_pages.get(tenant, 0) + 1
        return pid

    def _decref(self, pid: int):
        sanitizer.emit("page", (self._san, pid),
                       "free" if self._ref[pid] == 1 else "unshare")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            key = self._page_key.pop(pid, None)
            if key is not None:
                self._prefix.pop(key, None)
            tenant = self._owner.pop(pid)
            self._tenant_pages[tenant] -= 1
            if not self._tenant_pages[tenant]:
                del self._tenant_pages[tenant]
            self._free.append(pid)
            if self.scrub_on_free:
                self._pending_scrub.append(pid)

    def _register(self, key: Hashable, pid: int):
        # first writer wins; identical content by construction
        if key not in self._prefix and pid not in self._page_key:
            self._prefix[key] = pid
            self._page_key[pid] = key

    # ---------------- zero-on-free ----------------
    @property
    def scrub_pending(self) -> int:
        return len(self._pending_scrub)

    def take_scrub(self) -> List[int]:
        """Drain the zero-on-free queue. The caller (the engine) owns the
        actual device-side zeroing — it must scrub exactly these pages
        before its next allocation, and every queued page is still on the
        free list when this returns (``_alloc_one`` enforces it)."""
        pids, self._pending_scrub = self._pending_scrub, []
        for pid in pids:
            sanitizer.emit("page", (self._san, pid), "scrub")
        self.pages_scrubbed += len(pids)
        return pids

    # ---------------- prefix matching ----------------
    @staticmethod
    def _chain_seed(tenant: str) -> int:
        """Per-tenant salt for the content-hash chain: keyed BLAKE2b, so
        identical prompts from different tenants map to unrelated key
        chains and no tenant can probe another's cache by hash collision
        (``hash()`` would be forgeable and PYTHONHASHSEED-unstable)."""
        d = hashlib.blake2b(repr(tenant).encode("utf-8"),
                            key=b"rc3e-kvpfx", digest_size=16).digest()
        return int.from_bytes(d, "big")

    @staticmethod
    def _chain_step(h: int, toks) -> int:
        data = h.to_bytes(16, "big") + b"".join(
            int(t).to_bytes(8, "big", signed=True) for t in toks)
        d = hashlib.blake2b(data, key=b"rc3e-kvpfx", digest_size=16).digest()
        return int.from_bytes(d, "big")

    def _block_keys(self, tenant: str, toks) -> List[Hashable]:
        """Hash chain over full, content-complete blocks of a context.
        Block j is content-complete once prefill has written all of its
        positions, i.e. (j+1)*ps <= len(toks) - 1 (position len-1 is
        written by the first decode step, not prefill)."""
        ps = self.page_size
        full = (len(toks) - 1) // ps
        keys, h = [], self._chain_seed(tenant)
        for j in range(full):
            h = self._chain_step(h, toks[j * ps:(j + 1) * ps])
            keys.append(h)
        return keys

    def _tail_key(self, tenant: str, toks) -> Optional[Hashable]:
        """Exact-content key for the partially filled tail page (positions
        full*ps .. len(toks)-2), or None when the tail is empty."""
        ps = self.page_size
        n = len(toks)
        full = (n - 1) // ps
        if (n - 1) % ps == 0:
            return None
        keys = self._block_keys(tenant, toks)
        h = keys[-1] if keys else self._chain_seed(tenant)
        return ("tail", h, tuple(int(t) for t in toks[full * ps:n - 1]))

    def _match(self, tenant: str, toks) -> Tuple[List[int], int]:
        """(shared page ids, total blocks) for a context, read-only."""
        n = len(toks)
        total = (n - 1) // self.page_size + 1
        shared: List[int] = []
        keys = self._block_keys(tenant, toks)
        for key in keys:
            pid = self._prefix.get(key)
            if pid is None:
                break
            shared.append(pid)
        if len(shared) == len(keys):
            tkey = self._tail_key(tenant, toks)
            if tkey is not None:
                pid = self._prefix.get(tkey)
                if pid is not None:
                    shared.append(pid)
        return shared, total

    def pages_needed(self, tenant: str, toks, share: bool = True) -> int:
        """Fresh pages a context would allocate at admission (read-only —
        the engine's queue-on-exhaustion check)."""
        if not share:
            return (len(toks) - 1) // self.page_size + 1
        shared, total = self._match(tenant, toks)
        return total - len(shared)

    # ---------------- slot admission / growth ----------------
    def admit(self, slot: int, tenant: str, toks,
              share: bool = True) -> AdmitPlan:
        """Assign pages for context ``toks`` (prompt + generated so far,
        including the token the first decode step consumes): prefix-matched
        pages by refcount, the rest freshly allocated. Builds the slot's
        block-table row and registers this context's content keys.
        ``share=False`` (legacy prefill, which writes every position)
        allocates everything fresh and registers nothing."""
        n = len(toks)
        total = (n - 1) // self.page_size + 1
        if total > self.max_blocks:
            raise ValueError(f"context of {n} tokens needs {total} blocks, "
                             f"table has {self.max_blocks}")
        shared = self._match(tenant, toks)[0] if share else []
        for pid in shared:
            sanitizer.emit("page", (self._san, pid), "share")
            self._ref[pid] += 1
            self.prefix_hits += 1
        fresh: List[int] = []
        try:
            for _ in range(total - len(shared)):
                fresh.append(self._alloc_one(tenant))
        except NoPagesError:
            # roll back BOTH halves: pages allocated before the exhaustion
            # point and the shared-page increfs
            for pid in fresh:
                self._decref(pid)
            for pid in shared:
                self._decref(pid)
            raise
        blocks = shared + fresh
        self.block_tables[slot, :] = 0
        self.block_tables[slot, :total] = blocks
        self._slot_pages[slot] = list(blocks)
        self.version += 1
        if share:
            # register what this request will write: content-complete full
            # blocks, plus its tail page (exact content) if it owns one
            keys = self._block_keys(tenant, toks)
            for j in range(len(shared), len(keys)):
                self._register(keys[j], blocks[j])
            full = len(keys)
            if len(shared) <= full:  # tail page not among the shared ones
                tkey = self._tail_key(tenant, toks)
                if tkey is not None:
                    self._register(tkey, blocks[full])
        return AdmitPlan(blocks=blocks, write_start=len(shared),
                         skip_prefill=len(shared) == total,
                         matched_pages=len(shared))

    def grow(self, slot: int, tenant: str) -> int:
        """Append one fresh page to a slot (decode crossed a page
        boundary). Caller pre-checks ``free_pages`` and tenant budget."""
        pid = self._alloc_one(tenant)
        bi = len(self._slot_pages[slot])
        self.block_tables[slot, bi] = pid
        self._slot_pages[slot].append(pid)
        self.version += 1
        return pid

    # ---------------- copy-on-write ----------------
    def is_shared(self, slot: int, block: int) -> bool:
        return self._ref[self._slot_pages[slot][block]] > 1

    def cow(self, slot: int, block: int, tenant: str) -> Tuple[int, int]:
        """Detach a shared page before this slot writes it: allocate a
        private copy target and repoint the block table. Returns
        (src, dst); the engine performs the actual device copy."""
        src = self._slot_pages[slot][block]
        dst = self._alloc_one(tenant)
        # route through _decref, never a bare ref decrement: if the other
        # holder released between the is_shared check and here, src must
        # take the full free path (prefix-key retirement, tenant
        # accounting, scrub queue) — a bare decrement would strand a
        # dangling _page_key entry on a free page
        self._decref(src)
        self._slot_pages[slot][block] = dst
        self.block_tables[slot, block] = dst
        self.cow_copies += 1
        self.version += 1
        return src, dst

    def touch_write(self, slot: int, block: int):
        """A privately held page is about to be mutated: retire its tail
        registration (its content will no longer match the key). Full-block
        registrations are immutable — decode never writes into a
        content-complete block."""
        pid = self._slot_pages[slot][block]
        key = self._page_key.get(pid)
        if key is not None and isinstance(key, tuple) and key[0] == "tail":
            del self._page_key[pid]
            self._prefix.pop(key, None)

    # ---------------- release ----------------
    def release_slot(self, slot: int):
        for pid in self._slot_pages[slot]:
            self._decref(pid)
        self._slot_pages[slot] = []
        self.block_tables[slot, :] = 0
        self.version += 1

    # ---------------- invariants ----------------
    def verify(self) -> None:
        """Machine-checked conservation invariants — the chaos harness and
        the property suite call this after every event:

          * ``free + referenced == total`` (no page leaked, none lost);
          * the free list holds no duplicates and only ref==0 pages;
          * every referenced page's refcount equals the number of slots
            holding it (registrations never outlive their pages);
          * per-tenant accounting sums exactly to the referenced pages;
          * block tables mirror the slot page lists (tail zeroed);
          * the prefix cache and its reverse map are a bijection onto
            live pages;
          * no free page retains a dangling prefix key or owner entry;
          * the zero-on-free queue is a duplicate-free subset of the
            free list (a scrub can never hit a reallocated page).

        Raises AssertionError on the first violation.
        """
        assert self._ref[0] == 1, "null page refcount must stay pinned at 1"
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "free-list duplicate " \
            "(double-free)"
        assert 0 not in free_set, "null page on the free list"
        # iterate the free LIST, not the set: set order is salted per
        # process and would make any failure message non-reproducible
        for pid in self._free:
            assert self._ref[pid] == 0, f"free page {pid} has refcount " \
                f"{self._ref[pid]}"
            assert pid not in self._page_key, \
                f"free page {pid} retains a dangling prefix key " \
                f"{self._page_key[pid]!r}"
            assert pid not in self._owner, \
                f"free page {pid} retains an owner entry"
        pending = set(self._pending_scrub)
        assert len(pending) == len(self._pending_scrub), \
            "page queued for scrub twice"
        assert pending <= free_set, \
            f"scrub queue holds non-free pages {sorted(pending - free_set)}"
        referenced = [p for p in range(1, self.n_pages) if self._ref[p] > 0]
        assert len(referenced) + len(self._free) == self.total_pages, \
            f"page conservation broken: {len(referenced)} referenced + " \
            f"{len(self._free)} free != {self.total_pages} total"
        holders: Dict[int, int] = {}
        for slot, pages in enumerate(self._slot_pages):
            for bi, pid in enumerate(pages):
                assert self._ref[pid] > 0, \
                    f"slot {slot} holds freed page {pid}"
                assert self.block_tables[slot, bi] == pid, \
                    f"block table desync at slot {slot} block {bi}"
                holders[pid] = holders.get(pid, 0) + 1
            assert not self.block_tables[slot, len(pages):].any(), \
                f"slot {slot} block-table tail not zeroed"
        for pid in referenced:
            assert self._ref[pid] == holders.get(pid, 0), \
                f"page {pid} refcount {self._ref[pid]} != " \
                f"{holders.get(pid, 0)} slot holders"
        assert sum(self._tenant_pages.values()) == len(referenced), \
            "tenant page accounting != referenced pages"
        assert set(self._owner) == set(referenced), \
            "owner map out of sync with referenced pages"
        for key, pid in self._prefix.items():
            assert self._page_key.get(pid) == key, \
                f"prefix entry for page {pid} lost its reverse mapping"
            assert self._ref[pid] > 0, f"prefix cache points at freed " \
                f"page {pid}"
        for pid, key in self._page_key.items():
            assert self._prefix.get(key) == pid, \
                f"reverse prefix mapping for page {pid} dangling"

    # ---------------- introspection ----------------
    def stats(self) -> dict:
        return {
            "page_size": self.page_size,
            "pages_total": self.total_pages,
            "pages_used": self.used_pages,
            "pages_free": self.free_pages,
            "occupancy": round(self.occupancy, 4),
            "by_tenant": self.pages_by_tenant(),
            "prefix_hits": self.prefix_hits,
            "cow_copies": self.cow_copies,
            "scrub_on_free": self.scrub_on_free,
            "pages_scrubbed": self.pages_scrubbed,
            "scrub_pending": self.scrub_pending,
        }
