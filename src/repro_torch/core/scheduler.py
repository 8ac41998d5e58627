"""Batch system (paper §IV-C: "integrated batch system for long-running
applications without direct user interaction").

Jobs specify slice size, service model and a run callable. The scheduler
admits jobs FIFO-within-priority when capacity exists, tracks running jobs,
and re-queues jobs orphaned by node failures or straggler migration.
"""
from __future__ import annotations

import enum
import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.device_db import (DeviceDB, DeviceState,
                                        NoCapacityError, SliceState)


class JobState(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    REQUEUED = "requeued"


@dataclass(order=True)
class _QEntry:
    priority: int
    seq: int
    job_id: str = field(compare=False)


@dataclass
class Job:
    job_id: str
    owner: str
    slots: int                    # vSlice size (1/2/4)
    service_model: str            # raas | baas
    run: Optional[Callable[..., Any]] = None   # called with (slice_id)
    priority: int = 10            # lower = sooner
    state: JobState = JobState.QUEUED
    slice_id: Optional[str] = None
    result: Any = None
    error: Optional[str] = None
    submitted_at: float = 0.0
    attempts: int = 0
    max_attempts: int = 3
    deferrals: int = 0            # consecutive NoCapacity passes (aging)


class BatchScheduler:
    def __init__(self, db: DeviceDB,
                 clock: Callable[[], float] = time.monotonic,
                 starvation_patience: int = 3):
        self.db = db
        self.clock = clock
        self.starvation_patience = starvation_patience
        self.jobs: Dict[str, Job] = {}
        self._heap: List[_QEntry] = []
        self._seq = itertools.count()        # job ids
        self._hseq = itertools.count()       # FIFO tiebreak within priority
        self.history: List[dict] = []
        # per-owner weighted fair share (deficit credit): owners with
        # queued work accrue weight each pass and pay ``slots`` per start,
        # so within a priority band a flood of one owner's jobs cannot
        # starve a co-tenant — the same DRR policy the serving engine
        # applies to decode slots, here over batch vSlice allocations
        self._owner_weight: Dict[str, float] = {}
        self._owner_credit: Dict[str, float] = {}

    # ---------------- submission ----------------
    def submit(self, owner: str, slots: int, service_model: str = "raas",
               run: Optional[Callable] = None, priority: int = 10) -> Job:
        job_id = f"job-{next(self._seq):05d}"
        job = Job(job_id, owner, slots, service_model, run, priority,
                  submitted_at=self.clock())
        self.jobs[job_id] = job
        heapq.heappush(self._heap, _QEntry(priority, next(self._hseq), job_id))
        return job

    def set_owner_weight(self, owner: str,
                         weight: Optional[float] = None) -> None:
        """Fair-share weight for ``owner`` (None resets to 1.0)."""
        if weight is None:
            self._owner_weight.pop(owner, None)
        else:
            self._owner_weight[owner] = max(1e-3, float(weight))

    # ---------------- scheduling loop ----------------
    def _fair_order(self, entries: List[_QEntry]) -> List[_QEntry]:
        """Order queued entries by (priority, owner fair-share credit,
        submission order). Owners with queued work accrue credit each
        pass; a start debits ``slots``. With one owner — or balanced,
        equally-weighted owners — this degenerates to plain
        priority-FIFO, so fairness costs nothing until tenants actually
        contend. Credit is pruned only when an owner has neither queued
        nor running jobs (erasing debt mid-flight would reward a
        one-job-at-a-time flood)."""
        queued_owners = {self.jobs[e.job_id].owner for e in entries}
        running_owners = {j.owner for j in self.jobs.values()
                          if j.state == JobState.RUNNING}
        for o in list(self._owner_credit):
            if o not in queued_owners and o not in running_owners:
                del self._owner_credit[o]
        for o in sorted(queued_owners):
            self._owner_credit[o] = self._owner_credit.get(o, 0.0) + \
                self._owner_weight.get(o, 1.0)
        return sorted(entries, key=lambda e: (
            e.priority,
            -self._owner_credit.get(self.jobs[e.job_id].owner, 0.0),
            e.seq))

    def schedule_once(self) -> List[Job]:
        """Admit as many queued jobs as capacity allows (priority order,
        owner-fair within a priority band — see ``_fair_order``).
        Returns the jobs started this pass.

        Backfill with aging: a job deferred by ``NoCapacityError`` normally
        lets smaller jobs behind it run (backfill), but after
        ``starvation_patience`` consecutive deferred passes the pass stops
        at it (hold-back reservation) — freed capacity then accumulates for
        the large job instead of being nibbled away by a stream of small
        ones behind it.
        """
        started: List[Job] = []
        deferred: List[_QEntry] = []
        live: List[_QEntry] = []
        while self._heap:
            entry = heapq.heappop(self._heap)
            if self.jobs[entry.job_id].state in (JobState.QUEUED,
                                                 JobState.REQUEUED):
                live.append(entry)
        pending = self._fair_order(live)
        for idx, entry in enumerate(pending):
            job = self.jobs[entry.job_id]
            try:
                vs = self.db.allocate_slice(job.owner, job.slots,
                                            job.service_model)
            except NoCapacityError:
                deferred.append(entry)
                job.deferrals += 1
                if job.deferrals >= self.starvation_patience \
                        and self._reservation_feasible(job):
                    self.history.append(
                        {"t": self.clock(), "kind": "holdback",
                         "job": job.job_id, "deferrals": job.deferrals})
                    deferred.extend(pending[idx + 1:])
                    break
                # keep draining the queue: a smaller job behind may still fit
                continue
            job.slice_id = vs.slice_id
            job.state = JobState.RUNNING
            job.attempts += 1
            job.deferrals = 0
            self._owner_credit[job.owner] = \
                self._owner_credit.get(job.owner, 0.0) - job.slots
            self.db.set_slice_state(vs.slice_id, SliceState.RUNNING)
            self.history.append({"t": self.clock(), "kind": "start",
                                 "job": job.job_id, "slice": vs.slice_id})
            started.append(job)
        for e in deferred:
            heapq.heappush(self._heap, e)
        return started

    def _reservation_feasible(self, job: Job) -> bool:
        """Escape hatch for the hold-back: only reserve capacity for a job
        that completing the currently-RUNNING batch jobs could ever make
        fit. If the blocking slots belong to allocations the scheduler
        does not control (serving sessions, RSaaS tenants), holding the
        queue would starve everyone behind the job forever — keep
        backfilling instead."""
        running_by_dev: Dict[str, int] = {}
        for j in self.jobs.values():
            if j.state == JobState.RUNNING and j.slice_id:
                try:
                    vs = self.db.find_slice(j.slice_id)
                except KeyError:
                    continue
                running_by_dev[vs.device_id] = \
                    running_by_dev.get(vs.device_id, 0) + vs.slots
        return any(
            d.free_slots() + running_by_dev.get(d.device_id, 0) >= job.slots
            for d in self.db.alive_devices()
            if d.state != DeviceState.EXCLUSIVE)

    def run_pending(self) -> List[Job]:
        """Admit + synchronously execute (test/CPU mode)."""
        started = self.schedule_once()
        for job in started:
            try:
                if job.run is not None:
                    job.result = job.run(job.slice_id)
                self.complete(job.job_id)
            except Exception as e:  # noqa: BLE001 - job isolation
                self.fail(job.job_id, str(e))
        return started

    # ---------------- lifecycle ----------------
    def complete(self, job_id: str):
        job = self.jobs[job_id]
        job.state = JobState.DONE
        if job.slice_id:
            self.db.release(job.slice_id)
            job.slice_id = None
        self.history.append({"t": self.clock(), "kind": "done", "job": job_id})

    def fail(self, job_id: str, error: str):
        job = self.jobs[job_id]
        job.error = error
        if job.slice_id:
            try:
                self.db.release(job.slice_id)
            except KeyError:
                pass   # slice died with its node
            job.slice_id = None
        if job.attempts < job.max_attempts:
            job.state = JobState.REQUEUED
            heapq.heappush(self._heap,
                           _QEntry(job.priority, next(self._hseq), job_id))
        else:
            job.state = JobState.FAILED
        self.history.append({"t": self.clock(), "kind": "fail", "job": job_id,
                             "error": error, "attempts": job.attempts})

    def requeue_orphans(self, orphan_slice_ids: List[str]):
        """Called by the hypervisor after a node failure."""
        for job in self.jobs.values():
            if job.state == JobState.RUNNING and job.slice_id in orphan_slice_ids:
                job.slice_id = None
                self.fail(job.job_id, "node failure")

    def queued(self) -> List[Job]:
        return [j for j in self.jobs.values()
                if j.state in (JobState.QUEUED, JobState.REQUEUED)]
