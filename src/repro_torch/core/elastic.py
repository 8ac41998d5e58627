"""Elastic scaling: grow/shrink a tenant's slice set and re-place work.

The paper's outlook ("migration of user designs between vFPGAs and physical
FPGAs is also intended") is implemented here as a first-class operation:
``resize`` reallocates a tenant to a new slot count, carrying the program
fingerprint so the PR cache makes re-programming cheap, and the training
runtime pairs this with ``repro.ckpt.reshard`` to move optimizer/model state
onto the new data-parallel extent.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.core.device_db import (DeviceState, NoCapacityError,
                                        SliceState, VSlice)
from repro_torch.core.hypervisor import Hypervisor


class ElasticController:
    def __init__(self, hv: Hypervisor):
        self.hv = hv

    def resize(self, owner: str, new_slots: int,
               service_model: str = "raas") -> List[VSlice]:
        """Replace the tenant's slices with one allocation of ``new_slots``.

        Allocate-before-release so a failed grow leaves the tenant intact.
        """
        old = self.hv.db.slices_of(owner)
        program = old[0].program if old else None
        new = self.hv.db.allocate_slice(owner, new_slots, service_model)
        for s in old:
            self.hv.release(s.slice_id)
        if program:
            new.program = program
            new.state = SliceState.CONFIGURED
        self.hv._log("elastic_resize", owner=owner, slots=new_slots,
                     slice=new.slice_id)
        return [new]

    # ------------------------------------------------------------------
    # Fleet-level scaling (DeviceDB energy policy, inverted on demand)
    # ------------------------------------------------------------------
    def pick_scale_out_device(self) -> Optional[str]:
        """A PARKED, alive, empty physical device to wake when serving
        demand outgrows the active fleet — the deliberate inversion of the
        pack-first energy policy. Returns its id, or None when every
        device is already active (or dead)."""
        cands = self.hv.db.idle_devices()
        return cands[0].device_id if cands else None

    def scale_out(self, slice_id: str) -> Optional[VSlice]:
        """Wake a PARKED device and move the given (hot / deepest-queued)
        slice onto it via a directed migration. The hypervisor's migration
        listeners carry the dataplane along (the serving fleet spins up an
        engine there and hands the tenant's traffic off live). Returns the
        new slice, or None when no parked capacity exists."""
        dev = self.pick_scale_out_device()
        if dev is None:
            return None
        new = self.hv.migrate_slice(slice_id, target_device=dev,
                                    reason="scale_out")
        if new is not None:
            self.hv._log("elastic_scale_out", slice=new.slice_id, device=dev)
        return new

    # ------------------------------------------------------------------
    # SLO-projection scaling (open-loop traffic: act on the trend, not
    # the backlog — by the time queue depth trips, the p95 is already
    # blown through a burst wave)
    # ------------------------------------------------------------------
    def _active_serving_devices(self) -> int:
        return len([d for d in self.hv.db.alive_devices()
                    if d.state in (DeviceState.ACTIVE,
                                   DeviceState.EXCLUSIVE)])

    def projected_p95_steps(self, backlog: int,
                            horizon: int = 16) -> Optional[float]:
        """Projected p95 request sojourn (in fleet steps) one ``horizon``
        from now, from the monitor's arrival-rate/service-rate trend.

        Fluid queueing estimate: a request arriving at the end of the
        horizon waits behind today's backlog plus the horizon's expected
        arrivals, all draining through the active fleet's measured service
        capacity — ``(backlog + λ·horizon) / (μ_dev · n_active)``. When
        λ exceeds capacity the estimate grows linearly in the horizon,
        which is exactly the divergence the autoscaler must act on.
        Returns None until the monitor has a usable trend (no samples yet,
        or nothing served so far)."""
        lam = self.hv.monitor.arrival_rate()
        mu_dev = self.hv.monitor.service_rate_per_device()
        if lam is None or mu_dev is None or mu_dev <= 0.0:
            return None
        mu_total = mu_dev * max(1, self._active_serving_devices())
        return (backlog + lam * horizon) / mu_total

    def scale_out_on_slo(self, slice_id: str, slo_p95_steps: float,
                         backlog: int, horizon: int = 16
                         ) -> Optional[VSlice]:
        """Wake a PARKED device when the *projected* p95 breaches the SLO
        — queue depth and page pressure are lagging signals; the trend
        fires while the burst is still arriving. ``slice_id`` is the slice
        worth moving (the fleet passes its deepest-queued tenant's).
        Returns the new slice, or None when the projection is under SLO
        (or unavailable) or no parked capacity exists."""
        projected = self.projected_p95_steps(backlog, horizon)
        if projected is None or projected <= slo_p95_steps:
            return None
        new = self.scale_out(slice_id)
        if new is not None:
            self.hv._log("elastic_slo_scale_out", slice=slice_id,
                         new_slice=new.slice_id, projected_p95=projected,
                         slo_p95=slo_p95_steps, backlog=backlog)
        return new

    def scale_out_on_page_pressure(self, hottest_slice_of: dict,
                                   threshold: float = 0.85
                                   ) -> Optional[VSlice]:
        """Memory-side elastic scaling: when a device's KV page pool runs
        hot (occupancy pushed into the monitor by the serving dataplane),
        move its hottest tenant's slice onto a woken PARKED device — queue
        depth says nothing about long-context tenants whose *pages* are
        the bottleneck. ``hottest_slice_of`` maps device_id -> slice_id of
        the tenant best worth moving (the fleet computes it from per-slot
        page counts). Returns the new slice, or None when no device is
        pressured or no parked capacity exists."""
        for dev in self.hv.monitor.find_page_pressure(threshold):
            sid = hottest_slice_of.get(dev)
            if sid is None:
                continue
            new = self.scale_out(sid)
            if new is not None:
                self.hv._log("elastic_page_pressure", device=dev,
                             slice=sid, new_slice=new.slice_id)
                return new
        return None

    def consolidate(self, device_id: str) -> bool:
        """Drain a device for parking (scale-in): migrate every slice it
        hosts onto the remaining fleet (pack-first). Returns True when the
        device emptied — ``DeviceDB.release`` then parks it, completing the
        energy policy's "minimize active devices" half.

        The placement is dry-run first (largest slice first against each
        other device's free slots), so an infeasible drain returns False
        WITHOUT migrating anything — no tenant pays a live hand-off for a
        device that cannot actually empty.
        """
        if not self.drain_feasible(device_id):
            return False
        dev = self.hv.db.device(device_id)
        slices = sorted(dev.slices.values(), key=lambda s: -s.slots)
        for s in slices:
            if self.hv.migrate_slice(s.slice_id, reason="scale_in") is None:
                return False    # capacity changed under us mid-drain
        self.hv._log("elastic_scale_in", device=device_id)
        return True

    def drain_feasible(self, device_id: str) -> bool:
        """Dry-run the ``consolidate`` placement: can every slice this
        device hosts fit onto the rest of the alive fleet (largest first,
        mirroring the allocator's pack-first order, honoring page grants
        on metered clusters)? No state is touched."""
        dev = self.hv.db.device(device_id)
        slices = sorted(dev.slices.values(), key=lambda s: -s.slots)
        others = [d for d in self.hv.db.alive_devices()
                  if d.device_id != device_id
                  and d.state != DeviceState.EXCLUSIVE]
        free = {d.device_id: d.free_slots() for d in others}
        free_pages = {d.device_id:
                      (d.cache_pages - d.granted_cache_pages()
                       if d.cache_pages else None) for d in others}
        for s in slices:
            # mirror the allocator's pack-first order (fewest free first)
            fits = sorted((k for k, v in free.items()
                           if v >= s.slots
                           and (not s.cache_pages or free_pages[k] is None
                                or free_pages[k] >= s.cache_pages)),
                          key=lambda k: (free[k], k))
            if not fits:
                return False
            free[fits[0]] -= s.slots
            if s.cache_pages and free_pages[fits[0]] is not None:
                free_pages[fits[0]] -= s.cache_pages
        return True

    def pick_scale_in_device(self, min_active: int = 1) -> Optional[str]:
        """The device to drain when the fleet is over-provisioned: among
        ACTIVE slice-hosting devices, the highest-draw one whose slices
        can actually be re-packed elsewhere (dry-run) — the power-hungry
        device classes park first, completing the energy policy under a
        diurnal down-ramp. Keeps at least ``min_active`` serving devices.
        Returns the device id, or None when nothing can (or should)
        drain."""
        active = [d for d in self.hv.db.alive_devices()
                  if d.state == DeviceState.ACTIVE and d.slices]
        if len(active) <= min_active:
            return None
        for d in sorted(active, key=lambda d: (-d.draw, d.device_id)):
            if self.drain_feasible(d.device_id):
                return d.device_id
        return None

    def place_failover(self, owner: str, slots: int,
                       service_model: str = "baas",
                       cache_pages_of: Optional[Callable[[int], int]] = None
                       ) -> Optional[VSlice]:
        """Re-place a dead device's tenant on surviving capacity. Tries the
        tenant's full slot count first; when the survivors cannot fit it,
        degrades 4 -> 2 -> 1 (elastic degrade — a smaller slice now beats a
        lost session). PARKED devices count as survivors: the allocator
        waking one IS the scale-out half of failover.

        ``cache_pages_of`` maps a slot count to that placement's page
        grant (the fleet passes its per-session grant formula). It is
        re-evaluated at every degrade step: on a page-metered cluster a
        smaller slice must ask for its OWN smaller grant, or a placement
        that fits in slots would keep failing on pages — and a degraded
        slice would over-reserve the full-size grant forever.

        Returns the new slice (``slots`` may be smaller than requested),
        or None when not even a 1-slot slice fits anywhere."""
        s = slots
        while s >= 1:
            try:
                vs = self.hv.db.allocate_slice(
                    owner, s, service_model,
                    cache_pages=cache_pages_of(s) if cache_pages_of else 0)
            except NoCapacityError:
                s //= 2
                continue
            self.hv._log("failover_place", owner=owner, slice=vs.slice_id,
                         device=vs.device_id, slots=s, requested=slots,
                         degraded=s != slots)
            return vs
        return None

    def shrink_to_survivors(self, owner: str) -> Optional[VSlice]:
        """After a node failure: re-place the tenant on surviving capacity at
        the largest slot count that fits (elastic degrade). Returns the new
        slice, or None if the cluster is full."""
        vs = self.place_failover(owner, 4, "raas")
        if vs is not None:
            self.hv._log("elastic_degrade", owner=owner, slots=vs.slots,
                         slice=vs.slice_id)
        return vs
