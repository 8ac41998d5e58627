"""User-facing sessions for the three cloud service models (paper §III).

These wrap the hypervisor with the per-model *capability* restrictions the
paper describes: RSaaS exposes raw device control; RAaaS only exposes the
RC2F core interface; BAaaS exposes nothing but named services.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.core.hypervisor import Hypervisor


class RSaaSSession:
    """Reconfigurable Silicon as a Service: full physical device, arbitrary
    programs (≈ IaaS). The user may replace 'the PCIe endpoint' — here, run
    any callable, including ones bypassing the RC2F shell."""

    def __init__(self, hv: Hypervisor, owner: str):
        self.hv = hv
        self.owner = owner
        self.device = hv.allocate_physical(owner)
        self.slice_id = next(iter(hv.db.device(self.device.device_id)
                                  .slices.keys()))

    def program(self, fn: Callable, example_inputs, desc: str = ""):
        return self.hv.program_slice(self.slice_id, fn, example_inputs, desc)

    def run(self, *args):
        return self.hv.execute(self.slice_id, *args)

    def close(self):
        self.hv.release(self.slice_id)


class RAaaSSession:
    """Reconfigurable Accelerators as a Service: a vSlice + the RC2F core
    interface only (≈ PaaS). Admission-checks the user core against its
    declared stream shapes before programming (the paper's planned
    'bitstream sanity checking')."""

    def __init__(self, hv: Hypervisor, owner: str, slots: int = 1):
        self.hv = hv
        self.owner = owner
        self.vslice = hv.allocate_vslice(owner, slots, "raas")

    def deploy_core(self, core_fn: Callable, example_inputs,
                    desc: str = "") -> Any:
        from repro_torch.rc2f.admission import admit_core
        admit_core(core_fn, example_inputs)
        return self.hv.program_slice(self.vslice.slice_id, core_fn,
                                     example_inputs, desc)

    def run(self, *args):
        return self.hv.execute(self.vslice.slice_id, *args)

    def submit_batch(self, run: Callable, priority: int = 10):
        """Paper §III-B: host program submitted to the batch system."""
        return self.hv.scheduler.submit(self.owner, self.vslice.slots,
                                        "raas", run, priority)

    def close(self):
        self.hv.release(self.vslice.slice_id)


class BAaaSSession:
    """Background Acceleration as a Service: only named services are visible;
    vFPGAs/vSlices are never exposed (≈ SaaS)."""

    def __init__(self, hv: Hypervisor, owner: str):
        self.hv = hv
        self.owner = owner

    def list_services(self):
        return sorted(self.hv.services.keys())

    def invoke(self, service: str, *args, slots: int = 1):
        """Invoke with the given inputs; with none, the service runs on its
        registered example inputs. To call a zero-input core explicitly,
        pass ``args=()`` to ``Hypervisor.invoke_service`` directly."""
        return self.hv.invoke_service(service, self.owner,
                                      args if args else None, slots=slots)
