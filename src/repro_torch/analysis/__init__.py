"""rc3e-check over the port: static + dynamic enforcement of RC3E's
resource discipline.

Static half (``python -m repro_torch.analysis src/repro_torch``): four
AST/dataflow passes — ownership (acquire/release pairing), hostsync
(device syncs reachable from the per-token loop, torch's markers),
determinism (wall clocks, unseeded RNG, set iteration), kernels (the CUDA
wrappers' hygiene + the registry's and the tuner's executed shape checks).
Dynamic half: the ``RC3E_SANITIZE=1`` lifecycle sanitizer in
:mod:`repro_torch.analysis.lifecycle`.

This ``__init__`` stays import-light (lifecycle only — stdlib) because
the runtime imports the sanitizer on every start; the analyzer passes
load only under ``python -m repro_torch.analysis``.
"""
from repro_torch.analysis.lifecycle import (LifecycleViolation, Sanitizer,
                                            sanitizer)

__all__ = ["LifecycleViolation", "Sanitizer", "sanitizer"]
