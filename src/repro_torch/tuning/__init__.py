"""Design-space auto-tuner for the serving geometry on Hopper.

``space`` declares the TunedConfig knobs (page size, decode slots,
prefill chunk) and enumerates legal candidates, ``cost_model`` scores each
candidate with an analytical model of the port's host-bound eager step
and the H100's ceilings under hard shared-memory/HBM/divisibility
constraints, and ``explorer`` sweeps the space and persists the winner per
(model fingerprint, device class) in the ProgramCache — so the fleet binds
tuned programs automatically, per device class, with zero operator input.

All of it is pure math — no device, no clock, deterministic across hosts.
"""
from repro_torch.tuning.cost_model import (DeviceProfile, candidate_cost,
                                           profile_for_speed, prune_reason)
from repro_torch.tuning.explorer import (device_class, model_fingerprint,
                                         resolve_tuned, tune)
from repro_torch.tuning.space import (TunedConfig, enumerate_candidates,
                                      legal_reason)

__all__ = [
    "TunedConfig", "enumerate_candidates", "legal_reason",
    "DeviceProfile", "profile_for_speed", "prune_reason", "candidate_cost",
    "tune", "resolve_tuned", "device_class", "model_fingerprint",
]
