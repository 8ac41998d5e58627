"""Runtime lifecycle sanitizer (copied from ``repro.analysis.lifecycle``;
the AST lint passes are not ported yet)."""
from repro_torch.analysis.lifecycle import (LifecycleViolation, Sanitizer,
                                            sanitizer)

__all__ = ["LifecycleViolation", "Sanitizer", "sanitizer"]
