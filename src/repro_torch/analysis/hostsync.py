"""Hot-path host-sync pass, with torch's markers.

``BatchingEngine.step()`` is the per-token loop: everything it reaches
runs once per decoded token for every active slot. A device->host sync
there (``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``, a blocking
``.to("cpu")``, ``np.asarray`` of a tensor, ``float()`` of a device value,
``torch.cuda.synchronize()``) stalls the card's queue per token, and breaks
CUDA-graph capture of the step; a host->device re-upload of host state
(``torch.from_numpy(x).to(dev)``, ``torch.as_tensor(x, device=...)``)
copies per token. The paper's monitoring loop (§V) is explicitly off the
data path for the same reason.

The pass computes the set of functions reachable from
``BatchingEngine.step`` (conservative name-based call graph) and flags
every sync marker inside them. Justified sites carry
``# rc3e: allow-host-sync`` with a reason; merely grandfathered ones live
in the committed baseline.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.common import (Finding, Workspace, call_name,
                                         dotted_call)

PASS = "hostsync"
RULE = "host-sync"
HOT_ROOT = "BatchingEngine.step"

# numpy module aliases whose .asarray/.array force a device download
NUMPY_NAMES = {"np", "numpy"}
# calls that build a tensor from host data (an upload when given a device)
HOST_TENSOR_CALLS = {"from_numpy", "as_tensor", "tensor"}


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return isinstance(node, ast.Call) and call_name(node) == "device" \
        and bool(node.args) and _is_cpu(node.args[0])


def _device_arg(node: ast.Call):
    """The device a ``.to(...)`` / tensor constructor names, if any."""
    for kw in node.keywords:
        if kw.arg == "device":
            return kw.value
    return None


def _marker(node: ast.Call) -> str:
    """Classify a call as a sync marker; '' if benign."""
    name = call_name(node)
    f = node.func
    if isinstance(f, ast.Attribute):
        base = f.value
        if name in {"asarray", "array"} and isinstance(base, ast.Name) \
                and base.id in NUMPY_NAMES:
            return f"np.{name}() forces a device->host download"
        if name == "item":
            return ".item() blocks on the device and downloads a scalar"
        if name == "cpu":
            return ".cpu() blocks on the device and downloads the tensor"
        if name == "numpy":
            return ".numpy() needs a host tensor (a download before it)"
        if name == "tolist" and not isinstance(base, ast.Constant):
            return ".tolist() downloads the whole array"
        if name == "synchronize" and dotted_call(node).endswith(
                "cuda.synchronize"):
            return "torch.cuda.synchronize() stalls until the card drains"
        if name == "to":
            dev = node.args[0] if node.args else _device_arg(node)
            if dev is not None and _is_cpu(dev):
                return '.to("cpu") blocks on the device and downloads'
            if dev is not None and isinstance(base, ast.Call) \
                    and call_name(base) in HOST_TENSOR_CALLS:
                return (f"{call_name(base)}(...).to(device) re-uploads host "
                        "state to the device every step")
        if name in {"as_tensor", "tensor"} and _device_arg(node) is not None \
                and not _is_cpu(_device_arg(node)):
            return (f"torch.{name}(..., device=...) re-uploads host state to "
                    "the device every step")
    if isinstance(f, ast.Name) and name == "float" and node.args \
            and not isinstance(node.args[0], ast.Constant):
        return "float() of a device value blocks and downloads it"
    return ""


def run(ws: Workspace) -> List[Finding]:
    hot = ws.reachable_from(HOT_ROOT)
    out: List[Finding] = []
    for mod in ws.modules:
        for fi in mod.functions:
            if f"{mod.rel}::{fi.qualname}" not in hot:
                continue
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                why = _marker(node)
                if not why:
                    continue
                if mod.allows(node.lineno, RULE, fi.node):
                    continue
                out.append(Finding(
                    PASS, RULE, mod.rel, node.lineno, fi.qualname,
                    f"{dotted_call(node) or call_name(node)}() in the "
                    f"per-token hot path (reachable from {HOT_ROOT}): "
                    f"{why} — hoist it out of the loop, keep the value "
                    "on-device, or justify with `# rc3e: allow-host-sync`"))
    return out
