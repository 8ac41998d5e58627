"""Per-device cost analysis over the dispatched op stream (the counterpart
of the reference's loop-aware HLO analyzer, ``launch/hlo_analysis.py``).

The reference parses post-SPMD HLO text and has to multiply while-loop
bodies by their trip counts. Here ``analyze(fn, *args, world=...)`` runs
``fn`` under a ``TorchDispatchMode`` and counts every op as it is
dispatched, so a Python loop of seven layers is counted seven times by
construction (and a backward pass run inside ``fn`` is counted too):

  flops             — matmul / bmm / addmm / baddbmm and convolution
                      FLOPs (2·M·N·K), per device
  dot_bytes         — Σ operand+result bytes of those ops, per device (an
                      un-fused upper bound on their HBM traffic)
  score_bytes       — the part of dot_bytes in attention-score-shaped
                      tensors (what a flash kernel keeps on chip): a
                      rank≥3 product whose result is ≥2× both operands, or
                      whose lhs is ≥2× the rest, at ≥16 MiB, as the
                      reference detects them
  collective_bytes  — per-device *wire* bytes under ring algorithms, over
                      each collective's group size n:
                        all-reduce        2·B·(n-1)/n
                        all-gather        O·(n-1)/n   (O = gathered output)
                        reduce-scatter    o·(n-1)     (o = scattered output)
                        all-to-all        B·(n-1)/n
  per-op collective breakdown and count.

Per device, not global: the mode sees a DTensor op with GLOBAL shapes
(DTensor dispatches its local op below the mode). A global op whose
output is ``Shard`` or ``Partial`` over mesh dims of total size k costs
1/k of its global count on each device (each device computes its piece);
a replicated output is computed whole on every device. Operand and
result bytes are the local tensors'. The collectives DTensor issues
(``_c10d_functional.*``) reach the mode with their local tensors.

A live-bytes tracker rides along (``Costs.peak_live_bytes``): each op
output that is not an alias adds its local bytes and gives them back when
the tensor dies (``weakref.finalize``). On meta tensors a kernel's plain
version stands in for the kernel (``kernels.ops``): its products are
counted, but only its outputs are live bytes — the kernel keeps its
score matrices and partial sums on chip.

``cpu_dus_legalization_bytes`` has no counterpart: it corrects XLA-CPU's
float legalisation of bf16 dynamic-update-slice, and no such legalisation
happens here.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

_SCORE_MIN = 1 << 24


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    dot_bytes: float = 0.0
    collective_bytes: float = 0.0
    score_bytes: float = 0.0   # traffic of attention-score-shaped tensors
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_count: int = 0
    peak_live_bytes: float = 0.0

    def scaled(self, k: float) -> "Costs":
        c = Costs(self.flops * k, self.dot_bytes * k,
                  self.collective_bytes * k, self.score_bytes * k)
        c.collectives = defaultdict(
            float, {op: v * k for op, v in self.collectives.items()})
        c.collective_count = int(self.collective_count * k)
        return c


def local_bytes(t) -> int:
    """Bytes of ``t`` on one device (a DTensor's local shard)."""
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


def _split_factor(t) -> int:
    """Product of the mesh dim sizes over which a DTensor is Shard or
    Partial: the number of devices its global value is split across."""
    if not isinstance(t, DTensor):
        return 1
    k = 1
    for i, p in enumerate(t.placements):
        if p.is_shard() or p.is_partial():
            k *= t.device_mesh.size(i)
    return k


_MM = {"aten.mm.default", "aten.bmm.default", "aten.addmm.default",
       "aten.baddbmm.default"}
_CONV = {"aten.convolution.default", "aten.convolution_backward.default"}


def _mm_cost(name, args, out):
    a, b = (args[1], args[2]) if name.startswith(("aten.addmm",
                                                  "aten.baddbmm")) \
        else (args[0], args[1])
    flops = 2.0 * out.numel() * a.shape[-1]
    k = _split_factor(out)
    la, lb, lo = local_bytes(a), local_bytes(b), local_bytes(out)
    score = 0.0
    if out.ndim >= 3 and lo >= 2 * (la + lb) and lo >= _SCORE_MIN:
        score += lo
    if a.ndim >= 3 and la >= 2 * (lb + lo) and la >= _SCORE_MIN:
        score += la
    return flops / k, float(la + lb + lo), score


def _conv_cost(name, args, out):
    if name == "aten.convolution_backward.default":
        # (grad_output, input, weight, bias_sizes, stride, padding,
        #  dilation, transposed, output_padding, groups, output_mask)
        grad_out, x, w = args[0], args[1], args[2]
        ksize = math.prod(w.shape[2:])
        per = 2.0 * grad_out.numel() * ksize * (w.shape[1])
        mask = args[10] if len(args) > 10 else (True, True, True)
        n = sum(1 for m in mask[:2] if m)
        outs = [o for o in out if isinstance(o, torch.Tensor)]
        nbytes = local_bytes(grad_out) + local_bytes(x) + local_bytes(w) \
            + sum(local_bytes(o) for o in outs)
        return per * n / _split_factor(grad_out), float(nbytes)
    x, w = args[0], args[1]
    ksize = math.prod(w.shape[2:])
    flops = 2.0 * out.numel() * ksize * w.shape[1]   # w: (Cout, Cin/g, k)
    return flops / _split_factor(out), float(local_bytes(x) + local_bytes(w)
                                             + local_bytes(out))


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _collective(name, args, out):
    """(kind, wire bytes) of a functional collective, or None."""
    if "all_reduce" in name:
        n = _group_size(args[-1])
        nbytes = local_bytes(args[0])
        return "all-reduce", 2.0 * nbytes * (n - 1) / n, n
    if "all_gather_into_tensor" in name:
        n = int(args[1])
        return "all-gather", local_bytes(args[0]) * n * (n - 1) / n, n
    if "reduce_scatter_tensor" in name:
        n = int(args[2])
        return "reduce-scatter", local_bytes(args[0]) / n * (n - 1), n
    if "all_to_all_single" in name:
        n = _group_size(args[-1])
        return "all-to-all", local_bytes(args[0]) * (n - 1) / n, n
    return None


class _Counter(TorchDispatchMode):
    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs
        self.live = 0.0
        self.in_kernel = 0

    def kernel(self, fn):
        """``fn`` (a kernel wrapper) with its temporaries untracked."""
        def run(*args, **kwargs):
            self.in_kernel += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.in_kernel -= 1
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for o in outs:
                if isinstance(o, torch.Tensor):
                    self._add(o)
            return out
        return run

    def _add(self, o):
        nbytes = float(local_bytes(o))
        self.live += nbytes
        self.costs.peak_live_bytes = max(self.costs.peak_live_bytes,
                                         self.live)
        weakref.finalize(o, self._free, nbytes)

    def _track(self, func, out):
        if self.in_kernel:
            return
        outs = out if isinstance(out, (tuple, list)) else (out,)
        rets = func._schema.returns
        for i, o in enumerate(outs):
            if not isinstance(o, torch.Tensor):
                continue
            if i < len(rets) and rets[i].alias_info is not None:
                continue                     # a view or an in-place result
            self._add(o)

    def _free(self, nbytes):
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        c = self.costs
        if name in _MM:
            f, b, s = _mm_cost(name, args, out)
            c.flops += f
            c.dot_bytes += b
            c.score_bytes += s
        elif name in _CONV:
            f, b = _conv_cost(name, args, out)
            c.flops += f
            c.dot_bytes += b
        elif name.startswith("_c10d_functional."):
            coll = _collective(name, args, out)
            if coll is not None and coll[2] > 1:
                kind, wire, _ = coll
                c.collective_bytes += wire
                c.collectives[kind] += wire
                c.collective_count += 1
        self._track(func, out)
        return out


def analyze(fn, *args, world: int = 1, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the counter; returns (its result,
    ``Costs`` per device). ``world``: the mesh's rank count (the counts
    are already per device; it is kept for the reference's signature)."""
    from repro_torch.kernels import ops
    costs = Costs()
    counter = _Counter(costs)
    saved = {k: getattr(ops, k) for k in _KERNELS}
    for k, f in saved.items():
        setattr(ops, k, counter.kernel(_ssd_model(f, costs) if k == "ssd"
                                       else f))
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        for k, f in saved.items():
            setattr(ops, k, f)
    return out, costs


def _ssd_model(ssd, costs: Costs):
    """``ops.ssd`` that, on meta, counts the CUDA kernel's chunked passes
    by formula instead of running the plain version (a sequential
    recurrence, one Python step a token): per chunk of q steps and head,
    C B^T (q·q·N, once a group), x^T M^T (P·q·q), state C^T (P·N·q) and
    the state update (P·q·N), 2 flops a multiply-add; bytes each input and
    output once."""
    def run(xs, dt, A, Bm, Cm, D, *, init_state=None, chunk=256):
        if xs.device.type != "meta":
            return ssd(xs, dt, A, Bm, Cm, D, init_state=init_state,
                       chunk=chunk)
        from repro_torch.kernels.mamba2_chunk import SSD_CHUNK
        B, S, H, P = xs.shape
        G, N = Bm.shape[2], Bm.shape[3]
        q = SSD_CHUNK
        per_chunk = 2.0 * (G * q * q * N + H * (P * q * q + 2 * P * N * q))
        costs.flops += B * -(-S // q) * per_chunk
        y = torch.empty_like(xs)
        state = torch.empty((B, H, P, N), dtype=torch.float32,
                            device=xs.device)
        costs.dot_bytes += float(sum(local_bytes(t) for t in (
            xs, dt, Bm, Cm, y, state) if t is not None))
        return y, state
    return run


_KERNELS = ("decode_attention", "paged_decode_attention", "flash_attention",
            "ssd", "ssd_chunk_scan", "matmul", "matmul_batched")
