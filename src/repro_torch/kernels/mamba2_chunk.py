"""Mamba2 SSD scan (state-space duality):

    state_t = exp(dt_t * a) * state_{t-1} + (dt_t * x_t) (outer) B_t
    y_t     = C_t . state_t + d * x_t

with an fp32 state and y in x's dtype.

Replaces the Pallas kernel ``repro.kernels.mamba2_chunk.ssd_chunk_scan``
with a hand-written CUDA kernel (``csrc/ssd_chunk_scan.cu``). Beside it, the
plain PyTorch version (the sequential recurrence of
``repro.kernels.ref.ssd_chunk_scan_ref``) serves CPU tensors and is what the
kernel is held against.

Two layouts, one kernel:

* the layer's (``ssd_cuda`` / ``ssd_ref``): xs (B, S, H, P), dt (B, S, H)
  fp32, Bm/Cm (B, S, G, N) with H/G heads sharing a group, A/D (H,) fp32,
  an optional init state (B, H, P, N) fp32. Returns y (B, S, H, P) and the
  final state (B, H, P, N) fp32. xs, Bm and Cm may be strided views whose
  last dim is contiguous and whose rows start on 16 bytes (the layer passes
  slices of its activation, which always do).
* the reference's (``ssd_chunk_scan_cuda`` / ``ssd_chunk_scan_ref``): x
  (BH, S, P), dt (BH, S), Bm/Cm (BH, S, N), a/d (BH,); y (BH, S, P). It is
  the layer's case with one sequence of BH heads, one group per head.

The kernel runs the chunked form on the tensor cores (see the source's
note): ``ssd_plan`` picks its chunk length and block shape, and
``ssd_chunked_ref`` is the plain model of its passes, with the kernel's
TF32 hi/lo splits emulated, that the CPU tests hold against the JAX
package.

``chunk`` is accepted for signature parity with the Pallas kernel; the
kernel's chunk is its own (``SSD_CHUNK``) and the result does not depend on
either but for fp32 rounding. Any S works. Inference only: there is no
backward.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _lib

STATE_DIMS = (16, 64, 128)     # the configs' d_state: reduced, zamba2, mamba2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SSD_CHUNK = 32                 # steps a chunk (csrc: kChunk)


class SsdPlan(NamedTuple):
    """How the kernel cuts a scan: chunks of ``q`` steps (``n_chunks``);
    a block holds 16 * ``wp`` state rows (``wp`` warps along P) of one
    (sequence, head), each warp N / ``ns`` state columns (``ns`` warps
    along N); ``p_blocks`` blocks cover P."""
    q: int
    n_chunks: int
    wp: int
    ns: int
    p_blocks: int


def ssd_plan(B: int, S: int, H: int, P: int, N: int, sms: int) -> SsdPlan:
    """64-row blocks (4 x 2 warps) where the (sequence, head) pairs give at
    least half as many blocks as SMs; else 16-row blocks (1 x 8 warps, 1 x
    2 at N 16), four times as many."""
    q = SSD_CHUNK
    if B * H * -(-P // 64) * 2 >= sms:
        wp, ns = 4, 2
    else:
        wp, ns = 1, (8 if N >= 64 else 2)
    return SsdPlan(q, max(1, -(-S // q)), wp, ns, -(-P // (16 * wp)))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def ssd_ref(xs, dt, A, Bm, Cm, D, init_state=None):
    """The sequential recurrence in the layer's layout. Returns (y in xs's
    dtype, final state fp32)."""
    Bsz, S, H, P = xs.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    x32 = xs.float()
    dt32 = dt.float()
    Bh = Bm.float().repeat_interleave(hpg, dim=2)        # (B, S, H, N)
    Ch = Cm.float().repeat_interleave(hpg, dim=2)
    A32, D32 = A.float(), D.float()
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=xs.device)
             if init_state is None else init_state.float().clone())
    ys = []
    for t in range(S):
        dA = torch.exp(dt32[:, t] * A32)                 # (B, H)
        dtx = x32[:, t] * dt32[:, t, :, None]            # (B, H, P)
        state = state * dA[:, :, None, None] \
            + dtx[..., None] * Bh[:, t, :, None, :]
        y = torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]) \
            + D32[None, :, None] * x32[:, t]
        ys.append(y)
    if ys:
        y = torch.stack(ys, dim=1)
    else:
        y = torch.zeros((Bsz, 0, H, P), dtype=torch.float32,
                        device=xs.device)
    return y.to(xs.dtype), state


def _tf32(v):
    """v rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds: half an ulp of TF32 added to the
    bits, then the 13 low mantissa bits masked off."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, a_exact: bool, b_exact: bool):
    """a @ b (fp32) as the kernel's tensor-core products: each operand that
    is not exact in TF32 is split into hi + lo, and the terms lo*hi, hi*lo,
    hi*hi (those that exist) are summed in fp32."""
    ah = a if a_exact else _tf32(a)
    bh = b if b_exact else _tf32(b)
    out = torch.matmul(ah, bh)
    if not a_exact:
        out = out + torch.matmul(_tf32(a - ah), bh)
    if not b_exact:
        out = out + torch.matmul(ah, _tf32(b - bh))
    return out


def ssd_chunked_ref(xs, dt, A, Bm, Cm, D, init_state=None, *, q=None):
    """The CUDA kernel's passes in plain PyTorch, in the layer's layout
    (arguments and results as ``ssd_ref``): per chunk of ``q`` steps (the
    kernel's ``SSD_CHUNK`` by default) C B^T once per group, the decay
    vectors per head, then y^T = state . C^T scaled by exp(cums),
    + x^T . M^T with M = C B^T o L o dt_j, and state = exp(total) state +
    (x o w)^T . B, with every fp32 operand split hi/lo in TF32 as the kernel
    splits it (bf16 x, B, C are exact)."""
    Bsz, S, H, P = xs.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    q = q or SSD_CHUNK
    exact = xs.dtype == torch.bfloat16
    nc = max(1, -(-S // q))
    pad = nc * q - S
    F = torch.nn.functional
    x32 = F.pad(xs.float(), (0, 0, 0, 0, 0, pad))            # (B, S', H, P)
    dt32 = F.pad(dt.float(), (0, 0, 0, pad))                 # (B, S', H)
    B32 = F.pad(Bm.float(), (0, 0, 0, 0, 0, pad))            # (B, S', G, N)
    C32 = F.pad(Cm.float(), (0, 0, 0, 0, 0, pad))
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=xs.device)
             if init_state is None else init_state.float().clone())
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xs.device))
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        xq = x32[:, sl].permute(0, 2, 1, 3)                  # (B, H, Q, P)
        dq = dt32[:, sl].permute(0, 2, 1)                    # (B, H, Q)
        Bq = B32[:, sl].permute(0, 2, 1, 3)                  # (B, G, Q, N)
        Cq = C32[:, sl].permute(0, 2, 1, 3)
        # pass 1: C B^T a group; the heads' cums, w, exp(cums)
        cb = _mm_tf32(Cq, Bq.transpose(-1, -2), exact, exact)
        cb = cb.repeat_interleave(hpg, dim=1)                # (B, H, Q, Q)
        cums = torch.cumsum(dq * A.float()[None, :, None], dim=-1)
        total = cums[..., -1:]
        w = dq * torch.exp(total - cums)
        seg = (cums[..., :, None] - cums[..., None, :]).masked_fill(
            ~tri, float("-inf"))
        m = cb * torch.exp(seg) * dq[..., None, :]           # (B, H, Qi, Qj)
        # pass 2
        Ch = Cq.repeat_interleave(hpg, dim=1)                # (B, H, Q, N)
        Bh = Bq.repeat_interleave(hpg, dim=1)
        y = _mm_tf32(Ch, state.transpose(-1, -2), exact, False) \
            * torch.exp(cums)[..., None]
        y = y + _mm_tf32(m, xq, False, exact)
        state = state * torch.exp(total)[..., None] + _mm_tf32(
            (xq * w[..., None]).transpose(-1, -2), Bh, False, exact)
        y = y + D.float()[None, :, None, None] * xq
        ys.append(y.permute(0, 2, 1, 3))
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(xs.dtype), state


def _as_layer(x, dt, Bm, Cm):
    """(BH, S, ...) reference operands as views of one sequence of BH heads,
    one group per head."""
    return (x.transpose(0, 1)[None], dt.transpose(0, 1)[None],
            Bm.transpose(0, 1)[None], Cm.transpose(0, 1)[None])


def ssd_chunk_scan_ref(x, dt, Bm, Cm, a, d):
    """x (BH, S, P); dt (BH, S); Bm/Cm (BH, S, N); a/d (BH,). Returns y
    (BH, S, P) in x's dtype."""
    xs, dtl, Bl, Cl = _as_layer(x, dt, Bm, Cm)
    y, _ = ssd_ref(xs, dtl, a, Bl, Cl, d)
    return y[0].transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``SsdArgs`` in csrc/ssd_chunk_scan.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "dt", "bm", "cm", "a", "d", "init_state", "y", "state_out",
        "cb_ws", "vec_ws")] + [
        (n, ctypes.c_longlong) for n in (
            "x_sb", "x_ss", "x_sh", "dt_sb", "dt_ss", "dt_sh",
            "b_sb", "b_ss", "b_sg", "c_sb", "c_ss", "c_sg",
            "y_sb", "y_ss", "y_sh", "is_sb", "is_sh", "so_sb", "so_sh")] + [
        (n, ctypes.c_int) for n in ("B", "S", "H", "G", "P", "N", "q", "wp",
                                    "ns", "dtype")]


def _check(name, xs, dt, A, Bm, Cm, D, init_state):
    if xs.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{xs.device}")
    ts = [xs, dt, A, Bm, Cm, D] + ([] if init_state is None
                                   else [init_state])
    for t in ts:
        if t.device != xs.device:
            raise ValueError(f"{name}: all tensors must be on {xs.device}")
        if t.requires_grad:
            raise ValueError(f"{name}: inference kernel, no backward")
    if xs.dtype not in _DTYPES or Bm.dtype != xs.dtype \
            or Cm.dtype != xs.dtype:
        raise TypeError(f"{name}: x/B/C dtypes {xs.dtype}/{Bm.dtype}/"
                        f"{Cm.dtype} (all float32 or all bfloat16)")
    for t, what in ((dt, "dt"), (A, "A"), (D, "D")) + (
            () if init_state is None else ((init_state, "init_state"),)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
    if xs.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError(f"{name}: expected xs (B,S,H,P), dt (B,S,H), "
                         "Bm/Cm (B,S,G,N)")
    Bsz, S, H, P = xs.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(Bm.shape) != (Bsz, S, G, N) \
            or tuple(Cm.shape) != (Bsz, S, G, N) \
            or tuple(A.shape) != (H,) or tuple(D.shape) != (H,):
        raise ValueError(f"{name}: shapes xs {tuple(xs.shape)}, dt "
                         f"{tuple(dt.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)} do not agree")
    if G == 0 or H % G:
        raise ValueError(f"{name}: {H} heads do not divide into {G} groups")
    if N not in STATE_DIMS:
        raise ValueError(f"{name}: state dim {N} (kernel takes "
                         f"{STATE_DIMS})")
    if xs.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError(f"{name}: x, B and C need a contiguous last dim")
    if P * xs.element_size() % 16:
        raise ValueError(f"{name}: head dim {P} (the kernel copies 16-byte "
                         f"rows: a multiple of {16 // xs.element_size()})")
    for t, what in ((xs, "x"), (Bm, "B"), (Cm, "C")):
        _lib.check_rows_aligned(name, what, t)   # 16-byte cp.async rows
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError(f"{name}: A and D must be contiguous")
    if init_state is not None and (
            tuple(init_state.shape) != (Bsz, H, P, N)
            or init_state.stride(-1) != 1 or init_state.stride(-2) != N):
        raise ValueError(f"{name}: init_state must be ({Bsz}, {H}, {P}, "
                         f"{N}) with contiguous (P, N) rows")
    if Bsz * H > 65535:
        raise ValueError(f"{name}: B*H = {Bsz * H} exceeds the grid")


def _launch(xs, dt, A, Bm, Cm, D, init_state, y, y_strides, state):
    """One call (two kernels, counted as one launch); y (and state, if
    given) are written in place. The plan is left in ``_lib.last_plan``."""
    name = "ssd_chunk_scan"
    Bsz, S, H, P = xs.shape
    G, N = Bm.shape[2], Bm.shape[3]
    ist = init_state
    sms = torch.cuda.get_device_properties(xs.device).multi_processor_count
    plan = ssd_plan(Bsz, S, H, P, N, sms)
    cb_ws = torch.empty((Bsz, plan.n_chunks, G, plan.q, plan.q),
                        dtype=torch.float32, device=xs.device)
    vec_ws = torch.empty((Bsz, plan.n_chunks, H, 4, plan.q),
                         dtype=torch.float32, device=xs.device)
    a = _Args(
        x=xs.data_ptr(), dt=dt.data_ptr(), bm=Bm.data_ptr(),
        cm=Cm.data_ptr(), a=A.data_ptr(), d=D.data_ptr(),
        init_state=None if ist is None else ist.data_ptr(),
        y=y.data_ptr(), state_out=None if state is None else state.data_ptr(),
        cb_ws=cb_ws.data_ptr(), vec_ws=vec_ws.data_ptr(),
        x_sb=xs.stride(0), x_ss=xs.stride(1), x_sh=xs.stride(2),
        dt_sb=dt.stride(0), dt_ss=dt.stride(1), dt_sh=dt.stride(2),
        b_sb=Bm.stride(0), b_ss=Bm.stride(1), b_sg=Bm.stride(2),
        c_sb=Cm.stride(0), c_ss=Cm.stride(1), c_sg=Cm.stride(2),
        y_sb=y_strides[0], y_ss=y_strides[1], y_sh=y_strides[2],
        is_sb=0 if ist is None else ist.stride(0),
        is_sh=0 if ist is None else ist.stride(1),
        so_sb=0 if state is None else state.stride(0),
        so_sh=0 if state is None else state.stride(1),
        B=Bsz, S=S, H=H, G=G, P=P, N=N, q=plan.q, wp=plan.wp, ns=plan.ns,
        dtype=_DTYPES[xs.dtype])
    lib = _lib.library(name)
    fn = lib.rt_ssd_chunk_scan
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(a), torch.cuda.current_stream(xs.device).cuda_stream)
    _lib.check(rc, lib, name)
    _lib.launches[name] += 1
    _lib.last_plan[name] = plan


def ssd_cuda(xs, dt, A, Bm, Cm, D, init_state=None, *, chunk: int = 256):
    """The CUDA kernel in the layer's layout; arguments and results as
    ``ssd_ref``. One launch computes y and the final state."""
    del chunk                        # the result does not depend on it
    _check("ssd_chunk_scan", xs, dt, A, Bm, Cm, D, init_state)
    Bsz, S, H, P = xs.shape
    N = Bm.shape[3]
    y = torch.empty((Bsz, S, H, P), dtype=xs.dtype, device=xs.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32,
                        device=xs.device)
    if Bsz == 0 or H == 0 or P == 0:
        return y, state
    if S == 0:
        return y, (state.zero_() if init_state is None
                   else state.copy_(init_state))
    _launch(xs, dt, A, Bm, Cm, D, init_state, y, y.stride()[:3], state)
    return y, state


def ssd_chunk_scan_cuda(x, dt, Bm, Cm, a, d, *, chunk: int = 256):
    """The CUDA kernel in the reference's (BH, S, P) layout (no state out);
    arguments as ``ssd_chunk_scan_ref``. A bfloat16 dt is widened to
    float32 (the Pallas kernel widens it in VMEM)."""
    del chunk
    if x.dim() != 3 or dt.dim() != 2 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError("ssd_chunk_scan: expected x (BH,S,P), dt (BH,S), "
                         "Bm/Cm (BH,S,N)")
    BH, S, P = x.shape
    xs, dtl, Bl, Cl = _as_layer(x, dt.float(), Bm, Cm)
    _check("ssd_chunk_scan", xs, dtl, a, Bl, Cl, d, None)
    y = torch.empty((BH, S, P), dtype=x.dtype, device=x.device)
    if BH and S and P:
        # y[bh, s, p] as (B=1, S, H=BH, P): strides (0, P, S*P)
        _launch(xs, dtl, a, Bl, Cl, d, None, y, (0, P, S * P), None)
    return y
