"""Mamba2 (state-space duality) block: SSD scan over the prompt + single-token
decode.

Follows the minimal-SSD formulation (Dao & Gu 2024). Decode is the pure
recurrence
  state' = exp(dt*A) * state + dt * x ⊗ B ;  y = C · state' + D * x
with a (d_conv-1)-deep buffer of pre-conv inputs for the causal conv.

Shapes (as in the reference): x (B, S, d_model); the SSD runs on xs
(B, S, H, P), dt (B, S, H) fp32, Bm/Cm (B, S, G, N); its state is
(B, H, P, N) fp32.

The prompt's SSD goes through ``kernels.ops.ssd``: the hand-written CUDA
kernel on a CUDA tensor, its plain sequential version on a CPU tensor.
``kernel_force="ref"`` selects ``ssd_scan``, the reference's chunked einsum
form, on any device; so does a forward that records an autograd graph
(training), since the kernel defines no backward (nor does the reference's,
which trains on its own ``jnp`` scan). Caches are filled and updated IN PLACE.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops
from repro_torch.layers.attention import _plain   # the kernel_force check
from repro_torch.layers.norms import rms_norm
from repro_torch.placement import P, _div, constrain, dp_spec_for, local_region


@dataclasses.dataclass(frozen=True)
class SSMOpts:
    d_model: int
    cfg: SSMConfig
    kernel_force: str = ""       # "" = kernel on CUDA | "ref" = chunked einsum
                                 # | "kernel" = kernel, or raise
    tp: bool = False             # tensor-parallel hints (cfg.tp_mode "tp")

    @property
    def d_inner(self) -> int:
        return self.cfg.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.cfg.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.cfg.n_groups * self.cfg.d_state


def init_ssm(generator: torch.Generator, opts: SSMOpts, dtype=torch.float32,
             device=None):
    """The reference's init distributions. ``A_log``, ``dt_bias`` and ``D``
    are float32 whatever ``dtype`` is, as in the reference."""
    c = opts.cfg
    d, d_in, H = opts.d_model, opts.d_inner, opts.n_heads
    conv_ch = opts.conv_channels
    proj_out = 2 * d_in + 2 * c.n_groups * c.d_state + H

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=dtype) * scale
        return w.to(device)

    lo, hi = c.a_init_range
    u = torch.rand((H,), generator=generator, device=generator.device,
                   dtype=torch.float32)
    log_a = math.log(lo) + u * (math.log(hi) - math.log(lo))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": normal((d, proj_out), d ** -0.5),
        "conv_w": normal((c.d_conv, conv_ch), 0.1),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((H,), **f32),
        "A_log": log_a.to(device),
        "D": torch.ones((H,), **f32),
        "norm": torch.zeros((d_in,), dtype=dtype, device=device),
        "out_proj": normal((d_in, d), d_in ** -0.5),
    }


def _shard_tail(t, tail_axis_from_end: int):
    """The reference's hint: a (B, S, ...) ssm tensor with batch over dp
    and the channel/head dim (``tail_axis_from_end`` from the right) over
    "model". No-op on a plain tensor."""
    spec_tail = [None] * (t.ndim - 1)
    spec_tail[-tail_axis_from_end] = "model"
    return constrain(t, P(dp_spec_for(t, t.shape[0]), *spec_tail))


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B,S,C), w (K,C). Returns (B,S,C),
    contiguous. On DTensors a local region over channel shards (a
    depthwise conv is channel-local): DTensor has no rule for the grouped
    conv of sharded channels."""
    if isinstance(x, DTensor):
        dp = dp_spec_for(x, x.shape[0])
        return local_region(
            _causal_conv_local, x.device_mesh,
            in_specs=(P(dp, None, "model"), P(None, "model"), P("model")),
            out_specs=P(dp, None, "model"))(x, w, b)
    return _causal_conv_local(x, w, b)


def _causal_conv_local(x, w, b):
    K, C = w.shape
    xt = F.pad(x.transpose(1, 2), (K - 1, 0))
    out = F.conv1d(xt, w.t()[:, None, :].to(x.dtype), groups=C)
    return (out.transpose(1, 2) + b.to(x.dtype)).contiguous()


def _split_proj(zxbcdt, opts: SSMOpts):
    c, d_in, H = opts.cfg, opts.d_inner, opts.n_heads
    gn = c.n_groups * c.d_state
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in: d_in + d_in + 2 * gn]
    dt = zxbcdt[..., -H:]
    return z, xbc, dt


def _split_xbc(xbc, opts: SSMOpts):
    """Views of (B, S, C) as xs (B,S,H,P), Bm/Cm (B,S,G,N)."""
    c, d_in = opts.cfg, opts.d_inner
    gn = c.n_groups * c.d_state
    B, S = xbc.shape[0], xbc.shape[1]
    xs = xbc[..., :d_in].reshape(B, S, opts.n_heads, c.head_dim)
    Bm = xbc[..., d_in: d_in + gn].reshape(B, S, c.n_groups, c.d_state)
    Cm = xbc[..., d_in + gn:].reshape(B, S, c.n_groups, c.d_state)
    return xs, Bm, Cm


def ssd_scan(xs, dt, A, Bm, Cm, D, chunk: int, init_state=None):
    """Chunked SSD (the reference's einsum form). xs (B,S,H,P), dt (B,S,H),
    A (H,), Bm/Cm (B,S,G,N), D (H,).

    Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    Bsz, S, H, P = xs.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Q = min(chunk, S)
    orig_S = S
    if S % Q:
        # pad with dt=0 steps: dA=exp(0)=1 keeps state, dtx=0 adds nothing
        pad = Q - S % Q
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=xs.device)
             if init_state is None else init_state.float())
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xs.device))
    ys = []
    for ci in range(nc):
        sl = slice(ci * Q, (ci + 1) * Q)
        xq, dtq, Bq, Cq = xs[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        dA = dtq.float() * A                              # (B,Q,H), negative
        cums = torch.cumsum(dA, dim=1)                    # (B,Q,H)
        seg = cums[:, :, None, :] - cums[:, None, :, :]   # (B,Qi,Qj,H)
        # mask BEFORE exp: the upper triangle of seg is positive (dA < 0)
        # and exp of it overflows
        seg = seg.masked_fill(~tri[None, :, :, None], float("-inf"))
        L = torch.exp(seg)
        CB = torch.einsum("bqgn,bkgn->bqkg", Cq.float(), Bq.float())
        M = CB.repeat_interleave(hpg, dim=-1) * L         # (B,Q,Q,H)
        dtx = (xq * dtq[..., None]).float()               # (B,Q,H,P)
        y_intra = torch.einsum("bqkh,bkhp->bqhp", M, dtx)
        decay_in = torch.exp(cums)                        # (B,Q,H)
        Ch = Cq.repeat_interleave(hpg, dim=2)             # (B,Q,H,N)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", Ch.float(),
                               state) * decay_in[..., None]
        total = cums[:, -1]                               # (B,H)
        decay_out = torch.exp(total[:, None] - cums)      # (B,Q,H)
        Bh = Bq.repeat_interleave(hpg, dim=2)             # (B,Q,H,N)
        contrib = torch.einsum("bqhn,bqhp->bhpn",
                               (Bh * decay_out[..., None]).float(), dtx)
        state = state * torch.exp(total)[:, :, None, None] + contrib
        y = y_intra + y_inter + D[None, None, :, None] * xq.float()
        ys.append(y.to(xs.dtype))
    y = torch.cat(ys, dim=1)[:, :orig_S]
    return y, state


def _ssd(xs, dt, A, Bm, Cm, D, init_state, chunk: int):
    """``ops.ssd``; on DTensors a local region over (batch over the dp
    axes, heads over "model" where they divide and one group serves all
    heads), so the kernel sees local shards."""
    if not isinstance(xs, DTensor):
        return ops.ssd(xs, dt, A, Bm, Cm, D, init_state=init_state,
                       chunk=chunk)
    mesh = xs.device_mesh
    dp = dp_spec_for(xs, xs.shape[0])
    hm = "model" if Bm.shape[2] == 1 and _div(xs.shape[2], mesh) else None
    return local_region(
        lambda x_, dt_, A_, B_, C_, D_, s_: ops.ssd(
            x_, dt_, A_, B_, C_, D_, init_state=s_, chunk=chunk), mesh,
        in_specs=(P(dp, None, hm, None), P(dp, None, hm), P(hm),
                  P(dp, None, None, None), P(dp, None, None, None), P(hm),
                  None if init_state is None else P(dp, hm, None, None)),
        out_specs=(P(dp, None, hm, None), P(dp, hm, None, None)))(
            xs, dt, A, Bm, Cm, D, init_state)


def ssm_forward(p, x, opts: SSMOpts, init_state=None):
    """Full-sequence Mamba2 block. Returns (y, (ssd_state, conv_tail)):
    the conv tail is the last d_conv-1 rows of the pre-conv, pre-SiLU xbc,
    the decode cache's conv buffer."""
    # a forward that records a graph takes the chunked einsum form on every
    # device: the kernel defines no backward (as attention's rule)
    plain = _plain(opts) or (torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in p.values())))
    if not plain:
        _plain(opts, x)                 # "kernel" off the card raises
    Bsz, S, d = x.shape
    c = opts.cfg
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = _split_proj(zxbcdt, opts)
    conv_tail = xbc[:, -(c.d_conv - 1):, :]
    if opts.tp:
        xbc = _shard_tail(xbc, 1)                    # channels over model
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    if opts.tp:
        xbc = _shard_tail(xbc, 1)
    xs, Bm, Cm = _split_xbc(xbc, opts)
    if opts.tp:
        xs = _shard_tail(xs, 2)                      # ssd heads over model
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if plain:
        y, state = ssd_scan(xs, dt, A, Bm, Cm, p["D"], c.chunk, init_state)
    else:
        y, state = _ssd(xs, dt, A, Bm, Cm, p["D"], init_state, c.chunk)
    y = y.reshape(Bsz, S, opts.d_inner)
    y = rms_norm(y * F.silu(z), p["norm"], plus_one=False)
    out = y @ p["out_proj"].to(x.dtype)
    return out, (state, conv_tail)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_ssm_cache(batch: int, opts: SSMOpts, dtype, device=None):
    c = opts.cfg
    return {
        "state": torch.zeros((batch, opts.n_heads, c.head_dim, c.d_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, c.d_conv - 1, opts.conv_channels),
                            dtype=dtype, device=device),
    }


def fill_ssm_cache(cache, state, conv_tail) -> None:
    """Write a prompt's final SSD state and conv tail into ``cache`` (a
    layer's view of the stacked cache), in place.

    A prompt shorter than d_conv-1 tokens leaves a conv tail shorter than
    the buffer. The reference then fails inside its first decode step (the
    window no longer matches the (d_conv, C) conv weight); here it is
    refused up front."""
    need = cache["conv"].shape[1]
    if conv_tail.shape[1] < need:
        raise ValueError(
            f"SSM decode needs a prompt of at least d_conv-1 = {need} "
            f"tokens, got {conv_tail.shape[1]} (the reference has no "
            "padding for shorter prompts)")
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_tail)


def ssm_decode(p, x, cache, opts: SSMOpts):
    """x (B,1,d). Returns (y (B,1,d), cache), the cache updated in place."""
    Bsz = x.shape[0]
    c = opts.cfg
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc_t, dt = _split_proj(zxbcdt, opts)          # xbc_t (B,1,C)
    window = torch.cat([cache["conv"], xbc_t], dim=1)  # (B,K,C)
    cache["conv"].copy_(window[:, 1:, :])
    w = p["conv_w"].to(x.dtype)                        # (K,C)
    conv_out = torch.einsum("bkc,kc->bc", window, w) + p["conv_b"].to(x.dtype)
    xbc = F.silu(conv_out)[:, None, :]                 # (B,1,C)
    xs, Bm, Cm = _split_xbc(xbc, opts)                 # (B,1,H,P),(B,1,G,N)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]  # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                             # (B,H)
    hpg = opts.n_heads // c.n_groups
    Bh = Bm[:, 0].repeat_interleave(hpg, dim=1)        # (B,H,N)
    Ch = Cm[:, 0].repeat_interleave(hpg, dim=1)
    dtx = (xs[:, 0] * dt[..., None]).float()          # (B,H,P)
    state = (cache["state"] * dA[:, :, None, None]
             + torch.einsum("bhp,bhn->bhpn", dtx, Bh.float()))
    cache["state"].copy_(state)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.float())
    y = y + p["D"][None, :, None] * xs[:, 0].float()
    y = y.reshape(Bsz, 1, opts.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], plus_one=False)
    out = y @ p["out_proj"].to(x.dtype)
    return out, cache
