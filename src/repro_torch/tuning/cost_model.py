"""Analytical cost model for geometry candidates on an H100.

The reference's model scores a TPU step as a roofline stream plus a small
host cost a Pallas grid step. The port's eager step is host-bound instead:
every device op is issued from Python, at about ``LAUNCH_HOST_S`` each, and
the step's wall is close to that host time plus the device's busy time (a
decode step syncs on its tokens, and the host rarely runs ahead). So the
model keeps the reference's method and its terms, with the port's regime:

  host term        launches a step x ``LAUNCH_HOST_S``: layers x ops a
                   layer (the decode kernel's split and merge launches
                   among them) plus the step's own ops; a paged engine also
                   re-uploads its block tables when a slot grows a page
                   (about ``min(1, slots / page_size)`` uploads a step)
  stream term      max(bytes moved / HBM bandwidth, flops / peak): the
                   parameters once a step, the KV rows each slot sweeps
  grid term        the decode sweep's blocks as ``split_plan`` cuts them on
                   the class's SMs: a last wave that is partly empty stretches
                   the sweep (blocks over whole waves)
  fragmentation    paged pools round each context up to whole pages
                   ((page_size - 1) / 2 rows a slot on average): bigger
                   pages waste bandwidth, smaller ones re-upload the block
                   tables more often; the optimum is class-dependent
  slot term        parameters stream and the host issues its ops once a
                   step regardless of batch, so more slots amortize them;
                   KV bytes stay per slot
  chunk term       async prefill chunking: big chunks stall decode, small
                   chunks delay admission (convex in the chunk)

Hard constraints prune before scoring: the kernels' shared memory a block
against the class's, HBM fit of params + KV pool, and the registry's
rules. All pure math — no device, no clock, deterministic across hosts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL,
                                      MIXER_SHARED_ATTN, ModelConfig)
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.decode_attention import head_chunks, launch_plan
from repro_torch.tuning.space import TunedConfig, legal_reason

# H100 SXM ceilings (kernels/registry.py) — scaled by device speed below.
PEAK_FLOPS = kreg.PEAK_FLOPS          # by dtype, per second
HBM_BW = kreg.HBM_BW                  # bytes/s
HBM_CAP = kreg.HBM_BYTES              # bytes
# Host time a device op of the eager step: smollm-135m's dense bf16 decode
# step at 8 slots took 35.1 ms of wall with 4.95 ms of device busy time
# over 2569 device ops, (35.1 - 4.95) ms / 2569 = 11.7 us (chip_smoke.py's
# profile_dense_decode on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit; PERF.md section 5).
LAUNCH_HOST_S = 11.7e-6
# Device ops of that step: 2569 = 30 layers x (83 + 2 decode launches) +
# 19. The split between a layer's ops and the step's own (embedding, final
# norm, logits, argmax, uploads) is this model's, not a measurement.
OPS_PER_LAYER = 83                    # a layer's ops but decode attention's
DECODE_LAUNCHES = 2                   # split + merge, at every split count
OPS_PER_STEP = 19

_ATTN_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, MIXER_SHARED_ATTN)


@dataclass(frozen=True)
class DeviceProfile:
    """What a device class looks like to the tuner. ``speed`` matches
    ``PhysicalDevice.speed`` (ClusterSpec.device_speeds); the device's
    rates and SMs scale with it, the host's launch cost does not.
    Sub-half-speed classes are cut-down parts with half the HBM (an H100's
    MIG slices, e.g. 3g.40gb) and the same shared memory a block (an SM
    does not shrink)."""
    name: str
    speed: float
    flops: float                     # bf16 tensor cores
    hbm_bw: float
    smem_bytes: int                  # shared memory a block
    hbm_bytes: int
    sm_count: int = kreg.SM_COUNT
    flops_fp32: float = PEAK_FLOPS["float32"]
    launch_host_s: float = LAUNCH_HOST_S

    def peak(self, dtype: str) -> float:
        return self.flops if dtype == "bfloat16" else self.flops_fp32


def profile_for_speed(speed: float, name: str = "") -> DeviceProfile:
    s = max(float(speed), 1e-6)
    small = s < 0.5
    return DeviceProfile(
        name=name or f"c{s:.2f}x",
        speed=s,
        flops=PEAK_FLOPS["bfloat16"] * s,
        hbm_bw=HBM_BW * s,
        smem_bytes=kreg.SMEM_PER_BLOCK,
        hbm_bytes=HBM_CAP // (2 if small else 1),
        sm_count=max(1, round(kreg.SM_COUNT * s)),
        flops_fp32=PEAK_FLOPS["float32"] * s)


@dataclass
class Cost:
    """Modeled serving cost of one candidate on one device class."""
    step_s: float                  # one decode step at the candidate's slots
    us_per_token: float            # amortized service time per decoded token
    pruned: Optional[str] = None   # non-None => candidate violates a hard fit
    terms: Dict[str, float] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Model byte/flop accounting (the reference's, unchanged)
# ---------------------------------------------------------------------------

def _attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for k in cfg.layer_kinds() if k in _ATTN_KINDS)


def kv_bytes_per_pos(cfg: ModelConfig) -> float:
    """KV-cache bytes per cached position, summed over attention layers."""
    if cfg.mla is not None:
        per = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) \
            * kreg.dtype_bytes(cfg.dtype)
    else:
        per = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
        if cfg.kv_quant:
            per = per * 1 + 2 * cfg.n_kv_heads * 4   # int8 + fp32 row scales
        else:
            per *= kreg.dtype_bytes(cfg.dtype)
    return float(per * _attn_layers(cfg))


def _param_bytes(cfg: ModelConfig) -> float:
    return float(cfg.param_count()) * kreg.dtype_bytes(cfg.dtype)


def step_launches(cfg: ModelConfig) -> int:
    """Device ops of one eager decode step: every layer's, the decode
    kernel's split and merge launches at each attention layer (the wrapper
    launches both whatever split ``split_plan`` gives), and the step's
    own."""
    return (cfg.n_layers * OPS_PER_LAYER + _attn_layers(cfg) * DECODE_LAUNCHES
            + OPS_PER_STEP)


def _group_plan(cfg: ModelConfig):
    """The group kernel's plan where the wrapper routes this model's
    decode to it (``registry.decode_route``: bf16, a group past one
    chunk), else None (the chunked split kernel)."""
    g = cfg.n_heads // max(cfg.n_kv_heads, 1)
    if kreg.decode_route(g, cfg.resolved_head_dim, cfg.dtype) != "group":
        return None
    return kreg.decode_group_plan(g, cfg.resolved_head_dim)


def _chunks(cfg: ModelConfig):
    """(query heads a decode split block, blocks a (slot, kv head)) as the
    wrapper launches them: the group kernel's rows and slices, or the
    group's chunks."""
    plan = _group_plan(cfg)
    if plan is not None:
        return plan.m, plan.n_slices
    return head_chunks(cfg.n_heads // max(cfg.n_kv_heads, 1),
                       cfg.resolved_head_dim)


def _group(cfg: ModelConfig) -> int:
    """The G of the decode split kernel that runs this model's chunks:
    the smallest built one that holds a chunk (the chunked route)."""
    hd = kreg.padded_head_dim(cfg.resolved_head_dim) or cfg.resolved_head_dim
    return next(g for g in kreg.decode_groups(hd) if g >= _chunks(cfg)[0])


# ---------------------------------------------------------------------------
# Hard-constraint pruning
# ---------------------------------------------------------------------------

def smem_bytes(cfg: ModelConfig) -> int:
    """The largest shared memory a block among the serving kernels this
    model launches: decode's split and merge and flash, at the head dim the
    kernels run it at."""
    hd = kreg.padded_head_dim(cfg.resolved_head_dim) or cfg.resolved_head_dim
    kv = "int8" if cfg.kv_quant else cfg.dtype
    plan = _group_plan(cfg)
    split = kreg.decode_split_smem_bytes(hd, _group(cfg)) if plan is None \
        else kreg.decode_group_smem_bytes(hd, kv, plan.m)
    return max(split, kreg.decode_merge_smem_bytes(hd, kv),
               kreg.flash_smem_bytes(hd, cfg.dtype))


def prune_reason(cand: TunedConfig, cfg: ModelConfig, prof: DeviceProfile,
                 *, max_len: int, paged: bool) -> Optional[str]:
    r = legal_reason(cand, max_len=max_len, head_dim=cfg.resolved_head_dim,
                     paged=paged)
    if r is not None:
        return r
    smem = smem_bytes(cfg)
    if smem > prof.smem_bytes:
        return f"SMEM {smem} > {prof.smem_bytes}"
    pool_positions = cand.n_slots * max_len
    if paged:
        # whole-page rounding wastes (ps - 1) positions worst-case per slot
        pool_positions += cand.n_slots * (cand.page_size - 1)
    hbm = _param_bytes(cfg) + pool_positions * kv_bytes_per_pos(cfg)
    if hbm > prof.hbm_bytes:
        return f"HBM {hbm / 2 ** 30:.2f}GiB > {prof.hbm_bytes / 2 ** 30:.2f}GiB"
    return None


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def sweep_plan(cfg: ModelConfig, cand: TunedConfig, prof: DeviceProfile, *,
               max_len: int, paged: bool) -> Dict[str, float]:
    """The decode sweep's grid as the wrapper launches it: ``split_plan``
    over (slots x kv heads x head chunks, or the group kernel's slices)
    rows on the class's SMs, split rows a multiple of the page size on a
    paged pool; blocks an SM by the kernel's launch bounds (two at a G of
    4 up to head dim 256, else one; the group kernel one). ``wave_eff`` is
    the share of the launched waves' block slots that hold a block."""
    bh = cand.n_slots * cfg.n_kv_heads * _chunks(cfg)[1]
    n_split, rows, _ = launch_plan(
        cand.n_slots, cfg.n_kv_heads, cfg.n_heads // max(cfg.n_kv_heads, 1),
        cfg.resolved_head_dim, cfg.dtype, max_len, prof.sm_count,
        cand.page_size if paged else 0)
    two = _group_plan(cfg) is None and _group(cfg) <= 4 and \
        cfg.resolved_head_dim <= kreg.MAX_PADDED_HEAD_DIM
    per_wave = prof.sm_count * (2 if two else 1)
    blocks = bh * n_split
    waves = -(-blocks // per_wave)
    return dict(n_split=float(n_split), split_rows=float(rows),
                blocks=float(blocks), waves=float(waves),
                wave_eff=blocks / (waves * per_wave))


def candidate_cost(cand: TunedConfig, cfg: ModelConfig, prof: DeviceProfile,
                   *, max_len: int, paged: bool) -> Cost:
    """Score one candidate. Workload assumption (fixed, documented, the
    reference's): steady-state context = max_len/2, prompts = max_len/4,
    and each request decodes max_len/2 tokens."""
    pr = prune_reason(cand, cfg, prof, max_len=max_len, paged=paged)
    if pr is not None:
        return Cost(step_s=float("inf"), us_per_token=float("inf"), pruned=pr)

    hd, ns = cfg.resolved_head_dim, cand.n_slots
    layers = _attn_layers(cfg)
    kvpp = kv_bytes_per_pos(cfg)
    avg_ctx = max(max_len // 2, 1)
    peak = prof.peak(cfg.dtype)
    launches = step_launches(cfg)

    # ---- decode step: host issue + params once + KV sweep per slot -------
    host_dec = launches * prof.launch_host_s
    if paged:
        ps = cand.page_size
        # a context ends anywhere in its last page: (ps - 1) / 2 rows of
        # that page are swept and unused on average (fragmentation waste)
        swept = avg_ctx + (ps - 1) / 2
        host_dec += min(1.0, ns / ps) * prof.launch_host_s   # table uploads
    else:
        swept = max_len                               # dense sweeps full L
    grid = sweep_plan(cfg, cand, prof, max_len=max_len, paged=paged)
    kv_bytes = ns * swept * kvpp
    dec_flops = 2.0 * cfg.param_count() * ns \
        + 4.0 * ns * avg_ctx * cfg.n_heads * hd * layers
    t_sweep = kv_bytes / prof.hbm_bw / grid["wave_eff"]
    t_dev = max(_param_bytes(cfg) / prof.hbm_bw + t_sweep,
                dec_flops / peak)
    t_dec = host_dec + t_dev

    # ---- prefill (one call over the prompt), amortized per token ----------
    S = max(max_len // 4, 1)
    pf_flops = 2.0 * cfg.param_count() * S \
        + 4.0 * S * S * cfg.n_heads * hd * layers
    t_prefill = launches * prof.launch_host_s + max(
        (_param_bytes(cfg) + S * kvpp) / prof.hbm_bw, pf_flops / peak)

    decode_tokens = max(max_len // 2, 1)
    # ---- async prefill chunking: stall vs admission delay (convex) ------
    pc = cand.prefill_chunk
    t_chunk = (pc * t_prefill + t_dec / pc) / decode_tokens

    us_per_token = (t_dec / ns + t_prefill / decode_tokens + t_chunk) * 1e6
    return Cost(
        step_s=t_dec,
        us_per_token=us_per_token,
        terms={
            "decode_us": t_dec * 1e6,
            "decode_host_us": host_dec * 1e6,
            "decode_device_us": t_dev * 1e6,
            "prefill_us": t_prefill * 1e6,
            "chunk_us": t_chunk * 1e6,
            "kv_gb_per_step": kv_bytes / 1e9,
            "launches": float(launches),
            **grid,
        })
