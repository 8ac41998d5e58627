"""Model / system configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; the stage planner
(`repro.models.stages`) turns the per-layer pattern into grouped ``lax.scan`` stages so
deep models lower to small HLO (fast SPMD compiles at 256/512 devices).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = full-rank q projection (v2-lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    top_k: int = 6
    d_expert: int = 1408          # per-expert ffn hidden size
    n_shared: int = 0             # shared experts always active
    first_k_dense: int = 0        # first k layers use a dense mlp instead
    dense_d_ff: int = 0           # hidden size of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    norm_topk: bool = True
    # data-parallel shard count the dispatch is local to (set by the
    # launcher from the mesh): tokens reshape to (dp_shards, T_local) so the
    # position-in-expert cumsum never crosses shards
    dp_shards: int = 1


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # SSD head dim (P)
    n_groups: int = 1
    chunk: int = 256              # SSD chunk length
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). Frontend is a stub:
    inputs are precomputed frame embeddings (batch, frames, d_model)."""

    n_layers: int = 4
    max_frames: int = 1500


@dataclass(frozen=True)
class GeometryConfig:
    """The reference's kernel geometry, copied field for field so that the
    configs stay equal to the reference's. The block fields are the
    reference's Pallas tiles: the port reads none of them (its CUDA tiles
    are compiled constants, ``kernels/registry.py``, and its auto-tuner,
    ``repro_torch.tuning``, sweeps the serving geometry instead).

    ``kernel_force`` is read: "" runs the CUDA kernels on CUDA tensors and
    the plain versions on CPU tensors; "ref" forces the plain versions on
    any device; "kernel" (the reference's "force the kernel") runs the CUDA
    kernels and raises on a tensor off the card. The reference's
    "interpret" (Pallas's interpreter) has no counterpart for CUDA sources,
    and the port refuses it."""

    decode_block_k: int = 512
    flash_block_q: int = 256
    flash_block_k: int = 256
    mm_block_m: int = 128
    mm_block_n: int = 128
    mm_block_k: int = 128
    kernel_force: str = ""


# ---------------------------------------------------------------------------
# Main config
# ---------------------------------------------------------------------------

ATTN_GLOBAL = "global"
ATTN_LOCAL = "local"
MIXER_SSM = "ssm"
MIXER_SHARED_ATTN = "shared_attn"   # zamba2: one weight set reused at every site


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | ssm | moe | hybrid | audio | vlm

    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 32000

    # Per-layer mixer pattern. ``pattern`` has length ``pattern_period`` and is
    # tiled across n_layers (remainder = prefix of the pattern). Entries are
    # ATTN_GLOBAL / ATTN_LOCAL / MIXER_SSM / MIXER_SHARED_ATTN.
    pattern: Tuple[str, ...] = (ATTN_GLOBAL,)

    window: int = 4096              # sliding window for ATTN_LOCAL layers
    attn_softcap: float = 0.0       # gemma2 logit soft-capping (0 = off)
    final_softcap: float = 0.0
    qk_norm: bool = False           # qwen3-style RMSNorm on q/k heads
    causal: bool = True             # False for encoder stacks
    use_rope: bool = True           # False for sinusoidal-posemb stacks
    embed_scale: bool = False       # gemma: embeddings scaled by sqrt(d)
    rope_theta: float = 10000.0
    rope_local_theta: float = 0.0   # gemma3: different theta for local layers (0=same)
    query_scale: float = 0.0        # 0 -> head_dim ** -0.5
    attn_tp: str = "heads"          # set to "seq" by the launcher when
                                    # n_kv_heads doesn't divide the TP axis
    tp_mode: str = "tp"             # "tp" | "pure_dp" | "fsdp"
    kv_quant: bool = False          # int8 KV cache (+fp32 row scales):
                                    # halves decode cache bytes per device
    max_seq_len: int = 131072

    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None

    # VLM stub: number of prepended patch-embedding positions.
    n_patches: int = 0

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"               # silu | gelu
    post_norm: bool = False         # gemma2/3 use post-block norms as well

    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"

    # serving kernel geometry (auto-tuner output; defaults = hand-picked)
    geometry: GeometryConfig = GeometryConfig()

    # ---------------- derived helpers ----------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Mixer kind per layer, tiling the pattern."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.mla is not None:
            m = self.mla
            qd = (m.qk_nope_head_dim + m.qk_rope_head_dim) * self.n_heads
            p = d * qd                                      # q proj (full rank)
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)  # kv down + rope k
            p += m.kv_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.v_head_dim)          # kv up
            p += self.n_heads * m.v_head_dim * d            # o proj
            return p
        return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)

    def _mlp_params(self, layer_idx: int) -> int:
        d = self.d_model
        if self.moe is not None:
            mo = self.moe
            if layer_idx < mo.first_k_dense:
                return 3 * d * (mo.dense_d_ff or self.d_ff)
            return (3 * d * mo.d_expert * (mo.n_experts + mo.n_shared)
                    + d * mo.n_experts)
        return 3 * d * self.d_ff

    def _ssm_params(self) -> int:
        d, s = self.d_model, self.ssm
        d_in = s.expand * d
        n_heads_ssm = d_in // s.head_dim
        p = d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads_ssm)  # in_proj
        p += s.d_conv * (d_in + 2 * s.n_groups * s.d_state)            # conv
        p += 2 * n_heads_ssm                                           # A, D
        p += d_in * d                                                  # out proj
        return p

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, v = self.d_model, self.vocab_size
        total = v * d
        if not self.tie_embeddings:
            total += v * d
        shared_counted = False
        for i, kind in enumerate(self.layer_kinds()):
            if kind == MIXER_SSM:
                total += self._ssm_params()
            elif kind == MIXER_SHARED_ATTN:
                if not shared_counted:   # zamba2: one weight set reused
                    total += self._attn_params() + 3 * d * self.d_ff
                    shared_counted = True
            else:  # global/local attention layer + its mlp
                total += self._attn_params() + self._mlp_params(i)
        if self.encoder is not None:
            enc_per = self._attn_params() + 3 * d * self.d_ff
            total += self.encoder.n_layers * enc_per
            # decoder cross-attention adds one more attn block per layer
            total += self.n_layers * self._attn_params()
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        d = self.d_model
        total_moe = 3 * d * mo.d_expert * (mo.n_experts + mo.n_shared)
        active_moe = 3 * d * mo.d_expert * (mo.top_k + mo.n_shared)
        n_moe_layers = self.n_layers - mo.first_k_dense
        return self.param_count() - n_moe_layers * (total_moe - active_moe)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shape cells (assigned input shapes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# Archs allowed to run long_500k (sub-quadratic cache growth). See DESIGN.md §4.
LONG_CONTEXT_ARCHS = ("mamba2-370m", "zamba2-7b", "gemma3-1b", "gemma2-9b")
