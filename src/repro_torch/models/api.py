"""``Model``: init / prefill / decode for the dense attention
families and the pure-SSM family (mamba2: every layer an SSM mixer), on an
explicit device (CUDA unless the caller asks for the CPU).

Families the port cannot run yet raise ``NotImplementedError``: MoE, MLA,
hybrid SSM/attention (zamba2), encoder-decoder and VLM configs arrive with
ROADMAP.md Queue 1 item 5 ("Remaining model families").
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import MIXER_SHARED_ATTN, MIXER_SSM, ModelConfig
from repro_torch.models import lm


def _unsupported(cfg: ModelConfig) -> str:
    if cfg.moe is not None:
        return "MoE"
    if cfg.mla is not None:
        return "MLA"
    if MIXER_SHARED_ATTN in cfg.pattern:
        return ("hybrid SSM/attention (the shared attention block and "
                "hybrid stage path are not ported)")
    pure_ssm = cfg.ssm is not None and set(cfg.layer_kinds()) == {MIXER_SSM}
    if not pure_ssm and (cfg.ssm is not None or MIXER_SSM in cfg.pattern):
        return "mixed SSM/attention"
    if cfg.encoder is not None:
        return "encoder-decoder"
    if cfg.n_patches:
        return "VLM"
    return ""


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: str = "cuda"

    def __post_init__(self):
        family = _unsupported(self.cfg)
        if family:
            raise NotImplementedError(
                f"{self.cfg.name}: {family} models are not ported yet "
                "(ROADMAP.md Queue 1 item 5, remaining model families)")
        # the card unless the caller asks for the CPU; no silent fallback
        if self.dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")

    @property
    def dev(self) -> torch.device:
        return torch.device(self.device)

    def init(self, generator: torch.Generator) -> dict:
        return lm.init_lm(self.cfg, generator, self.dev)

    def logits(self, params, hidden):
        return lm.lm_logits(self.cfg, params, hidden)

    @torch.no_grad()
    def prefill(self, params, batch, max_len: int, clamp_window: bool = True):
        return lm.lm_prefill(self.cfg, params, batch["tokens"], max_len,
                             clamp_window=clamp_window)

    @torch.no_grad()
    def decode(self, params, caches, tokens, pos):
        return lm.lm_decode(self.cfg, params, caches, tokens, pos)

    @torch.no_grad()
    def decode_paged(self, params, caches, tokens, pos, block_tables):
        return lm.lm_decode_paged(self.cfg, params, caches, tokens, pos,
                                  block_tables)

    def make_caches(self, batch: int, max_len: int):
        return lm.make_decode_caches(self.cfg, batch, max_len, self.dev)

    def make_paged_caches(self, n_pages: int, page_size: int):
        return lm.make_paged_caches(self.cfg, n_pages, page_size, self.dev)

