"""``Model``: init / prefill / decode for every family the JAX package
serves (dense, MoE, MLA, SSM, hybrid, VLM through ``models.lm``; the
whisper encoder-decoder through ``models.encdec``), on an explicit device
(CUDA unless the caller asks for the CPU).

Batch keys of ``prefill``: ``tokens``; ``patches`` (B, n_patches, d_model)
for a VLM; ``frames`` (B, F, d_model) for the audio family.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: str = "cuda"

    def __post_init__(self):
        # the card unless the caller asks for the CPU; no silent fallback
        if self.dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")

    @property
    def dev(self) -> torch.device:
        return torch.device(self.device)

    @property
    def audio(self) -> bool:
        return self.cfg.family == "audio"

    def init(self, generator: torch.Generator) -> dict:
        if self.audio:
            return encdec.init_encdec(self.cfg, generator, self.dev)
        return lm.init_lm(self.cfg, generator, self.dev)

    def logits(self, params, hidden):
        if self.audio:
            return encdec.encdec_logits(self.cfg, params, hidden)
        return lm.lm_logits(self.cfg, params, hidden)

    @torch.no_grad()
    def prefill(self, params, batch, max_len: int, clamp_window: bool = True):
        if self.audio:
            return encdec.encdec_prefill(self.cfg, params, batch["frames"],
                                         batch["tokens"])
        return lm.lm_prefill(self.cfg, params, batch["tokens"], max_len,
                             patches=batch.get("patches"),
                             clamp_window=clamp_window)

    @torch.no_grad()
    def decode(self, params, caches, tokens, pos):
        if self.audio:
            return encdec.encdec_decode(self.cfg, params, caches, tokens,
                                        pos)
        return lm.lm_decode(self.cfg, params, caches, tokens, pos)

    @torch.no_grad()
    def decode_paged(self, params, caches, tokens, pos, block_tables):
        """One decode step against the paged KV pool (block-table
        indirection; attention-family LMs only)."""
        if self.audio:
            raise ValueError("paged decode supports decoder-only LMs")
        return lm.lm_decode_paged(self.cfg, params, caches, tokens, pos,
                                  block_tables)

    def make_caches(self, batch: int, max_len: int):
        """Empty decode caches; for the audio family ``max_len`` is the
        encoder length of the cross-attention K/V."""
        if self.audio:
            # the reference zero-fills the whole tree here (self-cache pos
            # 0, unlike the prefill's caches, which start at -1)
            caches = encdec.make_encdec_caches(self.cfg, batch, max_len,
                                               self.dev)
            for leaf in caches["self"].values():
                leaf.zero_()
            return caches
        return lm.make_decode_caches(self.cfg, batch, max_len, self.dev)

    def make_paged_caches(self, n_pages: int, page_size: int):
        if self.audio:
            raise ValueError("paged caches support decoder-only LMs")
        return lm.make_paged_caches(self.cfg, n_pages, page_size, self.dev)
