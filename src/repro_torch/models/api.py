"""``Model``: init / forward / prefill / decode for every family the JAX
package serves (dense, MoE, MLA, SSM, hybrid, VLM through ``models.lm``;
the whisper encoder-decoder through ``models.encdec``), on an explicit
device (CUDA unless the caller asks for the CPU).

Batch keys of ``forward`` and ``prefill``: ``tokens``; ``patches`` (B,
n_patches, d_model) for a VLM; ``frames`` (B, F, d_model) for the audio
family. ``forward`` (training) records the autograd graph; the serving
entry points run under ``torch.no_grad``.

``input_specs(cfg, shape_cell)`` returns ``meta``-device tensors of the
shapes and dtypes of every input of the corresponding step (no
allocation): the reference's ``ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
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

    def init(self, generator) -> dict:
        """Seeded weights drawn from ``generator``. On the meta device
        (``generator`` None) the tree of meta tensors with the shapes and
        dtypes of a seeded init, and no draws: ``jax.eval_shape(init)``."""
        if self.dev.type == "meta":
            generator = _MetaDraws()
        if self.audio:
            return encdec.init_encdec(self.cfg, generator, self.dev)
        return lm.init_lm(self.cfg, generator, self.dev)

    def forward(self, params, batch, remat: bool = False):
        """batch dict -> (hidden, aux), recording the autograd graph."""
        cfg = self.cfg
        if self.audio:
            return encdec.encdec_forward(cfg, params, batch["frames"],
                                         batch["tokens"], remat=remat)
        return lm.lm_forward(cfg, params, batch["tokens"],
                             patches=batch.get("patches"), remat=remat)

    def logits(self, params, hidden):
        if self.audio:
            return encdec.encdec_logits(self.cfg, params, hidden)
        return lm.lm_logits(self.cfg, params, hidden)

    @torch.no_grad()
    def prefill(self, params, batch, max_len: int, clamp_window: bool = True,
                caches=None):
        """batch dict -> (hidden, caches). ``caches`` (decoder-only LMs: a
        tree of ``make_prefill_caches``'s) is reset and filled in place
        instead of a new tree."""
        if self.audio:
            if caches is not None:
                raise ValueError("the audio family's prefill builds its own "
                                 "caches")
            return encdec.encdec_prefill(self.cfg, params, batch["frames"],
                                         batch["tokens"])
        return lm.lm_prefill(self.cfg, params, batch["tokens"], max_len,
                             patches=batch.get("patches"),
                             clamp_window=clamp_window, caches=caches)

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

    def make_prefill_caches(self, batch: int, max_len: int,
                            clamp_window: bool = True):
        """The cache tree ``prefill`` builds for ``batch`` prompts (its
        ``caches`` argument): decoder-only LMs only."""
        if self.audio:
            raise ValueError("the audio family's prefill builds its own "
                             "caches")
        return lm.make_decode_caches(self.cfg, batch, max_len, self.dev,
                                     clamp_window=clamp_window)

    def make_paged_caches(self, n_pages: int, page_size: int):
        if self.audio:
            raise ValueError("paged caches support decoder-only LMs")
        return lm.make_paged_caches(self.cfg, n_pages, page_size, self.dev)


class _MetaDraws(torch.Generator):
    """A generator whose draws land on the meta device: the layers draw on
    ``generator.device``, and a meta draw allocates and computes nothing."""

    @property
    def device(self):
        return torch.device("meta")


def get_model(cfg: ModelConfig, device: str = "cuda") -> Model:
    return Model(cfg, device=device)


# ---------------------------------------------------------------------------
# Dry-run input specs (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def _sds(shape, dtype):
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(shape, dtype=dt, device="meta")


def train_input_specs(cfg: ModelConfig, cell: ShapeCell):
    """Inputs of train_step: {tokens, labels[, patches | frames]}."""
    B, S = cell.global_batch, cell.seq_len
    if cfg.family == "audio":
        return {
            "frames": _sds((B, S, cfg.d_model), cfg.dtype),
            "tokens": _sds((B, encdec.DEC_MAX_LEN), torch.int32),
            "labels": _sds((B, encdec.DEC_MAX_LEN), torch.int32),
        }
    specs = {
        "tokens": _sds((B, S - cfg.n_patches), torch.int32),
        "labels": _sds((B, S - cfg.n_patches), torch.int32),
    }
    if cfg.n_patches:
        specs["patches"] = _sds((B, cfg.n_patches, cfg.d_model), cfg.dtype)
    return specs


def prefill_input_specs(cfg: ModelConfig, cell: ShapeCell):
    B, S = cell.global_batch, cell.seq_len
    if cfg.family == "audio":
        return {
            "frames": _sds((B, S, cfg.d_model), cfg.dtype),
            "tokens": _sds((B, encdec.DEC_MAX_LEN), torch.int32),
        }
    specs = {"tokens": _sds((B, S - cfg.n_patches), torch.int32)}
    if cfg.n_patches:
        specs["patches"] = _sds((B, cfg.n_patches, cfg.d_model), cfg.dtype)
    return specs


def decode_input_specs(cfg: ModelConfig, cell: ShapeCell):
    """Inputs of serve_step: one new token + caches over cell.seq_len (the
    caches built on the meta device)."""
    B, S = cell.global_batch, cell.seq_len
    return {
        "tokens": _sds((B, 1), torch.int32),
        "pos": _sds((B,), torch.int32),
        "caches": get_model(cfg, device="meta").make_caches(B, S),
    }


def input_specs(cfg: ModelConfig, cell: ShapeCell):
    if cell.kind == "train":
        return train_input_specs(cfg, cell)
    if cell.kind == "prefill":
        return prefill_input_specs(cfg, cell)
    return decode_input_specs(cfg, cell)
