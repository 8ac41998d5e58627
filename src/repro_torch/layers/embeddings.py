"""Token embeddings and sinusoidal positions."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.placement import (P, dp_spec_for, local_offset, local_region,
                                   spec_of)


def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32, device=None):
    tok = torch.randn((vocab, d_model), generator=generator,
                      device=generator.device, dtype=dtype) * d_model ** -0.5
    return {"tok": tok.to(device)}


def embed(p, tokens, scale_by_dim: bool = False):
    # F.embedding, not indexing: its backward is one op that a DTensor
    # table (a mesh step) runs as the plain table does, bit for bit
    x = _lookup(tokens, p["tok"])
    if scale_by_dim:
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype)
    return x



def sinusoidal_positions(seq: int, d_model: int, dtype=torch.float32,
                         device=None):
    """(seq, d_model) sin | cos table, computed in fp32 (whisper's stub
    frontends use it in place of learned positions)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    # whisper's decode step rebuilds the table every step, as the
    # reference's does: the base is filled on the device, not uploaded, so
    # that the step can be captured as a CUDA graph
    base = torch.full((), 10000.0, device=device)
    ang = pos / torch.pow(base, dim / d_model)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe[:, :d_model].to(dtype)


def _lookup(tokens, table):
    """Rows of ``table`` (V, d). A DTensor table sharded over its
    vocabulary is read in a local region (the vocab-parallel embedding):
    each rank looks up the tokens in its own slice, zero elsewhere, and
    the rows are summed over the vocabulary's mesh dims (DTensor's own
    masked partial of a sharded lookup fails to reduce downstream)."""
    if not isinstance(table, DTensor) or not any(
            isinstance(pl, Shard) and pl.dim == 0 for pl in table.placements):
        return torch.nn.functional.embedding(tokens, table)
    mesh = table.device_mesh
    lo = local_offset(table, 0)
    vocab_dims = [i for i, pl in enumerate(table.placements)
                  if isinstance(pl, Shard) and pl.dim == 0]
    dp = dp_spec_for(tokens, tokens.shape[0])
    ids_spec = P(dp, *([None] * (tokens.ndim - 1)))
    return local_region(
        lambda ids, tab: _VocabSlice.apply(ids, tab, lo, mesh, vocab_dims),
        mesh, in_specs=(ids_spec, spec_of(table)),
        out_specs=P(*ids_spec, None))(tokens, table)


class _VocabSlice(torch.autograd.Function):
    """Local rows of a vocabulary slice starting at ``lo``, summed over the
    vocabulary's mesh dims; the backward scatters the (replicated) row
    gradients into the slice's own rows."""

    @staticmethod
    def forward(ctx, ids, tab, lo, mesh, dims):
        import torch.distributed._functional_collectives as funcol
        n = tab.shape[0]
        hit = (ids >= lo) & (ids < lo + n)
        li = (ids - lo).clamp(0, n - 1)
        rows = torch.nn.functional.embedding(li, tab) \
            * hit[..., None].to(tab.dtype)
        for d in dims:
            rows = funcol.all_reduce(rows, "sum", (mesh, d))
        ctx.save_for_backward(li, hit)
        ctx.n = n
        return rows

    @staticmethod
    def backward(ctx, grad):
        li, hit = ctx.saved_tensors
        g = grad * hit[..., None].to(grad.dtype)
        return None, torch.ops.aten.embedding_dense_backward(
            g, li, ctx.n, -1, False), None, None, None
