"""The plain reference of a decoder-only transformer, dense or
mixture-of-experts: the whole forward pass over one sequence in float32,
with no kernel, cache, padding or batching. It imports nothing of the
port and takes from it only the layout of the weight tree, which both
read as they would read one checkpoint.

The model, as the configuration file's ``model`` states it (and as the
published Phi-3 and Qwen3-MoE describe it): token embedding; per layer,
RMSNorm (weights stored as w - 1, epsilon ``norm_eps``), grouped-query
attention with split-halves RoPE (Qwen3: RMSNorm of each q and k head
first), causal softmax in fp32, the output projection and the residual;
then RMSNorm and a SwiGLU MLP, or the router (fp32 softmax over every
expert, the top-k by a stable descending sort, the gates renormalised)
and the SwiGLU of each chosen expert weighted by its gate, and the
residual; the final RMSNorm and the vocabulary head.

``precision="fp8"`` is the control: every linear layer (q, k, v, o, the
MLP or experts, the head; not the router) takes its operands through
float8 e4m3, the weights scaled per output channel and the activations
per token, and accumulates in fp32. It is the step below the bf16 that
the configuration computes in.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_exact():
    """fp32 products without TF32, restored afterwards."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (the amax of the slice maps to 448)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Linear:
    """``x @ w`` in fp32, or through fp8 for the control."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 or fp8")
        self.fp8 = precision == "fp8"

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = x.float()
        w = w.float()
        if self.fp8:
            x = _fp8(x, -1)
            w = _fp8(w, 0)
        return x @ w


def rms_norm(x, w, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope(x, pos, theta: float):
    """x (S, ..., hd), split halves rotated by positions (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos.float()[:, None] * inv
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (hd // 2,)
    cos, sin = torch.cos(ang).reshape(shape), torch.sin(ang).reshape(shape)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(m, p, h, lin: Linear):
    S = h.shape[0]
    d, kv, hd = m["d_model"], m["n_kv_heads"], m["head_dim"]
    g = m["n_heads"] // kv
    q = lin(h, p["wq"].reshape(d, -1)).reshape(S, kv, g, hd)
    k = lin(h, p["wk"].reshape(d, -1)).reshape(S, kv, hd)
    v = lin(h, p["wv"].reshape(d, -1)).reshape(S, kv, hd)
    eps = m["norm_eps"]
    if m.get("qk_norm"):
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    pos = torch.arange(S, device=h.device)
    q = rope(q, pos, m["rope_theta"]) * hd ** -0.5
    k = rope(k, pos, m["rope_theta"])
    scores = torch.einsum("qhgc,khc->hgqk", q, k)
    diff = pos[:, None] - pos[None, :]
    keep = diff >= 0
    if m.get("window"):
        keep &= diff < m["window"]
    scores = scores.masked_fill(~keep, float("-inf"))
    o = torch.einsum("hgqk,khc->qhgc", torch.softmax(scores, -1), v)
    return lin(o.reshape(S, -1), p["wo"].reshape(-1, d))


def _swiglu(x, wg, wu, wd, lin: Linear):
    return lin(torch.nn.functional.silu(lin(x, wg)) * lin(x, wu), wd)


def _moe(m, p, h, lin: Linear):
    c = m["moe"]
    probs = torch.softmax(h.float() @ p["router"].float(), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[:, :c["top_k"]], idx[:, :c["top_k"]]
    if c.get("norm_topk", True):
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    out = torch.zeros_like(h, dtype=torch.float32)
    for e in torch.unique(idx).tolist():
        tok, j = (idx == e).nonzero(as_tuple=True)
        y = _swiglu(h[tok], p["wg"][e], p["wu"][e], p["wd"][e], lin)
        out.index_add_(0, tok, y * gate[tok, j][:, None])
    if c.get("n_shared"):
        s = p["shared"]
        out = out + _swiglu(h, s["wg"], s["wu"], s["wd"], lin)
    return out


def _layers(params):
    """Each layer's weights: the stages' leaves stacked over layers."""
    for stage in params["stages"]:
        if not isinstance(stage, dict):
            raise NotImplementedError("the reference runs stages of one "
                                      "repeated layer (run stages)")
        n = next(iter(_leaves(stage))).shape[0]
        for i in range(n):
            yield _index(stage, i)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _index(tree, i):
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@torch.no_grad()
def logits(m: dict, params, tokens: torch.Tensor, start: int,
           precision: str = "fp32") -> torch.Tensor:
    """(S - start, V) fp32 logits of the positions ``start..S-1`` of the
    sequence ``tokens`` (S,), each predicting the token after it."""
    lin = Linear(precision)
    eps = m["norm_eps"]
    with fp32_exact():
        x = params["embed"]["tok"][tokens.long()].float()
        for p in _layers(params):
            x = x + _attention(m, p["attn"], rms_norm(x, p["norm1"], eps),
                               lin)
            h = rms_norm(x, p["norm2"], eps)
            x = x + (_moe(m, p["moe"], h, lin) if "moe" in p else
                     _swiglu(h, p["mlp"]["wg"], p["mlp"]["wu"],
                             p["mlp"]["wd"], lin))
        h = rms_norm(x[start:], params["final_norm"], eps)
        head = params["embed"]["tok"].t() if m["tie_embeddings"] \
            else params["head"]
        return lin(h, head)
