"""How ``correct`` is decided: the served tokens of a sample of finished
requests against the plain reference.

Once the window has closed and the system under test is freed, a sample
drawn from the seed of the requests the run finished (the one with the
longest output always in it, then more until ``SAMPLE_TOKENS`` served
tokens and ``SAMPLE_REQUESTS`` requests) is run through the reference in
fp32, one whole sequence at a time: the prompt and the served tokens.
At each served position the number read is how far the served token's
reference logit lies below the reference's best; the numbers that the configuration's ``limits``
name (the widest gap ``max_gap``, or another statistic of the gaps from
``stats``) are compared with their limits. With ``control``, the same
positions are read for the token that the reference computed through
fp8 (the control) puts first.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from bench.traffic import _mix

HERE = Path(__file__).resolve().parent
SAMPLE_TOKENS = 1024
SAMPLE_REQUESTS = 4
TAIL_GAP = 0.2          # a served token this far below the best is a miss


def reference(name: str):
    """``reference/<name>.py``: the configuration's plain reference."""
    spec = importlib.util.spec_from_file_location(
        "bench_reference_" + name, HERE / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample(finished: List[Tuple[np.ndarray, list]], seed: int
           ) -> List[Tuple[np.ndarray, list]]:
    """The longest, then others in an order drawn from the seed, until the
    sample holds ``SAMPLE_TOKENS`` served tokens and ``SAMPLE_REQUESTS``
    requests (or every finished request)."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: len(finished[i][1]))
    rng = np.random.default_rng(_mix(seed, "sample"))
    order = [longest] + [i for i in rng.permutation(len(finished))
                         if i != longest]
    out, n = [], 0
    for i in order:
        if n >= SAMPLE_TOKENS and len(out) >= SAMPLE_REQUESTS:
            break
        out.append(finished[i])
        n += len(finished[i][1])
    return out


def gaps(ref, m: dict, params, prompt: np.ndarray, out: list,
         control: bool = False):
    """Each served token's gap below the reference's best (and, with
    ``control``, the gap of the token the control puts first at each of
    those positions; else None), as fp32 tensors."""
    dev = params["final_norm"].device
    toks = torch.from_numpy(np.concatenate(
        [prompt, np.asarray(out[:-1], np.int32)]).astype(np.int64)).to(dev)
    start = len(prompt) - 1
    want = ref.logits(m, params, toks, start)
    best = want.max(dim=-1).values
    served = torch.as_tensor(out, dtype=torch.long, device=dev)
    gap = best - want.gather(1, served[:, None])[:, 0]
    cgap = None
    if control:
        low = ref.logits(m, params, toks, start, precision="fp8")
        first = low.argmax(dim=-1)
        cgap = best - want.gather(1, first[:, None])[:, 0]
    return gap, cgap


def stats(g: torch.Tensor) -> dict:
    """The numbers a limit can be set on: the widest gap, the mean gap,
    the 99th percentile (nearest rank), the share of tokens that are not
    the reference's best, and the share more than ``TAIL_GAP`` below it
    (``tail_share``: where routing flips make the widest gap of sound bf16
    runs as wide as the control's, this still separates them)."""
    g = g.double().cpu()
    k = max(0, int(np.ceil(0.99 * g.numel())) - 1)
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "p99_gap": float(g.sort().values[k]),
            "miss_share": float((g > 0).double().mean()),
            "tail_share": float((g > TAIL_GAP).double().mean())}


def compare(config: dict, params, finished, seed: int,
            control: bool = False) -> dict:
    """The check of one run: each number the configuration's ``limits``
    names beside its limit (``correct`` when every one is within it; a
    limit of None is never met), the tokens and requests compared, every
    number read and, with ``control``, the control's numbers."""
    ref = reference(config["reference"])
    picks = sample(finished, seed)
    got, low = [], []
    for prompt, out in picks:
        g, c = gaps(ref, config["model"], params, prompt, out, control)
        got.append(g)
        if control:
            low.append(c)
    if not got:
        return {"correct": False, "numbers": {}, "tokens": 0,
                "requests": 0, "read": {}, "control": None}
    read = stats(torch.cat(got))
    limits = config["limits"]
    numbers = {k: {"value": read[k], "limit": v} for k, v in limits.items()}
    ok = all(v is not None and read[k] <= v for k, v in limits.items())
    return {"correct": ok, "numbers": numbers,
            "tokens": sum(len(o) for _, o in picks), "requests": len(picks),
            "read": read,
            "control": stats(torch.cat(low)) if control else None}
