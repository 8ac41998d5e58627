"""BAaaS serving on the PyTorch port (``examples/serve_baas.py`` through
``repro_torch``): a provider-prebuilt LM served behind the hypervisor with
continuous batching over a PAGED KV-cache pool — users submit prompts,
never see devices (paper §III-C); device memory is virtualized into pages
exactly as compute is virtualized into vSlices.

Runs on the card unless ``--device cpu`` is passed (raises where CUDA is
absent); on the card the paged decode and flash prefill kernels serve
(``--kernel-force ref``: the plain versions). ``main`` returns the
wall-clock-free results it printed, and every request's whole token
stream.

Run:  PYTHONPATH=src python examples/serve_baas_torch.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import ClusterSpec, Hypervisor
from repro_torch.models import get_model
from repro_torch.runtime import BatchingEngine


def main(argv=None, *, params=None):
    """``params``: the model's weights (default: a seeded init)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is absent) or cpu")
    ap.add_argument("--kernel-force", default="", choices=("", "ref"),
                    help="'ref': the kernels' plain versions on any device")
    args = ap.parse_args(argv)
    res = {}

    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1),
                    device=args.device)

    # provider prepares the service: model + weights ("prebuilt bitfile")
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    cfg = cfg.replace(geometry=dataclasses.replace(
        cfg.geometry, kernel_force=args.kernel_force))
    model = get_model(cfg, device=args.device)
    if params is None:
        params = model.init(torch.Generator(device=model.dev).manual_seed(0))
    vs = hv.allocate_vslice("provider:lm-service", slots=2, service_model="baas")
    # 8 slots share a page pool holding only 4 dense rows' worth of cache:
    # short requests take 1-2 pages instead of a whole max_len row
    engine = BatchingEngine(model, params, n_slots=8, max_len=96,
                            paged=True, page_size=16,
                            cache_pages=4 * (96 // 16) + 1)
    res["service"] = (vs.slice_id, vs.device_id, engine.pool.total_pages)
    print(f"lm-service up on {vs.slice_id} ({vs.device_id}), 8 decode "
          f"slots over a {engine.pool.total_pages}-page KV pool")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 3, 8, 4, 6, 2, 7, 5)]
    # two of a kind: identical prompts admitted together share prefix
    # pages copy-on-write
    prompts[1] = list(prompts[0])
    t0 = time.monotonic()
    reqs = [engine.submit(p, max_new_tokens=12) for p in prompts]
    drained = engine.run_until_idle()
    assert drained, "engine stalled with work still queued"

    total_new = sum(len(r.out_tokens) for r in reqs)
    wall = time.monotonic() - t0
    res["requests"] = []
    for r in reqs:
        ttft = (r.first_token_at - r.submitted_at) * 1e3
        res["requests"].append((r.request_id, len(r.prompt),
                                len(r.out_tokens), r.finish_reason,
                                r.out_tokens[:6]))
        print(f"req {r.request_id}: prompt {len(r.prompt)} tok -> "
              f"{len(r.out_tokens)} new ({r.finish_reason}), "
              f"TTFT {ttft:.0f} ms, tokens {r.out_tokens[:6]}...")
    res["streams"] = {r.request_id: list(r.out_tokens) for r in reqs}
    res["total_new"], res["engine_steps"] = total_new, engine.steps
    print(f"\n{len(reqs)} requests, {total_new} tokens in {wall:.2f}s "
          f"({total_new / wall:.1f} tok/s aggregate, {engine.steps} engine "
          "steps — continuous batching shares every step across slots)")
    res["page_stats"] = engine.page_stats()
    print(f"page pool: {res['page_stats']}")
    hv.release(vs.slice_id)
    return res


if __name__ == "__main__":
    main()
