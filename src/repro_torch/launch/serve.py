"""Serving launcher: stands up the multi-tenant serving FLEET for an arch
and runs a synthetic request workload from several tenants through the RC3E
hypervisor — every request is admitted, bound to a vSlice, batched across
tenants on its vSlice's device, and logged by the hypervisor. With
``--devices N`` the fleet runs one engine per physical device of the
inventory and the DeviceDB's placement decides where each tenant decodes;
every engine runs on ``--device`` (the card unless ``--device cpu``).

Ported from ``repro.launch.serve`` (same flags, prints and audit, float32
as there), plus ``--device``. Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduce --device cpu --requests 12 --devices 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --requests 12 --devices 2 --tenants 3            # on the card
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import MAX_SLOTS, ClusterSpec, Hypervisor
from repro_torch.models import Model
from repro_torch.rc2f import AdmissionError
from repro_torch.runtime import GatewayFleet


def main(argv=None) -> dict:
    """Run the launcher (``argv`` as on the command line; None reads
    ``sys.argv``). Returns the run's summary: requests, tokens, wall
    seconds, tokens/s, median latency, the audited serve events, and the
    decode program's configures, CUDA graph captures and replays (none on
    the CPU)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--devices", type=int, default=0,
                    help="physical devices in the inventory "
                         "(0 = size to the tenant count)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV-cache pool engines (block tables, "
                         "per-tenant page budgets, COW prefix sharing)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where every engine runs: cuda (default; raises "
                         "where CUDA is absent) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    cfg = cfg.replace(dtype="float32")
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.dev).manual_seed(0))

    # size the simulated inventory to the tenant count unless --devices set:
    # first tenant gets a 2-slot vSlice, the rest 1 slot each
    total_slots = args.tenants + 1
    n_devices = args.devices or max(1, -(-total_slots // MAX_SLOTS))
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=n_devices),
                    device=args.device)
    fleet = GatewayFleet(hv, model, params, n_slots=args.slots,
                         max_len=args.max_len, paged=args.paged,
                         page_size=args.page_size)
    tenants = [f"tenant-{i}" for i in range(args.tenants)]
    for i, t in enumerate(tenants):
        sess = fleet.open_session(t, slots=2 if i == 0 else 1)
        print(f"{t}: session on {sess.slice_id} "
              f"({sess.slots} slot(s), {fleet.device_of(t)})")
    print(f"{cfg.name} fleet up: {len(fleet._engines)} engine(s) across "
          f"{n_devices} device(s), {args.slots} decode slots each, "
          f"{len(tenants)} tenants")

    def submit_throttled(tenant, prompt):
        """Back-pressure instead of failing when a tenant hits its
        in-flight quota: drive the fleet until the backlog drains."""
        while True:
            try:
                return fleet.submit(tenant, prompt,
                                    max_new_tokens=args.max_new)
            except AdmissionError:
                if fleet.step() == 0:
                    raise       # nothing draining: structurally rejected
    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    reqs = [submit_throttled(tenants[i % len(tenants)],
                             rng.integers(0, cfg.vocab_size,
                                          size=rng.integers(2, 9)).tolist())
            for i in range(args.requests)]
    fleet.run_until_idle()
    if model.dev.type == "cuda":
        torch.cuda.synchronize(model.dev)
    wall = time.monotonic() - t0

    total = sum(len(r.out_tokens) for r in reqs)
    lat = [(r.finished_at - r.submitted_at) for r in reqs]
    print(f"\n{len(reqs)} requests, {total} tokens, {wall:.2f}s wall "
          f"({total/wall:.1f} tok/s), median latency "
          f"{np.median(lat)*1e3:.0f} ms")
    if args.paged:
        for dev, fs in sorted(fleet.fleet_stats().items()):
            if "pages" in fs:
                print(f"  {dev} pages: {fs['pages']}")
    for t, s in sorted(fleet.stats().items()):
        print(f"  {t}: {s['served']} served on {s['slice']} "
              f"({s['device']}), {s['tokens_out']} tokens, "
              f"quota {s['quota']}")

    # audit: every request must have been served through a hypervisor vSlice
    serve_events = {e["request"]: e for e in hv.log if e["kind"] == "serve"}
    assert len(serve_events) == len(reqs), \
        f"{len(reqs) - len(serve_events)} requests missing from hv.log"
    assert all(e["slice"].startswith("vs-") for e in serve_events.values())
    print(f"\naudit: all {len(serve_events)} requests logged against "
          f"hypervisor vSlices "
          f"({sorted({e['slice'] for e in serve_events.values()})})")
    programs = hv.reconfig.cache.programs()
    print(f"programs: {hv.reconfig.configures} configure(s), "
          f"{programs['captures']} CUDA graph capture(s), "
          f"{programs['replays']} replay(s)")
    fleet.close()
    return dict(requests=len(reqs), tokens=total, wall_s=wall,
                tokens_per_s=total / wall,
                median_latency_ms=float(np.median(lat)) * 1e3,
                serve_events=len(serve_events),
                slices=sorted({e["slice"] for e in serve_events.values()}),
                engines=len({e["device"] for e in hv.log
                             if e["kind"] == "engine_up"}),
                configures=hv.reconfig.configures,
                captures=programs["captures"], replays=programs["replays"])


if __name__ == "__main__":
    main()
