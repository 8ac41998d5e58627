"""Quickstart on the PyTorch port: the paper's workflow end to end on one
box (``examples/quickstart.py`` through ``repro_torch``).

1. Stand up the RC3E hypervisor over a simulated 2-node inventory.
2. RAaaS: allocate a vSlice, deploy a streaming matmul core (the paper's §V
   example) through admission + configure, stream data through it.
3. Swap the core via partial reconfiguration (cache hit) and show the
   latency gap vs the cold configuration.
4. BAaaS: invoke a provider-registered service without seeing any device.

Runs on the card unless ``--device cpu`` is passed (raises where CUDA is
absent). ``main`` returns the wall-clock-free results it printed.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (BAaaSSession, ClusterSpec, Hypervisor,
                              RAaaSSession)
from repro_torch.rc2f import CoreSpec, SharedLink, StreamSpec, core_throughput


def mm_stream_core(a, b):
    return (torch.einsum("gij,gjk->gik", a, b),)


def main(argv=None, *, params=None):
    """``params`` is unused: the quickstart serves no model (the keyword
    keeps the examples' common entry point)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is absent) or cpu")
    args = ap.parse_args(argv)
    res = {}

    hv = Hypervisor(ClusterSpec(n_nodes=2, devices_per_node=2),
                    device=args.device)
    print("== RC3E inventory ==")
    res["utilization_start"] = hv.status()["utilization"]
    for dev, util in res["utilization_start"].items():
        print(f"  {dev}: {util:.0%} used")

    # ---- RAaaS: user core on a vSlice ----
    sess = RAaaSSession(hv, "alice", slots=1)
    res["vslice"] = (sess.vslice.slice_id, sess.vslice.device_id)
    print(f"\nallocated {sess.vslice.slice_id} on {sess.vslice.device_id}")

    g = 64
    spec = CoreSpec("mm16", (StreamSpec((g, 16, 16)), StreamSpec((g, 16, 16))),
                    (StreamSpec((g, 16, 16)),))

    t0 = time.perf_counter()
    sess.deploy_core(mm_stream_core, spec.example_inputs(), "mm16")
    t_cold = time.perf_counter() - t0
    a = torch.from_numpy(np.random.default_rng(0).random(
        (g, 16, 16)).astype(np.float32)).to(args.device)
    out = sess.run(a, a)
    res["out_shape"] = tuple(out[0].shape)
    print(f"deployed + ran streaming matmul core: out {res['out_shape']}, "
          f"cold configure {t_cold * 1e3:.1f} ms")

    t0 = time.perf_counter()
    sess.deploy_core(mm_stream_core, spec.example_inputs(), "mm16")
    t_pr = time.perf_counter() - t0
    print(f"partial reconfiguration (cache hit): {t_pr * 1e3:.2f} ms "
          f"({t_cold / max(t_pr, 1e-9):.0f}x faster — paper Table I: 29.5 s "
          "vs 0.9 s)")

    # ---- paper Table III contention forecast for this core ----
    link = SharedLink()
    res["table3"] = [round(core_throughput(509e6, link, n) / 1e6)
                     for n in (1, 2, 4)]
    print("\nper-core MB/s if co-resident (paper Table III):", res["table3"])

    # ---- BAaaS ----
    hv.register_service("vector-double", lambda: (
        lambda v: (v * 2,),
        (torch.ones((8,), dtype=torch.float32, device=args.device),)))
    ba = BAaaSSession(hv, "bob")
    res["services"] = ba.list_services()
    print("\nBAaaS services visible to bob:", res["services"])
    got = ba.invoke("vector-double", torch.arange(
        8, dtype=torch.float32, device=args.device))[0].cpu().numpy()
    res["invoke"] = got.tolist()
    print("invoke:", got)

    sess.close()
    res["utilization_end"] = hv.status()["utilization"]
    print("\nfinal utilization:", res["utilization_end"])
    return res


if __name__ == "__main__":
    main()
