"""Multi-tenant demo on the PyTorch port (``examples/multi_tenant.py``
through ``repro_torch``) — the paper's headline scenario (§V, Table III)
at two levels:

Part 1 (RC2F shell): four tenants' cores co-resident on ONE physical device,
throughput per core degrading as they share bandwidth while total utilization
rises; then one tenant is hot-swapped (partial reconfiguration) without
disturbing others.

Part 2 (serving gateway): three tenants' LM inference traffic routed through
the RC3E hypervisor — quota-checked sessions on vSlices, requests batched
across tenants on the shared device, every request logged against its slice.

Part 3 (serving fleet): one engine per physical device; a hot tenant is
flagged by the straggler monitor mid-stream and its session — queued AND
in-flight requests, generated tokens included — is handed off LIVE to a
second device's engine (the paper's outlook: "migration of user designs
between vFPGAs and physical FPGAs").

Runs on the card unless ``--device cpu`` is passed (raises where CUDA is
absent); on the card the dense decode and flash prefill kernels serve parts
2 and 3 (``--kernel-force ref``: the plain versions). ``main`` returns the
wall-clock-free results it printed, and every request's whole token stream
by request id.

Run:  PYTHONPATH=src python examples/multi_tenant_torch.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.rc2f import (CoreSpec, FusedShell, SharedLink, StreamSpec,
                              core_throughput)

G, N_BLOCKS = 64, 12
SPEC = CoreSpec("mm16", (StreamSpec((G, 16, 16)), StreamSpec((G, 16, 16))),
                (StreamSpec((G, 16, 16)),))


def mm_core(a, b):
    return torch.einsum("gij,gjk->gik", a, b)


def axpy_core(a, b):
    return a * 2.0 + b


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(shell, slots, blocks):
    inputs = {s: blocks for s in slots}
    shell.run_cycle(inputs)      # warm
    t0 = time.perf_counter()
    for _ in range(N_BLOCKS):
        shell.run_cycle(inputs)
    _sync(shell.device)
    dt = time.perf_counter() - t0
    per_core = N_BLOCKS * 2 * blocks[0].nbytes / dt / 1e6
    return per_core, per_core * len(slots)


def main(argv=None, *, params=None):
    """``params``: the served model's weights for parts 2 and 3 (default:
    a seeded init)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is absent) or cpu")
    ap.add_argument("--kernel-force", default="", choices=("", "ref"),
                    help="'ref': the kernels' plain versions on any device")
    args = ap.parse_args(argv)
    res = {}

    a = np.random.default_rng(0).random((G, 16, 16)).astype(np.float32)
    link = SharedLink()
    res["table3"] = [round(core_throughput(509e6, link, n) / 1e6)
                     for n in (1, 2, 4)]
    print("paper Table III model (16x16, MB/s/core):", res["table3"])

    print("\nmeasured on this host (one physical device, fused shell):")
    shell = FusedShell(4, device=args.device)
    history = []
    for n in (1, 2, 4):
        for s in range(n):
            shell.load(s, mm_core, SPEC, f"tenant{s}")
        per, total = measure(shell, list(range(n)), (a, a))
        history.append((n, per, total))
        print(f"  {n} tenant(s): {per:7.1f} MB/s/core, {total:7.1f} MB/s total")
    base = history[0][2]
    print(f"  -> total throughput with 4 tenants = "
          f"{history[-1][2] / base:.2f}x of 1 tenant "
          "(paper: utilization maximized despite per-core loss)")

    # hot swap tenant 2's core (PR) and verify tenant 0 output unchanged
    before = shell.run_cycle({s: (a, a) for s in range(4)})
    shell.load(2, axpy_core, SPEC, "tenant2-v2")
    after = shell.run_cycle({s: (a, a) for s in range(4)})
    res["tenant0_unchanged"] = bool(np.allclose(
        before[0][0].cpu().numpy(), after[0][0].cpu().numpy()))
    print(f"\npartial reconfiguration of slot 2: tenant 0 output unchanged: "
          f"{res['tenant0_unchanged']}")
    res["slot2_axpy"] = bool(np.allclose(after[2][0].cpu().numpy(),
                                         2 * a + a))
    print("slot 2 now computes 2a+b:", res["slot2_axpy"])

    res["gateway"] = serving_gateway_demo(args, params)
    res["fleet"] = fleet_migration_demo(args, params)
    return res


def _model(args, params):
    """The reference example's model, reduced smollm-135m in fp32, and its
    weights."""
    from repro_torch.models import get_model
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    cfg = cfg.replace(geometry=dataclasses.replace(
        cfg.geometry, kernel_force=args.kernel_force))
    model = get_model(cfg, device=args.device)
    if params is None:
        params = model.init(torch.Generator(device=model.dev).manual_seed(0))
    return model, params


def serving_gateway_demo(args, params=None):
    """Part 2: multi-tenant LM serving through the hypervisor."""
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.rc2f import AdmissionError
    from repro_torch.runtime import ServingGateway

    print("\n--- serving gateway: 3 tenants, one device, one hypervisor ---")
    model, params = _model(args, params)
    res = {"sessions": []}

    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1),
                    device=args.device)
    gw = ServingGateway(hv, model, params, n_slots=4, max_len=96)
    for tenant, slots in (("alice", 2), ("bob", 1), ("carol", 1)):
        s = gw.open_session(tenant, slots=slots)
        res["sessions"].append((tenant, slots, s.slice_id))
        print(f"  {tenant}: {slots}-slot vSlice {s.slice_id}")

    # quotas are enforced before any allocation happens
    try:
        gw.open_session("alice-2nd-core", slots=4)   # baas quota is 2 slots
    except AdmissionError as e:
        res["quota_rejection"] = str(e)
        print(f"  quota rejection works: {e}")

    rng = np.random.default_rng(1)
    reqs = []
    for i in range(9):
        tenant = ("alice", "bob", "carol")[i % 3]
        reqs.append(gw.submit(tenant, rng.integers(
            0, model.cfg.vocab_size, size=5).tolist(), max_new_tokens=8))
    t0 = time.monotonic()
    gw.run_until_idle()
    wall = time.monotonic() - t0

    res["stats"] = sorted(gw.stats().items())
    for tenant, s in res["stats"]:
        print(f"  {tenant}: {s['served']} requests, {s['tokens_out']} tokens "
              f"on {s['slice']}")
    served = [e for e in hv.log if e["kind"] == "serve"]
    res["audited"], res["steps"] = len(served), gw.engine.steps
    print(f"  {len(served)} requests audited in Hypervisor.log, "
          f"{gw.engine.steps} shared decode steps, {wall:.2f}s "
          f"(cross-tenant continuous batching)")
    res["streams"] = {r.request_id: list(r.out_tokens) for r in reqs}
    gw.close()
    return res


def fleet_migration_demo(args, params=None):
    """Part 3: live migration of a serving tenant between devices."""
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.runtime import GatewayFleet

    print("\n--- serving fleet: live session hand-off between devices ---")
    model, params = _model(args, params)
    res = {}

    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=2),
                    device=args.device)
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=96)
    hot = fleet.open_session("hot", slots=2)
    cold = fleet.open_session("cold", slots=1)
    res["placed"] = (hot.slice_id, fleet.device_of("hot"), cold.slice_id,
                     fleet.device_of("cold"))
    print(f"  hot:  {hot.slice_id} on {fleet.device_of('hot')}  "
          f"cold: {cold.slice_id} on {fleet.device_of('cold')}")

    rng = np.random.default_rng(2)
    vocab = model.cfg.vocab_size
    reqs = [fleet.submit("hot", rng.integers(0, vocab, size=6).tolist(),
                         max_new_tokens=12) for _ in range(4)]
    cold_req = fleet.submit("cold", rng.integers(0, vocab, size=6).tolist(),
                            max_new_tokens=12)
    for _ in range(4):            # decoding is under way...
        fleet.step()
    mid = [len(r.out_tokens) for r in reqs]

    # ...when the monitor flags the hot tenant as a straggler
    for _ in range(8):
        hv.monitor.record_step(hot.slice_id, 400.0)
        hv.monitor.record_step(cold.slice_id, 100.0)
    fleet.rebalance()
    h = fleet.handoffs[-1]
    res["handoff"] = (h["tenant"], h["old_device"], h["new_device"],
                      h["moved_requests"], mid)
    print(f"  straggler sweep: {h['tenant']} moved "
          f"{h['old_device']} -> {h['new_device']} with "
          f"{h['moved_requests']} request(s) in flight "
          f"(tokens generated so far: {mid})")

    fleet.run_until_idle()
    assert all(len(r.out_tokens) == 12 for r in reqs)
    served = [e for e in hv.log if e["kind"] == "serve"]
    res["served"] = len(served)
    res["hot_end"] = (fleet.device_of("hot"),
                      fleet.engine_for("hot").steps)
    print(f"  all {len(served)} requests completed; hot finished on "
          f"{fleet.device_of('hot')} "
          f"({fleet.engine_for('hot').steps} steps there)")
    res["streams"] = {r.request_id: list(r.out_tokens)
                      for r in reqs + [cold_req]}
    fleet.close()
    res["devices"] = {d.device_id: d.state.value
                      for d in hv.db.devices.values()}
    print(f"  engines drained and parked; devices: "
          f"{ {d.device_id: d.state.value for d in hv.db.devices.values()} }")
    return res


if __name__ == "__main__":
    main()
