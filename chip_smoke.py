#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (also appended to chiprun_out/chip_smoke/
lines.jsonl):

1. ``build``: compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a, one process per source, all at once) and reports the
   build time, ptxas's registers, spills and static shared memory per
   kernel, and the tensor-core instructions (HMMA, HGMMA) in each
   library's SASS (``cuobjdump -sass``), and every kernel that spills.
   Fails if the flash library has no tensor-core instruction, or if a
   flash kernel (bf16 ``flash_mma_kernel``, fp32 3xTF32
   ``flash_tf32_kernel``) is missing a head dim of ``HEAD_DIMS`` or spills.
2. ``kernel``: each kernel against its plain PyTorch version. Attention at
   the serving path's shapes (B=8, Hq=9, Hkv=3, D=64, L=2048, page 16;
   prefill S 64 to 2048): fp32, bf16, int8 KV, window, an idle slot (the
   mean of V, as the reference), ragged L and S; decode also at B=1 and
   B=64 (many splits and one; each decode record gives the ``n_split``
   its first launch used). Decode (dense and paged; fp32, bf16, int8) at
   the heads of the configs with head dims 96, 112 and 256 (``NEW_HEADS``);
   flash (fp32, bf16) at every head dim at S=1024, at the families'
   prefill shapes, and fp32 at S=1500 with window 256 and softcap 50; flash
   (fp32, bf16, S=1024) and decode (fp32, bf16, int8) also at D 80, a head dim
   outside ``HEAD_DIMS`` that the wrappers zero-pad to 96 (``pad_ms``: the
   padding copies alone). Paged decode (fp32, bf16) also at the harness
   phases' engines: B=4, L=64, pages of 4 and 8, one slot idle. The
   fp32 flash bound is operations over 3xTF32's rate (495 / 3 TFLOP/s),
   with the fp32 CUDA-core bound beside it (``bound_cuda_core_ms``).
   The streaming matmul on
   the paper's stream of 100,000 16x16 / 32x32 products (fp32, bf16) and on
   2-D products (129x257x65, split K with unaligned rows; 4096^3 fp32 and
   bf16), each 2-D record with its launch plan; the 2-D fp32 bound is
   operations over 3xTF32's rate with the CUDA-core bound beside it. The
   SSD scan at mamba2-370m's width (H 32, P 64, N 128, G 1) on the layer's
   strided views: bf16 and fp32 at B=4, S=1024, bf16 at B=8, S=256 (the
   ssm_serve batches), B=1 at S=2048, ragged S=1000, so that both block
   shapes of its plan (64 rows of 4 x 2 warps, 16 rows of 1 x 8) are held;
   y and the final state against the plain sequential version and the
   chunked ``ssd_scan``, with ptxas's registers, shared memory and spills;
   its bound counts the function's 4*P*N operations a token and head over
   the TF32 tensor-core rate of its products (2 TF32 mma a product in bf16,
   3 in fp32), the CUDA-core bound beside it. The 2-D matmul and the SSD
   must give bitwise equal results on two calls.
   Error against the stated tolerance, kernel / plain-version / bound
   times, and the time of one PyTorch library call computing the same
   function (``scaled_dot_product_attention``, ``torch.bmm``,
   ``torch.matmul``; a yardstick only; none for the SSD).
3. ``model``: full-width smollm-135m prefill + decode logits, kernel path
   against the plain path, fp32.
4. ``dense_engine`` / ``paged_engine`` (the serving path): full-width
   30-layer smollm-135m in bfloat16 (seeded torch init) served by
   ``BatchingEngine`` with 8 slots, max_len 2048, 16 requests of 64-1024
   prompt tokens (pairs sharing a 256-token prefix), 32 new tokens each.
   Launch counts must equal what the path needs (layers x decode calls,
   layers x prefill calls); token streams must equal the same engine forced
   onto the plain versions (``kernel_force="ref"``), except from a step
   where the kernel path's token has a plain-path logit within the bf16
   tolerance of the plain path's top logit (counted).
5. ``profile_*``: device busy time and idle share of decode steps, and
   the step's five largest device kernels by time.
5b. serving through the hypervisor, each path with the launch counts zeroed
   before it and read after it, every decode and flash launch accounted
   for (layers x engine decode calls, plus one decode step a configure's
   warm-up; layers x prefill calls):
   ``launch_serve``: the port's launcher (``repro_torch.launch.serve``) at
   full width (smollm-135m, fp32 as the launcher sets it), 2 devices, 3
   tenants, 12 requests, dense and ``--paged``; its own audit (every
   request in ``hv.log`` against a ``vs-`` slice) must hold; tokens/s and
   median latency. ``gateway_fleet``: smollm-135m in bf16 through a paged
   ``GatewayFleet`` (8 slots, max_len 2048) on a Hypervisor over 2 x 2
   devices, four tenants of 2, 2, 2, 1 slots, the 16-request workload of
   phase 4, 32 new tokens, one directed migration of a tenant mid-decode (a
   live hand-off that copies pages); streams against the same fleet on the
   plain path (near-ties counted), one ``serve`` event a request, every pool
   verified and empty after the drain; tokens/s, step and round ms, TTFT,
   steps by engine, and the host ms a decode step of an engine bare and
   bound to the configured program, with the program wrapper's tree
   rebuild alone. ``fleet_chaos``: the reference's chaos workload (4 nodes
   x 1 device, six 2-slot tenants packed on 3 devices and a spare parked, 2
   requests of 64-256 tokens each, 16 new tokens) at full width in fp32;
   a seeded device kill mid-decode in the lockstep loop and through
   ``EventLoop``; token logs against the fault-free run (near-ties
   counted), 4 requests resumed from the journal, the spare woken, the
   invariants after every step; the fault-free run's token logs against
   the same fleet on the plain path at the fp32 tolerance (the bf16
   ``gateway_fleet`` comparison stops most streams at an exact tie; fp32
   ties are rare, so this holds most of the fleet's tokens); and
   Table I's pair on the serving program
   (the first engine's configure against the other engines' PR swaps).
5c. the traffic and tenant-isolation harnesses through the port's fleet and
   gateway, smollm-135m at full width and depth, with the same launch
   accounting (``harness_watch`` observes ``replay_trace`` and
   ``run_scenario`` from outside): ``scale_soak_presets``: bf16,
   ``smoke_cell()`` and the seed-0 chaos cells of both preset traces on
   ``fleet2``, each record equal to its record in
   ``benchmarks/BENCH_scale_baseline.json`` on the baseline's fields (the
   reference added two fields after writing it), and steady / fleet2 /
   seed 0 with chaos through the event loop twice, to identical records.
   ``scale_soak_long``: the same harness at a chat service's request sizes
   (``long_trace()``: prompts of median ~245 tokens up to 1024, outputs of
   median ~25 up to 48, 2 nodes of 8 slots x 2048, 16 rounds of arrivals):
   bf16 lockstep (under the profiler) and event loop with a seeded kill
   and partition, fp32 fault-free on the
   kernel path and on the plain path (token logs at the fp32 tolerance,
   near-ties counted; records equal); arrivals accounted for, invariants
   after every round, pools empty at close, every completed request in
   ``hv.log`` against a ``vs-`` slice; goodput, TTFT, latency, round ms,
   and the fleet's device idle share over the bf16 lockstep run's rounds
   from the profiler. ``adversary``: ``run_scenario`` in bf16 at the
   reference's parameters (4 slots, max_len 64, page 8, 48 rounds), the
   solo run and the four behaviors, each report equal to the JAX
   package's (``tests/data/torch_adversary_reference.json``), the victim
   within the reference suite's bounds, isolation checked after every
   step, the free pages read back from the card, every hostile behavior
   with at least one request admitted; then the solo run and
   ``CancelChurn`` at the serving shape (8 slots, max_len 2048, page 16,
   victim prompts of 256), victim p95 against solo.
6. ``fp32_*_engine``: the same two engines in float32, where the streams
   are held to the fp32 logit tolerance; ``int8_*_engine``: both layouts
   with ``kv_quant`` at 4 layers.
7. ``rc3e`` (the RAaaS path): one ``Hypervisor`` over 2 nodes x 2 devices
   on the card. Four RAaaS tenants deploy the streaming-matmul core through
   admission and ``program_slice`` (Table I: the first configures cold,
   the rest swap it in from the program cache). Table III: 1, 2 and 4
   co-resident cores in a ``FusedShell``, each streaming 100,000 fp32
   16x16 (then 32x32) matrices in blocks of 64, once from pinned host
   memory through its own ``StreamFIFO`` and once from blocks resident on
   the card; per-core and aggregate MB/s are input bytes over wall time;
   every block of core 0 is checked against the plain version and the
   batched kernel must launch exactly cores x cycles times. Then one BAaaS
   ``invoke_service`` and one RSaaS ``program``/``run`` of a 2-D product.
8. ``ssm_model``: full-width, full-depth (48-layer) mamba2-370m prefill of
   2 x 100 tokens + 4 decode steps in fp32, logits on the kernel path
   against the plain chunked path (``kernel_force="ref"``).
9. ``ssm_serve`` (the SSM path): mamba2-370m in bfloat16 (seeded torch
   init, gate norms set to 1) served through ``make_prefill_step`` /
   ``make_serve_step`` with greedy argmax on the device: 4 prompts x 1024
   tokens, then 8 x 256, 32 new tokens each. The plain path, and both paths
   in float32, are then fed the kernel path's tokens, so that every step of
   every stream is compared on the same inputs: the fp32 logits within the
   model phases' tolerance and the fp32 greedy tokens equal but at a
   counted near-tie; the bf16 kernel path no less accurate than the plain
   bf16 path against fp32 (RMS). ``ssd_chunk_scan`` must launch 48 times a
   prefill call and nothing else may launch. Prefill ms, decode step ms,
   tokens/s, and the decode step's device idle share.
10. the dense families (after the int8 engines): ``gemma3_dense_engine`` /
   ``gemma3_paged_engine`` (gemma3-1b, full width and depth: 26 layers, d
   1152, 4 q / 1 kv heads of 256, 5:1 local (window 512) : global,
   qk-norm) and ``phi3_dense_engine`` / ``phi3_paged_engine``
   (phi3-mini-3.8b, 32 layers, d 3072, 32 heads of 96), bf16, the
   serving workload and gates of phase 4; ``profile_phi3_dense_decode``;
   ``families_model`` (fp32, 2 x 600 tokens + 4 decode steps, kernel path
   against the plain path, flash once a layer and decode once a layer a
   step) for both, and for gemma2-9b at full width cut to 4 layers (two
   local/global pairs; attention softcap 50 at D 256, so its decode takes
   the einsum path as the reference's does). Weights are freed between.
11. the ``kernels`` summary line (launches of the attention kernels from
   the smollm, the families', the fleet phases' and the harness phases'
   serving paths, ``launches_by_path``; the flash row's ``fp32`` entry:
   the fp32 S=512 case and fp32 flash's launches on the fp32 engines,
   ``families_model``, ``launch_serve``, ``fleet_chaos`` and
   ``scale_soak_long``; the streaming
   matmul's from the rc3e path, the SSD scan's from the SSM path), the
   GPU's name and power limit, and ``{"ok": true, ...}`` last. Any failed
   check exits non-zero.
"""
import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
MEM_BYTES_S = 3.35e12                              # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# fp32 flash runs as 3xTF32 on the tensor cores: three TF32 products (495
# TFLOP/s dense) per fp32 product
PEAK_FLOPS_3XTF32 = 495e12 / 3
# the SSD's bf16 products split only their fp32 operand: two TF32 products
PEAK_FLOPS_2XTF32 = 495e12 / 2
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
B, HQ, HKV, D, L, PS = 8, 9, 3, 64, 2048, 16
# the paged engines of the soak presets (page 4) and of the adversary's
# reference shape (page 8): 4 slots x 64
HARNESS_B, HARNESS_L, HARNESS_PAGES = 4, 64, (4, 8)
SEED = 0
DEV = "cuda"
MM_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}   # x sqrt(K) atol
RC3E_MATS = 100_000     # the paper's stream, per core (Table III)
RC3E_BLOCK = 64         # matrices per FIFO block (benchmarks/table3_matmul)
RC3E_FIFO_DEPTH = 4
RC3E_PROFILE_CYCLES = 200
SERVING_KERNELS = ("decode_attention", "paged_decode_attention",
                   "flash_attention")
# (Hq, Hkv, D) of the configs with head dims 96, 112 and 256: phi3-mini-3.8b,
# zamba2-7b, gemma3-1b, gemma2-9b
NEW_HEADS = (("d96g1", (32, 32, 96)), ("d112g1", (32, 32, 112)),
             ("d256g4", (4, 1, 256)), ("d256g2", (16, 8, 256)))
# a head dim outside HEAD_DIMS (a multiple of 8 the reference takes): the
# wrappers zero-pad it to 96; smollm's heads
PAD_D = 80
SSM_H, SSM_P, SSM_N = 32, 64, 128      # mamba2-370m's SSD width
SSD_TOL = {torch.float32: dict(atol=5e-4, rtol=5e-3),    # tests/test_kernels
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
SSM_BATCHES = ((4, 1024), (8, 256))    # prompts x tokens, ssm_serve
SSM_NEW_TOKENS = 32
SSM_LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)   # fp32 logits, as model phases
# the bf16 kernel path's RMS logit error against the fp32 plain path, over
# the plain bf16 path's: the two differ only in the SSD's summation order,
# which moves the ratio by under 1% on the H100 (PERF.md)
SSM_BF16_RMS_RATIO = 1.05


class SmokeFailure(Exception):
    pass


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT / "lines.jsonl", "a") as f:
        f.write(line + "\n")


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

_flush = None


def time_ms(fn, iters=20, graph=True):
    """Mean device time of ``fn`` per call, CUDA events around each call,
    with a 256 MB write between calls so every call finds L2 cold (as a
    layer does in the engine: the other layers' caches evict it). With
    ``graph`` the call is captured once in a CUDA graph and replayed, so
    the events time the device's work alone: a kernel of a few microseconds
    would otherwise be timed by its wrapper's host work (argument checks,
    allocation, the launch), which the eager engine pays per call and the
    ``eager_ms`` records show."""
    global _flush
    if _flush is None:
        _flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    for _ in range(3):
        fn()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(g):
            fn()
        run = g.replay
    total = 0.0
    for _ in range(iters):
        _flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def bound(nbytes, flops, dtype):
    t_b = nbytes / MEM_BYTES_S * 1e3
    t_o = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def tc_bound(nbytes, flops, dtype, split=3):
    """A tensor-core kernel's bound: bf16 as ``bound``; fp32 work done as
    ``split`` TF32 products a product on the tensor cores (operations over
    495 / split TFLOP/s, "operations (3xTF32)"), with the fp32 CUDA-core
    bound beside it."""
    if dtype != torch.float32 and split == 3:
        b_ms, b_by = bound(nbytes, flops, dtype)
        return dict(bound_ms=b_ms, bound_by=b_by)
    peak = PEAK_FLOPS_3XTF32 if split == 3 else PEAK_FLOPS_2XTF32
    t_b = nbytes / MEM_BYTES_S * 1e3
    t_o = flops / peak * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o
                else f"operations ({split}xTF32)",
                bound_cuda_core_ms=bound(nbytes, flops, torch.float32)[0])


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def _quant(x):
    amax = x.abs().amax(-1)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x / s[..., None]), -127, 127) \
        .to(torch.int8), s.float()


def decode_inputs(gen, dtype, quant, cur, fill, Lc=L, heads=(HQ, HKV, D)):
    """Dense-cache inputs, one row per entry of ``cur``: row b holds
    positions 0..fill[b]-1 (entries past ``cur`` are stale and masked), the
    rest empty (-1). ``heads``: (Hq, Hkv, D)."""
    dev = DEV
    Bc = len(cur)
    hq, hkv, d = heads
    q = torch.randn((Bc, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((Bc, hkv, Lc, d), generator=gen, device=dev)
    v = torch.randn((Bc, hkv, Lc, d), generator=gen, device=dev)
    ks = vs = None
    if quant:
        k, ks = _quant(k)
        v, vs = _quant(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    ar = torch.arange(Lc, device=dev, dtype=torch.int32)[None]
    fill_t = torch.tensor(fill, device=dev, dtype=torch.int32)[:, None]
    kpos = torch.where(ar < fill_t, ar, torch.full_like(ar, -1))
    cur_t = torch.tensor(cur, device=dev, dtype=torch.int32)
    return q, k, v, kpos.contiguous(), cur_t, ks, vs


def to_pool(gen, k, v, kpos, ks, vs, ps=PS):
    """Scatter a dense cache into a shuffled (P, Hkv, ps, D) page pool with
    page 0 left as the null page; returns pool tensors and block tables."""
    Bc, nb = k.shape[0], k.shape[2] // ps
    P = Bc * nb + 1
    perm = torch.randperm(P - 1, generator=gen, device=DEV) + 1
    bt = perm[:Bc * nb].reshape(Bc, nb).to(torch.int32)

    def scatter(x):
        shp = (P,) + (x.shape[1], ps) + tuple(x.shape[3:]) \
            if x.dim() >= 3 else (P, ps)
        pool = torch.zeros(shp, dtype=x.dtype, device=DEV)
        if x.dim() == 2:                     # kpos (B, L)
            pool.fill_(-1)
            pool[bt.long()] = x.reshape(Bc, nb, ps)
        else:                                # (B, Hkv, L, ...)
            pool[bt.long()] = x.reshape(
                (Bc, x.shape[1], nb, ps) + tuple(x.shape[3:])).movedim(2, 1)
        return pool

    return (scatter(k), scatter(v), scatter(kpos),
            None if ks is None else scatter(ks),
            None if vs is None else scatter(vs), bt)


def sdpa_decode(q, k, v, kpos, cur, window):
    """One library call computing dense decode (timing yardstick)."""
    F = torch.nn.functional
    mask = (kpos >= 0) & (kpos <= cur[:, None])
    if window:
        mask &= (cur[:, None] - kpos) < window
    mask = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)


def decode_cost(q, kpos, cur, window, kvbytes, hkv, paged_nb=0):
    valid = (kpos >= 0) & (kpos <= cur[:, None])
    if window:
        valid &= (cur[:, None] - kpos) < window
    n_valid = int(valid.sum())
    hq, d = q.shape[1], q.shape[2]
    qb = q.element_size()
    nbytes = (2 * q.numel() * qb + kpos.numel() * 4 + cur.numel() * 4
              + n_valid * hkv * d * kvbytes * 2)
    if kvbytes == 1:
        nbytes += n_valid * hkv * 4 * 2                # row scales
    if paged_nb:
        nbytes += kpos.shape[0] * paged_nb * 4         # block table
    return nbytes, 4 * d * hq * n_valid


def pad_cost(q, k, v):
    """For a head dim outside ``HEAD_DIMS``: the dim the wrapper pads to and
    the device time of the padding copies alone (q, k/pool, v/pool; the
    wrapper pays them on every call, inside its ``ms``); else nothing."""
    from repro_torch.kernels.decode_attention import (pad_head_dim,
                                                      padded_head_dim)
    d = q.shape[-1]
    dp = padded_head_dim("pad_cost", d)
    if dp == d:
        return {}
    return dict(padded_to=dp, pad_ms=time_ms(
        lambda: [pad_head_dim(t, dp) for t in (q, k, v)]))


def kernel_phase(results):
    from repro_torch.kernels import _lib
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def batch(n):
        lens = rng.integers(64, 2047, size=n)
        return ([int(x) for x in lens],
                [min(L, int(x) + 1 + int(rng.integers(0, 64))) for x in lens])

    cur, fill = batch(B)
    cur1, fill1 = batch(1)              # n_split large
    cur64, fill64 = batch(64)           # B*Hkv fills the card: one split
    cases = [("fp32", torch.float32, False, 0, cur, fill, L),
             ("bf16", torch.bfloat16, False, 0, cur, fill, L),
             ("int8", torch.bfloat16, True, 0, cur, fill, L),
             ("window256", torch.bfloat16, False, 256, cur, fill, L),
             ("idle_slot", torch.float32, False, 0, [-1] + cur[1:], fill, L),
             ("ragged_L2000", torch.float32, False, 0,
              [min(c, 1990) for c in cur], fill, 2000),
             ("bf16/B1", torch.bfloat16, False, 0, cur1, fill1, L),
             ("bf16/B64", torch.bfloat16, False, 0, cur64, fill64, L)]
    cases = [c + ((HQ, HKV, D),) for c in cases]
    # the new head dims at their configs' heads: phi3-mini (D 96, g 1),
    # zamba2 (D 112, g 1), gemma3-1b (D 256, g 4), gemma2-9b (D 256, g 2)
    for tag, heads in NEW_HEADS:
        for kind, dtype, quant in (("fp32", torch.float32, False),
                                   ("bf16", torch.bfloat16, False),
                                   ("int8", torch.bfloat16, True)):
            cases.append((f"{tag}/{kind}", dtype, quant, 0, cur, fill, L,
                          heads))
    for kind, dtype, quant in (("fp32", torch.float32, False),
                               ("bf16", torch.bfloat16, False),
                               ("int8", torch.bfloat16, True)):
        cases.append((f"d{PAD_D}g3/{kind}", dtype, quant, 0, cur, fill, L,
                      (HQ, HKV, PAD_D)))
    for name, dtype, quant, window, cur_c, fill_c, Lc, heads in cases:
        hq, hkv, d = heads
        q, k, v, kpos, cur_t, ks, vs = decode_inputs(
            gen, dtype, quant, cur_c, [min(f, Lc) for f in fill_c], Lc,
            heads)
        Bc = len(cur_c)
        idle = cur_t < 0
        tol = TOL[dtype]
        kvbytes = k.element_size()
        # dense
        got = da.decode_attention_cuda(q, k, v, kpos, cur_t, window=window,
                                       k_scale=ks, v_scale=vs)
        n_split = _lib.last_plan["decode_attention"][0]
        ref = da.decode_attention_ref(q, k, v, kpos, cur_t, window=window,
                                      k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        require(torch.allclose(got.float(), ref.float(), **tol),
                f"decode_attention {name}: max err {err}")
        if idle.any():        # the mean of the swept V rows, as the reference
            v_deq = v[idle].float() * (vs[idle][..., None] if quant else 1.0)
            mean_v = v_deq.mean(dim=2).repeat_interleave(hq // hkv, dim=1)
            require(torch.allclose(got[idle].float(),
                                   mean_v.to(dtype).float(), **tol),
                    f"decode_attention {name}: idle row is not the mean "
                    "of V")
        nbytes, flops = decode_cost(q, kpos, cur_t, window, kvbytes, hkv)
        b_ms, b_by = bound(nbytes, flops, dtype)
        lib = None if quant else time_ms(sdpa_decode(q, k, v, kpos, cur_t,
                                                      window))
        rec = dict(phase="kernel", name="decode_attention", case=name,
                   shape=dict(B=Bc, Hq=hq, Hkv=hkv, D=d, L=Lc),
                   n_split=n_split,
                   max_abs_err=err, tol=tol,
                   ms=time_ms(lambda: da.decode_attention_cuda(
                       q, k, v, kpos, cur_t, window=window, k_scale=ks,
                       v_scale=vs)),
                   eager_ms=time_ms(lambda: da.decode_attention_cuda(
                       q, k, v, kpos, cur_t, window=window, k_scale=ks,
                       v_scale=vs), graph=False),
                   plain_ms=time_ms(lambda: da.decode_attention_ref(
                       q, k, v, kpos, cur_t, window=window, k_scale=ks,
                       v_scale=vs)),
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                   **pad_cost(q, k, v))
        emit(rec)
        results.setdefault("decode_attention", []).append(rec)
        if Lc % PS:
            continue
        # paged: the same logical cache scattered over a shuffled pool
        kp, vp, kpp, ksp, vsp, bt = to_pool(gen, k, v, kpos, ks, vs)
        got = da.paged_decode_attention_cuda(q, kp, vp, kpp, bt, cur_t,
                                             window=window, k_scale=ksp,
                                             v_scale=vsp)
        n_split = _lib.last_plan["paged_decode_attention"][0]
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        require(torch.allclose(got.float(), ref.float(), **tol),
                f"paged_decode_attention {name}: max err {err}")
        nbytes, flops = decode_cost(q, kpos, cur_t, window, kvbytes, hkv,
                                    paged_nb=bt.shape[1])
        b_ms, b_by = bound(nbytes, flops, dtype)
        rec = dict(phase="kernel", name="paged_decode_attention", case=name,
                   shape=dict(B=Bc, Hq=hq, Hkv=hkv, D=d, L=Lc, ps=PS),
                   n_split=n_split,
                   max_abs_err=err, tol=tol,
                   ms=time_ms(lambda: da.paged_decode_attention_cuda(
                       q, kp, vp, kpp, bt, cur_t, window=window,
                       k_scale=ksp, v_scale=vsp)),
                   eager_ms=time_ms(lambda: da.paged_decode_attention_cuda(
                       q, kp, vp, kpp, bt, cur_t, window=window,
                       k_scale=ksp, v_scale=vsp), graph=False),
                   plain_ms=time_ms(lambda: da.paged_decode_attention_ref(
                       q, kp, vp, kpp, bt, cur_t, window=window,
                       k_scale=ksp, v_scale=vsp)),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   **pad_cost(q, kp, vp))
        emit(rec)
        results.setdefault("paged_decode_attention", []).append(rec)

    # the harness phases' paged engines, 4 slots x 64 at smollm's heads:
    # page 4 (the soak presets' fleets) and page 8 (the adversary's
    # reference shape); the page size picks the kernel's page shift and
    # the split plan's unit. One slot idle, as between requests.
    for ps in HARNESS_PAGES:
        lens = rng.integers(1, HARNESS_L - 1, size=HARNESS_B)
        cur_h = [int(x) for x in lens[:-1]] + [-1]
        fill_h = [min(HARNESS_L, int(x) + 1 + int(rng.integers(0, 8)))
                  for x in lens]
        for kind, dtype in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
            q, k, v, kpos, cur_t, _, _ = decode_inputs(
                gen, dtype, False, cur_h, fill_h, HARNESS_L)
            kp, vp, kpp, _, _, bt = to_pool(gen, k, v, kpos, None, None, ps)
            got = da.paged_decode_attention_cuda(q, kp, vp, kpp, bt, cur_t)
            n_split = _lib.last_plan["paged_decode_attention"][0]
            ref = da.paged_decode_attention_ref(q, kp, vp, kpp, bt, cur_t)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            err = float((got.float() - ref.float()).abs().max())
            require(torch.allclose(got.float(), ref.float(), **tol),
                    f"paged_decode_attention ps{ps}/{kind}: max err {err}")
            nbytes, flops = decode_cost(q, kpos, cur_t, 0, k.element_size(),
                                        HKV, paged_nb=bt.shape[1])
            b_ms, b_by = bound(nbytes, flops, dtype)
            rec = dict(phase="kernel", name="paged_decode_attention",
                       case=f"ps{ps}/{kind}/B{HARNESS_B}/L{HARNESS_L}",
                       shape=dict(B=HARNESS_B, Hq=HQ, Hkv=HKV, D=D,
                                  L=HARNESS_L, ps=ps),
                       n_split=n_split, max_abs_err=err, tol=tol,
                       ms=time_ms(lambda: da.paged_decode_attention_cuda(
                           q, kp, vp, kpp, bt, cur_t)),
                       plain_ms=time_ms(lambda: da.paged_decode_attention_ref(
                           q, kp, vp, kpp, bt, cur_t)),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
            emit(rec)
            results["paged_decode_attention"].append(rec)

    F = torch.nn.functional
    f32, b16 = torch.float32, torch.bfloat16
    flash_cases = [(n, dt, S, w, cap, (HQ, HKV, D)) for n, dt, S, w, cap in (
        ("fp32/S512", f32, 512, 0, 0.0),
        ("fp32/S2048", f32, 2048, 0, 0.0),
        ("fp32/S1500", f32, 1500, 0, 0.0),
        ("bf16/S64", b16, 64, 0, 0.0),
        ("bf16/S256", b16, 256, 0, 0.0),
        ("bf16/S1024", b16, 1024, 0, 0.0),
        ("bf16/S2048", b16, 2048, 0, 0.0),
        ("window256/S2048", f32, 2048, 256, 0.0),
        ("softcap50/S2048", f32, 2048, 0, 50.0),
        ("fp32/S1500/window256/softcap50", f32, 1500, 256, 50.0))]
    # every head dim at S 1024 on smollm's heads (comparable with D 64),
    # then the families' own prefill shapes
    for d in (96, 112, 128, 256):
        for tag, dt in (("fp32", f32), ("bf16", b16)):
            flash_cases.append((f"{tag}/D{d}/S1024", dt, 1024, 0, 0.0,
                                (HQ, HKV, d)))
    flash_cases += [
        (f"fp32/D{PAD_D}/S1024", f32, 1024, 0, 0.0, (HQ, HKV, PAD_D)),
        (f"bf16/D{PAD_D}/S1024", b16, 1024, 0, 0.0, (HQ, HKV, PAD_D)),
        ("phi3/bf16/S1024", b16, 1024, 0, 0.0, (32, 32, 96)),
        ("gemma3/bf16/S1024/window512", b16, 1024, 512, 0.0, (4, 1, 256)),
        ("gemma2/fp32/S1024/softcap50", f32, 1024, 0, 50.0, (16, 8, 256))]
    for name, dtype, S, window, cap, (hq, hkv, d) in flash_cases:
        q = torch.randn((1, hq, S, d), generator=gen, device=DEV).to(dtype)
        k = torch.randn((1, hkv, S, d), generator=gen,
                        device=DEV).to(dtype)
        v = torch.randn((1, hkv, S, d), generator=gen,
                        device=DEV).to(dtype)
        tol = TOL[dtype]
        got = fa.flash_attention_cuda(q, k, v, window=window, softcap=cap)
        ref = fa.flash_attention_ref(q, k, v, window=window, softcap=cap)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        require(torch.allclose(got.float(), ref.float(), **tol),
                f"flash_attention {name}: max err {err}")
        pairs = sum(min(i + 1, window) if window else i + 1
                    for i in range(S))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        lib = None
        if not cap:
            if window:
                i = torch.arange(S, device=DEV)
                wmask = (i[None] <= i[:, None]) & (i[:, None] - i[None]
                                                   < window)
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=wmask, enable_gqa=True))
            else:
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
        rec = dict(phase="kernel", name="flash_attention", case=name,
                   shape=dict(B=1, Hq=hq, Hkv=hkv, D=d, S=S),
                   window=window, softcap=cap,
                   max_abs_err=err, tol=tol,
                   ms=time_ms(lambda: fa.flash_attention_cuda(
                       q, k, v, window=window, softcap=cap)),
                   eager_ms=time_ms(lambda: fa.flash_attention_cuda(
                       q, k, v, window=window, softcap=cap), graph=False),
                   plain_ms=time_ms(lambda: fa.flash_attention_ref(
                       q, k, v, window=window, softcap=cap)),
                   library_ms=lib,
                   **tc_bound(nbytes, 4 * d * hq * pairs, dtype),
                   **pad_cost(q, k, v))
        emit(rec)
        results.setdefault("flash_attention", []).append(rec)


def matmul_kernel_phase(results):
    """The streaming matmul against its plain version: the paper's stream
    of 100,000 products (batched, one launch) and 2-D products, ragged and
    4096^3, the 2-D ones with their plan and repeated bitwise. Library
    yardstick: torch.bmm / torch.matmul (cuBLAS), TF32 off."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import stream_matmul as mm
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    cases = [("batched", "fp32/s16/G100000", torch.float32, (100_000, 16)),
             ("batched", "fp32/s32/G100000", torch.float32, (100_000, 32)),
             ("batched", "bf16/s32/G100000", torch.bfloat16, (100_000, 32)),
             ("2d", "fp32/129x257x65", torch.float32, (129, 257, 65)),
             ("2d", "fp32/4096^3", torch.float32, (4096, 4096, 4096)),
             ("2d", "bf16/4096^3", torch.bfloat16, (4096, 4096, 4096))]
    for kind, case, dtype, dims in cases:
        if kind == "batched":
            G, sz = dims
            M = K = N = sz
            shp_a, shp_b = (G, sz, sz), (G, sz, sz)
            kern, plain = mm.stream_matmul_batched_cuda, mm.matmul_batched_ref
            lib_fn, name = torch.bmm, "stream_matmul_batched"
        else:
            G, (M, K, N) = 1, dims
            shp_a, shp_b = (M, K), (K, N)
            kern, plain = mm.stream_matmul_cuda, mm.matmul_ref
            lib_fn, name = torch.matmul, "stream_matmul"
        a = torch.randn(shp_a, generator=gen, device=DEV).to(dtype)
        b = torch.randn(shp_b, generator=gen, device=DEV).to(dtype)
        got = kern(a, b)
        plan = _lib.last_plan.get(name)
        again = kern(a, b)
        ref = plain(a, b)
        torch.cuda.synchronize()
        tol = dict(atol=MM_TOL[dtype] * K ** 0.5, rtol=MM_TOL[dtype])
        err = float((got.float() - ref.float()).abs().max())
        require(torch.allclose(got.float(), ref.float(), **tol),
                f"{name} {case}: max err {err}")
        el = a.element_size()
        nbytes = G * (M * K + K * N + M * N) * el
        if kind == "2d":               # tensor cores: 3xTF32 in fp32
            require(torch.equal(got, again),
                    f"{name} {case}: two calls differ")
            b_rec = tc_bound(nbytes, 2 * M * N * K, dtype)
        else:                          # the batched kernel: CUDA cores
            b_ms, b_by = bound(nbytes, 2 * G * M * N * K, dtype)
            b_rec = dict(bound_ms=b_ms, bound_by=b_by)
        rec = dict(phase="kernel", name=name, case=case,
                   shape=dict(G=G, M=M, K=K, N=N), max_abs_err=err, tol=tol,
                   ms=time_ms(lambda: kern(a, b)),
                   plain_ms=time_ms(lambda: plain(a, b)), **b_rec,
                   library_ms=time_ms(lambda: lib_fn(a, b)))
        if kind == "2d":
            rec["plan"] = plan._asdict()
        emit(rec)
        results.setdefault("stream_matmul", []).append(rec)


def ssd_kernel_phase(results):
    """The Mamba2 SSD scan against its plain (sequential) version and the
    layer's chunked ``ssd_scan``, at mamba2-370m's width (H 32, P 64,
    N 128, G 1), on the layer's strided views of one (B, S, C) activation;
    y and the final state. No single PyTorch call computes the SSD, so
    there is no library yardstick."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import mamba2_chunk as ssd
    from repro_torch.layers.ssm import ssd_scan
    F = torch.nn.functional
    t_phase = time.monotonic()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    H, P, N, G = SSM_H, SSM_P, SSM_N, 1
    ptxas = _lib.ptxas_table("ssd_chunk_scan")
    shapes = set()
    for case, dtype, Bsz, S in (("bf16/B4/S1024", torch.bfloat16, 4, 1024),
                                ("fp32/B4/S1024", torch.float32, 4, 1024),
                                ("bf16/B8/S256", torch.bfloat16, 8, 256),
                                ("fp32/B1/S2048", torch.float32, 1, 2048),
                                ("fp32/B2/S1000", torch.float32, 2, 1000)):
        C = H * P + 2 * G * N
        xbc = (torch.randn((Bsz, S, C), generator=gen, device=DEV)
               * 0.5).to(dtype)
        xs = xbc[..., :H * P].reshape(Bsz, S, H, P)
        Bm = xbc[..., H * P:H * P + G * N].reshape(Bsz, S, G, N)
        Cm = xbc[..., H * P + G * N:].reshape(Bsz, S, G, N)
        dt = F.softplus(torch.randn((Bsz, S, H), generator=gen, device=DEV)
                        - 1.0)
        A = -torch.exp(torch.randn((H,), generator=gen, device=DEV))
        D = torch.randn((H,), generator=gen, device=DEV)
        args = (xs, dt, A, Bm, Cm, D)
        y, st = ssd.ssd_cuda(*args)
        plan = _lib.last_plan["ssd_chunk_scan"]
        shapes.add((plan.wp, plan.ns))          # the block shape launched
        y2, st2 = ssd.ssd_cuda(*args)
        ry, rs = ssd.ssd_ref(*args)
        cy, cs = ssd_scan(*args, 256)
        torch.cuda.synchronize()
        tol = SSD_TOL[dtype]
        err = float((y.float() - ry.float()).abs().max())
        err_state = float((st - rs).abs().max())
        err_chunked = float(max((y.float() - cy.float()).abs().max(),
                                (st - cs).abs().max()))
        require(tuple(y.shape) == (Bsz, S, H, P) and y.dtype == dtype
                and bool(torch.isfinite(y.float()).all())
                and bool(torch.isfinite(st).all()),
                f"ssd_chunk_scan {case}: shape, dtype or non-finite")
        require(torch.equal(y, y2) and torch.equal(st, st2),
                f"ssd_chunk_scan {case}: two calls differ")
        for name, a, b in (("y", y, ry), ("state", st, rs),
                           ("y vs ssd_scan", y, cy),
                           ("state vs ssd_scan", st, cs)):
            require(torch.allclose(a.float(), b.float(), **tol),
                    f"ssd_chunk_scan {case} {name}: max err "
                    f"{float((a.float() - b.float()).abs().max())}")
        el = xs.element_size()
        nbytes = (2 * Bsz * S * H * P * el + Bsz * S * H * 4
                  + 2 * Bsz * S * G * N * el + Bsz * H * P * N * 4)
        rec = dict(phase="kernel", name="ssd_chunk_scan", case=case,
                   shape=dict(B=Bsz, S=S, H=H, P=P, G=G, N=N),
                   plan=plan._asdict(),
                   max_abs_err=max(err, err_state), max_abs_err_y=err,
                   max_abs_err_state=err_state,
                   max_abs_err_vs_ssd_scan=err_chunked, tol=tol,
                   ms=time_ms(lambda: ssd.ssd_cuda(*args)),
                   plain_ms=time_ms(lambda: ssd.ssd_ref(*args), iters=3),
                   chunked_ms=time_ms(lambda: ssd_scan(*args, 256), iters=5),
                   **tc_bound(nbytes, 4 * P * N * Bsz * S * H, dtype,
                              split=3 if dtype == torch.float32 else 2),
                   library_ms=None,
                   ptxas=ptxas, phase_wall_s=time.monotonic() - t_phase)
        emit(rec)
        results.setdefault("ssd_chunk_scan", []).append(rec)
    require(shapes == {(4, 2), (1, 8)},
            f"ssd_chunk_scan: held the block shapes {sorted(shapes)}, not "
            "(4, 2) and (1, 8) warps")


# ---------------------------------------------------------------------------
# RC3E phase: the paper's RAaaS / BAaaS / RSaaS workflow
# ---------------------------------------------------------------------------

def _stream_core(a, b):
    """The tenant's streaming user core (the paper's section V example):
    one G-block of products per shell cycle."""
    from repro_torch.kernels import ops
    return (ops.matmul_batched(a, b),)


def _matmul_core(a, b):
    """A 2-D product core (BAaaS service, RSaaS program)."""
    from repro_torch.kernels import ops
    return (ops.matmul(a, b),)


def _streams(gen, n_cores, sz):
    """Each core's 100,000 (sz, sz) fp32 A and B, made on the card and
    copied once into pinned host memory (FIFO blocks are slices of it).
    Returns (host pairs, device pairs)."""
    dev = [[torch.randn((RC3E_MATS, sz, sz), generator=gen, device=DEV)
            for _ in range(2)] for _ in range(n_cores)]
    host = []
    for pair in dev:
        host.append([])
        for d in pair:
            h = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
            h.copy_(d)
            host[-1].append(h)
    return host, dev


def _stream_run(shell, n, blocks_of, n_cycles):
    """Run n_cycles shell cycles; core i's inputs come from blocks_of(i);
    returns (wall seconds, core 0's output blocks)."""
    outs0 = []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    srcs = [blocks_of(i) for i in range(n)]
    for _ in range(n_cycles):
        outs = shell.run_cycle({i: srcs[i]() for i in range(n)})
        outs0.append(outs[0][0])
    torch.cuda.synchronize()
    return time.monotonic() - t0, outs0


def _profile_cycles(shell, n, srcs, cycles):
    """Device busy ms and the host's top ops over ``cycles`` shell cycles
    under the profiler (each src returns core i's next blocks)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(cycles):
            shell.run_cycle({i: srcs[i]() for i in range(n)})
        torch.cuda.synchronize()
    ev = prof.key_averages()
    dev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
    host = sorted((e for e in ev
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    return (sum(e.self_device_time_total for e in dev) / 1e3,
            {e.key[:60]: e.self_cpu_time_total / 1e3 / cycles for e in host})


def rc3e_phase():
    """Table I (cold configure vs PR swap) and Table III (1, 2, 4
    co-resident streaming cores, 100,000 fp32 matrices each, from host
    memory through StreamFIFOs and from blocks resident on the card) on one
    Hypervisor; one BAaaS invocation and one RSaaS program/run. Returns the
    launches of this path."""
    from repro_torch.core import (BAaaSSession, ClusterSpec, Hypervisor,
                                  RAaaSSession, RSaaSSession)
    from repro_torch.kernels import _lib
    from repro_torch.kernels import stream_matmul as mm
    from repro_torch.rc2f import (CoreSpec, FusedShell, OutputFIFO,
                                  StreamFIFO, StreamSpec)
    t_phase = time.monotonic()
    _lib.launches.reset()                    # the rc3e path starts here
    hv = Hypervisor(ClusterSpec(n_nodes=2, devices_per_node=2), device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    g = RC3E_BLOCK
    n_cycles = -(-RC3E_MATS // g)
    table1, table3 = [], []
    for sz in (16, 32):
        spec = CoreSpec(f"mm{sz}", (StreamSpec((g, sz, sz)),) * 2,
                        (StreamSpec((g, sz, sz)),))
        sessions = [RAaaSSession(hv, f"tenant{i}") for i in range(4)]
        entries = []
        for i, sess in enumerate(sessions):
            t0 = time.perf_counter()
            entries.append(sess.deploy_core(_stream_core,
                                            spec.example_inputs(),
                                            f"mm{sz}"))
            deploy_ms = (time.perf_counter() - t0) * 1e3
            ev = hv.log[-1]
            require(ev["kind"] == "program" and ev["cache_hit"] == (i > 0),
                    f"rc3e: deploy {i} of mm{sz}: {ev}")
            if i < 2:
                table1.append(dict(core=f"mm{sz}", tenant=i,
                                   path="pr_swap" if i else "full_configure",
                                   program_ms=ev["seconds"] * 1e3,
                                   deploy_ms=deploy_ms))
        host, dev = _streams(gen, 4, sz)
        ref0 = mm.matmul_batched_ref(*dev[0])         # core 0's answer
        tol = dict(atol=MM_TOL[torch.float32] * sz ** 0.5,
                   rtol=MM_TOL[torch.float32])
        in_bytes = 2 * RC3E_MATS * sz * sz * 4          # per core
        # grow the allocator's pool for one run's output blocks up front,
        # so that no timed run pays cudaMalloc (each run's blocks are
        # freed before the next)
        warm = [torch.empty((g, sz, sz), device=DEV) for _ in range(n_cycles)]
        del warm
        for n in (1, 2, 4):
            shell = FusedShell(4, device=DEV)
            for i in range(n):
                shell.load(i, entries[i].compiled, spec, f"tenant{i}")
            rows = {}
            for source in ("host", "resident"):
                if source == "host":
                    fifos = []

                    def blocks_of(i):   # the FIFO starts inside the timing
                        fifos.append(StreamFIFO(depth=RC3E_FIFO_DEPTH,
                                                device=DEV).feed(
                            (host[i][0][j:j + g], host[i][1][j:j + g])
                            for j in range(0, RC3E_MATS, g)))
                        return fifos[-1].get
                else:
                    def blocks_of(i):
                        it = ((dev[i][0][j:j + g], dev[i][1][j:j + g])
                              for j in range(0, RC3E_MATS, g))
                        return lambda: next(it)
                before = _lib.launches["stream_matmul_batched"]
                wall, outs0 = _stream_run(shell, n, blocks_of, n_cycles)
                got = _lib.launches["stream_matmul_batched"] - before
                require(got == n * n_cycles,
                        f"rc3e mm{sz} n={n} {source}: {got} launches != "
                        f"{n * n_cycles}")
                out0 = torch.cat(outs0)
                err = float((out0 - ref0).abs().max())
                require(out0.shape == ref0.shape
                        and bool(torch.isfinite(out0).all())
                        and torch.allclose(out0, ref0, **tol),
                        f"rc3e mm{sz} n={n} {source}: max err {err}")
                del outs0, out0
                if source == "host":
                    require(all(f.items_in == n_cycles for f in fifos),
                            "rc3e: a FIFO lost blocks")
                rows[source] = dict(
                    wall_s=wall, per_core_MBps=in_bytes / wall / 1e6,
                    aggregate_MBps=n * in_bytes / wall / 1e6,
                    max_abs_err_core0=err)
                if n == 4 and sz == 16:     # where the cycle's time goes
                    p = RC3E_PROFILE_CYCLES
                    if source == "host":
                        srcs = [StreamFIFO(depth=RC3E_FIFO_DEPTH, device=DEV)
                                .feed((h[0][j:j + g], h[1][j:j + g])
                                      for j in range(0, p * g, g)).get
                                for h in host[:n]]
                    else:
                        srcs = [blocks_of(i) for i in range(n)]
                    busy_ms, top = _profile_cycles(shell, n, srcs, p)
                    cycle_ms = wall * 1e3 / n_cycles
                    rows[source].update(
                        cycle_ms=cycle_ms,
                        device_busy_ms_per_cycle=busy_ms / p,
                        device_idle_share=1.0 - busy_ms / p / cycle_ms,
                        host_top_ms_per_cycle=top)
            rec = dict(phase="rc3e", table="III", core=f"mm{sz}",
                       cores=n, matrices_per_core=RC3E_MATS, block=g,
                       cycles=n_cycles, launches=n * n_cycles, tol=tol,
                       **{f"{k}_{src}": v for src, r in rows.items()
                          for k, v in r.items()})
            emit(rec)
            table3.append(rec)
        del host, dev, ref0
        for sess in sessions:
            sess.close()

    # BAaaS: a provider service, allocation invisible to the tenant
    gen2 = torch.Generator(device=DEV).manual_seed(SEED + 5)
    a = torch.randn((129, 257), generator=gen2, device=DEV)
    b = torch.randn((257, 65), generator=gen2, device=DEV)
    hv.register_service("matmul-129x257x65",
                        lambda: (_matmul_core, (a, b)))
    out = BAaaSSession(hv, "carol").invoke("matmul-129x257x65", a, b)[0]
    # RSaaS: a whole device, the tenant's own program
    rs = RSaaSSession(hv, "dave")
    rs.program(_matmul_core, (a, b))
    out_rs = rs.run(a, b)[0]
    rs.close()
    ref = mm.matmul_ref(a, b)
    torch.cuda.synchronize()
    tol = dict(atol=MM_TOL[torch.float32] * 257 ** 0.5,
               rtol=MM_TOL[torch.float32])
    require(torch.allclose(out, ref, **tol) and torch.allclose(out_rs, ref,
                                                                **tol),
            "rc3e: BAaaS / RSaaS product disagrees with the plain version")
    require(all(u == 0.0 for u in hv.status()["utilization"].values()),
            "rc3e: allocations not reclaimed")
    launches = dict(_lib.launches)
    for k in ("stream_matmul", "stream_matmul_batched"):
        require(launches[k] > 0, f"rc3e: {k} never launched")
    sink = OutputFIFO(depth=1)
    sink.put((out,))
    require(sink.get()[0].shape == (129, 65), "rc3e: output FIFO")
    emit(dict(phase="rc3e", table="I", rows=table1,
              baas_rsaas_max_abs_err=float(max((out - ref).abs().max(),
                                               (out_rs - ref).abs().max())),
              launches=launches, log_events=len(hv.log),
              wall_s=time.monotonic() - t_phase))
    return launches


# ---------------------------------------------------------------------------
# Model and engine phases
# ---------------------------------------------------------------------------

def plain_cfg(cfg):
    return cfg.replace(geometry=dataclasses.replace(cfg.geometry,
                                                    kernel_force="ref"))


def kernel_vs_plain_logits(cfg, params, n_tok, max_len, steps=4):
    """fp32 prefill of 2 x ``n_tok`` seeded tokens + ``steps`` greedy
    decode steps on the kernel path and on the plain path
    (``kernel_force="ref"``), the same weights. Returns the two (steps + 1,
    2, vocab) logit stacks and the kernel path's launches."""
    from repro_torch.kernels import launches
    from repro_torch.models import Model
    cfg32 = cfg.replace(dtype="float32")
    out, got = {}, {}
    for tag, c in (("kernel", cfg32), ("plain", plain_cfg(cfg32))):
        before = dict(launches)
        m = Model(c, device=DEV)
        gen = np.random.default_rng(SEED)
        toks = torch.from_numpy(gen.integers(0, c.vocab_size, (2, n_tok))
                                .astype(np.int32)).to(DEV)
        h, caches = m.prefill(params, {"tokens": toks}, max_len)
        logs = [m.logits(params, h[:, -1:])[:, 0]]
        nxt = logs[0].argmax(-1).to(torch.int32)
        pos = torch.full((2,), n_tok, dtype=torch.int32, device=DEV)
        for _ in range(steps):
            lg, caches = m.decode(params, caches, nxt[:, None], pos)
            logs.append(lg[:, 0])
            nxt, pos = lg[:, 0].argmax(-1).to(torch.int32), pos + 1
        out[tag] = torch.stack(logs)
        got[tag] = {k: launches[k] - before[k] for k in launches}
        del caches, h
    require(not any(got["plain"].values()),
            f"{cfg.name}: the plain path launched {got['plain']}")
    return out["kernel"], out["plain"], got["kernel"]


def model_phase(cfg, params):
    """Full-width prefill + 4 decode steps, kernel path against the plain
    path, in fp32 (summation order is the only difference)."""
    tol = dict(atol=1e-3, rtol=1e-3)
    a, b, _ = kernel_vs_plain_logits(cfg, params, 100, 256)
    err = float((a - b).abs().max())
    require(bool(torch.isfinite(a).all()), "model: non-finite logits")
    require(tuple(a.shape) == (5, 2, cfg.vocab_size), "model: logits shape")
    require(torch.allclose(a, b, **tol), f"model: max err {err}")
    emit(dict(phase="model", layers=cfg.n_layers, dtype="float32",
              shape=list(a.shape), max_abs_err=err, tol=tol))


def families_model_phase(cfg, params, cut=""):
    """One dense family in fp32 at full width: a prefill of 2 x 600 tokens
    (past gemma3's 512-token window) + 4 decode steps, logits on the kernel
    path against the plain path at the model phase's tolerance. Flash must
    launch once a layer; decode once a layer a step, or never where an
    attention softcap sends decode to the einsum path (gemma2), as in the
    reference. Returns the kernel path's launches."""
    t_phase = time.monotonic()
    tol = dict(atol=1e-3, rtol=1e-3)
    steps = 4
    a, b, got = kernel_vs_plain_logits(cfg, params, 600, 640, steps)
    err = float((a - b).abs().max())
    n_dec = 0 if cfg.attn_softcap else steps * cfg.n_layers
    need = {"flash_attention": cfg.n_layers, "decode_attention": n_dec}
    require(all(got[k] == need[k] for k in need)
            and sum(got.values()) == sum(need.values()),
            f"families_model {cfg.name}: launches {got} != {need}")
    require(bool(torch.isfinite(a).all()),
            f"families_model {cfg.name}: non-finite logits")
    require(tuple(a.shape) == (steps + 1, 2, cfg.vocab_size),
            f"families_model {cfg.name}: logits shape")
    require(torch.allclose(a, b, **tol),
            f"families_model {cfg.name}: max err {err}")
    emit(dict(phase="families_model", arch=cfg.name, layers=cfg.n_layers,
              cut=cut or "none", d_model=cfg.d_model, heads=[
                  cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
              dtype="float32", prompt=[2, 600], decode_steps=steps,
              shape=list(a.shape), max_abs_err=err, tol=tol, launches=got,
              wall_s=time.monotonic() - t_phase))
    return got


def ssm_params(model, seed):
    """Seeded mamba2 weights. The reference's init sets each block's gated
    RMSNorm weight to 0, and ``rms_norm(..., plus_one=False)`` then zeroes
    the block's output, so the SSD would not reach the logits: set it to 1
    (upstream Mamba2's init)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = model.init(gen)
    for st in params["stages"]:
        st["ssm"]["norm"].fill_(1.0)
    return params


def ssm_model_phase(cfg, params):
    """Full-width, full-depth mamba2-370m prefill (2 x 100 tokens) + 4 decode
    steps in fp32: logits on the kernel path against the plain chunked path
    (``kernel_force="ref"``), at the smollm model phase's tolerance."""
    from repro_torch.kernels import _lib
    from repro_torch.models import Model
    tol = SSM_LOGIT_TOL
    cfg32 = cfg.replace(dtype="float32")
    t_phase = time.monotonic()
    out = {}
    for tag, c in (("kernel", cfg32), ("plain", plain_cfg(cfg32))):
        m = Model(c, device=DEV)
        before = _lib.launches["ssd_chunk_scan"]
        toks = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, c.vocab_size, (2, 100)).astype(np.int32)).to(DEV)
        h, caches = m.prefill(params, {"tokens": toks}, 0)
        logs = [m.logits(params, h[:, -1:])[:, 0]]
        nxt = logs[0].argmax(-1).to(torch.int32)
        pos = torch.full((2,), 100, dtype=torch.int32, device=DEV)
        for _ in range(4):
            lg, caches = m.decode(params, caches, nxt[:, None], pos)
            logs.append(lg[:, 0])
            nxt, pos = lg[:, 0].argmax(-1).to(torch.int32), pos + 1
        out[tag] = torch.stack(logs)
        got = _lib.launches["ssd_chunk_scan"] - before
        require(got == (cfg.n_layers if tag == "kernel" else 0),
                f"ssm_model {tag}: {got} ssd_chunk_scan launches")
    a, b = out["kernel"], out["plain"]
    err = float((a - b).abs().max())
    require(bool(torch.isfinite(a).all()), "ssm_model: non-finite logits")
    require(tuple(a.shape) == (5, 2, cfg.vocab_size), "ssm_model: shape")
    require(torch.allclose(a, b, **tol), f"ssm_model: max err {err}")
    emit(dict(phase="ssm_model", layers=cfg.n_layers, dtype="float32",
              shape=list(a.shape), max_abs_err=err, tol=tol,
              wall_s=time.monotonic() - t_phase))


def ssm_generate(model, params, prompts, feed=None):
    """Greedy generation through the serve-step factories: one prefill of
    the (B, S) prompts, then SSM_NEW_TOKENS - 1 decode steps (the first
    token comes from the prefill). With ``feed`` (B, SSM_NEW_TOKENS), step i
    is fed ``feed[:, i - 1]`` instead of the model's own last token, so that
    two paths see the same inputs. Returns (own greedy tokens (B, n) on the
    host, logits (n, B, V) on the device, prefill ms, decode step ms list,
    caches, last tokens, next position)."""
    from repro_torch.runtime import make_prefill_step, make_serve_step
    prefill = make_prefill_step(model, 0)
    step = make_serve_step(model)
    B, S = prompts.shape
    torch.cuda.synchronize()
    t0 = time.monotonic()
    h, caches = prefill(params, {"tokens": prompts})
    logits = [model.logits(params, h[:, -1:])[:, 0]]
    toks = [logits[0].argmax(-1).to(torch.int32)]
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    step_ms = []
    nxt = toks[0] if feed is None else feed[:, 0]
    pos = torch.full((B,), S, dtype=torch.int32, device=DEV)
    for i in range(1, SSM_NEW_TOKENS):
        t0 = time.monotonic()
        lg, caches = step(params, caches, nxt[:, None], pos)
        logits.append(lg[:, 0])
        toks.append(lg[:, 0].argmax(-1).to(torch.int32))
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        nxt = toks[-1] if feed is None else feed[:, i]
        pos = pos + 1
    return (torch.stack(toks, 1).cpu().numpy(), torch.stack(logits),
            prefill_ms, step_ms, caches, nxt, pos)


def _errs(a, b, tol):
    """Max and RMS of |a - b| over all logits, and the share outside
    atol + rtol |b|."""
    e = (a.float() - b.float()).abs()
    out = e > tol["atol"] + tol["rtol"] * b.float().abs()
    return dict(max=float(e.max()), rms=float(e.pow(2).mean().sqrt()),
                share_outside_tol=float(out.float().mean()))


def compare_forced(logits, tol16):
    """Four runs on the same weights and the same tokens at every step (the
    bf16 kernel path's own greedy tokens): ``k16``/``p16`` the bf16 kernel
    and plain paths, ``k32``/``p32`` the same two in fp32. Every step of
    every stream is compared; nothing is excused wholesale.

    * fp32, where the two paths differ by summation order only: every logit
      within SSM_LOGIT_TOL (the model phases' tolerance), and every greedy
      token the plain path's argmax or, at a near-tie (the plain logit of
      the kernel's token within that tolerance of the top), counted; a
      check that excused more than half of the tokens would hold nothing,
      and fails.
    * bf16: over 48 layers bf16 rounding alone moves the logits far past
      the bf16 tolerance (the plain bf16 path against the fp32 one shows
      it), so the bf16 kernel path is held to be no less accurate than the
      plain bf16 path, both measured against the fp32 plain path: RMS
      error at most SSM_BF16_RMS_RATIO times the plain path's."""
    require(all(bool(torch.isfinite(v).all()) for v in logits.values()),
            "ssm_serve: non-finite logits")
    k32, p32 = logits["k32"], logits["p32"]
    err32 = _errs(k32, p32, SSM_LOGIT_TOL)
    require(err32["share_outside_tol"] == 0.0,
            f"ssm_serve fp32: logits outside {SSM_LOGIT_TOL}: {err32}")
    top2 = p32.topk(2, dim=-1).values                    # (n, B, 2)
    best = top2[..., 0]
    mine_idx = k32.argmax(-1)
    mine = p32.gather(-1, mine_idx[..., None])[..., 0]
    differ = mine_idx != p32.argmax(-1)
    near = best - mine <= (SSM_LOGIT_TOL["atol"]
                           + SSM_LOGIT_TOL["rtol"] * best.abs())
    require(not bool((differ & ~near).any()),
            f"ssm_serve fp32: {int((differ & ~near).sum())} greedy tokens "
            "are not the plain path's argmax nor a near-tie")
    n_tok = int(differ.numel())
    excused = int(differ.sum())
    require(2 * excused <= n_tok,
            f"ssm_serve fp32: {excused} of {n_tok} tokens excused")
    k16_err = _errs(logits["k16"], p32, tol16)
    p16_err = _errs(logits["p16"], p32, tol16)
    ratio = k16_err["rms"] / p16_err["rms"]
    require(ratio <= SSM_BF16_RMS_RATIO,
            f"ssm_serve bf16: kernel path RMS error {k16_err['rms']} against "
            f"fp32 is {ratio:.4f}x the plain path's {p16_err['rms']}")
    margin = (top2[..., 0] - top2[..., 1]).flatten().cpu().numpy()
    return dict(
        logits_compared=int(k32.numel()),
        fp32_kernel_vs_plain=err32, fp32_logit_tol=SSM_LOGIT_TOL,
        fp32_tokens_compared=n_tok, fp32_tokens_excused_near_tie=excused,
        fp32_streams_without_excuse=int((~differ).all(0).sum()),
        fp32_plain_margin_p50=float(np.median(margin)),
        bf16_kernel_vs_plain=_errs(logits["k16"], logits["p16"], tol16),
        bf16_kernel_vs_fp32=k16_err, bf16_plain_vs_fp32=p16_err,
        bf16_rms_ratio=ratio,
        bf16_argmax_differ=int((logits["k16"].argmax(-1)
                                != logits["p16"].argmax(-1)).sum()),
        plain_logit_std=float(p32.std()))


def ssm_decode_profile(model, params, caches, nxt, pos, steps=10):
    """Device busy time of ``steps`` decode steps under the profiler; the
    idle share is taken against the wall time of ``steps`` unprofiled
    steps just before (as ``profile_phase``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import make_serve_step
    step = make_serve_step(model)

    def run():
        nonlocal nxt, pos
        for _ in range(steps):
            logits, _ = step(params, caches, nxt[:, None], pos)
            nxt = logits[:, 0].argmax(-1).to(torch.int32)
            pos = pos + 1
        torch.cuda.synchronize()

    run()                                 # warm up
    t0 = time.monotonic()
    run()
    wall_ms = (time.monotonic() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy,
                device_idle_share=1.0 - busy / wall_ms if busy else None,
                device_ops_per_step=sum(e.count for e in dev) / steps,
                top_kernels_ms_per_step={
                    e.key[:80]: e.self_device_time_total / 1e3 / steps
                    for e in top})


def ssm_serve_phase(cfg, params):
    """mamba2-370m in bf16 served through make_prefill_step /
    make_serve_step with greedy argmax on the device: 4 prompts x 1024
    tokens, then 8 x 256, 32 new tokens each, on the kernel path; then the
    plain path, and both paths in fp32, fed the kernel path's tokens
    (``compare_forced``). The SSD kernel must launch once per layer per
    prefill call. Returns the launches of the (bf16) kernel path."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.mamba2_chunk import ssd_plan
    from repro_torch.models import Model
    cfg32 = cfg.replace(dtype="float32")
    models = {"k16": Model(cfg, device=DEV),
              "p16": Model(plain_cfg(cfg), device=DEV),
              "k32": Model(cfg32, device=DEV),
              "p32": Model(plain_cfg(cfg32), device=DEV)}
    tol = TOL[getattr(torch, cfg.dtype)]
    n_heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 7)
    path = {k: 0 for k in _lib.launches}
    for bi, (B, S) in enumerate(SSM_BATCHES):
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                   .astype(np.int32)).to(DEV)
        before = dict(_lib.launches)
        t0 = time.monotonic()
        kt, k_logits, k_pre, k_steps, caches, nxt, pos = ssm_generate(
            models["k16"], params, prompts)
        k_wall = time.monotonic() - t0
        got = {k: _lib.launches[k] - before[k] for k in before}
        for k in path:
            path[k] += got[k]
        require(got["ssd_chunk_scan"] == cfg.n_layers
                and sum(got.values()) == cfg.n_layers,
                f"ssm_serve {B}x{S}: launches {got}, needed "
                f"{cfg.n_layers} ssd_chunk_scan (1 prefill call)")
        require(kt.shape == (B, SSM_NEW_TOKENS)
                and bool(((kt >= 0) & (kt < cfg.vocab_size)).all()),
                f"ssm_serve {B}x{S}: token shape or range")
        prof = ssm_decode_profile(models["k16"], params, caches, nxt, pos) \
            if bi == 0 else None
        del caches
        logits = {"k16": k_logits}
        feed = torch.from_numpy(kt).to(DEV)
        for tag in ("p16", "k32", "p32"):
            before = dict(_lib.launches)
            t0 = time.monotonic()
            _, logits[tag], pre, steps, _, _, _ = ssm_generate(
                models[tag], params, prompts, feed=feed)
            if tag == "p16":
                p_pre, p_steps = pre, steps
                p_wall = time.monotonic() - t0
            n = _lib.launches["ssd_chunk_scan"] - before["ssd_chunk_scan"]
            require(n == (cfg.n_layers if tag == "k32" else 0)
                    and sum(_lib.launches.values()) - sum(before.values())
                    == n, f"ssm_serve {tag}: {n} ssd_chunk_scan launches")
        checks = compare_forced(logits, tol)
        del logits, k_logits
        n_tok = B * SSM_NEW_TOKENS
        rec = dict(phase="ssm_serve", layers=cfg.n_layers, dtype=cfg.dtype,
                   prompts=B, prompt_tokens=S, new_tokens=SSM_NEW_TOKENS,
                   launches=got, ssd_plan=ssd_plan(
                       B, S, n_heads, cfg.ssm.head_dim, cfg.ssm.d_state,
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count)._asdict(),
                   logit_tol=tol, **checks,
                   kernel_path=dict(
                       prefill_ms=k_pre,
                       step_ms_p50=float(np.percentile(k_steps, 50)),
                       step_ms_p95=float(np.percentile(k_steps, 95)),
                       wall_s=k_wall, tokens_per_s=n_tok / k_wall,
                       decode_tokens_per_s=B * len(k_steps)
                       / (sum(k_steps) / 1e3)),
                   plain_path=dict(
                       prefill_ms=p_pre,
                       step_ms_p50=float(np.percentile(p_steps, 50)),
                       wall_s=p_wall, tokens_per_s=n_tok / p_wall))
        if prof is not None:
            rec["profile_decode"] = prof
        rec["phase_wall_s"] = time.monotonic() - t_phase
        emit(rec)
    return path


@contextlib.contextmanager
def engine_calls(calls, top8=None):
    """Count every engine's decode and prefill calls (``calls``) while the
    block runs; with ``top8``, record each decoding slot's top-8 logits,
    keyed (request id, tokens generated so far), for ``compare_streams``."""
    from repro_torch.runtime.serve import BatchingEngine
    dec, pre = BatchingEngine._decode, BatchingEngine._prefill

    def decode(self, tokens, pos):
        calls["decode"] += 1
        logits = dec(self, tokens, pos)
        if top8 is not None:
            top = logits[:, 0].float().topk(8, dim=-1)
            val, idx = top.values.cpu().numpy(), top.indices.cpu().numpy()
            for i, r in enumerate(self._slots):
                if r is not None and i not in self._prefilling:
                    top8[(r.request_id, len(r.out_tokens))] = dict(
                        zip(idx[i].tolist(), val[i].tolist()))
        return logits

    def prefill(self, toks):
        calls["prefill"] += 1
        return pre(self, toks)

    BatchingEngine._decode, BatchingEngine._prefill = decode, prefill
    try:
        yield
    finally:
        BatchingEngine._decode, BatchingEngine._prefill = dec, pre


def program_launches(phase, cfg, calls, configures, paged, got):
    """The launches a serving run needs: one decode launch a layer for every
    engine decode call, plus one a configure of a decode program
    (``Reconfigurator.configure`` warms it up once), one flash launch a
    layer for every prefill call; fails unless ``got`` is exactly that (a
    run that decoded without launching bypassed the kernels)."""
    dec = "paged_decode_attention" if paged else "decode_attention"
    need = {dec: (calls["decode"] + configures) * cfg.n_layers,
            "flash_attention": calls["prefill"] * cfg.n_layers}
    require(all(got[k] == need[k] for k in need)
            and sum(got.values()) == sum(need.values()),
            f"{phase}: launches {got} != needed {need}")
    return need


def workload(vocab, n=16):
    """16 prompts of 64-1024 tokens; requests 4k and 4k+1 share a 256-token
    prefix (same tenant); two tenants."""
    rng = np.random.default_rng(SEED + 1)
    lens = rng.integers(64, 1025, size=n)
    out = []
    for i, n_tok in enumerate(lens):
        toks = rng.integers(0, vocab, size=int(n_tok)).astype(np.int32)
        if i % 4 == 1 and n_tok > 256 and len(out[-1][0]) > 256:
            toks[:256] = out[-1][0][:256]
        out.append((toks, "ab"[(i // 2) % 2]))
    return out


def serve(model, params, prompts, paged, new_tokens=32, top8=None):
    """Serve ``prompts`` to completion; returns (streams, metrics)."""
    from repro_torch.runtime import BatchingEngine
    eng = BatchingEngine(model, params, n_slots=8, max_len=2048, paged=paged,
                         page_size=16)
    calls = {"decode": 0, "prefill": 0}
    step_ms = []
    eng.on_step = lambda active, ms: step_ms.append(ms)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with engine_calls(calls, top8):      # plain path: record its top 8
        reqs = [eng.submit(p, max_new_tokens=new_tokens, tenant=t)
                for p, t in prompts]
        drained = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    require(drained, "engine did not drain")
    ttft = sorted((r.first_token_at - r.submitted_at) * 1e3 for r in reqs)
    n_tok = sum(len(r.out_tokens) for r in reqs)
    require(n_tok == new_tokens * len(reqs), "engine: short streams")
    metrics = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
                   tokens_per_s=n_tok / wall,
                   decode_steps=eng.steps,
                   step_ms_p50=float(np.percentile(step_ms, 50)),
                   step_ms_p95=float(np.percentile(step_ms, 95)),
                   ttft_ms_p50=float(np.percentile(ttft, 50)),
                   ttft_ms_max=ttft[-1],
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   decode_calls=calls["decode"],
                   prefill_calls=calls["prefill"])
    if paged:
        metrics["page_stats"] = eng.page_stats()
    return [r.out_tokens for r in reqs], metrics


def compare_streams(kern, plain, top8, tol):
    """Streams must be equal, except from a step where the token the kernel
    path took has a plain-path logit within the logit tolerance
    (atol + rtol |top|) of the plain path's top logit (a near-tie; bf16
    logits tie exactly at times); the rest of such a stream is not
    compared. Returns the counts."""
    flips = compared = 0
    for rid, (a, b) in enumerate(zip(kern, plain)):
        for i, (x, y) in enumerate(zip(a, b)):
            compared += 1
            if x != y:
                cand = top8[(rid, i)]
                best = max(cand.values())
                require(x in cand and best - cand[x] <=
                        tol["atol"] + tol["rtol"] * abs(best),
                        f"request {rid} token {i}: {x} != {y}, plain "
                        f"logits {cand.get(x)} vs {best}")
                flips += 1
                break
    gaps = [sorted(c.values())[-1] - sorted(c.values())[-2]
            for c in top8.values()]
    return dict(streams_equal=flips == 0, divergent_steps_within_tol=flips,
                tokens_compared=compared, min_plain_margin=min(gaps),
                plain_steps_with_tie=sum(g == 0 for g in gaps))


def engine_phase(phase, cfg, params, prompts, paged):
    """Serve ``prompts`` on the kernel path and on the plain path; check the
    launches and compare the streams at the logit tolerance of the
    config's dtype."""
    from repro_torch.kernels import launches
    from repro_torch.models import Model
    before = dict(launches)
    kern, km = serve(Model(cfg, device=DEV), params, prompts, paged)
    got = {k: launches[k] - before[k] for k in launches}
    top8 = {}
    plain, pm = serve(Model(plain_cfg(cfg), device=DEV), params, prompts,
                      paged, top8=top8)
    require(all(launches[k] - before[k] == got[k] for k in launches),
            "plain path launched a kernel")
    need = program_launches(phase, cfg, dict(decode=km["decode_calls"],
                                             prefill=km["prefill_calls"]),
                            0, paged, got)
    tol = TOL[getattr(torch, cfg.dtype)]
    streams = compare_streams(kern, plain, top8, tol)
    emit(dict(phase=phase, arch=cfg.name, layers=cfg.n_layers,
              dtype=cfg.dtype, kv_quant=cfg.kv_quant, paged=paged,
              launches=got,
              launches_needed=need, logit_tol=tol, **streams,
              kernel_path=km, plain_path=pm))


def profile_phase(phase, cfg, params, prompts, paged):
    """Device busy time over 10 steady decode steps under the profiler;
    the idle share is taken against the wall time of 10 unprofiled steps
    just before (the profiler itself slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import Model
    from repro_torch.runtime import BatchingEngine
    eng = BatchingEngine(Model(cfg, device=DEV), params, n_slots=8,
                         max_len=2048, paged=paged, page_size=16)
    for p, t in prompts[:8]:
        eng.submit(p, max_new_tokens=64, tenant=t)     # 3 + 20 steps
    for _ in range(3):
        eng.step()                      # admit + warm up
    steps = 10
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.monotonic() - t0) * 1e3 / steps
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    emit(dict(phase=phase, steps=steps, wall_ms_per_step=wall_ms,
              profiled_wall_ms_per_step=prof_wall_ms,
              device_busy_ms_per_step=busy,
              device_idle_share=1.0 - busy / wall_ms if busy else None,
              device_ops_per_step=sum(e.count for e in dev) / steps,
              top_kernels_ms_per_step={
                  e.key[:80]: e.self_device_time_total / 1e3 / steps
                  for e in top}))


# ---------------------------------------------------------------------------
# Serving through the hypervisor: the launcher, the gateway fleet, chaos
# ---------------------------------------------------------------------------

# (tenant, vSlice slots) of gateway_fleet; request i goes to tenant
# (i // 2) % 4, so the shared-prefix pairs of ``workload`` share a tenant
FLEET_TENANTS = (("t0", 2), ("t1", 2), ("t2", 2), ("t3", 1))
FLEET_MIGRATE_AT = 8            # round of the directed migration of t3
CHAOS_TENANTS, CHAOS_REQS, CHAOS_NEW_TOKENS = 6, 2, 16


def launch_serve_phase():
    """The port's launcher (``repro_torch.launch.serve``) at full width:
    smollm-135m in fp32 (as the launcher sets it), 2 devices, 3 tenants, 12
    requests, dense then paged. The launcher's own audit must hold; its
    printed output goes to ``OUT / "launch_serve_{dense,paged}.txt"``.
    Returns the launches of both runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve as launcher
    cfg = get_config("smollm-135m")
    total = {k: 0 for k in _lib.launches}
    for paged in (False, True):
        t_phase = time.monotonic()
        args = ["--arch", "smollm-135m", "--devices", "2", "--tenants", "3",
                "--requests", "12", "--device", DEV] \
            + (["--paged"] if paged else [])
        buf = io.StringIO()
        calls = {"decode": 0, "prefill": 0}
        _lib.launches.reset()
        with engine_calls(calls), contextlib.redirect_stdout(buf):
            out = launcher.main(args)
        got = dict(_lib.launches)
        text = buf.getvalue()
        (OUT / f"launch_serve_{'paged' if paged else 'dense'}.txt") \
            .write_text(text)
        audit = [ln for ln in text.splitlines() if ln.startswith("audit:")]
        require(out["serve_events"] == out["requests"] == 12
                and all(sl.startswith("vs-") for sl in out["slices"])
                and audit, f"launch_serve: audit failed: {out}")
        need = program_launches("launch_serve", cfg, calls, 1, paged, got)
        for k in total:
            total[k] += got[k]
        emit(dict(phase="launch_serve", arch=cfg.name, dtype="float32",
                  paged=paged, argv=args, requests=out["requests"],
                  tokens=out["tokens"], wall_s=out["wall_s"],
                  tokens_per_s=out["tokens_per_s"],
                  median_latency_ms=out["median_latency_ms"],
                  engines=out["engines"], audit=audit[0], launches=got,
                  launches_needed=need, engine_calls=calls,
                  phase_wall_s=time.monotonic() - t_phase))
    return total


def fleet_serve(model, params, prompts, top8=None, new_tokens=32):
    """``prompts`` through a paged ``GatewayFleet`` (8 slots, max_len 2048)
    on a Hypervisor over 2 nodes x 2 devices, four tenants
    (``FLEET_TENANTS``); at round ``FLEET_MIGRATE_AT`` tenant t3 is moved
    to a parked device mid-decode (a live hand-off, pages copied). Returns
    (streams, metrics, hv, fleet, engine calls)."""
    from repro_torch.core import ClusterSpec, DeviceState, Hypervisor
    from repro_torch.runtime import GatewayFleet
    calls = {"decode": 0, "prefill": 0}
    with engine_calls(calls, top8):
        hv = Hypervisor(ClusterSpec(n_nodes=2, devices_per_node=2),
                        device=DEV)
        fleet = GatewayFleet(hv, model, params, n_slots=8, max_len=2048,
                             paged=True, page_size=16)
        for t, slots in FLEET_TENANTS:
            fleet.open_session(t, slots=slots)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        reqs = [fleet.submit(FLEET_TENANTS[(i // 2) % 4][0], p,
                             max_new_tokens=new_tokens)
                for i, (p, _) in enumerate(prompts)]
        rounds, engine_ms, handoff = [], [], None
        for rnd in range(10000):
            if rnd == FLEET_MIGRATE_AT:
                dst = sorted(d for d, dv in hv.db.devices.items()
                             if dv.state == DeviceState.PARKED)[0]
                require(hv.migrate_slice(fleet.session("t3").slice_id,
                                         target_device=dst, reason="ops")
                        is not None, "gateway_fleet: migration refused")
                handoff = fleet.handoffs[-1]
            t1 = time.monotonic()
            fleet.step()
            rounds.append((time.monotonic() - t1) * 1e3)
            engine_ms.extend(fleet.last_round_ms.values())
            if all(r.done.is_set() for r in reqs):
                break
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    require(all(r.done.is_set() for r in reqs), "gateway_fleet: not drained")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    require(n_tok == new_tokens * len(reqs), "gateway_fleet: short streams")
    ttft = [(r.first_token_at - r.submitted_at) * 1e3 for r in reqs]
    metrics = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
                   tokens_per_s=n_tok / wall, rounds=len(rounds),
                   round_ms_p50=float(np.percentile(rounds, 50)),
                   round_ms_p95=float(np.percentile(rounds, 95)),
                   step_ms_p50=float(np.percentile(engine_ms, 50)),
                   step_ms_p95=float(np.percentile(engine_ms, 95)),
                   ttft_ms_p50=float(np.percentile(ttft, 50)),
                   steps_by_engine={d: e.steps
                                    for d, e in fleet._engines.items()},
                   handoff=handoff)
    return [r.out_tokens for r in reqs], metrics, hv, fleet, calls


def program_overhead(model, params, prompts):
    """Host ms a decode step of one paged engine (8 slots, 8 requests in
    decode) bare and bound to the program the hypervisor configured
    (``use_program``), in turns bare, program, program, bare of 10 steps
    each; and the host time of the program wrapper's rebuild of the
    parameter and cache trees alone (``_device_program``), per call."""
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.core.reconfig import _device_program
    from repro_torch.runtime import BatchingEngine
    from repro_torch.runtime.gateway import serve_example
    from repro_torch.runtime.serve import make_paged_serve_step
    eng = BatchingEngine(model, params, n_slots=8, max_len=2048, paged=True,
                         page_size=16)
    for p, t in prompts[:8]:
        eng.submit(p, max_new_tokens=64, tenant=t)
    for _ in range(3):
        eng.step()
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1), device=DEV)
    entry, _, _ = hv.reconfig.partial_reconfigure(
        make_paged_serve_step(model),
        serve_example(model, params, 8, 2048, True, 16, eng.cache_pages),
        static_desc="program_overhead")
    bare = eng._decode_fn
    ms = {"bare": [], "program": []}
    for tag in ("bare", "program", "program", "bare"):
        eng.use_program(bare if tag == "bare" else entry.compiled)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(10):
            eng.step()
        torch.cuda.synchronize()
        ms[tag].append((time.monotonic() - t0) * 1e3 / 10)
    args = (params, eng.caches, torch.zeros((8, 1), dtype=torch.int32,
                                            device=DEV),
            torch.zeros((8,), dtype=torch.int32, device=DEV),
            eng._block_tables_dev())
    # the wrapper the program cache holds, around a step that does nothing
    place = _device_program(lambda *a: None, hv.reconfig.device)
    t0 = time.monotonic()
    for _ in range(100):
        place(*args)
    wrap_ms = (time.monotonic() - t0) * 1e3 / 100
    return dict(step_host_ms_bare=ms["bare"],
                step_host_ms_program=ms["program"],
                program_wrapper_host_ms=wrap_ms)


def gateway_fleet_phase(cfg, params, prompts):
    """Full-width smollm-135m (bf16) through the paged ``GatewayFleet``
    (``fleet_serve``): the 16-request workload, 32 new tokens each, four
    tenants, one live hand-off mid-decode; the same fleet on the plain path
    (``kernel_force="ref"``) gives the reference streams. Gates: the
    launches the kernel path needs through the fleet's program path, the
    streams (near-ties counted), one ``serve`` event a request in
    ``hv.log`` against a ``vs-`` slice, a hand-off that copied pages, every
    pool verified and empty after the drain. Returns the kernel run's
    launches."""
    from repro_torch.kernels import _lib
    from repro_torch.models import Model
    t_phase = time.monotonic()
    _lib.launches.reset()
    kern, km, hv, fleet, calls = fleet_serve(Model(cfg, device=DEV), params,
                                             prompts)
    got = dict(_lib.launches)
    configures = sum(1 for e in hv.log if e["kind"] in ("fleet_up",
                                                         "engine_up")
                     and not e["cache_hit"])
    need = program_launches("gateway_fleet", cfg, calls, configures, True,
                            got)
    serve_events = [e for e in hv.log if e["kind"] == "serve"]
    require(len(serve_events) == len(prompts)
            and len({e["request"] for e in serve_events}) == len(prompts)
            and all(e["slice"].startswith("vs-") for e in serve_events),
            f"gateway_fleet: {len(serve_events)} serve events for "
            f"{len(prompts)} requests")
    require(km["handoff"] is not None and km["handoff"]["page_copied"] >= 1,
            f"gateway_fleet: the hand-off copied no pages: {km['handoff']}")
    for eng in fleet._engines.values():
        eng.pool.verify()
        require(eng.pool.used_pages == 0,
                f"gateway_fleet: {eng.pool.used_pages} pages still held")
    fleet.close()
    before = dict(_lib.launches)
    top8 = {}
    plain, pm, phv, pfleet, _ = fleet_serve(Model(plain_cfg(cfg),
                                                  device=DEV),
                                            params, prompts, top8=top8)
    require(dict(_lib.launches) == before, "plain fleet launched a kernel")
    pfleet.close()
    streams = compare_streams(kern, plain, top8, TOL[torch.bfloat16])
    overhead = program_overhead(Model(cfg, device=DEV), params, prompts)
    emit(dict(phase="gateway_fleet", arch=cfg.name, layers=cfg.n_layers,
              dtype=cfg.dtype, tenants=dict(FLEET_TENANTS),
              launches=got, launches_needed=need, engine_calls=calls,
              configures=configures, serve_events=len(serve_events),
              **streams, kernel_path=km,
              plain_path=dict(tokens_per_s=pm["tokens_per_s"],
                              step_ms_p50=pm["step_ms_p50"]),
              **overhead, phase_wall_s=time.monotonic() - t_phase))
    return got


def chaos_run(cfg, model, params, prompts, loop="lockstep", injector=None,
              top8=None, calls=None):
    """The reference's chaos workload (tests/test_chaos.py) at full width:
    a paged fleet (4 slots, max_len 512) on 4 nodes x 1 device sharing the
    injector's clock, six 2-slot tenants packed on 3 devices and one spare
    parked, 2 requests each, ``CHAOS_NEW_TOKENS`` new tokens; invariants
    verified after every step or tick. Returns (streams, hv, fleet)."""
    from repro_torch.core import ClusterSpec, Hypervisor, MonitorConfig
    from repro_torch.runtime import EventLoop, GatewayFleet
    from repro_torch.runtime.faults import FakeClock
    calls = calls if calls is not None else {"decode": 0, "prefill": 0}
    with engine_calls(calls, top8):
        clock = injector.clock if injector is not None else FakeClock()
        hv = Hypervisor(ClusterSpec(n_nodes=4, devices_per_node=1),
                        MonitorConfig(heartbeat_interval_s=1.0,
                                      heartbeat_deadline_s=2.5),
                        clock=clock, device=DEV)
        fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=512,
                             paged=True, faults=injector)
        for ti in range(CHAOS_TENANTS):
            fleet.open_session(f"t{ti}", slots=2)
        require(len(fleet._engines) == 3, "fleet_chaos: not packed on 3")
        reqs = [fleet.submit(f"t{ti}", prompts[ti * CHAOS_REQS + k],
                             max_new_tokens=CHAOS_NEW_TOKENS)
                for ti in range(CHAOS_TENANTS) for k in range(CHAOS_REQS)]
        ev = EventLoop(fleet, prefill_chunk=64) if loop == "event" else None
        for _ in range(400):
            fleet.step() if ev is None else ev.run_ticks(1)
            fleet.verify_invariants()
            if all(r.done.is_set() for r in reqs):
                break
        if ev is not None:
            fleet.flush_journal()
    require(all(r.done.is_set() for r in reqs)
            and all(len(r.out_tokens) == CHAOS_NEW_TOKENS for r in reqs),
            f"fleet_chaos {loop}: the workload did not drain")
    for eng in fleet._engines.values():
        eng.pool.verify()
        require(eng.pool.used_pages == 0,
                f"fleet_chaos {loop}: pages still held")
    return [r.out_tokens for r in reqs], hv, fleet


def fleet_chaos_phase(cfg, params):
    """The chaos workload in fp32 (a replayed request re-prefills through
    flash instead of decoding; fp32 keeps near-ties rare): a fault-free
    lockstep run, then one seeded device kill mid-decode
    (``FaultInjector(seed=0).plan_device_kill``, rounds 2-5) in the
    lockstep loop and through ``EventLoop``. Gates: the token logs equal the
    fault-free run's (near-ties counted), 4 requests resumed from the
    journal, the spare device woken, the invariants after every step, the
    launches the path needs; the fault-free run's token logs equal the same
    fleet's on the plain path (``runs["plain"]``, near-ties counted). Then Table I's pair on the serving program:
    the configure time against the PR swaps of the other engines. Returns
    the launches."""
    from repro_torch.core import DeviceState
    from repro_torch.kernels import _lib
    from repro_torch.models import Model
    from repro_torch.runtime import FaultInjector
    t_phase = time.monotonic()
    cfg = cfg.replace(dtype="float32")
    model = Model(cfg, device=DEV)
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 257,
                                     size=CHAOS_TENANTS * CHAOS_REQS)]
    calls = {"decode": 0, "prefill": 0}
    configures = 0
    _lib.launches.reset()
    top8 = {}
    free, fhv, ffleet = chaos_run(cfg, model, params, prompts, top8=top8,
                                  calls=calls)
    up = [e for e in fhv.log if e["kind"] in ("fleet_up", "engine_up")]
    configures += sum(not e["cache_hit"] for e in up)
    table1 = dict(configure_s=next(e["compile_s"] for e in up
                                   if e["kind"] == "fleet_up"),
                  pr_swap_s=[e["swap_s"] for e in up
                             if e["kind"] == "engine_up"],
                  pr_swap_cache_hits=[e["cache_hit"] for e in up
                                      if e["kind"] == "engine_up"])
    ffleet.close()
    tol = TOL[torch.float32]
    runs = {}
    for loop in ("lockstep", "event"):
        inj = FaultInjector(seed=0)
        ev = inj.plan_device_kill(["dev-0-0", "dev-1-0", "dev-2-0"], lo=2,
                                  hi=6)
        got, hv, fleet = chaos_run(cfg, model, params, prompts, loop=loop,
                                   injector=inj, calls=calls)
        configures += sum(not e["cache_hit"] for e in hv.log
                          if e["kind"] in ("fleet_up", "engine_up"))
        rec = fleet.recoveries
        require(len(rec) == 1 and rec[0]["resumed"] == 4
                and not rec[0]["evicted"],
                f"fleet_chaos {loop}: recoveries {rec}")
        require(hv.db.devices[ev.target].state == DeviceState.DEAD
                and hv.db.devices["dev-3-0"].state == DeviceState.ACTIVE,
                f"fleet_chaos {loop}: the spare did not wake")
        runs[loop] = dict(kill=dict(step=ev.step, device=ev.target),
                          recovery=rec[0],
                          **compare_streams(got, free, top8, tol))
        fleet.close()
    got = dict(_lib.launches)
    need = program_launches("fleet_chaos", cfg, calls, configures, True,
                            got)
    # the fault-free fleet on the plain path: the kernel path's token logs
    # against plain at the fp32 tolerance
    top8_plain = {}
    plain, phv, pfleet = chaos_run(plain_cfg(cfg), Model(plain_cfg(cfg),
                                                         device=DEV),
                                   params, prompts, top8=top8_plain)
    require(dict(_lib.launches) == got, "plain chaos fleet launched a kernel")
    pfleet.close()
    runs["plain"] = compare_streams(free, plain, top8_plain, tol)
    emit(dict(phase="fleet_chaos", arch=cfg.name, layers=cfg.n_layers,
              dtype=cfg.dtype, tenants=CHAOS_TENANTS,
              requests=len(prompts), new_tokens=CHAOS_NEW_TOKENS,
              logit_tol=tol, runs=runs, launches=got, launches_needed=need,
              engine_calls=calls, phase_wall_s=time.monotonic() - t_phase))
    emit(dict(phase="fleet_chaos", table="I", program="serve decode step",
              **table1))
    return got


# ---------------------------------------------------------------------------
# The traffic and tenant-isolation harnesses: trace-replay soak, adversary
# ---------------------------------------------------------------------------

SOAK_BASELINE = ROOT / "benchmarks" / "BENCH_scale_baseline.json"
ADVERSARY_REFERENCE = ROOT / "tests" / "data" \
    / "torch_adversary_reference.json"
# scale_soak_long's event-loop run: context tokens accounted a prefill
# event (the reference's default of 4 would keep a 245-token median prompt
# prefilling for ~60 engine events)
LONG_PREFILL_CHUNK = 256
# scale_soak_long's rounds of arrivals, cut from 32 to keep the three
# harness phases near 180 s (the lengths are not cut)
LONG_HORIZON = 16


def long_trace():
    """scale_soak_long: the soak harness at the request sizes a chat service
    sees (median prompt ~245 tokens, capped at 1024; median output ~25,
    capped at 48) on 2 one-device nodes of 8 slots x 2048."""
    from repro_torch.runtime.loadgen import FleetSpec, TraceSpec
    trace = TraceSpec(
        name="long", horizon=LONG_HORIZON, base_rate=0.5,
        burst_rate_mult=3.0, burst_on_mean=4.0, burst_off_mean=8.0,
        diurnal_period=16, diurnal_amp=0.5, tenants=4, zipf_s=1.1,
        prompt_len_mu=5.5, prompt_len_sigma=0.8, prompt_len_max=1024,
        out_tokens_mu=3.2, out_tokens_sigma=0.5, out_tokens_max=48)
    fleet = FleetSpec(name="long2", n_nodes=2, devices_per_node=1,
                      n_slots=8, max_len=2048, page_size=16,
                      device_draws=(1.0, 2.0))
    return trace, fleet


def _sorted_json(obj):
    return json.dumps(obj, sort_keys=True)


@contextlib.contextmanager
def harness_watch(w, top8=None):
    """Observe ``replay_trace`` and ``run_scenario`` from outside, through
    the classes they drive: engine decode and prefill calls
    (``engine_calls``), configures of a decode program, the requests
    submitted, every fleet round's wall ms and ``verify_invariants``
    after it; and, when a fleet closes, the requests the drain bound left
    unfinished cancelled through ``GatewayFleet.cancel``, then every pool
    verified and empty, and every completed request's ``serve`` event in
    ``hv.log`` (against a ``vs-`` slice) collected."""
    from repro_torch.core.reconfig import Reconfigurator
    from repro_torch.runtime.events import EventLoop
    from repro_torch.runtime.fleet import GatewayFleet
    w.update(calls={"decode": 0, "prefill": 0}, configures=0, reqs=[],
             round_ms=[], serve_events=[], cancelled_at_close=0)
    configure, submit = Reconfigurator.configure, GatewayFleet.submit
    step, ticks, close = GatewayFleet.step, EventLoop.run_ticks, \
        GatewayFleet.close

    def counted_configure(self, *a, **kw):
        w["configures"] += 1
        return configure(self, *a, **kw)

    def watched_submit(self, *a, **kw):
        req = submit(self, *a, **kw)
        w["reqs"].append(req)
        return req

    def round_of(run, fleet_of):
        def watched(self, *a, **kw):
            t0 = time.monotonic()
            out = run(self, *a, **kw)
            w["round_ms"].append((time.monotonic() - t0) * 1e3)
            fleet_of(self).verify_invariants()
            return out
        return watched

    def checked_close(self):
        for req in w["reqs"]:
            if not req.done.is_set():
                require(self.cancel(req), f"request {req.request_id}: "
                        "cancel of an unfinished request refused")
                w["cancelled_at_close"] += 1
        for eng in self._engines.values():
            eng.pool.verify()
            require(eng.pool.used_pages == 0,
                    f"{eng.pool.used_pages} pages still held at close")
        w["serve_events"] += [e for e in self.hv.log
                              if e["kind"] == "serve"]
        return close(self)

    Reconfigurator.configure = counted_configure
    GatewayFleet.submit = watched_submit
    GatewayFleet.step = round_of(step, lambda f: f)
    EventLoop.run_ticks = round_of(ticks, lambda ev: ev.fleet)
    GatewayFleet.close = checked_close
    try:
        with engine_calls(w["calls"], top8):
            yield w
    finally:
        Reconfigurator.configure, GatewayFleet.submit = configure, submit
        GatewayFleet.step, EventLoop.run_ticks = step, ticks
        GatewayFleet.close = close


def harness_gates(phase, cfg, w, got, launch=True):
    """The gates every soak run shares: the launches the run needs (one
    paged decode launch a layer for every engine decode call and every
    configure's warm-up step, one flash launch a layer for every prefill
    call), and one ``serve`` event in ``hv.log`` against a ``vs-`` slice
    for every request that completed. Returns the launches needed."""
    done = {r.request_id for r in w["reqs"] if r.done.is_set()
            and r.finish_reason != "cancelled"}
    served = [e for e in w["serve_events"] if e["request"] in done]
    require(len(served) == len(done)
            and {e["request"] for e in served} == done
            and all(e["slice"].startswith("vs-") for e in served),
            f"{phase}: {len(served)} serve events for {len(done)} "
            "completed requests")
    if not launch:
        require(sum(got.values()) == 0, f"{phase}: the plain path launched "
                f"{got}")
        return {}
    return program_launches(phase, cfg, w["calls"], w["configures"], True,
                            got)


def soak_run(phase, cfg, model, params, trace, fleet, seed, top8=None,
             **kw):
    """One ``replay_trace`` on the card under ``harness_watch``; the
    launches gated (none on the plain path). Returns (record, watch,
    metrics)."""
    from repro_torch.kernels import _lib
    from repro_torch.runtime.loadgen import replay_trace
    w = {}
    before = dict(_lib.launches)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with harness_watch(w, top8):
        rec = replay_trace(trace, fleet, seed, model, params, device=DEV,
                           **kw)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    got = {k: _lib.launches[k] - before[k] for k in _lib.launches}
    need = harness_gates(phase, cfg, w, got,
                         launch=cfg.geometry.kernel_force != "ref")
    m = rec["metrics"]
    require(m["completed"] + m["cancelled"] + m["incomplete"]
            + m["rejected"] == m["arrivals"],
            f"{phase}: arrivals not accounted for: {m}")
    require(w["cancelled_at_close"] == m["incomplete"],
            f"{phase}: {w['cancelled_at_close']} unfinished requests at "
            f"close, the record says {m['incomplete']}")
    done = [r for r in w["reqs"] if r.done.is_set()
            and r.finish_reason == "length"]
    ttft = [(r.first_token_at - r.submitted_at) * 1e3 for r in done]
    lat = [(r.finished_at - r.submitted_at) * 1e3 for r in done]
    metrics = dict(
        wall_s=wall, tokens_out=m["tokens_out"], rounds=m["rounds"],
        tokens_per_s=m["tokens_out"] / wall,
        goodput_tokens_per_round=m["goodput_tokens_per_round"],
        round_ms_p50=float(np.percentile(w["round_ms"], 50)),
        round_ms_p95=float(np.percentile(w["round_ms"], 95)),
        ttft_ms_p50=float(np.percentile(ttft, 50)) if ttft else None,
        ttft_ms_p95=float(np.percentile(ttft, 95)) if ttft else None,
        latency_ms_p50=float(np.percentile(lat, 50)) if lat else None,
        latency_ms_p95=float(np.percentile(lat, 95)) if lat else None,
        peak_active_devices=m["peak_active_devices"],
        engine_calls=dict(w["calls"]), configures=w["configures"],
        launches=got, launches_needed=need)
    return rec, w, metrics


def scale_soak_presets_phase(cfg, params):
    """smollm-135m at full width and depth (bf16) through the port's
    ``replay_trace`` on the card: ``smoke_cell()``, the chaos cells of
    seed 0 of both preset traces on ``fleet2`` (lockstep), each record
    equal to its record in the committed baseline on the baseline's
    fields; then steady / fleet2 / seed 0 with chaos through the event
    loop, twice, to identical records. Returns the launches."""
    from repro_torch.kernels import _lib
    from repro_torch.models import Model
    from repro_torch.runtime.loadgen import (preset_fleets, preset_traces,
                                             smoke_cell)
    from soak_baseline import on_baseline_fields
    t_phase = time.monotonic()
    committed = {_sorted_json(r["cell"]): r
                 for r in json.loads(SOAK_BASELINE.read_text())["records"]}
    model = Model(cfg, device=DEV)
    fleet2 = preset_fleets()[0]
    cells = [smoke_cell() + (False,)] + [(t, fleet2, 0, True)
                                         for t in preset_traces()]
    _lib.launches.reset()
    for trace, fleet, seed, chaos in cells:
        rec, w, metrics = soak_run("scale_soak_presets", cfg, model, params,
                                   trace, fleet, seed, chaos=chaos)
        base = committed[_sorted_json(rec["cell"])]
        equal = (_sorted_json(on_baseline_fields(rec, base))
                 == _sorted_json(base))
        require(equal, f"scale_soak_presets {rec['cell']}: the record "
                f"differs from the committed baseline: {rec}")
        require(not chaos or rec["faults"],
                f"scale_soak_presets {rec['cell']}: no fault injected")
        emit(dict(phase="scale_soak_presets", arch=cfg.name,
                  layers=cfg.n_layers, dtype=cfg.dtype, cell=rec["cell"],
                  equals_baseline=equal, faults=rec["faults"],
                  per_device_steps=rec["metrics"]["per_device_steps"],
                  **metrics))
    trace, fleet = preset_traces()[0], fleet2
    recs = []
    for _ in range(2):
        rec, w, metrics = soak_run("scale_soak_presets", cfg, model, params,
                                   trace, fleet, 0, chaos=True, loop="event")
        require(rec["faults"], "scale_soak_presets event: no fault")
        recs.append(rec)
        emit(dict(phase="scale_soak_presets", arch=cfg.name,
                  layers=cfg.n_layers, dtype=cfg.dtype, cell=rec["cell"],
                  record_metrics=rec["metrics"], faults=rec["faults"],
                  **metrics))
    require(_sorted_json(recs[0]) == _sorted_json(recs[1]),
            "scale_soak_presets: two event-loop replays differ")
    got = dict(_lib.launches)
    emit(dict(phase="scale_soak_presets", event_runs_identical=True,
              launches=got, phase_wall_s=time.monotonic() - t_phase))
    return got


def soak_profile(cfg, model, params, trace, fleet, **kw):
    """One ``soak_run`` of scale_soak_long under the profiler, tracing the
    device only: its busy time, its idle share over the run's rounds (1 -
    busy / the sum of the rounds' wall ms; the busy time also holds the
    fleet set-up's warm-up steps, outside the rounds, so the share is a
    lower bound) and its five largest device kernels. The trace holds
    ~10^5-10^6 kernels, so their times are summed from the raw events
    (``key_averages`` takes minutes over that many). Returns soak_run's
    (record, watch, metrics) and the profile."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA if DEV == "cuda"
                             else ProfilerActivity.CPU]) as prof:
        rec, w, metrics = soak_run("scale_soak_long", cfg, model, params,
                                   trace, fleet, 0, **kw)
    t0 = time.monotonic()
    by_name, n_ops = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
            n_ops += 1
    busy = sum(by_name.values()) / 1e9
    require(busy > 0 or DEV != "cuda",
            "scale_soak_long: the profiler saw no device time")
    rounds_s = sum(w["round_ms"]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return rec, w, metrics, dict(
        rounds_wall_s=rounds_s, device_busy_s=busy,
        device_idle_share=1.0 - busy / rounds_s if busy else None,
        device_ops=n_ops, rounds=rec["metrics"]["rounds"],
        top_kernels_ms={k[:80]: v / 1e6 for k, v in top},
        events_summed_s=time.monotonic() - t0)


def scale_soak_long_phase(cfg, params):
    """The serving shape (``long_trace``) at full width: bf16 lockstep with
    chaos (a seeded partition and device kill) under the profiler, which
    gives the fleet's device idle share over its rounds; bf16 through the
    event loop with chaos; then fp32 fault-free on the kernel path and on
    the plain path. Gates: arrivals accounted for, faults injected,
    invariants after every round, pools verified and empty at close (after
    the requests the drain bound left unfinished are cancelled), every
    completed request in ``hv.log`` against a ``vs-`` slice, the launches,
    the fp32 kernel-path token logs against the plain path's at the fp32
    tolerance (near-ties counted), the kernel and plain fp32 records
    equal. Returns (bf16 launches, fp32 launches)."""
    from repro_torch.kernels import _lib
    from repro_torch.models import Model
    t_phase = time.monotonic()
    trace, fleet = long_trace()
    model = Model(cfg, device=DEV)
    _lib.launches.reset()
    for loop in ("lockstep", "event"):
        kw = dict(chaos=True, loop=loop, prefill_chunk=LONG_PREFILL_CHUNK)
        if loop == "lockstep":
            rec, w, metrics, prof = soak_profile(cfg, model, params, trace,
                                                 fleet, **kw)
        else:
            rec, w, metrics = soak_run("scale_soak_long", cfg, model,
                                       params, trace, fleet, 0, **kw)
            prof = None
        require(rec["faults"], f"scale_soak_long {loop}: no fault")
        emit(dict(phase="scale_soak_long", arch=cfg.name,
                  layers=cfg.n_layers, dtype=cfg.dtype, cell=rec["cell"],
                  prefill_chunk=LONG_PREFILL_CHUNK, faults=rec["faults"],
                  record_metrics=rec["metrics"],
                  cancelled_at_close=w["cancelled_at_close"], profile=prof,
                  **metrics))
    bf16 = dict(_lib.launches)
    cfg32 = cfg.replace(dtype="float32")
    _lib.launches.reset()
    kern, kw_, km = soak_run("scale_soak_long", cfg32, Model(cfg32,
                                                            device=DEV),
                             params, trace, fleet, 0, chaos=False)
    fp32 = dict(_lib.launches)
    top8 = {}
    plain, pw, pm = soak_run("scale_soak_long", plain_cfg(cfg32),
                             Model(plain_cfg(cfg32), device=DEV), params,
                             trace, fleet, 0, top8=top8, chaos=False)
    require(_sorted_json(kern) == _sorted_json(plain),
            "scale_soak_long: the fp32 kernel and plain records differ")
    # compare_streams keys top8 by a stream's index: the request id
    rids = [r.request_id for r in kw_["reqs"]]
    require(rids == list(range(len(rids)))
            == [r.request_id for r in pw["reqs"]],
            "scale_soak_long: the fp32 runs' request ids differ")
    streams = compare_streams([r.out_tokens for r in kw_["reqs"]],
                              [r.out_tokens for r in pw["reqs"]], top8,
                              TOL[torch.float32])
    emit(dict(phase="scale_soak_long", arch=cfg.name, layers=cfg.n_layers,
              dtype="float32", cell=kern["cell"],
              record_metrics=kern["metrics"], logit_tol=TOL[torch.float32],
              **streams, kernel_path=km,
              plain_path=dict(wall_s=pm["wall_s"],
                              tokens_per_s=pm["tokens_per_s"],
                              round_ms_p50=pm["round_ms_p50"]),
              phase_wall_s=time.monotonic() - t_phase))
    return bf16, fp32


# the reference suite's bounds (tests/test_adversary.py)
ADV_FAIRNESS_FACTOR, ADV_SLACK_STEPS, ADV_PATIENCE_STEPS = 2.0, 6, 40
# the serving shape the adversary runs at once more
ADV_SERVING = dict(n_slots=8, max_len=2048, page_size=16,
                   victim_prompt_len=256)


def adversary_run(cfg, model, params, behavior, seed, **kw):
    """One ``run_scenario`` on the card (it checks pool conservation and
    cross-tenant page disjointness after every step, and reads the free
    pages back from the card at teardown); the launches gated, the victim
    completing everything it submitted, a nonzero number of free pages
    read back. Returns (report, metrics)."""
    from repro_torch.kernels import _lib
    from repro_torch.runtime.adversary import HOSTILE, VICTIM, run_scenario
    w = {}
    before = dict(_lib.launches)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with harness_watch(w):
        report = run_scenario(model, params, behavior=behavior, seed=seed,
                              device=DEV, **kw)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    got = {k: _lib.launches[k] - before[k] for k in _lib.launches}
    need = program_launches("adversary", cfg, w["calls"], w["configures"],
                            True, got)
    require(report.free_pages_checked > 0,
            f"adversary {report.behavior}: no free page read back")
    require(behavior is None or report.submitted.get(HOSTILE, 0) > 0,
            f"adversary {report.behavior}: every hostile submit was shed, "
            "so the attack never landed")
    require(report.completed.get(VICTIM) == report.submitted.get(VICTIM),
            f"adversary {report.behavior}: the victim lost requests")
    return report, dict(wall_s=wall, steps=report.steps,
                        step_ms=wall * 1e3 / report.steps,
                        engine_calls=dict(w["calls"]),
                        configures=w["configures"], launches=got,
                        launches_needed=need)


def adversary_phase(cfg, params):
    """The port's ``run_scenario`` at full width (bf16) on the card at the
    reference's parameters (4 slots, max_len 64, page 8, 48 rounds): the
    solo baseline and the four behaviors at seed 0, each report equal to
    the JAX package's in ``tests/data/torch_adversary_reference.json``,
    the victim within the reference suite's patience and fairness bounds.
    (A report depends on the vocabulary size, not on width or dtype: the
    file holds the reports at the full model's vocabulary.)
    Then the solo run and ``CancelChurn`` at the serving shape
    (``ADV_SERVING``), with the victim's p95 against the solo run's.
    ``PageSquat`` is not run there: its requests ask for max_len - 24 =
    2024 new tokens, which the baas quota (512) sheds at admission, and a
    quota that admits them makes the drain ~2000 decode steps a request.
    Returns the launches."""
    from repro_torch.kernels import _lib
    from repro_torch.models import Model
    from repro_torch.runtime import adversary
    t_phase = time.monotonic()
    model = Model(cfg, device=DEV)
    ref = [e for e in json.loads(ADVERSARY_REFERENCE.read_text())
           ["scenarios"] if e["seed"] == 0
           and e["vocab_size"] == cfg.vocab_size]
    require(len(ref) == 5, f"adversary: {len(ref)} reference reports at "
            f"vocabulary {cfg.vocab_size}, not the solo run and four")
    _lib.launches.reset()
    solo = None
    for entry in ref:
        behavior = entry["behavior"] and getattr(
            adversary, entry["behavior"])(**entry["kwargs"])
        report, metrics = adversary_run(cfg, model, params, behavior, 0)
        got = dataclasses.asdict(report)
        equal = _sorted_json(got) == _sorted_json(entry["report"])
        require(equal, f"adversary {report.behavior}: the report differs "
                f"from the JAX package's: {got}")
        victim = adversary.VICTIM
        solo = solo or report
        bound = ADV_FAIRNESS_FACTOR * solo.p95(victim) + ADV_SLACK_STEPS
        require(report.max_latency(victim) <= ADV_PATIENCE_STEPS
                and report.p95(victim) <= bound,
                f"adversary {report.behavior}: victim p95 "
                f"{report.p95(victim)} (bound {bound}), max "
                f"{report.max_latency(victim)}")
        emit(dict(phase="adversary", arch=cfg.name, layers=cfg.n_layers,
                  dtype=cfg.dtype, shape="reference", behavior=
                  report.behavior, equals_reference=equal,
                  victim_p95_steps=report.p95(victim),
                  solo_p95_steps=solo.p95(victim), bound_steps=bound,
                  free_pages_checked=report.free_pages_checked,
                  pages_scrubbed=report.pages_scrubbed, shed=report.shed,
                  **metrics))
    solo = None
    for behavior in (None, adversary.CancelChurn()):
        report, metrics = adversary_run(cfg, model, params, behavior, 0,
                                        **ADV_SERVING)
        solo = solo or report
        victim = adversary.VICTIM
        emit(dict(phase="adversary", arch=cfg.name, layers=cfg.n_layers,
                  dtype=cfg.dtype, shape="serving", **ADV_SERVING,
                  behavior=report.behavior,
                  victim_p95_steps=report.p95(victim),
                  solo_p95_steps=solo.p95(victim),
                  victim_max_steps=report.max_latency(victim),
                  within_reference_bound=report.p95(victim)
                  <= ADV_FAIRNESS_FACTOR * solo.p95(victim)
                  + ADV_SLACK_STEPS,
                  free_pages_checked=report.free_pages_checked,
                  pages_scrubbed=report.pages_scrubbed,
                  submitted=report.submitted, shed=report.shed,
                  cancelled=report.cancelled, **metrics))
    got = dict(_lib.launches)
    emit(dict(phase="adversary", launches=got,
              phase_wall_s=time.monotonic() - t_phase))
    return got


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))     # soak_baseline
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import Model

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "lines.jsonl").write_text("")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    t_start = t0 = time.monotonic()
    built = _lib.build()
    ptxas = {n: _lib.ptxas_table(n) for n in _lib.SOURCES}
    tensor_ops = {n: _lib.sass_count(n) for n in _lib.SOURCES}
    spills = {k: v["spill_bytes"] for n in _lib.SOURCES
              for k, v in ptxas[n].items() if v["spill_bytes"]}
    emit(dict(phase="build", gpu=gpu, torch=torch.__version__,
              cuda=torch.version.cuda, build_s=built["build_s"],
              wall_s=time.monotonic() - t0, tensor_core_ops=tensor_ops,
              spill_bytes=spills, ptxas=ptxas))
    require(sum(tensor_ops["flash_attention"].values()) > 0,
            "flash_attention: no HMMA/HGMMA in the SASS (the kernels do not "
            "run on the tensor cores)")
    from repro_torch.kernels.decode_attention import HEAD_DIMS
    for kern in ("flash_mma_kernel", "flash_tf32_kernel"):
        by_d = {int(m.group(1)): v for k, v in ptxas["flash_attention"].items()
                for m in [re.search(kern + r"(?:<(?:\(int\))?|ILi)(\d+)", k)]
                if m}
        require(sorted(by_d) == sorted(HEAD_DIMS),
                f"flash_attention: {kern} built for D {sorted(by_d)}, not "
                f"{HEAD_DIMS}")
        spills = {d: v["spill_bytes"] for d, v in by_d.items()
                  if v["spill_bytes"]}
        require(not spills, f"flash_attention: {kern} spills registers "
                f"(bytes by head dim): {spills}")
    # the redesigned 2-D matmul and SSD: on the tensor cores, no spills
    for lib, kerns in (("stream_matmul", ("mm_kernel",)),
                       ("ssd_chunk_scan", ("ssd_prep_kernel",
                                           "ssd_chunk_kernel"))):
        require(sum(tensor_ops[lib].values()) > 0,
                f"{lib}: no HMMA/HGMMA in the SASS")
        spills = {k: v["spill_bytes"] for k, v in ptxas[lib].items()
                  if k.split("<")[0].split()[-1] in kerns
                  and v["spill_bytes"]}
        require(not spills, f"{lib}: kernels spill registers: {spills}")

    results = {}
    kernel_phase(results)
    matmul_kernel_phase(results)
    ssd_kernel_phase(results)

    cfg = get_config("smollm-135m")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = Model(cfg, device=DEV).init(gen)
    model_phase(cfg, params)

    prompts = workload(cfg.vocab_size)
    _lib.launches.reset()                   # the serving path starts here
    engine_phase("dense_engine", cfg, params, prompts, False)
    engine_phase("paged_engine", cfg, params, prompts, True)
    serving_path = dict(_lib.launches)
    require(all(serving_path[k] > 0 for k in SERVING_KERNELS),
            f"a kernel of the serving path never launched: {serving_path}")
    cfg32 = cfg.replace(dtype="float32")
    _lib.launches.reset()                   # fp32 flash: the fp32 engines
    engine_phase("fp32_dense_engine", cfg32, params, prompts, False)
    engine_phase("fp32_paged_engine", cfg32, params, prompts, True)
    fp32_path = {"fp32_engines": _lib.launches["flash_attention"]}
    profile_phase("profile_dense_decode", cfg, params, prompts, False)
    profile_phase("profile_paged_decode", cfg, params, prompts, True)

    # serving through the hypervisor: each phase zeroes the counts before
    # it drives its path and reads them after
    launch_path = launch_serve_phase()                  # fp32
    gateway_path = gateway_fleet_phase(cfg, params, prompts)     # bf16
    chaos_path = fleet_chaos_phase(cfg, params)         # fp32
    fleet_path = {k: launch_path[k] + gateway_path[k] + chaos_path[k]
                  for k in SERVING_KERNELS}
    require(all(fleet_path[k] > 0 for k in SERVING_KERNELS),
            f"a kernel of the fleet paths never launched: {fleet_path}")
    fp32_path["launch_serve"] = launch_path["flash_attention"]
    fp32_path["fleet_chaos"] = chaos_path["flash_attention"]

    # the traffic and tenant-isolation harnesses through the port's fleet
    # and gateway (paged: dense decode has no launch there)
    harness_path = {"scale_soak_presets": scale_soak_presets_phase(cfg,
                                                                   params)}
    harness_path["scale_soak_long"], long32 = scale_soak_long_phase(cfg,
                                                                    params)
    harness_path["adversary"] = adversary_phase(cfg, params)
    for phase, got in harness_path.items():
        require(all(got[k] > 0 for k in ("paged_decode_attention",
                                         "flash_attention")),
                f"{phase}: a kernel of its path never launched: {got}")
    fp32_path["scale_soak_long"] = long32["flash_attention"]

    qcfg = cfg.replace(kv_quant=True, n_layers=4)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    qparams = Model(qcfg, device=DEV).init(gen)
    engine_phase("int8_dense_engine", qcfg, qparams, prompts, False)
    engine_phase("int8_paged_engine", qcfg, qparams, prompts, True)
    del params, qparams

    # the dense families at full width and depth (bf16 serving; fp32
    # logits), then gemma2-9b at full width, 4 layers; weights freed between
    families_path = {k: 0 for k in SERVING_KERNELS}
    fp32_path["families_model"] = 0
    for i, (tag, arch) in enumerate((("gemma3", "gemma3-1b"),
                                     ("phi3", "phi3-mini-3.8b"))):
        fcfg = get_config(arch)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 10 + i)
        fparams = Model(fcfg, device=DEV).init(gen)
        fprompts = workload(fcfg.vocab_size)
        _lib.launches.reset()               # this family's serving path
        engine_phase(f"{tag}_dense_engine", fcfg, fparams, fprompts, False)
        engine_phase(f"{tag}_paged_engine", fcfg, fparams, fprompts, True)
        for k in SERVING_KERNELS:
            require(_lib.launches[k] > 0,
                    f"{tag}: {k} never launched on its serving path")
            families_path[k] += _lib.launches[k]
        if tag == "phi3":
            profile_phase("profile_phi3_dense_decode", fcfg, fparams,
                          fprompts, False)
        got = families_model_phase(fcfg, fparams)
        fp32_path["families_model"] += got["flash_attention"]
        del fparams
        torch.cuda.empty_cache()
    g2cfg = get_config("gemma2-9b").replace(n_layers=4)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    g2params = Model(g2cfg, device=DEV).init(gen)
    got = families_model_phase(
        g2cfg, g2params, cut="n_layers 42 -> 4 (two local/global pairs; "
        "chip time)")
    fp32_path["families_model"] += got["flash_attention"]
    del g2params
    torch.cuda.empty_cache()

    rc3e_path = rc3e_phase()

    scfg = get_config("mamba2-370m")
    sparams = ssm_params(Model(scfg, device=DEV), SEED + 8)
    ssm_model_phase(scfg, sparams)
    _lib.launches.reset()                   # the SSM path starts here
    ssm_path = ssm_serve_phase(scfg, sparams)
    require(ssm_path["ssd_chunk_scan"] > 0,
            f"ssd_chunk_scan never launched on the SSM path: {ssm_path}")
    del sparams

    main_case = {"decode_attention": "bf16", "paged_decode_attention": "bf16",
                 "flash_attention": "bf16/S1024",
                 "stream_matmul": "fp32/s16/G100000",
                 "ssd_chunk_scan": "bf16/B4/S1024"}
    sources = {"decode_attention": ("decode_attention", "decode_attention",
                                    133),
               "paged_decode_attention": ("decode_attention",
                                          "decode_attention", 235),
               "flash_attention": ("flash_attention", "flash_attention", 100),
               "stream_matmul": ("stream_matmul", "stream_matmul", 57),
               "ssd_chunk_scan": ("ssd_chunk_scan", "mamba2_chunk", 68)}
    # flash: the bf16 paths here, the fp32 ones in the row's fp32 entry
    fleet_main = dict(fleet_path,
                      flash_attention=gateway_path["flash_attention"])
    path_launches = {k: serving_path[k] + families_path[k] + fleet_main[k]
                     + sum(got[k] for got in harness_path.values())
                     for k in SERVING_KERNELS}
    path_launches["stream_matmul"] = (rc3e_path["stream_matmul"]
                                      + rc3e_path["stream_matmul_batched"])
    path_launches["ssd_chunk_scan"] = ssm_path["ssd_chunk_scan"]
    rows = []
    for name, recs in results.items():
        m = next(r for r in recs if r["case"] == main_case[name])
        src, ref, line = sources[name]
        row = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}.cu",
            replaces=f"src/repro/kernels/{ref}.py:{line}",
            launches=path_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m["library_ms"])
        if name == "stream_matmul":
            row["launches_by_entry"] = {
                k: rc3e_path[k] for k in ("stream_matmul",
                                          "stream_matmul_batched")}
            # the 2-D entry (tensor cores) at the rc3e path's product and
            # at 4096^3
            row["2d"] = [dict(
                case=f["case"], launches=rc3e_path["stream_matmul"]
                if f["case"] == "fp32/129x257x65" else 0,
                plan=f["plan"], max_abs_err=f["max_abs_err"], ms=f["ms"],
                plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
                bound_by=f["bound_by"],
                bound_cuda_core_ms=f.get("bound_cuda_core_ms"),
                library_ms=f["library_ms"]) for f in recs if "plan" in f]
        if name in SERVING_KERNELS:
            row["launches_by_path"] = {
                "smollm_serving": serving_path[name],
                "families_serving": families_path[name],
                "fleet_serving": fleet_main[name],
                **{p: got[name] for p, got in harness_path.items()}}
        if name == "flash_attention":      # the fp32 (3xTF32) kernel
            f = next(r for r in recs if r["case"] == "fp32/S512")
            row["fp32"] = dict(
                case=f["case"], shape=f["shape"],
                launches=sum(fp32_path.values()),
                launches_by_path=fp32_path, max_abs_err=max(
                    r["max_abs_err"] for r in recs
                    if r["tol"] == TOL[torch.float32]),
                ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
                bound_by=f["bound_by"],
                bound_cuda_core_ms=f["bound_cuda_core_ms"],
                library_ms=f["library_ms"])
        rows.append(row)
    emit({"kernels": rows, "wall_s": time.monotonic() - t_start})
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        sys.exit(1)
