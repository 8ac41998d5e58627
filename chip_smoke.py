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
   ``flash_tf32_kernel``) is missing a head dim of ``HEAD_DIMS`` or spills,
   or if the registry's static shared memory of a decode split or merge
   instantiation (``kernel_footprints``) is not ptxas's, or the registry's
   dynamic shared memory of a decode group build, at every block size, is
   not what its launch requests (``group_launch_smem``), or the two list
   other instantiations, or any decode kernel (split, merge, group)
   spills; a ``build_decode`` line gives the decode kernels' registers and
   the group builds' dynamic shared memory.
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
   padding copies alone). Decode and paged decode (fp32, bf16, int8) and
   flash (fp32, bf16) at the remaining families' heads
   (``FAMILY2_HEADS``): qwen3-moe (32 / 4 of 128, g 8, flash S=1024),
   llava (56 / 8 of 128, g 7, S=1176) and whisper-tiny (6 / 6 of 64,
   S=448). Decode and paged decode (fp32, bf16, int8) at groups past the 8
   heads a block holds (``WIDE_GROUPS``: Qwen3-235B-A22B's 64 / 4 of 128,
   Llama-3.1-405B's 128 / 8, MQA's 71 / 1 of 64 and 48 / 1 of 128; and
   ``GROUP_D512``, 16 / 1 of 512): bf16 and int8 on the decode group kernel,
   also held against its pass model (``decode_group_partials_ref``,
   ``model_max_abs_err``), fp32 in head chunks; each record gives the
   route and the K/V bytes its blocks request (each chunk, or each group
   slice, reads its kv head's valid rows) and
   all three kernels (flash in fp32 and bf16 at S=1024) at the head dims
   past 256 (``WIDE_DIMS``: 264, 320, 384, 512 at g 4), which the 384 and
   512 builds read in place (``runs_on``). Paged decode (fp32, bf16) also
   at the harness phases' engines:
   B=4, L=64, pages of 4 and 8, one slot idle; and (fp32, bf16, int8; bf16
   at B=1) at the tuner's pages 32 and 64 (``TUNER_PAGES``), at the
   serving shape, each split of whole pages. Every dense decode case also
   asks for the merge pass's log-sum-exp (``return_lse``, what a mesh
   decode over a length-sharded cache merges the ranks by): the output
   must be unchanged and the log-sum-exp within ``LSE_TOL`` of the plain
   version's (``lse_max_abs_err``). The
   fp32 flash bound is operations over 3xTF32's rate (495 / 3 TFLOP/s),
   with the fp32 CUDA-core bound beside it (``bound_cuda_core_ms``).
   The streaming matmul on
   the paper's stream of 100,000 16x16 / 32x32 products (fp32, bf16) and on
   2-D products (129x257x65, split K with unaligned rows; 4096^3 fp32 and
   bf16), each 2-D record with its launch plan; the 2-D fp32 bound is
   operations over 3xTF32's rate with the CUDA-core bound beside it. The
   SSD scan at mamba2-370m's width (H 32, P 64, N 128, G 1; and bf16 and
   fp32 B=4, S=1024 at zamba2-7b's, H 112, P 64, N 64) on the layer's
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
   tolerance of the plain path's top logit (counted). Every engine decode
   call of every serving phase (``engine_calls``) must capture its
   engine's CUDA graph (its first call) or replay it, and every engine
   prefill call its prefill program's graph of the prompt's pad length;
   each record gives the engine's captures, replays, capture ms and graph
   memory, and its prefill program's captures, replays, evictions,
   capture ms and card memory (captures and caches).
5. ``profile_*``: device busy time and idle share of decode steps, and
   the step's five largest device kernels by time.
5a. the decode step as CUDA graphs (``core/graphs.py``): ``graph_replay``
   (full-width smollm, 8 slots x 2048, dense and paged, bf16, fp32 and
   int8 KV: 16 replays an engine, each held against a direct call of the
   captured function on copies of the same inputs; ids identical, the
   largest logit difference, fp32 within 1e-5), ``graph_profile`` (one
   replay under ``torch.profiler``: the decode split or group kernel and
   the merge kernel once an attention site, by name), ``graph_refusal``
   (``configure`` of a step that syncs with the host and of one that
   uploads from pageable memory raises ``GraphCaptureError`` naming the
   op; the program refuses later calls without running the step; the
   allocator still empties its cache afterwards) and
   ``graph_configure`` (Table I on the serving program: a 4-engine paged
   fleet's configure, its capture included, against the engines' PR
   swaps; each engine's capture ms and graph memory; every later step a
   replay). ``prefill_graph_replay`` (the same smollm engines: for each pad
   bucket of the workload, a replay of the engine's prefill program held
   against a direct eager prefill of the same prompt, every cache leaf and
   the hidden states bit-equal or within 1e-5 fp32 / the bf16 tolerance /
   one int8 step, the record naming such a leaf; the token streams with
   the program equal those of an eager prefill; a ``step_async`` run with
   two admissions of one bucket pending at once equal to the lockstep
   run).
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
   bound to the configured program, with the graph program's binding of
   the argument trees alone. ``fleet_chaos``: the reference's chaos
   workload (4 nodes x 1 device, six 2-slot tenants packed on 3 devices
   and a spare parked, 2 requests of 64-256 tokens each, 16 new tokens) at
   full width in fp32;
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
   gateway, smollm-135m at full width, cut to ``HARNESS_LAYERS`` (10) of
   its 30 layers (chip time; records and reports depend on neither depth
   nor weights), seeded weights of their own, with the same launch
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
5d. ``autotune`` (the design-space auto-tuner, ``repro_torch.tuning``),
   smollm-135m at full width and depth in bf16: ``autotune_registry``, the
   registry's card (132 SMs, 80 GiB, 227 / 228 KiB of shared memory a
   block / an SM, 64 Ki registers an SM) against
   ``torch.cuda.get_device_properties``; ``autotune_tune``, ``tune``'s
   winner, win, candidates, prunes and census for smollm-135m and
   gemma3-1b at 2048, classes 1.0 and 0.25, dense and paged;
   ``autotune_measure``, the measure hook: the modeled top 4 of smollm at
   class 1.0, dense and paged, each timed as wall ms a generated token
   through a ``BatchingEngine`` (8 requests of 64 prompt tokens, 16 new,
   ``step_async`` at the candidate's prefill chunk), 3 rounds alternating
   the candidates, the modeled rank beside the measured one and
   ``tune(..., measure=...)``'s winner; ``autotune_fleet_lockstep`` /
   ``_event``: an autotuned paged ``GatewayFleet`` on a 1.0 / 0.25 class
   pair (tenants of 2, 1, 1 slots, 8 requests of 96 prompt tokens, 16 new),
   each class bound to its ``tune`` winner, tenant c moved to the other
   class mid-decode (page sizes differ: 0 pages copied, 1 request
   replayed), the invariants after every round, streams against the same
   fleet at the default geometry (near-ties counted), every launch
   accounted for.
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
   batched kernel must launch exactly cores x cycles times. Every cycle
   runs through the shell's program: one CUDA graph a block shape (1,562
   full blocks of 64 and one tail of 32), so each shell captures exactly
   2 graphs in its first run (replays: cycles - 2) and replays in every
   later one; each run records its captures, replays, capture ms and
   graph MB. Then one BAaaS ``invoke_service`` and one RSaaS
   ``program``/``run`` of a 2-D product.
7b. ``shell_graph_replay``: a 4-core ``FusedShell`` cycle at the rc3e
   shapes (cores: the batched matmul, a ucs-reading core, an axpy): a
   replayed cycle bitwise equal to a direct eager call of the cycle's
   function on the shell's buffers, full blocks and the tail; a register
   written between two replays read by the next one as the plain version
   says (the register uploaded once); a hot swap of slot 2 captures anew
   and drops the old program's graphs and pool, slot 0's output
   unchanged, slot 2 computing the new core; a core that calls
   ``.item()`` refused with ``GraphCaptureError`` naming its line, and
   the next cycle refused without a launch.
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
   prefill call and nothing else may launch. Every path runs through the
   port's ``GreedyLoop``: on the card one prefill graph a (B, S) and one
   decode graph captured at the first step and replayed by every later
   one (gated; the launches count through the capture tally). Prefill ms
   (eager run and capture) and a replay's, decode step ms, tokens/s, the
   graphs' counts and capture ms, and the decode step's device idle share.
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
10b. the remaining families at full width (``families2_phases``; each
   family's weights seeded, MLA ``kv_norm`` and SSM gate norms set to 1,
   freed after it): ``qwen3moe_dense_engine`` / ``qwen3moe_paged_engine``
   (qwen3-moe-30b-a3b cut from 48 to 6 layers: 128 experts top 8 at
   capacity factor 1.25, GQA 32 / 4 of 128), ``deepseek_dense_engine``
   (deepseek-v2-lite-16b cut from 27 to 6: the dense first layer and 5
   MoE layers of 64 experts top 6 + 2 shared, MLA; no kernel launches, as
   in the reference) and ``deepseek_paged_refused`` (the paged engine
   refused with no card memory allocated), ``llava_dense_engine`` /
   ``llava_paged_engine`` (llava-next-34b cut from 60 to 4, text), bf16,
   the serving workload of phase 4; MoE streams are compared with both
   runs' routing (``compare_streams``: a divergence is excused at a logit
   near-tie or where the two paths routed that very token apart);
   ``profile_qwen3moe_dense_decode``; ``zamba2_serve`` (zamba2-7b, 81
   layers: 68 SSM, 13 sites of the shared block) through the serve-step
   factories with ``ssm_serve``'s gates at 4 x 1024; ``whisper_serve``
   (whisper-tiny, 4 streams over 1500 frames, 64 greedy steps, kernel
   against plain); ``families2_model`` (fp32, the five, 2 x 600 tokens or
   8 over 1500 frames + 4 decode steps, the kernel path fed the plain
   path's tokens; a MoE row outside the tolerance counts only at a plain
   router top-k near-tie within ``ROUTER_TIE``). Each accounts for every
   launch (``kernel_sites``). Then ``whisper_engine``: whisper-tiny in
   fp32 through the dense ``BatchingEngine`` (prompts [3, 5, 7, 9] and
   [11, 2], 32 new tokens), kernel path against plain path, the logs
   equal, and a longer context failing with ``KeyError('frames')`` as
   the reference's engine does.
10b'. ``wide_group_engine`` (the thirteenth slice's path): qwen3-moe-30b-
   a3b's config at Qwen3-235B-A22B's published widths (``wide_group_cfg``:
   d_model 4096, 64 query heads over 4 kv heads of 128, a group of 16; 128
   experts top 8 of 1536; vocab 151936, untied), cut from 94 to 2 layers,
   bf16, seeded weights: the dense and the paged engine serve the
   workload of phase 4 with the gates of ``qwen3moe_*_engine`` (streams
   against ``kernel_force="ref"``'s, near-ties and tokens routed apart
   counted; decode and flash launches layers x calls; every decode launch
   on the decode group kernel's route, ``decode_group`` = decode + paged
   launches); then ``profile_wide_group_dense_decode`` (step ms, idle
   share).
10c. training (``training_phases``; fp32, TF32 off; every phase must
   launch no kernel, as the reference's training reaches no Pallas
   kernel; every step through ``train_program`` / ``dp_train_program``:
   on the card one capture a binding, then replays, the state at its
   addresses): ``train_smollm`` (``repro_torch.launch.train.main`` on
   full-width, full-depth smollm-135m, B 8, S 1024, 30 steps, warmup 10,
   timing the launcher's program: losses finite and falling, each
   returned loss its own step's; step ms p50/p95 after 3 warm-up steps,
   tokens/s, peak memory, capture ms and graph MB, one step under the
   profiler: device busy ms, idle share, ops, top-5 device ops),
   ``train_graph_replay`` (the same model, plain / remat / 2
   microbatches, 3 program steps against 3 eager in-place steps under
   deterministic algorithms: metrics and every state leaf bit-equal;
   remat's and the microbatches' first loss within 1e-5 relative of the
   plain one, grad_norm within 1e-4; peak memory of each),
   ``train_device_parity`` (2 layers, B 2, S 256: loss and every gradient
   leaf against the CPU), ``train_restart`` (4 layers, B 4, S 256,
   deterministic algorithms: 6 program steps straight against 3 + save +
   restore + 3 and against 6 eager steps, bit for bit),
   ``train_families`` (qwen3-moe at 2 layers, mamba2-370m at 4,
   whisper-tiny in full: finite loss, MoE aux > 0, every gradient leaf
   finite and nonzero; 3 program steps against 3 eager ones, bit-equal)
   and ``train_dp_nccl`` (``dp_train_program`` on an NCCL world of 1,
   compressed and not, 5 steps, 4 layers, its collectives captured,
   against the eager in-place DP step, bit-equal).
10d. the mesh slice on a one-rank NCCL mesh (``mesh_phases``), whose
   steps are graph programs bound to the DTensors' local shards (one
   capture a binding, then replays; the training state and the caches
   written in place): ``mesh_serve`` (smollm-135m bf16 through
   ``jit_serve_step``, tokens bitwise and 30 x 32 decode launches, one
   capture and 31 replays; replay, direct eager and plain step p50,
   capture ms, graph MB, busy ms and idle share), ``mesh_train`` (fp32, B
   8, S 1024, 3 steps, losses and leaves within 1e-6 of
   ``make_train_step``, the state written at its addresses; the same
   records), ``mesh_ckpt`` (restore by placements, bit-equal; a capture
   for each new binding), ``mesh_graph_replay`` (every replay of a serve
   program and of a 4-layer train program bitwise equal to a direct
   eager call on clones, under deterministic algorithms; a syncing mesh
   step refused naming its line), ``dryrun_vs_card`` (flops and peak from
   the eager calls); then ``mesh_train_deepseek`` (deepseek-v2-lite-16b
   at full width cut from 27 to 2 layers, fp32, its MoE dispatch split
   over the dp axes, ``dp_shards`` 2: 3 steps held as ``mesh_train``
   holds smollm) and
   ``spatial_shell`` (``SpatialShell()`` over the group: 4 slots whose
   groups are [0], each slot mesh a CUDA DeviceMesh of size 1 whose
   all-reduce returns its input; the paper's stream of 100,000 16x16 and
   32x32 products for each of 4 cores through the slots' streams, each
   slot one CUDA graph a block shape replayed on its stream, bitwise
   equal to a ``FusedShell``'s graph cycle on the same blocks, the
   batched kernel launched cores x cycles times by each, 2 captures per
   slot and per fused shell a size).
10e. ``examples``: ``examples/{quickstart,serve_baas,multi_tenant,
   train_smollm}_torch.py`` with ``--device cuda`` through ``main`` in this
   process (what each prints goes to the output directory's examples/):
   the quickstart's results; serve_baas (the paged engine) and
   multi_tenant (the gateway's and the fleet's dense engines) served on
   the kernels and on the plain versions, each serving part's launches
   exactly what its engine calls and configures need and its streams
   equal but at counted fp32 near-ties; train_smollm ``--full --steps 40
   --seq 1024 --batch 8`` saving every 10 steps, then rerun from step 30
   under deterministic algorithms: the loss falls and the rerun's losses
   equal the first run's bit for bit; no launch.
11. the ``kernels`` summary line (launches of the attention kernels from
   the smollm, the families', the fleet phases', the harness phases', the
   autotuned fleets', the remaining families' and whisper_engine's
   serving paths, ``launches_by_path``, ``wide_group_engine`` among
   them; the flash row's ``fp32`` entry:
   the fp32 S=512 case and fp32 flash's launches on the fp32 engines,
   ``families_model``, ``launch_serve``, ``fleet_chaos`` and
   ``scale_soak_long``; the streaming matmul's from the rc3e path, the
   SSD scan's from the SSM path and zamba2's; every row's
   ``launches_by_path`` has ``training``: 0 and ``mesh``; the decode rows
   ``examples``, the flash row's fp32 entry ``examples``, the streaming
   matmul's ``spatial_shell``; the ``decode_group`` row: the decode group
   kernel's launches on every path, all of them ``wide_group_engine``'s,
   its g 16 case's ms, paged ms and K/V bytes requested, and its largest
   errors against the plain version and its pass model), the GPU's name and power
   limit, and ``{"ok": true, ...}`` last. Any failed check exits
   non-zero.
"""
import collections
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS's deterministic workspace (train_restart runs under
# torch.use_deterministic_algorithms); set before the first CUDA call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
# the decode kernel's log-sum-exp: fp32 in both, from the same scores
# (the kernel's ex2.approx and its split sums in another order)
LSE_TOL = dict(atol=1e-3, rtol=1e-5)
B, HQ, HKV, D, L, PS = 8, 9, 3, 64, 2048, 16
# the paged engines of the soak presets (page 4) and of the adversary's
# reference shape (page 8): 4 slots x 64
HARNESS_B, HARNESS_L, HARNESS_PAGES = 4, 64, (4, 8)
HARNESS_LAYERS = 10        # smollm's depth in the harness phases (of 30)
# the page sizes of the tuner's sweep past the serving path's 16 (its
# winners on the card's classes take 64 and 32)
TUNER_PAGES = (32, 64)
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
# groups past the 8 query heads a decode block holds (Hq, Hkv, D):
# Qwen3-235B-A22B (g 16), Llama-3.1-405B (128 / 8, g 16), Falcon-7B's MQA
# (71 / 1 at D 64), StarCoder's and granite-code's MQA (48 / 1 at D 128)
WIDE_GROUPS = (("g16", (64, 4, 128)), ("g16h128", (128, 8, 128)),
               ("g71", (71, 1, 64)), ("g48", (48, 1, 128)))
# the decode group kernel also at a group of 16 on one kv head of 512
# columns (the widest build; O in four column groups)
GROUP_D512 = ("g16d512", (16, 1, 512))
# head dims past 256 (no configured model; parity with the reference), at
# g 4 (8 / 2): the 384 and 512 builds read them in place
WIDE_DIMS = (264, 320, 384, 512)
WIDE_D_HEADS = (8, 2)
# Qwen3-235B-A22B's published widths (hf Qwen/Qwen3-235B-A22B config.json)
# over qwen3-moe-30b-a3b's config; every other field stays the 30B's
# (qk-norm, rope theta 1e6, untied embeddings, capacity factor 1.25)
WIDE_GROUP_WIDTHS = dict(d_model=4096, n_heads=64, n_kv_heads=4,
                         head_dim=128, vocab_size=151936)
WIDE_GROUP_MOE = dict(n_experts=128, top_k=8, d_expert=1536)
WIDE_GROUP_LAYERS = 2                  # of 94 (fp32 weights: ~25 GB)
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
# the remaining families' attention shapes (Hq, Hkv, D), each with its flash
# prefill length: qwen3-moe (g 8, CHUNK_HEADS), llava (g 7; 576 patches + 600
# tokens), whisper-tiny (D 64, g 1; its decoder's 448-token window)
FAMILY2_HEADS = (("qwen3moe", "d128g8", (32, 4, 128), 1024),
                 ("llava", "d128g7", (56, 8, 128), 1176),
                 ("whisper", "d64g1", (6, 6, 64), 448))
ZAMBA2_SSD = (112, 64, 64)             # zamba2-7b's SSD width (H, P, N)
# depth where fp32 master weights would not fit beside their bf16 casts on
# the card's 80 GB (``param_count()`` x 4 bytes at full depth: qwen3-moe 122
# GB, llava 138, deepseek 63; x 6 with a bf16 copy: 183, 206, 94); zamba2
# (22 GB fp32) and whisper-tiny run at full depth
FAMILY2_LAYERS = {"qwen3-moe-30b-a3b": 6, "llava-next-34b": 4,
                  "deepseek-v2-lite-16b": 6}
# fp32 router top-k near-tie (families2_model): the k-th and (k+1)-th
# probabilities closer than this may swap between two summation orders
ROUTER_TIE = 1e-5
WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS = 4, 4, 64
WHISPER_ENGINE_NEW = 32                # whisper_engine: tokens a request
GRAPH_STEPS = 16                       # graph_replay: replays an engine
GRAPH_FP32_TOL = 1e-5                  # graph_replay: fp32 logits
PREFILL_CHUNK = 64                     # prefill_graph_replay: async chunk


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


def free_card():
    """Close the cached prefill programs (their caches and graphs), collect
    unreachable objects, then return the allocator's cached blocks to the
    card. A fleet and its hypervisor reference each other (migration
    listeners), so the engines of a finished phase, their caches and their
    graphs' memory pools wait for the cycle collector."""
    from repro_torch.runtime import clear_prefill_programs
    clear_prefill_programs()
    gc.collect()
    torch.cuda.empty_cache()


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
        from repro_torch.kernels import _lib
        g = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        # a timing's launches are measurements, not a path's: the capture
        # keeps its tally (the ledger asks it to) and the replays drop it
        with _lib.capture_tally(), torch.cuda.graph(g):
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
    """For a head dim outside ``HEAD_DIMS``: up to 256, the dim the wrapper
    pads to and the device time of the padding copies alone (q, k/pool,
    v/pool; the wrapper pays them on every call, inside its ``ms``); past
    it, the build that reads the true width in place (no copy); else
    nothing."""
    from repro_torch.kernels.decode_attention import (MAX_PADDED_HEAD_DIM,
                                                      pad_head_dim,
                                                      padded_head_dim)
    d = q.shape[-1]
    dp = padded_head_dim("pad_cost", d)
    if dp == d:
        return {}
    if d > MAX_PADDED_HEAD_DIM:
        return dict(runs_on=dp, in_place=True)
    return dict(padded_to=dp, pad_ms=time_ms(
        lambda: [pad_head_dim(t, dp) for t in (q, k, v)]))


def group_model(q, k, v, kpos, cur, split_rows, plan, window, ks, vs):
    """The decode group kernel's pass model at the launch's split rows and
    plan, merged by the plain merge (the mean of V where no key counts)."""
    from repro_torch.kernels import decode_attention as da
    acc, m, l = da.decode_group_partials_ref(
        q, k, v, kpos, cur, split_rows, plan, window=window, k_scale=ks,
        v_scale=vs)
    vf = v.float() * (1.0 if vs is None else vs[..., None])
    g = q.shape[1] // k.shape[1]
    return da.merge_partials_ref(acc, m, l,
                                 vf.mean(2).repeat_interleave(g, dim=1))


def check_model(what, got, model, tol):
    """The group kernel's output against its pass model: max abs err."""
    err = float((got.float() - model).abs().max())
    require(torch.allclose(got.float(), model, **tol),
            f"{what}: against the group kernel's pass model, max err {err}")
    return err


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
        # the remaining families: qwen3-moe (g 8), llava (g 7), whisper
        for _, tag, heads, _ in FAMILY2_HEADS:
            cases.append((f"{tag}/{kind}", dtype, quant, 0, cur, fill, L,
                          heads))
        # this slice: groups past 8, and head dims past 256 at g 4
        for tag, heads in WIDE_GROUPS + (GROUP_D512,):
            cases.append((f"{tag}/{kind}", dtype, quant, 0, cur, fill, L,
                          heads))
        for d in WIDE_DIMS:
            cases.append((f"d{d}g4/{kind}", dtype, quant, 0, cur, fill, L,
                          WIDE_D_HEADS + (d,)))
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
        n_split, split_rows = _lib.last_plan["decode_attention"]
        ref = da.decode_attention_ref(q, k, v, kpos, cur_t, window=window,
                                      k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        require(torch.allclose(got.float(), ref.float(), **tol),
                f"decode_attention {name}: max err {err}")
        group = da.uses_group_kernel(hq // hkv, d, dtype)
        gplan = _lib.last_plan["decode_group"] if group else None
        route = {}
        if group:               # the group kernel against its pass model
            model = group_model(q, k, v, kpos, cur_t, split_rows, gplan,
                                window, ks, vs)
            route = dict(route="group", group_plan=gplan._asdict(),
                         model_max_abs_err=check_model(
                             f"decode_attention {name}", got, model, tol))
        if idle.any():        # the mean of the swept V rows, as the reference
            v_deq = v[idle].float() * (vs[idle][..., None] if quant else 1.0)
            mean_v = v_deq.mean(dim=2).repeat_interleave(hq // hkv, dim=1)
            require(torch.allclose(got[idle].float(),
                                   mean_v.to(dtype).float(), **tol),
                    f"decode_attention {name}: idle row is not the mean "
                    "of V")
        # the merge pass's log-sum-exp (a mesh decode over a length-sharded
        # cache merges the ranks' outputs by it): the output unchanged,
        # the log-sum-exp against the plain version's
        got_l, lse = da.decode_attention_cuda(
            q, k, v, kpos, cur_t, window=window, k_scale=ks, v_scale=vs,
            return_lse=True)
        _, ref_l = da.decode_attention_ref(q, k, v, kpos, cur_t,
                                           window=window, k_scale=ks,
                                           v_scale=vs, return_lse=True)
        torch.cuda.synchronize()
        fin = ~torch.isinf(ref_l)
        lse_err = float((lse[fin] - ref_l[fin]).abs().max()) \
            if fin.any() else 0.0
        require(torch.equal(got_l, got)
                and torch.equal(torch.isinf(lse), ~fin)
                and torch.allclose(lse[fin], ref_l[fin], **LSE_TOL),
                f"decode_attention {name}: log-sum-exp max err {lse_err}")
        nbytes, flops = decode_cost(q, kpos, cur_t, window, kvbytes, hkv)
        b_ms, b_by = bound(nbytes, flops, dtype)
        lib = None if quant else time_ms(sdpa_decode(q, k, v, kpos, cur_t,
                                                      window))
        heads_a_block, chunks = da.head_chunks(hq // hkv, d)
        # K/V bytes the split blocks request: every chunk of a kv head
        # reads its rows (from L2 where another chunk brought them); the
        # group kernel once a kv head (a slice of the group)
        kv_read = (gplan.n_slices if group else chunks) * (
            nbytes - decode_cost(q, kpos, cur_t, window, kvbytes, 0)[0])
        rec = dict(phase="kernel", name="decode_attention", case=name,
                   shape=dict(B=Bc, Hq=hq, Hkv=hkv, D=d, L=Lc),
                   n_split=n_split, head_chunks=chunks,
                   heads_a_block=heads_a_block, bytes=nbytes,
                   kv_bytes_requested=kv_read, **route,
                   max_abs_err=err, tol=tol, lse_max_abs_err=lse_err,
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
        if group:
            results.setdefault("decode_group", []).append(rec)
        if Lc % PS:
            continue
        # paged: the same logical cache scattered over a shuffled pool
        kp, vp, kpp, ksp, vsp, bt = to_pool(gen, k, v, kpos, ks, vs)
        got = da.paged_decode_attention_cuda(q, kp, vp, kpp, bt, cur_t,
                                             window=window, k_scale=ksp,
                                             v_scale=vsp)
        n_split, prow = _lib.last_plan["paged_decode_attention"]
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        require(torch.allclose(got.float(), ref.float(), **tol),
                f"paged_decode_attention {name}: max err {err}")
        if group:       # the pool's rows in table order are the dense rows
            if prow != split_rows:
                model = group_model(q, k, v, kpos, cur_t, prow, gplan,
                                    window, ks, vs)
            route = dict(route="group", model_max_abs_err=check_model(
                f"paged_decode_attention {name}", got, model, tol))
        nbytes, flops = decode_cost(q, kpos, cur_t, window, kvbytes, hkv,
                                    paged_nb=bt.shape[1])
        b_ms, b_by = bound(nbytes, flops, dtype)
        rec = dict(phase="kernel", name="paged_decode_attention", case=name,
                   shape=dict(B=Bc, Hq=hq, Hkv=hkv, D=d, L=Lc, ps=PS),
                   n_split=n_split, **route,
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
        if group:
            results["decode_group"].append(rec)

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

    # the tuner's page sizes at the serving shape (B=8, L=2048; and B=1,
    # where split_plan cuts the most splits): split rows must be whole
    # pages (split_plan's unit), held against the plain version
    for ps in TUNER_PAGES:
        for kind, dtype, quant, cur_c, fill_c in (
                ("fp32", torch.float32, False, cur, fill),
                ("bf16", torch.bfloat16, False, cur, fill),
                ("int8", torch.bfloat16, True, cur, fill),
                ("bf16/B1", torch.bfloat16, False, cur1, fill1)):
            q, k, v, kpos, cur_t, ks, vs = decode_inputs(
                gen, dtype, quant, cur_c, fill_c)
            kp, vp, kpp, ksp, vsp, bt = to_pool(gen, k, v, kpos, ks, vs, ps)
            got = da.paged_decode_attention_cuda(q, kp, vp, kpp, bt, cur_t,
                                                 k_scale=ksp, v_scale=vsp)
            n_split, rows = _lib.last_plan["paged_decode_attention"]
            ref = da.paged_decode_attention_ref(q, kp, vp, kpp, bt, cur_t,
                                                k_scale=ksp, v_scale=vsp)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            err = float((got.float() - ref.float()).abs().max())
            require(torch.allclose(got.float(), ref.float(), **tol),
                    f"paged_decode_attention ps{ps}/{kind}: max err {err}")
            require(rows % ps == 0, f"paged_decode_attention ps{ps}/{kind}: "
                    f"split rows {rows} are not whole pages")
            nbytes, flops = decode_cost(q, kpos, cur_t, 0, k.element_size(),
                                        HKV, paged_nb=bt.shape[1])
            b_ms, b_by = bound(nbytes, flops, dtype)
            rec = dict(phase="kernel", name="paged_decode_attention",
                       case=f"ps{ps}/{kind}",
                       shape=dict(B=len(cur_c), Hq=HQ, Hkv=HKV, D=D, L=L,
                                  ps=ps),
                       n_split=n_split, split_rows=rows, max_abs_err=err,
                       tol=tol,
                       ms=time_ms(lambda: da.paged_decode_attention_cuda(
                           q, kp, vp, kpp, bt, cur_t, k_scale=ksp,
                           v_scale=vsp)),
                       plain_ms=time_ms(lambda: da.paged_decode_attention_ref(
                           q, kp, vp, kpp, bt, cur_t, k_scale=ksp,
                           v_scale=vsp)),
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
    flash_cases += [(f"{fam}/{tag}/S{S}", dt, S, 0, 0.0, heads)
                    for fam, _, heads, S in FAMILY2_HEADS
                    for tag, dt in (("fp32", f32), ("bf16", b16))]
    # this slice: Qwen3-235B-A22B's prefill heads (g 16), and the head dims
    # past 256 read in place
    flash_cases += [("qwen3_235b/bf16/S1024", b16, 1024, 0, 0.0,
                     WIDE_GROUPS[0][1])]
    flash_cases += [(f"{tag}/D{d}/S1024", dt, 1024, 0, 0.0,
                     WIDE_D_HEADS + (d,)) for d in WIDE_DIMS
                    for tag, dt in (("fp32", f32), ("bf16", b16))]
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
    N 128, G 1) and at zamba2-7b's (H 112, P 64, N 64, G 1), on the layer's
    strided views of one (B, S, C) activation; y and the final state. No
    single PyTorch call computes the SSD, so there is no library
    yardstick."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import mamba2_chunk as ssd
    from repro_torch.layers.ssm import ssd_scan
    F = torch.nn.functional
    t_phase = time.monotonic()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    G = 1
    ptxas = _lib.ptxas_table("ssd_chunk_scan")
    shapes = set()
    mamba2, zamba2 = (SSM_H, SSM_P, SSM_N), ZAMBA2_SSD
    for case, dtype, Bsz, S, (H, P, N) in (
            ("bf16/B4/S1024", torch.bfloat16, 4, 1024, mamba2),
            ("fp32/B4/S1024", torch.float32, 4, 1024, mamba2),
            ("bf16/B8/S256", torch.bfloat16, 8, 256, mamba2),
            ("fp32/B1/S2048", torch.float32, 1, 2048, mamba2),
            ("fp32/B2/S1000", torch.float32, 2, 1000, mamba2),
            ("zamba2/bf16/B4/S1024", torch.bfloat16, 4, 1024, zamba2),
            ("zamba2/fp32/B4/S1024", torch.float32, 4, 1024, zamba2)):
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


def rc3e_shapes():
    """Block shapes of one core's stream (full blocks and the tail): the
    graphs a shell captures."""
    return len({min(RC3E_BLOCK, RC3E_MATS - j)
                for j in range(0, RC3E_MATS, RC3E_BLOCK)})


def _graph_delta(before, after):
    """A shell's graph counts (``counts()``) between two readings: captures
    and replays, and each new capture's ms and graph MB."""
    n = len(before["capture_ms"])
    return dict(captures=after["captures"] - before["captures"],
                replays=after["replays"] - before["replays"],
                capture_ms=after["capture_ms"][n:],
                graph_mb=[b / 2**20 for b in after["graph_bytes"][n:]])


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
                graphs0 = shell.counts()
                wall, outs0 = _stream_run(shell, n, blocks_of, n_cycles)
                got = _lib.launches["stream_matmul_batched"] - before
                require(got == n * n_cycles,
                        f"rc3e mm{sz} n={n} {source}: {got} launches != "
                        f"{n * n_cycles}")
                graph = _graph_delta(graphs0, shell.counts())
                captures = rc3e_shapes() if source == "host" else 0
                require(DEV == "cpu" or (
                    graph["captures"] == captures
                    and graph["replays"] == n_cycles - captures),
                        f"rc3e mm{sz} n={n} {source}: {graph['captures']} "
                        f"captures, {graph['replays']} replays over "
                        f"{n_cycles} cycles (want {captures} and "
                        f"{n_cycles - captures})")
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
                    max_abs_err_core0=err, graph=graph)
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


def _regs_core(a, b, ucs):
    """A core that reads its slot's registers."""
    return ((a + b) * ucs["r1"],)


def _axpy_core(a, b):
    return (a * 2.0 + b,)


def _sub_core(a, b):
    return (a - b,)


def _item_core(a, b, ucs):
    """A core that syncs with the host: it cannot be captured."""
    return (a * ucs["r0"].item() + b,)


def shell_graph_replay_phase():
    """A 4-core ``FusedShell`` cycle's graph at the rc3e shapes: replays
    against direct calls, a register write, a hot swap, a refusal (module
    docstring, 7b)."""
    from repro_torch.core.graphs import GraphCaptureError
    from repro_torch.kernels import _lib
    from repro_torch.kernels import stream_matmul as mm
    from repro_torch.rc2f import CoreSpec, FusedShell, StreamSpec
    t_phase = time.monotonic()
    g, sz = RC3E_BLOCK, 16
    tail = RC3E_MATS % g or g
    spec = CoreSpec(f"mm{sz}", (StreamSpec((g, sz, sz)),) * 2,
                    (StreamSpec((g, sz, sz)),))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 66)
    card = DEV == "cuda"

    def blocks(rows):
        return {i: tuple(torch.randn((rows, sz, sz), generator=gen,
                                     device=DEV) for _ in range(2))
                for i in range(4)}

    shell = FusedShell(4, device=DEV)
    for i, core in enumerate((_stream_core, _regs_core, _axpy_core,
                              _stream_core)):
        shell.load(i, core, spec, f"tenant{i}")
    shell.slots[1].ucs.write("r1", 3)
    replays = []
    for rows in (g, tail):
        for _ in range(3):                  # a capture, then replays
            inputs = blocks(rows)
            out = shell.run_cycle(inputs)
        fn = getattr(shell.program, "fn", shell.program)
        direct = fn(*shell.bound)           # eager, on the same buffers
        torch.cuda.synchronize()
        equal = all(torch.equal(out[i][0], direct[i][0]) for i in range(4))
        plain = [mm.matmul_batched_ref(*inputs[0]),
                 (inputs[1][0] + inputs[1][1]) * 3.0,
                 inputs[2][0] * 2.0 + inputs[2][1],
                 mm.matmul_batched_ref(*inputs[3])]
        tol = dict(atol=MM_TOL[torch.float32] * sz ** 0.5,
                   rtol=MM_TOL[torch.float32])
        close = all(torch.allclose(out[i][0], plain[i], **tol)
                    for i in (0, 3)) and all(torch.equal(out[i][0], plain[i])
                                             for i in (1, 2))
        require(equal and close, f"shell_graph_replay: rows {rows}: the "
                f"replay against the direct call {equal}, the plain "
                f"versions {close}")
        replays.append(dict(rows=rows, bitwise_equal_direct=equal,
                            max_abs_err_mm=float(max(
                                (out[i][0] - plain[i]).abs().max()
                                for i in (0, 3)))))
    program = shell.program
    counts = shell.counts()
    require(not card or (counts["captures"] == 2
                         and counts["replays"] == 4),
            f"shell_graph_replay: counts {counts}")
    # a register written between two replays
    uploads = shell.slots[1].regs.uploads
    shell.slots[1].ucs.write("r1", -5)
    out_w = shell.run_cycle(inputs)
    torch.cuda.synchronize()
    register = dict(uploads=shell.slots[1].regs.uploads - uploads,
                    equal=torch.equal(out_w[1][0], (inputs[1][0]
                                                    + inputs[1][1]) * -5.0),
                    replayed=not card or shell.counts()["replays"] == 5)
    require(all(register.values()) and register["uploads"] == 1,
            f"shell_graph_replay: register write {register}")
    # a hot swap of slot 2
    reserved = torch.cuda.memory_reserved() if card else 0
    shell.load(2, _sub_core, spec, "tenant2-v2")
    out_s = shell.run_cycle(inputs)
    torch.cuda.synchronize()
    swap = dict(recaptured=shell.program is not program and (
                    not card or shell.program.captures == 1),
                old_dropped=not card or (not program._graphs
                                         and program._pool.live == 0),
                slot0_unchanged=torch.equal(out_s[0][0], out_w[0][0]),
                slot2_new=torch.equal(out_s[2][0],
                                      inputs[2][0] - inputs[2][1]))
    require(all(swap.values()), f"shell_graph_replay: hot swap {swap}")
    del program
    if card:
        torch.cuda.empty_cache()
    swap["reserved_mb_before"] = reserved / 2**20
    swap["reserved_mb_after"] = (torch.cuda.memory_reserved() if card
                                 else 0) / 2**20
    # a core that cannot be captured
    refusal = dict(named=None, refused_again=False, launches_after=None)
    if card:
        shell.load(3, _item_core, spec, "tenant3-sync")
        try:
            shell.run_cycle(inputs)
        except GraphCaptureError as e:
            refusal["named"] = str(e)
        before = dict(_lib.launches)
        try:
            shell.run_cycle(inputs)
        except GraphCaptureError:
            refusal["refused_again"] = True
        refusal["launches_after"] = {k: _lib.launches[k] - before[k]
                                     for k in before if _lib.launches[k]
                                     != before[k]}
        require(refusal["named"] is not None
                and "_item_core" in refusal["named"]
                and ".item()" in refusal["named"]
                and refusal["refused_again"]
                and not refusal["launches_after"],
                f"shell_graph_replay: refusal {refusal}")
    emit(dict(phase="shell_graph_replay", block=g, tail=tail,
              replays=replays, register=register, swap=swap,
              refusal=refusal, counts=shell.counts(),
              wall_s=time.monotonic() - t_phase))


# ---------------------------------------------------------------------------
# Model and engine phases
# ---------------------------------------------------------------------------

def plain_cfg(cfg):
    return cfg.replace(geometry=dataclasses.replace(cfg.geometry,
                                                    kernel_force="ref"))


def kernel_sites(cfg):
    """(attention-kernel sites, SSM sites) of a config. Flash launches once
    a prefill and decode once a decode step at each attention site (MLA
    sites run outside any kernel, as in the reference; whisper: its
    decoder's self-attention; its encoder and cross-attention are not
    causal self-attention); the SSD once a prefill at each SSM site."""
    from repro_torch.models.stages import plan_stages
    if cfg.family == "audio":
        return cfg.n_layers, 0
    sites = [s for st in plan_stages(cfg) for _ in range(st.repeats)
             for s in st.sites]
    ssm = sum(s.mixer == "ssm" for s in sites)
    return (0 if cfg.mla is not None else len(sites) - ssm), ssm


def family_batch(cfg, B, n_tok, seed=SEED):
    """A seeded prompt batch of ``n_tok`` tokens a row, with the config's
    precomputed patch embeddings (VLM: 576) or frame embeddings (audio:
    1500) of scale 0.1, as the reference's stub frontends take them.
    Returns (batch, position of the first decode step)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, n_tok)).astype(np.int32)).to(DEV)}
    gen = torch.Generator(device=DEV).manual_seed(seed + 20)
    if cfg.n_patches:
        batch["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model),
                                       generator=gen, device=DEV) * 0.1
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, cfg.encoder.max_frames,
                                       cfg.d_model), generator=gen,
                                      device=DEV) * 0.1
    return batch, n_tok + cfg.n_patches


@contextlib.contextmanager
def router_watch(log, captured=None):
    """Record every MoE routing while the block runs: per ``moe.route``
    call, each token's top-k margin (the k-th sorted router probability
    less the (k+1)-th), its experts and which of its assignments were kept
    (capacity). A routing recorded while a CUDA graph is captured goes to
    ``captured`` instead: its tensors are the graph's, and each replay of
    the graph rewrites them with that step's routing."""
    from repro_torch.kernels import _lib
    from repro_torch.layers import moe
    route = moe.route

    def watched(p, xf, opts):
        out = route(p, xf, opts)
        sp, _, expert, pos, cap, _ = out
        k = opts.cfg.top_k
        rec = dict(margin=sp[..., k - 1] - sp[..., k], expert=expert,
                   keep=(pos < cap).reshape(expert.shape))
        (captured if captured is not None and _lib._capturing()
         else log).append(rec)
        return out

    moe.route = watched
    try:
        yield
    finally:
        moe.route = route


def kernel_vs_plain_logits(cfg, params, n_tok, max_len, steps=4):
    """fp32 prefill of 2 x ``n_tok`` seeded tokens (``family_batch``: after
    the patches of a VLM, over the frames of the audio family) +
    ``steps`` greedy decode steps on the plain path (``kernel_force=
    "ref"``), then the same on the kernel path fed the plain path's tokens,
    the same weights. Returns the two (steps + 1, 2, vocab) logit stacks,
    the kernel path's launches, and the plain path's router margins: at
    each compared token, the smallest over the MoE layers ((steps + 1, 2);
    None without MoE), and the smallest it saw over every token."""
    from repro_torch.kernels import launches
    from repro_torch.models import Model
    cfg32 = cfg.replace(dtype="float32")
    batch, pos0 = family_batch(cfg32, 2, n_tok)
    out, got, feed = {}, {}, None
    for tag, c in (("plain", plain_cfg(cfg32)), ("kernel", cfg32)):
        before = dict(launches)
        m = Model(c, device=DEV)
        log = []
        with router_watch(log):
            h, caches = m.prefill(params, batch, max_len + cfg.n_patches)
            logs = [m.logits(params, h[:, -1:])[:, 0]]
            fed = [logs[0].argmax(-1).to(torch.int32)]
            pos = torch.full((2,), pos0, dtype=torch.int32, device=DEV)
            for s in range(steps):
                nxt = fed[s] if feed is None else feed[s]
                lg, caches = m.decode(params, caches, nxt[:, None], pos)
                logs.append(lg[:, 0])
                fed.append(lg[:, 0].argmax(-1).to(torch.int32))
                pos = pos + 1
        out[tag] = torch.stack(logs)
        got[tag] = {k: launches[k] - before[k] for k in launches}
        if tag == "plain":
            feed, plain_log = fed, log
        del caches, h
    require(not any(got["plain"].values()),
            f"{cfg.name}: the plain path launched {got['plain']}")
    near = smallest = None
    if plain_log:
        n_moe = len(plain_log) // (steps + 1)
        require(n_moe * (steps + 1) == len(plain_log),
                f"{cfg.name}: {len(plain_log)} routings over {steps + 1} "
                "calls")
        last = torch.stack([r["margin"].reshape(2, -1)[:, -1]
                            for r in plain_log])
        near = last.reshape(steps + 1, n_moe, 2).amin(1)
        smallest = min(float(r["margin"].min()) for r in plain_log)
    return out["kernel"], out["plain"], got["kernel"], near, smallest


def model_phase(cfg, params):
    """Full-width prefill + 4 decode steps, kernel path against the plain
    path, in fp32 (summation order is the only difference)."""
    tol = dict(atol=1e-3, rtol=1e-3)
    a, b, _, _, _ = kernel_vs_plain_logits(cfg, params, 100, 256)
    err = float((a - b).abs().max())
    require(bool(torch.isfinite(a).all()), "model: non-finite logits")
    require(tuple(a.shape) == (5, 2, cfg.vocab_size), "model: logits shape")
    require(torch.allclose(a, b, **tol), f"model: max err {err}")
    emit(dict(phase="model", layers=cfg.n_layers, dtype="float32",
              shape=list(a.shape), max_abs_err=err, tol=tol))


def families_model_phase(cfg, params, cut="", phase="families_model",
                         n_tok=600):
    """One family in fp32 at full width: a prefill of 2 x ``n_tok`` tokens
    (past gemma3's 512-token window; llava's 576 patches first; whisper
    over 1500 frames) + 4 decode steps, logits on the kernel path against
    the plain path at the model phase's tolerance. Launches: flash once an
    attention site, decode once an attention site a step (never where an
    attention softcap sends decode to the einsum path, gemma2, as in the
    reference), the SSD once an SSM site (``kernel_sites``; deepseek's MLA:
    none). MoE: a (step, row) whose logits miss the tolerance is counted,
    not failed, only where the plain run's router had a top-k near-tie at
    that token (k-th and (k+1)-th probability within ROUTER_TIE, in some
    layer): fp32 summation order then may pick another expert. Returns the
    kernel path's launches."""
    t_phase = time.monotonic()
    tol = dict(atol=1e-3, rtol=1e-3)
    steps = 4
    a, b, got, near, smallest = kernel_vs_plain_logits(cfg, params, n_tok,
                                                       n_tok + 40, steps)
    attn, ssm = kernel_sites(cfg)
    n_dec = 0 if cfg.attn_softcap else steps * attn
    need = {"flash_attention": attn, "decode_attention": n_dec,
            "ssd_chunk_scan": ssm}
    require(all(got[k] == need[k] for k in need)
            and sum(got.values()) == sum(need.values()),
            f"{phase} {cfg.name}: launches {got} != {need}")
    require(bool(torch.isfinite(a).all()),
            f"{phase} {cfg.name}: non-finite logits")
    require(tuple(a.shape) == (steps + 1, 2, cfg.vocab_size),
            f"{phase} {cfg.name}: logits shape")
    miss = ~torch.isclose(a, b, **tol).all(-1)           # (steps + 1, 2)
    excused = miss & (near < ROUTER_TIE) if near is not None \
        else torch.zeros_like(miss)
    err = float((a - b).abs().max())
    require(not bool((miss & ~excused).any()),
            f"{phase} {cfg.name}: max err {err}, outside {tol} at "
            f"(step, row) {(miss & ~excused).nonzero().tolist()}")
    held = ~excused[..., None].expand_as(a)
    rec = dict(phase=phase, arch=cfg.name, layers=cfg.n_layers,
               cut=cut or "none", d_model=cfg.d_model, heads=[
                   cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
               dtype="float32", prompt=[2, n_tok], patches=cfg.n_patches,
               decode_steps=steps, shape=list(a.shape), max_abs_err=err,
               max_abs_err_held=float((a - b).abs()[held].max()), tol=tol,
               launches=got, launches_needed=need,
               wall_s=time.monotonic() - t_phase)
    if cfg.family == "audio":
        rec["frames"] = cfg.encoder.max_frames
    if near is not None:
        rec.update(router_tie=ROUTER_TIE,
                   rows_excused_router_tie=int(excused.sum()),
                   rows_compared=int(miss.numel()),
                   router_margin_min=smallest,
                   router_margin_min_compared=float(near.min()))
    emit(rec)
    return got


def norms_to_one(params):
    """The reference's init sets each SSM block's gated RMSNorm weight and
    each MLA layer's ``kv_norm`` to 0, and ``rms_norm(..., plus_one=False)``
    then zeroes the block's output (the SSD would not reach the logits) and
    the MLA latent (hence its keys, values and output): set them to 1
    (upstream Mamba2's and DeepSeek-V2's init). Returns the params."""
    for st in params.get("stages", ()):
        for site in (st,) if isinstance(st, dict) else st:
            if "ssm" in site:
                site["ssm"]["norm"].fill_(1.0)
            if "kv_norm" in site.get("attn", {}):
                site["attn"]["kv_norm"].fill_(1.0)
    return params


def seeded_params(model, seed):
    """Seeded weights on the card, SSM gate norms and MLA ``kv_norm`` set to
    1 (``norms_to_one``)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return norms_to_one(model.init(gen))


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


def greedy_generate(model, params, batch, feed=None, n_new=None):
    """Greedy generation through the serve-step factories: one prefill of
    ``batch`` ((B, S) ``tokens``; whisper: and its ``frames``), then
    ``n_new`` (SSM_NEW_TOKENS by default) - 1 decode steps (the first token
    comes from the prefill). Decoder-only models run through the port's
    ``GreedyLoop`` (on the card: a prefill graph, and one decode graph the
    steps replay on the loop's fixed buffers); whisper, whose prefill
    builds its own caches, calls the factories eagerly.
    With ``feed`` (B, n_new), step i is fed ``feed[:, i - 1]`` instead of
    the model's own last token, so that two paths see the same inputs.
    Returns (own greedy tokens (B, n_new) on the host, logits (n_new, B, V)
    on the device, prefill ms, decode step ms list, the GreedyLoop or
    None)."""
    from repro_torch.runtime import GreedyLoop
    n_new = n_new or SSM_NEW_TOKENS
    B, S = batch["tokens"].shape
    if model.audio:
        return greedy_eager(model, params, batch, n_new) + (None,)
    # the caches of attention sites hold the prompt and the new tokens
    loop = GreedyLoop(model, B, S + n_new)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    lg, ids = loop.prefill(params, batch)
    logits, toks = [lg.clone()], [ids.clone()]   # a replay rewrites them
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    step_ms = []
    for i in range(1, n_new):
        t0 = time.monotonic()
        lg, ids = loop.step(params, None if feed is None else feed[:, i - 1])
        logits.append(lg.clone())
        toks.append(ids.clone())
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
    return (torch.stack(toks, 1).cpu().numpy(), torch.stack(logits),
            prefill_ms, step_ms, loop)


def greedy_eager(model, params, batch, n_new):
    """``greedy_generate`` through the step factories called eagerly,
    without a feed: (tokens, logits, prefill ms, step ms)."""
    from repro_torch.runtime import make_prefill_step, make_serve_step
    B, S = batch["tokens"].shape
    prefill = make_prefill_step(model, S + n_new)
    step = make_serve_step(model)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    h, caches = prefill(params, batch)
    logits = [model.logits(params, h[:, -1:])[:, 0]]
    toks = [logits[0].argmax(-1).to(torch.int32)]
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    step_ms = []
    pos = torch.full((B,), S, dtype=torch.int32, device=DEV)
    for _ in range(1, n_new):
        t0 = time.monotonic()
        lg, caches = step(params, caches, toks[-1][:, None], pos)
        logits.append(lg[:, 0])
        toks.append(lg[:, 0].argmax(-1).to(torch.int32))
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        pos = pos + 1
    return (torch.stack(toks, 1).cpu().numpy(), torch.stack(logits),
            prefill_ms, step_ms)


def _errs(a, b, tol):
    """Max and RMS of |a - b| over all logits, and the share outside
    atol + rtol |b|."""
    e = (a.float() - b.float()).abs()
    out = e > tol["atol"] + tol["rtol"] * b.float().abs()
    return dict(max=float(e.max()), rms=float(e.pow(2).mean().sqrt()),
                share_outside_tol=float(out.float().mean()))


def compare_forced(logits, tol16, phase="ssm_serve"):
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
            f"{phase}: non-finite logits")
    k32, p32 = logits["k32"], logits["p32"]
    err32 = _errs(k32, p32, SSM_LOGIT_TOL)
    require(err32["share_outside_tol"] == 0.0,
            f"{phase} fp32: logits outside {SSM_LOGIT_TOL}: {err32}")
    top2 = p32.topk(2, dim=-1).values                    # (n, B, 2)
    best = top2[..., 0]
    mine_idx = k32.argmax(-1)
    mine = p32.gather(-1, mine_idx[..., None])[..., 0]
    differ = mine_idx != p32.argmax(-1)
    near = best - mine <= (SSM_LOGIT_TOL["atol"]
                           + SSM_LOGIT_TOL["rtol"] * best.abs())
    require(not bool((differ & ~near).any()),
            f"{phase} fp32: {int((differ & ~near).sum())} greedy tokens "
            "are not the plain path's argmax nor a near-tie")
    n_tok = int(differ.numel())
    excused = int(differ.sum())
    require(2 * excused <= n_tok,
            f"{phase} fp32: {excused} of {n_tok} tokens excused")
    k16_err = _errs(logits["k16"], p32, tol16)
    p16_err = _errs(logits["p16"], p32, tol16)
    ratio = k16_err["rms"] / p16_err["rms"]
    require(ratio <= SSM_BF16_RMS_RATIO,
            f"{phase} bf16: kernel path RMS error {k16_err['rms']} against "
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


def ssm_decode_profile(loop, params, steps=10):
    """Device busy time of ``steps`` decode steps of ``loop`` (a
    ``GreedyLoop``: replays of its decode graph on the card) under the
    profiler; the idle share is taken against the wall time of ``steps``
    unprofiled steps just before (as ``profile_phase``)."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        for _ in range(steps):
            loop.step(params)
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


def loop_graphs(phase, loop, steps):
    """A GreedyLoop's graph counts after one prefill and ``steps`` decode
    steps (None on the CPU): on the card one prefill capture, and one
    decode capture that every later step replayed."""
    if DEV == "cpu":
        return None
    counts = loop.counts()
    require(counts["prefill"]["captures"] == 1
            and counts["decode"] == dict(graphs=1, captures=1,
                                         replays=steps - 1, evictions=0),
            f"{phase}: graphs {counts} after 1 prefill and {steps} steps")
    return dict(counts, prefill_capture_ms=loop._prefill.capture_ms,
                decode_capture_ms=loop._step.capture_ms)


def ssm_serve_phase(cfg, params, batches=SSM_BATCHES, phase="ssm_serve",
                    cut=""):
    """An SSM model in bf16 served through make_prefill_step /
    make_serve_step with greedy argmax on the device (mamba2-370m: 4
    prompts x 1024 tokens, then 8 x 256; zamba2-7b: 4 x 1024), 32 new
    tokens each, on the kernel path; then the plain path, and both paths in
    fp32, fed the kernel path's tokens (``compare_forced``). A prefill call
    must launch the SSD once an SSM site and flash once an attention site
    (zamba2's shared block), a decode step decode once an attention site
    (``kernel_sites``), and nothing else. Returns the launches of the bf16
    and of the fp32 kernel path."""
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
    path32 = dict(path)
    attn, ssm = kernel_sites(cfg)
    need = {k: 0 for k in _lib.launches}
    need.update(ssd_chunk_scan=ssm, flash_attention=attn,
                decode_attention=attn * (SSM_NEW_TOKENS - 1))
    for bi, (B, S) in enumerate(batches):
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                   .astype(np.int32)).to(DEV)
        before = dict(_lib.launches)
        t0 = time.monotonic()
        kt, k_logits, k_pre, k_steps, loop = greedy_generate(
            models["k16"], params, {"tokens": prompts})
        k_wall = time.monotonic() - t0
        got = {k: _lib.launches[k] - before[k] for k in before}
        graphs = loop_graphs(phase, loop, SSM_NEW_TOKENS - 1)
        for k in path:
            path[k] += got[k]
        require(got == need, f"{phase} {B}x{S}: launches {got}, needed "
                f"{need} (1 prefill call, {SSM_NEW_TOKENS - 1} decode steps)")
        require(kt.shape == (B, SSM_NEW_TOKENS)
                and bool(((kt >= 0) & (kt < cfg.vocab_size)).all()),
                f"{phase} {B}x{S}: token shape or range")
        prof = ssm_decode_profile(loop, params) if bi == 0 else None
        # a prefill replayed (timing only: after the path's launches were
        # read); the first call above ran eagerly and captured
        replay_ms = None
        if DEV != "cpu":
            torch.cuda.synchronize()
            t0 = time.monotonic()
            loop.prefill(params, {"tokens": prompts})
            torch.cuda.synchronize()
            replay_ms = (time.monotonic() - t0) * 1e3
            require(loop._prefill.replays == 1,
                    f"{phase}: the second prefill did not replay")
        loop.close()
        del loop
        logits = {"k16": k_logits}
        feed = torch.from_numpy(kt).to(DEV)
        for tag in ("p16", "k32", "p32"):
            before = dict(_lib.launches)
            t0 = time.monotonic()
            _, logits[tag], pre, steps, tloop = greedy_generate(
                models[tag], params, {"tokens": prompts}, feed=feed)
            loop_graphs(f"{phase} {tag}", tloop, SSM_NEW_TOKENS - 1)
            tloop.close()
            del tloop
            if tag == "p16":
                p_pre, p_steps = pre, steps
                p_wall = time.monotonic() - t0
            n = {k: _lib.launches[k] - before[k] for k in before}
            require(n == need if tag == "k32" else not any(n.values()),
                    f"{phase} {tag}: launches {n}")
            if tag == "k32":
                for k in path32:
                    path32[k] += n[k]
        checks = compare_forced(logits, tol, phase)
        del logits, k_logits
        n_tok = B * SSM_NEW_TOKENS
        rec = dict(phase=phase, arch=cfg.name, layers=cfg.n_layers,
                   cut=cut or "none", dtype=cfg.dtype,
                   prompts=B, prompt_tokens=S, new_tokens=SSM_NEW_TOKENS,
                   launches=got, ssd_plan=ssd_plan(
                       B, S, n_heads, cfg.ssm.head_dim, cfg.ssm.d_state,
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count)._asdict(),
                   logit_tol=tol, **checks,
                   kernel_path=dict(
                       prefill_ms=k_pre, prefill_replay_ms=replay_ms,
                       graphs=graphs,
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
    return path, path32


@contextlib.contextmanager
def engine_calls(calls, top8=None, routes=None):
    """Count every engine's decode and prefill calls (``calls``) while the
    block runs; with ``top8``, record each decoding slot's top-8 logits,
    keyed (request id, tokens generated so far), for ``compare_streams``;
    with ``routes`` (MoE), each decoding slot's routing in that step under
    the same key: per MoE layer, its experts and which were kept. On the
    card every decode call must capture its engine's graph (its first
    call) or replay it, and nothing else: ``calls`` counts the captures
    and the replays. So must every prefill call capture its prefill
    program's graph of the prompt's length or replay it: ``calls`` counts
    those captures and replays and the graphs evicted, and keeps each
    prefill program's card memory (its captures' reserved MB and its
    caches' MB, by program). A replayed step runs no Python: its routing
    is read from the tensors the engine's capture recorded
    (``router_watch``), which the replay rewrote."""
    from repro_torch.core.graphs import GraphProgram
    from repro_torch.runtime.serve import BatchingEngine
    dec, pre = BatchingEngine._decode, BatchingEngine._prefill
    log, captured, graph_routes = [], [], {}
    for k in ("captures", "replays", "prefill_captures", "prefill_replays",
              "prefill_evictions"):
        calls.setdefault(k, 0)
    calls.setdefault("prefill_mb", {})

    def decode(self, tokens, pos):
        calls["decode"] += 1
        log.clear()                      # routings of earlier prefills
        prog, n_cap = self._greedy, len(captured)
        was = (prog.captures, prog.replays) \
            if isinstance(prog, GraphProgram) else None
        logits = dec(self, tokens, pos)
        if DEV != "cpu":
            require(was is not None, "an engine's decode step is not a "
                    f"graph program: {prog!r}")
            cap, rep = prog.captures - was[0], prog.replays - was[1]
            require((cap, rep) in ((1, 0), (0, 1)),
                    f"an engine decode call captured {cap} and replayed "
                    f"{rep} graphs")
            calls["captures"] += cap
            calls["replays"] += rep
        if len(captured) > n_cap:        # this call captured the graph
            graph_routes[id(self)] = captured[n_cap:]
        step_log = log if log else graph_routes.get(id(self), [])
        rows = [(i, (r.request_id, len(r.out_tokens)))
                for i, r in enumerate(self._slots)
                if r is not None and i not in self._prefilling]
        if top8 is not None:
            top = logits[:, 0].float().topk(8, dim=-1)
            val, idx = top.values.cpu().numpy(), top.indices.cpu().numpy()
            for i, key in rows:
                top8[key] = dict(zip(idx[i].tolist(), val[i].tolist()))
        if routes is not None:
            require(step_log, "a MoE decode step recorded no routing")
            for i, key in rows:   # copies: a replay rewrites the graph's
                routes[key] = [(r["expert"][0, i].clone(),
                                r["keep"][0, i].clone()) for r in step_log]
        return logits

    def prefill(self, toks):
        calls["prefill"] += 1
        prog = self._prefill_fn
        was = prog.counts()
        out = pre(self, toks)
        if DEV != "cpu":
            now = prog.counts()
            cap, rep = (now["captures"] - was["captures"],
                        now["replays"] - was["replays"])
            require((cap, rep) in ((1, 0), (0, 1)),
                    f"an engine prefill call of length {toks.shape[1]} "
                    f"captured {cap} and replayed {rep} graphs")
            calls["prefill_captures"] += cap
            calls["prefill_replays"] += rep
            calls["prefill_evictions"] += now["evictions"] - was["evictions"]
            calls["prefill_mb"][prog._program.__name__] = dict(
                graphs=now["graphs"],
                capture_reserved_mb=now["graph_bytes"] / 1e6,
                caches_mb=now["cache_bytes"] / 1e6)
        return out

    BatchingEngine._decode, BatchingEngine._prefill = decode, prefill
    try:
        with router_watch(log, captured) if routes is not None \
                else contextlib.nullcontext():
            yield
    finally:
        BatchingEngine._decode, BatchingEngine._prefill = dec, pre


def program_launches(phase, cfg, calls, configures, paged, got):
    """The launches a serving run needs: one decode launch an attention
    site (``kernel_sites``: every layer of a dense model, none of an MLA
    one) for every engine decode call, plus one a configure of a decode
    program (``Reconfigurator.configure`` warms it up once), one flash
    launch an attention site for every prefill call; where the model's
    decode takes the group kernel's route, every decode launch counts under
    ``decode_group`` too; fails unless ``got`` is exactly that (a run that
    decoded without launching bypassed the kernels)."""
    from repro_torch.kernels.decode_attention import uses_group_kernel
    dec = "paged_decode_attention" if paged else "decode_attention"
    attn = kernel_sites(cfg)[0]
    need = {dec: (calls["decode"] + configures) * attn,
            "flash_attention": calls["prefill"] * attn}
    if uses_group_kernel(cfg.n_heads // max(cfg.n_kv_heads, 1),
                         cfg.resolved_head_dim, cfg.dtype):
        need["decode_group"] = need[dec]    # of those, the group kernel's
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


def serve(model, params, prompts, paged, new_tokens=32, top8=None,
          routes=None):
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
    with engine_calls(calls, top8, routes):  # plain path: its top 8
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
                   decode_steps=eng.steps, graph=graph_stats(eng, calls),
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


def graph_stats(eng, calls):
    """An engine's decode graph (None on the CPU): its captures and
    replays, the ms each capture took and the card memory it reserved. On
    the card an engine captures once and replays every later step. And its
    prefill program's: captures (one a prompt length), replays, graphs
    evicted, the ms of its captures, the card memory they reserved and its
    caches' (``engine_calls`` gated each prefill call)."""
    g = eng._greedy
    if DEV == "cpu":
        return None
    pg = eng._prefill_fn._program
    out = dict(captures=calls["captures"], replays=calls["replays"],
               capture_ms=g.capture_ms,
               graph_mb=[b / 1e6 for b in g.graph_bytes],
               prefill=dict(captures=calls["prefill_captures"],
                            replays=calls["prefill_replays"],
                            evictions=calls["prefill_evictions"],
                            capture_ms=pg.capture_ms,
                            programs_mb=calls["prefill_mb"]))
    require(calls["captures"] == 1
            and calls["replays"] == calls["decode"] - 1,
            f"engine: {calls['decode']} decode calls, {out}")
    require(calls["prefill_captures"] + calls["prefill_replays"]
            == calls["prefill"],
            f"engine: {calls['prefill']} prefill calls, {out['prefill']}")
    return out


def routed_apart(routes, key):
    """Whether the two runs' MoE routing of one token differs in some
    layer: another set of experts, or another set kept under capacity (an
    order swap inside the top k alone changes neither)."""
    def sets(expert, keep):
        return (torch.sort(expert).values,
                torch.sort(torch.where(keep, expert, -1)).values)

    return any(not all(torch.equal(x, y) for x, y in zip(sets(*a), sets(*b)))
               for a, b in zip(routes[0][key], routes[1][key]))


def compare_streams(kern, plain, top8, tol, routes=None):
    """Streams must be equal, except from a step where the token the kernel
    path took has a plain-path logit within the logit tolerance
    (atol + rtol |top|) of the plain path's top logit (a near-tie; bf16
    logits tie exactly at times), or, for MoE (``routes``: the kernel and
    plain runs' routing of every decoding slot, ``engine_calls``), where
    the two paths routed that very token apart (in bf16 the two attention
    paths' rounding moves a router probability across a top-k boundary);
    the rest of such a stream is not compared. Returns the counts."""
    flips = compared = by_route = 0
    apart = []
    for rid, (a, b) in enumerate(zip(kern, plain)):
        for i, (x, y) in enumerate(zip(a, b)):
            compared += 1
            moved = routes is not None and routed_apart(routes, (rid, i))
            apart.append(moved)
            if x != y:
                cand = top8[(rid, i)]
                best = max(cand.values())
                tie = x in cand and best - cand[x] <= \
                    tol["atol"] + tol["rtol"] * abs(best)
                require(tie or moved,
                        f"request {rid} token {i}: {x} != {y}, plain "
                        f"logits {cand.get(x)} vs {best}"
                        + (", routed alike" if routes is not None else ""))
                flips += 1
                by_route += not tie
                break
    gaps = [sorted(c.values())[-1] - sorted(c.values())[-2]
            for c in top8.values()]
    out = dict(streams_equal=flips == 0, divergent_steps_within_tol=flips,
               tokens_compared=compared, min_plain_margin=min(gaps),
               plain_steps_with_tie=sum(g == 0 for g in gaps))
    if routes is not None:
        out.update(divergent_steps_routed_apart=by_route,
                   tokens_routed_apart=sum(apart))
    return out


def engine_phase(phase, cfg, params, prompts, paged, cut=""):
    """Serve ``prompts`` on the kernel path and on the plain path; check the
    launches and compare the streams at the logit tolerance of the
    config's dtype (MoE: with both runs' routing, ``compare_streams``)."""
    from repro_torch.kernels import launches
    from repro_torch.models import Model
    routes = ({}, {}) if cfg.moe is not None else (None, None)
    before = dict(launches)
    kern, km = serve(Model(cfg, device=DEV), params, prompts, paged,
                     routes=routes[0])
    got = {k: launches[k] - before[k] for k in launches}
    top8 = {}
    plain, pm = serve(Model(plain_cfg(cfg), device=DEV), params, prompts,
                      paged, top8=top8, routes=routes[1])
    require(all(launches[k] - before[k] == got[k] for k in launches),
            "plain path launched a kernel")
    need = program_launches(phase, cfg, dict(decode=km["decode_calls"],
                                             prefill=km["prefill_calls"]),
                            0, paged, got)
    tol = TOL[getattr(torch, cfg.dtype)]
    streams = compare_streams(kern, plain, top8, tol,
                              routes if cfg.moe is not None else None)
    emit(dict(phase=phase, arch=cfg.name, layers=cfg.n_layers,
              cut=cut or "none", dtype=cfg.dtype, kv_quant=cfg.kv_quant,
              paged=paged, launches=got,
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
# The decode step as CUDA graphs (core/graphs.py)
# ---------------------------------------------------------------------------

def replay_against_direct(eng, params):
    """Wrap ``eng._decode``: each step, replayed from the engine's graph,
    is followed by a direct call of the captured function (the serve step
    and ``greedy_tail``, eagerly) on copies of the step's inputs. Returns
    the list of (ids equal, largest |logit difference|) a step."""
    step = eng._greedy.fn
    dec = eng._decode
    got = []

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(clone(v) for v in tree)
        return tree.clone()

    def decode(tokens, pos):
        caches = clone(eng.caches)
        extra = (torch.from_numpy(np.ascontiguousarray(
            eng.pool.block_tables, np.int32)).to(DEV),) if eng.paged else ()
        logits = dec(tokens, pos).clone()
        ids = eng._step_ids.clone()
        want, want_ids = step(
            params, caches, torch.from_numpy(np.array(tokens)).to(DEV),
            torch.from_numpy(np.array(pos, np.int32)).to(DEV), *extra)
        got.append((bool(torch.equal(ids, want_ids)),
                    float((logits.float() - want.float()).abs().max())))
        return logits

    eng._decode = decode
    return got


def graph_replay_phase(cfg, params, prompts):
    """smollm-135m at full width and depth, 8 slots x 2048, 8 requests of
    the workload: for each engine (dense and paged; bf16, fp32, int8 KV)
    its first decode step captures the graph and the next GRAPH_STEPS
    replay it, each held against a direct call of the captured function on
    copies of the same inputs: the ids identical, the largest logit
    difference reported (fp32: within GRAPH_FP32_TOL). Launches: one decode
    a layer for each step and each direct call."""
    from repro_torch.kernels import _lib
    from repro_torch.models import Model
    from repro_torch.runtime import BatchingEngine
    rows = []
    for dtype, quant in (("bfloat16", False), ("float32", False),
                         ("bfloat16", True)):
        c = cfg.replace(dtype=dtype, kv_quant=quant)
        for paged in (False, True):
            eng = BatchingEngine(Model(c, device=DEV), params, n_slots=8,
                                 max_len=2048, paged=paged, page_size=16)
            for p, t in prompts[:8]:
                eng.submit(p, max_new_tokens=64, tenant=t)
            got = replay_against_direct(eng, params)
            _lib.launches.reset()
            while len(got) < GRAPH_STEPS + 1:
                eng.step()
            name = "paged_decode_attention" if paged else "decode_attention"
            need = 2 * c.n_layers * len(got)
            require(_lib.launches[name] == need,
                    f"graph_replay: {_lib.launches[name]} {name} launches, "
                    f"{need} needed")
            counts = eng._greedy.counts()
            require(counts == dict(graphs=1, captures=1, replays=len(got) - 1,
                                   evictions=0),
                    f"graph_replay: {counts} over {len(got)} steps")
            diff = max(d for _, d in got)
            require(all(same for same, _ in got),
                    f"graph_replay {dtype} kv_quant={quant} paged={paged}: "
                    "a replay's tokens differ from the direct call's")
            require(dtype != "float32" or diff <= GRAPH_FP32_TOL,
                    f"graph_replay fp32 paged={paged}: logits {diff} apart")
            rows.append(dict(dtype=dtype, kv_quant=quant, paged=paged,
                             replays=len(got) - 1, ids_equal=True,
                             max_logit_diff=diff,
                             capture_ms=eng._greedy.capture_ms[0],
                             graph_mb=eng._greedy.graph_bytes[0] / 1e6))
            del eng._decode, eng        # the wrapper's cycle with eng
            free_card()
    emit(dict(phase="graph_replay", arch=cfg.name, layers=cfg.n_layers,
              steps=GRAPH_STEPS, fp32_tol=GRAPH_FP32_TOL, rows=rows))


def prefill_leaf_check(got, want, dtype):
    """Leaf by leaf, a replayed prefill's caches against a direct call's:
    the names of the leaves not bit-equal; fails unless each of those is
    within 1e-5 (fp32), the bf16 tolerance (bf16) or one quantization step
    (int8 K/V), positions always bit-equal."""
    from repro_torch.core.graphs import _leaves
    off = []
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"prefill leaf {i}: {g.shape}/{g.dtype} vs {w.shape}/"
                f"{w.dtype}")
        if torch.equal(g, w):
            continue
        require(g.dtype not in (torch.int32, torch.int64),
                f"prefill leaf {i}: positions differ")
        d = (g.float() - w.float()).abs()
        if g.dtype == torch.int8:
            ok = bool((d <= 1).all())
        else:
            tol = dict(atol=GRAPH_FP32_TOL, rtol=0.0) \
                if dtype == torch.float32 else TOL[torch.bfloat16]
            ok = bool((d <= tol["atol"] + tol["rtol"] * w.float().abs())
                      .all())
        require(ok, f"prefill leaf {i} ({g.dtype}): {float(d.max())} apart")
        off.append(dict(leaf=i, dtype=str(g.dtype).split(".")[-1],
                        max_abs_diff=float(d.max())))
    return off


def prefill_graph_replay_phase(cfg, params, prompts):
    """smollm-135m at full width and depth, engines of 8 slots x 2048,
    dense and paged, bf16, fp32 and int8 KV. For each pad bucket the
    workload's prompts fall in: one call of the engine's prefill program
    (its first of the bucket captures the graph), then a replay on another
    prompt of the bucket, held against a direct eager prefill of that
    prompt into a new cache tree: every cache leaf bit-equal, or within
    the stated tolerance (``prefill_leaf_check``; the record names the
    leaf), and the hidden states bit-equal or within it. Then 8 requests
    of the workload, 16 new tokens each: the engine's token streams with
    the prefill program equal those of an engine whose prefill is the
    eager call, and a ``step_async`` run (chunk PREFILL_CHUNK) in which at
    least two admissions of one bucket are pending at once gives the
    lockstep streams. Launches here are comparisons, not a path: main
    zeroes the counts after the graph phases."""
    from repro_torch.models import Model
    from repro_torch.runtime import BatchingEngine
    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 50)
    rows = []
    for dtype, quant in (("bfloat16", False), ("float32", False),
                         ("bfloat16", True)):
        c = cfg.replace(dtype=dtype, kv_quant=quant)
        model = Model(c, device=DEV)
        for paged in (False, True):
            def engine():
                return BatchingEngine(model, params, n_slots=8,
                                      max_len=2048, paged=paged,
                                      page_size=16)
            eng = engine()
            prog = eng._prefill_fn
            by_bucket = {}
            for p, _ in prompts:
                by_bucket.setdefault(eng._pad_ctx(p[:-1]).shape[1],
                                     []).append(p[:-1])
            buckets = []
            for b, ctxs in sorted(by_bucket.items()):
                other = rng.integers(0, c.vocab_size, size=len(ctxs[0]))
                prog(params, eng._pad_ctx(ctxs[0]))
                was = prog.counts()
                toks = eng._pad_ctx(other.astype(np.int32))
                hidden, caches = prog(params, toks)
                now = prog.counts()
                if DEV != "cpu":
                    require(now["replays"] == was["replays"] + 1
                            and now["captures"] == was["captures"],
                            f"prefill_graph_replay: bucket {b} did not "
                            f"replay: {was} -> {now}")
                want_h, want = model.prefill(
                    params, {"tokens": torch.from_numpy(toks).to(DEV)},
                    2048, clamp_window=not paged)
                off = prefill_leaf_check(caches, want, getattr(torch, dtype))
                h_diff = float((hidden.float() - want_h.float()).abs().max())
                require(h_diff <= (GRAPH_FP32_TOL if dtype == "float32"
                                   else TOL[torch.bfloat16]["atol"]),
                        f"prefill_graph_replay: bucket {b} hidden "
                        f"{h_diff} apart")
                buckets.append(dict(bucket=b, prompts=len(ctxs),
                                    leaves_not_bit_equal=off,
                                    hidden_max_abs_diff=h_diff))
                del hidden, caches, want_h, want
            reqs = prompts[:8]

            def run(e, mode):
                rs = [e.submit(p, max_new_tokens=16, tenant=t)
                      for p, t in reqs]
                pending = []
                for _ in range(10000):
                    if mode == "step":
                        e.step()
                    else:
                        e.step_async(prefill_chunk=PREFILL_CHUNK)
                        pending.append(collections.Counter(
                            e._pad_ctx(e._ctx_tokens(e._slots[i])[:-1])
                            .shape[1] for i in e._prefilling))
                    if e.idle():
                        break
                require(e.idle(), "prefill_graph_replay: not drained")
                return [r.out_tokens for r in rs], pending

            calls = {"decode": 0, "prefill": 0}
            with engine_calls(calls):
                graph_logs, _ = run(eng, "step")
                async_logs, pending = run(engine(), "async")
            plain = engine()
            plain._prefill_fn = lambda p, toks: model.prefill(
                p, {"tokens": torch.from_numpy(toks).to(DEV)}, 2048,
                clamp_window=not paged)
            eager_logs, _ = run(plain, "step")
            together = max((n for cnt in pending for n in cnt.values()),
                           default=0)
            require(graph_logs == eager_logs,
                    f"prefill_graph_replay {dtype} kv_quant={quant} "
                    f"paged={paged}: streams differ from the eager "
                    "prefill's")
            require(together >= 2, "prefill_graph_replay: no two pending "
                    f"prefills of one bucket at once: {pending[:3]}")
            require(async_logs == graph_logs,
                    f"prefill_graph_replay {dtype} kv_quant={quant} "
                    f"paged={paged}: step_async streams differ from step's")
            rows.append(dict(
                dtype=dtype, kv_quant=quant, paged=paged, buckets=buckets,
                streams_equal_eager=True, async_streams_equal=True,
                async_pending_one_bucket_max=together,
                engine_calls=calls, program=prog.counts(),
                capture_ms=None if prog._program is None
                else prog._program.capture_ms))
            del eng, plain, prog
            free_card()
    emit(dict(phase="prefill_graph_replay", arch=cfg.name,
              layers=cfg.n_layers, fp32_tol=GRAPH_FP32_TOL,
              bf16_tol=TOL[torch.bfloat16], rows=rows,
              phase_wall_s=time.monotonic() - t_phase))


def graph_profile_phase(cfg, params, prompts):
    """One replayed decode step under ``torch.profiler``, dense and paged
    (bf16, 8 slots): the decode kernels by name, the split pass (the split
    or the group kernel) and the merge pass once an attention site, and
    the step's device ops and busy ms."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import Model
    from repro_torch.runtime import BatchingEngine
    sites = kernel_sites(cfg)[0]
    for paged in (False, True):
        eng = BatchingEngine(Model(cfg, device=DEV), params, n_slots=8,
                             max_len=2048, paged=paged, page_size=16)
        for p, t in prompts[:8]:
            eng.submit(p, max_new_tokens=64, tenant=t)
        for _ in range(3):
            eng.step()                  # admit, capture, replay
        args = (eng.params, eng.caches, eng._tok, eng._posd) \
            + ((eng._bt,) if paged else ())
        replays = eng._greedy.replays
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng._greedy(*args)
            torch.cuda.synchronize()
        require(eng._greedy.replays == replays + 1,
                "graph_profile: the profiled call did not replay")
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        by = {k: sum(e.count for e in dev if k in e.key)
              for k in ("decode_split_kernel", "decode_group_kernel",
                        "decode_merge_kernel", "flash_")}
        require(by["decode_split_kernel"] + by["decode_group_kernel"]
                == by["decode_merge_kernel"] == sites and not by["flash_"],
                f"graph_profile paged={paged}: decode kernels {by} in one "
                f"replay, {sites} attention sites")
        emit(dict(phase="graph_profile", arch=cfg.name, paged=paged,
                  attention_sites=sites, decode_kernels=by,
                  device_ops=sum(e.count for e in dev),
                  device_busy_ms=sum(e.self_device_time_total
                                     for e in dev) / 1e3))
        del eng


def graph_refusal_phase():
    """``Reconfigurator.configure`` of a step that syncs with the host
    (``torch.cuda.synchronize()``) and of one that uploads from pageable
    memory (``torch.tensor(..., device=...)``): each raises
    ``GraphCaptureError`` naming the op's source line; the program then
    refuses a call without running the step; the card still computes."""
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.core.graphs import GraphCaptureError, GraphProgram
    ran = []

    def synced_step(x):
        ran.append(1)
        y = x * 2
        torch.cuda.synchronize()
        return y

    def uploading_step(x):
        ran.append(1)
        return x * torch.tensor(2.0, device=x.device)

    out = {}
    free_card()
    reserved = torch.cuda.memory_reserved()
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1), device=DEV)
    for fn, op in ((synced_step, "torch.cuda.synchronize()"),
                   (uploading_step, "torch.tensor(2.0, device=x.device)")):
        try:
            hv.reconfig.configure(fn, (torch.empty((4, 4), device="meta"),))
            msg = None
        except GraphCaptureError as e:
            msg = str(e)
        require(msg is not None and op in msg,
                f"graph_refusal: configure of {fn.__name__}: {msg!r}")
        program = GraphProgram(fn, DEV)
        x = torch.ones((4, 4), device=DEV)
        for i in range(2):
            n = len(ran)
            try:
                program(x)
                refused = False
            except GraphCaptureError:
                refused = True
            # the first call runs the step (eagerly, then under the
            # capture that fails); a refused program runs nothing
            require(refused and (len(ran) > n if i == 0 else len(ran) == n),
                    f"graph_refusal: call {i} of {fn.__name__} ran "
                    f"{len(ran) - n} times, refused {refused}")
        out[fn.__name__] = msg
    require(len(hv.reconfig.cache) == 0, "graph_refusal: a refused program "
            "entered the program cache")
    x = torch.ones((64, 64), device=DEV)
    require(float((x @ x).sum()) == 64.0 ** 3,
            "graph_refusal: the card computes wrong after a refused capture")
    # the allocator still returns memory: a refused capture left it routing
    # to the graph's pool, where it empties no cache (repaired in graphs.py)
    x = torch.empty(1 << 30, dtype=torch.uint8, device=DEV)
    del x
    free_card()
    after = torch.cuda.memory_reserved()
    require(after <= reserved + (64 << 20),
            f"graph_refusal: {after - reserved} bytes stay reserved after a "
            "refused capture")
    emit(dict(phase="graph_refusal", messages=out,
              reserved_bytes_before=reserved, reserved_bytes_after=after))


def graph_configure_phase(cfg, params, prompts):
    """Table I on the serving program, and the graphs of a fleet's
    engines: a paged ``GatewayFleet`` of smollm-135m (bf16, 4 slots x
    2048) over 4 devices, one tenant of 4 slots on each (rsaas), serves 8
    requests of the workload, 8 new tokens each. The first engine's
    ``configure`` (the meta check, the warm-up run, the capture; its
    capture ms) against the other engines' PR swaps; each engine's own
    capture (ms, card memory reserved) at its first step; every later step
    a replay."""
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.models import Model
    from repro_torch.runtime import GatewayFleet
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=4), device=DEV)
    calls = {"decode": 0, "prefill": 0}
    with engine_calls(calls):
        fleet = GatewayFleet(hv, Model(cfg, device=DEV), params, n_slots=4,
                             max_len=2048, paged=True, page_size=16)
        for t in "abcd":
            fleet.open_session(t, slots=4, service_model="rsaas")
        reqs = [fleet.submit("abcd"[i % 4], p, max_new_tokens=8)
                for i, (p, _) in enumerate(prompts[:8])]
        fleet.run_until_idle()
    require(all(len(r.out_tokens) == 8 for r in reqs),
            "graph_configure: short streams")
    up = next(e for e in hv.log if e["kind"] == "fleet_up")
    swaps = [e for e in hv.log if e["kind"] == "engine_up"]
    program = hv.reconfig.cache.entry_for(fleet.program_fingerprint).compiled
    chained = list(program._chained.values())
    require(len(swaps) == 4 and all(e["cache_hit"] for e in swaps)
            and len(chained) == 1,
            f"graph_configure: {len(swaps)} engines, {len(chained)} chained")
    engines = chained[0]
    require(engines.captures == calls["captures"] == 4
            and engines.replays == calls["replays"] == calls["decode"] - 4,
            f"graph_configure: {engines.counts()} for {calls}")
    emit(dict(phase="graph_configure", table="I", arch=cfg.name,
              configure_s=up["compile_s"],
              configure_capture_ms=program.capture_ms[0],
              configure_graph_mb=program.graph_bytes[0] / 1e6,
              pr_swap_s=[e["swap_s"] for e in swaps],
              engine_capture_ms=engines.capture_ms,
              engine_graph_mb=[b / 1e6 for b in engines.graph_bytes],
              decode_calls=calls["decode"], replays=calls["replays"]))
    fleet.close()


# ---------------------------------------------------------------------------
# The remaining families: MoE, MLA, hybrid, encoder-decoder, VLM
# ---------------------------------------------------------------------------

def whisper_serve_phase(cfg, params):
    """whisper-tiny in bf16 at full width and depth: WHISPER_B streams over
    1500 seeded frames each and a WHISPER_PROMPT-token decoder prompt, then
    WHISPER_STEPS greedy decode steps through the serve-step factories
    (``Model.prefill`` / ``Model.decode``) on the kernel path and on the
    plain path; streams under ``compare_streams``. Launches: flash once a
    decoder layer (one prefill), decode once a decoder layer a step; the
    encoder's and the cross-attention's einsums launch nothing. Returns
    the kernel path's launches."""
    from repro_torch.kernels import launches
    from repro_torch.models import Model
    t_phase = time.monotonic()
    batch, _ = family_batch(cfg, WHISPER_B, WHISPER_PROMPT, SEED + 31)
    runs = {}
    for tag, c in (("kernel", cfg), ("plain", plain_cfg(cfg))):
        before = dict(launches)
        t0 = time.monotonic()
        toks, logits, pre, steps, _ = greedy_generate(
            Model(c, device=DEV), params, batch, n_new=WHISPER_STEPS + 1)
        wall = time.monotonic() - t0
        n = toks.size
        runs[tag] = (toks.tolist(), logits, dict(
            streams=WHISPER_B, tokens=n, wall_s=wall, tokens_per_s=n / wall,
            prefill_ms=pre, step_ms_p50=float(np.percentile(steps, 50)),
            step_ms_p95=float(np.percentile(steps, 95))),
            {k: launches[k] - before[k] for k in launches})
    kern, _, km, got = runs["kernel"]
    plain, plain_logits, pm, plain_got = runs["plain"]
    require(not any(plain_got.values()),
            f"whisper_serve: the plain path launched {plain_got}")
    need = {k: 0 for k in launches}
    need.update(flash_attention=cfg.n_layers,
                decode_attention=cfg.n_layers * WHISPER_STEPS)
    require(got == need, f"whisper_serve: launches {got} != {need}")
    require(all(0 <= t < cfg.vocab_size for row in kern for t in row),
            "whisper_serve: token range")
    top = plain_logits.float().topk(8, dim=-1)           # (n, B, 8)
    val, idx = top.values.cpu().numpy(), top.indices.cpu().numpy()
    top8 = {(r, i): dict(zip(idx[i, r].tolist(), val[i, r].tolist()))
            for i in range(idx.shape[0]) for r in range(WHISPER_B)}
    tol = TOL[getattr(torch, cfg.dtype)]
    emit(dict(phase="whisper_serve", arch=cfg.name, layers=[
        cfg.encoder.n_layers, cfg.n_layers], dtype=cfg.dtype,
        frames=cfg.encoder.max_frames, prompt=WHISPER_PROMPT,
        decode_steps=WHISPER_STEPS, launches=got, launches_needed=need,
        logit_tol=tol, **compare_streams(kern, plain, top8, tol),
        kernel_path=km, plain_path=pm, wall_s=time.monotonic() - t_phase))
    return got


def mla_paged_refusal_phase(cfg, params):
    """An MLA model's paged engine is refused before anything is allocated
    on the card (the reference's message)."""
    from repro_torch.models import Model
    from repro_torch.runtime import BatchingEngine
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    msg = ""
    try:
        BatchingEngine(Model(cfg, device=DEV), params, n_slots=8,
                       max_len=2048, paged=True, page_size=16)
    except ValueError as e:
        msg = str(e)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    require("MLA latents are not paged" in msg and after == mem,
            f"deepseek paged engine: refusal {msg!r}, card memory "
            f"{mem} -> {after} bytes")
    emit(dict(phase="deepseek_paged_refused", arch=cfg.name, message=msg,
              allocated_bytes_before=mem, allocated_bytes_after=after))


def families2_phases(get_config, fp32_path):
    """The eighth slice's families at full width, each phase with the
    counts zeroed before its path and read after it: qwen3-moe (6 of 48
    layers), deepseek-v2-lite (6 of 27: the dense first layer and 5 MoE)
    and llava (4 of 60; text) through both engines in bf16 (deepseek: the
    dense engine, and the paged one's refusal), qwen3-moe's decode step
    profiled; zamba2-7b (81 layers) through the serve-step factories and
    whisper-tiny through ``Model.prefill`` / ``Model.decode``, full depth;
    ``families2_model`` (fp32 logits, kernel against plain) for all five.
    Weights are freed between families. Returns the serving launches of
    the bf16 paths; adds fp32 flash's to ``fp32_path``."""
    from repro_torch.kernels import _lib
    from repro_torch.models import Model
    path = {k: 0 for k in _lib.launches}
    fp32_path["families2_model"] = fp32_path["zamba2_serve_fp32"] = 0

    def add(got):
        for k in path:
            path[k] += got[k]

    for i, (tag, arch) in enumerate((("qwen3moe", "qwen3-moe-30b-a3b"),
                                     ("deepseek", "deepseek-v2-lite-16b"),
                                     ("llava", "llava-next-34b"))):
        full = get_config(arch)
        fcfg = full.replace(n_layers=FAMILY2_LAYERS[arch])
        cut = (f"n_layers {full.n_layers} -> {fcfg.n_layers} (fp32 master "
               "weights at full depth do not fit beside their bf16 casts "
               "on 80 GB)")
        fparams = seeded_params(Model(fcfg, device=DEV), SEED + 40 + i)
        fprompts = workload(fcfg.vocab_size)
        _lib.launches.reset()               # this family's serving path
        engine_phase(f"{tag}_dense_engine", fcfg, fparams, fprompts, False,
                     cut)
        if fcfg.mla is not None:
            mla_paged_refusal_phase(fcfg, fparams)
        else:
            engine_phase(f"{tag}_paged_engine", fcfg, fparams, fprompts,
                         True, cut)
        add(_lib.launches)
        if tag == "qwen3moe":
            profile_phase("profile_qwen3moe_dense_decode", fcfg, fparams,
                          fprompts, False)
        got = families_model_phase(fcfg, fparams, cut, "families2_model")
        fp32_path["families2_model"] += got["flash_attention"]
        del fparams
        free_card()

    zcfg = get_config("zamba2-7b")
    zparams = seeded_params(Model(zcfg, device=DEV), SEED + 43)
    got = families_model_phase(zcfg, zparams, phase="families2_model")
    fp32_path["families2_model"] += got["flash_attention"]
    _lib.launches.reset()                   # zamba2's serving path
    got16, got32 = ssm_serve_phase(zcfg, zparams, batches=((4, 1024),),
                                   phase="zamba2_serve")
    add(got16)
    fp32_path["zamba2_serve_fp32"] += got32["flash_attention"]
    del zparams
    free_card()

    wcfg = get_config("whisper-tiny")
    wparams = seeded_params(Model(wcfg, device=DEV), SEED + 44)
    got = families_model_phase(wcfg, wparams, phase="families2_model",
                               n_tok=8)
    fp32_path["families2_model"] += got["flash_attention"]
    _lib.launches.reset()                   # whisper's serving path
    add(whisper_serve_phase(wcfg, wparams))
    del wparams
    free_card()
    require(all(path[k] > 0 for k in SERVING_KERNELS + ("ssd_chunk_scan",)),
            f"a kernel of the families2 paths never launched: {path}")
    return path


def wide_group_cfg(get_config):
    """qwen3-moe-30b-a3b's config at Qwen3-235B-A22B's widths, cut to
    ``WIDE_GROUP_LAYERS`` layers (no new config in the registry)."""
    base = get_config("qwen3-moe-30b-a3b")
    return base.replace(n_layers=WIDE_GROUP_LAYERS,
                        moe=dataclasses.replace(base.moe, **WIDE_GROUP_MOE),
                        **WIDE_GROUP_WIDTHS)


def wide_group_engine_phase(get_config):
    """The slice's path: Qwen3-235B-A22B's widths (a group of 16 query
    heads a kv head, decoded by the group kernel) through the dense and the
    paged ``BatchingEngine`` in bf16, the gates of the MoE engines, then
    the dense decode step profiled. Returns the path's launches."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.decode_attention import uses_group_kernel
    from repro_torch.models import Model
    cfg = wide_group_cfg(get_config)
    g = cfg.n_heads // cfg.n_kv_heads
    require(g == 16 and uses_group_kernel(g, cfg.resolved_head_dim,
                                          torch.bfloat16),
            f"wide_group_engine: group {g} is not Qwen3-235B-A22B's 16 on "
            "the decode group kernel")
    cut = (f"n_layers 94 -> {cfg.n_layers} (qwen3-moe-30b-a3b's config at "
           "Qwen3-235B-A22B's widths; fp32 weights and their bf16 casts on "
           "80 GB, chip time)")
    t_phase = time.monotonic()
    params = seeded_params(Model(cfg, device=DEV), SEED + 50)
    prompts = workload(cfg.vocab_size)
    _lib.launches.reset()                   # the slice's serving path
    engine_phase("wide_group_engine", cfg, params, prompts, False, cut)
    engine_phase("wide_group_engine", cfg, params, prompts, True, cut)
    path = dict(_lib.launches)
    require(all(path[k] > 0 for k in SERVING_KERNELS),
            f"wide_group_engine: a kernel of its path never launched: {path}")
    require(path["decode_group"] == path["decode_attention"]
            + path["paged_decode_attention"],
            f"wide_group_engine: a decode launch left the group kernel's "
            f"route: {path}")
    profile_phase("profile_wide_group_dense_decode", cfg, params, prompts,
                  False)
    emit(dict(phase="wide_group_engine_path", launches=path,
              wall_s=time.monotonic() - t_phase))
    del params
    free_card()
    return path


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
    decode) bare (its own graph program) and bound to the program the
    hypervisor configured (``use_program``), in turns bare, program,
    program, bare of 10 steps each; and the host time of a graph program's
    binding of the parameter and cache trees alone (``graphs.binding``:
    the key a replay is looked up by), per call."""
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.core.graphs import binding
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
    args = (params, eng.caches, eng._tok, eng._posd, eng._bt)
    t0 = time.monotonic()
    for _ in range(100):
        binding(args, eng.device)
    bind_ms = (time.monotonic() - t0) * 1e3 / 100
    return dict(step_host_ms_bare=ms["bare"],
                step_host_ms_program=ms["program"],
                program_binding_host_ms=bind_ms)


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


# ---------------------------------------------------------------------------
# The design-space auto-tuner on the card
# ---------------------------------------------------------------------------

TUNER_ARCHS = ("smollm-135m", "gemma3-1b")
TUNER_SPEEDS = (1.0, 0.25)
TUNER_MAX_LEN = 2048
# the measure hook: the modeled top 4, each served MEASURE_REQS requests of
# MEASURE_PROMPT prompt tokens and MEASURE_NEW new tokens through
# ``step_async`` at its prefill chunk; MEASURE_ROUNDS rounds alternating
# the candidates, the median ms a token kept
MEASURE_TOP, MEASURE_ROUNDS = 4, 3
MEASURE_REQS, MEASURE_PROMPT, MEASURE_NEW = 8, 64, 16
# the autotuned fleet: tenants (slots) filling the first device of a 1.0 /
# 0.25 class pair; tenant c moves to the other class once its first request
# has AUTOTUNE_MIGRATE_AFTER tokens (mid-decode: an overlapped hand-off of a
# request still in chunked prefill adopts wrong pages in both packages,
# ROADMAP Queue 3)
AUTOTUNE_TENANTS = (("a", 2), ("b", 1), ("c", 1))
AUTOTUNE_REQS, AUTOTUNE_PROMPT, AUTOTUNE_NEW = 8, 96, 16
AUTOTUNE_MIGRATE_AFTER = 2


def autotune_card_line():
    """The registry's card against ``torch.cuda.get_device_properties``:
    the SM count must be equal and the memory within 3% (80 GiB declared;
    the card keeps some); the shared memory and registers are
    compared where this torch reports them."""
    from repro_torch.kernels import registry as kreg
    props = torch.cuda.get_device_properties(0)
    card = dict(sm_count=props.multi_processor_count,
                total_memory=props.total_memory)
    reg = dict(sm_count=kreg.SM_COUNT, total_memory=kreg.HBM_BYTES)
    for key, attr, want in (
            ("smem_per_block", "shared_memory_per_block_optin",
             kreg.SMEM_PER_BLOCK),
            ("smem_per_sm", "shared_memory_per_multiprocessor",
             kreg.SMEM_PER_SM),
            ("regs_per_sm", "regs_per_multiprocessor", kreg.REGS_PER_SM)):
        got = getattr(props, attr, None)
        card[key], reg[key] = got, want
        require(got is None or got == want,
                f"autotune: the card's {attr} {got} != the registry's {want}")
    require(card["sm_count"] == kreg.SM_COUNT,
            f"autotune: {card['sm_count']} SMs, the registry declares "
            f"{kreg.SM_COUNT}")
    require(abs(card["total_memory"] - kreg.HBM_BYTES)
            <= 0.03 * kreg.HBM_BYTES,
            f"autotune: card memory {card['total_memory']} bytes against "
            f"the registry's {kreg.HBM_BYTES}")
    fp = kreg.kernel_footprints()
    big = max(fp, key=fp.get)
    return dict(card=card, registry=reg, largest_smem_kernel=big,
                largest_smem_bytes=fp[big])


def measure_candidates(model, params, prompts, cands, paged):
    """Wall ms a generated token of each candidate through a
    ``BatchingEngine`` at its slots and page size, driven by ``step_async``
    at its prefill chunk: MEASURE_REQS requests to completion, in
    MEASURE_ROUNDS rounds alternating the candidates. Returns {candidate:
    [ms a token, a round]}."""
    from repro_torch.runtime import BatchingEngine
    out = {c: [] for c in cands}
    for _ in range(MEASURE_ROUNDS):
        for c in cands:
            eng = BatchingEngine(model, params, n_slots=c.n_slots,
                                 max_len=TUNER_MAX_LEN, paged=paged,
                                 page_size=c.page_size)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            reqs = [eng.submit(p[:MEASURE_PROMPT], max_new_tokens=MEASURE_NEW,
                               tenant=t) for p, t in prompts[:MEASURE_REQS]]
            for _ in range(100000):
                eng.step_async(prefill_chunk=c.prefill_chunk)
                if eng.idle():
                    break
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            n = sum(len(r.out_tokens) for r in reqs)
            require(n == MEASURE_NEW * len(reqs),
                    f"autotune measure {c.geometry_key()}: short streams")
            out[c].append(wall * 1e3 / n)
            del eng
    return out


def autotune_fleet(model, params, prompts, loop, autotune, top8=None):
    """``prompts`` through a paged ``GatewayFleet`` (max_len 2048; default
    geometry 8 slots, page 16) on two device classes (1.0 / 0.25), lockstep
    or under ``EventLoop``; tenant c is moved to the other class once its
    first request has AUTOTUNE_MIGRATE_AFTER tokens. Invariants checked
    every round. Returns (streams, hv, fleet, engine calls, the hand-off)."""
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.runtime import EventLoop, GatewayFleet
    calls = {"decode": 0, "prefill": 0}
    with engine_calls(calls, top8):
        hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=2,
                                    device_speeds=TUNER_SPEEDS), device=DEV)
        fleet = GatewayFleet(hv, model, params, n_slots=8,
                             max_len=TUNER_MAX_LEN, paged=True, page_size=16,
                             autotune=autotune)
        ev = EventLoop(fleet) if loop == "event" else None
        for t, slots in AUTOTUNE_TENANTS:
            fleet.open_session(t, slots=slots)
        reqs = [fleet.submit(AUTOTUNE_TENANTS[i % 3][0],
                             p[:AUTOTUNE_PROMPT], max_new_tokens=AUTOTUNE_NEW)
                for i, (p, _) in enumerate(prompts[:AUTOTUNE_REQS])]
        first_c, moved = reqs[2], False
        for _ in range(100000):
            if not moved and len(first_c.out_tokens) >= \
                    AUTOTUNE_MIGRATE_AFTER:
                moved = True
                src = fleet.device_of("c")
                dst = next(d for d in sorted(hv.db.devices) if d != src)
                require(hv.migrate_slice(fleet.session("c").slice_id,
                                         target_device=dst, reason="ops")
                        is not None, "autotune fleet: migration refused")
            fleet.step() if ev is None else ev.run_ticks(1)
            fleet.verify_invariants()
            if all(r.done.is_set() for r in reqs) and (
                    ev is None or not fleet._inflight_handoffs):
                break
        torch.cuda.synchronize()
    require(all(r.done.is_set() for r in reqs), "autotune fleet: not drained")
    require(sum(len(r.out_tokens) for r in reqs)
            == AUTOTUNE_NEW * len(reqs), "autotune fleet: short streams")
    for eng in fleet._engines.values():
        eng.pool.verify()
        require(eng.pool.used_pages == 0,
                f"autotune fleet: {eng.pool.used_pages} pages still held")
    handoff = fleet.handoffs[-1] if fleet.handoffs else None
    return [r.out_tokens for r in reqs], hv, fleet, calls, handoff


def autotune_phase(cfg, params, prompts):
    """The design-space auto-tuner (``repro_torch.tuning``) at full width:
    the registry's card against the card's properties; ``tune``'s results
    for the pinned archs, classes and layouts; the measure hook on the
    card (the modeled top 4 of smollm-135m, class 1.0, dense and paged,
    timed as wall ms a token, modeled rank beside measured rank, and
    ``tune(..., measure=...)``'s winner); an autotuned two-class paged
    fleet, lockstep and under the event loop, against the default-geometry
    fleet (near-ties counted), each class bound to its winner, the cross-
    class hand-off declining the source's pages (page sizes differ) and
    replaying, and every launch accounted for. Returns the launches of the
    autotuned fleets' runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import Model
    from repro_torch.tuning import (cost_model, device_class,
                                    profile_for_speed, tune)
    t_phase = time.monotonic()
    emit(dict(phase="autotune_registry", **autotune_card_line()))

    tunes = []
    for arch in TUNER_ARCHS:
        acfg = get_config(arch)
        for speed in TUNER_SPEEDS:
            for paged in (False, True):
                rep = tune(acfg, profile_for_speed(speed),
                           max_len=TUNER_MAX_LEN, paged=paged)
                tunes.append(dict(
                    arch=arch, device_class=device_class(speed),
                    paged=paged, winner=rep.best.geometry_key(),
                    win=rep.win, candidates=rep.n_candidates,
                    pruned=rep.n_pruned, census=rep.prune_census,
                    modeled_us_per_token=rep.best_cost.us_per_token,
                    default_us_per_token=rep.default_cost.us_per_token,
                    terms=rep.best_cost.terms))
    emit(dict(phase="autotune_tune", max_len=TUNER_MAX_LEN, tunes=tunes,
              launch_host_s=cost_model.LAUNCH_HOST_S))

    model = Model(cfg, device=DEV)
    prof = profile_for_speed(1.0)
    for paged in (False, True):
        rep = tune(cfg, prof, max_len=TUNER_MAX_LEN, paged=paged,
                   top_k=MEASURE_TOP)
        cands = [c for c, _ in rep.table]
        ms = measure_candidates(model, params, prompts, cands, paged)
        med = {c: float(np.median(v)) for c, v in ms.items()}
        won = tune(cfg, prof, max_len=TUNER_MAX_LEN, paged=paged,
                   top_k=MEASURE_TOP, measure=med.__getitem__).best
        emit(dict(phase="autotune_measure", arch=cfg.name, dtype=cfg.dtype,
                  device_class=device_class(1.0), paged=paged,
                  requests=MEASURE_REQS, prompt=MEASURE_PROMPT,
                  new_tokens=MEASURE_NEW, rounds=MEASURE_ROUNDS,
                  modeled_rank=[c.geometry_key() for c in cands],
                  modeled_us_per_token=[k.us_per_token for _, k in rep.table],
                  measured_rank=[c.geometry_key()
                                 for c in sorted(cands, key=med.get)],
                  measured_ms_per_token={c.geometry_key(): ms[c]
                                         for c in cands},
                  modeled_winner=rep.best.geometry_key(),
                  measured_winner=won.geometry_key()))

    got_all = {k: 0 for k in _lib.launches}
    for loop in ("lockstep", "event"):
        top8 = {}
        base, _, bfleet, bcalls, _ = autotune_fleet(
            model, params, prompts, loop, False, top8=top8)
        bfleet.close()
        _lib.launches.reset()               # the autotuned fleet's path
        auto, hv, fleet, calls, handoff = autotune_fleet(
            model, params, prompts, loop, True)
        got = dict(_lib.launches)
        configures = sum(1 for e in hv.log if e["kind"] in ("fleet_up",
                                                             "engine_up")
                         and not e["cache_hit"])
        need = program_launches(f"autotune_{loop}", cfg, calls, configures,
                                True, got)
        binds = {e["device_class"]: e for e in hv.log
                 if e["kind"] == "autotune_bind"}
        winners = {device_class(s): tune(cfg, profile_for_speed(s),
                                         max_len=TUNER_MAX_LEN,
                                         paged=True).best
                   for s in TUNER_SPEEDS}
        require(sorted(binds) == sorted(winners) and all(
            binds[c]["geometry"] == w.geometry_key()
            for c, w in winners.items()),
            f"autotune {loop}: bound {binds}, winners {winners}")
        for dev, eng in fleet._engines.items():
            w = winners[device_class(hv.db.devices[dev].speed)]
            require((eng.n_slots, eng.page_size) == (w.n_slots, w.page_size)
                    and fleet.prefill_chunk_for(dev, 4)
                    == w.prefill_chunk,
                    f"autotune {loop}: {dev} runs ({eng.n_slots}, "
                    f"{eng.page_size}), its class's winner {w}")
        require(handoff is not None and handoff["page_copied"] == 0,
                f"autotune {loop}: the cross-class hand-off {handoff}")
        if loop == "lockstep":
            require(handoff["replayed_inflight"] == 1
                    and handoff["src_geometry"] != handoff["dst_geometry"],
                    f"autotune lockstep: the hand-off {handoff}")
        fleet.close()
        streams = compare_streams(auto, base, top8, TOL[torch.bfloat16])
        for k in got_all:
            got_all[k] += got[k]
        emit(dict(phase=f"autotune_fleet_{loop}", arch=cfg.name,
                  dtype=cfg.dtype, classes=list(TUNER_SPEEDS),
                  tenants=dict(AUTOTUNE_TENANTS), bound={
                      c: b["geometry"] for c, b in binds.items()},
                  launches=got, launches_needed=need, engine_calls=calls,
                  default_engine_calls=bcalls, configures=configures,
                  handoff=handoff, **streams))
    emit(dict(phase="autotune", wall_s=time.monotonic() - t_phase))
    return got_all


def whisper_engine_phase(get_config):
    """whisper-tiny (full width and depth, fp32) through the dense
    ``BatchingEngine`` on the kernel path and on the plain path: the two
    prompts' token logs must be equal (contexts under PREFILL_MIN_TOKENS
    run through the decode step; the cross K/V is the engine's empty
    cache, as the reference's engine has no encoder input), decode once a
    decoder layer a step; and a context of PREFILL_MIN_TOKENS or more
    fails as the reference's engine does (KeyError 'frames'). Returns the
    kernel path's launches."""
    from repro_torch.kernels import launches
    from repro_torch.models import Model
    from repro_torch.runtime import BatchingEngine
    cfg = get_config("whisper-tiny").replace(dtype="float32")
    params = seeded_params(Model(cfg, device=DEV), SEED + 41)
    prompts = ([3, 5, 7, 9], [11, 2])
    runs = {}
    for tag, c in (("kernel", cfg), ("plain", plain_cfg(cfg))):
        calls, top8 = {"decode": 0, "prefill": 0}, {}
        before = dict(launches)
        eng = BatchingEngine(Model(c, device=DEV), params, n_slots=2,
                             max_len=cfg.encoder.max_frames)
        with engine_calls(calls, top8):
            reqs = [eng.submit(p, max_new_tokens=WHISPER_ENGINE_NEW)
                    for p in prompts]
            require(eng.run_until_idle(), f"whisper_engine {tag}: not idle")
        runs[tag] = ([r.out_tokens for r in reqs], top8, calls,
                     {k: launches[k] - before[k] for k in launches})
    kern, _, kcalls, got = runs["kernel"]
    plain, top8, _, plain_got = runs["plain"]
    require(not any(plain_got.values()),
            f"whisper_engine: the plain path launched {plain_got}")
    need = {k: 0 for k in launches}
    need["decode_attention"] = cfg.n_layers * kcalls["decode"]
    require(got == need, f"whisper_engine: launches {got} != {need}")
    streams = compare_streams(kern, plain, top8, TOL[torch.float32])
    require(streams["streams_equal"],
            f"whisper_engine: kernel logs {kern} != plain logs {plain}")
    eng = BatchingEngine(Model(cfg, device=DEV), params, n_slots=2,
                         max_len=cfg.encoder.max_frames)
    eng.submit(list(range(1, BatchingEngine.PREFILL_MIN_TOKENS + 2)),
               max_new_tokens=2)
    err = None
    try:
        eng.step()
    except KeyError as e:
        err = e.args
    require(err == ("frames",),
            f"whisper_engine: a long context raised {err}, not "
            "KeyError('frames')")
    emit(dict(phase="whisper_engine", arch=cfg.name, dtype=cfg.dtype,
              layers=cfg.n_layers, prompts=[list(p) for p in prompts],
              logs=kern, launches=got, launches_needed=need,
              long_context_error="KeyError('frames')", **streams))
    del params
    return got


# ---------------------------------------------------------------------------
# Training (repro_torch.launch.train, runtime.train): no kernel launches
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARM = 8, 1024, 30, 3
TRAIN_PROFILE_STEP = 5          # the launcher's step traced by the profiler
TRAIN_GRAPH_STEPS = 3           # train_graph_replay: steps a variant
TRAIN_PARITY = dict(layers=2, B=2, S=256)
TRAIN_RESTART = dict(layers=4, B=4, S=256, steps=6)
TRAIN_FAMILIES = (("qwen3-moe-30b-a3b", 2, 2, 256),   # arch, layers, B, S
                  ("mamba2-370m", 4, 2, 256),
                  ("whisper-tiny", 0, 2, 0))          # 0: full depth / S
TRAIN_FAMILY_STEPS = 3
TRAIN_DP = dict(layers=4, B=8, S=256, steps=5)
TRAIN_LR = dict(lr=1e-3, warmup_steps=10)             # the launcher's


def _mem_reset():
    torch.cuda.synchronize()
    free_card()
    torch.cuda.reset_peak_memory_stats()


def _mem_peak():
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _no_launch(phase, before):
    from repro_torch.kernels import launches
    got = {k: launches[k] - before[k] for k in launches}
    require(not any(got.values()),
            f"{phase}: training launched kernels {got} (no kernel defines a "
            "backward; training takes the plain paths)")
    return got


def _train_setup(cfg, B, S, seed, **opts_kw):
    """Model (fp32 activations, as the launcher sets them), TrainOpts (the
    launcher's schedule, loss chunk 64), a seeded state on the card with
    SSM gate norms and MLA kv_norm at 1, and a batch of the synthetic
    pipeline (patches or frames seeded too)."""
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import TrainOpts, init_train_state
    cfg = cfg.replace(dtype="float32")
    model = get_model(cfg, device=DEV)
    opts = TrainOpts(opt=AdamWConfig(total_steps=TRAIN_STEPS, **TRAIN_LR),
                     loss_chunk=64, **opts_kw)
    state = init_train_state(
        model, torch.Generator(device=DEV).manual_seed(seed), opts)
    norms_to_one(state["params"])
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    if cfg.family == "audio":
        data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=64, batch_size=B, seed=seed))
        batch = {k: torch.from_numpy(v).to(DEV)
                 for k, v in data.batch_at(0).items()}
        batch["frames"] = torch.randn((B, S, cfg.d_model), generator=gen,
                                      device=DEV)
        return model, opts, state, batch
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=S - cfg.n_patches, batch_size=B,
                                   seed=seed))
    return model, opts, state, {k: torch.from_numpy(v).to(DEV)
                                for k, v in data.batch_at(0).items()}


def _tree_cpu(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().cpu(), tree)


def _leaves(tree):
    from repro_torch.tree import flatten
    return flatten(tree)[0]


def _diff_leaves(a, b):
    """Indices of the leaves of two state trees that are not bit-equal."""
    return [i for i, (x, y) in enumerate(zip(_leaves(a), _leaves(b)))
            if not torch.equal(x, y)]


def _graph_record(phase, program, steps, binds=1):
    """A program's graph counts and costs (a training program, a mesh
    step); on the card every call after a binding's first must be a replay
    (``binds`` bindings, one capture each, ``steps`` calls in all)."""
    g = getattr(program, "graphs", None)
    if g is None:                       # DEV = "cpu": the step runs eagerly
        require(DEV == "cpu", f"{phase}: the step on the card is not a "
                "graph program")
        return dict(captures=0, replays=0)
    c = g.counts()
    require(c["captures"] == binds and c["replays"] == steps - binds,
            f"{phase}: {c['captures']} captures and {c['replays']} replays "
            f"for {steps} calls over {binds} bindings (one capture a "
            "binding, then replays)")
    return dict(captures=c["captures"], replays=c["replays"],
                capture_ms=list(g.capture_ms),
                graph_mb=[b / 2**20 for b in g.graph_bytes])


def _close(program):
    g = getattr(program, "graphs", None)
    if g is not None:
        g.close()


def _timed_steps(step, state, batches, kept=None):
    """Run ``step`` over ``batches`` from ``state``, each call between two
    synchronisations; returns (state, metrics of each step as floats, ms of
    each step). The state's leaves must keep their addresses (an in-place
    step); ``kept`` collects each step's metric tensors."""
    ptrs = [t.data_ptr() for t in _leaves(state)]
    metrics, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if kept is not None:
            kept.append(m)
    require([t.data_ptr() for t in _leaves(state)] == ptrs,
            "an in-place training step moved a state leaf")
    return state, metrics, ms


def train_smollm_phase(get_config):
    """``repro_torch.launch.train.main`` on full-width, full-depth
    smollm-135m (B 8, S 1024, 30 steps, warmup 10, fp32), whose steps run
    through its ``train_program``: the losses finite and the last below
    the first, each returned loss the one its step computed (read right
    after the step), the state at its addresses, one capture then replays,
    no kernel launched; step ms p50/p95 after 3 warm-up steps (each step
    synchronised), the first step's ms (its eager run and the capture),
    tokens/s, the peak memory, the capture's ms and graph MB, and one
    step traced by the profiler (device busy ms, idle share against the
    unprofiled p50, ops, top-5 device ops)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import launches
    from repro_torch.launch import train as launch_train
    t_phase = time.monotonic()
    cfg = get_config("smollm-135m")
    times, traced, seen, moved, made = [], {}, [], [], []
    real = launch_train.train_program

    def timed_factory(model, opts):
        program = real(model, opts)
        made.append(program)

        def timed(state, batch):
            ptrs = [t.data_ptr() for t in _leaves(state)]
            if len(times) == TRAIN_PROFILE_STEP and not traced:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.monotonic()
                    out = program(state, batch)
                    torch.cuda.synchronize()
                traced["wall_ms"] = (time.monotonic() - t0) * 1e3
                traced["prof"] = prof
            else:
                torch.cuda.synchronize()
                t0 = time.monotonic()
                out = program(state, batch)
                torch.cuda.synchronize()
                times.append(time.monotonic() - t0)
            seen.append(float(out[1]["loss"]))
            if [t.data_ptr() for t in _leaves(out[0])] != ptrs:
                moved.append(len(seen))
            return out

        return timed

    before = dict(launches)
    _mem_reset()
    launch_train.train_program = timed_factory
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            losses = launch_train.main(
                ["--arch", cfg.name, "--steps", str(TRAIN_STEPS),
                 "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
                 "--device", DEV])
    finally:
        launch_train.train_program = real
    peak = _mem_peak()
    got = _no_launch("train_smollm", before)
    require(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
            f"train_smollm: losses {losses}")
    require(losses[-1] < losses[0],
            f"train_smollm: the loss did not fall: {losses[0]} -> "
            f"{losses[-1]}")
    require(losses == seen, f"train_smollm: the launcher returned {losses}, "
            f"its steps computed {seen} (aliased metrics)")
    require(not moved, f"train_smollm: the state moved at steps {moved}")
    graphs = _graph_record("train_smollm", made[0], TRAIN_STEPS)
    _close(made[0])
    steady = np.array(times[TRAIN_WARM:]) * 1e3
    p50 = float(np.percentile(steady, 50))
    dev = [e for e in traced["prof"].key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    emit(dict(phase="train_smollm", arch=cfg.name, layers=cfg.n_layers,
              dtype="float32", batch=TRAIN_B, seq=TRAIN_S,
              steps=TRAIN_STEPS, losses=losses,
              step_ms_p50=p50, step_ms_p95=float(np.percentile(steady, 95)),
              step_ms_first=times[0] * 1e3,
              tokens_per_s=TRAIN_B * TRAIN_S / (p50 / 1e3),
              profiled_step_wall_ms=traced["wall_ms"],
              device_busy_ms_per_step=busy,
              device_idle_share=1.0 - busy / p50 if busy else None,
              device_ops_per_step=sum(e.count for e in dev),
              top_device_ops_ms={e.key[:80]: e.self_device_time_total / 1e3
                                 for e in top},
              peak_memory_bytes=peak, launches=got, **graphs,
              launcher_lines=printed.getvalue().splitlines()[-4:],
              wall_s=time.monotonic() - t_phase))
    return got


def train_graph_replay_phase(get_config):
    """Full-width, full-depth smollm-135m, fp32, B 8, S 1024, TF32 off,
    under deterministic algorithms: plain, remat and 2 microbatches, each
    ``TRAIN_GRAPH_STEPS`` steps through ``train_program`` against as many
    eager in-place steps from the same state on the same batches (numpy,
    staged through the program's pinned buffers): every step's metrics and
    every state leaf bit-equal, the state at its addresses, one capture
    then replays; remat's and the microbatches' first loss within 1e-5
    relative of the plain one and grad_norm within 1e-4; the capture's ms
    and graph MB, each run's step ms and peak memory."""
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import launches
    from repro_torch.runtime.train import (make_inplace_train_step,
                                           train_program)
    t_phase = time.monotonic()
    cfg = get_config("smollm-135m")
    model, opts, state, _ = _train_setup(cfg, TRAIN_B, TRAIN_S, SEED + 50)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_S, batch_size=TRAIN_B))
    batches = [data.batch_at(i) for i in range(TRAIN_GRAPH_STEPS)]
    before = dict(launches)
    rec = {}
    torch.use_deterministic_algorithms(True)
    try:
        for tag, kw in (("plain", {}), ("remat", {"remat": True}),
                        ("microbatches2", {"microbatches": 2})):
            o = dataclasses.replace(opts, **kw)
            _mem_reset()
            eager_state, eager, eager_ms = _timed_steps(
                make_inplace_train_step(model, o), _clone_tree(state),
                batches)
            eager_peak = _mem_peak()
            _mem_reset()
            program = train_program(model, o)
            kept = []
            graph_state, graph, graph_ms = _timed_steps(
                program, _clone_tree(state), batches, kept)
            graph_peak = _mem_peak()
            require(graph == eager, f"train_graph_replay {tag}: the "
                    f"program's metrics {graph} vs the eager step's {eager}")
            require(len({id(m["loss"]) for m in kept}) == len(kept),
                    f"train_graph_replay {tag}: metrics of two calls are "
                    "one tensor")
            diff = _diff_leaves(graph_state, eager_state)
            require(not diff, f"train_graph_replay {tag}: leaves {diff} "
                    "differ from the eager steps'")
            rec[tag] = dict(metrics=graph, eager_ms=eager_ms,
                            graph_ms=graph_ms,
                            eager_peak_memory_bytes=eager_peak,
                            graph_peak_memory_bytes=graph_peak,
                            bitequal_leaves=len(_leaves(graph_state)),
                            **_graph_record(f"train_graph_replay {tag}",
                                            program, TRAIN_GRAPH_STEPS))
            _close(program)
            del program, eager_state, graph_state, kept
    finally:
        torch.use_deterministic_algorithms(False)
    got = _no_launch("train_graph_replay", before)
    p = rec["plain"]["metrics"][0]
    for tag in ("remat", "microbatches2"):
        r = rec[tag]["metrics"][0]
        require(abs(r["loss"] - p["loss"]) <= 1e-5 * abs(p["loss"]),
                f"train_graph_replay: {tag} loss {r['loss']} vs "
                f"{p['loss']}")
        require(abs(r["grad_norm"] - p["grad_norm"])
                <= 1e-4 * abs(p["grad_norm"]),
                f"train_graph_replay: {tag} grad_norm {r['grad_norm']} vs "
                f"{p['grad_norm']}")
    emit(dict(phase="train_graph_replay", arch=cfg.name, layers=cfg.n_layers,
              dtype="float32", batch=TRAIN_B, seq=TRAIN_S,
              steps=TRAIN_GRAPH_STEPS, deterministic=True, tolerance="bit",
              runs=rec,
              remat_peak_memory_ratio=rec["remat"]["eager_peak_memory_bytes"]
              / rec["plain"]["eager_peak_memory_bytes"],
              launches=got, wall_s=time.monotonic() - t_phase))
    del state
    return got


def train_device_parity_phase(get_config):
    """Full-width smollm cut to 2 layers, B 2, S 256: the loss and every
    gradient leaf of one step on the card against the CPU from the same
    state (loss within 1e-5 relative; each leaf's max |card - cpu| within
    1e-3 of the CPU leaf's max |g|)."""
    from repro_torch.kernels import launches
    from repro_torch.models import get_model
    from repro_torch.runtime.train import _value_and_grad, make_loss_fn
    from repro_torch.tree import flatten
    t_phase = time.monotonic()
    p = TRAIN_PARITY
    cfg = get_config("smollm-135m").replace(n_layers=p["layers"])
    model, opts, state, batch = _train_setup(cfg, p["B"], p["S"], SEED + 51)
    before = dict(launches)
    loss, _, grads = _value_and_grad(make_loss_fn(model, opts),
                                     state["params"], batch)
    got = _no_launch("train_device_parity", before)
    cpu_model = get_model(model.cfg, device="cpu")
    closs, _, cgrads = _value_and_grad(make_loss_fn(cpu_model, opts),
                                       _tree_cpu(state["params"]),
                                       _tree_cpu(batch))
    rel = abs(float(loss) - float(closs)) / abs(float(closs))
    require(rel <= 1e-5, f"train_device_parity: loss {float(loss)} vs the "
            f"CPU's {float(closs)}")
    errs = []
    for i, (g, c) in enumerate(zip(flatten(grads)[0], flatten(cgrads)[0])):
        scale = float(c.abs().max())
        err = float((g.cpu() - c).abs().max())
        errs.append(dict(leaf=i, shape=list(c.shape), max_abs_err=err,
                         max_abs_grad=scale))
        require(err <= 1e-3 * scale,
                f"train_device_parity: leaf {i} {tuple(c.shape)} off by "
                f"{err} (max |g| {scale})")
    emit(dict(phase="train_device_parity", arch=cfg.name, layers=cfg.n_layers,
              batch=p["B"], seq=p["S"], loss=float(loss),
              cpu_loss=float(closs), loss_rel_err=rel, grad_errs=errs,
              launches=got, wall_s=time.monotonic() - t_phase))
    return got


def train_restart_phase(get_config):
    """Full width, 4 layers, B 4, S 256, under deterministic algorithms,
    through ``train_program``: 6 steps straight against 3 + ``save`` +
    ``restore`` + 3, and against 6 eager in-place steps; the three states
    bit for bit equal; three bindings (the straight state, the saved one,
    the restored one), each captured once and replayed after."""
    from repro_torch.ckpt import restore, save
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import launches
    from repro_torch.runtime.train import (make_inplace_train_step,
                                           train_program)
    t_phase = time.monotonic()
    p = TRAIN_RESTART
    cfg = get_config("smollm-135m").replace(n_layers=p["layers"])
    model, opts, state, _ = _train_setup(cfg, p["B"], p["S"], SEED + 52)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=p["S"], batch_size=p["B"]))
    ckpt = OUT / "train_restart_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    before = dict(launches)
    half = p["steps"] // 2
    torch.use_deterministic_algorithms(True)
    try:
        program = train_program(model, opts)
        sa = _clone_tree(state)
        for i in range(p["steps"]):
            sa, _ = program(sa, data.batch_at(i))
        se, eager = _clone_tree(state), make_inplace_train_step(model, opts)
        for i in range(p["steps"]):
            se, _ = eager(se, data.batch_at(i))
        sb = _clone_tree(state)
        for i in range(half):
            sb, _ = program(sb, data.batch_at(i))
        save(sb, str(ckpt), step=half)
        del sb
        sb, at = restore(str(ckpt), state)
        for i in range(at, p["steps"]):
            sb, _ = program(sb, data.batch_at(i))
    finally:
        torch.use_deterministic_algorithms(False)
    got = _no_launch("train_restart", before)
    graphs = _graph_record("train_restart", program, 2 * p["steps"], binds=3)
    _close(program)
    diff = _diff_leaves(sa, sb)
    eager_diff = _diff_leaves(sa, se)
    shutil.rmtree(ckpt, ignore_errors=True)      # the output dir stays small
    require(not diff, f"train_restart: leaves {diff} differ after the "
            "restart")
    require(not eager_diff, f"train_restart: leaves {eager_diff} of the "
            "program's state differ from the eager steps'")
    emit(dict(phase="train_restart", arch=cfg.name, layers=cfg.n_layers,
              batch=p["B"], seq=p["S"], steps=p["steps"], restored_at=at,
              leaves=len(_leaves(sa)), bitexact=True, eager_bitexact=True,
              launches=got, **graphs, wall_s=time.monotonic() - t_phase))
    return got


def train_families_phase(get_config):
    """Norms at 1: qwen3-moe full width cut to 2 layers, mamba2-370m full
    width cut to 4, whisper-tiny in full. One gradient pass: the loss
    finite, the MoE aux > 0, every gradient leaf finite and nonzero (as
    every leaf is in the CPU parity tests at these norms). Then, under
    deterministic algorithms, ``TRAIN_FAMILY_STEPS`` steps through
    ``train_program`` against as many eager in-place steps from the same
    state on the same batch: metrics and every state leaf bit-equal, one
    capture then replays; no kernel launched (no ``ssd_chunk_scan``: the
    SSM trains on ``ssd_scan``); loss, aux, the ms of each step of both,
    the capture's ms and graph MB."""
    from repro_torch.kernels import launches
    from repro_torch.runtime.train import (_value_and_grad, make_loss_fn,
                                           make_inplace_train_step,
                                           train_program)
    t_phase = time.monotonic()
    total = {k: 0 for k in launches}
    for arch, layers, B, S in TRAIN_FAMILIES:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(n_layers=layers)
        S = S or cfg.encoder.max_frames
        model, opts, state, batch = _train_setup(cfg, B, S, SEED + 53)
        before = dict(launches)
        loss, m, grads = _value_and_grad(make_loss_fn(model, opts),
                                         state["params"], batch)
        bad = [i for i, g in enumerate(_leaves(grads))
               if not bool(torch.isfinite(g).all()) or
               float(g.abs().max()) == 0.0]
        del grads
        require(not bad, f"train_families {arch}: gradient leaves {bad} "
                "zero or not finite")
        require(np.isfinite(float(loss)), f"train_families {arch}: loss "
                f"{float(loss)}")
        if cfg.moe is not None:
            require(float(m["aux"]) > 0, f"train_families {arch}: aux "
                    f"{float(m['aux'])}")
        batches = [batch] * TRAIN_FAMILY_STEPS
        torch.use_deterministic_algorithms(True)
        try:
            eager_state, eager, eager_ms = _timed_steps(
                make_inplace_train_step(model, opts), _clone_tree(state),
                batches)
            program = train_program(model, opts)
            graph_state, graph, graph_ms = _timed_steps(
                program, state, batches)
        finally:
            torch.use_deterministic_algorithms(False)
        require(graph == eager, f"train_families {arch}: the program's "
                f"metrics {graph} vs the eager step's {eager}")
        diff = _diff_leaves(graph_state, eager_state)
        require(not diff, f"train_families {arch}: leaves {diff} differ "
                "from the eager steps'")
        graphs = _graph_record(f"train_families {arch}", program,
                               TRAIN_FAMILY_STEPS)
        _close(program)
        got = _no_launch(f"train_families {arch}", before)
        total = {k: total[k] + got[k] for k in total}
        emit(dict(phase="train_families", arch=arch, layers=cfg.n_layers,
                  batch=B, seq=S, loss=float(loss), aux=float(m["aux"]),
                  metrics=graph, loss_step2=graph[1]["loss"],
                  eager_step_ms=eager_ms, graph_step_ms=graph_ms,
                  step_ms=graph_ms[-1], bitequal=True,
                  params=sum(t.numel() for t in _leaves(state["params"])),
                  launches=got, **graphs))
        del state, batch, model, program, eager_state, graph_state
        free_card()
    emit(dict(phase="train_families", wall_s=time.monotonic() - t_phase))
    return total


def train_dp_nccl_phase(get_config):
    """On an NCCL world of 1 (``file://`` rendezvous), full width, 4
    layers, B 8, S 256, 5 steps compressed (int8 all-gather with error
    feedback) and not, under deterministic algorithms: ``dp_train_program``
    (its collectives captured with the step) against as many eager steps
    of ``make_inplace_dp_train_step`` from the same state: metrics and
    every state leaf (the residuals too) bit-equal, one capture then
    replays; the loss falls in both, the compressed run's last loss within
    0.25 x the first of the uncompressed; ms a step of each."""
    import torch.distributed as dist
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import launches
    from repro_torch.runtime.train import (dp_train_program,
                                           make_inplace_dp_train_step)
    t_phase = time.monotonic()
    p = TRAIN_DP
    cfg = get_config("smollm-135m").replace(n_layers=p["layers"])
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=p["S"], batch_size=p["B"]))
    batches = [data.batch_at(i) for i in range(p["steps"])]
    rdv = OUT / "nccl_rendezvous"
    if rdv.exists():
        rdv.unlink()
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            init_method=f"file://{rdv}", world_size=1,
                            rank=0)
    before = dict(launches)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for tag, compress in (("uncompressed", False), ("compressed", True)):
            model, opts, state, _ = _train_setup(
                cfg, p["B"], p["S"], SEED + 54, compress_grads=compress)
            eager_state, eager, eager_ms = _timed_steps(
                make_inplace_dp_train_step(model, None, opts),
                _clone_tree(state), batches)
            program = dp_train_program(model, None, opts)
            graph_state, graph, graph_ms = _timed_steps(program, state,
                                                        batches)
            require(graph == eager, f"train_dp_nccl {tag}: the program's "
                    f"metrics {graph} vs the eager step's {eager}")
            diff = _diff_leaves(graph_state, eager_state)
            require(not diff, f"train_dp_nccl {tag}: leaves {diff} differ "
                    "from the eager steps'")
            losses = [m["loss"] for m in graph]
            runs[tag] = dict(losses=losses, step_ms=graph_ms,
                             step_ms_median=float(np.median(graph_ms[1:])),
                             eager_step_ms=eager_ms,
                             eager_step_ms_median=float(
                                 np.median(eager_ms[1:])),
                             bitequal=True,
                             **_graph_record(f"train_dp_nccl {tag}", program,
                                             p["steps"]))
            _close(program)
            del state, program, eager_state, graph_state
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    got = _no_launch("train_dp_nccl", before)
    lu, lc = runs["uncompressed"]["losses"], runs["compressed"]["losses"]
    require(lu[-1] < lu[0] and lc[-1] < lc[0],
            f"train_dp_nccl: the loss did not fall: {lu} / {lc}")
    require(abs(lc[-1] - lu[-1]) < 0.25 * lu[0],
            f"train_dp_nccl: compressed {lc[-1]} vs uncompressed {lu[-1]}")
    emit(dict(phase="train_dp_nccl", arch=cfg.name, layers=cfg.n_layers,
              batch=p["B"], seq=p["S"], world=1, runs=runs, launches=got,
              wall_s=time.monotonic() - t_phase))
    return got


def training_phases(get_config):
    """Every training phase; returns the launches they made (all 0)."""
    t0 = time.monotonic()
    total = {}
    for fn in (train_smollm_phase, train_graph_replay_phase,
               train_device_parity_phase, train_restart_phase,
               train_families_phase, train_dp_nccl_phase):
        got = fn(get_config)
        total = {k: total.get(k, 0) + v for k, v in got.items()}
        free_card()
    emit(dict(phase="training", launches=total,
              wall_s=time.monotonic() - t0))
    return total


# ---------------------------------------------------------------------------
# The mesh slice: jit_serve_step / jit_train_step on a one-rank NCCL mesh,
# the checkpoint restored by placements, the dry run against the card
# ---------------------------------------------------------------------------

MESH_SERVE = dict(B=8, prompt=64, new=32)
MESH_TRAIN = dict(B=8, S=1024, steps=3)


def _clone_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


def _card_bytes(make):
    """``make()``'s tensors' bytes on the card: memory_allocated after it
    (the caller drops what it does not keep) minus before."""
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated()
    kept = make()
    gc.collect()
    torch.cuda.synchronize()
    return kept, torch.cuda.memory_allocated() - base


def _flops_of(fn):
    from torch.utils.flop_counter import FlopCounterMode
    fc = FlopCounterMode(display=False)
    with fc:
        out = fn()
    return out, float(fc.get_total_flops())


def _busy_ms(call, n):
    """The device's busy ms a call over ``n`` calls of ``call`` under the
    profiler (None off the card)."""
    if DEV == "cpu":
        return None
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in dev) / 1e3 / n


def _direct(step):
    """The eager step a mesh program captures (the program's direct call);
    off the card the mesh step is that step."""
    return getattr(step, "step", step)


def _timed_mesh_train(step, state, data, steps):
    """Wall ms of ``steps`` calls of a mesh train step from ``state`` on
    the pipeline's first batches, each between two synchronisations."""
    ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, _ = step(state, data.batch_at(i))
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
    return ms


def _mesh_train_records(step, state, data, mesh_ms, plain_ms):
    """A mesh train phase's times: the program's replay p50 (its calls
    after the first), the direct eager call's p50 over 2 calls on a clone
    of the state, the plain step's p50, and one replay's busy ms under the
    profiler (the state put back after it) with the idle share against
    the replay p50."""
    replay = float(np.percentile(mesh_ms[1:], 50))
    direct = _timed_mesh_train(_direct(step), _clone_tree(state), data, 2)
    saved = _clone_tree(state)
    busy = _busy_ms(lambda: step(state, data.batch_at(0)), 1)
    with torch.no_grad():
        for a, b in zip(_leaves(state), _leaves(saved)):
            a.copy_(b)
    del saved
    plain = float(np.percentile(plain_ms[1:], 50))
    return dict(mesh_step_ms_p50=replay,
                mesh_direct_ms_p50=float(np.percentile(direct, 50)),
                plain_step_ms_p50=plain,
                dtensor_host_ms=float(np.percentile(direct, 50)) - plain,
                replay_minus_plain_ms=replay - plain,
                device_busy_ms=busy,
                idle_share=None if busy is None else 1.0 - busy / replay)


def mesh_serve_phase(get_config, mesh, card):
    """Full smollm-135m, bf16: 8 prompts of 64 tokens prefilled through
    ``make_prefill_step``, then 32 decode steps through ``jit_serve_step``
    on the one-rank mesh and through ``make_serve_step`` from a copy of the
    same caches: the tokens bitwise equal, decode_attention launched 30 x
    32 times by the mesh path (counts zeroed just before it), one capture
    and 31 replays of the mesh program; step p50 of the program's
    replays, of its direct eager call (8 steps on a copy of the caches)
    and of the plain step, capture ms, graph MB, and 5 replays' busy ms
    under the profiler (idle share against the replay p50)."""
    from repro_torch.kernels import _lib
    from repro_torch.models import get_model
    from repro_torch.runtime import (jit_serve_step, make_prefill_step,
                                     make_serve_step)
    from repro_torch.runtime.sharding import place
    t_phase = time.monotonic()
    p = MESH_SERVE
    cfg = get_config("smollm-135m")
    model = get_model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED + 60))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 61)
    prompts = torch.randint(0, cfg.vocab_size, (p["B"], p["prompt"]),
                            generator=gen, device=DEV, dtype=torch.int32)
    max_len = p["prompt"] + p["new"]
    h, caches = make_prefill_step(model, max_len)(params,
                                                  {"tokens": prompts})
    first = model.logits(params, h[:, -1:]).argmax(-1).to(torch.int32)
    mstep, specs = jit_serve_step(model, mesh, p["B"], max_len, params,
                                  caches)

    mparams = place(params, mesh, specs["params"])
    mcaches = place(_clone_tree(caches), mesh, specs["caches"])
    # the placed params and caches alone, made afresh (a one-rank mesh
    # places a tensor without copying it)
    _, arg_bytes = _card_bytes(lambda: (
        place(model.init(torch.Generator(device=DEV).manual_seed(SEED + 60)),
              mesh, specs["params"]),
        place(model.make_caches(p["B"], max_len), mesh, specs["caches"])))
    plain = make_serve_step(model)

    def decode(step, prm, cch, mesh_path, n=p["new"]):
        tok, pos = first.clone(), torch.full((p["B"],), p["prompt"],
                                             dtype=torch.int32, device=DEV)
        toks, times = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            logits, cch = step(prm, cch, tok, pos)
            if mesh_path:
                logits = logits.to_local()
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
            toks.append(tok[:, 0].cpu())
            pos = pos + 1
        return torch.stack(toks, 1), times

    want, plain_ms = decode(plain, params, _clone_tree(caches), False)
    _lib.launches.reset()                  # the mesh serving path
    got, mesh_ms = decode(mstep, mparams, mcaches, True)
    launched = dict(_lib.launches)
    require(torch.equal(got, want),
            "mesh_serve: jit_serve_step's tokens differ from "
            "make_serve_step's")
    need = cfg.n_layers * p["new"]
    require(launched["decode_attention"] == need,
            f"mesh_serve: decode_attention launched "
            f"{launched['decode_attention']} times, the path needs {need}")
    graph = _graph_record("mesh_serve", mstep, p["new"])
    _, direct_ms = decode(_direct(mstep), mparams, _clone_tree(mcaches),
                          True, n=8)
    last = torch.full((p["B"],), max_len - 1, dtype=torch.int32, device=DEV)
    busy = _busy_ms(lambda: mstep(mparams, mcaches, first, last), 5)
    replay = float(np.percentile(mesh_ms[1:], 50))
    direct = float(np.percentile(direct_ms[1:], 50))
    plain_p50 = float(np.percentile(plain_ms[1:], 50))
    # one card step of each kind for the dry run, from the direct eager
    # call: the flops of the mesh step on the plain attention
    # (FlopCounterMode cannot see inside a kernel nor into a replay; the
    # dry run counts the plain version's products), the peak
    pcfg = cfg.replace(geometry=dataclasses.replace(cfg.geometry,
                                                    kernel_force="ref"))
    pmodel = get_model(pcfg, device=DEV)
    pstep, _ = jit_serve_step(pmodel, mesh, p["B"], max_len, params, caches)
    pos = torch.full((p["B"],), p["prompt"], dtype=torch.int32, device=DEV)
    _, flops = _flops_of(lambda: _direct(pstep)(mparams, mcaches, first,
                                                 pos))
    _mem_reset()
    base = torch.cuda.memory_allocated()
    _direct(mstep)(mparams, mcaches, first, pos)
    peak = _mem_peak() - base + arg_bytes
    card["decode"] = dict(arguments=arg_bytes, peak=peak, flops=flops,
                          step_ms=replay, max_len=max_len,
                          graph_mb=graph.get("graph_mb"))
    emit(dict(phase="mesh_serve", arch=cfg.name, layers=cfg.n_layers,
              dtype=cfg.dtype, batch=p["B"], prompt=p["prompt"],
              new_tokens=p["new"], mesh="1x1 nccl", tokens_equal=True,
              launches=launched, graph=graph, mesh_step_ms_p50=replay,
              mesh_direct_ms_p50=direct, plain_step_ms_p50=plain_p50,
              dtensor_host_ms=direct - plain_p50,
              replay_minus_plain_ms=replay - plain_p50,
              device_busy_ms=busy,
              idle_share=None if busy is None else 1.0 - busy / replay,
              wall_s=time.monotonic() - t_phase))
    _close(mstep)
    del params, mparams, caches, mcaches
    free_card()
    return launched


def _mesh_against_plain(phase, plain, mstep, state, mstate, data, steps):
    """``steps`` steps of the plain train step from ``state`` and of the
    mesh step from ``mstate`` (the same state placed) on the same batches:
    the mesh state written in place at its addresses, the losses within
    1e-6 relative, every state leaf within 1e-6 x its max, no kernel
    launched. Returns (runs: losses, step ms and final
    state by "plain" / "mesh", the launches, the losses' and the leaves'
    largest relative difference)."""
    from repro_torch.kernels import launches
    from repro_torch.tree import flatten
    before = dict(launches)
    runs = {}
    ptrs = [t.to_local().data_ptr() for t in _leaves(mstate)]
    for tag, step, st in (("plain", plain, state), ("mesh", mstep, mstate)):
        losses, times = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            st, m = step(st, data.batch_at(i))
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
            losses.append(float(m["loss"]))
        runs[tag] = dict(losses=losses, step_ms=times, state=st)
    require(all(a is b for a, b in zip(_leaves(runs["mesh"]["state"]),
                                       _leaves(mstate))) and [
        t.to_local().data_ptr() for t in _leaves(mstate)] == ptrs,
            f"{phase}: the mesh step did not write the caller's state in "
            "place")
    got = _no_launch(phase, before)
    lp, lm = runs["plain"]["losses"], runs["mesh"]["losses"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(lp, lm))
    require(rel <= 1e-6, f"{phase}: losses {lm} vs plain {lp}")
    worst = 0.0
    for a, b in zip(flatten(runs["plain"]["state"])[0],
                    flatten(runs["mesh"]["state"])[0]):
        b = b.to_local()
        scale = float(a.abs().max()) if a.numel() else 0.0
        err = float((a.double() - b.double()).abs().max()) if a.numel() \
            else 0.0
        require(err <= 1e-6 * max(scale, 1e-30),
                f"{phase}: a state leaf differs by {err} (max {scale})")
        worst = max(worst, err / scale if scale else 0.0)
    return runs, got, rel, worst


def mesh_train_phase(get_config, mesh, card):
    """Full smollm-135m, fp32, B 8, S 1024: three ``jit_train_step`` steps
    on the one-rank mesh (its program: the first captures, the others
    replay, the placed state written in place) against three
    ``make_train_step`` steps on the same state and batches; the losses
    within 1e-6 relative, every state leaf within 1e-6 x its max; no
    kernel launched; step p50 of the replays, of the direct eager call and
    of the plain step, capture ms, graph MB, a replay's busy ms. Flops and
    peak for the dry run come from the functional eager mesh step
    (``step.functional``, the step the dry run models), before the capture.
    Returns (launches, the mesh state, its specs, the step, the data)."""
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.runtime.train import jit_train_step, make_train_step
    from repro_torch.runtime.sharding import place
    t_phase = time.monotonic()
    p = MESH_TRAIN
    cfg = get_config("smollm-135m")
    model, opts, state, _ = _train_setup(cfg, p["B"], p["S"], SEED + 62)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=p["S"],
                                   batch_size=p["B"], seed=SEED + 62))
    mstep, sspecs, bspecs = jit_train_step(model, mesh, opts, state,
                                           data.batch_at(0))

    mstate = place(_clone_tree(state), mesh, sspecs)
    # the placed state and batch alone, made afresh
    _, arg_bytes = _card_bytes(lambda: (
        place(_clone_tree(state), mesh, sspecs),
        place({k: torch.from_numpy(v).to(DEV) for k, v in
               data.batch_at(0).items()}, mesh, bspecs)))
    # the card step for the dry run: its flops and peak
    _, flops = _flops_of(lambda: mstep.functional(mstate, data.batch_at(0)))
    _mem_reset()
    base = torch.cuda.memory_allocated()
    mstep.functional(mstate, data.batch_at(0))
    peak = _mem_peak() - base + arg_bytes
    runs, got, rel, worst = _mesh_against_plain(
        "mesh_train", make_train_step(model, opts), mstep, state, mstate,
        data, p["steps"])
    lp, lm = runs["plain"]["losses"], runs["mesh"]["losses"]
    graph = _graph_record("mesh_train", mstep, p["steps"])
    times = _mesh_train_records(mstep, runs["mesh"]["state"], data,
                                runs["mesh"]["step_ms"],
                                runs["plain"]["step_ms"])
    card["train"] = dict(arguments=arg_bytes, peak=peak, flops=flops,
                         step_ms=times["mesh_step_ms_p50"], opts=opts,
                         graph_mb=graph.get("graph_mb"))
    emit(dict(phase="mesh_train", arch=cfg.name, layers=cfg.n_layers,
              dtype="float32", batch=p["B"], seq=p["S"], steps=p["steps"],
              mesh="1x1 nccl", losses=lm, plain_losses=lp,
              loss_max_rel_diff=rel, state_max_rel_diff=worst, graph=graph,
              **times, launches=got, wall_s=time.monotonic() - t_phase))
    return got, runs["mesh"]["state"], sspecs, mstep, data


def mesh_ckpt_phase(mesh, state, sspecs, step, data):
    """``save`` after mesh_train, ``restore(shardings=named(mesh,
    state_specs))``, one more step: bit-equal to the step taken from the
    state in memory (deterministic algorithms for both). Each of the two
    steps is a first call of its binding in mesh_train's program (the
    flag is in the key; the restored state is new DTensors): it runs
    eagerly, then captures."""
    from repro_torch.ckpt import restore, save
    from repro_torch.kernels import launches
    from repro_torch.runtime.sharding import named
    from repro_torch.tree import flatten
    t_phase = time.monotonic()
    ckpt = OUT / "mesh_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    before = dict(launches)
    g = getattr(step, "graphs", None)
    n0 = (g.captures, g.replays, len(g.capture_ms)) if g else None
    at = MESH_TRAIN["steps"]
    torch.use_deterministic_algorithms(True)
    try:
        save(state, str(ckpt), step=at)
        sa, _ = step(state, data.batch_at(at))
        rs, got_at = restore(str(ckpt), state,
                             shardings=named(mesh, sspecs))
        sb, _ = step(rs, data.batch_at(got_at))
    finally:
        torch.use_deterministic_algorithms(False)
    got = _no_launch("mesh_ckpt", before)
    diff = [i for i, (a, b) in enumerate(zip(flatten(sa)[0],
                                             flatten(sb)[0]))
            if not torch.equal(a.to_local(), b.to_local())]
    placed = all(tuple(a.placements) == tuple(b.placements)
                 for a, b in zip(flatten(sa)[0], flatten(rs)[0]))
    shutil.rmtree(ckpt, ignore_errors=True)
    require(got_at == at, f"mesh_ckpt: restored step {got_at}, saved {at}")
    require(placed, "mesh_ckpt: a restored leaf lost its placements")
    require(not diff, f"mesh_ckpt: leaves {diff} differ after the restart")
    graph = {}
    if g is not None:
        graph = dict(captures=g.captures - n0[0], replays=g.replays - n0[1],
                     capture_ms=g.capture_ms[n0[2]:],
                     graph_mb=[b / 2**20 for b in g.graph_bytes[n0[2]:]])
        require(graph["captures"] == 2 and graph["replays"] == 0,
                f"mesh_ckpt: {graph} (a capture for each new binding)")
    emit(dict(phase="mesh_ckpt", restored_at=got_at,
              leaves=len(flatten(sa)[0]), bitexact=True, launches=got,
              graph=graph, wall_s=time.monotonic() - t_phase))
    return got


def dryrun_vs_card_phase(get_config, card):
    """The port's dry run of smollm-135m on a one-rank fake mesh at
    mesh_train's shape (fp32, its options) and at mesh_serve's decode
    shape (bf16), against the card's runs of the same steps: arguments
    bytes against memory_allocated of the placed state/params, batch and
    caches (gate 1%), the predicted peak against max_memory_allocated (the
    ratio), the counted flops against FlopCounterMode over the card step
    (gate 2%), and the compute-bound time against the measured step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16, fake_world
    from repro_torch.kernels.registry import PEAK_FLOPS
    t_phase = time.monotonic()
    fake_world(1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_config("smollm-135m")
        tr, dec = card["train"], card["decode"]
        pred = {
            "train": dryrun.measure(
                cfg.replace(dtype="float32"),
                ShapeCell("mesh_train", MESH_TRAIN["S"], MESH_TRAIN["B"],
                          "train"), mesh, "fake1x1", opts=tr["opts"]),
            "decode": dryrun.measure(
                cfg, ShapeCell("mesh_serve", dec["max_len"],
                               MESH_SERVE["B"], "decode"), mesh, "fake1x1")}
    finally:
        dist.destroy_process_group()
    out = {}
    for kind, meas in (("train", tr), ("decode", dec)):
        r = pred[kind]
        args_err = abs(r["memory"]["arguments"] - meas["arguments"]) \
            / meas["arguments"]
        flops_err = abs(r["per_device"]["flops"] - meas["flops"]) \
            / meas["flops"]
        rate = PEAK_FLOPS["float32"] if kind == "train" else PEAK_FLOPS_BF16
        out[kind] = dict(
            arguments_pred=r["memory"]["arguments"],
            arguments_card=meas["arguments"], arguments_rel_err=args_err,
            peak_pred=r["memory"]["per_device_bytes"],
            peak_card=meas["peak"],
            peak_ratio=r["memory"]["per_device_bytes"] / meas["peak"],
            flops_pred=r["per_device"]["flops"], flops_card=meas["flops"],
            flops_rel_err=flops_err,
            compute_bound_ms=r["per_device"]["flops"] / rate * 1e3,
            compute_rate="float32 CUDA cores" if kind == "train"
            else "bf16 tensor cores",
            step_ms=meas["step_ms"],
            roofline_fraction=r["per_device"]["flops"] / rate * 1e3
            / meas["step_ms"], trace_s=r["trace_s"])
        require(args_err <= 0.01, f"dryrun_vs_card: {kind} arguments "
                f"{r['memory']['arguments']} vs the card's "
                f"{meas['arguments']}")
        require(flops_err <= 0.02, f"dryrun_vs_card: {kind} flops "
                f"{r['per_device']['flops']} vs the card's {meas['flops']}")
    emit(dict(phase="dryrun_vs_card", arch="smollm-135m", **out,
              wall_s=time.monotonic() - t_phase))


MESH_REPLAY = dict(serve_calls=8, train_layers=4, B=8, S=1024,
                   train_steps=3)


class _SyncingModel:
    """A model whose decode reads its positions on the host (a step that
    cannot be captured)."""

    def __init__(self, model):
        self.model, self.cfg, self.dev = model, model.cfg, model.dev
        self.calls = 0

    def decode(self, params, caches, tokens, pos):
        self.calls += 1
        if int(pos.to_local().max()) < 0:
            raise ValueError("negative position")
        return self.model.decode(params, caches, tokens, pos)


def _dt_equal(a, b):
    return tuple(a.placements) == tuple(b.placements) and torch.equal(
        a.to_local(), b.to_local())


def mesh_graph_replay_phase(get_config, mesh):
    """The mesh programs against their direct eager calls, on the one-rank
    mesh, under deterministic algorithms. Serve: full smollm-135m bf16, 8
    prompts of 64, a new ``jit_serve_step`` program called 8 times, each
    call after a direct eager call of its step on a clone of the same
    caches with the same tokens and positions: logits and caches bitwise
    equal, the caches returned as the caller's own, one capture and 7
    replays. Train: smollm-135m at full width cut to 4 layers, fp32, B 8,
    S 1024, 3 program steps each after a direct eager in-place step on a
    clone of the same state and batch: metrics and every leaf bitwise
    equal, the caller's state returned, every local shard at its address,
    one capture and 2 replays, no launch. Refusal: ``jit_serve_step`` of a
    model whose decode reads its positions on the host: its first call
    raises ``GraphCaptureError`` naming the line, the next is refused
    without running the step. Off the card (a rehearsal) the steps run
    eagerly and the refusal is skipped."""
    from repro_torch.core.graphs import GraphCaptureError
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import launches
    from repro_torch.models import get_model
    from repro_torch.runtime import (jit_serve_step, jit_train_step,
                                     make_prefill_step)
    from repro_torch.runtime.sharding import place
    t_phase = time.monotonic()
    p, B, prompt = MESH_REPLAY, MESH_SERVE["B"], MESH_SERVE["prompt"]
    cfg = get_config("smollm-135m")
    model = get_model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED + 66))
    prompts = torch.randint(
        0, cfg.vocab_size, (B, prompt), device=DEV, dtype=torch.int32,
        generator=torch.Generator(device=DEV).manual_seed(SEED + 67))
    max_len = prompt + p["serve_calls"]
    h, caches = make_prefill_step(model, max_len)(params,
                                                  {"tokens": prompts})
    tok0 = model.logits(params, h[:, -1:]).argmax(-1).to(torch.int32)
    step, specs = jit_serve_step(model, mesh, B, max_len, params, caches)
    mparams = place(params, mesh, specs["params"])
    mcaches = place(caches, mesh, specs["caches"])
    leaves = _leaves(mcaches)
    tok = tok0
    pos = torch.full((B,), prompt, dtype=torch.int32, device=DEV)
    bad = []
    torch.use_deterministic_algorithms(True)
    try:
        for i in range(p["serve_calls"]):
            want, direct = _direct(step)(mparams, _clone_tree(mcaches), tok,
                                         pos)
            logits, got = step(mparams, mcaches, tok, pos)
            if not (_dt_equal(logits, want) and all(
                    a is b and _dt_equal(a, c) for a, b, c in zip(
                        _leaves(got), leaves, _leaves(direct)))):
                bad.append(i)
            tok = logits.to_local()[:, -1:].argmax(-1).to(torch.int32)
            pos = pos + 1
    finally:
        torch.use_deterministic_algorithms(False)
    require(not bad, f"mesh_graph_replay: serve calls {bad} differ from "
            "the direct eager call")
    out = dict(serve=dict(calls=p["serve_calls"], bitwise_equal=True,
                          graph=_graph_record("mesh_graph_replay serve", step,
                                             p["serve_calls"])))
    _close(step)
    if DEV != "cpu":
        syncing = _SyncingModel(model)
        sstep, _ = jit_serve_step(syncing, mesh, B, max_len, params, caches)
        pos = torch.full((B,), prompt, dtype=torch.int32, device=DEV)
        msgs, runs = [], []
        for _ in range(2):
            try:
                sstep(mparams, mcaches, tok0, pos)
                msgs.append("")
            except GraphCaptureError as e:
                msgs.append(str(e))
            runs.append(syncing.calls)
        torch.cuda.synchronize()            # the card is still usable
        require(msgs[0].startswith("mesh_serve_step") and "chip_smoke.py"
                in msgs[0] and "pos.to_local().max()" in msgs[0]
                and msgs[1] == msgs[0] and runs == [2, 2],
                f"mesh_graph_replay: a syncing mesh step gave {msgs} after "
                f"{runs} runs (refused, naming its line, and not run again)")
        out["refusal"] = dict(message=msgs[0][:400], step_runs=runs)
    del params, mparams, caches, mcaches, h
    free_card()

    tcfg = cfg.replace(n_layers=p["train_layers"])
    tmodel, opts, state, _ = _train_setup(tcfg, p["B"], p["S"], SEED + 68)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=p["S"],
                                   batch_size=p["B"], seed=SEED + 68))
    tstep, sspecs, _ = jit_train_step(tmodel, mesh, opts, state,
                                      data.batch_at(0))
    mstate = place(state, mesh, sspecs)
    ptrs = [t.to_local().data_ptr() for t in _leaves(mstate)]
    before = dict(launches)
    bad = []
    torch.use_deterministic_algorithms(True)
    try:
        for i in range(p["train_steps"]):
            direct, want = _direct(tstep)(_clone_tree(mstate),
                                          data.batch_at(i))
            got_state, got = tstep(mstate, data.batch_at(i))
            if any(a is not b for a, b in zip(_leaves(got_state),
                                              _leaves(mstate))) or any(
                    not torch.equal(got[k], want[k]) for k in want) or any(
                    not _dt_equal(a, b) for a, b in zip(
                        _leaves(mstate), _leaves(direct))):
                bad.append(i)
            del direct
    finally:
        torch.use_deterministic_algorithms(False)
    kept = [t.to_local().data_ptr() for t in _leaves(mstate)] == ptrs
    require(not bad and kept, f"mesh_graph_replay: train steps {bad} "
            f"differ from the direct eager step (addresses kept: {kept})")
    got = _no_launch("mesh_graph_replay", before)
    out["train"] = dict(layers=p["train_layers"], batch=p["B"], seq=p["S"],
                        steps=p["train_steps"], bitwise_equal=True,
                        addresses_kept=True,
                        graph=_graph_record("mesh_graph_replay train", tstep,
                                           p["train_steps"]))
    _close(tstep)
    del state, mstate
    free_card()
    emit(dict(phase="mesh_graph_replay", **out, launches=got,
              wall_s=time.monotonic() - t_phase))


MESH_DEEPSEEK = dict(layers=2, B=2, S=256, steps=3)   # train_families' cut


def mesh_train_deepseek_phase(get_config, mesh):
    """deepseek-v2-lite-16b at full width cut to 2 layers (the dense first
    layer and one MoE layer, as train_families cuts the MoE families),
    fp32, its MoE dispatch split over the dp axes (``dp_shards`` 2): three
    ``jit_train_step`` steps on the one-rank mesh against three
    ``make_train_step`` steps on the same state and batches, held as
    mesh_train holds smollm (losses and leaves within 1e-6, no launch, one
    capture then replays), with its records."""
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.runtime.sharding import place
    from repro_torch.runtime.train import jit_train_step, make_train_step
    t_phase = time.monotonic()
    p = MESH_DEEPSEEK
    cfg = get_config("deepseek-v2-lite-16b").replace(n_layers=p["layers"])
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dp_shards=2))
    model, opts, state, _ = _train_setup(cfg, p["B"], p["S"], SEED + 64)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=p["S"],
                                   batch_size=p["B"], seed=SEED + 64))
    mstep, sspecs, _ = jit_train_step(model, mesh, opts, state,
                                      data.batch_at(0))
    mstate = place(_clone_tree(state), mesh, sspecs)
    runs, got, rel, worst = _mesh_against_plain(
        "mesh_train_deepseek", make_train_step(model, opts), mstep, state,
        mstate, data, p["steps"])
    graph = _graph_record("mesh_train_deepseek", mstep, p["steps"])
    times = _mesh_train_records(mstep, runs["mesh"]["state"], data,
                                runs["mesh"]["step_ms"],
                                runs["plain"]["step_ms"])
    emit(dict(phase="mesh_train_deepseek", arch=cfg.name,
              layers=cfg.n_layers, cut=f"n_layers 27 -> {p['layers']}",
              dtype="float32", dp_shards=2, batch=p["B"], seq=p["S"],
              steps=p["steps"], mesh="1x1 nccl",
              losses=runs["mesh"]["losses"],
              plain_losses=runs["plain"]["losses"],
              loss_max_rel_diff=rel, state_max_rel_diff=worst, graph=graph,
              **times, launches=got, wall_s=time.monotonic() - t_phase))
    _close(mstep)
    del runs, state, mstate
    free_card()
    return got


SHELL_SLOTS = 4


def spatial_shell_phase():
    """``SpatialShell()`` on the card over the existing one-rank group: 4
    slots whose groups are all [0], each ``slot_mesh`` a CUDA DeviceMesh
    of size 1 whose all-reduce returns its input. Then the paper's stream
    (each of 4 cores streaming 100,000 fp32 16x16, then 32x32, matrices
    resident on the card, blocks of 64) through the 4 slots' streams,
    against a ``FusedShell`` running the same cores on the same blocks:
    outputs bitwise equal, the batched kernel launched cores x cycles
    times by each, each slot's program and the fused cycle capturing one
    graph a block shape. Returns the launches of the spatial runs."""
    import torch.distributed as dist
    from repro_torch.kernels import _lib
    from repro_torch.rc2f import (CoreSpec, FusedShell, SpatialShell,
                                  StreamSpec)
    t_phase = time.monotonic()
    shell = SpatialShell(device=DEV)
    require(shell.n_slots == SHELL_SLOTS and shell.devices == [0]
            and shell._groups == [[0]] * SHELL_SLOTS,
            f"spatial_shell: groups {shell._groups} on {shell.devices}")
    sums = []
    for i in range(SHELL_SLOTS):
        m = shell.slot_mesh(i)
        require(m.device_type == DEV and m.size() == 1
                and m.mesh.tolist() == [0],
                f"spatial_shell: slot {i} mesh {m}")
        x = torch.arange(8.0, device=DEV) + i
        y = x.clone()
        dist.all_reduce(y, group=m.get_group())
        require(torch.equal(x, y), f"spatial_shell: slot {i} all-reduce")
        sums.append(float(y.sum()))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 65)
    g = RC3E_BLOCK
    n_cycles = -(-RC3E_MATS // g)
    spatial_path = {k: 0 for k in _lib.launches}
    rows = []
    for sz in (16, 32):
        spec = CoreSpec(f"mm{sz}", (StreamSpec((g, sz, sz)),) * 2,
                        (StreamSpec((g, sz, sz)),))
        dev = [[torch.randn((RC3E_MATS, sz, sz), generator=gen, device=DEV)
                for _ in range(2)] for _ in range(SHELL_SLOTS)]
        fused = FusedShell(SHELL_SLOTS, device=DEV)
        for i in range(SHELL_SLOTS):
            shell.load(i, _stream_core, spec, f"tenant{i}")
            fused.load(i, _stream_core, spec, f"tenant{i}")
        blocks = [[(dev[i][0][j:j + g], dev[i][1][j:j + g])
                   for j in range(0, RC3E_MATS, g)]
                  for i in range(SHELL_SLOTS)]
        runs = {}
        for tag in ("fused", "spatial"):
            before = dict(_lib.launches)
            graphs0 = (fused if tag == "fused" else shell).counts()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            outs = [[] for _ in range(SHELL_SLOTS)]
            for c in range(n_cycles):
                if tag == "fused":
                    got = fused.run_cycle({i: blocks[i][c]
                                           for i in range(SHELL_SLOTS)})
                else:
                    got = {i: shell.run(i, *blocks[i][c])
                           for i in range(SHELL_SLOTS)}
                for i in range(SHELL_SLOTS):
                    outs[i].append(got[i][0])
            if tag == "spatial":
                shell.join()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            n = {k: _lib.launches[k] - before[k] for k in _lib.launches}
            require(n["stream_matmul_batched"] == SHELL_SLOTS * n_cycles
                    and sum(n.values()) == n["stream_matmul_batched"],
                    f"spatial_shell mm{sz} {tag}: launches {n} != "
                    f"{SHELL_SLOTS} x {n_cycles}")
            graph = _graph_delta(graphs0, (fused if tag == "fused"
                                           else shell).counts())
            per = 1 if tag == "fused" else SHELL_SLOTS      # programs
            require(DEV == "cpu" or (
                graph["captures"] == rc3e_shapes() * per
                and graph["replays"] == (n_cycles - rc3e_shapes()) * per),
                    f"spatial_shell mm{sz} {tag}: {graph['captures']} "
                    f"captures, {graph['replays']} replays for {per} "
                    f"program(s) over {n_cycles} cycles")
            if tag == "spatial":
                spatial_path = {k: spatial_path[k] + n[k] for k in n}
            runs[tag] = dict(outs=[torch.cat(o) for o in outs], wall=wall,
                             graph=graph)
        for i in range(SHELL_SLOTS):
            a, b = runs["fused"]["outs"][i], runs["spatial"]["outs"][i]
            require(a.shape == (RC3E_MATS, sz, sz)
                    and bool(torch.isfinite(b).all()) and torch.equal(a, b),
                    f"spatial_shell mm{sz}: slot {i} differs from the fused "
                    "shell's")
        in_bytes = 2 * RC3E_MATS * sz * sz * 4
        rows.append(dict(core=f"mm{sz}", cores=SHELL_SLOTS, cycles=n_cycles,
                         launches_each=SHELL_SLOTS * n_cycles,
                         bitwise_equal=True, **{
                             f"aggregate_MBps_{t}": SHELL_SLOTS * in_bytes
                             / runs[t]["wall"] / 1e6 for t in runs},
                         **{f"wall_s_{t}": runs[t]["wall"] for t in runs},
                         **{f"graph_{t}": runs[t]["graph"] for t in runs}))
        del runs, blocks, dev
    emit(dict(phase="spatial_shell", slots=SHELL_SLOTS, groups=shell._groups,
              mesh_sizes=[shell.slot_mesh(i).size()
                          for i in range(SHELL_SLOTS)],
              all_reduce_sums=sums, matrices_per_core=RC3E_MATS, block=g,
              rows=rows, launches=spatial_path,
              wall_s=time.monotonic() - t_phase))
    return spatial_path


def mesh_phases(get_config):
    """The mesh slice's phases on a world of 1 over NCCL
    (``make_host_mesh(1, 1)``), then deepseek's train step on that mesh
    and ``SpatialShell`` over its group; returns the mesh path's launches
    (the counts zeroed just before jit_serve_step's decode loop and read
    just after; the training phases launch nothing) and the spatial
    shell's (zeroed just before its runs, read just after)."""
    import torch.distributed as dist
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.monotonic()
    mesh = make_host_mesh(1, 1, device=DEV)
    card = {}
    try:
        path = mesh_serve_phase(get_config, mesh, card)
        got, state, sspecs, step, data = mesh_train_phase(get_config, mesh,
                                                          card)
        got2 = mesh_ckpt_phase(mesh, state, sspecs, step, data)
        _close(step)
        del state, step
        free_card()
        mesh_graph_replay_phase(get_config, mesh)
        got3 = mesh_train_deepseek_phase(get_config, mesh)
        # the counts zeroed just before the shell's path, read just after
        _lib.launches.reset()
        shell_path = spatial_shell_phase()
    finally:
        dist.destroy_process_group()
    require(not any(got.values()) and not any(got2.values())
            and not any(got3.values()),
            f"mesh: training launched kernels {got} {got2} {got3}")
    dryrun_vs_card_phase(get_config, card)
    emit(dict(phase="mesh", launches=path, wall_s=time.monotonic() - t0))
    return path, shell_path


# ---------------------------------------------------------------------------
# The port's examples (examples/*_torch.py) through their main
# ---------------------------------------------------------------------------

# 40 steps: a restart from step 10 of a 20-step run trains while the lr
# peaks and its loss rises (5.45 -> 5.68), failing the example's own
# assert; from step 30 of 40 it falls
EXAMPLE_TRAIN = ("--full", "--steps", "40", "--seq", "1024", "--batch", "8",
                 "--save-every", "10")
EXAMPLE_RESTART_AT = 30


def load_example(name):
    """``examples/<name>_torch.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name, fn, *args, **kw):
    """``fn``'s result; what it printed goes to OUT/examples/<name>.txt."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    (OUT / "examples").mkdir(exist_ok=True)
    with open(OUT / "examples" / f"{name}.txt", "a") as f:
        f.write(buf.getvalue())
    return out


@contextlib.contextmanager
def served_watch(w, top8=None):
    """While the block runs: engine decode and prefill calls
    (``engine_calls``) into ``w["calls"]``, configures of a program into
    ``w["configures"]``, and the kernel launches into ``w["launches"]``
    when it ends."""
    from repro_torch.core.reconfig import Reconfigurator
    from repro_torch.kernels import _lib
    w.update(calls={"decode": 0, "prefill": 0}, configures=0)
    configure = Reconfigurator.configure

    def counted(self, *a, **kw):
        w["configures"] += 1
        return configure(self, *a, **kw)

    before = dict(_lib.launches)
    Reconfigurator.configure = counted
    try:
        with engine_calls(w["calls"], top8):
            yield w
    finally:
        Reconfigurator.configure = configure
        w["launches"] = {k: _lib.launches[k] - before[k]
                         for k in _lib.launches}


def by_request(streams, phase):
    """Streams keyed by request id as a list in id order (ids 0..n-1, as
    ``compare_streams`` indexes them)."""
    require(sorted(streams) == list(range(len(streams))),
            f"{phase}: request ids {sorted(streams)}")
    return [streams[i] for i in range(len(streams))]


def example_serving(name, parts, paged):
    """Run example ``name`` on the kernels and on the plain versions
    (``--kernel-force ref``), each of its serving ``parts`` (label ->
    the module's function serving that part, whose result holds
    ``streams`` and is ``main``'s result under the label; None: ``main``
    itself) watched on its own (``served_watch``). Gates per part: the
    kernel run's launches exactly what its engine calls and configures
    need (``program_launches``, paged or dense engines), none on the plain
    run, nothing launched outside the parts, the streams equal but at
    counted near-ties (fp32 tolerance). Returns (the results of both runs,
    per part: launches, engine calls, configures, the stream
    comparison)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import _lib
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    mod = load_example(name)
    runs = {}
    for tag, force in (("kernel", []), ("plain", ["--kernel-force",
                                                  "ref"])):
        watched = {label: {} for label in parts}
        top8 = {label: {} if tag == "plain" else None for label in parts}

        def watch(label, fn):
            def run(*a, **kw):
                with served_watch(watched[label], top8[label]):
                    return fn(*a, **kw)
            return run
        saved = {attr: getattr(mod, attr) for attr in parts.values() if attr}
        for label, attr in parts.items():
            if attr:
                setattr(mod, attr, watch(label, saved[attr]))
        main = mod.main
        if None in parts.values():
            main = watch(next(k for k, v in parts.items() if v is None), main)
        _lib.launches.reset()
        try:
            res = run_example(name, main, ["--device", DEV, *force])
        finally:
            for attr, fn in saved.items():
                setattr(mod, attr, fn)
        total = dict(_lib.launches)
        in_parts = {k: sum(w["launches"][k] for w in watched.values())
                    for k in total}
        require(total == in_parts, f"examples {name} {tag}: launches "
                f"{total} outside its serving parts {in_parts}")
        runs[tag] = dict(res=res, watched=watched, top8=top8)
    out = {}
    for label, attr in parts.items():
        phase = f"examples {name} {label}"
        kw = runs["kernel"]["watched"][label]
        require(not any(runs["plain"]["watched"][label]["launches"].values()),
                f"{phase}: the plain run launched "
                f"{runs['plain']['watched'][label]['launches']}")
        need = program_launches(phase, cfg, kw["calls"], kw["configures"],
                                paged, kw["launches"])
        got = {t: runs[t]["res"] if attr is None else runs[t]["res"][label]
               for t in runs}
        streams = compare_streams(
            by_request(got["kernel"]["streams"], phase),
            by_request(got["plain"]["streams"], phase),
            runs["plain"]["top8"][label], TOL[torch.float32])
        out[label] = dict(launches=kw["launches"], launches_needed=need,
                          engine_calls=kw["calls"],
                          configures=kw["configures"], **streams)
    return runs["kernel"]["res"], runs["plain"]["res"], out


def examples_phase():
    """The four port examples with ``--device cuda`` in this process,
    through ``main`` (what each prints goes to OUT/examples/): quickstart
    (RAaaS deploy, PR swap, BAaaS; user cores, no kernel), serve_baas (the
    paged engine, 8 slots over a 25-page pool, COW prefix sharing) and
    multi_tenant (the FusedShell's user cores, then the ServingGateway's
    and the GatewayFleet's dense engines with a live hand-off), each
    served on the kernels and on the plain versions (``example_serving``;
    their wall-clock-free results equal), and train_smollm ``--full
    --steps 40 --seq 1024 --batch 8`` saving every 10 steps, then rerun
    from its step-30 checkpoint, under deterministic algorithms: the loss
    falls, the rerun's 10 losses equal the first run's last 10 bit for
    bit, nothing launched. Returns the launches by example."""
    from repro_torch.ckpt.checkpoint import _step_dir
    from repro_torch.kernels import _lib
    t_phase = time.monotonic()
    shutil.rmtree(OUT / "examples", ignore_errors=True)
    path = {}

    _lib.launches.reset()
    qs = run_example("quickstart", load_example("quickstart").main,
                     ["--device", DEV])
    path["quickstart"] = dict(_lib.launches)
    require(not any(path["quickstart"].values()),
            f"examples quickstart: launched {path['quickstart']} (its cores "
            "are user einsum)")
    require(qs["out_shape"] == (64, 16, 16)
            and qs["invoke"] == [2.0 * i for i in range(8)]
            and qs["services"] == ["vector-double"]
            and not any(qs["utilization_end"].values()),
            f"examples quickstart: {qs}")
    emit(dict(phase="examples", example="quickstart", results=qs,
              launches=path["quickstart"]))

    k, p, cmp = example_serving("serve_baas", {"main": None}, paged=True)
    require(k["page_stats"] == p["page_stats"]
            and k["engine_steps"] == p["engine_steps"]
            and k["total_new"] == p["total_new"] == 96
            and k["streams"][0] == k["streams"][1],
            f"examples serve_baas: kernel {k} plain {p}")
    path["serve_baas"] = cmp["main"]["launches"]
    emit(dict(phase="examples", example="serve_baas",
              page_stats=k["page_stats"], engine_steps=k["engine_steps"],
              requests=k["requests"], **cmp["main"]))

    k, p, cmp = example_serving(
        "multi_tenant", {"gateway": "serving_gateway_demo",
                         "fleet": "fleet_migration_demo"}, paged=False)
    for key in ("tenant0_unchanged", "slot2_axpy"):
        require(k[key] and p[key], f"examples multi_tenant: {key}")
    for part in ("gateway", "fleet"):
        a = {x: y for x, y in k[part].items() if x != "streams"}
        b = {x: y for x, y in p[part].items() if x != "streams"}
        require(a == b, f"examples multi_tenant {part}: kernel {a} vs "
                f"plain {b}")
    require(k["fleet"]["handoff"][0] == "hot" and k["gateway"]["audited"]
            == 9 and k["fleet"]["served"] == 5,
            f"examples multi_tenant: {k['gateway']} {k['fleet']}")
    path["multi_tenant"] = {
        x: sum(c["launches"][x] for c in cmp.values())
        for x in _lib.launches}
    emit(dict(phase="examples", example="multi_tenant",
              gateway={x: y for x, y in k["gateway"].items()
                       if x != "streams"},
              fleet={x: y for x, y in k["fleet"].items() if x != "streams"},
              **{f"{part}_{x}": y for part, c in cmp.items()
                 for x, y in c.items()}))

    train = load_example("train_smollm")
    before = dict(_lib.launches)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            argv = ["--device", DEV, *EXAMPLE_TRAIN, "--ckpt-dir", ckpt]
            t0 = time.monotonic()
            first = run_example("train_smollm", train.main, argv)
            first_s = time.monotonic() - t0
            shutil.rmtree(_step_dir(ckpt, len(first["losses"])))
            again = run_example("train_smollm", train.main, argv)
    finally:
        torch.use_deterministic_algorithms(False)
    path["train_smollm"] = _no_launch("examples train_smollm", before)
    losses = first["losses"]
    steps = int(EXAMPLE_TRAIN[EXAMPLE_TRAIN.index("--steps") + 1])
    require(len(losses) == steps and losses[-1] < losses[0]
            and all(np.isfinite(losses)),
            f"examples train_smollm: losses {losses}")
    require(again["start"] == EXAMPLE_RESTART_AT
            and again["losses"] == losses[EXAMPLE_RESTART_AT:],
            f"examples train_smollm: the restart from step "
            f"{again['start']} gave {again['losses']}, not "
            f"{losses[EXAMPLE_RESTART_AT:]}")
    emit(dict(phase="examples", example="train_smollm",
              argv=list(EXAMPLE_TRAIN), model=first["model"],
              losses=losses, restart_at=again["start"],
              restart_losses=again["losses"], restart_bitexact=True,
              first_run_s=first_s, launches=path["train_smollm"]))
    emit(dict(phase="examples", wall_s=time.monotonic() - t_phase))
    return path


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
    # the registry's shared memory a block (what the tuner and rc3e-check
    # read) against the build, at every decode instantiation: the split
    # and merge kernels' static arrays against ptxas's; the group kernel
    # (no static arrays) at every block size against the dynamic shared
    # memory its launch requests (group_launch_smem)
    from repro_torch.kernels import registry as kreg
    fp = kreg.kernel_footprints()
    kv_names = {"float": "float32", "__nv_bfloat16": "bfloat16",
                "signed char": "int8"}
    from repro_torch.kernels.decode_attention import group_launch_smem
    seen, dynamic = set(), {}
    for k, v in ptxas["decode_attention"].items():
        m = re.search(r"decode_group_kernel<([^,]+), \(int\)(\d+)>", k)
        if m:
            kv, d = kv_names[m.group(1)], int(m.group(2))
            key = f"decode_group/D{d}/{kv}"
            require(v["smem_bytes"] == 0,
                    f"{key}: {v['smem_bytes']} bytes of static shared memory")
            for mrows in range(16, kreg.group_max_m(d) + 1, 16):
                want = kreg.decode_group_smem_bytes(d, kv, mrows)
                got = group_launch_smem(kv, d, mrows)
                require(got == want, f"registry {key} at M {mrows}: {want} "
                        f"bytes of dynamic shared memory, the launch {got}")
            require(fp.get(key) == group_launch_smem(kv, d,
                                                     kreg.group_max_m(d)),
                    f"registry {key}: {fp.get(key)} bytes")
            dynamic[key] = fp[key]
            seen.add(key)
            continue
        m = re.search(r"decode_(split|merge)_kernel<([^,]+), ([^,]+), "
                      r"\(bool\)\d, \(int\)(\d+)(?:, \(int\)(\d+))?>", k)
        require(m is not None, f"decode_attention: unparsed kernel {k}")
        kind, _, kt, d, g = m.groups()
        key = f"decode_split/D{d}/G{g}" if kind == "split" \
            else f"decode_merge/D{d}/{kv_names[kt]}"
        require(fp.get(key) == v["smem_bytes"],
                f"registry {key}: {fp.get(key)} bytes of shared memory, "
                f"ptxas {v['smem_bytes']}")
        seen.add(key)
    listed = {k for k in fp if k.startswith("decode_")}
    require(seen == listed, f"decode_attention: built {sorted(seen - listed)}"
            f" beyond the registry, missing {sorted(listed - seen)}")
    # no decode build spills: split, merge and group kernels alike
    spills = {k: v["spill_bytes"] for k, v in ptxas["decode_attention"].items()
              if v["spill_bytes"]}
    require(not spills, f"decode_attention: kernels spill registers: "
            f"{spills}")
    emit(dict(phase="build_decode", group_dynamic_smem=dynamic,
              registers={k: v["registers"]
                         for k, v in ptxas["decode_attention"].items()},
              tensor_core_ops=tensor_ops["decode_attention"]))
    require(sum(tensor_ops["decode_attention"].values()) > 0,
            "decode_attention: no HMMA in the SASS (the group kernel does "
            "not run on the tensor cores)")
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

    # the decode step as CUDA graphs: replays against direct calls, one
    # replay profiled, configure's refusal of a step that syncs, Table I
    # and each fleet engine's capture (counts zeroed before and after:
    # the direct calls are comparisons, not a path)
    graph_replay_phase(cfg, params, prompts)
    prefill_graph_replay_phase(cfg, params, prompts)
    graph_profile_phase(cfg, params, prompts)
    graph_refusal_phase()
    graph_configure_phase(cfg, params, prompts)
    _lib.launches.reset()

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
    # and gateway (paged: dense decode has no launch there), at full width
    # and HARNESS_LAYERS of the 30 layers (chip time: their records and
    # reports depend on neither depth nor weights)
    hcfg = cfg.replace(n_layers=HARNESS_LAYERS)
    hparams = Model(hcfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(SEED + 13))
    harness_path = {"scale_soak_presets": scale_soak_presets_phase(hcfg,
                                                                   hparams)}
    harness_path["scale_soak_long"], long32 = scale_soak_long_phase(hcfg,
                                                                    hparams)
    harness_path["adversary"] = adversary_phase(hcfg, hparams)
    del hparams
    for phase, got in harness_path.items():
        require(all(got[k] > 0 for k in ("paged_decode_attention",
                                         "flash_attention")),
                f"{phase}: a kernel of its path never launched: {got}")
    fp32_path["scale_soak_long"] = long32["flash_attention"]

    # the auto-tuner: the registry against the card, tune's results, the
    # measure hook, and an autotuned two-class fleet (its counts zeroed
    # before each autotuned run and read after it)
    autotune_path = autotune_phase(cfg, params, prompts)
    require(all(autotune_path[k] > 0 for k in ("paged_decode_attention",
                                               "flash_attention")),
            f"autotune: a kernel of its path never launched: {autotune_path}")

    qcfg = cfg.replace(kv_quant=True, n_layers=4)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    qparams = Model(qcfg, device=DEV).init(gen)
    engine_phase("int8_dense_engine", qcfg, qparams, prompts, False)
    engine_phase("int8_paged_engine", qcfg, qparams, prompts, True)
    del params, qparams

    # the dense families at full width and depth (bf16 serving; fp32
    # logits), then gemma2-9b at full width, 4 layers; weights freed between
    families_path = {k: 0 for k in SERVING_KERNELS + ("decode_group",)}
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
        families_path["decode_group"] += _lib.launches["decode_group"]
        if tag == "phi3":
            profile_phase("profile_phi3_dense_decode", fcfg, fparams,
                          fprompts, False)
        got = families_model_phase(fcfg, fparams)
        fp32_path["families_model"] += got["flash_attention"]
        del fparams
        free_card()
    g2cfg = get_config("gemma2-9b").replace(n_layers=4)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    g2params = Model(g2cfg, device=DEV).init(gen)
    got = families_model_phase(
        g2cfg, g2params, cut="n_layers 42 -> 4 (two local/global pairs; "
        "chip time)")
    fp32_path["families_model"] += got["flash_attention"]
    del g2params
    free_card()

    # the remaining families: MoE, MLA, VLM, hybrid, encoder-decoder
    families2_path = families2_phases(get_config, fp32_path)
    # this slice: a group of 16 at Qwen3-235B-A22B's widths
    wide_path = wide_group_engine_phase(get_config)
    _lib.launches.reset()                   # whisper through the engine
    whisper_engine_path = whisper_engine_phase(get_config)

    rc3e_path = rc3e_phase()
    shell_graph_replay_phase()

    scfg = get_config("mamba2-370m")
    sparams = seeded_params(Model(scfg, device=DEV), SEED + 8)
    ssm_model_phase(scfg, sparams)
    _lib.launches.reset()                   # the SSM path starts here
    ssm_path, _ = ssm_serve_phase(scfg, sparams)
    require(ssm_path["ssd_chunk_scan"] > 0,
            f"ssd_chunk_scan never launched on the SSM path: {ssm_path}")
    del sparams
    free_card()

    # training: AdamW, chunked xent, remat, microbatches, checkpoints and
    # the DP exchange through the port's entry points; no kernel launches
    # (none defines a backward, as in the reference)
    train_path = training_phases(get_config)

    # the mesh slice: jit_serve_step / jit_train_step on a one-rank NCCL
    # mesh, the checkpoint restored by placements, the dry run vs the card
    mesh_path, shell_path = mesh_phases(get_config)

    # the port's examples through their main, on the card (fp32 serving:
    # flash launches count in the flash row's fp32 entry)
    examples_path = examples_phase()
    example_launches = {k: sum(got[k] for got in examples_path.values())
                        for k in SERVING_KERNELS}
    fp32_path["examples"] = example_launches["flash_attention"]

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
                     + families2_path[k] + autotune_path[k]
                     + whisper_engine_path[k] + wide_path[k]
                     + sum(got[k] for got in harness_path.values())
                     for k in SERVING_KERNELS}
    path_launches["stream_matmul"] = (rc3e_path["stream_matmul"]
                                      + rc3e_path["stream_matmul_batched"])
    path_launches["ssd_chunk_scan"] = (ssm_path["ssd_chunk_scan"]
                                       + families2_path["ssd_chunk_scan"])
    # the decode group kernel: its launches are decode_attention's and
    # paged_decode_attention's that took its route, on every path
    main_case["decode_group"] = "g16/bf16"
    sources["decode_group"] = sources["decode_attention"]
    group_paths = {"smollm_serving": serving_path,
                   "families_serving": families_path,
                   "launch_serve": launch_path, "gateway_fleet": gateway_path,
                   "fleet_chaos": chaos_path, **harness_path,
                   "families2": families2_path, "autotune": autotune_path,
                   "whisper_engine": whisper_engine_path,
                   "wide_group_engine": wide_path, "training": train_path,
                   "mesh": mesh_path, **examples_path}
    group_by_path = {p: got.get("decode_group", 0)
                     for p, got in group_paths.items()}
    rows = []
    for name, recs in results.items():
        m = next(r for r in recs if r["case"] == main_case[name])
        if name == "decode_group":
            row = dict(
                name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:133",
                launches=sum(group_by_path.values()),
                launches_by_path=group_by_path,
                max_abs_err=max(r["max_abs_err"] for r in recs),
                model_max_abs_err=max(r["model_max_abs_err"] for r in recs),
                ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                bound_by=m["bound_by"], library_ms=m["library_ms"],
                kv_bytes_requested=m["kv_bytes_requested"],
                paged_ms=next(r["ms"] for r in recs
                              if r["name"] == "paged_decode_attention"
                              and r["case"] == main_case[name]))
            require(row["launches"] == wide_path["decode_group"] > 0,
                    f"decode_group: launched off its path or never: "
                    f"{group_by_path}")
            rows.append(row)
            continue
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
                **{p: got[name] for p, got in harness_path.items()},
                "families2": families2_path[name],
                "autotune": autotune_path[name],
                "whisper_engine": whisper_engine_path[name],
                "wide_group_engine": wide_path[name]}
        if name == "ssd_chunk_scan":
            row["launches_by_path"] = {
                "ssm_serve": ssm_path[name],
                "families2": families2_path[name]}
        if name == "stream_matmul":
            row["launches_by_path"] = {"rc3e": path_launches[name]}
        # every training phase: 0 (no kernel defines a backward)
        row["launches_by_path"]["training"] = train_path[name] + (
            train_path["stream_matmul_batched"]
            if name == "stream_matmul" else 0)
        # jit_serve_step's decode: decode_attention only
        row["launches_by_path"]["mesh"] = mesh_path[name] + (
            mesh_path["stream_matmul_batched"]
            if name == "stream_matmul" else 0)
        row["launches"] += row["launches_by_path"]["mesh"]
        if name in ("decode_attention", "paged_decode_attention"):
            row["launches_by_path"]["examples"] = example_launches[name]
            row["launches"] += example_launches[name]
        if name == "stream_matmul":     # SpatialShell's slot streams
            row["launches_by_path"]["spatial_shell"] = (
                shell_path["stream_matmul"]
                + shell_path["stream_matmul_batched"])
            row["launches"] += row["launches_by_path"]["spatial_shell"]
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
