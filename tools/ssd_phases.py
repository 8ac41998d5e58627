"""Where the SSD chunk kernel's time goes, phase by phase, on the card.

    python3 tools/ssd_phases.py

There is no ncu on the machine with the card, so this script builds an
instrumented copy of ``csrc/ssd_chunk_scan.cu``: ``clock64()`` read at the
phase boundaries of every chunk, the cycles summed per phase over the
chunks, and written out by the first and the last warp of every block. The
copy goes to ``kernels/_build/ssd_phases/`` (ignored by git); the repo's
source is not changed. The readings perturb what they time (each is a
fence for the scheduler), so they give shares, not a time to quote as the
kernel's.

Phases of a chunk: ``wait`` (this chunk's copies land, then the block's
barrier), ``issue`` (the next chunk's cp.async copies), ``state_C`` (y^T =
state . C^T and its scaling), ``intra_state`` (y^T += x^T . M^T, with M
formed in registers, and the state update), ``y_partials`` (each warp's y
to shared memory), ``barrier``, ``y_out`` (the partials summed and y
written). Cases: mamba2-370m's width (H 32, P 64, N 128, G 1), bf16 B=4
S=1024 and fp32 B=1 S=2048, the layer's strided views.

Prints one JSON line a case (cycles a chunk per phase, the mean over
blocks, for the first and the last warp, and each phase's share), then
the card's name, power limit and SM clocks.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("wait", "issue", "state_C", "intra_state", "y_partials",
          "barrier", "y_out")
# (anchor in the source, text put before it, text put after it)
PATCHES = (
    ("namespace {\n", "__device__ unsigned long long g_prof[2][8192][8];\n",
     ""),
    ("  for (int c = 0; c < nc; ++c) {\n",
     "  unsigned long long tp[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long tq = clock64(), tn;\n"
     "#define TICK(k) tn = clock64(); tp[k] += tn - tq; tq = tn;\n", ""),
    ("    __syncthreads();  // chunk c landed; chunk c - 1 fully consumed\n",
     "", "    TICK(0)\n"),
    ("    cp_async_commit();\n\n    const unsigned char* stg", "    TICK(1)\n",
     ""),
    ("    const float etot = ecum[Q - 1];\n", "    TICK(2)\n", ""),
    ("    // this warp's y partial to ys[nsi][q][p]\n", "    TICK(3)\n", ""),
    ("    __syncthreads();  // the partials are complete\n", "    TICK(4)\n",
     "    TICK(5)\n"),
    ("             v.w + dh * to_f(xq[3]));\n    }\n", "",
     "    TICK(6)\n"),
    ("  if (a.state_out != nullptr) {\n",
     "  {\n"
     "    const int bid = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "    const int w = threadIdx.x == 0 ? 0 : threadIdx.x == kThreads - 32"
     " ? 1 : -1;\n"
     "    if (w >= 0 && bid < 8192)\n"
     "      for (int k = 0; k < 8; ++k) g_prof[w][bid][k] = tp[k] / nc;\n"
     "  }\n", ""),
)


def instrumented_source():
    src = (ROOT / "src/repro_torch/kernels/csrc/ssd_chunk_scan.cu").read_text()
    for anchor, before, after in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"ssd_phases: anchor not found once: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    return src + ('\nextern "C" int rt_prof_read(unsigned long long* out) {\n'
                  "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof,"
                  " sizeof(g_prof)));\n}\n")


def build(_lib):
    out = _lib.BUILD_ROOT / "ssd_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd_phases.cu").write_text(instrumented_source())
    so = out / "libssd_phases.so"
    subprocess.run([_lib.cuda_tool(), *_lib.NVCC_FLAGS, "-o", str(so),
                    str(out / "ssd_phases.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def main():
    if not torch.cuda.is_available():
        print("ssd_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _lib
    from repro_torch.kernels import mamba2_chunk as ssd
    lib = build(_lib)
    _lib._libs["ssd_chunk_scan"] = lib     # the wrappers launch the copy
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = np.zeros((2, 8192, 8), dtype=np.uint64)
    H, P, G, N = 32, 64, 1, 128
    for case, dtype, B, S in (("bf16/B4/S1024", torch.bfloat16, 4, 1024),
                              ("fp32/B1/S2048", torch.float32, 1, 2048)):
        xbc = (torch.randn((B, S, H * P + 2 * G * N), generator=gen,
                           device="cuda") * 0.5).to(dtype)
        xs = xbc[..., :H * P].reshape(B, S, H, P)
        Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
        Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
        dt = F.softplus(torch.randn((B, S, H), generator=gen, device="cuda")
                        - 1.0)
        A = -torch.exp(torch.randn((H,), generator=gen, device="cuda"))
        D = torch.randn((H,), generator=gen, device="cuda")
        for _ in range(3):
            ssd.ssd_cuda(xs, dt, A, Bm, Cm, D)
        torch.cuda.synchronize()
        rc = lib.rt_prof_read(buf.ctypes.data_as(ctypes.c_void_p))
        if rc:
            raise SystemExit(f"ssd_phases: cudaMemcpyFromSymbol error {rc}")
        plan = _lib.last_plan["ssd_chunk_scan"]
        nb = plan.p_blocks * B * H
        rec = dict(case=case, plan=plan._asdict())
        for w, tag in ((0, "first_warp"), (1, "last_warp")):
            mean = buf[w, :nb, :len(PHASES)].astype(np.float64).mean(0)
            rec[tag] = {n: float(v) for n, v in zip(PHASES, mean)}
            rec[tag + "_share"] = {n: float(v / mean.sum())
                                   for n, v in zip(PHASES, mean)}
        print(json.dumps(rec), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
