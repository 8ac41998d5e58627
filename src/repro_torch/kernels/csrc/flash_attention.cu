// Causal flash attention (prefill) for Hopper (sm_90a): GQA, blocked online
// softmax with an fp32 accumulator, optional sliding window and tanh logit
// softcap, ragged sequence lengths.
//
// Replaces the Pallas TPU kernel flash_attention (_flash_kernel) in
// src/repro/kernels/flash_attention.py.
//
// What bounds it: operations. Each (query, key) pair of the causal band
// costs 4*D flops, while the bytes grow only linearly in S (q, k, v and out
// once each), so above a few hundred tokens the arithmetic dominates.
//
// Two kernels, chosen by dtype in the wrapper (one entry point each):
//
// flash_mma_kernel (bfloat16), an FA2-style forward on the tensor cores:
//   * one block per (sequence, query head, 64-query tile) with two sets of
//     4 warps; a warp owns 16 query rows, and set j takes the tile's key
//     tiles j, j+2, ... (two warps a query row, so a long row's sweep is
//     halved); the sets merge (m, l, O) through shared memory at the end;
//   * S = Q K^T and O += P V run as mma.sync.m16n8k16 (bf16 in, fp32
//     accumulators in registers); Q and K fragments come from shared
//     memory by ldmatrix, V by ldmatrix.trans; P goes from the S
//     accumulator fragment to the A fragment of P V in registers (rounded
//     to bf16, as the reference layer rounds its probabilities before
//     P V), never through shared memory; the softmax scale is applied to
//     the fp32 scores;
//   * K/V tiles of 64 keys are staged bf16 by 16-byte cp.async, two groups
//     of two tiles deep, in rows whose 16-byte chunks are XOR-swizzled by
//     the row index so that each 8-row ldmatrix phase hits 8 distinct bank
//     groups;
//   * the online softmax works per row in registers (log2 domain, exp2);
//     a row's max is reduced over the 4 lanes of its fragment quad, its sum
//     is kept per lane and reduced once at the end;
//   * loop bounds come from the causal band and the window; only the
//     diagonal tile and the tiles at the window's edge compute masks, and
//     a row none of whose keys in a tile is valid keeps m = -inf without a
//     NaN (exp2 is taken against 0 while m is -inf);
//   * the query-tile axis is the grid's slowest and is walked in reverse,
//     so the longest (most keys) tiles start first.
//   What bounds it now (by count): instruction issue and shared-memory
//   reads. A 16-row warp tile re-reads every K/V fragment per 2 mma.sync,
//   so ldmatrix traffic matches the tensor work; wgmma (64-row warpgroup
//   tiles reading K/V from shared memory once per warpgroup) and TMA copies
//   are the next step. Not done either: folding a kv group's query heads
//   into one block.
//
// flash_kernel (float32) stays on the fp32 CUDA cores (TF32 cannot meet the
// fp32 tolerance): 4 warps, a lane scores one key of a 32-key tile from
// shared memory, P V broadcasts each probability by shuffle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, Hq, Hkv, S, D;
  int window;
  float scale;
  float softcap;
};

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;     // query rows per block
constexpr int kBK = 32;     // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;

template <int DPL>
constexpr int smem_bytes() {
  return (kBQ * 32 * DPL + kBK * (32 * DPL + 1) + kBK * 32 * DPL) *
         static_cast<int>(sizeof(float));
}

template <int DPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const FlashArgs a) {
  constexpr int D = 32 * DPL;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][D], pre-scaled
  float* ks = qs + kBQ * D;          // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);    // [kBK][D]

  const int bh = blockIdx.y;
  const int b = bh / a.Hq;
  const int h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* og = static_cast<float*>(a.out) + b * a.o_sb + h * a.o_sh;

  for (int e = threadIdx.x; e < kBQ * D; e += blockDim.x) {
    const int r = e / D;
    const int d = e - r * D;
    const int qi = q0 + r;
    qs[e] = qi < a.S ? qg[qi * a.q_ss + d] * a.scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const int k_end = min(q0 + kBQ, a.S);  // causal: keys <= last query
  int k_begin = a.window ? max(0, q0 - a.window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int e = threadIdx.x; e < kBK * D; e += blockDim.x) {
      const int r = e / D;
      const int d = e - r * D;
      const int ki = k0 + r;
      const bool in = ki < a.S;
      ks[r * (D + 1) + d] = in ? kg[ki * a.k_ss + d] : 0.f;
      vs[r * D + d] = in ? vg[ki * a.v_ss + d] : 0.f;
    }
    __syncthreads();

    const int kp = k0 + lane;  // this lane's key
    const float* krow = ks + lane * (D + 1);
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
      const int qp = q0 + r;
      // warp-uniform skips: row past the end, tile after the row, tile
      // wholly before the row's window
      if (qp >= a.S || k0 > qp) continue;
      if (a.window && k0 + kBK - 1 <= qp - a.window) continue;
      const float* qrow = qs + r * D;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += qrow[d] * krow[d];
      if (a.softcap != 0.f) s = a.softcap * tanhf(s / a.softcap);
      const bool valid = kp <= qp && (a.window == 0 || qp - kp < a.window);
      float mx = valid ? s : -INFINITY;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[rr], mx);  // finite: key qp or an
                                             // earlier one is in the tile
      const float p = valid ? __expf(s - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float alpha = __expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + psum;
      float o_acc[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) o_acc[i] = acc[rr][i] * alpha;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) o_acc[i] += pj * vs[j * D + lane + 32 * i];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] = o_acc[i];
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int qp = q0 + warp * kRows + rr;
    if (qp < a.S) {
      const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        og[qp * a.o_ss + lane + 32 * i] = acc[rr][i] * inv;
    }
  }
}

template <int DPL>
int launch_f32_d(const FlashArgs& a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DPL>();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.Hq);
  flash_kernel<DPL><<<grid, kWarps * 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 64;      // query rows per block: 16 per warp of a set
constexpr int kMmaBK = 64;      // keys per K/V tile
constexpr int kSets = 2;       // warp sets: set j takes tiles j, j+kSets..
constexpr int kMmaWarps = 4 * kSets;
constexpr int kStages = 2;     // groups of kSets K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async 16 bytes; src_bytes 0 zero-fills (rows past the end).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU op (flushes results below 2^-126 to 0; x <= 0 here).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Element offset of (row, 16-byte chunk) in a [rows][D] bf16 tile whose
// chunks are XOR-swizzled: the 8 rows an ldmatrix phase reads at one
// logical chunk land in 8 distinct 16-byte bank groups. At D = 32 two rows
// share a 128-byte line, so the row index is halved first.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int kShift = D == 32 ? 1 : 0;
  constexpr int kMask = D == 32 ? 3 : 7;
  return row * D + ((chunk ^ ((row >> kShift) & kMask)) << 3);
}

template <int D>
constexpr int mma_smem_bytes() {
  return (kMmaBQ + 2 * kStages * kSets * kMmaBK) * D * 2;
}

// 64 rows of a [S][D] bf16 matrix (row stride ss) into a swizzled tile;
// rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int r0, int S) {
  constexpr int kChunks = D / 8;
  constexpr int kPerThread = 64 * kChunks / (kMmaWarps * 32);
  static_assert(kPerThread * kMmaWarps * 32 == 64 * kChunks,
                "every thread copies the same number of 16-byte chunks");
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = threadIdx.x + i * kMmaWarps * 32;
    const int r = e / kChunks;
    const int c = e - r * kChunks;
    const int gr = r0 + r;
    const bool in = gr < S;
    cp_async16(smem_addr(dst + swz<D>(r, c)),
               src + (long long)(in ? gr : 0) * ss + c * 8, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
flash_mma_kernel(const FlashArgs a) {
  constexpr int kKSteps = D / 16;      // k-steps of Q K^T
  constexpr int kSTiles = kMmaBK / 8;  // n8 tiles of S
  constexpr int kOTiles = D / 8;       // n8 tiles of O
  constexpr int kTile = kMmaBK * D;    // elements of a K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMmaBQ * D;  // [kStages][kSets][kMmaBK][D]
  __nv_bfloat16* vs = ks + kStages * kSets * kTile;

  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;  // longest first
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wrow = (warp & 3) * 16;  // this warp's 16 rows of the tile
  const int set = warp >> 2;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;

  const int k_end = min(q0 + kMmaBQ, a.S);  // causal: keys <= last query
  int k_begin = a.window ? max(0, q0 - a.window + 1) : 0;
  k_begin = (k_begin / kMmaBK) * kMmaBK;
  const int n_tiles = (k_end - k_begin + kMmaBK - 1) / kMmaBK;
  const int n_groups = (n_tiles + kSets - 1) / kSets;

  // group i: tiles i*kSets .. i*kSets + kSets-1 (those that exist)
  auto load_group = [&](int i) {
    const int st = i % kStages;
#pragma unroll
    for (int j = 0; j < kSets; ++j) {
      const int tile = i * kSets + j;
      if (tile < n_tiles) {
        const int k0 = k_begin + tile * kMmaBK;
        load_tile<D>(ks + (st * kSets + j) * kTile, kg, a.k_ss, k0, a.S);
        load_tile<D>(vs + (st * kSets + j) * kTile, vg, a.v_ss, k0, a.S);
      }
    }
    cp_async_commit();
  };
  load_tile<D>(qs, qg, a.q_ss, q0, a.S);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_group(i);  // Q rides group 0

  // this lane's rows of the fragments: ra (c0, c1) and ra + 8 (c2, c3)
  const int ra = q0 + wrow + (lane >> 2);
  const int col = 2 * (lane & 3);
  // scores to the log2 domain: s * scale * log2(e), or with the cap
  // cap * tanh(s * scale / cap) * log2(e)
  const bool capped = a.softcap != 0.f;
  const float s_mul = capped ? a.scale / a.softcap : a.scale * kLog2e;
  const float cap_log2 = a.softcap * kLog2e;

  uint32_t qf[kKSteps][4];
  float o[kOTiles][4];
#pragma unroll
  for (int t = 0; t < kOTiles; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int it = 0; it < n_groups; ++it) {
    // keep kStages - 1 groups in flight: issue group it + kStages - 1
    // (an empty commit past the end keeps the group count uniform)
    load_group(it + kStages - 1 < n_groups ? it + kStages - 1 : n_groups);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(qs + swz<D>(wrow + (lane & 15),
                                                  2 * kk + (lane >> 4))));
    }
    const int tile = it * kSets + set;
    if (tile < n_tiles) {  // warp-uniform
      const int k0 = k_begin + tile * kMmaBK;
      const int slot = (it % kStages) * kSets + set;
      const __nv_bfloat16* kt = ks + slot * kTile;
      const __nv_bfloat16* vt = vs + slot * kTile;

      // S = Q K^T: an x4 load's matrices are (keys 0-7 | 8-15) x (d lo | hi)
      float s[kSTiles][4];
#pragma unroll
      for (int t = 0; t < kSTiles; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t bf[kSTiles / 2][4];  // all loads of a k-step, then the mmas
#pragma unroll
        for (int np = 0; np < kSTiles / 2; ++np)
          ldmatrix_x4(bf[np], smem_addr(kt + swz<D>(np * 16 + (lane & 7) +
                                                        ((lane >> 4) << 3),
                                                    2 * kk +
                                                        ((lane >> 3) & 1))));
#pragma unroll
        for (int np = 0; np < kSTiles / 2; ++np) {
          mma_bf16(s[2 * np], qf[kk], bf[np][0], bf[np][1]);
          mma_bf16(s[2 * np + 1], qf[kk], bf[np][2], bf[np][3]);
        }
      }

      // scale (and cap) in fp32, to the log2 domain; mask where needed
      if (capped) {
#pragma unroll
        for (int t = 0; t < kSTiles; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[t][e] = cap_log2 * tanhf(s[t][e] * s_mul);
      } else {
#pragma unroll
        for (int t = 0; t < kSTiles; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] *= s_mul;
      }
      if (k0 + kMmaBK - 1 > q0 ||                            // the diagonal
          (a.window && q0 + kMmaBQ - 1 - k0 >= a.window)) {  // window edge
#pragma unroll
        for (int t = 0; t < kSTiles; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + ((e >> 1) << 3);
            const int key = k0 + 8 * t + col + (e & 1);
            if (key > row || (a.window && row - key >= a.window))
              s[t][e] = -INFINITY;
          }
        }
      }

      // online softmax, per row: max over the quad, exp2 against a finite
      // base (0 while the row has seen no valid key)
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < kSTiles; ++t)
          mx = fmaxf(mx, fmaxf(s[t][2 * r], s[t][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2_approx(m[r] - base);
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < kSTiles; ++t) {
          s[t][2 * r] = exp2_approx(s[t][2 * r] - base);
          s[t][2 * r + 1] = exp2_approx(s[t][2 * r + 1] - base);
          sum += s[t][2 * r] + s[t][2 * r + 1];
        }
        l[r] = l[r] * alpha[r] + sum;
        m[r] = m_new;
      }
#pragma unroll
      for (int t = 0; t < kOTiles; ++t) {
        o[t][0] *= alpha[0];
        o[t][1] *= alpha[0];
        o[t][2] *= alpha[1];
        o[t][3] *= alpha[1];
      }

      // O += P V: the S fragments of keys 16kk..16kk+15 are P's A fragment
#pragma unroll
      for (int kk = 0; kk < kMmaBK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        uint32_t bf[kOTiles / 2][4];
#pragma unroll
        for (int dp = 0; dp < kOTiles / 2; ++dp)
          ldmatrix_x4_trans(bf[dp],
                            smem_addr(vt + swz<D>(kk * 16 + (lane & 15),
                                                  2 * dp + (lane >> 4))));
#pragma unroll
        for (int dp = 0; dp < kOTiles / 2; ++dp) {
          mma_bf16(o[2 * dp], pa, bf[dp][0], bf[dp][1]);
          mma_bf16(o[2 * dp + 1], pa, bf[dp][2], bf[dp][3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (kSets > 1) {
    // sets 1.. hand (m, l, o) to set 0 through the drained K/V buffers
    cp_async_wait<0>();
    __syncthreads();
    constexpr int kPart = 4 + 4 * kOTiles;  // floats a lane hands over
    float* xs = reinterpret_cast<float*>(ks);  // [kSets-1][128][kPart]
    const int li = (warp & 3) * 32 + lane;
    if (set > 0) {
      float* x = xs + ((set - 1) * 128 + li) * kPart;
      x[0] = m[0];
      x[1] = m[1];
      x[2] = l[0];
      x[3] = l[1];
#pragma unroll
      for (int t = 0; t < kOTiles; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 + 4 * t + e] = o[t][e];
    }
    __syncthreads();
    if (set > 0) return;
#pragma unroll
    for (int j = 1; j < kSets; ++j) {
      const float* x = xs + ((j - 1) * 128 + li) * kPart;
      float c_own[2], c_x[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], x[r]);
        const float base = mn == -INFINITY ? 0.f : mn;
        c_own[r] = exp2_approx(m[r] - base);
        c_x[r] = exp2_approx(x[r] - base);
        l[r] = l[r] * c_own[r] + x[2 + r] * c_x[r];
        m[r] = mn;
      }
#pragma unroll
      for (int t = 0; t < kOTiles; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[t][e] = o[t][e] * c_own[e >> 1] + x[4 + 4 * t + e] * c_x[e >> 1];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row < a.S) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = og + (long long)row * a.o_ss + col;
#pragma unroll
      for (int t = 0; t < kOTiles; ++t)
        *reinterpret_cast<uint32_t*>(orow + 8 * t) =
            pack_bf16(o[t][2 * r] * inv, o[t][2 * r + 1] * inv);
    }
  }
}

template <int D>
int launch_mma_d(const FlashArgs& a, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<D>();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.B * a.Hq, (a.S + kMmaBQ - 1) / kMmaBQ);
  flash_mma_kernel<D><<<grid, kMmaWarps * 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(const FlashArgs* a) {
  return a->Hkv <= 0 || a->Hq % a->Hkv != 0;
}

}  // namespace

extern "C" int rt_flash_attention_f32(const FlashArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a->D) {
    case 32: return launch_f32_d<1>(*a, s);
    case 64: return launch_f32_d<2>(*a, s);
    case 128: return launch_f32_d<4>(*a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int rt_flash_attention_bf16(const FlashArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a->D) {
    case 32: return launch_mma_d<32>(*a, s);
    case 64: return launch_mma_d<64>(*a, s);
    case 128: return launch_mma_d<128>(*a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
