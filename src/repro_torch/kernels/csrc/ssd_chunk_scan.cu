// Mamba2 SSD scan for Hopper (sm_90a): the state-space recurrence
//   state_t = exp(dt_t * a) * state_{t-1} + (dt_t * x_t) (outer) B_t
//   y_t     = C_t . state_t + d * x_t
// per (sequence, head), fp32 state and accumulation, y in x's dtype, and
// optionally the final (P, N) state of every (sequence, head).
//
// Replaces the Pallas TPU kernel ssd_chunk_scan (_ssd_kernel) in
// src/repro/kernels/mamba2_chunk.py. The Pallas kernel walks the sequence
// chunk by chunk (grid minor axis) and carries the (P, N) state in VMEM
// scratch; within a chunk it uses the quadratic "attention-like" form
// (C B^T masked by the decay matrix L) so that the MXU does the work.
//
// What bounds it on this card: by count, operations. At mamba2-370m's
// width (P = 64, N = 128) a token of one head costs 4*P*N = 32 KFLOP (C .
// state and the state update) for a few hundred bytes of x, B, C and y; on
// the fp32 CUDA cores the operations outweigh the bytes five times over. On the tensor cores the
// kernel is bound by latency instead: tools/ssd_phases.py times its
// phases, and every phase of a chunk (copies issued, the three products,
// the y write-out) runs far below the rate of its unit.
// What the design does: the same chunked form as the Pallas kernel, on the
// tensor cores, in two kernels a call:
//   * ssd_prep_kernel, one block per (sequence, chunk of Q, group): C B^T
//     of the chunk (bf16: mma.sync.m16n8k16, exact products; fp32: 3xTF32)
//     into a workspace, on and below the diagonal only, ONCE per group and
//     not per head (mamba2-370m's 32 heads share one group); and for each
//     head of the group the chunk's decay vectors: cums = cumsum(dt * a)
//     (a warp's shuffle scan), w = dt * exp(total - cums), exp(cums), dt.
//   * ssd_chunk_kernel, design (a): one block per (sequence, head, tile of
//     16 * WP state rows p) sweeps the chunks in order; its (P, N) state
//     never leaves registers (it is the accumulator of the state-update
//     product, WP x NS warps of 16 rows x N / NS columns). A chunk:
//       y^T  = state . C^T                 (state, in registers, as the A
//                                           operand: an accumulator tile's
//                                           columns 2t, 2t+1 are the
//                                           fragment's k t, t + 4)
//       y^T *= exp(cums) (columns); state *= exp(total)
//       y^T += x^T . M^T, M = (C B^T) o L o dt_j (each warp forms its own
//                                           fragments of M from the staged
//                                           C B^T, masked before the exp)
//       state += (x o w)^T . B
//     All on mma.sync.m16n8k8 TF32 with fp32 accumulators. An operand that
//     is bf16 (x, B, C in a bf16 layer) is exact in TF32, so only the fp32
//     side (state, M, x o w) is split into hi + lo: two mma a product; fp32
//     inputs take 3xTF32. The intermediates stay as close to fp32 as the
//     plain chunked form keeps them (layers/ssm.py ssd_scan). The NS warps
//     that share state rows split the causal i tiles of x^T . M^T in a
//     snake order (equal work) and sum their y partials through shared
//     memory in a fixed order; the block writes y with coalesced stores.
//     x, B, C, the C B^T chunk and the vectors are staged by 16-byte
//     cp.async two chunks deep. Q = 32 (on the card, Q = 64 was no faster
//     and takes twice the shared memory).
//   * Why (a) and not three passes (chunk states, a pass across chunks,
//     chunk outputs): (a) keeps the state on chip, while the three-pass
//     form writes and reads B*H*nc*P*N*4 bytes of chunk states (128 MB at
//     B 4, S 1024, Q 32). Where (sequence, head) pairs are fewer than half
//     the SMs, the wrapper's plan takes 16-row tiles of 8 warps (4 blocks a
//     head instead of 1, 16 state columns a warp) so that B = 1 still
//     spreads over the card.
//   * The inputs are read through their strides, so the layer passes views
//     of its (B, S, conv_channels) activation without copies; heads map to
//     groups as h / (H / G). Any S works: past S, x, B, C and dt load as
//     zeros (dt = 0 keeps the state) and y is not stored.
// Results are deterministic: no atomics.
// Not done yet: wgmma and TMA; overlapping one chunk's copies and
// products with the next chunk's (warp specialisation).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct SsdArgs {
  const void* x;           // (B, S, H, P), p contiguous
  const float* dt;         // (B, S, H), fp32
  const void* bm;          // (B, S, G, N), n contiguous
  const void* cm;          // (B, S, G, N), n contiguous
  const float* a;          // (H,) negative decay
  const float* d;          // (H,) skip
  const float* init_state; // (B, H, P, N) or null; p stride N, n stride 1
  void* y;                 // (B, S, H, P), p contiguous
  float* state_out;        // (B, H, P, N) or null; p stride N, n stride 1
  float* cb_ws;            // (B, nc, G, Q, Q) fp32 workspace
  float* vec_ws;           // (B, nc, H, 4, Q) fp32 workspace
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
  long long is_sb, is_sh;
  long long so_sb, so_sh;
  int B, S, H, G, P, N;
  int q;                   // chunk length (kChunk)
  int wp;                  // warps along P (16 state rows each)
  int ns;                  // warps along N
  int dtype;               // 0: float32, 1: bfloat16
};

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive outputs, one vector store (16 B fp32, 8 B bf16)
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// two consecutive elements (an even offset) widened to fp32
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x8, row) * b (8x8, col), tf32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo, both tf32 (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// c += a * b, where an operand marked exact is already tf32 (a bf16 value)
// and the others are given as hi + lo: the small cross terms first.
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  if constexpr (!kAExact) mma_tf32(c, al, bh);
  if constexpr (!kBExact) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// ---------------------------------------------------------------------------
// Pass 1: C B^T of every (sequence, chunk, group), the heads' decay vectors
// ---------------------------------------------------------------------------

constexpr int kPrepThreads = 256;
constexpr int kChunk = 32;  // Q: steps a chunk

template <typename T, int N, int Q>
__global__ void __launch_bounds__(kPrepThreads)
ssd_prep_kernel(const SsdArgs a) {
  constexpr int kLd = N + 8;            // C, B rows in shared memory
  constexpr int E = 16 / sizeof(T);     // elements a 16-byte chunk
  constexpr int kRowChunks = N / E;
  extern __shared__ __align__(16) unsigned char smem[];
  T* cs = reinterpret_cast<T*>(smem);
  T* bs = cs + Q * kLd;
  const int c = blockIdx.x;
  const int nc = gridDim.x;
  const int b = blockIdx.y / a.G, g = blockIdx.y % a.G;
  const int s0 = c * Q;
  const int hpg = a.H / a.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;

  const T* cg = static_cast<const T*>(a.cm) + b * a.c_sb + g * a.c_sg;
  const T* bg = static_cast<const T*>(a.bm) + b * a.b_sb + g * a.b_sg;
  for (int e = tid; e < Q * kRowChunks; e += kPrepThreads) {
    const int r = e / kRowChunks, ch = e - (e / kRowChunks) * kRowChunks;
    const int s = s0 + r;
    const bool in = s < a.S;
    cp_async16(cs + r * kLd + ch * E,
               in ? cg + (long long)s * a.c_ss + ch * E : cg, in ? 16 : 0);
    cp_async16(bs + r * kLd + ch * E,
               in ? bg + (long long)s * a.b_ss + ch * E : bg, in ? 16 : 0);
  }
  cp_async_commit();

  // the decay vectors of this group's heads, while the copies fly: lane l
  // holds steps l * kPer .. l * kPer + kPer - 1
  constexpr int kPer = Q / 32;
  for (int hh = warp; hh < hpg; hh += kPrepThreads / 32) {
    const int h = g * hpg + hh;
    const float* dtg = a.dt + b * a.dt_sb + h * a.dt_sh;
    const float ah = a.a[h];
    float dtv[kPer], cum[kPer];
    float run = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int s = s0 + lane * kPer + u;
      dtv[u] = s < a.S ? dtg[(long long)s * a.dt_ss] : 0.f;
      run += dtv[u] * ah;
      cum[u] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const float excl = incl - run;
    const float total = __shfl_sync(0xffffffffu, incl, 31);
    float* vg = a.vec_ws + (((long long)b * nc + c) * a.H + h) * 4 * Q;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = lane * kPer + u;
      const float ci = excl + cum[u];
      vg[i] = ci;
      vg[Q + i] = dtv[u] * __expf(total - ci);
      vg[2 * Q + i] = __expf(ci);
      vg[3 * Q + i] = dtv[u];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // tiles of 16 rows i x 8 columns j on or below the diagonal:
  // tile row it holds 2 * it + 2 of them
  constexpr int kIT = Q / 16;
  constexpr int kTiles = kIT * (kIT + 1);
  float* cbg = a.cb_ws + (((long long)b * nc + c) * a.G + g) * Q * Q;
  for (int tau = warp; tau < kTiles; tau += kPrepThreads / 32) {
    int it = 0;
    while ((it + 1) * (it + 2) <= tau) ++it;
    const int i0 = 16 * it, j0 = 8 * (tau - it * (it + 1));
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (sizeof(T) == 2) {
#pragma unroll 4
      for (int k0 = 0; k0 < N; k0 += 16) {
        const T* c0 = cs + (i0 + gq) * kLd + k0 + 2 * t;
        const T* b0 = bs + (j0 + gq) * kLd + k0 + 2 * t;
        const uint32_t af[4] = {
            *reinterpret_cast<const uint32_t*>(c0),
            *reinterpret_cast<const uint32_t*>(c0 + 8 * kLd),
            *reinterpret_cast<const uint32_t*>(c0 + 8),
            *reinterpret_cast<const uint32_t*>(c0 + 8 * kLd + 8)};
        mma_bf16(acc, af, *reinterpret_cast<const uint32_t*>(b0),
                 *reinterpret_cast<const uint32_t*>(b0 + 8));
      }
    } else {
#pragma unroll 4
      for (int k0 = 0; k0 < N; k0 += 8) {
        // k order within the step: fragment k t, t + 4 = columns 2t, 2t+1
        const float2 u = ld_pair(cs + (i0 + gq) * kLd + k0 + 2 * t);
        const float2 v = ld_pair(cs + (i0 + gq + 8) * kLd + k0 + 2 * t);
        const float2 w = ld_pair(bs + (j0 + gq) * kLd + k0 + 2 * t);
        uint32_t ah[4], al[4], bh[2], bl[2];
        split_tf32(u.x, ah[0], al[0]);
        split_tf32(v.x, ah[1], al[1]);
        split_tf32(u.y, ah[2], al[2]);
        split_tf32(v.y, ah[3], al[3]);
        split_tf32(w.x, bh[0], bl[0]);
        split_tf32(w.y, bh[1], bl[1]);
        mma_split<false, false>(acc, ah, al, bh, bl);
      }
    }
    *reinterpret_cast<float2*>(cbg + (i0 + gq) * Q + j0 + 2 * t) =
        make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(cbg + (i0 + gq + 8) * Q + j0 + 2 * t) =
        make_float2(acc[2], acc[3]);
  }
}

template <typename T, int N, int Q>
constexpr int prep_smem() {
  return 2 * Q * (N + 8) * static_cast<int>(sizeof(T));
}

// ---------------------------------------------------------------------------
// Pass 2: the chunks of one (sequence, head, row tile) in order
// ---------------------------------------------------------------------------

template <typename T, int N, int Q_, int WP, int NS>
struct SsdCfg {
  static constexpr int Q = Q_;
  static constexpr int PT = 16 * WP;            // state rows a block
  static constexpr int kWarps = WP * NS;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int NW = N / NS;             // state columns a warp
  static constexpr int kNT = NW / 8;
  static constexpr int kQT = Q / 8;
  static constexpr int E = 16 / sizeof(T);
  // row pitches (elements) that put each fragment load on distinct banks
  static constexpr int kLdX = PT + E;           // x [Q][kLdX]
  static constexpr int kLdB = N + E;            // B [Q][kLdB]
  static constexpr int kLdC = N + 8;            // C [Q][kLdC]
  static constexpr int kLdCB = Q + 8;           // C B^T [Q][kLdCB] fp32
  static constexpr int kLdY = PT + 4;           // y [NS][Q][kLdY] fp32
  static constexpr int kXBytes = Q * kLdX * sizeof(T);
  static constexpr int kBBytes = Q * kLdB * sizeof(T);
  static constexpr int kCBytes = Q * kLdC * sizeof(T);
  static constexpr int kCBBytes = Q * kLdCB * 4;
  static constexpr int kVecBytes = 4 * Q * 4;
  static constexpr int kStage =
      kXBytes + kBBytes + kCBytes + kCBBytes + kVecBytes;
  static constexpr int kYBytes = NS * Q * kLdY * 4;
  static constexpr int kSmem = 2 * kStage + kYBytes;
  static_assert(NW % 8 == 0, "whole n8 tiles a warp");
  static_assert(kXBytes % 16 == 0 && kBBytes % 16 == 0 && kCBytes % 16 == 0,
                "16-byte aligned regions");
  static_assert(kSmem <= 232448, "shared memory a block may use");
};

// The warp (of NS sharing rows) that takes causal i tile it of x^T . M^T:
// a snake over the tiles, so the slots' work (it + 1 blocks of j each)
// is even.
template <int NS>
__device__ __forceinline__ int intra_slot(int it) {
  return (it / NS) % 2 == 0 ? it % NS : NS - 1 - it % NS;
}

template <typename T, int N, int Q_, int WP, int NS>
__global__ void __launch_bounds__(SsdCfg<T, N, Q_, WP, NS>::kThreads, 1)
ssd_chunk_kernel(const SsdArgs a) {
  using C = SsdCfg<T, N, Q_, WP, NS>;
  constexpr int Q = C::Q, PT = C::PT, NW = C::NW, kNT = C::kNT;
  constexpr int kQT = C::kQT, E = C::E, kThreads = C::kThreads;
  constexpr bool kX = sizeof(T) == 2;  // x, B, C exact in tf32
  extern __shared__ __align__(16) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem + 2 * C::kStage);

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int g = h / (a.H / a.G);
  const int p0 = blockIdx.x * PT;
  const int nc = (a.S + Q - 1) / Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wpi = warp % WP, nsi = warp / WP;
  const int pw = 16 * wpi;  // the warp's first row in the block tile
  const int nw = nsi * NW;  // the warp's first state column

  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const T* bg = static_cast<const T*>(a.bm) + b * a.b_sb + g * a.b_sg;
  const T* cg = static_cast<const T*>(a.cm) + b * a.c_sb + g * a.c_sg;
  T* yg = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh;
  const int xbytes = min(PT, a.P - p0) * static_cast<int>(sizeof(T));

  auto load_stage = [&](int stage, int c) {
    unsigned char* st = smem + stage * C::kStage;
    T* xs = reinterpret_cast<T*>(st);
    T* bs = reinterpret_cast<T*>(st + C::kXBytes);
    T* cs = reinterpret_cast<T*>(st + C::kXBytes + C::kBBytes);
    float* cbs =
        reinterpret_cast<float*>(st + C::kXBytes + C::kBBytes + C::kCBytes);
    float* vs = cbs + Q * C::kLdCB;
    const int s0 = c * Q;
    constexpr int kXCh = PT / E;
    for (int e = tid; e < Q * kXCh; e += kThreads) {
      const int r = e / kXCh, ch = e - (e / kXCh) * kXCh;
      const int s = s0 + r;
      const int nb = s < a.S ? max(0, min(16, xbytes - 16 * ch)) : 0;
      cp_async16(xs + r * C::kLdX + ch * E,
                 nb ? xg + (long long)s * a.x_ss + p0 + ch * E : xg, nb);
    }
    constexpr int kNCh = N / E;
    for (int e = tid; e < Q * kNCh; e += kThreads) {
      const int r = e / kNCh, ch = e - (e / kNCh) * kNCh;
      const int s = s0 + r;
      const bool in = s < a.S;
      cp_async16(bs + r * C::kLdB + ch * E,
                 in ? bg + (long long)s * a.b_ss + ch * E : bg, in ? 16 : 0);
      cp_async16(cs + r * C::kLdC + ch * E,
                 in ? cg + (long long)s * a.c_ss + ch * E : cg, in ? 16 : 0);
    }
    const float* cbg = a.cb_ws + (((long long)b * nc + c) * a.G + g) * Q * Q;
    for (int e = tid; e < Q * Q / 4; e += kThreads) {
      const int r = e / (Q / 4), c4 = 4 * (e - (e / (Q / 4)) * (Q / 4));
      cp_async16(cbs + r * C::kLdCB + c4, cbg + r * Q + c4, 16);
    }
    const float* vg = a.vec_ws + (((long long)b * nc + c) * a.H + h) * 4 * Q;
    for (int e = tid; e < Q; e += kThreads)
      cp_async16(vs + 4 * e, vg + 4 * e, 16);
  };

  // the state: accumulator tiles of (rows pw + gq, + 8) x (columns
  // nw + 8 nt + 2t, + 1)
  float st[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + pw + gq + 8 * (e >> 1);
      const int n = nw + 8 * nt + 2 * t + (e & 1);
      st[nt][e] = (a.init_state != nullptr && p < a.P)
                      ? a.init_state[b * a.is_sb + h * a.is_sh +
                                     (long long)p * N + n]
                      : 0.f;
    }

  load_stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int cur = c & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed; chunk c - 1 fully consumed
    if (c + 1 < nc) load_stage(cur ^ 1, c + 1);
    cp_async_commit();

    const unsigned char* stg = smem + cur * C::kStage;
    const T* xs = reinterpret_cast<const T*>(stg);
    const T* bs = reinterpret_cast<const T*>(stg + C::kXBytes);
    const T* cs = reinterpret_cast<const T*>(stg + C::kXBytes + C::kBBytes);
    const float* cbs = reinterpret_cast<const float*>(
        stg + C::kXBytes + C::kBBytes + C::kCBytes);
    const float* cums = cbs + Q * C::kLdCB;
    const float* wv = cums + Q;
    const float* ecum = cums + 2 * Q;
    const float* dtv = cums + 3 * Q;

    // y^T (rows p, columns q) = state . C^T over this warp's columns
    float yacc[kQT][4];
#pragma unroll
    for (int qt = 0; qt < kQT; ++qt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[qt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      // the accumulator tile as an A fragment: a0 (g, k t) = c0 (column 2t),
      // a1 (g + 8, t) = c2, a2 (g, t + 4) = c1 (column 2t + 1), a3 = c3
      uint32_t sh[4], sl[4];
      split_tf32(st[nt][0], sh[0], sl[0]);
      split_tf32(st[nt][2], sh[1], sl[1]);
      split_tf32(st[nt][1], sh[2], sl[2]);
      split_tf32(st[nt][3], sh[3], sl[3]);
      const int n0 = nw + 8 * nt + 2 * t;
#pragma unroll
      for (int qt = 0; qt < kQT; ++qt) {
        const float2 cv = ld_pair(cs + (8 * qt + gq) * C::kLdC + n0);
        uint32_t bh[2], bl[2];
        if constexpr (kX) {
          bh[0] = __float_as_uint(cv.x);
          bh[1] = __float_as_uint(cv.y);
        } else {
          split_tf32(cv.x, bh[0], bl[0]);
          split_tf32(cv.y, bh[1], bl[1]);
        }
        mma_split<false, kX>(yacc[qt], sh, sl, bh, bl);
      }
    }
#pragma unroll
    for (int qt = 0; qt < kQT; ++qt) {
      const float e0 = ecum[8 * qt + 2 * t], e1 = ecum[8 * qt + 2 * t + 1];
      yacc[qt][0] *= e0;
      yacc[qt][1] *= e1;
      yacc[qt][2] *= e0;
      yacc[qt][3] *= e1;
    }
    const float etot = ecum[Q - 1];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] *= etot;

    // 8 steps j at a time: y^T += x^T . M^T (this warp's i tiles), then
    // state += (x o w)^T . B
#pragma unroll
    for (int jb = 0; jb < kQT; ++jb) {
      const int j0 = 8 * jb + 2 * t;  // fragment k t, t + 4 = j0, j0 + 1
      const T* xr0 = xs + j0 * C::kLdX + pw + gq;
      const T* xr1 = xr0 + C::kLdX;
      const float xv[4] = {to_f(xr0[0]), to_f(xr0[8]), to_f(xr1[0]),
                           to_f(xr1[8])};
      uint32_t xh[4], xl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kX)
          xh[e] = __float_as_uint(xv[e]);
        else
          split_tf32(xv[e], xh[e], xl[e]);
      }
#pragma unroll
      for (int it = jb; it < kQT; ++it) {
        if (intra_slot<NS>(it) != nsi) continue;
        // M[i][j] = (C B^T)[i][j] exp(cums_i - cums_j) dt_j for this lane's
        // i = 8 it + g, j = j0, j0 + 1; 0 above the diagonal, masked before
        // the exp (only the diagonal tile it == jb has such j)
        const int i = 8 * it + gq;
        const float2 cb =
            *reinterpret_cast<const float2*>(cbs + i * C::kLdCB + j0);
        const float ci = cums[i];
        const bool in0 = it > jb || j0 <= i, in1 = it > jb || j0 + 1 <= i;
        const float m0 =
            in0 ? cb.x * __expf(ci - cums[j0]) * dtv[j0] : 0.f;
        const float m1 =
            in1 ? cb.y * __expf(ci - cums[j0 + 1]) * dtv[j0 + 1] : 0.f;
        uint32_t mh[2], ml[2];
        split_tf32(m0, mh[0], ml[0]);
        split_tf32(m1, mh[1], ml[1]);
        mma_split<kX, false>(yacc[it], xh, xl, mh, ml);
      }
      const float w0 = wv[j0], w1 = wv[j0 + 1];
      uint32_t wh[4], wl[4];
      split_tf32(xv[0] * w0, wh[0], wl[0]);
      split_tf32(xv[1] * w0, wh[1], wl[1]);
      split_tf32(xv[2] * w1, wh[2], wl[2]);
      split_tf32(xv[3] * w1, wh[3], wl[3]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const T* bc = bs + j0 * C::kLdB + nw + 8 * nt + gq;
        const float bv0 = to_f(bc[0]), bv1 = to_f(bc[C::kLdB]);
        uint32_t bh[2], bl[2];
        if constexpr (kX) {
          bh[0] = __float_as_uint(bv0);
          bh[1] = __float_as_uint(bv1);
        } else {
          split_tf32(bv0, bh[0], bl[0]);
          split_tf32(bv1, bh[1], bl[1]);
        }
        mma_split<false, kX>(st[nt], wh, wl, bh, bl);
      }
    }

    // this warp's y partial to ys[nsi][q][p]
    float* yw = ys + nsi * Q * C::kLdY + pw + gq;
#pragma unroll
    for (int qt = 0; qt < kQT; ++qt) {
      const int q = 8 * qt + 2 * t;
      yw[q * C::kLdY] = yacc[qt][0];
      yw[(q + 1) * C::kLdY] = yacc[qt][1];
      yw[q * C::kLdY + 8] = yacc[qt][2];
      yw[(q + 1) * C::kLdY + 8] = yacc[qt][3];
    }
    __syncthreads();  // the partials are complete
    // y = the partials summed in slot order + d x, 4 columns a thread (P
    // is a multiple of 4 and y's rows start on 4 elements)
    const float dh = a.d[h];
    for (int e = tid; e < Q * PT / 4; e += kThreads) {
      const int q = e / (PT / 4), p = 4 * (e - (e / (PT / 4)) * (PT / 4));
      const int s = c * Q + q;
      if (s >= a.S || p0 + p >= a.P) continue;
      float4 v = *reinterpret_cast<const float4*>(ys + q * C::kLdY + p);
#pragma unroll
      for (int k = 1; k < NS; ++k) {
        const float4 u =
            *reinterpret_cast<const float4*>(ys + (k * Q + q) * C::kLdY + p);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      const T* xq = xs + q * C::kLdX + p;
      store4(yg + (long long)s * a.y_ss + p0 + p, v.x + dh * to_f(xq[0]),
             v.y + dh * to_f(xq[1]), v.z + dh * to_f(xq[2]),
             v.w + dh * to_f(xq[3]));
    }
  }

  if (a.state_out != nullptr) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = p0 + pw + gq + 8 * r;
        if (p < a.P)
          *reinterpret_cast<float2*>(
              a.state_out + b * a.so_sb + h * a.so_sh + (long long)p * N +
              nw + 8 * nt + 2 * t) = make_float2(st[nt][2 * r],
                                                 st[nt][2 * r + 1]);
      }
  }
}

template <typename T, int N, int Q, int WP, int NS>
int launch_cfg(const SsdArgs& a, cudaStream_t stream) {
  using C = SsdCfg<T, N, Q, WP, NS>;
  const int nc = (a.S + Q - 1) / Q;
  constexpr int prep_bytes = prep_smem<T, N, Q>();
  ssd_prep_kernel<T, N, Q>
      <<<dim3(nc, a.B * a.G), kPrepThreads, prep_bytes, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(ssd_chunk_kernel<T, N, Q, WP, NS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.P + C::PT - 1) / C::PT, a.B * a.H);
  ssd_chunk_kernel<T, N, Q, WP, NS>
      <<<grid, C::kThreads, C::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the plan's two block shapes: 64 rows (4 x 2 warps) where the (sequence,
// head) pairs fill half the card, else 16 rows (1 x 8 warps; N 16: 1 x 2)
template <typename T, int N>
int launch_n(const SsdArgs& a, cudaStream_t stream) {
  constexpr int kSmallNS = N >= 64 ? 8 : 2;
  if (a.q != kChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (a.wp == 4 && a.ns == 2) return launch_cfg<T, N, kChunk, 4, 2>(a, stream);
  if (a.wp == 1 && a.ns == kSmallNS)
    return launch_cfg<T, N, kChunk, 1, kSmallNS>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const SsdArgs& a, cudaStream_t stream) {
  switch (a.N) {
    // the configs' d_state: 16 (reduced), 64 (zamba2), 128 (mamba2)
    case 16: return launch_n<T, 16>(a, stream);
    case 64: return launch_n<T, 64>(a, stream);
    case 128: return launch_n<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rt_ssd_chunk_scan(const SsdArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->G <= 0 || a->H % a->G != 0 || a->S <= 0 || a->P <= 0 ||
      a->B * a->H > 65535 || a->B * a->G > 65535 ||
      a->cb_ws == nullptr || a->vec_ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return a->dtype ? launch<__nv_bfloat16>(*a, s) : launch<float>(*a, s);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
