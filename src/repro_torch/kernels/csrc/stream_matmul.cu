// Streaming matrix multiply for Hopper (sm_90a): C = A @ B with fp32
// accumulation, output in A's dtype (float32 or bfloat16 inputs, A and B of
// one dtype).
//
// Replaces the Pallas TPU kernel stream_matmul (_mm_kernel) and its vmap
// stream_matmul_batched in src/repro/kernels/stream_matmul.py: the paper's
// section V user core, which RC3E streams 100,000 small (16x16 or 32x32)
// products through. The Pallas wrapper pads each product up to MXU-aligned
// (bm, 128) x (128, 128) tiles with jnp.pad; nothing here is padded.
//
// Two entry points:
//   * rt_stream_matmul_batched: (G, S, S) @ (G, S, S) in one launch, G on
//     the grid. What bounds it: bytes. A 16x16 product does 2*16^3 flops on
//     3*16^2*4 bytes (2.7 flop/byte), a 32x32 one 5.3 flop/byte, both far
//     below the ~20 flop/byte where the H100's 67 TFLOP/s of fp32 FMA would
//     be the limit. What the design does about it: each block takes MPB
//     whole matrices (16 of 16x16, 4 of 32x32: 32 KB of fp32 A and B),
//     loads them with coalesced reads of contiguous memory into shared
//     memory (A rows padded by one word, so the column walk is free of bank
//     conflicts), and every thread computes a 4x4 register tile of one
//     output matrix from two shared-memory reads per 16 FMAs; the output is
//     written once. S is a template parameter (16 and 32); other sizes take
//     the CUDA-core tiled kernel (tiled_kernel: 64x64 tiles, K in steps of
//     16, a 4x4 register tile a thread) with the batch on grid z.
//   * rt_stream_matmul: one (M, K) @ (K, N) product on the tensor cores
//     (mm_kernel). What bounds it: operations for large products (4096^3:
//     137 GFLOP on 100 MB in bf16), latency for the path's 129x257x65
//     (4.3 MFLOP; a chain of dependent copies and a launch). The design:
//       - 128x128 block tiles, 8 warps of 64x32 (2 along M, 4 along N);
//       - bf16: mma.sync.m16n8k16 with fp32 accumulators; A fragments by
//         ldmatrix, B by ldmatrix.trans, from tiles whose 16-byte chunks
//         are XOR-swizzled by row & 7 (each 8-row ldmatrix phase hits 8
//         bank groups); 64-deep k tiles, 3 stages of cp.async; two blocks
//         an SM (one where bf16 rows are not 16-byte aligned: their element
//         loads need registers);
//       - fp32: 3xTF32 on mma.sync.m16n8k8 (x = hi + lo, both TF32; each
//         product lo*hi + hi*lo + hi*hi). Each element is split ONCE, by the
//         thread that copied it, from its cp.async stage into a split tile
//         of float4 (hi, lo of two k neighbours), so every fragment is one
//         128-bit load and no warp re-splits what another warp reads (the
//         fp32 flash kernel re-splits per warp); the k order inside each
//         8-deep step is permuted (k 2t, 2t+1 for lanes' t, t + 4) so the
//         pairs sit side by side. A thread splits tile it + 1 while its
//         warp's mma.sync work on tile it (two split buffers, one barrier a
//         k tile); 16-deep k tiles, 4 raw stages; one block an SM;
//       - products with fewer output tiles than SMs split K over grid z
//         (the plan is computed in Python: stream_matmul.matmul_plan); each
//         split writes an fp32 partial tile to a workspace and a second
//         kernel sums the partials in split order (deterministic: no
//         atomics) and writes the output in A's dtype;
//       - rows that start on 16 bytes (A: K, B: N a multiple of 16 bytes)
//         are copied by 16-byte cp.async; other fp32 rows by 4-byte
//         cp.async, other bf16 rows by element loads; nothing past an edge
//         is read (zero-filled) or written;
//       - blocks walk the tiles in groups of 8 tile rows, so a wave's A and
//         B panels stay in L2.
//     Not done yet: wgmma and TMA (Hopper's own tensor-core path), a
//     persistent kernel whose epilogue overlaps the next tile's loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---------------------------------------------------------------------------
// Batched small products, S in {16, 32}
// ---------------------------------------------------------------------------

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
small_batched_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ c, long long G) {
  constexpr int kTile = 4;                           // 4x4 outputs a thread
  constexpr int kPerMat = (S / kTile) * (S / kTile);  // threads a matrix
  constexpr int MPB = kThreads / kPerMat;             // matrices a block
  constexpr int kElems = MPB * S * S;
  __shared__ float sa[MPB][S][S + 1];
  __shared__ __align__(16) float sb[MPB][S][S];

  const long long g0 = (long long)blockIdx.x * MPB;
  const int n_mat = (int)min((long long)MPB, G - g0);
  const long long base = g0 * S * S;
  const int n_el = n_mat * S * S;
  for (int i = threadIdx.x; i < kElems; i += kThreads) {
    const int m = i / (S * S);
    const int r = (i / S) % S;
    const int k = i % S;
    float va = 0.f, vb = 0.f;
    if (i < n_el) {
      va = to_f(a[base + i]);
      vb = to_f(b[base + i]);
    }
    sa[m][r][k] = va;
    sb[m][r][k] = vb;
  }
  __syncthreads();

  const int m = threadIdx.x / kPerMat;
  const int t = threadIdx.x % kPerMat;
  const int r0 = (t / (S / kTile)) * kTile;
  const int c0 = (t % (S / kTile)) * kTile;
  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float4 bv = *reinterpret_cast<const float4*>(&sb[m][k][c0]);
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const float av = sa[m][r0 + i][k];
      acc[i][0] += av * bv.x;
      acc[i][1] += av * bv.y;
      acc[i][2] += av * bv.z;
      acc[i][3] += av * bv.w;
    }
  }
  if (m >= n_mat) return;
  T* out = c + base + (long long)m * S * S;
#pragma unroll
  for (int i = 0; i < kTile; ++i) store4(out + (r0 + i) * S + c0, acc[i]);
}

// ---------------------------------------------------------------------------
// Tiled GEMM, any M, K, N; batch on grid z (grid-stride over G)
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int kPadA = 4;  // keeps float4 reads aligned, spreads the stores

template <typename T>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ c, int M, int K, int N, long long G,
             long long sa_g, long long sb_g, long long sc_g) {
  __shared__ __align__(16) float As[BK][BM + kPadA];  // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  for (long long g = blockIdx.z; g < G; g += gridDim.z) {
    const T* ag = a + g * sa_g;
    const T* bg = b + g * sb_g;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int u = 0; u < BM * BK / kThreads; ++u) {
        const int idx = threadIdx.x + u * kThreads;
        const int r = idx / BK, kk = idx % BK;
        const int gr = row0 + r, gk = k0 + kk;
        As[kk][r] = (gr < M && gk < K) ? to_f(ag[(long long)gr * K + gk])
                                       : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BK * BN / kThreads; ++u) {
        const int idx = threadIdx.x + u * kThreads;
        const int kk = idx / BN, cc = idx % BN;
        const int gk = k0 + kk, gc = col0 + cc;
        Bs[kk][cc] = (gk < K && gc < N) ? to_f(bg[(long long)gk * N + gc])
                                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
      }
      __syncthreads();
    }

    T* cg = c + g * sc_g;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + ty * 4 + i;
      if (gr >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gc = col0 + tx * 4 + j;
        if (gc < N) cg[(long long)gr * N + gc] = from_f<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch_tiled(const void* a, const void* b, void* c, long long G, int M,
                 int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM,
                  (unsigned)(G < 65535 ? G : 65535));
  tiled_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, K, N, G, (long long)M * K, (long long)K * N, (long long)M * N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int launch_small(const void* a, const void* b, void* c, long long G,
                 cudaStream_t stream) {
  constexpr int MPB = kThreads / ((S / 4) * (S / 4));
  const long long blocks = (G + MPB - 1) / MPB;
  small_batched_kernel<T, S><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int batched(const void* a, const void* b, void* c, long long G, int M, int K,
            int N, cudaStream_t stream) {
  if (M == K && K == N && M == 16)
    return launch_small<T, 16>(a, b, c, G, stream);
  if (M == K && K == N && M == 32)
    return launch_small<T, 32>(a, b, c, G, stream);
  return launch_tiled<T>(a, b, c, G, M, K, N, stream);
}

// ---------------------------------------------------------------------------
// 2-D product on the tensor cores (mm_kernel) and the split-K sum
// ---------------------------------------------------------------------------

constexpr int kMmBM = 128, kMmBN = 128;
constexpr int kMmGroupM = 8;         // tile rows walked together (L2 reuse)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async: 16 bytes (src_bytes 0 zero-fills) or 4 bytes (the same).
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src,
                                    int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// x = hi + lo with hi and lo both tf32 (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  const float r = x - __uint_as_float(h);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(r));
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

template <typename T>
struct MmCfg;

// bf16: 8 warps of 64 x 32 (2 along M, 4 along N); A [128][64] and
// B [64][128] tiles a stage, swizzled, 32 KB a stage.
template <>
struct MmCfg<__nv_bfloat16> {
  static constexpr int kWN = 32;
  static constexpr int kThreads = 256;
  static constexpr int kBK = 64;
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = 2;
  static constexpr int kStageBytes = (kMmBM * kBK + kBK * kMmBN) * 2;
  static constexpr int kSmem = kStages * kStageBytes;             // 96 KB
};

// fp32: 8 warps of 64 x 32 (2 along M, 4 along N); raw A [128][16] and
// B [16][128] a stage (16 KB), and two split
// tiles: A4 [128][kLdA4] float4 (hi, lo of k 2c, 2c+1), B4 [8][kLdB4]
// float4 (hi, lo of rows 2r, 2r+1). The pads put each quarter-warp's
// 128-bit fragment loads on 32 distinct banks.
template <>
struct MmCfg<float> {
  static constexpr int kWN = 32;     // 8 warps of 64 x 32 (2 x 4)
  static constexpr int kThreads = 256;
  static constexpr int kBK = 16;
  static constexpr int kStages = 4;
  static constexpr int kMinBlocks = 1;
  static constexpr int kLdA4 = kBK / 2 + 4;
  static constexpr int kLdB4 = kMmBN + 2;
  static constexpr int kStageBytes = (kMmBM * kBK + kBK * kMmBN) * 4;
  static constexpr int kSplitBytes =
      (kMmBM * kLdA4 + kBK / 2 * kLdB4) * 16;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kSplitBytes;
};

// Element offset of (row, 16-byte chunk) in a swizzled bf16 A / B tile:
// chunks XOR-swizzled by row & 7 within groups of 8.
__device__ __forceinline__ int swz_a(int r, int c) {
  return r * MmCfg<__nv_bfloat16>::kBK + ((c ^ (r & 7)) << 3);
}
__device__ __forceinline__ int swz_b(int r, int c) {
  return r * kMmBN + ((c ^ (r & 7)) << 3);
}

struct MmArgs {
  const void* a;
  const void* b;
  void* c;       // the output (n_split 1) or the fp32 workspace
  int M, K, N;
  int kt_per;    // k tiles a split
  int tiles_m, tiles_n;
};

// One 16-byte chunk of a tile: 8 bf16 or 4 fp32 elements of row `row`
// from column `col` (global), masked at the row's end `len` and at
// `rows`. kAligned: the chunk starts on 16 bytes and the row length is a
// multiple of the chunk, so it is either whole or past the edge.
template <typename T, bool kAligned>
__device__ __forceinline__ void load_chunk(T* dst, const T* base, long long ld,
                                           int row, int rows, int col,
                                           int len) {
  constexpr int E = 16 / sizeof(T);
  const bool in_row = row < rows;
  if constexpr (kAligned) {
    const bool in = in_row && col < len;
    cp16(dst, in ? base + (long long)row * ld + col : base, in ? 16 : 0);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const bool in = in_row && col + u < len;
      cp4(dst + u, in ? base + (long long)row * ld + col + u : base,
          in ? 4 : 0);
    }
  } else {
    // bf16 rows off 4-byte boundaries: element loads through registers
    uint16_t v[E];
    const uint16_t* src = reinterpret_cast<const uint16_t*>(base);
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const bool in = in_row && col + u < len;
      v[u] = in ? src[(long long)row * ld + col + u] : uint16_t(0);
    }
    uint4 w;
    w.x = v[0] | (uint32_t(v[1]) << 16);
    w.y = v[2] | (uint32_t(v[3]) << 16);
    w.z = v[4] | (uint32_t(v[5]) << 16);
    w.w = v[6] | (uint32_t(v[7]) << 16);
    *reinterpret_cast<uint4*>(dst) = w;
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* row, int col, int N, bool even,
                                           float x, float y) {
  if (even && col + 1 < N) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(row + col) = make_float2(x, y);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(row + col) =
          __floats2bfloat162_rn(x, y);
    }
    return;
  }
  if (col < N) row[col] = from_f<T>(x);
  if (col + 1 < N) row[col + 1] = from_f<T>(y);
}

// One block: one 128x128 output tile, k tiles [z * kt_per, ...) of split z.
// Writes T (one split) or an fp32 partial tile into the workspace at
// z * M * N.
template <typename T, bool kAligned, bool kSplit>
__global__ void __launch_bounds__(MmCfg<T>::kThreads,
                                  kAligned ? MmCfg<T>::kMinBlocks : 1)
mm_kernel(const MmArgs p) {
  using C = MmCfg<T>;
  constexpr int BK = C::kBK;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int E = 16 / sizeof(T);          // elements a 16-byte chunk
  constexpr int kMmThreads = C::kThreads;
  constexpr int kNT = C::kWN / 8;            // n8 tiles a warp
  extern __shared__ __align__(128) unsigned char smem[];

  // grouped tile order: kMmGroupM tile rows, column by column
  const int pid = blockIdx.x;
  const int per_group = kMmGroupM * p.tiles_n;
  const int first_m = (pid / per_group) * kMmGroupM;
  const int gsz = min(p.tiles_m - first_m, kMmGroupM);
  const int tm = first_m + (pid % per_group) % gsz;
  const int tn = (pid % per_group) / gsz;
  const int m0 = tm * kMmBM, n0 = tn * kMmBN;
  const int k_tiles = (p.K + BK - 1) / BK;
  const int kt0 = blockIdx.z * p.kt_per;
  const int n_kt = min(k_tiles, kt0 + p.kt_per) - kt0;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * C::kWN;
  const int g = lane >> 2, t = lane & 3;
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);

  // this thread's chunks: A four (bf16) / two (fp32), B four (bf16) / one
  // row pair (fp32)
  constexpr int kAChunks = kMmBM * BK / E / kMmThreads;
  constexpr int kBChunks = BK * kMmBN / E / kMmThreads;
  auto load_tile = [&](int stage, int kt) {
    T* as = reinterpret_cast<T*>(smem + stage * C::kStageBytes);
    T* bs = as + kMmBM * BK;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int e = tid + i * kMmThreads;
      const int r = e / (BK / E), c = e % (BK / E);
      T* dst = kBf16 ? as + swz_a(r, c) : as + r * BK + c * E;
      load_chunk<T, kAligned>(dst, A, p.K, m0 + r, p.M, k0 + c * E, p.K);
    }
    if constexpr (kBf16) {
#pragma unroll
      for (int i = 0; i < kBChunks; ++i) {
        const int e = tid + i * kMmThreads;
        const int r = e / (kMmBN / E), c = e % (kMmBN / E);
        load_chunk<T, kAligned>(bs + swz_b(r, c), B, p.N, k0 + r, p.K,
                                n0 + c * E, p.N);
      }
    } else {
      const int rp = tid / (kMmBN / E), c = tid % (kMmBN / E);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        load_chunk<T, kAligned>(bs + (2 * rp + h) * kMmBN + c * E, B, p.N,
                                k0 + 2 * rp + h, p.K, n0 + c * E, p.N);
    }
  };

  float acc[4][kNT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // fp32: split this thread's own chunks of tile `tile` (its cp.async
  // copies have landed) once into split buffer `buf`
  auto split_tile = [&](int tile, int buf) {
    if constexpr (!kBf16) {
      const float* as = reinterpret_cast<const float*>(
          smem + (tile % C::kStages) * C::kStageBytes);
      const float* bs = as + kMmBM * BK;
      float4* a4 = reinterpret_cast<float4*>(
          smem + C::kStages * C::kStageBytes + buf * C::kSplitBytes);
      float4* b4 = a4 + kMmBM * C::kLdA4;
#pragma unroll
      for (int i = 0; i < kAChunks; ++i) {
        const int e = tid + i * kMmThreads;
        const int r = e / (BK / 4), c = e % (BK / 4);
        const float4 v = *reinterpret_cast<const float4*>(as + r * BK + 4 * c);
        float h[4], l[4];
        split_tf32(v.x, h[0], l[0]);
        split_tf32(v.y, h[1], l[1]);
        split_tf32(v.z, h[2], l[2]);
        split_tf32(v.w, h[3], l[3]);
        a4[r * C::kLdA4 + 2 * c] = make_float4(h[0], l[0], h[1], l[1]);
        a4[r * C::kLdA4 + 2 * c + 1] = make_float4(h[2], l[2], h[3], l[3]);
      }
      const int rp = tid / (kMmBN / 4), c = tid % (kMmBN / 4);
      const float4 v0 =
          *reinterpret_cast<const float4*>(bs + 2 * rp * kMmBN + 4 * c);
      const float4 v1 =
          *reinterpret_cast<const float4*>(bs + (2 * rp + 1) * kMmBN + 4 * c);
      const float x0[4] = {v0.x, v0.y, v0.z, v0.w};
      const float x1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float h0, l0, h1, l1;
        split_tf32(x0[u], h0, l0);
        split_tf32(x1[u], h1, l1);
        b4[rp * C::kLdB4 + 4 * c + u] = make_float4(h0, l0, h1, l1);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_kt) load_tile(s, kt0 + s);
    cp_commit();
  }
  if constexpr (!kBf16) {
    cp_wait<C::kStages - 2>();
    split_tile(0, 0);
    __syncthreads();
  }

  for (int it = 0; it < n_kt; ++it) {
    const int nx = it + C::kStages - 1;
    if constexpr (kBf16) {
      cp_wait<C::kStages - 2>();  // tile it landed
      __syncthreads();            // ... for all; tile it - 1 consumed
      if (nx < n_kt) load_tile(nx % C::kStages, kt0 + nx);
      cp_commit();
      const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(
          smem + (it % C::kStages) * C::kStageBytes);
      const __nv_bfloat16* bs = as + kMmBM * BK;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[4][4], bf[kNT / 2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(af[mi], smem_u32(as + swz_a(wm + 16 * mi + (lane & 15),
                                              2 * kk + (lane >> 4))));
#pragma unroll
        for (int nj = 0; nj < kNT / 2; ++nj)
          ldsm_x4_t(bf[nj], smem_u32(bs + swz_b(16 * kk + (lane & 15),
                                                wn / 8 + 2 * nj +
                                                    (lane >> 4))));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < kNT / 2; ++nj) {
            mma_bf16(acc[mi][2 * nj], af[mi], bf[nj][0], bf[nj][1]);
            mma_bf16(acc[mi][2 * nj + 1], af[mi], bf[nj][2], bf[nj][3]);
          }
      }
    } else {
      // the raw stage of tile it - 1 was read by this thread's own split
      // (at it - 2): refill it. The mma.sync work on tile it is issued
      // first; then this thread waits for its copies of tile it + 1 and
      // splits them into the other buffer while the tensor cores run.
      if (nx < n_kt) load_tile(nx % C::kStages, kt0 + nx);
      cp_commit();
      const float4* a4 = reinterpret_cast<const float4*>(
          smem + C::kStages * C::kStageBytes + (it & 1) * C::kSplitBytes);
      const float4* b4 = a4 + kMmBM * C::kLdA4;
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const float4 u = a4[(wm + 16 * mi + g) * C::kLdA4 + 4 * ks + t];
          const float4 v = a4[(wm + 16 * mi + g + 8) * C::kLdA4 + 4 * ks + t];
          // a0 (g, k 2t), a1 (g + 8, 2t), a2 (g, 2t + 1), a3 (g + 8, 2t + 1)
          ah[mi][0] = __float_as_uint(u.x);
          ah[mi][1] = __float_as_uint(v.x);
          ah[mi][2] = __float_as_uint(u.z);
          ah[mi][3] = __float_as_uint(v.z);
          al[mi][0] = __float_as_uint(u.y);
          al[mi][1] = __float_as_uint(v.y);
          al[mi][2] = __float_as_uint(u.w);
          al[mi][3] = __float_as_uint(v.w);
        }
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const float4 u = b4[(4 * ks + t) * C::kLdB4 + wn + 8 * nj + g];
          bh[nj][0] = __float_as_uint(u.x);
          bh[nj][1] = __float_as_uint(u.z);
          bl[nj][0] = __float_as_uint(u.y);
          bl[nj][1] = __float_as_uint(u.w);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            mma_tf32(acc[mi][nj], al[mi], bh[nj]);
            mma_tf32(acc[mi][nj], ah[mi], bl[nj]);
            mma_tf32(acc[mi][nj], ah[mi], bh[nj]);
          }
      }
      if (it + 1 < n_kt) {
        cp_wait<C::kStages - 2>();
        split_tile(it + 1, (it + 1) & 1);
      }
      __syncthreads();  // buffer it & 1 consumed, buffer it + 1 complete
    }
  }
  cp_wait<0>();

  // epilogue: this lane's rows g, g + 8 of each m16 tile, columns 2t, 2t+1
  const bool even = (p.N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * mi + g + 8 * h;
      if (row >= p.M) continue;
#pragma unroll
      for (int nj = 0; nj < kNT; ++nj) {
        const int col = n0 + wn + 8 * nj + 2 * t;
        const float x = acc[mi][nj][2 * h], y = acc[mi][nj][2 * h + 1];
        if constexpr (kSplit) {
          float* ws = static_cast<float*>(p.c) +
                      (long long)blockIdx.z * p.M * p.N + (long long)row * p.N;
          store_pair<float>(ws, col, p.N, even, x, y);
        } else {
          store_pair<T>(static_cast<T*>(p.c) + (long long)row * p.N, col, p.N,
                        even, x, y);
        }
      }
    }
  }
}

// out[i] = sum over splits z = 0, 1, ... of ws[z][i], in that order.
template <typename T>
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ ws, T* __restrict__ out,
                 long long mn, int n_split) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
       i += (long long)gridDim.x * 256) {
    float s = 0.f;
    for (int z = 0; z < n_split; ++z) s += ws[z * mn + i];
    out[i] = from_f<T>(s);
  }
}

template <typename T, bool kAligned, bool kSplit>
int launch_mm_kernel(const MmArgs& p, int n_split, cudaStream_t stream) {
  constexpr int bytes = MmCfg<T>::kSmem;
  auto kern = mm_kernel<T, kAligned, kSplit>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.tiles_m * p.tiles_n, 1, n_split);
  kern<<<grid, MmCfg<T>::kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mm(const void* a, const void* b, void* c, float* ws, int M, int K,
              int N, int n_split, int kt_per, cudaStream_t stream) {
  const bool aligned =
      reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
      (long long)K * sizeof(T) % 16 == 0 && (long long)N * sizeof(T) % 16 == 0;
  const bool split = n_split > 1;
  MmArgs p{a, b, split ? static_cast<void*>(ws) : c, M, K, N, kt_per,
           (M + kMmBM - 1) / kMmBM, (N + kMmBN - 1) / kMmBN};
  int rc;
  if (aligned)
    rc = split ? launch_mm_kernel<T, true, true>(p, n_split, stream)
               : launch_mm_kernel<T, true, false>(p, n_split, stream);
  else
    rc = split ? launch_mm_kernel<T, false, true>(p, n_split, stream)
               : launch_mm_kernel<T, false, false>(p, n_split, stream);
  if (rc != 0 || !split) return rc;
  const long long mn = (long long)M * N;
  const long long blocks = mn / 256 + 1 < 4096 ? mn / 256 + 1 : 4096;
  split_sum_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      ws, static_cast<T*>(c), mn, n_split);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(long long G, int M, int K, int N) {
  return G <= 0 || M <= 0 || K <= 0 || N <= 0;
}

}  // namespace

// a (M, K), b (K, N), c (M, N), all contiguous row-major; dtype 0: float32,
// 1: bfloat16. K is split into n_split ranges of kt_per k tiles (16 deep in
// fp32, 64 in bf16); n_split > 1 needs ws, an fp32 workspace of
// n_split * M * N. Returns a cudaError_t code (0: launched).
extern "C" int rt_stream_matmul(const void* a, const void* b, void* c,
                                void* ws, int M, int K, int N, int dtype,
                                int n_split, int kt_per, void* stream) {
  const int bk = dtype ? MmCfg<__nv_bfloat16>::kBK : MmCfg<float>::kBK;
  const int k_tiles = (K + bk - 1) / bk;
  if (bad_shape(1, M, K, N) || n_split < 1 || n_split > 65535 ||
      kt_per < 1 || (long long)(n_split - 1) * kt_per >= k_tiles ||
      (long long)n_split * kt_per < k_tiles || (n_split > 1 && !ws))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  return dtype ? launch_mm<__nv_bfloat16>(a, b, c, w, M, K, N, n_split,
                                          kt_per, s)
               : launch_mm<float>(a, b, c, w, M, K, N, n_split, kt_per, s);
}

// a (G, M, K), b (G, K, N), c (G, M, N), all contiguous.
extern "C" int rt_stream_matmul_batched(const void* a, const void* b, void* c,
                                        long long G, int M, int K, int N,
                                        int dtype, void* stream) {
  if (bad_shape(G, M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? batched<__nv_bfloat16>(a, b, c, G, M, K, N, s)
               : batched<float>(a, b, c, G, M, K, N, s);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
