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
//     the tiled kernel below with the batch on grid z.
//   * rt_stream_matmul: one (M, K) @ (K, N) product, a shared-memory tiled
//     GEMM: 64x64 output tiles, K in steps of 16, a 4x4 fp32 register tile
//     per thread, ragged M/K/N edges masked in the kernel (zeros loaded past
//     the edge, stores masked). Large products are bound by operations:
//     this kernel runs on the fp32 CUDA cores (bf16 inputs are widened in
//     shared memory). Not done yet: tensor cores (mma.sync / wgmma), TMA,
//     a multi-stage copy pipeline.

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

bool bad_shape(long long G, int M, int K, int N) {
  return G <= 0 || M <= 0 || K <= 0 || N <= 0;
}

}  // namespace

// a (M, K), b (K, N), c (M, N), all contiguous row-major; dtype 0: float32,
// 1: bfloat16. Returns a cudaError_t code (0: launched).
extern "C" int rt_stream_matmul(const void* a, const void* b, void* c, int M,
                                int K, int N, int dtype, void* stream) {
  if (bad_shape(1, M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_tiled<__nv_bfloat16>(a, b, c, 1, M, K, N, s)
               : launch_tiled<float>(a, b, c, 1, M, K, N, s);
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
