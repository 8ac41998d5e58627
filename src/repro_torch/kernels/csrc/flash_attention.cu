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
// What the design does about it:
//   * one block per (sequence, query head, 64-query tile); 4 warps each own
//     16 query rows and keep their m, l and fp32 accumulators in registers
//     (the Pallas grid carried them in VMEM scratch across its kv axis);
//   * the key loop runs inside the block over 32-key tiles staged in shared
//     memory (K padded to D+1 floats a row so the per-lane row reads are
//     conflict-free), and its bounds come from the causal band and the
//     window, so tiles outside the band are never loaded; rows of a warp
//     skip a tile that lies wholly outside their own band;
//   * a lane scores one key of the tile, the warp reduces max and sum with
//     shuffles, and P·V broadcasts each key's probability to the lanes that
//     own the head-dim elements.
// Not done yet: tensor cores (mma.sync / wgmma), TMA, bf16 staging; this
// kernel runs on the fp32 CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
  int dtype;  // 0: float32, 1: bfloat16
};

namespace {

constexpr int kBQ = 64;     // query rows per block
constexpr int kBK = 32;     // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;

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

template <int DPL>
constexpr int smem_bytes() {
  return (kBQ * 32 * DPL + kBK * (32 * DPL + 1) + kBK * 32 * DPL) *
         static_cast<int>(sizeof(float));
}

template <typename T, int DPL>
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
  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* og = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;

  for (int e = threadIdx.x; e < kBQ * D; e += blockDim.x) {
    const int r = e / D;
    const int d = e - r * D;
    const int qi = q0 + r;
    qs[e] = qi < a.S ? to_f(qg[qi * a.q_ss + d]) * a.scale : 0.f;
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
      ks[r * (D + 1) + d] = in ? to_f(kg[ki * a.k_ss + d]) : 0.f;
      vs[r * D + d] = in ? to_f(vg[ki * a.v_ss + d]) : 0.f;
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
        og[qp * a.o_ss + lane + 32 * i] = from_f<T>(acc[rr][i] * inv);
    }
  }
}

template <typename T, int DPL>
int launch_d(const FlashArgs& a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DPL>();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.Hq);
  flash_kernel<T, DPL><<<grid, kWarps * 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const FlashArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 32: return launch_d<T, 1>(a, stream);
    case 64: return launch_d<T, 2>(a, stream);
    case 128: return launch_d<T, 4>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rt_flash_attention(const FlashArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->Hkv <= 0 || a->Hq % a->Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return a->dtype ? launch<__nv_bfloat16>(*a, s) : launch<float>(*a, s);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
