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
// What bounds it on this card: at mamba2-370m's width (P = 64, N = 128) a
// token of one head costs 4*P*N = 32 KFLOP for a few hundred bytes of x, B,
// C and y, so the arithmetic dominates whenever it runs on the fp32 CUDA
// cores (bytes bound it only on tensor cores). What the design does:
//   * On CUDA cores the plain recurrence needs fewer operations than the
//     chunked form (per token and head 3*P*N FP32 instructions against
//     Q*N + Q*P/2 + 2*P*N multiply-adds for a chunk of Q, plus exps of the
//     Q x Q segment sums), and it needs no Q x Q matrix and no masked
//     exp(cums_i - cums_j) at all (whose upper triangle overflows). The
//     chunked form pays off with tensor cores (wgmma), which come later.
//   * The state never leaves registers: L lanes share one row p of the
//     state (L = 8, or 4 for N = 16), each holding N/L of its columns
//     (n = 4Lk + 4r + i for lane r of the L, so a float4 read of B_t or C_t
//     from shared memory by the L lanes covers 16L contiguous bytes: no
//     bank conflicts). A warp holds 32/L rows; y_t[p] is a sum over the L
//     lanes (log2 L shuffles). At N = 128 a lane holds 16 state values, so
//     mamba2-370m's B = 4 prefill runs 2,048 warps, twice as many as with
//     4 lanes a row, to hide the step's latencies.
//   * Rows are independent along P, so the grid is (P / rows, B * H): the
//     wrapper picks rows in {32, 16, 8} so that at least two blocks per SM
//     exist where the batch allows (B = 1 gives only 32 (sequence, head)
//     pairs on 132 SMs).
//   * The sequence is swept in sub-chunks (32 steps in bf16, 16 in fp32:
//     the same bytes). B and C of a sub-chunk (shared by the heads of a
//     group: the layer passes them once, not expanded per head), x of the
//     block's rows and dt are copied to shared memory with cp.async, in the
//     input dtype, two stages deep: the next sub-chunk's copies are in
//     flight while this one computes, so a block with one or two warps
//     (small batches) does not wait on them. The sub-chunk's y is
//     gathered in shared memory and written back with coalesced stores. Any S works: the last sub-chunk is short (the
//     layer's dt = 0 padding is not needed).
//   * The inputs are read through their strides, so the layer passes views
//     of its (B, S, conv_channels) activation without copies; heads map to
//     groups as h / (H / G).
// Not done yet: tensor cores (the chunked form with wgmma), TMA, sharing
// one staged B/C sub-chunk between the blocks of several heads, and
// splitting long sequences across blocks (two-pass chunk states) for
// small batches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
  long long is_sb, is_sh;
  long long so_sb, so_sh;
  int B, S, H, G, P, N;
  int rows;                // state rows a block holds (8, 16 or 32)
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

// four consecutive values from shared memory, widened to fp32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// cp.async: global -> shared without staging in registers. The 16-byte
// form reads src_bytes (0..16) and zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Steps a sub-chunk: 32 in bf16, 16 in fp32 (the same bytes a stage).
template <typename T>
__host__ __device__ constexpr int steps() {
  return 64 / static_cast<int>(sizeof(T));
}

// One pipeline stage: B and C [Qc][N], x [Qc][rows] in the input dtype,
// dt [Qc] fp32. Every region is a multiple of 16 bytes.
template <typename T>
__host__ __device__ inline int stage_bytes(int N, int rows) {
  return steps<T>() * (2 * N + rows) * static_cast<int>(sizeof(T)) +
         steps<T>() * static_cast<int>(sizeof(float));
}

template <typename T>
inline int smem_bytes(int N, int rows) {
  return 2 * stage_bytes<T>(N, rows) +
         steps<T>() * rows * static_cast<int>(sizeof(float));  // y
}

// Start the copies of sub-chunk [c0, c0 + nt) into one stage.
template <typename T, int N>
__device__ __forceinline__ void load_stage(
    const SsdArgs& a, unsigned char* st, int rows, int c0, int nt, int p0,
    const T* xg, const float* dtg, const T* bg, const T* cg) {
  constexpr int Qc = steps<T>();
  constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
  constexpr int kRowVecs = N / kPer16;          // 16-byte vectors a B row
  T* bs = reinterpret_cast<T*>(st);
  T* cs = bs + Qc * N;
  T* xs = cs + Qc * N;
  float* dts = reinterpret_cast<float*>(xs + Qc * rows);
  for (int e = threadIdx.x; e < nt * kRowVecs; e += blockDim.x) {
    const int t = e / kRowVecs;
    const int v = (e - t * kRowVecs) * kPer16;
    const long long g = (long long)(c0 + t);
    cp_async16(bs + t * N + v, bg + g * a.b_ss + v, 16);
    cp_async16(cs + t * N + v, cg + g * a.c_ss + v, 16);
  }
  const int xvecs = rows / kPer16;
  const int valid = min(rows, a.P - p0) * static_cast<int>(sizeof(T));
  for (int e = threadIdx.x; e < nt * xvecs; e += blockDim.x) {
    const int t = e / xvecs;
    const int v = e - t * xvecs;
    const int bytes = max(0, min(16, valid - 16 * v));
    const T* src = xg + (long long)(c0 + t) * a.x_ss + p0 + v * kPer16;
    cp_async16(xs + t * rows + v * kPer16, bytes ? src : xg, bytes);
  }
  for (int t = threadIdx.x; t < nt; t += blockDim.x)
    cp_async4(dts + t, dtg + (long long)(c0 + t) * a.dt_ss);
}

// L lanes a state row, each holding 4 * K columns: N = 4 * K * L.
template <typename T, int K, int L>
__global__ void __launch_bounds__(256)
ssd_kernel(const SsdArgs a) {
  constexpr int N = 4 * K * L;
  constexpr int Qc = steps<T>();
  const int rows = a.rows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sbytes = stage_bytes<T>(N, rows);
  float* ys = reinterpret_cast<float*>(smem + 2 * sbytes);  // [Qc][rows]

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int g = h / (a.H / a.G);
  const int p0 = blockIdx.x * rows;
  const int lane = threadIdx.x & 31;
  const int r = lane % L;                               // column slot
  const int row = (threadIdx.x >> 5) * (32 / L) + lane / L;  // block row
  const int p = p0 + row;
  const bool live = p < a.P;
  const float decay = a.a[h];
  const float skip = a.d[h];

  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const float* dtg = a.dt + b * a.dt_sb + h * a.dt_sh;
  const T* bg = static_cast<const T*>(a.bm) + b * a.b_sb + g * a.b_sg;
  const T* cg = static_cast<const T*>(a.cm) + b * a.c_sb + g * a.c_sg;
  T* yg = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh;

  float s[4 * K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      if (a.init_state != nullptr && live)
        v = a.init_state[b * a.is_sb + h * a.is_sh + (long long)p * N +
                         4 * L * k + 4 * r + i];
      s[4 * k + i] = v;
    }
  }

  load_stage<T, N>(a, smem, rows, 0, min(Qc, a.S), p0, xg, dtg, bg, cg);
  cp_async_commit();
  for (int c0 = 0, stage = 0; c0 < a.S; c0 += Qc, stage ^= 1) {
    const int nt = min(Qc, a.S - c0);
    // the other stage was last read before the previous write-out's
    // barrier: refill it with the next sub-chunk while this one computes
    if (c0 + Qc < a.S) {
      load_stage<T, N>(a, smem + (stage ^ 1) * sbytes, rows, c0 + Qc,
                       min(Qc, a.S - c0 - Qc), p0, xg, dtg, bg, cg);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this sub-chunk's copies are visible to all

    const T* bs = reinterpret_cast<const T*>(smem + stage * sbytes);
    const T* cs = bs + Qc * N;
    const T* xs = cs + Qc * N;
    const float* dts = reinterpret_cast<const float*>(xs + Qc * rows);
    // unrolled by two: one step's y reduction (a chain of FMAs, two
    // shuffles) overlaps the next step's state update
#pragma unroll 2
    for (int t = 0; t < nt; ++t) {
      const float dtv = dts[t];
      const float da = __expf(dtv * decay);
      const float xv = to_f(xs[t * rows + row]);
      const float dtx = xv * dtv;
      const T* bt = bs + t * N + 4 * r;
      const T* ct = cs + t * N + 4 * r;
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 bv = ld4(bt + 4 * L * k);
        const float4 cv = ld4(ct + 4 * L * k);
        s[4 * k + 0] = fmaf(dtx, bv.x, s[4 * k + 0] * da);
        s[4 * k + 1] = fmaf(dtx, bv.y, s[4 * k + 1] * da);
        s[4 * k + 2] = fmaf(dtx, bv.z, s[4 * k + 2] * da);
        s[4 * k + 3] = fmaf(dtx, bv.w, s[4 * k + 3] * da);
        acc0 = fmaf(s[4 * k + 0], cv.x, acc0);
        acc1 = fmaf(s[4 * k + 1], cv.y, acc1);
        acc2 = fmaf(s[4 * k + 2], cv.z, acc2);
        acc3 = fmaf(s[4 * k + 3], cv.w, acc3);
      }
      float acc = (acc0 + acc1) + (acc2 + acc3);
#pragma unroll
      for (int o = 1; o < L; o <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (r == 0) ys[t * rows + row] = acc + skip * xv;
    }
    __syncthreads();  // ys complete; this stage's inputs consumed
    for (int e = threadIdx.x; e < nt * rows; e += blockDim.x) {
      const int t = e / rows;
      const int j = e - t * rows;
      if (p0 + j < a.P)
        yg[(long long)(c0 + t) * a.y_ss + p0 + j] = from_f<T>(ys[e]);
    }
  }

  if (a.state_out != nullptr && live) {
    float* so = a.state_out + b * a.so_sb + h * a.so_sh + (long long)p * N;
#pragma unroll
    for (int k = 0; k < K; ++k)
      *reinterpret_cast<float4*>(so + 4 * L * k + 4 * r) =
          make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
  }
}

template <typename T, int K, int L>
int launch_n(const SsdArgs& a, cudaStream_t stream) {
  const int bytes = smem_bytes<T>(4 * K * L, a.rows);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T, K, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.P + a.rows - 1) / a.rows, a.B * a.H);
  ssd_kernel<T, K, L><<<grid, a.rows * L, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const SsdArgs& a, cudaStream_t stream) {
  switch (a.N) {
    // the configs' d_state: 16 (reduced), 64 (zamba2), 128 (mamba2)
    case 16: return launch_n<T, 1, 4>(a, stream);
    case 64: return launch_n<T, 2, 8>(a, stream);
    case 128: return launch_n<T, 4, 8>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rt_ssd_chunk_scan(const SsdArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->G <= 0 || a->H % a->G != 0 ||
      (a->rows != 8 && a->rows != 16 && a->rows != 32) ||
      a->B * a->H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return a->dtype ? launch<__nv_bfloat16>(*a, s) : launch<float>(*a, s);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
