// Causal flash attention (prefill) for Hopper (sm_90a): GQA, blocked online
// softmax with an fp32 accumulator, optional sliding window and tanh logit
// softcap, ragged sequence lengths, head dims 32, 64, 96, 112, 128 and 256
// (compiled exactly) and any multiple of 8 from 264 to 512 (the 384 and 512
// builds read the true width in place; see "Head dims past 256" below).
//
// Replaces the Pallas TPU kernel flash_attention (_flash_kernel) in
// src/repro/kernels/flash_attention.py.
//
// What bounds it: operations. Each (query, key) pair of the causal band
// costs 4*D flops, while the bytes grow only linearly in S (q, k, v and out
// once each), so above a few hundred tokens the arithmetic dominates.
//
// Two kernels, chosen by dtype in the wrapper (one entry point each), both
// FA2-style forwards on the tensor cores with one structure:
//   * one block per (sequence, query head, 64-query tile) with kSets sets
//     of 4 warps; a warp owns 16 query rows, and set j takes the tile's key
//     tiles j, j+kSets, ... (several warps a query row, so a long row's
//     sweep is shortened); the sets merge (m, l, O) through shared memory
//     at the end (finish);
//   * S = Q K^T and O += P V run as mma.sync with fp32 accumulators in
//     registers; P goes from the S accumulator fragment to the A fragment
//     of P V in registers, never through shared memory; the softmax scale
//     (and cap) is applied to the fp32 scores;
//   * K/V tiles are staged by 16-byte cp.async, kStages groups of kSets
//     tiles deep, in rows laid out so that a fragment load hits distinct
//     banks;
//   * the online softmax works per row in registers (log2 domain, exp2);
//     a row's max is reduced over the 4 lanes of its fragment quad, its sum
//     is kept per lane and reduced once at the end (softmax_tile);
//   * loop bounds come from the causal band and the window; only the
//     diagonal tile and the tiles at the window's edge compute masks, and
//     a row none of whose keys in a tile is valid keeps m = -inf without a
//     NaN (exp2 is taken against 0 while m is -inf);
//   * the query-tile axis is the grid's slowest and is walked in reverse,
//     so the longest (most keys) tiles start first.
//
// flash_mma_kernel (bfloat16): mma.sync.m16n8k16 bf16 -> fp32. Q and K
//   fragments come from shared memory by ldmatrix, V by ldmatrix.trans; P is
//   rounded to bf16 before P V, as the reference layer rounds its
//   probabilities. Rows of 16-byte chunks are XOR-swizzled by the row index
//   (within groups of 8 chunks; a row is padded to a multiple of 64
//   elements, so D 96 and 112 take D 128's 256-byte rows) so that each
//   8-row ldmatrix phase hits 8 distinct bank groups. At D <= 128 a warp
//   keeps its Q fragments in registers; at D 256 (O alone is 128 fp32
//   registers a lane) it reloads them by ldmatrix every key tile, takes
//   32-key tiles and loads V fragments 4 at a time, so that nothing spills.
//   What bounds it now (by count): instruction issue and shared-memory
//   reads; a 16-row warp tile re-reads every K/V fragment per 2 mma.sync.
//   wgmma on 64-row warpgroup tiles and TMA copies are the next step.
//
// flash_tf32_kernel (float32): 3xTF32 on mma.sync.m16n8k8. TF32 keeps 10
//   mantissa bits, too few for the fp32 tolerance, so each operand x is
//   split into hi = tf32(x) and lo = tf32(x - hi), and each product is
//   lo*hi + hi*lo + hi*hi into the fp32 accumulator (the dropped lo*lo is
//   below 2^-22 of the product). The same holds for Q K^T and for P V (P
//   in fp32, split the same way). fp32 fragments cannot be loaded by
//   ldmatrix (b16 only), so they are read from shared memory with plain
//   32-bit loads; rows are padded to D + 4 floats (D + 4 = 4 or 20 mod 32),
//   which puts the 32 lanes of every fragment load (8 rows x 4 columns for
//   Q and K, 4 row pairs x 8 columns for V) on 32 distinct banks with no
//   swizzle. Operands are split where they are read (3 instructions an
//   element). V's rows are read in the order of P's accumulator columns
//   (key 2t, 2t+1 to fragment rows t, t+4), so P needs no shuffle. D <= 64
//   takes 64-key tiles and two warp sets, D 96-128 32-key tiles (shared
//   memory), D 256 32-key tiles and one warp set whose two halves each
//   keep half of O's columns (O whole is 128 registers a lane, and ptxas
//   spilled at 255): both halves score the same keys, 1.5x the mma work.
//   What bounds it (by count): issue, about 3 split and load instructions
//   an mma, near the tensor pipe's own rate.
//
// Head dims past 256 (kExactMaxD): the builds for D 384 and 512 take any
// multiple of 8 above 256 up to their D. Rows are copied in place: a
// 16-byte chunk at or past the true width a.D is zero-filled by cp.async
// (src-size 0), not read, so a width between the builds moves no padding
// bytes; k-steps of Q K^T wholly past a.D, and O tiles past it, are
// skipped, and only columns below a.D are stored. What is left idle is the
// part of the last k-step and of the last batch of O tiles past a.D (D 264
// on the 384 build: 8 of 272 score columns, 8 of 264 output columns a
// half). What binds there: shared memory and registers.
//   * bf16: O of a 16-row strip is D / 2 fp32 registers a lane (256 at D
//     512, past the 255 cap), so two halves of 4 warps each keep half of
//     O's columns (as fp32 at D 256); both score the same keys (1.5x the
//     mma work of one). One warp set: (64 + 2*2*32) rows of D bf16 are 192
//     KB at D 512; two sets would be 320 KB.
//   * fp32: a 64-query tile of D + 4 floats is 132 KB at D 512 alone, so
//     the tile is 32 queries (2 row warps) and the K/V tiles 16 keys
//     ((32 + 2*2*16) rows: 194 KB at D 512); O is split in D / 128 column
//     parts of 64 registers a lane (3 at D 384, 4 at D 512), each part
//     scoring the same keys (S's mma work times the parts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

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

constexpr int kBQ = 64;      // query rows per block: 16 per warp of a set
constexpr int kStages = 2;   // groups of kSets K/V tiles in flight
constexpr int kExactMaxD = 256;  // widest head dim compiled exactly
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------

// c += a (16x8, row) * b (8x8, col), tf32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo with hi and lo both tf32 (round to nearest).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// c += a * b in 3xTF32: the two small cross terms first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// A key tile's scores (kST n8 accumulator fragments of a 16-row warp tile;
// this lane's rows ra (c0, c1) and ra + 8 (c2, c3), keys k0 + 8t + col and
// + 1) to unnormalised probabilities, in place: scale (or cap) to the log2
// domain, mask on the diagonal and window-edge tiles (masked), exp2
// against the running max m. Updates m and l (this lane's share of the row
// sums) and gives the factor alpha by which each row's O is rescaled.
template <int kST>
__device__ __forceinline__ void softmax_tile(float (&s)[kST][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const FlashArgs& a, float s_mul,
                                             float cap_log2, bool masked,
                                             int ra, int k0, int col) {
  if (a.softcap != 0.f) {
#pragma unroll
    for (int t = 0; t < kST; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = cap_log2 * tanhf(s[t][e] * s_mul);
  } else {
#pragma unroll
    for (int t = 0; t < kST; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] *= s_mul;
  }
  if (masked) {
#pragma unroll
    for (int t = 0; t < kST; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = ra + ((e >> 1) << 3);
        const int key = k0 + 8 * t + col + (e & 1);
        if (key > row || (a.window && row - key >= a.window))
          s[t][e] = -INFINITY;
      }
    }
  }
  // per row: max over the quad, exp2 against a finite base (0 while the
  // row has seen no valid key)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kST; ++t)
      mx = fmaxf(mx, fmaxf(s[t][2 * r], s[t][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp2_approx(m[r] - base);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kST; ++t) {
      s[t][2 * r] = exp2_approx(s[t][2 * r] - base);
      s[t][2 * r + 1] = exp2_approx(s[t][2 * r + 1] - base);
      sum += s[t][2 * r] + s[t][2 * r + 1];
    }
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
}

// End of a block: reduce the row sums over the quad, merge the warp sets'
// (m, l, O) into set 0 through xs (the drained K/V buffers: kSets - 1 sets
// x 128 lanes x (4 + 4 kOT) floats), normalise and store this lane's
// output pairs.
template <int kOT, int kSets, typename T>
__device__ __forceinline__ void finish(float (&o)[kOT][4], float (&m)[2],
                                       float (&l)[2], float* xs, int set,
                                       int li, T* og, long long o_ss, int ra,
                                       int col, int S, int n_cols) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (kSets > 1) {
    cp_async_wait<0>();
    __syncthreads();
    constexpr int kPart = 4 + 4 * kOT;  // floats a lane hands over
    if (set > 0) {
      float* x = xs + ((set - 1) * 128 + li) * kPart;
      x[0] = m[0];
      x[1] = m[1];
      x[2] = l[0];
      x[3] = l[1];
#pragma unroll
      for (int t = 0; t < kOT; ++t)
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
      for (int t = 0; t < kOT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[t][e] = o[t][e] * c_own[e >> 1] + x[4 + 4 * t + e] * c_x[e >> 1];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row < S) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      T* orow = og + (long long)row * o_ss + col;
#pragma unroll
      for (int t = 0; t < kOT; ++t)  // n_cols: this warp's columns below D
        if (8 * t < n_cols)
          store2(orow + 8 * t, o[t][2 * r] * inv, o[t][2 * r + 1] * inv);
    }
  }
}

// The key range of the bq-query tile q0: causal (keys <= last query) and
// window.
__device__ __forceinline__ void key_range(const FlashArgs& a, int q0, int bq,
                                          int bk, int* k_begin,
                                          int* n_tiles) {
  const int k_end = min(q0 + bq, a.S);
  int kb = a.window ? max(0, q0 - a.window + 1) : 0;
  kb = (kb / bk) * bk;
  *k_begin = kb;
  *n_tiles = (k_end - kb + bk - 1) / bk;
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

template <int D>
struct MmaCfg {
  static constexpr bool kMasked = D > kExactMaxD;  // true D <= D, in place
  static constexpr int kBK = D >= 256 ? 32 : 64;  // keys a K/V tile
  static constexpr int kSets = kMasked ? 1 : 2;
  // past 256: two halves of 4 warps, each with half of O's columns
  static constexpr int kHalves = kMasked ? 2 : 1;
  static constexpr int kWarps = 4 * kSets * kHalves;
  // elements a shared row: whole groups of 8 16-byte chunks (D 32: 4)
  static constexpr int kLd = D <= 32 ? 32 : (D + 63) / 64 * 64;
  static constexpr bool kQReg = D <= 128;  // Q fragments kept in registers
  static constexpr int kSmem = (kBQ + 2 * kStages * kSets * kBK) * kLd * 2;
  static_assert(kSmem <= 232448, "shared memory a block may use");
  static_assert((kSets - 1) * 128 * (4 + D / 2) * 4 <=
                    2 * kStages * kSets * kBK * kLd * 2,
                "the set merge fits in the K/V buffers");
};

// Element offset of (row, 16-byte chunk) in a [rows][kLd] bf16 tile whose
// chunks are XOR-swizzled within groups of 8: the 8 rows an ldmatrix phase
// reads at one logical chunk land in 8 distinct 16-byte bank groups. At
// D = 32 two rows share a 128-byte line, so the row index is halved first.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int kShift = D == 32 ? 1 : 0;
  constexpr int kMask = D == 32 ? 3 : 7;
  return row * MmaCfg<D>::kLd + ((chunk ^ ((row >> kShift) & kMask)) << 3);
}

// kRows rows of a [S][D] bf16 matrix (row stride ss) into a swizzled
// tile; rows at or past S, and 16-byte chunks at or past nc (the true
// width's), are zero-filled.
template <int D, int kRows>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long ss, int r0, int S,
                                               int nc) {
  constexpr int kChunks = D / 8;
  constexpr int kThreads = MmaCfg<D>::kWarps * 32;
  constexpr int kN = kRows * kChunks;
#pragma unroll
  for (int i = 0; i < (kN + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (kN % kThreads == 0 || e < kN) {
      const int r = e / kChunks;
      const int c = e - r * kChunks;
      const int gr = r0 + r;
      const bool in = gr < S && c < nc;
      cp_async16(smem_addr(dst + swz<D>(r, c)),
                 src + (long long)(gr < S ? gr : 0) * ss + (in ? c * 8 : 0),
                 in ? 16 : 0);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MmaCfg<D>::kWarps * 32, 1)
flash_mma_kernel(const FlashArgs a) {
  using C = MmaCfg<D>;
  constexpr int kBK = C::kBK;
  constexpr int kSets = C::kSets;
  constexpr int kKSteps = D / 16;   // k-steps of Q K^T
  constexpr int kSTiles = kBK / 8;  // n8 tiles of S
  constexpr int kOTiles = D / 8 / C::kHalves;  // n8 tiles of O a warp
  constexpr int kVP = kOTiles / 2;  // x4 loads of V a k-step
  constexpr int kVB = kVP <= 8 ? kVP : 4;  // of which in flight at once
  constexpr int kTile = kBK * C::kLd;      // elements of a K or V tile
  static_assert(kVP % kVB == 0, "V loads in whole batches");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * C::kLd;  // [kStages][kSets][kBK][kLd]
  __nv_bfloat16* vs = ks + kStages * kSets * kTile;

  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest first
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wrow = (warp & 3) * 16;  // this warp's 16 rows of the tile
  const int set = C::kHalves > 1 ? 0 : warp >> 2;
  const int d0 = C::kHalves > 1 ? (warp >> 2) * (D / 2) : 0;  // O columns
  const int nd = C::kMasked ? a.D : D;   // the true width
  const int nc = nd / 8;                 // its 16-byte chunks
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh + d0;

  int k_begin, n_tiles;
  key_range(a, q0, kBQ, kBK, &k_begin, &n_tiles);
  const int n_groups = (n_tiles + kSets - 1) / kSets;

  // group i: tiles i*kSets .. i*kSets + kSets-1 (those that exist)
  auto load_group = [&](int i) {
    const int st = i % kStages;
#pragma unroll
    for (int j = 0; j < kSets; ++j) {
      const int tile = i * kSets + j;
      if (tile < n_tiles) {
        const int k0 = k_begin + tile * kBK;
        load_tile_bf16<D, kBK>(ks + (st * kSets + j) * kTile, kg, a.k_ss, k0,
                               a.S, nc);
        load_tile_bf16<D, kBK>(vs + (st * kSets + j) * kTile, vg, a.v_ss, k0,
                               a.S, nc);
      }
    }
    cp_async_commit();
  };
  load_tile_bf16<D, kBQ>(qs, qg, a.q_ss, q0, a.S, nc);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_group(i);  // Q rides group 0

  // this lane's rows of the fragments: ra (c0, c1) and ra + 8 (c2, c3)
  const int ra = q0 + wrow + (lane >> 2);
  const int col = 2 * (lane & 3);
  // scores to the log2 domain: s * scale * log2(e), or with the cap
  // cap * tanh(s * scale / cap) * log2(e)
  const float s_mul =
      a.softcap != 0.f ? a.scale / a.softcap : a.scale * kLog2e;
  const float cap_log2 = a.softcap * kLog2e;

  uint32_t qf[C::kQReg ? kKSteps : 1][4];
  float o[kOTiles][4];
#pragma unroll
  for (int t = 0; t < kOTiles; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  auto q_frag = [&](uint32_t(&r)[4], int kk) {
    ldmatrix_x4(r, smem_addr(qs + swz<D>(wrow + (lane & 15),
                                         2 * kk + (lane >> 4))));
  };

  for (int it = 0; it < n_groups; ++it) {
    // keep kStages - 1 groups in flight: issue group it + kStages - 1
    // (an empty commit past the end keeps the group count uniform)
    load_group(it + kStages - 1 < n_groups ? it + kStages - 1 : n_groups);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (C::kQReg && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (C::kQReg ? kKSteps : 0); ++kk)
        q_frag(qf[kk], kk);
    }
    const int tile = it * kSets + set;
    if (tile < n_tiles) {  // warp-uniform
      const int k0 = k_begin + tile * kBK;
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
        if (C::kMasked && 16 * kk >= nd) continue;  // zero columns
        uint32_t qa[4];
        if constexpr (C::kQReg) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        } else {
          q_frag(qa, kk);
        }
        uint32_t bf[kSTiles / 2][4];  // all loads of a k-step, then the mmas
#pragma unroll
        for (int np = 0; np < kSTiles / 2; ++np)
          ldmatrix_x4(bf[np], smem_addr(kt + swz<D>(np * 16 + (lane & 7) +
                                                        ((lane >> 4) << 3),
                                                    2 * kk +
                                                        ((lane >> 3) & 1))));
#pragma unroll
        for (int np = 0; np < kSTiles / 2; ++np) {
          mma_bf16(s[2 * np], qa, bf[np][0], bf[np][1]);
          mma_bf16(s[2 * np + 1], qa, bf[np][2], bf[np][3]);
        }
      }

      float alpha[2];
      softmax_tile<kSTiles>(
          s, m, l, alpha, a, s_mul, cap_log2,
          k0 + kBK - 1 > q0 ||                                 // diagonal
              (a.window && q0 + kBQ - 1 - k0 >= a.window),     // window edge
          ra, k0, col);
#pragma unroll
      for (int t = 0; t < kOTiles; ++t) {
        o[t][0] *= alpha[0];
        o[t][1] *= alpha[0];
        o[t][2] *= alpha[1];
        o[t][3] *= alpha[1];
      }

      // O += P V: the S fragments of keys 16kk..16kk+15 are P's A fragment
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int vb = 0; vb < kVP; vb += kVB) {
          if (C::kMasked && d0 + 16 * vb >= nd) continue;  // past D
          uint32_t bf[kVB][4];
#pragma unroll
          for (int i = 0; i < kVB; ++i)
            ldmatrix_x4_trans(bf[i],
                              smem_addr(vt + swz<D>(kk * 16 + (lane & 15),
                                                    d0 / 8 + 2 * (vb + i) +
                                                        (lane >> 4))));
#pragma unroll
          for (int i = 0; i < kVB; ++i) {
            mma_bf16(o[2 * (vb + i)], pa, bf[i][0], bf[i][1]);
            mma_bf16(o[2 * (vb + i) + 1], pa, bf[i][2], bf[i][3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  finish<kOTiles, kSets>(o, m, l, reinterpret_cast<float*>(ks), set,
                         (warp & 3) * 32 + lane, og, a.o_ss, ra, col, a.S,
                         nd - d0);
}

// ---------------------------------------------------------------------------
// float32: 3xTF32, mma.sync m16n8k8
// ---------------------------------------------------------------------------

template <int D>
struct Tf32Cfg {
  static constexpr bool kMasked = D > kExactMaxD;  // true D <= D, in place
  // past 256: 32-query tiles and 16-key K/V tiles (shared memory)
  static constexpr int kBQ = kMasked ? ::kBQ / 2 : ::kBQ;
  static constexpr int kRowWarps = kBQ / 16;
  static constexpr int kBK = D <= 64 ? 64 : kMasked ? 16 : 32;  // keys a tile
  // D 256: one warp set whose O columns are split between two halves of 4
  // warps (each half scores the same keys; 64 O registers a lane, not 128);
  // past 256, D / 128 parts of 64 registers
  static constexpr int kSets = D >= 256 ? 1 : 2;
  static constexpr int kHalves = kMasked ? D / 128 : D >= 256 ? 2 : 1;
  static constexpr int kWarps = kRowWarps * kSets * kHalves;
  static constexpr int kLd = D + 4;  // floats a shared row
  static constexpr int kSmem = (kBQ + 2 * kStages * kSets * kBK) * kLd * 4;
  static_assert(kSmem <= 232448, "shared memory a block may use");
  static_assert((kSets - 1) * 128 * (4 + D / 2) * 4 <=
                    2 * kStages * kSets * kBK * kLd * 4,
                "the set merge fits in the K/V buffers");
};

// kRows rows of a [S][D] fp32 matrix (row stride ss) into a [kRows][kLd]
// tile; rows at or past S, and 16-byte chunks at or past nc, are
// zero-filled.
template <int D, int kRows>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long ss, int r0, int S,
                                              int nc) {
  constexpr int kChunks = D / 4;
  constexpr int kThreads = Tf32Cfg<D>::kWarps * 32;
  constexpr int kN = kRows * kChunks;
#pragma unroll
  for (int i = 0; i < (kN + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (kN % kThreads == 0 || e < kN) {
      const int r = e / kChunks;
      const int c = e - r * kChunks;
      const int gr = r0 + r;
      const bool in = gr < S && c < nc;
      cp_async16(smem_addr(dst + r * Tf32Cfg<D>::kLd + c * 4),
                 src + (long long)(gr < S ? gr : 0) * ss + (in ? c * 4 : 0),
                 in ? 16 : 0);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tf32Cfg<D>::kWarps * 32, 1)
flash_tf32_kernel(const FlashArgs a) {
  using C = Tf32Cfg<D>;
  constexpr int kBQ = C::kBQ;
  constexpr int kBK = C::kBK;
  constexpr int kSets = C::kSets;
  constexpr int kLd = C::kLd;
  constexpr int kKSteps = D / 8;    // k-steps of Q K^T
  constexpr int kSTiles = kBK / 8;  // n8 tiles of S (= k-steps of P V)
  constexpr int kOTiles = D / 8 / C::kHalves;  // n8 tiles of O a warp
  constexpr int kTile = kBK * kLd;  // floats of a K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kBQ][kLd]
  float* ks = qs + kBQ * kLd;  // [kStages][kSets][kBK][kLd]
  float* vs = ks + kStages * kSets * kTile;

  const int bh = blockIdx.x;
  const int b = bh / a.Hq;
  const int h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest first
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wrow = (warp % C::kRowWarps) * 16;  // this warp's 16 rows
  const int part = warp / C::kRowWarps;
  const int set = C::kHalves > 1 ? 0 : part;
  const int d0 = C::kHalves > 1 ? part * (D / C::kHalves) : 0;  // O columns
  const int nd = C::kMasked ? a.D : D;   // the true width
  const int nc = nd / 4;                 // its 16-byte chunks
  const int gq = lane >> 2;  // fragment row (A, C) / column (B)
  const int tq = lane & 3;   // fragment column (A) / row (B)
  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg =
      static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vg =
      static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* og = static_cast<float*>(a.out) + b * a.o_sb + h * a.o_sh + d0;

  int k_begin, n_tiles;
  key_range(a, q0, kBQ, kBK, &k_begin, &n_tiles);
  const int n_groups = (n_tiles + kSets - 1) / kSets;

  auto load_group = [&](int i) {
    const int st = i % kStages;
#pragma unroll
    for (int j = 0; j < kSets; ++j) {
      const int tile = i * kSets + j;
      if (tile < n_tiles) {
        const int k0 = k_begin + tile * kBK;
        load_tile_f32<D, kBK>(ks + (st * kSets + j) * kTile, kg, a.k_ss, k0,
                              a.S, nc);
        load_tile_f32<D, kBK>(vs + (st * kSets + j) * kTile, vg, a.v_ss, k0,
                              a.S, nc);
      }
    }
    cp_async_commit();
  };
  load_tile_f32<D, kBQ>(qs, qg, a.q_ss, q0, a.S, nc);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_group(i);  // Q rides group 0

  const int ra = q0 + wrow + gq;
  const int col = 2 * tq;
  const float s_mul =
      a.softcap != 0.f ? a.scale / a.softcap : a.scale * kLog2e;
  const float cap_log2 = a.softcap * kLog2e;

  float o[kOTiles][4];
#pragma unroll
  for (int t = 0; t < kOTiles; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  // A fragment of Q: rows gq, gq + 8 x columns tq, tq + 4 of k-step kk
  const float* qrow = qs + (wrow + gq) * kLd + tq;

  for (int it = 0; it < n_groups; ++it) {
    load_group(it + kStages - 1 < n_groups ? it + kStages - 1 : n_groups);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int tile = it * kSets + set;
    if (tile < n_tiles) {  // warp-uniform
      const int k0 = k_begin + tile * kBK;
      const int slot = (it % kStages) * kSets + set;
      const float* kt = ks + slot * kTile;
      const float* vt = vs + slot * kTile;

      // S = Q K^T; B fragment of K^T: key 8nt + gq, d 8kk + tq (+ 4)
      float s[kSTiles][4];
#pragma unroll
      for (int t = 0; t < kSTiles; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        if (C::kMasked && 8 * kk >= nd) continue;  // zero columns
        uint32_t ah[4], al[4];
        split_tf32(qrow[8 * kk], ah[0], al[0]);
        split_tf32(qrow[8 * kLd + 8 * kk], ah[1], al[1]);
        split_tf32(qrow[8 * kk + 4], ah[2], al[2]);
        split_tf32(qrow[8 * kLd + 8 * kk + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < kSTiles; ++nt) {
          const float* kr = kt + (8 * nt + gq) * kLd + 8 * kk + tq;
          uint32_t bh[2], bl[2];
          split_tf32(kr[0], bh[0], bl[0]);
          split_tf32(kr[4], bh[1], bl[1]);
          mma_3xtf32(s[nt], ah, al, bh, bl);
        }
      }

      float alpha[2];
      softmax_tile<kSTiles>(
          s, m, l, alpha, a, s_mul, cap_log2,
          k0 + kBK - 1 > q0 || (a.window && q0 + kBQ - 1 - k0 >= a.window),
          ra, k0, col);
#pragma unroll
      for (int t = 0; t < kOTiles; ++t) {
        o[t][0] *= alpha[0];
        o[t][1] *= alpha[0];
        o[t][2] *= alpha[1];
        o[t][3] *= alpha[1];
      }

      // O += P V over k-steps of 8 keys. The lane holds P at keys
      // 8kk + 2tq, + 1 (accumulator columns); as A fragment columns tq and
      // tq + 4 they pair with V rows 8kk + 2tq and 8kk + 2tq + 1.
#pragma unroll
      for (int kk = 0; kk < kSTiles; ++kk) {
        uint32_t ph[4], pl[4];
        split_tf32(s[kk][0], ph[0], pl[0]);  // row gq,     column tq
        split_tf32(s[kk][2], ph[1], pl[1]);  // row gq + 8, column tq
        split_tf32(s[kk][1], ph[2], pl[2]);  // row gq,     column tq + 4
        split_tf32(s[kk][3], ph[3], pl[3]);  // row gq + 8, column tq + 4
        const float* vr = vt + (8 * kk + 2 * tq) * kLd + d0 + gq;
#pragma unroll
        for (int dt = 0; dt < kOTiles; ++dt) {
          if (C::kMasked && d0 + 8 * dt >= nd) continue;  // past D
          uint32_t bh[2], bl[2];
          split_tf32(vr[8 * dt], bh[0], bl[0]);
          split_tf32(vr[kLd + 8 * dt], bh[1], bl[1]);
          mma_3xtf32(o[dt], ph, pl, bh, bl);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  finish<kOTiles, kSets>(o, m, l, ks, set, (warp & 3) * 32 + lane, og,
                         a.o_ss, ra, col, a.S, nd - d0);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int threads, int bytes, int bq, const FlashArgs& a,
           cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.B * a.Hq, (a.S + bq - 1) / bq);
  kernel<<<grid, threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma_d(const FlashArgs& a, cudaStream_t stream) {
  using C = MmaCfg<D>;
  return launch(flash_mma_kernel<D>, C::kWarps * 32, C::kSmem, kBQ, a,
                stream);
}

template <int D>
int launch_tf32_d(const FlashArgs& a, cudaStream_t stream) {
  using C = Tf32Cfg<D>;
  return launch(flash_tf32_kernel<D>, C::kWarps * 32, C::kSmem, C::kBQ, a,
                stream);
}

bool bad_args(const FlashArgs* a) {
  return a->Hkv <= 0 || a->Hq % a->Hkv != 0;
}

// past kExactMaxD: a multiple of 8 up to 512, read in place by the next
// build (0: none takes it)
int wide_build(int D) {
  if (D % 8 != 0 || D <= kExactMaxD || D > 512) return 0;
  return D <= 384 ? 384 : 512;
}

}  // namespace

extern "C" int rt_flash_attention_f32(const FlashArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a->D) {
    case 32: return launch_tf32_d<32>(*a, s);
    case 64: return launch_tf32_d<64>(*a, s);
    case 96: return launch_tf32_d<96>(*a, s);
    case 112: return launch_tf32_d<112>(*a, s);
    case 128: return launch_tf32_d<128>(*a, s);
    case 256: return launch_tf32_d<256>(*a, s);
    default: break;
  }
  switch (wide_build(a->D)) {
    case 384: return launch_tf32_d<384>(*a, s);
    case 512: return launch_tf32_d<512>(*a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int rt_flash_attention_bf16(const FlashArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a->D) {
    case 32: return launch_mma_d<32>(*a, s);
    case 64: return launch_mma_d<64>(*a, s);
    case 96: return launch_mma_d<96>(*a, s);
    case 112: return launch_mma_d<112>(*a, s);
    case 128: return launch_mma_d<128>(*a, s);
    case 256: return launch_mma_d<256>(*a, s);
    default: break;
  }
  switch (wide_build(a->D)) {
    case 384: return launch_mma_d<384>(*a, s);
    case 512: return launch_mma_d<512>(*a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
