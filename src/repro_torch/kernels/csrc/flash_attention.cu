// Blocked online-softmax attention (flash), forward, for Hopper (sm_90a).
// Hand-written CUDA C++, bound to PyTorch through a plain C interface and
// ctypes (repro_torch/kernels/flash_attention.py).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel).  What it computes, per (batch, q-head, query row i):
//   out_i = sum_j softmax_j(scale * q_i . k_j over the visible keys) v_j
// with key j visible when j < Tk, j <= q_pos (causal) and j > q_pos - window
// (sliding window), q_pos = i + Tk - Tq (query rows aligned to the END of
// the key axis).  GQA reads kv-head h / (Hq / Hkv) for q-head h; K/V are
// never repeated.  A row with no visible key gives 0 (the TPU kernel's
// max(l, 1e-30) clamp).  Output in the input type (float32 or bfloat16).
//
// Both routes: one block owns one (batch * q-head, 64-row query tile) and
// walks the key axis in 64-key tiles (the TPU's sequential K grid axis
// becomes a loop; blocks of heavy causal tiles are issued first).  The loop
// visits only the key tiles that the causal/window mask does not hide
// entirely, and masks element by element only the tiles that the mask
// cuts.  Running max m, denominator l and the (64, D) accumulator stay in
// float32 registers.  Tq/Tk edges are zero-filled in the kernel (rows past
// Tq are not stored).
//
// bfloat16 route (fa_tc_kernel, every path): both products on the bf16
// tensor cores, mma.sync m16n8k16 with float32 accumulation, in the
// FlashAttention-2 pattern.  Four warps own 16 query rows each; Q's
// fragments stay in registers for the whole key loop; K and V tiles are
// double-buffered in shared memory by cp.async (the next tile loads while
// this one is multiplied), rows of 16-byte chunks XOR-swizzled (D = 80:
// rows padded to an odd stride of 11 chunks instead) so that ldmatrix (K,
// for S = Q.K^T) and ldmatrix.trans (V, for O += P.V) read conflict-free.
// Q is staged in the second buffer's K slot before the loop, so a block
// holds 64 KB (D = 128) and three fit on an SM.  S is
// scaled in float32 by scale*log2(e) and exponentiated with exp2f; P is
// rounded to bf16 as the A operand of P.V straight from the S accumulator
// registers (no trip through shared memory); the output is staged through
// shared memory for 16-byte stores.
//
// float32 route (fa_kernel; the float32 forwards of the examples, e.g.
// quickstart, and the float32 cases of the card check): float32 FMA on the
// CUDA cores, Q (pre-scaled) and K transposed in shared memory.  The
// tensor cores would round float32 inputs to bf16 or TF32, so this route
// keeps them exact to float32 sums.
//
// Head dims 16, 32, 64, 80 and 128 are compiled on both routes.  At 16
// (olmo-1b-reduced) a bf16 tile row is two 16-byte chunks, swizzled with
// r & 1, and a float32 thread owns one accumulator column.
//
// Bound on the H100: causal prefill at (4, 16, 1024, 128) bf16 is ~17
// GFLOP of products on ~67 MB of q/k/v/out: ~17 us at the bf16 tensor-core
// rate, ~20 us at the memory rate.  What holds this route above that:
// mma.sync does not reach wgmma's rate on Hopper; every warp reads the
// whole K and V tile from shared memory for its 16 rows (one ldmatrix per
// two mma); and each 64-row block fetches its K/V tiles from L2 on its
// own.  A wgmma tile with 64 rows per warpgroup, K/V by TMA and P from
// registers would address all three.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int PS = BK + 4;    // padded row stride of the probability tile
constexpr int NT = 256;       // threads per block (16 row groups x 16)
constexpr float NEG = -1e30f; // masked score (finite, as in the TPU kernel)

// 8 consecutive floats from a 32-byte aligned address
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// accumulator column c (of NC = D/16) of thread tx.  NC >= 4: groups of
// four columns at 64-column strides (float4 reads of V), then, where 4 does
// not divide NC (D = 80), the NC % 4 columns left, tx's own past the last
// group: D = 80 maps c < 4 to tx*4 + c (0..63) and c = 4 to 64 + tx.
template <int D>
__device__ __forceinline__ int acc_col(int tx, int c) {
  constexpr int NC = D / 16, NF = NC / 4 * 4, NR = NC % 4;
  if constexpr (NC >= 4) {
    if (c < NF) return (c / 4) * 64 + tx * 4 + (c % 4);
    return NF * 16 + tx * NR + (c - NF);
  } else {
    return tx * NC + c;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(D * BQ + D * BK + BK * D + BQ * PS) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) fa_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int hq, int hkv, int tq, int tk, int causal, int window,
    float scale, long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost) {
  constexpr int CH = D / 8;   // 8-element chunks per row
  constexpr int NC = D / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [D][BQ], pre-scaled
  float* Kt = Qt + D * BQ;     // [D][BK]
  float* Vs = Kt + D * BK;     // [BK][D]
  float* Ps = Vs + BK * D;     // [BQ][PS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int bi = blockIdx.y / hq, h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const T* qb = q + bi * qsb + h * qsh;
  const T* kb = k + bi * ksb + hk * ksh;
  const T* vb = v + bi * vsb + hk * vsh;
  T* ob = o + bi * osb + h * osh;

  for (int c = tid; c < BQ * CH; c += NT) {
    const int r = c % BQ, dc = c / BQ;
    float x[8];
    if (q0 + r < tq) {
      load8(qb + (long long)(q0 + r) * qst + dc * 8, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) Qt[(dc * 8 + i) * BQ + r] = x[i] * scale;
  }

  // key tiles the mask does not hide entirely
  const int off = tk - tq;
  const int first_q = q0 + off;
  const int last_q = min(q0 + BQ, tq) - 1 + off;
  const int kend = causal ? min(tk, last_q + 1) : tk;
  int kbeg = window > 0 ? max(0, first_q - window + 1) : 0;
  kbeg = (kbeg / BK) * BK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // Q written; the previous tile's K/V/P reads are done
    for (int c = tid; c < BK * CH; c += NT) {
      const int r = c % BK, dc = c / BK;
      float x[8];
      if (k0 + r < tk) {
        load8(kb + (long long)(k0 + r) * kst + dc * 8, x);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) Kt[(dc * 8 + i) * BK + r] = x[i];
    }
    for (int c = tid; c < BK * CH; c += NT) {
      const int r = c / CH, dc = c % CH;
      float x[8];
      if (k0 + r < tk) {
        load8(vb + (long long)(k0 + r) * vst + dc * 8, x);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(Vs + r * D + dc * 8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * BQ + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(Kt + d * BK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, online softmax update
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i + off;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        const bool vis = kp < tk && (!causal || kp <= qp) &&
                         (window <= 0 || kp > qp - window);
        s[i][j] = vis ? s[i][j] : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mnew = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mnew);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > 0.5f * NEG ? expf(s[i][j] - mnew) : 0.f;
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      m[i] = mnew;
      *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * PS + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc += P . V
    for (int j = 0; j < BK; j += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * PS + j);
        pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = Vs + (j + jj) * D;
        float vv[NC];
        if constexpr (NC >= 4) {
#pragma unroll
          for (int g = 0; g < NC / 4; ++g) {
            const float4 t =
                *reinterpret_cast<const float4*>(vr + g * 64 + tx * 4);
            vv[g * 4] = t.x; vv[g * 4 + 1] = t.y;
            vv[g * 4 + 2] = t.z; vv[g * 4 + 3] = t.w;
          }
#pragma unroll
          for (int c = NC / 4 * 4; c < NC; ++c) vv[c] = vr[acc_col<D>(tx, c)];
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c) vv[c] = vr[tx * NC + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[i][c] = fmaf(pv[i][jj], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = ob + (long long)r * ost;
#pragma unroll
    for (int c = 0; c < NC; ++c) store1(orow + acc_col<D>(tx, c), acc[i][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int tq, int tk, int causal, int window,
           float scale, const long long* st, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  static bool attr_set = false;  // per instantiation, outside graph capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((tq + BQ - 1) / BQ, b * hq);
  fa_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, tq, tk, causal,
      window, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

// --- bfloat16 route: tensor cores ------------------------------------------

namespace tc {

constexpr int BQ = 64;   // query rows per block: four warps of 16
constexpr int BKV = 64;  // keys per tile
constexpr int NT = 128;  // threads per block

// 16-byte chunks a tile row takes in shared memory: the D / 8 of a row,
// or, where that is neither below 8 nor a multiple of 8 (D = 80: 10), one
// more, so that the stride is odd (11)
template <int D>
__host__ __device__ constexpr int row_chunks() {
  constexpr int CH = D / 8;
  return (CH < 8 || CH % 8 == 0) ? CH : (CH | 1);
}

// 16-byte chunk index of (row r, chunk c) in a tile of D-element rows, such
// that the 8 rows one ldmatrix reads at one c hit distinct banks: rows of a
// power-of-two number of chunks XOR-swizzle the chunk with the row; an odd
// row stride (D = 80) needs no swizzle, since r * stride mod 8 already
// differs for 8 consecutive rows.  (XOR-swizzling D = 80's 10 chunks would
// send c = 8, 9 to 8..15, into the next row.)
template <int D>
__device__ __forceinline__ int chunk(int r, int c) {
  constexpr int CH = D / 8, RS = row_chunks<D>();
  if constexpr (RS != CH) {
    return r * RS + c;
  } else {
    constexpr int MASK = CH < 8 ? CH - 1 : 7;
    return r * CH + (c ^ (r & MASK));
  }
}

template <int D>
constexpr int smem_bytes() {
  // two (K, V) buffers; Q passes through the second
  return 4 * BKV * row_chunks<D>() * 16;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// d += a . b: (16 x 16, row) bf16 by (16 x 8, col) bf16, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// rows [r0, r0 + R) of a (T, D) operand (row stride st elements) into a
// swizzled tile; rows at or past t are zero-filled
template <int D, int R>
__device__ __forceinline__ void load_tile(uint4* dst, const __nv_bfloat16* src,
                                          long long st, int r0, int t,
                                          int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = tid; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < t;
    cp_async16(dst + chunk<D>(r, c),
               ok ? src + (long long)(r0 + r) * st + c * 8 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 3) fa_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int hq, int hkv, int tq, int tk, int causal, int window, float scale_log2,
    long long qsb, long long qsh, long long qst, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst, long long osb,
    long long osh, long long ost) {
  constexpr int CH = D / 8, KS = D / 16, NB = BKV / 8, DB = D / 8;
  constexpr int TILE = BKV * row_chunks<D>();  // chunks of one K or V tile
  static_assert(BQ == BKV, "Q is staged in a K slot");
  extern __shared__ __align__(128) uint4 KVs[];  // buffer b: K at 2b, V at
                                                 // 2b + 1
  uint4* Qs = KVs + 2 * TILE;  // Q arrives in buffer 1's K slot

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int bi = blockIdx.y / hq, h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const __nv_bfloat16* qb = q + bi * qsb + h * qsh;
  const __nv_bfloat16* kb = k + bi * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + bi * vsb + hk * vsh;

  // key tiles the mask does not hide entirely
  const int off = tk - tq;
  const int first_q = q0 + off;
  const int last_q = min(q0 + BQ, tq) - 1 + off;
  const int kend = causal ? min(tk, last_q + 1) : tk;
  int kbeg = window > 0 ? max(0, first_q - window + 1) : 0;
  kbeg = (kbeg / BKV) * BKV;
  const int ntiles = kend > kbeg ? (kend - kbeg + BKV - 1) / BKV : 0;

  auto load_kv = [&](int it) {
    const int k0 = kbeg + it * BKV;
    uint4* buf = KVs + (it & 1) * 2 * TILE;
    load_tile<D, BKV>(buf, kb, kst, k0, tk, tid);
    load_tile<D, BKV>(buf + TILE, vb, vst, k0, tk, tid);
  };

  load_tile<D, BQ>(Qs, qb, qst, q0, tq, tid);
  if (ntiles > 0) load_kv(0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16 columns of D;
  // buffer 1 is refilled once every warp holds its fragments
  const int wr = warp * 16;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], saddr(Qs + chunk<D>(wr + (lane & 15), 2 * ks + (lane >> 4))));
  __syncthreads();

  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BKV;
    if (it + 1 < ntiles) {
      load_kv(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const uint4* Ks = KVs + (it & 1) * 2 * TILE;
    const uint4* Vs = Ks + TILE;

    // S = Q . K^T for this warp's 16 rows and the tile's 64 keys
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jj = 0; jj < NB / 2; ++jj) {
        uint32_t b[4];
        ldsm_x4(b, saddr(Ks + chunk<D>(jj * 16 + (lane & 7) + 8 * (lane >> 4),
                                       2 * ks + ((lane >> 3) & 1))));
        mma_bf16(s[2 * jj], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * jj + 1], qf[ks], b[2], b[3]);
      }
    }

    // scale to log2 units in float32; mask only the tiles the mask cuts
    const bool cut = (k0 + BKV > tk) || (causal && k0 + BKV - 1 > first_q) ||
                     (window > 0 && k0 <= last_q - window);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (cut) {
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = q0 + wr + g + 8 * (e >> 1) + off;
          const bool vis = kp < tk && (!causal || kp <= qp) &&
                           (window <= 0 || kp > qp - window);
          x = vis ? x : -INFINITY;
        }
        s[j][e] = x;
      }

    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[hh], mx);
      const float base = mnew == -INFINITY ? 0.f : mnew;  // empty so far
      const float corr = exp2f(m[hh] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float p = exp2f(s[j][e] - base);
          s[j][e] = p;
          sum += p;
        }
      l[hh] = l[hh] * corr + sum;  // this thread's share of the row
      m[hh] = mnew;
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        acc[j][2 * hh] *= corr;
        acc[j][2 * hh + 1] *= corr;
      }
    }

    // O += P . V: P (bf16) from the S registers as A fragments
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < DB / 2; ++dd) {
        uint32_t b[4];
        ldsm_x4_t(b, saddr(Vs + chunk<D>(kk * 16 + (lane & 7) +
                                             8 * ((lane >> 3) & 1),
                                         2 * dd + (lane >> 4))));
        mma_bf16(acc[2 * dd], a, b[0], b[1]);
        mma_bf16(acc[2 * dd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  // normalise, stage the warp's rows in buffer 0's K slot (free after the
  // loop's last barrier; each warp its own 16 rows), 16-byte stores
  uint4* Os = KVs;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
    const int r = wr + g + 8 * hh;
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(Os + chunk<D>(r, j)) + t4;
      *dst = pack_bf16(acc[j][2 * hh] * inv, acc[j][2 * hh + 1] * inv);
    }
  }
  __syncwarp();
  __nv_bfloat16* ob = o + bi * osb + h * osh;
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = wr + i / CH, c = i % CH;
    if (q0 + r < tq)
      *reinterpret_cast<uint4*>(ob + (long long)(q0 + r) * ost + c * 8) =
          Os[chunk<D>(r, c)];
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int tq, int tk, int causal, int window,
           float scale, const long long* st, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static bool attr_set = false;  // per instantiation, outside graph capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((tq + BQ - 1) / BQ, b * hq);
  fa_tc_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), hq,
      hkv, tq, tk, causal, window, scale * 1.4426950408889634f, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // namespace tc

// bfloat16 -> tensor-core route, float32 -> CUDA-core route
int launch_d(int bf16, int d, const void* q, const void* k, const void* v,
             void* o, int b, int hq, int hkv, int tq, int tk, int causal,
             int window, float scale, const long long* st,
             cudaStream_t stream) {
  switch (d) {
    case 16:
      return bf16 ? tc::launch<16>(q, k, v, o, b, hq, hkv, tq, tk, causal,
                                   window, scale, st, stream)
                  : launch<float, 16>(q, k, v, o, b, hq, hkv, tq, tk, causal,
                                      window, scale, st, stream);
    case 32:
      return bf16 ? tc::launch<32>(q, k, v, o, b, hq, hkv, tq, tk, causal,
                                   window, scale, st, stream)
                  : launch<float, 32>(q, k, v, o, b, hq, hkv, tq, tk, causal,
                                      window, scale, st, stream);
    case 64:
      return bf16 ? tc::launch<64>(q, k, v, o, b, hq, hkv, tq, tk, causal,
                                   window, scale, st, stream)
                  : launch<float, 64>(q, k, v, o, b, hq, hkv, tq, tk, causal,
                                      window, scale, st, stream);
    case 80:
      return bf16 ? tc::launch<80>(q, k, v, o, b, hq, hkv, tq, tk, causal,
                                   window, scale, st, stream)
                  : launch<float, 80>(q, k, v, o, b, hq, hkv, tq, tk, causal,
                                      window, scale, st, stream);
    case 128:
      return bf16 ? tc::launch<128>(q, k, v, o, b, hq, hkv, tq, tk, causal,
                                    window, scale, st, stream)
                  : launch<float, 128>(q, k, v, o, b, hq, hkv, tq, tk,
                                       causal, window, scale, st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: element strides (b, h, t) of each operand in st order
// q, k, v, o; the last axis (D) is contiguous and rows are 16-byte aligned.
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         int bf16, int b, int hq, int hkv, int tq, int tk,
                         int d, int causal, int window, float scale,
                         long long qsb, long long qsh, long long qst,
                         long long ksb, long long ksh, long long kst,
                         long long vsb, long long vsh, long long vst,
                         long long osb, long long osh, long long ost,
                         void* stream) {
  const long long st[12] = {qsb, qsh, qst, ksb, ksh, kst,
                            vsb, vsh, vst, osb, osh, ost};
  return launch_d(bf16, d, q, k, v, o, b, hq, hkv, tq, tk, causal, window,
                  scale, st, static_cast<cudaStream_t>(stream));
}
