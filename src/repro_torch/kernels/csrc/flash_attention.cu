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
// Both routes: one block owns one (batch * q-head, 64-row query tile), four
// warps of 16 rows, and walks the key axis in tiles (the TPU's sequential K
// grid axis becomes a loop; blocks of heavy causal tiles are issued first).
// The loop visits only the key tiles that the causal/window mask does not
// hide entirely, and masks element by element only the tiles that the mask
// cuts.  K and V tiles are double-buffered in shared memory by cp.async
// (the next tile loads while this one is multiplied).  Scores are taken in
// log2 units (times
// scale * log2(e)) and exponentiated with exp2f.  Running max m,
// denominator l and the (16, D) accumulator of each warp stay in float32
// registers.  P goes from the S accumulator registers straight into the A
// fragments of P.V (no trip through shared memory).  Tq/Tk edges are
// zero-filled in the kernel (rows past Tq are not stored).
//
// bfloat16 route (fa_tc_kernel, every serving path): both products on the
// bf16 tensor cores, mma.sync m16n8k16 with float32 accumulation, in the
// FlashAttention-2 pattern, 64-key tiles.  Q passes through the second
// buffer before the loop and its fragments stay in registers for the whole
// key loop; rows of 16-byte chunks XOR-swizzled (D = 80: rows
// padded to an odd stride of 11 chunks instead) so that ldmatrix (K, for
// S = Q.K^T) and ldmatrix.trans (V, for O += P.V) read conflict-free; a
// block holds 64 KB (D = 128) and three fit on an SM.  P is rounded to bf16
// for P.V; the output is staged through shared memory for 16-byte stores.
// Bound on the H100: causal prefill at (4, 16, 1024, 128) is ~17 GFLOP of
// products on ~67 MB of q/k/v/out: ~17 us at the bf16 tensor-core rate, ~20
// us at the memory rate.  What holds this route above that: mma.sync does
// not reach wgmma's rate on Hopper; every warp reads the whole K and V tile
// from shared memory for its 16 rows (one ldmatrix per two mma); and each
// 64-row block fetches its K/V tiles from L2 on its own.  A wgmma tile with
// 64 rows per warpgroup, K/V by TMA and P from registers would address all
// three.
//
// float32 route (fa_f32_kernel: the float32 forwards, e.g. the examples'
// quickstart, and the float32 cases of the card check): both of _kernel's
// float32 dots on the TF32 tensor cores in 3xTF32, mma.sync m16n8k8 with
// float32 sums.  Each operand x = hi + lo, hi = x rounded to TF32 (to
// nearest, ties away from zero), lo = the exact float32 remainder (read by
// the tensor cores cut to TF32), and a.b = a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi.  Bound on the H100: causal (4, 16, 1024, 128) is ~17 GFLOP of
// products, three passes of it at the TF32 rate (495 TFLOP/s) ~104 us,
// against ~40 us for its ~134 MB at the memory rate and ~257 us for one
// pass on the float32 CUDA cores (67 TFLOP/s).  What holds the route above
// that: mma.sync m16n8k8 does not reach the data sheet's rate; every B
// fragment comes from 32-bit shared-memory loads and is split in
// registers (one 8 x 8 block, 256 bytes a warp, feeds the three mma of its
// 16 rows); and at 255 registers two blocks (8 warps) share an SM, too few
// to hide the chains of dependent mma.  The design: K and V are staged as
// they are in memory and split as they are read (hi and lo planes in
// shared memory would double the B loads and the footprint); Q (times
// scale * log2(e)) stays in shared memory and its A fragments are read and
// split at each k-step (in registers, D / 2 of them, it spilled at D = 128
// beside the (16, D) accumulator, and was slower at D = 64).  P's A
// fragment takes the S accumulator's columns (2t, 2t + 1) of each 8-key
// slice as its k = t and t + 4, and V's B fragment reads keys 2t and
// 2t + 1 to match, so P needs no shuffle.  Rows are padded to D + 4 floats
// (4 times an odd number), so that K's (key g, dim t) and V's (key 2t or
// 2t + 1, dim g) fragment reads both hit 32 distinct banks.  Key tiles of
// 64 up to D = 64 and of 32 above: two stages and Q stay at or under 99 KB,
// two blocks an SM.
// Error: each product keeps all but ~2^-20 of itself (lo.lo, dropped, is
// under 2^-22; the cut lo parts 2^-21 each).  The tensor cores also drop
// low bits of the accumulator at each mma: one accumulator over the whole
// key axis missed the card check's FLASH_RTOL (2e-5 of each row's scale)
// against a float64 reference at Tk = 4096 on the H100.  So S sums its two
// small passes apart from the big one, and P.V sums each key tile in fresh
// registers that a rounded FMA adds to the rescaled accumulator; the card
// check holds every float32 case to FLASH_RTOL of a float64 reference too.
// The tests' _tf32x3_route repeats the split arithmetic on the CPU against
// the JAX kernel.
//
// Head dims 16, 32, 64, 80 and 128 are compiled on both routes.  At 16
// (olmo-1b-reduced) a bf16 tile row is two 16-byte chunks, swizzled with
// r & 1, and a float32 row four.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// --- float32 route: TF32 tensor cores in 3xTF32 ----------------------------

namespace tf32 {

constexpr int BQ = 64;   // query rows per block: four warps of 16
constexpr int NT = 128;  // threads per block

// keys per tile: 64 up to D = 64, 32 above
template <int D>
__host__ __device__ constexpr int bkv() {
  return D <= 64 ? 64 : 32;
}
// row stride of a staged tile, in floats: D + 4, 4 times an odd number
template <int D>
__host__ __device__ constexpr int row_stride() {
  return D + 4;
}
template <int D>
constexpr int smem_bytes() {
  // two (K, V) stages and the Q tile
  return (2 * 2 * bkv<D>() + BQ) * row_stride<D>() * (int)sizeof(float);
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero:
// the bits of a finite float plus half of the dropped place, cut), lo the
// exact float32 remainder, which the tensor cores read cut to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// d (16 x 8) += a (16 x 8, row) b (8 x 8, col) in TF32, float32 sums;
// fragments for lane 4 g + t: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); d0, d1 (g, 2t and 2t + 1),
// d2, d3 (g + 8, 2t and 2t + 1)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + R) of a (T, D) float32 operand (row stride st elements)
// into a tile of row_stride<D>() floats a row; rows at or past t are
// zero-filled
template <int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int r0, int t,
                                          int tid) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < t;
    cp_async16(dst + r * row_stride<D>() + c * 4,
               ok ? src + (long long)(r0 + r) * st + c * 4 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2) fa_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int hq, int hkv,
    int tq, int tk, int causal, int window, float scale_log2, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, long long osb, long long osh,
    long long ost) {
  constexpr int BKV = bkv<D>(), RS = row_stride<D>();
  constexpr int KS = D / 8;     // 8-wide steps of D: S's k-steps, O's n-tiles
  constexpr int NB = BKV / 8;   // 8-key slices of a tile
  constexpr int TILE = BKV * RS;  // floats of one K or V tile
  extern __shared__ __align__(16) float KVs[];  // stage b: K at 2b, V at
                                                // 2b + 1; then Q
  float* Qs = KVs + 4 * TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int bi = blockIdx.y / hq, h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const float* qb = q + bi * qsb + h * qsh;
  const float* kb = k + bi * ksb + hk * ksh;
  const float* vb = v + bi * vsb + hk * vsh;

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
    float* buf = KVs + (it & 1) * 2 * TILE;
    load_tile<D, BKV>(buf, kb, kst, k0, tk, tid);
    load_tile<D, BKV>(buf + TILE, vb, vst, k0, tk, tid);
  };

  load_tile<D, BQ>(Qs, qb, qst, q0, tq, tid);
  if (ntiles > 0) load_kv(0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // Q in log2 units; its A fragments are read (and split) at each use: in
  // registers they would spill at D = 128 beside the accumulator
  for (int i = tid; i < BQ * D; i += NT)
    Qs[(i / D) * RS + i % D] *= scale_log2;

  const int wr = warp * 16;
  float acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
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
    const float* Ks = KVs + (it & 1) * 2 * TILE;
    const float* Vs = Ks + TILE;

    // S = Q . K^T for this warp's 16 rows and the tile's keys; the B
    // fragment of slice j at k-step ks is K[8j + g][8ks + t] and
    // [8ks + t + 4].  The two small passes sum apart from the big one (the
    // tensor cores' sums lose low bits to each addition: the big pass's
    // chain is a third as long)
    float s[NB][4], sl[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float* pq = Qs + (wr + g) * RS + 8 * ks + t4;
      const float a[4] = {pq[0], pq[8 * RS], pq[4], pq[8 * RS + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float* p = Ks + (8 * j + g) * RS + 8 * ks + t4;
        uint32_t bh0, bl0, bh1, bl1;
        split(p[0], bh0, bl0);
        split(p[4], bh1, bl1);
        mma(sl[j], al, bh0, bh1);
        mma(sl[j], ah, bl0, bl1);
        mma(s[j], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += sl[j][e];

    // mask only the tiles the mask cuts
    const bool cut = (k0 + BKV > tk) || (causal && k0 + BKV - 1 > first_q) ||
                     (window > 0 && k0 <= last_q - window);
    if (cut) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = q0 + wr + g + 8 * (e >> 1) + off;
          const bool vis = kp < tk && (!causal || kp <= qp) &&
                           (window <= 0 || kp > qp - window);
          if (!vis) s[j][e] = -INFINITY;
        }
    }

    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float corr[2];
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
      corr[hh] = exp2f(m[hh] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float p = exp2f(s[j][e] - base);
          s[j][e] = p;
          sum += p;
        }
      l[hh] = l[hh] * corr[hh] + sum;  // this thread's share of the row
      m[hh] = mnew;
    }

    // O = O * corr + P . V.  P's A fragment of slice kk takes keys 2t and
    // 2t + 1 as its k = t and t + 4, so the B fragment of n-tile dd is
    // V[8kk + 2t][8dd + g] and V[8kk + 2t + 1][8dd + g].  Each n-tile sums
    // this tile's keys in registers of its own (a chain of 3 NB products,
    // not one over the whole key axis), then one rounded FMA adds it in
    uint32_t ph[NB][4], pl[NB][4];
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], ph[kk][e], pl[kk][e]);
    }
#pragma unroll
    for (int dd = 0; dd < KS; ++dd) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        const float* p = Vs + (8 * kk + 2 * t4) * RS + 8 * dd + g;
        uint32_t bh0, bl0, bh1, bl1;
        split(p[0], bh0, bl0);
        split(p[RS], bh1, bl1);
        mma(t, pl[kk], bh0, bh1);
        mma(t, ph[kk], bl0, bl1);
        mma(t, ph[kk], bh0, bh1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[dd][e] = fmaf(acc[dd][e], corr[e >> 1], t[e]);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  // normalise (IEEE division, as _kernel's acc / max(l, 1e-30)) and store
  // each thread's (row, 2t and 2t + 1) pairs
  float* ob = o + bi * osb + h * osh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const float den = fmaxf(l[hh], 1e-30f);
    const int r = q0 + wr + g + 8 * hh;
    if (r >= tq) continue;
    float* orow = ob + (long long)r * ost + 2 * t4;
#pragma unroll
    for (int dd = 0; dd < KS; ++dd)
      *reinterpret_cast<float2*>(orow + 8 * dd) =
          make_float2(acc[dd][2 * hh] / den, acc[dd][2 * hh + 1] / den);
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
        fa_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((tq + BQ - 1) / BQ, b * hq);
  fa_f32_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, tq, tk,
      causal, window, scale * 1.4426950408889634f, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // namespace tf32

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

// bfloat16 -> bf16 tensor-core route, float32 -> 3xTF32 route
int launch_d(int bf16, int d, const void* q, const void* k, const void* v,
             void* o, int b, int hq, int hkv, int tq, int tk, int causal,
             int window, float scale, const long long* st,
             cudaStream_t stream) {
#define FA_CASE(D)                                                         \
  case D:                                                                  \
    return bf16 ? tc::launch<D>(q, k, v, o, b, hq, hkv, tq, tk, causal,    \
                                window, scale, st, stream)                 \
                : tf32::launch<D>(q, k, v, o, b, hq, hkv, tq, tk, causal,  \
                                  window, scale, st, stream);
  switch (d) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
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
