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
// Design.  One block of 256 threads owns one (batch * q-head, 64-row query
// tile) and walks the key axis in 64-key tiles (the TPU's sequential K grid
// axis becomes a loop; blocks of heavy causal tiles are issued first).  The
// loop visits only the key tiles that the causal/window mask does not hide
// entirely, so a causal prefill does about half the work of a full one.
// Running max m, denominator l and the (64, D) accumulator stay in float32
// registers: each thread owns 4 query rows and 4 key columns of the score
// tile and D/16 columns of the accumulator, and the 16 threads sharing a
// row group reduce row max and sum with warp shuffles.  Q (pre-scaled) and
// K sit transposed in shared memory so that one 16-byte load feeds 16 FMAs;
// V and the probability tile sit row-major.  Tq/Tk edges are masked in the
// kernel (rows past Tq are zero-filled and not stored).  Arithmetic is
// float32 FMA on the CUDA cores: no tensor cores yet.
//
// Bound on the H100: causal prefill at (4, 16, 1024, 128) is ~17 GFLOP on
// ~67 MB of bf16 q/k/v/out, so it is bound by operations — at the bf16
// tensor-core rate the least time is ~17 us.  On the CUDA cores in float32
// (67 TFLOP/s peak) this kernel cannot come closer than ~0.26 ms; moving the
// two products to bf16 mma/wgmma with TMA-fed tiles is the redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int PS = BK + 4;    // padded row stride of the probability tile
constexpr int NT = 256;       // threads per block (16 row groups x 16)
constexpr float NEG = -1e30f; // masked score (finite, as in the TPU kernel)

// 8 consecutive elements (16-byte aligned for bf16, 32 bytes for f32)
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// accumulator column c (of D/16) of thread tx
template <int D>
__device__ __forceinline__ int acc_col(int tx, int c) {
  constexpr int NC = D / 16;
  if constexpr (NC >= 4) {
    return (c / 4) * 64 + tx * 4 + (c % 4);
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

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int b, int hq, int hkv, int tq, int tk, int causal, int window,
             float scale, const long long* st, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, tq, tk, causal, window,
                           scale, st, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, tq, tk, causal, window,
                           scale, st, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, tq, tk, causal, window,
                            scale, st, stream);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, tq, tk, causal,
                                   window, scale, st, s);
  return launch_d<float>(d, q, k, v, o, b, hq, hkv, tq, tk, causal, window,
                         scale, st, s);
}
