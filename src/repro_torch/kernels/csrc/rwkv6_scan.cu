// RWKV6 (Finch) WKV recurrence as a chunked scan, for Hopper (sm_90a).
// Hand-written CUDA C++, bound to PyTorch through a plain C interface and
// ctypes (repro_torch/kernels/rwkv6_scan.py).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan (body
// _kernel).  Per (batch, head), from a zero state S (Dk, Dv), over chunks of
// L = 32 steps with cumulative log-decays logD_t = sum_{s<=t} log w_s:
//   r~_t = r_t exp(logD_{t-1})      k~_s = k_s exp(-logD_s)
//   A[t,s] = r~_t . k~_s (s < t)    diag_t = r_t . (u * k_t)
//   out   = A V + diag * V + r~ S
//   S    <- diag(exp(logD_L)) (S + k~^T V)
// which is the reference's algebra, float32 range limit for strong decays
// included.  Besides out (B, T, H, Dv) it writes the final state
// (B, H, Dk, Dv), which the TPU kernel keeps in VMEM scratch and the
// model's prefill needs.  Steps past T are padded inside the kernel as the
// reference's wkv_chunked pads them (w = 1, r = k = v = 0: the state is
// unchanged) and not stored.
//
// Design.  One block of 256 threads per (batch, head); the TPU's sequential
// chunk axis is a loop inside the block, and S lives in shared memory for
// the whole walk.  Per chunk the block loads r, k, v (float32 or bfloat16)
// and w (float32) into padded shared tiles, runs the per-column cumulative
// sum of log w, forms r~ and k~, then the three small products on the CUDA
// cores in float32.  Dk, Dv <= 64.
//
// Bound on the H100: at (4, 512, 32, 64) the function moves ~61 MB (r, k,
// v bf16 and w f32 in, out f32 and the state out, ~18 us at 3.35 TB/s) and
// does ~1.6 GFLOP of float32 products (~24 us at 67 TFLOP/s), so the f32
// rate bounds it.  With one block per (batch, head) only 128
// blocks run — fewer than the 132 SMs, each with 8 warps — so the kernel is
// bound by the latency of one SM's chunk loop; splitting the (Dk, Dv) state
// across blocks, or the chunks with a second pass, is the redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int L = 32;        // chunk length
constexpr int DM = 64;       // largest Dk / Dv
constexpr int DP = DM + 1;   // padded row stride of the (L, D) tiles
constexpr int NT = 256;

__device__ __forceinline__ float to_f32(const float* p) { return *p; }
__device__ __forceinline__ float to_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

constexpr size_t smem_bytes() {
  return (size_t)(4 * L * DP + DM * DM + L * (L + 1) + 2 * DM + L) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(NT) rwkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    float* __restrict__ out, float* __restrict__ state, int tlen, int nh,
    int dk, int dv) {
  extern __shared__ float sm[];
  float* rt = sm;               // [L][DP]  r, then r~
  float* kt = rt + L * DP;      // [L][DP]  k, then k~
  float* vs = kt + L * DP;      // [L][DP]  v
  float* lg = vs + L * DP;      // [L][DP]  log w, then logD
  float* S = lg + L * DP;       // [DM][DM] state (row stride dv)
  float* A = S + DM * DM;       // [L][L + 1]
  float* us = A + L * (L + 1);  // [DM] bonus
  float* dfull = us + DM;       // [DM] exp(logD_L)
  float* diag = dfull + DM;     // [L]

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / nh, h = blockIdx.x % nh;
  const long long rk_row = (long long)nh * dk, v_row = (long long)nh * dv;
  const long long rk0 = (long long)bi * tlen * rk_row + (long long)h * dk;
  const long long v0 = (long long)bi * tlen * v_row + (long long)h * dv;

  for (int i = tid; i < dk * dv; i += NT) S[i] = 0.f;
  for (int c = tid; c < dk; c += NT) us[c] = u[h * dk + c];

  for (int t0 = 0; t0 < tlen; t0 += L) {
    __syncthreads();  // previous chunk done with every tile
    for (int i = tid; i < L * dk; i += NT) {
      const int t = i / dk, c = i % dk, tt = t0 + t;
      const long long g = rk0 + (long long)tt * rk_row + c;
      const bool in = tt < tlen;
      rt[t * DP + c] = in ? to_f32(r + g) : 0.f;
      kt[t * DP + c] = in ? to_f32(k + g) : 0.f;
      lg[t * DP + c] = in ? logf(w[g]) : 0.f;
    }
    for (int i = tid; i < L * dv; i += NT) {
      const int t = i / dv, c = i % dv, tt = t0 + t;
      vs[t * DP + c] = tt < tlen ? to_f32(v + v0 + (long long)tt * v_row + c) : 0.f;
    }
    __syncthreads();

    if (tid < dk) {  // cumulative log-decay per key column
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        run += lg[t * DP + tid];
        lg[t * DP + tid] = run;
      }
    } else if (tid >= DM && tid < DM + L) {  // u-bonus diagonal
      const int t = tid - DM;
      float s = 0.f;
      for (int c = 0; c < dk; ++c) s += rt[t * DP + c] * (us[c] * kt[t * DP + c]);
      diag[t] = s;
    }
    __syncthreads();

    for (int i = tid; i < L * dk; i += NT) {
      const int t = i / dk, c = i % dk;
      const float prev = t > 0 ? lg[(t - 1) * DP + c] : 0.f;
      rt[t * DP + c] *= expf(prev);
      kt[t * DP + c] *= expf(-lg[t * DP + c]);
    }
    for (int c = tid; c < dk; c += NT) dfull[c] = expf(lg[(L - 1) * DP + c]);
    __syncthreads();

    for (int i = tid; i < L * L; i += NT) {  // strict lower triangle
      const int t = i / L, s = i % L;
      float a = 0.f;
      if (s < t)
        for (int c = 0; c < dk; ++c) a += rt[t * DP + c] * kt[s * DP + c];
      A[t * (L + 1) + s] = a;
    }
    __syncthreads();

    for (int i = tid; i < L * dv; i += NT) {
      const int t = i / dv, j = i % dv;
      float o = 0.f;
      for (int s = 0; s < t; ++s) o += A[t * (L + 1) + s] * vs[s * DP + j];
      o += diag[t] * vs[t * DP + j];
      float o2 = 0.f;
      for (int c = 0; c < dk; ++c) o2 += rt[t * DP + c] * S[c * dv + j];
      o += o2;
      if (t0 + t < tlen) out[v0 + (long long)(t0 + t) * v_row + j] = o;
    }
    __syncthreads();  // S read by every output row before it changes

    for (int i = tid; i < dk * dv; i += NT) {
      const int c = i / dv, j = i % dv;
      float s = 0.f;
      for (int t = 0; t < L; ++t) s += kt[t * DP + c] * vs[t * DP + j];
      S[i] = dfull[c] * (S[i] + s);
    }
  }
  __syncthreads();
  float* st = state + (long long)blockIdx.x * dk * dv;
  for (int i = tid; i < dk * dv; i += NT) st[i] = S[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, float* out, float* state, int b, int t, int h,
           int dk, int dv, cudaStream_t stream) {
  const size_t smem = smem_bytes();
  static bool attr_set = false;  // per instantiation, outside graph capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        rwkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  rwkv6_kernel<T><<<b * h, NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, out, state, t, h, dk, dv);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k (B, T, H, Dk) and v (B, T, H, Dv) contiguous, float32 or bfloat16;
// w (B, T, H, Dk) and u (H, Dk) float32; out (B, T, H, Dv) and state
// (B, H, Dk, Dv) float32.
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const void* w, const void* u, void* out,
                            void* state, int bf16, int b, int t, int h,
                            int dk, int dv, void* stream) {
  if (dk < 1 || dk > DM || dv < 1 || dv > DM) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* of = static_cast<float*>(out);
  float* sf = static_cast<float*>(state);
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, wf, uf, of, sf, b, t, h, dk, dv, s);
  return launch<float>(r, k, v, wf, uf, of, sf, b, t, h, dk, dv, s);
}
