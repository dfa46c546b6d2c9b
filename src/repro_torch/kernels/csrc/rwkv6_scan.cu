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
// Bound on the H100 at (4, 512, 32, 64) bf16 r/k/v: the function moves
// ~61 MB (r, k, v bf16 and w f32 in, out f32 and the state out: 18.2 us at
// 3.35 TB/s).  Its products are 1.33 GFLOP (A and A V over the strict lower
// triangle, r~ S and k~^T V in full): 19.9 us in float32 at 67 TFLOP/s,
// the bound of a kernel that multiplies on the CUDA cores.  (Counting A
// and A V over the whole 32 x 32 square gives 1.6 GFLOP and ~24 us.)  Here
// they run on the TF32 tensor cores in two or three passes (below), 3.3
// GFLOP at 495 TFLOP/s: 6.7 us, so the bytes bound the function at 18.2 us.
//
// Design.  A cluster of NS = 4 blocks of 128 threads per (batch, head), so
// the grid has B * H * 4 blocks (512 at the served shape, five resident per
// SM, all in one wave).  The TPU's sequential chunk axis is a loop inside
// each block.
//   * Key-row split.  Block q of the cluster owns the key columns
//     [16q, 16q + 16) of r, k, w and the matching 16 rows of S (16 x 64
//     float32, 8 values a thread in registers for the whole walk).  Every
//     term of a chunk's output is a sum over key columns, so block q
//     computes the part of A V + diag V + r~ S that its 16 columns give
//     (A_q = r~_q k~_q^T, diag_q, r~_q S_q), and S_q's update k~_q^T V,
//     from its own columns and all 64 value columns of v.  Nothing else
//     crosses blocks: each block stores its 32 x 64 partial output into the
//     shared memory of the block that owns the rows (block p owns steps
//     [8p, 8p + 8)), which adds the four partials in the order q = 0..3
//     and writes out.  So no logf / expf is evaluated twice, each input
//     byte is read from device memory once (v once per block, through L2),
//     every sum runs in a fixed order and nothing is atomic: a call is
//     deterministic.
//   * One cluster barrier a chunk.  The partial buffers are double-buffered
//     and chunk c's partials are added up in the next iteration, after
//     chunk c + 1's products, so the barrier's wait finds the other blocks
//     long arrived; the arrive, whose release costs a memory barrier, comes
//     after the next chunk's preparation.
//   * Pipelined chunks.  Once a chunk's preparation has read the shared
//     stage, the next chunk's r, k, w and v are copied into it by cp.async
//     (16-byte pieces, from per-thread pointers that advance a chunk a
//     call), under this chunk's products and the reduction.
//   * Preparation in registers.  One lane per step (L = 32 is the warp
//     width), four key columns a warp side by side (a padded step takes
//     log 1, not a branch): log w, the cumulative log-decay as a warp scan
//     (five shuffles), exp(logD_t) and exp(-logD_t) with the precise logf /
//     expf; exp(logD_{t-1}) for r~ is lane t - 1's exp(logD_t).
//   * Products on the tensor cores, mma.sync m16n8k8 TF32, in 3xTF32: each
//     float32 operand x = hi + lo with hi = x cut to TF32 and lo the exact
//     remainder (read cut to TF32 in turn), and a b ~ a_lo b_hi + a_hi b_lo
//     + a_hi b_hi keeps all but ~2^-19 of each product, where one TF32 pass
//     keeps 2^-10 and misses the 1e-4 the scan is held to (k~ reaches e^8
//     within a chunk).  A bfloat16 v is exact in TF32, so A_q V and k~_q^T V
//     take two passes.  Each warp owns 16 value columns of the partial
//     output and of k~_q^T V, and two (warps 2, 3: one) 16 x 8 tiles of
//     A_q, whose r~ fragments it shares with r~_q S_q.
//   * Widths.  Dk = Dv = 64 with 16-byte aligned operands loads by
//     cp.async; other Dk, Dv <= 64 load element by element and pad with
//     zeros inside the kernel (r = k = 0, w = 1, v = 0).  The products run
//     at the padded width, fixed at compile time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int L = 32;        // chunk length: one lane per step
constexpr int D = 64;        // Dk, Dv padded to this width
constexpr int NS = 4;        // blocks per (batch, head): one cluster
constexpr int KS = D / NS;   // key columns (rows of S) a block owns
constexpr int RP = L / NS;   // output steps a block adds up and stores
constexpr int NT = 128;
// Row strides (in elements), each chosen so that the fragment and row
// loads below are free of bank conflicts.
constexpr int RT = KS + 4;   // r~ (float32)
constexpr int KT = KS + 8;   // k~ (float32)
constexpr int AT = L + 4;    // A_q (float32)
constexpr int ST = D + 8;    // S_q (float32)
constexpr int VT = D + 8;    // v (input type)
constexpr unsigned FULL = 0xffffffffu;

// One staged chunk, rows as they lie in device memory: this block's 16 key
// columns of r, k, w and all 64 value columns of v.
template <typename T>
struct Stage {
  static constexpr int rk = KS * (int)sizeof(T);  // r, k row bytes
  static constexpr int w = KS * 4;
  static constexpr int v = D * (int)sizeof(T);
  static constexpr int r_off = 0;
  static constexpr int k_off = L * rk;
  static constexpr int w_off = 2 * L * rk;
  static constexpr int v_off = 2 * L * rk + L * w;
  static constexpr int bytes = v_off + L * v;
};

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)(L * RT + L * KT + L * AT + KS * ST + 2 * NS * RP * D +
                  5 * L + KS) * sizeof(float) +
         (size_t)L * VT * sizeof(T) + (size_t)Stage<T>::bytes;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// address of the same shared-memory location in block `rank` of the cluster
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(unsigned addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
               :: "r"(addr), "f"(a), "f"(b) : "memory");
}

// barrier.cluster.arrive has release, barrier.cluster.wait acquire semantics
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// 3xTF32 on mma.sync m16n8k8: x = hi + lo with hi = x cut to TF32 and lo
// the exact float32 remainder, which the tensor cores read cut to TF32 in
// turn; so each product keeps all but ~2^-19 of itself.
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], unsigned (&hi)[N],
                                      unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = __float_as_uint(x[i]) & 0xffffe000u;
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
  }
}
// d (16 x 8) += a (16 x 8, row) b (8 x 8, col), fragments as PTX lays them
// out for lane 4 g + t: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); d0, d1 (g, 2t and 2t + 1),
// d2, d3 (g + 8, 2t and 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B fragment of v (rows p and p + 4 VT): TF32 high and low parts; a
// bfloat16 is exact in TF32, so its low part is zero and never used.
struct VFrag {
  unsigned hi[2], lo[2];
};
template <typename T>
__device__ __forceinline__ VFrag v_frag(const T* p) {
  VFrag f;
  if constexpr (sizeof(T) == 2) {
    f.hi[0] = (unsigned)__bfloat16_as_ushort(p[0]) << 16;
    f.hi[1] = (unsigned)__bfloat16_as_ushort(p[4 * VT]) << 16;
    f.lo[0] = f.lo[1] = 0u;
  } else {
    const float x[2] = {p[0], p[4 * VT]};
    split(x, f.hi, f.lo);
  }
  return f;
}
// d += a v in 3xTF32 (two passes when v is exact)
template <typename T>
__device__ __forceinline__ void mma_v(float (&d)[4], const unsigned (&ah)[4],
                                      const unsigned (&al)[4],
                                      const VFrag& b) {
  mma(d, al, b.hi[0], b.hi[1]);
  if constexpr (sizeof(T) == 4) mma(d, ah, b.lo[0], b.lo[1]);
  mma(d, ah, b.hi[0], b.hi[1]);
}

// four consecutive staged values as float32
template <typename T>
__device__ __forceinline__ void load4(const unsigned char* p, float* o) {
  if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    o[0] = f.x, o[1] = f.y, o[2] = f.z, o[3] = f.w;
  } else {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 a = __bfloat1622float2(b[0]), c = __bfloat1622float2(b[1]);
    o[0] = a.x, o[1] = a.y, o[2] = c.x, o[3] = c.y;
  }
}

struct Geom {
  long long rk0, v0, rk_row, v_row;  // element offsets / row strides
  int tlen, dk, dv, kc0;
};

// Stages the chunks in turn: this block's 16 key columns of r, k, w and all
// 64 value columns of v.  Rows past T (and, on the element path, columns
// past Dk / Dv) are left as they are; the preparation masks them.  On the
// cp.async path each thread copies the same 16-byte pieces of every chunk,
// from pointers that advance a chunk a call.
template <typename T, bool FAST>
struct Loader {
  using S = Stage<T>;
  static constexpr int E = 16 / (int)sizeof(T);  // elements in 16 bytes
  static constexpr int NRK = S::rk / 16, NW = S::w / 16, NV = S::v / 16;
  const T *r, *k, *v;
  const float* w;
  Geom g;
  int tid, rk_t, w_t, v_t;        // first row of each array's pieces
  const T *rp, *kp, *vp;          // the pieces of the next chunk
  const float* wp;
  unsigned rk_s, w_s, v_s;        // their byte offsets in the stage

  __device__ Loader(const T* r_, const T* k_, const T* v_, const float* w_,
                    const Geom& g_, int tid_)
      : r(r_), k(k_), v(v_), w(w_), g(g_), tid(tid_) {
    rk_t = tid / NRK, w_t = tid / NW, v_t = tid / NV;
    const int rk_p = tid % NRK, w_p = tid % NW, v_p = tid % NV;
    rp = r + g.rk0 + rk_t * g.rk_row + g.kc0 + rk_p * E;
    kp = k + (rp - r);
    wp = w + g.rk0 + w_t * g.rk_row + g.kc0 + w_p * 4;
    vp = v + g.v0 + v_t * g.v_row + v_p * E;
    rk_s = rk_t * S::rk + rk_p * 16;
    w_s = S::w_off + w_t * S::w + w_p * 16;
    v_s = S::v_off + v_t * S::v + v_p * 16;
  }

  // stages the chunk at step t0, the one after the last call's
  __device__ __forceinline__ void issue(unsigned char* st, int t0) {
    if constexpr (FAST) {
#pragma unroll
      for (int j = 0; j < (L * NRK + NT - 1) / NT; ++j) {
        const int t = rk_t + j * (NT / NRK);
        if (t < L && t0 + t < g.tlen) {
          const long long e = j * (NT / NRK) * g.rk_row;
          cp_async16(st + S::r_off + rk_s + j * (NT / NRK) * S::rk, rp + e);
          cp_async16(st + S::k_off + rk_s + j * (NT / NRK) * S::rk, kp + e);
        }
      }
#pragma unroll
      for (int j = 0; j < (L * NW + NT - 1) / NT; ++j) {
        const int t = w_t + j * (NT / NW);
        if (t < L && t0 + t < g.tlen)
          cp_async16(st + w_s + j * (NT / NW) * S::w,
                     wp + j * (NT / NW) * g.rk_row);
      }
#pragma unroll
      for (int j = 0; j < (L * NV + NT - 1) / NT; ++j) {
        const int t = v_t + j * (NT / NV);
        if (t < L && t0 + t < g.tlen)
          cp_async16(st + v_s + j * (NT / NV) * S::v,
                     vp + j * (NT / NV) * g.v_row);
      }
      rp += L * g.rk_row, kp += L * g.rk_row, wp += L * g.rk_row;
      vp += L * g.v_row;
    } else {
      for (int i = tid; i < L * KS; i += NT) {
        const int t = i / KS, c = i % KS, tt = t0 + t;
        if (tt >= g.tlen || g.kc0 + c >= g.dk) continue;
        const long long e = g.rk0 + tt * g.rk_row + g.kc0 + c;
        reinterpret_cast<T*>(st + S::r_off + t * S::rk)[c] = r[e];
        reinterpret_cast<T*>(st + S::k_off + t * S::rk)[c] = k[e];
        reinterpret_cast<float*>(st + S::w_off + t * S::w)[c] = w[e];
      }
      for (int i = tid; i < L * D; i += NT) {
        const int t = i / D, j = i % D, tt = t0 + t;
        if (tt >= g.tlen || j >= g.dv) continue;
        reinterpret_cast<T*>(st + S::v_off + t * S::v)[j] =
            v[g.v0 + tt * g.v_row + j];
      }
    }
  }
};

template <typename T, bool FAST>
__global__ void __cluster_dims__(NS, 1, 1) __launch_bounds__(NT, 5)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, float* __restrict__ out,
             float* __restrict__ state, int tlen, int nh, int dk, int dv) {
  using St = Stage<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* rt = reinterpret_cast<float*>(smem);  // [L][RT] r~ of own columns
  float* kt = rt + L * RT;                     // [L][KT] k~
  float* A = kt + L * KT;                      // [L][AT] A_q
  float* Sb = A + L * AT;                      // [KS][ST] S_q
  float* part = Sb + KS * ST;                  // [2][NS][RP][D] partial out
  float* dpart = part + 2 * NS * RP * D;       // [4][L] diag_q by warp
  float* dfull = dpart + 4 * L;                // [KS] exp(logD_L)
  float* diag = dfull + KS;                    // [L] diag_q
  T* vs = reinterpret_cast<T*>(diag + L);      // [L][VT] v, all columns
  unsigned char* stage = reinterpret_cast<unsigned char*>(vs + L * VT);

  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const unsigned rank = cluster_rank();
  const int bh = blockIdx.x / NS, bi = bh / nh, h = bh % nh;
  Geom g;
  g.rk_row = (long long)nh * dk;
  g.v_row = (long long)nh * dv;
  g.rk0 = (long long)bi * tlen * g.rk_row + (long long)h * dk;
  g.v0 = (long long)bi * tlen * g.v_row + (long long)h * dv;
  g.tlen = tlen, g.dk = dk, g.dv = dv;
  g.kc0 = (int)rank * KS;
  const int nch = (tlen + L - 1) / L;

  // preparation: warp wi, lane = step, own key columns pc .. pc + 3
  const int pc = 4 * wi;
  float uu[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = g.kc0 + pc + i;
    uu[i] = c < dk ? u[h * dk + c] : 0.f;
  }
  // this warp's output and S columns: the 8-wide tiles n0 and n0 + 1
  const int n0 = 2 * wi;
  // S_q in mma accumulator layout: rows g8 (+ 8), columns 8 n + 2 t4 (+ 1)
  float S[2][4], kv[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n) S[n][0] = S[n][1] = S[n][2] = S[n][3] = 0.f;
  for (int i = tid; i < KS * ST; i += NT) Sb[i] = 0.f;
  // this block's partial-output slot (row g8, column 2 t4) in every owner
  const unsigned a_part = smem_u32(part + (rank * RP + g8) * D + 2 * t4);

  // every block of the cluster runs before any stores into its memory
  cluster_arrive();
  cluster_wait();

  Loader<T, FAST> loader(r, k, v, w, g, tid);
  loader.issue(stage, 0);
  cp_commit();
  for (int ci = 0; ci <= nch; ++ci) {
    const int t0 = ci * L;
    if (ci < nch) {
      cp_wait_all();
      __syncthreads();  // the stage is in; the last chunk's tiles are read
      if (ci > 0) {  // S_q for this chunk's r~_q S_q
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float* sp = Sb + g8 * ST + 8 * (n0 + n) + 2 * t4;
          *reinterpret_cast<float2*>(sp) = make_float2(S[n][0], S[n][1]);
          *reinterpret_cast<float2*>(sp + 8 * ST) =
              make_float2(S[n][2], S[n][3]);
        }
      }

      // --- preparation of the own 16 key columns
      const bool tv = t0 + lane < tlen;
      float rr[4], kk[4], ww[4];
      load4<T>(stage + St::r_off + lane * St::rk + pc * sizeof(T), rr);
      load4<T>(stage + St::k_off + lane * St::rk + pc * sizeof(T), kk);
      load4<float>(stage + St::w_off + lane * St::w + pc * 4, ww);
      // the four columns side by side, so that their latencies overlap
      float x[4], dsum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = tv && g.kc0 + pc + i < dk;
        x[i] = logf(ok ? ww[i] : 1.f);  // a padded step: w = 1
        rr[i] = ok ? rr[i] : 0.f;
        kk[i] = ok ? kk[i] : 0.f;
        dsum += rr[i] * (uu[i] * kk[i]);
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1) {  // inclusive scan over the steps
        float y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i] = __shfl_up_sync(FULL, x[i], o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (lane >= o) x[i] += y[i];
      }
      // exp(logD_{t-1}) is lane t - 1's exp(logD_t)
      float rtv[4], ktv[4], dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dl[i] = expf(x[i]);
        ktv[i] = kk[i] * expf(-x[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float prev = __shfl_up_sync(FULL, dl[i], 1);
        if (lane == 0) prev = 1.f;
        rtv[i] = rr[i] * prev;
      }
      *reinterpret_cast<float4*>(rt + lane * RT + pc) =
          make_float4(rtv[0], rtv[1], rtv[2], rtv[3]);
      *reinterpret_cast<float4*>(kt + lane * KT + pc) =
          make_float4(ktv[0], ktv[1], ktv[2], ktv[3]);
      dpart[wi * L + lane] = dsum;
      if (lane == L - 1)
        *reinterpret_cast<float4*>(dfull + pc) =
            make_float4(dl[0], dl[1], dl[2], dl[3]);
      // v, zero past T and past Dv
      if constexpr (FAST) {
        constexpr int E = 16 / (int)sizeof(T), nv = D / E;
#pragma unroll
        for (int jj = 0; jj < L * nv / NT; ++jj) {
          const int t = tid / nv + jj * (NT / nv), p = tid % nv;
          uint4 x = make_uint4(0u, 0u, 0u, 0u);
          if (t0 + t < tlen)
            x = *reinterpret_cast<const uint4*>(stage + St::v_off +
                                                t * St::v + p * 16);
          *reinterpret_cast<uint4*>(vs + t * VT + p * E) = x;
        }
      } else {
        for (int i = tid; i < L * D; i += NT) {
          const int t = i / D, j = i % D;
          vs[t * VT + j] =
              t0 + t < tlen && j < dv
                  ? reinterpret_cast<const T*>(stage + St::v_off + t * St::v)[j]
                  : T(0.f);
        }
      }
      // the last chunk's partials are sent and the one before's added up:
      // arrive, a preparation after the sends, so that the release finds
      // them delivered
      if (ci > 0) cluster_arrive();
      __syncthreads();  // the stage is read; r~, k~, v are in

      // the next chunk's loads run under this chunk's products
      if (ci + 1 < nch) loader.issue(stage, t0 + L);
      cp_commit();

      if (tid < L)  // the u-bonus diagonal of the own columns
        diag[tid] = ((dpart[tid] + dpart[L + tid]) + dpart[2 * L + tid]) +
                    dpart[3 * L + tid];

      // --- tensor cores.  This warp's 16 value columns (8-wide tiles n0,
      // n0 + 1) of the partial output r~_q S_q (+ A_q V below) and of
      // k~_q^T V; and two 16 x 8 tiles (m, n) of A_q = r~_q k~_q^T, which
      // share the r~ fragments of r~_q S_q: (0, 0), (1, 2) in warp 0,
      // (0, 1), (1, 3) in warp 1, (1, 0) in warp 2, (1, 1) in warp 3.
      float acc[2][2][4] = {};  // [m tile][n][fragment]
      float a4[2][4] = {};      // this warp's tiles of A_q
      const int am0 = wi >= 2 ? 1 : 0, an0 = wi >= 2 ? wi - 2 : wi;
#pragma unroll
      for (int ks = 0; ks < KS / 8; ++ks) {
        unsigned bh[2][2], bl[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* bp = Sb + (8 * ks + t4) * ST + 8 * (n0 + n) + g8;
          const float b[2] = {bp[0], bp[4 * ST]};
          split(b, bh[n], bl[n]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* ap = rt + (16 * mt + g8) * RT + 8 * ks + t4;
          const float a[4] = {ap[0], ap[8 * RT], ap[4], ap[8 * RT + 4]};
          unsigned ah[4], al[4];
          split(a, ah, al);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma(acc[mt][n], al, bh[n][0], bh[n][1]);
            mma(acc[mt][n], ah, bl[n][0], bl[n][1]);
            mma(acc[mt][n], ah, bh[n][0], bh[n][1]);
          }
#pragma unroll
          for (int it = 0; it < 2; ++it) {  // A_q tiles in row tile mt
            const int tm = it == 0 ? am0 : 1, tn = it == 0 ? an0 : wi + 2;
            if (tm != mt || (it == 1 && wi >= 2)) continue;
            const float* kp = kt + (8 * tn + g8) * KT + 8 * ks + t4;
            const float kb[2] = {kp[0], kp[4]};
            unsigned kh[2], kl[2];
            split(kb, kh, kl);
            mma(a4[it], al, kh[0], kh[1]);
            mma(a4[it], ah, kl[0], kl[1]);
            mma(a4[it], ah, kh[0], kh[1]);
          }
        }
      }
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        if (it == 1 && wi >= 2) break;
        const int tm = it == 0 ? am0 : 1, tn = it == 0 ? an0 : wi + 2;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = 16 * tm + g8 + 8 * hf, s = 8 * tn + 2 * t4;
          *reinterpret_cast<float2*>(A + t * AT + s) =
              make_float2(s < t ? a4[it][2 * hf] : 0.f,
                          s + 1 < t ? a4[it][2 * hf + 1] : 0.f);
        }
      }
      __syncthreads();  // A_q and the diagonal are in
      // k~_q^T V (rows g8, g8 + 8 of S_q) and A_q V, sharing v's fragments
#pragma unroll
      for (int n = 0; n < 2; ++n) kv[n][0] = kv[n][1] = kv[n][2] = kv[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < L / 8; ++ks) {
        VFrag b[2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
          b[n] = v_frag<T>(vs + (8 * ks + t4) * VT + 8 * (n0 + n) + g8);
        {
          const float* ap = kt + (8 * ks + t4) * KT + g8;
          const float a[4] = {ap[0], ap[8], ap[4 * KT], ap[4 * KT + 8]};
          unsigned ah[4], al[4];
          split(a, ah, al);
#pragma unroll
          for (int n = 0; n < 2; ++n) mma_v<T>(kv[n], ah, al, b[n]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (ks >= 2 * (mt + 1)) continue;  // A_q is zero above the diagonal
          const float* ap = A + (16 * mt + g8) * AT + 8 * ks + t4;
          const float a[4] = {ap[0], ap[8 * AT], ap[4], ap[8 * AT + 4]};
          unsigned ah[4], al[4];
          split(a, ah, al);
#pragma unroll
          for (int n = 0; n < 2; ++n) mma_v<T>(acc[mt][n], ah, al, b[n]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)  // + diag_q v
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = 16 * mt + g8 + 8 * hf;
          const float dg = diag[t];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int j = 8 * (n0 + n) + 2 * t4;
            acc[mt][n][2 * hf] += dg * (float)vs[t * VT + j];
            acc[mt][n][2 * hf + 1] += dg * (float)vs[t * VT + j + 1];
          }
        }

      // every owner has added up chunk ci - 2's partials from the buffer
      // this chunk's go into, and every partial of chunk ci - 1 is in
      if (ci > 0) cluster_wait();
      // --- send this chunk's partial: steps 8 p .. 8 p + 7 to block p
      const int buf = (ci & 1) * NS * RP * D;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const unsigned p = 2 * mt + hf;
          if (p == rank) {
            float* dst = part + buf + (rank * RP + g8) * D + 2 * t4;
#pragma unroll
            for (int n = 0; n < 2; ++n)
              *reinterpret_cast<float2*>(dst + 8 * (n0 + n)) =
                  make_float2(acc[mt][n][2 * hf], acc[mt][n][2 * hf + 1]);
          } else {
            const unsigned dst = mapa(a_part + buf * 4, p);
#pragma unroll
            for (int n = 0; n < 2; ++n)
              st_cluster(dst + 8 * (n0 + n) * 4, acc[mt][n][2 * hf],
                         acc[mt][n][2 * hf + 1]);
          }
        }
    } else if (ci > 0) {
      cluster_arrive();
      cluster_wait();  // every partial of the last chunk is in
    }

    // --- add up chunk ci - 1's four partials of this block's steps
    if (ci > 0) {
      const int row = tid >> 4, c4 = 4 * (tid & 15);
      const float* pp = part + ((ci - 1) & 1) * NS * RP * D + row * D + c4;
      float4 o = *reinterpret_cast<const float4*>(pp);
#pragma unroll
      for (int q = 1; q < NS; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(pp + q * RP * D);
        o.x += x.x, o.y += x.y, o.z += x.z, o.w += x.w;
      }
      const int tt = t0 - L + (int)rank * RP + row;
      if (tt < tlen) {
        float* op = out + g.v0 + (long long)tt * g.v_row + c4;
        if constexpr (FAST) {
          *reinterpret_cast<float4*>(op) = o;
        } else {
          const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (c4 + i < dv) op[i] = ov[i];
        }
      }
    }

    if (ci < nch) {
      // --- S_q <- diag(exp(logD_L)) (S_q + k~_q^T V), in registers; the
      // next chunk stores it for its r~_q S_q once every warp has read it
      const float d0 = dfull[g8], d1 = dfull[g8 + 8];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        S[n][0] = d0 * (S[n][0] + kv[n][0]);
        S[n][1] = d0 * (S[n][1] + kv[n][1]);
        S[n][2] = d1 * (S[n][2] + kv[n][2]);
        S[n][3] = d1 * (S[n][3] + kv[n][3]);
      }
    }
  }

  float* sp = state + (long long)bh * dk * dv;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = g.kc0 + g8 + 8 * (i >> 1);
      const int j = 8 * (n0 + n) + 2 * t4 + (i & 1);
      if (c < dk && j < dv) sp[(long long)c * dv + j] = S[n][i];
    }
}

template <typename T, bool FAST>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, float* out, float* state, int b, int t, int h,
           int dk, int dv, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  static bool attr_set = false;  // per instantiation, outside graph capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        rwkv6_kernel<T, FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  rwkv6_kernel<T, FAST><<<b * h * NS, NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, out, state, t, h, dk, dv);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Blocks the kernel launches for B * H = bh heads.
extern "C" int rwkv6_grid_blocks(int bh) { return bh * NS; }

// r, k (B, T, H, Dk) and v (B, T, H, Dv) contiguous, float32 or bfloat16;
// w (B, T, H, Dk) and u (H, Dk) float32; out (B, T, H, Dv) and state
// (B, H, Dk, Dv) float32.
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const void* w, const void* u, void* out,
                            void* state, int bf16, int b, int t, int h,
                            int dk, int dv, void* stream) {
  if (dk < 1 || dk > D || dv < 1 || dv > D) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* of = static_cast<float*>(out);
  float* sf = static_cast<float*>(state);
  const bool fast = dk == D && dv == D && aligned16(r) && aligned16(k) &&
                    aligned16(v) && aligned16(w) && aligned16(out);
  if (bf16)
    return fast ? launch<__nv_bfloat16, true>(r, k, v, wf, uf, of, sf, b, t, h, dk, dv, s)
                : launch<__nv_bfloat16, false>(r, k, v, wf, uf, of, sf, b, t, h, dk, dv, s);
  return fast ? launch<float, true>(r, k, v, wf, uf, of, sf, b, t, h, dk, dv, s)
              : launch<float, false>(r, k, v, wf, uf, of, sf, b, t, h, dk, dv, s);
}
