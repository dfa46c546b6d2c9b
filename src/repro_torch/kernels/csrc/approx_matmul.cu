// Approximate-multiplier matmul with the control-variate epilogue, for
// Hopper (sm_90a).  Hand-written CUDA C++, bound to PyTorch through a plain
// C interface and ctypes (repro_torch/kernels/approx_matmul.py).
//
// Replaces the TPU kernels of repro/kernels/approx_matmul.py:
//   am_fused_launch -> approx_matmul_cv_fused (body _fused_kernel): float
//                      activations quantized on the card, offline-blocked
//                      uint8 weights, (EPI_ROWS, Nb) epilogue table with
//                      per-column weight quant params;
//   am_codes_launch -> approx_matmul_cv (body _kernel): pre-quantized uint8
//                      activation codes, per-tensor quant params.
//
// What it computes, per output (r, c), exactly as the TPU kernels do:
//   acc   = sum_k AM(W[k,c], A[r,k])           exact 32-bit integer
//   sumx  = sum_k x(A[r,k])    sumqa = sum_k A[r,k]
//   out   = sa*sw * (acc + sumx*C + C0 - zw*sumqa - za*sum_qw + K*za*zw) + bias
// with the epilogue evaluated in float32 in the reference's order.  The
// build passes -fmad=false, so no multiply-add is contracted and every
// step rounds as the reference's separate float32 operations do.
//
// Every approximate product is an exact integer sum of unsigned 8-bit
// products, run on the int8 tensor cores (mma.sync m16n8k32 u8.u8.s32):
//   acc = A.W - sum_p (A & amask_p).(W & wmask_p)
//   perforated: one plane (amask = 2^m-1, wmask = 0xFF)
//   recursive : one plane (amask = wmask = 2^m-1)
//   truncated : m planes  (amask = 1<<i, wmask = 2^(m-i)-1)
// Partial sums stay below 255*255*K < 2^31 for K <= 33025 (the wrapper
// checks), so the 32-bit accumulators hold the exact value.
//
// Design.  The float entry first quantizes x once per call into a uint8
// code buffer (quantize_kernel; IEEE division, round half to even, codes
// beyond the true fan-in K written as 0, rows padded to 16 bytes) — the TPU
// kernel re-quantized x in every N block, which on this card would repeat
// one float division per activation in each of N/BN blocks.  The matmul
// kernel then owns a (BM, BN) output tile and loops over K (the TPU's
// sequential K grid axis): a STAGES-deep cp.async pipeline streams code
// tiles straight into the mma operand layout (4 consecutive k per 32-bit
// word) and raw (BK, BN) weight tiles, which each step transposes in shared
// memory with byte permutes so that 4 consecutive k of one column form one
// word as well.  The K and N edges are masked in the kernel (zero-filled
// copies), so the caller pads nothing.  Warps split each tile's K steps
// and add their partial sums at the end; decode-shaped calls (M <= 8) use
// a thin 16 x 32 tile so that N spreads over many blocks.
//
// Bound on the H100: decode reads every weight byte once and does little
// arithmetic per byte, so it is bound by the weight bytes over the memory
// rate; the pipeline keeps three weight tiles per block in flight for it.
// Prefill at M = 128 is below the int8 tensor-core ridge, so it is bound by
// bytes too.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// --- PTX helpers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; bytes beyond src_bytes (0..16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a . b over a 16x32 (row) by 32x8 (col) tile of unsigned bytes
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- quantization -----------------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// quant.quantize_i32: clip(round(x / sa) + za, 0, 255), IEEE division,
// round half to even
__device__ __forceinline__ uint32_t to_code(float x, float sa, float za) {
  float q = rintf(__fdiv_rn(x, sa)) + za;
  q = fminf(fmaxf(q, 0.0f), 255.0f);
  return (uint32_t)q;
}

// One thread per 4 codes of a row; columns in [K, ldq) are written 0.
template <typename InT>
__global__ void quantize_kernel(const InT* __restrict__ x, int M, int K,
                                const float* __restrict__ meta,
                                uint8_t* __restrict__ q, int ldq) {
  const int wpr = ldq / 4;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)M * wpr) return;
  const int r = (int)(idx / wpr), kw = (int)(idx % wpr);
  const float sa = meta[0], za = meta[1];
  const InT* row = x + (size_t)r * K;
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = kw * 4 + i;
    if (k < K) word |= to_code(to_float(row[k]), sa, za) << (8 * i);
  }
  reinterpret_cast<uint32_t*>(q + (size_t)r * ldq)[kw] = word;
}

// --- the matmul kernel ------------------------------------------------------

struct Planes {
  int n;              // number of subtractive planes (0..8)
  uint32_t amask[8];  // activation byte mask, replicated to 4 bytes
  uint32_t wmask[8];  // weight byte mask, replicated to 4 bytes
};

struct Epi {
  const float* c;        // (N,) CV constant C
  const float* c0;       // (N,) CV constant C0
  const float* sumqw_f;  // (N,) float column sums (blocked layout) or null
  const int* sumqw_i;    // (N,) int32 column sums (codes entry) or null
  const float* bias;     // (N,) or null (adds 0.0f)
  const float* sw;       // (N,) per-column weight scale, or null: meta
  const float* zw;       // (N,) per-column weight zero point, or null: meta
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Byte-wise "is this byte nonzero", one bit per byte at bit 7 of it.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t t) {
  return (((t & 0x7f7f7f7fu) + 0x7f7f7f7fu) | t) & 0x80808080u;
}

template <int BM_, int BN_, int BK_, int WM_, int WN_, int KS_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int KS = KS_, STAGES = STAGES_;
  static constexpr int NT = 32 * WM * WN * KS;  // threads
  static constexpr int KW = BK / 4;             // 32-bit words per tile row
  static constexpr int LD = KW + 4;  // padded row stride (words), = 4 mod 8:
                                     // mma fragment loads hit 32 banks
  static constexpr int A_STAGE = BM * LD * 4;   // bytes
  static constexpr int W_STAGE = BK * BN;       // bytes, raw (BK, BN)
  static constexpr int WS = BN * LD * 4;        // transposed weight tile
  static constexpr int OUT_LD = BN + 1;
  static constexpr int OUT = BM * OUT_LD * 4;
  static constexpr int SMEM =
      STAGES * (A_STAGE + W_STAGE) + WS + OUT + 2 * BM * 4;
  static constexpr int MT = BM / WM / 16;  // m16 tiles per warp
  static constexpr int NT8 = BN / WN / 8;  // n8 tiles per warp
  static_assert(BK % 32 == 0 && BN % 16 == 0 && BM % 16 == 0, "tile shape");
  static_assert(MT >= 1 && NT8 >= 1 && (BK / 32) % KS == 0, "warp split");
  static_assert(NT % BM == 0 && (BM * KW) % NT == 0, "stat split");
};

template <typename Cfg, typename OutT, bool PER_COL>
__global__ void __launch_bounds__(Cfg::NT)
am_mma_kernel(const uint8_t* __restrict__ q, int ldq, int M, int K,
              const uint8_t* __restrict__ w, int ldw, int w_cols, int N,
              int vec, Epi epi, const float* __restrict__ meta,
              OutT* __restrict__ out, Planes pl, int stat_kind,
              uint32_t stat_mask4, int use_cv) {
  constexpr int BM = Cfg::BM, BN = Cfg::BN, BK = Cfg::BK, KW = Cfg::KW;
  constexpr int LD = Cfg::LD, NT = Cfg::NT, S = Cfg::STAGES, KS = Cfg::KS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* a_st = smem;                            // S x (BM, LD) words
  uint8_t* w_st = smem + S * Cfg::A_STAGE;         // S x (BK, BN) bytes
  uint32_t* ws = reinterpret_cast<uint32_t*>(w_st + S * Cfg::W_STAGE);
  int* out_s = reinterpret_cast<int*>(ws + BN * LD);
  int* s_sqa = out_s + BM * Cfg::OUT_LD;
  int* s_sx = s_sqa + BM;
  __shared__ uint32_t s_am[8], s_wm[8];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  for (int i = tid; i < BM * Cfg::OUT_LD; i += NT) out_s[i] = 0;
  if (tid < BM) { s_sqa[tid] = 0; s_sx[tid] = 0; }
  if (tid < 8) { s_am[tid] = pl.amask[tid]; s_wm[tid] = pl.wmask[tid]; }
  const int n_planes = pl.n;
  const int nkt = (K + BK - 1) / BK;

  // stage s <- tile kt: codes (BM, BK) into operand layout, raw weights
  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * BK;
    uint8_t* a_dst = a_st + s * Cfg::A_STAGE;
    uint8_t* w_dst = w_st + s * Cfg::W_STAGE;
    if (vec) {
      for (int c = tid; c < BM * (BK / 16); c += NT) {
        const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
        const bool ok = (m0 + r < M) && (k0 + kc < ldq);
        const uint8_t* src = ok ? q + (size_t)(m0 + r) * ldq + k0 + kc : q;
        cp_async16(a_dst + r * LD * 4 + kc, src, ok ? 16 : 0);
      }
      for (int c = tid; c < BK * (BN / 16); c += NT) {
        const int kr = c / (BN / 16), nc = (c % (BN / 16)) * 16;
        const int cols = w_cols - (n0 + nc);
        const bool ok = (k0 + kr < K) && cols > 0;
        const uint8_t* src = ok ? w + (size_t)(k0 + kr) * ldw + n0 + nc : w;
        cp_async16(w_dst + kr * BN + nc, src, ok ? min(cols, 16) : 0);
      }
    } else {  // rows not 16-byte aligned: plain loads
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, k = e % BK;
        a_dst[r * LD * 4 + k] = (m0 + r < M && k0 + k < K)
                                    ? q[(size_t)(m0 + r) * ldq + k0 + k] : 0;
      }
      for (int e = tid; e < BK * BN; e += NT) {
        const int kr = e / BN, c = e % BN;
        w_dst[kr * BN + c] = (k0 + kr < K && n0 + c < w_cols)
                                 ? w[(size_t)(k0 + kr) * ldw + n0 + c] : 0;
      }
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kz = warp % KS, wn = (warp / KS) % Cfg::WN, wm = warp / (KS * Cfg::WN);
  const int mb = wm * (BM / Cfg::WM), nb = wn * (BN / Cfg::WN);
  int acc[Cfg::MT][Cfg::NT8][4], sub[Cfg::MT][Cfg::NT8][4];
#pragma unroll
  for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) { acc[i][j][e] = 0; sub[i][j][e] = 0; }
  const int srow = tid % BM;
  uint32_t sqa = 0u, sx = 0u;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nkt) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    const int s = kt % S;
    const uint32_t* a_w = reinterpret_cast<const uint32_t*>(a_st + s * Cfg::A_STAGE);
    const uint32_t* w_raw = reinterpret_cast<const uint32_t*>(w_st + s * Cfg::W_STAGE);
    // transpose the raw (BK, BN) weight tile into (BN, LD) words
    for (int u = tid; u < KW * (BN / 4); u += NT) {
      const int c4 = u % (BN / 4), kw = u / (BN / 4);
      const uint32_t r0 = w_raw[(4 * kw + 0) * (BN / 4) + c4];
      const uint32_t r1 = w_raw[(4 * kw + 1) * (BN / 4) + c4];
      const uint32_t r2 = w_raw[(4 * kw + 2) * (BN / 4) + c4];
      const uint32_t r3 = w_raw[(4 * kw + 3) * (BN / 4) + c4];
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      ws[(4 * c4 + 0) * LD + kw] = __byte_perm(t0, t2, 0x5410);
      ws[(4 * c4 + 1) * LD + kw] = __byte_perm(t0, t2, 0x7632);
      ws[(4 * c4 + 2) * LD + kw] = __byte_perm(t1, t3, 0x5410);
      ws[(4 * c4 + 3) * LD + kw] = __byte_perm(t1, t3, 0x7632);
    }
    __syncthreads();
    // refill the stage consumed in the previous step
    if (kt + S - 1 < nkt) load_tile(kt + S - 1, (kt + S - 1) % S);
    cp_async_commit();

    // per-row statistics over this tile's codes
#pragma unroll
    for (int i = 0; i < (BM * KW) / NT; ++i) {
      const uint32_t a4 = a_w[srow * LD + tid / BM + i * (NT / BM)];
      sqa = __dp4a(a4, 0x01010101u, sqa);
      if (stat_kind == 1) sx = __dp4a(a4 & stat_mask4, 0x01010101u, sx);
      else if (stat_kind == 2) sx += __popc(nonzero_bytes(a4 & stat_mask4));
    }

#pragma unroll
    for (int ks = kz; ks < BK / 32; ks += KS) {
      uint32_t a[Cfg::MT][4], b[Cfg::NT8][2];
#pragma unroll
      for (int i = 0; i < Cfg::MT; ++i) {
        const int r = mb + i * 16 + g;
        a[i][0] = a_w[r * LD + 8 * ks + t];
        a[i][1] = a_w[(r + 8) * LD + 8 * ks + t];
        a[i][2] = a_w[r * LD + 8 * ks + 4 + t];
        a[i][3] = a_w[(r + 8) * LD + 8 * ks + 4 + t];
      }
#pragma unroll
      for (int j = 0; j < Cfg::NT8; ++j) {
        const int c = nb + j * 8 + g;
        b[j][0] = ws[c * LD + 8 * ks + t];
        b[j][1] = ws[c * LD + 8 * ks + 4 + t];
      }
#pragma unroll
      for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
        for (int j = 0; j < Cfg::NT8; ++j) mma_u8(acc[i][j], a[i], b[j]);
      for (int p = 0; p < n_planes; ++p) {
        const uint32_t am = s_am[p], wmk = s_wm[p];
        uint32_t ap[Cfg::MT][4], bp[Cfg::NT8][2];
#pragma unroll
        for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) ap[i][e] = a[i][e] & am;
#pragma unroll
        for (int j = 0; j < Cfg::NT8; ++j) {
          bp[j][0] = b[j][0] & wmk;
          bp[j][1] = b[j][1] & wmk;
        }
#pragma unroll
        for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
          for (int j = 0; j < Cfg::NT8; ++j) mma_u8(sub[i][j], ap[i], bp[j]);
      }
    }
  }
  cp_async_wait<0>();

  // gather the integer accumulators of all warps into the output tile
#pragma unroll
  for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mb + i * 16 + g + (e >= 2 ? 8 : 0);
        const int c = nb + j * 8 + 2 * t + (e & 1);
        const int v = acc[i][j][e] - sub[i][j][e];
        if (KS == 1) out_s[r * Cfg::OUT_LD + c] = v;
        else atomicAdd(&out_s[r * Cfg::OUT_LD + c], v);
      }
  atomicAdd(&s_sqa[srow], (int)sqa);
  if (stat_kind) atomicAdd(&s_sx[srow], (int)sx);
  __syncthreads();

  float sa, za, true_k, sw_s = 0.0f, zw_s = 0.0f;
  if (PER_COL) { sa = meta[0]; za = meta[1]; true_k = meta[2]; }
  else { sa = meta[0]; sw_s = meta[1]; za = meta[2]; zw_s = meta[3]; true_k = meta[4]; }

  for (int e = tid; e < BM * BN; e += NT) {
    const int rl = e / BN, cl = e % BN, r = m0 + rl, col = n0 + cl;
    if (r >= M || col >= N) continue;
    const float swc = PER_COL ? epi.sw[col] : sw_s;
    const float zwc = PER_COL ? epi.zw[col] : zw_s;
    const float sqw = PER_COL ? epi.sumqw_f[col] : (float)epi.sumqw_i[col];
    float o = (float)out_s[rl * Cfg::OUT_LD + cl];
    if (use_cv) {
      o = o + (float)s_sx[rl] * epi.c[col];
      o = o + epi.c0[col];
    }
    o = o - zwc * (float)s_sqa[rl];
    o = o - za * sqw;
    o = o + true_k * za * zwc;
    o = o * (sa * swc) + (epi.bias ? epi.bias[col] : 0.0f);
    store_out(out + (size_t)r * N + col, o);
  }
}

Planes make_planes(int n, unsigned long long amasks, unsigned long long wmasks) {
  Planes p;
  p.n = n;
  for (int i = 0; i < 8; ++i) {
    p.amask[i] = (uint32_t)((amasks >> (8 * i)) & 0xff) * 0x01010101u;
    p.wmask[i] = (uint32_t)((wmasks >> (8 * i)) & 0xff) * 0x01010101u;
  }
  return p;
}

// Tile configurations (BM, BN, BK, warps along M, N and K, stages):
// decode (M <= 8) streams a 32-column strip per block with eight warps
// splitting K; prefill takes 64 x 64 tiles, 2 x 2 warps of 32 x 32, each
// pair splitting K.  Eight warps share each tile's transpose and
// statistics, which otherwise serialise behind one block per SM.
using DecodeCfg = Cfg<16, 32, 512, 1, 1, 8, 4>;
using PrefillCfg = Cfg<64, 64, 128, 2, 2, 2, 3>;

template <typename C, typename OutT, bool PER_COL>
int launch_mma(const uint8_t* q, int ldq, int M, int K, const uint8_t* w,
               int ldw, int w_cols, int N, int vec, Epi epi,
               const float* meta, OutT* out, Planes pl, int stat_kind,
               uint32_t stat_mask4, int use_cv, cudaStream_t stream) {
  auto kern = am_mma_kernel<C, OutT, PER_COL>;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  kern<<<grid, C::NT, C::SMEM, stream>>>(q, ldq, M, K, w, ldw, w_cols, N, vec,
                                          epi, meta, out, pl, stat_kind,
                                          stat_mask4, use_cv);
  return (int)cudaGetLastError();
}

template <typename OutT, bool PER_COL>
int launch(int decode, const uint8_t* q, int ldq, int M, int K,
           const uint8_t* w, int ldw, int w_cols, int N, int vec, Epi epi,
           const float* meta, OutT* out, Planes pl, int stat_kind,
           uint32_t stat_mask4, int use_cv, cudaStream_t stream) {
  if (decode)
    return launch_mma<DecodeCfg, OutT, PER_COL>(
        q, ldq, M, K, w, ldw, w_cols, N, vec, epi, meta, out, pl, stat_kind,
        stat_mask4, use_cv, stream);
  return launch_mma<PrefillCfg, OutT, PER_COL>(
      q, ldq, M, K, w, ldw, w_cols, N, vec, epi, meta, out, pl, stat_kind,
      stat_mask4, use_cv, stream);
}

}  // namespace

extern "C" {

// Float-in entry (kernel 1).  x (M, K) float32 (x_bf16 = 0) or bfloat16
// (x_bf16 = 1), row-major; codes: scratch (M, ldq) uint8, ldq = K rounded up
// to 16; w_qb (Kb, Nb) uint8 with row stride ldw = Nb; epilogue (8, Nb)
// float32; meta [sa, za, true_k, ...]; out (M, N) in x's dtype.  Launches
// the quantize kernel and the matmul kernel; returns cudaGetLastError().
int am_fused_launch(const void* x, int x_bf16, uint8_t* codes, int ldq,
                    const uint8_t* w_qb, int ldw, int w_vec,
                    const float* epilogue, const float* meta, void* out,
                    int M, int K, int N, int decode, int n_planes,
                    unsigned long long amasks, unsigned long long wmasks,
                    int stat_kind, int stat_mask, int use_cv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long words = (long)M * (ldq / 4);
  const int qgrid = (int)((words + 255) / 256);
  if (x_bf16)
    quantize_kernel<__nv_bfloat16><<<qgrid, 256, 0, s>>>(
        (const __nv_bfloat16*)x, M, K, meta, codes, ldq);
  else
    quantize_kernel<float><<<qgrid, 256, 0, s>>>((const float*)x, M, K, meta,
                                                 codes, ldq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Epi epi;
  epi.c = epilogue + 0 * ldw;
  epi.c0 = epilogue + 1 * ldw;
  epi.sumqw_f = epilogue + 2 * ldw;
  epi.sumqw_i = nullptr;
  epi.bias = epilogue + 3 * ldw;
  epi.sw = epilogue + 4 * ldw;
  epi.zw = epilogue + 5 * ldw;
  Planes pl = make_planes(n_planes, amasks, wmasks);
  const uint32_t sm4 = (uint32_t)stat_mask * 0x01010101u;
  if (x_bf16)
    return launch<__nv_bfloat16, true>(decode, codes, ldq, M, K, w_qb, ldw,
                                       ldw, N, w_vec, epi, meta,
                                       (__nv_bfloat16*)out, pl, stat_kind, sm4,
                                       use_cv, s);
  return launch<float, true>(decode, codes, ldq, M, K, w_qb, ldw, ldw, N,
                             w_vec, epi, meta, (float*)out, pl, stat_kind,
                             sm4, use_cv, s);
}

// Codes-in entry (kernel 2).  a_q (M, K) uint8; w_q (K, N) uint8 with row
// stride N; vec = rows of both 16-byte aligned; c, c0, bias (N,) float32
// (bias may be null); sum_qw (N,) int32; meta [sa, sw, za, zw, true_k];
// out (M, N) float32.
int am_codes_launch(const uint8_t* a_q, const uint8_t* w_q, int vec,
                    const float* c, const float* c0, const int* sum_qw,
                    const float* bias, const float* meta, float* out, int M,
                    int K, int N, int decode, int n_planes,
                    unsigned long long amasks, unsigned long long wmasks,
                    int stat_kind, int stat_mask, int use_cv, void* stream) {
  Epi epi;
  epi.c = c;
  epi.c0 = c0;
  epi.sumqw_f = nullptr;
  epi.sumqw_i = sum_qw;
  epi.bias = bias;
  epi.sw = nullptr;
  epi.zw = nullptr;
  Planes pl = make_planes(n_planes, amasks, wmasks);
  const uint32_t sm4 = (uint32_t)stat_mask * 0x01010101u;
  return launch<float, false>(decode, a_q, K, M, K, w_q, N, N, N, vec, epi,
                              meta, out, pl, stat_kind, sm4, use_cv,
                              (cudaStream_t)stream);
}

}  // extern "C"
