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
// products on the int8 tensor cores.  The wrapper hands the decomposition
// over as data (kernels/approx_matmul.py::_mode_args):
//   acc = (A & main).W - sum_p (A & amask_p).(W & wmask_p)
//   perforated: main = ~(2^m-1), no plane  (A_hi.W: one product)
//   exact     : main = 0xFF, no plane
//   recursive : main = 0xFF, one plane (amask = wmask = 2^m-1)
//   truncated : main = 0xFF, m planes  (amask = 1<<i, wmask = 2^(m-i)-1)
// Partial sums stay below 255*255*K < 2^31 for K <= 33025 (the wrapper
// checks), so the 32-bit accumulators hold the exact value.
//
// The float-in entry reads the weights from the pack's K-major codes w_qbt
// (N rows of ldt bytes, K contiguous; made once with the pack, so no tile
// is transposed on the card), by three routes:
//
// * Decode rows (M <= DECODE_M_MAX): one split-K kernel per call, which
//   quantizes its own slice of x, runs mma.sync m16n8k32 over the codes
//   staged in a two-stage shared-memory ring and adds the K slices of a
//   cluster through distributed shared memory (design notes at
//   am_splitk_kernel).
// * Conv-shaped rows (above DECODE_M_MAX, K <= 1152, N <= 128, K * N <=
//   36,864: the CNNs' im2col calls but vgg's two widest; no LLM layer is
//   that narrow): one launch of the conv kernel, which streams x once
//   through a ring of bulk copies, quantizes in registers, keeps the pack
//   in shared memory and multiplies on mma.sync (design notes at
//   am_conv_kernel).
// * Other prefill rows: a prep kernel (one block of eight warps per row)
//   quantizes x once (to_code: quantize_i32's quotient, round half to
//   even), writes the codes
//   masked with `main` into an (M, ldq) buffer (zeros past K, rows padded
//   to 16 bytes), and writes each row's sum of codes and CV statistic into
//   an (M, 2) int32 scratch from its unmasked codes, so no matmul block
//   sums codes again.  Then the prefill tile, warp-specialised wgmma.  A
//   producer thread issues TMA loads of 128-byte K slices of the codes (BM
//   rows) and of w_qbt (BN rows) into a ring of stages with 128-byte
//   swizzle (one slice is one swizzle atom), paced by full/empty mbarriers.
//   Two consumer warpgroups run wgmma.mma_async m64nNk32 u8.u8.s32 straight
//   from shared memory, each on a 64 x N slab, and keep the K loop whole (no
//   K split, no shared-memory atomics).  Tiles: 128 x 256 with one block
//   per SM (4 stages; producer warpgroup's registers handed to the
//   consumers) where K >= 4096; else 128 x 128 with two blocks per SM (3
//   stages each), so one block's epilogue overlaps the other's main loop;
//   else 64 x 128 (the engine's M = 128 chunks: 32 blocks at N = 2048, a
//   narrower N tile rather than a split K, so the epilogue stays whole).
//   The grid runs M tiles fastest: the blocks in flight share few weight
//   tiles, each read from memory once, while the codes stay in L2.  The
//   epilogue's per-column constants and row statistics are staged in shared
//   memory while the ring fills; the CV + zero-point epilogue runs from the
//   accumulator registers into the idle ring, and the tile leaves in
//   16-byte row chunks.  Subtractive planes (recursive, truncated: off the
//   served path) mask a copy of each stage into a scratch slot and
//   accumulate into a second register array, so those modes take the
//   one-block 128 x 128 and 64 x 128 tiles.
// K and N edges are masked in the kernels (TMA zero-fills out of bounds),
// so the caller pads nothing.
//
// The codes-in entry reads the caller's operands in place, as the
// reference's kernel takes them: (M, K) activation codes and the row-major
// (K, N) weight codes w_q, at any alignment (N = 32,001, K = 27).  It makes
// no copy of w_q (the K-major copy it used to make on every call cost ~500
// of the 567 us of an olmo-1b decode layer), no scratch and no prep pass,
// and one launch a call:
// * Decode rows: the split-K kernel over row-major weights (ROWW): a round
//   is 256 weight rows of the block's 32 columns in the ring; each lane
//   turns four 32-bit row words into four K-contiguous column words with
//   a 4 x 4 byte transpose (__byte_perm) and feeds them to mma.sync as B
//   fragments, the codes' matching 8 bytes as A (design notes at
//   am_splitk_kernel).  Bound by the weight bytes.
// * Conv-shaped calls: the conv kernel, which reads the row-major pack
//   once a block into its K-major shared-memory copy.
// * Other calls: the prefill tile's transposing variant (Tile ROWW, the
//   tr_ tiles).  wgmma takes 8-bit B only K-major from shared memory, so
//   the transpose happens on the chip, between the loads and the products:
//   TMA loads the codes box into the stage (128-byte swizzle, as the
//   K-major tile has it) and a row-major (128, BN) weight box into a raw
//   slot; the producer warpgroup takes each row's statistics from the
//   unmasked codes, masks them with `main`, transposes the weight box into
//   the stage's K-major slot in the same swizzle (byte permutes, one 16-
//   byte store per column chunk) and releases the stage to the consumers,
//   which run the tile's own wgmma loop and epilogue (design notes at
//   rowmajor_producer).  Where K, N or a base is off 16 bytes, which TMA
//   refuses, a rows tile (mma.sync over cp.async stages, B fragments by
//   the same byte transposes in registers) runs the call instead.
// Zeros fill the K and N edges on the chip, so true_k (by value) stays the
// only fan-in term, where the reference pads and then subtracts its pad
// terms.

// Bound on the H100: prefill at M >= 2048 is bound by int8 operations (one
// product per output for perforated: 2*M*K*N at 1,979 TOP/s).  The main
// loop alone comes close to that rate with the epilogue cut out; what
// keeps the tile from it is the float32
// epilogue, a chain of seven dependent operations per output that the
// reference's rounding fixes, run by only eight warps per block.  Two
// blocks per SM hide part of it; a persistent kernel whose consumer
// warpgroups alternate between tiles would hide the rest.  The prep pass
// reads x once and writes one byte per code, so it is bound by bytes.
// Decode rows and the engine's M = 128 chunks are bound by the weight
// bytes; conv-shaped calls by the bytes of x and out.

#include <cuda.h>  // CUtensorMap and its enums only: the CUDA driver's
                   // tensor-map encoder is fetched at run time, libcuda is
                   // not linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

// --- PTX helpers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// 2-D TMA tile load (inner coordinate first), completion on an mbarrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads/writes across the
// asynchronous wgmma window
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO), start address in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D(64 x N, s32) += A(64 x 32, u8, smem) . B(32 x N, u8, smem), both K-major
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_u8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (N == 256) wgmma_n256(d, a, b);
  else if constexpr (N == 128) wgmma_n128(d, a, b);
  else wgmma_n64(d, a, b);
}

// the 4 x 4 byte transpose: out[i] = byte i of v0, v1, v2, v3 (in order)
__device__ __forceinline__ void transpose4(uint32_t v0, uint32_t v1,
                                           uint32_t v2, uint32_t v3,
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(v0, v1, 0x5140);  // v0.0 v1.0 v0.1 v1.1
  const uint32_t t1 = __byte_perm(v0, v1, 0x7362);  // v0.2 v1.2 v0.3 v1.3
  const uint32_t t2 = __byte_perm(v2, v3, 0x5140);
  const uint32_t t3 = __byte_perm(v2, v3, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// --- prep: quantize, mask, row statistics -----------------------------------

// 16-byte load through the read-only path, issued where it is written
__device__ __forceinline__ uint4 ldg_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ float ldg_nc(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// The activation quant params, with 1/sa rounded once (IEEE division).
struct Quant {
  float sa, inv, za;
};
__device__ __forceinline__ Quant make_quant(float sa, float za) {
  return {sa, __fdiv_rn(1.0f, sa), za};
}

// quant.quantize_i32: clip(round(x / sa) + za, 0, 255), IEEE division,
// round half to even.  Where |x / sa| < 512, x * inv is within 2^-13 of the
// correctly rounded quotient (two roundings of 2^-24 relative, plus half an
// ulp), so both round to the same integer unless x * inv lies within 2^-12
// of a half-integer: those few take the IEEE division.  Beyond 512 both clip
// alike.  Adding 1.5 * 2^23 rounds to an integer (half to even, exact below
// 2^22), adding 2^23 leaves an integer in [0, 255] in the low mantissa bits.
__device__ __forceinline__ uint32_t to_code(float x, const Quant& qp) {
  constexpr float kRound = 12582912.0f, kInt = 8388608.0f;
  float q = x * qp.inv;
  float r = (q + kRound) - kRound;
  if (fabsf(q) < 512.0f && fabsf(q - r) > 0.5f - 0x1p-12f) {
    q = __fdiv_rn(x, qp.sa);
    r = (q + kRound) - kRound;
  }
  const float c = fminf(fmaxf(r + qp.za, 0.0f), 255.0f);
  return __float_as_uint(c + kInt) & 0xFFu;
}
__device__ __forceinline__ uint32_t code_of(float v, const Quant& qp) {
  return to_code(v, qp);
}
__device__ __forceinline__ uint32_t code_of(__nv_bfloat16 v, const Quant& qp) {
  return to_code(__bfloat162float(v), qp);
}
__device__ __forceinline__ uint32_t code_of(uint8_t v, const Quant&) {
  return v;
}

// 8 consecutive inputs, loaded raw from a 16-byte aligned (bf16, float) or
// 8-byte aligned (uint8) address, and their codes packed 4 to a word
template <typename InT>
struct Item;
template <>
struct Item<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = ldg_nc(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void codes(const Quant& qp, uint32_t (&w)[2]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      w[i / 2] |= (to_code(f.x, qp) | (to_code(f.y, qp) << 8))
                  << (16 * (i % 2));
    }
  }
};
template <>
struct Item<float> {
  uint4 u[2];
  __device__ __forceinline__ void load(const float* p) {
    u[0] = ldg_nc(reinterpret_cast<const uint4*>(p));
    u[1] = ldg_nc(reinterpret_cast<const uint4*>(p) + 1);
  }
  __device__ __forceinline__ void codes(const Quant& qp, uint32_t (&w)[2]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 f = *reinterpret_cast<const float4*>(&u[h]);
      w[h] = to_code(f.x, qp) | (to_code(f.y, qp) << 8) |
             (to_code(f.z, qp) << 16) | (to_code(f.w, qp) << 24);
    }
  }
};
template <>
struct Item<uint8_t> {
  uint2 u;
  __device__ __forceinline__ void load(const uint8_t* p) {
    u = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void codes(const Quant&, uint32_t (&w)[2]) const {
    w[0] = u.x;
    w[1] = u.y;
  }
};
template <typename InT>
__device__ __forceinline__ void codes8(const InT* p, const Quant& qp,
                                       uint32_t (&w)[2]) {
  Item<InT> it;
  it.load(p);
  it.codes(qp, w);
}

// Byte-wise "is this byte nonzero", one bit per byte at bit 7 of it.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t t) {
  return (((t & 0x7f7f7f7fu) + 0x7f7f7f7fu) | t) & 0x80808080u;
}

// One block of eight warps per row.  Codes (masked with main4) into q (M,
// ldq), zeros in [K, ldq); stats[2r] = sum of the row's codes, stats[2r+1]
// = its CV statistic (stat_kind 1: sum of the low bits; 2: count of nonzero
// low bits; 0: none), both from the unmasked codes.
template <typename InT>
__global__ void __launch_bounds__(256)
prep_kernel(const InT* __restrict__ x, int K, int vec,
            const float* __restrict__ meta, uint8_t* __restrict__ q, int ldq,
            int* __restrict__ stats, uint32_t main4, int stat_kind,
            uint32_t stat4) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x;
  const Quant qp = make_quant(meta[0], meta[1]);
  const InT* row = x + (size_t)r * K;
  uint2* qrow = reinterpret_cast<uint2*>(q + (size_t)r * ldq);
  uint32_t sqa = 0u, sx = 0u;
#pragma unroll 4
  for (int g = threadIdx.x; g < ldq / 8; g += 256) {
    const int k0 = g * 8;
    uint32_t w[2] = {0u, 0u};
    if (vec && k0 + 8 <= K) {
      codes8(row + k0, qp, w);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (k0 + i < K) w[i / 4] |= code_of(row[k0 + i], qp) << (8 * (i % 4));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sqa = __dp4a(w[h], 0x01010101u, sqa);
      if (stat_kind == 1) sx = __dp4a(w[h] & stat4, 0x01010101u, sx);
      else if (stat_kind == 2) sx += __popc(nonzero_bytes(w[h] & stat4));
    }
    qrow[g] = make_uint2(w[0] & main4, w[1] & main4);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sqa += __shfl_xor_sync(0xffffffffu, sqa, o);
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
  }
  __shared__ uint32_t red[8][2];
  if (lane == 0) { red[warp][0] = sqa; red[warp][1] = sx; }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t a = 0u, b = 0u;
    for (int i = 0; i < 8; ++i) { a += red[i][0]; b += red[i][1]; }
    stats[2 * r] = (int)a;
    stats[2 * r + 1] = (int)b;
  }
}

// --- epilogue (shared by both matmul kernels) -------------------------------

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
  const float* meta;     // per column: [sa, za, true_k]; per tensor:
                         // [sa, sw, za, zw]
  const int* stats;      // (M, 2) row statistics from the prep kernel
  void* out;             // (M, N) bfloat16 (out_bf16) or float32
  int out_bf16, use_cv;
  float k_arg;           // per tensor: true_k, by value
};

struct Scalars {
  float sa, za, true_k, sw, zw;
};

__device__ __forceinline__ Scalars load_scalars(const Epi& e) {
  Scalars s;
  if (e.sw) {
    s.sa = e.meta[0]; s.za = e.meta[1]; s.true_k = e.meta[2];
    s.sw = 0.0f; s.zw = 0.0f;
  } else {
    s.sa = e.meta[0]; s.sw = e.meta[1]; s.za = e.meta[2]; s.zw = e.meta[3];
    s.true_k = e.k_arg;
  }
  return s;
}

// One column's epilogue constants.  za_sqw = za*sum_qw, kzz = true_k*za*zw
// and sasw = sa*sw are the products the reference forms per element; each
// is one correctly rounded float32 operation on the same operands, so
// forming it once per column rounds identically.
struct Col {
  float c, c0, zw, za_sqw, kzz, sasw, bias;
};

__device__ __forceinline__ Col load_col(const Epi& e, const Scalars& s,
                                        int col) {
  Col k;
  k.c = e.c[col];
  k.c0 = e.c0[col];
  const float sqw = e.sumqw_f ? e.sumqw_f[col] : (float)e.sumqw_i[col];
  const float sw = e.sw ? e.sw[col] : s.sw;
  k.zw = e.zw ? e.zw[col] : s.zw;
  k.za_sqw = s.za * sqw;
  k.kzz = s.true_k * s.za * k.zw;
  k.sasw = s.sa * sw;
  k.bias = e.bias ? e.bias[col] : 0.0f;
  return k;
}

// the reference kernel's float32 epilogue, operation for operation
__device__ __forceinline__ float epi_value(int acc, float sx, float sqa,
                                           const Col& k, int use_cv) {
  float o = (float)acc;
  if (use_cv) {
    o = o + sx * k.c;
    o = o + k.c0;
  }
  o = o - k.zw * sqa;
  o = o - k.za_sqw;
  o = o + k.kzz;
  return o * k.sasw + k.bias;
}

__device__ __forceinline__ void store1(const Epi& e, size_t i, float v) {
  if (e.out_bf16) static_cast<__nv_bfloat16*>(e.out)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(e.out)[i] = v;
}

// --- prefill tile: TMA + wgmma, warp-specialised ----------------------------

constexpr int EPI_COLS = 7;       // per-column epilogue constants, below
constexpr int PBK = 128;          // K bytes per stage: one swizzle atom row
static_assert(sizeof(Col) == EPI_COLS * 4, "column constants");

// Threads 0-255 are the two consumer warpgroups, the rest the producer.
// CTAS blocks per SM: one block holds a 192 KB ring (stages and plane
// scratch) and a producer warpgroup whose registers it hands to the
// consumers (setmaxnreg: 168 -> 40 and 232); two blocks hold 96 KB each and
// a producer warp, at 112 registers a thread, and one block's epilogue then
// runs beside the other block's main loop.
// ROWW (the codes-in entry, row-major weights): one block an SM, whose
// producer warpgroup also transposes, so it keeps its registers (no
// hand-over: every thread keeps the 168 that ptxas fits the tile into);
// beside the ring RAWS slots of row-major (PBK, BN) weight boxes, fewer
// than the stages (the producer waits for stage kt + RAWS - S to be
// released while it holds stage kt).
template <int BM_, int BN_, bool PLANES_, int CTAS_, bool ROWW_ = false>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, CTAS = CTAS_;
  static constexpr bool PLANES = PLANES_, ROWW = ROWW_;
  static constexpr int THREADS = CTAS == 1 ? 384 : 288;
  static constexpr int P_RING =
      (ROWW ? (BN == 256 ? 144 : 128) : CTAS == 1 ? 192 : 96) * 1024;
  // 128-row tiles give each consumer warpgroup 64 rows and every column;
  // 64-row tiles give each one half of the columns
  static constexpr int WGN = BM == 128 ? BN : BN / 2;
  static constexpr int A_BYTES = BM * PBK, B_BYTES = BN * PBK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = P_RING / STAGE - (PLANES ? 1 : 0);
  static constexpr int RAW = ROWW ? PBK * BN : 0;
  static constexpr int RAWS =
      !ROWW ? 0 : (BN == 256 ? 2 : 4) < STAGES ? (BN == 256 ? 2 : 4)
                                               : STAGES - 1;
  // after the ring (and the raw slots): full/empty barriers (ROWW: also
  // the transposed stages' and the row statistics'), then the epilogue's
  // per-column constants (EPI_COLS floats per column) and per-row
  // statistics
  static constexpr int BARS = (ROWW ? 3 * STAGES + 1 : 2 * STAGES) * 8;
  static constexpr int BARS_OFF = P_RING + RAWS * RAW;
  static constexpr int COLS = EPI_COLS * BN * 4, ROWS = 2 * BM * 4;
  static constexpr int SMEM = 1024 + BARS_OFF + BARS + COLS + ROWS;
  static_assert(BM == 64 || BM == 128, "tile rows");
  static_assert(WGN == 64 || WGN == 128 || WGN == 256, "wgmma width");
  static_assert(STAGES >= 3, "ring depth");
  static_assert(BM * (BN * 4 + 16) <= P_RING, "staged output tile");
  static_assert(CTAS == 1 || CTAS == 2, "blocks per SM");
  static_assert(!ROWW || (CTAS == 1 && RAWS >= 2), "transposer");
  static_assert(SMEM <= 232448, "shared memory");
};

// The ROWW producer warpgroup (128 threads).  Warp 0 issues tile kt's
// TMA loads: the (BM, PBK) codes box into the stage's A slot (128-byte
// swizzle, as every K-major operand of the tile) and the row-major (PBK, BN)
// weight box into raw slot kt % RAWS, both on full[s].  Then all 128:
//  * A: the row statistics from the unmasked codes, then main4 in place
//    (thread: row tid % BM, 8 BM / 128 of its 16-byte chunks, taken from
//    chunk (j + row) & 7 so that a quarter warp's eight rows hit eight
//    distinct banks; the swizzle does not matter to a sum or a mask);
//  * B: the transpose into the stage's K-major slot in wgmma's 128-byte
//    swizzle.  A warp's unit is 16 k rows of 128 columns: lane l reads the
//    32-bit word at columns 4l .. 4l + 3 of each row (the warp reads whole
//    rows), rotates its bytes by rot = (l >> 1) & 3, transposes each four
//    rows (transpose4) and stores column 4l + ((i + rot) & 3)'s 16 k bytes
//    as one 16-byte store into chunk kc ^ (n & 7): the rotation puts a
//    quarter warp's eight stores in eight distinct chunks;
//  * fence.proxy.async (wgmma reads what the threads wrote), arrive on
//    ready[s]; once all 128 have read the raw slot (named barrier 2),
//    warp 0 loads tile kt + RAWS into it, after stage (kt + RAWS) % S is
//    released: tile kt + RAWS - S, which the consumers release once they
//    hold tile kt + RAWS - S + 1 <= kt (RAWS < S), so the wait ends.
// Zero-filled TMA edges (rows past M or K, columns past N or K) give zero
// codes: no product, no statistic.  At the end the row statistics go to
// rstats, then stats_done.
template <class T>
__device__ __forceinline__ void rowmajor_producer(
    uint8_t* smem, uint8_t* raw, uint64_t* full, uint64_t* empty,
    uint64_t* ready, uint64_t* stats_done, int* rstats,
    const CUtensorMap* tma_a, const CUtensorMap* tma_b, int nkt, int m0,
    int n0, uint32_t main4, int stat_kind, uint32_t stat4) {
  constexpr int S = T::STAGES, R = T::RAWS, BM = T::BM, BN = T::BN;
  constexpr int CH = 8 * BM / 128;  // codes chunks a thread a stage
  constexpr int CB = BN / 128, UPW = CB * (PBK / 16) / 4;  // units a warp
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  // warp 0 issues: its lanes wait together and lane 0 copies, so that the
  // warp arrives converged at the next barrier
  auto issue = [&](int kt) {
    const int s = kt % S;
    mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(&full[s], T::A_BYTES + T::RAW);
      tma_load(smem + s * T::STAGE, tma_a, kt * PBK, m0, &full[s]);
      tma_load(raw + (kt % R) * T::RAW, tma_b, n0, kt * PBK, &full[s]);
    }
    __syncwarp();
  };
  if (warp == 0)
    for (int kt = 0; kt < R && kt < nkt; ++kt) issue(kt);
  const int ar = tid % BM, ac = (tid / BM) * CH;
  const int rot = (lane >> 1) & 3;
  const uint32_t rsel = (uint32_t)(rot | ((rot + 1) & 3) << 4 |
                                   ((rot + 2) & 3) << 8 |
                                   ((rot + 3) & 3) << 12);
  uint32_t sq = 0u, sx = 0u;
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    uint8_t* st = smem + s * T::STAGE;
    uint4* arow = reinterpret_cast<uint4*>(st + ar * PBK);
    const uint8_t* rs = raw + (kt % R) * T::RAW;
    uint8_t* bs = st + T::A_BYTES;
    // every load of the stage first, in registers: the compiler cannot
    // tell the slots apart, so a store would hold up each later load (a
    // warp a sub-partition has little else to hide their latency with)
    uint4 av[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) av[j] = arow[(ac + j + ar) & 7];
    uint32_t bv[UPW][16];
#pragma unroll
    for (int uu = 0; uu < UPW; ++uu) {
      const int u = warp + 4 * uu, cb = u % CB, kc = u / CB;
      const uint8_t* src = rs + 16 * kc * BN + 128 * cb + 4 * lane;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        bv[uu][r] = *reinterpret_cast<const uint32_t*>(src + r * BN);
    }
    // A: the statistics in two chains, the masked codes back
    uint32_t q2[2] = {0u, 0u}, x2[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const uint32_t w[4] = {av[j].x, av[j].y, av[j].z, av[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q2[e & 1] = __dp4a(w[e], 0x01010101u, q2[e & 1]);
        if (stat_kind == 1)
          x2[e & 1] = __dp4a(w[e] & stat4, 0x01010101u, x2[e & 1]);
        else if (stat_kind == 2)
          x2[e & 1] += __popc(nonzero_bytes(w[e] & stat4));
      }
    }
    sq += q2[0] + q2[1];
    sx += x2[0] + x2[1];
    if (main4 != 0xFFFFFFFFu) {
#pragma unroll
      for (int j = 0; j < CH; ++j)
        arow[(ac + j + ar) & 7] =
            make_uint4(av[j].x & main4, av[j].y & main4, av[j].z & main4,
                       av[j].w & main4);
    }
    // B: rotate, transpose, one 16-byte store a column
#pragma unroll
    for (int uu = 0; uu < UPW; ++uu) {
      const int u = warp + 4 * uu, cb = u % CB, kc = u / CB;
      uint32_t col[4][4];  // [column (i + rot) & 3][k bytes 4b .. 4b + 3]
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        uint32_t o[4];
        transpose4(__byte_perm(bv[uu][4 * b], 0u, rsel),
                   __byte_perm(bv[uu][4 * b + 1], 0u, rsel),
                   __byte_perm(bv[uu][4 * b + 2], 0u, rsel),
                   __byte_perm(bv[uu][4 * b + 3], 0u, rsel), o);
#pragma unroll
        for (int i = 0; i < 4; ++i) col[i][b] = o[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 128 * cb + 4 * lane + ((i + rot) & 3);
        *reinterpret_cast<uint4*>(bs + n * PBK + ((kc ^ (n & 7)) << 4)) =
            make_uint4(col[i][0], col[i][1], col[i][2], col[i][3]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&ready[s]);
    asm volatile("barrier.sync 2, 128;\n" ::: "memory");  // raw slot read
    if (warp == 0 && kt + R < nkt) issue(kt + R);
  }
  // a row's statistics (BM = 64: threads tid and tid + 64 hold halves)
  if (tid < BM) {
    rstats[2 * ar] = (int)sq;
    rstats[2 * ar + 1] = (int)sx;
  }
  if constexpr (BM < 128) {
    asm volatile("barrier.sync 2, 128;\n" ::: "memory");
    if (tid >= BM) {
      rstats[2 * ar] += (int)sq;
      rstats[2 * ar + 1] += (int)sx;
    }
  }
  mbar_arrive(stats_done);
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::CTAS)
am_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, int M, int N,
                int K, Epi epi, Planes pl, uint32_t main4, int stat_kind,
                uint32_t stat4) {
  // tma_a: the (M, K) codes; tma_b: the K-major weights, or (ROWW) the
  // row-major (K, N) weights in (PBK, BN) boxes.  main4, stat_kind, stat4:
  // ROWW only (the prep kernel's masks elsewhere)
  constexpr int S = T::STAGES, WGN = T::WGN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* raw = smem + T::P_RING;  // ROWW: the row-major weight boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BARS_OFF);
  uint64_t* empty = full + S;
  uint64_t* ready = empty + S;        // ROWW: stage transposed
  uint64_t* stats_done = ready + S;   // ROWW: row statistics in rstats
  Col* cols = reinterpret_cast<Col*>(smem + T::BARS_OFF + T::BARS);
  int* rstats =
      reinterpret_cast<int*>(smem + T::BARS_OFF + T::BARS + T::COLS);
  uint8_t* scratch = smem + S * T::STAGE;  // plane operands (PLANES only)

  const int nkt = (K + PBK - 1) / PBK;
  // M tiles fastest: the blocks in flight share few weight tiles, each
  // read from memory once, while the smaller code matrix stays in L2
  const int n0 = blockIdx.y * T::BN, m0 = blockIdx.x * T::BM;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one release per consumer warpgroup
      if constexpr (T::ROWW) mbar_init(&ready[s], 128);
    }
    if constexpr (T::ROWW) mbar_init(stats_done, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    if constexpr (T::CTAS == 1 && !T::ROWW)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if constexpr (T::ROWW) {  // the producer warpgroup loads and transposes
      rowmajor_producer<T>(smem, raw, full, empty, ready, stats_done, rstats,
                           &tma_a, &tma_b, nkt, m0, n0, main4, stat_kind,
                           stat4);
    } else if (tid == 0) {  // one thread keeps the ring full
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % S;
        mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE);
        uint8_t* st = smem + s * T::STAGE;
        tma_load(st, &tma_a, kt * PBK, m0, &full[s]);
        tma_load(st + T::A_BYTES, &tma_b, kt * PBK, n0, &full[s]);
      }
    }
  } else {  // consumers: wgmma over the ring, then the epilogue
    if constexpr (T::CTAS == 1 && !T::ROWW)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    {  // the epilogue's column constants and row statistics, read while
       // the ring fills (visible to both warpgroups after the main loop)
      const int ct = threadIdx.x;  // 0..255
      const Scalars sc = load_scalars(epi);
      for (int i = ct; i < T::BN; i += 256)
        if (n0 + i < N) cols[i] = load_col(epi, sc, n0 + i);
      for (int i = ct; i < (T::ROWW ? 0 : T::BM); i += 256) {
        const bool ok = m0 + i < M;
        rstats[2 * i] = ok ? epi.stats[2 * (m0 + i)] : 0;
        rstats[2 * i + 1] = ok ? epi.stats[2 * (m0 + i) + 1] : 0;
      }
    }
    const uint32_t a_off = T::BM == 128 ? wg * 64 * PBK : 0;
    const uint32_t b_off = T::A_BYTES + (T::BM == 128 ? 0 : wg * WGN * PBK);
    const uint32_t base = smem_addr(smem);
    int acc[WGN / 2];
    int sub[T::PLANES ? WGN / 2 : 1];
#pragma unroll
    for (int i = 0; i < WGN / 2; ++i) acc[i] = 0;
#pragma unroll
    for (int i = 0; i < (T::PLANES ? WGN / 2 : 1); ++i) sub[i] = 0;

    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % S;
      mbar_wait(T::ROWW ? &ready[s] : &full[s], (kt / S) & 1);
      const uint32_t st = base + s * T::STAGE;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PBK / 32; ++kk)
        wgmma_u8<WGN>(acc, sw128_desc(st + a_off + 32 * kk),
                      sw128_desc(st + b_off + 32 * kk));
      wgmma_commit();
      fence_regs(acc);
      if constexpr (T::PLANES) {
        // each consumer warpgroup masks half of the stage's bytes into the
        // scratch slot (byte masks keep the swizzled layout), then both
        // multiply the masked copies into sub
        const uint4* src = reinterpret_cast<const uint4*>(smem + s * T::STAGE);
        uint4* dst = reinterpret_cast<uint4*>(scratch);
        constexpr int A16 = T::A_BYTES / 16, ALL16 = T::STAGE / 16;
        for (int p = 0; p < pl.n; ++p) {
          const uint32_t am = pl.amask[p], wm = pl.wmask[p];
          asm volatile("bar.sync 1, 256;\n" ::: "memory");  // scratch free
          for (int i = wg * (ALL16 / 2) + tid; i < (wg + 1) * (ALL16 / 2);
               i += 128) {
            const uint32_t mk = i < A16 ? am : wm;
            uint4 v = src[i];
            v.x &= mk; v.y &= mk; v.z &= mk; v.w &= mk;
            dst[i] = v;
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync 1, 256;\n" ::: "memory");
          const uint32_t sc = smem_addr(scratch);
          fence_regs(sub);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < PBK / 32; ++kk)
            wgmma_u8<WGN>(sub, sw128_desc(sc + a_off + 32 * kk),
                          sw128_desc(sc + b_off + 32 * kk));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sub);
        }
      }
      wgmma_wait<T::PLANES ? 0 : 1>();  // stage kt - 1 has been read
      fence_regs(acc);
      if (kt > 0 && tid == 0) mbar_arrive(&empty[(kt - 1) % S]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // both warpgroups' wgmma reads of the ring are done, constants staged
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if constexpr (T::ROWW) mbar_wait(stats_done, 0);

    // epilogue from registers: thread owns rows r, r + 8 and column pairs
    const int warp = tid >> 5, lane = tid & 31;
    const int rl = (T::BM == 128 ? wg * 64 : 0) + warp * 16 + (lane >> 2);
    const int cl = (T::BM == 128 ? 0 : wg * WGN) + 2 * (lane & 3);
    float sqa[2], sx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sqa[h] = (float)rstats[2 * (rl + 8 * h)];
      sx[h] = (float)rstats[2 * (rl + 8 * h) + 1];
    }
    // values into the (now idle) ring as a row-major (BM, BN) tile, rows
    // padded by 16 bytes so that the warp's 8 rows x 4 column pairs hit 32
    // banks; then every consumer thread stores 16-byte chunks of whole rows
    const int es = epi.out_bf16 ? 2 : 4;
    const int ld = T::BN * es + 16;  // bytes
#pragma unroll
    for (int j = 0; j < WGN / 8; ++j) {
      const int c = cl + 8 * j;
      if (n0 + c >= N) continue;
      const Col k0 = cols[c];
      const Col k1 = n0 + c + 1 < N ? cols[c + 1] : k0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        if constexpr (T::PLANES) {
          a0 -= sub[4 * j + 2 * h];
          a1 -= sub[4 * j + 2 * h + 1];
        }
        const float v0 = epi_value(a0, sx[h], sqa[h], k0, epi.use_cv);
        const float v1 = epi_value(a1, sx[h], sqa[h], k1, epi.use_cv);
        uint8_t* dst = smem + (rl + 8 * h) * ld + c * es;
        if (epi.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int cpr = T::BN * es / 16;  // 16-byte chunks per tile row
    const int per = 16 / es;          // elements per chunk
    const bool vec_rows = (N * es) % 16 == 0;
    for (int i = threadIdx.x; i < T::BM * cpr; i += 256) {
      const int r = i / cpr, c = (i % cpr) * per;
      const int row = m0 + r, col = n0 + c;
      if (row >= M || col >= N) continue;
      const uint8_t* src = smem + r * ld + c * es;
      uint8_t* out = static_cast<uint8_t*>(epi.out) + ((size_t)row * N + col) * es;
      if (vec_rows && col + per <= N) {
        *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < per && col + e < N; ++e)
          for (int b = 0; b < es; ++b) out[e * es + b] = src[e * es + b];
      }
    }
  }
}

// --- split-K decode kernel: quantize + mma.sync over the K-major codes -----
//
// Decode rows (M <= DECODE_M_MAX) are bound by the weight bytes: each code is
// read once and used for at most 8 products.  One launch does the whole
// call:
//   * Grid (cs, ceil(N / SK_BN)), launched as clusters of cs blocks along K.
//     Block `rank` of a cluster owns a K slice of `ks` bytes of 32 columns.
//     split_k() picks cs (1..8) and ks from the shape (see there).
//   * Weights are read from w_qbt, K contiguous, one round (256 K bytes of
//     the 32 columns) at a time: cp.async copies it into a two-stage
//     shared-memory ring, each warp two whole 256-byte runs of two columns,
//     and lanes read their fragments back from there.  No tile is
//     transposed.  A block quantizes its K slice of x (rows < M) into shared
//     memory while its first round is in flight; the quant params and each
//     thread's first inputs are its first loads, since the products wait on
//     them.  So a call needs no prep launch and no scratch.  Measured on the
//     served shapes, deeper rings, per-thread slots, loads straight into
//     registers and bulk copies of whole slices were all slower: more bytes
//     in flight a block did not buy bandwidth.
//   * Products: mma.sync m16n8k32 u8, M padded to 16 with zero registers
//     (rows 8-15 of A are the constant 0).  A lane (g, t) holds 16 bytes of
//     column g at byte 16t of a 64-byte K chunk, and its 16 codes of row g at
//     the same bytes; they feed two mmas as B and A fragments directly: the
//     mma's K index 4t+i stands for byte 16t+i of the chunk and 16+4t+i for
//     16t+4+i (the same K permutation for A and B, so the same products are
//     summed).  dp4a on the CUDA cores would waste no rows, but needs 32x
//     the instructions per weight byte, and they would share the issue slots
//     with the quantization; the tensor cores leave the block bound by its
//     copies.
//   * Four warps split a 256-byte K round, two the 32 columns.  Row
//     statistics (sum of codes, CV statistic) come from the unmasked codes
//     in the same loop.  They, and acc - sub, are exact integers, summed over
//     the block's warps in shared memory, then over the cluster: every block
//     writes its partial into the leader's shared memory (distributed shared
//     memory), and the leader adds the cs partials in rank order and runs
//     the epilogue (its per-column constants are prefetched into L2 at the
//     start).  No global scratch, no atomics: two calls are bit-equal.

//
// Row-major weights (ROWW: the codes-in entry's (K, N) w_q, read in place):
// the same block, cluster and epilogue, with the K round split over all
// eight warps (32 K bytes each, every warp all 32 columns).  A round is 256
// rows of 32 column bytes, copied by 16-byte pieces into the ring (rows
// past K and columns past N zero; where N or w_q is off 16 bytes, byte by
// byte).  A lane (g, t) reads four 32-bit words, rows 8t .. 8t + 3 of its
// warp's 32 at bytes 4g .. 4g + 3, and transposes them (__byte_perm) into
// four words, each 4 consecutive K bytes of one column; with rows 8t + 4
// .. 8t + 7 that is the B fragment (b0, b1) of column 4g + i for the i-th
// of four mmas.  So mma i's column index g stands for column 4g + i, and
// its K index 4t + e (16 + 4t + e) for row 8t + e (8t + 4 + e): the A
// fragment is then the 8 consecutive codes of row g at 8t, one 8-byte load.
// Lane (g, t)'s accumulators are columns 8t .. 8t + 7 of row g.  Ring rows
// are stored at row ^ ((row >> 3) & 3), so the four t of one load hit
// distinct banks.

constexpr int SK_BN = 32;                   // columns per block
constexpr int SK_WN = 2, SK_WK = 4;         // warps along N, along K
constexpr int SK_CG = SK_BN / (8 * SK_WN);  // 8-column groups per warp
constexpr int SK_KR = 64 * SK_WK;           // K bytes per block round
constexpr int SK_THREADS = 32 * SK_WN * SK_WK;
constexpr int SK_STAGES = 2;                // rounds in the ring
constexpr int SK_MAX_CS = 8;                // portable cluster size
constexpr int SK_MAX_ROUNDS = 18;           // K up to MAX_K in 8 blocks
constexpr int SK_RLD = SK_BN + 8;           // row stride of the warp sums
constexpr int SK_SLOT = 8 * SK_BN + 16;     // a block's partial: acc, stats
constexpr int SK_WLD = SK_KR + 64;          // weight ring row (one column)
constexpr int SK_RING = SK_STAGES * SK_BN * SK_WLD;
constexpr int SK_WK_ROWS = SK_THREADS / 32;  // row-major: warps along K
static_assert(SK_THREADS == 8 * SK_BN, "one output per thread");
static_assert(SK_MAX_CS * SK_MAX_ROUNDS * SK_KR >= 33025, "MAX_K");
static_assert(SK_WK_ROWS * 32 == SK_KR, "row-major: 32 K bytes a warp");
static_assert(SK_STAGES * SK_KR * SK_BN <= SK_RING, "row-major ring");

// Dynamic shared memory: the weight ring (SK_STAGES, SK_BN, SK_WLD), or
// row-major (SK_STAGES, SK_KR, SK_BN), and the codes (8, ks + pad), whose
// row pads (64 bytes K-major, 32 row-major) put the 8 rows of a warp's
// 16-byte (8-byte) loads on distinct banks; the warps' sums (wk, 8,
// SK_RLD) and statistics (wk, 8, 2); the cluster's partials (SK_MAX_CS
// slots, written by the other blocks at any time after the first cluster
// barrier).
__host__ __device__ constexpr int sk_lda(int ks, bool rows) {
  return ks + (rows ? 32 : 64);
}
__host__ __device__ constexpr int sk_smem(int ks, bool rows) {
  return SK_RING + 8 * sk_lda(ks, rows) +
         4 * ((rows ? SK_WK_ROWS : SK_WK) * (8 * SK_RLD + 16) +
              SK_MAX_CS * SK_SLOT);
}

// 16 bytes of a row-major weight row at src, the first nb (0..16) of them,
// the rest 0, loaded byte by byte (src off 16 bytes)
__device__ __forceinline__ uint4 ld_bytes16(const uint8_t* src, int nb) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < nb) w[e / 4] |= (uint32_t)__ldg(src + e) << (8 * (e % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16-byte async copy; bytes beyond src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// address of the same shared-memory location in block `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, int v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}
// barrier.cluster.arrive has release, barrier.cluster.wait acquire semantics
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// d += A(rows g, bytes a0 | a2) . B(bytes b0 | b1), rows 8-15 of A zero
__device__ __forceinline__ void mma_rows8(int (&d)[4], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  const uint32_t a[4] = {a0, 0u, a2, 0u};
  const uint32_t b[2] = {b0, b1};
  mma_u8(d, a, b);
}

template <typename InT, bool ROWW>
__global__ void __launch_bounds__(SK_THREADS, 4)
am_splitk_kernel(const InT* __restrict__ x, int vec,
                 const uint8_t* __restrict__ wt, int ldt, int wvec, int M,
                 int K, int N, int ks, Epi epi, Planes pl, uint32_t main4,
                 int stat_kind, uint32_t stat4) {
  // ROWW: wt is row-major (K rows of ldt bytes), wvec: 16-byte copies
  // allowed (ldt and wt 16-byte aligned); else wt is K-major (N rows of ldt
  // bytes, ldt a multiple of 16)
  constexpr int WK = ROWW ? SK_WK_ROWS : SK_WK, WN = ROWW ? 1 : SK_WN;
  constexpr int CG = ROWW ? 4 : SK_CG;  // mmas per K step a warp
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t s_am[8], s_wm[8];
  const int lda = sk_lda(ks, ROWW);
  uint8_t* ring = smem;  // weights, (SK_STAGES, SK_BN, SK_WLD) or row-major
  uint8_t* codes = smem + SK_RING;  // (8, lda)
  int* red = reinterpret_cast<int*>(codes + 8 * lda);
  int* sred = red + WK * 8 * SK_RLD;
  int* slots = sred + WK * 16;

  const int cs = gridDim.x;
  const uint32_t rank = cluster_rank();
  const int n0 = blockIdx.y * SK_BN, k0 = (int)rank * ks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % WN, wk = warp / WN;
  // rounds of this block's slice that reach into K (split_k leaves every
  // block at least one)
  const int nr = min(ks, K - k0 + SK_KR - 1) / SK_KR;
  cluster_arrive_relaxed();  // this block runs (waited on before DSMEM)

  // K-major: a round's weights, (SK_BN, SK_KR) bytes, copied by 16-byte
  // pieces: piece q = 256 j + tid is column q / 16, bytes 16 (q % 16) of the
  // round, so a warp's copy covers two whole 256-byte runs; past ldt or N
  // they read as zero.  Row-major: piece q is row q / 2 of the round,
  // column bytes 16 (q % 2), stored at ring row q / 2 ^ ((q / 16) & 3).
  const int koff = ROWW ? 32 * wk + 8 * t : 64 * wk + 16 * t;
  const uint8_t* wsrc[2];
  int wk0[2], wdst[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = j * SK_THREADS + tid;
    if constexpr (ROWW) {
      const int row = q / 2, c = 16 * (q % 2);
      wk0[j] = n0 + c < N ? min(16, N - n0 - c) : 0;  // bytes of the piece
      wsrc[j] = wt + (size_t)(k0 + row) * ldt + n0 + c;
      wdst[j] = (row ^ ((row >> 3) & 3)) * SK_BN + c;
    } else {
      const int c = q / 16, b = 16 * (q % 16);
      // a column past N reads as zero: its K offset is put past ldt
      wk0[j] = n0 + c < N ? k0 + b : ldt;
      wsrc[j] = wt + (size_t)(n0 + c < N ? n0 + c : 0) * ldt + k0 + b;
      wdst[j] = c * SK_WLD + b;
    }
  }
  auto load_round = [&](int r) {
    if constexpr (ROWW) {
      uint8_t* stage = ring + (r % SK_STAGES) * SK_KR * SK_BN;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = (j * SK_THREADS + tid) / 2;
        const int nb = k0 + r * SK_KR + row < K ? wk0[j] : 0;
        const uint8_t* src = wsrc[j] + (size_t)r * SK_KR * ldt;
        if (wvec) cp_async16(stage + wdst[j], nb ? src : wt, nb);
        else *reinterpret_cast<uint4*>(stage + wdst[j]) = ld_bytes16(src, nb);
      }
    } else {
      uint8_t* stage = ring + (r % SK_STAGES) * SK_BN * SK_WLD;
#pragma unroll
      for (int j = 0; j < SK_CG; ++j) {
        const bool ok = wk0[j] + r * SK_KR < ldt;  // 16-byte units
        cp_async16(stage + wdst[j], ok ? wsrc[j] + r * SK_KR : wt,
                   ok ? 16 : 0);
      }
    }
  };
  // first the quant params and this thread's first two items of x (8
  // codes each): the quantization waits on them, and their latency then
  // overlaps the weights'; then the first round
  const int per_row = nr * SK_KR / 8, items = M * per_row;
  auto item_src = [&](int i, int& kk) {  // row start, item's K offset
    const int r = i / per_row;
    kk = (i - r * per_row) * 8;
    return x + (size_t)r * K;
  };
  auto whole = [&](int i) {  // a full vector load of item i
    int kk;
    item_src(i, kk);
    return i < items && vec && k0 + kk + 8 <= K;
  };
  Item<InT> pre[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = tid + u * SK_THREADS;
    int kk;
    const InT* row = item_src(i, kk);
    if (whole(i)) pre[u].load(row + k0 + kk);
  }
  const float sa = ldg_nc(epi.meta), za = ldg_nc(epi.meta + (epi.sw ? 1 : 2));
#pragma unroll
  for (int r = 0; r < SK_STAGES - 1; ++r) {
    if (r < nr) load_round(r);
    cp_async_commit();
  }
  if (rank == 0 && tid < 6) {  // the leader's epilogue constants into L2
    const void* p = tid == 0 ? (const void*)epi.c
                  : tid == 1 ? (const void*)epi.c0
                  : tid == 2 ? (epi.sumqw_f ? (const void*)epi.sumqw_f
                                            : (const void*)epi.sumqw_i)
                  : tid == 3 ? (const void*)epi.bias
                  : tid == 4 ? (const void*)epi.sw : (const void*)epi.zw;
    if (p) prefetch_l2(static_cast<const float*>(p) + n0);
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) { s_am[i] = pl.amask[i]; s_wm[i] = pl.wmask[i]; }
  }

  // quantize rows < M of the slice into codes (zeros past K); rows >= M
  // are never read
  const Quant qp = make_quant(sa, za);
  auto quantize = [&](int i, const Item<InT>* it) {
    int kk;
    const InT* row = item_src(i, kk);
    const int k = k0 + kk;
    uint32_t w[2] = {0u, 0u};
    if (it) {
      it->codes(qp, w);
    } else if (whole(i)) {
      codes8(row + k, qp, w);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (k + e < K) w[e / 4] |= code_of(row[k + e], qp) << (8 * (e % 4));
    }
    *reinterpret_cast<uint2*>(codes + (i / per_row) * lda + kk) =
        make_uint2(w[0], w[1]);
  };
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = tid + u * SK_THREADS;
    if (i < items) quantize(i, whole(i) ? &pre[u] : nullptr);
  }
  for (int i = tid + 2 * SK_THREADS; i < items; i += SK_THREADS)
    quantize(i, nullptr);
  __syncthreads();

  int acc[CG][4], sub[CG][4];
#pragma unroll
  for (int j = 0; j < CG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) { acc[j][e] = 0; sub[j][e] = 0; }
  uint32_t sqa = 0u, sx = 0u;
  const bool arow = g < M;
  const uint8_t* afrag = codes + g * lda + koff;
  const int n_planes = pl.n;
  // row statistics, once per K byte (K-major: the warps of wn == 0)
  auto stats = [&](uint32_t a) {
    sqa = __dp4a(a, 0x01010101u, sqa);
    if (stat_kind == 1) sx = __dp4a(a & stat4, 0x01010101u, sx);
    else if (stat_kind == 2) sx += __popc(nonzero_bytes(a & stat4));
  };
  for (int r = 0; r < nr; ++r) {
    cp_async_wait<SK_STAGES - 2>();  // this thread's pieces of round r
    __syncthreads();  // everyone's; round r - 1's stage is free again
    if (r + SK_STAGES - 1 < nr) load_round(r + SK_STAGES - 1);
    cp_async_commit();
    if constexpr (ROWW) {
      const uint2 a = arow ? *reinterpret_cast<const uint2*>(afrag + r * SK_KR)
                           : make_uint2(0u, 0u);
      stats(a.x);
      stats(a.y);
      // rows 8t .. 8t + 7 of the warp's 32, word g, transposed: b0[i], b1[i]
      // are column 4g + i's K bytes 8t .. 8t + 3 and 8t + 4 .. 8t + 7
      const uint8_t* stage = ring + (r % SK_STAGES) * SK_KR * SK_BN;
      const uint8_t* wrow = stage + (32 * wk + 8 * t) * SK_BN + 4 * g;
      uint32_t v[8], b0[4], b1[4];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = *reinterpret_cast<const uint32_t*>(wrow + (e ^ t) * SK_BN);
      transpose4(v[0], v[1], v[2], v[3], b0);
      transpose4(v[4], v[5], v[6], v[7], b1);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_rows8(acc[i], a.x & main4, a.y & main4, b0[i], b1[i]);
      for (int p = 0; p < n_planes; ++p) {
        const uint32_t am = s_am[p], wm = s_wm[p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mma_rows8(sub[i], a.x & am, a.y & am, b0[i] & wm, b1[i] & wm);
      }
    } else {
      const uint4 a = arow ? *reinterpret_cast<const uint4*>(afrag + r * SK_KR)
                           : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t au[4] = {a.x, a.y, a.z, a.w};
      if (wn == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) stats(au[e]);
      }
      const uint8_t* stage = ring + (r % SK_STAGES) * SK_BN * SK_WLD;
      uint4 w[SK_CG];
#pragma unroll
      for (int j = 0; j < SK_CG; ++j) {
        w[j] = *reinterpret_cast<const uint4*>(
            stage + (wn * 8 * SK_CG + 8 * j + g) * SK_WLD + koff);
        mma_rows8(acc[j], au[0] & main4, au[1] & main4, w[j].x, w[j].y);
        mma_rows8(acc[j], au[2] & main4, au[3] & main4, w[j].z, w[j].w);
      }
      for (int p = 0; p < n_planes; ++p) {
        const uint32_t am = s_am[p], wm = s_wm[p];
#pragma unroll
        for (int j = 0; j < SK_CG; ++j) {
          mma_rows8(sub[j], au[0] & am, au[1] & am, w[j].x & wm, w[j].y & wm);
          mma_rows8(sub[j], au[2] & am, au[3] & am, w[j].z & wm, w[j].w & wm);
        }
      }
    }
  }

  // the block's partial: warps' sums in shared memory, added in warp order
  if constexpr (ROWW) {  // lane (g, t): mma i's columns 8t + i, 8t + 4 + i
    int* dst = red + (wk * 8 + g) * SK_RLD + 8 * t;
    *reinterpret_cast<int4*>(dst) = make_int4(
        acc[0][0] - sub[0][0], acc[1][0] - sub[1][0], acc[2][0] - sub[2][0],
        acc[3][0] - sub[3][0]);
    *reinterpret_cast<int4*>(dst + 4) = make_int4(
        acc[0][1] - sub[0][1], acc[1][1] - sub[1][1], acc[2][1] - sub[2][1],
        acc[3][1] - sub[3][1]);
  } else {
#pragma unroll
    for (int j = 0; j < SK_CG; ++j) {
      const int c = wn * 8 * SK_CG + 8 * j + 2 * t;
      *reinterpret_cast<int2*>(red + (wk * 8 + g) * SK_RLD + c) =
          make_int2(acc[j][0] - sub[j][0], acc[j][1] - sub[j][1]);
    }
  }
  if (wn == 0) {
    sqa += __shfl_xor_sync(0xffffffffu, sqa, 1);
    sqa += __shfl_xor_sync(0xffffffffu, sqa, 2);
    sx += __shfl_xor_sync(0xffffffffu, sx, 1);
    sx += __shfl_xor_sync(0xffffffffu, sx, 2);
    if (t == 0) {
      sred[wk * 16 + 2 * g] = (int)sqa;
      sred[wk * 16 + 2 * g + 1] = (int)sx;
    }
  }
  __syncthreads();
  const int orow = tid / SK_BN, ocol = tid % SK_BN;
  int v = 0, st = 0;
#pragma unroll
  for (int w = 0; w < WK; ++w) {
    v += red[(w * 8 + orow) * SK_RLD + ocol];
    if (tid < 16) st += sred[w * 16 + tid];
  }

  // into slot `rank` of the leader's shared memory
  cluster_wait();  // every block of the cluster runs
  const uint32_t dst = mapa(smem_addr(slots + rank * SK_SLOT), 0);
  st_cluster(dst + 4 * tid, v);
  if (tid < 16) st_cluster(dst + 4 * (8 * SK_BN + tid), st);
  cluster_arrive();
  const int col = n0 + ocol;
  const bool store = rank == 0 && orow < M && col < N;
  Col kc;
  if (store) kc = load_col(epi, load_scalars(epi), col);
  cluster_wait();  // every partial is in the leader
  if (!store) return;
  int a_sum = 0, sqa_sum = 0, sx_sum = 0;
  for (int q = 0; q < cs; ++q) {
    const int* s = slots + q * SK_SLOT;
    a_sum += s[tid];
    sqa_sum += s[8 * SK_BN + 2 * orow];
    sx_sum += s[8 * SK_BN + 2 * orow + 1];
  }
  store1(epi, (size_t)orow * N + col,
         epi_value(a_sum, (float)sx_sum, (float)sqa_sum, kc, epi.use_cv));
}

// --- conv route: one fused launch for im2col-shaped calls ------------------
//
// The CNNs' im2col calls are tall and narrow: M = 16,000-256,000 rows of
// K = 16-1152 values against N = 4-128 columns.  They are bound by bytes
// (x read once, out written once: at (256,000, 288, 32) float32, 295 MB in
// and 33 MB out); truncated m=7's eight products are a fifth of that time
// on the int8 tensor cores.  The prep kernel and wgmma tile paid a block
// launch a row, wrote and read the codes back, and padded N to 128 and K
// to 128 bytes.  Here one launch streams x once and keeps everything else
// on the chip:
//   * Persistent blocks (as many as fit, at most one a row tile) walk row
//     tiles of bm rows.  x is row-major and contiguous, so a tile is one
//     span of bm * K values: its whole 16-byte vectors, whatever K's
//     alignment (a K = 27 row starts at a 108-byte offset), arrive by bulk
//     copies (cp.async.bulk, completion on an mbarrier) of CV_CHUNK vectors
//     into a ring of CV_STAGES slots.  A producer warp issues them, up to
//     the ring's depth ahead and across tile boundaries, so the next tile's
//     x is on its way while the eight consumer warps multiply, run the
//     epilogue and store.  Values before the first or after the last whole
//     vector of a tile (a misaligned x, the last partial tile) are read one
//     by one.
//   * A consumer thread takes every CV_THREADS-th vector of a slot, finds
//     its k and code-tile offset from its previous vector's by a constant
//     step with one carry (a division once a tile), quantizes in registers
//     (codes4: to_code's codes, four values' chains interleaved) and writes
//     only the codes to shared memory: one store where the vector lies in
//     one row at a 4-aligned k, bytes where it wraps.  Code rows are padded
//     to kp = K rounded up to 32 with code 0 (zeroed once a block;
//     quantizing never writes there) and to a stride of kp + 16 bytes, so
//     the 8 rows of an ldmatrix hit distinct banks.
//   * The pack is read once a block: the K-major codes of all N columns
//     (N padded to 16, K to kp, with zeros) and the epilogue's per-column
//     constants stay in shared memory.
//   * Products: a warp takes items in turn, each a 16-row m-tile and a
//     group of its 16-column pairs (so that every warp has one where the
//     m-tiles are few); ldmatrix.x4 loads the unmasked A fragment and two
//     8-column B fragments for 32 K bytes, and mma.sync m16n8k32 u8
//     accumulates (A & main).W and each plane's (A & amask).(W & wmask) in
//     registers.  The row statistics (sum of codes, CV statistic) come from
//     the same unmasked A fragments, once an item: a row's codes lie in the
//     4 lanes of one quad, so two shuffles finish them, with no block
//     barrier a row.
//   * The epilogue (load_col / epi_value, as the other routes) writes the
//     tile's values into shared memory, rows ss elements apart (ss >= N, ss
//     = 8 mod 16, so the 8-byte column pairs of a half warp's four rows hit
//     distinct banks), and the consumers store the rows as one contiguous
//     span of out in 16-byte pieces, coalesced at any N (N = 4 included).
// Two consumer barriers a tile: codes written -> products; values staged
// -> store (which also frees the codes for the next tile).  A call is one
// launch with no scratch.  What keeps it above its byte bound (PERF.md):
// while a block multiplies, runs the epilogue and stores, it quantizes
// nothing, and the ring only refills.  Consumers split into quantizer and
// multiplier warps on two code tiles were tried and were no faster: fewer
// warps were left to quantize.

constexpr int CONV_K_MAX = 1152;          // the route's widest fan-in,
constexpr int CONV_N_MAX = 128;           // widest output
constexpr int CONV_KN_MAX = 36864;        // and largest K * N
constexpr int CV_THREADS = 256;           // consumer threads
constexpr int CV_WARPS = CV_THREADS / 32;
constexpr int CV_BLOCK = CV_THREADS + 32;  // and one producer warp
constexpr int CV_CHUNK = 512;             // 16-byte vectors a ring slot
constexpr int CV_STAGES = 3;              // ring slots
constexpr int CV_TILE_BYTES = 64 * 1024;  // x bytes a row tile aims at
constexpr int CV_BM_MIN = 32, CV_BM_MAX = 128;
constexpr int CV_SMEM = 232448 - 1024;    // dynamic shared memory a block
static_assert(CV_CHUNK % CV_THREADS == 0, "whole rounds of vectors a slot");

// A call's row-tile geometry and shared-memory layout (conv_geom)
struct ConvGeom {
  int bm;       // rows a tile, a multiple of 16
  int kp;       // K rounded up to 32 (one mma's depth)
  int lda;      // byte stride of a code row and of a weight row: kp + 16
  int np;       // N rounded up to 16 (two mma widths)
  int ss;       // element stride of a staged output row (= 8 mod 16)
  int tiles;    // ceil(M / bm)
  int codes_off, w_off, out_off, col_off, bar_off;  // byte offsets
  int smem;     // dynamic shared-memory bytes
};

// 1-D bulk copy of `bytes` (a multiple of 16) global -> shared, completion
// on an mbarrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CV_THREADS) : "memory");
}

// the first n bytes of w (n <= 0: none, n >= 4: all)
__device__ __forceinline__ uint32_t keep_bytes(uint32_t w, int n) {
  return n >= 4 ? w : n <= 0 ? 0u : w & ((1u << (8 * n)) - 1u);
}

// The conv kernel's quantizer: to_code's codes, four at a time, in fewer
// operations.  t = q + 1.5 * 2^23 is 1.5 * 2^23 + round(q) (one rounding,
// half to even) wherever the code does not clip; t + za clamped to [1.5 *
// 2^23, 1.5 * 2^23 + 255] holds the code in its low byte.  The four fast
// quotients and their tie tests come first, so the four chains interleave;
// a value near a tie takes the IEEE quotient on to_code's condition, in a
// branch taken once for the four.  to_code's |q| < 512 test only spares
// the division where both quotients clip alike, so it is left out.
struct QuantC {
  float sa, inv, za;
};
__device__ __forceinline__ QuantC make_quant_c(float sa, float za) {
  return {sa, __fdiv_rn(1.0f, sa), za};
}
__device__ __forceinline__ uint32_t codes4(float x0, float x1, float x2,
                                           float x3, const QuantC& qc) {
  constexpr float kRound = 12582912.0f, kTie = 0.5f - 0x1p-12f;
  const float x[4] = {x0, x1, x2, x3};
  float t[4];
  bool near = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = x[i] * qc.inv;
    t[i] = q + kRound;
    near |= fabsf(q - (t[i] - kRound)) > kTie;
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float q = x[i] * qc.inv;
      if (fabsf(q - (t[i] - kRound)) > kTie)
        t[i] = __fdiv_rn(x[i], qc.sa) + kRound;
    }
  }
  uint32_t c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[i] = __float_as_uint(fminf(fmaxf(t[i] + qc.za, kRound), kRound + 255.0f));
  // the low bytes of c[0..3], in that order
  return __byte_perm(__byte_perm(c[0], c[1], 0x0040),
                     __byte_perm(c[2], c[3], 0x0040), 0x5410);
}

// One 16-byte vector of x: its V values' codes, four to a word
template <typename InT>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int V = 4;
  __device__ static void codes(const uint4& u, const QuantC& qc,
                               uint32_t (&w)[1]) {
    w[0] = codes4(__uint_as_float(u.x), __uint_as_float(u.y),
                  __uint_as_float(u.z), __uint_as_float(u.w), qc);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int V = 8;
  // a bfloat16 is the high half of the float32 of the same value
  __device__ static uint32_t four(uint32_t h0, uint32_t h1,
                                  const QuantC& qc) {
    return codes4(__uint_as_float(h0 << 16),
                  __uint_as_float(h0 & 0xFFFF0000u),
                  __uint_as_float(h1 << 16),
                  __uint_as_float(h1 & 0xFFFF0000u), qc);
  }
  __device__ static void codes(const uint4& u, const QuantC& qc,
                               uint32_t (&w)[2]) {
    w[0] = four(u.x, u.y, qc);
    w[1] = four(u.z, u.w, qc);
  }
};
template <>
struct Vec16<uint8_t> {
  static constexpr int V = 16;
  __device__ static void codes(const uint4& u, const QuantC&,
                               uint32_t (&w)[4]) {
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  }
};

// A vector's 4 W codes at byte ofs = row * lda + k of the code tile, k <
// K: one store where they lie in one row at a 4-aligned k, else byte by
// byte across the row's end
template <int W>
__device__ __forceinline__ void put_codes(uint8_t* codes, int ofs, int k,
                                          int K, int lda,
                                          const uint32_t (&w)[W]) {
  if (k + 4 * W <= K && (k & 3) == 0) {
    uint32_t* p = reinterpret_cast<uint32_t*>(codes + ofs);
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = w[i];
    return;
  }
#pragma unroll
  for (int i = 0; i < 4 * W; ++i) {
    codes[ofs++] = (uint8_t)(w[i / 4] >> (8 * (i % 4)));
    if (++k == K) { k = 0; ofs += lda - K; }
  }
}
// W words at a 4 W-aligned address
__device__ __forceinline__ void st_words(uint8_t* p, const uint32_t (&w)[1]) {
  *reinterpret_cast<uint32_t*>(p) = w[0];
}
__device__ __forceinline__ void st_words(uint8_t* p, const uint32_t (&w)[2]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void st_words(uint8_t* p, const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// a column's constants in shared memory, padded to two 16-byte loads
struct __align__(16) ColS {
  Col c;
  float pad;
};

template <typename InT, bool ROWW>
__global__ void __launch_bounds__(CV_BLOCK, 3)
am_conv_kernel(const InT* __restrict__ x, const uint8_t* __restrict__ wt,
               int ldt, int M, int K, int N, ConvGeom g, Epi epi, Planes pl,
               uint32_t main4, int stat_kind, uint32_t stat4) {
  // wt: K-major (N rows of ldt bytes, ldt >= K a multiple of 16), or with
  // ROWW row-major (K rows of ldt >= N bytes, any alignment)
  using VT = Vec16<InT>;
  constexpr int V = VT::V, W = V / 4;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint32_t s_am[8], s_wm[8];
  const uint4* ring = reinterpret_cast<const uint4*>(smem);  // (S, CHUNK)
  uint8_t* codes = smem + g.codes_off;                 // (bm, lda)
  uint8_t* wsm = smem + g.w_off;                       // (np, lda)
  uint8_t* stage = smem + g.out_off;                   // (bm, ss), out's type
  ColS* cols = reinterpret_cast<ColS*>(smem + g.col_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  uint64_t* empty = full + CV_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // x as 16-byte vectors: vector q holds elements [q V - s, q V - s + V)
  const int s = (int)(((uintptr_t)x & 15) / sizeof(InT));
  const uint4* xv = reinterpret_cast<const uint4*>(
      reinterpret_cast<const uint8_t*>(x) - s * (int)sizeof(InT));
  // tile t's whole vectors: [qa, qa + nv)
  auto span = [&](int t, long long& qa, long long& nv) {
    const long long e0 = (long long)t * g.bm * K;
    const long long e1 = (long long)min(t * g.bm + g.bm, M) * K;
    qa = (e0 + s + V - 1) / V;
    const long long qb = (e1 + s) / V;
    nv = qb > qa ? qb - qa : 0;
  };

  if (tid == 0) {
    for (int i = 0; i < CV_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CV_WARPS);  // one release per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CV_WARPS) {  // producer: one lane keeps the ring full
    if (lane == 0) {
      uint32_t q = 0;  // slots filled so far
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        long long qa, nv;
        span(t, qa, nv);
        for (long long c0 = 0; c0 < nv; c0 += CV_CHUNK, ++q) {
          const int sl = q % CV_STAGES;
          mbar_wait(&empty[sl], ((q / CV_STAGES) & 1) ^ 1);
          const int bytes = (int)min((long long)CV_CHUNK, nv - c0) * 16;
          mbar_expect_tx(&full[sl], bytes);
          bulk_load(smem + sl * CV_CHUNK * 16, xv + qa + c0, bytes,
                    &full[sl]);
        }
      }
    }
    return;  // the consumers synchronise among themselves (barrier 1)
  }

  // once a block: code tile zeroed (the K padding stays 0), the weights
  // (zeros past K and N), the column constants, the plane masks
  for (int i = tid; i < g.bm * g.lda / 16; i += CV_THREADS)
    reinterpret_cast<uint4*>(codes)[i] = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (ROWW) {
    // a thread takes 4 rows of one column (neighbouring threads:
    // neighbouring columns) and stores them as one K-major word
    const int kq = g.kp / 4;
    for (int i = tid; i < g.np * kq; i += CV_THREADS) {
      const int kb = (i / g.np) * 4, n = i - (i / g.np) * g.np;
      uint32_t w = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n < N && kb + e < K)
          w |= (uint32_t)__ldg(wt + (size_t)(kb + e) * ldt + n) << (8 * e);
      *reinterpret_cast<uint32_t*>(wsm + n * g.lda + kb) = w;
    }
  } else {
    const int wch = g.kp / 16;
    for (int i = tid; i < g.np * wch; i += CV_THREADS) {
      const int n = i / wch, kb = (i - n * wch) * 16;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && kb < K) {  // kb + 16 <= ldt: ldt >= K, a multiple of 16
        w = *reinterpret_cast<const uint4*>(wt + (size_t)n * ldt + kb);
        const int keep = K - kb;
        w.x = keep_bytes(w.x, keep);
        w.y = keep_bytes(w.y, keep - 4);
        w.z = keep_bytes(w.z, keep - 8);
        w.w = keep_bytes(w.w, keep - 12);
      }
      *reinterpret_cast<uint4*>(wsm + n * g.lda + kb) = w;
    }
  }
  {
    const Scalars sc = load_scalars(epi);
    for (int i = tid; i < N; i += CV_THREADS) cols[i].c = load_col(epi, sc, i);
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) { s_am[i] = pl.amask[i]; s_wm[i] = pl.wmask[i]; }
  }
  const Quant qp = make_quant(epi.meta[0], epi.meta[1]);  // single values
  const QuantC qc = make_quant_c(epi.meta[0], epi.meta[1]);
  // a thread's successive vectors lie CV_THREADS * V elements apart: dk
  // further in K, dofs further in the code tile (before K's carry); where
  // K is a multiple of V and x 16-byte aligned, each lies in one row at a
  // V-aligned k
  const int dk = (int)((long long)CV_THREADS * V % K);
  const int dofs = (int)((long long)CV_THREADS * V / K) * g.lda + dk;
  const bool whole = s == 0 && K % V == 0;
  const int MT = g.bm / 16, NPAIR = g.np / 16, KC = g.kp / 32;
  const int G = max(1, min(NPAIR, CV_WARPS / MT));
  const int n_planes = pl.n;
  const int es = epi.out_bf16 ? 2 : 4;
  // ldmatrix row addresses: A rows (lane & 7) + 8 * bit 3, K bytes 16 *
  // bit 4 (fragments a0..a3); B columns (lane & 7) + 8 * bit 4, K bytes 16
  // * bit 3 (b0, b1 of two 8-column tiles)
  const uint32_t a_lane =
      smem_addr(codes) + ((lane & 7) + ((lane >> 3) & 1) * 8) * g.lda +
      (lane >> 4) * 16;
  const uint32_t b_lane =
      smem_addr(wsm) + ((lane >> 4) * 8 + (lane & 7)) * g.lda +
      ((lane >> 3) & 1) * 16;
  const int qr = lane >> 2, qt = lane & 3;
  // 16-byte pieces of out: E elements, a row's worth cpr of them where N
  // is a multiple of E (else the store goes element by element)
  const int E = 16 / es, cpr = N % E == 0 ? N / E : 0;
  consumer_sync();

  uint32_t q = 0;  // slots consumed so far
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const int m0 = t * g.bm, m1 = min(m0 + g.bm, M);
    long long qa, nv;
    span(t, qa, nv);
    // (k, code-tile offset) of this thread's first vector
    const long long e = (qa + tid) * V - s;
    const int r0 = (int)(e / K);
    int k = (int)(e - (long long)r0 * K);
    int ofs = (r0 - m0) * g.lda + k;
    for (long long c0 = 0; c0 < nv; c0 += CV_CHUNK, ++q) {
      const int sl = q % CV_STAGES;
      const int cnt = (int)min((long long)CV_CHUNK, nv - c0);
      mbar_wait(&full[sl], (q / CV_STAGES) & 1);
      const uint4* src = ring + sl * CV_CHUNK;
#pragma unroll
      for (int u = 0; u < CV_CHUNK / CV_THREADS; ++u) {
        const int i = u * CV_THREADS + tid;
        if (i < cnt) {
          uint32_t w[W];
          VT::codes(src[i], qc, w);
          if (whole) st_words(codes + ofs, w);
          else put_codes(codes, ofs, k, K, g.lda, w);
        }
        k += dk;
        ofs += dofs;
        if (k >= K) { k -= K; ofs += g.lda - K; }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sl]);  // the warp's reads are done
    }
    {  // values outside the whole vectors, one by one
      const long long e0 = (long long)m0 * K, e1 = (long long)m1 * K;
      const long long h1 = nv > 0 ? qa * V - s : e1;
      const long long t0 = nv > 0 ? (qa + nv) * V - s : e1;
      const int nh = (int)(h1 - e0), nt = (int)(e1 - t0);
      for (int i = tid; i < nh + nt; i += CV_THREADS) {
        const long long ee = i < nh ? e0 + i : t0 + (i - nh);
        const int rr = (int)(ee / K), kk = (int)(ee - (long long)rr * K);
        codes[(rr - m0) * g.lda + kk] = (uint8_t)code_of(x[ee], qp);
      }
    }
    consumer_sync();  // the tile's codes are in shared memory

    // items: a 16-row m-tile and one of G groups of its 16-column pairs
    // (every G-th pair), G as large as keeps every warp busy; a warp takes
    // items in turn, and the row statistics once an item
    for (int it = warp; it < MT * G; it += CV_WARPS) {
      const int mt = it / G;
      const uint32_t pa = a_lane + mt * 16 * g.lda;
      uint32_t sq[2] = {0u, 0u}, sx[2] = {0u, 0u};
      for (int pr = it - mt * G; pr < NPAIR; pr += G) {
        const bool first = pr < G;
        int acc[2][4], sub[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) { acc[j][i] = 0; sub[j][i] = 0; }
        const uint32_t pb = b_lane + pr * 16 * g.lda;
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t a[4], b[4];
          ldsm_x4(a, pa + kc * 32);
          ldsm_x4(b, pb + kc * 32);
          if (first) {  // row statistics, once an item
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // a0, a2: row qr; a1, a3: qr + 8
              sq[i & 1] = __dp4a(a[i], 0x01010101u, sq[i & 1]);
              if (stat_kind == 1)
                sx[i & 1] = __dp4a(a[i] & stat4, 0x01010101u, sx[i & 1]);
              else if (stat_kind == 2)
                sx[i & 1] += __popc(nonzero_bytes(a[i] & stat4));
            }
          }
          const uint32_t am[4] = {a[0] & main4, a[1] & main4, a[2] & main4,
                                  a[3] & main4};
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
          mma_u8(acc[0], am, b0);
          mma_u8(acc[1], am, b1);
          for (int p = 0; p < n_planes; ++p) {
            const uint32_t amk = s_am[p], wmk = s_wm[p];
            const uint32_t ap[4] = {a[0] & amk, a[1] & amk, a[2] & amk,
                                    a[3] & amk};
            const uint32_t bp0[2] = {b[0] & wmk, b[1] & wmk};
            const uint32_t bp1[2] = {b[2] & wmk, b[3] & wmk};
            mma_u8(sub[0], ap, bp0);
            mma_u8(sub[1], ap, bp1);
          }
        }
        if (first) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // the quad's four K slices of a row
            sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
            sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
            sx[h] += __shfl_xor_sync(0xffffffffu, sx[h], 1);
            sx[h] += __shfl_xor_sync(0xffffffffu, sx[h], 2);
          }
        }
        // lane (qr, qt) holds rows qr, qr + 8 and columns 2 qt, 2 qt + 1
        // of each 8-column tile
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = pr * 16 + 8 * j + 2 * qt;
          if (col >= N) continue;
          const bool two = col + 1 < N;
          const Col k0 = cols[col].c, k1 = cols[two ? col + 1 : col].c;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mt * 16 + qr + 8 * h;
            const float v0 = epi_value(acc[j][2 * h] - sub[j][2 * h],
                                       (float)sx[h], (float)sq[h], k0,
                                       epi.use_cv);
            const float v1 = epi_value(acc[j][2 * h + 1] - sub[j][2 * h + 1],
                                       (float)sx[h], (float)sq[h], k1,
                                       epi.use_cv);
            const int o = row * g.ss + col;
            if (epi.out_bf16) {
              __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(stage) + o;
              if (two) *reinterpret_cast<__nv_bfloat162*>(d) =
                  __floats2bfloat162_rn(v0, v1);
              else d[0] = __float2bfloat16_rn(v0);
            } else {
              float* d = reinterpret_cast<float*>(stage) + o;
              if (two) *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
              else d[0] = v0;
            }
          }
        }
      }
    }
    consumer_sync();  // the tile's values are staged; the codes are free

    // rows m0..m1 of out are one contiguous span
    const int rows = m1 - m0;
    uint8_t* gout = static_cast<uint8_t*>(epi.out) + (size_t)m0 * N * es;
    if (cpr) {  // whole 16-byte pieces, each within one row
      // piece i is at byte so of the stage; a thread's pieces lie
      // CV_THREADS apart: sdo further on, then the row's end carried
      int c = tid % cpr;
      int so = (tid / cpr) * g.ss * es + c * 16;
      const int sdc = CV_THREADS % cpr;
      const int sdo = (CV_THREADS / cpr) * g.ss * es + sdc * 16;
      for (int i = tid; i < rows * cpr; i += CV_THREADS) {
        reinterpret_cast<uint4*>(gout)[i] =
            *reinterpret_cast<const uint4*>(stage + so);
        c += sdc;
        so += sdo;
        if (c >= cpr) { c -= cpr; so += g.ss * es - cpr * 16; }
      }
    } else {
      for (int i = tid; i < rows * N; i += CV_THREADS) {
        const int rr = i / N, c = i - rr * N;
        const uint8_t* src = stage + (rr * g.ss + c) * es;
        for (int b = 0; b < es; ++b) gout[i * es + b] = src[b];
      }
    }
  }
}

// --- rows tile: codes-in calls whose operands are off 16 bytes -----------
//
// The transposing wgmma tiles read both operands by TMA, which needs row
// strides and bases that are multiples of 16 bytes.  Where an operand is
// not (K = 2000 at an odd N, hymba's head at N = 32,001 above 8 rows), the
// rows tile runs the call: mma.sync over cp.async stages of both operands
// as they lie in memory, B fragments by register transposes.
//   * One 64 x 128 block tile of eight warps (2 x 4, each 32 x 32); K steps
//     of 128 bytes (64 with planes, which take a second accumulator array)
//     through a ring of four stages, both operands copied in 16-byte
//     pieces by cp.async where aligned, else byte by byte (rows or columns
//     past M, N, K zero).  The codes rows are padded by 16 bytes, so
//     ldmatrix's 8 rows fall on distinct banks; a weight row (one k, BN
//     columns) is BN bytes with its 16-byte chunks XOR-swizzled by 2
//     ((k >> 2) & 3), so the four k rows 4t + e of one B load fall on
//     distinct banks.
//   * A fragments by ldmatrix.x4 (the codes are K-major already); a lane
//     (g, t) reads 32-bit words at rows 4t .. 4t + 3 and 16 + 4t .. 16 + 4t
//     + 3 of a 32-byte K step, bytes 4g .. 4g + 3 of its warp's 32 columns,
//     and transposes each four (transpose4) into the B fragments of four
//     mmas: mma i's column index g stands for column 4g + i (the K order is
//     the mma's own).  Lane (g, t) so holds columns 8t .. 8t + 7 of rows g
//     and g + 8 of each m16 tile, stored as two 16-byte pieces a row.
//   * The planes mask A and W after the transpose, on the same registers;
//     the row statistics come from the unmasked A fragments, each m16
//     tile's from one warp of its row slab (m-tile mt: warp wn = mt),
//     summed over the quad and handed to the other warps through shared
//     memory: no prep kernel, no scratch, one launch a call.
//   * The epilogue is load_col / epi_value, as every route, from the
//     accumulators straight to out (float32).
// No served call takes it; it is kept for the alignments TMA refuses, not
// tuned (PERF.md row 2 has its time at the olmo-1b shapes).

constexpr int RT_THREADS = 256;

// BK: K bytes a stage (128: more bytes in flight a block); 2 warps along
// M, 4 along N
template <int BM_, int BN_, int BK_, int STAGES_, bool PLANES_>
struct RowTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr bool PLANES = PLANES_;
  static constexpr int WM = 2, WN = RT_THREADS / 32 / WM;
  static constexpr int ALD = BK + 16;  // codes row stride in the ring
  static constexpr int MT = BM / (16 * WM);  // m16 tiles a warp
  static constexpr int NG = BN / (32 * WN);  // 32-column groups a warp
  static constexpr int A_BYTES = BM * ALD, B_BYTES = BK * BN;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int A_PIECES = BM * BK / 16;
  static constexpr int PIECES = (A_PIECES + BK * BN / 16) / RT_THREADS;
  static constexpr int COLS_OFF = STAGES * STAGE;
  static constexpr int ROWS_OFF = COLS_OFF + BN * (int)sizeof(Col);
  static constexpr int SMEM = ROWS_OFF + 2 * BM * 4;
  // MT * NG * 16 accumulators a thread (twice with planes): two blocks an
  // SM at 64 of them
  static constexpr int CTAS = (PLANES ? 2 : 1) * MT * NG <= 4 ? 2 : 1;
  static_assert(BM == 64 || BM == 128, "tile rows");
  static_assert(MT * WM * 16 == BM && NG * WN * 32 == BN, "warp tiles");
  static_assert(NG == 1 || NG == 2, "tile columns");
  static_assert(BK == 64 || BK == 128, "stage depth");
  static_assert(MT <= WN, "a warp of the row slab for each m16 tile");
  static_assert(A_PIECES % RT_THREADS == 0, "whole rounds of pieces");
  static_assert(ROWS_OFF % 16 == 0, "aligned row statistics");
  static_assert(CTAS * SMEM <= 232448, "shared memory");
};

// byte offset of weight chunk c (16 bytes) of ring row k, rows bn bytes:
// chunks XOR 2 ((k >> 2) & 3), kept inside a 64-byte row (there t and t + 2
// share banks)
__device__ __forceinline__ int rt_swz(int k, int bn) {
  return (((k >> 2) & 3) << 1) & (bn / 16 - 1);
}
__device__ __forceinline__ int rt_wofs(int k, int c, int bn) {
  return k * bn + ((c ^ rt_swz(k, bn)) << 4);
}

template <class T>
__global__ void __launch_bounds__(RT_THREADS, T::CTAS)
am_rows_kernel(const uint8_t* __restrict__ a, int avec,
               const uint8_t* __restrict__ w, int ldw, int wvec, int M,
               int K, int N, Epi epi, Planes pl, uint32_t main4,
               int stat_kind, uint32_t stat4) {
  // a: (M, K) codes, rows K bytes apart; w: (K, N) codes, rows ldw bytes
  // apart; avec / wvec: 16-byte copies allowed (K / ldw and the base a
  // multiple of 16)
  constexpr int BM = T::BM, MT = T::MT, S = T::STAGES;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint32_t s_am[8], s_wm[8];
  Col* cols = reinterpret_cast<Col*>(smem + T::COLS_OFF);
  int* rstats = reinterpret_cast<int*>(smem + T::ROWS_OFF);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int WN = T::WN, SLAB = BM / T::WM;  // rows a warp
  const int wm = warp / WN, wn = warp % WN;
  constexpr int BN = T::BN, NG = T::NG, CPR = BN / 16, BK = T::BK;
  constexpr int ALD = T::ALD, APR = BK / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nkt = (K + BK - 1) / BK;

  // stage kt: piece q < A_PIECES is codes row q / APR, K bytes 16 (q % APR);
  // the rest weight row (q - A_PIECES) / CPR, column chunk (q - A_PIECES)
  // % CPR
  auto load_stage = [&](int kt) {
    uint8_t* st = smem + (kt % S) * T::STAGE;
    const int kb = kt * BK;
#pragma unroll
    for (int j = 0; j < T::PIECES; ++j) {
      const int q = j * RT_THREADS + tid;
      if (j < T::A_PIECES / RT_THREADS) {
        const int r = q / APR, c = (q % APR) * 16;
        const int nb = m0 + r < M ? max(0, min(16, K - kb - c)) : 0;
        const uint8_t* src = a + (size_t)(m0 + r) * K + kb + c;
        uint8_t* dst = st + r * ALD + c;
        if (avec) cp_async16(dst, nb ? src : a, nb);
        else *reinterpret_cast<uint4*>(dst) = ld_bytes16(src, nb);
      } else {
        const int qb = q - T::A_PIECES, r = qb / CPR, c = qb % CPR;
        const int nb = kb + r < K ? max(0, min(16, N - n0 - 16 * c)) : 0;
        const uint8_t* src = w + (size_t)(kb + r) * ldw + n0 + 16 * c;
        uint8_t* dst = st + T::A_BYTES + rt_wofs(r, c, BN);
        if (wvec) cp_async16(dst, nb ? src : w, nb);
        else *reinterpret_cast<uint4*>(dst) = ld_bytes16(src, nb);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nkt) load_stage(s);
    cp_async_commit();
  }
  {  // the epilogue's column constants (read after the main loop)
    const Scalars sc = load_scalars(epi);
    for (int i = tid; i < BN; i += RT_THREADS)
      if (n0 + i < N) cols[i] = load_col(epi, sc, n0 + i);
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) { s_am[i] = pl.amask[i]; s_wm[i] = pl.wmask[i]; }
  }

  int acc[MT][4 * NG][4], sub[T::PLANES ? MT : 1][4 * NG][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4 * NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][i][e] = 0;
        if constexpr (T::PLANES) sub[mt][i][e] = 0;
      }
  // row statistics of m16 tile wn (rows g, g + 8), from its warp of the
  // row half (the tile's other warps skip them)
  uint32_t sq0 = 0u, sq1 = 0u, sx0 = 0u, sx1 = 0u;
  auto stat = [&](uint32_t a, uint32_t& q, uint32_t& x) {
    q = __dp4a(a, 0x01010101u, q);
    if (stat_kind == 1) x = __dp4a(a & stat4, 0x01010101u, x);
    else if (stat_kind == 2) x += __popc(nonzero_bytes(a & stat4));
  };
  const int n_planes = pl.n;
  // ldmatrix rows: (lane & 7) + 8 * bit 3, K bytes 16 * bit 4
  const uint32_t a_lane = smem_addr(smem) +
      (wm * SLAB + (lane & 7) + ((lane >> 3) & 1) * 8) * ALD +
      (lane >> 4) * 16;
  // B words of 32-column group gi: chunk 2 (NG wn + gi) + g / 4, word g %
  // 4 of rows 4t + e (swizzle: 2t)
  int b_lane[NG];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi)
    b_lane[gi] = T::A_BYTES + 4 * t * BN +
                 (((2 * (NG * wn + gi) + (g >> 2)) ^ rt_swz(4 * t, BN)) << 4) +
                 4 * (g & 3);
  // the fragments of 32-byte K step kc of the stage at byte st
  auto frags = [&](int st, int kc, uint32_t (&af)[MT][4],
                   uint32_t (&b0)[4 * NG], uint32_t (&b1)[4 * NG]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(af[mt], a_lane + st + mt * 16 * ALD + kc * 32);
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      const uint8_t* bp = smem + st + b_lane[gi] + kc * 32 * BN;
      uint32_t v[8], t0[4], t1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = *reinterpret_cast<const uint32_t*>(bp + e * BN);
        v[4 + e] = *reinterpret_cast<const uint32_t*>(bp + (16 + e) * BN);
      }
      transpose4(v[0], v[1], v[2], v[3], t0);
      transpose4(v[4], v[5], v[6], v[7], t1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b0[4 * gi + i] = t0[i];
        b1[4 * gi + i] = t1[i];
      }
    }
  };

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<S - 2>();  // this thread's pieces of stage kt
    __syncthreads();  // everyone's; stage kt - 1 is free again
    if (kt + S - 1 < nkt) load_stage(kt + S - 1);
    cp_async_commit();
    const int st = (kt % S) * T::STAGE;
    // two fragment sets: step kc + 1's loads are issued before step kc's
    // products
    uint32_t af[2][MT][4], b0[2][4 * NG], b1[2][4 * NG];
    frags(st, 0, af[0], b0[0], b1[0]);
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc) {
      const int cur = kc & 1;
      if (kc + 1 < BK / 32) frags(st, kc + 1, af[cur ^ 1], b0[cur ^ 1],
                                  b1[cur ^ 1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* a = af[cur][mt];
        if (mt == wn) {  // a0, a2: row g; a1, a3: row g + 8
          stat(a[0], sq0, sx0);
          stat(a[2], sq0, sx0);
          stat(a[1], sq1, sx1);
          stat(a[3], sq1, sx1);
        }
        const uint32_t am[4] = {a[0] & main4, a[1] & main4, a[2] & main4,
                                a[3] & main4};
#pragma unroll
        for (int i = 0; i < 4 * NG; ++i) {
          const uint32_t b[2] = {b0[cur][i], b1[cur][i]};
          mma_u8(acc[mt][i], am, b);
        }
      }
      if constexpr (T::PLANES) {
        for (int p = 0; p < n_planes; ++p) {
          const uint32_t amk = s_am[p], wmk = s_wm[p];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t* a = af[cur][mt];
            const uint32_t ap[4] = {a[0] & amk, a[1] & amk, a[2] & amk,
                                    a[3] & amk};
#pragma unroll
            for (int i = 0; i < 4 * NG; ++i) {
              const uint32_t bp2[2] = {b0[cur][i] & wmk, b1[cur][i] & wmk};
              mma_u8(sub[mt][i], ap, bp2);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4 * NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if constexpr (T::PLANES) acc[mt][i][e] -= sub[mt][i][e];

  // the quad's four K slices of a row, then to the block
  if (wn < MT) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t q = h ? sq1 : sq0, x = h ? sx1 : sx0;
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (t == 0) {
        const int r = wm * SLAB + wn * 16 + g + 8 * h;
        rstats[2 * r] = (int)q;
        rstats[2 * r + 1] = (int)x;
      }
    }
  }
  __syncthreads();

  // lane (g, t): columns c0 .. c0 + 7 of each 32-column group, rows g and
  // g + 8 of each m16 tile; column c0 + j is mma (j & 3)'s accumulator j >>
  // 2 (row g) or 2 + (j >> 2)
  float* out = static_cast<float*>(epi.out);
#pragma unroll
  for (int gi = 0; gi < NG; ++gi)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int c0 = (NG * wn + gi) * 32 + 8 * t;
    const bool whole = (N & 3) == 0 && n0 + c0 + 8 <= N;
    const int rl = wm * SLAB + mt * 16 + g;
    float f[2][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const Col k = cols[n0 + c0 + j < N ? c0 + j : 0];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = acc[mt][4 * gi + (j & 3)][2 * h + (j >> 2)];
        f[h][j] = epi_value(v, (float)rstats[2 * (rl + 8 * h) + 1],
                            (float)rstats[2 * (rl + 8 * h)], k, epi.use_cv);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + rl + 8 * h;
      if (row >= M) continue;
      float* o = out + (size_t)row * N + n0 + c0;
      if (whole) {
        *reinterpret_cast<float4*>(o) =
            make_float4(f[h][0], f[h][1], f[h][2], f[h][3]);
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(f[h][4], f[h][5], f[h][6], f[h][7]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (n0 + c0 + j < N) o[j] = f[h][j];
      }
    }
  }
}

// --- host side --------------------------------------------------------------

Planes make_planes(int n, unsigned long long amasks, unsigned long long wmasks) {
  Planes p;
  p.n = n;
  for (int i = 0; i < 8; ++i) {
    p.amask[i] = (uint32_t)((amasks >> (8 * i)) & 0xff) * 0x01010101u;
    p.wmask[i] = (uint32_t)((wmasks >> (8 * i)) & 0xff) * 0x01010101u;
  }
  return p;
}

// CUDA launches of each matmul kernel that the launch functions made since
// the library was loaded (read by am_launches), in the wrapper's
// LAUNCH_KINDS order; one host thread launches
enum LaunchKind { L_PREP, L_WGMMA, L_SPLIT_K, L_CONV, L_ROWS, L_KINDS };
unsigned long long g_launches[L_KINDS];

// cudaGetLastError after a launch of `kind`, counted if it is 0
int counted(LaunchKind kind) {
  const int err = (int)cudaGetLastError();
  if (err == 0) ++g_launches[kind];
  return err;
}

// status codes beyond cudaError_t's range (the wrapper names them)
constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled not found
constexpr int ERR_TMA_MAP = -2;     // the driver refused a tensor map

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    if (e != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (rows, inner) uint8 matrix with row stride ld bytes, read in boxes of
// (box_rows, box_inner): with 128-byte swizzle (sw128: the K-major
// operands, box_inner = PBK), else as they lie (row-major weights);
// out-of-bounds bytes read as 0
int tma_map(CUtensorMap* map, const void* base, int inner, int rows, int ld,
            int box_inner, int box_rows, bool sw128) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        sw128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMA_MAP;
}

struct Operands {
  const uint8_t* q; int ldq;    // (M, ldq) codes (prefill tile: masked)
  const uint8_t* wt; int ldt;   // (wt_rows >= N, ldt) K-major weights, or
  int wt_rows;                  // (K, ldt >= N) row-major (codes entry)
  int M, K, N;
};

// ROWW tiles: o.q, o.wt the codes-in entry's a_q (ldq = K) and row-major
// w_q, both 16-byte aligned with row strides a multiple of 16
template <class T>
int launch_wgmma(const Operands& o, const Epi& epi, const Planes& pl,
                 uint32_t main4, int stat_kind, uint32_t stat4,
                 cudaStream_t stream) {
  auto kern = am_wgmma_kernel<T>;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap ta, tb;
  int st = tma_map(&ta, o.q, o.ldq, o.M, o.ldq, PBK, T::BM, true);
  if (st == 0)
    st = T::ROWW
        ? tma_map(&tb, o.wt, o.N, o.K, o.ldt, T::BN, PBK, false)
        : tma_map(&tb, o.wt, o.ldt, o.wt_rows, o.ldt, PBK, T::BN, true);
  if (st != 0) return st;
  const dim3 grid((o.M + T::BM - 1) / T::BM, (o.N + T::BN - 1) / T::BN);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(ta, tb, o.M, o.N, o.K, epi, pl,
                                              main4, stat_kind, stat4);
  return counted(L_WGMMA);
}

constexpr int SMS = 132;

// The split-K kernel's cluster: cs blocks of ks K bytes each (rounds of
// SK_KR bytes).  Enough blocks for 2 * SMS where each block still gets two
// rounds (at K = 2048, N = 2048 that is 256 blocks: eight blocks of one
// round each were slower); more rounds a block where K needs them to fit
// SK_MAX_CS blocks.
struct SplitK {
  int cs, ks;
};
SplitK split_k(int K, int N) {
  const int tiles = (N + SK_BN - 1) / SK_BN;
  const int chunks = (K + SK_KR - 1) / SK_KR;
  const int want = std::min(SK_MAX_CS, (2 * SMS + tiles - 1) / tiles);
  int r = std::max(2, chunks / want);
  r = std::max(r, (chunks + SK_MAX_CS - 1) / SK_MAX_CS);
  r = std::min(r, SK_MAX_ROUNDS);
  return {(chunks + r - 1) / r, r * SK_KR};
}

// 16-byte copies of a row-major (K, ldt) operand: ldt and base aligned
int row_vec(const void* p, int ld) {
  return ld % 16 == 0 && (uintptr_t)p % 16 == 0;
}

// One launch: quantize, products, cluster reduction and epilogue
template <typename InT, bool ROWW>
int launch_split_k(const InT* x, int vec, const Operands& o, const Epi& epi,
                   const Planes& pl, uint32_t main4, int stat_kind,
                   uint32_t stat4, cudaStream_t stream) {
  auto kern = am_splitk_kernel<InT, ROWW>;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        sk_smem(SK_MAX_ROUNDS * SK_KR, ROWW));
    if (err == cudaSuccess)  // the largest shared-memory carveout: four
      err = cudaFuncSetAttribute(  // blocks a SM at the served slices
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const SplitK sp = split_k(o.K, o.N);
  if (sp.cs > SK_MAX_CS || sp.ks > SK_MAX_ROUNDS * SK_KR)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sp.cs, (o.N + SK_BN - 1) / SK_BN, 1);
  cfg.blockDim = dim3(SK_THREADS, 1, 1);
  cfg.dynamicSmemBytes = sk_smem(sp.ks, ROWW);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sp.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int wvec = ROWW ? row_vec(o.wt, o.ldt) : 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, x, vec, o.wt, o.ldt, wvec,
                                       o.M, o.K, o.N, sp.ks, epi, pl, main4,
                                       stat_kind, stat4);
  if (err != cudaSuccess) return (int)err;
  return counted(L_SPLIT_K);
}

// The conv route's row tile: about CV_TILE_BYTES of x (bm rows of K
// values, bm a multiple of 16 in [CV_BM_MIN, CV_BM_MAX]), halved while the
// call has fewer tiles than SMs.  Under the route's bounds (K * N <=
// CONV_KN_MAX) the block's shared memory (ring, codes, weights, staged
// output, column constants, barriers) stays under 183 KB, below CV_SMEM
// (the most: uint8 x at K = 545, N = 67).
ConvGeom conv_geom(int M, int K, int N, int in_es, int out_es) {
  ConvGeom g;
  g.kp = (K + 31) / 32 * 32;
  g.lda = g.kp + 16;
  g.np = (N + 15) / 16 * 16;
  g.ss = (N + 7) / 16 * 16 + 8;  // the least ss >= N with ss = 8 mod 16
  int bm = (CV_TILE_BYTES / (K * in_es) + 15) / 16 * 16;
  bm = std::min(CV_BM_MAX, std::max(CV_BM_MIN, bm));
  while (bm > CV_BM_MIN && (M + bm - 1) / bm < SMS)
    bm = std::max(CV_BM_MIN, bm / 32 * 16);
  g.bm = bm;
  g.codes_off = CV_STAGES * CV_CHUNK * 16;
  g.w_off = g.codes_off + bm * g.lda;
  g.out_off = g.w_off + g.np * g.lda;
  g.col_off = g.out_off + (bm * g.ss * out_es + 15) / 16 * 16;
  g.bar_off = g.col_off + N * (int)sizeof(ColS);
  g.smem = g.bar_off + 2 * CV_STAGES * 8;
  g.tiles = (M + bm - 1) / bm;
  return g;
}

// One launch: persistent blocks, as many as fit on the SMs (at most one a
// row tile)
template <typename InT, bool ROWW>
int launch_conv(const InT* x, const Operands& o, const Epi& epi,
                const Planes& pl, uint32_t main4, int stat_kind,
                uint32_t stat4, cudaStream_t stream) {
  auto kern = am_conv_kernel<InT, ROWW>;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, CV_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  if ((uintptr_t)epi.out % 16) return (int)cudaErrorMisalignedAddress;
  const ConvGeom g = conv_geom(o.M, o.K, o.N, (int)sizeof(InT),
                               epi.out_bf16 ? 2 : 4);
  int occ = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, kern, CV_BLOCK, g.smem);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = std::min(g.tiles, SMS * occ);
  kern<<<grid, CV_BLOCK, g.smem, stream>>>(x, o.wt, o.ldt, o.M, o.K, o.N,
                                             g, epi, pl, main4, stat_kind,
                                             stat4);
  return counted(L_CONV);
}

// The matmul kernels, as am_tile names them (the wrapper's TILES lists the
// same names in this order); the codes-in entry takes the split-K and conv
// kernels over row-major weights, the transposing wgmma tiles (tr_*) and,
// where an operand is off 16 bytes, the rows tiles.
enum TileId {
  TILE_SPLIT_K, TILE_128x128_PLANES, TILE_64x128_PLANES, TILE_128x256,
  TILE_128x128, TILE_64x128, TILE_CONV, TILE_ROWS_64x128_PLANES,
  TILE_ROWS_64x128, TILE_TR_64x128_PLANES, TILE_TR_128x256, TILE_TR_128x128,
  TILE_TR_64x128
};

bool conv_shaped(int K, int N) {
  return K <= CONV_K_MAX && N <= CONV_N_MAX && K * N <= CONV_KN_MAX;
}

// What codes-in calls take above the split-K and conv routes (choose_tile)
enum CodesIn { FLOAT_IN = 0, CODES_ALIGNED = 1, CODES_BYTES = 2 };

// Decode rows take the split-K kernel; conv-shaped calls (K <= CONV_K_MAX,
// N <= CONV_N_MAX, K * N <= CONV_KN_MAX: the CNN suite's im2col calls but
// its two widest, no LLM layer) the conv kernel.  At K * N = 73,728 and
// 147,456 (vgg's (16,000, 576, 128) and (16,000, 1152, 128)) the prep and
// wgmma tile were measured faster; at 36,864 the conv kernel.  Above them the widest wgmma tile whose grid still gives
// every SM a block.  128 x 256 (one block per SM) only where K >= 4096: its
// main loop is long enough to hide an epilogue that nothing overlaps; at
// shorter K two 128 x 128 blocks per SM, whose epilogues overlap each
// other's main loops, are faster.
// The codes-in entry (codes): with K, N and both bases multiples of 16
// (CODES_ALIGNED: TMA reads them) a transposing wgmma tile (planes: 64 x
// 128), one block an SM: the tile with the least time by waves of blocks
// (ceil(blocks / SMS)) times a block's time, a 128 x 128 block taking ~0.7
// and a 64 x 128 block ~0.47 of a 128 x 256 block's (at M = 4096, K = N =
// 2048: chip_smoke.py times the three there), so that a grid just past one
// wave of wide blocks takes narrower ones; else (CODES_BYTES) the rows
// tile, which copies byte by byte.
int choose_tile(int decode, int M, int K, int N, int n_planes, int codes) {
  auto blocks = [&](int bm, int bn) {
    return ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  };
  if (decode) return TILE_SPLIT_K;
  if (conv_shaped(K, N)) return TILE_CONV;
  if (codes != FLOAT_IN) {
    if (codes == CODES_BYTES || K % 16 || N % 16)
      return n_planes > 0 ? TILE_ROWS_64x128_PLANES : TILE_ROWS_64x128;
    if (n_planes > 0) return TILE_TR_64x128_PLANES;
    auto cost = [&](int bm, int bn, int per_block) {
      return (blocks(bm, bn) + SMS - 1) / SMS * per_block;
    };
    const int c256 = cost(128, 256, 100), c128 = cost(128, 128, 70),
              c64 = cost(64, 128, 47);
    if (c256 <= c128 && c256 <= c64) return TILE_TR_128x256;
    return c128 <= c64 ? TILE_TR_128x128 : TILE_TR_64x128;
  }
  if (n_planes > 0)
    return blocks(128, 128) >= SMS ? TILE_128x128_PLANES : TILE_64x128_PLANES;
  if (K >= 4096 && blocks(128, 256) >= SMS) return TILE_128x256;
  return blocks(128, 128) >= SMS ? TILE_128x128 : TILE_64x128;
}

// The prefill route: the prep kernel, then one wgmma tile
int launch_prefill(const Operands& o, const Epi& epi, const Planes& pl,
                   cudaStream_t stream) {
  auto go = [&](auto tile) {  // the prep kernel has masked the codes
    return launch_wgmma<decltype(tile)>(o, epi, pl, 0xFFFFFFFFu, 0, 0u,
                                        stream);
  };
  switch (choose_tile(0, o.M, o.K, o.N, pl.n, FLOAT_IN)) {
    case TILE_128x128_PLANES: return go(Tile<128, 128, true, 1>());
    case TILE_64x128_PLANES: return go(Tile<64, 128, true, 1>());
    case TILE_128x256: return go(Tile<128, 256, false, 1>());
    case TILE_128x128: return go(Tile<128, 128, false, 2>());
    default: return go(Tile<64, 128, false, 2>());
  }
}

template <typename InT>
int launch_prep(const InT* x, int M, int K, int vec, const float* meta,
                uint8_t* codes, int ldq, int* stats, uint32_t main4,
                int stat_kind, uint32_t stat4, cudaStream_t s) {
  // each thread converts 8 codes per iteration: a 2048-wide row is one
  prep_kernel<InT><<<M, 256, 0, s>>>(x, K, vec, meta, codes, ldq, stats,
                                     main4, stat_kind, stat4);
  return counted(L_PREP);
}

template <class T>
int launch_rows(const uint8_t* a, int avec, const Operands& o,
                const Epi& epi, const Planes& pl, uint32_t main4,
                int stat_kind, uint32_t stat4, cudaStream_t stream) {
  auto kern = am_rows_kernel<T>;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((o.M + T::BM - 1) / T::BM, (o.N + T::BN - 1) / T::BN);
  kern<<<grid, RT_THREADS, T::SMEM, stream>>>(
      a, avec, o.wt, o.ldt, row_vec(o.wt, o.ldt), o.M, o.K, o.N, epi, pl,
      main4, stat_kind, stat4);
  return counted(L_ROWS);
}

// The codes-in entry over row-major weights: decode rows one split-K
// launch, conv-shaped calls one conv launch, the rest one transposing
// wgmma tile or (an operand off 16 bytes) one rows tile.  tile: the
// TileId to launch, or -1 for choose_tile's; another tile than that only
// where it computes the call too (a tr_ or rows tile above the split-K and
// conv routes; a planes mode only on a planes tile; tr_ tiles need the
// aligned operands), else cudaErrorInvalidValue.
int launch_codes(const uint8_t* a, int tile, int decode, const Operands& o,
                 const Epi& epi, const Planes& pl, uint32_t main4,
                 int stat_kind, uint32_t stat4, cudaStream_t s) {
  const int avec = row_vec(a, o.K);
  const int codes = avec && row_vec(o.wt, o.ldt) ? CODES_ALIGNED
                                                 : CODES_BYTES;
  const int own = choose_tile(decode, o.M, o.K, o.N, pl.n, codes);
  if (tile < 0) {
    tile = own;
  } else if (tile != own) {
    const bool tr = tile >= TILE_TR_64x128_PLANES && tile <= TILE_TR_64x128;
    const bool rows = tile == TILE_ROWS_64x128_PLANES ||
                      tile == TILE_ROWS_64x128;
    const bool planes_tile = tile == TILE_ROWS_64x128_PLANES ||
                             tile == TILE_TR_64x128_PLANES;
    if (own == TILE_SPLIT_K || own == TILE_CONV || !(tr || rows) ||
        (pl.n > 0 && !planes_tile) || (tr && codes != CODES_ALIGNED))
      return (int)cudaErrorInvalidValue;
  }
  auto rows_go = [&](auto t) {
    return launch_rows<decltype(t)>(a, avec, o, epi, pl, main4, stat_kind,
                                    stat4, s);
  };
  Operands q = o;  // the transposing tiles read the codes by TMA as well
  q.q = a;
  q.ldq = o.K;
  auto tr_go = [&](auto t) {
    return launch_wgmma<decltype(t)>(q, epi, pl, main4, stat_kind, stat4,
                                     s);
  };
  switch (tile) {
    case TILE_SPLIT_K:
      return launch_split_k<uint8_t, true>(
          a, o.K % 8 == 0 && (uintptr_t)a % 8 == 0, o, epi, pl, main4,
          stat_kind, stat4, s);
    case TILE_CONV:
      return launch_conv<uint8_t, true>(a, o, epi, pl, main4, stat_kind,
                                        stat4, s);
    case TILE_ROWS_64x128_PLANES:
      return rows_go(RowTile<64, 128, 64, 4, true>());
    case TILE_ROWS_64x128: return rows_go(RowTile<64, 128, 128, 4, false>());
    case TILE_TR_64x128_PLANES:
      return tr_go(Tile<64, 128, true, 1, true>());
    case TILE_TR_128x256: return tr_go(Tile<128, 256, false, 1, true>());
    case TILE_TR_128x128: return tr_go(Tile<128, 128, false, 1, true>());
    default: return tr_go(Tile<64, 128, false, 1, true>());
  }
}

// Decode rows: one split-K launch; conv-shaped calls: one conv launch.
// Else prep, then a wgmma tile (codes and stats are the prep kernel's
// scratch, unused by the other two routes).
template <typename InT>
int launch_call(const InT* x, int vec, int decode, uint8_t* codes, int ldq,
                int* stats, Operands o, const Epi& epi0, const Planes& pl,
                uint32_t main4, int stat_kind, uint32_t stat4,
                cudaStream_t s) {
  Epi epi = epi0;
  if (decode)
    return launch_split_k<InT, false>(x, vec, o, epi, pl, main4, stat_kind,
                                      stat4, s);
  if (conv_shaped(o.K, o.N))
    return launch_conv<InT, false>(x, o, epi, pl, main4, stat_kind, stat4,
                                   s);
  if (codes == nullptr || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  int st = launch_prep(x, o.M, o.K, vec, epi.meta, codes, ldq, stats, main4,
                       stat_kind, stat4, s);
  if (st != 0) return st;
  epi.stats = stats;
  o.q = codes;
  o.ldq = ldq;
  return launch_prefill(o, epi, pl, s);
}

}  // namespace

extern "C" {

// The launch counts (L_KINDS of them) into out
void am_launches(unsigned long long* out) {
  for (int i = 0; i < L_KINDS; ++i) out[i] = g_launches[i];
}

// The TileId that a call of M x K x N with n_planes subtractive planes
// launches (decode: the wrapper's thin-M choice; codes: the codes-in
// entry's, on 16-byte aligned operands).
int am_tile(int decode, int M, int K, int N, int n_planes, int codes) {
  return choose_tile(decode, M, K, N, n_planes,
                     codes ? CODES_ALIGNED : FLOAT_IN);
}

// Float-in entry (kernel 1).  x (M, K) float32 (x_bf16 = 0) or bfloat16
// (x_bf16 = 1), row-major; w_qbt (wt_rows >= N, ldt) uint8, K contiguous,
// ldt >= K a multiple of 16; epilogue (8, lde) float32, lde >= N; meta
// [sa, za, true_k, ...]; out (M, N) in x's dtype, 16-byte aligned.  decode
// (M <= DECODE_M_MAX): one split-K launch; conv-shaped (K <= CONV_K_MAX, N
// <= CONV_N_MAX): one conv launch; in both codes and stats are unused (may
// be null); else codes: scratch (M, ldq) uint8, ldq = K rounded up to 16,
// stats: scratch (M, 2) int32, and the prep kernel then a wgmma tile.
// Returns 0,
// a cudaError_t, or a negative status (tensor maps).
int am_fused_launch(const void* x, int x_bf16, uint8_t* codes, int ldq,
                    int* stats, const uint8_t* w_qbt, int ldt, int wt_rows,
                    const float* epilogue, int lde, const float* meta,
                    void* out, int M, int K, int N, int decode,
                    int main_mask, int n_planes, unsigned long long amasks,
                    unsigned long long wmasks, int stat_kind, int stat_mask,
                    int use_cv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t main4 = (uint32_t)main_mask * 0x01010101u;
  const uint32_t stat4 = (uint32_t)stat_mask * 0x01010101u;
  const int vec = (K % 8 == 0) && ((uintptr_t)x % 16 == 0);
  Epi epi;
  epi.c = epilogue + 0 * lde;
  epi.c0 = epilogue + 1 * lde;
  epi.sumqw_f = epilogue + 2 * lde;
  epi.sumqw_i = nullptr;
  epi.bias = epilogue + 3 * lde;
  epi.sw = epilogue + 4 * lde;
  epi.zw = epilogue + 5 * lde;
  epi.meta = meta;
  epi.stats = nullptr;
  epi.out = out;
  epi.out_bf16 = x_bf16;
  epi.use_cv = use_cv;
  epi.k_arg = 0.0f;  // per column: true_k is meta[2]
  const Operands o{nullptr, 0, w_qbt, ldt, wt_rows, M, K, N};
  const Planes pl = make_planes(n_planes, amasks, wmasks);
  return x_bf16
      ? launch_call((const __nv_bfloat16*)x, vec, decode, codes, ldq, stats,
                    o, epi, pl, main4, stat_kind, stat4, s)
      : launch_call((const float*)x, vec, decode, codes, ldq, stats, o, epi,
                    pl, main4, stat_kind, stat4, s);
}

// Codes-in entry (kernel 2), over the caller's operands in place: a_q (M,
// K) uint8 codes, rows K bytes apart; w_q (K, N) uint8 codes, row-major,
// rows ldw >= N bytes apart (any alignment: off 16 bytes the kernels copy
// byte by byte); c, c0, bias (N,) float32 (bias may be null); sum_qw (N,)
// int32; meta [sa, sw, za, zw] float32 on the device, and true_k by value;
// out (M, N) float32, 16-byte aligned.  Decode rows: one split-K launch;
// conv-shaped calls: one conv launch; the rest: one transposing wgmma tile
// (one rows tile where an operand is off 16 bytes).  No scratch.  tile:
// -1, or the TileId to launch instead (launch_codes says which).
int am_codes_launch(const uint8_t* a_q, const uint8_t* w_q, int ldw,
                    const float* c, const float* c0, const int* sum_qw,
                    const float* bias, const float* meta, float true_k,
                    int tile, float* out, int M, int K, int N,
                    int decode, int main_mask, int n_planes,
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
  epi.meta = meta;
  epi.stats = nullptr;
  epi.out = out;
  epi.out_bf16 = 0;
  epi.use_cv = use_cv;
  epi.k_arg = true_k;
  const Operands o{nullptr, 0, w_q, ldw, K, M, K, N};
  // the codes pass through unchanged, so no kernel quantizes with sa or za
  return launch_codes(a_q, tile, decode, o, epi,
                      make_planes(n_planes, amasks, wmasks),
                      (uint32_t)main_mask * 0x01010101u, stat_kind,
                      (uint32_t)stat_mask * 0x01010101u,
                      (cudaStream_t)stream);
}

}  // extern "C"
