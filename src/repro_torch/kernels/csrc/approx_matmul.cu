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
// Pipeline of one call: a prep kernel (one block of eight warps per row)
// quantizes x once (IEEE division, round half to even), writes the codes
// masked with `main` into an (M, ldq) buffer (zeros past K, rows padded to
// 16 bytes), and writes each row's sum of codes and CV statistic into an
// (M, 2) int32 scratch from its unmasked codes, so no matmul block sums
// codes again.  Then one of two matmul kernels:
//
// * Prefill tile (M > DECODE_M_MAX): warp-specialised wgmma.  A producer
//   thread issues TMA loads of 128-byte K slices of the codes (BM rows) and
//   of the K-major weight copy (BN rows; built once with the pack, so no
//   tile is transposed on the card) into a ring of stages with 128-byte
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
// * Decode tile (M <= DECODE_M_MAX): mma.sync m16n8k32 on 16 x 32 strips of
//   the row-major weights, STAGES-deep cp.async pipeline, eight warps
//   splitting K, weight tile transposed in shared memory with byte permutes
//   (decode is bound by the weight bytes, which it reads once).
// K and N edges are masked in the kernels (TMA zero-fills out of bounds),
// so the caller pads nothing.
//
// Bound on the H100: prefill at M >= 2048 is bound by int8 operations (one
// product per output for perforated: 2*M*K*N at 1,979 TOP/s).  The main
// loop alone comes close to that rate (tools/tile_variants.py times it with
// the epilogue cut out); what keeps the tile from it is the float32
// epilogue, a chain of seven dependent operations per output that the
// reference's rounding fixes, run by only eight warps per block.  Two
// blocks per SM hide part of it; a persistent kernel whose consumer
// warpgroups alternate between tiles would hide the rest.  The prep pass
// reads x once and writes one byte per code, so it is bound by bytes.
// Decode and the engine's M = 128 chunks are bound by the weight bytes.

#include <cuda.h>  // CUtensorMap and its enums only: the CUDA driver's
                   // tensor-map encoder is fetched at run time, libcuda is
                   // not linked
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

// --- prep: quantize, mask, row statistics -----------------------------------

// quant.quantize_i32: clip(round(x / sa) + za, 0, 255), IEEE division,
// round half to even
__device__ __forceinline__ uint32_t to_code(float x, float sa, float za) {
  float q = rintf(__fdiv_rn(x, sa)) + za;
  q = fminf(fmaxf(q, 0.0f), 255.0f);
  return (uint32_t)q;
}
__device__ __forceinline__ uint32_t code_of(float v, float sa, float za) {
  return to_code(v, sa, za);
}
__device__ __forceinline__ uint32_t code_of(__nv_bfloat16 v, float sa,
                                            float za) {
  return to_code(__bfloat162float(v), sa, za);
}
__device__ __forceinline__ uint32_t code_of(uint8_t v, float, float) {
  return v;
}

// codes of 8 consecutive inputs, from a 16-byte aligned (bf16, float) or
// 8-byte aligned (uint8) address, packed 4 to a word
__device__ __forceinline__ void codes8(const __nv_bfloat16* p, float sa,
                                       float za, uint32_t (&w)[2]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[i / 2] |= (to_code(f.x, sa, za) | (to_code(f.y, sa, za) << 8))
                << (16 * (i % 2));
  }
}
__device__ __forceinline__ void codes8(const float* p, float sa, float za,
                                       uint32_t (&w)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 f = reinterpret_cast<const float4*>(p)[h];
    w[h] = to_code(f.x, sa, za) | (to_code(f.y, sa, za) << 8) |
           (to_code(f.z, sa, za) << 16) | (to_code(f.w, sa, za) << 24);
  }
}
__device__ __forceinline__ void codes8(const uint8_t* p, float, float,
                                       uint32_t (&w)[2]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  w[0] = u.x;
  w[1] = u.y;
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
  const float sa = meta[0], za = meta[1];
  const InT* row = x + (size_t)r * K;
  uint2* qrow = reinterpret_cast<uint2*>(q + (size_t)r * ldq);
  uint32_t sqa = 0u, sx = 0u;
#pragma unroll 4
  for (int g = threadIdx.x; g < ldq / 8; g += 256) {
    const int k0 = g * 8;
    uint32_t w[2] = {0u, 0u};
    if (vec && k0 + 8 <= K) {
      codes8(row + k0, sa, za, w);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (k0 + i < K) w[i / 4] |= code_of(row[k0 + i], sa, za) << (8 * (i % 4));
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
                         // [sa, sw, za, zw, true_k]
  const int* stats;      // (M, 2) row statistics from the prep kernel
  void* out;             // (M, N) bfloat16 (out_bf16) or float32
  int out_bf16, use_cv;
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
    s.true_k = e.meta[4];
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
template <int BM_, int BN_, bool PLANES_, int CTAS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, CTAS = CTAS_;
  static constexpr bool PLANES = PLANES_;
  static constexpr int THREADS = CTAS == 1 ? 384 : 288;
  static constexpr int P_RING = (CTAS == 1 ? 192 : 96) * 1024;
  // 128-row tiles give each consumer warpgroup 64 rows and every column;
  // 64-row tiles give each one half of the columns
  static constexpr int WGN = BM == 128 ? BN : BN / 2;
  static constexpr int A_BYTES = BM * PBK, B_BYTES = BN * PBK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = P_RING / STAGE - (PLANES ? 1 : 0);
  // after the ring: full/empty barriers, then the epilogue's per-column
  // constants (EPI_COLS floats per column) and per-row statistics
  static constexpr int BARS = 2 * STAGES * 8;
  static constexpr int COLS = EPI_COLS * BN * 4, ROWS = 2 * BM * 4;
  static constexpr int SMEM = 1024 + P_RING + BARS + COLS + ROWS;
  static_assert(BM == 64 || BM == 128, "tile rows");
  static_assert(WGN == 64 || WGN == 128 || WGN == 256, "wgmma width");
  static_assert(STAGES >= 3, "ring depth");
  static_assert(BM * (BN * 4 + 16) <= P_RING, "staged output tile");
  static_assert(CTAS == 1 || CTAS == 2, "blocks per SM");
};

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::CTAS)
am_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, int M, int N,
                int K, Epi epi, Planes pl) {
  constexpr int S = T::STAGES, WGN = T::WGN, P_RING = T::P_RING;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P_RING);
  uint64_t* empty = full + S;
  Col* cols = reinterpret_cast<Col*>(smem + P_RING + T::BARS);
  int* rstats = reinterpret_cast<int*>(smem + P_RING + T::BARS + T::COLS);
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
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread keeps the ring full
    if constexpr (T::CTAS == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
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
    if constexpr (T::CTAS == 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    {  // the epilogue's column constants and row statistics, read while
       // the ring fills (visible to both warpgroups after the main loop)
      const int ct = threadIdx.x;  // 0..255
      const Scalars sc = load_scalars(epi);
      for (int i = ct; i < T::BN; i += 256)
        if (n0 + i < N) cols[i] = load_col(epi, sc, n0 + i);
      for (int i = ct; i < T::BM; i += 256) {
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
      mbar_wait(&full[s], (kt / S) & 1);
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

// --- decode tile: mma.sync over row-major weights ---------------------------

template <int BM_, int BN_, int BK_, int KS_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int KS = KS_, STAGES = STAGES_;
  static constexpr int NT = 32 * KS;            // threads
  static constexpr int KW = BK / 4;             // 32-bit words per tile row
  static constexpr int LD = KW + 4;  // padded row stride (words), = 4 mod 8:
                                     // mma fragment loads hit 32 banks
  static constexpr int A_STAGE = BM * LD * 4;   // bytes
  static constexpr int W_STAGE = BK * BN;       // bytes, raw (BK, BN)
  static constexpr int WS = BN * LD * 4;        // transposed weight tile
  static constexpr int OUT_LD = BN + 1;
  static constexpr int OUT = BM * OUT_LD * 4;
  static constexpr int SMEM = STAGES * (A_STAGE + W_STAGE) + WS + OUT;
  static constexpr int MT = BM / 16;  // m16 tiles per warp
  static constexpr int NT8 = BN / 8;  // n8 tiles per warp
  static_assert(BK % 32 == 0 && BN % 16 == 0 && BM % 16 == 0, "tile shape");
  static_assert((BK / 32) % KS == 0, "warp split");
};

// Decode (M <= 8) streams a 32-column strip per block with eight warps
// splitting K.
using DecodeCfg = Cfg<16, 32, 512, 8, 4>;

template <typename C>
__global__ void __launch_bounds__(C::NT)
am_decode_kernel(const uint8_t* __restrict__ q, int ldq, int M, int K,
                 const uint8_t* __restrict__ w, int ldw, int N, int vec,
                 Epi epi, Planes pl) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK;
  constexpr int LD = C::LD, NT = C::NT, S = C::STAGES, KS = C::KS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* a_st = smem;                            // S x (BM, LD) words
  uint8_t* w_st = smem + S * C::A_STAGE;           // S x (BK, BN) bytes
  uint32_t* ws = reinterpret_cast<uint32_t*>(w_st + S * C::W_STAGE);
  int* out_s = reinterpret_cast<int*>(ws + BN * LD);
  __shared__ uint32_t s_am[8], s_wm[8];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  for (int i = tid; i < BM * C::OUT_LD; i += NT) out_s[i] = 0;
  if (tid < 8) { s_am[tid] = pl.amask[tid]; s_wm[tid] = pl.wmask[tid]; }
  const int n_planes = pl.n;
  const int nkt = (K + BK - 1) / BK;

  // stage s <- tile kt: codes (BM, BK) into operand layout, raw weights
  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * BK;
    uint8_t* a_dst = a_st + s * C::A_STAGE;
    uint8_t* w_dst = w_st + s * C::W_STAGE;
    for (int c = tid; c < BM * (BK / 16); c += NT) {
      const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const bool ok = (m0 + r < M) && (k0 + kc < ldq);
      const uint8_t* src = ok ? q + (size_t)(m0 + r) * ldq + k0 + kc : q;
      cp_async16(a_dst + r * LD * 4 + kc, src, ok ? 16 : 0);
    }
    if (vec) {
      for (int c = tid; c < BK * (BN / 16); c += NT) {
        const int kr = c / (BN / 16), nc = (c % (BN / 16)) * 16;
        const int cols = ldw - (n0 + nc);
        const bool ok = (k0 + kr < K) && cols > 0;
        const uint8_t* src = ok ? w + (size_t)(k0 + kr) * ldw + n0 + nc : w;
        cp_async16(w_dst + kr * BN + nc, src, ok ? min(cols, 16) : 0);
      }
    } else {  // weight rows not 16-byte aligned: plain loads
      for (int e = tid; e < BK * BN; e += NT) {
        const int kr = e / BN, c = e % BN;
        w_dst[kr * BN + c] = (k0 + kr < K && n0 + c < ldw)
                                 ? w[(size_t)(k0 + kr) * ldw + n0 + c] : 0;
      }
    }
  };

  const int lane = tid & 31, kz = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  int acc[C::MT][C::NT8][4], sub[C::MT][C::NT8][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) { acc[i][j][e] = 0; sub[i][j][e] = 0; }

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nkt) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    const int s = kt % S;
    const uint32_t* a_w = reinterpret_cast<const uint32_t*>(a_st + s * C::A_STAGE);
    const uint32_t* w_raw = reinterpret_cast<const uint32_t*>(w_st + s * C::W_STAGE);
    // transpose the raw (BK, BN) weight tile into (BN, LD) words
    for (int u = tid; u < C::KW * (BN / 4); u += NT) {
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

#pragma unroll
    for (int ks = kz; ks < BK / 32; ks += KS) {
      uint32_t a[C::MT][4], b[C::NT8][2];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const int r = i * 16 + g;
        a[i][0] = a_w[r * LD + 8 * ks + t];
        a[i][1] = a_w[(r + 8) * LD + 8 * ks + t];
        a[i][2] = a_w[r * LD + 8 * ks + 4 + t];
        a[i][3] = a_w[(r + 8) * LD + 8 * ks + 4 + t];
      }
#pragma unroll
      for (int j = 0; j < C::NT8; ++j) {
        const int c = j * 8 + g;
        b[j][0] = ws[c * LD + 8 * ks + t];
        b[j][1] = ws[c * LD + 8 * ks + 4 + t];
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT8; ++j) mma_u8(acc[i][j], a[i], b[j]);
      for (int p = 0; p < n_planes; ++p) {
        const uint32_t am = s_am[p], wmk = s_wm[p];
        uint32_t ap[C::MT][4], bp[C::NT8][2];
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) ap[i][e] = a[i][e] & am;
#pragma unroll
        for (int j = 0; j < C::NT8; ++j) {
          bp[j][0] = b[j][0] & wmk;
          bp[j][1] = b[j][1] & wmk;
        }
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int j = 0; j < C::NT8; ++j) mma_u8(sub[i][j], ap[i], bp[j]);
      }
    }
  }
  cp_async_wait<0>();

  // gather the integer accumulators of all warps into the output tile
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = i * 16 + g + (e >= 2 ? 8 : 0);
        const int c = j * 8 + 2 * t + (e & 1);
        atomicAdd(&out_s[r * C::OUT_LD + c], acc[i][j][e] - sub[i][j][e]);
      }
  __syncthreads();

  const Scalars sc = load_scalars(epi);
  for (int e = tid; e < BM * BN; e += NT) {
    const int rl = e / BN, cl = e % BN, r = m0 + rl, col = n0 + cl;
    if (r >= M || col >= N) continue;
    const Col k = load_col(epi, sc, col);
    const float v = epi_value(out_s[rl * C::OUT_LD + cl],
                              (float)epi.stats[2 * r + 1],
                              (float)epi.stats[2 * r], k, epi.use_cv);
    store1(epi, (size_t)r * N + col, v);
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
// (box_rows, 128) with 128-byte swizzle; out-of-bounds bytes read as 0
int tma_map(CUtensorMap* map, const void* base, int inner, int rows, int ld,
            int box_rows) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)PBK, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMA_MAP;
}

struct Operands {
  const uint8_t* q; int ldq;    // (M, ldq) masked codes
  const uint8_t* w; int ldw;    // (K, ldw) row-major weights (decode tile)
  int w_vec;                    // w rows 16-byte aligned
  const uint8_t* wt; int ldt;   // (wt_rows, ldt) K-major weights (prefill)
  int wt_rows;
  int M, K, N;
};

template <class T>
int launch_wgmma(const Operands& o, const Epi& epi, const Planes& pl,
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
  int st = tma_map(&ta, o.q, o.ldq, o.M, o.ldq, T::BM);
  if (st == 0) st = tma_map(&tb, o.wt, o.ldt, o.wt_rows, o.ldt, T::BN);
  if (st != 0) return st;
  const dim3 grid((o.M + T::BM - 1) / T::BM, (o.N + T::BN - 1) / T::BN);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(ta, tb, o.M, o.N, o.K, epi, pl);
  return (int)cudaGetLastError();
}

int launch_decode(const Operands& o, const Epi& epi, const Planes& pl,
                  cudaStream_t stream) {
  using C = DecodeCfg;
  auto kern = am_decode_kernel<C>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((o.N + C::BN - 1) / C::BN, (o.M + C::BM - 1) / C::BM);
  kern<<<grid, C::NT, C::SMEM, stream>>>(o.q, o.ldq, o.M, o.K, o.w, o.ldw,
                                         o.N, o.w_vec, epi, pl);
  return (int)cudaGetLastError();
}

// The matmul kernel instantiations, as am_tile names them (the wrapper's
// TILES lists the same names in this order).
enum TileId {
  TILE_DECODE, TILE_128x128_PLANES, TILE_64x128_PLANES, TILE_128x256,
  TILE_128x128, TILE_64x128
};

// The tile: the widest whose grid still gives every SM a block.  128 x 256
// (one block per SM) only where K >= 4096: its main loop is long enough to
// hide an epilogue that nothing overlaps; at shorter K two 128 x 128 blocks
// per SM, whose epilogues overlap each other's main loops, are faster.
int choose_tile(int decode, int M, int K, int N, int n_planes) {
  constexpr int SMS = 132;
  auto blocks = [&](int bm, int bn) {
    return ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  };
  if (decode) return TILE_DECODE;
  if (n_planes > 0)
    return blocks(128, 128) >= SMS ? TILE_128x128_PLANES : TILE_64x128_PLANES;
  if (K >= 4096 && blocks(128, 256) >= SMS) return TILE_128x256;
  return blocks(128, 128) >= SMS ? TILE_128x128 : TILE_64x128;
}

int launch_matmul(int decode, const Operands& o, const Epi& epi,
                  const Planes& pl, cudaStream_t stream) {
  switch (choose_tile(decode, o.M, o.K, o.N, pl.n)) {
    case TILE_DECODE: return launch_decode(o, epi, pl, stream);
    case TILE_128x128_PLANES:
      return launch_wgmma<Tile<128, 128, true, 1>>(o, epi, pl, stream);
    case TILE_64x128_PLANES:
      return launch_wgmma<Tile<64, 128, true, 1>>(o, epi, pl, stream);
    case TILE_128x256:
      return launch_wgmma<Tile<128, 256, false, 1>>(o, epi, pl, stream);
    case TILE_128x128:
      return launch_wgmma<Tile<128, 128, false, 2>>(o, epi, pl, stream);
    default:
      return launch_wgmma<Tile<64, 128, false, 2>>(o, epi, pl, stream);
  }
}

template <typename InT>
int launch_prep(const InT* x, int M, int K, int vec, const float* meta,
                uint8_t* codes, int ldq, int* stats, uint32_t main4,
                int stat_kind, uint32_t stat4, cudaStream_t s) {
  // each thread converts 8 codes per iteration: a 2048-wide row is one
  prep_kernel<InT><<<M, 256, 0, s>>>(x, K, vec, meta, codes, ldq, stats,
                                     main4, stat_kind, stat4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The TileId that a call of M x K x N with n_planes subtractive planes
// launches (decode: the wrapper's thin-M choice).
int am_tile(int decode, int M, int K, int N, int n_planes) {
  return choose_tile(decode, M, K, N, n_planes);
}

// Float-in entry (kernel 1).  x (M, K) float32 (x_bf16 = 0) or bfloat16
// (x_bf16 = 1), row-major; codes: scratch (M, ldq) uint8, ldq = K rounded up
// to 16; stats: scratch (M, 2) int32; w_qb (Kb, Nb) uint8 with row stride
// ldw = Nb (decode tile); w_qbt (Nb, ldt) its K-major copy (prefill tile,
// may be null when decode); epilogue (8, Nb) float32; meta [sa, za, true_k,
// ...]; out (M, N) in x's dtype.  Launches the prep kernel and one matmul
// kernel; returns 0, a cudaError_t, or a negative status (tensor maps).
int am_fused_launch(const void* x, int x_bf16, uint8_t* codes, int ldq,
                    int* stats, const uint8_t* w_qb, int ldw, int w_vec,
                    const uint8_t* w_qbt, int ldt, const float* epilogue,
                    const float* meta, void* out, int M, int K, int N,
                    int decode, int main_mask, int n_planes,
                    unsigned long long amasks, unsigned long long wmasks,
                    int stat_kind, int stat_mask, int use_cv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t main4 = (uint32_t)main_mask * 0x01010101u;
  const uint32_t stat4 = (uint32_t)stat_mask * 0x01010101u;
  const int vec = (K % 8 == 0) && ((uintptr_t)x % 16 == 0);
  int st = x_bf16
      ? launch_prep((const __nv_bfloat16*)x, M, K, vec, meta, codes, ldq,
                    stats, main4, stat_kind, stat4, s)
      : launch_prep((const float*)x, M, K, vec, meta, codes, ldq, stats,
                    main4, stat_kind, stat4, s);
  if (st != 0) return st;
  Epi epi;
  epi.c = epilogue + 0 * ldw;
  epi.c0 = epilogue + 1 * ldw;
  epi.sumqw_f = epilogue + 2 * ldw;
  epi.sumqw_i = nullptr;
  epi.bias = epilogue + 3 * ldw;
  epi.sw = epilogue + 4 * ldw;
  epi.zw = epilogue + 5 * ldw;
  epi.meta = meta;
  epi.stats = stats;
  epi.out = out;
  epi.out_bf16 = x_bf16;
  epi.use_cv = use_cv;
  const Operands o{codes, ldq, w_qb, ldw, w_vec, w_qbt, ldt, ldw, M, K, N};
  return launch_matmul(decode, o, epi, make_planes(n_planes, amasks, wmasks),
                       s);
}

// Codes-in entry (kernel 2).  a_q (M, K) uint8; codes, stats: scratch as
// above; w_q (K, N) uint8 with row stride N (decode tile); w_qt (N, ldt)
// its K-major copy (prefill tile, may be null when decode); c, c0, bias
// (N,) float32 (bias may be null); sum_qw (N,) int32; meta [sa, sw, za, zw,
// true_k]; out (M, N) float32.
int am_codes_launch(const uint8_t* a_q, uint8_t* codes, int ldq, int* stats,
                    const uint8_t* w_q, int w_vec, const uint8_t* w_qt,
                    int ldt, const float* c, const float* c0,
                    const int* sum_qw, const float* bias, const float* meta,
                    float* out, int M, int K, int N, int decode,
                    int main_mask, int n_planes, unsigned long long amasks,
                    unsigned long long wmasks, int stat_kind, int stat_mask,
                    int use_cv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = (K % 8 == 0) && ((uintptr_t)a_q % 8 == 0);
  // the prep kernel reads za from meta[1]: the codes entry passes codes
  // through unchanged, so sa and za are not read
  int st = launch_prep(a_q, M, K, vec, meta, codes, ldq, stats,
                       (uint32_t)main_mask * 0x01010101u, stat_kind,
                       (uint32_t)stat_mask * 0x01010101u, s);
  if (st != 0) return st;
  Epi epi;
  epi.c = c;
  epi.c0 = c0;
  epi.sumqw_f = nullptr;
  epi.sumqw_i = sum_qw;
  epi.bias = bias;
  epi.sw = nullptr;
  epi.zw = nullptr;
  epi.meta = meta;
  epi.stats = stats;
  epi.out = out;
  epi.out_bf16 = 0;
  epi.use_cv = use_cv;
  const Operands o{codes, ldq, w_q, N, w_vec, w_qt, ldt, N, M, K, N};
  return launch_matmul(decode, o, epi, make_planes(n_planes, amasks, wmasks),
                       s);
}

}  // extern "C"
