// The wgmma and TMA primitives of the row engines on Hopper (sm_90a): the
// persistent K3f / K3b row engine (csrc/fused_relu_mlp.cu, rw_*) and K1 /
// K2's engine (csrc/nerf_heads.cu, nh_*) are built from them.
//
// - TMA: 1D bulk copies from global to shared memory that complete on an
//   mbarrier (rw_bulk_load, rw_mbar_*).
// - wgmma.mma_async m64nNk8 in TF32 (N = 8, 16, 32, 64, 128): A, the
//   warpgroup's 64 rows, from registers in the m16n8k8 A fragment of each
//   warp's 16 rows; B from shared memory in wgmma's K-major core matrices
//   without swizzle (rw_desc); the accumulator in registers, rw_each's
//   layout. 3xTF32 callers split each fp32 operand by rw_split.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t rw_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void rw_mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(rw_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void rw_mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = rw_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes from global to shared memory by the TMA unit (a 1D bulk copy),
// completing on bar
__device__ __forceinline__ void rw_bulk_load(float* dst, const float* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(rw_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(rw_addr(dst)),
      "l"(src), "r"(bytes), "r"(rw_addr(bar))
      : "memory");
}

// wgmma's shared-memory descriptor without swizzle: lbo the bytes between
// the two core matrices of a k8 step, sbo between 8-column groups
__device__ __forceinline__ uint64_t rw_desc(const float* s, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((rw_addr(s) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void rw_wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void rw_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void rw_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns past the wgmma's start or its wait
template <int N>
__device__ __forceinline__ void rw_own(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void rw_own(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A . B for the warpgroup's 64 rows: A (64 x 8, tf32) from registers
// (the m16n8k8 A fragment of the warp's 16 rows), B (8 x N) from shared
// memory; scale_d = 0 starts from zero. The accumulation stays in the
// tensor core until the caller reads d after rw_wait0.
__device__ __forceinline__ void rw_mma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void rw_mma_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{" "%0, %1, %2, %3" "}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void rw_mma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7" "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void rw_mma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void rw_mma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// x = hi + lo: hi is x cut to tf32 (its low 13 mantissa bits cleared, so
// exact), lo the rest, exact in fp32 with at most 13 significant bits, of
// which the tensor core reads the top 11. Two instructions where a
// rounding split takes three, two of them conversions.
__device__ __forceinline__ void rw_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// hm_frag_a's A fragment (rows m0 .. m0 + 16, columns ka .. ka + 8), split
// by rw_split
template <class AOp>
__device__ __forceinline__ void rw_frag_a(const AOp& A, int ka, int m0, uint32_t (&ah)[4],
                                          uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  rw_split(A(m0 + g, ka + t), ah[0], al[0]);
  rw_split(A(m0 + g + 8, ka + t), ah[1], al[1]);
  rw_split(A(m0 + g, ka + t + 4), ah[2], al[2]);
  rw_split(A(m0 + g + 8, ka + t + 4), ah[3], al[3]);
}

// rw_mma_n<NW> for NW = 8, 16, 32, 64 or 128 columns
template <int NW>
__device__ __forceinline__ void rw_mma(float (&d)[NW / 2], const uint32_t (&a)[4], uint64_t desc,
                                       int scale_d) {
  static_assert(NW == 8 || NW == 16 || NW == 32 || NW == 64 || NW == 128, "a wgmma width");
  if constexpr (NW == 128) rw_mma_n128(d, a, desc, scale_d);
  else if constexpr (NW == 64) rw_mma_n64(d, a, desc, scale_d);
  else if constexpr (NW == 32) rw_mma_n32(d, a, desc, scale_d);
  else if constexpr (NW == 16) rw_mma_n16(d, a, desc, scale_d);
  else rw_mma_n8(d, a, desc, scale_d);
}

// f(m, c, v(m, c), v(m, c + 1)) for the warpgroup's accumulators: m the
// row of 64, c an even column of NW
template <int NW, class F>
__device__ __forceinline__ void rw_each(const float (&v)[NW / 2], const F& f) {
  const int lane = threadIdx.x & 31, m = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    f(m, 8 * j + c, v[4 * j], v[4 * j + 1]);
    f(m + 8, 8 * j + c, v[4 * j + 2], v[4 * j + 3]);
  }
}

// Two elements of a row of floats at p (v0 at p[0], v1 at p[1] when two)
// as one 8-byte store where p is aligned (vec), else as two; cs: streaming
// stores (__stcs)
__device__ __forceinline__ void rw_st2(float* p, float v0, float v1, bool two, bool vec, bool cs) {
  if (two && vec) {
    if (cs) __stcs(reinterpret_cast<float2*>(p), make_float2(v0, v1));
    else *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    return;
  }
  if (cs) __stcs(p, v0);
  else p[0] = v0;
  if (two) {
    if (cs) __stcs(p + 1, v1);
    else p[1] = v1;
  }
}
