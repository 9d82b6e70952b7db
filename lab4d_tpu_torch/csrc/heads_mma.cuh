// Tensor-core tile products in 3xTF32 for Hopper (sm_90a): the core of K1
// and K2 (csrc/nerf_heads.cu).
//
// What bounds it: the field heads are fp32 products at 234,688
// multiply-adds per point; on fp32 FMA the flagship step's K1 needs at
// least 1.84 ms and K2 about three times that (the H100's 67 TFLOP/s). The
// tensor cores run TF32 at 495 TFLOP/s, but one TF32 product keeps 11
// significant bits, which misses the kernels' 1e-4 tolerance against the
// fp32 plain versions. What the design does about it: each fp32 operand is
// split into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and every k-step
// issues three mma.sync.m16n8k8 products, lo.hi + hi.lo + hi.hi (the
// dropped lo.lo term is below fp32 rounding), whose sum is added to an fp32
// register accumulator (hm_mma3). That is 3 x 2 x 123 GFLOP = 0.75 ms for
// K1 at the TF32 peak, below the FMA bound.
//
// A warp computes units of 16 rows x 32 columns (four n8 tiles), from
// operands in shared memory that the caller lays out m-major (element
// (i, j) at i * ld + j, ld = 4 mod 8 floats: hm_ld) or k-major (ld = 72
// for 64-wide tiles), so the fragment loads of a warp hit 32 distinct
// banks. Operands from device memory are staged into shared memory by
// cp.async, two stages deep with one barrier per k-slab: 16-byte copies of
// weights pre-split and padded to whole slabs, 4-byte copies of data
// whose rows may be 1, 3 or 63 floats long.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HM_THREADS 256    // 8 warps per block
#define HM_KS 32          // k-slab depth of a staged operand
#define HM_LDT 72         // row stride of a k-major 64-wide slab (8 mod 32)

// Row stride of an m-major buffer of n columns: 4 mod 8, so rows 0..7 of a
// fragment fall on distinct banks.
__host__ __device__ __forceinline__ int hm_ld(int n) { return (n + 3) / 8 * 8 + 4; }

__device__ __forceinline__ uint32_t hm_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void hm_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = hm_tf32(x);
  lo = hm_tf32(x - __uint_as_float(hi));
}

// c += a . b for one m16n8k8 TF32 tile
__device__ __forceinline__ void hm_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b for one m16n8k8 TF32 tile (a zero accumulator)
__device__ __forceinline__ void hm_mma0(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(z));
}

// Element (i, j) of a buffer at s[i * ld + j] (HmMK) or s[j * ld + i] (HmKM).
// An A operand is read as A(m, k), a B operand as B(k, n).
struct HmMK {
  const float* s;
  int ld;
  __device__ __forceinline__ float operator()(int i, int j) const { return s[i * ld + j]; }
};
struct HmKM {
  const float* s;
  int ld;
  __device__ __forceinline__ float operator()(int i, int j) const { return s[j * ld + i]; }
};

// c += a . b for one m16n8k8 tile in 3xTF32: the three products summed
// from zero in the tensor core (lo.hi, hi.lo, then hi.hi), that partial
// added to c in fp32 (round to nearest). Accumulating the whole k loop in
// the tensor core instead truncates every step of the running sum, which
// costs about a decimal digit against fp32 at K = 128.
__device__ __forceinline__ void hm_mma3(float (&c)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                        uint32_t bl0, uint32_t bl1) {
  float t[4];
  hm_mma0(t, al, bh0, bh1);
  hm_mma(t, ah, bl0, bl1);
  hm_mma(t, ah, bh0, bh1);
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] += t[q];
}

// The A fragment of rows m0 .. m0+16, columns ka .. ka+8, split
template <class AOp>
__device__ __forceinline__ void hm_frag_a(const AOp& A, int ka, int m0, uint32_t (&ah)[4],
                                          uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  hm_split(A(m0 + g, ka + t), ah[0], al[0]);
  hm_split(A(m0 + g + 8, ka + t), ah[1], al[1]);
  hm_split(A(m0 + g, ka + t + 4), ah[2], al[2]);
  hm_split(A(m0 + g + 8, ka + t + 4), ah[3], al[3]);
}

// One k-step of 8 of a warp's unit: c[j] += A[m0 .. m0+16, ka .. ka+8) .
// B[kb .. kb+8, n0 + 8j .. n0 + 8j + 8) for j < nv, in 3xTF32.
template <class AOp, class BOp>
__device__ __forceinline__ void hm_step(float (&c)[4][4], const AOp& A, int ka, const BOp& B,
                                        int kb, int m0, int n0, int nv) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
  hm_frag_a(A, ka, m0, ah, al);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < nv) {
      uint32_t bh0, bl0, bh1, bl1;
      hm_split(B(kb + t, n0 + 8 * j + g), bh0, bl0);
      hm_split(B(kb + t + 4, n0 + 8 * j + g), bh1, bl1);
      hm_mma3(c[j], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// The same with B already split: B(k, n) of bhi / blo at n * ldn + k * ldk
// (a slab of pre-split weights)
template <class AOp>
__device__ __forceinline__ void hm_step_pk(float (&c)[4][4], const AOp& A, int ka,
                                           const float* bhi, const float* blo, int ldn, int ldk,
                                           int kb, int m0, int n0, int nv) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
  hm_frag_a(A, ka, m0, ah, al);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < nv) {
      const int i = (n0 + 8 * j + g) * ldn + (kb + t) * ldk;
      hm_mma3(c[j], ah, al, __float_as_uint(bhi[i]), __float_as_uint(bhi[i + 4 * ldk]),
              __float_as_uint(blo[i]), __float_as_uint(blo[i + 4 * ldk]));
    }
  }
}

// epi(m, n, value) for every element of a unit's accumulators with n < n_max
template <class Epi>
__device__ __forceinline__ void hm_store(const float (&c)[4][4], int m0, int n0, int nv,
                                         int n_max, const Epi& epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < nv) {
      const int n = n0 + 8 * j + 2 * t;
      if (n < n_max) {
        epi(m0 + g, n, c[j][0]);
        epi(m0 + g + 8, n, c[j][2]);
      }
      if (n + 1 < n_max) {
        epi(m0 + g, n + 1, c[j][1]);
        epi(m0 + g + 8, n + 1, c[j][3]);
      }
    }
  }
}

__device__ __forceinline__ void hm_zero(float (&c)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] = 0.f;
}

// n8 tiles of a unit at column n0 of n columns (0 to 4)
__device__ __forceinline__ int hm_nv(int n, int n0) {
  const int v = (n - n0 + 7) / 8;
  return v < 0 ? 0 : (v > 4 ? 4 : v);
}

// 4-byte asynchronous copy to shared memory; zero-filled where !ok (src is
// then not read, but must be a valid address)
__device__ __forceinline__ void hm_cp4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

// 16-byte asynchronous copy to shared memory, through L2 only; zero-filled
// where !ok
__device__ __forceinline__ void hm_cp16(float* dst, const float* src, bool ok = true) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void hm_cp_commit() { asm volatile("cp.async.commit_group;" ::); }

__device__ __forceinline__ void hm_cp_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Sum over a warp; every lane gets the same value (each butterfly step
// adds the same two numbers on both lanes).
__device__ __forceinline__ float hm_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
