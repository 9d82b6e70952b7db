// Tensor-core tile products in 3xTF32 for Hopper (sm_90a) on mma.sync:
// the engine of K3's cluster engine (csrc/fused_relu_mlp.cu), with its
// split-K weight gradients (hm_dw_tile) and the ordered reduction of K3b's
// and K4b's workspace slices (hm_reduce_kernel). (K1 / K2, K4f / K4b and
// K3's row engine run on wgmma, csrc/wgmma.cuh and csrc/wg_engine.cuh;
// they take only this file's staging helpers: hm_ld, hm_cp4, HmMK.)
//
// What bounds it: the MLPs are fp32 products. The tensor cores run
// TF32 at 495 TFLOP/s, but one TF32 product keeps 11 significant bits,
// which misses the kernels' 1e-4 tolerance against the fp32 plain
// versions. What the design does about it: each fp32 operand is split
// into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and every k-step
// issues three mma.sync.m16n8k8 products, lo.hi + hi.lo + hi.hi (the
// dropped lo.lo term is below fp32 rounding), whose sum is added to an
// fp32 register accumulator (hm_mma3).
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

// ------------------------------------------- split-K weight gradients

// A row-major operand over the points whose column k is s1[p][k] for
// k < k1 and s2[p][k - k1] after
struct HmSrc {
  const float* s1;
  int ld1, k1;
  const float* s2;
  int ld2;
  __device__ __forceinline__ const float* at(size_t p, int k) const {
    return k < k1 ? s1 + p * ld1 + k : s2 + p * ld2 + (k - k1);
  }
};

// Four consecutive floats of a row to shared memory: one 16-byte copy
// where all four lie in the run of n valid floats at src and src is
// 16-byte aligned, else four 4-byte copies, zero past n (base: any valid
// address)
__device__ __forceinline__ void hm_cp4x4(float* dst, const float* src, int n, const float* base) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    hm_cp16(dst, src);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) hm_cp4(dst + i, i < n ? src + i : base, i < n);
}

// dW = G^T . A (N x K) and db = sum G (unless off_b < 0) over the chunk
// `chunk` of pc points (cut at rows), into that chunk's workspace slice of
// n_slice floats: columns k < kw at off_w1 ((N, kw) row-major), the rest
// at off_w2 ((N, K - kw)); kw = K for one (N, K) array. `tile`: the
// block's 64 outputs x 64 inputs; a k-slab is 32 points of both operands,
// k-major, staged in runs of four columns (16-byte copies where they can),
// zero past the chunk's last point. One block of HM_THREADS threads.
__device__ __forceinline__ void hm_dw_tile(int tile, int chunk, const float* __restrict__ g, int N,
                                           const HmSrc& src, int K, int rows, int pc,
                                           int n_ktiles, float* __restrict__ ws, int n_slice,
                                           int kw, int off_w1, int off_w2, int off_b) {
  __shared__ __align__(16) float sm[2][2][HM_KS * HM_LDT];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int nb = (tile / n_ktiles) * 64, kt = tile % n_ktiles, kb = kt * 64;
  const size_t p0 = (size_t)chunk * pc;
  const int np = min(pc, rows - (int)p0);  // points of this chunk
  auto stage = [&](int s) {
    const size_t p = p0 + (size_t)s * HM_KS;
    for (int e = tid; e < HM_KS * 16 * 2; e += HM_THREADS) {
      const int op = e >= HM_KS * 16, e2 = e - op * HM_KS * 16;
      const int kk = e2 >> 4, m = (e2 & 15) * 4;
      const bool in = s * HM_KS + kk < np;
      float* dst = &sm[s & 1][op][kk * HM_LDT + m];
      if (op == 0) {  // 32 points x 64 columns of G
        const int n = nb + m;
        hm_cp4x4(dst, g + (p + kk) * N + n, in ? N - n : 0, g);
      } else {  // and of A; a run that crosses from s1 into s2 takes four 4-byte copies
        const int k = kb + m;
        const int run = !in ? 0 : k < src.k1 ? min(K, src.k1) - k : K - k;
        if (run >= 4 && (reinterpret_cast<uintptr_t>(src.at(p + kk, k)) & 15) == 0) {
          hm_cp16(dst, src.at(p + kk, k));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool ok = in && k + i < K;
            hm_cp4(dst + i, ok ? src.at(p + kk, k + i) : src.s1, ok);
          }
        }
      }
    }
    hm_cp_commit();
  };
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int nv = nb + m0 < N ? hm_nv(K - kb, n0) : 0;
  const bool do_b = off_b >= 0 && kt == 0 && tid < 64;
  float c[4][4];
  hm_zero(c);
  float db = 0.f;
  const int n_slab = (np + HM_KS - 1) / HM_KS;
  stage(0);
  for (int s = 0; s < n_slab; ++s) {
    hm_cp_wait();
    __syncthreads();
    if (s + 1 < n_slab) stage(s + 1);
    const HmKM A{sm[s & 1][0], HM_LDT};  // A(m, kk) = G[kk][m]
    const HmMK B{sm[s & 1][1], HM_LDT};  // B(kk, n) = A_l[kk][n]
    if (nv > 0) {
#pragma unroll
      for (int k8 = 0; k8 < HM_KS; k8 += 8) hm_step(c, A, k8, B, k8, m0, n0, nv);
    }
    if (do_b) {
      for (int kk = 0; kk < HM_KS; ++kk) db += sm[s & 1][0][kk * HM_LDT + tid];
    }
  }
  float* out = ws + (size_t)chunk * n_slice;
  if (nv > 0)
    hm_store(c, m0, n0, nv, K - kb, [&](int m, int n, float v) {
      const int o = nb + m, k = kb + n;
      if (o >= N) return;
      if (k < kw) out[off_w1 + (size_t)o * kw + k] = v;
      else out[off_w2 + (size_t)o * (K - kw) + (k - kw)] = v;
    });
  if (do_b && nb + tid < N) out[off_b + nb + tid] = db;
}

// out[e] = sum over the slices b (in order) of ws[b * n + e]: the same
// order on every run, with no float atomics
__global__ void __launch_bounds__(HM_THREADS)
hm_reduce_kernel(const float* __restrict__ ws, int n_slices, int n, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_slices; ++b) s += ws[(size_t)b * n + e];
  out[e] = s;
}
