// K4f and K4b: the Fourier-embedding fused MLP, forward and backward,
// hand-written for Hopper (sm_90a) on the 3xTF32 tensor-core products of
// heads_mma.cuh.
//
// K4f replaces lab4d_tpu/ops/mlp_kernel.py:_pe_fwd (Pallas kernel
// _pe_fwd_kernel); K4b replaces _pe_bwd_call (_pe_bwd_kernel). The field
// MLPs of the training step (the bg field's base, colour and visibility
// MLPs, the visibility-decay points, the fg feature field) run through
// them. Semantics are the Pallas kernels': the input x (rows, C) is
// Fourier-embedded as [x (C), sin (F x C), cos (F x C)] (fourier_embed's
// block layout), each angle x * freq elementwise with precise sinf / cosf
// (angles reach 2^9 |x| on the visibility field), sin / cos times an
// optional per-frequency annealing window; then D+1 dense layers, ReLU
// between them, the embedding re-read before each skip layer as [X, h]
// (the weight's leading c_x columns take X: never concatenated), an
// optional ReLU on the output. The final ReLU's mask on the incoming
// gradient is applied by the caller, as the JAX VJP does; no gradient
// reaches the window.
//
// What bounds it on the card: the bg step calls it on 262,144 points; its
// base MLP (F6, W128 x 6, skip 4) costs 91,904 multiply-adds per point,
// 48.2 GFLOP forward: 0.72 ms on fp32 FMA (67 TFLOP/s), 0.29 ms in
// 3xTF32 at the tensor cores' 495 TFLOP/s. The backward from saved layer
// outputs costs twice that; its recompute-free bound is 0.58 ms in 3xTF32.
// The saved outputs (640 floats per point, 671 MB) add 0.2 ms of writes
// and the same of reads at 3.35 TB/s.
//
// What the design does about it:
// - K4f is two launches: the weights split into tf32 hi / lo once per
//   call (pm_pack_kernel, zero-padded to whole k-slabs of 32), then one
//   fused kernel. A block of 16 warps works on tiles of 256 points (8
//   warps on 128 where the buffers of 256 do not fit in shared memory);
//   each warp owns 16 of them and every output column of a layer (up to
//   16 n8 tiles, 64 accumulators a thread), so one split of an A fragment
//   serves every n8 tile of the row, and a warp reads and writes only its
//   own rows: the hidden layer is updated in place, with no block barrier
//   between layers beyond the weight staging. The n8 tile count is a
//   template parameter, so the independent product chains unroll without
//   branches and interleave; the engine is bound by the latency of those
//   chains, and 16 warps (at most 128 registers each) hide more of it
//   than 8. The weights stream from L2 once per 256 points in
//   double-buffered 16-deep k-slabs (16-byte cp.async, one barrier per
//   slab); the grid is persistent (one block per SM), and the slabs form
//   one stream across layers and tiles, so no layer waits for its first
//   slab. Each k-step is three mma.sync.m16n8k8 products summed from zero
//   and added to an fp32 register (hm_mma3). The embedding is built per
//   tile in shared memory, one sincosf per angle. When autograd needs
//   them, every hidden output is also written once to device memory with
//   streaming stores (__stcs), layer by layer in the saved layout: layer
//   l's block is a (rows, out_l) row-major array at act_off[l] * rows
//   floats. The tail tile's rows are masked in the kernel; rows are
//   arbitrary.
// - K4b is a sequence of launches over those saved outputs, walking the
//   layers in reverse, like K2 (nerf_heads.cu): the split of the weights'
//   transposes, the embedding X of every point, then per layer
//   - dW = G^T . A and db = sum G as a split-K product over up to 512
//     chunks of points, each into its own workspace slice (hm_dw_kernel of
//     heads_mma.cuh, which K2 shares: 64 x 64 tiles, the operands staged
//     by 16-byte cp.async where a row allows);
//   - dIn = G . W on K4f's engine (a warp owns 16 points' rows of G and
//     every output column, W^T streams through the slabs), with the ReLU
//     mask of the saved input as its epilogue and the X columns into dX;
//   then the chain rule through sin / cos and the window to dx, and the
//   chunks' slices summed in chunk order (hm_reduce_kernel). No forward is
//   recomputed.
//   2 D + 6 launches per call.
//
// No float atomics: every sum across blocks runs in a fixed order, and the
// result is the same from run to run.

#include "heads_mma.cuh"

#define PM_MAX_LAYERS 16
#define PM_MAX_FREQS 16
#define PM_MAX_WARPS 16  // a K4f block: 16 warps on 256 points, or 8 on 128 where those do not fit
#define PM_NMAX 128      // widest layer output and embedding
#define PM_NT (PM_NMAX / 8)  // n8 tiles of the widest layer
#define PM_KS 16         // k-slab depth of K4f's staged weights
#define PM_LDS 20        // row stride of a staged weight slab (PM_KS + 4)
#define PM_CHUNKS 512    // most chunks of K4b's split-K weight gradients

struct PmArgs {
  int n_layers, c_raw, n_freqs, c_x, rows, skip_mask, final_act;
  int tr;       // K4f: points per tile, 16 per warp
  int max_h;    // widest hidden output (0 with one layer)
  int max_out;  // widest layer output
  int in_dim[PM_MAX_LAYERS];
  int out_dim[PM_MAX_LAYERS];
  int pk_off[PM_MAX_LAYERS];   // the layer's pre-split weights in the packed buffer (K4f)
  int pt_off[PM_MAX_LAYERS];   // and its transpose's (K4b)
  int act_off[PM_MAX_LAYERS];  // floats per point before the layer's saved block
  int off_w[PM_MAX_LAYERS];    // the layer's dW (out, in) in a gradient slice
  int off_b[PM_MAX_LAYERS];    // and its db, after every dW
  int pk_total, pt_total, act_total, n_params;
  int pc, n_chunks;  // K4b: chunks of pc points (a multiple of HM_KS) for dW / db
  float freq[PM_MAX_FREQS];
  const float* window;  // (n_freqs,) or null
  const float* w[PM_MAX_LAYERS];  // (out_l, in_l), row-major
  const float* b[PM_MAX_LAYERS];  // (out_l,)
};

__host__ __device__ __forceinline__ int pm_kp(int K) { return (K + HM_KS - 1) / HM_KS * HM_KS; }

__host__ __device__ __forceinline__ size_t pm_round4(size_t n) { return (n + 3) & ~(size_t)3; }

// Item j < C (F + 1) of point p's embedding into its row: x[c] for
// j < C, else the sin and cos of x[c] * freq[f] (c = (j - C) % C,
// f = (j - C) / C), each times the window, at columns C + f C + c and
// C + F C + f C + c; zeros instead when !valid
__device__ __forceinline__ void pm_embed_item(const PmArgs& a, const float* __restrict__ x,
                                              size_t p, int j, float* row, bool valid) {
  const int C = a.c_raw;
  if (j < C) {
    row[j] = valid ? __ldg(x + p * C + j) : 0.f;
    return;
  }
  const int c = (j - C) % C, f = (j - C) / C;
  float sv = 0.f, cv = 0.f;
  if (valid) {
    sincosf(__ldg(x + p * C + c) * a.freq[f], &sv, &cv);
    if (a.window != nullptr) {
      const float w = __ldg(a.window + f);
      sv *= w;
      cv *= w;
    }
  }
  row[C + f * C + c] = sv;
  row[C + a.n_freqs * C + f * C + c] = cv;
}

// Every layer's weights, split into tf32 hi and lo, zero-padded to whole
// k-slabs: layer l at pk_off[l], hi then lo, each (out_l, kp(in_l))
// row-major; or, with transpose, W^T at pt_off[l], each (in_l,
// kp(out_l)). blockIdx.y: the layer.
__global__ void __launch_bounds__(HM_THREADS)
pm_pack_kernel(const __grid_constant__ PmArgs a, float* __restrict__ wpk, int transpose) {
  const int l = blockIdx.y, N = a.out_dim[l], K = a.in_dim[l];
  const int R = transpose ? K : N, C = transpose ? N : K, kp = pm_kp(C);
  const float* w = a.w[l];
  float* hi = wpk + (transpose ? a.pt_off[l] : a.pk_off[l]);
  float* lo = hi + (size_t)R * kp;
  for (int e = blockIdx.x * HM_THREADS + threadIdx.x; e < R * kp; e += gridDim.x * HM_THREADS) {
    const int r = e / kp, c = e - r * kp;
    uint32_t h, l2;
    hm_split(c < C ? __ldg(w + (transpose ? (size_t)c * K + r : (size_t)r * K + c)) : 0.f, h, l2);
    hi[e] = __uint_as_float(h);
    lo[e] = __uint_as_float(l2);
  }
}

// ------------------------------------------------------------------ K4f

// A layer input of a warp's 16 points in shared memory: columns [0, k1) of
// s1, then s2; zero at and past K
struct PmIn {
  const float* s1;
  int ld1, k1;
  const float* s2;
  int ld2, K;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return k < k1 ? s1[m * ld1 + k] : (k < K ? s2[m * ld2 + (k - k1)] : 0.f);
  }
};

// One staged k-slab of a warp's layer product: c[j] += In[16 rows, k0 ..
// k0 + PM_KS) . W^T for the n8 tiles j < NT (columns 8 j .. 8 j + 7), the
// slab's hi and lo weights at bh and bh + PM_NMAX * PM_LDS. NT is a
// compile-time count, so the NT independent product chains are unrolled
// without branches and interleave; tiles past the layer's width read
// unstaged slab rows and are never stored.
template <int NT>
__device__ __forceinline__ void pm_slab(float (&c)[PM_NT][4], const PmIn& in, int k0,
                                        const float* bh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* bl = bh + PM_NMAX * PM_LDS;
#pragma unroll
  for (int k8 = 0; k8 < PM_KS; k8 += 8) {
    uint32_t ah[4], al[4];
    hm_frag_a(in, k0 + k8, 0, ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int i = (8 * j + g) * PM_LDS + k8 + t;
      hm_mma3(c[j], ah, al, __float_as_uint(bh[i]), __float_as_uint(bh[i + 4]),
              __float_as_uint(bl[i]), __float_as_uint(bl[i + 4]));
    }
  }
}

// The n8 tiles pm_slab computes for n output columns: a power of two
__host__ __device__ __forceinline__ int pm_ntp(int n) {
  const int nt = (n + 7) / 8;
  return nt > 8 ? 16 : nt > 4 ? 8 : nt > 2 ? 4 : nt;
}

// pm_slab with NT = ntp (pm_ntp)
__device__ __forceinline__ void pm_slab_n(int ntp, float (&c)[PM_NT][4], const PmIn& in, int k0,
                                          const float* bh) {
  switch (ntp) {
    case 16: pm_slab<16>(c, in, k0, bh); break;
    case 8: pm_slab<8>(c, in, k0, bh); break;
    case 4: pm_slab<4>(c, in, k0, bh); break;
    case 2: pm_slab<2>(c, in, k0, bh); break;
    default: pm_slab<1>(c, in, k0, bh); break;
  }
}

// o[0] = v0 and, if two, o[1] = v1: one 8-byte store where aligned;
// streaming stores (__stcs) for the saved outputs, which K4b reads once
__device__ __forceinline__ void pm_store2(float* o, float v0, float v1, bool two, bool stream) {
  if (two && (reinterpret_cast<uintptr_t>(o) & 7) == 0) {
    if (stream) __stcs(reinterpret_cast<float2*>(o), make_float2(v0, v1));
    else *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else if (stream) {
    __stcs(o, v0);
    if (two) __stcs(o + 1, v1);
  } else {
    o[0] = v0;
    if (two) o[1] = v1;
  }
}

// smem: X and the hidden layer of a tile of tr points (row-major, hm_ld
// strides; warp w's rows 16 w .. 16 w + 15), two stages of hi / lo weight
// slabs (PM_NMAX x PM_LDS each). A persistent grid: block b takes the
// tiles b, b + gridDim.x, ... The weights stream through the two stages as
// one sequence of k-slabs, layer after layer and tile after tile, so the
// next layer's (or tile's) first slab loads during the current one's last.
// acts: null, or the saved layout.
__global__ void __launch_bounds__(32 * PM_MAX_WARPS, 1)
pe_mlp_fwd_kernel(const __grid_constant__ PmArgs a, const float* __restrict__ x,
                  const float* __restrict__ wpk, float* __restrict__ y, float* __restrict__ acts) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ldx = hm_ld(a.c_x), ldh = hm_ld(a.max_h > 0 ? a.max_h : 1), tr = a.tr;
  float* xs = smem + warp * 16 * ldx;
  float* hs = smem + tr * ldx + warp * 16 * ldh;
  float* wsl = smem + tr * (ldx + ldh);
  const int n_tiles = (a.rows + tr - 1) / tr;
  const int n_items = a.c_raw * (a.n_freqs + 1);  // embedding items per point
  // the next slab to stage: tile, layer, slab
  int st_tile = blockIdx.x, st_l = 0, st_s = 0;
  auto stage_next = [&](int buf) {
    if (st_tile >= n_tiles) return;
    const int N = a.out_dim[st_l], kp = pm_kp(a.in_dim[st_l]);
    const float* whi = wpk + a.pk_off[st_l];
    const float* wlo = whi + (size_t)N * kp;
    float* dst = wsl + buf * (2 * PM_NMAX * PM_LDS);
    const int k0 = st_s * PM_KS;
    for (int e = tid; e < N * (PM_KS / 4) * 2; e += blockDim.x) {
      const int half = e >= N * (PM_KS / 4);
      const int e2 = e - half * N * (PM_KS / 4), n = e2 / (PM_KS / 4), q = (e2 % (PM_KS / 4)) * 4;
      hm_cp16(dst + half * PM_NMAX * PM_LDS + n * PM_LDS + q,
              (half ? wlo : whi) + (size_t)n * kp + k0 + q);
    }
    hm_cp_commit();
    if (++st_s == kp / PM_KS) {
      st_s = 0;
      if (++st_l == a.n_layers) {
        st_l = 0;
        st_tile += gridDim.x;
      }
    }
  };
  int q = 0;  // slabs consumed; slab q sits in stage q & 1
  stage_next(0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * tr + warp * 16;  // the warp's first point
    const int nr = min(16, a.rows - row0);   // its points (<= 0: none)
    for (int idx = lane; idx < 16 * n_items; idx += 32) {
      const int r = idx / n_items;
      pm_embed_item(a, x, (size_t)(row0 + r), idx - r * n_items, xs + r * ldx, r < nr);
    }
    __syncwarp();
    for (int l = 0; l < a.n_layers; ++l) {
      const int N = a.out_dim[l], K = a.in_dim[l], nt = (N + 7) / 8, ntp = pm_ntp(N);
      const bool last = l == a.n_layers - 1;
      const bool skip = l > 0 && ((a.skip_mask >> l) & 1);
      const PmIn in = l == 0 ? PmIn{xs, ldx, a.c_x, xs, ldx, a.c_x}
                    : skip   ? PmIn{xs, ldx, a.c_x, hs, ldh, K}
                             : PmIn{hs, ldh, K, hs, ldh, K};
      float c[PM_NT][4];
#pragma unroll
      for (int j = 0; j < PM_NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
      const int n_slab = pm_kp(K) / PM_KS;
      for (int s = 0; s < n_slab; ++s, ++q) {
        hm_cp_wait();
        __syncthreads();  // slab q is in; every warp is done with slab q - 1
        stage_next((q + 1) & 1);
        const float* bh = wsl + (q & 1) * (2 * PM_NMAX * PM_LDS);
        if (nr > 0) pm_slab_n(ntp, c, in, s * PM_KS, bh);
      }
      __syncwarp();  // every lane's reads of the layer input are done: update it in place
      if (nr <= 0) continue;
      const float* bias = a.b[l];
      float* out = last ? y : (acts != nullptr ? acts + (size_t)a.act_off[l] * a.rows : nullptr);
#pragma unroll
      for (int j = 0; j < PM_NT; ++j) {
        if (j < nt) {
          const int n = 8 * j + 2 * t;
          const float b0 = n < N ? __ldg(bias + n) : 0.f;
          const float b1 = n + 1 < N ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows g and g + 8
            const int m = g + 8 * h;
            float v0 = c[j][2 * h] + b0, v1 = c[j][2 * h + 1] + b1;
            if (!last || a.final_act) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            if (!last) {
              if (n < N) hs[m * ldh + n] = v0;
              if (n + 1 < N) hs[m * ldh + n + 1] = v1;
            }
            if (out != nullptr && m < nr && n < N)
              pm_store2(out + (size_t)(row0 + m) * N + n, v0, v1, n + 1 < N, !last);
          }
        }
      }
      __syncwarp();  // the layer output is in place before the next layer reads it
    }
  }
}

// ------------------------------------------------------------------ K4b

// Where dIn = G . W goes: columns k < x_cols into dX (stored or added),
// the rest, masked by the saved input hprev > 0, into gn (the gradient of
// the previous layer's output)
struct PmDinOut {
  float* dX;
  int ldx, x_cols, store;
  float* gn;
  const float* hprev;
};

// A warp's 16 rows of n floats, contiguous at src, to dst (rows ld
// floats apart, ld a multiple of 4), zero past the first nr rows, by
// cp.async (16-byte copies when n is a multiple of 4), waited for.
__device__ __forceinline__ void pm_warp_rows(float* dst, int ld, const float* src, int n, int nr) {
  const int lane = threadIdx.x & 31;
  if ((n & 3) == 0) {
    for (int i = lane * 4; i < 16 * n; i += 128) {
      const int r = i / n;
      hm_cp16(dst + r * ld + i - r * n, r < nr ? src + i : src, r < nr);
    }
  } else {
    for (int i = lane; i < 16 * n; i += 32) {
      const int r = i / n;
      hm_cp4(dst + r * ld + i - r * n, r < nr ? src + i : src, r < nr);
    }
  }
  hm_cp_commit();
  hm_cp_wait();
  __syncwarp();
}

// dIn = G . W on K4f's engine: tiles of tr points taken in turn by a
// persistent block, a warp's 16 points at a time. The warp's rows of G (N
// floats each) sit in shared memory; W streams as the pre-split rows of
// W^T (pm_pack_kernel with transpose: (K, kp(N)) hi then lo) in 16-deep
// k-slabs, across tiles and passes: the X columns [0, x_cols), then the h
// columns [x_cols, K), each at most 128 wide, every output column of a row
// from one split of its A fragment. After the last pass's products the
// warp's G rows are done with, and their shared memory takes the side
// data of the epilogue, read coalesced: the saved ReLU outputs hprev for
// the h pass, or dX where the X pass adds to it. smem: tr x ld floats
// (ld >= every row width), two stages of hi / lo slabs.
__global__ void __launch_bounds__(32 * PM_MAX_WARPS, 1)
pm_din_kernel(const float* __restrict__ g, int N, const float* __restrict__ wt, int K, int rows,
              int tr, int ld, const PmDinOut o) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int kpn = pm_kp(N), kh = K - o.x_cols;
  const int p0 = o.x_cols > 0 ? 0 : 1, p1 = kh > 0 ? 1 : 0;  // passes: 0 X, 1 h
  float* gs = smem + warp * 16 * ld;
  float* wsl = smem + tr * ld;
  const int n_tiles = (rows + tr - 1) / tr;
  const float* wlo = wt + (size_t)K * kpn;
  int st_tile = blockIdx.x, st_p = p0, st_s = 0;  // the next slab to stage: tile, pass, slab
  auto stage_next = [&](int buf) {
    if (st_tile >= n_tiles) return;
    const int c0 = st_p == 0 ? 0 : o.x_cols, np = st_p == 0 ? o.x_cols : kh, k0 = st_s * PM_KS;
    float* dst = wsl + buf * (2 * PM_NMAX * PM_LDS);
    for (int e = tid; e < np * (PM_KS / 4) * 2; e += blockDim.x) {
      const int half = e >= np * (PM_KS / 4);
      const int e2 = e - half * np * (PM_KS / 4), n = e2 / (PM_KS / 4), q = (e2 % (PM_KS / 4)) * 4;
      hm_cp16(dst + half * PM_NMAX * PM_LDS + n * PM_LDS + q,
              (half ? wlo : wt) + (size_t)(c0 + n) * kpn + k0 + q);
    }
    hm_cp_commit();
    if (++st_s == kpn / PM_KS) {
      st_s = 0;
      if (++st_p > p1) {
        st_p = p0;
        st_tile += gridDim.x;
      }
    }
  };
  int q = 0;  // slabs consumed; slab q sits in stage q & 1
  stage_next(0);
  const PmIn in{gs, ld, N, gs, ld, N};
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * tr + warp * 16;  // the warp's first point
    const int nr = min(16, rows - row0);     // its points (<= 0: none)
    pm_warp_rows(gs, ld, g + (size_t)row0 * N, N, nr);
    for (int pass = p0; pass <= p1; ++pass) {
      const int np = pass == 0 ? o.x_cols : kh, nt = (np + 7) / 8, ntp = pm_ntp(np);
      float c[PM_NT][4];
#pragma unroll
      for (int j = 0; j < PM_NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
      for (int s = 0; s < kpn / PM_KS; ++s, ++q) {
        hm_cp_wait();
        __syncthreads();  // slab q is in; every warp is done with slab q - 1
        stage_next((q + 1) & 1);
        const float* bh = wsl + (q & 1) * (2 * PM_NMAX * PM_LDS);
        if (nr > 0) pm_slab_n(ntp, c, in, s * PM_KS, bh);
      }
      if (nr <= 0) continue;
      // the side data: hprev for the h pass, dX where the X pass adds; in
      // shared memory when this is the last pass, else (an X pass before
      // an h pass that adds, with more than one skip layer) from device memory
      const bool add = pass == 0 && !o.store;
      const bool staged = pass == p1 && (pass == 1 || add);
      const float* side = pass == 1 ? o.hprev : o.dX;
      const int ls = pass == 1 ? kh : o.ldx;
      if (staged) {
        __syncwarp();  // every lane is done with the warp's rows of G
        pm_warp_rows(gs, ld, side + (size_t)row0 * ls, ls, nr);
      }
#pragma unroll
      for (int j = 0; j < PM_NT; ++j) {
        if (j < nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows gq and gq + 8, columns n and n + 1
            const int m = gq + 8 * h, n = 8 * j + 2 * t;
            if (m >= nr || n >= np) continue;
            const size_t i = (size_t)(row0 + m) * ls + n;
            float v0 = c[j][2 * h], v1 = c[j][2 * h + 1];
            const bool two = n + 1 < np;
            if (pass == 1 || add) {
              const float s0 = staged ? gs[m * ld + n] : side[i];
              const float s1 = !two ? 0.f : staged ? gs[m * ld + n + 1] : side[i + 1];
              v0 = pass == 1 ? (s0 > 0.f ? v0 : 0.f) : s0 + v0;
              v1 = pass == 1 ? (s1 > 0.f ? v1 : 0.f) : s1 + v1;
            }
            pm_store2((pass == 1 ? o.gn : o.dX) + i, v0, v1, two, false);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the warp's shared memory
  }
}

// X = the embedding of every point, row-major (rows, c_x)
__global__ void __launch_bounds__(HM_THREADS)
pm_embed_kernel(const __grid_constant__ PmArgs a, const float* __restrict__ x,
                float* __restrict__ X) {
  const int n_items = a.c_raw * (a.n_freqs + 1);
  const size_t total = (size_t)a.rows * n_items;
  for (size_t idx = (size_t)blockIdx.x * HM_THREADS + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * HM_THREADS) {
    const size_t p = idx / n_items;
    pm_embed_item(a, x, p, (int)(idx - p * n_items), X + p * a.c_x, true);
  }
}

// dx = the x columns of dX plus the chain rule through the sin / cos
// columns and the window
__global__ void __launch_bounds__(HM_THREADS)
pm_fold_kernel(const __grid_constant__ PmArgs a, const float* __restrict__ x,
               const float* __restrict__ dX, float* __restrict__ dx) {
  const int C = a.c_raw, FC = a.n_freqs * C;
  for (size_t idx = (size_t)blockIdx.x * HM_THREADS + threadIdx.x; idx < (size_t)a.rows * C;
       idx += (size_t)gridDim.x * HM_THREADS) {
    const size_t p = idx / C;
    const int c = (int)(idx - p * C);
    const float* d = dX + p * a.c_x;
    float s = d[c];
    const float xv = __ldg(x + idx);
    for (int f = 0; f < a.n_freqs; ++f) {
      float sv, cv;
      sincosf(xv * a.freq[f], &sv, &cv);
      const float win = a.window != nullptr ? __ldg(a.window + f) : 1.f;
      const float gs = d[C + f * C + c] * win;
      const float gc = d[C + FC + f * C + c] * win;
      s += (cv * gs - sv * gc) * a.freq[f];
    }
    dx[idx] = s;
  }
}

// ------------------------------------------------------------------ launch

static size_t pm_fwd_smem(const PmArgs& a, int tr) {
  return sizeof(float) * ((size_t)tr * (hm_ld(a.c_x) + hm_ld(a.max_h > 0 ? a.max_h : 1)) +
                          4 * PM_NMAX * PM_LDS);
}

// The layer table, the packed weights', saved outputs' and gradients'
// layouts, and K4b's chunks. w / b may be null (sizes only).
static int pm_fill_args(PmArgs& a, const void* const* w, const void* const* b,
                        const int* in_dim, const int* out_dim, int n_layers, int c_raw,
                        int n_freqs, const float* freqs, const float* window, int rows,
                        int skip_mask, int final_act) {
  if (n_layers < 1 || n_layers > PM_MAX_LAYERS || n_freqs < 0 || n_freqs > PM_MAX_FREQS ||
      rows < 1 || c_raw < 1 || (skip_mask & 1))
    return (int)cudaErrorInvalidValue;
  a.n_layers = n_layers;
  a.c_raw = c_raw;
  a.n_freqs = n_freqs;
  a.c_x = c_raw * (2 * n_freqs + 1);
  a.rows = rows;
  a.skip_mask = skip_mask;
  a.final_act = final_act;
  a.window = window;
  if (a.c_x > PM_NMAX) return (int)cudaErrorInvalidValue;
  for (int f = 0; f < PM_MAX_FREQS; ++f) a.freq[f] = f < n_freqs ? freqs[f] : 0.f;
  int pk = 0, pt = 0, act = 0, nw = 0, max_h = 0, max_out = 0;
  for (int l = 0; l < n_layers; ++l) {
    const bool has_x = l == 0 || ((skip_mask >> l) & 1);
    const int want_in = (l == 0 ? 0 : out_dim[l - 1]) + (has_x ? a.c_x : 0);
    if (in_dim[l] != want_in || out_dim[l] < 1 || out_dim[l] > PM_NMAX)
      return (int)cudaErrorInvalidValue;
    a.w[l] = w != nullptr ? static_cast<const float*>(w[l]) : nullptr;
    a.b[l] = b != nullptr ? static_cast<const float*>(b[l]) : nullptr;
    a.in_dim[l] = in_dim[l];
    a.out_dim[l] = out_dim[l];
    a.pk_off[l] = pk;
    pk += 2 * out_dim[l] * pm_kp(in_dim[l]);
    a.pt_off[l] = pt;
    pt += 2 * in_dim[l] * pm_kp(out_dim[l]);
    a.act_off[l] = act;
    if (l < n_layers - 1) {
      act += out_dim[l];
      max_h = out_dim[l] > max_h ? out_dim[l] : max_h;
    }
    a.off_w[l] = nw;
    nw += out_dim[l] * in_dim[l];
    max_out = out_dim[l] > max_out ? out_dim[l] : max_out;
  }
  for (int l = 0; l < n_layers; ++l) {
    a.off_b[l] = nw;
    nw += out_dim[l];
  }
  a.max_h = max_h;
  a.max_out = max_out;
  a.pk_total = pk;
  a.pt_total = pt;
  a.act_total = act;
  a.n_params = nw;
  const int per = (rows + PM_CHUNKS - 1) / PM_CHUNKS;
  a.pc = (per + HM_KS - 1) / HM_KS * HM_KS;
  a.n_chunks = (rows + a.pc - 1) / a.pc;
  a.tr = 16 * PM_MAX_WARPS;  // the tallest tile whose buffers fit
  while (a.tr > 128 && pm_fwd_smem(a, a.tr) > 227 * 1024) a.tr /= 2;
  return 0;
}

// K4b's scratch, floats: the pre-split weights' transposes, two gradient
// buffers (rows x max_out), X and dX (rows x c_x), the chunks' workspace
// slices; each region a whole number of 16-byte units
static size_t pm_bwd_scratch(const PmArgs& a) {
  const size_t P = a.rows;
  return pm_round4(a.pt_total) + 2 * pm_round4(P * a.max_out) + 2 * pm_round4(P * a.c_x) +
         pm_round4((size_t)a.n_chunks * a.n_params);
}

static int pm_set_smem(const void* kernel, size_t smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" {

// K4f / K4b's launch plan for an MLP of these widths on `rows` points, the
// one the entry points below follow: sizes[0] floats of pre-split weights,
// [1] saved floats per point, [2] floats of the gradients (every dW_l
// (out_l, in_l), then every db_l), [3] K4b's chunks, [4] points per chunk,
// [5] K4b's scratch floats, [6] K4f's shared memory per block (bytes), [7]
// K4f's points per tile (256, or 128 where those do not fit), [8] its
// tiles (one persistent block per SM takes them in turn), [9] K4b's CUDA
// launches.
int lab4d_pe_mlp_plan(const int* in_dim, const int* out_dim, int n_layers, int c_raw,
                      int n_freqs, int rows, int skip_mask, long long* sizes) {
  PmArgs a;
  float freqs[PM_MAX_FREQS] = {};
  int err = pm_fill_args(a, nullptr, nullptr, in_dim, out_dim, n_layers, c_raw, n_freqs, freqs,
                         nullptr, rows, skip_mask, 0);
  if (err) return err;
  sizes[0] = a.pk_total;
  sizes[1] = a.act_total;
  sizes[2] = a.n_params;
  sizes[3] = a.n_chunks;
  sizes[4] = a.pc;
  sizes[5] = (long long)pm_bwd_scratch(a);
  sizes[6] = (long long)pm_fwd_smem(a, a.tr);
  sizes[7] = a.tr;
  sizes[8] = (rows + a.tr - 1) / a.tr;
  sizes[9] = 2 * n_layers + 4;
  return 0;
}

// K4f: y (rows, out_last) = MLP(embed(x)) for x (rows, c_raw); window:
// (n_freqs,) device pointer or null; freqs: n_freqs host floats. wpk:
// sizes[0] floats of scratch for the pre-split weights. acts: null, or
// rows * sizes[1] floats for every hidden layer output (K4b's input). Two
// launches: the weights' split, then the MLP. Returns the error, or 0;
// *n_launches: the launches made.
int lab4d_pe_mlp_fwd(const float* x, float* y, float* acts, float* wpk, const void* const* w,
                     const void* const* b, const int* in_dim, const int* out_dim, int n_layers,
                     int c_raw, int n_freqs, const float* freqs, const float* window, int rows,
                     int skip_mask, int final_act, int* n_launches, void* stream) {
  PmArgs a;
  int err = pm_fill_args(a, w, b, in_dim, out_dim, n_layers, c_raw, n_freqs, freqs, window, rows,
                         skip_mask, final_act);
  if (err) return err;
  const size_t smem = pm_fwd_smem(a, a.tr);
  if ((err = pm_set_smem((const void*)pe_mlp_fwd_kernel, smem))) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, n_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev))) return err;
  int n = 0;
  pm_pack_kernel<<<dim3(8, n_layers), HM_THREADS, 0, st>>>(a, wpk, 0);
  if ((err = (int)cudaGetLastError())) return err;
  ++n;
  const int n_tiles = (rows + a.tr - 1) / a.tr;
  pe_mlp_fwd_kernel<<<n_tiles < n_sm ? n_tiles : n_sm, 2 * a.tr, smem, st>>>(a, x, wpk, y, acts);
  if ((err = (int)cudaGetLastError())) return err;
  ++n;
  if (n_launches != nullptr) *n_launches = n;
  return 0;
}

// K4b: dx (rows, c_raw) and grads (sizes[2] floats: every dW_l, then every
// db_l) for the output gradient g (rows, out_last), already masked by the
// final ReLU, from K4f's saved hidden outputs acts. scratch: sizes[5]
// floats. events / kinds (may be null): a CUDA event recorded before the
// first launch and after each launch, and each launch's kind (0 weight
// split, 1 embedding, 2 dW, 3 dIn, 4 dx fold, 5 reduction), for as many
// launches as n_events allows. Returns the error, or 0; *n_launches: the
// launches made.
int lab4d_pe_mlp_bwd(const float* x, const float* g, const float* acts, float* dx, float* grads,
                     float* scratch, const void* const* w, const void* const* b,
                     const int* in_dim, const int* out_dim, int n_layers, int c_raw, int n_freqs,
                     const float* freqs, const float* window, int rows, int skip_mask,
                     void** events, int* kinds, int n_events, int* n_launches, void* stream) {
  PmArgs a;
  int err = pm_fill_args(a, w, b, in_dim, out_dim, n_layers, c_raw, n_freqs, freqs, window, rows,
                         skip_mask, 0);
  if (err) return err;
  // dIn: 256-point tiles, one persistent block per SM
  const int din_tr = 16 * PM_MAX_WARPS, din_tiles = (rows + din_tr - 1) / din_tr;
  const size_t din_smem = sizeof(float) * ((size_t)din_tr * hm_ld(PM_NMAX) + 4 * PM_NMAX * PM_LDS);
  if ((err = pm_set_smem((const void*)pm_din_kernel, din_smem))) return err;
  int dev = 0, n_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev))) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t P = rows;
  float* wpt = scratch;
  float* GA = wpt + pm_round4(a.pt_total);
  float* GB = GA + pm_round4(P * a.max_out);
  float* X = GB + pm_round4(P * a.max_out);
  float* dX = X + pm_round4(P * a.c_x);
  float* ws = dX + pm_round4(P * a.c_x);
  int n = 0;
  if (events != nullptr && n_events > 0 &&
      (err = (int)cudaEventRecord(static_cast<cudaEvent_t>(events[0]), st)))
    return err;
  auto done = [&](int kind) {
    const int e = (int)cudaGetLastError();
    if (e) return e;
    if (n + 1 < n_events) {
      if (events != nullptr) {
        const int r = (int)cudaEventRecord(static_cast<cudaEvent_t>(events[n + 1]), st);
        if (r) return r;
      }
      if (kinds != nullptr) kinds[n] = kind;
    }
    ++n;
    return 0;
  };
  const int eb = (int)((P * a.c_x + HM_THREADS - 1) / HM_THREADS);
  const int grid_e = eb < 132 * 16 ? eb : 132 * 16;

  pm_pack_kernel<<<dim3(8, n_layers), HM_THREADS, 0, st>>>(a, wpt, 1);
  if ((err = done(0))) return err;
  pm_embed_kernel<<<grid_e, HM_THREADS, 0, st>>>(a, x, X);
  if ((err = done(1))) return err;
  const float* gc = g;
  float* gbuf[2] = {GA, GB};
  int cur = 0;
  bool x_written = false;
  for (int l = n_layers - 1; l >= 0; --l) {
    const int N = a.out_dim[l], K = a.in_dim[l];
    const bool has_x = l == 0 || ((skip_mask >> l) & 1);
    const float* hprev = l > 0 ? acts + (size_t)a.act_off[l - 1] * P : nullptr;
    const int kh = l > 0 ? a.out_dim[l - 1] : 0;
    const HmSrc src = l == 0 ? HmSrc{X, a.c_x, a.c_x, X, a.c_x}
                    : has_x  ? HmSrc{X, a.c_x, a.c_x, hprev, kh}
                             : HmSrc{hprev, kh, kh, hprev, kh};
    const int nkt = (K + 63) / 64;
    hm_dw_kernel<<<dim3(((N + 63) / 64) * nkt, a.n_chunks), HM_THREADS, 0, st>>>(
        gc, N, src, K, rows, a.pc, nkt, ws, a.n_params, K, a.off_w[l], a.off_w[l], a.off_b[l]);
    if ((err = done(2))) return err;
    const PmDinOut o{dX, a.c_x, has_x ? a.c_x : 0, x_written ? 0 : 1, gbuf[cur], hprev};
    const int ld = hm_ld(max(N, max(K - o.x_cols, o.x_cols)));
    pm_din_kernel<<<din_tiles < n_sm ? din_tiles : n_sm, 32 * PM_MAX_WARPS,
                    sizeof(float) * ((size_t)din_tr * ld + 4 * PM_NMAX * PM_LDS), st>>>(
        gc, N, wpt + a.pt_off[l], K, rows, din_tr, ld, o);
    if ((err = done(3))) return err;
    x_written = x_written || has_x;
    gc = gbuf[cur];
    cur ^= 1;
  }
  const int fb = (int)((P * c_raw + HM_THREADS - 1) / HM_THREADS);
  pm_fold_kernel<<<fb < 132 * 16 ? fb : 132 * 16, HM_THREADS, 0, st>>>(a, x, dX, dx);
  if ((err = done(4))) return err;
  hm_reduce_kernel<<<(a.n_params + HM_THREADS - 1) / HM_THREADS, HM_THREADS, 0, st>>>(
      ws, a.n_chunks, a.n_params, grads);
  if ((err = done(5))) return err;
  if (n_launches != nullptr) *n_launches = n;
  return 0;
}

const char* lab4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
