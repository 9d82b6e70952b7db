// K4f and K4b: the Fourier-embedding fused MLP, forward and backward,
// hand-written for Hopper (sm_90a) on wgmma in 3xTF32 with weights fed by
// the TMA unit: the tile engine of csrc/wg_engine.cuh, which K1 / K2
// (csrc/nerf_heads.cu) run too, on csrc/wgmma.cuh's primitives.
//
// K4f replaces lab4d_tpu/ops/mlp_kernel.py:_pe_fwd (Pallas kernel
// _pe_fwd_kernel); K4b replaces _pe_bwd_call (_pe_bwd_kernel). The field
// MLPs of the training steps (the bg field's base, colour and visibility
// MLPs, the visibility-decay points, the category step's gauss-skin and
// feature field) and export's SDF grid run through them. Semantics are
// the Pallas kernels': the input x (rows, C) is Fourier-embedded as [x
// (C), sin (F x C), cos (F x C)] (fourier_embed's block layout), each angle
// x * freq elementwise with precise sinf / cosf (angles reach 2^9 |x|),
// sin / cos times an optional per-frequency annealing window; then D+1
// dense layers, ReLU between them, the embedding re-read before each skip
// layer as [X, h] (the weight's leading c_x columns take X: never
// concatenated), an optional ReLU on the output. The final ReLU's mask on
// the incoming gradient is applied by the caller, as the JAX VJP does; no
// gradient reaches the window.
//
// What bounds it on the card: the bg step calls it on 262,144 points; its
// base MLP (F6, W128 x 6, skip 4) costs 91,904 multiply-adds per point,
// 48.2 GFLOP forward: 0.72 ms on fp32 FMA (67 TFLOP/s), 0.29 ms in
// 3xTF32 at the tensor cores' 495 TFLOP/s. The backward from saved layer
// outputs costs twice that. The saved outputs (640 floats per point, 671
// MB) add 0.2 ms of writes and the same of reads at 3.35 TB/s. The
// earlier mma.sync engine ran at 2x (K4f) and 3x (K4b) the fp32 bound:
// each warp's product chains ran one k-step at a time behind a block
// barrier per slab, and K4b was 2 D + 6 launches (split-K dW per layer).
//
// What the design does about it:
// - One persistent block of two warpgroups per SM walks tiles of 128
//   points; each warpgroup owns 64 rows and every column of a layer (one
//   wgmma of m64nNk8, N = 8 .. 128 by the layer's width), so both read the
//   same weight slab and meet only at the slab ring. A pass's products
//   accumulate each 32-deep slab in the tensor core from zero (lo.hi +
//   hi.lo + hi.hi per k8 step, A split in registers) and add the slab's
//   sum to fp32 registers (tests/test_torch_mlp_kernel.py emulates this
//   order). What the engine waits on is each warpgroup's chain of slabs
//   (A's loads and split, the slot's barrier, the products' drain, the
//   release, the fp32 sum), not the products: slabs of 32 halve that chain
//   against K1's 16 (K4f base 0.84 -> 0.74 ms, K4b 2.38 -> 2.28 in turns).
//   The ring's depth (3 to 8 slots) moved nothing, and a whole layer
//   accumulated in the tensor core with two slabs in flight was slower
//   (0.82 ms: ptxas serialises the wgmma for want of registers, C7512).
// - The weights are split into tf32 hi / lo once per call (pm_pack_kernel)
//   into the slabs of the passes, K padded to whole slabs there (the
//   embedding's 39, 51 or 63 columns to 64), never in the caller's
//   tensors; the slabs stream as one sequence across passes and tiles
//   through a ring of 3 slots (2 where 3 do not fit) of 1D TMA bulk
//   copies on mbarriers.
// - K4f: the tile's x arrives by cp.async (all loads in flight at once:
//   one load per embedding item kept the ladder latency-bound) and the
//   embedding is built from it in shared memory; the biases are staged
//   once per block. The hidden layers stay in shared memory, and only the
//   output and, when autograd needs them, the hidden outputs go to device
//   memory (streaming stores, pe_act_layout). A last layer of one output
//   on h alone (the visibility MLP's) is its input layer's epilogue: each
//   row's dot product summed across the accumulator's quad, as K1's sdf
//   head. Two launches: the split, the engine.
// - K4b's dIn: the same engine walks each tile from the last layer to the
//   first over W^T's slabs (a skip layer's X columns into the tile's dX,
//   then its h columns), g and x arriving by cp.async, the ReLU masks read
//   from K4f's saved outputs (into L2 during the pass); each layer's G goes
//   to device memory once, in the slabs dW reads. dX is carried through
//   sin / cos and the window to dx in the tile's epilogue, one thread per
//   (row, frequency), where the embedding also goes to a buffer
//   for dW. dW = G^T A and db = sum G of every layer are one launch over
//   chunks of rows (wg_engine.cuh's warp-specialised dW: A's rows by TMA,
//   the producer's warpgroup handing its registers to the two that run the
//   products), the chunks' slices summed in chunk order
//   (hm_reduce_kernel). Four launches: the split of W^T, dIn, dW, the
//   reduction.
// Rows are arbitrary: the tail tile's missing rows are zero in the
// embedding and G and never stored; dW copies only rows that exist.
//
// No float atomics: every sum across blocks runs in a fixed order, and the
// result is the same from run to run.

#include <algorithm>

#include "wg_engine.cuh"

#define PM_MAX_LAYERS 16
#define PM_MAX_FREQS 16
#define PM_MAX_PASSES (2 * PM_MAX_LAYERS)  // K4b: a skip layer's X and h passes
#define PM_CHUNKS 512  // most chunks of K4b's dW
#define PM_KS 32  // k-depth of a weight slab: four k8 steps summed in the tensor core

// What a pass's epilogue does (NhPass.epi): K4f's hidden layer (bias,
// ReLU, into H, saved), the same with a last layer of one output folded in
// (its dot product with the row, to the output), or the last layer (to the
// output); K4b's X columns of a layer into dX, or its h columns, masked,
// into the previous layer's G
enum { PM_E_HID, PM_E_HID1, PM_E_OUT, PM_E_DX, PM_E_DH };

struct PmArgs {
  NhPass pass[PM_MAX_PASSES];  // K4f's or K4b's, as the launch takes them
  NhDw dw[PM_MAX_LAYERS];      // dW's layers
  int n_pass, n_dw, rows, n_tiles, n_chunks, pc, dw_blocks;
  int n_layers, c_raw, n_freqs, c_x, skip_mask, final_act;
  int fold;      // K4f: the last layer (one output, no embedding) is the epilogue of the one before
  int stages;    // slots of the engine's ring
  int ldx, ldh;  // row strides of the embedding (K4b: dX) and of H in shared memory
  int ldl;       // row stride of K4b's embedding buffer (dW's X columns)
  int gstride;   // floats of one 32-row group of K4b's G image
  int img_total, n_params, act_total;
  int rows_pad;  // the tiles' rows: K4b's buffers' rows
  int in_dim[PM_MAX_LAYERS];
  int out_dim[PM_MAX_LAYERS];
  int act_off[PM_MAX_LAYERS];  // floats per point before the layer's saved block
  int off_w[PM_MAX_LAYERS];    // the layer's dW (out, in) in a gradient slice
  int off_b[PM_MAX_LAYERS];    // and its db, after every dW
  // hidden layer l's copy for dW's TMA rows (hp_off[l] floats per row of
  // hpad before it, rows of round4(out_l)) where the saved block's rows
  // cannot be copied in 16-byte units; -1 where they can
  int hp_off[PM_MAX_LAYERS];
  int hp_total;  // floats per row of hpad
  float freq[PM_MAX_FREQS];
  const float* window;  // (n_freqs,) or null
  const float* w[PM_MAX_LAYERS];  // (out_l, in_l), row-major
  const float* b[PM_MAX_LAYERS];  // (out_l,)
  const float* hpad;              // K4b's dW: the padded copies
};

__host__ __device__ __forceinline__ bool pm_has_x(const PmArgs& a, int l) {
  return l == 0 || ((a.skip_mask >> l) & 1);
}

__host__ __device__ __forceinline__ int pm_round4(int n) { return (n + 3) & ~3; }

// Columns of a row of K4b's staged x: c_raw, none without frequencies
__host__ __device__ __forceinline__ int pm_xr_cols(const PmArgs& a) {
  return a.n_freqs > 0 ? a.c_raw : 0;
}

// The engine's weight stream (wg_engine.cuh) over K4f's or K4b's passes
using PmFeed = NhFeed<PmArgs, PM_KS>;

// The engine's shared memory: the ring's barriers and slots, then per
// warpgroup the embedding (K4b: dX; NH_HALF x ldx) and H (NH_HALF x ldh),
// then K4f's biases (layer l's at l NH_NMAX) and a folded last layer's
// weights (NH_NMAX), then per warpgroup K4b's x for sin / cos (NH_HALF x
// c_raw, none without frequencies)
struct PmBufs {
  float *ring, *xs, *hs, *bs, *w1, *xr;
  uint64_t* full;
  uint32_t* cnt;
  __device__ __forceinline__ PmBufs(float* smem, const PmArgs& a) {
    ring = nh_ring_init(smem, a.stages, full, cnt);
    const int wg = threadIdx.x >> 7;
    float* base = ring + a.stages * PmFeed::kSlot;
    xs = base + wg * NH_HALF * a.ldx;
    hs = base + NH_TR * a.ldx + wg * NH_HALF * a.ldh;
    bs = base + NH_TR * (a.ldx + a.ldh);
    w1 = bs + PM_MAX_LAYERS * NH_NMAX;
    xr = w1 + NH_NMAX + wg * NH_HALF * pm_xr_cols(a);
    for (int i = threadIdx.x; i < NH_TR * (a.ldx + a.ldh); i += NH_THREADS) base[i] = 0.f;
  }
};

// Every row the warpgroup's threads need of a row-major (rows, n) array
// src from row r0 (nr of them exist; zeros after) into dst (row stride
// ld) by cp.async, waited for: the loads are all in flight at once
__device__ __forceinline__ void pm_rows_in(float* dst, int ld, const float* __restrict__ src, int n,
                                           int r0, int nr) {
  const int wt = threadIdx.x & 127;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int e = wt; e < NH_HALF * n4; e += 128) {
      const int m = e / n4, c = 4 * (e - m * n4);
      hm_cp16(dst + m * ld + c, src + (m < nr ? (size_t)(r0 + m) * n + c : 0), m < nr);
    }
  } else {
    for (int e = wt; e < NH_HALF * n; e += 128) {
      const int m = e / n, c = e - m * n;
      hm_cp4(dst + m * ld + c, src + (m < nr ? (size_t)(r0 + m) * n + c : 0), m < nr);
    }
  }
  hm_cp_commit();
  hm_cp_wait();
}

// ------------------------------------------------------------------ K4f

// The embedding of the warpgroup's 64 points from row r0 (nr of them
// exist; zero x after): x into its first C columns, then [sin (F x C) |
// cos (F x C)] from it, times the window. The caller syncs the warpgroup
// after.
__device__ __forceinline__ void pm_ladder(float* xs, int ldx, const float* __restrict__ x, int r0,
                                          int nr, const PmArgs& a) {
  const int C = a.c_raw, F = a.n_freqs;
  pm_rows_in(xs, ldx, x, C, r0, nr);
  nh_bar();
  for (int e = threadIdx.x & 127; e < NH_HALF * F; e += 128) {  // a (row, frequency) each
    const int m = e / F, f = e - m * F;
    const float fr = a.freq[f], w = a.window != nullptr ? __ldg(a.window + f) : 1.f;
    float* row = xs + m * ldx;
    for (int c = 0; c < C; ++c) {
      float s, co;
      sincosf(row[c] * fr, &s, &co);
      row[C + f * C + c] = s * w;
      row[C + F * C + f * C + c] = co * w;
    }
  }
}

// One K4f pass (a layer) on the warpgroup's rows r0 .. r0 + 64 (nr exist)
// and its epilogue
template <int NW>
__device__ __forceinline__ void pm_fwd_pass(const PmArgs& a, const NhPass& ps, PmBufs& B, int r0,
                                            int nr, float* __restrict__ y, float* __restrict__ acts,
                                            int& it, PmFeed& feed) {
  float sum[NW / 2];
  nh_pass<NW>(sum, B.xs, a.ldx, B.hs, a.ldh, ps.nsl, ps.nxs, B.ring, B.full, B.cnt, a.stages, it,
              feed);
  const int N = ps.n;
  const float* bias = B.bs + ps.layer * NH_NMAX;
  if (ps.epi == PM_E_OUT) {
    float* out = y + (size_t)r0 * N;
    const bool relu = a.final_act != 0, vec = (N & 1) == 0;
    rw_each<NW>(sum, [&](int m, int c, float v0, float v1) {
      if (m >= nr || c >= N) return;
      const bool two = c + 1 < N;
      v0 += bias[c];
      v1 = two ? v1 + bias[c + 1] : 0.f;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      rw_st2(out + (size_t)m * N + c, v0, v1, two, vec, false);
    });
    return;
  }
  float* sv = acts != nullptr && nr > 0 ? acts + (size_t)a.act_off[ps.layer] * a.rows + (size_t)r0 * N
                                        : nullptr;
  const bool vec = (N & 1) == 0 && (reinterpret_cast<uintptr_t>(sv) & 7) == 0;
  const bool fold = ps.epi == PM_E_HID1;
  float pa = 0.f, pb = 0.f;  // the folded layer's dot products, rows mq and mq + 8
  nh_bar();  // every thread of the warpgroup is done reading the pass's input
  rw_each<NW>(sum, [&](int m, int c, float v0, float v1) {
    if (c >= N) return;
    const bool two = c + 1 < N;
    v0 = fmaxf(v0 + bias[c], 0.f);
    v1 = two ? fmaxf(v1 + bias[c + 1], 0.f) : 0.f;
    rw_st2(B.hs + m * a.ldh + c, v0, v1, two, true, false);
    if (sv != nullptr && m < nr) rw_st2(sv + (size_t)m * N + c, v0, v1, two, vec, true);
    if (fold) {
      const float p = fmaf(two ? B.w1[c + 1] : 0.f, v1, B.w1[c] * v0);
      if (m & 8) pb += p;
      else pa += p;
    }
  });
  if (fold) {
    const int lane = threadIdx.x & 31, mq = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const float b1 = bias[NH_NMAX];  // the folded layer's
    float sa = nh_quad_sum(pa) + b1, sb = nh_quad_sum(pb) + b1;
    if (a.final_act) {
      sa = fmaxf(sa, 0.f);
      sb = fmaxf(sb, 0.f);
    }
    if ((lane & 3) == 0 && mq < nr) y[r0 + mq] = sa;
    if ((lane & 3) == 0 && mq + 8 < nr) y[r0 + mq + 8] = sb;
  }
  nh_bar();  // the layer is complete in shared memory
}

// K4f: one block per SM walks the tiles of NH_TR points and carries each
// through every layer. pk: the packed weights (pm_pack_kernel over K4f's
// passes); y (rows, out_last); acts: null, or every hidden output
// (pe_act_layout).
__global__ void __launch_bounds__(NH_THREADS, 1)
pm_fwd_kernel(const __grid_constant__ PmArgs a, const float* __restrict__ x,
              const float* __restrict__ pk, float* __restrict__ y, float* __restrict__ acts) {
  extern __shared__ __align__(16) float pm_smem[];
  PmBufs B(pm_smem, a);
  for (int l = 0; l < a.n_layers; ++l)
    for (int c = threadIdx.x; c < a.out_dim[l]; c += NH_THREADS)
      B.bs[l * NH_NMAX + c] = __ldg(a.b[l] + c);
  if (a.fold)
    for (int c = threadIdx.x; c < a.in_dim[a.n_layers - 1]; c += NH_THREADS)
      B.w1[c] = __ldg(a.w[a.n_layers - 1] + c);
  __syncthreads();
  PmFeed feed{&a, pk, (int)blockIdx.x, 0, 0};
  nh_prime(feed, a.stages, B.ring, B.full);
  int it = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int r0 = tile * NH_TR + (threadIdx.x >> 7) * NH_HALF;
    const int nr = max(0, min(NH_HALF, a.rows - r0));
    nh_bar();  // the warpgroup is done with the previous tile's embedding
    pm_ladder(B.xs, a.ldx, x, r0, nr, a);
    nh_bar();
    for (int p = 0; p < a.n_pass; ++p) {
      const NhPass& ps = a.pass[p];
      switch (ps.nw) {
        case 128: pm_fwd_pass<128>(a, ps, B, r0, nr, y, acts, it, feed); break;
        case 64: pm_fwd_pass<64>(a, ps, B, r0, nr, y, acts, it, feed); break;
        case 32: pm_fwd_pass<32>(a, ps, B, r0, nr, y, acts, it, feed); break;
        case 16: pm_fwd_pass<16>(a, ps, B, r0, nr, y, acts, it, feed); break;
        default: pm_fwd_pass<8>(a, ps, B, r0, nr, y, acts, it, feed); break;
      }
    }
  }
}

// ------------------------------------------------------------------ K4b

// One K4b pass on the warpgroup's rows and its epilogue: dIn's X columns
// of the layer added into dX, or its h columns, masked by K4f's saved
// h_{l-1} > 0, into H as the previous layer's G
template <int NW>
__device__ __forceinline__ void pm_bwd_pass(const PmArgs& a, const NhPass& ps, PmBufs& B, int r0,
                                            int nr, const float* __restrict__ acts, int& it,
                                            PmFeed& feed) {
  const int N = ps.n;
  const float* hprev =
      ps.epi == PM_E_DH ? acts + (size_t)a.act_off[ps.layer - 1] * a.rows : nullptr;
  if (hprev != nullptr && nr > 0) nh_prefetch_l2(hprev + (size_t)r0 * N, nr * N);  // the masks, into L2
  float sum[NW / 2];
  nh_pass<NW>(sum, B.xs, a.ldx, B.hs, a.ldh, ps.nsl, 0, B.ring, B.full, B.cnt, a.stages, it, feed);
  if (ps.epi == PM_E_DX) {
    const int ldx = a.ldx;
    rw_each<NW>(sum, [&](int m, int c, float v0, float v1) {
      if (c < N) B.xs[m * ldx + c] += v0;
      if (c + 1 < N) B.xs[m * ldx + c + 1] += v1;
    });
    return;
  }
  const uint64_t on = nh_mask_bits<NW>(hprev, N, r0, nr);
  const int ldh = a.ldh;
  nh_bar();  // every thread of the warpgroup is done reading G
  nh_each_bit<NW>(sum, N, [&](int m, int k, int bit, float v) {
    B.hs[m * ldh + k] = (on >> bit) & 1 ? v : 0.f;
  });
  nh_bar();
}

struct PmGrad {
  const float *x, *g, *acts;
  float *dx, *gimg, *lad, *hpad;
};

// K4b's dIn: the engine over K4b's passes (the tile's output cotangent g
// into H; each layer's G into its dW slabs before its passes), then dx
// from dX through sin / cos and the window; the embedding into lad (ldl
// floats a row) and the padded copies of hp_off's hidden layers into hpad
// for dW.
__global__ void __launch_bounds__(NH_THREADS, 1)
pm_din_kernel(const __grid_constant__ PmArgs a, const float* __restrict__ pk, PmGrad g) {
  extern __shared__ __align__(16) float pm_smem[];
  PmBufs B(pm_smem, a);
  __syncthreads();
  PmFeed feed{&a, pk, (int)blockIdx.x, 0, 0};
  nh_prime(feed, a.stages, B.ring, B.full);
  int it = 0;
  const int wt = threadIdx.x & 127, L = a.n_layers, NL = a.out_dim[L - 1];
  const int C = a.c_raw, F = a.n_freqs, ldh = a.ldh, ldx = a.ldx;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int r0 = tile * NH_TR + (threadIdx.x >> 7) * NH_HALF;
    const int nr = max(0, min(NH_HALF, a.rows - r0));
    nh_bar();  // the warpgroup is done with the previous tile's buffers
    for (int e = wt; e < NH_HALF * ldx; e += 128) B.xs[e] = 0.f;
    if (F > 0) pm_rows_in(B.xr, C, g.x, C, r0, nr);  // for the epilogue's sin / cos
    pm_rows_in(B.hs, ldh, g.g, NL, r0, nr);
    nh_bar();
    for (int p = 0; p < a.n_pass; ++p) {
      const NhPass& ps = a.pass[p];
      if (ps.dw >= 0 && nr > 0) nh_gput(B.hs, ldh, a.dw[ps.dw].N, a.dw[ps.dw], g.gimg, a.gstride, r0);
      switch (ps.nw) {
        case 128: pm_bwd_pass<128>(a, ps, B, r0, nr, g.acts, it, feed); break;
        case 64: pm_bwd_pass<64>(a, ps, B, r0, nr, g.acts, it, feed); break;
        case 32: pm_bwd_pass<32>(a, ps, B, r0, nr, g.acts, it, feed); break;
        case 16: pm_bwd_pass<16>(a, ps, B, r0, nr, g.acts, it, feed); break;
        default: pm_bwd_pass<8>(a, ps, B, r0, nr, g.acts, it, feed); break;
      }
    }
    nh_bar();  // dX is complete
    // each sin / cos pair's term of dx into its sin column of dX, and the
    // embedding for dW; then dx = the x columns plus the terms, in order
    for (int e = wt; e < nr * F; e += 128) {  // a (row, frequency) each
      const int m = e / F, f = e - m * F;
      const float fr = a.freq[f], win = a.window != nullptr ? __ldg(a.window + f) : 1.f;
      float* d = B.xs + m * ldx;
      float* lad = g.lad + (size_t)(r0 + m) * a.ldl;
      for (int c = 0; c < C; ++c) {
        float sv, cv;
        sincosf(B.xr[m * C + c] * fr, &sv, &cv);
        const float gs = d[C + f * C + c] * win, gc = d[C + F * C + f * C + c] * win;
        d[C + f * C + c] = (cv * gs - sv * gc) * fr;
        lad[C + f * C + c] = sv * win;
        lad[C + F * C + f * C + c] = cv * win;
      }
    }
    nh_bar();
    for (int e = wt; e < nr * C; e += 128) {
      const int m = e / C, c = e - m * C;
      const float* d = B.xs + m * ldx;
      float s = d[c];
      for (int f = 0; f < F; ++f) s += d[C + f * C + c];
      const float xv = F > 0 ? B.xr[m * C + c] : __ldg(g.x + (size_t)(r0 + m) * C + c);
      g.lad[(size_t)(r0 + m) * a.ldl + c] = xv;
      g.dx[(size_t)(r0 + m) * C + c] = s;
    }
    for (int l = 0; l + 1 < L; ++l) {
      if (a.hp_off[l] < 0) continue;
      const int w = a.out_dim[l], w4 = pm_round4(w);
      const float* src = g.acts + (size_t)a.act_off[l] * a.rows;
      float* dst = g.hpad + (size_t)a.hp_off[l] * a.rows_pad;
      for (int e = wt; e < nr * w4; e += 128) {
        const int m = e / w4, c = e - m * w4;
        dst[(size_t)(r0 + m) * w4 + c] = c < w ? __ldg(src + (size_t)(r0 + m) * w + c) : 0.f;
      }
    }
  }
}

// dW's A sources of layer d (wg_engine.cuh): the embedding buffer and the
// saved h_{l-1} (or its padded copy)
__device__ __forceinline__ NhDwSrc nh_dw_src(const PmArgs& a, const NhDw& d, const float* acts,
                                             const float* lad) {
  const int l = d.layer, cx = pm_has_x(a, l) ? a.c_x : 0, kh = d.K - cx;
  const float* hs = nullptr;
  int ldh = kh;
  if (l > 0) {
    if (a.hp_off[l - 1] >= 0) {
      hs = a.hpad + (size_t)a.hp_off[l - 1] * a.rows_pad;
      ldh = pm_round4(kh);
    } else {
      hs = acts + (size_t)a.act_off[l - 1] * a.rows;
    }
  }
  if (cx == 0) return NhDwSrc{{hs, nullptr}, {ldh, 0}, 1, 0};
  return NhDwSrc{{lad, hs}, {a.ldl, ldh}, hs != nullptr ? 2 : 1, cx};
}

__device__ __forceinline__ long long nh_dw_dst(const PmArgs& a, const NhDw& d, int o, int i,
                                               float& scale) {
  scale = 1.f;
  return a.off_w[d.layer] + (long long)o * d.K + i;
}

__device__ __forceinline__ int nh_dw_boff(const PmArgs& a, const NhDw& d) { return a.off_b[d.layer]; }

// dW of every layer over the chunks (blockIdx.y; blockIdx.x the layer's
// block, dw[].blk0), each into its slice of ws
__global__ void __launch_bounds__(NH_DW_THREADS, 1)
pm_dw_kernel(const __grid_constant__ PmArgs a, const float* __restrict__ lad,
             const float* __restrict__ acts, const float* __restrict__ gimg, float* __restrict__ ws) {
  extern __shared__ __align__(16) float pm_smem[];
  const bool tail = a.rows % NH_RS != 0 && (int)blockIdx.y == a.n_chunks - 1;
  const NhDwRing R = nh_dw_ring(pm_smem, tail);
  int di = 0;
  while (di + 1 < a.n_dw && (int)blockIdx.x >= a.dw[di + 1].blk0) ++di;
  nh_dw_layer(a, di, lad, acts, gimg, ws + (size_t)blockIdx.y * a.n_params, R);
}

// ------------------------------------------------------------------ the pack

// B(k, n) of pass ps: K4f's W_l[n][k] (k over [the embedding, padded to
// 16 nxs | h]); K4b's W_l[k][n] (n over the X columns, or the h columns).
// Zero past the ends.
__device__ __forceinline__ float pm_pack_value(const PmArgs& a, const NhPass& ps, int k, int n) {
  const int l = ps.layer, N = a.out_dim[l], K = a.in_dim[l];
  const int cx = pm_has_x(a, l) ? a.c_x : 0, kh = K - cx;
  const float* w = a.w[l];
  if (ps.epi == PM_E_DX) return k < N && n < cx ? __ldg(w + (size_t)k * K + n) : 0.f;
  if (ps.epi == PM_E_DH) return k < N && n < kh ? __ldg(w + (size_t)k * K + cx + n) : 0.f;
  if (n >= N) return 0.f;
  if (k < PM_KS * ps.nxs) return k < cx ? __ldg(w + (size_t)n * K + k) : 0.f;
  const int j = k - PM_KS * ps.nxs;
  return j < kh ? __ldg(w + (size_t)n * K + cx + j) : 0.f;
}

// Every pass's weights split into tf32 hi and lo (rw_split), in the slabs
// the engine streams (pk, img_total floats)
__global__ void __launch_bounds__(HM_THREADS)
pm_pack_kernel(const __grid_constant__ PmArgs a, float* __restrict__ pk) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < a.img_total; e += gridDim.x * blockDim.x) {
    int p = 0;  // the last pass whose slabs start at or before e
    while (p + 1 < a.n_pass && a.pass[p + 1].img <= e) ++p;
    const NhPass& ps = a.pass[p];
    int k, n;
    bool lo;
    nh_slab_at<PM_KS>(e - ps.img, ps.nw, k, n, lo);
    uint32_t hv, lv;
    rw_split(pm_pack_value(a, ps, k, n), hv, lv);
    pk[e] = __uint_as_float(lo ? lv : hv);
  }
}

// ------------------------------------------------------------------ launch

static int pm_cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

static int pm_rks(int n) { return (n + PM_KS - 1) / PM_KS * PM_KS; }

static int pm_wgmma_width(int n) {
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
}

static size_t pm_engine_smem(const PmArgs& a) {
  return sizeof(float) * (32 + (size_t)a.stages * PmFeed::kSlot +
                          (size_t)NH_TR * (a.ldx + a.ldh + pm_xr_cols(a)) +
                          (size_t)(PM_MAX_LAYERS + 1) * NH_NMAX);
}

static size_t pm_r4(size_t n) { return (n + 3) & ~(size_t)3; }

// K4b's scratch, floats, each region a whole number of 16-byte units: the
// split transposed weights (K4b's passes), the G image, the embedding
// buffer, the padded hidden copies, the chunks' workspace slices
static size_t pm_bwd_scratch(const PmArgs& a) {
  const size_t R = a.rows_pad;
  return pm_r4(a.img_total) + pm_r4(R / NH_RS * a.gstride) + pm_r4(R * a.ldl) +
         pm_r4(R * a.hp_total) + pm_r4((size_t)a.n_chunks * a.n_params);
}

// The layer table, K4f's passes (or K4b's with bwd), dW's layers and
// chunks for n_sm SMs, the strides and the saved outputs' and gradients'
// layouts. w / b may be null (sizes only).
static int pm_fill(PmArgs& a, const void* const* w, const void* const* b, const int* in_dim,
                   const int* out_dim, int n_layers, int c_raw, int n_freqs, const float* freqs,
                   const float* window, int rows, int skip_mask, int final_act, bool bwd, int n_sm) {
  const int bad = (int)cudaErrorInvalidValue;
  if (n_layers < 1 || n_layers > PM_MAX_LAYERS || n_freqs < 0 || n_freqs > PM_MAX_FREQS ||
      rows < 1 || c_raw < 1 || (skip_mask & 1) || n_sm < 1)
    return bad;
  a = PmArgs{};
  a.n_layers = n_layers;
  a.c_raw = c_raw;
  a.n_freqs = n_freqs;
  a.c_x = c_raw * (2 * n_freqs + 1);
  a.rows = rows;
  a.skip_mask = skip_mask;
  a.final_act = final_act;
  a.window = window;
  if (a.c_x > NH_NMAX) return bad;
  for (int f = 0; f < PM_MAX_FREQS; ++f) a.freq[f] = f < n_freqs ? freqs[f] : 0.f;
  int act = 0, nw = 0, max_out = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int want_in = (l == 0 ? 0 : out_dim[l - 1]) + (pm_has_x(a, l) ? a.c_x : 0);
    if (in_dim[l] != want_in || out_dim[l] < 1 || out_dim[l] > NH_NMAX) return bad;
    a.w[l] = w != nullptr ? static_cast<const float*>(w[l]) : nullptr;
    a.b[l] = b != nullptr ? static_cast<const float*>(b[l]) : nullptr;
    a.in_dim[l] = in_dim[l];
    a.out_dim[l] = out_dim[l];
    a.act_off[l] = act;
    if (l < n_layers - 1) act += out_dim[l];
    a.off_w[l] = nw;
    nw += out_dim[l] * in_dim[l];
    max_out = std::max(max_out, out_dim[l]);
  }
  for (int l = 0; l < n_layers; ++l) {
    a.off_b[l] = nw;
    nw += out_dim[l];
  }
  a.act_total = act;
  a.n_params = nw;
  a.n_tiles = pm_cdiv(rows, NH_TR);
  a.rows_pad = a.n_tiles * NH_TR;
  // the passes: K4f's layers in order; K4b's from the last layer to the
  // first, a layer's X columns before its h columns, the first of them
  // storing the layer's G for dW
  int img = 0;
  auto add = [&](int nsl, int n, int epi, int l, int nxs, int dw) {
    if (a.n_pass == PM_MAX_PASSES) return false;
    const int pw = pm_wgmma_width(n);
    a.pass[a.n_pass++] = NhPass{img, (short)nsl, (short)n, (unsigned char)nxs, (unsigned char)pw,
                                (signed char)epi, 0, (signed char)l, 0, (signed char)dw, 0};
    img += nsl * 2 * PM_KS * pw;
    return true;
  };
  if (!bwd) {
    // a last layer of one output on h alone is its input layer's epilogue
    a.fold = n_layers >= 2 && out_dim[n_layers - 1] == 1 && !pm_has_x(a, n_layers - 1);
    for (int l = 0; l < n_layers - a.fold; ++l) {
      const bool hx = pm_has_x(a, l);
      const int nxs = hx ? pm_rks(a.c_x) / PM_KS : 0, kh = in_dim[l] - (hx ? a.c_x : 0);
      const int epi = l == n_layers - 1 ? PM_E_OUT : a.fold && l == n_layers - 2 ? PM_E_HID1 : PM_E_HID;
      if (!add(nxs + pm_cdiv(kh, PM_KS), out_dim[l], epi, l, nxs, -1)) return bad;
    }
  } else {
    for (int l = n_layers - 1; l >= 0; --l) {
      const bool hx = pm_has_x(a, l);
      const int nsl = pm_cdiv(out_dim[l], PM_KS), kh = in_dim[l] - (hx ? a.c_x : 0);
      int dw = l;
      if (hx) {
        if (!add(nsl, a.c_x, PM_E_DX, l, 0, dw)) return bad;
        dw = -1;
      }
      if (l > 0 && !add(nsl, kh, PM_E_DH, l, 0, dw)) return bad;
    }
  }
  a.img_total = img;
  // dW: every layer, G's slabs one after another in each 32-row group
  int goff = 0, blk = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int nwo = pm_wgmma_width(out_dim[l]);
    const int kind = l == 0 ? NH_A_X : pm_has_x(a, l) ? NH_A_XH : NH_A_H;
    a.dw[l] = NhDw{goff, blk, (short)in_dim[l], (short)out_dim[l], (short)nwo, (signed char)kind, 0,
                   (signed char)l};
    goff += 32 * nwo;
    blk += pm_cdiv(in_dim[l], NH_DW_M);
  }
  a.n_dw = n_layers;
  a.gstride = goff;
  a.dw_blocks = blk;
  // dW's A rows arrive by 16-byte TMA copies from the saved blocks: a
  // hidden layer whose block or rows are not 16-byte aligned is copied
  // padded by dIn
  a.hp_total = 0;
  for (int l = 0; l < n_layers; ++l) {
    const bool pad = l + 1 < n_layers &&
                     (out_dim[l] % 4 != 0 || (long long)a.act_off[l] * rows % 4 != 0);
    a.hp_off[l] = pad ? a.hp_total : -1;
    if (pad) a.hp_total += pm_round4(out_dim[l]);
  }
  a.ldx = hm_ld(pm_rks(a.c_x));
  a.ldh = hm_ld(pm_rks(max_out));
  a.ldl = pm_round4(a.c_x);
  a.stages = 3;  // 3 to 8 slots of 16-deep slabs timed the same
  if (pm_engine_smem(a) > NH_SMEM) a.stages = 2;
  if (pm_engine_smem(a) > NH_SMEM) return bad;
  // dW's chunks: whole G slabs, about eight waves of its blocks
  const int n = std::max(1, std::min({pm_cdiv(rows, NH_RS), pm_cdiv(8LL * n_sm, blk), PM_CHUNKS}));
  a.pc = pm_cdiv(pm_cdiv(rows, n), NH_RS) * NH_RS;
  a.n_chunks = pm_cdiv(rows, a.pc);
  return 0;
}

extern "C" {

// K4f / K4b's launch plan for an MLP of these widths on `rows` points, the
// one the entry points below follow: sizes[0] floats of K4f's split
// weights, [1] saved floats per point, [2] floats of the gradients (every
// dW_l (out_l, in_l), then every db_l), [3] K4b's dW chunks, [4] points per
// chunk, [5] K4b's scratch floats, [6] the engine's shared memory per block
// (bytes), [7] points per tile, [8] tiles (one persistent block per SM
// takes them in turn), [9] K4b's CUDA launches.
int lab4d_pe_mlp_plan(const int* in_dim, const int* out_dim, int n_layers, int c_raw,
                      int n_freqs, int rows, int skip_mask, long long* sizes) {
  PmArgs f, bw;
  float freqs[PM_MAX_FREQS] = {};
  const int n_sm = nh_sms();
  int err = pm_fill(f, nullptr, nullptr, in_dim, out_dim, n_layers, c_raw, n_freqs, freqs, nullptr,
                    rows, skip_mask, 0, false, n_sm);
  if (!err)
    err = pm_fill(bw, nullptr, nullptr, in_dim, out_dim, n_layers, c_raw, n_freqs, freqs, nullptr,
                  rows, skip_mask, 0, true, n_sm);
  if (err) return err;
  sizes[0] = f.img_total;
  sizes[1] = f.act_total;
  sizes[2] = f.n_params;
  sizes[3] = bw.n_chunks;
  sizes[4] = bw.pc;
  sizes[5] = (long long)pm_bwd_scratch(bw);
  sizes[6] = (long long)pm_engine_smem(f);
  sizes[7] = NH_TR;
  sizes[8] = f.n_tiles;
  sizes[9] = 4;
  return 0;
}

// K4f: y (rows, out_last) = MLP(embed(x)) for x (rows, c_raw); window:
// (n_freqs,) device pointer or null; freqs: n_freqs host floats. wpk:
// sizes[0] floats of scratch for the split weights. acts: null, or rows *
// sizes[1] floats for every hidden layer output (K4b's input). Two
// launches: the split, then the engine. Returns the error, or 0;
// *n_launches: the launches made.
int lab4d_pe_mlp_fwd(const float* x, float* y, float* acts, float* wpk, const void* const* w,
                     const void* const* b, const int* in_dim, const int* out_dim, int n_layers,
                     int c_raw, int n_freqs, const float* freqs, const float* window, int rows,
                     int skip_mask, int final_act, int* n_launches, void* stream) {
  const int n_sm = nh_sms();
  if (n_sm < 1) return (int)cudaErrorInvalidDevice;
  PmArgs a;
  int err = pm_fill(a, w, b, in_dim, out_dim, n_layers, c_raw, n_freqs, freqs, window, rows,
                    skip_mask, final_act, false, n_sm);
  if (err) return err;
  const size_t smem = pm_engine_smem(a);
  if ((err = nh_set_smem((const void*)pm_fwd_kernel, smem))) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pm_pack_kernel<<<std::min(pm_cdiv(a.img_total, HM_THREADS), 1024), HM_THREADS, 0, st>>>(a, wpk);
  if ((err = (int)cudaGetLastError())) return err;
  pm_fwd_kernel<<<std::min(a.n_tiles, n_sm), NH_THREADS, smem, st>>>(a, x, wpk, y, acts);
  if ((err = (int)cudaGetLastError())) return err;
  if (n_launches != nullptr) *n_launches = 2;
  return 0;
}

// K4b: dx (rows, c_raw) and grads (sizes[2] floats: every dW_l, then every
// db_l) for the output gradient g (rows, out_last), already masked by the
// final ReLU, from K4f's saved hidden outputs acts (16-byte aligned).
// scratch: sizes[5] floats. events / kinds (may be null): a CUDA event
// recorded before the first launch and after each launch, and each
// launch's kind (0 weight split, 1 dIn, 2 dW, 3 reduction), for as many
// launches as n_events allows. Returns the error, or 0; *n_launches: the
// launches made (4).
int lab4d_pe_mlp_bwd(const float* x, const float* g, const float* acts, float* dx, float* grads,
                     float* scratch, const void* const* w, const void* const* b,
                     const int* in_dim, const int* out_dim, int n_layers, int c_raw, int n_freqs,
                     const float* freqs, const float* window, int rows, int skip_mask,
                     void** events, int* kinds, int n_events, int* n_launches, void* stream) {
  const int n_sm = nh_sms();
  if (n_sm < 1) return (int)cudaErrorInvalidDevice;
  if ((reinterpret_cast<uintptr_t>(acts) & 15) || (reinterpret_cast<uintptr_t>(scratch) & 15))
    return (int)cudaErrorMisalignedAddress;
  PmArgs a;
  int err = pm_fill(a, w, b, in_dim, out_dim, n_layers, c_raw, n_freqs, freqs, window, rows,
                    skip_mask, 0, true, n_sm);
  if (err) return err;
  const size_t smem = pm_engine_smem(a);
  if ((err = nh_set_smem((const void*)pm_din_kernel, smem)) ||
      (err = nh_set_smem((const void*)pm_dw_kernel, NH_DW_SMEM)))
    return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t R = a.rows_pad;
  float* pk = scratch;  // the TMA unit's sources: 16-byte aligned
  float* gimg = pk + pm_r4(a.img_total);
  float* lad = gimg + pm_r4(R / NH_RS * a.gstride);
  float* hpad = lad + pm_r4(R * a.ldl);
  float* ws = hpad + pm_r4(R * a.hp_total);
  a.hpad = hpad;
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
  pm_pack_kernel<<<std::min(pm_cdiv(a.img_total, HM_THREADS), 1024), HM_THREADS, 0, st>>>(a, pk);
  if ((err = done(0))) return err;
  const PmGrad gr{x, g, acts, dx, gimg, lad, hpad};
  pm_din_kernel<<<std::min(a.n_tiles, n_sm), NH_THREADS, smem, st>>>(a, pk, gr);
  if ((err = done(1))) return err;
  pm_dw_kernel<<<dim3(a.dw_blocks, a.n_chunks), NH_DW_THREADS, NH_DW_SMEM, st>>>(a, lad, acts, gimg, ws);
  if ((err = done(2))) return err;
  hm_reduce_kernel<<<pm_cdiv(a.n_params, HM_THREADS), HM_THREADS, 0, st>>>(ws, a.n_chunks,
                                                                         a.n_params, grads);
  if ((err = done(3))) return err;
  if (n_launches != nullptr) *n_launches = n;
  return 0;
}

const char* lab4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
