// K1 and K2: every per-point head of the FeatureNeRF field, forward and
// backward, hand-written for Hopper (sm_90a) on wgmma in 3xTF32 with
// weights fed by the TMA unit (the tile engine of csrc/wg_engine.cuh, which
// K4f / K4b share, on the primitives of csrc/wgmma.cuh).
//
// K1 replaces lab4d_tpu/ops/field_kernel.py:_run_fwd (Pallas kernel
// _fwd_kernel / _forward_tile); K2 replaces _run_bwd (_bwd_kernel /
// _backward_tile). The heads:
//   base MLP (Fourier embedding, ReLU layers, skip) -> feat -> sdf head ->
//     VolSDF density (Laplace CDF, expm1, times ibeta);
//   colour MLP -> + feat = hc -> rgb1 (with the pair's appearance row as a
//     bias row) -> ReLU -> rgb2 -> sigmoid;
//   visibility MLP -> logit; feature MLP -> 16 channels -> L2 normalisation.
// K2 returns dx through the Fourier embeddings, every dW / db, d ibeta and
// the appearance rows' gradient; the windows get none (as in the JAX VJP).
// Weights come in the split layout of ops/field_kernel.py:split_nets (the
// torch.nn.Linear (out, in) layout, a skip layer as [W_x | W_h] column
// blocks, rgb1 as W_hc and W_appr).
//
// What bounds it on the card: at the flagship step (262,144 points, W 128)
// the heads cost 234,688 multiply-adds per point: 123 GFLOP for K1 and
// twice that for K2 from K1's saved outputs, 0.75 ms and 1.49 ms at the
// TF32 peak in 3xTF32 (1.84 ms and 3.67 ms on fp32 FMA); K1's 2,001 saved
// floats per point (2.1 GB) take 0.63 ms at 3.35 TB/s, and K2 reads them
// twice and writes and reads every layer's G once for dW. The mma.sync
// engine of PR 4 ran at 4x the fp32 bound: each 64-point block re-streamed
// all weights from L2 by cp.async with a block barrier per 32-deep slab,
// and K2 walked the heads layer by layer over all points in 53 launches.
// What this engine does about it:
// - One persistent block of two warpgroups per SM walks tiles of 128
//   points (ops/field_kernel.py:heads_plan). Each warpgroup owns 64 of the
//   tile's rows and every column of a layer (widths <= 128: one wgmma of
//   m64nNk8, N = 8 .. 128 by the layer's width), so the two warpgroups read
//   the same weight slab for 128 rows and sync with each other only
//   through the slab ring; inside a warpgroup a named barrier (128 threads)
//   orders a layer's in-place store. A pass's products accumulate each
//   16-deep slab in the tensor core from zero (lo.hi + hi.lo + hi.hi per k8
//   step; A split in registers by rw_split) and add the slab's sum to fp32
//   registers, which bounds what the tensor core's accumulation can lose
//   (tests/test_torch_field_kernel.py emulates this order).
// - The weights are split into tf32 hi / lo once per call (nh_pack_kernel)
//   into the slabs of the passes (ops/field_kernel.py:heads_passes), laid
//   out as wgmma's K-major core matrices without swizzle, and stream as one
//   sequence across passes and tiles through a ring of 3 slots (2 where 3
//   do not fit) of 1D TMA bulk copies completing on mbarriers; the last
//   warp out of a slot refills it.
// - One Fourier ladder per point, the colour ladder interleaved as [x |
//   sin, cos of frequency 0 | ...], so that every head's embedding is a
//   prefix of it; the pack permutes the weights' embedding columns to that
//   order and folds the heads' annealing windows into them. An embedding's
//   K is padded to whole slabs in the pack, never in the callers' tensors.
// - K1: the tile's hidden layers stay in shared memory (H; feat and then
//   hc = feat + colour in F); only the four outputs and, when autograd
//   needs them, every layer output go to device memory (streaming stores).
//   The sdf head (width -> 1) is an FMA epilogue of the base head's last
//   layer, from its registers; the feature's normalisation sums the
//   channels of a row across the accumulator's quad. rgb1's appearance
//   term is a bias row per pair, computed by the pack launch.
// - K2's dIn: the same engine walks each tile's heads from the last layer
//   to the first over W^T's slabs: the output cotangents in the tile's
//   prologue, the ReLU masks from K1's saved outputs (loaded after the
//   pass, two parts of 16 in flight; into L2 during it), dX of the shared
//   ladder summed over every head in shared memory and carried through
//   sin / cos to dx in the tile's epilogue (no X or dX reaches device
//   memory; the ladder itself goes to a buffer for dW), the pairs' sums of
//   d rgb_h per 64-row half.
//   Every layer's G goes to device memory once, in fp32 by streaming
//   stores, in the 32-row K-major slabs dW's wgmma reads (2.1 GB at the
//   flagship step; split into hi / lo it was 4.2).
// - K2's dW = G^T A for every layer is one launch over chunks of rows,
//   each chunk into its workspace slice; the slices are summed in chunk
//   order with the appearance gradients and d ibeta in the last launch. A
//   block is warp specialised (wg_engine.cuh's nh_dw_block, which K4b
//   runs too): a producer warp streams each 32-row slab by TMA into a ring
//   (G's fp32 slab; A's whole saved rows, the embedding from the ladder
//   buffer, hc as feat and colour, in 8 bulk copies of 4 rows per
//   operand: one copy per row was dW's bottleneck), its warpgroup splits G
//   into hi / lo in the slot and releases it to the two warpgroups that
//   run the products, with the registers it handed them (setmaxnreg). A
//   slab's rows are permuted (nh_slab_row) so that the A^T fragment
//   loads, from tiles padded per 4-row chunk, hit distinct banks. K1 is 2
//   CUDA launches, K2 4.

// No float atomics on values: every sum across warps, blocks and chunks
// runs in a fixed order, and the result is the same from run to run.
// Precise sinf / cosf / expf / expm1f (no fast math); angles reach 2^11 |x|.

#include <algorithm>

#include "wg_engine.cuh"

#define NH_MAX_LAYERS 8
#define NH_MAX_FREQS 16
#define NH_MAX_PASSES 68   // K2's passes at 4 heads of 8 layers that all read x
#define NH_MAX_DW 36       // dW's layers: every head layer, sdf, rgb2, rgb1
#define NH_HEADS 4         // base, colour, visibility, feature
#define NH_RGB 3
#define NH_SLAB (2 * NH_KS * NH_NMAX)  // floats of a ring slot: the widest slab, hi and lo

// What a pass computes (NhPass.epi). K1: a hidden layer into H; the base
// head's last layer into F, with the sdf and density; the colour head's
// last into F (+= : hc); rgb1 into H; rgb2 to rgb; the visibility logit;
// the feature and its normalisation. K2: d hc from d rgb_h (the base and
// colour heads' last G); a layer's x columns into dX; its h columns into
// the previous layer's G.
enum { NH_E_HID, NH_E_BASE, NH_E_COL, NH_E_RGB1, NH_E_RGB2, NH_E_VIS, NH_E_FEAT,
       NH_E_DHC, NH_E_DX, NH_E_DH };

// One ReLU MLP head in the split layout. off_*: offsets of its gradients in
// a workspace slice; act_off: floats per point before layer l's saved
// output (a (rows, out) row-major block at act_off * rows).
struct NhHead {
  int n_layers, skip_mask, n_freqs, c_x;
  int in_dim[NH_MAX_LAYERS];  // full input width (c_x + h on a skip layer)
  int out_dim[NH_MAX_LAYERS];
  int off_w1[NH_MAX_LAYERS], off_w2[NH_MAX_LAYERS], off_b[NH_MAX_LAYERS];
  int act_off[NH_MAX_LAYERS];
  const float* window;  // (n_freqs,) annealing window or null
  const float* w1[NH_MAX_LAYERS];  // (out, c_x) on a layer with x (0 or skip), else (out, in)
  const float* w2[NH_MAX_LAYERS];  // the h columns of a skip layer, else null
  const float* b[NH_MAX_LAYERS];
};

struct NhArgs {
  NhHead head[NH_HEADS];
  NhPass pass[NH_MAX_PASSES];  // K1's passes or K2's, as the launch takes them
  NhDw dw[NH_MAX_DW];
  int n_pass, n_dw, rows, spp, n_tiles, n_chunks, pc, dw_blocks;
  int width;       // output width of the base and colour MLPs (hc)
  int rgb_hidden;  // rgb1 outputs
  int appr_dim;    // appearance channels
  int feat_dim;    // feature channels
  int n_freqs;     // frequencies of the shared ladder (the most any head takes)
  int img_total;   // floats of the packed weights
  int stages;      // slots of the engine's ring
  int ldx, ldh;    // row strides of the ladder (dX) and of H / F in shared memory
  int ldl;         // row stride of K2's ladder buffer (dW's embedding columns)
  int gstride;     // floats of one 32-row group of K2's G image
  int off_w_sdf, off_b_sdf, off_w_hc, off_w_rgb2, off_b_rgb2, off_dibeta;
  int n_slice;     // floats of one workspace slice
  int act_rgbh;    // floats per point before rgb_h in the saved outputs
  int act_total;   // saved floats per point
  int dw_sdf, dw_rgb2, dw_rgb1;  // their dW layers
  float freq[NH_MAX_FREQS];
  const float* w_sdf;   // (1, width)
  const float* b_sdf;   // (1,)
  const float* w_hc;    // (rgb_hidden, width)
  const float* w_appr;  // (rgb_hidden, appr_dim)
  const float* b_rgb1;  // (rgb_hidden,)
  const float* w_rgb2;  // (3, rgb_hidden)
  const float* b_rgb2;  // (3,)
  const float* ibeta;   // (1,) on the device
};

// The engine's weight stream (wg_engine.cuh) over K1's or K2's passes
using NhHeadsFeed = NhFeed<NhArgs, NH_KS>;

__device__ __forceinline__ float nh_sign(float s) { return s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f); }

__device__ __forceinline__ float nh_sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__host__ __device__ __forceinline__ bool nh_has_x(const NhHead& h, int l) {
  return l == 0 || ((h.skip_mask >> l) & 1);
}

// The column of head h's embedding [x, sin (nf x 3), cos (nf x 3)] at
// position p of the shared ladder [x | sin, cos of frequency 0 | ...]
__device__ __forceinline__ int nh_orig(int nf, int p) {
  if (p < 3) return p;
  const int q = p - 3, f = q / 6, r = q - 6 * f;
  return 3 + (r >= 3 ? 3 * nf : 0) + 3 * f + r % 3;
}

// Head h's annealing window at ladder position p
__device__ __forceinline__ float nh_win(const NhHead& h, int p) {
  return p < 3 || h.window == nullptr ? 1.f : __ldg(h.window + (p - 3) / 6);
}

// The engine's shared memory: the ring's barriers and slots, then per
// warpgroup the ladder (K1) or dX (K2) (NH_HALF x ldx), H and F (NH_HALF x
// ldh each), then K2's per-row g_sdf and d ibeta terms
struct NhBufs {
  float *ring, *xs, *hs, *fs, *gsd, *dib;
  uint64_t* full;
  uint32_t* cnt;
  __device__ __forceinline__ NhBufs(float* smem, const NhArgs& a) {
    ring = nh_ring_init(smem, a.stages, full, cnt);
    const int wg = threadIdx.x >> 7;
    float* base = ring + a.stages * NH_SLAB;
    xs = base + wg * NH_HALF * a.ldx;
    hs = base + NH_TR * a.ldx + wg * NH_HALF * a.ldh;
    fs = hs + NH_TR * a.ldh;
    gsd = base + NH_TR * (a.ldx + 2 * a.ldh) + wg * NH_HALF;
    dib = gsd + NH_TR;
    for (int i = threadIdx.x; i < NH_TR * (a.ldx + 2 * a.ldh); i += NH_THREADS) base[i] = 0.f;
  }
};

// ------------------------------------------------------------------ K1

// The shared ladder of the warpgroup's 64 points at row r0: [x | sin, cos
// of each frequency] (zero where the half holds no points)
__device__ __forceinline__ void nh_ladder(float* xs, int ldx, const float* __restrict__ x, int r0,
                                          bool valid, const NhArgs& a) {
  const int per = 3 * (a.n_freqs + 1);
  for (int e = threadIdx.x & 127; e < NH_HALF * per; e += 128) {
    const int m = e / per, q = e - m * per, f = q / 3 - 1, c = q % 3;
    const float xv = valid ? __ldg(x + (size_t)(r0 + m) * 3 + c) : 0.f;
    float* row = xs + m * ldx;
    if (f < 0) {
      row[c] = xv;
    } else {
      float s, co;
      sincosf(xv * a.freq[f], &s, &co);
      row[3 + 6 * f + c] = s;
      row[6 + 6 * f + c] = co;
    }
  }
}

struct NhOut {
  const float* abias;  // (pairs, rgb_hidden) rgb1's bias row per pair
  float *density, *rgb, *vis, *feat, *acts;
};

// One K1 pass on the warpgroup's rows r0 .. r0 + 64 and its epilogue
template <int NW>
__device__ __forceinline__ void nh_fwd_pass(const NhArgs& a, const NhPass& ps, NhBufs& B, int r0,
                                            bool valid, const NhOut& o, int& it, NhHeadsFeed& feed) {
  float sum[NW / 2];
  nh_pass<NW>(sum, B.xs, a.ldx, ps.src ? B.fs : B.hs, a.ldh, ps.nsl, ps.nxs, B.ring, B.full, B.cnt,
              a.stages, it, feed);
  const int N = ps.n, rows = a.rows, ldh = a.ldh;
  const NhHead& h = a.head[ps.head < 0 ? 0 : ps.head];
  const float* bias = ps.epi == NH_E_RGB1   ? o.abias + (size_t)(r0 / a.spp) * a.rgb_hidden
                      : ps.epi == NH_E_RGB2 ? a.b_rgb2
                                            : h.b[ps.layer];
  const int aoff = ps.epi == NH_E_RGB1 ? a.act_rgbh : h.act_off[ps.layer];
  float* sv = o.acts != nullptr && valid && ps.epi != NH_E_RGB2
                  ? o.acts + (size_t)aoff * rows + (size_t)r0 * N
                  : nullptr;
  const bool vec = (N & 1) == 0;
  const int lane = threadIdx.x & 31, mq = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  if (ps.epi == NH_E_RGB2) {  // sigmoid rgb, straight to the output
    if (valid)
      rw_each<NW>(sum, [&](int m, int c, float v0, float v1) {
        float* y = o.rgb + (size_t)(r0 + m) * NH_RGB + c;
        if (c < NH_RGB) y[0] = nh_sigmoid(v0 + __ldg(bias + c));
        if (c + 1 < NH_RGB) y[1] = nh_sigmoid(v1 + __ldg(bias + c + 1));
      });
    return;
  }
  if (ps.epi == NH_E_VIS) {  // the logit: column 0
    if (valid)
      rw_each<NW>(sum, [&](int m, int c, float v0, float) {
        if (c != 0) return;
        const float v = v0 + __ldg(bias);
        o.vis[r0 + m] = v;
        if (sv != nullptr) __stcs(sv + m, v);
      });
    return;
  }
  if (ps.epi == NH_E_FEAT) {  // save the raw feature, then normalise each row
    float pa = 0.f, pb = 0.f;
    rw_each<NW>(sum, [&](int m, int c, float v0, float v1) {
      if (c >= N) return;
      const bool two = c + 1 < N;
      v0 += __ldg(bias + c);
      v1 = two ? v1 + __ldg(bias + c + 1) : 0.f;
      if (m & 8) pb = fmaf(v1, v1, fmaf(v0, v0, pb));
      else pa = fmaf(v1, v1, fmaf(v0, v0, pa));
      if (sv != nullptr) rw_st2(sv + (size_t)m * N + c, v0, v1, two, vec, true);
    });
    const float da = fmaxf(sqrtf(nh_quad_sum(pa) + 1e-12f), 1e-6f);
    const float db = fmaxf(sqrtf(nh_quad_sum(pb) + 1e-12f), 1e-6f);
    if (valid)
      rw_each<NW>(sum, [&](int m, int c, float v0, float v1) {
        if (c >= N) return;
        const float d = (m & 8) ? db : da;
        float* y = o.feat + (size_t)(r0 + m) * N + c;
        y[0] = (v0 + __ldg(bias + c)) / d;
        if (c + 1 < N) y[1] = (v1 + __ldg(bias + c + 1)) / d;
      });
    return;
  }
  // ReLU layers into shared memory: H (hidden, rgb1), F (base: feat; colour: += into hc)
  float* dst = ps.epi == NH_E_BASE || ps.epi == NH_E_COL ? B.fs : B.hs;
  float pa = 0.f, pb = 0.f;  // the base head: the sdf's dot product, rows mq and mq + 8
  nh_bar();                  // every thread of the warpgroup is done reading the pass's input
  rw_each<NW>(sum, [&](int m, int c, float v0, float v1) {
    if (c >= N) return;
    const bool two = c + 1 < N;
    v0 = fmaxf(v0 + __ldg(bias + c), 0.f);
    v1 = two ? fmaxf(v1 + __ldg(bias + c + 1), 0.f) : 0.f;
    float* d = dst + m * ldh + c;
    if (ps.epi == NH_E_COL) {
      d[0] += v0;
      if (two) d[1] += v1;
    } else {
      rw_st2(d, v0, v1, two, true, false);
    }
    if (sv != nullptr) rw_st2(sv + (size_t)m * N + c, v0, v1, two, vec, true);
    if (ps.epi == NH_E_BASE) {
      const float p = fmaf(two ? __ldg(a.w_sdf + c + 1) : 0.f, v1, __ldg(a.w_sdf + c) * v0);
      if (m & 8) pb += p;
      else pa += p;
    }
  });
  if (ps.epi == NH_E_BASE) {
    const float sa = nh_quad_sum(pa) + __ldg(a.b_sdf), sb = nh_quad_sum(pb) + __ldg(a.b_sdf);
    if (valid && (lane & 3) == 0) {
      const float ib = __ldg(a.ibeta);
      o.density[r0 + mq] = (0.5f + 0.5f * nh_sign(sa) * expm1f(-fabsf(sa) * ib)) * ib;
      o.density[r0 + mq + 8] = (0.5f + 0.5f * nh_sign(sb) * expm1f(-fabsf(sb) * ib)) * ib;
    }
  }
  nh_bar();  // the layer is complete in shared memory
}

// K1: one block per SM walks the tiles of NH_TR points and carries each
// through every pass (NhArgs.pass: the heads' layers, rgb1 and rgb2 in
// order). pk: the packed weights (nh_pack_kernel); acts: null, or every
// layer output (act_total floats per point).
__global__ void __launch_bounds__(NH_THREADS, 1)
nh_fwd_kernel(const __grid_constant__ NhArgs a, const float* __restrict__ x,
              const float* __restrict__ pk, NhOut o) {
  extern __shared__ __align__(16) float nh_smem[];
  NhBufs B(nh_smem, a);
  __syncthreads();
  NhHeadsFeed feed{&a, pk, (int)blockIdx.x, 0, 0};
  nh_prime(feed, a.stages, B.ring, B.full);
  int it = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int r0 = tile * NH_TR + (threadIdx.x >> 7) * NH_HALF;
    const bool valid = r0 < a.rows;  // rows are whole halves
    nh_bar();  // the warpgroup is done with the previous tile's ladder
    nh_ladder(B.xs, a.ldx, x, r0, valid, a);
    nh_bar();
    for (int p = 0; p < a.n_pass; ++p) {
      const NhPass& ps = a.pass[p];
      switch (ps.nw) {
        case 128: nh_fwd_pass<128>(a, ps, B, r0, valid, o, it, feed); break;
        case 64: nh_fwd_pass<64>(a, ps, B, r0, valid, o, it, feed); break;
        case 32: nh_fwd_pass<32>(a, ps, B, r0, valid, o, it, feed); break;
        case 16: nh_fwd_pass<16>(a, ps, B, r0, valid, o, it, feed); break;
        default: nh_fwd_pass<8>(a, ps, B, r0, valid, o, it, feed); break;
      }
    }
  }
}

// ------------------------------------------------------------------ K2

struct NhGrad {
  const float *acts, *rgb, *gd, *grgb, *gvis, *gfeat;
  float *dx, *gimg, *gpart, *dpart;
  float* lad;  // the rows' ladder (ldl floats a row), for dW's embedding columns
};

// The tile's output cotangents, on the warpgroup's 64 rows: g_sdf (through
// the density) in gsd and each row's d ibeta term, g_rgb (through the
// sigmoid) in F's first 3 columns, g_rgbh (through rgb2 and its ReLU) in H;
// their G slabs for dW, the half's column sums of g_rgbh and d ibeta.
__device__ __forceinline__ void nh_bwd_prologue(const NhArgs& a, NhBufs& B, int r0, bool valid,
                                                const NhGrad& g) {
  const int wt = threadIdx.x & 127, W = a.width, RH = a.rgb_hidden, rows = a.rows, ldh = a.ldh;
  const NhHead& hb = a.head[0];
  const float* feat = g.acts + (size_t)hb.act_off[hb.n_layers - 1] * rows;
  const float* rgbh = g.acts + (size_t)a.act_rgbh * rows;
  nh_bar();  // the warpgroup is done with the previous tile's buffers
  // feat into F and rgb_h into H by cp.async (zero where the half holds no
  // points): a loop of loads and shared stores would wait for each load
  for (int e = wt; e < NH_HALF * W; e += 128) {
    const int m = e / W, c = e - m * W;
    hm_cp4(B.fs + m * ldh + c, valid ? feat + (size_t)(r0 + m) * W + c : feat, valid);
  }
  for (int e = wt; e < NH_HALF * RH; e += 128) {
    const int m = e / RH, j = e - m * RH;
    hm_cp4(B.hs + m * ldh + j, valid ? rgbh + (size_t)(r0 + m) * RH + j : rgbh, valid);
  }
  hm_cp_commit();
  for (int e = wt; e < NH_HALF * a.ldx; e += 128) B.xs[e] = 0.f;
  hm_cp_wait();
  nh_bar();
  {  // the sdf, two threads per row
    const int m = wt >> 1;
    float s = 0.f;
    for (int c = wt & 1; c < W; c += 2) s = fmaf(__ldg(a.w_sdf + c), B.fs[m * ldh + c], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __ldg(a.b_sdf);
    if ((wt & 1) == 0) {
      const float ib = __ldg(a.ibeta), ex = expf(-fabsf(s) * ib);
      const float gv = valid ? __ldg(g.gd + r0 + m) : 0.f;
      B.gsd[m] = gv * (-0.5f * ib * ib * ex);
      B.dib[m] = gv * (0.5f + 0.5f * nh_sign(s) * expm1f(-fabsf(s) * ib) - 0.5f * ib * s * ex);
    }
  }
  nh_bar();  // F is read
  for (int e = wt; e < NH_HALF * NH_RGB; e += 128) {
    const int m = e / NH_RGB, c = e - m * NH_RGB;
    const size_t i = (size_t)(r0 + m) * NH_RGB + c;
    const float sv = valid ? __ldg(g.rgb + i) : 0.f, gv = valid ? __ldg(g.grgb + i) : 0.f;
    B.fs[m * ldh + c] = gv * sv * (1.f - sv);
  }
  nh_bar();
  for (int e = wt; e < NH_HALF * RH; e += 128) {  // in place over rgb_h
    const int m = e / RH, j = e - m * RH;
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < NH_RGB; ++c) v = fmaf(B.fs[m * ldh + c], __ldg(a.w_rgb2 + c * RH + j), v);
    B.hs[m * ldh + j] = B.hs[m * ldh + j] > 0.f ? v : 0.f;
  }
  nh_bar();
  if (!valid) return;
  nh_gput(B.gsd, 1, 1, a.dw[a.dw_sdf], g.gimg, a.gstride, r0);
  nh_gput(B.fs, ldh, NH_RGB, a.dw[a.dw_rgb2], g.gimg, a.gstride, r0);
  nh_gput(B.hs, ldh, RH, a.dw[a.dw_rgb1], g.gimg, a.gstride, r0);
  for (int j = wt; j < RH; j += 128) {
    float s = 0.f;
    for (int m = 0; m < NH_HALF; ++m) s += B.hs[m * ldh + j];
    g.gpart[(size_t)(r0 / NH_HALF) * RH + j] = s;
  }
  if (wt == 0) {
    float s = 0.f;
    for (int m = 0; m < NH_HALF; ++m) s += B.dib[m];
    g.dpart[r0 / NH_HALF] = s;
  }
}

// A head's first G before its last layer's passes: the visibility logit's
// cotangent, or the feature's through its normalisation, into H
__device__ __forceinline__ void nh_bwd_start(const NhArgs& a, int head, NhBufs& B, int r0, bool valid,
                                             const NhGrad& g) {
  const int wt = threadIdx.x & 127, ldh = a.ldh;
  nh_bar();
  if (head == 2) {
    for (int m = wt; m < NH_HALF; m += 128) B.hs[m * ldh] = valid ? __ldg(g.gvis + r0 + m) : 0.f;
  } else {
    const NhHead& hf = a.head[3];
    const int FD = a.feat_dim, m = wt >> 1;
    const float* f16 = g.acts + (size_t)hf.act_off[hf.n_layers - 1] * a.rows + (size_t)(r0 + m) * FD;
    const float* gf = g.gfeat + (size_t)(r0 + m) * FD;
    float ss = 0.f, dot = 0.f;
    for (int c = wt & 1; c < FD; c += 2) {
      const float fv = valid ? __ldg(f16 + c) : 0.f;
      ss = fmaf(fv, fv, ss);
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    const float den = fmaxf(sqrtf(ss + 1e-12f), 1e-6f);
    for (int c = wt & 1; c < FD; c += 2)
      if (valid) dot = fmaf(__ldg(f16 + c) / den, __ldg(gf + c), dot);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    for (int c = wt & 1; c < FD; c += 2)
      B.hs[m * ldh + c] = valid ? (__ldg(gf + c) - __ldg(f16 + c) / den * dot) / den : 0.f;
  }
  nh_bar();
}

// One K2 pass on the warpgroup's rows and its epilogue
template <int NW>
__device__ __forceinline__ void nh_bwd_pass(const NhArgs& a, const NhPass& ps, NhBufs& B, int r0,
                                            bool valid, const NhGrad& g, int& it, NhHeadsFeed& feed) {
  const int N = ps.n, rows = a.rows, ldh = a.ldh, ldx = a.ldx;
  // the ReLU masks the epilogue reads: into L2 while the products run
  if (valid && ps.epi == NH_E_DH)
    nh_prefetch_l2(g.acts + (size_t)a.head[ps.head].act_off[ps.layer - 1] * rows + (size_t)r0 * N,
                   NH_HALF * N);
  if (valid && ps.epi == NH_E_DHC)
    for (int hi = 0; hi < 2; ++hi)
      nh_prefetch_l2(g.acts + (size_t)a.head[hi].act_off[a.head[hi].n_layers - 1] * rows + (size_t)r0 * N,
                     NH_HALF * N);
  float sum[NW / 2];
  nh_pass<NW>(sum, B.xs, a.ldx, ps.src ? B.fs : B.hs, a.ldh, ps.nsl, 0, B.ring, B.full, B.cnt,
              a.stages, it, feed);
  if (ps.epi == NH_E_DX) {  // the layer's x columns into dX
    rw_each<NW>(sum, [&](int m, int c, float v0, float v1) {
      if (c < N) B.xs[m * ldx + c] += v0;
      if (c + 1 < N) B.xs[m * ldx + c + 1] += v1;
    });
    return;
  }
  if (ps.epi == NH_E_DHC) {  // G of the base head's last layer (with the sdf's) into H, the colour's into F
    const NhHead &hb = a.head[0], &hc = a.head[1];
    const uint64_t fon = nh_mask_bits<NW>(g.acts + (size_t)hb.act_off[hb.n_layers - 1] * rows, N, r0, valid ? NH_HALF : 0);
    const uint64_t con = nh_mask_bits<NW>(g.acts + (size_t)hc.act_off[hc.n_layers - 1] * rows, N, r0, valid ? NH_HALF : 0);
    nh_bar();
    nh_each_bit<NW>(sum, N, [&](int m, int k, int bit, float v) {
      B.hs[m * ldh + k] = (fon >> bit) & 1 ? v + B.gsd[m] * __ldg(a.w_sdf + k) : 0.f;
      B.fs[m * ldh + k] = (con >> bit) & 1 ? v : 0.f;
    });
    nh_bar();
    return;
  }
  // NH_E_DH: the h columns, masked by K1's saved h_{l-1}, into H
  const NhHead& h = a.head[ps.head];
  const uint64_t on = nh_mask_bits<NW>(g.acts + (size_t)h.act_off[ps.layer - 1] * rows, N, r0, valid ? NH_HALF : 0);
  nh_bar();
  nh_each_bit<NW>(sum, N, [&](int m, int k, int bit, float v) {
    B.hs[m * ldh + k] = (on >> bit) & 1 ? v : 0.f;
  });
  nh_bar();
}

// K2's dIn: the engine of K1 over K2's passes (the tile's output
// cotangents, then each head from its last layer to its first; each
// layer's G into its dW slabs before its passes), then dx from dX through
// the ladder's sin / cos, the ladder itself into g.lad for dW.
__global__ void __launch_bounds__(NH_THREADS, 1)
nh_din_kernel(const __grid_constant__ NhArgs a, const float* __restrict__ x,
              const float* __restrict__ pk, NhGrad g) {
  extern __shared__ __align__(16) float nh_smem[];
  NhBufs B(nh_smem, a);
  __syncthreads();
  NhHeadsFeed feed{&a, pk, (int)blockIdx.x, 0, 0};
  nh_prime(feed, a.stages, B.ring, B.full);
  int it = 0;
  const int wt = threadIdx.x & 127;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int r0 = tile * NH_TR + (threadIdx.x >> 7) * NH_HALF;
    const bool valid = r0 < a.rows;
    nh_bwd_prologue(a, B, r0, valid, g);
    for (int p = 0; p < a.n_pass; ++p) {
      const NhPass& ps = a.pass[p];
      if (ps.first && ps.head >= 2) nh_bwd_start(a, ps.head, B, r0, valid, g);
      if (ps.dw >= 0 && valid)
        nh_gput(ps.src ? B.fs : B.hs, a.ldh, a.dw[ps.dw].N, a.dw[ps.dw], g.gimg, a.gstride, r0);
      switch (ps.nw) {
        case 128: nh_bwd_pass<128>(a, ps, B, r0, valid, g, it, feed); break;
        case 64: nh_bwd_pass<64>(a, ps, B, r0, valid, g, it, feed); break;
        case 32: nh_bwd_pass<32>(a, ps, B, r0, valid, g, it, feed); break;
        case 16: nh_bwd_pass<16>(a, ps, B, r0, valid, g, it, feed); break;
        default: nh_bwd_pass<8>(a, ps, B, r0, valid, g, it, feed); break;
      }
    }
    nh_bar();  // dX is complete
    if (!valid) continue;
    for (int e = wt; e < NH_HALF * 3; e += 128) {
      const int m = e / 3, c = e - 3 * m;
      const float* d = B.xs + m * a.ldx;
      const float xv = __ldg(x + (size_t)(r0 + m) * 3 + c);
      float* lad = g.lad + (size_t)(r0 + m) * a.ldl;
      float s = d[c];
      lad[c] = xv;
      for (int f = 0; f < a.n_freqs; ++f) {
        float sn, cs;
        sincosf(xv * a.freq[f], &sn, &cs);
        s += (cs * d[3 + 6 * f + c] - sn * d[6 + 6 * f + c]) * a.freq[f];
        lad[3 + 6 * f + c] = sn;
        lad[6 + 6 * f + c] = cs;
      }
      g.dx[(size_t)(r0 + m) * 3 + c] = s;
    }
  }
}

// dW layer d's A sources (NhDwSrc): the ladder buffer, which K2's dIn
// writes, where the layer reads x; the saved blocks of its h (hc: feat's
// and the colour's)
__device__ __forceinline__ NhDwSrc nh_dw_src(const NhArgs& a, const NhDw& d, const float* acts,
                                             const float* lad) {
  const int rows = a.rows;
  const NhHead &hb = a.head[0], &hc = a.head[1];
  const float* feat = acts + (size_t)hb.act_off[hb.n_layers - 1] * rows;
  if (d.head == -1) return NhDwSrc{{feat, nullptr}, {d.K, 0}, 1, 0};
  if (d.head == -2) return NhDwSrc{{acts + (size_t)a.act_rgbh * rows, nullptr}, {d.K, 0}, 1, 0};
  if (d.head == -3)
    return NhDwSrc{{feat, acts + (size_t)hc.act_off[hc.n_layers - 1] * rows}, {d.K, d.K}, 2, 0};
  const NhHead& h = a.head[d.head];
  const int cx = nh_has_x(h, d.layer) ? h.c_x : 0, kh = d.K - cx;
  const float* hs = d.layer > 0 ? acts + (size_t)h.act_off[d.layer - 1] * rows : nullptr;
  if (cx == 0) return NhDwSrc{{hs, nullptr}, {kh, 0}, 1, 0};
  return NhDwSrc{{lad, hs}, {a.ldl, kh}, hs != nullptr ? 2 : 1, cx};
}

// Where dW(o, i) goes in the chunk's workspace slice (the pack's
// permutation and window undone on the embedding's columns), or -1
__device__ __forceinline__ long long nh_dw_dst(const NhArgs& a, const NhDw& d, int o, int i, float& scale) {
  scale = 1.f;
  if (d.head == -1) return a.off_w_sdf + i;
  if (d.head == -2) return a.off_w_rgb2 + (long long)o * d.K + i;
  if (d.head == -3) return a.off_w_hc + (long long)o * d.K + i;
  const NhHead& h = a.head[d.head];
  const int l = d.layer;
  if (!nh_has_x(h, l)) return h.off_w1[l] + (long long)o * d.K + i;
  if (i < h.c_x) {
    scale = nh_win(h, i);
    return h.off_w1[l] + (long long)o * h.c_x + nh_orig(h.n_freqs, i);
  }
  return h.off_w2[l] + (long long)o * (d.K - h.c_x) + (i - h.c_x);
}

// Where db of dW layer d goes in a workspace slice, or -1 (rgb1's: from
// the pairs' sums)
__device__ __forceinline__ int nh_dw_boff(const NhArgs& a, const NhDw& d) {
  return d.head == -1 ? a.off_b_sdf : d.head == -2 ? a.off_b_rgb2 : d.head == -3 ? -1
                                                   : a.head[d.head].off_b[d.layer];
}

// The pairs' sums of d rgb_h (gpair: the halves' column sums in order),
// each pair's appearance gradient dappr = gpair . W_appr, and the halves'
// d ibeta terms of an even share of the halves summed in order into
// dsum[blockIdx.x]. sm: rgb_hidden floats of shared memory.
__device__ __forceinline__ void nh_appr_pairs(const NhArgs& a, const float* __restrict__ gpart,
                                              const float* __restrict__ dpart, float* __restrict__ gpair,
                                              float* __restrict__ dappr, float* __restrict__ dsum,
                                              float* sm) {
  const int RH = a.rgb_hidden, CA = a.appr_dim, hpp = a.spp / NH_HALF, n_pairs = a.rows / a.spp;
  for (int m = blockIdx.x; m < n_pairs; m += gridDim.x) {
    for (int o = threadIdx.x; o < RH; o += NH_THREADS) {
      float s = 0.f;
      for (int h = 0; h < hpp; ++h) s += gpart[(size_t)(m * hpp + h) * RH + o];
      sm[o] = s;
      gpair[(size_t)m * RH + o] = s;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < CA; c += NH_THREADS) {
      float s = 0.f;
      for (int o = 0; o < RH; ++o) s = fmaf(sm[o], __ldg(a.w_appr + (size_t)o * CA + c), s);
      dappr[(size_t)m * CA + c] = s;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int n = a.rows / NH_HALF, per = (n + gridDim.x - 1) / gridDim.x;
    float s = 0.f;
    for (int h = blockIdx.x * per; h < min(n, (int)(blockIdx.x + 1) * per); ++h) s += dpart[h];
    dsum[blockIdx.x] = s;
  }
}

struct NhDwOut {
  const float *gpart, *dpart;
  float *ws, *gpair, *dappr, *dsum;
};

// dW of every layer over the chunks (blockIdx.y < n_chunks; blockIdx.x the
// layer's block, dw[].blk0), and in the row blockIdx.y == n_chunks the
// appearance pairs (nh_appr_pairs)
__global__ void __launch_bounds__(NH_DW_THREADS, 1)
nh_dw_kernel(const __grid_constant__ NhArgs a, const float* __restrict__ lad,
             const float* __restrict__ acts, const float* __restrict__ gimg, NhDwOut o) {
  extern __shared__ __align__(16) float nh_smem[];
  if ((int)blockIdx.y == a.n_chunks) {
    nh_appr_pairs(a, o.gpart, o.dpart, o.gpair, o.dappr, o.dsum, nh_smem);
    return;
  }
  const NhDwRing R = nh_dw_ring(nh_smem, false);
  int di = 0;
  while (di + 1 < a.n_dw && (int)blockIdx.x >= a.dw[di + 1].blk0) ++di;
  nh_dw_layer(a, di, lad, acts, gimg, o.ws + (size_t)blockIdx.y * a.n_slice, R);
}

// grads: the chunks' workspace slices summed in chunk order (d ibeta: the
// blocks' sums of nh_appr_pairs in order), then dW_appr = gpair^T appr and
// db_rgb1 = sum gpair over the pairs in order
__global__ void __launch_bounds__(HM_THREADS)
nh_reduce_kernel(const __grid_constant__ NhArgs a, const float* __restrict__ ws,
                 const float* __restrict__ gpair, const float* __restrict__ dsum,
                 const float* __restrict__ appr, float* __restrict__ grads) {
  const int e = blockIdx.x * HM_THREADS + threadIdx.x, RH = a.rgb_hidden, CA = a.appr_dim;
  const int n_pairs = a.rows / a.spp;
  float s = 0.f;
  if (e < a.n_slice) {
    if (e == a.off_dibeta)
      for (int b = 0; b < a.dw_blocks; ++b) s += dsum[b];
    else
      for (int b = 0; b < a.n_chunks; ++b) s += ws[(size_t)b * a.n_slice + e];
  } else if (e < a.n_slice + RH * CA) {
    const int k = e - a.n_slice, o = k / CA, c = k - o * CA;
    for (int m = 0; m < n_pairs; ++m)
      s = fmaf(gpair[(size_t)m * RH + o], __ldg(appr + (size_t)m * CA + c), s);
  } else if (e < a.n_slice + RH * CA + RH) {
    const int o = e - a.n_slice - RH * CA;
    for (int m = 0; m < n_pairs; ++m) s += gpair[(size_t)m * RH + o];
  } else {
    return;
  }
  grads[e] = s;
}

// ------------------------------------------------------------------ the pack

// B(k, n) of pass ps: the forward's W_l[n][k] (k over [the ladder's
// positions, padded to 16 nxs | h]); K2's W_l[k][n] (its x columns at the
// ladder's positions, or its h columns), W_hc for rgb1 / d hc, W_rgb2. The
// embedding's columns carry the head's window. Zero past the ends.
__device__ __forceinline__ float nh_pack_value(const NhArgs& a, const NhPass& ps, int k, int n) {
  const int W = a.width, RH = a.rgb_hidden;
  if (ps.epi == NH_E_RGB1) return n < RH && k < W ? __ldg(a.w_hc + (size_t)n * W + k) : 0.f;
  if (ps.epi == NH_E_RGB2) return n < NH_RGB && k < RH ? __ldg(a.w_rgb2 + (size_t)n * RH + k) : 0.f;
  if (ps.epi == NH_E_DHC) return k < RH && n < W ? __ldg(a.w_hc + (size_t)k * W + n) : 0.f;
  const NhHead& h = a.head[ps.head];
  const int l = ps.layer, N = h.out_dim[l], K = h.in_dim[l];
  const int cx = nh_has_x(h, l) ? h.c_x : 0, kh = K - cx;
  int o, p = -1, j = -1;  // W_l's row; a ladder position or an h column
  if (ps.epi == NH_E_DX) {
    o = k;
    p = n;
  } else if (ps.epi == NH_E_DH) {
    o = k;
    j = n;
  } else {
    o = n;
    if (k < NH_KS * ps.nxs) p = k;
    else j = k - NH_KS * ps.nxs;
  }
  if (o >= N) return 0.f;
  if (p >= 0) return p < cx ? __ldg(h.w1[l] + (size_t)o * cx + nh_orig(h.n_freqs, p)) * nh_win(h, p) : 0.f;
  if (j >= kh) return 0.f;
  return cx > 0 ? __ldg(h.w2[l] + (size_t)o * kh + j) : __ldg(h.w1[l] + (size_t)o * K + j);
}

// Every pass's weights split into tf32 hi and lo, in the slabs the engine
// streams (pk, img_total floats); with abias, also rgb1's bias row of every
// pair, b_rgb1 + W_appr . appr (K1).
__global__ void __launch_bounds__(HM_THREADS)
nh_pack_kernel(const __grid_constant__ NhArgs a, const float* __restrict__ appr,
               float* __restrict__ pk, float* __restrict__ abias) {
  const long long n_ab = abias != nullptr ? (long long)(a.rows / a.spp) * a.rgb_hidden : 0;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < a.img_total + n_ab;
       e += (long long)gridDim.x * blockDim.x) {
    if (e >= a.img_total) {
      const int k = (int)(e - a.img_total), m = k / a.rgb_hidden, oc = k - m * a.rgb_hidden;
      float s = __ldg(a.b_rgb1 + oc);
      for (int c = 0; c < a.appr_dim; ++c)
        s = fmaf(__ldg(a.w_appr + (size_t)oc * a.appr_dim + c), __ldg(appr + (size_t)m * a.appr_dim + c), s);
      abias[k] = s;
      continue;
    }
    int lo_p = 0, hi_p = a.n_pass - 1;  // the last pass whose slabs start at or before e
    while (lo_p < hi_p) {
      const int mid = (lo_p + hi_p + 1) >> 1;
      if (a.pass[mid].img <= e) lo_p = mid;
      else hi_p = mid - 1;
    }
    const NhPass& ps = a.pass[lo_p];
    int k, n;
    bool lo;
    nh_slab_at<NH_KS>((int)(e - ps.img), ps.nw, k, n, lo);
    uint32_t hv, lv;
    rw_split(nh_pack_value(a, ps, k, n), hv, lv);
    pk[e] = __uint_as_float(lo ? lv : hv);
  }
}

// ------------------------------------------------------------------ launch

static size_t nh_engine_smem(const NhArgs& a) {
  return sizeof(float) * (32 + (size_t)a.stages * NH_SLAB + (size_t)NH_TR * (a.ldx + 2 * a.ldh) +
                          2 * NH_TR);
}

static int nh_round16(int n) { return (n + NH_KS - 1) / NH_KS * NH_KS; }

// The shapes the kernels assume: each head a chain of layers over its
// embedding (skip layers re-reading it), whole halves of 64 points within
// one pair's samples, every width within the engine's buffers, and the
// pass and dW tables of ops/field_kernel.py within the packed weights and
// the G image.
static int nh_check(const NhArgs& a, bool bwd) {
  const int bad = (int)cudaErrorInvalidValue;
  if (a.spp % NH_HALF != 0 || a.rows < a.spp || a.rows % a.spp != 0 ||
      a.n_tiles != (a.rows + NH_TR - 1) / NH_TR || a.pc < NH_RS || a.pc % NH_RS != 0 ||
      a.n_chunks != (a.rows + a.pc - 1) / a.pc || a.n_freqs < 0 || a.n_freqs > NH_MAX_FREQS)
    return bad;
  if (a.width > NH_NMAX || a.rgb_hidden > NH_NMAX || a.feat_dim > 32 || a.stages < 2 || a.stages > 3 ||
      a.ldh < a.width || a.ldh < a.rgb_hidden || a.ldh % 8 != 4 || a.ldx % 8 != 4 ||
      nh_engine_smem(a) > NH_SMEM)
    return bad;
  for (int i = 0; i < NH_HEADS; ++i) {
    const NhHead& h = a.head[i];
    if (h.n_layers < 2 || h.n_layers > NH_MAX_LAYERS || h.n_freqs < 0 || h.n_freqs > a.n_freqs ||
        h.c_x != 3 * (2 * h.n_freqs + 1) || nh_round16(h.c_x) > a.ldx || (h.skip_mask & 1))
      return bad;
    for (int l = 0; l < h.n_layers; ++l) {
      const bool hx = nh_has_x(h, l);
      const int want = (l == 0 ? 0 : h.out_dim[l - 1]) + (hx ? h.c_x : 0);
      if (h.in_dim[l] != want || h.out_dim[l] < 1 || h.out_dim[l] > NH_NMAX ||
          ((l > 0 && hx) != (h.w2[l] != nullptr)))
        return bad;
    }
  }
  if (a.head[0].out_dim[a.head[0].n_layers - 1] != a.width ||
      a.head[1].out_dim[a.head[1].n_layers - 1] != a.width ||
      a.head[2].out_dim[a.head[2].n_layers - 1] != 1 ||
      a.head[3].out_dim[a.head[3].n_layers - 1] != a.feat_dim)
    return bad;
  if (a.n_pass < 1 || a.n_pass > NH_MAX_PASSES) return bad;
  int img = 0;
  for (int p = 0; p < a.n_pass; ++p) {
    const NhPass& ps = a.pass[p];
    const bool k2 = ps.epi >= NH_E_DHC;
    if (k2 != bwd || ps.img != img || !nh_wgmma_width(ps.nw) || ps.n < 1 || ps.n > ps.nw ||
        ps.nsl < 1 || ps.nxs > ps.nsl || NH_KS * (ps.nsl - ps.nxs) > NH_NMAX || NH_KS * ps.nxs > a.ldx ||
        ps.head >= NH_HEADS || (ps.head < 0 && ps.epi != NH_E_RGB1 && ps.epi != NH_E_RGB2 &&
                                ps.epi != NH_E_DHC) ||
        (ps.head >= 0 && ps.layer >= a.head[ps.head].n_layers) || ps.dw >= a.n_dw)
      return bad;
    img += ps.nsl * 32 * ps.nw;
  }
  if (img != a.img_total) return bad;
  if (!bwd) return 0;
  if (a.n_dw < 3 || a.n_dw > NH_MAX_DW || a.dw_sdf >= a.n_dw || a.dw_rgb2 >= a.n_dw || a.dw_rgb1 >= a.n_dw)
    return bad;
  int goff = 0, blk = 0;
  for (int i = 0; i < a.n_dw; ++i) {
    const NhDw& d = a.dw[i];
    if (d.goff != goff || d.blk0 != blk || !nh_wgmma_width(d.nwo) || d.N < 1 || d.N > d.nwo || d.K < 1)
      return bad;
    goff += 32 * d.nwo;
    blk += (d.K + NH_DW_M - 1) / NH_DW_M;
  }
  // dW's A rows arrive by TMA bulk copies: 16-byte rows
  if (a.ldl % 4 != 0 || a.ldl < 3 + 6 * a.n_freqs || a.width % 4 != 0 || a.rgb_hidden % 4 != 0)
    return bad;
  for (int i = 0; i < NH_HEADS; ++i)
    for (int l = 0; l + 1 < a.head[i].n_layers; ++l)
      if (a.head[i].out_dim[l] % 4 != 0) return bad;
  return goff == a.gstride && blk == a.dw_blocks ? 0 : bad;
}

static int nh_pack(const NhArgs& a, const float* appr, float* pk, float* abias, cudaStream_t st) {
  const long long total = a.img_total + (abias != nullptr ? (long long)(a.rows / a.spp) * a.rgb_hidden : 0);
  const long long blocks = std::min<long long>((total + HM_THREADS - 1) / HM_THREADS, 4096);
  nh_pack_kernel<<<(unsigned)blocks, HM_THREADS, 0, st>>>(a, appr, pk, abias);
  return (int)cudaGetLastError();
}

// K2's scratch, floats: the split transposed weights, the G image, the
// rows' ladder, the chunks' workspace slices, the halves' g_rgbh sums and
// d ibeta terms, the pairs' sums, the dW blocks' d ibeta sums.
static size_t nh_bwd_scratch(const NhArgs& a) {
  const size_t halves = a.rows / NH_HALF, groups = (size_t)a.n_tiles * (NH_TR / NH_RS);
  return (size_t)a.img_total + groups * a.gstride + (size_t)a.n_chunks * a.n_slice +
         halves * (a.rgb_hidden + 1) + (size_t)(a.rows / a.spp) * a.rgb_hidden + a.dw_blocks +
         (size_t)a.rows * a.ldl;
}

extern "C" {

// The launch layout of these args (K1's passes, or K2's with bwd): sizes[0]
// the engine's shared memory per block (bytes), [1] its blocks, [2] dW's
// shared memory, [3] K2's scratch floats, [4] sizeof(NhArgs). Returns the
// error of nh_check, or 0.
int lab4d_nerf_heads_layout(const NhArgs* args, int bwd, long long* sizes) {
  const NhArgs& a = *args;
  const int err = nh_check(a, bwd != 0);
  const int n_sm = nh_sms();
  sizes[0] = (long long)nh_engine_smem(a);
  sizes[1] = std::min(a.n_tiles, n_sm);
  sizes[2] = (long long)NH_DW_SMEM;
  sizes[3] = bwd ? (long long)nh_bwd_scratch(a) : 0;
  sizes[4] = (long long)sizeof(NhArgs);
  return err;
}

// density (rows, 1), rgb (rows, 3), vis (rows, 1), feat (rows, feat_dim) of
// the points x (rows, 3); appr: (rows / spp, appr_dim) appearance rows.
// wpk: img_total + (rows / spp) * rgb_hidden floats of scratch for the
// split weights and rgb1's bias rows. acts: null, or (act_total * rows)
// floats for every layer output (K2's input). Two launches: the split,
// then the engine. Returns the error, or 0; *n_launches: the launches made.
int lab4d_nerf_heads_fwd(const NhArgs* args, const float* x, const float* appr, float* wpk,
                         float* density, float* rgb, float* vis, float* feat, float* acts,
                         int* n_launches, void* stream) {
  const NhArgs& a = *args;
  int err = nh_check(a, false);
  if (err) return err;
  const size_t smem = nh_engine_smem(a);
  const int n_sm = nh_sms();
  if (n_sm < 1) return (int)cudaErrorInvalidDevice;
  if ((err = nh_set_smem((const void*)nh_fwd_kernel, smem))) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* abias = wpk + a.img_total;
  if ((err = nh_pack(a, appr, wpk, abias, st))) return err;
  const NhOut o{abias, density, rgb, vis, feat, acts};
  nh_fwd_kernel<<<std::min(a.n_tiles, n_sm), NH_THREADS, smem, st>>>(a, x, wpk, o);
  if ((err = (int)cudaGetLastError())) return err;
  if (n_launches != nullptr) *n_launches = 2;
  return 0;
}

size_t lab4d_nerf_heads_bwd_scratch(const NhArgs* args) { return nh_bwd_scratch(*args); }

// The VJP for the cotangents gd (rows, 1), grgb (rows, 3), gvis (rows, 1),
// gfeat (rows, feat_dim), from K1's saved layer outputs acts and its rgb:
// dx (rows, 3); grads: the reduced workspace slice (n_slice floats, d ibeta
// among them), then dW_appr (rgb_hidden, appr_dim) and db_rgb1
// (rgb_hidden,); dappr (rows / spp, appr_dim). scratch: nh_bwd_scratch
// floats. events / kinds (may be null): a CUDA event recorded before the
// first launch and after each launch, and each launch's kind (7 weight
// split, 3 dIn engine, 2 dW and the appearance pairs, 6 reduction), for as
// many launches as n_events allows. Returns the error, or 0;
// *n_launches: the launches made (4).
int lab4d_nerf_heads_bwd(const NhArgs* args, const float* x, const float* appr, const float* acts,
                         const float* rgb, const float* gd, const float* grgb, const float* gvis,
                         const float* gfeat, float* dx, float* grads, float* dappr, float* scratch,
                         void** events, int* kinds, int n_events, int* n_launches, void* stream) {
  const NhArgs& a = *args;
  int err = nh_check(a, true);
  if (err) return err;
  const size_t smem = nh_engine_smem(a);
  const int n_sm = nh_sms();
  if (n_sm < 1) return (int)cudaErrorInvalidDevice;
  if ((err = nh_set_smem((const void*)nh_din_kernel, smem)) ||
      (err = nh_set_smem((const void*)nh_dw_kernel, NH_DW_SMEM)))
    return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t halves = a.rows / NH_HALF, groups = (size_t)a.n_tiles * (NH_TR / NH_RS);
  float* pk = scratch;  // the TMA unit's sources first: 16-byte aligned
  float* gimg = pk + a.img_total;
  float* lad = gimg + groups * a.gstride;
  float* ws = lad + (size_t)a.rows * a.ldl;
  float* gpart = ws + (size_t)a.n_chunks * a.n_slice;
  float* dpart = gpart + halves * a.rgb_hidden;
  float* gpair = dpart + halves;
  float* dsum = gpair + (size_t)(a.rows / a.spp) * a.rgb_hidden;
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
  if ((err = nh_pack(a, appr, pk, nullptr, st)) || (err = done(7))) return err;
  const NhGrad g{acts, rgb, gd, grgb, gvis, gfeat, dx, gimg, gpart, dpart, lad};
  nh_din_kernel<<<std::min(a.n_tiles, n_sm), NH_THREADS, smem, st>>>(a, x, pk, g);
  if ((err = done(3))) return err;
  const NhDwOut o{gpart, dpart, ws, gpair, dappr, dsum};
  nh_dw_kernel<<<dim3(a.dw_blocks, a.n_chunks + 1), NH_DW_THREADS, NH_DW_SMEM, st>>>(a, lad, acts, gimg, o);
  if ((err = done(2))) return err;
  const int n_out = a.n_slice + a.rgb_hidden * (a.appr_dim + 1);
  nh_reduce_kernel<<<(n_out + HM_THREADS - 1) / HM_THREADS, HM_THREADS, 0, st>>>(a, ws, gpair, dsum,
                                                                                 appr, grads);
  if ((err = done(6))) return err;
  if (n_launches != nullptr) *n_launches = n;
  return 0;
}

// sizeof(NhArgs), for the caller's check of its copy of the layout
int lab4d_nerf_heads_args_size() { return (int)sizeof(NhArgs); }

const char* lab4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
