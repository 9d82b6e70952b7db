// K1 and K2: every per-point head of the FeatureNeRF field in one pass,
// forward and backward, hand-written for Hopper (sm_90a).
//
// K1 replaces lab4d_tpu/ops/field_kernel.py:_run_fwd (Pallas kernel
// _fwd_kernel / _forward_tile); K2 replaces _run_bwd (_bwd_kernel /
// _backward_tile). Per tile of TR canonical points, one block computes:
//   base MLP (Fourier embedding, ReLU layers, skip) -> feat -> sdf head ->
//     VolSDF density (Laplace CDF, expm1, times ibeta);
//   colour MLP -> + feat = hc -> rgb1 (with the pair's appearance row as a
//     bias row) -> ReLU -> rgb2 -> sigmoid;
//   visibility MLP -> logit; feature MLP -> 16 channels -> L2 normalisation.
// The heads read the shared frequency ladder (the colour ladder; the other
// embeddings use its first n_freqs), the base and colour embeddings carry
// their annealing windows. K2 recomputes the forward per tile and backprops
// every head: dx through the Fourier embeddings, every dW / db, d ibeta, and
// the appearance rows' gradient; the windows get none (as in the JAX VJP).
//
// Weights come in the split layout of ops/field_kernel.py:split_nets (the
// torch.nn.Linear (out, in) layout, a skip layer as [W_x | W_h] column
// blocks, rgb1 as W_hc and W_appr), read through WSegs, so the [X, h]
// operand of a skip layer is never concatenated.
//
// What bounds it on the card: at the flagship step (262,144 points, W 128)
// the heads cost 234,688 multiply-adds per point, 123 GFLOP for K1 (1.84 ms
// at the H100's 67 TFLOP/s of fp32 FMA) and about three times that for K2;
// only the points, the cotangents and the outputs cross device memory
// (~25 MB), so both are bound by operations. What the design does about it:
// the layers are the row-tiled GEMMs of mlp_tiles.cuh (activations
// transposed in shared memory, register-staged k-chunks of the weights, 4 x 4
// FMA tiles per thread), chained head after head on the same tile, so no
// hidden feature ever reaches device memory. The ~0.95 MB of weights do not
// fit in shared memory; they are streamed per layer from L2, which holds
// them all. K2 keeps only what its backward needs at once: the base MLP's
// activations while the colour and rgb heads run, then the colour MLP
// recomputed in the base buffers, then visibility and feature in the same
// buffers; the embeddings are rebuilt from x where needed. That caps the
// backward tile at 32 points (~200 KB of shared memory, one block per SM).
//
// Reductions across tiles: each block of K2's grid-stride launch adds its
// tiles' weight gradients and d ibeta to its own workspace slice (first tile
// stores, later tiles add), and tile_mlp_reduce_kernel sums the slices in
// block order. Each tile writes the column sums of d rgb_h (the gradient of
// its pair's rgb1 bias row); a one-block kernel sums them per pair in tile
// order and forms d appearance, dW_appr and db_rgb1. No float atomics: the
// result is the same from run to run. Tiles divide the samples of a pair,
// so no tile straddles two appearance rows. fp32 FMA throughout, precise
// sinf / cosf / expf / expm1f (no fast math).

#include "mlp_tiles.cuh"

#define NH_MAX_LAYERS 8
#define NH_RGB 3
#define NH_HEADS 4  // base, colour, visibility, feature

// One ReLU MLP head in the split layout; the *_off fields are offsets of its
// gradients in a workspace slice.
struct NhHead {
  int n_layers, skip_mask, n_freqs, c_x;
  int in_dim[NH_MAX_LAYERS];  // full input width (c_x + h on a skip layer)
  int out_dim[NH_MAX_LAYERS];
  int k1[NH_MAX_LAYERS];  // columns of w1: c_x on a skip layer, in_dim otherwise
  int off_w1[NH_MAX_LAYERS], off_w2[NH_MAX_LAYERS], off_b[NH_MAX_LAYERS];
  const float* window;  // (n_freqs,) annealing window or null
  const float* w1[NH_MAX_LAYERS];
  const float* w2[NH_MAX_LAYERS];  // the h columns of a skip layer, else null
  const float* b[NH_MAX_LAYERS];
};

struct NhArgs {
  NhHead head[NH_HEADS];
  int rows, spp, tr, ts, stage_ld;
  int width;       // output width of the base and colour MLPs (hc)
  int rgb_hidden;  // rgb1 outputs
  int appr_dim;    // appearance channels
  int feat_dim;    // feature channels
  int max_cx;      // widest embedding
  int g_width;     // widest layer output (gradient buffers)
  int h_total;     // most floats per row that one head's layer outputs take
  int off_w_sdf, off_b_sdf, off_w_hc, off_w_rgb2, off_b_rgb2, off_dibeta;
  int n_slice;  // floats of one workspace slice
  float freq[TM_MAX_FREQS];
  const float* w_sdf;   // (1, width)
  const float* b_sdf;   // (1,)
  const float* w_hc;    // (rgb_hidden, width)
  const float* w_appr;  // (rgb_hidden, appr_dim)
  const float* b_rgb1;  // (rgb_hidden,)
  const float* w_rgb2;  // (3, rgb_hidden)
  const float* b_rgb2;  // (3,)
  const float* ibeta;   // (1,) on the device
};

// X^T of one head's embedding [x, sin (F x 3), cos (F x 3)] (sin / cos times
// the window) for the rows [row0, row0 + tr).
__device__ void nh_embed(float* xs, const float* __restrict__ x, int row0, const NhArgs& a,
                         const NhHead& h) {
  const int tr = a.tr, C = 3, FC = h.n_freqs * 3;
  for (int idx = threadIdx.x; idx < h.c_x * tr; idx += blockDim.x) {
    const int k = idx / tr, r = idx - k * tr;
    const int c = k < C ? k : (k - C) % C;
    const float xv = __ldg(x + (size_t)(row0 + r) * C + c);
    float v = xv;
    if (k >= C) {
      const int f = ((k - C) % FC) / C;
      const float ang = xv * a.freq[f];
      v = k < C + FC ? sinf(ang) : cosf(ang);
      if (h.window != nullptr) v *= __ldg(h.window + f);
    }
    xs[k * a.ts + r] = v;
  }
}

// dx[c][r] += the gradient of x through head h's embedding, from dX^T in
// dxs; then dxs is zeroed for the next head.
__device__ void nh_fold_dx(float* dxa, float* dxs, const float* __restrict__ x, int row0,
                           const NhArgs& a, const NhHead& h) {
  const int tr = a.tr, ts = a.ts, C = 3, FC = h.n_freqs * 3;
  __syncthreads();
  for (int idx = threadIdx.x; idx < tr * C; idx += blockDim.x) {
    const int r = idx / C, c = idx - r * C;
    float s = dxs[c * ts + r];
    const float xv = __ldg(x + (size_t)(row0 + r) * C + c);
    for (int f = 0; f < h.n_freqs; ++f) {
      const float ang = xv * a.freq[f];
      const float win = h.window != nullptr ? __ldg(h.window + f) : 1.f;
      const float gs = dxs[(C + f * C + c) * ts + r] * win;
      const float gc = dxs[(C + FC + f * C + c) * ts + r] * win;
      s += (cosf(ang) * gs - sinf(ang) * gc) * a.freq[f];
    }
    dxa[c * ts + r] += s;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < h.c_x * ts; idx += blockDim.x) dxs[idx] = 0.f;
  __syncthreads();
}

__device__ __forceinline__ KSegs nh_layer_input(const NhHead& h, int l, const float* xs,
                                                const float* hprev, int ts) {
  if (l == 0) return KSegs{xs, h.c_x, xs, 0, ts};
  if ((h.skip_mask >> l) & 1) return KSegs{xs, h.c_x, hprev, h.in_dim[l] - h.c_x, ts};
  return KSegs{hprev, h.in_dim[l], hprev, 0, ts};
}

__device__ __forceinline__ WSegs nh_weight(const NhHead& h, int l) {
  return WSegs{h.w1[l], h.k1[l], h.w2[l]};
}

// Layers [0, n_run) of head h on the tile (X^T in xs): layer l < n - 1
// writes its ReLU output to hid[l]; the last layer hands its output to epi.
template <typename Epi>
__device__ void nh_head_fwd(const NhArgs& a, const NhHead& h, const float* xs, float* const* hid,
                            int n_run, float* as, Epi epi) {
  for (int l = 0; l < n_run; ++l) {
    const KSegs in = nh_layer_input(h, l, xs, l > 0 ? hid[l - 1] : xs, a.ts);
    if (l < h.n_layers - 1)
      tm_gemm<true>(nh_weight(h, l), h.out_dim[l], h.in_dim[l], in, a.tr, as, a.stage_ld,
                    TmEpiHidden{hid[l], h.b[l], a.ts});
    else
      tm_gemm<true>(nh_weight(h, l), h.out_dim[l], h.in_dim[l], in, a.tr, as, a.stage_ld, epi);
  }
}

// Backward of head h from the gradient of its last layer's output in g0
// (ReLU masks of the final activation already applied): every dW / db into
// the block's workspace slice, dX^T added to dxs. hid: the layer outputs of
// the recomputed forward.
__device__ void nh_head_bwd(const NhArgs& a, const NhHead& h, const float* xs, float* const* hid,
                            float* g0, float* g1, float* dxs, float* slice, bool first,
                            float* as) {
  const int ts = a.ts, tr = a.tr;
  float* gb[2] = {g0, g1};
  int cur = 0;
  __syncthreads();  // g0, xs and hid are complete
  for (int l = h.n_layers - 1; l >= 0; --l) {
    const float* hprev = l > 0 ? hid[l - 1] : xs;
    const bool skip = l > 0 && ((h.skip_mask >> l) & 1);
    const int n_o = h.out_dim[l];
    if (skip) {
      const int kh = h.in_dim[l] - h.c_x;
      tm_weight_grads(slice + h.off_w1[l], slice + h.off_b[l], gb[cur], n_o,
                      KSegs{xs, h.c_x, xs, 0, ts}, h.c_x, tr, first);
      tm_weight_grads(slice + h.off_w2[l], nullptr, gb[cur], n_o, KSegs{hprev, kh, hprev, 0, ts},
                      kh, tr, first);
    } else {
      tm_weight_grads(slice + h.off_w1[l], slice + h.off_b[l], gb[cur], n_o,
                      nh_layer_input(h, l, xs, hprev, ts), h.in_dim[l], tr, first);
    }
    const bool has_x = l == 0 || skip;
    tm_gemm<false>(nh_weight(h, l), h.in_dim[l], n_o, KSegs{gb[cur], n_o, gb[cur], 0, ts}, tr, as,
                   a.stage_ld, TmEpiDin{dxs, gb[cur ^ 1], hprev, has_x ? h.c_x : 0, ts});
    cur ^= 1;
  }
}

// The rgb1 bias row of a pair: b_rgb1 + W_appr . appr_row.
__device__ void nh_rgb1_bias(float* abias, const NhArgs& a, const float* __restrict__ appr_row) {
  for (int o = threadIdx.x; o < a.rgb_hidden; o += blockDim.x) {
    float s = __ldg(a.b_rgb1 + o);
    for (int c = 0; c < a.appr_dim; ++c)
      s = fmaf(__ldg(a.w_appr + (size_t)o * a.appr_dim + c), __ldg(appr_row + c), s);
    abias[o] = s;
  }
}

__device__ __forceinline__ float nh_sdf(const NhArgs& a, const float* feat, int r) {
  float s = __ldg(a.b_sdf);
  for (int k = 0; k < a.width; ++k) s = fmaf(__ldg(a.w_sdf + k), feat[k * a.ts + r], s);
  return s;
}

__device__ __forceinline__ float nh_sign(float s) { return s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f); }

__device__ __forceinline__ float nh_sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

struct NhEpiAddRelu {  // dst[o][r] = add[o][r] + relu(v + b[o]); dst may be add
  float* dst;
  const float* add;
  const float* b;
  int ts;
  __device__ __forceinline__ void operator()(int o, int r, float v) const {
    dst[o * ts + r] = add[o * ts + r] + fmaxf(v + __ldg(b + o), 0.f);
  }
};

struct NhEpiReluSmemBias {  // h[o][r] = relu(v + bias[o]), bias in shared memory
  float* h;
  const float* bias;
  int ts;
  __device__ __forceinline__ void operator()(int o, int r, float v) const {
    h[o * ts + r] = fmaxf(v + bias[o], 0.f);
  }
};

struct NhEpiStore {  // dst[o][r] = v + (b ? b[o] : 0)
  float* dst;
  const float* b;
  int ts;
  __device__ __forceinline__ void operator()(int o, int r, float v) const {
    dst[o * ts + r] = b != nullptr ? v + __ldg(b + o) : v;
  }
};

struct NhEpiSigmoidOut {  // rgb[row0 + r][o] = sigmoid(v + b[o])
  float* y;
  const float* b;
  int row0;
  __device__ __forceinline__ void operator()(int o, int r, float v) const {
    y[(size_t)(row0 + r) * NH_RGB + o] = nh_sigmoid(v + __ldg(b + o));
  }
};

struct NhEpiSigmoidGrad {  // g[o][r] = d rgb through the sigmoid, from the cotangent of rgb
  float* g;
  const float* b;
  const float* grgb;
  int row0, ts;
  __device__ __forceinline__ void operator()(int o, int r, float v) const {
    const float s = nh_sigmoid(v + __ldg(b + o));
    g[o * ts + r] = __ldg(grgb + (size_t)(row0 + r) * NH_RGB + o) * s * (1.f - s);
  }
};

// per-layer output buffers of head h: consecutive regions of base
__device__ __forceinline__ void nh_stack(float** hid, const NhHead& h, float* base, int ts) {
  for (int l = 0; l < h.n_layers; ++l) {
    hid[l] = base;
    base += (size_t)h.out_dim[l] * ts;
  }
}

// ------------------------------------------------------------------ K1

// smem: X^T (max_cx), two layer buffers (g_width), hc (width), the rgb1 bias
// row, the weight staging buffer.
__global__ void __launch_bounds__(TM_THREADS, 2)
nerf_heads_fwd_kernel(const __grid_constant__ NhArgs a, const float* __restrict__ x,
                      const float* __restrict__ appr, float* __restrict__ density,
                      float* __restrict__ rgb, float* __restrict__ vis, float* __restrict__ feat) {
  extern __shared__ __align__(16) float smem[];
  const int tr = a.tr, ts = a.ts;
  const NhHead &hb = a.head[0], &hcol = a.head[1], &hv = a.head[2], &hf = a.head[3];
  float* xs = smem;
  float* H0 = xs + (size_t)a.max_cx * ts;
  float* H1 = H0 + (size_t)a.g_width * ts;
  float* F = H1 + (size_t)a.g_width * ts;
  float* abias = F + (size_t)a.width * ts;
  float* as = abias + tm_round4(a.rgb_hidden);
  float* pp[NH_MAX_LAYERS];  // ping-pong layer buffers
  for (int l = 0; l < NH_MAX_LAYERS; ++l) pp[l] = (l & 1) ? H1 : H0;

  const int ntiles = a.rows / tr;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * tr;
    __syncthreads();  // the previous tile is done with every buffer
    nh_rgb1_bias(abias, a, appr + (size_t)(row0 / a.spp) * a.appr_dim);
    // base MLP -> feat (final ReLU) in F; density from the sdf head
    nh_embed(xs, x, row0, a, hb);
    nh_head_fwd(a, hb, xs, pp, hb.n_layers, as, TmEpiHidden{F, hb.b[hb.n_layers - 1], ts});
    if (threadIdx.x < tr) {
      const int r = threadIdx.x;
      const float s = nh_sdf(a, F, r);
      const float ib = __ldg(a.ibeta);
      density[row0 + r] = (0.5f + 0.5f * nh_sign(s) * expm1f(-fabsf(s) * ib)) * ib;
    }
    // colour MLP; hc = feat + its output, in place in F
    nh_embed(xs, x, row0, a, hcol);
    nh_head_fwd(a, hcol, xs, pp, hcol.n_layers, as,
                NhEpiAddRelu{F, F, hcol.b[hcol.n_layers - 1], ts});
    // rgb head
    tm_gemm<true>(a.w_hc, a.rgb_hidden, a.width, KSegs{F, a.width, F, 0, ts}, tr, as, a.stage_ld,
                  NhEpiReluSmemBias{H0, abias, ts});
    tm_gemm<true>(a.w_rgb2, NH_RGB, a.rgb_hidden, KSegs{H0, a.rgb_hidden, H0, 0, ts}, tr, as,
                  a.stage_ld, NhEpiSigmoidOut{rgb, a.b_rgb2, row0});
    // visibility logit
    nh_embed(xs, x, row0, a, hv);
    nh_head_fwd(a, hv, xs, pp, hv.n_layers, as,
                TmEpiOut{vis, hv.b[hv.n_layers - 1], row0, tr, 1, 0});
    // feature, then its L2 normalisation per point
    nh_embed(xs, x, row0, a, hf);
    float* f16 = pp[hf.n_layers - 1];
    nh_head_fwd(a, hf, xs, pp, hf.n_layers, as, NhEpiStore{f16, hf.b[hf.n_layers - 1], ts});
    if (threadIdx.x < tr) {
      const int r = threadIdx.x;
      float ss = 0.f;
      for (int j = 0; j < a.feat_dim; ++j) ss = fmaf(f16[j * ts + r], f16[j * ts + r], ss);
      const float denom = fmaxf(sqrtf(ss + 1e-12f), 1e-6f);
      for (int j = 0; j < a.feat_dim; ++j)
        feat[(size_t)(row0 + r) * a.feat_dim + j] = f16[j * ts + r] / denom;
    }
  }
}

// ------------------------------------------------------------------ K2

// smem: X^T and dX^T (max_cx each), the dx accumulator (4 rows), the layer
// outputs of one head (h_total), two gradient buffers (g_width), HC (width:
// hc, later d hc), S (4 rows: g_sdf, then d rgb), the rgb1 bias row, the
// weight staging buffer. ws: gridDim.x slices of n_slice floats; gsum_ws:
// rgb_hidden floats per tile.
__global__ void __launch_bounds__(TM_THREADS, 1)
nerf_heads_bwd_kernel(const __grid_constant__ NhArgs a, const float* __restrict__ x,
                      const float* __restrict__ appr, const float* __restrict__ gd,
                      const float* __restrict__ grgb, const float* __restrict__ gvis,
                      const float* __restrict__ gfeat, float* __restrict__ dx,
                      float* __restrict__ ws, float* __restrict__ gsum_ws) {
  extern __shared__ __align__(16) float smem[];
  const int tr = a.tr, ts = a.ts, W = a.width, RH = a.rgb_hidden;
  const NhHead &hb = a.head[0], &hcol = a.head[1], &hv = a.head[2], &hf = a.head[3];
  float* xs = smem;
  float* dxs = xs + (size_t)a.max_cx * ts;
  float* dxa = dxs + (size_t)a.max_cx * ts;
  float* H = dxa + (size_t)4 * ts;
  float* G0 = H + (size_t)a.h_total * ts;
  float* G1 = G0 + (size_t)a.g_width * ts;
  float* HC = G1 + (size_t)a.g_width * ts;
  float* S = HC + (size_t)W * ts;
  float* abias = S + (size_t)4 * ts;
  float* as = abias + tm_round4(RH);
  float* slice = ws + (size_t)blockIdx.x * a.n_slice;
  float* hid[NH_MAX_LAYERS];

  const int ntiles = a.rows / tr;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int row0 = tile * tr;
    __syncthreads();  // the previous tile is done with every buffer
    for (int idx = threadIdx.x; idx < (a.max_cx + 4) * ts; idx += blockDim.x) dxs[idx] = 0.f;
    nh_rgb1_bias(abias, a, appr + (size_t)(row0 / a.spp) * a.appr_dim);

    // base forward, keeping every layer output; feat = the last
    nh_stack(hid, hb, H, ts);
    float* featb = hid[hb.n_layers - 1];
    nh_embed(xs, x, row0, a, hb);
    nh_head_fwd(a, hb, xs, hid, hb.n_layers, as, TmEpiHidden{featb, hb.b[hb.n_layers - 1], ts});
    // sdf: its gradient from the density's (S row 0) and each point's share
    // of d ibeta (S row 1, summed below)
    if (threadIdx.x < tr) {
      const int r = threadIdx.x;
      const float s = nh_sdf(a, featb, r);
      const float ib = __ldg(a.ibeta);
      const float e = expf(-fabsf(s) * ib);
      const float g = __ldg(gd + row0 + r);
      S[r] = g * (-0.5f * ib * ib * e);
      S[ts + r] = g * (0.5f + 0.5f * nh_sign(s) * expm1f(-fabsf(s) * ib) - 0.5f * ib * s * e);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int r = 0; r < tr; ++r) t += S[ts + r];
      slice[a.off_dibeta] = first ? t : slice[a.off_dibeta] + t;
    }

    // colour forward (layers in G0 / G1); hc = feat + its output, in HC
    float* pp[NH_MAX_LAYERS];
    for (int l = 0; l < NH_MAX_LAYERS; ++l) pp[l] = (l & 1) ? G1 : G0;
    nh_embed(xs, x, row0, a, hcol);
    nh_head_fwd(a, hcol, xs, pp, hcol.n_layers, as,
                NhEpiAddRelu{HC, featb, hcol.b[hcol.n_layers - 1], ts});
    // rgb forward: rgb_h in G0; the gradient through the sigmoid in S rows 1..3
    tm_gemm<true>(a.w_hc, RH, W, KSegs{HC, W, HC, 0, ts}, tr, as, a.stage_ld,
                  NhEpiReluSmemBias{G0, abias, ts});
    tm_gemm<true>(a.w_rgb2, NH_RGB, RH, KSegs{G0, RH, G0, 0, ts}, tr, as, a.stage_ld,
                  NhEpiSigmoidGrad{S + ts, a.b_rgb2, grgb, row0, ts});
    // rgb2 backward; d rgb_h (masked by its ReLU) in G1
    tm_weight_grads(slice + a.off_w_rgb2, slice + a.off_b_rgb2, S + ts, NH_RGB,
                    KSegs{G0, RH, G0, 0, ts}, RH, tr, first);
    tm_gemm<false>(a.w_rgb2, RH, NH_RGB, KSegs{S + ts, NH_RGB, S + ts, 0, ts}, tr, as, a.stage_ld,
                   TmEpiDin{dxs, G1, G0, 0, ts});
    // the tile's column sums of d rgb_h: its share of the pair's bias-row gradient
    for (int o = threadIdx.x; o < RH; o += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < tr; ++r) s += G1[o * ts + r];
      gsum_ws[(size_t)tile * RH + o] = s;
    }
    // rgb1 backward: dW_hc, then d hc over hc in HC
    tm_weight_grads(slice + a.off_w_hc, nullptr, G1, RH, KSegs{HC, W, HC, 0, ts}, W, tr, first);
    tm_gemm<false>(a.w_hc, W, RH, KSegs{G1, RH, G1, 0, ts}, tr, as, a.stage_ld,
                   NhEpiStore{HC, nullptr, ts});
    // sdf head backward; d feat = d hc + g_sdf w_sdf through the final ReLU, in G0
    tm_weight_grads(slice + a.off_w_sdf, slice + a.off_b_sdf, S, 1, KSegs{featb, W, featb, 0, ts},
                    W, tr, first);
    for (int idx = threadIdx.x; idx < W * tr; idx += blockDim.x) {
      const int k = idx / tr, r = idx - k * tr;
      G0[k * ts + r] = featb[k * ts + r] > 0.f ? HC[k * ts + r] + S[r] * __ldg(a.w_sdf + k) : 0.f;
    }
    // base backward
    nh_embed(xs, x, row0, a, hb);
    nh_head_bwd(a, hb, xs, hid, G0, G1, dxs, slice, first, as);
    nh_fold_dx(dxa, dxs, x, row0, a, hb);

    // colour backward: its forward again, in the base buffers
    nh_stack(hid, hcol, H, ts);
    float* featc = hid[hcol.n_layers - 1];
    nh_embed(xs, x, row0, a, hcol);
    nh_head_fwd(a, hcol, xs, hid, hcol.n_layers, as,
                TmEpiHidden{featc, hcol.b[hcol.n_layers - 1], ts});
    for (int idx = threadIdx.x; idx < W * tr; idx += blockDim.x) {
      const int k = idx / tr, r = idx - k * tr;
      G0[k * ts + r] = featc[k * ts + r] > 0.f ? HC[k * ts + r] : 0.f;
    }
    nh_head_bwd(a, hcol, xs, hid, G0, G1, dxs, slice, first, as);
    nh_fold_dx(dxa, dxs, x, row0, a, hcol);

    // visibility: hidden layers, then the backward from its cotangent
    nh_stack(hid, hv, H, ts);
    nh_embed(xs, x, row0, a, hv);
    nh_head_fwd(a, hv, xs, hid, hv.n_layers - 1, as, TmEpiHidden{nullptr, nullptr, ts});
    for (int r = threadIdx.x; r < tr; r += blockDim.x) G0[r] = __ldg(gvis + row0 + r);
    nh_head_bwd(a, hv, xs, hid, G0, G1, dxs, slice, first, as);
    nh_fold_dx(dxa, dxs, x, row0, a, hv);

    // feature: the raw output in G1, the gradient through the normalisation in G0
    nh_stack(hid, hf, H, ts);
    nh_embed(xs, x, row0, a, hf);
    nh_head_fwd(a, hf, xs, hid, hf.n_layers, as, NhEpiStore{G1, hf.b[hf.n_layers - 1], ts});
    if (threadIdx.x < tr) {
      const int r = threadIdx.x;
      const float* gf = gfeat + (size_t)(row0 + r) * a.feat_dim;
      float ss = 0.f;
      for (int j = 0; j < a.feat_dim; ++j) ss = fmaf(G1[j * ts + r], G1[j * ts + r], ss);
      const float denom = fmaxf(sqrtf(ss + 1e-12f), 1e-6f);
      float dot = 0.f;
      for (int j = 0; j < a.feat_dim; ++j) dot = fmaf(G1[j * ts + r] / denom, __ldg(gf + j), dot);
      for (int j = 0; j < a.feat_dim; ++j)
        G0[j * ts + r] = (__ldg(gf + j) - G1[j * ts + r] / denom * dot) / denom;
    }
    nh_head_bwd(a, hf, xs, hid, G0, G1, dxs, slice, first, as);
    nh_fold_dx(dxa, dxs, x, row0, a, hf);

    for (int idx = threadIdx.x; idx < tr * 3; idx += blockDim.x) {
      const int r = idx / 3, c = idx - r * 3;
      dx[(size_t)(row0 + r) * 3 + c] = dxa[c * ts + r];
    }
  }
}

// The appearance gradients from the tiles' column sums of d rgb_h: per pair
// m, gpair[m] = the sum of its tiles' sums in tile order; then
// dappr[m][c] = sum_o gpair[m][o] W_appr[o][c],
// dW_appr[o][c] = sum_m gpair[m][o] appr[m][c], db_rgb1[o] = sum_m gpair[m][o].
// One block.
__global__ void __launch_bounds__(TM_THREADS)
nerf_heads_appr_kernel(const float* __restrict__ gsum_ws, int tiles_per_pair, int n_pairs,
                       int RH, int CA, const float* __restrict__ appr,
                       const float* __restrict__ w_appr, float* __restrict__ gpair,
                       float* __restrict__ dappr, float* __restrict__ dw_appr,
                       float* __restrict__ db_rgb1) {
  for (int idx = threadIdx.x; idx < n_pairs * RH; idx += blockDim.x) {
    const int m = idx / RH, o = idx - m * RH;
    float s = 0.f;
    for (int t = 0; t < tiles_per_pair; ++t) s += gsum_ws[((size_t)m * tiles_per_pair + t) * RH + o];
    gpair[idx] = s;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n_pairs * CA; idx += blockDim.x) {
    const int m = idx / CA, c = idx - m * CA;
    float s = 0.f;
    for (int o = 0; o < RH; ++o) s = fmaf(gpair[(size_t)m * RH + o], __ldg(w_appr + o * CA + c), s);
    dappr[idx] = s;
  }
  for (int idx = threadIdx.x; idx < RH * CA; idx += blockDim.x) {
    const int o = idx / CA, c = idx - o * CA;
    float s = 0.f;
    for (int m = 0; m < n_pairs; ++m) s = fmaf(gpair[(size_t)m * RH + o], __ldg(appr + (size_t)m * CA + c), s);
    dw_appr[idx] = s;
  }
  for (int o = threadIdx.x; o < RH; o += blockDim.x) {
    float s = 0.f;
    for (int m = 0; m < n_pairs; ++m) s += gpair[(size_t)m * RH + o];
    db_rgb1[o] = s;
  }
}

// ------------------------------------------------------------------ launch

static size_t nh_fwd_smem(const NhArgs& a) {
  return sizeof(float) * ((size_t)a.ts * (a.max_cx + 2 * a.g_width + a.width) +
                          tm_round4(a.rgb_hidden) + (size_t)TM_KC * a.stage_ld);
}

static size_t nh_bwd_smem(const NhArgs& a) {
  return sizeof(float) * ((size_t)a.ts * (2 * a.max_cx + 4 + a.h_total + 2 * a.g_width + a.width + 4) +
                          tm_round4(a.rgb_hidden) + (size_t)TM_KC * a.stage_ld);
}

// The shapes the kernels assume: each head a chain of layers over its
// embedding (skip layers re-reading it), the tile a divisor of the samples
// of a pair, every width within the staging and gradient buffers.
static int nh_check(const NhArgs& a) {
  if (a.tr < 4 || a.tr % 4 != 0 || a.tr > TM_THREADS || a.ts != a.tr + 4 || a.spp % a.tr != 0 ||
      a.rows < a.spp || a.rows % a.spp != 0)
    return (int)cudaErrorInvalidValue;
  int max_w = a.width > a.rgb_hidden ? a.width : a.rgb_hidden;
  for (int i = 0; i < NH_HEADS; ++i) {
    const NhHead& h = a.head[i];
    if (h.n_layers < 2 || h.n_layers > NH_MAX_LAYERS || h.n_freqs < 0 ||
        h.n_freqs > TM_MAX_FREQS || h.c_x != 3 * (2 * h.n_freqs + 1) || h.c_x > a.max_cx ||
        (h.skip_mask & 1))
      return (int)cudaErrorInvalidValue;
    int total = 0;
    for (int l = 0; l < h.n_layers; ++l) {
      const bool skip = l > 0 && ((h.skip_mask >> l) & 1);
      const int want = (l == 0 ? 0 : h.out_dim[l - 1]) + ((l == 0 || skip) ? h.c_x : 0);
      if (h.in_dim[l] != want || h.out_dim[l] < 1 || h.out_dim[l] > a.g_width ||
          h.k1[l] != (skip ? h.c_x : want) || (skip != (h.w2[l] != nullptr)))
        return (int)cudaErrorInvalidValue;
      max_w = h.in_dim[l] > max_w ? h.in_dim[l] : max_w;
      max_w = h.out_dim[l] > max_w ? h.out_dim[l] : max_w;
      total += h.out_dim[l];
    }
    if (total > a.h_total) return (int)cudaErrorInvalidValue;
  }
  if (a.head[0].out_dim[a.head[0].n_layers - 1] != a.width ||
      a.head[1].out_dim[a.head[1].n_layers - 1] != a.width ||
      a.head[2].out_dim[a.head[2].n_layers - 1] != 1 ||
      a.head[3].out_dim[a.head[3].n_layers - 1] != a.feat_dim || a.width > a.g_width ||
      a.rgb_hidden > a.g_width || a.feat_dim > a.g_width)
    return (int)cudaErrorInvalidValue;
  if (TM_KC * tm_round4(max_w) > TM_STAGE_REGS * TM_THREADS || a.stage_ld < tm_round4(max_w))
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" {

// density (rows, 1), rgb (rows, 3), vis (rows, 1), feat (rows, feat_dim) of
// the points x (rows, 3); appr: (rows / spp, appr_dim) appearance rows.
int lab4d_nerf_heads_fwd(const NhArgs* args, const float* x, const float* appr, float* density,
                         float* rgb, float* vis, float* feat, int grid, void* stream) {
  const NhArgs& a = *args;
  int err = nh_check(a);
  if (err) return err;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = nh_fwd_smem(a);
  err = tm_set_smem((const void*)nerf_heads_fwd_kernel, smem);
  if (err) return err;
  nerf_heads_fwd_kernel<<<grid, TM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, x, appr, density, rgb, vis, feat);
  return (int)cudaGetLastError();
}

// The VJP for the cotangents gd (rows, 1), grgb (rows, 3), gvis (rows, 1),
// gfeat (rows, feat_dim): dx (rows, 3); grads: the reduced workspace slice
// (n_slice floats, d ibeta among them), then dW_appr (rgb_hidden, appr_dim)
// and db_rgb1 (rgb_hidden,); dappr (rows / spp, appr_dim). Scratch: ws
// (grid * n_slice), gsum_ws (rows / tr * rgb_hidden), gpair
// (rows / spp * rgb_hidden). grid <= rows / tr.
int lab4d_nerf_heads_bwd(const NhArgs* args, const float* x, const float* appr, const float* gd,
                         const float* grgb, const float* gvis, const float* gfeat, float* dx,
                         float* ws, float* gsum_ws, float* gpair, float* grads, float* dappr,
                         int grid, void* stream) {
  const NhArgs& a = *args;
  int err = nh_check(a);
  if (err) return err;
  const int ntiles = a.rows / a.tr;
  if (grid < 1 || grid > ntiles) return (int)cudaErrorInvalidValue;  // every slice gets a first tile
  const size_t smem = nh_bwd_smem(a);
  err = tm_set_smem((const void*)nerf_heads_bwd_kernel, smem);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nerf_heads_bwd_kernel<<<grid, TM_THREADS, smem, s>>>(a, x, appr, gd, grgb, gvis, gfeat, dx, ws,
                                                       gsum_ws);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int blocks = (a.n_slice + TM_THREADS - 1) / TM_THREADS;
  tile_mlp_reduce_kernel<<<blocks, TM_THREADS, 0, s>>>(ws, grid, a.n_slice, grads);
  err = (int)cudaGetLastError();
  if (err) return err;
  float* dw_appr = grads + a.n_slice;
  nerf_heads_appr_kernel<<<1, TM_THREADS, 0, s>>>(gsum_ws, a.spp / a.tr, a.rows / a.spp,
                                                  a.rgb_hidden, a.appr_dim, appr, a.w_appr, gpair,
                                                  dappr, dw_appr,
                                                  dw_appr + (size_t)a.rgb_hidden * a.appr_dim);
  return (int)cudaGetLastError();
}

// sizeof(NhArgs), for the caller's check of its copy of the layout
int lab4d_nerf_heads_args_size() { return (int)sizeof(NhArgs); }

const char* lab4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
