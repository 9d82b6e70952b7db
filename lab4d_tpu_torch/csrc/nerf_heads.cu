// K1 and K2: every per-point head of the FeatureNeRF field, forward and
// backward, hand-written for Hopper (sm_90a) on the 3xTF32 tensor-core
// products of heads_mma.cuh.
//
// K1 replaces lab4d_tpu/ops/field_kernel.py:_run_fwd (Pallas kernel
// _fwd_kernel / _forward_tile); K2 replaces _run_bwd (_bwd_kernel /
// _backward_tile). The heads:
//   base MLP (Fourier embedding, ReLU layers, skip) -> feat -> sdf head ->
//     VolSDF density (Laplace CDF, expm1, times ibeta);
//   colour MLP -> + feat = hc -> rgb1 (with the pair's appearance row as a
//     bias row) -> ReLU -> rgb2 -> sigmoid;
//   visibility MLP -> logit; feature MLP -> 16 channels -> L2 normalisation.
// The heads read the shared frequency ladder (the colour ladder; the other
// embeddings use its first n_freqs), the base and colour embeddings carry
// their annealing windows. K2 returns dx through the Fourier embeddings,
// every dW / db, d ibeta and the appearance rows' gradient; the windows get
// none (as in the JAX VJP).
//
// Weights come in the split layout of ops/field_kernel.py:split_nets (the
// torch.nn.Linear (out, in) layout, a skip layer as [W_x | W_h] column
// blocks, rgb1 as W_hc and W_appr), so the [X, h] operand of a skip layer
// is never concatenated.
//
// What bounds it on the card: at the flagship step (262,144 points, W 128)
// the heads cost 234,688 multiply-adds per point: 123 GFLOP for K1 and
// about three times that for K2, 0.75 ms and 2.24 ms at the TF32 peak in
// 3xTF32 (1.84 ms and 5.51 ms on fp32 FMA). What the design does about it:
// - K1 is one fused kernel. A block of 16 warps owns 64 points and keeps
//   their activations in shared memory (row-major, ~121 KB), chaining the
//   heads' layers as tensor-core products. The 0.95 MB of weights do not
//   fit in shared memory: they are split into tf32 hi / lo once per call
//   (nh_pack_kernel) and stream from L2 in double-buffered k-slabs of 32
//   by 16-byte cp.async, one barrier per slab, once per 64 points. Narrow
//   layers (1, 3, 16 outputs) are single n8 tiles of the warps that hold
//   their rows, not block-wide sweeps. When autograd needs them, K1 also
//   writes every layer output to device memory (streaming stores): 2,001
//   floats per point at the flagship widths (2.1 GB at 262,144 points,
//   0.63 ms at 3.35 TB/s), which K2 reads instead of recomputing the
//   forward.
// - K2 is a sequence of launches that walks the heads in reverse, layer by
//   layer over all points: dIn = G . W (the ReLU mask of the saved input as
//   its epilogue, the X columns into dX) and dW = G^T . A, db = sum G as a
//   split-K product over 128 chunks of points, each chunk's partials in its
//   own workspace slice, summed in chunk order at the end. (A fused
//   backward tile must hold the base head's 768 floats per point in shared
//   memory, which caps it at 32 points, and add every tile's 0.95 MB of
//   weight gradients to a workspace.) Small kernels of their own: the
//   output cotangents through the density, sigmoid and normalisation (and
//   d ibeta); the embedding of each head; the chain rule through sin / cos
//   to dx; the per-pair column sums of d rgb_h and the appearance
//   gradients.
//
// No float atomics: every sum across blocks runs in a fixed order, and the
// result is the same from run to run. Precise sinf / cosf / expf / expm1f
// (no fast math); angles reach 2^11 |x|.

#include "heads_mma.cuh"

#define NH_MAX_LAYERS 8
#define NH_MAX_FREQS 16
#define NH_RGB 3
#define NH_HEADS 4   // base, colour, visibility, feature
#define NH_TR 64     // points per K1 block
#define NH_K1_THREADS 512  // 16 warps per K1 block
#define NH_NMAX 128  // widest layer output
#define NH_LDS 36    // row stride of a staged weight slab (k-slab of 32 + 4)

// One ReLU MLP head in the split layout. off_*: offsets of its gradients in
// a workspace slice; act_off: floats per point before layer l's saved
// output in the activation buffer (each layer a (rows, out) block).
struct NhHead {
  int n_layers, skip_mask, n_freqs, c_x;
  int in_dim[NH_MAX_LAYERS];  // full input width (c_x + h on a skip layer)
  int out_dim[NH_MAX_LAYERS];
  int k1[NH_MAX_LAYERS];  // columns of w1: c_x on a skip layer, in_dim otherwise
  int off_w1[NH_MAX_LAYERS], off_w2[NH_MAX_LAYERS], off_b[NH_MAX_LAYERS];
  int act_off[NH_MAX_LAYERS];
  int pk_off[NH_MAX_LAYERS];  // offset of the layer's pre-split weights in the packed buffer
  const float* window;  // (n_freqs,) annealing window or null
  const float* w1[NH_MAX_LAYERS];
  const float* w2[NH_MAX_LAYERS];  // the h columns of a skip layer, else null
  const float* b[NH_MAX_LAYERS];
};

struct NhArgs {
  NhHead head[NH_HEADS];
  int rows, spp, tr, n_chunks;
  int width;       // output width of the base and colour MLPs (hc)
  int rgb_hidden;  // rgb1 outputs
  int appr_dim;    // appearance channels
  int feat_dim;    // feature channels
  int max_cx;      // widest embedding
  int g_width;     // widest layer output
  int off_w_sdf, off_b_sdf, off_w_hc, off_w_rgb2, off_b_rgb2, off_dibeta;
  int n_slice;    // floats of one workspace slice
  int act_rgbh;   // floats per point before rgb_h in the activation buffer
  int act_total;  // saved floats per point
  int pk_hc, pk_rgb2, pk_total;  // packed weights: rgb1's W_hc, rgb2's; floats in all
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

// A layer weight as column blocks [w1 (n, k1) | w2 (n, K - k1)]
struct NhW {
  const float* w1;
  int k1;
  const float* w2;
  __device__ __forceinline__ const float* at(int n, int k, int K) const {
    return k < k1 ? w1 + (size_t)n * k1 + k : w2 + (size_t)n * (K - k1) + (k - k1);
  }
};

__host__ __host__ __device__ __forceinline__ NhW nh_w(const NhHead& h, int l) { return NhW{h.w1[l], h.k1[l], h.w2[l]}; }

__device__ __forceinline__ float nh_sign(float s) { return s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f); }

__device__ __forceinline__ float nh_sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Column k of head h's embedding [x, sin (F x 3), cos (F x 3)] of the point
// xv (3 floats), sin / cos times the window
__device__ __forceinline__ float nh_embed_at(const NhArgs& a, const NhHead& h, const float* xv,
                                             int k) {
  const int C = 3, FC = h.n_freqs * 3;
  if (k < C) return xv[k];
  const int c = (k - C) % C, f = ((k - C) % FC) / C;
  const float ang = xv[c] * a.freq[f];
  float v = k < C + FC ? sinf(ang) : cosf(ang);
  if (h.window != nullptr) v *= __ldg(h.window + f);
  return v;
}

// ------------------------------------------------------------------ K1

// A layer input in shared memory: columns [0, k1) of s1, then s2; zero at
// and past K
struct NhActIn {
  const float* s1;
  int ld1, k1;
  const float* s2;
  int ld2, K;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return k < k1 ? s1[m * ld1 + k] : (k < K ? s2[m * ld2 + (k - k1)] : 0.f);
  }
};

// A layer's weights, pre-split by nh_pack_kernel: hi then lo, each (N, kp)
// row-major, kp = K rounded up to a whole k-slab (zero-padded)
struct NhPk {
  const float* hi;
  int kp;
};

__host__ __device__ __forceinline__ int nh_kp(int K) { return (K + HM_KS - 1) / HM_KS * HM_KS; }

__device__ __forceinline__ NhPk nh_pk(const float* wpk, const NhHead& h, int l) {
  return NhPk{wpk + h.pk_off[l], nh_kp(h.in_dim[l])};
}

// O = In . W^T on the block's 64 points, O handed to epi(m, n, value);
// wsl: two stages of hi and lo weight slabs (NH_NMAX x NH_LDS each). Warp w
// owns the unit of rows 16 (w % 4) and columns 32 (w / 4). Called by the
// whole block; ends with a barrier, so O is visible and the slabs free.
template <class Epi>
__device__ void nh_layer(const NhActIn& in, const NhPk& W, int N, int K, float* wsl, const Epi& epi) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int nv = warp < 4 * ((N + 31) / 32) ? hm_nv(N, n0) : 0;
  float c[4][4];
  hm_zero(c);
  const int n_slab = W.kp / HM_KS;
  const float* lo = W.hi + (size_t)N * W.kp;
  auto stage = [&](int s) {
    float* dst = wsl + (s & 1) * (2 * NH_NMAX * NH_LDS);
    const int k0 = s * HM_KS;
    for (int e = tid; e < N * (HM_KS / 4) * 2; e += NH_K1_THREADS) {
      const int half = e >= N * (HM_KS / 4);
      const int e2 = e - half * N * (HM_KS / 4), n = e2 >> 3, q = (e2 & 7) * 4;
      hm_cp16(dst + half * NH_NMAX * NH_LDS + n * NH_LDS + q,
              (half ? lo : W.hi) + (size_t)n * W.kp + k0 + q);
    }
    hm_cp_commit();
  };
  stage(0);
  for (int s = 0; s < n_slab; ++s) {
    hm_cp_wait();
    __syncthreads();  // slab s is in; every warp is done with slab s - 1
    if (s + 1 < n_slab) stage(s + 1);
    const float* bh = wsl + (s & 1) * (2 * NH_NMAX * NH_LDS);
    if (nv > 0) {
#pragma unroll
      for (int k8 = 0; k8 < HM_KS; k8 += 8)
        hm_step_pk(c, in, s * HM_KS + k8, bh, bh + NH_NMAX * NH_LDS, NH_LDS, 1, k8, m0, n0, nv);
    }
  }
  if (nv > 0) hm_store(c, m0, n0, nv, N, epi);
  __syncthreads();
}

// Each epilogue also writes its value to the layer's saved block sv
// ((rows, svn) row-major, from the tile's first row) unless sv is null,
// as a streaming store (__stcs), so the 2 GB of saved outputs do not evict
// the weights from L2.
struct NhEpiRelu {  // h[m][n] = relu(v + b[n])
  float* h;
  int ld;
  const float* b;
  float* sv;
  int svn;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    const float o = fmaxf(v + __ldg(b + n), 0.f);
    h[m * ld + n] = o;
    if (sv != nullptr) __stcs(sv + (size_t)m * svn + n, o);
  }
};

struct NhEpiColour {  // c = relu(v + b[n]) (saved); hc = feat + c in place in f
  float* f;
  int ld;
  const float* b;
  float* sv;
  int svn;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    const float cv = fmaxf(v + __ldg(b + n), 0.f);
    f[m * ld + n] += cv;
    if (sv != nullptr) __stcs(sv + (size_t)m * svn + n, cv);
  }
};

struct NhEpiReluSmemBias {  // h[m][n] = relu(v + bias[n]), bias in shared memory
  float* h;
  int ld;
  const float* bias;
  float* sv;
  int svn;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    const float o = fmaxf(v + bias[n], 0.f);
    h[m * ld + n] = o;
    if (sv != nullptr) __stcs(sv + (size_t)m * svn + n, o);
  }
};

struct NhEpiSigmoidOut {  // rgb[row0 + m][n] = sigmoid(v + b[n])
  float* y;
  const float* b;
  int row0;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    y[(size_t)(row0 + m) * NH_RGB + n] = nh_sigmoid(v + __ldg(b + n));
  }
};

struct NhEpiOut {  // y[row0 + m][n] = v + b[n] (n_out columns, unless y is null), and h[m][n]
  float* y;
  float* h;
  int ld;
  const float* b;
  int row0, n_out;
  float* sv;
  int svn;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    const float o = v + __ldg(b + n);
    if (y != nullptr) y[(size_t)(row0 + m) * n_out + n] = o;
    h[m * ld + n] = o;
    if (sv != nullptr) __stcs(sv + (size_t)m * svn + n, o);
  }
};

// The saved block of a layer of n outputs at act_off for the tile at row0
__device__ __forceinline__ float* nh_sv(float* acts, int act_off, int n, int row0, int rows) {
  return acts == nullptr ? nullptr : acts + (size_t)act_off * rows + (size_t)row0 * n;
}

// X of head h for the block's points, row-major (ld floats per point)
__device__ void nh_embed_tile(float* xs, int ld, const float* __restrict__ x, int row0,
                              const NhArgs& a, const NhHead& h) {
  for (int idx = threadIdx.x; idx < NH_TR * h.c_x; idx += NH_K1_THREADS) {
    const int r = idx / h.c_x, k = idx - r * h.c_x;
    const float* xp = x + (size_t)(row0 + r) * 3;
    const float xv[3] = {__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
    xs[r * ld + k] = nh_embed_at(a, h, xv, k);
  }
  __syncthreads();
}

// Layers [0, n_layers) of head h on the tile (X in xs), each ReLU output in
// pp[l & 1] and saved; the last layer's output goes to epi_last (which
// saves it).
template <class Epi>
__device__ void nh_head_fwd(const NhArgs& a, const NhHead& h, const float* wpk, const float* xs,
                            int ldx, float* const* pp, int ldh, float* wsl, float* acts, int row0,
                            const Epi& epi_last) {
  for (int l = 0; l < h.n_layers; ++l) {
    const bool skip = l > 0 && ((h.skip_mask >> l) & 1);
    const float* hp = l > 0 ? pp[(l - 1) & 1] : xs;
    const NhActIn in = l == 0 ? NhActIn{xs, ldx, h.c_x, xs, ldx, h.c_x}
                       : skip ? NhActIn{xs, ldx, h.c_x, hp, ldh, h.in_dim[l]}
                              : NhActIn{hp, ldh, h.in_dim[l], hp, ldh, h.in_dim[l]};
    if (l < h.n_layers - 1)
      nh_layer(in, nh_pk(wpk, h, l), h.out_dim[l], h.in_dim[l], wsl,
               NhEpiRelu{pp[l & 1], ldh, h.b[l],
                         nh_sv(acts, h.act_off[l], h.out_dim[l], row0, a.rows), h.out_dim[l]});
    else
      nh_layer(in, nh_pk(wpk, h, l), h.out_dim[l], h.in_dim[l], wsl, epi_last);
  }
}

// Every layer's weights of K1, pre-split into tf32 hi and lo, zero-padded
// to whole k-slabs, into wpk (pk_total floats). blockIdx.y: the layer, in
// the heads' order, then rgb1's W_hc and rgb2.
__global__ void __launch_bounds__(HM_THREADS)
nh_pack_kernel(const __grid_constant__ NhArgs a, float* __restrict__ wpk) {
  int L = blockIdx.y, N, K, off;
  NhW w;
  for (int hi = 0; hi < NH_HEADS; ++hi) {
    const NhHead& h = a.head[hi];
    if (L < h.n_layers) {
      N = h.out_dim[L], K = h.in_dim[L], off = h.pk_off[L], w = nh_w(h, L);
      L = -1;
      break;
    }
    L -= h.n_layers;
  }
  if (L == 0) N = a.rgb_hidden, K = a.width, off = a.pk_hc, w = NhW{a.w_hc, a.width, nullptr};
  if (L == 1) N = NH_RGB, K = a.rgb_hidden, off = a.pk_rgb2, w = NhW{a.w_rgb2, a.rgb_hidden, nullptr};
  if (L > 1) return;
  const int kp = nh_kp(K);
  for (int e = blockIdx.x * HM_THREADS + threadIdx.x; e < N * kp; e += gridDim.x * HM_THREADS) {
    const int n = e / kp, k = e - n * kp;
    const float v = k < K ? __ldg(w.at(n, k, K)) : 0.f;
    uint32_t hi, lo;
    hm_split(v, hi, lo);
    wpk[off + e] = __uint_as_float(hi);
    wpk[off + (size_t)N * kp + e] = __uint_as_float(lo);
  }
}

// smem: X (64 x hm_ld(max_cx)), H0, H1, F (64 x hm_ld(g_width) each), two
// stages of hi / lo weight slabs, the rgb1 bias row. One block per 64 points.
__global__ void __launch_bounds__(NH_K1_THREADS, 1)
nerf_heads_fwd_kernel(const __grid_constant__ NhArgs a, const float* __restrict__ x,
                      const float* __restrict__ appr, const float* __restrict__ wpk,
                      float* __restrict__ density, float* __restrict__ rgb, float* __restrict__ vis,
                      float* __restrict__ feat, float* __restrict__ acts) {
  extern __shared__ __align__(16) float smem[];
  const int ldx = hm_ld(a.max_cx), ldh = hm_ld(a.g_width);
  const NhHead &hb = a.head[0], &hcol = a.head[1], &hv = a.head[2], &hf = a.head[3];
  float* xs = smem;
  float* H0 = xs + NH_TR * ldx;
  float* H1 = H0 + NH_TR * ldh;
  float* F = H1 + NH_TR * ldh;
  float* wsl = F + NH_TR * ldh;
  float* abias = wsl + 4 * NH_NMAX * NH_LDS;
  float* pp[2] = {H0, H1};
  const int row0 = blockIdx.x * NH_TR;
  const float* arow = appr + (size_t)(row0 / a.spp) * a.appr_dim;
  for (int o = threadIdx.x; o < a.rgb_hidden; o += NH_K1_THREADS) {
    float s = __ldg(a.b_rgb1 + o);
    for (int c = 0; c < a.appr_dim; ++c)
      s = fmaf(__ldg(a.w_appr + (size_t)o * a.appr_dim + c), __ldg(arow + c), s);
    abias[o] = s;
  }

  // base MLP -> feat (final ReLU) in F; density from the sdf head
  nh_embed_tile(xs, ldx, x, row0, a, hb);
  const int lb = hb.n_layers - 1, lc = hcol.n_layers - 1, lv = hv.n_layers - 1, lf = hf.n_layers - 1;
  nh_head_fwd(a, hb, wpk, xs, ldx, pp, ldh, wsl, acts, row0,
              NhEpiRelu{F, ldh, hb.b[lb], nh_sv(acts, hb.act_off[lb], a.width, row0, a.rows), a.width});
  if (threadIdx.x < NH_TR) {
    const int r = threadIdx.x;
    float s = __ldg(a.b_sdf);
    for (int k = 0; k < a.width; ++k) s = fmaf(__ldg(a.w_sdf + k), F[r * ldh + k], s);
    const float ib = __ldg(a.ibeta);
    density[row0 + r] = (0.5f + 0.5f * nh_sign(s) * expm1f(-fabsf(s) * ib)) * ib;
  }
  // colour MLP; hc = feat + its output in place in F
  nh_embed_tile(xs, ldx, x, row0, a, hcol);
  nh_head_fwd(a, hcol, wpk, xs, ldx, pp, ldh, wsl, acts, row0,
              NhEpiColour{F, ldh, hcol.b[lc], nh_sv(acts, hcol.act_off[lc], a.width, row0, a.rows),
                          a.width});
  // rgb head: rgb_h into the other buffer, then rgb2 and the sigmoid
  float* rbuf = pp[(lc + 1) & 1];
  nh_layer(NhActIn{F, ldh, a.width, F, ldh, a.width}, NhPk{wpk + a.pk_hc, nh_kp(a.width)},
           a.rgb_hidden, a.width, wsl,
           NhEpiReluSmemBias{rbuf, ldh, abias, nh_sv(acts, a.act_rgbh, a.rgb_hidden, row0, a.rows),
                             a.rgb_hidden});
  nh_layer(NhActIn{rbuf, ldh, a.rgb_hidden, rbuf, ldh, a.rgb_hidden},
           NhPk{wpk + a.pk_rgb2, nh_kp(a.rgb_hidden)}, NH_RGB, a.rgb_hidden, wsl,
           NhEpiSigmoidOut{rgb, a.b_rgb2, row0});
  // visibility logit
  nh_embed_tile(xs, ldx, x, row0, a, hv);
  float* vbuf = pp[lv & 1];
  nh_head_fwd(a, hv, wpk, xs, ldx, pp, ldh, wsl, acts, row0,
              NhEpiOut{vis, vbuf, ldh, hv.b[lv], row0, 1, nh_sv(acts, hv.act_off[lv], 1, row0, a.rows), 1});
  // feature, then its L2 normalisation per point
  nh_embed_tile(xs, ldx, x, row0, a, hf);
  float* fbuf = pp[lf & 1];
  nh_head_fwd(a, hf, wpk, xs, ldx, pp, ldh, wsl, acts, row0,
              NhEpiOut{nullptr, fbuf, ldh, hf.b[lf], row0, a.feat_dim,
                       nh_sv(acts, hf.act_off[lf], a.feat_dim, row0, a.rows), a.feat_dim});
  if (threadIdx.x < NH_TR) {
    const int r = threadIdx.x;
    const float* f16 = fbuf + r * ldh;
    float ss = 0.f;
    for (int j = 0; j < a.feat_dim; ++j) ss = fmaf(f16[j], f16[j], ss);
    const float denom = fmaxf(sqrtf(ss + 1e-12f), 1e-6f);
    for (int j = 0; j < a.feat_dim; ++j) feat[(size_t)(row0 + r) * a.feat_dim + j] = f16[j] / denom;
  }
}

// ------------------------------------------------------------------ K2

// Per point, one warp: the gradients at the heads' outputs. g_sdf: of the
// sdf through the density; g_rgb: of rgb2's output through the sigmoid
// (from the saved rgb); g_rgbh: of rgb_h (through rgb2 and its ReLU); hc =
// feat + the colour output; g_f16: of the feature MLP's raw output through
// the normalisation. Block b covers chunk b of the points and writes its
// d ibeta into its workspace slice (the warps' sums in warp order).
#define NH_OUT_THREADS 1024
__global__ void __launch_bounds__(NH_OUT_THREADS)
nh_bwd_out_kernel(const __grid_constant__ NhArgs a, const float* __restrict__ acts,
                  const float* __restrict__ rgb, const float* __restrict__ gd,
                  const float* __restrict__ grgb, const float* __restrict__ gfeat,
                  float* __restrict__ hc, float* __restrict__ g_sdf, float* __restrict__ g_rgb,
                  float* __restrict__ g_rgbh, float* __restrict__ g_f16, float* __restrict__ ws) {
  const int W = a.width, RH = a.rgb_hidden, FD = a.feat_dim, P = a.rows;
  const int pc = P / a.n_chunks, p0 = blockIdx.x * pc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const NhHead &hb = a.head[0], &hcol = a.head[1], &hf = a.head[3];
  const float* featb = acts + (size_t)hb.act_off[hb.n_layers - 1] * P;
  const float* col = acts + (size_t)hcol.act_off[hcol.n_layers - 1] * P;
  const float* rgbh = acts + (size_t)a.act_rgbh * P;
  const float* f16 = acts + (size_t)hf.act_off[hf.n_layers - 1] * P;
  const float ib = __ldg(a.ibeta);
  float dib = 0.f;
  for (int p = p0 + warp; p < p0 + pc; p += NH_OUT_THREADS / 32) {
    float s = 0.f;
    for (int k = lane; k < W; k += 32) {
      const float fv = featb[(size_t)p * W + k];
      s = fmaf(__ldg(a.w_sdf + k), fv, s);
      hc[(size_t)p * W + k] = fv + col[(size_t)p * W + k];
    }
    s = hm_warp_sum(s) + __ldg(a.b_sdf);
    const float e = expf(-fabsf(s) * ib), g = gd[p];
    if (lane == 0) {
      g_sdf[p] = g * (-0.5f * ib * ib * e);
      dib += g * (0.5f + 0.5f * nh_sign(s) * expm1f(-fabsf(s) * ib) - 0.5f * ib * s * e);
    }
    float gr[NH_RGB];
#pragma unroll
    for (int o = 0; o < NH_RGB; ++o) {
      const float sv = rgb[(size_t)p * NH_RGB + o];
      gr[o] = grgb[(size_t)p * NH_RGB + o] * sv * (1.f - sv);
      if (lane == o) g_rgb[(size_t)p * NH_RGB + o] = gr[o];
    }
    for (int j = lane; j < RH; j += 32) {
      float v = 0.f;
#pragma unroll
      for (int o = 0; o < NH_RGB; ++o) v = fmaf(gr[o], __ldg(a.w_rgb2 + o * RH + j), v);
      g_rgbh[(size_t)p * RH + j] = rgbh[(size_t)p * RH + j] > 0.f ? v : 0.f;
    }
    const float fv = lane < FD ? f16[(size_t)p * FD + lane] : 0.f;
    const float denom = fmaxf(sqrtf(hm_warp_sum(fv * fv) + 1e-12f), 1e-6f);
    const float gf = lane < FD ? gfeat[(size_t)p * FD + lane] : 0.f;
    const float dot = hm_warp_sum(fv / denom * gf);
    if (lane < FD) g_f16[(size_t)p * FD + lane] = (gf - fv / denom * dot) / denom;
  }
  __shared__ float part[NH_OUT_THREADS / 32];
  if (lane == 0) part[warp] = dib;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < NH_OUT_THREADS / 32; ++w) t += part[w];
    ws[(size_t)blockIdx.x * a.n_slice + a.off_dibeta] = t;
  }
}

// Where dIn = G . W goes. mode 0: columns k < x_cols into dX (stored or
// added), the rest, masked by the saved input hprev > 0, into gn (the
// gradient of the previous layer's output). mode 1 (rgb1): d hc into the
// base head's gradient gn = [feat > 0] (v + g_sdf w_sdf) and the colour
// head's gc = [colour > 0] v.
struct NhDinOut {
  int mode;
  float* dX;
  int ldx, x_cols, store;
  float* gn;
  const float* hprev;
  float* gc;
  const float* feat;
  const float* col;
  const float* g_sdf;
  const float* w_sdf;
};

// dIn = G . W for 64 points x 64 input columns per block; a k-slab is 32
// outputs: G m-major (4-byte copies: its rows may be 1 or 3 floats), W
// from its pre-split hi / lo (nh_pack_kernel), k-major. Dynamic shared
// memory: two stages of G (64 x NH_LDS) and of W's hi and lo (32 x HM_LDT).
#define NH_DIN_SMEM (sizeof(float) * 2 * (64 * NH_LDS + 2 * HM_KS * HM_LDT))
__global__ void __launch_bounds__(HM_THREADS)
nh_din_kernel(const float* __restrict__ g, int N, NhPk w, int K, const NhDinOut o) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t p0 = (size_t)blockIdx.x * 64;
  const int kb = blockIdx.y * 64;
  const float* wlo = w.hi + (size_t)N * w.kp;
  auto sa = [&](int s) { return smem + (s & 1) * (64 * NH_LDS + 2 * HM_KS * HM_LDT); };
  auto stage = [&](int s) {
    const int ns = s * HM_KS;
    float* a = sa(s);
    float* b = a + 64 * NH_LDS;
    for (int e = tid; e < 64 * HM_KS; e += HM_THREADS) {
      const int m = e >> 5, kk = e & 31, n = ns + kk;
      hm_cp4(a + m * NH_LDS + kk, n < N ? g + (p0 + m) * N + n : g, n < N);
    }
    for (int e = tid; e < 2 * HM_KS * 16; e += HM_THREADS) {  // 16-byte chunks of hi, then lo
      const int half = e >= HM_KS * 16, e2 = e - half * HM_KS * 16;
      const int kk = e2 >> 4, col = (e2 & 15) * 4, n = ns + kk;
      if (kb + col < w.kp)
        hm_cp16(b + half * HM_KS * HM_LDT + kk * HM_LDT + col,
                (half ? wlo : w.hi) + (size_t)min(n, N - 1) * w.kp + kb + col, n < N);
    }
    hm_cp_commit();
  };
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int nv = hm_nv(K - kb, n0);
  float c[4][4];
  hm_zero(c);
  const int n_slab = (N + HM_KS - 1) / HM_KS;
  stage(0);
  for (int s = 0; s < n_slab; ++s) {
    hm_cp_wait();
    __syncthreads();
    if (s + 1 < n_slab) stage(s + 1);
    const HmMK A{sa(s), NH_LDS};  // A(m, kk) = G[m][kk]
    const float* bh = sa(s) + 64 * NH_LDS;  // B(kk, n) = W[kk][n]
    if (nv > 0) {
#pragma unroll
      for (int k8 = 0; k8 < HM_KS; k8 += 8)
        hm_step_pk(c, A, k8, bh, bh + HM_KS * HM_LDT, 1, HM_LDT, k8, m0, n0, nv);
    }
  }
  if (nv == 0) return;
  hm_store(c, m0, n0, nv, K - kb, [&](int m, int n, float v) {
    const size_t p = p0 + m;
    const int k = kb + n;
    if (o.mode == 1) {
      const size_t i = p * K + k;
      o.gn[i] = o.feat[i] > 0.f ? v + o.g_sdf[p] * __ldg(o.w_sdf + k) : 0.f;
      o.gc[i] = o.col[i] > 0.f ? v : 0.f;
    } else if (k < o.x_cols) {
      float* d = o.dX + p * o.ldx + k;
      *d = o.store ? v : *d + v;
    } else {
      const int kh = K - o.x_cols;
      const size_t i = p * kh + (k - o.x_cols);
      o.gn[i] = o.hprev[i] > 0.f ? v : 0.f;
    }
  });
}

// X = head h's embedding of every point, row-major (rows, c_x)
__global__ void __launch_bounds__(HM_THREADS)
nh_embed_kernel(const __grid_constant__ NhArgs a, int head, const float* __restrict__ x,
                float* __restrict__ X) {
  const NhHead& h = a.head[head];
  const size_t total = (size_t)a.rows * h.c_x;
  for (size_t idx = (size_t)blockIdx.x * HM_THREADS + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * HM_THREADS) {
    const size_t p = idx / h.c_x;
    const int k = (int)(idx - p * h.c_x);
    const float xv[3] = {__ldg(x + p * 3), __ldg(x + p * 3 + 1), __ldg(x + p * 3 + 2)};
    X[idx] = nh_embed_at(a, h, xv, k);
  }
}

// dx (stored or added) = the X columns of dX plus the chain rule through
// head h's sin / cos columns
__global__ void __launch_bounds__(HM_THREADS)
nh_fold_kernel(const __grid_constant__ NhArgs a, int head, const float* __restrict__ x,
               const float* __restrict__ dX, float* __restrict__ dx, int store) {
  const NhHead& h = a.head[head];
  const int C = 3, FC = h.n_freqs * 3;
  for (size_t idx = (size_t)blockIdx.x * HM_THREADS + threadIdx.x; idx < (size_t)a.rows * C;
       idx += (size_t)gridDim.x * HM_THREADS) {
    const size_t p = idx / C;
    const int c = (int)(idx - p * C);
    const float* d = dX + p * h.c_x;
    float s = d[c];
    const float xv = __ldg(x + idx);
    for (int f = 0; f < h.n_freqs; ++f) {
      const float ang = xv * a.freq[f];
      const float win = h.window != nullptr ? __ldg(h.window + f) : 1.f;
      const float gs = d[C + f * C + c] * win;
      const float gc = d[C + FC + f * C + c] * win;
      s += (cosf(ang) * gs - sinf(ang) * gc) * a.freq[f];
    }
    dx[idx] = store ? s : dx[idx] + s;
  }
}

// gpair[m][j] = sum over the spp points of pair m, in order, of g_rgbh[p][j]
__global__ void __launch_bounds__(HM_THREADS)
nh_pair_sum_kernel(const float* __restrict__ g_rgbh, int spp, int RH, float* __restrict__ gpair) {
  const size_t m = blockIdx.x;
  for (int j = threadIdx.x; j < RH; j += HM_THREADS) {
    float s = 0.f;
    for (int r = 0; r < spp; ++r) s += g_rgbh[(m * spp + r) * RH + j];
    gpair[m * RH + j] = s;
  }
}

// The appearance gradients from the pairs' sums gpair (n_pairs, RH):
// dappr[m][c] = sum_o gpair[m][o] W_appr[o][c],
// dW_appr[o][c] = sum_m gpair[m][o] appr[m][c], db_rgb1[o] = sum_m gpair[m][o].
__global__ void __launch_bounds__(HM_THREADS)
nh_appr_kernel(const float* __restrict__ gpair, int n_pairs, int RH, int CA,
               const float* __restrict__ appr, const float* __restrict__ w_appr,
               float* __restrict__ dappr, float* __restrict__ dw_appr, float* __restrict__ db_rgb1) {
  const int stride = gridDim.x * HM_THREADS, i0 = blockIdx.x * HM_THREADS + threadIdx.x;
  for (int idx = i0; idx < n_pairs * CA; idx += stride) {
    const int m = idx / CA, c = idx - m * CA;
    float s = 0.f;
    for (int o = 0; o < RH; ++o) s = fmaf(gpair[(size_t)m * RH + o], __ldg(w_appr + o * CA + c), s);
    dappr[idx] = s;
  }
  for (int idx = i0; idx < RH * CA; idx += stride) {
    const int o = idx / CA, c = idx - o * CA;
    float s = 0.f;
    for (int m = 0; m < n_pairs; ++m) s = fmaf(gpair[(size_t)m * RH + o], __ldg(appr + (size_t)m * CA + c), s);
    dw_appr[idx] = s;
  }
  for (int o = i0; o < RH; o += stride) {
    float s = 0.f;
    for (int m = 0; m < n_pairs; ++m) s += gpair[(size_t)m * RH + o];
    db_rgb1[o] = s;
  }
}

// ------------------------------------------------------------------ launch

static size_t nh_fwd_smem(const NhArgs& a) {
  return sizeof(float) * ((size_t)NH_TR * (hm_ld(a.max_cx) + 3 * hm_ld(a.g_width)) +
                          4 * NH_NMAX * NH_LDS + (a.rgb_hidden + 3) / 4 * 4);
}

// The shapes the kernels assume: each head a chain of layers over its
// embedding (skip layers re-reading it), K1's 64-point tiles and K2's
// chunks whole and within one pair's samples, every width within the
// kernels' buffers.
static int nh_check(const NhArgs& a) {
  if (a.tr != NH_TR || a.spp % NH_TR != 0 || a.rows < a.spp || a.rows % a.spp != 0 ||
      a.n_chunks < 1 || a.rows % a.n_chunks != 0 || (a.rows / a.n_chunks) % HM_KS != 0)
    return (int)cudaErrorInvalidValue;
  if (a.g_width > NH_NMAX || a.width > a.g_width || a.rgb_hidden > a.g_width || a.feat_dim > 32 ||
      a.feat_dim > a.g_width || a.max_cx < 3)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < NH_HEADS; ++i) {
    const NhHead& h = a.head[i];
    if (h.n_layers < 2 || h.n_layers > NH_MAX_LAYERS || h.n_freqs < 0 ||
        h.n_freqs > NH_MAX_FREQS || h.c_x != 3 * (2 * h.n_freqs + 1) || h.c_x > a.max_cx ||
        (h.skip_mask & 1))
      return (int)cudaErrorInvalidValue;
    for (int l = 0; l < h.n_layers; ++l) {
      const bool skip = l > 0 && ((h.skip_mask >> l) & 1);
      const int want = (l == 0 ? 0 : h.out_dim[l - 1]) + ((l == 0 || skip) ? h.c_x : 0);
      if (h.in_dim[l] != want || h.out_dim[l] < 1 || h.out_dim[l] > a.g_width ||
          h.k1[l] != (skip ? h.c_x : want) || (skip != (h.w2[l] != nullptr)))
        return (int)cudaErrorInvalidValue;
    }
  }
  if (a.head[0].out_dim[a.head[0].n_layers - 1] != a.width ||
      a.head[1].out_dim[a.head[1].n_layers - 1] != a.width ||
      a.head[2].out_dim[a.head[2].n_layers - 1] != 1 ||
      a.head[3].out_dim[a.head[3].n_layers - 1] != a.feat_dim)
    return (int)cudaErrorInvalidValue;
  return 0;
}

static int nh_set_smem(const void* kernel, size_t smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Scratch of K2, floats: 3 gradient buffers (rows x g_width), X and dX
// (rows x max_cx), hc (rows x width), g_sdf, g_rgb (3), g_rgbh, g_f16 per
// point, the chunks' workspace slices, the pairs' sums and the pre-split
// weights.
static size_t nh_bwd_scratch(const NhArgs& a) {
  const size_t P = a.rows;
  return P * (3 * a.g_width + 2 * a.max_cx + a.width + 1 + NH_RGB + a.rgb_hidden + a.feat_dim) +
         (size_t)a.n_chunks * a.n_slice + (size_t)(a.rows / a.spp) * a.rgb_hidden + a.pk_total;
}

extern "C" {

// density (rows, 1), rgb (rows, 3), vis (rows, 1), feat (rows, feat_dim) of
// the points x (rows, 3); appr: (rows / spp, appr_dim) appearance rows.
// wpk: pk_total floats of scratch for the pre-split weights. acts: null,
// or (act_total * rows) floats for every layer output (K2's input). Two
// launches: the weights' split, then the heads. Returns the error, or 0;
// *n_launches: the launches made.
int lab4d_nerf_heads_fwd(const NhArgs* args, const float* x, const float* appr, float* wpk,
                         float* density, float* rgb, float* vis, float* feat, float* acts,
                         int* n_launches, void* stream) {
  const NhArgs& a = *args;
  int err = nh_check(a);
  if (err) return err;
  const size_t smem = nh_fwd_smem(a);
  err = nh_set_smem((const void*)nerf_heads_fwd_kernel, smem);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n_layers = 2;
  for (int i = 0; i < NH_HEADS; ++i) n_layers += a.head[i].n_layers;
  int n = 0;
  nh_pack_kernel<<<dim3(8, n_layers), HM_THREADS, 0, st>>>(a, wpk);
  err = (int)cudaGetLastError();
  if (err) return err;
  ++n;
  nerf_heads_fwd_kernel<<<a.rows / NH_TR, NH_K1_THREADS, smem, st>>>(a, x, appr, wpk, density, rgb,
                                                                     vis, feat, acts);
  err = (int)cudaGetLastError();
  if (err) return err;
  ++n;
  if (n_launches != nullptr) *n_launches = n;
  return 0;
}

size_t lab4d_nerf_heads_bwd_scratch(const NhArgs* args) { return nh_bwd_scratch(*args); }

// The VJP for the cotangents gd (rows, 1), grgb (rows, 3), gvis (rows, 1),
// gfeat (rows, feat_dim), from K1's saved layer outputs acts and its rgb:
// dx (rows, 3); grads: the reduced workspace slice (n_slice floats, d ibeta
// among them), then dW_appr (rgb_hidden, appr_dim) and db_rgb1
// (rgb_hidden,); dappr (rows / spp, appr_dim). scratch: nh_bwd_scratch
// floats. events / kinds (may be null): a CUDA event recorded before the
// first launch and after each launch, and each launch's kind (0 output cotangents, 1 embedding, 2 dW,
// 3 dIn, 4 dx fold, 5 appearance, 6 reduction, 7 weight split), for as
// many launches as n_events allows. Returns the error, or 0;
// *n_launches: the launches made.
int lab4d_nerf_heads_bwd(const NhArgs* args, const float* x, const float* appr, const float* acts,
                         const float* rgb, const float* gd, const float* grgb, const float* gvis,
                         const float* gfeat, float* dx, float* grads, float* dappr, float* scratch,
                         void** events, int* kinds, int n_events, int* n_launches, void* stream) {
  const NhArgs& a = *args;
  int err = nh_check(a);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t P = a.rows;
  const int n_pairs = a.rows / a.spp, pc = a.rows / a.n_chunks;
  float* GA = scratch;
  float* GB = GA + P * a.g_width;
  float* GC = GB + P * a.g_width;
  float* X = GC + P * a.g_width;
  float* dX = X + P * a.max_cx;
  float* hc = dX + P * a.max_cx;
  float* g_sdf = hc + P * a.width;
  float* g_rgb = g_sdf + P;
  float* g_rgbh = g_rgb + P * NH_RGB;
  float* g_f16 = g_rgbh + P * a.rgb_hidden;
  float* ws = g_f16 + P * a.feat_dim;
  float* gpair = ws + (size_t)a.n_chunks * a.n_slice;
  float* wpk = gpair + (size_t)n_pairs * a.rgb_hidden;
  if ((err = nh_set_smem((const void*)nh_din_kernel, NH_DIN_SMEM))) return err;
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
  auto act = [&](int off) { return acts + (size_t)off * P; };
  auto dw = [&](const float* g, int N, HmSrc src, int K, int ow1, int ow2, int ob) {
    const int nkt = (K + 63) / 64;
    hm_dw_kernel<<<dim3(((N + 63) / 64) * nkt, a.n_chunks), HM_THREADS, 0, st>>>(
        g, N, src, K, a.rows, pc, nkt, ws, a.n_slice, src.k1, ow1, ow2, ob);
    return done(2);
  };
  auto din = [&](const float* g, int N, NhPk w, int K, const NhDinOut& o) {
    nh_din_kernel<<<dim3(a.rows / 64, (K + 63) / 64), HM_THREADS, NH_DIN_SMEM, st>>>(g, N, w, K, o);
    return done(3);
  };
  const int eb = (int)((P * a.max_cx + HM_THREADS - 1) / HM_THREADS);
  const int grid_e = eb < 132 * 16 ? eb : 132 * 16;
  const NhHead& hb = a.head[0];
  const NhHead& hcol = a.head[1];
  const float* featb = act(hb.act_off[hb.n_layers - 1]);
  const float* colb = act(hcol.act_off[hcol.n_layers - 1]);
  const float* rgbh = act(a.act_rgbh);
  const int W = a.width, RH = a.rgb_hidden;

  int n_layers = 2;
  for (int i = 0; i < NH_HEADS; ++i) n_layers += a.head[i].n_layers;
  nh_pack_kernel<<<dim3(8, n_layers), HM_THREADS, 0, st>>>(a, wpk);
  if ((err = done(7))) return err;
  nh_bwd_out_kernel<<<a.n_chunks, NH_OUT_THREADS, 0, st>>>(a, acts, rgb, gd, grgb, gfeat, hc, g_sdf,
                                                       g_rgb, g_rgbh, g_f16, ws);
  if ((err = done(0))) return err;
  if ((err = dw(g_sdf, 1, HmSrc{featb, W, W, featb, W}, W, a.off_w_sdf, a.off_w_sdf, a.off_b_sdf))) return err;
  if ((err = dw(g_rgb, NH_RGB, HmSrc{rgbh, RH, RH, rgbh, RH}, RH, a.off_w_rgb2, a.off_w_rgb2,
                a.off_b_rgb2)))
    return err;
  nh_pair_sum_kernel<<<n_pairs, HM_THREADS, 0, st>>>(g_rgbh, a.spp, RH, gpair);
  if ((err = done(5))) return err;
  float* dw_appr = grads + a.n_slice;
  nh_appr_kernel<<<8, HM_THREADS, 0, st>>>(gpair, n_pairs, RH, a.appr_dim, appr, a.w_appr, dappr,
                                           dw_appr, dw_appr + (size_t)RH * a.appr_dim);
  if ((err = done(5))) return err;
  if ((err = dw(g_rgbh, RH, HmSrc{hc, W, W, hc, W}, W, a.off_w_hc, a.off_w_hc, -1))) return err;
  {
    NhDinOut o{};
    o.mode = 1;
    o.gn = GA;
    o.gc = GC;
    o.feat = featb;
    o.col = colb;
    o.g_sdf = g_sdf;
    o.w_sdf = a.w_sdf;
    if ((err = din(g_rgbh, RH, NhPk{wpk + a.pk_hc, nh_kp(W)}, W, o))) return err;
  }

  // the heads in reverse, layer by layer; start gradients: base GA, colour
  // GC, visibility gvis, feature g_f16
  const float* g_start[NH_HEADS] = {GA, GC, gvis, g_f16};
  for (int hi = 0; hi < NH_HEADS; ++hi) {
    const NhHead& h = a.head[hi];
    nh_embed_kernel<<<grid_e, HM_THREADS, 0, st>>>(a, hi, x, X);
    if ((err = done(1))) return err;
    const float* g = g_start[hi];
    float* gbuf[2] = {hi == 0 ? GB : GA, hi == 0 ? GA : GB};  // never the start buffer
    int cur = 0;
    bool x_written = false;
    for (int l = h.n_layers - 1; l >= 0; --l) {
      const int N = h.out_dim[l], K = h.in_dim[l];
      const bool skip = l > 0 && ((h.skip_mask >> l) & 1);
      const bool has_x = l == 0 || skip;
      const float* hprev = l > 0 ? act(h.act_off[l - 1]) : nullptr;
      const int kh = l > 0 ? h.out_dim[l - 1] : 0;
      const HmSrc src = l == 0 ? HmSrc{X, h.c_x, h.c_x, X, h.c_x}
                        : skip ? HmSrc{X, h.c_x, h.c_x, hprev, kh}
                               : HmSrc{hprev, kh, kh, hprev, kh};
      if ((err = dw(g, N, src, K, h.off_w1[l], h.off_w2[l], h.off_b[l]))) return err;
      NhDinOut o{};
      o.mode = 0;
      o.dX = dX;
      o.ldx = h.c_x;
      o.x_cols = has_x ? h.c_x : 0;
      o.store = x_written ? 0 : 1;
      o.gn = gbuf[cur];
      o.hprev = hprev;
      if ((err = din(g, N, NhPk{wpk + h.pk_off[l], nh_kp(K)}, K, o))) return err;
      x_written = x_written || has_x;
      g = gbuf[cur];
      cur ^= 1;
    }
    nh_fold_kernel<<<grid_e, HM_THREADS, 0, st>>>(a, hi, x, dX, dx, hi == 0 ? 1 : 0);
    if ((err = done(4))) return err;
  }
  hm_reduce_kernel<<<(a.n_slice + HM_THREADS - 1) / HM_THREADS, HM_THREADS, 0, st>>>(
      ws, a.n_chunks, a.n_slice, grads);
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
