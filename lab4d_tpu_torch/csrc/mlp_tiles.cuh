// Row-tiled fused ReLU MLP backward for Hopper (sm_90a): K3b, the VJP of
// the TimeMLP backbones' fused MLP. Its entry point is in
// fused_relu_mlp.cu, beside K3f.
//
// Replaces the Pallas kernel lab4d_tpu/ops/mlp_kernel.py:_bwd_kernel.
// Semantics are its: D+1 dense fp32 layers, ReLU between them, the input
// re-concatenated before each skip layer as [x, h]; the backward
// recomputes the forward per row tile and returns dx, every dW and every
// db. The final ReLU's mask on the incoming gradient is applied by the
// caller (as the JAX VJP does outside its kernel).
//
// What bounds it on the card: the training step calls it on the 256 frames
// of a batch at W = 256 (camera and intrinsics TimeMLPs, D5), about 3x the
// forward's 0.4 MFLOP per row: fp32 FMA throughput, with only x, g and dx
// crossing device memory. What the design does about it: one block of 256
// threads owns a tile of TR rows and keeps every activation of the tile
// in shared memory, transposed (k-major, one row of TR floats, padded to
// TR + 4 against bank conflicts, per feature), so a layer is a small GEMM
// O^T = W . In^T whose operands come from shared memory. Each thread
// computes up to two 4 x 4 output tiles per pass from float4 reads of a
// staged 16-wide k-chunk of the weights and of the activations; the next
// chunk's weights are loaded into registers while the current one is
// consumed, so their latency hides behind the FMAs. Weights stay in the
// torch.nn.Linear layout (out, in); the staging copy transposes them where
// a layer needs it. The weight gradients are 4 x 128 tiles per warp, lanes
// along the input dimension, so their workspace updates are coalesced.
//
// The weight gradients sum over all rows. Pallas summed them over its
// sequential grid; CUDA blocks run in parallel, so each block of a
// grid-stride launch accumulates its own tiles into its own slice of a
// workspace (first tile stores, later tiles add), and a second kernel
// (hm_reduce_kernel of heads_mma.cuh, shared with K2 and K4b) sums the
// slices in block order. No float atomics: the result is the same from run
// to run. fp32 FMA throughout, no tensor cores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "heads_mma.cuh"

#define TM_MAX_LAYERS 16
#define TM_THREADS 256
#define TM_KC 16
#define TM_STAGE_REGS 16  // staged weights per thread: TM_KC * width <= 16 * TM_THREADS
#define TM_MT 2           // 4 x 4 output tiles per thread per pass

struct TileMlpArgs {
  const float* w[TM_MAX_LAYERS];  // (out_l, in_l), row-major
  const float* b[TM_MAX_LAYERS];  // (out_l,)
  int in_dim[TM_MAX_LAYERS];
  int out_dim[TM_MAX_LAYERS];
  int n_layers;
  int c_x;         // columns of x
  int rows;
  int tr;          // rows per tile, a multiple of 4
  int ts;          // shared-memory row stride of the k-major buffers: tr + 4
  int skip_mask;   // bit l set: layer l reads [X, h]
  int max_out;     // widest layer output
  int stage_ld;    // row stride of the weight staging buffer
  int n_params;    // floats of one workspace slice: every dW then db
};

// One source operand of a layer: the k-major rows [0, k1) of seg1 followed
// by the rows [0, k2) of seg2, rows ts floats apart.
struct KSegs {
  const float* seg1;
  int k1;
  const float* seg2;
  int k2;
  int ts;
  __device__ __forceinline__ const float* row(int k) const {
    return k < k1 ? seg1 + (size_t)k * ts : seg2 + (size_t)(k - k1) * ts;
  }
};

__host__ __device__ __forceinline__ int tm_round4(int n) { return (n + 3) & ~3; }

// A(o, k) of a staged k-chunk. kFwd: W(o, k) of an (n_o, K) weight; otherwise
// W(k, o) of a (K, n_o) weight (its transpose, for dIn = g . W).
template <bool kFwd>
__device__ __forceinline__ float tm_wload(const float* __restrict__ W, int n_o, int K, int o, int k) {
  return kFwd ? __ldg(W + (size_t)o * K + k) : __ldg(W + (size_t)k * n_o + o);
}

// The weights of one k-chunk, A(o, k0 + kk) for kk < TM_KC and o < n_o, in
// registers until they are stored to as[kk * ld + o] (zero outside).
// kFwd: A(o, k) = W[o * K + k] (a layer's weight, output o); otherwise
// A(o, k) = W[k * n_o + o] (its transpose, for dIn = g . W).
template <bool kFwd>
struct TmStager {
  float v[TM_STAGE_REGS];
  int kk0, o0, dk, d_o, n_o4;  // element s sits at (kk0, o0) advanced s times

  __device__ __forceinline__ explicit TmStager(int n_o) : n_o4(tm_round4(n_o)) {
    const int idx = threadIdx.x;
    if (kFwd) {  // consecutive threads along k: 16 consecutive floats of a row of W
      kk0 = idx % TM_KC;
      o0 = idx / TM_KC;
      dk = 0;
      d_o = TM_THREADS / TM_KC;
    } else {  // consecutive threads along o: a row of W
      kk0 = idx / n_o4;
      o0 = idx % n_o4;
      dk = TM_THREADS / n_o4;
      d_o = TM_THREADS % n_o4;
    }
  }

  __device__ __forceinline__ void next(int& kk, int& o) const {
    kk += dk;
    o += d_o;
    if (!kFwd && o >= n_o4) {
      o -= n_o4;
      ++kk;
    }
  }

  template <typename WT>
  __device__ __forceinline__ void load(const WT& W, int n_o, int K, int k0) {
    int kk = kk0, o = o0;
#pragma unroll
    for (int s = 0; s < TM_STAGE_REGS; ++s) {
      const int k = k0 + kk;
      v[s] = (kk < TM_KC && o < n_o && k < K) ? tm_wload<kFwd>(W, n_o, K, o, k) : 0.f;
      next(kk, o);
    }
  }

  __device__ __forceinline__ void store(float* as, int ld) const {
    int kk = kk0, o = o0;
#pragma unroll
    for (int s = 0; s < TM_STAGE_REGS; ++s) {
      if (kk < TM_KC && o < n_o4) as[kk * ld + o] = v[s];
      next(kk, o);
    }
  }
};

// O[o][r] = sum_k A(o, k) * In(k)[r] for o < n_o, r < tr, handed to
// epi(o, r, value) for every o < n_o. Must be called by the whole block.
// Tiles are numbered with r fastest, so a warp reads few weight vectors
// (broadcast) and contiguous activations.
template <bool kFwd, typename WT, typename Epi>
__device__ void tm_gemm(const WT& W, int n_o, int K, KSegs in, int tr, float* as, int ld,
                        Epi epi) {
  const int n_rt = tr / 4;
  const int n_mt = ((n_o + 3) / 4) * n_rt;
  for (int m0 = 0; m0 < n_mt; m0 += TM_MT * TM_THREADS) {
    bool active[TM_MT];
    int ot[TM_MT], rt[TM_MT];
    float acc[TM_MT][4][4];
#pragma unroll
    for (int t = 0; t < TM_MT; ++t) {
      const int m = m0 + t * TM_THREADS + threadIdx.x;
      active[t] = m < n_mt;
      rt[t] = active[t] ? m % n_rt : 0;
      ot[t] = active[t] ? m / n_rt : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][i][q] = 0.f;
    }
    TmStager<kFwd> st(n_o);
    st.load(W, n_o, K, 0);
    for (int k0 = 0; k0 < K; k0 += TM_KC) {
      __syncthreads();  // the previous chunk is consumed; producers of In are done
      st.store(as, ld);
      __syncthreads();
      if (k0 + TM_KC < K) st.load(W, n_o, K, k0 + TM_KC);  // in flight during the FMAs
      const int kn = min(TM_KC, K - k0);
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float* brow = in.row(k0 + kk);
        const float* arow = as + kk * ld;
#pragma unroll
        for (int t = 0; t < TM_MT; ++t) {
          if (!active[t]) continue;
          const float4 a = *reinterpret_cast<const float4*>(arow + ot[t] * 4);
          const float4 b = *reinterpret_cast<const float4*>(brow + rt[t] * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[t][i][q] = fmaf(av[i], bv[q], acc[t][i][q]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TM_MT; ++t) {
      if (!active[t]) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = ot[t] * 4 + i;
        if (o < n_o) {
#pragma unroll
          for (int q = 0; q < 4; ++q) epi(o, rt[t] * 4 + q, acc[t][i][q]);
        }
      }
    }
  }
  __syncthreads();  // every epilogue store is visible to the next phase
}

// The kernel input X^T (c_x rows of TR floats) of the rows [row0, row0 + nr);
// rows past nr read x = 0.
__device__ void tm_build_input(float* xs, const float* __restrict__ x, int row0, int nr,
                               const TileMlpArgs& a) {
  const int tr = a.tr;
  for (int idx = threadIdx.x; idx < a.c_x * tr; idx += blockDim.x) {
    const int k = idx / tr, r = idx - k * tr;
    xs[k * a.ts + r] = r < nr ? __ldg(x + (size_t)(row0 + r) * a.c_x + k) : 0.f;
  }
}

// The source operand of layer l: X for layer 0, [X, h] for a skip layer,
// h otherwise.
__device__ __forceinline__ KSegs tm_layer_input(const TileMlpArgs& a, int l, const float* xs,
                                                const float* h) {
  if (l == 0) return KSegs{xs, a.c_x, xs, 0, a.ts};
  if ((a.skip_mask >> l) & 1) return KSegs{xs, a.c_x, h, a.in_dim[l] - a.c_x, a.ts};
  return KSegs{h, a.in_dim[l], h, 0, a.ts};
}

struct TmEpiHidden {  // h[o][r] = relu(v + b[o])
  float* h;
  const float* b;
  int ts;
  __device__ __forceinline__ void operator()(int o, int r, float v) const {
    h[o * ts + r] = fmaxf(v + __ldg(b + o), 0.f);
  }
};

// ----------------------------------------------------------------- backward

// dIn of layer l: the X part accumulates into dX, the h part (the gradient
// of layer l - 1's output) is masked by that output's ReLU and stored.
struct TmEpiDin {
  float* dxs;
  float* gnext;
  const float* hprev;
  int x_cols, ts;  // x_cols: leading input columns that are X (0 or c_x)
  __device__ __forceinline__ void operator()(int o, int r, float v) const {
    if (o < x_cols) {
      dxs[o * ts + r] += v;
    } else {
      const int k = o - x_cols;
      gnext[k * ts + r] = hprev[k * ts + r] > 0.f ? v : 0.f;
    }
  }
};

// dW[j][k] (+)= sum_r G[j][r] In(k)[r] and, unless db is null, db[j] (+)=
// sum_r G[j][r] into this block's workspace slice. A warp owns 4 rows j and 128 columns k, lane l
// the columns k0 + l + 32 q: its activation reads hit distinct banks and
// its workspace updates are coalesced.
__device__ void tm_weight_grads(float* __restrict__ dw, float* __restrict__ db, const float* g,
                                int n_o, KSegs in, int K, int tr, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = TM_THREADS / 32;
  const int n_jt = (n_o + 3) / 4, n_kb = (K + 127) / 128;
  const int ts = in.ts;
  for (int t = warp; t < n_jt * n_kb; t += n_warps) {
    const int jt = t % n_jt, kb = t / n_jt;
    float acc[4][4];
    const float* gr[4];
    const float* ir[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      gr[i] = g + (size_t)min(jt * 4 + i, n_o - 1) * ts;
      ir[i] = in.row(min(kb * 128 + i * 32 + lane, K - 1));
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    }
    for (int r = 0; r < tr; r += 4) {
      float4 gv[4], iv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gv[i] = *reinterpret_cast<const float4*>(gr[i] + r);
        iv[i] = *reinterpret_cast<const float4*>(ir[i] + r);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float s = acc[i][q];
          s = fmaf(gv[i].x, iv[q].x, s);
          s = fmaf(gv[i].y, iv[q].y, s);
          s = fmaf(gv[i].z, iv[q].z, s);
          s = fmaf(gv[i].w, iv[q].w, s);
          acc[i][q] = s;
        }
    }
    // all 16 loads of the slice in flight at once, then the stores
    if (!first) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = jt * 4 + i, k = kb * 128 + q * 32 + lane;
          acc[i][q] += (j < n_o && k < K) ? dw[(size_t)j * K + k] : 0.f;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = jt * 4 + i, k = kb * 128 + q * 32 + lane;
        if (j < n_o && k < K) dw[(size_t)j * K + k] = acc[i][q];
      }
  }
  if (db == nullptr) return;
  for (int j = threadIdx.x; j < n_o; j += TM_THREADS) {
    const float* gj = g + (size_t)j * ts;
    float s = 0.f;
    for (int r = 0; r < tr; ++r) s += gj[r];
    db[j] = first ? s : db[j] + s;
  }
}

// smem: X^T (c_x x TR); the outputs of layers 0 .. n-2 (out_l x TR each);
// two gradient buffers (max_out x TR); dX^T (c_x x TR); the staging buffer.
// ws: gridDim.x slices of n_params floats.
__global__ void __launch_bounds__(TM_THREADS)
tile_mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ dx, float* __restrict__ ws, TileMlpArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tr = a.tr, ts = a.ts, n = a.n_layers;
  float* xs = smem;
  float* hs[TM_MAX_LAYERS];
  float* p = xs + a.c_x * ts;
  for (int l = 0; l < n - 1; ++l) {
    hs[l] = p;
    p += a.out_dim[l] * ts;
  }
  float* gbuf[2] = {p, p + a.max_out * ts};
  float* dxs = p + 2 * a.max_out * ts;
  float* as = dxs + a.c_x * ts;
  float* slice = ws + (size_t)blockIdx.x * a.n_params;

  const int ntiles = (a.rows + tr - 1) / tr;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int row0 = tile * tr;
    const int nr = min(tr, a.rows - row0);
    __syncthreads();  // the previous tile is done with every buffer
    tm_build_input(xs, x, row0, nr, a);
    const int n_last = a.out_dim[n - 1];
    for (int idx = threadIdx.x; idx < a.c_x * ts; idx += blockDim.x) dxs[idx] = 0.f;
    for (int idx = threadIdx.x; idx < n_last * tr; idx += blockDim.x) {
      const int r = idx / n_last, j = idx - r * n_last;  // coalesced reads of g
      gbuf[0][j * ts + r] = r < nr ? __ldg(g + (size_t)(row0 + r) * n_last + j) : 0.f;
    }
    // forward recompute, keeping every hidden output
    for (int l = 0; l < n - 1; ++l) {
      const KSegs in = tm_layer_input(a, l, xs, l > 0 ? hs[l - 1] : xs);
      tm_gemm<true>(a.w[l], a.out_dim[l], a.in_dim[l], in, tr, as, a.stage_ld,
                    TmEpiHidden{hs[l], a.b[l], ts});
    }
    // backward, layer n-1 down to 0
    int cur = 0;
    size_t off = 0;
    size_t offs[TM_MAX_LAYERS];
    for (int l = 0; l < n; ++l) {
      offs[l] = off;
      off += (size_t)a.out_dim[l] * a.in_dim[l];
    }
    for (int l = n - 1; l >= 0; --l) {
      const KSegs in = tm_layer_input(a, l, xs, l > 0 ? hs[l - 1] : xs);
      float* dwl = slice + offs[l];
      float* dbl = slice + off;
      for (int l2 = 0; l2 < l; ++l2) dbl += a.out_dim[l2];
      tm_weight_grads(dwl, dbl, gbuf[cur], a.out_dim[l], in, a.in_dim[l], tr, first);
      const bool has_x = l == 0 || ((a.skip_mask >> l) & 1);
      const float* hprev = l > 0 ? hs[l - 1] : xs;
      // dIn = g . W_l: output index o over in_dim, reduction over out_dim
      tm_gemm<false>(a.w[l], a.in_dim[l], a.out_dim[l],
                     KSegs{gbuf[cur], a.out_dim[l], gbuf[cur], 0, ts}, tr, as, a.stage_ld,
                     TmEpiDin{dxs, gbuf[cur ^ 1], hprev, has_x ? a.c_x : 0, ts});
      cur ^= 1;
    }
    for (int idx = threadIdx.x; idx < nr * a.c_x; idx += blockDim.x) {
      const int r = idx / a.c_x, c = idx - r * a.c_x;
      dx[(size_t)(row0 + r) * a.c_x + c] = dxs[c * ts + r];
    }
  }
}

// ------------------------------------------------------------------ launch

static int tm_fill_args(TileMlpArgs& a, const void* const* w, const void* const* b,
                        const int* in_dim, const int* out_dim, int n_layers, int c_x, int rows,
                        int tr, int skip_mask) {
  if (n_layers < 1 || n_layers > TM_MAX_LAYERS || rows < 1 || c_x < 1 || tr < 4 || tr % 4 != 0 ||
      (skip_mask & 1))
    return (int)cudaErrorInvalidValue;
  a.n_layers = n_layers;
  a.c_x = c_x;
  a.rows = rows;
  a.tr = tr;
  a.ts = tr + 4;
  a.skip_mask = skip_mask;
  int max_out = 0, max_w = 0, n_params = 0;
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(w[l]);
    a.b[l] = static_cast<const float*>(b[l]);
    a.in_dim[l] = in_dim[l];
    a.out_dim[l] = out_dim[l];
    const int want_in = (l == 0 ? 0 : out_dim[l - 1]) + ((l == 0 || ((skip_mask >> l) & 1)) ? a.c_x : 0);
    if (in_dim[l] != want_in || out_dim[l] < 1) return (int)cudaErrorInvalidValue;
    max_out = out_dim[l] > max_out ? out_dim[l] : max_out;
    max_w = in_dim[l] > max_w ? in_dim[l] : max_w;
    n_params += out_dim[l] * (in_dim[l] + 1);
  }
  max_w = max_out > max_w ? max_out : max_w;
  if (TM_KC * tm_round4(max_w) > TM_STAGE_REGS * TM_THREADS) return (int)cudaErrorInvalidValue;
  a.max_out = max_out;
  a.stage_ld = (max_w + 31) / 32 * 32 + 4;  // rows 16-byte aligned, staggered banks
  a.n_params = n_params;
  return 0;
}

static size_t tm_bwd_smem(const TileMlpArgs& a) {
  size_t hidden = 0;
  for (int l = 0; l < a.n_layers - 1; ++l) hidden += a.out_dim[l];
  return sizeof(float) * ((size_t)a.ts * (2 * a.c_x + hidden + 2 * a.max_out) +
                          (size_t)TM_KC * a.stage_ld);
}

static int tm_set_smem(const void* kernel, size_t smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// grads: n_params floats, every dW_l (out_l, in_l) then every db_l
static int tm_launch_bwd(const float* x, const float* g, float* dx, float* ws, float* grads,
                         const TileMlpArgs& a, int grid, void* stream) {
  // every slice must be written by its block's first tile
  if (grid < 1 || grid > (a.rows + a.tr - 1) / a.tr) return (int)cudaErrorInvalidValue;
  const size_t smem = tm_bwd_smem(a);
  int err = tm_set_smem((const void*)tile_mlp_bwd_kernel, smem);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_mlp_bwd_kernel<<<grid, TM_THREADS, smem, s>>>(x, g, dx, ws, a);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int blocks = (a.n_params + HM_THREADS - 1) / HM_THREADS;
  hm_reduce_kernel<<<blocks, HM_THREADS, 0, s>>>(ws, grid, a.n_params, grads);
  return (int)cudaGetLastError();
}
