// K3f: forward of the fused ReLU MLP, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel lab4d_tpu/ops/mlp_kernel.py:_fwd_kernel
// (entry fused_relu_mlp). It computes D+1 dense fp32 layers with ReLU
// between them, re-concatenates the input before each skip layer as
// [x, h], and applies an optional final ReLU.
//
// What bounds it on the card: the rendering path calls it on a handful of
// rows (1 per rendered frame, 2 for the articulation's batched t/rest
// pass, the frame count when cameras are queried), at C_in = W = 256 with
// D = 5 (camera, articulation, intrinsics) and W = 64 with D = 2
// (appearance). At one to eight rows every weight is used once per row:
// the kernel streams ~1.5 MB of fp32 weights for a few KFLOP, so it is
// bound by memory latency and launch count, not by arithmetic, and a
// tensor-core tile of 64 rows would sit almost empty. A single block per
// row tile is latency-bound on one SM (a first design measured 191 us
// against 23 us for six cuBLAS calls on the same H100).
//
// What the design does about it: a thread-block cluster of 8 blocks on 8
// SMs works on one tile of 8 rows and runs every layer, so the whole MLP
// is one launch and the activations never leave shared memory. Each block
// computes 1/8 of a layer's output columns and stores them into the
// shared memory of all 8 blocks (distributed shared memory); one cluster
// barrier per layer orders the layers. Weights stay in the
// torch.nn.Linear layout (out, in). Each warp owns 4 output columns at a
// time; every lane first issues all its float4 weight loads for those
// columns (coalesced 16-byte chunks, up to 8 in flight per lane), then
// FMAs them against float4 reads of the 8 activation rows in shared
// memory, and the 4 x 8 partial sums are reduced across the warp with a
// 31-shuffle reduce-scatter, after which lane l holds column l / 8, row
// l % 8. fp32 FMA throughout, no TF32. The input tile is staged into the
// leading columns of both ping-pong buffers, so a skip layer reads [x, h]
// as one contiguous row. Layers whose widths or pointers are not 16-byte
// aligned take the same path with scalar loads.
//
// This library also holds K3b, the VJP of this MLP on the training path
// (lab4d_relu_mlp_tile_bwd): the row-tiled fp32 backward of mlp_tiles.cuh,
// whose design and bound are described there.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tiles.cuh"

namespace cg = cooperative_groups;

#define MLP_MAX_LAYERS 16
#define MLP_TILE_ROWS 8
#define MLP_CLUSTER 8
#define MLP_THREADS 256
#define MLP_COLS_PER_WARP 4
static_assert(MLP_COLS_PER_WARP * MLP_TILE_ROWS == 32, "one partial sum per lane");

struct MlpArgs {
  const float* w[MLP_MAX_LAYERS];  // (out_l, in_l), row-major
  const float* b[MLP_MAX_LAYERS];  // (out_l,)
  int in_dim[MLP_MAX_LAYERS];
  int out_dim[MLP_MAX_LAYERS];
  int n_layers;
  int c_in;
  int rows;
  int ld;         // shared-memory row stride: c_in + widest hidden layer, rounded up to 4
  int skip_mask;  // bit l set: layer l reads [x, h]
  int final_act;
};

// v[i] holds a lane's partial sum of value i; afterwards v[0] of lane l is
// the sum over the warp of value l (butterfly reduce-scatter).
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[32], int lane) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const bool upper = lane & s;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = upper ? v[i] : v[i + s];
      const float keep = upper ? v[i + s] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
}

__device__ __forceinline__ void fma4(float& acc, const float4& h, const float4& w) {
  acc = fmaf(h.x, w.x, acc);
  acc = fmaf(h.y, w.y, acc);
  acc = fmaf(h.z, w.z, acc);
  acc = fmaf(h.w, w.w, acc);
}

// Partial sums v[q * 8 + r] of columns jb + q (clamped to the last column)
// and rows r over this lane's share of the `in` inputs.
__device__ __forceinline__ void partial_dots(float (&v)[32], const float* __restrict__ W,
                                             const float* src, int ld, int in, int out,
                                             int jb, int lane, bool vec) {
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = 0.f;
  const float* wrow[MLP_COLS_PER_WARP];
#pragma unroll
  for (int q = 0; q < MLP_COLS_PER_WARP; ++q) wrow[q] = W + (size_t)min(jb + q, out - 1) * in;
  if (vec) {
    // 2 chunks of 128 inputs per pass: all 8 weight loads are issued first
    for (int k0 = lane * 4; k0 < in; k0 += 256) {
      float4 w[MLP_COLS_PER_WARP][2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = k0 + c * 128;
#pragma unroll
        for (int q = 0; q < MLP_COLS_PER_WARP; ++q)
          w[q][c] = k < in ? __ldg(reinterpret_cast<const float4*>(wrow[q] + k))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = k0 + c * 128;
        if (k < in) {
#pragma unroll
          for (int r = 0; r < MLP_TILE_ROWS; ++r) {
            const float4 h = *reinterpret_cast<const float4*>(src + r * ld + k);
#pragma unroll
            for (int q = 0; q < MLP_COLS_PER_WARP; ++q) fma4(v[q * MLP_TILE_ROWS + r], h, w[q][c]);
          }
        }
      }
    }
  } else {
#pragma unroll 2
    for (int k = lane; k < in; k += 32) {
      float w[MLP_COLS_PER_WARP];
#pragma unroll
      for (int q = 0; q < MLP_COLS_PER_WARP; ++q) w[q] = __ldg(wrow[q] + k);
#pragma unroll
      for (int r = 0; r < MLP_TILE_ROWS; ++r) {
        const float h = src[r * ld + k];
#pragma unroll
        for (int q = 0; q < MLP_COLS_PER_WARP; ++q)
          v[q * MLP_TILE_ROWS + r] = fmaf(h, w[q], v[q * MLP_TILE_ROWS + r]);
      }
    }
  }
}

__global__ void __cluster_dims__(MLP_CLUSTER, 1, 1) __launch_bounds__(MLP_THREADS)
fused_relu_mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ y, MlpArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ld = a.ld;
  const int buf_stride = MLP_TILE_ROWS * ld;  // ping-pong buffers at smem, smem + buf_stride
  const int row0 = (blockIdx.x / MLP_CLUSTER) * MLP_TILE_ROWS;
  const int nr = min(MLP_TILE_ROWS, a.rows - row0);

  // every block stages x into columns [0, c_in) of both of its buffers;
  // rows past the end are 0
  for (int i = threadIdx.x; i < MLP_TILE_ROWS * a.c_in; i += blockDim.x) {
    const int r = i / a.c_in, c = i - r * a.c_in;
    const float v = r < nr ? x[(size_t)(row0 + r) * a.c_in + c] : 0.f;
    smem[r * ld + c] = v;
    smem[buf_stride + r * ld + c] = v;
  }
  float* peer[MLP_CLUSTER];  // the shared memory of every block of the cluster
#pragma unroll
  for (int p = 0; p < MLP_CLUSTER; ++p) peer[p] = cluster.map_shared_rank(smem, p);
  cluster.sync();  // all blocks staged and running before any remote store

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int my_col = lane / MLP_TILE_ROWS, my_row = lane % MLP_TILE_ROWS;
  int cur = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int in = a.in_dim[l], out = a.out_dim[l];
    const bool last = l == a.n_layers - 1;
    const bool relu = !last || a.final_act;
    // layer 0 reads x; a skip layer reads [x, h]; any other layer reads h
    const int start = (l == 0 || ((a.skip_mask >> l) & 1)) ? 0 : a.c_in;
    const float* src = smem + cur * buf_stride + start;
    const int dst_off = (cur ^ 1) * buf_stride + a.c_in;
    const float* __restrict__ W = a.w[l];
    const bool vec = (in % 4 == 0) && (start % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(W) % 16 == 0);
    // this block's share of the output columns
    const int per_block = (out + MLP_CLUSTER - 1) / MLP_CLUSTER;
    const int c0 = rank * per_block, c1 = min(out, c0 + per_block);
    for (int jb = c0 + warp * MLP_COLS_PER_WARP; jb < c1; jb += nwarps * MLP_COLS_PER_WARP) {
      float v[32];
      partial_dots(v, W, src, ld, in, out, jb, lane, vec);
      warp_reduce_scatter(v, lane);
      const int j = jb + my_col;
      if (j < c1) {
        float o = v[0] + __ldg(a.b[l] + j);
        if (relu) o = fmaxf(o, 0.f);
        if (last) {
          if (my_row < nr) y[(size_t)(row0 + my_row) * out + j] = o;
        } else {
#pragma unroll
          for (int p = 0; p < MLP_CLUSTER; ++p) peer[p][dst_off + my_row * ld + j] = o;
        }
      }
    }
    cluster.sync();  // layer l complete in every block before layer l + 1 reads it
    cur ^= 1;
  }
}

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// w and b hold n_layers device pointers; shapes are checked by the caller.
int lab4d_fused_relu_mlp_fwd(const float* x, float* y, const void* const* w,
                             const void* const* b, const int* in_dim, const int* out_dim,
                             int n_layers, int c_in, int rows, int skip_mask,
                             int final_act, void* stream) {
  if (n_layers < 1 || n_layers > MLP_MAX_LAYERS || rows < 1 || c_in < 1)
    return (int)cudaErrorInvalidValue;
  MlpArgs a;
  int widest = 0;
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(w[l]);
    a.b[l] = static_cast<const float*>(b[l]);
    a.in_dim[l] = in_dim[l];
    a.out_dim[l] = out_dim[l];
    if (l < n_layers - 1 && out_dim[l] > widest) widest = out_dim[l];
  }
  a.n_layers = n_layers;
  a.c_in = c_in;
  a.rows = rows;
  a.ld = (c_in + widest + 3) / 4 * 4;  // rows start 16-byte aligned
  a.skip_mask = skip_mask;
  a.final_act = final_act;

  const size_t smem = 2 * (size_t)MLP_TILE_ROWS * a.ld * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_relu_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned tiles = (unsigned)((rows + MLP_TILE_ROWS - 1) / MLP_TILE_ROWS);
  fused_relu_mlp_fwd_kernel<<<tiles * MLP_CLUSTER, MLP_THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(x, y, a);
  return (int)cudaGetLastError();
}

// K3b: dx (rows, c_in) and grads (every dW_l, then every db_l) of the MLP
// for the output gradient g (rows, out_last), already masked by the final
// ReLU. ws: grid * n_params floats of scratch, grid <= ceil(rows / tr).
int lab4d_relu_mlp_tile_bwd(const float* x, const float* g, float* dx, float* ws, float* grads,
                            const void* const* w, const void* const* b, const int* in_dim,
                            const int* out_dim, int n_layers, int c_in, int rows, int tr,
                            int skip_mask, int grid, void* stream) {
  TileMlpArgs a;
  int err = tm_fill_args(a, w, b, in_dim, out_dim, n_layers, c_in, rows, tr, skip_mask);
  if (err) return err;
  return tm_launch_bwd(x, g, dx, ws, grads, a, grid, stream);
}

const char* lab4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
