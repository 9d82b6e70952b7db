// K3f and K3b: the fused ReLU MLP, forward and backward, hand-written for
// Hopper (sm_90a), on two engines behind the same entry points.
//
// K3f replaces the Pallas kernel lab4d_tpu/ops/mlp_kernel.py:_fwd
// (_fwd_kernel); K3b replaces _bwd (_bwd_kernel). Semantics are theirs: D+1
// dense fp32 layers, ReLU between them, the input re-concatenated before
// each skip layer as [x, h], an optional ReLU on the output; the backward
// returns dx, every dW and every db. The final ReLU's mask on the incoming
// gradient is applied by the caller, as the JAX VJP does. Weights stay in
// the torch.nn.Linear layout (out, in). K3f saves every hidden layer's
// output after its ReLU when autograd needs it (the caller decides), layer
// l's block a row-major (rows, out_l) array at act_off[l] * rows floats
// (K4f's layout); K3b reads those and recomputes no forward.
//
// Two kinds of callers, and an engine for each (ops/mlp_kernel.py
// relu_mlp_plan picks by row count; the crossover, 1,024 rows, is measured
// by tools/profile_k4b_phases.py --k3_sweep):
// - the TimeMLPs (camera, intrinsics, articulation: D5 W256, 1.57 MB of
//   weights; appearance D2 W64) on 1 to 512 rows: the cluster engine (rm_*);
// - the warps' CondMLPs at every sample of a training step, 262,144 rows
//   (the dense warp's maps, 167 inputs -> D6 W256 with x again at layer 4
//   -> 3; the composed warp's post-warp, D2 W256): the row engine (rw_*).
//
// The cluster engine. What bounds it: at 256 rows the forward is 201 MFLOP
// (3.0 us on fp32 FMA, 1.2 us in 3xTF32 on the tensor cores) and the
// backward from saved layer outputs twice that; at 1 row the weights, read
// once, bound it (0.47 us). Every layer depends on the one before, so what
// the card waits on is the latency of each layer's weights, of its short
// product chain and of the barrier between layers, not arithmetic (PERF.md
// prices each with the anatomy copies of tools/profile_k4b_phases.py); and
// a block that streams all 1.57 MB from L2 alone needs ~15 us for it.
// What its design does about it:
// - A cluster of 8 blocks on 8 SMs carries one tile of rows through every
//   layer, in one launch. Each block owns 1/8 of a layer's output columns
//   (the forward) or input columns (the backward's dIn), so it reads only
//   its 1/8 of the weights, and it stores its columns into the shared
//   memory of all 8 blocks (distributed shared memory); one cluster
//   barrier per layer orders the layers.
// - Each block stages its slice of the weights by cp.async into a ring of
//   slabs in shared memory, as many layers ahead as fit (every layer at
//   render rows), before layer 0 runs: no layer waits for its weights
//   after the first.
// - Up to 8 rows (the render), the forward runs fp32 FMA on a tile of 8
//   rows: a 16-row tensor-core tile would be almost empty. Each warp takes
//   4 columns; its lanes split the inputs and a butterfly reduce-scatter
//   leaves lane l with column l / 8 of row l % 8.
// - Past 8 rows, both directions run on 32-row tiles (two m16 tiles,
//   so that 256 rows take 8 clusters: one wave, where 16 clusters of
//   16-row tiles took two) with 3xTF32 mma.sync products (heads_mma.cuh:
//   each fp32 operand split into tf32 hi + lo, three products per k-step
//   summed into an fp32 register); the 16 warps of a block split the
//   reduction, and their partial sums are added in a fixed order through
//   shared memory.
// - K3b is two launches: dIn through every layer on K3f's cluster tiles
//   (each layer's masked gradient G stored for dW; dx summed over the
//   cluster in rank order), then every layer's dW = G^T A and db = sum G at
//   once, straight into the gradient. Up to 512 rows each 32 x 32 output
//   tile is one block that stages all rows of its operands at once and
//   splits them over its warps (rm_dw_rows_kernel). More rows take
//   hm_dw_tile's 64 x 64 tiles over chunks of rows, into workspace slices
//   summed in chunk order by hm_reduce_kernel (a third launch).
//
// The row engine. What bounds it: the products. The dense map is 414k
// multiply-adds per row, 217 GFLOP forward per call: 3.2 ms on fp32 FMA,
// 1.3 ms in 3xTF32 at the tensor cores' TF32 rate; K3b twice that. At many
// rows the cluster engine's tiles re-stage all weights per 32 rows (12 GB
// from L2 per call) and wait at a cluster barrier per layer: it ran at 12%
// of the fp32 bound and lost 3x to the plain per-layer chain. What its
// design does about it:
// - One block of two warpgroups per SM (persistent) walks tiles of 64 rows
//   and carries each through every layer: the tile's x and hidden layer
//   stay in shared memory; only the output, the saved outputs and K3b's G
//   go to device memory. 64 rows halve the weights' L2 traffic of 32-row
//   tiles (13.6 GB per dense call in hi and lo, under the products); 128
//   rows do not fit: x, h and a ring of weight slabs fill 210 KB of the
//   227.
// - The products are wgmma.mma_async m64n128k8 (m64n8k8 for a last layer
//   of at most 16 outputs; the primitives are csrc/wgmma.cuh's) in
//   3xTF32: A (the tile's rows) from registers, split once per slab by rw_split (hi = x cut to tf32, lo = the rest: two
//   instructions); B from shared memory, the weights split once per call
//   by rw_pack_kernel into slabs laid out as wgmma's K-major core matrices
//   (no swizzle). Each warpgroup takes 128 of a layer's 256 columns; a
//   slab's three products per k8 step accumulate in the tensor core from
//   zero, and the slab's sum (16 of K) is added to fp32 registers, which
//   bounds what the tensor core's accumulation can lose
//   (tests/test_torch_mlp_kernel.py emulates it).
// - The weight slabs (16 of K x 256 columns, hi and lo: 32 KB) stream
//   through a ring of 3 slots by 1D bulk copies of the TMA unit, completing
//   on mbarriers; the last warp to finish with a slot refills it, so no
//   warp waits on a producer and all 255 registers a thread may hold are
//   the products'. The slabs form one stream across layers and tiles.
// - A hidden layer's pass keeps its columns in registers until both
//   warpgroups are done reading the layer's input, then bias, ReLU and the
//   store go into the same shared buffer (the biases are staged once) and,
//   when saving, to device memory in 8-byte streaming stores. (Stores or
//   shared-memory loads moved under the next products to hide them made
//   the engine slower: wgmma reads B from the same shared memory.)
// - K3b's dIn runs the same engine through the layers last to first over
//   W^T's slabs (x's columns first, into a dx accumulator, then h's), with
//   the ReLU masks read from K3f's saved outputs; G_{l-1} goes from
//   shared memory to device memory split into hi and lo, in the K-major
//   core-matrix slabs dW's wgmma reads (coalesced 16-byte stores). dW =
//   G^T A is a wgmma product over chunks of rows, 128 inputs x 128 outputs
//   per block: A^T's fragments from the saved outputs in registers (loaded
//   one slab ahead), G's slabs through a ring of 4 by the TMA unit; each
//   32-row slab's sum is added to fp32, the chunks' slices summed in chunk
//   order by hm_reduce_kernel; db is the sum of G's hi + lo in row order.
//   (G stored in fp32 and split by dW's threads made dIn 0.7 ms faster and
//   dW 2 ms slower at the dense map.) K3f is two launches (the split, the
//   engine), K3b four.
//
// No float atomics on values: every sum across warps, blocks and chunks
// runs in a fixed order, and the result is the same from run to run.
// Layers take at most 512 inputs and outputs (the cluster engine) or 256
// outputs and x of 256 (the row engine); the buffers of their widths must
// fit in shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "heads_mma.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

#define RM_MAX_LAYERS 16
#define RM_CLUSTER 8     // blocks of a cluster, each 1/8 of a layer's columns
#define RM_WARPS 16      // a block of the cluster kernels
#define RM_THREADS (32 * RM_WARPS)
#define RM_PART (RM_WARPS * 16 * RM_PLD)  // floats of the warps' partial sums
#define RM_DW_WARPS 8    // a block of rm_dw_rows_kernel
#define RM_FMA_ROWS 8    // the forward's fp32 FMA tile: up to this many rows
#define RM_MMA_ROWS 32   // the 3xTF32 tile of both directions: two m16 tiles
#define RM_PLD 36        // row stride of a warp's partial sums (32 columns + 4)
#define RM_MAX_WIDTH 512 // widest layer input or output: 64 columns per block
#define RM_SMEM (227 * 1024)
#define RM_DW_ROWS 512   // K3b's dW from every row at once up to this many rows
#define RM_DW_LD 40      // row stride of its staged operands (8 mod 32: conflict-free fragments)

struct RmArgs {
  const float* w[RM_MAX_LAYERS];  // (out_l, in_l), row-major
  const float* b[RM_MAX_LAYERS];  // (out_l,)
  int in_dim[RM_MAX_LAYERS];
  int out_dim[RM_MAX_LAYERS];
  int n_layers, c_in, rows, skip_mask, final_act;
  int tr;      // rows per tile
  int stages;  // slabs in the ring: layers whose weights are in flight
  int lda;     // row stride of the hidden (K3f) or gradient (K3b) buffers
  int ldx;     // row stride of the x buffer (K3f) or the dx accumulator (K3b)
  int slab;    // floats per slab
  int nb[RM_MAX_LAYERS];   // columns a block owns: layer l's outputs (K3f) or inputs (K3b)
  int ldb[RM_MAX_LAYERS];  // row stride of layer l's slab
  int act_off[RM_MAX_LAYERS];  // floats per row before layer l's saved block
  int off_w[RM_MAX_LAYERS];    // layer l's dW (out, in) in the gradients
  int off_b[RM_MAX_LAYERS];    // and its db, after every dW
  int dw_tile0[RM_MAX_LAYERS + 1];  // the first dW block of layer l; [n_layers]: all
  int dw32_tile0[RM_MAX_LAYERS + 1];  // the same for 32 x 32 tiles (rm_dw_rows_kernel)
  int act_total, n_params, pc, n_chunks;
};

__host__ __device__ __forceinline__ int rm_round(int n, int m) { return (n + m - 1) / m * m; }

// Row stride of a k-major slab of n columns: 8 mod 32 floats, so that the
// B fragment loads (lanes 4 apart along k) hit 32 distinct banks
__host__ __device__ __forceinline__ int rm_ldk(int n) { return n + ((8 - n) % 32 + 32) % 32; }

__device__ __forceinline__ bool rm_skip(const RmArgs& a, int l) {
  return l > 0 && ((a.skip_mask >> l) & 1);
}

template <int N>
__device__ __forceinline__ void rm_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Wait until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void rm_cp_wait(int n) {
  switch (n) {
    case 0: rm_wait_group<0>(); break;
    case 1: rm_wait_group<1>(); break;
    case 2: rm_wait_group<2>(); break;
    case 3: rm_wait_group<3>(); break;
    case 4: rm_wait_group<4>(); break;
    case 5: rm_wait_group<5>(); break;
    case 6: rm_wait_group<6>(); break;
    case 7: rm_wait_group<7>(); break;
    default: rm_wait_group<0>(); break;
  }
}

// Operands in shared memory, zero at and past K along the reduction.
// RmIn, a layer input: A(m, k) = s1[m * ld1 + k] for k < k1, then
// s2[m * ld2 + k - k1] (a skip layer's [x, h]); RmBRows: B(k, n) =
// s[n * ld + k] (the rows of W a block's outputs take); RmBCols: B(k, n) =
// s[k * ld + n] (the columns of W a block's inputs take)
struct RmIn {
  const float* s1;
  int ld1, k1;
  const float* s2;
  int ld2, K;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return k < k1 ? s1[m * ld1 + k] : (k < K ? s2[m * ld2 + (k - k1)] : 0.f);
  }
};
struct RmAT {  // A(m, k) = s[k * ld + m]: G's columns, row after row
  const float* s;
  int ld, K;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return k < K ? s[k * ld + m] : 0.f;
  }
};
struct RmBRows {
  const float* s;
  int ld, K;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return k < K ? s[n * ld + k] : 0.f;
  }
};
struct RmBCols {
  const float* s;
  int ld, K;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return k < K ? s[k * ld + n] : 0.f;
  }
};

// c[j] += the k-steps k8_0, k8_0 + kstep, ... of A (rows m0 .. m0 + 15)
// . B (columns n0 + 8 j ..) for j < NV, in 3xTF32. NV is a compile-time
// count, so the NV product chains unroll without branches and interleave.
template <int NV, class AOp, class BOp>
__device__ __forceinline__ void rm_mma_steps(float (&c)[4][4], const AOp& A, const BOp& B, int K,
                                             int k8_0, int kstep, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k8 = k8_0; k8 < K; k8 += kstep) {
    uint32_t ah[4], al[4];
    hm_frag_a(A, k8, m0, ah, al);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      hm_split(B(k8 + t, n0 + 8 * j + g), bh0, bl0);
      hm_split(B(k8 + t + 4, n0 + 8 * j + g), bh1, bl1);
      hm_mma3(c[j], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// out (32 x cnt) = A (32 x K) . B (K x cnt) in 3xTF32 on a block of WARPS
// warps: each warp takes one 16-row half, one of ceil(nb / 32) units of 32
// columns and every S-th k-step (S = WARPS / 2 / units); the partial sums
// meet in `part` (WARPS x 16 x RM_PLD floats, which may alias the
// operands: it is written after every warp's products) and are added in
// warp order; emit(m, n, value) for every m < 32, n < cnt.
template <int WARPS, class AOp, class BOp, class Emit>
__device__ __forceinline__ void rm_mma_layer(const AOp& A, const BOp& B, int K, int nb, int cnt,
                                             float* part, const Emit& emit) {
  const int warp = threadIdx.x >> 5;
  const int units = (nb + 31) / 32, S = WARPS / 2 / units;
  const int h = warp & 1, u = (warp >> 1) % units, s = (warp >> 1) / units;
  const int n0 = 32 * u, nv = hm_nv(cnt, n0);
  float c[4][4];
  hm_zero(c);
  switch (nv) {
    case 4: rm_mma_steps<4>(c, A, B, K, 8 * s, 8 * S, 16 * h, n0); break;
    case 3: rm_mma_steps<3>(c, A, B, K, 8 * s, 8 * S, 16 * h, n0); break;
    case 2: rm_mma_steps<2>(c, A, B, K, 8 * s, 8 * S, 16 * h, n0); break;
    case 1: rm_mma_steps<1>(c, A, B, K, 8 * s, 8 * S, 16 * h, n0); break;
    default: break;
  }
  __syncthreads();  // every warp is done with the operands
  if (nv > 0)
    hm_store(c, 0, 0, nv, 32, [&](int m, int n, float v) {
      part[(warp * 16 + m) * RM_PLD + n] = v;
    });
  __syncthreads();
  for (int o = threadIdx.x; o < RM_MMA_ROWS * cnt; o += 32 * WARPS) {
    const int m = o / cnt, n = o - m * cnt, un = n >> 5, hh = m >> 4, ml = m & 15;
    float v = 0.f;
    for (int ss = 0; ss < S; ++ss)
      v += part[((hh + 2 * (un + units * ss)) * 16 + ml) * RM_PLD + n - 32 * un];
    emit(m, n, v);
  }
}

// One butterfly stage of rm_reduce_scatter: lanes with bit S set keep the
// upper S values, the others the lower, each adding its partner's
template <int S>
__device__ __forceinline__ void rm_rs_stage(float (&v)[32], bool upper) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float lo = v[i], hi = v[i + S];
    v[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, S);
  }
}

// v[i] holds a lane's partial sum of value i; afterwards v[0] of lane l is
// the sum over the warp of value l (butterfly reduce-scatter). The stages
// are compile-time, so every index is fixed and v stays in registers.
__device__ __forceinline__ void rm_reduce_scatter(float (&v)[32], int lane) {
  rm_rs_stage<16>(v, lane & 16);
  rm_rs_stage<8>(v, lane & 8);
  rm_rs_stage<4>(v, lane & 4);
  rm_rs_stage<2>(v, lane & 2);
  rm_rs_stage<1>(v, lane & 1);
}

// out (8 x cnt) = A (8 x K) . B (K x cnt) in fp32 FMA, B's rows of W at
// wsl[n * ldb + k]: each warp takes 4 columns at a time, its lanes every
// 32nd input; emit(m, n, value) for every m < 8, n < cnt.
template <class Emit>
__device__ __forceinline__ void rm_fma_layer(const RmIn& in, const float* wsl, int ldb, int cnt,
                                             const Emit& emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int jb = 4 * warp; jb < cnt; jb += 4 * RM_WARPS) {
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.f;
    const float* wr[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wr[q] = wsl + min(jb + q, cnt - 1) * ldb;
    for (int k = lane; k < in.K; k += 32) {
      const float* src = k < in.k1 ? in.s1 + k : in.s2 + (k - in.k1);
      const int ld = k < in.k1 ? in.ld1 : in.ld2;
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = wr[q][k];
#pragma unroll
      for (int r = 0; r < RM_FMA_ROWS; ++r) {
        const float h = src[r * ld];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q * RM_FMA_ROWS + r] = fmaf(h, w[q], v[q * RM_FMA_ROWS + r]);
      }
    }
    rm_reduce_scatter(v, lane);
    const int n = jb + lane / RM_FMA_ROWS;
    if (n < cnt) emit(lane % RM_FMA_ROWS, n, v[0]);
  }
}

// ------------------------------------------------------------------ K3f

// One cluster per tile of a.tr rows (FMA: 8, else 32). smem: the block's
// biases of every layer (RM_MAX_LAYERS x 64, loaded once), x (tr x ldx),
// two buffers of the hidden layer (tr x ldh), the warps' partial sums
// (3xTF32 only), the ring of weight slabs (slab l: the block's nb_l rows
// of W_l, each in_l floats). acts: null, or the saved layout.
template <bool FMA>
__global__ void __cluster_dims__(RM_CLUSTER, 1, 1) __launch_bounds__(RM_THREADS, 1)
rm_fwd_kernel(const __grid_constant__ RmArgs a, const float* __restrict__ x, float* __restrict__ y,
              float* __restrict__ acts) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), tid = threadIdx.x;
  constexpr int TR = FMA ? RM_FMA_ROWS : RM_MMA_ROWS;
  const int ldx = a.ldx, ldh = a.lda, L = a.n_layers, S = a.stages, c_in = a.c_in;
  float* sb = smem + TR * ldx;  // sb[l * 64 + n]: the bias of the block's column n of layer l
  float* hbuf = sb + RM_MAX_LAYERS * 64;  // two buffers of TR x ldh
  float* part = hbuf + 2 * TR * ldh;
  float* slabs = part + (FMA ? 0 : RM_PART);
  const int row0 = (blockIdx.x / RM_CLUSTER) * TR;
  const int nr = min(TR, a.rows - row0);

  auto stage = [&](int l) {  // the block's rows of W_l into slab l % S
    const int N = a.out_dim[l], K = a.in_dim[l], nb = a.nb[l], ldb = a.ldb[l];
    const int c0 = rank * nb, cnt = min(nb, N - c0);
    const float* W = a.w[l] + (size_t)max(c0, 0) * K;
    float* dst = slabs + (l % S) * a.slab;
    if ((K & 3) == 0 && (reinterpret_cast<uintptr_t>(a.w[l]) & 15) == 0) {
      const int q = K / 4;
      for (int e = tid; e < cnt * q; e += RM_THREADS) {
        const int n = e / q, k = (e - n * q) * 4;
        hm_cp16(dst + n * ldb + k, W + (size_t)n * K + k);
      }
    } else {
      for (int e = tid; e < cnt * K; e += RM_THREADS) {
        const int n = e / K, k = e - n * K;
        hm_cp4(dst + n * ldb + k, W + (size_t)n * K + k, true);
      }
    }
    hm_cp_commit();
  };
  for (int l = 0; l < S && l < L; ++l) stage(l);

  for (int i = tid; i < TR * c_in; i += RM_THREADS) {  // rows past the end are 0
    const int r = i / c_in, c = i - r * c_in;
    smem[r * ldx + c] = r < nr ? __ldg(x + (size_t)(row0 + r) * c_in + c) : 0.f;
  }
  for (int i = tid; i < L * 64; i += RM_THREADS) {
    const int l = i >> 6, j = rank * a.nb[l] + (i & 63);
    sb[i] = (i & 63) < a.nb[l] && j < a.out_dim[l] ? __ldg(a.b[l] + j) : 0.f;
  }
  float* peer[RM_CLUSTER];  // the shared memory of every block of the cluster
#pragma unroll
  for (int p = 0; p < RM_CLUSTER; ++p) peer[p] = cluster.map_shared_rank(smem, p);
  cluster.sync();  // every block staged and running before any remote store

  int cur = 0;
  for (int l = 0; l < L; ++l) {
    const int N = a.out_dim[l], K = a.in_dim[l], nb = a.nb[l], ldb = a.ldb[l];
    const int c0 = rank * nb, cnt = min(nb, N - c0);
    const bool last = l == L - 1, relu = !last || a.final_act;
    rm_cp_wait(min(L, l + S) - l - 1);
    __syncthreads();  // slab l is in
    // layer 0 reads x, a skip layer [x, h], any other layer h
    const float* hc = hbuf + cur * TR * ldh;
    const RmIn in = l == 0 ? RmIn{smem, ldx, c_in, smem, ldx, c_in}
                  : rm_skip(a, l) ? RmIn{smem, ldx, c_in, hc, ldh, K}
                                  : RmIn{hc, ldh, K, hc, ldh, K};
    const float* wsl = slabs + (l % S) * a.slab;
    const float* bias = sb + l * 64;
    const size_t nxt = (hbuf - smem) + (size_t)(cur ^ 1) * TR * ldh;
    float* saved = acts != nullptr && !last ? acts + (size_t)a.act_off[l] * a.rows : nullptr;
    auto emit = [&](int m, int n, float v) {
      const int j = c0 + n;
      v += bias[n];
      if (relu) v = fmaxf(v, 0.f);
      if (last) {
        if (m < nr) y[(size_t)(row0 + m) * N + j] = v;
        return;
      }
      const size_t off = nxt + m * ldh + j;
#pragma unroll
      for (int p = 0; p < RM_CLUSTER; ++p) peer[p][off] = v;
      if (saved != nullptr && m < nr) __stcs(saved + (size_t)(row0 + m) * N + j, v);
    };
    if (cnt > 0) {
      if constexpr (FMA) rm_fma_layer(in, wsl, ldb, cnt, emit);
      else rm_mma_layer<RM_WARPS>(in, RmBRows{wsl, ldb, K}, K, nb, cnt, part, emit);
    }
    cluster.sync();  // layer l complete in every block before layer l + 1 reads it
    cur ^= 1;
    if (l + S < L) stage(l + S);  // into the slab every warp of this block is done with
  }
}

// ------------------------------------------------------------------ K3b

// dIn through every layer, last to first, on 32-row tiles, one cluster
// each: G (the gradient of a layer's output) in two buffers of 32 rows;
// each block computes its nb_l input columns of dIn_l = G_l . W_l; the x
// columns are added to the block's dx accumulator, the h columns masked by
// the saved output of layer l - 1 (> 0) and stored as G_{l-1} into every
// block's next buffer and into gsave (the saved layout, for dW). Slab l:
// the block's columns of W_l (out_l rows), then its columns of the saved
// h_{l-1} for the tile's rows. At the end each block sums its share of
// dx's columns over the 8 accumulators, in rank order.
__global__ void __cluster_dims__(RM_CLUSTER, 1, 1) __launch_bounds__(RM_THREADS, 1)
rm_din_kernel(const __grid_constant__ RmArgs a, const float* __restrict__ g,
              const float* __restrict__ acts, float* __restrict__ gsave, float* __restrict__ dx) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), tid = threadIdx.x;
  constexpr int TR = RM_MMA_ROWS;
  const int lda = a.lda, ldx = a.ldx, L = a.n_layers, S = a.stages, c_in = a.c_in;
  float* dxa = smem + 2 * TR * lda;
  float* part = dxa + TR * ldx;
  float* slabs = part + RM_PART;
  const int row0 = (blockIdx.x / RM_CLUSTER) * TR;
  const int nr = min(TR, a.rows - row0);

  auto stage = [&](int i) {  // step i: layer L - 1 - i
    const int l = L - 1 - i, N = a.out_dim[l], K = a.in_dim[l], nb = a.nb[l], ldb = a.ldb[l];
    const int c0 = rank * nb, cnt = min(nb, K - c0);
    const float* W = a.w[l];
    float* dst = slabs + (i % S) * a.slab;
    if (cnt > 0) {
      if ((K & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0) {
        const int q = cnt / 4;  // K, c0 and so cnt are multiples of 4
        for (int e = tid; e < N * q; e += RM_THREADS) {
          const int n = e / q, j = (e - n * q) * 4;
          hm_cp16(dst + n * ldb + j, W + (size_t)n * K + c0 + j);
        }
      } else {
        for (int e = tid; e < N * cnt; e += RM_THREADS) {
          const int n = e / cnt, j = e - n * cnt;
          hm_cp4(dst + n * ldb + j, W + (size_t)n * K + c0 + j, true);
        }
      }
      if (l > 0) {  // the saved h_{l-1} of the block's h columns, zero past the last row
        const int xoff = rm_skip(a, l) ? c_in : 0, kh = a.out_dim[l - 1];
        const float* hprev = acts + (size_t)a.act_off[l - 1] * a.rows;
        float* hp = dst + N * ldb;
        for (int e = tid; e < TR * cnt; e += RM_THREADS) {
          const int m = e / cnt, j = e - m * cnt, k = c0 + j;
          if (k < xoff) continue;
          const bool ok = m < nr;
          hm_cp4(hp + m * ldb + j, ok ? hprev + (size_t)(row0 + m) * kh + (k - xoff) : hprev, ok);
        }
      }
    }
    hm_cp_commit();
  };
  for (int i = 0; i < S && i < L; ++i) stage(i);

  const int n_last = a.out_dim[L - 1];
  for (int i = tid; i < TR * n_last; i += RM_THREADS) {
    const int r = i / n_last, c = i - r * n_last;
    smem[r * lda + c] = r < nr ? __ldg(g + (size_t)(row0 + r) * n_last + c) : 0.f;
  }
  for (int i = tid; i < TR * c_in; i += RM_THREADS) dxa[(i / c_in) * ldx + i % c_in] = 0.f;
  float* peer[RM_CLUSTER];
#pragma unroll
  for (int p = 0; p < RM_CLUSTER; ++p) peer[p] = cluster.map_shared_rank(smem, p);
  cluster.sync();

  int cur = 0;
  for (int i = 0; i < L; ++i) {
    const int l = L - 1 - i, N = a.out_dim[l], K = a.in_dim[l], nb = a.nb[l], ldb = a.ldb[l];
    const int c0 = rank * nb, cnt = min(nb, K - c0);
    const int xoff = (l == 0 || rm_skip(a, l)) ? c_in : 0, kh = l > 0 ? a.out_dim[l - 1] : 0;
    rm_cp_wait(min(L, i + S) - i - 1);
    __syncthreads();  // slab i is in
    const float* wsl = slabs + (i % S) * a.slab;
    const float* hp = wsl + N * ldb;
    const size_t nxt = (size_t)(cur ^ 1) * TR * lda;
    float* gs = l > 0 ? gsave + (size_t)a.act_off[l - 1] * a.rows : nullptr;
    auto emit = [&](int m, int n, float v) {
      const int k = c0 + n;
      if (k < xoff) {
        dxa[m * ldx + k] += v;
        return;
      }
      const int hk = k - xoff;
      const float gv = hp[m * ldb + n] > 0.f ? v : 0.f;
#pragma unroll
      for (int p = 0; p < RM_CLUSTER; ++p) peer[p][nxt + m * lda + hk] = gv;
      if (m < nr) gs[(size_t)(row0 + m) * kh + hk] = gv;
    };
    const float* gc = smem + cur * TR * lda;
    if (cnt > 0)
      rm_mma_layer<RM_WARPS>(RmIn{gc, lda, N, gc, lda, N}, RmBCols{wsl, ldb, N}, N, nb, cnt, part,
                             emit);
    cluster.sync();  // G_{l-1} complete in every block
    cur ^= 1;
    if (i + S < L) stage(i + S);
  }

  const int cb = (c_in + RM_CLUSTER - 1) / RM_CLUSTER;
  const size_t dxo = dxa - smem;
  for (int o = tid; o < TR * cb; o += RM_THREADS) {
    const int m = o / cb, k = rank * cb + (o - m * cb);
    if (m >= nr || k >= c_in) continue;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < RM_CLUSTER; ++p) s += peer[p][dxo + m * ldx + k];
    dx[(size_t)(row0 + m) * c_in + k] = s;
  }
  cluster.sync();  // no block leaves while another reads its accumulator
}

// Every layer's dW = G^T A and db = sum G over the chunk blockIdx.y of
// a.pc rows: blockIdx.x is a 64 x 64 tile of one layer's dW (dw_tile0).
// G_l: g for the last layer, else gsave; A_l: x, [x, h_{l-1}] or h_{l-1}.
__global__ void __launch_bounds__(HM_THREADS)
rm_dw_kernel(const __grid_constant__ RmArgs a, const float* __restrict__ x,
             const float* __restrict__ g, const float* __restrict__ acts,
             const float* __restrict__ gsave, float* __restrict__ out) {
  int l = 0;
  while (l + 1 < a.n_layers && (int)blockIdx.x >= a.dw_tile0[l + 1]) ++l;
  const int N = a.out_dim[l], K = a.in_dim[l], L = a.n_layers, c = a.c_in;
  const float* G = l == L - 1 ? g : gsave + (size_t)a.act_off[l] * a.rows;
  const int kh = l > 0 ? a.out_dim[l - 1] : 0;
  const float* hprev = l > 0 ? acts + (size_t)a.act_off[l - 1] * a.rows : x;
  const HmSrc src = l == 0 ? HmSrc{x, c, c, x, c}
                  : rm_skip(a, l) ? HmSrc{x, c, c, hprev, kh}
                                  : HmSrc{hprev, kh, kh, hprev, kh};
  hm_dw_tile(blockIdx.x - a.dw_tile0[l], blockIdx.y, G, N, src, K, a.rows, a.pc, (K + 63) / 64,
             out, a.n_params, K, a.off_w[l], a.off_w[l], a.off_b[l]);
}

// Every layer's dW and db from all rows at once (rows <= RM_DW_ROWS, dW
// straight into the gradient): blockIdx.x is a 32 x 32 tile of one
// layer's dW (dw32_tile0). G's 32 columns and A's 32 columns of every row
// are staged by cp.async and waited for once; its 8 warps split the rows
// (rm_mma_layer), their partial sums added in warp order. The tiles of the
// first 32 inputs also sum G's columns over the rows for db (each warp
// every 8th row, then the 8 sums in warp order).
__global__ void __launch_bounds__(32 * RM_DW_WARPS)
rm_dw_rows_kernel(const __grid_constant__ RmArgs a, const float* __restrict__ x,
                  const float* __restrict__ g, const float* __restrict__ acts,
                  const float* __restrict__ gsave, float* __restrict__ grads) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, L = a.n_layers, c = a.c_in, R = a.rows;
  int l = 0;
  while (l + 1 < L && (int)blockIdx.x >= a.dw32_tile0[l + 1]) ++l;
  const int N = a.out_dim[l], K = a.in_dim[l], nkt = (K + 31) / 32;
  const int t = blockIdx.x - a.dw32_tile0[l], o0 = (t / nkt) * 32, c0 = (t % nkt) * 32;
  const float* G = l == L - 1 ? g : gsave + (size_t)a.act_off[l] * R;
  const int kh = l > 0 ? a.out_dim[l - 1] : 0;
  const float* hprev = l > 0 ? acts + (size_t)a.act_off[l - 1] * R : x;
  const HmSrc src = l == 0 ? HmSrc{x, c, c, x, c}
                  : rm_skip(a, l) ? HmSrc{x, c, c, hprev, kh}
                                  : HmSrc{hprev, kh, kh, hprev, kh};
  const int rp = rm_round(R, 8);
  float* sg = smem;                 // sg[p * RM_DW_LD + o]: G[p][o0 + o]
  float* sa = smem + rp * RM_DW_LD;  // sa[p * RM_DW_LD + k]: A[p][c0 + k]
  for (int e = tid; e < rp * 16; e += 32 * RM_DW_WARPS) {  // runs of 4 floats, zero past the ends
    const int op = e >= rp * 8, e2 = e - op * rp * 8, p = e2 >> 3, q = (e2 & 7) * 4;
    if (op == 0) {
      const int n = o0 + q;
      hm_cp4x4(sg + p * RM_DW_LD + q, G + (size_t)p * N + n, p < R ? N - n : 0, G);
    } else {  // a run that crosses from x into h takes four 4-byte copies
      const int k = c0 + q;
      const int run = p >= R ? 0 : k < src.k1 ? min(K, src.k1) - k : K - k;
      float* dst = sa + p * RM_DW_LD + q;
      if (run >= 4 && (reinterpret_cast<uintptr_t>(src.at(p, k)) & 15) == 0) {
        hm_cp16(dst, src.at(p, k));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = p < R && k + i < K;
          hm_cp4(dst + i, ok ? src.at(p, k + i) : src.s1, ok);
        }
      }
    }
  }
  hm_cp_commit();
  hm_cp_wait();
  __syncthreads();
  // db: warp w sums the rows w, w + 8, ... of the 32 columns (lane:
  // column), then warp 0 adds the 8 sums in warp order
  const bool do_b = c0 == 0;
  const int warp = tid >> 5, lane = tid & 31;
  float dbp = 0.f;
  if (do_b)
    for (int p = warp; p < R; p += RM_DW_WARPS) dbp += sg[p * RM_DW_LD + lane];
  const int mo = min(32, N - o0), cnt = min(32, K - c0);
  float* dw = grads + a.off_w[l] + (size_t)o0 * K + c0;
  rm_mma_layer<RM_DW_WARPS>(RmAT{sg, RM_DW_LD, R}, RmBCols{sa, RM_DW_LD, R}, R, 32, cnt, smem,
               [&](int m, int n, float v) {
                 if (m < mo) dw[(size_t)m * K + n] = v;
               });
  if (do_b) {
    __syncthreads();  // every warp is done with the partial sums in smem
    smem[tid] = dbp;
    __syncthreads();
    if (warp == 0 && o0 + lane < N) {
      float db = 0.f;
      for (int w = 0; w < RM_DW_WARPS; ++w) db += smem[w * 32 + lane];
      grads[a.off_b[l] + o0 + lane] = db;
    }
  }
}

// ------------------------------------------------------------------ the row engine

#define RW_ROWS 64       // rows of a tile: one m64 wgmma per warpgroup
#define RW_KS 16         // k-depth of a weight slab: two k8 steps
#define RW_RS 32         // rows of a G slab of the dW product: four k8 steps
#define RW_NW 128        // columns of a warpgroup's wgmma (n128) ...
#define RW_NWS 8         // ... or n8, for a last layer of at most 16 outputs
#define RW_STAGES 3      // weight slabs in flight (2 where 3 do not fit)
#define RW_DW_STAGES 4   // G slabs in flight
#define RW_THREADS 256   // two warpgroups
#define RW_WARPS (RW_THREADS / 32)
#define RW_SLAB (64 * RW_NW)       // floats of the largest slab, hi and lo
#define RW_MAX_WIDTH 256 // widest layer output and x the engine takes
#define RW_DW_M 128      // dW inputs per block: 64 per warpgroup

// One step of the engine: K3f's layer l, or K3b's dIn of layer L - 1 - s.
// A pass is 2 nw columns, nw per warpgroup; a slab RW_KS of the reduction
// for those columns, hi then lo, each [k / 4][n / 8][n % 8][k % 4] (the
// K-major core matrices of wgmma without swizzle).
struct RwStep {
  int K, kpad;      // reduction length; padded to whole slabs
  int nw;           // RW_NW or RW_NWS
  int n_pass;       // passes
  int n_xpass;      // K3b: the first passes take x's columns (into dx), the rest h's
  int x_cols, h_cols, h_src;  // K3b: x and h columns, and W's column of h column 0
  long long img;    // floats before the step's slabs in the packed weights
};

struct RwArgs {
  RmArgs m;                  // the layers, the saved-output and gradient layouts
  RwStep st[RM_MAX_LAYERS];  // K3f: layer s; K3b: layer L - 1 - s
  long long img_total;       // floats of the packed weights
  int n_tiles, rows_pad, ldx, ldh;  // tiles of RW_ROWS rows; smem row strides
  int bias_off[RM_MAX_LAYERS], bias_total;  // K3f: the biases in shared memory
  int stages;                // slots of K3f's / K3b's dIn ring: RW_STAGES, or 2
  int nwo[RM_MAX_LAYERS];    // dW: columns (outputs) of layer l's G slabs, RW_NW or RW_NWS
  int n_ot[RM_MAX_LAYERS];   // and how many such slabs side by side
  long long gimg[RM_MAX_LAYERS + 1];  // floats before layer l's G slabs; [L]: all
  int dwt0[RM_MAX_LAYERS + 1];        // the first dW block of layer l; [L]: all
};

// The slabs of K3f's or K3b's dIn steps in the order the engine takes
// them: tile after tile (blockIdx.x, then every gridDim.x-th), step after
// step, pass after pass, slab after slab. next() gives the next slab's
// source and size and moves on.
struct RwFeed {
  const RwArgs* a;
  const float* pk;
  int tile, s, q;
  __device__ __forceinline__ bool next(const float*& src, uint32_t& bytes) {
    if (tile >= a->n_tiles) return false;
    const RwStep& st = a->st[s];
    const int f = 64 * st.nw;
    src = pk + st.img + (long long)q * f;
    bytes = 4 * f;
    if (++q == st.n_pass * (st.kpad / RW_KS)) {
      q = 0;
      if (++s == a->m.n_layers) {
        s = 0;
        tile += gridDim.x;
      }
    }
    return true;
  }
};

// dW's slabs: n of them, stride floats apart
struct RwDwFeed {
  const float* base;
  int s, n, stride;
  uint32_t bytes;
  __device__ __forceinline__ bool next(const float*& src, uint32_t& b) {
    if (s >= n) return false;
    src = base + (size_t)s * stride;
    b = bytes;
    ++s;
    return true;
  }
};

// The first `stages` slabs of feed into the ring (thread 0), every thread
// moving its copy of feed on by as many
template <class Feed>
__device__ __forceinline__ void rw_prime(Feed& feed, int stages, float* ring, uint64_t* full) {
  for (int i = 0; i < stages; ++i) {
    const float* src;
    uint32_t bytes;
    if (feed.next(src, bytes) && threadIdx.x == 0)
      rw_bulk_load(ring + i * RW_SLAB, src, bytes, full + i);
  }
}

// The warp is done with the slab in `slot`: it counts itself out (cnt, per
// slot, counts modulo the block's warps), and the last warp out refills the
// slot with feed's next slab, `stages` on from the one it held. Every thread
// moves its copy of feed on.
template <class Feed>
__device__ __forceinline__ void rw_release(Feed& feed, int slot, float* ring, uint64_t* full,
                                           uint32_t* cnt) {
  const float* src = nullptr;
  uint32_t bytes = 0;
  const bool more = feed.next(src, bytes);
  __syncwarp();
  if ((threadIdx.x & 31) == 0 && atomicAdd(cnt + slot, 1u) % RW_WARPS == RW_WARPS - 1 && more)
    rw_bulk_load(ring + slot * RW_SLAB, src, bytes, full + slot);
}

// One pass of a step: sum (the warpgroup's 64 rows x NW columns) = A (64 x
// K, rows of the tile in shared memory, zero past K) . B (the step's slabs,
// streamed through the ring of `stages` slots), in 3xTF32: per slab, each
// k8 step's three products (lo.hi, hi.lo, hi.hi) accumulate in the tensor
// core from zero, and the slab's sum is added to sum in fp32. A's
// fragments are split into hi and lo once per slab (loaded before the
// slab's products: shared-memory loads under them slow the products'
// reads of B); the slabs' B is split already.
template <int NW, class AOp, class Feed>
__device__ __forceinline__ void rw_pass(float (&sum)[NW / 2], const AOp& A, int nslab, float* ring,
                                        uint64_t* full, uint32_t* cnt, int stages, int& it,
                                        Feed& feed) {
  const int wg = threadIdx.x >> 7, mw = 16 * ((threadIdx.x >> 5) & 3);
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) sum[i] = acc[i] = 0.f;
  for (int s = 0; s < nslab; ++s, ++it) {
    const int slot = it % stages;
    const float* sl = ring + slot * RW_SLAB;
    uint32_t ah[2][4], al[2][4];
    rw_frag_a(A, RW_KS * s, mw, ah[0], al[0]);
    rw_frag_a(A, RW_KS * s + 8, mw, ah[1], al[1]);
    rw_mbar_wait(full + slot, (it / stages) & 1);
    rw_own(acc);
    rw_wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* bh = sl + 16 * NW * j + 4 * NW * wg;
      const uint64_t dh = rw_desc(bh, 32 * NW, 128), dl = rw_desc(bh + 32 * NW, 32 * NW, 128);
      rw_mma<NW>(acc, al[j], dh, j);
      rw_mma<NW>(acc, ah[j], dl, 1);
      rw_mma<NW>(acc, ah[j], dh, 1);
    }
    rw_commit();
    rw_wait0();
    rw_own(acc);
    rw_own(ah[0]);
    rw_own(ah[1]);
    rw_own(al[0]);
    rw_own(al[1]);
    rw_release(feed, slot, ring, full, cnt);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) sum[i] += acc[i];
  }
}

// Rows r0 .. r0 + RW_ROWS of a layer's G (hs, n columns; zero past them up
// to its slabs' n_ot * nwo) into its dW slabs, split into tf32 hi and lo:
// slab (r / RW_RS, c / nwo), each half [r % 32 / 4][c % nwo / 8][c % 8]
// [r % 4]. A thread takes 4 rows of a column at a time: one float4 in each
// half, a warp 512 bytes in a row.
__device__ __forceinline__ void rw_gput(const float* hs, int ldh, int n, float* img, int nwo,
                                        int n_ot, int r0) {
  const int w = n_ot * nwo;
  for (int e = threadIdx.x; e < (RW_ROWS / 4) * w; e += RW_THREADS) {
    const int r4 = e / w, c = e - r4 * w, r = r0 + 4 * r4, ot = c / nwo, o = c - ot * nwo;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) rw_split(c < n ? hs[(4 * r4 + q) * ldh + c] : 0.f, hi[q], lo[q]);
    float* d = img + ((size_t)(r / RW_RS) * n_ot + ot) * (64 * nwo) +
               ((r % RW_RS) >> 2) * (4 * nwo) + (o >> 3) * 32 + (o & 7) * 4;
    *reinterpret_cast<float4*>(d) = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                                                __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    *reinterpret_cast<float4*>(d + 32 * nwo) = make_float4(
        __uint_as_float(lo[0]), __uint_as_float(lo[1]), __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  }
}

// n floats from p on into L2, one 128-byte line per thread at a time
__device__ __forceinline__ void rw_prefetch_l2(const float* p, size_t n) {
  for (size_t i = 32 * (size_t)threadIdx.x; i < n; i += 32 * (size_t)RW_THREADS)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + i));
}

// Every step's weights split into tf32 hi and lo, in the slabs the engine
// streams (K3f: B(k, n) = W_l[n][k]; K3b: B(k, n) = W_l[k][i(n)], i(n) x's
// column in the x passes, h_src + n in the h pass), zero past the ends.
__global__ void __launch_bounds__(HM_THREADS)
rw_pack_kernel(const __grid_constant__ RwArgs a, int bwd, float* __restrict__ pk) {
  const int L = a.m.n_layers;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < a.img_total;
       e += (long long)gridDim.x * blockDim.x) {
    int s = 0;
    while (s + 1 < L && e >= a.st[s + 1].img) ++s;
    const RwStep& st = a.st[s];
    const int l = bwd ? L - 1 - s : s, nw = st.nw, f = 64 * nw, nsl = st.kpad / RW_KS;
    const long long o = e - st.img, ps = o / f;
    const int q = (int)(o - ps * f), p = (int)(ps / nsl), sl = (int)(ps % nsl);
    const bool lo = q >= 32 * nw;
    const int q2 = lo ? q - 32 * nw : q, kc = q2 / (8 * nw), q3 = q2 - kc * 8 * nw;
    const int c = 2 * nw * p + (q3 >> 5) * 8 + ((q3 & 31) >> 2);
    const int k = RW_KS * sl + 4 * kc + (q3 & 3);
    float v = 0.f;
    if (k < st.K) {
      if (!bwd) {
        if (c < st.h_cols) v = __ldg(a.m.w[l] + (size_t)c * st.K + k);
      } else {
        const int hc = c - 2 * nw * st.n_xpass;
        const int i = p < st.n_xpass ? (c < st.x_cols ? c : -1) : (hc < st.h_cols ? st.h_src + hc : -1);
        if (i >= 0) v = __ldg(a.m.w[l] + (size_t)k * a.m.in_dim[l] + i);
      }
    }
    uint32_t hi, lw;
    rw_split(v, hi, lw);
    pk[e] = __uint_as_float(lo ? lw : hi);
  }
}

// The ring's barriers and slot counters (the first 32 floats of shared
// memory), then the ring
__device__ __forceinline__ float* rw_ring_init(float* smem, int stages, uint64_t*& full,
                                               uint32_t*& cnt) {
  full = reinterpret_cast<uint64_t*>(smem);
  cnt = reinterpret_cast<uint32_t*>(full + stages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      rw_mbar_init(full + s, 1);
      cnt[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  return smem + 32;
}

// K3f (BWD false) and K3b's dIn (BWD true) on the row engine: one block per
// SM walks tiles of RW_ROWS rows and carries each through every step.
// K3f: in = x, out = y, save = the saved outputs (or null). K3b: in = g,
// acts = K3f's saved outputs, out = dx, save = the G slabs for dW.
// smem: the ring's barriers and counters, the ring, then xs (x, or K3b's
// dx accumulator; RW_ROWS x ldx), hs (the hidden layer, or K3b's G; RW_ROWS
// x ldh) and K3f's biases. A hidden layer's pass holds its 2 x 128 columns
// in registers until every warp is done reading hs, then stores them in
// place.
template <bool BWD>
__global__ void __launch_bounds__(RW_THREADS, 1)
rw_kernel(const __grid_constant__ RwArgs a, const float* __restrict__ in,
          const float* __restrict__ pk, const float* __restrict__ acts, float* __restrict__ out,
          float* __restrict__ save) {
  extern __shared__ __align__(16) float rw_smem[];
  uint64_t* full;
  uint32_t* cnt;
  float* ring = rw_ring_init(rw_smem, a.stages, full, cnt);
  float* xs = ring + a.stages * RW_SLAB;
  float* hs = xs + RW_ROWS * a.ldx;
  float* bsm = hs + RW_ROWS * a.ldh;  // K3f: layer l's bias at bias_off[l]
  const int tid = threadIdx.x, L = a.m.n_layers, c_in = a.m.c_in, rows = a.m.rows;
  const int ldx = a.ldx, ldh = a.ldh;
  if constexpr (!BWD)
    for (int l = 0; l < L; ++l)
      for (int i = tid; i < a.m.out_dim[l]; i += RW_THREADS) bsm[a.bias_off[l] + i] = __ldg(a.m.b[l] + i);
  __syncthreads();
  RwFeed feed{&a, pk, (int)blockIdx.x, 0, 0};
  rw_prime(feed, a.stages, ring, full);
  const int wg = tid >> 7;
  int it = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int row0 = tile * RW_ROWS, nr = min(RW_ROWS, rows - row0);
    __syncthreads();  // every warp is done with the previous tile's xs and hs
    // the tile's x (K3f) or g (K3b) by cp.async, zero past the last row: a
    // loop of loads and shared stores would wait for each load in turn
    const int nin = BWD ? a.m.out_dim[L - 1] : c_in;
    float* dst = BWD ? hs : xs;
    const int ld = BWD ? ldh : ldx;
    for (int i = tid; i < RW_ROWS * nin; i += RW_THREADS) {
      const int r = i / nin, c = i - r * nin;
      hm_cp4(dst + r * ld + c, r < nr ? in + (size_t)(row0 + r) * nin + c : in, r < nr);
    }
    hm_cp_commit();
    if constexpr (BWD) {  // dx's accumulator from zero; G of the last layer is g, into its dW slabs too
      for (int i = tid; i < RW_ROWS * c_in; i += RW_THREADS) xs[(i / c_in) * ldx + i % c_in] = 0.f;
      hm_cp_wait();
      __syncthreads();
      rw_gput(hs, ldh, nin, save + a.gimg[L - 1], a.nwo[L - 1], a.n_ot[L - 1], row0);
    } else {
      hm_cp_wait();
    }
    __syncthreads();
    for (int s = 0; s < L; ++s) {
      const RwStep& st = a.st[s];
      const int l = BWD ? L - 1 - s : s, nsl = st.kpad / RW_KS;
      const RmIn A = BWD ? RmIn{hs, ldh, st.K, hs, ldh, st.K}
                   : l == 0 ? RmIn{xs, ldx, c_in, xs, ldx, c_in}
                   : rm_skip(a.m, l) ? RmIn{xs, ldx, c_in, hs, ldh, st.K}
                                     : RmIn{hs, ldh, st.K, hs, ldh, st.K};
      const float* bias = bsm + a.bias_off[l];
      if (BWD && st.h_cols > 0)  // the ReLU masks this step's h pass reads: into L2 meanwhile
        rw_prefetch_l2(acts + (size_t)a.m.act_off[l - 1] * rows + (size_t)row0 * st.h_cols,
                       (size_t)nr * st.h_cols);
      for (int p = 0; p < st.n_pass; ++p) {
        if (st.nw == RW_NWS) {  // K3f's narrow last layer: straight to y
          float sum[RW_NWS / 2];
          rw_pass<RW_NWS>(sum, A, nsl, ring, full, cnt, a.stages, it, feed);
          const int N = st.h_cols, c0 = 2 * RW_NWS * p + RW_NWS * wg;
          rw_each<RW_NWS>(sum, [&](int m, int cl, float v0, float v1) {
            const int c = c0 + cl;
            if (m >= nr || c >= N) return;
            v0 += bias[c];
            out[(size_t)(row0 + m) * N + c] = a.m.final_act ? fmaxf(v0, 0.f) : v0;
            if (c + 1 < N) {
              v1 += bias[c + 1];
              out[(size_t)(row0 + m) * N + c + 1] = a.m.final_act ? fmaxf(v1, 0.f) : v1;
            }
          });
          continue;
        }
        float sum[RW_NW / 2];
        rw_pass<RW_NW>(sum, A, nsl, ring, full, cnt, a.stages, it, feed);
        const int c0 = 2 * RW_NW * p + RW_NW * wg;
        if constexpr (!BWD) {
          const int N = st.h_cols;
          const bool relu = l < L - 1 || a.m.final_act;
          if (l == L - 1) {  // the output layer: straight to y
            const bool vec = (N & 1) == 0;
            rw_each<RW_NW>(sum, [&](int m, int cl, float v0, float v1) {
              const int c = c0 + cl;
              if (m >= nr || c >= N) return;
              v0 += bias[c];
              v1 += c + 1 < N ? bias[c + 1] : 0.f;
              rw_st2(out + (size_t)(row0 + m) * N + c, relu ? fmaxf(v0, 0.f) : v0,
                     relu ? fmaxf(v1, 0.f) : v1, c + 1 < N, vec, false);
            });
            continue;
          }
          float* sv = save != nullptr ? save + (size_t)a.m.act_off[l] * rows : nullptr;
          const bool vec = ((N | (a.m.act_off[l] * rows)) & 1) == 0;
          __syncthreads();  // every warp is done reading hs
          rw_each<RW_NW>(sum, [&](int m, int cl, float v0, float v1) {
            const int c = c0 + cl;
            if (c >= N) return;
            const bool two = c + 1 < N;
            v0 = fmaxf(v0 + bias[c], 0.f);
            v1 = two ? fmaxf(v1 + bias[c + 1], 0.f) : 0.f;
            rw_st2(hs + m * ldh + c, v0, v1, two, true, false);
            if (sv != nullptr && m < nr) rw_st2(sv + (size_t)(row0 + m) * N + c, v0, v1, two, vec, true);
          });
          __syncthreads();  // layer l is complete in hs
        } else if (p < st.n_xpass) {  // x's columns: into dx
          rw_each<RW_NW>(sum, [&](int m, int cl, float v0, float v1) {
            const int c = c0 + cl;
            if (c < st.x_cols) xs[m * ldx + c] += v0;
            if (c + 1 < st.x_cols) xs[m * ldx + c + 1] += v1;
          });
        } else {  // h's columns: G_{l-1}, masked by K3f's saved h_{l-1}
          const int kh = st.h_cols, c1 = RW_NW * wg;
          const float* hp = acts + (size_t)a.m.act_off[l - 1] * rows;
          const bool vec = ((kh | (a.m.act_off[l - 1] * rows)) & 1) == 0;
          // every mask value of the thread's elements first (rw_each's), so
          // that the loads overlap
          const int lane = tid & 31, mb = 16 * ((tid >> 5) & 3) + (lane >> 2);
          const int cb = c1 + 2 * (lane & 3);
          float2 mk[RW_NW / 8][2];
#pragma unroll
          for (int j = 0; j < RW_NW / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = mb + 8 * h, c = cb + 8 * j;
              mk[j][h] = make_float2(0.f, 0.f);
              if (m >= nr || c >= kh) continue;
              const float* p = hp + (size_t)(row0 + m) * kh + c;
              if (c + 1 < kh && vec) mk[j][h] = __ldg(reinterpret_cast<const float2*>(p));
              else mk[j][h] = make_float2(__ldg(p), c + 1 < kh ? __ldg(p + 1) : 0.f);
            }
          __syncthreads();  // every warp is done reading G_l
#pragma unroll
          for (int j = 0; j < RW_NW / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = mb + 8 * h, c = cb + 8 * j;
              if (c < kh)
                rw_st2(hs + m * ldh + c, mk[j][h].x > 0.f ? sum[4 * j + 2 * h] : 0.f,
                       mk[j][h].y > 0.f ? sum[4 * j + 2 * h + 1] : 0.f, c + 1 < kh, true, false);
            }
          __syncthreads();  // G_{l-1} is complete in hs
          rw_gput(hs, ldh, kh, save + a.gimg[l - 1], a.nwo[l - 1], a.n_ot[l - 1], row0);
        }
      }
    }
    if constexpr (BWD) {
      __syncthreads();
      for (int i = tid; i < nr * c_in; i += RW_THREADS) {
        const int r = i / c_in, c = i - r * c_in;
        out[(size_t)(row0 + r) * c_in + c] = xs[r * ldx + c];
      }
    }
  }
}

// dW = G^T A and db = sum G of one layer over the chunk blockIdx.y of
// a.m.pc rows, as dW^T = A^T G: blockIdx.x is one layer's block of
// RW_DW_M inputs x NWO outputs (dwt0). A^T's fragments come straight from
// the saved outputs (x, [x, h_{l-1}] or h_{l-1}; 32-byte runs of 4 rows,
// one slab ahead), G from its slabs through the ring; each slab's products
// accumulate in the tensor core and are added to fp32 registers. The
// blocks of the first inputs also sum G's columns for db (hi + lo, in row
// order). Into ws, the chunk's slice of the gradients.
template <int NWO>
__device__ __forceinline__ void rw_dw_block(const RwArgs& a, int l, const float* __restrict__ x,
                                            const float* __restrict__ acts,
                                            const float* __restrict__ gimg, float* __restrict__ ws,
                                            float* ring, uint64_t* full, uint32_t* cnt) {
  const int tid = threadIdx.x, c = a.m.c_in, rows = a.m.rows;
  const int t = blockIdx.x - a.dwt0[l], n_ot = a.n_ot[l], ot = t % n_ot, mt = t / n_ot;
  const int N = a.m.out_dim[l], K = a.m.in_dim[l];
  const int r0 = blockIdx.y * a.m.pc, nsl = (min(a.m.pc, rows - r0) + RW_RS - 1) / RW_RS;
  RwDwFeed feed{gimg + a.gimg[l] + ((size_t)(r0 / RW_RS) * n_ot + ot) * 64 * NWO, 0, nsl,
                n_ot * 64 * NWO, 256 * NWO};
  rw_prime(feed, RW_DW_STAGES, ring, full);
  const int lane = tid & 31, wg = tid >> 7, g = lane >> 2, tq = lane & 3;
  const int i0 = RW_DW_M * mt + 64 * wg + 16 * ((tid >> 5) & 3) + g;  // the thread's first input
  const bool has_x = l == 0 || rm_skip(a.m, l);
  const int xoff = has_x ? c : 0, kh = l > 0 ? a.m.out_dim[l - 1] : 0;
  const float* hp = l > 0 ? acts + (size_t)a.m.act_off[l - 1] * rows : x;
  // the thread's two inputs i0 and i0 + 8: each a column of x or of h_{l-1}
  const float* col[2];
  int ld[2];
  bool ok[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = i0 + 8 * u;
    col[u] = i < xoff ? x + i : hp + (i - xoff);
    ld[u] = i < xoff ? c : kh;
    ok[u] = i < K;
  }
  float raw[4][4];
  auto load = [&](int s) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + RW_RS * s + 8 * j + tq + 4 * (q >> 1), u = q & 1;
        raw[j][q] = ok[u] && r < rows ? __ldg(col[u] + (size_t)r * ld[u]) : 0.f;
      }
  };
  const bool do_b = mt == 0 && wg == 0 && tid < NWO;
  float db = 0.f, sum[NWO / 2], acc[NWO / 2];
#pragma unroll
  for (int i = 0; i < NWO / 2; ++i) sum[i] = acc[i] = 0.f;
  if (nsl > 0) load(0);
  for (int s = 0; s < nsl; ++s) {
    const int slot = s % RW_DW_STAGES;
    const float* sl = ring + slot * RW_SLAB;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) rw_split(raw[j][q], ah[j][q], al[j][q]);
    if (s + 1 < nsl) load(s + 1);
    rw_mbar_wait(full + slot, (s / RW_DW_STAGES) & 1);
    if (do_b) {
      const float* hb = sl + (tid >> 3) * 32 + (tid & 7) * 4;
#pragma unroll
      for (int kc = 0; kc < RW_RS / 4; ++kc) {
        const float4 h4 = *reinterpret_cast<const float4*>(hb + kc * 4 * NWO);
        const float4 l4 = *reinterpret_cast<const float4*>(hb + kc * 4 * NWO + 32 * NWO);
        db += h4.x + l4.x;
        db += h4.y + l4.y;
        db += h4.z + l4.z;
        db += h4.w + l4.w;
      }
    }
    rw_own(acc);
    rw_wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* bh = sl + 8 * NWO * j;
      const uint64_t dh = rw_desc(bh, 16 * NWO, 128), dl = rw_desc(bh + 32 * NWO, 16 * NWO, 128);
      rw_mma<NWO>(acc, al[j], dh, j);
      rw_mma<NWO>(acc, ah[j], dl, 1);
      rw_mma<NWO>(acc, ah[j], dh, 1);
    }
    rw_commit();
    rw_wait0();
    rw_own(acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rw_own(ah[j]);
      rw_own(al[j]);
    }
    rw_release(feed, slot, ring, full, cnt);
#pragma unroll
    for (int i = 0; i < NWO / 2; ++i) sum[i] += acc[i];
  }
  const int ib = RW_DW_M * mt + 64 * wg, o0 = NWO * ot;
  float* dw = ws + a.m.off_w[l];
  rw_each<NWO>(sum, [&](int m, int cl, float v0, float v1) {
    const int i = ib + m, o = o0 + cl;
    if (i >= K) return;
    if (o < N) dw[(size_t)o * K + i] = v0;
    if (o + 1 < N) dw[(size_t)(o + 1) * K + i] = v1;
  });
  if (do_b && o0 + tid < N) ws[a.m.off_b[l] + o0 + tid] = db;
}

__global__ void __launch_bounds__(RW_THREADS, 1)
rw_dw_kernel(const __grid_constant__ RwArgs a, const float* __restrict__ x,
             const float* __restrict__ acts, const float* __restrict__ gimg,
             float* __restrict__ ws) {
  extern __shared__ __align__(16) float rw_smem[];
  uint64_t* full;
  uint32_t* cnt;
  float* ring = rw_ring_init(rw_smem, RW_DW_STAGES, full, cnt);
  int l = 0;
  while (l + 1 < a.m.n_layers && (int)blockIdx.x >= a.dwt0[l + 1]) ++l;
  __syncthreads();
  float* out = ws + (size_t)blockIdx.y * a.m.n_params;
  if (a.nwo[l] == RW_NW) rw_dw_block<RW_NW>(a, l, x, acts, gimg, out, ring, full, cnt);
  else rw_dw_block<RW_NWS>(a, l, x, acts, gimg, out, ring, full, cnt);
}

// The row engine's steps (K3f, or K3b's dIn with bwd) and dW layout for
// a.m's layers and rows; cudaErrorInvalidValue when a width exceeds
// RW_MAX_WIDTH
static size_t rw_smem_bytes(const RwArgs& r);

static int rw_fill(RwArgs& r, bool bwd) {
  const RmArgs& m = r.m;
  const int L = m.n_layers, c = m.c_in;
  if (c > RW_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  int wmax = 1;
  for (int l = 0; l < L; ++l) {
    if (m.out_dim[l] > RW_MAX_WIDTH) return (int)cudaErrorInvalidValue;
    if (bwd || l < L - 1) wmax = std::max(wmax, m.out_dim[l]);
  }
  long long img = 0;
  for (int s = 0; s < L; ++s) {
    RwStep& st = r.st[s];
    const int l = bwd ? L - 1 - s : s;
    st.img = img;
    if (!bwd) {
      st.K = m.in_dim[l];
      st.nw = m.out_dim[l] <= 2 * RW_NWS ? RW_NWS : RW_NW;
      st.n_pass = (m.out_dim[l] + 2 * st.nw - 1) / (2 * st.nw);
      st.n_xpass = st.x_cols = st.h_src = 0;
      st.h_cols = m.out_dim[l];
    } else {
      st.K = m.out_dim[l];
      st.nw = RW_NW;
      st.x_cols = l == 0 || ((m.skip_mask >> l) & 1) ? c : 0;
      st.n_xpass = (st.x_cols + 2 * RW_NW - 1) / (2 * RW_NW);
      st.h_cols = l > 0 ? m.out_dim[l - 1] : 0;
      st.h_src = st.x_cols;
      st.n_pass = st.n_xpass + (st.h_cols > 0);
    }
    st.kpad = rm_round(st.K, RW_KS);
    img += (long long)st.n_pass * (st.kpad / RW_KS) * 64 * st.nw;
  }
  r.img_total = img;
  r.bias_total = 0;
  for (int l = 0; l < L; ++l) {
    r.bias_off[l] = r.bias_total;
    if (!bwd) r.bias_total += rm_round(m.out_dim[l], 4);
  }
  r.ldx = hm_ld(c);
  r.ldh = hm_ld(wmax);
  r.n_tiles = (m.rows + RW_ROWS - 1) / RW_ROWS;
  r.rows_pad = r.n_tiles * RW_ROWS;
  long long gi = 0;
  int tiles = 0;
  for (int l = 0; l < L; ++l) {
    r.nwo[l] = m.out_dim[l] <= RW_NWS ? RW_NWS : RW_NW;
    r.n_ot[l] = (m.out_dim[l] + r.nwo[l] - 1) / r.nwo[l];
    r.gimg[l] = gi;
    gi += (long long)(r.rows_pad / RW_RS) * r.n_ot[l] * 64 * r.nwo[l];
    r.dwt0[l] = tiles;
    tiles += ((m.in_dim[l] + RW_DW_M - 1) / RW_DW_M) * r.n_ot[l];
  }
  r.gimg[L] = gi;
  r.dwt0[L] = tiles;
  r.stages = RW_STAGES;
  if (rw_smem_bytes(r) > RM_SMEM) r.stages = 2;
  return 0;
}

static size_t rw_smem_bytes(const RwArgs& r) {
  return sizeof(float) * (32 + (size_t)r.stages * RW_SLAB + (size_t)RW_ROWS * (r.ldx + r.ldh) +
                          r.bias_total);
}

static const size_t RW_DW_SMEM = sizeof(float) * (32 + (size_t)RW_DW_STAGES * RW_SLAB);

static int rw_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

static int rw_pack(const RwArgs& r, int bwd, float* pk, cudaStream_t st) {
  const long long blocks = std::min<long long>((r.img_total + HM_THREADS - 1) / HM_THREADS, 4096);
  rw_pack_kernel<<<(unsigned)blocks, HM_THREADS, 0, st>>>(r, bwd, pk);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ launch

// The layer table and the layouts of the saved outputs and gradients; w /
// b may be null (sizes only)
static int rm_fill_args(RmArgs& a, const void* const* w, const void* const* b, const int* in_dim,
                        const int* out_dim, int n_layers, int c_in, int rows, int skip_mask,
                        int final_act) {
  if (n_layers < 1 || n_layers > RM_MAX_LAYERS || rows < 1 || c_in < 1 || (skip_mask & 1))
    return (int)cudaErrorInvalidValue;
  a.n_layers = n_layers;
  a.c_in = c_in;
  a.rows = rows;
  a.skip_mask = skip_mask;
  a.final_act = final_act;
  int act = 0, nw = 0, tiles = 0, tiles32 = 0;
  for (int l = 0; l < n_layers; ++l) {
    const bool has_x = l == 0 || ((skip_mask >> l) & 1);
    const int want_in = (l == 0 ? 0 : out_dim[l - 1]) + (has_x ? c_in : 0);
    if (in_dim[l] != want_in || out_dim[l] < 1 || out_dim[l] > RM_MAX_WIDTH ||
        in_dim[l] > RM_MAX_WIDTH)
      return (int)cudaErrorInvalidValue;
    a.w[l] = w != nullptr ? static_cast<const float*>(w[l]) : nullptr;
    a.b[l] = b != nullptr ? static_cast<const float*>(b[l]) : nullptr;
    a.in_dim[l] = in_dim[l];
    a.out_dim[l] = out_dim[l];
    a.act_off[l] = act;
    if (l < n_layers - 1) act += out_dim[l];
    a.off_w[l] = nw;
    nw += out_dim[l] * in_dim[l];
    a.dw_tile0[l] = tiles;
    a.dw32_tile0[l] = tiles32;
    tiles += ((out_dim[l] + 63) / 64) * ((in_dim[l] + 63) / 64);
    tiles32 += ((out_dim[l] + 31) / 32) * ((in_dim[l] + 31) / 32);
  }
  a.dw_tile0[n_layers] = tiles;
  a.dw32_tile0[n_layers] = tiles32;
  for (int l = 0; l < n_layers; ++l) {
    a.off_b[l] = nw;
    nw += out_dim[l];
  }
  a.act_total = act;
  a.n_params = nw;
  return 0;
}

// K3f's buffers for the FMA (8-row) or 3xTF32 (32-row) tile with `stages`
// slabs, floats; fills tr, lda, ldx, nb, ldb and slab
static size_t rm_fwd_floats(RmArgs& a, bool fma, int stages) {
  int max_h = 0, slab = 0;
  for (int l = 0; l + 1 < a.n_layers; ++l) max_h = std::max(max_h, a.out_dim[l]);
  a.tr = fma ? RM_FMA_ROWS : RM_MMA_ROWS;
  a.ldx = hm_ld(a.c_in);
  a.lda = hm_ld(max_h);
  for (int l = 0; l < a.n_layers; ++l) {
    const int per = (a.out_dim[l] + RM_CLUSTER - 1) / RM_CLUSTER;
    a.nb[l] = fma ? per : rm_round(per, 8);
    a.ldb[l] = fma ? rm_round(a.in_dim[l], 4) : hm_ld(a.in_dim[l]);
    slab = std::max(slab, a.nb[l] * a.ldb[l]);
  }
  a.slab = slab;
  a.stages = stages;
  return (size_t)a.tr * (a.ldx + 2 * a.lda) + RM_MAX_LAYERS * 64 +
         (fma ? 0 : RM_PART) + (size_t)stages * slab;
}

// K3b's dIn buffers with `stages` slabs, floats; fills tr, lda, ldx, nb,
// ldb and slab
static size_t rm_bwd_floats(RmArgs& a, int stages) {
  int max_out = 0, slab = 0;
  a.tr = RM_MMA_ROWS;
  for (int l = 0; l < a.n_layers; ++l) max_out = std::max(max_out, a.out_dim[l]);
  a.lda = hm_ld(max_out);
  a.ldx = hm_ld(a.c_in);
  for (int l = 0; l < a.n_layers; ++l) {
    a.nb[l] = rm_round((a.in_dim[l] + RM_CLUSTER - 1) / RM_CLUSTER, 8);
    a.ldb[l] = rm_ldk(a.nb[l]);
    slab = std::max(slab, (a.out_dim[l] + a.tr) * a.ldb[l]);
  }
  a.slab = slab;
  a.stages = stages;
  return (size_t)2 * a.tr * a.lda + (size_t)a.tr * a.ldx + RM_PART +
         (size_t)stages * slab;
}

// The most slabs (layers whose weights are in flight at once, at most
// every layer) whose buffers fit in a block's shared memory, for K3f
// (kind 0: its FMA tile, 1: its 3xTF32 tile) or K3b's dIn (2); fills a as
// rm_fwd_floats / rm_bwd_floats do. Returns the bytes, or 0 when not even
// one slab fits.
static size_t rm_layout(RmArgs& a, int kind) {
  const bool bwd = kind == 2;
  const long long fixed = (long long)(bwd ? rm_bwd_floats(a, 0) : rm_fwd_floats(a, kind == 0, 0));
  const long long room = (long long)(RM_SMEM / sizeof(float)) - fixed;
  const long long stages = std::min<long long>(a.n_layers, room / a.slab);
  if (stages < 1) return 0;
  return sizeof(float) * (bwd ? rm_bwd_floats(a, (int)stages)
                              : rm_fwd_floats(a, kind == 0, (int)stages));
}

static int rm_set_smem(const void* kernel, size_t smem) {
  if (smem > RM_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" {

// K3f's (fma: its 8-row FMA tile, else the 32-row 3xTF32 one) and K3b's
// dIn layout for an MLP of these widths, as their launches pick it:
// sizes[0] K3f's stages (layers whose weight slices are in flight at
// once), [1] its shared memory per block in bytes, [2] and [3] the same
// for K3b's dIn, [4] floats per row of the saved outputs, [5] floats of
// the gradients. Returns the error (cudaErrorInvalidValue when the buffers
// of these widths do not fit in shared memory), or 0.
int lab4d_relu_mlp_smem(const int* in_dim, const int* out_dim, int n_layers, int c_in,
                        int skip_mask, int fma, long long* sizes) {
  RmArgs a;
  int err = rm_fill_args(a, nullptr, nullptr, in_dim, out_dim, n_layers, c_in, 1, skip_mask, 0);
  if (err) return err;
  const size_t fwd = rm_layout(a, fma ? 0 : 1);
  sizes[0] = a.stages;
  sizes[1] = (long long)fwd;
  const size_t bwd = rm_layout(a, 2);
  sizes[2] = a.stages;
  sizes[3] = (long long)bwd;
  sizes[4] = a.act_total;
  sizes[5] = a.n_params;
  return fwd == 0 || bwd == 0 ? (int)cudaErrorInvalidValue : 0;
}

// The clusters of 8 blocks of K3f (kernel 0: FMA, 1: 3xTF32) or K3b's dIn
// (2) that the card runs at once with `smem` bytes per block; 0 on error.
int lab4d_relu_mlp_max_clusters(int kernel, int smem) {
  const void* k = kernel == 0 ? (const void*)rm_fwd_kernel<true>
                : kernel == 1 ? (const void*)rm_fwd_kernel<false> : (const void*)rm_din_kernel;
  if (rm_set_smem(k, (size_t)smem)) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(RM_CLUSTER * 64);
  cfg.blockDim = dim3(RM_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, k, &cfg) == cudaSuccess ? n : 0;
}

// K3f: y (rows, out_last) = MLP(x) for x (rows, c_in). fma: the 8-row FMA
// tile (else 3xTF32 on 32 rows); as many layers' weight slices in flight
// as fit in shared memory (rm_layout). acts: null, or rows * sizes[4]
// floats (lab4d_relu_mlp_smem) for every hidden layer output (K3b's
// input). Returns the error, or 0; *n_launches: the launches made (1).
int lab4d_relu_mlp_fwd(const float* x, float* y, float* acts, const void* const* w,
                       const void* const* b, const int* in_dim, const int* out_dim, int n_layers,
                       int c_in, int rows, int skip_mask, int final_act, int fma,
                       int* n_launches, void* stream) {
  RmArgs a;
  int err = rm_fill_args(a, w, b, in_dim, out_dim, n_layers, c_in, rows, skip_mask, final_act);
  if (err) return err;
  const size_t smem = rm_layout(a, fma ? 0 : 1);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const void* k = fma ? (const void*)rm_fwd_kernel<true> : (const void*)rm_fwd_kernel<false>;
  if ((err = rm_set_smem(k, (size_t)smem))) return err;
  const unsigned tiles = (unsigned)((rows + a.tr - 1) / a.tr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fma) rm_fwd_kernel<true><<<tiles * RM_CLUSTER, RM_THREADS, smem, st>>>(a, x, y, acts);
  else rm_fwd_kernel<false><<<tiles * RM_CLUSTER, RM_THREADS, smem, st>>>(a, x, y, acts);
  if ((err = (int)cudaGetLastError())) return err;
  if (n_launches != nullptr) *n_launches = 1;
  return 0;
}

// K3b: dx (rows, c_in) and grads (sizes[3] floats: every dW_l, then every
// db_l) for the output gradient g (rows, out_last), already masked by the
// final ReLU, from K3f's saved hidden outputs acts. dIn stages as many
// layers' weight slices as fit in shared memory (rm_layout); n_chunks
// chunks of pc rows (a multiple of 32) for dW, one up to RM_DW_ROWS rows.
// scratch: rows * sizes[4] floats for the gradients of the hidden layers,
// then n_chunks * sizes[5] floats of workspace when n_chunks > 1. Returns
// the error, or 0; *n_launches: the launches made (2, or 3 with chunks).
int lab4d_relu_mlp_bwd(const float* x, const float* g, const float* acts, float* dx, float* grads,
                       float* scratch, const void* const* w, const void* const* b,
                       const int* in_dim, const int* out_dim, int n_layers, int c_in, int rows,
                       int skip_mask, int n_chunks, int pc, int* n_launches, void* stream) {
  RmArgs a;
  int err = rm_fill_args(a, w, b, in_dim, out_dim, n_layers, c_in, rows, skip_mask, 0);
  if (err) return err;
  const size_t smem = rm_layout(a, 2);
  if (smem == 0 || n_chunks < 1 ||
      pc < 1 || pc % HM_KS || (long long)(n_chunks - 1) * pc >= rows ||
      (long long)n_chunks * pc < rows || (rows <= RM_DW_ROWS && n_chunks != 1))
    return (int)cudaErrorInvalidValue;
  a.pc = pc;
  a.n_chunks = n_chunks;
  if ((err = rm_set_smem((const void*)rm_din_kernel, (size_t)smem))) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* gsave = scratch;
  float* ws = n_chunks > 1 ? scratch + (size_t)rows * a.act_total : grads;
  int n = 0;
  const unsigned tiles = (unsigned)((rows + a.tr - 1) / a.tr);
  rm_din_kernel<<<tiles * RM_CLUSTER, RM_THREADS, smem, st>>>(a, g, acts, gsave, dx);
  if ((err = (int)cudaGetLastError())) return err;
  ++n;
  if (rows <= RM_DW_ROWS) {
    const size_t dw_smem = sizeof(float) * std::max(2 * rm_round(rows, 8) * RM_DW_LD,
                                                    RM_DW_WARPS * 16 * RM_PLD);
    if ((err = rm_set_smem((const void*)rm_dw_rows_kernel, dw_smem))) return err;
    rm_dw_rows_kernel<<<a.dw32_tile0[n_layers], 32 * RM_DW_WARPS, dw_smem, st>>>(a, x, g, acts, gsave,
                                                                           grads);
  } else {
    rm_dw_kernel<<<dim3(a.dw_tile0[n_layers], n_chunks), HM_THREADS, 0, st>>>(a, x, g, acts,
                                                                              gsave, ws);
  }
  if ((err = (int)cudaGetLastError())) return err;
  ++n;
  if (n_chunks > 1) {
    hm_reduce_kernel<<<(a.n_params + HM_THREADS - 1) / HM_THREADS, HM_THREADS, 0, st>>>(
        ws, n_chunks, a.n_params, grads);
    if ((err = (int)cudaGetLastError())) return err;
    ++n;
  }
  if (n_launches != nullptr) *n_launches = n;
  return 0;
}

// The row engine's layout for an MLP of these widths at `rows` rows:
// sizes[0] K3f's packed weights (floats), [1] K3b's, [2] the G slabs of
// dW, [3] dW's blocks per chunk, [4] K3f's and [5] K3b's dIn shared memory
// per block (bytes), [6] dW's, [7] floats per row of the saved outputs,
// [8] floats of the gradients. Returns cudaErrorInvalidValue when the
// engine does not take these widths, else 0.
int lab4d_relu_mlp_rows_layout(const int* in_dim, const int* out_dim, int n_layers, int c_in,
                               int skip_mask, int rows, long long* sizes) {
  RwArgs f, b;
  int err = rm_fill_args(f.m, nullptr, nullptr, in_dim, out_dim, n_layers, c_in, rows, skip_mask, 0);
  if (err) return err;
  b.m = f.m;
  if ((err = rw_fill(f, false)) || (err = rw_fill(b, true))) return err;
  sizes[0] = f.img_total;
  sizes[1] = b.img_total;
  sizes[2] = b.gimg[n_layers];
  sizes[3] = b.dwt0[n_layers];
  sizes[4] = (long long)rw_smem_bytes(f);
  sizes[5] = (long long)rw_smem_bytes(b);
  sizes[6] = (long long)RW_DW_SMEM;
  sizes[7] = f.m.act_total;
  sizes[8] = f.m.n_params;
  return rw_smem_bytes(f) > RM_SMEM || rw_smem_bytes(b) > RM_SMEM ? (int)cudaErrorInvalidValue : 0;
}

// K3f on the row engine: y (rows, out_last) = MLP(x); acts as for
// lab4d_relu_mlp_fwd; pk: sizes[0] floats (lab4d_relu_mlp_rows_layout) for
// the split weights. Returns the error, or 0; *n_launches: 2.
int lab4d_relu_mlp_rows_fwd(const float* x, float* y, float* acts, float* pk,
                            const void* const* w, const void* const* b, const int* in_dim,
                            const int* out_dim, int n_layers, int c_in, int rows, int skip_mask,
                            int final_act, int* n_launches, void* stream) {
  RwArgs r;
  int err = rm_fill_args(r.m, w, b, in_dim, out_dim, n_layers, c_in, rows, skip_mask, final_act);
  if (err || (err = rw_fill(r, false))) return err;
  const size_t smem = rw_smem_bytes(r);
  const int n_sm = rw_sms();
  if (n_sm < 1) return (int)cudaErrorInvalidDevice;
  if ((err = rm_set_smem((const void*)rw_kernel<false>, smem))) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((err = rw_pack(r, 0, pk, st))) return err;
  rw_kernel<false><<<std::min(r.n_tiles, n_sm), RW_THREADS, smem, st>>>(r, x, pk, nullptr, y, acts);
  if ((err = (int)cudaGetLastError())) return err;
  if (n_launches != nullptr) *n_launches = 2;
  return 0;
}

// K3b on the row engine, from K3f's saved outputs: dx and grads as for
// lab4d_relu_mlp_bwd; n_chunks chunks of pc rows (a multiple of 32) for
// dW. scratch: sizes[1] floats for the split transposed weights, sizes[2]
// for G's slabs, then n_chunks * sizes[8] floats of workspace when
// n_chunks > 1. Returns the error, or 0; *n_launches: the launches made
// (3, or 4 with chunks).
int lab4d_relu_mlp_rows_bwd(const float* x, const float* g, const float* acts, float* dx,
                            float* grads, float* scratch, const void* const* w,
                            const void* const* b, const int* in_dim, const int* out_dim,
                            int n_layers, int c_in, int rows, int skip_mask, int n_chunks, int pc,
                            int* n_launches, void* stream) {
  RwArgs r;
  int err = rm_fill_args(r.m, w, b, in_dim, out_dim, n_layers, c_in, rows, skip_mask, 0);
  if (err || (err = rw_fill(r, true))) return err;
  if (n_chunks < 1 || pc < 1 || pc % RW_RS || (long long)(n_chunks - 1) * pc >= rows ||
      (long long)n_chunks * pc < rows)
    return (int)cudaErrorInvalidValue;
  r.m.pc = pc;
  r.m.n_chunks = n_chunks;
  const size_t smem = rw_smem_bytes(r);
  const int n_sm = rw_sms();
  if (n_sm < 1) return (int)cudaErrorInvalidDevice;
  if ((err = rm_set_smem((const void*)rw_kernel<true>, smem)) ||
      (err = rm_set_smem((const void*)rw_dw_kernel, RW_DW_SMEM)))
    return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = scratch;
  float* gimg = scratch + r.img_total;
  float* ws = n_chunks > 1 ? gimg + r.gimg[n_layers] : grads;
  int n = 0;
  if ((err = rw_pack(r, 1, pt, st))) return err;
  ++n;
  rw_kernel<true><<<std::min(r.n_tiles, n_sm), RW_THREADS, smem, st>>>(r, g, pt, acts, dx, gimg);
  if ((err = (int)cudaGetLastError())) return err;
  ++n;
  rw_dw_kernel<<<dim3(r.dwt0[n_layers], n_chunks), RW_THREADS, RW_DW_SMEM, st>>>(r, x, acts, gimg,
                                                                                ws);
  if ((err = (int)cudaGetLastError())) return err;
  ++n;
  if (n_chunks > 1) {
    hm_reduce_kernel<<<(r.m.n_params + HM_THREADS - 1) / HM_THREADS, HM_THREADS, 0, st>>>(
        ws, n_chunks, r.m.n_params, grads);
    if ((err = (int)cudaGetLastError())) return err;
    ++n;
  }
  if (n_launches != nullptr) *n_launches = n;
  return 0;
}

const char* lab4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
