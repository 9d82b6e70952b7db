// The tile engine of K1 / K2 (csrc/nerf_heads.cu) and K4f / K4b
// (csrc/fused_pe_mlp.cu) on Hopper (sm_90a), built from csrc/wgmma.cuh's
// primitives. Each kernel brings its own pass table and epilogues; this
// file holds what they run alike:
// - the weight ring: slabs of pre-split weights (KS of K, 16 for K1 and
//   32 for K4, x 8 .. 128 columns, hi then lo, in wgmma's K-major core
//   matrices) streamed by TMA bulk copies on mbarriers through 2 or 3
//   slots, one sequence across passes and tiles (NhFeed over the caller's
//   pass table), the last warp out of a slot refilling it (nh_prime,
//   nh_release);
// - a pass (nh_pass): a warpgroup's 64 rows x NW columns over nsl slabs,
//   each k8 step's three products (lo.hi, hi.lo, hi.hi) accumulating in
//   the tensor core from zero, the slab's sum added to fp32 registers;
// - the backward's helpers: a layer's G into the slabs dW reads
//   (nh_gput), the ReLU masks from the saved outputs (nh_mask_bits);
// - dW = G^T A and db = sum G over chunks of rows (nh_dw_block): a
//   producer warp feeds a ring of G slabs and A's whole rows by TMA, its
//   warpgroup splits G, and the two other warpgroups run wgmma over each
//   32-row slab with the registers it hands them (setmaxnreg). The caller supplies
//   nh_dw_src (A's sources), nh_dw_dst (where dW(o, i) goes) and
//   nh_dw_boff (db's offset) for its args type.
// Rows need not be whole slabs: the last chunk of dW copies only the rows
// that exist, and its blocks start from zeroed A tiles.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "heads_mma.cuh"
#include "wgmma.cuh"

#define NH_TR 128          // points per tile
#define NH_HALF 64         // a warpgroup's rows of the tile
#define NH_THREADS 256     // two warpgroups
#define NH_WARPS (NH_THREADS / 32)
#define NH_KS 16           // k-depth of K1's weight slabs: two k8 steps
#define NH_NMAX 128        // widest layer: one wgmma of a warpgroup
#define NH_RS 32           // rows of a G slab of dW: four k8 steps
#define NH_DW_M 128        // dW inputs per block: 64 per warpgroup
#define NH_DW_THREADS (NH_THREADS + 128)  // dW: two warpgroups and a producer warpgroup (one warp works)
#define NH_DW_REGS_PRODUCER 56  // dW's registers per thread after setmaxnreg: the producer's
#define NH_DW_REGS_MMA 224      // and the two warpgroups' (65536 / 384 = 168 at launch)
#define NH_DW_STAGES 3     // dW's slabs in flight
#define NH_DW_SLAB (64 * NH_NMAX)  // floats of the widest G slab, hi and lo
#define NH_DW_A (8 * (4 * NH_NMAX + 8))  // floats of an A tile: 8 chunks of 4 rows, padded
#define NH_DW_SLOT (NH_DW_SLAB + 2 * NH_DW_A)  // G's slab and A's tiles (x and h, or hc's two)
#define NH_SMEM (227 * 1024)

// dW's A operand (NhDw.kind): the embedding, [embedding | h_{l-1}], h_{l-1}
// (or the saved input of sdf / rgb2), hc = feat + colour
enum { NH_A_X, NH_A_XH, NH_A_H, NH_A_HC };

// One pass of the engine: a wgmma of nw columns (n of them real) over nsl
// slabs of the reduction. Its slabs lie at img in the packed weights, each
// hi then lo, [k / 4][n / 8][n % 8][k % 4] (wgmma's K-major core matrices).
struct NhPass {
  int img;
  short nsl, n;
  unsigned char nxs;   // forward: the first nxs slabs read the tile's embedding, the rest the A buffer
  unsigned char nw;    // 8, 16, 32, 64 or 128
  signed char epi;     // the caller's epilogue
  signed char head, layer;  // its layer (K1: head -1 for rgb1, rgb2, d hc)
  signed char src;     // the A buffer: 0 H, 1 F
  signed char dw;      // backward: the dW layer whose G the pass reads first, stored before it, or -1
  signed char first;   // K2: the first pass of a head
};

// One layer of dW = G^T A, db = sum G
struct NhDw {
  int goff;   // floats before its G slab in each 32-row group of the G image
  int blk0;   // its first dW block
  short K, N, nwo;  // inputs, outputs, G slab columns (8 .. 128)
  signed char kind, head, layer;  // NH_A_*; K1: head -1 sdf, -2 rgb2, -3 rgb1's W_hc
};

// The calling warpgroup's 128 threads (named barrier 1 or 2)
__device__ __forceinline__ void nh_bar() {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
}

// Where element o of a pass's slabs (KS deep, nw columns, from the pass's
// img on) sits: B(k, n), and whether it is the lo half
template <int KS>
__device__ __forceinline__ void nh_slab_at(int o, int nw, int& k, int& n, bool& lo) {
  const int f = 2 * KS * nw, sl = o / f, q = o - sl * f;
  lo = q >= KS * nw;
  const int q2 = lo ? q - KS * nw : q, kc = q2 / (4 * nw), q3 = q2 - kc * 4 * nw;
  n = (q3 >> 5) * 8 + ((q3 & 31) >> 2);
  k = KS * sl + 4 * kc + (q3 & 3);
}

// Sum over the 4 threads of an accumulator quad (a row's columns)
__device__ __forceinline__ float nh_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------------ the ring

// The ring's barriers and slot counters (the first 32 floats of shared
// memory), then the ring
__device__ __forceinline__ float* nh_ring_init(float* smem, int stages, uint64_t*& full,
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

// The engine's weight slabs (KS deep) in the order it takes them: tile
// after tile (blockIdx.x, then every gridDim.x-th), pass after pass, slab
// after slab. next() gives the next slab's source and size and moves on.
// Args: the kernel's args, with pass[], n_pass and n_tiles.
template <class Args, int KS>
struct NhFeed {
  static constexpr int kKS = KS;
  static constexpr int kSlot = 2 * KS * NH_NMAX;  // floats of a ring slot: the widest slab, hi and lo
  const Args* a;
  const float* pk;
  int tile, p, q;
  __device__ __forceinline__ bool next(const float*& src, uint32_t& bytes) {
    if (tile >= a->n_tiles) return false;
    const NhPass& ps = a->pass[p];
    const int f = 2 * KS * ps.nw;
    src = pk + ps.img + q * f;
    bytes = 4 * f;
    if (++q == ps.nsl) {
      q = 0;
      if (++p == a->n_pass) {
        p = 0;
        tile += gridDim.x;
      }
    }
    return true;
  }
};

// The first `stages` slabs of feed into the ring (thread 0), every thread
// moving its copy of feed on by as many
template <class Feed>
__device__ __forceinline__ void nh_prime(Feed& feed, int stages, float* ring, uint64_t* full) {
  for (int i = 0; i < stages; ++i) {
    const float* src;
    uint32_t bytes;
    if (feed.next(src, bytes) && threadIdx.x == 0)
      rw_bulk_load(ring + i * Feed::kSlot, src, bytes, full + i);
  }
}

// The warp is done with the slab in `slot`: it counts itself out, and the
// last of the block's warps refills the slot with feed's next slab,
// `stages` on from the one it held. Every thread moves its copy of feed on.
template <class Feed>
__device__ __forceinline__ void nh_release(Feed& feed, int slot, float* ring, uint64_t* full,
                                           uint32_t* cnt) {
  const float* src = nullptr;
  uint32_t bytes = 0;
  const bool more = feed.next(src, bytes);
  __syncwarp();
  if ((threadIdx.x & 31) == 0 && atomicAdd(cnt + slot, 1u) % NH_WARPS == NH_WARPS - 1 && more)
    rw_bulk_load(ring + slot * Feed::kSlot, src, bytes, full + slot);
}

// One pass: sum (the warpgroup's 64 rows x NW columns) = A . B over nsl
// slabs of KS (Feed::kKS): A's columns [KS s, KS s + KS) from xs for s <
// nxs, from as at column KS (s - nxs) after (row-major, zero or finite past
// the reduction, whose weights are zero); B the pass's slabs through the
// ring. Per slab, each k8 step's three products (lo.hi, hi.lo, hi.hi)
// accumulate in the tensor core from zero and the slab's sum is added to
// sum in fp32. it: the ring position, slot it % stages of phase it /
// stages, counted modulo 2 stages (no division per slab).
template <int NW, class Feed>
__device__ __forceinline__ void nh_pass(float (&sum)[NW / 2], const float* xs, int ldx,
                                        const float* as, int lda, int nsl, int nxs, float* ring,
                                        uint64_t* full, uint32_t* cnt, int stages, int& it,
                                        Feed& feed) {
  constexpr int KS = Feed::kKS, K8 = KS / 8;
  const int mw = 16 * ((threadIdx.x >> 5) & 3);
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) sum[i] = acc[i] = 0.f;
  for (int s = 0; s < nsl; ++s) {
    const int phase = it >= stages, slot = it - (phase ? stages : 0);
    const float* sl = ring + slot * Feed::kSlot;
    const HmMK A = s < nxs ? HmMK{xs + KS * s, ldx} : HmMK{as + KS * (s - nxs), lda};
    uint32_t ah[K8][4], al[K8][4];
#pragma unroll
    for (int j = 0; j < K8; ++j) rw_frag_a(A, 8 * j, mw, ah[j], al[j]);
    rw_mbar_wait(full + slot, phase);
    rw_own(acc);
    rw_wgmma_fence();
#pragma unroll
    for (int j = 0; j < K8; ++j) {
      const float* bh = sl + 8 * NW * j;
      const uint64_t dh = rw_desc(bh, 16 * NW, 128), dl = rw_desc(bh + KS * NW, 16 * NW, 128);
      rw_mma<NW>(acc, al[j], dh, j);
      rw_mma<NW>(acc, ah[j], dl, 1);
      rw_mma<NW>(acc, ah[j], dh, 1);
    }
    rw_commit();
    rw_wait0();
    rw_own(acc);
#pragma unroll
    for (int j = 0; j < K8; ++j) {
      rw_own(ah[j]);
      rw_own(al[j]);
    }
    nh_release(feed, slot, ring, full, cnt);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) sum[i] += acc[i];
    if (++it == 2 * stages) it = 0;
  }
}

// ------------------------------------------------------------------ the backward

// The row of a 32-row group at position k of its dW slab: k = 8 j + 4 h +
// t holds row 16 h + 4 t + j, so that the four rows a warp's A^T fragment
// load reads at once (t = 0 .. 3) lie in four chunks of 4 rows (nh_dw_fill)
__host__ __device__ __forceinline__ int nh_slab_row(int k) {
  return 16 * ((k >> 2) & 1) + 4 * (k & 3) + (k >> 3);
}

// Rows r0 .. r0 + 64 of a layer's G (src: n columns, row stride ld) into
// its dW slabs, in fp32 (dW's producer warp splits them): 32-row group
// r / 32 at gimg + (r / 32) gstride + goff, [k / 4][c / 8][c % 8][k % 4],
// k the row's position (nh_slab_row). A thread takes 4 positions of a
// column at a time: one float4, a streaming store (G is read back by the
// next launch, from device memory).
__device__ __forceinline__ void nh_gput(const float* src, int ld, int n, const NhDw& d,
                                        float* gimg, int gstride, int r0) {
  const int nwo = d.nwo;
  for (int e = threadIdx.x & 127; e < (NH_HALF / 4) * nwo; e += 128) {
    const int k4 = e / nwo, c = e - k4 * nwo, grp = k4 >> 3, k0 = 4 * (k4 & 7);
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = c < n ? src[(NH_RS * grp + nh_slab_row(k0 + q)) * ld + c] : 0.f;
    float* p = gimg + (size_t)(r0 / NH_RS + grp) * gstride + d.goff + (k4 & 7) * (4 * nwo) +
               (c >> 3) * 32 + (c & 7) * 4;
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
}

// Bit i of the result: whether the saved layer output (rows, n) at the
// thread's accumulator element i (rw_each's order: element 4 j + 2 h + u
// at row m + 8 h, column 8 j + c + u) is positive, for the warpgroup's
// rows from r0, of which the first nr exist; the loads issued 16 at a
// time, two parts in flight (NW / 2 <= 64 elements)
template <int NW>
__device__ __forceinline__ uint64_t nh_mask_bits(const float* __restrict__ act, int n, int r0,
                                                 int nr) {
  const int lane = threadIdx.x & 31, m = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int c = 2 * (lane & 3);
  constexpr int B = NW / 2 < 16 ? NW / 2 : 16, P = NW / 2 / B;  // parts of B loads
  float v[2][B];
  auto load = [&](int p, float (&w)[B]) {
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int e = p * B + i, k = 8 * (e >> 2) + c + (e & 1), row = m + 8 * ((e >> 1) & 1);
      w[i] = row < nr && k < n ? __ldg(act + (size_t)(r0 + row) * n + k) : 0.f;
    }
  };
  uint64_t bits = 0;
  load(0, v[0]);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p + 1 < P) load(p + 1, v[(p + 1) & 1]);  // the next part in flight while this one is tested
#pragma unroll
    for (int i = 0; i < B; ++i) bits |= (uint64_t)(v[p & 1][i] > 0.f) << (p * B + i);
  }
  return bits;
}

// f(m, k, i, v) for each accumulator element i of the thread at row m,
// column k < n
template <int NW, class F>
__device__ __forceinline__ void nh_each_bit(const float (&v)[NW / 2], int n, const F& f) {
  const int lane = threadIdx.x & 31, m = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int k = 8 * (i >> 2) + c + (i & 1);
    if (k < n) f(m + 8 * ((i >> 1) & 1), k, i, v[i]);
  }
}

// n floats from p on into L2, one 128-byte line per thread of the
// warpgroup at a time
__device__ __forceinline__ void nh_prefetch_l2(const float* p, int n) {
  for (int i = 32 * (threadIdx.x & 127); i < n; i += 32 * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + i));
}

// ------------------------------------------------------------------ dW

// dW layer d's A operand as it lands in a slot's tiles: whole rows of up
// to two sources, each tile 8 chunks of 4 rows (rows 4 c .. 4 c + 3 of the
// slab at chunk c, c (4 ld + 8) floats in: the padding puts the chunks
// that a fragment load reads at once on other banks). Tile 0 holds the
// embedding where the layer reads it, else the saved block of its h (K1's
// hc: feat's, and the colour's in tile 1); tile 1 the h of a layer that
// reads the embedding and h.
struct NhDwSrc {
  const float* src[2];
  int ld[2], n;  // the tiles' row strides; tiles
  int cx;        // the layer's embedding columns (0: none)
};

// A bulk copy by the TMA unit that completes on bar (the caller has set
// the barrier's expected bytes)
__device__ __forceinline__ void nh_bulk(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(rw_addr(dst)),
      "l"(src), "r"(bytes), "r"(rw_addr(bar))
      : "memory");
}

// The rows of A's chunk c (4 rows from rb + 4 c) that exist, of `rows`
__device__ __forceinline__ uint32_t nh_chunk_rows(int rows, int rb, int c) {
  const int n = rows - rb - 4 * c;
  return n >= 4 ? 4u : n > 0 ? (uint32_t)n : 0u;
}

// Slab rb .. rb + 32 of dW layer d into slot sl, by the calling warp: G's
// fp32 slab (lane 0), and lane 8 t + c the chunk c of tile t (its rows
// below `rows`), every copy on the slot's barrier, whose expected bytes
// lane 0 sets first
__device__ __forceinline__ void nh_dw_fill(const NhDw& d, const NhDwSrc& S, const float* gimg,
                                           int gstride, int rows, float* sl, uint64_t* bar, int rb) {
  const int lane = threadIdx.x & 31, t = lane >> 3, c = lane & 7;
  if (lane == 0) {
    uint32_t bytes = 128u * d.nwo;
    const uint32_t slab_rows = rows - rb < NH_RS ? (uint32_t)(rows - rb) : NH_RS;
    for (int i = 0; i < S.n; ++i) bytes += slab_rows * 4u * S.ld[i];
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(rw_addr(bar)), "r"(bytes)
                 : "memory");
  }
  __syncwarp();
  if (lane == 0) nh_bulk(sl, gimg + (size_t)(rb / NH_RS) * gstride + d.goff, 128u * d.nwo, bar);
  const uint32_t nr = nh_chunk_rows(rows, rb, c);
  if (t < S.n && nr > 0)
    nh_bulk(sl + NH_DW_SLAB + t * NH_DW_A + c * (4 * S.ld[t] + 8),
            S.src[t] + (size_t)(rb + 4 * c) * S.ld[t], 4u * S.ld[t] * nr, bar);
}

// dW's ring: per slot, full (the TMA copies landed), ready (G split),
// empty (every compute warp done with it)
struct NhDwRing {
  float* slots;
  uint64_t *full, *ready, *empty;
};

static const size_t NH_DW_SMEM = sizeof(float) * (32 + (size_t)NH_DW_STAGES * NH_DW_SLOT);

// dW's ring in shared memory (its barriers in the first 32 floats); with
// zero_a, every slot's A tiles start from zero (a chunk whose last slab
// holds rows past the last one: those rows of the tiles are never copied,
// and G's zero rows must meet finite values there). Ends with a block barrier.
__device__ __forceinline__ NhDwRing nh_dw_ring(float* smem, bool zero_a) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const NhDwRing R{smem + 32, bars, bars + NH_DW_STAGES, bars + 2 * NH_DW_STAGES};
  if (threadIdx.x == 0) {
    for (int i = 0; i < NH_DW_STAGES; ++i) {
      rw_mbar_init(R.full + i, 1);
      rw_mbar_init(R.ready + i, 1);
      rw_mbar_init(R.empty + i, NH_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (zero_a) {
    for (int s = 0; s < NH_DW_STAGES; ++s)
      for (int i = threadIdx.x; i < 2 * NH_DW_A; i += blockDim.x)
        R.slots[s * NH_DW_SLOT + NH_DW_SLAB + i] = 0.f;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // before the TMA's writes
  }
  __syncthreads();
  return R;
}

// dW = G^T A and db = sum G of the layer di over the chunk blockIdx.y of
// a.pc rows, as dW^T = A^T G: blockIdx.x is one of the layer's blocks of
// NH_DW_M inputs x NWO outputs. Warp specialised: the block's last
// warpgroup hands registers to the two that run the products
// (setmaxnreg: 168 each at launch; 56 and 224 after, which keeps NWO =
// 128's sum, slab partial and A fragments out of local memory); its first
// warp fills a ring of NH_DW_STAGES slots by TMA bulk copies (G's fp32
// slab, its rows in nh_slab_row's order, and A's whole rows in chunks of
// 4: nh_dw_src) and refills a slot once both warpgroups are done with it,
// and its four warps split each landed G slab into tf32 hi / lo in place
// (one warp's split was dW's bottleneck). The
// warpgroups take A^T's fragments from the slot's tiles (in the same row
// order); each slab's products accumulate in the tensor core and are added
// to fp32 registers. The block of the first inputs also sums G's columns
// for db (hi + lo, in row order). Into ws, the chunk's slice. Args: the
// caller's args (dw[], rows, pc, gstride) with nh_dw_src, nh_dw_dst and
// nh_dw_boff for them.
template <int NWO, class Args>
__device__ __forceinline__ void nh_dw_block(const Args& a, int di, const float* __restrict__ lad,
                                            const float* __restrict__ acts,
                                            const float* __restrict__ gimg, float* __restrict__ ws,
                                            const NhDwRing& R) {
  const NhDw& d = a.dw[di];
  const int tid = threadIdx.x, mt = blockIdx.x - d.blk0, ib0 = NH_DW_M * mt;
  const int r0 = blockIdx.y * a.pc, nsl = (min(a.pc, a.rows - r0) + NH_RS - 1) / NH_RS;
  const int lane = tid & 31;
  if (tid >= NH_THREADS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(NH_DW_REGS_PRODUCER) : "memory");
    const int pt = tid - NH_THREADS;  // its thread; the copies are its first warp's
    const NhDwSrc S = nh_dw_src(a, d, acts, lad);
    if (pt < 32)
      for (int s = 0; s < NH_DW_STAGES && s < nsl; ++s)
        nh_dw_fill(d, S, gimg, a.gstride, a.rows, R.slots + s * NH_DW_SLOT, R.full + s,
                   r0 + NH_RS * s);
    for (int s = 0; s < nsl; ++s) {
      const int slot = s % NH_DW_STAGES;
      rw_mbar_wait(R.full + slot, (s / NH_DW_STAGES) & 1);
      float4* g = reinterpret_cast<float4*>(R.slots + slot * NH_DW_SLOT);
      for (int e = pt; e < 8 * NWO; e += 128) {  // G into hi (in place) and lo
        const float4 v = g[e];
        uint32_t h[4], l[4];
        rw_split(v.x, h[0], l[0]);
        rw_split(v.y, h[1], l[1]);
        rw_split(v.z, h[2], l[2]);
        rw_split(v.w, h[3], l[3]);
        g[e] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                           __uint_as_float(h[3]));
        g[e + 8 * NWO] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                     __uint_as_float(l[2]), __uint_as_float(l[3]));
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the split, to wgmma's reads
      asm volatile("bar.sync 3, 128;" ::: "memory");  // the warpgroup's split is complete
      if (pt == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(rw_addr(R.ready + slot))
                     : "memory");
      // slab s - 1's slot, once both warpgroups are done with it, takes slab s - 1 + stages
      const int f = s - 1 + NH_DW_STAGES;
      if (pt < 32 && s >= 1 && f < nsl) {
        const int fs = (s - 1) % NH_DW_STAGES;
        rw_mbar_wait(R.empty + fs, ((s - 1) / NH_DW_STAGES) & 1);
        nh_dw_fill(d, S, gimg, a.gstride, a.rows, R.slots + fs * NH_DW_SLOT, R.full + fs,
                   r0 + NH_RS * f);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(NH_DW_REGS_MMA) : "memory");
  const int wg = tid >> 7, tq = lane & 3;
  const int i0 = ib0 + 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const NhDwSrc S = nh_dw_src(a, d, acts, lad);
  // each input's tile, column and row stride there; kind: 0 past the
  // inputs, 1 the tile's value, 2 the sum of both tiles' (hc)
  int tile[2], col[2], ld[2], kind[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = i0 + 8 * u;
    tile[u] = S.cx > 0 && i >= S.cx ? 1 : 0;
    col[u] = i - (tile[u] ? S.cx : 0);
    ld[u] = S.ld[tile[u]];
    kind[u] = i >= d.K ? 0 : d.kind == NH_A_HC ? 2 : 1;
  }
  const bool do_b = mt == 0 && wg == 0 && tid < NWO;
  float db = 0.f, sum[NWO / 2], acc[NWO / 2];
#pragma unroll
  for (int i = 0; i < NWO / 2; ++i) sum[i] = acc[i] = 0.f;
  for (int s = 0; s < nsl; ++s) {
    const int slot = s % NH_DW_STAGES;
    const float* sl = R.slots + slot * NH_DW_SLOT;
    rw_mbar_wait(R.ready + slot, (s / NH_DW_STAGES) & 1);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // position 8 j + 4 (q >> 1) + tq: row 4 c + j, c = 4 (q >> 1) + tq
        const int u = q & 1, c = 4 * (q >> 1) + tq;
        const float* t = sl + NH_DW_SLAB + tile[u] * NH_DW_A + c * (4 * ld[u] + 8) + j * ld[u] + col[u];
        rw_split(kind[u] == 0 ? 0.f : kind[u] == 2 ? t[0] + t[NH_DW_A] : t[0], ah[j][q], al[j][q]);
      }
    if (do_b) {
      const float* hb = sl + (tid >> 3) * 32 + (tid & 7) * 4;
#pragma unroll
      for (int kc = 0; kc < NH_RS / 4; ++kc) {
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
    __syncwarp();  // the warp is done with the slot
    if (lane == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(rw_addr(R.empty + slot)) : "memory");
#pragma unroll
    for (int i = 0; i < NWO / 2; ++i) sum[i] += acc[i];
  }
  const int ib = ib0 + 64 * wg;
  rw_each<NWO>(sum, [&](int m, int cl, float v0, float v1) {
    const int i = ib + m;
    if (i >= d.K) return;
    float sc;
    if (cl < d.N) {
      const long long o = nh_dw_dst(a, d, cl, i, sc);
      ws[o] = v0 * sc;
    }
    if (cl + 1 < d.N) {
      const long long o = nh_dw_dst(a, d, cl + 1, i, sc);
      ws[o] = v1 * sc;
    }
  });
  if (do_b && tid < d.N) {
    const int ob = nh_dw_boff(a, d);
    if (ob >= 0) ws[ob + tid] = db;
  }
}

// nh_dw_block<NWO> for the layer's G slab width
template <class Args>
__device__ __forceinline__ void nh_dw_layer(const Args& a, int di, const float* __restrict__ lad,
                                            const float* __restrict__ acts,
                                            const float* __restrict__ gimg, float* __restrict__ ws,
                                            const NhDwRing& R) {
  switch (a.dw[di].nwo) {
    case 128: nh_dw_block<128>(a, di, lad, acts, gimg, ws, R); break;
    case 64: nh_dw_block<64>(a, di, lad, acts, gimg, ws, R); break;
    case 32: nh_dw_block<32>(a, di, lad, acts, gimg, ws, R); break;
    case 16: nh_dw_block<16>(a, di, lad, acts, gimg, ws, R); break;
    default: nh_dw_block<8>(a, di, lad, acts, gimg, ws, R); break;
  }
}

// ------------------------------------------------------------------ the host

static int nh_set_smem(const void* kernel, size_t smem) {
  if (smem > NH_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

static int nh_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

static bool nh_wgmma_width(int nw) { return nw == 8 || nw == 16 || nw == 32 || nw == 64 || nw == 128; }
