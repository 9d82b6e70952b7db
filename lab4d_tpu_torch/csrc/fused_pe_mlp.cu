// K4f and K4b: the Fourier-embedding fused MLP, forward and backward,
// hand-written for Hopper (sm_90a).
//
// K4f replaces lab4d_tpu/ops/mlp_kernel.py:_pe_fwd (Pallas kernel
// _pe_fwd_kernel); K4b replaces _pe_bwd_call (_pe_bwd_kernel). The field
// MLPs of the training step (base, colour and visibility fields, and the
// visibility-decay points) run through them. The backward entry with
// n_freqs = 0 is also K3b, which replaces _bwd (_bwd_kernel), the VJP of
// fused_relu_mlp (K3f, fused_relu_mlp.cu): the camera and intrinsics
// TimeMLP backbones of the training step. The embedding, the layers and
// the backward's recompute never leave shared memory; the design, its bound
// and the deterministic weight-gradient reduction are described in
// mlp_tiles.cuh.

#include "mlp_tiles.cuh"

extern "C" {

// y (rows, out_last) = MLP(embed(x)); window: (n_freqs,) device pointer or
// null; freqs: n_freqs host floats. grid: blocks of a grid-stride launch.
int lab4d_fused_pe_mlp_fwd(const float* x, float* y, const void* const* w, const void* const* b,
                           const int* in_dim, const int* out_dim, int n_layers, int c_raw,
                           int n_freqs, const float* freqs, const float* window, int rows, int tr,
                           int skip_mask, int final_act, int grid, void* stream) {
  TileMlpArgs a;
  int err = tm_fill_args(a, w, b, in_dim, out_dim, n_layers, c_raw, n_freqs, freqs, window, rows,
                         tr, skip_mask, final_act);
  if (err) return err;
  return tm_launch_fwd(x, y, a, grid, stream);
}

// dx (rows, c_raw) and grads (every dW_l, then every db_l) of the MLP for
// the output gradient g (rows, out_last), already masked by the final ReLU.
// ws: grid * n_params floats of scratch, grid <= ceil(rows / tr).
int lab4d_fused_pe_mlp_bwd(const float* x, const float* g, float* dx, float* ws, float* grads,
                           const void* const* w, const void* const* b, const int* in_dim,
                           const int* out_dim, int n_layers, int c_raw, int n_freqs,
                           const float* freqs, const float* window, int rows, int tr,
                           int skip_mask, int grid, void* stream) {
  TileMlpArgs a;
  int err = tm_fill_args(a, w, b, in_dim, out_dim, n_layers, c_raw, n_freqs, freqs, window, rows,
                         tr, skip_mask, 0);
  if (err) return err;
  return tm_launch_bwd(x, g, dx, ws, grads, a, grid, stream);
}

const char* lab4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
