"""lab4d_tpu_torch: the PyTorch/CUDA port of lab4d_tpu for NVIDIA Hopper.

Module paths and class names mirror the JAX package (`lab4d_tpu`), which
stays the numerical reference. Plain tensor code is PyTorch; every Pallas
kernel of the JAX package becomes a kernel written by hand for sm_90a
(CUDA C++ under `csrc/`, built at first use). This package never imports
jax or flax: checkpoints written by the JAX trainer load through
`lab4d_tpu_torch.bridge`.

Ported so far: rendering (the exact merged two-pass eval, the top-k eval
and channel subsets), export and reanimation of the flagship model
(`field_type=fg`, `fg_motion=skel-quad`), the rigid object
(`fg_motion=rigid`) and the background field (`field_type=bg`), the
training of all three, and every kernel those paths run: the field heads
(K1 / K2), the fused ReLU MLP (K3f / K3b) and the Fourier-embedding MLP
(K4f / K4b).
"""

__version__ = "0.1.0"
