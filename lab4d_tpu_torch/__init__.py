"""lab4d_tpu_torch: the PyTorch/CUDA port of lab4d_tpu for NVIDIA Hopper.

Module paths and class names mirror the JAX package (`lab4d_tpu`), which
stays the numerical reference. Plain tensor code is PyTorch; every Pallas
kernel of the JAX package becomes a kernel written by hand for sm_90a
(CUDA C++ under `csrc/`, built at first use). This package never imports
jax or flax: checkpoints written by the JAX trainer load through
`lab4d_tpu_torch.bridge`.

Ported so far: the rendering path of the flagship model
(`field_type=fg`, `fg_motion=skel-quad`, exact merged two-pass eval) and
the forward of the fused ReLU-MLP kernel.
"""

__version__ = "0.1.0"
