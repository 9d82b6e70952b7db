"""The benchmark's tests run from the root of the checkout on the CPU; the
ones marked `cuda` need a card and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the tiny traffic of the CPU runs: the cells' widths, a few rays and pixels
TINY = {
    "train": dict(imgs_per_gpu=2, pixels_per_image=8, iters_per_round=2, trace_units=2),
    "render": dict(render_res=16, frames=4, warm_frames=1, ref_chunk=64, chunk=64, trace_units=1),
}


@pytest.fixture(scope="session")
def torch_threads():
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
