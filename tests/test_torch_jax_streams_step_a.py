"""The port's own random streams against the JAX package's on one
trainer each, bg and the flagship fg / skel-quad (tests/
torch_streams_step.py): the trainer-built init equal to flax's
model.init(PRNGKey(0)) leaf by leaf, the prior fit's eikonal rays and two
training steps' draws equal to the ones the JAX trainer draws, with
nothing injected, and the first step's loss terms equal."""

import pytest
import torch

from tests import torch_streams_step as S

torch.set_num_threads(1)


@pytest.mark.parametrize("extra,categories", [
    (("--field_type", "bg"), ("bg",)),
    (("--field_type", "fg", "--fg_motion", "skel-quad"), ("fg",)),
], ids=["bg", "skel-quad"])
def test_streams_equal_jax(tmp_path, extra, categories):
    terms = S.run_case(tmp_path, extra, categories)
    assert len(terms) >= 7
