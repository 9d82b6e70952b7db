"""The port's own random streams against the JAX package's (tests/
torch_streams_step.py), for both fields composed (--field_type comp) and
the category model (--nosingle_inst on two videos, whose instance-code
swaps draw from the step's swap key at each embedding's flax scope)."""

import pytest
import torch

from tests import torch_streams_step as S

torch.set_num_threads(1)


@pytest.mark.parametrize("extra,categories", [
    (("--field_type", "comp", "--fg_motion", "comp_skel-human_dense"), ("fg", "bg")),
    (("--field_type", "fg", "--fg_motion", "comp_skel-human_dense", "--no-single_inst"), ("fg",)),
], ids=["comp", "category"])
def test_streams_equal_jax(tmp_path, extra, categories):
    terms = S.run_case(tmp_path, extra, categories)
    assert len(terms) >= 10
