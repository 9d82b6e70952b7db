"""The check sees each fault a cell can have, planted in the timed path of
a whole run (the look for a card skipped, a test's size on the CPU): the
state left unchanged by a step, half of the batch left out (the mean taken
over the rest), an answer altered where it is produced. One card, so no
exchange between chips to leave out."""

import pytest

from benchmark import run as run_mod
from benchmark.tests.conftest import TINY

SEED = 2**31 + 999


@pytest.mark.parametrize("cell,fault", [
    ("dense.train", "state_unchanged"), ("dense.train", "half_batch"),
    ("skel-quad.render-topk", "answer_altered"), ("skel-quad.render-topk", "half_batch"),
    ("dense.render-topk", "answer_altered"), ("dense.render-topk", "half_batch")])
def test_fault_is_not_correct(cell, fault, torch_threads):
    args = run_mod.parse_args(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3"])
    tiny = TINY["train" if cell.endswith("train") else "render"]
    res = run_mod.run_cell(args, device="cpu", overrides=tiny, faults=(fault,))
    assert res["correct"] is False, res["checks"]
    sound = run_mod.run_cell(args, device="cpu", overrides=tiny)
    assert sound["correct"] is True, sound["checks"]
