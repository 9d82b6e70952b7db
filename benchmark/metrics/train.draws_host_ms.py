"""Host ms per step making the step's random draws (the program's span
train.draws: DVRModel.step_draws, inside the forward), over the window."""
from benchmark.metrics.program import mean_ms


def read(run):
    return mean_ms(run, "step", "train.draws")
