"""The plain reference of the benchmark: fp32 PyTorch, TF32 off.

`lab4d_ref/` is a frozen copy of the program's model math (the modules of
lab4d_tpu_torch's engine/model.py, nnutils/, ops/renderer.py and utils/
that the training step and the eval reach) with every kernel dispatch taken
out: each MLP runs its per-layer chain and the field heads run head by
head. The benchmark hands it the inputs it hands the program (the weights
and the scene it draws from the seed, the loader's batches) and it works
out everything else again. `precision.lowered()` is the control: the same
computation with every matrix product's operands in TF32.
"""
