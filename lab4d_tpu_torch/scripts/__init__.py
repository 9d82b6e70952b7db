"""The port's scripts outside the training / rendering entry points: the
five preprocessing-net trainers (train_*.py, their shared optimizer in
optim.py), the adversarial-scene validation and the tools over a run's
outputs (render_intermediate, create_collage, run_rendering_parallel,
run_crop_all). Each runs as `python -m lab4d_tpu_torch.scripts.<name>`."""
