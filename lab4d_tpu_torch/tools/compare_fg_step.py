"""How far one fg / skel-quad training step on the GPU lies from the same
step on the CPU, at several fitted states, on one CUDA device.

    python3 -m lab4d_tpu_torch.tools.compare_fg_step [--geo_init_steps N ...] [--eikonal_all_rays]
        [--batch_seeds S ...] [--cate category]

Run from the root of a checkout. For each N it builds chip_smoke.py's
reference trainer (the synthetic scene, prior fits with N geometry-init
steps, one batch of 128 rays x 64 samples, seeded random draws) and runs
that step three times: on the GPU through the kernels, on the GPU with
every kernel replaced by its plain version, and on the CPU. It prints
each pair's worst loss term (relative error) and worst gradient (share
of chip_smoke.py's bound, 1e-5 + 1e-3 max|g|): kernels vs plain on the
GPU isolates the kernels; plain GPU vs CPU is the rest of the step's
arithmetic. Each pair also prints the eikonal term's ReLU ties (points
whose SDF chain takes another side of a ReLU's kink in the two steps) and
reg_eikonal with and without them; --eikonal_all_rays takes the term at
all 128 rays (8,192 points) instead of 8, to count ties at a state.
The prior fits on the GPU are not bitwise repeatable, and the loader's
first batch varies, so a state N differs from run to run;
--batch_seeds S ... runs each N once for each batch drawn from seed S
(a new trainer each time) and ends with how many runs lay outside the
bound. --cate category: chip_smoke.py's category model on its 8-video
scene instead. Each plain-GPU-vs-CPU pair also counts the ReLU inputs of
the whole step (every torch.relu, in call order) that lie on other sides
of zero in the two runs.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import tempfile


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--geo_init_steps", type=int, nargs="+", default=[5, 20, 100, 500])
    parser.add_argument("--eikonal_all_rays", action="store_true",
                        help="the eikonal term at every ray, not a drawn sixteenth")
    parser.add_argument("--batch_seeds", type=int, nargs="+", default=[None],
                        help="batches drawn from these seeds (default: the loader's first)")
    parser.add_argument("--cate", default="fg", choices=["fg", "category"],
                        help="the flagship model or the category model")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_fg_step: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import chip_smoke

    card = chip_smoke.phase_env()
    with tempfile.TemporaryDirectory() as root:
        db = chip_smoke.write_scene(root)
        if args.cate == "category":
            chip_smoke.write_category_scene(db)
        outside = collections.Counter()
        for n in args.geo_init_steps:
            for seed in args.batch_seeds:
                step = chip_smoke.reference_steps(db, root, args.cate, n, args.eikonal_all_rays,
                                                  seed)
                kernels = step("cuda")
                relu_gpu, relu_cpu = [], []
                with chip_smoke.plain_kernels(), chip_smoke._relu_inputs(relu_gpu):
                    plain = step("cuda")
                with chip_smoke._relu_inputs(relu_cpu):
                    cpu = step("cpu")
                flips = [(a.cpu() > 0) != (b > 0) for a, b in zip(relu_gpu, relu_cpu)
                         if a.shape == b.shape]
                tag = f"geo_init_steps {n}, batch seed {seed}"
                print(f"[compare] {tag}: ReLU inputs on other sides of zero, plain GPU vs "
                      f"CPU: {sum(int(f.sum()) for f in flips)} of "
                      f"{sum(f.numel() for f in flips)} in {len(flips)} calls")
                for what, got, want in (("kernels vs plain, GPU", kernels, plain),
                                        ("plain GPU vs CPU", plain, cpu),
                                        ("kernels GPU vs CPU", kernels, cpu)):
                    summary, failures = chip_smoke._compare_steps(
                        got, want, chip_smoke.TRAIN_REF_TOL, f"{tag}, {what}")
                    outside[(n, what)] += bool(failures)
                    print(f"[compare] {tag}, {what}: {summary}; "
                          f"{len(failures)} outside the bound")
        for (n, what), k in outside.items():
            print(f"[compare] geo_init_steps {n}, {what}: {k} of {len(args.batch_seeds)} runs "
                  "outside the bound")
    print(card)


if __name__ == "__main__":
    main()
