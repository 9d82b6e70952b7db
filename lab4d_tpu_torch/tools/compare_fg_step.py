"""How far one fg / skel-quad training step on the GPU lies from the same
step on the CPU, at several fitted states, on one CUDA device.

    python3 -m lab4d_tpu_torch.tools.compare_fg_step [--geo_init_steps N ...] [--eikonal_all_rays]
        [--batch_seeds S|first ...] [--cate category] [--pairs all|kernels]

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
("first": the loader's first batch, as chip_smoke.py takes it; a new
trainer each time) and ends with how many runs lay outside the bound.
--cate category: chip_smoke.py's category model on its 8-video scene
instead. Each plain-GPU-vs-CPU pair also counts the ReLU inputs of the
whole step (every torch.relu, in call order) that lie on other sides of
zero in the two runs; kernels vs plain counts them per call site (a
kernel's plain version calls torch.relu where the kernel does not) and
names the sites with the most. --pairs kernels runs kernels vs plain
only (no CPU step).
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import tempfile


def _relu_sites(rec):
    """A TorchFunctionMode that appends to rec[site] the input of every
    torch.relu called while it is on, site being the file:line of the
    innermost caller in this package."""
    import torch
    from torch.overrides import TorchFunctionMode

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.relu:
                f = sys._getframe(1)
                while f is not None and "lab4d_tpu_torch" not in f.f_code.co_filename:
                    f = f.f_back
                site = ("?" if f is None else
                        f"{f.f_code.co_filename.split('lab4d_tpu_torch')[-1][1:]}:{f.f_lineno}")
                rec.setdefault(site, []).append(args[0].detach())
            return func(*args, **(kwargs or {}))

    return Mode()


def _site_flips(got, want):
    """{site: (ReLU inputs on other sides of zero, of how many, largest
    |input| in `want` among them)} over the calls of each site that both
    runs made with the same shape, in call order."""
    out = {}
    for site in sorted(set(got) & set(want)):
        n = total = 0
        z = 0.0
        for a, b in zip(got[site], want[site]):
            if a.shape == b.shape:
                flip = (a > 0) != (b > 0)
                n += int(flip.sum())
                total += flip.numel()
                if flip.any():
                    z = max(z, float(b.abs()[flip].max()))
        out[site] = (n, total, z)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--geo_init_steps", type=int, nargs="+", default=[5, 20, 100, 500])
    parser.add_argument("--eikonal_all_rays", action="store_true",
                        help="the eikonal term at every ray, not a drawn sixteenth")
    parser.add_argument("--batch_seeds", nargs="+", default=["first"],
                        help="batches drawn from these seeds, or 'first': the loader's first")
    parser.add_argument("--cate", default="fg", choices=["fg", "category"],
                        help="the flagship model or the category model")
    parser.add_argument("--pairs", default="all", choices=["all", "kernels"],
                        help="every pair, or kernels vs plain on the GPU only")
    args = parser.parse_args(argv)
    seeds = [None if s == "first" else int(s) for s in args.batch_seeds]

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
            for seed in seeds:
                step = chip_smoke.reference_steps(db, root, args.cate, n, args.eikonal_all_rays,
                                                  seed)
                sites_k, sites_p = {}, {}
                with _relu_sites(sites_k):
                    kernels = step("cuda")
                relu_gpu, relu_cpu = [], []
                with chip_smoke.plain_kernels(), chip_smoke._relu_inputs(relu_gpu), \
                        _relu_sites(sites_p):
                    plain = step("cuda")
                tag = f"geo_init_steps {n}, batch {'first' if seed is None else f'seed {seed}'}"
                flips = _site_flips(sites_k, sites_p)
                top = sorted(flips.items(), key=lambda t: -t[1][0])[:3]
                print(f"[compare] {tag}: ReLU inputs on other sides of zero, kernels vs plain "
                      f"GPU: {sum(v[0] for v in flips.values())} of "
                      f"{sum(v[1] for v in flips.values())} at {len(flips)} call sites; most at "
                      + ", ".join(f"{k} {v[0]} of {v[1]} (largest |input| {v[2]:.2e})"
                                  for k, v in top))
                pairs = [("kernels vs plain, GPU", kernels, plain)]
                if args.pairs == "all":
                    with chip_smoke._relu_inputs(relu_cpu):
                        cpu = step("cpu")
                    flips = [(a.cpu() > 0) != (b > 0) for a, b in zip(relu_gpu, relu_cpu)
                             if a.shape == b.shape]
                    print(f"[compare] {tag}: ReLU inputs on other sides of zero, plain GPU vs "
                          f"CPU: {sum(int(f.sum()) for f in flips)} of "
                          f"{sum(f.numel() for f in flips)} in {len(flips)} calls")
                    pairs += [("plain GPU vs CPU", plain, cpu), ("kernels GPU vs CPU", kernels, cpu)]
                for what, got, want in pairs:
                    summary, failures = chip_smoke._compare_steps(
                        got, want, chip_smoke.TRAIN_REF_TOL, f"{tag}, {what}")
                    outside[(n, what)] += bool(failures)
                    print(f"[compare] {tag}, {what}: {summary}; "
                          f"{len(failures)} outside the bound")
        for (n, what), k in outside.items():
            print(f"[compare] geo_init_steps {n}, {what}: {k} of {len(seeds)} runs "
                  "outside the bound")
    print(card)


if __name__ == "__main__":
    main()
