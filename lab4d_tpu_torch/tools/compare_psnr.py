"""The port's side of scripts/compare_reference_psnr.py: the rigid object's
masked-PSNR trajectory on the same synthetic scene, held against the JAX
package's recorded 4-seed spread (psnr_compare.json,
"full_budget_seed_spread").

    python3 -m lab4d_tpu_torch.tools.compare_psnr [--seeds 0,1,2,3] [--rounds 20]
        [--iters 20] [--frames 81] [--res 64] [--device cuda] [--out psnr_torch.json]

Run from the root of a checkout. The protocol is compare_reference_psnr.py's
run_ours: tools/synthetic_scene.py's orbit scene (one video, `--frames`
frames at `--res`^2, 112^2 features), the flags `--fg_motion rigid
--field_type fg --imgs_per_gpu 4 --pixels_per_image 8 --num_workers 0
--eval_res min(res, 32) --num_rounds max(rounds, 3)` and `effective_iters`
steps per round; after each round the trainer refreshes its geometry and
renders its eval frames, whose masked PSNR (masked_psnr: PSNR over the
reference mask) is the trajectory. Then the canonical mesh is extracted at
grid 64 (level 0, no visibility mask, extended aabb) and divided by the fg
field's scale; its mean distance from the scene's sphere (radius 0.5) and
its Chamfer distance to the GT sphere (`uv_sphere(radius=0.5,
count=[32, 32])`, as scripts/compare_reference_psnr.py compare_meshes
measures it) are recorded, the latter beside the JAX package's recorded
value (psnr_compare.json "full_budget_400steps", the JAX package's own
400-step protocol on its own hardware). `--seeds`: one run per seed, the seed setting torch's
generators, the loader's and each video's pixel draws. Writes `--out`
(default psnr_torch.json at the repo root; psnr_compare.json is read, not
written) with each seed's trajectory, the final mean and sample std, and
the gap to the JAX package's recorded mean.

The flagship skel-quad model is compared with the JAX package on the CPU
by tests/test_torch_skel_quad_psnr.py, which builds on run_seed's parts
(build_trainer, train_rounds).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEQNAME = "refcmp"
SPHERE_RADIUS = 0.5  # tools/synthetic_scene.py's object


def masked_psnr(pred_rgb, ref_rgb, ref_mask):
    """PSNR over the pixels where the reference mask is on (the object;
    the synthetic scene's background is empty)."""
    m = ref_mask.reshape(-1) > 0.5
    if m.sum() == 0:
        return float("nan")
    a = pred_rgb.reshape(-1, 3)[m]
    b = ref_rgb.reshape(-1, 3)[m]
    mse = float(np.mean((a - b) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def effective_iters(iters, frames, imgs_per_gpu=4):
    """Optimizer steps per round of the protocol: the reference trainer's
    loader has floor((frames - 1) / imgs_per_gpu) batches per round, and
    both sides run that many steps when it is fewer than `iters`."""
    return min(iters, max((frames - 1) // imgs_per_gpu, 1))


def make_dataset(workdir, res, num_frames):
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    db = os.path.join(workdir, "database")
    if not os.path.exists(os.path.join(db, "configs", f"{SEQNAME}.config")):
        make_synthetic_dataset(db, seqname=SEQNAME, num_vids=1, num_frames=num_frames, res=res,
                               feat_res=112)
    return db


def train_argv(db, logroot, logname, fg_motion, rounds, res, iters, frames, device):
    """The train CLI's flags of the protocol (compare_reference_psnr.py run_ours)."""
    return ["--seqname", SEQNAME, "--logname", logname, "--fg_motion", fg_motion,
            "--field_type", "fg", "--train_res", str(res), "--eval_res", str(min(res, 32)),
            "--num_rounds", str(max(rounds, 3)),
            "--iters_per_round", str(effective_iters(iters, frames)),
            "--imgs_per_gpu", "4", "--pixels_per_image", "8", "--num_workers", "0",
            "--save_freq", "100", "--device", device, "--database_root", db,
            "--logroot", logroot]


def seed_draws(trainer, seed):
    """The loader's pair draws and each video's delta and pixel draws from `seed`."""
    trainer.trainloader.rng = np.random.default_rng(seed)
    for i, ds in enumerate(trainer.datasets):
        ds.rng = np.random.default_rng(seed + 1 + i)
        ds.idx_sampler.rng = ds.rng
        ds.idx_sampler._refill()


def build_trainer(db, workdir, seed, rounds, res, iters, frames, device, fg_motion="rigid",
                  extra=()):
    """The protocol's Trainer, its prior fits run, torch's generators seeded
    with `seed` first; `extra`: train flags appended to the protocol's."""
    import torch

    from lab4d_tpu_torch.engine.trainer import Trainer
    from lab4d_tpu_torch.train import check_opts, get_parser

    if device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(seed)
    opts = vars(get_parser().parse_args(train_argv(
        db, os.path.join(workdir, "logdir"), f"seed{seed}", fg_motion, rounds, res, iters,
        frames, device) + list(extra)))
    check_opts(opts)
    return Trainer(opts)


def train_rounds(trainer, seed, rounds):
    """The draws seeded from `seed`, then `rounds` rounds, each followed by
    the geometry refresh and the eval frames' masked PSNR: the trajectory."""
    seed_draws(trainer, seed)
    traj = []
    for r in range(rounds):
        trainer.train_one_round(r)
        trainer.current_round += 1
        trainer.update_geometry_aux()
        out, ref = trainer.render_frames(trainer.eval_fid)
        traj.append(masked_psnr(out["rgb"], ref["rgb"], ref["mask"][..., 0]))
        print(f"[psnr] seed {seed} round {r}: {traj[-1]:.4f}", flush=True)
    return traj


def mesh_metrics(trainer):
    """The canonical fg mesh in world units: its mean distance from the
    scene's sphere and its Chamfer distance to the GT sphere."""
    import torch

    from lab4d_tpu_torch.meshlib import Mesh, uv_sphere
    from lab4d_tpu_torch.utils.metrics import chamfer_distance

    mesh = trainer.extract_canonical_mesh("fg", grid_size=64, level=0.0, use_visibility=False,
                                          use_extend_aabb=True)
    scale = float(torch.exp(trainer.model.fields.field_params["fg"].logscale).item())
    verts = np.asarray(mesh.vertices, np.float64) / scale
    if not len(verts):
        return {"radius_err": float("nan"), "chamfer_vs_gt": float("nan")}
    world = Mesh(verts.astype(np.float32), np.asarray(mesh.faces))
    return {"radius_err": float(np.mean(np.abs(np.linalg.norm(verts, axis=-1) - SPHERE_RADIUS))),
            "chamfer_vs_gt": chamfer_distance(world, uv_sphere(radius=SPHERE_RADIUS,
                                                               count=[32, 32]))}


def run_seed(db, workdir, seed, rounds, res, iters, frames, device):
    """One protocol run; returns (trajectory, mesh_metrics, seconds)."""

    t = time.time()
    trainer = build_trainer(db, workdir, seed, rounds, res, iters, frames, device)
    try:
        traj = train_rounds(trainer, seed, rounds)
        mesh = mesh_metrics(trainer)
    finally:
        trainer.close()
    return traj, mesh, time.time() - t


def recorded_chamfer(path=os.path.join(ROOT, "psnr_compare.json")) -> float:
    """The JAX package's recorded Chamfer distance of its canonical mesh to
    the GT sphere (its 400-step protocol)."""
    with open(path) as f:
        return float(json.load(f)["full_budget_400steps"]["mesh"]["chamfer_ours_vs_gt"])


def recorded_spread(path=os.path.join(ROOT, "psnr_compare.json")):
    """The JAX package's recorded final masked PSNR over 4 seeds."""
    with open(path) as f:
        rec = json.load(f)["full_budget_seed_spread"]
    return {"settings": rec["settings"], "final_mean": rec["ours_final_mean"],
            "final_std": rec["ours_final_std"], "final_by_seed": rec["ours_final_by_seed"],
            "traj_by_seed": rec["ours_traj_by_seed"]}


def first_parting_round(trajs, reference, std):
    """The first round from which the seed-mean trajectory stays below the
    JAX mean trajectory by more than 2.5 of its final std, or None."""
    ours = np.mean([trajs[s] for s in trajs], axis=0)
    theirs = np.mean([reference[s] for s in reference], axis=0)[: len(ours)]
    below = ours[: len(theirs)] < theirs - 2.5 * std
    for r in range(len(below)):
        if below[r:].all():
            return r
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--frames", type=int, default=81)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "psnr_torch.json"))
    ap.add_argument("--workdir", default=None, help="where the scene and logs go (default: a "
                                                    "temporary directory)")
    args = ap.parse_args(argv)
    args.seeds = [int(s) for s in args.seeds.split(",")]
    write_result(args.out, lambda workdir: rigid(args, workdir), args.workdir)


def write_result(path, run, workdir=None):
    """Merge what `run(workdir)` returns into the JSON file at `path`."""
    result = {}
    if os.path.exists(path):
        with open(path) as f:
            result = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = os.path.abspath(workdir or tmp)
        os.makedirs(workdir, exist_ok=True)
        result.update(run(workdir))
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[psnr] wrote {path}")


def rigid(args, workdir):
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("compare_psnr: no CUDA device (pass --device cpu for the CPU)")
    db = make_dataset(workdir, args.res, args.frames)
    card = "cpu"
    if args.device.startswith("cuda"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
    trajs, meshes, secs = {}, {}, {}
    for seed in args.seeds:
        trajs[str(seed)], meshes[str(seed)], secs[str(seed)] = run_seed(
            db, workdir, seed, args.rounds, args.res, args.iters, args.frames, args.device)
    finals = [t[-1] for t in trajs.values()]
    rec = recorded_spread()
    mean = float(np.mean(finals))
    std = float(np.std(finals, ddof=1)) if len(finals) > 1 else float("nan")
    out = {
        "settings": {"rounds": args.rounds, "res": args.res, "iters_requested": args.iters,
                     "iters_effective": effective_iters(args.iters, args.frames),
                     "frames": args.frames, "seqname": SEQNAME, "seeds": args.seeds,
                     "device": args.device, "card": card},
        "torch_traj_by_seed": trajs,
        "torch_final_by_seed": {s: t[-1] for s, t in trajs.items()},
        "torch_final_mean": mean, "torch_final_std": std,
        "torch_last3_mean": float(np.mean([np.mean(t[-3:]) for t in trajs.values()])),
        "torch_mesh_radius_err_by_seed": {s: m["radius_err"] for s, m in meshes.items()},
        "torch_mesh_chamfer_vs_gt_by_seed": {s: m["chamfer_vs_gt"] for s, m in meshes.items()},
        "torch_mesh_chamfer_vs_gt_mean": float(np.mean([m["chamfer_vs_gt"]
                                                         for m in meshes.values()])),
        "jax_recorded_chamfer_vs_gt_400steps": recorded_chamfer(),
        "torch_seconds_by_seed": secs,
        "jax_recorded": {k: rec[k] for k in ("final_mean", "final_std", "final_by_seed")},
        "gap_final_mean": mean - rec["final_mean"],
        "within_1db": bool(abs(mean - rec["final_mean"]) <= 1.0),
    }
    if len(trajs) == len(rec["traj_by_seed"]) and args.rounds == rec["settings"]["rounds"]:
        out["parting_round"] = first_parting_round(trajs, rec["traj_by_seed"], rec["final_std"])
    print(f"[psnr] final masked PSNR {mean:.4f} +- {std:.4f} dB over seeds {args.seeds} "
          f"({card}); lab4d_tpu recorded {rec['final_mean']:.4f} +- {rec['final_std']:.4f}; "
          f"gap {mean - rec['final_mean']:+.4f} dB; canonical mesh's Chamfer distance to the GT "
          f"sphere {out['torch_mesh_chamfer_vs_gt_mean']:.4f} (lab4d_tpu recorded "
          f"{out['jax_recorded_chamfer_vs_gt_400steps']:.4f} after its own 400-step protocol)",
          flush=True)
    return out


if __name__ == "__main__":
    main()
