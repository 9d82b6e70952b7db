"""Training CLI of the port.

Port of lab4d_tpu/train.py on PyTorch: the flags of lab4d_tpu/config.py,
with the same names and defaults, parsed with argparse. It runs the prior
fits and then rounds of AdamW steps on one card, or on --ngpu cards, writing
`<logroot>/<seqname>-<logname>/` (opts.log, metrics.jsonl, proxy meshes and
ckpt_*.flax checkpoints in the JAX trainer's layout).

    python -m lab4d_tpu_torch.train --seqname cat --logname bg --field_type bg
    python -m lab4d_tpu_torch.train --seqname cat --logname fg --field_type fg \
        --fg_motion skel-quad

    python -m lab4d_tpu_torch.train --seqname cat --logname comp --field_type comp \
        --fg_motion comp_skel-human_dense

    python -m lab4d_tpu_torch.train --seqname cat --logname cate --fg_motion \
        comp_skel-human_dense --nosingle_inst      # a multi-video category model
    python -m lab4d_tpu_torch.train --seqname dog --logname ft --fg_motion \
        comp_skel-human_dense --load_path logdir/cat-cate/ckpt_latest.flax --freeze_bone_len

    python -m lab4d_tpu_torch.train --ngpu 4 ...            # four cards, one process each
    torchrun --nproc_per_node 4 -m lab4d_tpu_torch.train --ngpu 4 ...
    python -m lab4d_tpu_torch.train --ngpu 2 --use_cpu ...  # two CPU processes (gloo)

--ngpu N trains on N ranks, one process per card (NCCL; gloo with
--use_cpu), on a global batch of imgs_per_gpu x N pairs of which each
rank takes its block; every update is the one-process update on the
global batch (parallel/dist.py). Outside torchrun the CLI starts the N
processes itself; under torchrun (or the JAX package's LAB4D_MULTIHOST
rendezvous) each process is one rank and the world size must equal
--ngpu. --ngpu above the visible cards is an error. --video_shards V makes
block j of the global batch draw from the videos of group j % V, as the
JAX trainer's ("data", "video") mesh does.

Every --field_type (fg, bg, comp) and --fg_motion of the JAX package
trains, one shared morphology or (--nosingle_inst) one instance code per
video. --load_path starts from a checkpoint of either package (transfer,
or with --noreset_steps a resumed run). opts.log is written in the JAX
package's format (flagfile.py), and `--flagfile` reads one; boolean flags
take absl's `--noname` as well as `--no-name`. The flags are checked at
startup as lab4d_tpu/config.py checks them (config_hier.validate), and
`--profile` cuts a round to 10 iterations.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch

from lab4d_tpu_torch.flagfile import (add_config_flags, add_flagfile_option, parse_opts,
                                      validate_opts, write_opts_log)
from lab4d_tpu_torch.nnutils.warping import parse_warp_type
from lab4d_tpu_torch.parallel import dist

# flag -> (default, help), as in lab4d_tpu/config.py
LOSS_WEIGHTS = {
    "mask_wt": (0.1, "weight for silhouette loss"),
    "rgb_wt": (0.1, "weight for color loss"),
    "depth_wt": (1e-4, "weight for depth loss"),
    "flow_wt": (0.5, "weight for flow loss"),
    "vis_wt": (1e-2, "weight for visibility loss"),
    "feature_wt": (1e-2, "weight for feature reconstruction loss"),
    "feat_reproj_wt": (5e-2, "weight for feature reprojection loss"),
    "reg_visibility_wt": (1e-4, "weight for visibility regularization"),
    "reg_eikonal_wt": (1e-3, "weight for eikonal regularization"),
    "reg_deform_cyc_wt": (0.01, "weight for deform cyc regularization"),
    "reg_delta_skin_wt": (5e-3, "weight for delta skinning reg"),
    "reg_skin_entropy_wt": (5e-4, "weight for skinning entropy reg"),
    "reg_gauss_skin_wt": (1e-3, "weight for gauss skinning consistency"),
    "reg_cam_prior_wt": (0.1, "weight for camera regularization"),
    "reg_skel_prior_wt": (0.1, "weight for skeleton regularization"),
    "reg_gauss_mask_wt": (0.01, "weight for gauss mask regularization"),
    "reg_soft_deform_wt": (100.0, "weight for soft deformation reg"),
}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, (default, help_) in LOSS_WEIGHTS.items():
        p.add_argument(f"--{name}", type=float, default=default, help=help_)
    p.add_argument("--field_type", default="fg", help="{bg, fg, comp}")
    p.add_argument("--fg_motion", default="rigid",
                   help="{rigid, dense, nvp, bob, skel-human, skel-quad, "
                        "comp_skel-human_dense, comp_skel-quad_dense}")
    p.add_argument("--single_inst", action=argparse.BooleanOptionalAction, default=True,
                   help="assume the same morphology over objs")
    p.add_argument("--seqname", default="cat", help="name of the sequence")
    p.add_argument("--logname", default="tmp", help="name of the saved log")
    p.add_argument("--data_prefix", default="crop", help="prefix of the data entries, {crop, full}")
    p.add_argument("--train_res", type=int, default=256, help="size of training images")
    p.add_argument("--logroot", default="logdir/", help="root directory for log files")
    p.add_argument("--feature_type", default="dinov2", help="{dinov2, cse}")
    p.add_argument("--load_path", default="", help="path to load pretrained model")
    p.add_argument("--load_suffix", default="", help="suffix of params, {latest, 0, 10, ...}")
    p.add_argument("--learning_rate", type=float, default=5e-4, help="learning rate")
    p.add_argument("--num_rounds", type=int, default=20, help="number of rounds to train")
    p.add_argument("--iters_per_round", type=int, default=200, help="number of iterations per round")
    p.add_argument("--imgs_per_gpu", type=int, default=128, help="images samples per iter")
    p.add_argument("--pixels_per_image", type=int, default=16, help="pixel samples per image")
    p.add_argument("--freeze_bone_len", action=argparse.BooleanOptionalAction, default=False,
                   help="do not change bone length of skeleton")
    p.add_argument("--reset_steps", action=argparse.BooleanOptionalAction, default=True,
                   help="reset steps of loss scheduling, set to False if resuming training")
    p.add_argument("--ngpu", type=int, default=1,
                   help="number of cards (ranks) to shard the ray batch over")
    p.add_argument("--video_shards", type=int, default=1,
                   help="video groups of a category model's batch: block j of the global "
                        "batch draws from videos j %% video_shards (must divide ngpu and the "
                        "video count)")
    p.add_argument("--num_workers", type=int, default=2, help="number of data-loading threads")
    p.add_argument("--save_freq", type=int, default=10, help="params saving frequency")
    p.add_argument("--eval_res", type=int, default=64, help="size used for eval visualizations")
    p.add_argument("--geo_init_steps", type=int, default=500,
                   help="SDF-distillation steps for geometry init")
    p.add_argument("--profile", action=argparse.BooleanOptionalAction, default=False,
                   help="profile the training loop (10 iterations per round)")
    p.add_argument("--database_root", default="database",
                   help="root of preprocessed dataset + configs")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on; opts.log writes it as --use_cpu / --nouse_cpu")
    p.add_argument("--use_cpu", action=argparse.BooleanOptionalAction, default=False,
                   help="train on the CPU (the same as --device cpu)")
    add_flagfile_option(p)
    add_config_flags(p)
    return p


def check_opts(opts: Dict):
    """The JAX package's startup checks (flagfile.validate_opts), then the
    port's own: a known warp and an existing --load_path file."""
    validate_opts(opts)
    if opts["field_type"] != "bg":
        parse_warp_type(opts["fg_motion"])  # raises on an unknown motion
    if opts["load_path"] and not os.path.isfile(opts["load_path"]):
        raise FileNotFoundError(f"--load_path {opts['load_path']}: no such checkpoint")


def save_opts(opts: Dict):
    """Snapshot the flags to <logroot>/<seqname>-<logname>/opts.log, as the
    JAX trainer writes it (every flag of lab4d_tpu/config.py)."""
    save_dir = os.path.join(opts["logroot"], "%s-%s" % (opts["seqname"], opts["logname"]))
    os.makedirs(save_dir, exist_ok=True)
    write_opts_log(os.path.join(save_dir, "opts.log"), opts)


def train(opts: Dict):
    """Build the trainer and run every round (over ranks: this rank's
    part; rank 0 writes opts.log); returns the trainer."""
    from lab4d_tpu_torch.engine.trainer import Trainer

    check_opts(opts)
    if opts["device"].startswith("cuda"):
        # fp32 products in full precision, as the kernels and the parity tests assume
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if dist.is_main():
        save_opts(opts)
    trainer = Trainer(opts)
    try:
        trainer.train()
    finally:
        trainer.close()
    return trainer


def check_cards(opts: Dict, local_ranks: int):
    """On the card, `local_ranks` ranks need as many visible cards."""
    if not opts["device"].startswith("cuda"):
        return
    visible = torch.cuda.device_count()
    if local_ranks > visible:
        raise SystemExit(f"--ngpu {opts['ngpu']} needs {local_ranks} cards on this host; "
                         f"{visible} visible")


def run_rank(rank: int, opts: Dict, init_method=None, world=None):
    """One rank: join the group (from the arguments, else the environment),
    train on this rank's device, leave the group."""
    if opts["device"] == "cpu" and world:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = dist.init_distributed(opts["device"], init_method, world, rank)
    try:
        return train(dict(opts, device=str(device)))
    finally:
        dist.shutdown()


def launch(opts: Dict):
    """Train on --ngpu ranks: this process alone at --ngpu 1; one rank of
    the group that torchrun's (or LAB4D_MULTIHOST's) environment describes,
    whose size must be --ngpu; else --ngpu processes started here, one per
    card (or on the CPU with --use_cpu). Returns this process's trainer,
    or None where the trainers ran in processes started here."""
    n = opts["ngpu"]
    found = dist.env_world()
    if found is not None:
        if found["world_size"] != n:
            raise SystemExit(f"--ngpu {n} but the process group has {found['world_size']} ranks")
        check_cards(opts, found["local_rank"] + 1)
        return run_rank(found["rank"], opts)
    if n == 1:
        return train(opts)
    check_opts(opts)
    check_cards(opts, n)
    import torch.multiprocessing as mp

    init = f"tcp://localhost:{dist.free_port()}"
    mp.start_processes(run_rank, args=(opts, init, n), nprocs=n, start_method="spawn")
    return None


def main(argv=None):
    return launch(parse_opts(get_parser(), argv))


if __name__ == "__main__":
    main()
