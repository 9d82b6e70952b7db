"""Every single-video warp through the port's CLIs on the CPU: `python -m
lab4d_tpu_torch.train --field_type fg --fg_motion <warp>` on a tiny
synthetic scene (1 round of 2 steps), then render (top-k), export and
reanimate of its checkpoint. The training steps themselves are held
against JAX in tests/test_torch_families*.py; here each CLI must accept
the warp and give finite outputs: a checkpoint and eval/psnr, frames,
meshes with the warp's motion file (joint angles for skeletons alone,
bones for skinning warps alone), and frames driven by that file.
"""

import json
import os

import numpy as np
import pytest
import torch

from lab4d_tpu_torch import bridge

# one torch thread per process: the CPU steps here are small, and with six
# test workers on the host's cores the OpenMP barriers of torch's default
# thread pool stall each small op for whole scheduler slices (process-wide)
torch.set_num_threads(1)

MOTIONS = ("bob", "skel-human", "dense", "nvp", "comp_skel-quad_dense")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    root = tmp_path_factory.mktemp("families_cli")
    make_synthetic_dataset(str(root / "database"), seqname="sf", num_frames=8, res=16)
    return root


@pytest.mark.parametrize("motion", MOTIONS)
def test_cli_trains_renders_exports_and_reanimates(scene, motion):
    from lab4d_tpu_torch import export, reanimate, render
    from lab4d_tpu_torch import train as train_cli

    run = ["--fg_motion", motion, "--seqname", "sf", "--logname", motion, "--train_res", "16",
           "--device", "cpu", "--database_root", str(scene / "database"),
           "--logroot", str(scene / "logdir")]
    trainer = train_cli.main(run + ["--num_rounds", "1", "--iters_per_round", "2",
                                    "--imgs_per_gpu", "4", "--pixels_per_image", "4",
                                    "--geo_init_steps", "3", "--save_freq", "1",
                                    "--eval_res", "8"])
    assert trainer.current_steps == 2 and all(np.isfinite(ld["total"]) for ld in trainer.losses)
    run_dir = scene / "logdir" / f"sf-{motion}"
    ckpt = bridge.load_flax_checkpoint(str(run_dir / "ckpt_latest.flax"))
    assert ckpt["current_steps"] == 2
    evals = [r for r in map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
             if "eval/psnr" in r]
    assert len(evals) == 1 and np.isfinite(evals[0]["eval/psnr"])

    app = run + ["--load_suffix", "latest"]
    rendered = render.main(app + ["--render_res", "8", "--freeze_id", "0", "--num_frames", "2"])
    assert all(v.shape[:3] == (2, 8, 8) and np.isfinite(v).all() for v in rendered.values())

    out = export.main(app + ["--grid_size", "16"])
    motion_json = json.load(open(os.path.join(out, "fg-motion.json")))
    skel = motion.startswith(("skel", "comp"))
    skinning = motion not in ("dense", "nvp")
    assert len(motion_json["field2cam"]) == 8
    assert len(motion_json["joint_so3"]) == (8 if skel else 0)
    assert len(motion_json["t_articulation"]) == (8 if skinning else 0)
    assert any(n.endswith("-bone.obj") for n in os.listdir(out)) == skinning

    frames = reanimate.main(app + ["--render_res", "8", "--motion_id", "0"])
    assert len(frames["rgb"]) == 8 and all(np.isfinite(v).all() for v in frames.values())
