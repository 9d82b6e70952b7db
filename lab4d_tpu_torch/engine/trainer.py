"""Round-based trainer: AdamW with a one-cycle schedule, skip-not-clip
of spiking steps with a two-round rollback, prior-fit initialization,
host-maintained geometry state per field (fg, bg, or both for comp), a
per-round eval render with its metrics, checkpoints in the JAX
trainer's layout (the AdamW moments in the layout of its optax state), and
`--load_path`: a checkpoint of either trainer loaded into the model
(merge_params: per-video tables of another video count are
mean-compressed), its Adam moments restored where every leaf matches, its
step count kept under --noreset_steps, and the skeleton's joint-angle
prior fit where the dataset metadata holds "joint_angles". Scalars and
the eval's image grids go to metrics.jsonl and, where tensorboardX
imports, to TensorBoard (make_logger). Port of lab4d_tpu/engine/trainer.py.

Over ranks (--ngpu N, one process per card; parallel/dist.py), every
rank's loader draws the same global batch of imgs_per_gpu x N pairs and
the rank trains on its block of it; the step's reductions are global, the
gradients are summed over the ranks before the skip-not-clip, so every
rank takes the update of the one-process step on the global batch. Rank
0 alone renders the eval, logs, refreshes the proxy geometry (broadcast
to the others) and writes files; the ranks' params and generators are
checked to agree at each round's end.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from lab4d_tpu_torch import bridge
from lab4d_tpu_torch.dataloader import data_utils
from lab4d_tpu_torch.engine import init_utils
from lab4d_tpu_torch.engine.model import LOSS_WEIGHT_NAMES, DVRModel
from lab4d_tpu_torch.engine.schedules import compute_sched
from lab4d_tpu_torch.meshlib import Mesh, load_obj, uv_sphere
from lab4d_tpu_torch.meshlib.marching import marching_cubes
from lab4d_tpu_torch.meshlib.sdf import MeshSDF
from lab4d_tpu_torch.nnutils.intrinsics import intrinsics_base_init
from lab4d_tpu_torch.nnutils.multifields import INIT_SCALE
from lab4d_tpu_torch.nnutils.pose import camera_base_quat_init
from lab4d_tpu_torch.parallel import dist
from lab4d_tpu_torch.render import render_batch
from lab4d_tpu_torch.utils import metrics
from lab4d_tpu_torch.utils.geom import get_near_far
from lab4d_tpu_torch.utils.quat import quaternion_translation_to_se3
from lab4d_tpu_torch.utils.vis import img2color, make_image_grid

EXPLICIT_PARAM_NAMES = (
    "logibeta", "logsigma", "logscale", "log_gauss", "base_quat",
    "base_logfocal", "base_ppoint", "shift",
)
GRAD_NORM_MAX = 5.0
# per-video tables that a checkpoint of another video count seeds with the
# mean of its rows (merge_params)
PER_VIDEO_TABLES = dist.PER_VIDEO_PARAM_TOKENS


def param_labels(model, freeze_bone_len: bool = False) -> Dict[str, str]:
    """Label each parameter by its JAX param-tree path: 'explicit' (10x
    learning rate), 'frozen' (bone lengths under --freeze_bone_len) or
    'base'."""
    labels = {}
    for name, _ in model.named_parameters():
        path, _ = bridge.torch_to_flax_path(name)
        if freeze_bone_len and "log_bone_len" in path:
            labels[name] = "frozen"
        elif path[-1] in EXPLICIT_PARAM_NAMES or (
            len(path) > 1 and path[-2] in EXPLICIT_PARAM_NAMES
        ):
            labels[name] = "explicit"
        else:
            labels[name] = "base"
    return labels


def onecycle_linear(step, total_steps, peak, pct_start, div_factor, final_div_factor) -> float:
    """Linear one-cycle schedule (torch OneCycleLR with anneal 'linear')."""
    warm = max(int(pct_start * total_steps), 1)
    init = peak / div_factor
    final = init / final_div_factor
    if step < warm:
        return init + (peak - init) * min(step, warm) / warm
    t = min(max((step - warm) / max(total_steps - warm, 1), 0.0), 1.0)
    return peak + (final - peak) * t


def clip_with_norm(params: List[torch.Tensor], max_norm: float = GRAD_NORM_MAX) -> torch.Tensor:
    """Skip, not clip: zero every gradient unless their global norm is
    strictly below max_norm (a non-finite norm skips too). The optimizer
    still steps on the zeros, so decay and momentum apply. Returns the
    norm (a device scalar; no host sync)."""
    grads = [p.grad for p in params]
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    ok = gnorm < max_norm
    zero = torch.zeros((), device=gnorm.device, dtype=grads[0].dtype)
    for g in grads:
        torch.where(ok, g, zero, out=g)  # where, not a multiply: nan * 0 would leak through
    return gnorm


def merge_params(state: Dict[str, torch.Tensor], loaded) -> Dict[str, torch.Tensor]:
    """The torch state dict `state` with the leaves of the flax param tree
    `loaded` that it also holds (a strict=False load). A per-video table
    (PER_VIDEO_TABLES) whose leading dimension differs, the video count,
    takes the mean of the loaded rows in every row: a category checkpoint
    seeds a new capture with its mean morphology. Other leaves of another
    shape, and leaves on one side only, are left as they are."""
    out = dict(state)
    for path, value in bridge._flatten(loaded):
        key, transpose = bridge.flax_to_torch_key(path)
        if key not in out:
            continue
        cur = out[key]
        v = np.asarray(value, np.float32)
        cur_flax = tuple(cur.shape[::-1]) if transpose else tuple(cur.shape)
        if v.shape == cur_flax:
            pass
        elif (v.ndim == len(cur_flax) and v.ndim >= 1 and v.shape[1:] == cur_flax[1:]
              and any(t in path for t in PER_VIDEO_TABLES)):
            v = np.broadcast_to(v.mean(0, keepdims=True), cur_flax)
        else:
            continue
        out[key] = torch.from_numpy(np.array(v.T if transpose else v)).to(cur)
    return out


class Trainer:
    """Train a model of the port on one device, or on one rank of a process
    group (parallel/dist.py) whose size is opts["ngpu"]."""

    # the source of the instance-code swap draws (trainer_init seeds one on
    # the device; None: torch's default generator)
    swap_generator = None
    # the learning rate of an update is the schedule at (step -
    # lr_step_offset): the optimizer's own update count, as the JAX
    # trainer's optax schedule reads it. A resumed run's Adam count may
    # differ from its step count (load_checkpoint_train).
    lr_step_offset = 0
    # whether --load_path restored the checkpoint's Adam state
    opt_restored = False
    # the skeleton's joint-angle prior fit: (final loss, updates), or None
    # where mlp_init ran none
    skel_fit = None
    # bytes of gradient summed over the ranks by the last step (0 on one rank)
    grad_bytes_reduced = 0

    def __init__(self, opts: Dict):
        is_resumed = bool(opts.get("load_path"))
        if opts.get("profile"):
            opts = dict(opts, iters_per_round=10)
        self.opts = opts
        self.device = torch.device(opts.get("device", "cuda"))
        self.define_dataset()
        self.trainer_init()
        self.define_model()
        self.optimizer_init(is_resumed=is_resumed)
        if is_resumed:
            self.load_checkpoint_train()
        self.sync_from_main()

    # ----------------------------------------------------------------- setup

    def define_dataset(self):
        """The datasets and the loader of the global batch: imgs_per_gpu x
        ngpu pairs, in ngpu blocks, one per rank; with --video_shards V,
        block j from the videos of group j % V, falling back to plain data
        parallelism (with a warning) where V does not divide both ngpu and
        the video count, as the JAX trainer does."""
        opts = self.opts
        self.datasets = data_utils.config_to_datasets(opts)
        self.eval_datasets = data_utils.config_to_datasets(opts, is_eval=True)
        self.data_info = data_utils.get_data_info(self.eval_datasets)
        num_shards = opts.get("ngpu", 1)
        if num_shards != dist.world_size():
            raise ValueError(f"--ngpu {num_shards} on a process group of {dist.world_size()} "
                             "ranks (train.py starts one rank per card)")
        num_vids = self.data_info["frame_info"].num_vids
        num_video = opts.get("video_shards", 1)
        if num_video > 1 and (num_shards % num_video or num_vids % num_video):
            print(f"[warn] video_shards={num_video} does not divide ngpu={num_shards} and "
                  f"num_vids={num_vids}; falling back to pure data parallelism", flush=True)
            num_video = 1
        self.num_video_shards = num_video
        self.num_data_shards = num_shards // num_video
        if num_shards > 1:  # every rank draws the same deltas and pixels
            self.datasets = [ds.with_draws(1 + i) for i, ds in enumerate(self.datasets)]
        self.trainloader = data_utils.TrainBatchLoader(
            self.datasets, imgs_per_batch=opts["imgs_per_gpu"] * num_shards,
            num_workers=opts.get("num_workers", 2), total_shards=num_shards,
            video_shards=num_video,
        )
        self.total_steps = opts["num_rounds"] * opts["iters_per_round"]

    def trainer_init(self):
        opts = self.opts
        self.save_dir = os.path.join(opts["logroot"], "%s-%s" % (opts["seqname"], opts["logname"]))
        if dist.is_main():
            os.makedirs(self.save_dir, exist_ok=True)
        self.log = make_logger(self.save_dir) if dist.is_main() else NullLogger()
        self.current_steps = 0
        self.current_round = 0
        self.swap_generator = torch.Generator(device=self.device).manual_seed(2)
        self.step_ms: List[float] = []
        self.grad_norms: List[float] = []
        self.losses: List[Dict[str, float]] = []
        total_eval = max(self.data_info["frame_info"].num_frames - 1, 1)
        self.eval_fid = np.linspace(0, total_eval - 1, 9).astype(int)

    def define_model(self):
        opts = self.opts
        info = self.data_info
        fi = info["frame_info"]
        self.categories = ("fg", "bg") if opts["field_type"] == "comp" else (opts["field_type"],)
        self.model = DVRModel(
            fi, field_type=opts["field_type"], fg_motion=opts["fg_motion"],
            num_inst=1 if opts["single_inst"] else fi.num_vids, device=self.device,
            generator=torch.Generator().manual_seed(0),
            intrinsics_init=info["intrinsics"], rtmat_fg=info["rtmat"][info["vis_info"]["fg"]],
            rtmat_bg=info["rtmat"][info["vis_info"]["bg"]], train_res=opts["train_res"],
            joint_angles_init=info.get("joint_angles"),
            loss_weights=tuple((k, opts[k]) for k in LOSS_WEIGHT_NAMES if k in opts),
        )
        self.proxy = {cate: self._init_proxy(cate) for cate in self.categories}
        self.geo_state = {}
        self.mlp_init()
        for cate in self.categories:
            self._reset_geo_state(cate, beta=0.0)
        # rollback caches, two rounds deep
        self.model_cache = [None, None]
        self.opt_cache = [None, None]

    def _init_proxy(self, cate: str):
        """Initial proxy mesh: the scaled TSDF mesh for bg and rigid fg, a
        small sphere for articulated fg."""
        if cate == "bg" or self.opts["fg_motion"] == "rigid":
            mesh = load_obj(self.data_info["geom_path"][self.data_info["vis_info"][cate]])
            return mesh.apply_scale(INIT_SCALE[cate])
        return uv_sphere(radius=0.12, count=[4, 4])

    def geo_for_batch(self):
        return {
            cate: {
                "aabb": torch.as_tensor(g["aabb"], device=self.device),
                "near_far_table": torch.as_tensor(g["near_far"], device=self.device),
                "proxy_corners": torch.as_tensor(g["corners"], device=self.device),
            }
            for cate, g in self.geo_state.items()
        }

    def _reset_geo_state(self, cate: str, beta: float = 0.0):
        """aabb from the proxy bounds; near-far from the proxy vertices and
        the cameras of all filtered frames; beta: EMA toward the previous."""
        mesh = self.proxy[cate]
        bounds = mesh.bounds
        if bounds is None:
            bounds = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
        prev = self.geo_state.get(cate)
        aabb = bounds.astype(np.float32)
        if prev is not None and beta > 0:
            aabb = prev["aabb"] * beta + aabb * (1 - beta)
        with torch.no_grad():
            quat, trans = self.model.fields.field_params[cate].camera_mlp.get_vals()
            rtmat = quaternion_translation_to_se3(quat, trans)
            verts = torch.as_tensor(np.asarray(mesh.vertices, np.float32), device=rtmat.device)
            near_far_frames = get_near_far(verts, rtmat).cpu().numpy()
        fi = self.data_info["frame_info"]
        near_far = (prev["near_far"].copy() if prev is not None
                    else np.tile(np.array([0.01, 10.0], np.float32), (fi.num_frames_raw, 1)))
        if prev is not None and beta > 0:
            near_far[fi.frame_mapping] = near_far[fi.frame_mapping] * beta + near_far_frames * (1 - beta)
        else:
            near_far[fi.frame_mapping] = near_far_frames
        self.geo_state[cate] = {
            "aabb": aabb.astype(np.float32),
            "near_far": near_far.astype(np.float32),
            "corners": mesh.corners().astype(np.float32),
        }

    # ------------------------------------------------------------- mlp init

    def mlp_init(self):
        """Initialize cameras, intrinsics and geometry from the priors."""
        info = self.data_info
        fi = info["frame_info"]
        model = self.model
        logfocal, ppoint = intrinsics_base_init(info["intrinsics"], fi)
        with torch.no_grad():
            model.intrinsics.base_logfocal.copy_(torch.as_tensor(logfocal))
            model.intrinsics.base_ppoint.copy_(torch.as_tensor(ppoint))
            for cate in self.categories:
                rtmat = np.array(info["rtmat"][info["vis_info"][cate]], dtype=np.float32)
                rtmat[..., :3, 3] *= INIT_SCALE[cate]
                model.fields.field_params[cate].camera_mlp.base_quat.copy_(
                    torch.as_tensor(camera_base_quat_init(rtmat, fi)))
        params = list(model.parameters())
        init_utils.fit_until_converged(model.fields.cam_prior_loss, params, tol=1e-4,
                                       log_name="camera")
        init_utils.fit_until_converged(model.intrinsics.compute_distance_to_prior, params,
                                       tol=1.0, log_name="intrinsics")
        if info.get("joint_angles") is not None and self.opts["fg_motion"].startswith(
                ("skel", "comp")):
            articulation = model.fields.field_params["fg"].warp.articulation
            self.skel_fit = init_utils.fit_until_converged(
                articulation.prior_fit_loss, params, tol=1e-4, log_name="skeleton")
        steps = self.opts.get("geo_init_steps", 500)
        self.geo_init_losses = init_utils.fit_geometry(
            model, self._build_geometry_pools(num_steps=steps), num_steps=steps)

    def _build_geometry_pools(self, num_steps=500, nsample=256):
        """Host-side sample pools for the SDF distillation: the proxy mesh's
        SDF for bg, the rest-pose bone spheres' (get_gauss_sdf) for the fg of
        the skeleton and composed warps, a sphere of radius 0.1 for the
        other fg warps (rigid, dense, nvp, bob)."""
        rng = np.random.default_rng(0)
        num_inst = self.model.num_inst
        pools = {}
        for cate in self.categories:
            mesh = self.proxy[cate]
            bounds = mesh.bounds
            size = bounds[1] - bounds[0]
            pts = rng.uniform(bounds[0] - size * 0.25, bounds[1] + size * 0.25,
                              size=(num_steps, nsample, 3)).astype(np.float32)
            if cate == "bg":
                sdf_gt = MeshSDF(mesh)(pts.reshape(-1, 3))
            elif not self.opts["fg_motion"].startswith(("skel", "comp")):
                sdf_gt = (np.linalg.norm(pts, axis=-1, keepdims=True) - 0.1).astype(np.float32)
            else:
                with torch.no_grad():
                    warp = self.model.fields.field_params[cate].warp
                    sdf_gt = warp.get_gauss_sdf(torch.as_tensor(pts.reshape(-1, 3),
                                                                device=self.device)).cpu().numpy()
            sdf_gt = sdf_gt.reshape(num_steps, nsample, 1)
            inst_id = rng.integers(0, num_inst, size=(num_steps, nsample))
            pools[cate] = {
                "pts": torch.as_tensor(pts, device=self.device),
                "sdf_gt": torch.as_tensor(sdf_gt, device=self.device),
                "inst_id": torch.as_tensor(inst_id, device=self.device),
            }
        return pools

    # ------------------------------------------------------------- optimizer

    def optimizer_init(self, is_resumed: bool = False):
        """AdamW (b1 0.9, b2 0.999, wd 1e-4) in two groups, the explicit
        parameters at 10x the learning rate, on a one-cycle schedule; the
        learning rate of update k (k from 0) is the schedule at k. A resumed
        run's schedule starts at its peak and decays to a fifth of it.
        Frozen parameters (--freeze_bone_len) are left out of the optimizer
        and count in the gradient norm, as in optax's chain."""
        opts = self.opts
        self.labels = param_labels(self.model, freeze_bone_len=opts.get("freeze_bone_len", False))
        named = dict(self.model.named_parameters())
        groups = []
        for label, scale in (("base", 1.0), ("explicit", 10.0)):
            ps = [p for n, p in named.items() if self.labels[n] == label]
            if ps:
                groups.append({"params": ps, "lr": 0.0, "lr_scale": scale, "label": label})
        self.params = [p for g in groups for p in g["params"]]
        self.param_names = [n for label in ("base", "explicit")
                            for n in named if self.labels[n] == label]
        self.frozen_params = [p for n, p in named.items() if self.labels[n] == "frozen"]
        self.optimizer = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=1e-4)
        if is_resumed:
            shape = dict(pct_start=0.0, div_factor=1.0, final_div_factor=5.0)
        else:
            shape = dict(pct_start=2.0 / opts["num_rounds"], div_factor=25.0,
                         final_div_factor=1.0)
        self.sched_kwargs = dict(total_steps=self.total_steps, peak=opts["learning_rate"],
                                 **shape)

    def learning_rate(self, step: int) -> float:
        return onecycle_linear(step, **self.sched_kwargs)

    def sync_from_main(self):
        """Over ranks: every rank takes rank 0's params, buffers, geometry
        state and proxy meshes (the prior fits on the card are not bitwise
        repeatable, and ranks that disagree would drift apart silently)."""
        if dist.world_size() == 1:
            return
        dist.broadcast_tensors_(list(self.model.state_dict().values()))
        self.geo_state, self.proxy = dist.broadcast_object((self.geo_state, self.proxy))

    def check_in_sync(self):
        """Over ranks: raise unless every rank holds the same params and the
        same state of the generator the step draws from."""
        if dist.world_size() == 1:
            return
        dist.check_in_sync({"params": dist.checksum(list(self.model.parameters())),
                            "generator": dist.rng_state_checksum(self.device)})

    def train_step(self, batch, step: int, draws=None):
        """One AdamW update on a device batch; returns (loss dict of device
        scalars with "total", grad norm). Over ranks, `batch` is this rank's
        block of the global batch, `draws` the global batch's draws, the
        loss terms returned are this rank's shares (summed over the ranks,
        the global batch's terms) and the norm is that of the gradient
        summed over the ranks."""
        with dist.sharded_batch():
            loss_dict = self.model(batch, compute_sched(step), draws=draws,
                                   generator=self.swap_generator)
        total = sum(loss_dict[k] for k in sorted(loss_dict))
        self.optimizer.zero_grad(set_to_none=True)
        frozen = self.frozen_params
        for p in frozen:
            p.grad = None
        total.backward()
        for p in self.params + frozen:
            if p.grad is None:  # untouched: a zero gradient, so weight decay still applies
                p.grad = torch.zeros_like(p)
        self.grad_bytes_reduced = dist.all_reduce_grads_(self.params + frozen)
        gnorm = clip_with_norm(self.params + frozen)
        lr = self.learning_rate(step - self.lr_step_offset)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.optimizer.step()
        loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        loss_dict["total"] = total.detach()
        return loss_dict, gnorm

    # ---------------------------------------------------------------- train

    def train(self):
        self.save_checkpoint(round_count=self.current_round)
        self.trainloader.start()
        try:
            for round_count in range(self.current_round,
                                     self.current_round + self.opts["num_rounds"]):
                start = time.time()
                self.run_one_round(round_count)
                print(f"Round {round_count:03d}: time={time.time() - start:.3f}s", flush=True)
        finally:
            self.trainloader.stop()
            self.log.flush()

    def run_one_round(self, round_count):
        times = {}

        def timed(name, fn):
            t0 = time.time()
            fn()
            times[name] = time.time() - t0

        if dist.is_main():
            try:
                timed("eval", self.model_eval)
            except Exception:  # a failed eval must not end the training run
                print("[warn] eval failed:\n" + traceback.format_exc(), flush=True)
        timed("geo", self.update_geometry_aux)
        if dist.is_main():
            timed("export", lambda: self.export_geometry_aux(
                "%s/%03d" % (self.save_dir, round_count)))
        timed("train", lambda: self.train_one_round(round_count))
        self.current_round += 1
        timed("ckpt", lambda: self.save_checkpoint(round_count=self.current_round))
        print("  " + " ".join(f"{k}={v:.1f}s" for k, v in times.items()), flush=True)

    def batch_to_device(self, batch_np):
        """A host batch on the device; over ranks, this rank's block of the
        global batch."""
        if dist.world_size() > 1:
            batch_np = dist.batch_block(batch_np, dist.rank(), dist.world_size())
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch_np.items()}

    def train_one_round(self, round_count):
        """iters_per_round updates. Grad norms and losses are read back
        every 10 steps in one transfer (over ranks, the losses summed over
        the ranks in one collective); a spike triggers the rollback then.
        On the card each step's time is kept (CUDA events) in step_ms. Over
        ranks the round starts with torch's generators seeded alike on every
        rank and ends with check_in_sync."""
        if dist.world_size() > 1:
            # every rank makes the round's draws from the same generator state,
            # whatever rank 0 alone drew before (eval, logging)
            torch.manual_seed(round_count + 1)
        geo = self.geo_for_batch()
        pending = []
        timing = self.device.type == "cuda"
        events = []

        def drain():
            if not pending:
                return
            norms = torch.stack([p[1] for p in pending]).tolist()
            keys = sorted(pending[0][2])
            terms = dist.all_reduce_sum_(torch.stack(
                [torch.stack([ld[k] for k in keys]) for _, _, ld in pending])).tolist()
            for (step, _, _), gn, values in zip(pending, norms, terms):
                self.grad_norms.append(gn)
                self.check_grad(gn)
                record = dict(zip(keys, values))
                self.losses.append(record)
                if step % 10 == 0:  # the JAX trainer's record: its loss dict, keys sorted
                    self.log.scalars(dict(sorted({**record, "grad_norm": gn}.items())), step)
            pending.clear()

        for _ in range(self.opts["iters_per_round"]):
            batch = self.batch_to_device(self.trainloader.next_batch())
            batch["geo"] = geo
            if timing:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            loss_dict, gnorm = self.train_step(batch, self.current_steps)
            if timing:
                end.record()
                events.append((start, end))
            pending.append((self.current_steps, gnorm, loss_dict))
            if len(pending) >= 10:
                drain()
            self.current_steps += 1
        drain()
        if timing:
            torch.cuda.synchronize(self.device)
            self.step_ms += [s.elapsed_time(e) for s, e in events]
        self.check_in_sync()

    def close(self):
        """Stop the loader threads and close the metrics log."""
        self.trainloader.stop()
        self.log.close()

    def check_grad(self, grad_norm: float, thresh: float = GRAD_NORM_MAX):
        """Loss-spike rollback: when a grad norm spikes or is non-finite,
        restore the model and optimizer from two rounds ago."""
        bad = grad_norm > thresh or not np.isfinite(grad_norm)
        if bad and self.model_cache[0] is not None:
            print(f"large grad: {grad_norm:.2f}, resume from cached weights", flush=True)
            self.model.load_state_dict(self.model_cache[0])
            self.optimizer.load_state_dict(copy.deepcopy(self.opt_cache[0]))

    # ----------------------------------------------------------------- eval

    def model_eval(self):
        """Render the eval frames; log their image grids and metrics (step:
        the round)."""
        rendered, ref = self.render_frames(self.eval_fid)
        self.log.images(rendered, self.current_round)
        self.log.scalars(self.compute_eval_metrics(rendered, ref), self.current_round)

    @staticmethod
    def compute_eval_metrics(rendered, ref):
        """eval/psnr (inside the reference mask), eval/ssim, eval/depth_err of
        (frames, res, res, C) renders against the references."""
        out = {}
        mask = ref.get("mask")
        mask = None if mask is None else mask[..., 0] > 0.5
        if "rgb" in rendered and "rgb" in ref:
            out["eval/psnr"] = metrics.psnr(rendered["rgb"], ref["rgb"], mask=mask)
            out["eval/ssim"] = float(np.mean([metrics.ssim(p, t)
                                              for p, t in zip(rendered["rgb"], ref["rgb"])]))
        if "depth" in rendered and "depth" in ref:
            out["eval/depth_err"] = metrics.depth_error(rendered["depth"], ref["depth"], mask=mask)
        return out

    def render_frames(self, fids):
        """Render the filtered frames `fids` at eval_res in the reference
        view, 8192 rays per evaluate_rays call. Returns ({channel: (frames,
        res, res, C)}, the frames' rgb, depth and mask resized to it)."""
        import cv2

        res = self.opts["eval_res"]
        pairs = [data_utils.load_eval_frame(self.eval_datasets, int(fid), self.data_info)
                 for fid in fids]
        crop2raw = np.stack([p["crop2raw"][0] for p in pairs]).astype(np.float32)
        crop2raw[:, :2] *= self.opts["train_res"] / res
        x, y = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
        hxy = np.stack([x.reshape(-1), y.reshape(-1), np.ones(res * res)], -1).astype(np.float32)
        batch = {
            "dataid": torch.as_tensor(np.array([p["dataid"][0] for p in pairs], np.int64)),
            "frameid_sub": torch.as_tensor(np.array([p["frameid_sub"][0] for p in pairs], np.int64)),
            "crop2raw": torch.as_tensor(crop2raw),
            "hxy": torch.as_tensor(np.tile(hxy[None], (len(pairs), 1, 1))),
        }
        batch = {k: v.to(self.device) for k, v in batch.items()}
        rendered = render_batch(self.model, batch, self.geo_state, chunk=min(res * res, 8192))
        refs = {}
        for k in ("rgb", "depth", "mask"):
            imgs = []
            for p in pairs:
                if k not in p:
                    break
                img = np.asarray(p[k][0], np.float32)
                if img.ndim == 2:  # flattened (N, C) full image
                    side = int(np.sqrt(img.shape[0]))
                    img = img.reshape(side, side, -1)
                if img.shape[0] != res:
                    interp = cv2.INTER_NEAREST if k == "mask" else cv2.INTER_LINEAR
                    img = cv2.resize(img, (res, res), interpolation=interp).reshape(res, res, -1)
                imgs.append(img)
            if imgs:
                refs[k] = np.stack(imgs)
        return rendered, refs

    # ------------------------------------------------------ geometry upkeep

    def update_geometry_aux(self):
        """Marching-cubes proxy refresh and aabb / near-far EMA; over ranks
        on rank 0, its results broadcast (marching cubes on the card is not
        bitwise repeatable)."""
        if dist.is_main():
            for cate in self.categories:
                mesh = self.extract_canonical_mesh(cate)
                if not mesh.is_empty:
                    self.proxy[cate] = mesh
                self._reset_geo_state(cate, beta=0.9)
        self.geo_state, self.proxy = dist.broadcast_object((self.geo_state, self.proxy))

    def extract_canonical_mesh(self, cate, grid_size=64, level=0.005, use_visibility=True,
                               use_extend_aabb=True):
        aabb = self.geo_state[cate]["aabb"]
        if use_extend_aabb:
            size = aabb[1] - aabb[0]
            aabb = np.stack([aabb[0] - 0.5 * size, aabb[1] + 0.5 * size])
        field = self.model.fields.field_params[cate]

        def sdf_fn(pts):
            with torch.no_grad():
                pts = torch.as_tensor(pts, device=self.device)
                return field.forward(pts, inst_id=None, get_density=False).cpu().numpy()

        def vis_fn(pts):
            with torch.no_grad():
                return (field.vis_mlp(torch.as_tensor(pts, device=self.device)) > 0).cpu().numpy()

        return marching_cubes(sdf_fn, aabb, visibility_func=vis_fn if use_visibility else None,
                              grid_size=grid_size, level=level,
                              apply_connected_component=(cate == "fg"))

    def export_geometry_aux(self, path):
        for cate in self.categories:
            self.proxy[cate].export(f"{path}-{cate}-proxy.obj")

    # ----------------------------------------------------------- checkpoint

    def opt_state_dict(self) -> Dict:
        """The AdamW state in the layout of the JAX trainer's optax state
        (bridge.opt_state_to_optax): zero moments and count for parameters
        no update has touched yet, and the last grad norm read back."""
        state = self.optimizer.state
        moments, count = {}, 0
        for name, p in zip(self.param_names, self.params):
            st = state.get(p, {})
            if "exp_avg" in st:
                moments[name] = (st["exp_avg"].detach().cpu().numpy(),
                                 st["exp_avg_sq"].detach().cpu().numpy())
                count = int(st["step"])
            else:
                zeros = np.zeros(tuple(p.shape), np.float32)
                moments[name] = (zeros, zeros)
        grad_norm = self.grad_norms[-1] if self.grad_norms else 0.0
        return bridge.opt_state_to_optax(moments, self.labels, count, grad_norm)

    def restore_opt_state(self, loaded) -> bool:
        """Restore the AdamW moments and update count of a checkpoint's
        opt_state (the optax layout, or the port's earlier manifest layout)
        when every leaf is there with the shape this model's state has;
        otherwise keep Adam fresh, as the JAX trainer does: a transfer to
        another architecture or video count starts Adam from zero."""
        if loaded is None:
            return False
        ok = True
        if loaded.get("layout") == bridge.PORT_LAYOUT:
            count, moments = bridge.opt_state_from_optax(loaded)
            ok = set(moments) == set(self.param_names)
            loaded = bridge.opt_state_to_optax(moments, self.labels, count) if ok else loaded
        want = bridge.opt_state_leaves(self.opt_state_dict())
        if not ok or bridge.opt_state_leaves(loaded) != want:
            print("[warn] optimizer state mismatch; Adam moments reset", flush=True)
            return False
        count, moments = bridge.opt_state_from_optax(loaded)
        for name, p in zip(self.param_names, self.params):
            m, v = moments[name]
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.from_numpy(np.array(m, np.float32)).to(p),
                "exp_avg_sq": torch.from_numpy(np.array(v, np.float32)).to(p),
            }
        self.lr_step_offset = self.current_steps - count
        return True

    def load_checkpoint_train(self):
        """--load_path: the checkpoint's params merged into the model
        (merge_params), its step and round kept under --noreset_steps, its
        Adam moments restored where they fit (restore_opt_state; else the
        schedule restarts with Adam), its proxy meshes taken and each
        field's geometry state reset from them."""
        ckpt = bridge.load_flax_checkpoint(self.opts["load_path"])
        self.model.load_state_dict(merge_params(self.model.state_dict(), ckpt["model"]))
        if not self.opts.get("reset_steps", True):
            self.current_steps = int(ckpt["current_steps"])
            self.current_round = int(ckpt["current_round"])
        self.lr_step_offset = self.current_steps
        self.opt_restored = self.restore_opt_state(ckpt.get("opt_state"))
        for cate, pm in ckpt.get("proxy", {}).items():
            if cate in self.categories:
                self.proxy[cate] = Mesh(np.asarray(pm["vertices"], np.float32),
                                        np.asarray(pm["faces"], np.int64))
        for cate in self.categories:
            self._reset_geo_state(cate, beta=0.0)

    def save_checkpoint(self, round_count):
        """Rotate the rollback caches; every save_freq rounds write
        ckpt_<round>.flax and ckpt_latest.flax: msgpack with the JAX
        trainer's "manifest", "model" (flax param tree), "opt_state" (the
        layout of its optax state), "geo_state" and "proxy"."""
        self.model_cache[0] = self.model_cache[1]
        self.opt_cache[0] = self.opt_cache[1]
        self.model_cache[1] = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self.opt_cache[1] = copy.deepcopy(self.optimizer.state_dict())
        if round_count % self.opts["save_freq"] != 0 or not dist.is_main():
            return
        path = "%s/ckpt_%04d.flax" % (self.save_dir, round_count)
        payload = {
            "manifest": {"format": 1, "current_steps": int(self.current_steps),
                         "current_round": int(self.current_round),
                         "opt_state_layout": bridge.OPTAX_LAYOUT},
            "model": bridge.params_to_flax(self.model.state_dict()),
            "opt_state": self.opt_state_dict(),
            "geo_state": {c: {k: np.asarray(v) for k, v in g.items()}
                          for c, g in self.geo_state.items()},
            "proxy": {c: {"vertices": np.asarray(m.vertices, np.float32),
                          "faces": np.asarray(m.faces, np.int32)}
                      for c, m in self.proxy.items()},
        }
        with open(path, "wb") as f:
            f.write(bridge.msgpack_dumps(payload))
        shutil.copy(path, "%s/ckpt_latest.flax" % self.save_dir)
        print(f"saved checkpoint round {round_count}", flush=True)


class NullLogger:
    """The logger of a rank other than 0: it writes nothing."""

    def scalars(self, d, step):
        pass

    def images(self, rendered, step):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class make_logger:
    """Scalar and image logger of a run directory: metrics.jsonl always,
    TensorBoard scalars and `img_<key>` image grids when tensorboardX
    imports (else JSONL only), as lab4d_tpu/engine/trainer.py's
    _make_logger. `tb` is the SummaryWriter or None."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        self.jsonl = open(os.path.join(save_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter

            self.tb = SummaryWriter(save_dir)
        except Exception:
            self.tb = None

    def scalars(self, d: Dict[str, float], step: int):
        self.jsonl.write(json.dumps({"step": step, **d}) + "\n")
        self.jsonl.flush()
        if self.tb:
            for k, v in d.items():
                self.tb.add_scalar(k, v, step)

    def images(self, rendered: Dict[str, np.ndarray], step: int):
        """Each (frames, H, W, C) channel of `rendered` as one colourized grid."""
        if not self.tb:
            return
        for k, v in rendered.items():
            try:
                img = img2color(k, make_image_grid(v))
                self.tb.add_image("img_" + k, img, step, dataformats="HWC")
            except Exception:  # a channel without a colour map is not logged
                pass

    def flush(self):
        self.jsonl.flush()
        if self.tb:
            self.tb.flush()

    def close(self):
        self.jsonl.close()
        if self.tb:
            self.tb.close()
