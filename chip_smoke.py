#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lab4d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each ending in a device
synchronise; any failure exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN;
2. build: compiles every CUDA kernel source in lab4d_tpu_torch/csrc/ and
   the K1 anatomy copies (one nvcc per source, all at once, sm_90a) into
   build/lab4d_tpu_torch/ and prints the compiler's report;
3. kernel: each kernel against its plain PyTorch version on the same
   inputs, at the shapes the render and training paths give it: K3f
   (fused_relu_mlp forward, with and without saving its hidden outputs)
   and K3b (its backward from K3f's saved outputs) at the TimeMLPs' render
   rows (1, 2, 7; 1 row also with the L2 cache flushed) and training rows
   (32, 256, 512) and a ragged 70,001 rows (K3f + K3b also against
   autograd outside the ReLU ties); K4f / K4b (fused_pe_mlp
   and its backward) at the bg field's base, colour and visibility MLPs
   on 262,144 points and at the 512 visibility-decay points (K4f with and
   without saving its hidden outputs, K4b from the saved ones; K4f + K4b
   also against autograd outside the ReLU ties), K1 / K2
   (fused_nerf_heads and its backward) at the flagship fg field's step
   (262,144 points, 1024 per pair, 256 appearance rows; K1 as training
   runs it, saving its layer outputs, and K2 from those; K1 + K2 also
   against autograd outside the ReLU ties), and K4f alone at export's
   canonical SDF grid (262,144 points of the fg base field, 10
   frequencies, widths 128 x 6, skip at 4, no saving), and K3f / K3b at
   the dense warps' shapes (262,144 rows of 167 inputs, skip at 4, no final
   ReLU: the dense map D6 W256 and the post-warp D2 W256; the dense map
   also at a ragged 262,143). K3 prints the engine each shape ran on (the
   cluster engine for the TimeMLPs' rows, the row engine from 1,024 rows:
   70,001 and the warps') and fails unless it is relu_mlp_plan's and a
   second call gives the same bits. Max error,
   tolerance, median device time from CUDA-graph replay for kernel and
   plain version, CUDA launches per call, and the bound (the larger of
   FLOPs over the fp32 peak and bytes over the memory rate; for K1 / K2
   and K4f / K4b also over the 3xTF32 tensor-core rate; K2's and K4b's
   work is dIn and dW from the saved layer outputs, and K4b's row also
   gives the bound of the VJP from x with the forward recomputed);
3b. heads-anatomy: one round of K1's anatomy copies
   (tools/profile_heads_phases.py, built beside the kernels): `full`
   against its plain version, the stripped copies timed;
4. model: the flagship fg / skel-quad DVRModel at full width (field heads
   D=5 W=128, TimeMLP backbones D=5 W=256, 25 bones) from a seeded
   generator, on a scene built in-process (one orbit video);
4b. streams: the port's copy of JAX's random streams
   (lab4d_tpu_torch/engine/jax_streams.py, utils/jax_random.py,
   utils/flax_rng.py), run on this host's numpy, against
   tests/data/jax_streams.npz, written from JAX: flax's scope keys, the
   flagship's first training step's draws and prior-fit eikonal rays, the
   first values of one leaf per initializer kind, a category swap; keys,
   ints and uniforms equal, the normal draws within 2 ulp; then the host
   ms of one flagship step's draws (4,096 rays) and of their one copy to
   the card;
5. reference: evaluate_rays on 256 rays on the GPU (through the kernel)
   against the same model on the CPU (plain versions); reference-topk: the
   same with the top-k eval at K = 8 on the rays whose K-th and (K+1)-th
   union weights are no near tie (at least 95%), the mask on all rays;
6. render: 2 frames at 512^2 through the render CLI's own functions
   (exact eval), with every kernel's launch count over exactly that run;
   render-topk: the same frames with the CLI's default top-k eval (K = 8),
   the mask against the exact frames' and the rgb PSNR; render-keys: one
   frame of --render_keys rgb,depth,mask against the full frame;
7. train-reference: one bg training step (128 rays of 64 samples) on the
   GPU (kernels) against the same weights, batch and random draws on the
   CPU (plain versions): every loss term and every gradient; reg_eikonal
   without the points where a ReLU input of its SDF chain lies on other
   sides of zero in the two steps (those inputs must agree within 1e-4,
   so only inputs within rounding of zero can flip; _eikonal_ties);
8. train: `lab4d_tpu_torch.train --field_type bg` at full width (128
   images x 2 frames x 16 pixels x 64 samples = 262,144 points per step,
   bg field D=5 W=128, TimeMLPs D=5 W=256) on a synthetic scene written by
   lab4d_tpu_torch.tools.synthetic_scene: prior fits, one round of 25
   steps, a checkpoint. Prints ms/step, peak memory, first and last total
   loss, grad norms and the launches of every kernel (K4f and K4b 4 each
   per step: base, colour, visibility, visibility decay);
9. train-reference-fg: as 7 for the flagship fg / skel-quad model, whose
   field heads run through K1 / K2 on the GPU: all 17 loss terms and
   every gradient;
10. train-fg: as 8 with `--field_type fg --fg_motion skel-quad` (field
   heads D=5 W=128, 25 bones) at full width, plus the round's eval render
   and its eval/psnr in metrics.jsonl, and the rows each TimeMLP backbone
   (K3f / K3b) is called with in the training steps;
11. export: export.py's functions at --grid_size 128 on the fg checkpoint
   of phase 10 and the bg one of phase 8 (the canonical SDF grid through
   K4f, the per-frame motion through K3f; mesh, json and times);
12. reanimate: reanimate.py's functions on the fg checkpoint with
   --motion_id 0 (phase 11's fg-motion.json), its frames at 128^2: the
   batch's articulations against get_vals(override_so3=...) on the CPU;
13. train-reference-comp: as 9 for the comp model (--field_type comp
   --fg_motion comp_skel-human_dense: the fg through K1 / K2, the bg
   through K4f / K4b, the TimeMLPs, the human skeleton's articulation, the
   dense post-warp and the soft-deformation points through K3f / K3b),
   every loss term (reg_soft_deform included) and every gradient, both
   fields' eikonal drawn at the same rays;
14. train-comp: as 10 for the comp model at full width (262,144 fg +
   262,144 bg points per step, composed into 128 samples per ray), 25
   steps: ms/step, peak memory, loss, and K3f's launches per step by
   shape (rows, inputs);
15. train-families: bob, skel-human, dense, nvp and comp_skel-quad_dense
   as the fg field at full width, 5 steps each after 20 geometry-init
   steps: finite losses, every kernel launched; the dense and comp paths
   must launch K3f at 262,144 rows of 167 inputs; the dense step's device
   time over 2 more steps (torch.profiler) and K3's share of it;
16. render-comp, export-comp, reanimate-comp: the comp checkpoint of 14
   rendered (2 frames at 512^2 exact and top-k, one bev-30 frame; both
   fields visible), exported (both categories at grid 128) and reanimated
   (motion 0, 32 frames at 128^2);
17. train-reference-category, train-category, render-category,
   export-category, reanimate-category, transfer, resume: the category
   model, its apps, and transfer / resume from its checkpoint;
18. config (before the training phases): the train CLI refuses
   `--imgs_per_gpu 0` at startup, before it writes anything; loader: the
   32-frame scene's batch (128 pairs x 16 px) through the native sampler
   (lab4d_tpu_torch/native) against its numpy reference and a second
   loader of the same seed, every key equal, ms per batch of both in
   turns; [train] / [train-fg] also print ms/step on batches drawn
   beforehand beside the figure with the loader, and which logs the run
   wrote (TensorBoard events need tensorboardX);
19. joint-prior (after train-fg): the flagship trainer with a seeded
   joint-angle prior (32 frames x 25 bones x 3) in its metadata runs
   mlp_init's skeleton fit on the card, the articulation TimeMLP through
   K3f / K3b at one row per frame, then on the CPU with every kernel
   plain: both converge to 1e-4, agree before the fit to 1e-4 and after
   it to 1e-2 relative, and take update counts within 10%;
20. psnr (last): tools/compare_psnr.py's rigid protocol at seed 0, 5
   rounds: the masked-PSNR trajectory beside lab4d_tpu's recorded one,
   the canonical mesh's Chamfer distance to the GT sphere, and every
   kernel's launches in the rigid steps;
22. ddp (after train-fg): the flagship step over ranks (parallel/dist.py)
   on train-fg's params and one global batch of 128 pairs x 16 px, 10
   steps per run in turns: one process, the sharded path at NCCL world
   size 1, two ranks sharing the card through gloo (64 pairs each), one
   process again; each held to tests/test_torch_ddp.py's bounds
   (tools/ddp_step.py compare), ms/step and the gradient bytes
   all-reduced per step;
21. k3-paths: every shape K3f launched in the phases above, and K3f /
   K3b against their plain versions at any the kernel phase did not
   check;
23. preprocess (after psnr): the port's preprocessing entry point
   (`python -m lab4d_tpu_torch.preprocess.run`'s main) on one synthetic
   raw video of 64 frames at 512^2 written in-process: every stage's
   backend (each must be the neural one: the shipped weights), seconds
   per stage and per frame, peak device memory, one batch of the port's
   loader from the output (no kernel of K1-K4 lies on this path: its
   nets and dense programs are plain PyTorch, as the JAX pipeline is XLA
   without Pallas); preprocess-reference: each of the five nets on 2
   frames, the LK flow, the filter bank and one TSDF integration at
   128^3 on the card against the port on the CPU, and the canonical
   rotation fit's stopping iterations and rotations, each with its
   tolerance; between the two, [preprocess] also runs the depth and
   segmentation stage CLIs (`python -m lab4d_tpu_torch.preprocess.scripts.depth
   smokevid-0000`, and `segmentation`) as subprocesses on a copy of
   [preprocess]'s frames, their Depth/ and Annotations/ frames against
   the pipeline's within [preprocess-reference]'s bound, and each CLI's
   seconds;
24. train-nets (after preprocess-reference): the five preprocessing-net
   trainers (lab4d_tpu_torch/scripts/train_*.py) at their default
   resolution and batch, NET_STEPS steps each, the weights into the run's
   temporary directory: pool seconds, ms/step (CUDA events), peak device
   memory, first and last logged loss, the held-out line; the written
   file must load; no trainer may write database/weights/ (checked over
   phases 24-27); no K1-K4 on this path (plain convs, as flax's);
25. train-nets-reference: each trainer from one init on one batch, 3
   updates on the card and on the CPU: the step-0 loss, the step-0
   gradients and the parameters after the updates (the sign-flip bound);
26. adversarial: scripts/validate_adversarial.py at ADV_ARGS (the
   skel-quad train CLI in this process on tools/synthetic_adversarial.py's
   scene): its JSON and every kernel's launches, each of which must run;
27. tools: render_intermediate on [train-fg]'s proxy meshes,
   create_collage on [render]'s frames, run_rendering_parallel (devlist
   0,0,0,0: four workers on the card) on the category run, run_crop_all on [preprocess]'s output, the
   browser's index and one mesh png; each must write its files.

The line before the last is the card's name and power limit, the one
before it a JSON summary of every kernel; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and
prints no result.
"""

import collections
import contextlib
import copy
import glob
import importlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

RES = 512
N_FRAMES = 2
SEED = 0

KERNEL_TOL = 1e-4  # fp32 FMA vs cuBLAS fp32: summation order only; on the
# forward's max abs error, and on the backward's max rel error (_rel_err),
# since the weight gradients sum over the rows
PEAK_FP32 = 67e12  # FLOP/s, H100 SXM outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # B/s, H100 SXM HBM3 (NVIDIA data sheet)
PEAK_TF32 = 495e12  # FLOP/s, H100 SXM dense TF32 tensor cores (NVIDIA data sheet); 3xTF32 takes 3 products
TRAIN_STEPS = 25
PREDRAWN_STEPS = 10  # [train], [train-fg]: steps on batches drawn beforehand
FG_PAIRS, FG_SPP = 256, 1024  # the flagship step: 128 images x 2 frames; 16 px x 64 samples
# one training step, GPU (kernels) vs CPU (plain versions), fp32: loss terms
# relative; gradients per parameter, max|d| <= abs + rel * max|g_cpu|
TRAIN_REF_TOL = {"loss_rtol": 1e-4, "grad_abs": 1e-5, "grad_rel": 1e-3, "tie_z": 1e-4}
# tie_z: the ReLU inputs of the eikonal term's SDF chain agree within it
# (max|d| / max(1, max|z|)); a ReLU input that lies on other sides of zero
# in the two steps is a tie, and the eikonal term is compared without the
# points that hold one (_eikonal_ties)
REF_TOL = {  # GPU (kernel) vs CPU (plain versions), fp32
    "rgb": ("abs", 1e-4), "mask": ("abs", 1e-4), "vis": ("abs", 1e-4),
    "feature": ("abs", 1e-4), "depth": ("rel", 1e-4), "normal": ("abs", 1e-3),
}
# (label, rows, C_in, hidden layers D, width W) of the TimeMLP backbones
# (final ReLU): the render path's queries and the training step's frames
# (the [train-fg] phase prints the rows every TimeMLP is called with, and
# phase_k3_paths checks any shape K3f launched that these miss)
K3_SHAPES = [
    ("camera/intrinsics D5 W256", 1, 256, 5, 256),
    ("articulation t+rest D5 W256", 2, 256, 5, 256),
    ("7 frames D5 W256", 7, 256, 5, 256),
    ("appearance D2 W64", 1, 64, 2, 64),
]
# the training path: camera / intrinsics TimeMLPs on the 256 frames of a
# batch; the fg step also runs the appearance TimeMLP on them, the
# articulation on 512 rows and the camera on the scene's 32 frames
K3_TRAIN = ("camera/intrinsics train D5 W256", 256, 256, 5, 256)
K3_TRAIN_SHAPES = [K3_TRAIN, ("appearance train D2 W64", 256, 64, 2, 64),
                   ("articulation train D5 W256", 512, 256, 5, 256),
                   ("camera, all 32 frames D5 W256", 32, 256, 5, 256)]
# the category step (8 videos of 16 frames): the camera TimeMLP's prior term
# over all 128 filtered frames
K3_CATEGORY_SHAPES = [("camera, all 128 frames of 8 videos D5 W256", 128, 256, 5, 256)]
# checked at a ragged count of many rows
K3_RAGGED = ("ragged D5 W256", 70001, 256, 5, 256)
# (label, rows, C_in, widths, skips, final_act) of the dense warps' CondMLPs
# at a full-width step's samples: PE(xyz) F6 + the 128-wide time code = 167
# inputs, the instance code folded into the biases, 3 outputs without a
# final ReLU. The dense warp's forward / backward maps are D6 W256 with the
# skip at layer 4, the composed warp's post-warp D2 W256 (its skip at 4
# lies past its layers)
K3_WARP_SHAPES = [
    ("dense map D6 W256", 262144, 167, (256,) * 6 + (3,), (4,), False),
    ("post-warp D2 W256", 262144, 167, (256,) * 2 + (3,), (), False),
    ("dense map D6 W256, ragged", 262143, 167, (256,) * 6 + (3,), (4,), False),
]
# the TimeMLP shapes tools/profile_k4b_phases.py profiles K3f / K3b at (with
# the warps' shapes of 262,144 rows)
K3_PROFILE = [("render D5 W256", 1, 256, 5, 256), K3_TRAIN, K3_TRAIN_SHAPES[1], K3_TRAIN_SHAPES[2]]
# (label, rows, n_freqs, widths, skips, final_act, window) of the bg field
K4_SHAPES = [
    ("base F6 D5 W128", 262144, 6, (128,) * 6, (4,), True, True),
    ("colour F8 D2 W128", 262144, 8, (128,) * 3, (), True, True),
    ("vis F10 D2 W64", 262144, 10, (64, 64, 1), (), False, False),
    ("vis-decay F10 D2 W64", 512, 10, (64, 64, 1), (), False, False),
]
# the category step's K4 calls: the fg base field at the mean instance code
# on the gauss-skin term's 2,048 points, and the canonical feature field
# (F6 D5 W128, 16 outputs, no window) at the step's 262,144 samples, which
# the fused heads (K1) carry in a single-instance step
K4_CATEGORY_SHAPES = [
    ("gauss-skin fg base F10 D5 W128", 2048, 10, (128,) * 6, (4,), True, True),
    ("feature F6 D5 W128", 262144, 6, (128,) * 5 + (16,), (4,), False, False),
]
# the fg base field of export's canonical SDF grid: one marching-cubes chunk
# of 64^3 points, instance code folded into the biases, no window, no saving
K4_EXPORT = ("export fg base F10 D5 W128", 262144, 10, (128,) * 6, (4,), True, False)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def sync():
    import torch

    torch.cuda.synchronize()


def phase_env():
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    """Every kernel source, and the K1 anatomy copies of
    tools/profile_heads_phases.py, one nvcc each, all started at once;
    returns the anatomy copies' libraries."""
    from lab4d_tpu_torch.ops import field_kernel as FK
    from lab4d_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR, KERNELS, build_all, build_log, load_library
    from lab4d_tpu_torch.tools import profile_heads_phases as PH

    t = time.time()
    anatomy_dir = str(BUILD_DIR / "heads_phases" / "smoke")
    procs = PH.start_copies(CSRC_DIR, PH.MMA_K1, anatomy_dir)
    build_all()
    for name in KERNELS:
        load_library(name)
    anatomy = PH.finish_copies(procs, anatomy_dir)
    for lib in anatomy.values():
        FK.bind_signatures(lib)
    print(f"[build] {', '.join(n + '.cu' for n in KERNELS)} and {len(anatomy)} anatomy copies of "
          f"nerf_heads.cu -> sm_90a in {time.time() - t:.1f} s")
    for name in KERNELS:
        for line in build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")
    return anatomy


def _mlp_params(C_in, D, W, gen, device, widths=None, skips=()):
    """torch.nn.Linear-style weights: D hidden layers of W (or `widths`)."""
    import torch

    widths = widths or [W] * (D + 1)
    weights, biases, prev = [], [], C_in
    for i, w in enumerate(widths):
        fan_in = prev + (C_in if i in skips else 0)
        bound = 1.0 / np.sqrt(fan_in)
        weights.append((torch.rand(w, fan_in, generator=gen) * 2 - 1).mul_(bound).to(device))
        biases.append((torch.rand(w, generator=gen) * 2 - 1).mul_(bound).to(device))
        prev = w
    return weights, biases


def _timed(run, reps=7):
    """Median over reps of one call of run() between two CUDA events, ms."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def eager_ms(fn, inner=100):
    """Per-call time of back-to-back eager calls between CUDA events, host
    launch work included, ms."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(inner):
            fn()

    return _timed(run) / inner


def device_ms(fn, inner=100):
    """Per-call device time, ms: `inner` calls captured into one CUDA graph
    and replayed, so no host launch gap sits between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    ms = _timed(graph.replay) / inner
    del graph
    torch.cuda.empty_cache()
    return ms


def mlp_macs(in_dims, out_dims):
    return sum(i * o for i, o in zip(in_dims, out_dims))


def bound_ms(flops, nbytes, peak=PEAK_FP32):
    """The least time the card could take: the larger of FLOPs over the
    peak (by default the fp32 non-tensor one) and bytes over the memory
    rate, ms; and which."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bwd_errs(got, want):
    """(max abs error, max rel error) of a backward's (dx, dWs, dbs) over
    every array; the rel error of an array is max|got - want| over
    max(1, max|want|), for sums over rows."""
    pairs = list(zip([got[0]] + got[1] + got[2], [want[0]] + want[1] + want[2]))
    diffs = [float((a - b).abs().max()) for a, b in pairs]
    rels = [d / max(1.0, float(b.abs().max())) for d, (_, b) in zip(diffs, pairs)]
    return max(diffs), max(rels)


def phase_kernel():
    import torch

    from lab4d_tpu_torch.ops import mlp_kernel as K

    gen = torch.Generator().manual_seed(SEED)
    results = {"K3f": [], "K3b": [], "K4f": [], "K4b": []}

    def report(name, label, rows, err, kernel, plain, flops, nbytes, inner, rel_err=None,
               extra=None):
        # K4b's plain backward runs autograd (dx through sin / cos), which a
        # CUDA graph does not capture reliably: it is timed as back-to-back
        # eager calls
        backward = name == "K4b"
        r = {"label": label, "rows": rows, "max_abs_err": err, "ms": device_ms(kernel, inner),
             "plain_ms": eager_ms(plain, inner) if backward else device_ms(plain, inner)}
        if rel_err is not None:
            r["max_rel_err"] = rel_err
        r["bound_ms"], r["bound_by"] = bound_ms(flops, nbytes)
        r.update(extra or {})
        sync()
        checked = f"err={err:.3e} (tol {KERNEL_TOL:g})" if rel_err is None else \
            f"abs err={err:.3e} rel err={rel_err:.3e} (tol {KERNEL_TOL:g})"
        print(f"[kernel] {name} {label}: rows={rows} {checked} "
              f"device kernel {r['ms'] * 1e3:.2f} us / plain {r['plain_ms'] * 1e3:.2f} us"
              f"{' (eager)' if backward else ''} / bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']}, fp32 FMA)"
              + "".join(f" / {k} {r[k] * 1e3:.2f} us" for k in (
                  "bound_3xtf32_ms", "bound_vjp_from_x_ms", "bound_vjp_from_x_3xtf32_ms",
                  "ms_no_save", "plain_ms_no_save", "ms_cold_l2", "plain_ms_cold_l2") if k in r)
              + (f" ({r['engine']})" if "engine" in r else "")
              + (f"; tiles of {r['tile_rows']} points" if "tile_rows" in r else "")
              + (f"; {r['cuda_launches_per_call']} CUDA launches per call"
                 if "cuda_launches_per_call" in r else ""))
        results[name].append(r)

    for label, rows, C, D, W in K3_SHAPES + K3_TRAIN_SHAPES + K3_CATEGORY_SHAPES + [K3_RAGGED]:
        _k3_kernels(K, gen, label, rows, C, [W] * (D + 1), report)
    for label, rows, C, widths, skips, final_act in K3_WARP_SHAPES:
        _k3_kernels(K, gen, label, rows, C, widths, report, skips, final_act)

    for shape in K4_SHAPES + K4_CATEGORY_SHAPES:
        _pe_kernels(K, gen, shape, report)
    _pe_forward_kernel(K, gen, K4_EXPORT, report)
    results.update(_heads_kernels(gen))
    return results


def _pe_relu_ties(K, args, acts):
    """The (row, unit) pairs where K4f's saved hidden output and the plain
    forward's input to that ReLU lie on opposite sides of zero, so that the
    two backward passes take other sides of the kink: (rows holding one,
    number of pairs, largest |input| among them). args: fused_pe_mlp's."""
    _, z = K.pe_mlp_forward_saved_reference(*args, pre_activations=True)
    return _mlp_relu_ties(K, args[2], args[0].shape[0], acts, z)


def _mlp_relu_ties(K, weights, P, acts, z):
    """_pe_relu_ties from the saved outputs acts and the plain forward's
    ReLU inputs z, both in pe_act_layout (K3f's and K4f's)."""
    import torch

    rows = torch.zeros(P, dtype=torch.bool, device=acts.device)
    n, z_max = 0, 0.0
    for off, w in zip(K.pe_act_layout(weights)[0], [w.shape[0] for w in weights[:-1]]):
        a, zz = (t[off * P: (off + w) * P].view(P, w) for t in (acts, z))
        flip = (a > 0) != (zz > 0)
        rows |= flip.any(1)
        n += int(flip.sum())
        z_max = max(z_max, float(zz.abs().masked_fill(~flip, 0).max()))
    return rows, n, z_max


K3_FLUSH_BYTES = 200 * 2**20  # written between timed calls: four times the H100's 50 MB L2
K3_SLEEP_CYCLES = 10_000_000  # the card's sleep before each timed call: ~5 ms at 1.98 GHz


def cold_ms(fn, reps=20):
    """Median device time of one call of fn with the L2 cache flushed
    before it (K3f at render rows: the field's work evicts the TimeMLP
    weights between calls), CUDA events around each call, ms. After the
    flush the card sleeps (torch.cuda._sleep) while the host queues the
    start event, fn's launches and the end event, so that the window
    between the events holds fn's device work and none of its host work;
    it fails if the host took longer than the sleep."""
    import torch

    junk = torch.empty(K3_FLUSH_BYTES // 4, device="cuda")
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(K3_SLEEP_CYCLES)
    end.record()
    end.synchronize()
    sleep_ms = start.elapsed_time(end)
    times, host = [], []
    for _ in range(reps):
        junk.fill_(1.0)
        torch.cuda._sleep(K3_SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        times.append(start.elapsed_time(end))
    del junk
    if not max(host) < sleep_ms:
        fail(f"cold_ms: the host took {max(host):.3f} ms to queue a call, longer than the "
             f"card's {sleep_ms:.3f} ms sleep before it")
    return float(np.median(times))


def _k3_kernels(K, gen, label, rows, C, widths, report=None, skips=(), final_act=True):
    """K3f and K3b at one MLP shape (by default with a final ReLU and no
    skip, as the TimeMLP backbones run; the dense warps' maps take a skip
    and no final ReLU) against their plain versions: K3f's output with and
    without saving and its saved hidden outputs against
    mlp_forward_saved_reference; K3b
    from K3f's own saved outputs against mlp_backward_saved_reference on the
    same ones; K3f + K3b against autograd through a recomputed plain
    forward outside the ReLU ties (_mlp_relu_ties: every flipped input
    within 10x K3f's saved error of zero); a second call of each must give
    the same bits, and both must run on relu_mlp_plan's engine (the cluster
    engine for few rows, the row engine for many). Then, given report, both timed
    with their bounds: fp32 FMA and
    3xTF32, K3b's from the saved outputs; K3f also without saving, against
    mlp_reference (a render saves nothing). At 1 row K3f and mlp_reference
    are also timed with the L2 cache flushed."""
    import torch

    W = widths[-1]
    skips = tuple(skips)
    weights, biases = _mlp_params(C, 0, 0, gen, "cuda", widths=list(widths), skips=skips)
    x = torch.randn(rows, C, generator=gen).cuda()
    args = (x, weights, biases, skips, final_act)
    got, acts = K.mlp_forward_saved(*args)
    launches_f, engine_f = K.fused_relu_mlp.cuda_launches, K.fused_relu_mlp.engine
    got_ns = K.fused_relu_mlp(*args)  # nothing requires a gradient: K3f without saving
    want, want_acts = K.mlp_forward_saved_reference(*args)
    sync()
    err = max(float((got - want).abs().max()), float((got_ns - want).abs().max()))
    err_saved = float((acts - want_acts).abs().max())
    if not got.is_cuda or got.shape != want.shape or not max(err, err_saved) <= KERNEL_TOL:
        fail(f"K3f {label} disagrees with its plain version: output {err}, saved outputs "
             f"{err_saved} > {KERNEL_TOL}")
    g = torch.randn(rows, W, generator=gen).cuda()
    if final_act:
        g = g * (got > 0)  # the final ReLU's mask, as the caller applies it
    bwd_args = (x, g, weights, biases, skips)
    got_b = K.fused_relu_mlp_backward(*bwd_args, saved=acts)
    launches_b, engine_b = K.fused_relu_mlp_backward.cuda_launches, K.fused_relu_mlp_backward.engine
    want_b = K.mlp_backward_saved_reference(*bwd_args, acts)
    sync()
    abs_err, rel_err = _bwd_errs(got_b, want_b)
    if not rel_err <= KERNEL_TOL:
        fail(f"K3b {label} disagrees with its plain version: rel err {rel_err} > {KERNEL_TOL}")
    again, acts_again = K.mlp_forward_saved(*args)
    again_b = K.fused_relu_mlp_backward(*bwd_args, saved=acts)
    sync()
    if not (torch.equal(again, got) and torch.equal(acts_again, acts) and all(
            torch.equal(a, b) for a, b in zip([got_b[0], *got_b[1], *got_b[2]],
                                              [again_b[0], *again_b[1], *again_b[2]]))):
        fail(f"K3f / K3b {label}: a second call differs from the first")
    del again, acts_again, again_b
    _, z = K.mlp_forward_saved_reference(*args, pre_activations=True)
    tie_rows, n_ties, z_tie = _mlp_relu_ties(K, weights, rows, acts, z)
    _, rel_auto = _bwd_errs(got_b, K.mlp_backward_reference(*bwd_args))
    g_kept = g * (~tie_rows).to(g.dtype)[:, None]
    _, rel_kept = _bwd_errs(K.fused_relu_mlp_backward(x, g_kept, *bwd_args[2:], saved=acts),
                            K.mlp_backward_reference(x, g_kept, *bwd_args[2:]))
    sync()
    print(f"[kernel] K3f + K3b {label} ({engine_f} engine; a second call bitwise equal) "
          f"against autograd through the plain forward: all rows "
          f"{rel_auto:.1e}; ReLU ties: {n_ties} (row, unit) pairs in {int(tie_rows.sum())} of "
          f"{rows} rows, largest |input| {z_tie:.2e} (tol {10 * err_saved:.2e}, 10x K3f's saved "
          f"error); the other rows {rel_kept:.1e} (tol {KERNEL_TOL:g})")
    if not z_tie <= 10 * err_saved:
        fail(f"K3f {label}: a ReLU input of {z_tie} flips between K3f and the plain forward")
    if not rel_kept <= KERNEL_TOL:
        fail(f"K3f + K3b {label} disagree with autograd outside the ReLU ties: {rel_kept}")
    in_dims = [C] + [w + (C if i + 1 in skips else 0) for i, w in enumerate(widths[:-1])]
    want_engine = K.relu_mlp_plan(C, in_dims, list(widths), rows).engine
    if (engine_f, engine_b) != (want_engine, want_engine):
        fail(f"K3f / K3b {label} ran on the {engine_f} / {engine_b} engine, the plan's is "
             f"{want_engine}")

    if report is None:
        return
    out_dims = list(widths)
    macs = mlp_macs(in_dims, out_dims)
    n_params = macs + sum(out_dims)
    saved_bytes = 4 * rows * sum(widths[:-1])
    flops_f = 2 * rows * macs
    nbytes_f = 4 * (rows * (C + W) + n_params) + saved_bytes
    flops_b = 4 * rows * macs  # dIn and dW of every layer from the saved outputs
    nbytes_b = 4 * (2 * rows * C + rows * W + 2 * n_params) + saved_bytes
    plan = K.relu_mlp_plan(C, in_dims, out_dims, rows)
    engine = ("row engine, wgmma 3xTF32" if plan.engine == "rows" else
              "cluster engine, " + ("fp32 FMA" if plan.fwd_fma else "mma.sync 3xTF32"))
    inner = 3 if rows > 4096 else 100
    main = (label, rows) == K3_TRAIN[:2]
    extra_f = {"ms_no_save": device_ms(lambda: K.fused_relu_mlp(*args), inner),
               "plain_ms_no_save": device_ms(lambda: K.mlp_reference(*args), inner),
               "bound_3xtf32_ms": bound_ms(3 * flops_f, nbytes_f, PEAK_TF32)[0],
               "cuda_launches_per_call": launches_f, "engine": engine, "main": main}
    if rows == 1:
        extra_f["ms_cold_l2"] = cold_ms(lambda: K.fused_relu_mlp(*args))
        extra_f["plain_ms_cold_l2"] = cold_ms(lambda: K.mlp_reference(*args))
    report("K3f", label, rows, max(err, err_saved), lambda: K.mlp_forward_saved(*args),
           lambda: K.mlp_forward_saved_reference(*args), flops_f, nbytes_f, inner, extra=extra_f)
    report("K3b", label, rows, abs_err, lambda: K.fused_relu_mlp_backward(*bwd_args, saved=acts),
           lambda: K.mlp_backward_saved_reference(*bwd_args, acts), flops_b, nbytes_b,
           inner, rel_err=rel_err, extra={
               "bound_3xtf32_ms": bound_ms(3 * flops_b, nbytes_b, PEAK_TF32)[0],
               "engine": "row engine, wgmma 3xTF32" if plan.engine == "rows" else
               "cluster engine, mma.sync 3xTF32",
               "cuda_launches_per_call": launches_b, "relu_tie_pairs": n_ties,
               "relu_tie_rows": int(tie_rows.sum()), "max_rel_err_autograd_all_rows": rel_auto,
               "max_rel_err_autograd_untied_rows": rel_kept, "main": main})


def _pe_kernels(K, gen, shape, report):
    """K4f and K4b at one of K4_SHAPES against their plain versions: K4f's
    output with and without saving and its saved hidden outputs against
    pe_mlp_forward_saved_reference; K4b from K4f's own saved outputs
    against pe_mlp_backward_saved_reference on the same ones; and K4f + K4b
    against autograd through a recomputed plain forward, which differs
    where a hidden ReLU input lies within rounding of zero (_pe_relu_ties):
    every such input must lie within 10x K4f's saved-output error of zero,
    and with the cotangents of the rows that hold one set to zero, every
    gradient must agree within KERNEL_TOL. Then both timed."""
    import torch

    label, rows, n_freqs, widths, skips, final_act, window = shape
    freqs = tuple(float(2.0**i) for i in range(n_freqs))
    c_x = 3 * (2 * n_freqs + 1)
    weights, biases = _mlp_params(c_x, 0, 0, gen, "cuda", widths=list(widths), skips=skips)
    x = ((torch.rand(rows, 3, generator=gen) * 2 - 1) * 0.5).cuda()
    win = torch.linspace(0.3, 1.0, n_freqs).cuda() if window else None
    args = (x, win, weights, biases, freqs, skips, final_act)
    got, acts = K.pe_mlp_forward_saved(*args)
    launches_f = K.fused_pe_mlp.cuda_launches
    got_ns = K.fused_pe_mlp(*args)  # nothing requires a gradient: K4f without saving
    want, want_acts = K.pe_mlp_forward_saved_reference(*args)
    sync()
    err = max(float((got - want).abs().max()), float((got_ns - want).abs().max()))
    err_saved = float((acts - want_acts).abs().max())
    if not got.is_cuda or got.shape != want.shape or not max(err, err_saved) <= KERNEL_TOL:
        fail(f"K4f {label} disagrees with its plain version: output {err}, saved outputs "
             f"{err_saved} > {KERNEL_TOL}")
    g = torch.randn(rows, widths[-1], generator=gen).cuda()
    bwd_args = (x, g, win, weights, biases, freqs, skips)
    got_b = K.fused_pe_mlp_backward(*bwd_args, saved=acts)
    launches_b = K.fused_pe_mlp_backward.cuda_launches
    want_b = K.pe_mlp_backward_saved_reference(*bwd_args, acts)
    sync()
    abs_err, rel_err = _bwd_errs(got_b, want_b)
    if not rel_err <= KERNEL_TOL:
        fail(f"K4b {label} disagrees with its plain version: rel err {rel_err} > {KERNEL_TOL}")
    tie_rows, n_ties, z_tie = _pe_relu_ties(K, args, acts)
    _, rel_auto = _bwd_errs(got_b, K.pe_mlp_backward_reference(*bwd_args))
    g_kept = g * (~tie_rows).to(g.dtype)[:, None]
    _, rel_kept = _bwd_errs(K.fused_pe_mlp_backward(x, g_kept, *bwd_args[2:], saved=acts),
                            K.pe_mlp_backward_reference(x, g_kept, *bwd_args[2:]))
    sync()
    print(f"[kernel] K4f + K4b {label} against autograd through the plain forward: all rows "
          f"{rel_auto:.1e}; ReLU ties (K4f's saved output and the plain input on other sides of "
          f"zero): {n_ties} (row, unit) pairs in {int(tie_rows.sum())} of {rows} rows, largest "
          f"|input| {z_tie:.2e} (tol {10 * err_saved:.2e}, 10x K4f's saved error {err_saved:.2e}); "
          f"the other rows {rel_kept:.1e} (tol {KERNEL_TOL:g})")
    if not z_tie <= 10 * err_saved:
        fail(f"K4f {label}: a ReLU input of {z_tie} flips between K4f and the plain forward")
    if not rel_kept <= KERNEL_TOL:
        fail(f"K4f + K4b {label} disagree with autograd outside the ReLU ties: {rel_kept}")

    in_dims = [w.shape[1] for w in weights]
    macs = mlp_macs(in_dims, widths)
    n_params = macs + sum(widths)
    saved_bytes = 4 * rows * sum(widths[:-1])
    inner = 5 if rows > 4096 else 100
    flops_f = 2 * rows * macs
    nbytes_f = 4 * (rows * (3 + widths[-1]) + n_params) + saved_bytes
    main = label == K4_SHAPES[0][0]  # the bg step's base MLP, the K4 rows' shape in PERF.md
    report("K4f", label, rows, max(err, err_saved),
           lambda: K.pe_mlp_forward_saved(*args), lambda: K.pe_mlp_forward_saved_reference(*args),
           flops_f, nbytes_f, inner, extra={
               "ms_no_save": device_ms(lambda: K.fused_pe_mlp(*args), inner),
               "bound_3xtf32_ms": bound_ms(3 * flops_f, nbytes_f, PEAK_TF32)[0],
               "cuda_launches_per_call": launches_f, "saved_floats_per_point": sum(widths[:-1]),
               "tile_rows": _pe_tile_rows(K, rows, n_freqs, weights, skips), "main": main})
    # K4b's work: dIn and dW of every layer from x, g and K4f's saved
    # outputs, which it reads once; beside it, the VJP from x and g alone,
    # which also recomputes the hidden layers (the row-tiled design's work)
    flops_b = 4 * rows * macs
    nbytes_vjp = 4 * (2 * rows * 3 + 2 * rows * widths[-1] + 2 * n_params)
    nbytes_b = nbytes_vjp + saved_bytes
    flops_vjp = 2 * rows * (mlp_macs(in_dims[:-1], widths[:-1]) + 2 * macs)
    report("K4b", label, rows, abs_err,
           lambda: K.fused_pe_mlp_backward(*bwd_args, saved=acts),
           lambda: K.pe_mlp_backward_saved_reference(*bwd_args, acts),
           flops_b, nbytes_b, inner, rel_err=rel_err, extra={
               "bound_3xtf32_ms": bound_ms(3 * flops_b, nbytes_b, PEAK_TF32)[0],
               "bound_vjp_from_x_ms": bound_ms(flops_vjp, nbytes_vjp)[0],
               "bound_vjp_from_x_3xtf32_ms": bound_ms(3 * flops_vjp, nbytes_vjp, PEAK_TF32)[0],
               "cuda_launches_per_call": launches_b, "relu_tie_pairs": n_ties,
               "relu_tie_rows": int(tie_rows.sum()), "max_rel_err_autograd_all_rows": rel_auto,
               "max_rel_err_autograd_untied_rows": rel_kept, "main": main})


def _pe_forward_kernel(K, gen, shape, report):
    """K4f alone at a shape where nothing needs its gradient (export's
    canonical SDF grid): fused_pe_mlp without saving against
    pe_mlp_reference on the same inputs, both timed; the bound counts the
    raw points read and the output written (no saved outputs)."""
    import torch

    label, rows, n_freqs, widths, skips, final_act, window = shape
    freqs = tuple(float(2.0**i) for i in range(n_freqs))
    c_x = 3 * (2 * n_freqs + 1)
    weights, biases = _mlp_params(c_x, 0, 0, gen, "cuda", widths=list(widths), skips=skips)
    x = ((torch.rand(rows, 3, generator=gen) * 2 - 1) * 0.5).cuda()
    win = torch.linspace(0.3, 1.0, n_freqs).cuda() if window else None
    args = (x, win, weights, biases, freqs, skips, final_act)
    got = K.fused_pe_mlp(*args)
    launches_f = K.fused_pe_mlp.cuda_launches
    want = K.pe_mlp_reference(*args)
    sync()
    err = float((got - want).abs().max())
    if not got.is_cuda or got.shape != want.shape or not err <= KERNEL_TOL:
        fail(f"K4f {label} disagrees with its plain version: {err} > {KERNEL_TOL}")
    in_dims = [w.shape[1] for w in weights]
    macs = mlp_macs(in_dims, widths)
    flops = 2 * rows * macs
    nbytes = 4 * (rows * (3 + widths[-1]) + macs + sum(widths))
    inner = 5 if rows > 4096 else 100
    report("K4f", label, rows, err, lambda: K.fused_pe_mlp(*args),
           lambda: K.pe_mlp_reference(*args), flops, nbytes, inner, extra={
               "bound_3xtf32_ms": bound_ms(3 * flops, nbytes, PEAK_TF32)[0],
               "cuda_launches_per_call": launches_f, "saved_floats_per_point": 0,
               "macs_per_row": macs, "tile_rows": _pe_tile_rows(K, rows, n_freqs, weights, skips)})


def _pe_tile_rows(K, rows, n_freqs, weights, skips):
    """Points per tile of K4f's launch plan (the library's) at this shape."""
    plan = K.pe_mlp_plan(K._kernel_lib("fused_pe_mlp"), 3, n_freqs, [w.shape[1] for w in weights],
                         [w.shape[0] for w in weights], rows, sum(1 << i for i in skips))
    return plan.tile_rows


def _flagship_heads(gen):
    """Random flagship-width field heads (FeatureNeRF, D=5 W=128) and the
    inputs of one training step: 262,144 points, live annealing windows."""
    import torch

    from lab4d_tpu_torch.nnutils.embedding import PosEmbedding
    from lab4d_tpu_torch.ops.field_kernel import FieldCfg

    def mlp(c_x, widths, skips=()):
        ws, bs = _mlp_params(c_x, 0, 0, gen, "cuda", widths=widths, skips=skips)
        return [t for wb in zip(ws, bs) for t in wb]

    nets = dict(base=mlp(63, [128] * 6, (4,)), sdf=mlp(128, [1]), color=mlp(75, [128] * 3),
                rgb1=mlp(160, [64]), rgb2=mlp(64, [3]), vis=mlp(63, [64, 64, 1]),
                feat=mlp(39, [128] * 5 + [16], (4,)))
    cfg = FieldCfg(tuple(float(2.0**i) for i in range(12)), 10, 12, 10, 6, (4,), (4,), (4,), (4,))
    P = FG_PAIRS * FG_SPP
    x = ((torch.rand(P, 3, generator=gen) * 2 - 1) * 0.5).cuda()
    appr = (torch.randn(FG_PAIRS, 32, generator=gen) * 0.3).cuda()
    win_b = PosEmbedding(3, 10).get_window(0.7).cuda()
    win_c = PosEmbedding(3, 12).get_window(0.7).cuda()
    ibeta = torch.tensor([10.0], device="cuda")
    g = [torch.randn(P, c, generator=gen).cuda() for c in (1, 3, 1, 16)]
    return (x, appr, win_b, win_c, nets, ibeta, cfg, FG_SPP), g


def _relu_ties(FK, args, acts):
    """The (row, unit) pairs where K1's saved output of a ReLU and the plain
    forward's input to it lie on opposite sides of zero, so that the two
    backward passes take other sides of the kink: (rows holding one, number
    of pairs, largest |input| among them)."""
    import torch

    nets, P = args[4], args[0].shape[0]
    _, z = FK.nerf_heads_forward_saved_reference(*args, pre_activations=True)
    rows = torch.zeros(P, dtype=torch.bool, device=acts.device)
    n, z_max = 0, 0.0
    for key, off in FK.act_layout(nets)[0].items():
        if key == "rgb_h":
            w = nets["rgb1"][0].shape[0]
        else:
            name, i = key
            w = nets[name][2 * i].shape[0]
            if name in ("vis", "feat") and i == len(nets[name]) // 2 - 1:
                continue  # the visibility logit and the feature have no ReLU
        a, zz = (t[off * P: (off + w) * P].view(P, w) for t in (acts, z))
        flip = (a > 0) != (zz > 0)
        rows |= flip.any(1)
        n += int(flip.sum())
        z_max = max(z_max, float(zz.abs().masked_fill(~flip, 0).max()))
    return rows, n, z_max


def _grad_rel_errs(FK, names, got, want):
    """{array: max abs difference / max(1, max|want|)} over (dx, dappr,
    dnets, dibeta) results."""
    out = {}
    for n, a, b in zip(names, [got[0], got[1], got[3]] + FK.flatten_nets(got[2])[0],
                       [want[0], want[1], want[3]] + FK.flatten_nets(want[2])[0]):
        out[n] = float((a.reshape(b.shape) - b).abs().max()) / max(1.0, float(b.abs().max()))
    return out


def _heads_kernels(gen):
    """K1 and K2 against their plain versions at the flagship step, every
    output, every saved layer output and every gradient. K1 runs as the
    training step runs it, saving its layer outputs; K2 takes those, and
    its plain version (nerf_heads_backward_saved_reference) the same ones.
    K1 + K2 are also held against autograd through a recomputed plain
    forward, which differs where a ReLU input lies within rounding of zero
    and the two forwards take other sides of the kink: every such input
    must lie within 10x K1's saved-output error of zero, and with the
    cotangents of the rows that hold one set to zero, every gradient must
    agree within KERNEL_TOL."""
    import torch

    from lab4d_tpu_torch.ops import field_kernel as FK

    args, g = _flagship_heads(gen)
    x, nets, P = args[0], args[4], args[0].shape[0]
    got, acts = FK.nerf_heads_forward_saved(*args)
    k1_launches = FK.fused_nerf_heads.cuda_launches
    want, want_acts = FK.nerf_heads_forward_saved_reference(*args)
    sync()
    errs = {n: float((a - b).abs().max()) for n, a, b in zip(("density", "rgb", "vis", "feat"), got, want)}
    errs["saved"] = float((acts - want_acts).abs().max())
    print("[kernel] K1 outputs and saved layer outputs, max abs err (tol %g): " % KERNEL_TOL
          + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    if not all(o.is_cuda for o in got) or not max(errs.values()) <= KERNEL_TOL:
        fail(f"K1 disagrees with its plain version: {errs}")
    saved = (acts, got[1])
    got_b = FK.fused_nerf_heads_backward(x, g, *args[1:], saved=saved)
    want_b = FK.nerf_heads_backward_saved_reference(x, g, *args[1:], *saved)
    auto_b = FK.nerf_heads_backward_reference(x, g, *args[1:])
    sync()
    names = ["dx", "dappr", "dibeta"] + [f"{n}.{i}" for n, i in FK.flatten_nets(nets)[1]]
    flat = [got_b[0], got_b[1], got_b[3]] + FK.flatten_nets(got_b[2])[0]
    abs_b = {n: float((a.reshape(b.shape) - b).abs().max()) for n, a, b in zip(
        names, flat, [want_b[0], want_b[1], want_b[3]] + FK.flatten_nets(want_b[2])[0])}
    rel_b = _grad_rel_errs(FK, names, got_b, want_b)
    rel_auto = _grad_rel_errs(FK, names, got_b, auto_b)
    print("[kernel] K2 gradients, max rel err (tol %g; abs err / max(1, max|g|)): " % KERNEL_TOL
          + " ".join(f"{k}={v:.1e}" for k, v in rel_b.items()))
    if not max(rel_b.values()) <= KERNEL_TOL:
        fail(f"K2 disagrees with its plain version: {max(rel_b.items(), key=lambda t: t[1])}")
    tie_rows, n_ties, z_tie = _relu_ties(FK, args, acts)
    keep = (~tie_rows).to(x.dtype)[:, None]
    g_kept = [t * keep for t in g]
    rel_kept = _grad_rel_errs(FK, names, FK.fused_nerf_heads_backward(x, g_kept, *args[1:], saved=saved),
                              FK.nerf_heads_backward_reference(x, g_kept, *args[1:]))
    sync()
    dx_ties = float((got_b[0] - auto_b[0]).abs()[tie_rows].max()) if n_ties else 0.0
    worst = sorted(rel_auto.items(), key=lambda t: -t[1])[:6]
    print(f"[kernel] K1 + K2 against autograd through the plain forward, all rows, worst of "
          f"max|d| / max(1, max|g|): " + " ".join(f"{k}={v:.1e}" for k, v in worst))
    print(f"[kernel] ReLU ties (K1's saved output and the plain input on other sides of zero): "
          f"{n_ties} (row, unit) pairs in {int(tie_rows.sum())} of {P} rows, largest |input| "
          f"{z_tie:.2e} (tol {10 * errs['saved']:.2e}, 10x K1's saved error); max|d dx| on those "
          f"rows {dx_ties:.2e}; the other rows alone, worst: {max(rel_kept.values()):.1e} "
          f"({max(rel_kept, key=rel_kept.get)}; tol {KERNEL_TOL:g})")
    if not z_tie <= 10 * errs["saved"]:
        fail(f"a ReLU input of {z_tie} flips between K1 and the plain forward")
    if not max(rel_kept.values()) <= KERNEL_TOL:
        fail(f"K1 + K2 disagree with autograd outside the ReLU ties: {max(rel_kept.items(), key=lambda t: t[1])}")
    k2_launches = FK.fused_nerf_heads_backward.cuda_launches

    # 234,688 multiply-adds per point at the flagship widths (PERF.md)
    macs = sum(w.numel() for w in FK.flatten_nets(nets)[0][0::2]) - 64 * 32
    weights = sum(t.numel() for t in FK.flatten_nets(nets)[0])
    n_saved = FK.act_layout(nets)[1]
    label = f"flagship heads D5 W128, {FG_PAIRS} pairs x {FG_SPP}"
    out = {}
    for key, kernel, plain, flops, nbytes, rel, launches in (
        ("K1", lambda: FK.nerf_heads_forward_saved(*args), lambda: FK.nerf_heads_reference(*args),
         2 * P * macs, 4 * (P * (3 + 21 + n_saved) + FG_PAIRS * 32 + weights), None, k1_launches),
        ("K2", lambda: FK.fused_nerf_heads_backward(x, g, *args[1:], saved=saved),
         lambda: FK.nerf_heads_backward_saved_reference(x, g, *args[1:], *saved),
         2 * 2 * P * macs, 4 * (P * (3 + 21 + 3 + n_saved + 3) + 2 * FG_PAIRS * 32 + 2 * weights),
         max(rel_b.values()), k2_launches),
    ):
        backward = key == "K2"
        r = {"label": label, "rows": P, "macs_per_point": macs,
             "max_abs_err": max(abs_b.values()) if backward else max(errs.values()),
             "ms": device_ms(kernel, 3), "plain_ms": eager_ms(plain, 2) if backward else device_ms(plain, 2),
             "cuda_launches_per_call": launches}
        if rel is not None:
            r["max_rel_err"] = rel
            r["relu_tie_pairs"], r["relu_tie_rows"] = n_ties, int(tie_rows.sum())
            r["max_rel_err_autograd_all_rows"] = max(rel_auto.values())
            r["max_rel_err_autograd_untied_rows"] = max(rel_kept.values())
        r["bound_ms"], r["bound_by"] = bound_ms(flops, nbytes)
        r["bound_3xtf32_ms"], _ = bound_ms(3 * flops, nbytes, PEAK_TF32)
        sync()
        print(f"[kernel] {key} {label}: {macs} MAC/point, {launches} CUDA launches per call, device "
              f"kernel {r['ms']:.3f} ms / plain {r['plain_ms']:.3f} ms{' (eager)' if backward else ''} "
              f"/ bound {r['bound_ms']:.3f} ms ({r['bound_by']}, fp32 FMA) / "
              f"{r['bound_3xtf32_ms']:.3f} ms (3xTF32 tensor cores)")
        out[key] = [r]
    return out


def phase_heads_anatomy(anatomy, kernels):
    """One round of K1's anatomy copies (tools/profile_heads_phases.py) at
    the flagship step: `full` against nerf_heads_reference, the others
    timed. Returns its row for the kernels line."""
    import torch

    from lab4d_tpu_torch.ops import field_kernel as FK
    from lab4d_tpu_torch.ops.mlp_kernel import _stream
    from lab4d_tpu_torch.tools import profile_heads_phases as PH

    heads, _ = _flagship_heads(torch.Generator().manual_seed(SEED))
    err, times = PH.anatomy_round(FK, anatomy, heads, _stream(heads[0].device), 1)
    sync()
    print(f"[heads-anatomy] full vs plain: max abs err {err:.3e} (tol {KERNEL_TOL:g}); one round, ms: "
          + " ".join(f"{k}={v:.3f}" for k, v in times.items()))
    if not err <= KERNEL_TOL:
        fail(f"the anatomy copy `full` of K1 disagrees with its plain version: {err}")
    k1 = kernels["K1"][0]
    return {"label": k1["label"], "rows": k1["rows"], "max_abs_err": err, "ms": times["full"],
            "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "copies_ms": times}


def make_scene(num_frames=8, res=RES):
    """One orbit video: frame tables, intrinsics, object-to-camera priors."""
    from lab4d_tpu_torch.nnutils.embedding import FrameInfo

    fi = FrameInfo.single_video(num_frames)
    rtmat = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    for i in range(num_frames):
        a = 2 * np.pi * i / num_frames * 0.25
        rtmat[i, :3, :3] = [[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]]
        rtmat[i, 2, 3] = 3.0
    intrinsics = np.tile(np.array([res, res, res / 2, res / 2], np.float32), (num_frames, 1))
    return {
        "frame_info": fi,
        "raw_size": np.array([[res, res]]),
        "intrinsics": intrinsics,
        "vis_info": {"bg": 0, "fg": 1},
        "rtmat": np.stack([rtmat, rtmat], 0),
    }


def init_from_priors(model, data_info):
    """The trainer's prior surgery before fitting, on random weights:
    intrinsics and camera base rotation from each video's first frame, and
    the camera MLP's translation bias offset so that its mean output is
    the prior's (field units). Without it the random intrinsics MLP gives
    a focal length near 1 px and almost every ray misses the object."""
    import torch

    from lab4d_tpu_torch.nnutils.intrinsics import intrinsics_base_init
    from lab4d_tpu_torch.utils.quat import matrix_to_quaternion

    fi = data_info["frame_info"]
    rtmat = data_info["rtmat"][data_info["vis_info"]["fg"]].copy()
    rtmat[:, :3, 3] *= 0.2  # the fg field's init_scale
    cam = model.fields.field_params["fg"].camera_mlp
    logfocal, ppoint = intrinsics_base_init(data_info["intrinsics"], fi)
    with torch.no_grad():
        model.intrinsics.base_logfocal.copy_(torch.as_tensor(logfocal))
        model.intrinsics.base_ppoint.copy_(torch.as_tensor(ppoint))
        first = torch.as_tensor(rtmat[fi.frame_offset[:-1], :3, :3])
        cam.base_quat.copy_(matrix_to_quaternion(first))
        _, trans = cam.get_vals()
        prior = torch.as_tensor(rtmat[:, :3, 3], device=trans.device)
        cam.trans_head[1].bias += (prior - trans).mean(0)


def sphere_proxy(radius=0.12, n_lat=4, n_lon=4):
    """Vertices of a latitude-longitude sphere (the trainer's initial proxy
    mesh), its (2, 3) bounds and the 8 corners of its bounding box."""
    lat = np.linspace(0, np.pi, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    lat, lon = np.meshgrid(lat, lon, indexing="ij")
    verts = np.stack([np.sin(lat) * np.cos(lon), np.sin(lat) * np.sin(lon), np.cos(lat)], -1)
    verts = (verts.reshape(-1, 3) * radius).astype(np.float32)
    bounds = np.stack([verts.min(0), verts.max(0)], 0)
    corners = np.array([[bounds[i, 0], bounds[j, 1], bounds[k, 2]]
                        for i in (0, 1) for j in (0, 1) for k in (0, 1)], np.float32)
    return verts, bounds, corners


def geo_state_for(model, data_info):
    """aabb from the proxy bounds; near-far from the proxy vertices and the
    cameras of all filtered frames (the JAX trainer's _reset_geo_state)."""
    import torch

    from lab4d_tpu_torch.utils.geom import get_near_far
    from lab4d_tpu_torch.utils.quat import quaternion_translation_to_se3

    verts, bounds, corners = sphere_proxy()
    fi = data_info["frame_info"]
    with torch.no_grad():
        quat, trans = model.fields.field_params["fg"].camera_mlp.get_vals()
        rtmat = quaternion_translation_to_se3(quat, trans)
        near_far_frames = get_near_far(torch.as_tensor(verts, device=rtmat.device), rtmat)
    near_far = np.tile(np.array([0.01, 10.0], np.float32), (fi.num_frames_raw, 1))
    near_far[fi.frame_mapping] = near_far_frames.cpu().numpy()
    return {"fg": {"aabb": bounds, "near_far": near_far, "corners": corners}}


def phase_model(data_info):
    import torch

    from lab4d_tpu_torch.engine.model import DVRModel

    t = time.time()
    model = DVRModel(data_info["frame_info"], field_type="fg", fg_motion="skel-quad",
                     num_inst=1, device="cuda", generator=torch.Generator().manual_seed(SEED))
    model.eval().requires_grad_(False)
    init_from_priors(model, data_info)
    geo_state = geo_state_for(model, data_info)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    if not all(p.is_cuda for p in model.parameters()):
        fail("model parameters are not all on cuda")
    print(f"[model] fg/skel-quad DVRModel: {n_params} parameters on cuda in {time.time() - t:.1f} s")
    return model, geo_state


@contextlib.contextmanager
def topk_weights(store):
    """While on, every top-k selection appends the union weights it ranks
    (rays, samples) to store."""
    from lab4d_tpu_torch.nnutils import nerf

    orig = nerf.topk_indices

    def record(weights, k):
        store.append(weights.detach().reshape(-1, weights.shape[-1]).double().cpu())
        return orig(weights, k)

    nerf.topk_indices = record
    try:
        yield
    finally:
        nerf.topk_indices = orig


STREAMS_FIXTURE = os.path.join("tests", "data", "jax_streams.npz")
STREAM_STEPS = 20


def phase_streams(model):
    """[streams]: the replica of JAX's random streams against the fixture
    JAX wrote, then the host cost of one flagship step's draws."""
    from lab4d_tpu_torch.engine import jax_streams

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), STREAMS_FIXTURE)
    if not os.path.exists(path):
        fail(f"[streams] no fixture at {STREAMS_FIXTURE}")
    rows = jax_streams.compare_fixture(np.load(path))
    bad = [r for r in rows if r[1] > r[2]]
    print("[streams] against JAX's fixture (ulps or mismatches / allowed): " + ", ".join(
        f"{n} {d}/{a}" for n, d, a in rows))
    if bad:
        fail(f"[streams] the replica differs from JAX's fixture: {bad}")
    host_ms, copy_ms = [], []
    for step in range(STREAM_STEPS):
        t = time.perf_counter()
        draws = jax_streams.training_draws(model, step, jax_streams.FLAGSHIP_RAYS)
        host_ms.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        jax_streams.to_device(draws, "cuda")
        sync()
        copy_ms.append(1e3 * (time.perf_counter() - t))
    n = sum(v.size for d in draws.values() if isinstance(d, dict) for v in d.values())
    print(f"[streams] one flagship step's draws ({n} numbers, {jax_streams.FLAGSHIP_RAYS} rays): "
          f"host median {np.median(host_ms):.3f} ms (min {min(host_ms):.3f}, max "
          f"{max(host_ms):.3f}, {STREAM_STEPS} steps), one copy to the card median "
          f"{np.median(copy_ms):.3f} ms")


def phase_reference(model, geo_state, data_info, topk=None):
    """GPU evaluate_rays (kernel) vs the same weights on the CPU (plain), 256
    rays of one frame; exact eval, or the top-k eval at topk. Top-k compares
    every channel on the rays where both devices select the same samples,
    which must be at least 95% of them, and the mask on every ray. A ray
    whose selections differ must be a near tie: its K-th and (K+1)-th
    union weights lie within twice the two devices' largest weight
    difference on that ray, so that rounding alone can swap them."""
    import torch

    from lab4d_tpu_torch.render import construct_batch_from_opts

    opts = {"inst_id": 0, "render_res": 16, "viewpoint": "ref", "freeze_id": 0,
            "num_frames": 1, "noskip": False}
    model_cpu = copy.deepcopy(model).cpu()
    outs, weights = {}, {}
    for name, m, dev in (("cuda", model, "cuda"), ("cpu", model_cpu, "cpu")):
        batch, _ = construct_batch_from_opts(opts, m, geo_state, data_info, dev)
        batch["geo"] = {"fg": {k: torch.as_tensor(v, device=dev)
                               for k, v in (("aabb", geo_state["fg"]["aabb"]),
                                            ("proxy_corners", geo_state["fg"]["corners"]))}}
        weights[name] = []
        with torch.no_grad(), topk_weights(weights[name]):
            outs[name] = m.evaluate_rays(m.prepare_eval_samples(batch), topk=topk)
    sync()
    for k, v in outs["cuda"].items():
        if not v.is_cuda:
            fail(f"reference: channel {k} is on {v.device}")
    tag, kept, note = "reference", None, ""
    if topk is not None:
        from lab4d_tpu_torch.nnutils.nerf import topk_indices

        tag = "reference-topk"
        w_gpu, w_cpu = weights["cuda"][0], weights["cpu"][0]
        kept = (topk_indices(w_gpu, topk) == topk_indices(w_cpu, topk)).all(-1)
        w_sorted = torch.sort(w_cpu, dim=-1, descending=True).values
        gap = w_sorted[:, topk - 1] - w_sorted[:, topk]
        diff = (w_gpu - w_cpu).abs().max(dim=-1).values
        # equal weights on both devices (all zero on the rays that miss) tie-break alike
        near_tie = (gap <= 2 * diff) & (diff > 0)
        n_out = int((~kept).sum())
        note = (f"; {n_out} of {len(kept)} rays set aside (other samples selected), "
                f"{int(near_tie.sum())} near ties, {int((diff == 0).sum())} rays with equal "
                "weights on both devices")
        if bool((~kept & ~near_tie).any()):
            fail(f"{tag}: the devices select other samples on a ray that is no near tie")
        if n_out > 0.05 * len(kept):
            fail(f"{tag}: {n_out} of {len(kept)} rays select other samples on the two devices")
        mask_err = float((outs["cuda"]["mask"].cpu() - outs["cpu"]["mask"]).abs().max())
        if not mask_err <= 1e-4:
            fail(f"{tag}: mask GPU vs CPU err {mask_err} > 1e-4 over all rays")
        note += f"; mask over all rays {mask_err:.2e} (<=1e-4)"
    worst = {}
    for k, (kind, tol) in REF_TOL.items():
        a, b = outs["cuda"][k].cpu().double()[0], outs["cpu"][k].double()[0]
        if kept is not None:
            a, b = a[kept], b[kept]
        err = (a - b).abs().max() if kind == "abs" else ((a - b).abs() / b.abs().clamp(min=1e-12)).max()
        worst[k] = float(err)
        if not worst[k] <= tol:
            fail(f"{tag}: channel {k} GPU vs CPU {kind} err {worst[k]} > {tol}")
    print(f"[{tag}] 256 rays{'' if topk is None else f', top-{topk} eval'}, GPU vs CPU: "
          + " ".join(f"{k}={v:.2e}({REF_TOL[k][0]}<={REF_TOL[k][1]:g})" for k, v in worst.items())
          + note)


@contextlib.contextmanager
def k3_records(calls, shapes):
    """While on, every TimeMLP backbone call counts its rows in
    calls[class name], and every K3f launch its (rows, C_in, widths,
    skips, final ReLU) in shapes (both collections.Counter)."""
    from lab4d_tpu_torch.nnutils.time_mlp import TimeMLP
    from lab4d_tpu_torch.ops import mlp_kernel as K

    orig_feat, orig_launch = TimeMLP.forward_feat, K._launch_k3f

    def forward_feat(self, t_embed):
        calls.setdefault(type(self).__name__, collections.Counter())[
            t_embed.reshape(-1, t_embed.shape[-1]).shape[0]] += 1
        return orig_feat(self, t_embed)

    def launch(lib, x, weights, biases, skip_idx, final_act, *args, **kwargs):
        skips = tuple(i for i in skip_idx if i < len(weights))
        shapes[(x.shape[0], x.shape[1], tuple(w.shape[0] for w in weights), skips,
                bool(final_act))] += 1
        return orig_launch(lib, x, weights, biases, skip_idx, final_act, *args, **kwargs)

    TimeMLP.forward_feat, K._launch_k3f = forward_feat, launch
    try:
        yield
    finally:
        TimeMLP.forward_feat, K._launch_k3f = orig_feat, orig_launch


@contextlib.contextmanager
def k4_records(shapes):
    """While on, every K4f and K4b launch counts its ("K4f" or "K4b",
    rows, input width, layer widths) in shapes (a collections.Counter)."""
    from lab4d_tpu_torch.ops import mlp_kernel as K

    orig_fwd, orig_bwd = K._launch_pe_fwd, K._launch_pe_bwd

    def record(name, orig):
        def launch(lib, x, *args, **kwargs):
            weights = args[2] if name == "K4b" else args[1]
            shapes[(name, x.shape[0], x.shape[1], tuple(w.shape[0] for w in weights))] += 1
            return orig(lib, x, *args, **kwargs)
        return launch

    K._launch_pe_fwd, K._launch_pe_bwd = record("K4f", orig_fwd), record("K4b", orig_bwd)
    try:
        yield
    finally:
        K._launch_pe_fwd, K._launch_pe_bwd = orig_fwd, orig_bwd


def phase_k3_paths(shapes):
    """K3f / K3b against their plain versions at every shape K3f launched
    on the render and training paths that the kernel phase did not check
    (K3_SHAPES, K3_TRAIN_SHAPES)."""
    from lab4d_tpu_torch.ops import mlp_kernel as K

    checked = {(rows, C, (W,) * (D + 1), (), True)
               for _, rows, C, D, W in K3_SHAPES + K3_TRAIN_SHAPES + K3_CATEGORY_SHAPES}
    checked |= {(rows, C, widths, skips, fa) for _, rows, C, widths, skips, fa in K3_WARP_SHAPES}
    gen = torch_generator()
    extra = sorted(set(shapes) - checked)
    for rows, C, widths, skips, final_act in extra:
        _k3_kernels(K, gen, f"path rows={rows} C={C} widths={list(widths)} skips={list(skips)}"
                    f"{'' if final_act else ' no final ReLU'}", rows, C, widths,
                    skips=skips, final_act=final_act)
    sync()
    print(f"[k3-paths] K3f launched at {len(shapes)} shapes on the render and training paths "
          f"(rows, C_in, widths, skips, final ReLU: launches): "
          + "; ".join(f"{r}, {c}, {list(w)}, {list(sk)}, {fa}: {n}"
                      for (r, c, w, sk, fa), n in sorted(shapes.items()))
          + f"; {len(extra)} not in the kernel phase's shapes, checked here against the plain "
          "versions")


def torch_generator():
    import torch

    return torch.Generator().manual_seed(SEED)


def phase_render(model, geo_state, data_info, tag="render", topk=None, channels=None,
                 n_frames=N_FRAMES, viewpoint="ref", inst_id=0):
    """n_frames frames at RES^2 through the render CLI's own functions (eval
    mode topk / channels, as --eval_topk / --render_keys give them);
    returns every kernel's launches over exactly that run, the frames and
    ms/frame."""
    import torch

    from lab4d_tpu_torch.render import construct_batch_from_opts, render_batch

    opts = {"inst_id": inst_id, "render_res": RES, "viewpoint": viewpoint, "freeze_id": 0,
            "num_frames": n_frames, "noskip": False}
    # warm-up at a small size: cuBLAS handles, allocator pools
    warm = dict(opts, render_res=32, num_frames=1)
    batch, _ = construct_batch_from_opts(warm, model, geo_state, data_info, "cuda")
    render_batch(model, batch, geo_state, topk=topk, channels=channels)
    sync()
    torch.cuda.reset_peak_memory_stats()

    _reset_kernel_counts()
    t = time.time()
    batch, _ = construct_batch_from_opts(opts, model, geo_state, data_info, "cuda")
    rendered = render_batch(model, batch, geo_state, topk=topk, channels=channels)
    sync()
    elapsed = time.time() - t
    launches = _kernel_counts()

    if launches["K3f"] <= 0:
        fail(f"{tag}: the render ran no fused_relu_mlp kernel")
    if not all(v.is_cuda for v in batch.values() if torch.is_tensor(v)):
        fail(f"{tag}: render batch is not on cuda")
    if channels is not None and set(rendered) != set(channels):
        fail(f"{tag}: rendered {sorted(rendered)}, asked for {sorted(channels)}")
    for k, v in rendered.items():
        if v.shape[:3] != (n_frames, RES, RES) or not np.isfinite(v).all():
            fail(f"{tag}: channel {k} has shape {v.shape} or non-finite values")
    mask = rendered["mask"]
    if not (mask.min() >= 0.0 and mask.max() <= 1.0 + 1e-6):
        fail(f"{tag}: mask outside [0, 1]: [{mask.min()}, {mask.max()}]")
    ms_frame = elapsed / n_frames * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] {n_frames} {viewpoint} frames at {RES}^2"
          f"{f' of instance {inst_id}' if inst_id else ''}"
          f"{'' if topk is None else f', top-{topk} eval'}: "
          f"{ms_frame:.1f} ms/frame, "
          f"launches {' '.join(f'{k}={v}' for k, v in launches.items())}, peak memory {peak:.2f} GiB, "
          f"channels {sorted(rendered)}, mask mean {mask.mean():.4f}")
    return launches, rendered, ms_frame


def phase_render_topk(model, geo_state, data_info, exact):
    """[render-topk]: the [render] frames with the render CLI's default
    top-k eval (K = 8): the mask within 1e-4 of the exact frames' (top-k
    keeps each ray's total mass), the rgb PSNR against them reported; then
    [render-keys]: --render_keys rgb,depth,mask on one frame, each channel
    within 1e-6 of the full top-k frame's."""
    launches, rendered, _ = phase_render(model, geo_state, data_info, "render-topk", topk=8)
    mask_err = float(np.abs(rendered["mask"] - exact["mask"]).max())
    if not mask_err <= 1e-4:
        fail(f"render-topk: mask differs from the exact eval's by {mask_err} > 1e-4")
    mse = float(np.mean((rendered["rgb"].astype(np.float64) - exact["rgb"]) ** 2))
    print(f"[render-topk] against the exact frames: mask max abs diff {mask_err:.2e} (<=1e-4), "
          f"rgb PSNR {10 * np.log10(1.0 / max(mse, 1e-20)):.2f} dB (reported)")
    keys = frozenset({"rgb", "depth", "mask"})
    _, sub, _ = phase_render(model, geo_state, data_info, "render-keys", topk=8, channels=keys,
                             n_frames=1)
    errs = {k: float(np.abs(sub[k][0] - rendered[k][0]).max()) for k in sorted(keys)}
    if not max(errs.values()) <= 1e-6:
        fail(f"render-keys: channels differ from the full render's: {errs}")
    print("[render-keys] against the full top-k frame: "
          + " ".join(f"{k}={v:.1e}" for k, v in errs.items()) + " (<=1e-6)")
    return launches


def phase_render_comp(db, root):
    """[render-comp]: the comp checkpoint of [train-comp] through the
    render CLI's functions: 2 reference frames at 512^2 exact and with the
    top-k eval (K = 8; its mask within 1e-4 of the exact one's), and one
    bev-30 frame (the bg's top view with the fg at its pose relative to
    the bg). Both fields must show: mask_fg and mask_bg each exceed 0.01
    somewhere. Returns the launches of the exact and top-k runs."""
    import torch

    from lab4d_tpu_torch.render import construct_test_model, get_parser

    opts = _app_opts(get_parser(), db, root, "comp")
    model, geo_state, data_info = construct_test_model(opts, torch.device("cuda"))
    if sorted(geo_state) != ["bg", "fg"]:
        fail(f"render-comp: the checkpoint holds {sorted(geo_state)}")
    launches, exact, _ = phase_render(model, geo_state, data_info, "render-comp")
    for k in ("mask_fg", "mask_bg"):
        if not float(exact[k].max()) > 0.01:
            fail(f"render-comp: {k} is nowhere above 0.01: one field renders nothing")
    topk_launches, topk, _ = phase_render(model, geo_state, data_info, "render-comp-topk", topk=8)
    mask_err = float(np.abs(topk["mask"] - exact["mask"]).max())
    if not mask_err <= 1e-4:
        fail(f"render-comp-topk: mask differs from the exact eval's by {mask_err} > 1e-4")
    mse = float(np.mean((topk["rgb"].astype(np.float64) - exact["rgb"]) ** 2))
    print(f"[render-comp] fg pixels {float((exact['mask_fg'] > 0.5).mean()):.4f}, bg pixels "
          f"{float((exact['mask_bg'] > 0.5).mean()):.4f}; top-k against exact: mask max abs diff "
          f"{mask_err:.2e} (<=1e-4), rgb PSNR {10 * np.log10(1.0 / max(mse, 1e-20)):.2f} dB")
    phase_render(model, geo_state, data_info, "render-comp-bev", topk=8, n_frames=1,
                 viewpoint="bev-30")
    return {k: launches[k] + topk_launches[k] for k in launches}


TRAIN_OPTS = {
    "bg": ["--field_type", "bg", "--seqname", "smoke", "--logname", "bg", "--train_res", "64",
           "--num_workers", "4"],
    "fg": ["--field_type", "fg", "--fg_motion", "skel-quad", "--seqname", "smoke", "--logname", "fg",
           "--train_res", "64", "--num_workers", "4"],
    "comp": ["--field_type", "comp", "--fg_motion", "comp_skel-human_dense", "--seqname", "smoke",
             "--logname", "comp", "--train_res", "64", "--num_workers", "4"],
}
# [train-families]: the other single-video warps as the fg field, FAMILY_STEPS
# full-width steps each after FAMILY_GEO_STEPS geometry-init steps
FAMILIES = ("bob", "skel-human", "dense", "nvp", "comp_skel-quad_dense")
FAMILY_STEPS, FAMILY_GEO_STEPS = 5, 20
for _motion in FAMILIES:
    TRAIN_OPTS[_motion] = ["--field_type", "fg", "--fg_motion", _motion, "--seqname", "smoke",
                           "--logname", _motion, "--train_res", "64", "--num_workers", "4",
                           "--geo_init_steps", str(FAMILY_GEO_STEPS)]
# [train-category]: the multi-video category model of the category tutorial
# (fg / comp_skel-human_dense, --nosingle_inst: one instance code per video)
# on CATEGORY_VIDS videos of CATEGORY_FRAMES frames at 64^2, each video's
# sphere 10% larger than the last; [transfer] loads its checkpoint into the
# one-video scene with --freeze_bone_len, [resume] into its own scene
CATEGORY_VIDS, CATEGORY_FRAMES, CATEGORY_GEO_STEPS = 8, 16, 500
TRANSFER_STEPS, RESUME_STEPS, LOAD_GEO_STEPS = 10, 2, 20
TRAIN_OPTS["category"] = ["--field_type", "fg", "--fg_motion", "comp_skel-human_dense",
                          "--no-single_inst", "--seqname", "cate", "--logname", "category",
                          "--train_res", "64", "--num_workers", "4"]
TRAIN_OPTS["transfer"] = ["--field_type", "fg", "--fg_motion", "comp_skel-human_dense",
                          "--freeze_bone_len", "--seqname", "smoke", "--logname", "transfer",
                          "--train_res", "64", "--num_workers", "4"]
FIELD_NAMES = {"bg": "bg field", "fg": "fg / skel-quad field",
               "comp": "comp: fg / comp_skel-human_dense + bg fields",
               "category": f"category: fg / comp_skel-human_dense, {CATEGORY_VIDS} instance codes",
               "transfer": "transfer: fg / comp_skel-human_dense from the category checkpoint"}


def write_scene(root):
    """A synthetic scene (one orbit video of 32 frames at 64^2) written by
    the port's own writer; returns the database root."""
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    t = time.time()
    db = os.path.join(root, "database")
    make_synthetic_dataset(db, seqname="smoke", num_frames=32, res=64)
    print(f"[scene] synthetic orbit scene, 32 frames at 64^2, in {time.time() - t:.1f} s")
    return db


def write_category_scene(db):
    """The category scene beside write_scene's: CATEGORY_VIDS orbit videos
    of CATEGORY_FRAMES frames at 64^2, video v's sphere (1 + 0.1 v) times
    the first's, so that the instance codes have sizes to fit."""
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    t = time.time()
    make_synthetic_dataset(db, seqname="cate", num_vids=CATEGORY_VIDS,
                           num_frames=CATEGORY_FRAMES, res=64, scale_step=0.1)
    print(f"[scene] synthetic category scene, {CATEGORY_VIDS} videos x {CATEGORY_FRAMES} frames "
          f"at 64^2, sphere radius 0.5 x (1 + 0.1 v), in {time.time() - t:.1f} s")


def _step_grads(model, batch, draws, step=0):
    """Loss terms and parameter gradients of training step `step`, its
    draws the port's own but for those `draws` gives."""
    from lab4d_tpu_torch.engine.schedules import compute_sched

    model.zero_grad(set_to_none=True)
    loss_dict = model(batch, compute_sched(step), draws=draws, step=step)
    sum(loss_dict[k] for k in sorted(loss_dict)).backward()
    return ({k: float(v.detach()) for k, v in loss_dict.items()},
            {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()
             if p.grad is not None})


def _relu_inputs(rec):
    """A TorchFunctionMode that appends to `rec` the input of every
    torch.relu called while it is on (nothing is patched)."""
    import torch
    from torch.overrides import TorchFunctionMode

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.relu:
                rec.append(args[0].detach())
            return func(*args, **(kwargs or {}))

    return Mode()


@contextlib.contextmanager
def eikonal_records(out):
    """Every NeRF.compute_eikonal call inside appends to `out` its
    per-point eikonal values (n,) and the inputs of its SDF chain's ReLUs
    (n, units), both fp64 on the CPU. A dense eikonal (comp's fields) is
    read at its drawn rays (the call's idx)."""
    import torch

    from lab4d_tpu_torch.nnutils.nerf import NeRF

    orig = NeRF.compute_eikonal

    def recorded(self, xyz, *args, **kwargs):
        rec = []
        with _relu_inputs(rec):
            eik = orig(self, xyz, *args, **kwargs)
        z = torch.cat([t.reshape(-1, t.shape[-1]) for t in rec], 1)
        vals = eik.detach()
        if self.eikonal_dense:
            vals = vals.reshape(xyz.shape[0] * xyz.shape[1], -1)[kwargs["idx"]]
        out.append({"eikonal": vals.reshape(-1).double().cpu(), "z": z.double().cpu()})
        return eik

    NeRF.compute_eikonal = recorded
    try:
        yield out
    finally:
        NeRF.compute_eikonal = orig


def _eikonal_ties(got, want, tol):
    """The eikonal term differentiates the SDF chain, whose ReLU masks it
    takes from the forward: where a ReLU input lies within rounding of
    zero the two steps may take other sides of the kink, and that point's
    eikonal value jumps (PERF.md §7). Returns (the two steps' reg_eikonal
    with the points that hold such a tie left out, a report, failures); the
    ReLU inputs must agree within tol["tie_z"] so that only inputs that
    close to zero can flip. Several records (comp: one per field, drawn at
    the same rays, so that reg_eikonal is the mean over all their points)
    are taken together."""
    import torch

    rec_g, rec_w = got["eikonal"], want["eikonal"]
    if len(rec_g) != len(rec_w) or not rec_w or \
            any(a["z"].shape != b["z"].shape for a, b in zip(rec_g, rec_w)):
        return None, "", ["the steps differ in their eikonal points"]
    eg, ew = (torch.cat([r["eikonal"] for r in recs]) for recs in (rec_g, rec_w))
    failures = []
    dz = max(float((a["z"] - b["z"]).abs().max()) / max(1.0, float(b["z"].abs().max()))
             for a, b in zip(rec_g, rec_w))
    if not dz <= tol["tie_z"]:
        failures.append(f"the eikonal term's ReLU inputs differ by {dz} > {tol['tie_z']} of max|z|")
    flips = [(a["z"] > 0) != (b["z"] > 0) for a, b in zip(rec_g, rec_w)]
    rows = torch.cat([f.any(1) for f in flips])
    zw = torch.cat([b["z"][f] for b, f in zip(rec_w, flips)])
    keep = (~rows).double()
    # reg_eikonal is a scheduled factor times the mean over the points
    adj = [s["loss"]["reg_eikonal"] * float((e * keep).sum() / keep.sum()) / float(e.mean())
           for s, e in ((got, eg), (want, ew))]
    jump = float((eg - ew).abs()[rows].max()) if rows.any() else 0.0
    z_tie = float(zw.abs().max()) if rows.any() else 0.0
    report = (f"eikonal: {int(zw.numel())} ReLU ties in {int(rows.sum())} of {rows.numel()} points "
              f"(largest |z| {z_tie:.2e}; ReLU inputs within {dz:.2e} of max|z|, tol {tol['tie_z']:g}), "
              f"max|d eikonal| {jump:.2e} on them; reg_eikonal relative error with them "
              f"{abs(got['loss']['reg_eikonal'] - want['loss']['reg_eikonal']) / abs(want['loss']['reg_eikonal']):.2e}, "
              f"without {abs(adj[0] - adj[1]) / abs(adj[1]):.2e}")
    return adj, report, failures


def _compare_steps(got, want, tol, what):
    """Two steps' loss terms (rtol) and gradients (per parameter, max|d| <=
    abs + rel * max|g_want|): (summary with the worst loss term's relative
    error and the worst gradient's share of its bound, list of failures).
    reg_eikonal is compared without the points whose ReLU masks differ
    between the steps (_eikonal_ties), where both steps carry the records
    of eikonal_records."""
    failures = []
    if sorted(got["grads"]) != sorted(want["grads"]):
        failures.append("the steps differ in which parameters get a gradient")
    loss_g, loss_w = dict(got["loss"]), dict(want["loss"])
    if "reg_eikonal" in loss_w and got.get("eikonal") and want.get("eikonal"):
        adj, report, tie_failures = _eikonal_ties(got, want, tol)
        failures += tie_failures
        if adj is not None:
            loss_g["reg_eikonal"], loss_w["reg_eikonal"] = adj
            print(f"[{what}] {report}")
    loss_errs = []
    for k, v in loss_w.items():
        err = abs(loss_g[k] - v) / max(abs(v), 1e-12)
        if not (np.isfinite(loss_g[k]) and err <= tol["loss_rtol"]):
            failures.append(f"loss {k} {loss_g[k]} vs {v}")
        loss_errs.append((err, k))
    grad_errs = []
    for n, g in want["grads"].items():
        if n in got["grads"]:
            d = float((got["grads"][n] - g).abs().max())
            bound = tol["grad_abs"] + tol["grad_rel"] * float(g.abs().max())
            if not d <= bound:
                failures.append(f"gradient of {n} differs by {d} > {bound}")
            grad_errs.append((d / bound, n))
    loss_errs.sort(reverse=True)
    grad_errs.sort(reverse=True)
    print(f"[{what}] worst loss terms (relative error): "
          + ", ".join(f"{k}={e:.2e}" for e, k in loss_errs[:4])
          + "; worst gradients (share of the bound): "
          + ", ".join(f"{n}={e:.3f}" for e, n in grad_errs[:4]))
    summary = (f"{len(loss_errs)} loss terms within rtol {tol['loss_rtol']:g} (worst "
               f"{loss_errs[0][0]:.2e}, {loss_errs[0][1]}), {len(grad_errs)} gradients within "
               f"{tol['grad_abs']:g} + {tol['grad_rel']:g} max|g| (worst {grad_errs[0][0]:.3f} of "
               f"the bound, {grad_errs[0][1]})")
    return summary, failures


def _check_steps(got, want, what):
    summary, failures = _compare_steps(got, want, TRAIN_REF_TOL, what)
    if failures:
        fail(f"{what}: " + "; ".join(failures[:4]))
    return summary


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper of the training step (K1/K2, K3f/K3b, K4f/K4b)
    replaced by its plain version, on whatever device: separates the
    kernels' error from the rest of the GPU's arithmetic."""
    from lab4d_tpu_torch.nnutils import feature
    from lab4d_tpu_torch.ops import field_kernel as FK
    from lab4d_tpu_torch.ops import mlp_kernel as K

    kept = K.fused_relu_mlp, K.fused_pe_mlp, feature.fused_nerf_heads
    K.fused_relu_mlp, K.fused_pe_mlp = K.mlp_reference, K.pe_mlp_reference
    feature.fused_nerf_heads = FK.nerf_heads_reference
    try:
        yield
    finally:
        K.fused_relu_mlp, K.fused_pe_mlp, feature.fused_nerf_heads = kept


def reference_steps(db, root, cate, geo_init_steps, eikonal_all_rays=False, batch_seed=None):
    """A small trainer of the `cate` model ("bg", the fg / skel-quad model,
    the comp model or the category model) after its prior fits with
    `geo_init_steps` geometry steps and one batch of 128 rays of 64
    samples; returns step(device): that training step's loss terms,
    gradients and eikonal records (eikonal_records) on the device, from
    the trainer's weights, with the port's own draws of step 0 (the JAX
    package's, engine/jax_streams.py; the category model's instance-code
    swaps among them). eikonal_all_rays: the eikonal term at every ray
    instead of the drawn sixteenth (a diagnostic's override). batch_seed:
    the batch drawn from that seed instead of the loader's first (whose
    worker threads share the videos' draws, so it differs from run to
    run)."""
    import torch

    from lab4d_tpu_torch.engine.trainer import Trainer
    from lab4d_tpu_torch.train import get_parser

    opts = vars(get_parser().parse_args(TRAIN_OPTS[cate] + [
        "--imgs_per_gpu", "4", "--geo_init_steps", str(geo_init_steps),
        "--num_rounds", "1", "--iters_per_round", "1", "--database_root", db,
        "--logroot", os.path.join(root, f"ref-{cate}-{geo_init_steps}"),
    ]))
    trainer = Trainer(opts)
    batch_np = (trainer.trainloader.next_batch() if batch_seed is None else
                trainer.trainloader._make_batch(np.random.default_rng(batch_seed)))
    trainer.close()
    rays = batch_np["hxy"].shape[0] * 2 * batch_np["hxy"].shape[2]
    given = ({c: {"eikonal_idx": np.arange(rays)} for c in trainer.categories}
             if eikonal_all_rays else None)

    def step(dev):
        dev = torch.device(dev)
        model = trainer.model if dev == trainer.device else copy.deepcopy(trainer.model).to(dev)
        geo = {c: {k: v.to(dev) for k, v in g.items()} for c, g in trainer.geo_for_batch().items()}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        batch["geo"] = geo
        with eikonal_records([]) as eik:
            loss, grads = _step_grads(model, batch, given)
        sync()
        return {"loss": loss, "grads": grads, "eikonal": eik}

    step.rays = rays
    return step


# geometry-init steps of the reference trainer. fg: a short fit; further
# fitted states (20-500 steps) make the fg step's GPU and CPU results
# differ beyond the bound with every kernel plain on the GPU as well
# (PERF.md §6; tools/compare_fg_step.py)
REF_GEO_STEPS = {"bg": 20, "fg": 5, "comp": 5, "category": 5}


def phase_train_reference(db, root, cate):
    """One training step of the `cate` field on the GPU (kernels) against
    the same weights, batch and random draws on the CPU (plain versions).
    For fg also against the same step on the GPU with every kernel's plain
    version, which isolates the kernels from the rest of the GPU's
    arithmetic."""
    step = reference_steps(db, root, cate, REF_GEO_STEPS[cate])
    got, want = step("cuda"), step("cpu")
    tag = "train-reference" + ("" if cate == "bg" else f"-{cate}")
    if cate in ("comp", "category"):
        need = {"reg_soft_deform", "reg_eikonal", "reg_gauss_skin", "reg_skel_prior"}
        if not all(want["loss"].get(k, 0) > 0 for k in need):
            fail(f"{tag}: a comp term is missing or zero on the CPU: "
                 + str({k: want["loss"].get(k) for k in sorted(need)}))
        if len(got["eikonal"]) != (2 if cate == "comp" else 1):
            fail(f"{tag}: {len(got['eikonal'])} eikonal records, not one per field")
    if cate != "bg":
        # the plain run's BaseMLP ReLU masks, to which the kernel run's are pinned
        masks = []
        with plain_kernels(), base_mlp_relus(masks):
            plain = step("cuda")
        pinned = {}
        with base_mlp_relus(masks, pinned):
            got_pinned = step("cuda")
        print(f"[{tag}] BaseMLP ReLU inputs of the kernel run on the other side of zero from "
              f"the plain run's, pinned to the plain run's masks: {pinned['flips']} of "
              f"{pinned['inputs']} (largest |plain input| among them {pinned['z']:.2e})")
        if pinned["flips"] and pinned["z"] > TRAIN_REF_TOL["tie_z"] * pinned["max_z"]:
            fail(f"{tag}: a pinned BaseMLP ReLU input lies {pinned['z']:.2e} from zero, beyond "
                 "rounding")
        print(f"[{tag}] {step.rays} rays x 64 samples, GPU through the kernels vs GPU through "
              "their plain versions: " + _check_steps(got_pinned, plain,
                                                      f"{tag}, kernels vs plain"))
    print(f"[{tag}] {step.rays} rays x 64 samples, GPU vs CPU: "
          + _check_steps(got, want, f"{tag}, GPU vs CPU"))


def _relu_mode(call, pinned=None):
    """A TorchFunctionMode over the ReLUs (torch.relu, F.relu) called
    while it is on: without `pinned`, append each input's mask (z > 0) to
    the list `call`; with it, apply call's masks in order in place of the
    run's own where the shapes match (z * mask: the recorded side of the
    kink, and its gradient; the ReLU still runs, for the modes outside),
    adding to pinned the inputs that flipped, of how many, the largest
    |input| among them and the largest |input|."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    class Mode(TorchFunctionMode):
        seen = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))  # the modes outside this one see the call
            if func is not torch.relu and func is not F.relu:
                return out
            z = args[0].detach()
            if pinned is None:
                call.append(z > 0)
                return out
            mask = call[self.seen] if self.seen < len(call) else None
            self.seen += 1
            if mask is None or mask.shape != z.shape:
                return out
            mask = mask.to(z.device)
            flip = mask != (z > 0)
            pinned["flips"] += int(flip.sum())
            pinned["inputs"] += z.numel()
            pinned["max_z"] = max(pinned["max_z"], float(z.abs().max()))
            if flip.any():
                pinned["z"] = max(pinned["z"], float(z[flip].abs().max()))
            return args[0] * mask.to(z.dtype)

    if pinned is not None:
        for k in ("flips", "inputs", "z", "max_z"):
            pinned.setdefault(k, 0)
    return Mode()


@contextlib.contextmanager
def base_mlp_relus(masks, pinned=None):
    """_relu_mode over each BaseMLP forward's ReLUs (its plain path, or a
    kernel's plain version; a kernel launch makes none): without `pinned`,
    append to `masks` one list of masks per forward call; with it, pin
    the k-th forward call's ReLUs to the k-th list. The category model's
    base MLPs run the plain path at per-row codes; an input within
    rounding of zero may fall on either side of the kink between two runs
    whose TimeMLPs (K3) differ by rounding."""
    from lab4d_tpu_torch.nnutils.base import BaseMLP

    orig = BaseMLP.forward
    calls = iter(masks)

    def forward(self, *args, **kwargs):
        if pinned is None:
            masks.append([])
        with _relu_mode(masks[-1] if pinned is None else next(calls, []), pinned):
            return orig(self, *args, **kwargs)

    BaseMLP.forward = forward
    try:
        yield masks
    finally:
        BaseMLP.forward = orig


def _counted():
    from lab4d_tpu_torch.ops import field_kernel as FK
    from lab4d_tpu_torch.ops import mlp_kernel as K

    return {"K3f": K.fused_relu_mlp, "K3b": K.fused_relu_mlp_backward, "K4f": K.fused_pe_mlp,
            "K4b": K.fused_pe_mlp_backward, "K1": FK.fused_nerf_heads,
            "K2": FK.fused_nerf_heads_backward}


def _kernel_counts():
    return {k: fn.launches for k, fn in _counted().items()}


def _reset_kernel_counts():
    for fn in _counted().values():
        fn.launches = 0


def phase_train(db, root, cate, calls=None, shapes=None, n_steps=TRAIN_STEPS, tag=None,
                extra=(), zero=(), out=None, trace=False):
    """The training entry at full width for the `cate` model (TRAIN_OPTS,
    then the arguments `extra`), n_steps steps; returns the launch counts
    of the whole run and of the training steps, and the median ms/step.
    calls: k3_records' TimeMLP calls, whose share of the training steps is
    printed; shapes: k3_records' K3f shapes, whose launches per training
    step are printed. The total loss must fall over the run where it has
    10 steps or more. Every kernel must launch in the training steps but
    those of `zero`, which must not (and K1 / K2 in a bg step); out["trainer"]
    receives the trainer; trace: 3 more steps traced (_trace_steps)."""
    import torch

    from lab4d_tpu_torch import train as train_cli
    from lab4d_tpu_torch.engine.trainer import Trainer

    steps, step_calls, step_shapes = {}, {}, collections.Counter()
    k4_shapes = collections.Counter()
    round_s = []
    orig = Trainer.train_one_round

    def counted_round(self, round_count):  # the launches of the training steps alone
        before, before_calls = _kernel_counts(), copy.deepcopy(calls or {})
        before_shapes = collections.Counter(shapes or {})
        t_round = time.perf_counter()
        with k4_records(k4_shapes):
            orig(self, round_count)
        round_s.append(time.perf_counter() - t_round)
        steps.update({k: v - before[k] for k, v in _kernel_counts().items()})
        step_calls.update({k: v - before_calls.get(k, collections.Counter())
                           for k, v in (calls or {}).items()})
        step_shapes.update(collections.Counter(shapes or {}) - before_shapes)

    argv = TRAIN_OPTS[cate] + ["--num_rounds", "1", "--iters_per_round", str(n_steps),
                         "--save_freq", "1", "--database_root", db,
                         "--logroot", os.path.join(root, "logdir"), *extra]
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    Trainer.train_one_round = counted_round
    t = time.time()
    try:
        trainer = train_cli.main(argv)
    finally:
        Trainer.train_one_round = orig
    sync()
    elapsed = time.time() - t
    launches = _kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if trainer.current_steps != n_steps or len(trainer.step_ms) != n_steps:
        fail(f"{cate} train: {trainer.current_steps} steps, {len(trainer.step_ms)} timed")
    if not all(p.is_cuda for p in trainer.model.parameters()):
        fail(f"{cate} train: model parameters are not all on cuda")
    totals = [ld["total"] for ld in trainer.losses]
    if not np.all(np.isfinite(totals)) or not np.all(np.isfinite(trainer.grad_norms)):
        fail(f"{cate} train: non-finite loss or grad norm: {totals} {trainer.grad_norms}")
    first, last = float(np.mean(totals[:5])), float(np.mean(totals[-5:]))
    if n_steps >= 10 and not last < first:
        fail(f"{cate} train: the total loss did not decrease: mean of the first 5 steps {first}, "
             f"of the last 5 {last}")
    tag = tag or ("train" + ("" if cate == "bg" else f"-{cate}"))
    for name, n in steps.items():
        if name in zero and n != 0:
            fail(f"{tag}: the training steps launched {name} {n} times, where it does not run")
        if name not in zero and n <= 0 and (cate != "bg" or name not in ("K1", "K2")):
            fail(f"{tag}: the training steps launched no {name} kernel")
    if cate == "bg" and not steps["K4f"] == steps["K4b"] == 4 * TRAIN_STEPS:
        fail(f"{tag}: K4f / K4b ran {steps['K4f']} / {steps['K4b']} times in {TRAIN_STEPS} steps, "
             "not 4 each per step (base, colour, visibility, visibility decay)")
    run_dir = os.path.join(root, "logdir", "%s-%s" % (trainer.opts["seqname"],
                                                      trainer.opts["logname"]))
    ckpt = os.path.join(run_dir, "ckpt_latest.flax")
    if not os.path.exists(ckpt):
        fail(f"{tag}: no checkpoint written")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "eval/psnr" in r]
    if cate != "bg" and not (evals and np.isfinite(evals[-1]["eval/psnr"])):
        fail(f"{tag}: the round's eval wrote no finite eval/psnr: {evals}")
    ms = float(np.median(trainer.step_ms[1:]))
    field = FIELD_NAMES.get(cate, f"fg / {cate} field")
    logs = ("metrics.jsonl and TensorBoard events" if trainer.log.tb is not None
            else "metrics.jsonl only (tensorboardX does not import here)")
    points = "262144 + 262144 points/step (fg + bg)" if cate == "comp" else "262144 points/step"
    print(f"[{tag}] {field}, 128 images x 2 frames x 16 px x 64 samples = {points}, "
          f"{n_steps} steps in {elapsed:.1f} s total (prior fits, geometry, checkpoint "
          f"included): {ms:.2f} ms/step (median after the first; first {trainer.step_ms[0]:.1f} ms), "
          f"peak memory {peak:.2f} GiB")
    if cate in ("bg", "fg"):
        print(f"[{tag}] with the loader (native sampler, {trainer.opts['num_workers']} threads): "
              f"{ms:.2f} ms/step (CUDA events), {1e3 * sum(round_s) / n_steps:.2f} ms/step wall "
              f"over the round; on {PREDRAWN_STEPS} batches drawn beforehand: "
              f"{_predrawn_ms(trainer):.2f} ms/step (CUDA events, median); the run wrote {logs}")
    if evals:
        print(f"[{tag}] eval at the round's start: " + " ".join(
            f"{k}={v:.4f}" for k, v in evals[-1].items() if k.startswith("eval/")))
    print(f"[{tag}] total loss {totals[0]:.5f} -> {totals[-1]:.5f} (mean of first/last 5: "
          f"{first:.5f} -> {last:.5f}); grad norm {trainer.grad_norms[0]:.4f} -> "
          f"{trainer.grad_norms[-1]:.4f} (max {max(trainer.grad_norms):.4f}); "
          f"geometry init loss {trainer.geo_init_losses[0]:.4f} -> {trainer.geo_init_losses[1]:.4f}")
    if step_shapes:
        print(f"[{tag}] K3f launches per training step by shape (rows, C_in, widths, skips: "
              "launches / step; each has its K3b in the backward): " + "; ".join(
                  f"{r}, {c}, {w[0]}x{len(w) - 1}+{w[-1]}, {list(sk)}: {n / n_steps:g}"
                  for (r, c, w, sk, _), n in sorted(step_shapes.items())))
    if k4_shapes:
        print(f"[{tag}] K4f / K4b launches per training step by shape (rows, input width, "
              "layer widths: launches / step): " + "; ".join(
                  f"{k} {r}, {c}, {'x'.join(map(str, w))}: {n / n_steps:g}"
                  for (k, r, c, w), n in sorted(k4_shapes.items())))
    if step_calls:
        print(f"[{tag}] TimeMLP backbone calls in the {n_steps} training steps (rows x calls; "
              "K3f forward, K3b backward): " + "; ".join(
                  f"{name} " + ", ".join(f"{r} x {n}" for r, n in sorted(c.items()))
                  for name, c in sorted(step_calls.items()) if c))
    print(f"[{tag}] launches in the training steps: "
          + " ".join(f"{k}={v}" for k, v in steps.items())
          + " (per step: " + " ".join(f"{k}={v / n_steps:g}" for k, v in steps.items())
          + "); in the whole run: " + " ".join(f"{k}={v}" for k, v in launches.items())
          + f"; checkpoint {os.path.getsize(ckpt)} bytes")
    if trace:
        dev, wall, idle, k3 = _trace_steps(trainer)
        print(f"[{tag}] torch.profiler over 2 more steps (pre-drawn batches): device time "
              f"{dev:.2f} ms/step of {wall:.2f} ms/step wall, idle share {idle:.3f}; K3f / K3b's "
              f"kernels (rm_*, rw_*) {k3:.2f} ms/step, {k3 / dev:.3f} of the device time")
        if trainer.model.num_inst > 1:
            fwd, both = _plain_field_ms(trainer)
            print(f"[{tag}] the fg field's heads at per-row codes (base, colour, visibility "
                  f"MLPs; sdf, rgb heads), the plain chain at {FG_PAIRS * FG_SPP} points: "
                  f"forward {fwd:.3f} ms, forward + backward {both:.3f} ms (CUDA events, "
                  "median of 5)")
    if out is not None:
        out["trainer"] = trainer
    return launches, steps, ms, step_shapes


DDP_STEPS = 10  # [ddp]: steps of each run, on one global batch


def phase_ddp(trainer, root):
    """The flagship step over ranks (parallel/dist.py) against the
    one-process step on the same global batch (128 pairs x 16 px: 262,144
    points), params and draws (torch's generators seeded alike; the draws'
    global shapes on the card), DDP_STEPS steps each, in turns: one process;
    (a) the sharded path at NCCL world size 1; (b) two ranks sharing the
    card through gloo (host copies), 64 pairs each; one process again.
    Each held to tools/ddp_step.py compare's bounds (tests/test_torch_ddp.py's)
    on its first step; ms/step (CUDA events, median after the first) and
    the gradient bytes all-reduced per step. Returns the kernels' launches
    in (a)."""
    import torch

    from lab4d_tpu_torch.engine.model import LOSS_WEIGHT_NAMES
    from lab4d_tpu_torch.parallel import dist
    from lab4d_tpu_torch.tools import ddp_step

    t = time.time()
    info, opts = trainer.data_info, trainer.opts
    batch = trainer.trainloader._make_batch(np.random.default_rng(SEED))
    path = os.path.join(root, "ddp_case.pt")
    ddp_step.save_case(
        path, info["frame_info"],
        {"field_type": "fg", "fg_motion": "skel-quad", "num_inst": 1,
         "intrinsics_init": info["intrinsics"], "rtmat_fg": info["rtmat"][info["vis_info"]["fg"]],
         "rtmat_bg": info["rtmat"][info["vis_info"]["bg"]], "train_res": opts["train_res"],
         "joint_angles_init": info.get("joint_angles"),
         "loss_weights": tuple((k, opts[k]) for k in LOSS_WEIGHT_NAMES if k in opts)},
        {k: v.detach().cpu().numpy() for k, v in trainer.model.state_dict().items()},
        batch, {c: {k: v.cpu().numpy() for k, v in g.items()}
                for c, g in trainer.geo_for_batch().items()},
        trainer.current_steps)
    case = ddp_step.load_case(path)
    npix = batch["rgb"].shape[0] * batch["rgb"].shape[2]
    one = ddp_step.run_case(case, "cuda", DDP_STEPS)
    dist.init_distributed("cuda", f"tcp://localhost:{dist.free_port()}", 1, 0)
    _reset_kernel_counts()
    try:
        nccl1 = ddp_step.run_case(case, "cuda", DDP_STEPS)
        sync()
        launches = _kernel_counts()
        backend = torch.distributed.get_backend()
    finally:
        dist.shutdown()
    gloo2 = ddp_step.run_sharded(path, 2, "cuda", backend="gloo", steps=DDP_STEPS,
                                 share_card=True)
    again = ddp_step.run_case(case, "cuda", DDP_STEPS)
    sync()
    med = lambda r: float(np.median(r["ms"][1:]))  # noqa: E731
    # the loader over ranks: each rank draws the whole global batch (the
    # draws stay the one-process order), not only its block
    from lab4d_tpu_torch.dataloader.data_utils import TrainBatchLoader

    loader_ms = {}
    for pairs in (128, 64):
        loader = TrainBatchLoader(trainer.datasets, imgs_per_batch=pairs, seed=SEED)
        rng = np.random.default_rng(SEED)
        draws_ms = []
        for _ in range(6):
            t_draw = time.perf_counter()
            loader._make_batch(rng)
            draws_ms.append(1e3 * (time.perf_counter() - t_draw))
        loader_ms[pairs] = float(np.median(draws_ms[1:]))
    lines = []
    for name, run in (("(a) NCCL world size 1", nccl1), ("(b) 2 ranks over gloo", gloo2),
                      ("one process, again", again)):
        res = ddp_step.compare(one, dict(run, checksums=run.get("checksums", [])), npix)
        if res["fails"]:
            fail(f"ddp {name} against the one-process step: {res['fails'][:5]}")
        lines.append(f"{name}: {med(run):.2f} ms/step; worst of the bounds: " + ", ".join(
            f"{k} {v:.3g}" for k, v in res["worst"].items()) + f", count flips {res['flips']}")
    if backend != "nccl" or any(launches[k] <= 0 for k in launches):
        fail(f"ddp (a): backend {backend}, launches {launches}")
    print(f"[ddp] fg / skel-quad, {batch['rgb'].shape[0]} pairs x {batch['rgb'].shape[2]} px "
          f"(262144 points) per step, {DDP_STEPS} steps per run, in turns; one process: "
          f"{med(one):.2f} ms/step; " + "; ".join(lines)
          + f"; rank 1 of (b): {float(np.median(gloo2['ms_by_rank'][1][1:])):.2f} ms/step; "
          f"gradient all-reduced per step: {gloo2['grad_bytes']} bytes (fp32, one flat buffer); "
          f"rank checksums of (b) after the last step equal; {time.time() - t:.1f} s")
    print(f"[ddp] the loader over ranks: a rank draws the global batch of 128 pairs x 16 px in "
          f"{loader_ms[128]:.2f} ms (host, one thread, median of 5), where its block of 64 pairs "
          f"alone would take {loader_ms[64]:.2f} ms")
    print("[ddp] launches in (a)'s steps: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    return launches


def _plain_field_ms(trainer, reps=5):
    """(forward ms, forward + backward ms) of the fg field's per-point
    heads where K1 / K2 would run in a single-instance step, at a step's
    points with one instance id per pair: NeRF.query_nerf (base and colour
    MLPs, sdf and rgb heads) and the visibility MLP, the plain chain with
    per-row code adds; the backward to every parameter and the points."""
    import torch

    field = trainer.model.fields.field_params["fg"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xyz = (torch.rand(FG_PAIRS, FG_SPP // 64, 64, 3, device="cuda", generator=gen) - 0.5) * 0.4
    inst = torch.randint(0, trainer.model.num_inst, (FG_PAIRS,), device="cuda", generator=gen)
    frame = torch.randint(0, trainer.data_info["frame_info"].num_frames_raw, (FG_PAIRS,),
                          device="cuda", generator=gen)
    xyz.requires_grad_(True)

    def run(backward):
        out = field.query_nerf(xyz, torch.zeros_like(xyz), frame, inst, alpha=1.0)
        vis = field.vis_mlp(xyz, inst_id=inst)
        if backward:
            (out["rgb"].sum() + out["density"].sum() + vis.sum()).backward()

    def median_ms(fn):
        times = []
        for _ in range(reps + 1):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            sync()
            times.append(s.elapsed_time(e))
        return float(np.median(times[1:]))

    fwd = median_ms(lambda: run(False))
    both = median_ms(lambda: run(True))
    field.zero_grad(set_to_none=True)
    return fwd, both


def _trace_steps(trainer, n=3):
    """(device ms/step, wall ms/step, idle share, K3's device ms/step) of
    the trainer's training step traced by torch.profiler over n - 1 steps on
    batches drawn beforehand, after one untraced step: the summed time of
    the kernels on the card against the steps' wall time; K3's: the kernels
    of csrc/fused_relu_mlp.cu's two engines (rm_*, rw_*; K3b's reduction of
    dW chunks, hm_reduce_kernel, is shared with K2 and K4b and not
    counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    geo = trainer.geo_for_batch()
    batches = []
    for _ in range(n):
        b = trainer.batch_to_device(trainer.trainloader.next_batch())
        b["geo"] = geo
        batches.append(b)
    trainer.trainloader.stop()
    trainer.train_step(batches[0], trainer.current_steps)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches[1:]:
            trainer.train_step(b, trainer.current_steps)
        sync()
        wall = (time.perf_counter() - t) * 1e3 / (n - 1)
    cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev = sum(e.device_time for e in cuda) / 1e3 / (n - 1)
    k3 = sum(e.device_time for e in cuda
             if re.search(r"(?:^|[^A-Za-z])r[mw]_\w*kernel", e.name)) / 1e3 / (n - 1)
    return dev, wall, 1 - dev / wall, k3


def _predrawn_ms(trainer, n=PREDRAWN_STEPS):
    """Median ms/step (CUDA events) of n more training steps of the trainer
    on batches drawn beforehand, after one warm-up step: the step without
    the loader, beside train_one_round's figure with it."""
    import torch

    geo = trainer.geo_for_batch()
    rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(n + 1):
        b = trainer.batch_to_device(trainer.trainloader._make_batch(rng))
        b["geo"] = geo
        batches.append(b)
    trainer.train_step(batches[0], trainer.current_steps)
    sync()
    events = []
    for b in batches[1:]:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        trainer.train_step(b, trainer.current_steps)
        e.record()
        events.append((s, e))
    sync()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


LOADER_PAIRS, LOADER_PIXELS, LOADER_BATCHES = 128, 16, 8


def _seeded_loader(db, gather, seed=SEED, seqname="smoke", pairs=LOADER_PAIRS):
    """The training loader of `seqname`'s videos at LOADER_PIXELS px per
    image, its pair draws and each video's delta and pixel draws seeded."""
    from lab4d_tpu_torch.dataloader import data_utils

    opts = dict(seqname=seqname, data_prefix="crop", train_res=64, feature_type="dinov2",
                pixels_per_image=LOADER_PIXELS, database_root=db)
    datasets = data_utils.config_to_datasets(opts)
    for i, ds in enumerate(datasets):
        ds.rng = np.random.default_rng(seed + 1 + i)
        ds.idx_sampler.rng = ds.rng
        ds.idx_sampler._refill()
    return data_utils.TrainBatchLoader(datasets, imgs_per_batch=pairs, seed=seed, gather=gather)


def phase_loader(db):
    """[loader]: the training batch of the 32-frame scene (128 pairs x 16
    px) through the native sampler against its numpy reference from the
    same seeds (every key equal), and against a second native loader of
    the same seed; ms per batch of both, in turns, in this process (one
    thread)."""
    loaders = {name: _seeded_loader(db, gather) for name, gather in (
        ("native", "native"), ("reference", "reference"), ("native-again", "native"))}
    rngs = {name: np.random.default_rng(SEED) for name in loaders}
    times = collections.defaultdict(list)
    for i in range(LOADER_BATCHES):
        batches = {}
        for name in (("native", "reference", "native-again") if i % 2 == 0
                     else ("native-again", "reference", "native")):
            t = time.perf_counter()
            batches[name] = loaders[name]._make_batch(rngs[name])
            times[name.split("-")[0]].append((time.perf_counter() - t) * 1e3)
        for other in ("reference", "native-again"):
            for k, v in batches["native"].items():
                if not np.array_equal(v, batches[other][k]):
                    fail(f"loader: the native batch's {k} differs from the {other} loader's "
                         f"(batch {i}, max abs diff {np.abs(v - batches[other][k]).max()})")
    shapes = {k: v.shape for k, v in batches["native"].items() if k in ("rgb", "feature", "hxy")}
    print(f"[loader] {LOADER_PAIRS} pairs x {LOADER_PIXELS} px of the 32-frame 64^2 scene, "
          f"{LOADER_BATCHES} batches: native (libsampler, on the "
          f"loader's thread) equals the numpy reference and a second loader of the same seed on "
          f"every key {shapes}; ms per batch (one thread, median): native "
          f"{np.median(times['native']):.3f} (min {min(times['native']):.3f}), reference "
          f"{np.median(times['reference']):.3f} (min {min(times['reference']):.3f})")
    return {k: float(np.median(v)) for k, v in times.items()}


JOINT_PRIOR_GEO_STEPS = 5
JOINT_PRIOR_DEVICES = ("cuda", "cpu")  # the fit on the card, then its reference


def joint_prior(num_frames, bones=25, seed=SEED):
    """A seeded synthetic joint-angle prior (num_frames, bones, 3): one
    sinusoid over the video per degree of freedom."""
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.05, 0.3, (1, bones, 3))
    phase = rng.uniform(0, 2 * np.pi, (1, bones, 3))
    t = np.arange(num_frames, dtype=np.float64)[:, None, None] / num_frames
    return (amp * np.sin(2 * np.pi * t + phase)).astype(np.float32)


def phase_joint_prior(db, root):
    """[joint-prior]: the trainer of `--field_type fg --fg_motion skel-quad`
    with a seeded joint-angle prior in its dataset metadata (32 frames x 25
    bones x 3) runs mlp_init's skeleton fit (init_utils.fit_until_converged
    at tol 1e-4) on the card, the articulation's TimeMLP through K3f / K3b
    at one row per frame, then the same trainer on the CPU with every
    kernel plain. Both fits must converge; the losses before the fits must
    agree to 1e-4 relative and after them to 1e-2 relative, the update
    counts within 10%, and the card's fit must launch K3f and K3b; returns
    its launches."""
    import torch

    from lab4d_tpu_torch.engine import init_utils
    from lab4d_tpu_torch.engine.trainer import Trainer
    from lab4d_tpu_torch.train import get_parser

    prior = joint_prior(32)
    fits = []
    orig = init_utils.fit_until_converged

    class PriorTrainer(Trainer):
        def define_dataset(self):
            super().define_dataset()
            self.data_info["joint_angles"] = prior

    def recorded(loss_fn, params, tol, log_name="fit", **kw):
        if log_name != "skeleton":
            return orig(loss_fn, params, tol, log_name=log_name, **kw)
        with torch.no_grad():
            before = float(loss_fn())
        _reset_kernel_counts()
        t = time.time()
        loss, iters = orig(loss_fn, params, tol, log_name=log_name, **kw)
        with torch.no_grad():
            after = float(loss_fn())
        if torch.cuda.is_available():
            sync()
        fits.append({
            "before": before, "loss": loss, "after": after, "iters": iters,
            "s": time.time() - t, "launches": _kernel_counts()})
        return loss, iters

    init_utils.fit_until_converged = recorded
    try:
        for n, dev in enumerate(JOINT_PRIOR_DEVICES):
            opts = vars(get_parser().parse_args(TRAIN_OPTS["fg"] + [
                "--logname", f"prior-{dev}", "--geo_init_steps", str(JOINT_PRIOR_GEO_STEPS),
                "--num_rounds", "1", "--iters_per_round", "1", "--device", dev,
                "--database_root", db, "--logroot", os.path.join(root, "logdir")]))
            trainer = PriorTrainer(opts)
            trainer.close()
            if len(fits) != n + 1 or trainer.skel_fit[0] != fits[n]["loss"]:
                fail(f"joint-prior: the {dev} trainer ran no skeleton fit")
    finally:
        init_utils.fit_until_converged = orig
    gpu, cpu = fits
    k3 = {k: gpu["launches"][k] for k in ("K3f", "K3b")}
    if not all(np.isfinite([gpu["after"], cpu["after"]])):
        fail(f"joint-prior: non-finite losses {gpu} {cpu}")
    if not (gpu["loss"] <= 1e-4 and cpu["loss"] <= 1e-4):
        fail(f"joint-prior: a fit did not converge to 1e-4: card {gpu['loss']}, cpu {cpu['loss']}")
    # both fits stop at 1e-4, so their ends are held relative to their size
    for key, rtol in (("before", 1e-4), ("after", 1e-2)):
        if abs(gpu[key] - cpu[key]) > rtol * max(gpu[key], cpu[key]):
            fail(f"joint-prior: the loss {key} the fit differs by more than {rtol:g} relative: "
                 f"card {gpu[key]!r}, CPU {cpu[key]!r}")
    if abs(gpu["iters"] - cpu["iters"]) > 0.1 * cpu["iters"]:
        fail(f"joint-prior: the card's fit took {gpu['iters']} updates, the CPU's {cpu['iters']}")
    if not (k3["K3f"] > 0 and k3["K3b"] > 0):
        fail(f"joint-prior: the card's fit launched K3f / K3b {k3['K3f']} / {k3['K3b']} times")
    print(f"[joint-prior] fg / skel-quad, a seeded prior of {prior.shape[0]} frames x "
          f"{prior.shape[1]} bones x 3 in the metadata; mlp_init's skeleton fit (tol 1e-4): "
          f"loss {gpu['before']!r} -> {gpu['after']!r} on the card in {gpu['iters']} updates "
          f"({gpu['s']:.1f} s), {cpu['before']!r} -> {cpu['after']!r} on the CPU with every "
          f"kernel plain in {cpu['iters']} updates ({cpu['s']:.1f} s); launches in the card's "
          "fit: " + " ".join(f"{k}={v}" for k, v in gpu["launches"].items())
          + f" (K3f / K3b {k3['K3f'] / max(gpu['iters'], 1):g} per update)")
    return gpu["launches"]


PSNR_ROUNDS, PSNR_FRAMES = 5, 81


def phase_psnr(root):
    """[psnr]: tools/compare_psnr.py's rigid protocol at seed 0 on the card,
    cut to PSNR_ROUNDS rounds: the masked-PSNR trajectory beside the JAX
    package's recorded seed-0 trajectory (psnr_compare.json) and every
    kernel's launches in the rigid training steps; returns the launches
    of the whole run."""
    from lab4d_tpu_torch.engine.trainer import Trainer
    from lab4d_tpu_torch.tools import compare_psnr as CP

    workdir = os.path.join(root, "psnr")
    t = time.time()
    db = CP.make_dataset(workdir, 64, PSNR_FRAMES)
    steps = collections.Counter()
    orig = Trainer.train_one_round

    def counted_round(self, round_count):
        before = _kernel_counts()
        orig(self, round_count)
        steps.update({k: v - before[k] for k, v in _kernel_counts().items()})

    _reset_kernel_counts()
    Trainer.train_one_round = counted_round
    try:
        traj, mesh, secs = CP.run_seed(db, workdir, SEED, PSNR_ROUNDS, 64, 20, PSNR_FRAMES,
                                       "cuda")
    finally:
        Trainer.train_one_round = orig
    sync()
    launches = _kernel_counts()
    if len(traj) != PSNR_ROUNDS or not np.all(np.isfinite(traj)):
        fail(f"psnr: the trajectory is not {PSNR_ROUNDS} finite values: {traj}")
    iters = CP.effective_iters(20, PSNR_FRAMES)
    jax_traj = CP.recorded_spread()["traj_by_seed"][str(SEED)][:PSNR_ROUNDS]
    print(f"[psnr] rigid fg, {PSNR_FRAMES} frames at 64^2, {PSNR_ROUNDS} rounds x {iters} steps of "
          f"4 pairs x 8 px, seed {SEED} ({time.time() - t:.1f} s with the scene; training and eval "
          f"{secs:.1f} s): masked PSNR by round " + ", ".join(f"{p:.4f}" for p in traj)
          + "; lab4d_tpu's recorded seed 0 (psnr_compare.json, CPU): "
          + ", ".join(f"{p:.4f}" for p in jax_traj)
          + f"; canonical mesh's mean distance from the sphere {mesh['radius_err']:.4f}, "
          f"its Chamfer distance to the GT sphere {mesh['chamfer_vs_gt']:.4f} (lab4d_tpu's "
          f"recorded {CP.recorded_chamfer():.4f} after its own 400-step protocol, not on this "
          f"card)")
    print(f"[psnr] launches in the {PSNR_ROUNDS * iters} rigid steps: "
          + " ".join(f"{k}={v}" for k, v in steps.items())
          + " (per step: " + " ".join(f"{k}={v / (PSNR_ROUNDS * iters):g}" for k, v in steps.items())
          + "); in the whole run: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    for k in ("K3f", "K3b"):
        if steps[k] <= 0:
            fail(f"psnr: the rigid steps launched no {k}")
    return launches, dict(steps)


def phase_config(db, root):
    """[config]: the train CLI refuses a bad flag at startup, as
    lab4d_tpu/config.py's get_config does, before it writes anything."""
    from lab4d_tpu_torch import train as train_cli

    logroot = os.path.join(root, "config-logdir")
    try:
        train_cli.main(TRAIN_OPTS["bg"] + ["--imgs_per_gpu", "0", "--database_root", db,
                                           "--logroot", logroot])
    except ValueError as e:
        if os.path.exists(logroot):
            fail("config: the refused run wrote its log directory")
        print(f"[config] --imgs_per_gpu 0 refused at startup: {e}")
        return
    fail("config: --imgs_per_gpu 0 was not refused")


EXPORT_GRID = 128  # export.py's default --grid_size
REANIMATE_RES = 128


def _app_opts(parser, db, root, cate, extra=()):
    """Options of an app CLI (export, reanimate) on the checkpoint that
    phase_train wrote for `cate`."""
    return vars(parser.parse_args(TRAIN_OPTS[cate][:-2] + [
        "--load_suffix", "latest", "--database_root", db,
        "--logroot", os.path.join(root, "logdir"), *extra]))


def phase_export(db, root, cate, inst_id=0):
    """export.py's functions at --grid_size 128 on the checkpoint of
    [train] / [train-fg]: the canonical mesh (SDF grid through K4f,
    marching cubes), each frame's motion (K3f) and the written files.
    The SDF grid (of instance inst_id: a category's code per row, so the
    plain chain) must be finite, and the mesh non-empty wherever the grid
    crosses the level (the bg field after 25 steps may hold none inside
    its aabb). Returns the launches of every kernel over the export."""
    import torch

    from lab4d_tpu_torch import export as E

    opts = _app_opts(E.get_parser(), db, root, cate,
                     ["--grid_size", str(EXPORT_GRID), "--inst_id", str(inst_id)])
    times, sdf_vals = {"sdf": 0.0, "mc": 0.0}, []
    orig_mc = E.marching_cubes

    def timed_mc(sdf_func, *args, **kwargs):  # marching_cubes, and the SDF grid's share
        def sdf_timed(pts):
            t = time.time()
            out = sdf_func(pts)  # a numpy array: the device work has ended
            times["sdf"] += time.time() - t
            sdf_vals.append(out)
            return out
        t = time.time()
        mesh = orig_mc(sdf_timed, *args, **kwargs)
        times["mc"] += time.time() - t
        return mesh

    _reset_kernel_counts()
    E.marching_cubes = timed_mc
    t = time.time()
    try:
        model, geo_state, data_info = E.construct_test_model(opts, torch.device("cuda"))
        t_mesh = time.time()
        meshes, motion = E.extract_motion_params(model, geo_state, opts, data_info)
        t_mesh_end = time.time()
        save_dir = E.make_save_dir(opts, sub_dir="export_%04d" % opts["inst_id"])
        E.save_motion_params(meshes, motion, save_dir)
    finally:
        E.marching_cubes = orig_mc
    sync()
    elapsed = time.time() - t
    launches = _kernel_counts()
    tag = f"export-{cate}" + (f" instance {inst_id}" if inst_id else "")
    if sorted(meshes) != sorted(geo_state) or len(sdf_vals) != len(meshes) * EXPORT_GRID**3 // 262144:
        fail(f"{tag}: exported {sorted(meshes)} from {len(sdf_vals)} SDF chunks")
    per_grid = len(sdf_vals) // len(meshes)  # marching cubes queries each field's grid in turn
    for i, c in enumerate(sorted(meshes, key=list(geo_state).index)):
        mesh = meshes[c]
        sdf = np.concatenate([v.reshape(-1) for v in sdf_vals[i * per_grid:(i + 1) * per_grid]])
        sdf = sdf - opts["level"]
        crosses = bool((sdf < 0).any() and (sdf >= 0).any())
        if sdf.size != EXPORT_GRID**3 or not np.isfinite(sdf).all():
            fail(f"{tag}: the {c} SDF grid has {sdf.size} values or non-finite ones")
        if (crosses and mesh.is_empty) or (c == "fg" and mesh.is_empty) or \
                not np.isfinite(mesh.vertices).all():
            fail(f"{tag}: the {c} canonical mesh is empty or not finite ({mesh}; SDF grid in "
                 f"[{sdf.min()}, {sdf.max()}] about the level)")
        with open(os.path.join(save_dir, f"{c}-motion.json")) as f:
            js = json.load(f)
        shapes = {k: np.asarray(v).shape for k, v in js.items()}
        if not all(np.isfinite(np.asarray(v)).all() for v in js.values()) or \
                shapes["field2cam"] != (len(motion[c]), 4, 4):
            fail(f"{tag}: {c}-motion.json has non-finite values or shapes {shapes}")
        for fid, mp in motion[c].items():
            if not np.isfinite(mp.mesh_t.vertices).all():
                fail(f"{tag}: the {c} mesh of frame {fid} is not finite")
        print(f"[{tag}] {c}: grid {EXPORT_GRID}^3, SDF about the level in [{sdf.min():.4f}, "
              f"{sdf.max():.4f}]: rest mesh {len(mesh.vertices)} vertices, "
              f"{len(mesh.faces)} faces; {len(motion[c])} frames; {c}-motion.json "
              + " ".join(f"{k}{list(v)}" for k, v in shapes.items()))
    # a category instance's SDF grid takes its code per row: the plain
    # chain, as in JAX (whose CondMLP leaves the fused kernel at per-row codes)
    per_row = model.num_inst > 1
    if (launches["K4f"] <= 0) != per_row or launches["K3f"] <= 0:
        fail(f"{tag}: the export launched K4f {launches['K4f']} / K3f {launches['K3f']} times")
    print(f"[{tag}] {elapsed:.2f} s in all: model load {t_mesh - t:.2f}, canonical mesh "
          f"{times['mc']:.2f} (SDF grid {times['sdf']:.2f}, marching cubes "
          f"{times['mc'] - times['sdf']:.2f}), per-frame motion and meshes "
          f"{t_mesh_end - t_mesh - times['mc']:.2f}, files {elapsed - (t_mesh_end - t):.2f}; "
          f"launches K3f={launches['K3f']} K4f={launches['K4f']}; "
          f"{len(os.listdir(save_dir))} files")
    return launches


def phase_reanimate(db, root, cate="fg", inst_id=0, motion_id=0):
    """reanimate.py's functions on the `cate` checkpoint (fg, comp, whose
    bg keeps its camera MLP, or the category model) with --inst_id and
    --motion_id (the export_<motion_id>/fg-motion.json of [export-<cate>]),
    its frames at 128^2 with the default top-k eval: the batch's time-t
    articulation of each frame equals get_vals(override_so3=...) of the
    json's joint angles at the instance's frames on the CPU within 1e-5.
    Returns the launches of every kernel over the render."""
    import torch

    from lab4d_tpu_torch import reanimate as RA
    from lab4d_tpu_torch.render import construct_test_model, eval_mode, render_batch

    tag = "reanimate" + ("" if cate == "fg" else f"-{cate}")
    opts = _app_opts(RA.get_parser(), db, root, cate,
                     ["--motion_id", str(motion_id), "--inst_id", str(inst_id), "--render_res",
                      str(REANIMATE_RES), "--freeze_id", "0"])
    model, geo_state, data_info = construct_test_model(opts, torch.device("cuda"))
    batch, _ = RA.construct_batch_from_opts_reanimate(opts, model, geo_state, data_info, "cuda")
    n = len(batch["frameid_sub"])
    arti_cpu = copy.deepcopy(model.fields.field_params["fg"].warp.articulation).cpu()
    geo = {c: {"aabb": torch.tensor(np.asarray(g["aabb"], np.float32), device="cuda"),
               "proxy_corners": torch.tensor(np.asarray(g["corners"], np.float32),
                                             device="cuda")} for c, g in geo_state.items()}
    err = 0.0
    with torch.no_grad():
        for i in range(n):
            sub = {k: ({k2: v2[i:i + 1] for k2, v2 in v.items()} if isinstance(v, dict)
                       else v[i:i + 1]) for k, v in batch.items()}
            sub["geo"] = geo
            got = model.prepare_eval_samples(sub)["fg"]["t_articulation"]
            fid = sub["frameid_sub"].cpu() + int(data_info["frame_info"].frame_offset_raw[inst_id])
            want = arti_cpu.get_vals(fid, override_so3=sub["joint_so3"].cpu())
            err = max(err, *(float((a.cpu() - b).abs().max()) for a, b in zip(got, want)))
    if not err <= 1e-5:
        fail(f"{tag}: t_articulation differs from get_vals(override_so3) by {err} > 1e-5")
    topk, channels = eval_mode(opts)
    render_batch(model, {k: ({k2: v2[:1] for k2, v2 in v.items()} if isinstance(v, dict)
                             else v[:1]) for k, v in batch.items()}, geo_state, topk=topk)  # warm-up
    sync()
    _reset_kernel_counts()
    t = time.time()
    rendered = render_batch(model, batch, geo_state, topk=topk, channels=channels)
    sync()
    elapsed = time.time() - t
    launches = _kernel_counts()
    for k, v in rendered.items():
        if v.shape[:3] != (n, REANIMATE_RES, REANIMATE_RES) or not np.isfinite(v).all():
            fail(f"{tag}: channel {k} has shape {v.shape} or non-finite values")
    if launches["K3f"] <= 0:
        fail(f"{tag}: the render ran no fused_relu_mlp kernel")
    print(f"[{tag}] motion {motion_id} on instance {inst_id} of the {cate} model: {n} frames at "
          f"{REANIMATE_RES}^2, top-{topk} "
          f"eval, {elapsed / n * 1e3:.1f} ms/frame; t_articulation vs get_vals(override_so3) on "
          f"the CPU {err:.1e} (<=1e-5); launches "
          + " ".join(f"{k}={v}" for k, v in launches.items())
          + f"; mask mean {rendered['mask'].mean():.4f}")
    return launches


def phase_render_category(db, root):
    """[render-category]: the category checkpoint of [train-category]
    through the render CLI's functions (--nosingle_inst: one code per
    video): one 512^2 reference frame of instance 0 and one of instance 5,
    the top-k eval (K = 8). Each instance must render its object (mask
    above 0.01 somewhere). Returns the launches of both."""
    import torch

    from lab4d_tpu_torch.render import construct_test_model, get_parser

    opts = _app_opts(get_parser(), db, root, "category")
    model, geo_state, data_info = construct_test_model(opts, torch.device("cuda"))
    codes = model.fields.field_params["fg"].basefield.inst_embedding.num_inst
    if codes != CATEGORY_VIDS:
        fail(f"render-category: the test-time model has {codes} instance codes")
    total = collections.Counter()
    for inst in (0, 5):
        launches, frames, _ = phase_render(model, geo_state, data_info, "render-category",
                                           topk=8, n_frames=1, inst_id=inst)
        if not float(frames["mask"].max()) > 0.01:
            fail(f"render-category: instance {inst} renders nothing (mask max "
                 f"{float(frames['mask'].max())})")
        total.update(launches)
    return dict(total)


def _category_ckpt(root):
    return os.path.join(root, "logdir", "cate-category", "ckpt_latest.flax")


def phase_transfer(db, root, shapes):
    """[transfer]: the train CLI on the one-video scene from [train-category]'s
    checkpoint (--load_path) with --freeze_bone_len, TRANSFER_STEPS steps,
    as the category tutorial's second step: the model written before the
    steps holds the category's per-video tables as their mean, Adam starts
    afresh (the tables' shapes differ), the bone lengths are the same after
    the steps, and the single-instance step runs its heads through K1 / K2.
    Returns the launches of the run and of its steps."""
    import torch

    from lab4d_tpu_torch import bridge
    from lab4d_tpu_torch.engine.trainer import PER_VIDEO_TABLES

    out = {}
    launches, steps, _, _ = phase_train(
        db, root, "transfer", shapes=shapes, n_steps=TRANSFER_STEPS, out=out, trace=True,
        extra=["--load_path", _category_ckpt(root), "--geo_init_steps", str(LOAD_GEO_STEPS)])
    trainer = out["trainer"]
    cate = bridge.params_from_flax(bridge.load_flax_checkpoint(_category_ckpt(root))["model"])
    first = bridge.params_from_flax(bridge.load_flax_checkpoint(
        os.path.join(trainer.save_dir, "ckpt_0000.flax"))["model"])
    tables = [k for k in cate if any(t in k for t in PER_VIDEO_TABLES)]
    err = max(float((first[k] - torch.from_numpy(cate[k].numpy().mean(0, keepdims=True)))
                    .abs().max()) for k in tables)
    if not (tables and err == 0.0) or any(first[k].shape[0] != 1 for k in tables):
        fail(f"transfer: the loaded per-video tables differ from the category mean by {err}")
    if trainer.opt_restored:
        fail("transfer: Adam was restored across another video count")
    bones = [k for k in first if "log_bone_len" in k]
    state = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    moved = max(float((state[k] - first[k]).abs().max()) for k in bones)
    if not (bones and moved == 0.0):
        fail(f"transfer: --freeze_bone_len let the bone lengths move by {moved}")
    print(f"[transfer] from the {CATEGORY_VIDS}-video category checkpoint into a one-video "
          f"capture: {len(tables)} per-video tables loaded as the category mean (max abs diff "
          f"{err:g}: {', '.join(sorted({k.split('.')[-2] for k in tables}))}); Adam reset (the "
          f"tables' shapes differ: opt_restored={trainer.opt_restored}); {len(bones)} bone-length "
          f"parameters unchanged after {TRANSFER_STEPS} steps (max abs diff {moved:g}); K1 / K2 "
          f"launches per step {steps['K1'] / TRANSFER_STEPS:g} / {steps['K2'] / TRANSFER_STEPS:g}")
    return launches, steps


def phase_resume(db, root):
    """[resume]: [train-category]'s checkpoint into the same architecture
    with --noreset_steps: the Adam moments and count restored equal the
    saved ones (max abs diff 0), and the step count continues through
    RESUME_STEPS more steps of a round. Returns the launches of the round."""
    import torch

    from lab4d_tpu_torch import bridge
    from lab4d_tpu_torch.engine.trainer import Trainer
    from lab4d_tpu_torch.train import get_parser

    path = _category_ckpt(root)
    ckpt = bridge.load_flax_checkpoint(path)
    opts = vars(get_parser().parse_args(TRAIN_OPTS["category"] + [
        "--logname", "resume", "--load_path", path, "--no-reset_steps", "--num_rounds", "1",
        "--iters_per_round", str(RESUME_STEPS), "--save_freq", "1",
        "--geo_init_steps", str(LOAD_GEO_STEPS), "--database_root", db,
        "--logroot", os.path.join(root, "logdir")]))
    trainer = Trainer(opts)
    count, moments = bridge.opt_state_from_optax(ckpt["opt_state"])
    if not trainer.opt_restored or trainer.current_steps != int(ckpt["current_steps"]):
        fail(f"resume: Adam restored {trainer.opt_restored}, step {trainer.current_steps}")
    err = 0.0
    for name, p in zip(trainer.param_names, trainer.params):
        st = trainer.optimizer.state[p]
        err = max(err, abs(float(st["step"]) - count),
                  *(float((st[k].cpu() - torch.from_numpy(np.array(m))).abs().max())
                    for k, m in zip(("exp_avg", "exp_avg_sq"), moments[name])))
    if err != 0.0:
        fail(f"resume: the restored Adam state differs from the saved one by {err}")
    start = trainer.current_steps
    _reset_kernel_counts()
    try:
        trainer.train()
    finally:
        trainer.close()
    sync()
    launches = _kernel_counts()
    totals = [ld["total"] for ld in trainer.losses]
    if trainer.current_steps != start + RESUME_STEPS or not np.all(np.isfinite(totals)):
        fail(f"resume: {trainer.current_steps} steps after {start}, losses {totals}")
    print(f"[resume] {path.split(os.sep)[-2]}/ckpt_latest.flax into the same model with "
          f"--noreset_steps: {len(moments)} parameters' Adam moments (count {count}) equal the "
          f"saved ones (max abs diff {err:g}); steps {start} -> {trainer.current_steps}, loss "
          f"{totals[0]:.5f} -> {totals[-1]:.5f}; launches "
          + " ".join(f"{k}={v}" for k, v in launches.items()))
    return launches


# the preprocessing phases: one raw video of PRE_FRAMES frames at PRE_RES^2,
# the orbit turning PRE_DEG_PER_FRAME between frames (enough motion that
# the frame filter, median flow > 5% of 160 px, keeps them)
PRE_FRAMES, PRE_RES, PRE_DEG_PER_FRAME = 64, 512, 12.0
PRE_NEURAL = {"segmentation": "unet", "flow": "raft", "depth": "unet", "viewpoint": "net",
              "features": "net"}
PRE_NET_TOL = 1e-4  # GPU vs CPU, of the output's largest magnitude (fp32, no TF32)
PRE_EPE_TOL = 1e-2  # px, mean endpoint error of the LK flow
PRE_TSDF_TOL = 1e-5
PRE_ROT_TOL_DEG = 0.05
PRE_FIT_LOSS_RTOL = 0.10  # the chaotic full-length fit: twice JAX's own spread (5%)
PRE_FEAT_TOL = 1e-5  # the filter bank, of its largest response


def phase_preprocess(root):
    """[preprocess]: the port's preprocessing entry point
    (lab4d_tpu_torch.preprocess.run's main, as `python -m
    lab4d_tpu_torch.preprocess.run smokevid "" quad 0` runs it) on one raw
    video written in-process (tools/synthetic_scene.write_raw_video):
    frames, filter, segmentation, flow at deltas 1, 2, 4, 8, depth, crops,
    camera registration, TSDF fusion, canonical registration, features.
    Fails unless every stage ran its neural backend. Prints seconds per
    stage and per frame, each worker's peak device memory, and one batch
    of the port's loader from the output; returns the database root."""
    from lab4d_tpu_torch.dataloader.data_utils import TrainBatchLoader, config_to_datasets
    from lab4d_tpu_torch.preprocess import run as pre_run
    from lab4d_tpu_torch.tools.synthetic_scene import write_raw_video

    db = os.path.join(root, "preprocess", "database")
    t = time.time()
    write_raw_video(db, "smokevid", num_frames=PRE_FRAMES, res=PRE_RES,
                    orbit_span=PRE_FRAMES * PRE_DEG_PER_FRAME / 360.0, lead_black=1)
    print(f"[preprocess] raw video: 1 black + {PRE_FRAMES} frames at {PRE_RES}^2 (MJPEG), "
          f"written in {time.time() - t:.1f} s")
    t = time.time()
    out = pre_run.main(["smokevid", "", "quad", "0", "--database_root", db])
    wall = time.time() - t
    (seq,) = out["seqnames"]
    rec = out["workers"][seq]
    backends = {**rec["segmentation"]["backends"], **rec["priors"]["backends"],
                **out["features"]["backends"]}
    print("[preprocess] backends: " + ", ".join(f"{k} {v}" for k, v in backends.items()))
    for stage, want in PRE_NEURAL.items():
        if backends.get(stage) != want:
            fail(f"preprocess: {stage} ran the {backends.get(stage)!r} backend, not {want!r}")
    proc = f"{db}/processed"
    n = len(glob.glob(f"{proc}/JPEGImages/Full-Resolution/{seq}/*.jpg"))
    if n < 8:
        fail(f"preprocess: the frame filter kept {n} frames")
    seconds = {}
    for part in ("frames", "segmentation", "priors"):
        seconds.update(rec[part]["seconds"])
    seconds.update(out["features"]["seconds"])
    print(f"[preprocess] {n} of {PRE_FRAMES} frames kept; seconds per stage (per frame, ms): "
          + ", ".join(f"{k} {v:.2f} ({1e3 * v / n:.1f})" for k, v in seconds.items())
          + f"; the stages {sum(seconds.values()):.1f} s, the run {wall:.1f} s with its two "
          f"worker processes' start")
    peaks = {part: rec[part]["peak_bytes"] for part in ("frames", "segmentation", "priors")}
    peaks["features"] = out["features"]["peak_bytes"]
    if None in peaks.values():
        fail(f"preprocess: a worker ran off the card: {peaks}")
    print("[preprocess] peak device memory (GiB): " + ", ".join(
        f"{k} {v / 2**30:.3f}" for k, v in peaks.items()))
    opts = {"seqname": "smokevid", "database_root": db, "data_prefix": "crop", "train_res": 256,
            "feature_type": "dinov2", "pixels_per_image": 16}
    loader = TrainBatchLoader(config_to_datasets(opts), imgs_per_batch=8, num_workers=1)
    try:
        batch = loader.next_batch()
    finally:
        loader.stop()
    for key in ("rgb", "mask", "depth", "flow", "feature"):
        if key not in batch or not np.isfinite(np.asarray(batch[key], np.float32)).all():
            fail(f"preprocess: the loader's batch has no finite {key}")
    print("[preprocess] the port's loader on the output: one batch of 8 pairs x 16 px, "
          + ", ".join(f"{k} {tuple(batch[k].shape)}" for k in ("rgb", "depth", "flow", "feature")))
    return db, seq


def phase_stage_clis(root, db, seq, card, device=None):
    """[preprocess], its stage CLIs: the depth and segmentation CLIs (`python -m
    lab4d_tpu_torch.preprocess.scripts.depth <seq>`, and `... .segmentation
    <seq>`) as subprocesses on a copy of [preprocess]'s frames, from a
    directory whose database/processed is the copy (their default outdir),
    on the card unless `device` is given. Their Depth/ and Annotations/
    frames are held against the pipeline's within [preprocess-reference]'s
    bound: depth within PRE_NET_TOL of its largest value plus one
    half-precision ulp of each stored value; a mask pixel may differ only
    where the segmentation net's probability on the card lies within
    PRE_NET_TOL of the 0.5 cut. Prints each CLI's seconds (its process
    start included)."""
    import shutil

    import cv2

    from lab4d_tpu_torch.preprocess.backends.seg_unet import segment_probs

    cwd = os.path.join(root, "stage_clis")
    frames_dir = f"{cwd}/database/processed/JPEGImages/Full-Resolution/{seq}"
    os.makedirs(frames_dir)
    for path in sorted(glob.glob(f"{db}/processed/JPEGImages/Full-Resolution/{seq}/*.jpg")):
        shutil.copy(path, frames_dir)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    seconds = {}
    for cli in ("depth", "segmentation"):
        cmd = [sys.executable, "-m", f"lab4d_tpu_torch.preprocess.scripts.{cli}", seq]
        cmd += ["--device", device] if device else []
        t = time.time()
        proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True,
                              timeout=600)
        seconds[cli] = time.time() - t
        if proc.returncode != 0:
            fail(f"preprocess stage CLIs: {' '.join(cmd[1:])} exited {proc.returncode}: "
                 f"{proc.stderr.strip()[-2000:]}")

    def frames(base, sub):
        return sorted(glob.glob(f"{base}/processed/{sub}/Full-Resolution/{seq}/0*.npy"))

    want, got = frames(db, "Depth"), frames(f"{cwd}/database", "Depth")
    if not want or len(want) != len(got):
        fail(f"preprocess stage CLIs: depth wrote {len(got)} frames, the pipeline "
             f"{len(want)}")
    depth_err, scale = 0.0, 0.0
    for a, b in zip(want, got):
        w, g = np.load(a).astype(np.float64), np.load(b).astype(np.float64)
        if g.shape != w.shape:
            fail(f"preprocess stage CLIs: depth {os.path.basename(b)} {g.shape} vs {w.shape}")
        scale = max(scale, float(np.abs(w).max()))
        depth_err = max(depth_err, float(np.max(np.abs(g - w) - 2.0**-10 * np.abs(w))))
    if not depth_err <= PRE_NET_TOL * scale:
        fail(f"preprocess stage CLIs: depth {depth_err} beyond one fp16 ulp > {PRE_NET_TOL} x "
             f"{scale}")
    want, got = frames(db, "Annotations"), frames(f"{cwd}/database", "Annotations")
    if not want or len(want) != len(got):
        fail(f"preprocess stage CLIs: segmentation wrote {len(got)} frames, the pipeline "
             f"{len(want)}")
    differ = [i for i, (a, b) in enumerate(zip(want, got))
              if not np.array_equal(np.load(a), np.load(b))]
    tie = 0.0
    if differ:
        imgs = [cv2.imread(p)[..., ::-1] for p in sorted(glob.glob(f"{frames_dir}/*.jpg"))]
        # every frame, as the stage runs them: each is conditioned on the last
        probs = list(segment_probs(imgs, device=device or "cuda"))
        for i in differ:
            flip = np.load(want[i]) != np.load(got[i])
            h, w = flip.shape
            prob = cv2.resize(probs[i], (w, h), interpolation=cv2.INTER_NEAREST)
            tie = max(tie, float(np.abs(prob[flip] - 0.5).max()))
        if not tie <= PRE_NET_TOL:
            fail(f"preprocess stage CLIs: a mask pixel differs {tie} from the 0.5 cut > "
                 f"{PRE_NET_TOL}")
    print(f"[preprocess] the depth and segmentation stage CLIs on a copy of the pipeline's "
          f"{len(want)} frames ({card}): depth {seconds['depth']:.2f} s, segmentation "
          f"{seconds['segmentation']:.2f} s (each with its process start); depth vs the "
          f"pipeline: max abs err beyond one fp16 ulp {depth_err:.3g} (tol {PRE_NET_TOL:g} x "
          f"max {scale:.4g}); masks: {len(differ)} of {len(want)} frames differ, farthest "
          f"differing pixel {tie:.3g} from the 0.5 cut (tol {PRE_NET_TOL:g})")
    return seconds


def _pre_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def phase_preprocess_reference(db, seq):
    """[preprocess-reference]: on the first 2 frames of [preprocess]'s
    output, each net, the LK flow, the filter bank, and one TSDF
    integration at the 128^3 grid on the card against the port on the
    CPU; the canonical rotation fit on tools/synthetic_scene.py's
    rotation_fit_inputs (as tests/test_torch_preprocess_classical.py).
    Each check prints its tolerance."""
    import cv2
    import torch

    from lab4d_tpu_torch.preprocess.backends import (depth_unet, feat_backends, feat_net,
                                                     flow_classical, flow_raft, seg_unet,
                                                     viewpoint_net)
    from lab4d_tpu_torch.preprocess.libs.registration import (fit_canonical_rotations, fit_loss,
                                                               rotation_gap_deg)
    from lab4d_tpu_torch.preprocess.scripts.tsdf_fusion import integrate
    from lab4d_tpu_torch.tools.synthetic_scene import (raw_orbit, render_raw_frame,
                                                       rotation_fit_inputs)

    t = time.time()
    paths = sorted(glob.glob(f"{db}/processed/JPEGImages/Full-Resolution/{seq}/*.jpg"))[:2]
    frames = [cv2.imread(p)[..., ::-1] for p in paths]
    masks = [np.load(p.replace("JPEGImages", "Annotations").replace(".jpg", ".npy"))
             for p in paths]
    crops = np.stack([viewpoint_net.crop_masked(f, m) for f, m in zip(frames, masks)])
    crops256 = [cv2.resize(f, (256, 256)) for f in frames]

    def nets(dev):
        out = {}
        fw, bw = flow_raft.compute_flows(frames[:1], frames[1:], device=dev)
        out["flow_raft"] = np.concatenate([fw, bw])
        out["seg_unet"] = np.stack(list(seg_unet.segment_probs(frames, device=dev)))
        out["depth_unet"] = np.stack(depth_unet.depth_video_unet(frames, device=dev))
        out["feat_net"] = feat_net.frames_features_net(crops256, device=dev).cpu().numpy()
        model = viewpoint_net.load_model("quad", device=dev)
        with torch.no_grad():
            out["viewpoint_net"] = model(
                torch.from_numpy(crops).permute(0, 3, 1, 2).to(dev)).cpu().numpy()
        return out

    got, want = nets("cuda"), nets("cpu")
    for name in got:
        err, scale = _pre_err(got[name], want[name])
        print(f"[preprocess-reference] {name} on 2 frames, GPU vs CPU: max abs err {err:.3g} "
              f"(tol {PRE_NET_TOL:g} x max |out| {scale:.4g})")
        if not err <= PRE_NET_TOL * scale:
            fail(f"preprocess-reference: {name} GPU vs CPU {err} > {PRE_NET_TOL} x {scale}")

    lk = {dev: flow_classical.compute_flows(frames[:1], frames[1:], device=dev)
          for dev in ("cuda", "cpu")}
    for i, direction in enumerate(("fw", "bw")):
        epe = np.linalg.norm(lk["cuda"][i][..., :2] - lk["cpu"][i][..., :2], axis=-1)
        print(f"[preprocess-reference] LK flow {direction} at 288^2, GPU vs CPU: mean endpoint "
              f"error {epe.mean():.3g} px (tol {PRE_EPE_TOL:g}), max {epe.max():.3g}")
        if not epe.mean() <= PRE_EPE_TOL:
            fail(f"preprocess-reference: LK flow {direction} mean EPE {epe.mean()}")

    fb = {}
    for dev in ("cuda", "cpu"):
        with torch.no_grad():
            x = torch.from_numpy(np.stack(crops256) / np.float32(255.0)).permute(0, 3, 1, 2)
            fb[dev] = feat_backends.filterbank_features(x.to(dev)).cpu().numpy()
    err, scale = _pre_err(fb["cuda"], fb["cpu"])
    print(f"[preprocess-reference] filter bank on 2 256^2 crops, GPU vs CPU: max abs err "
          f"{err:.3g} (tol {PRE_FEAT_TOL:g} x {scale:.4g})")
    if not err <= PRE_FEAT_TOL * scale:
        fail(f"preprocess-reference: filter bank {err}")

    # TSDF: 2 frames of the raw orbit's depth at 512^2 into 128^3 voxels
    K, rts = raw_orbit(PRE_FRAMES, PRE_RES, PRE_FRAMES * PRE_DEG_PER_FRAME / 360.0)
    depths = np.stack([render_raw_frame(rts[i], K, PRE_RES)[2] for i in (0, 1)])
    Ks = np.tile(K.astype(np.float32), (2, 1))
    s2c = rts[:2].astype(np.float32)
    ax = np.linspace(-6.5, 6.5, 128)
    vox = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    trunc = float(np.float32(5 * 13.0 / 127))
    ts = {}
    for dev in ("cuda", "cpu"):
        with torch.no_grad():
            tt, ww = integrate(torch.ones(len(vox), device=dev), torch.zeros(len(vox), device=dev),
                               torch.from_numpy(vox).to(dev), torch.from_numpy(depths).to(dev),
                               torch.from_numpy(Ks).to(dev), torch.from_numpy(s2c).to(dev), trunc)
        ts[dev] = (tt.cpu().numpy(), ww.cpu().numpy())
    p = vox.astype(np.float64) @ np.swapaxes(s2c[:, :3, :3], -1, -2).astype(np.float64)
    p = p + s2c[:, None, :3, 3]
    uv = Ks[:, None, :2] * p[..., :2] / np.maximum(p[..., 2:], 1e-6) + Ks[:, None, 2:]
    tie = (np.abs(uv - np.floor(uv) - 0.5) < 1e-4).any(-1).any(0)
    ok = ~tie
    w_diff = int((ts["cuda"][1][ok] != ts["cpu"][1][ok]).sum())
    err = float(np.abs(ts["cuda"][0][ok] - ts["cpu"][0][ok]).max())
    print(f"[preprocess-reference] TSDF, 2 frames into 128^3 voxels, GPU vs CPU: max abs err "
          f"{err:.3g} (tol {PRE_TSDF_TOL:g}) and {w_diff} weights apart, outside "
          f"{int(tie.sum())} voxels within 1e-4 px of a pixel boundary; "
          f"{int((ts['cpu'][1] > 0).sum())} voxels observed")
    if w_diff or not err <= PRE_TSDF_TOL:
        fail(f"preprocess-reference: TSDF err {err}, {w_diff} weights apart")

    for kind, iters in (("consistent", 2000), ("inconsistent", 20), ("inconsistent", 2000)):
        chain, ann = rotation_fit_inputs(kind)
        fits = {dev: fit_canonical_rotations(chain, ann, max_iters=iters, device=dev)
                for dev in ("cuda", "cpu")}
        gap = float(rotation_gap_deg(fits["cuda"][0], fits["cpu"][0]).max())
        if iters == 20 or kind == "consistent":
            print(f"[preprocess-reference] rotation fit, {kind} input, {iters} iterations per "
                  f"phase: stopping iterations GPU {fits['cuda'][1]} CPU {fits['cpu'][1]}; "
                  f"rotations {gap:.4f} deg apart (tol {PRE_ROT_TOL_DEG:g})")
            if fits["cuda"][1] != fits["cpu"][1] or not gap <= PRE_ROT_TOL_DEG:
                fail(f"preprocess-reference: rotation fit ({kind}, {iters}) {gap} deg")
        else:  # the chaotic full-length fit: held to the loss it reaches
            lg, lc = fit_loss(fits["cuda"][0], chain, ann), fit_loss(fits["cpu"][0], chain, ann)
            print(f"[preprocess-reference] rotation fit, {kind} input, full length: stopping "
                  f"iterations GPU {fits['cuda'][1]} CPU {fits['cpu'][1]}; final loss GPU "
                  f"{lg:.5f} CPU {lc:.5f} (tol {PRE_FIT_LOSS_RTOL:g} relative); rotations "
                  f"{gap:.3f} deg apart (the fit runs at its loss floor, where the end point "
                  f"is chaotic)")
            if not abs(lg - lc) <= PRE_FIT_LOSS_RTOL * lc:
                fail(f"preprocess-reference: full rotation fit loss {lg} vs {lc}")
    print(f"[preprocess-reference] {time.time() - t:.1f} s")


# [train-nets]: the five preprocessing-net trainers (lab4d_tpu_torch/scripts/
# train_*.py) at their default resolution and batch, NET_STEPS steps each
# (cut from their 1,500 / 1,200; the pool is min(96, steps) batches)
NET_TRAINERS = {  # name: (main's size arguments, the weights file, its backend module)
    "flow_raft": ({"res": 128, "batch": 4}, "flow_raft"),
    "seg_unet": ({"res": 128, "batch": 4}, "seg_unet"),
    "depth_unet": ({"res": 128, "batch": 4}, "depth_unet"),
    "feat_net": ({"batch": 4}, "feat_net"),
    "viewpoint": ({"batch": 16}, "viewpoint_net"),
}
NET_STEPS, NET_LOG_EVERY = 40, 10
NET_REF_STEPS = 3  # [train-nets-reference]: updates on the card and on the CPU
# grads: of each leaf's max|g_cpu|; close_share: of the parameters within 1e-5
NET_REF_TOL = {"loss_rtol": 1e-5, "grad_rel": 1e-4, "close_share": 0.999, "tie_z": 1e-4}
# [adversarial]: lab4d_tpu_torch/scripts/validate_adversarial.py, cut from
# 64 frames at 256^2, 20 rounds x 200 steps
ADV_ARGS = ["--frames", "16", "--res", "128", "--rounds", "1", "--iters_per_round", "50",
            "--geo_init_steps", "100"]
# [tools]: run_rendering_parallel's 8 renders as four workers sharing the
# card (each render process takes ~13 s to start and render; in turns on
# one worker 105.5 s)
TOOLS_DEVLIST = [0, 0, 0, 0]


def _net_module(name):
    return importlib.import_module(f"lab4d_tpu_torch.scripts.train_{name}")


def _weights_digest():
    """{file: bytes} of database/weights/, which no phase may write."""
    here = os.path.dirname(os.path.abspath(__file__))
    return {p: open(p, "rb").read() for p in sorted(glob.glob(f"{here}/database/weights/*"))}


def phase_train_nets(root):
    """[train-nets]: each trainer's main on the card (NET_STEPS steps, the
    weights into `root`): pool seconds, ms/step (CUDA events, median),
    peak device memory, first and last logged loss, the held-out line.
    Fails on a non-finite loss, a step off the card, or a written file the
    port's load_model cannot read."""
    import torch

    for name, (kw, backend) in NET_TRAINERS.items():
        mod = _net_module(name)
        out_path = os.path.join(root, "weights", f"{backend}.msgpack")
        stats = {}
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t = time.time()
        with contextlib.redirect_stdout(buf):
            mod.main(steps=NET_STEPS, out_path=out_path, log_every=NET_LOG_EVERY, stats=stats,
                     **kw)
        wall = time.time() - t
        log = buf.getvalue()
        losses = [v for _, v in stats["logged"]]
        if not np.all(np.isfinite(losses)):
            fail(f"train-nets {name}: non-finite loss {losses}")
        if len(stats["step_ms"]) != NET_STEPS:
            fail(f"train-nets {name}: {len(stats['step_ms'])} of {NET_STEPS} steps on the card")
        loader = importlib.import_module(f"lab4d_tpu_torch.preprocess.backends.{backend}")
        if loader.load_model(path=out_path) is None:
            fail(f"train-nets {name}: load_model cannot read {out_path}")
        held = [ln for ln in log.splitlines() if ln.startswith("held-out")]
        params = [ln for ln in log.splitlines() if ln.startswith("params:")]
        print(f"[train-nets] {name} ({', '.join(f'{k} {v}' for k, v in kw.items())}), "
              f"{params[0]}, {NET_STEPS} steps: pool of {min(96, NET_STEPS)} batches "
              f"{stats['pool_s']:.2f} s, {float(np.median(stats['step_ms'])):.2f} ms/step "
              f"(median; mean {float(np.mean(stats['step_ms'])):.2f}), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, wall {wall:.1f} s; {held[0]}")


def phase_train_nets_reference():
    """[train-nets-reference]: each trainer from flax's init (PRNGKey(SEED),
    make_model) on one batch, through its own `train` on the CPU and on the
    card (TF32 off): one update for the first loss (1e-5 relative) and its
    gradients as the chain takes them (1e-4 of each leaf's max|g|), the
    card's ReLU masks pinned to the CPU's (_relu_mode; the count printed:
    at flax's zero biases an input within rounding of zero takes either
    side of the kink on the two devices, and the flipped inputs must lie
    within NET_REF_TOL["tie_z"] of the largest), then NET_REF_STEPS
    updates from the init for the parameters, within the sign-flip bound
    2 * sum(lr) + 1e-6 (Adam's first updates are ~lr * sign(g)) and with
    at least NET_REF_TOL["close_share"] of the elements within 1e-5."""
    import torch

    from lab4d_tpu_torch.scripts.optim import warmup_cosine

    for name, (kw, _) in NET_TRAINERS.items():
        mod = _net_module(name)
        rng = np.random.default_rng(SEED)
        size = (kw["res"],) if "res" in kw else ()
        batch = mod.make_batch(rng, kw["batch"], *size)
        init = mod.make_model(SEED).train()
        runs, masks, pinned = {}, [], {}
        for dev in ("cpu", "cuda"):
            pool = [tuple(torch.from_numpy(x).to(dev) for x in batch)]
            first, model = copy.deepcopy(init).to(dev), copy.deepcopy(init).to(dev)
            with contextlib.redirect_stdout(io.StringIO()):
                with _relu_mode(masks, pinned if dev == "cuda" else None):
                    (_, loss), = mod.train(first, pool, 1, log_every=1)
                mod.train(model, pool, NET_REF_STEPS, log_every=1)
            runs[dev] = (loss, {k: p.grad.detach().cpu() for k, p in first.named_parameters()},
                         {k: v.detach().cpu() for k, v in model.state_dict().items()})
        (lg, gg, pg), (lc, gc, pc) = runs["cuda"], runs["cpu"]
        loss_err = abs(lg - lc) / abs(lc)
        leaf_errs = {k: float((gg[k] - gc[k]).abs().max() / gc[k].abs().max().clamp(min=1e-30))
                     for k in gc}
        worst = max(leaf_errs, key=leaf_errs.get)
        grad_err = leaf_errs[worst]
        sched = warmup_cosine(mod.PEAK_LR, NET_REF_STEPS)
        bound = 2 * sum(sched(k) for k in range(NET_REF_STEPS)) + 1e-6
        param_err = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
        close = sum(int(((pg[k] - pc[k]).abs() <= 1e-5).sum()) for k in pc) / sum(
            v.numel() for v in pc.values())
        print(f"[train-nets-reference] {name}: first loss GPU {lg:.6f} vs CPU {lc:.6f} (rel "
              f"{loss_err:.2e}, tol {NET_REF_TOL['loss_rtol']:g}), gradients worst leaf "
              f"({worst}) {grad_err:.2e} of its max (tol {NET_REF_TOL['grad_rel']:g}), "
              f"parameters after {NET_REF_STEPS} updates max |d| {param_err:.2e} (bound "
              f"{bound:.2e}), {100 * close:.3f}% within 1e-5 (tol "
              f"{100 * NET_REF_TOL['close_share']:g}%); ReLU inputs pinned to the CPU's side "
              f"{pinned['flips']} of {pinned['inputs']} (largest |input| {pinned['z']:.2e}, "
              f"of max {pinned['max_z']:.2e})")
        ties_ok = pinned["z"] <= NET_REF_TOL["tie_z"] * pinned["max_z"]
        if not (loss_err <= NET_REF_TOL["loss_rtol"] and grad_err <= NET_REF_TOL["grad_rel"]
                and param_err <= bound and close >= NET_REF_TOL["close_share"] and ties_ok):
            fail(f"train-nets-reference {name}: GPU and CPU disagree")


def phase_adversarial(root):
    """[adversarial]: lab4d_tpu_torch/scripts/validate_adversarial.py on the
    card (ADV_ARGS; the train CLI in this process), its JSON and every
    kernel's launches over the run, each of which must launch."""
    import torch

    from lab4d_tpu_torch.scripts import validate_adversarial

    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    buf = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        out = validate_adversarial.main(ADV_ARGS + ["--workdir", os.path.join(root, "adv")])
    sync()
    wall = time.time() - t
    launches = _kernel_counts()
    print(f"[adversarial] {' '.join(ADV_ARGS)}: {json.dumps(out)}")
    print(f"[adversarial] {wall:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
          + " ".join(f"{k}={v}" for k, v in launches.items()))
    if out["psnr_final"] is None or not np.isfinite(out["psnr_final"]):
        fail(f"adversarial: no finite eval/psnr: {out}")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        fail(f"adversarial: kernels {idle} never launched")
    return launches


def phase_tools(root, render_frames, pre_db, pre_seq):
    """[tools]: render_intermediate on [train-fg]'s proxy meshes,
    create_collage on [render]'s frames (as pngs), run_rendering_parallel
    with TOOLS_DEVLIST on the category run, run_crop_all on [preprocess]'s
    output, the browser's build_index and one render_mesh_png; each must
    write its files."""
    from lab4d_tpu_torch.browser import app
    from lab4d_tpu_torch.scripts import (create_collage, render_intermediate, run_crop_all,
                                         run_rendering_parallel)
    from lab4d_tpu_torch.utils.io import imwrite

    def written(pattern, what):
        found = glob.glob(pattern)
        if not found:
            fail(f"tools: {what} wrote nothing matching {pattern}")
        return found

    testdir = os.path.join(root, "logdir", "smoke-fg")
    t = time.time()
    frames = render_intermediate.main(["--testdir", testdir, "--res", "256"])
    if not frames:
        fail(f"tools: render_intermediate found no proxy mesh under {testdir}")
    out = written(f"{testdir}/intermediate-fg*", "render_intermediate")
    print(f"[tools] render_intermediate: {len(frames)} frames at 256^2 -> "
          f"{os.path.basename(out[0])} in {time.time() - t:.1f} s")

    t = time.time()
    clips = os.path.join(root, "tools", "render")
    for key, fr in render_frames.items():
        os.makedirs(f"{clips}/{key}", exist_ok=True)
        for i, f in enumerate(fr):
            f = np.clip(np.asarray(f, np.float32), 0, 1)
            f = f[..., 0] if f.ndim == 3 and f.shape[-1] == 1 else f
            imwrite(f"{clips}/{key}/{i:05d}.png", (f * 255).astype(np.uint8))
    collage = os.path.join(root, "tools", "collage.mp4")
    with contextlib.redirect_stdout(io.StringIO()):
        create_collage.create_collage(f"{clips}/*", collage)
    out = written(os.path.join(root, "tools", "collage*"), "create_collage")
    print(f"[tools] create_collage: {len(render_frames)} clips of {N_FRAMES} frames -> "
          f"{os.path.basename(out[0])} in {time.time() - t:.1f} s")

    t = time.time()
    extra = ["--field_type", "fg", "--fg_motion", "comp_skel-human_dense", "--no-single_inst",
             "--train_res", "64", "--database_root", os.path.join(root, "database"),
             "--logroot", os.path.join(root, "logdir"), "--render_res", "64", "--num_frames", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        done = run_rendering_parallel.run_rendering_parallel("cate", "category", TOOLS_DEVLIST,
                                                             extra)
    if done != list(range(CATEGORY_VIDS)):
        fail(f"tools: run_rendering_parallel rendered {done}")
    for inst in done:
        written(os.path.join(root, "logdir", "cate-category", f"renderings_{inst:04d}", "*", "*"),
                f"run_rendering_parallel instance {inst}")
    print(f"[tools] run_rendering_parallel: devlist {','.join(map(str, TOOLS_DEVLIST))}, "
          f"{len(done)} instances of the category run at 64^2, one frame each, in "
          f"{time.time() - t:.1f} s")

    t = time.time()
    proc = f"{pre_db}/processed"
    with contextlib.redirect_stdout(io.StringIO()):
        seqs = run_crop_all.main([pre_seq, "256", proc])
    for prefix in ("crop-256", "full-256"):
        written(f"{proc}/JPEGImages/Full-Resolution/{pre_seq}/{prefix}.npy",
                f"run_crop_all {prefix}")
    print(f"[tools] run_crop_all: {seqs}, crop and full at 256 in {time.time() - t:.1f} s")

    t = time.time()
    page = app.build_index(root)
    png = app.render_mesh_png(sorted(glob.glob(f"{testdir}/*-fg-proxy.obj"))[-1], 30.0)
    n_cells = page.count('<div class="cell">')
    if not n_cells or png[:8] != b"\x89PNG\r\n\x1a\n":
        fail("tools: the browser's index has no cell or its mesh render is no png")
    print(f"[tools] browser: index of {n_cells} cells, a 512^2 mesh png of {len(png)} bytes "
          f"in {time.time() - t:.1f} s")


KERNEL_INFO = {  # JSON name, source, the TPU kernel it replaces
    "K1": ("nerf_heads_fwd", "lab4d_tpu_torch/csrc/nerf_heads.cu",
           "lab4d_tpu/ops/field_kernel.py:544"),
    "K2": ("nerf_heads_bwd", "lab4d_tpu_torch/csrc/nerf_heads.cu",
           "lab4d_tpu/ops/field_kernel.py:626"),
    "anatomy": ("heads_anatomy", "lab4d_tpu_torch/tools/profile_heads_phases.py",
                "scripts/perf/bench_kernel_anatomy.py:174"),
    "K3f": ("fused_relu_mlp_fwd", "lab4d_tpu_torch/csrc/fused_relu_mlp.cu",
            "lab4d_tpu/ops/mlp_kernel.py:127"),
    "K3b": ("fused_relu_mlp_bwd", "lab4d_tpu_torch/csrc/fused_relu_mlp.cu",
            "lab4d_tpu/ops/mlp_kernel.py:227"),
    "K4f": ("fused_pe_mlp_fwd", "lab4d_tpu_torch/csrc/fused_pe_mlp.cu",
            "lab4d_tpu/ops/mlp_kernel.py:488"),
    "K4b": ("fused_pe_mlp_bwd", "lab4d_tpu_torch/csrc/fused_pe_mlp.cu",
            "lab4d_tpu/ops/mlp_kernel.py:514"),
}


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device; this script measures the port on a GPU only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lab4d_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable here: {e}")

    t0 = time.time()
    card = phase_env()
    anatomy = phase_build()
    sync()
    kernels = phase_kernel()
    kernels["anatomy"] = [phase_heads_anatomy(anatomy, kernels)]
    data_info = make_scene()
    model, geo_state = phase_model(data_info)
    phase_streams(model)
    phase_reference(model, geo_state, data_info)
    phase_reference(model, geo_state, data_info, topk=8)
    k3_shapes, fg_calls = collections.Counter(), {}
    with k3_records({}, k3_shapes):
        render_launches, exact_frames, _ = phase_render(model, geo_state, data_info)
        topk_launches = phase_render_topk(model, geo_state, data_info, exact_frames)
    render_frames = {k: exact_frames[k] for k in ("rgb", "mask")}
    del model, exact_frames
    with tempfile.TemporaryDirectory() as root:
        db = write_scene(root)
        phase_config(db, root)
        phase_loader(db)
        phase_train_reference(db, root, "bg")
        with k3_records({}, k3_shapes):
            bg_launches, bg_steps, _, _ = phase_train(db, root, "bg")
        phase_train_reference(db, root, "fg")
        fg_run = {}
        with k3_records(fg_calls, k3_shapes):
            fg_launches, fg_steps, _, _ = phase_train(db, root, "fg", fg_calls, k3_shapes,
                                                      out=fg_run)
            ddp_launches = phase_ddp(fg_run.pop("trainer"), root)
        with k3_records({}, k3_shapes):
            prior_launches = phase_joint_prior(db, root)
            export_launches = {cate: phase_export(db, root, cate) for cate in ("fg", "bg")}
            reanimate_launches = phase_reanimate(db, root)
        phase_train_reference(db, root, "comp")
        comp_calls, family_runs = {}, {}
        with k3_records(comp_calls, k3_shapes):
            comp_launches, comp_steps, _, comp_shapes = phase_train(
                db, root, "comp", comp_calls, k3_shapes)
            for motion in FAMILIES:
                family_runs[motion] = phase_train(db, root, motion, shapes=k3_shapes,
                                                  n_steps=FAMILY_STEPS,
                                                  tag=f"train-families {motion}",
                                                  trace=motion == "dense")
            render_comp_launches = phase_render_comp(db, root)
            export_comp_launches = phase_export(db, root, "comp")
            reanimate_comp_launches = phase_reanimate(db, root, "comp")
        # the category model, its apps, and transfer / resume from its checkpoint
        write_category_scene(db)
        phase_train_reference(db, root, "category")
        cate_calls = {}
        with k3_records(cate_calls, k3_shapes):
            cate_launches, cate_steps, _, _ = phase_train(
                db, root, "category", cate_calls, k3_shapes, zero=("K1", "K2"), trace=True,
                extra=["--geo_init_steps", str(CATEGORY_GEO_STEPS)])
            render_cate_launches = phase_render_category(db, root)
            export_cate_launches = phase_export(db, root, "category", inst_id=5)
            motion_launches = phase_export(db, root, "category", inst_id=2)  # reanimate's motion
            export_cate_launches = {k: v + motion_launches[k]
                                    for k, v in export_cate_launches.items()}
            reanimate_cate_launches = phase_reanimate(db, root, "category", inst_id=5,
                                                      motion_id=2)
            transfer_launches, transfer_steps = phase_transfer(db, root, k3_shapes)
            resume_launches = phase_resume(db, root)
        with k3_records({}, k3_shapes):
            psnr_launches, psnr_steps = phase_psnr(root)
        pre_db, pre_seq = phase_preprocess(root)
        phase_stage_clis(root, pre_db, pre_seq, card)
        phase_preprocess_reference(pre_db, pre_seq)
        weights_before = _weights_digest()
        phase_train_nets(root)
        phase_train_nets_reference()
        adv_launches = phase_adversarial(root)
        phase_tools(root, render_frames, pre_db, pre_seq)
        if _weights_digest() != weights_before:
            fail("a phase wrote into database/weights/")
        for name, shapes in (("train-comp", comp_shapes),
                             ("train-families dense", family_runs["dense"][3])):
            rows = {(r, c) for r, c, *_ in shapes}
            if not {(FG_PAIRS * FG_SPP, 167)} <= rows:
                fail(f"{name}: no K3f launch at the dense warp's 262144 rows x 167 inputs "
                     f"({sorted(rows)})")
    phase_k3_paths(k3_shapes)
    sync()
    jax_loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "lab4d_tpu"))
    if jax_loaded:
        fail(f"the smoke run loaded JAX or the JAX package: {jax_loaded[:5]}")
    print(f"[done] total {time.time() - t0:.1f} s")

    rows = []
    for key, (name, source, replaces) in KERNEL_INFO.items():
        # the training step's shape (K3: the camera / intrinsics TimeMLPs),
        # else the shape it gives the kernel most work at
        main_shape = next((r for r in kernels[key] if r.get("main")), None) or \
            max(kernels[key], key=lambda r: (r["rows"], r["bound_ms"]))
        # the anatomy copies are a profiler's, on no path
        by_path = {path: counts.get(key, 0) for path, counts in (
            ("render", render_launches), ("render_topk", topk_launches),
            ("train", bg_launches), ("train_fg", fg_launches),
            ("export", {k: export_launches["fg"][k] + export_launches["bg"][k]
                        for k in export_launches["fg"]}),
            ("reanimate", reanimate_launches), ("train_comp", comp_launches),
            ("train_families", {k: sum(r[0][k] for r in family_runs.values())
                                for k in comp_launches}),
            ("render_comp", render_comp_launches), ("export_comp", export_comp_launches),
            ("reanimate_comp", reanimate_comp_launches), ("train_category", cate_launches),
            ("render_category", render_cate_launches),
            ("export_category", export_cate_launches),
            ("reanimate_category", reanimate_cate_launches), ("transfer", transfer_launches),
            ("resume", resume_launches), ("joint_prior", prior_launches),
            ("psnr", psnr_launches), ("ddp", ddp_launches), ("adversarial", adv_launches))}
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": {**by_path, "train_steps": bg_steps.get(key, 0),
                                 "train_fg_steps": fg_steps.get(key, 0),
                                 "train_comp_steps": comp_steps.get(key, 0),
                                 "train_category_steps": cate_steps.get(key, 0),
                                 "transfer_steps": transfer_steps.get(key, 0),
                                 "psnr_steps": psnr_steps.get(key, 0),
                                 **{f"train_{m.replace('-', '_')}_steps": r[1].get(key, 0)
                                    for m, r in family_runs.items()}},
            "max_abs_err": max(r["max_abs_err"] for r in kernels[key]),
            **({"max_rel_err": max(r["max_rel_err"] for r in kernels[key])}
               if "max_rel_err" in kernels[key][0] else {}),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
            "library_ms": None, "shape": main_shape["label"],
            **{k: main_shape[k] for k in (
                "bound_3xtf32_ms", "bound_vjp_from_x_ms", "bound_vjp_from_x_3xtf32_ms",
                "ms_no_save", "plain_ms_no_save", "cuda_launches_per_call", "copies_ms")
                if k in main_shape},
            **({"shapes": [{k: r[k] for k in (
                "label", "rows", "engine", "ms", "ms_no_save", "ms_cold_l2", "plain_ms",
                "plain_ms_no_save", "plain_ms_cold_l2", "bound_ms", "bound_3xtf32_ms", "cuda_launches_per_call",
                "max_abs_err", "max_rel_err") if k in r} for r in kernels[key]]}
               if key in ("K3f", "K3b", "K4f", "K4b") else {}),
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
