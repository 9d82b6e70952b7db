#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lab4d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each ending in a device
synchronise; any failure exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN;
2. build: compiles the CUDA kernels from lab4d_tpu_torch/csrc/ (nvcc,
   sm_90a) into build/lab4d_tpu_torch/ and prints the compiler's report;
3. kernel: K3f (fused_relu_mlp forward) against its plain PyTorch version
   at the shapes the render path gives it: max error, tolerance, and
   median times from CUDA events, both as device time (calls replayed
   from a CUDA graph) and per eager call (host work included);
4. model: the flagship fg / skel-quad DVRModel at full width (field heads
   D=5 W=128, TimeMLP backbones D=5 W=256, 25 bones) from a seeded
   generator, on a scene built in-process (one orbit video);
5. reference: evaluate_rays on 256 rays on the GPU (through the kernel)
   against the same model on the CPU (plain versions);
6. render: 2 frames at 512^2 through the render CLI's own functions,
   with the kernel's launch count over exactly that run.

The line before the last is the card's name and power limit, the one
before it a JSON summary of every kernel; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and
prints no result.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

RES = 512
N_FRAMES = 2
SEED = 0

KERNEL_TOL = 1e-4  # fp32 FMA vs cuBLAS fp32: summation order only
REF_TOL = {  # GPU (kernel) vs CPU (plain versions), fp32
    "rgb": ("abs", 1e-4), "mask": ("abs", 1e-4), "vis": ("abs", 1e-4),
    "feature": ("abs", 1e-4), "depth": ("rel", 1e-4), "normal": ("abs", 1e-3),
}
# (label, rows, C_in, hidden layers D, width W) on the render path
K3_SHAPES = [
    ("camera/intrinsics D5 W256", 1, 256, 5, 256),
    ("articulation t+rest D5 W256", 2, 256, 5, 256),
    ("7 frames D5 W256", 7, 256, 5, 256),
    ("appearance D2 W64", 1, 64, 2, 64),
]


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
    from lab4d_tpu_torch.ops.build import build_log, load_library

    t = time.time()
    load_library("fused_relu_mlp")
    print(f"[build] fused_relu_mlp.cu -> sm_90a in {time.time() - t:.1f} s")
    for line in build_log("fused_relu_mlp").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")


def _mlp_params(C_in, D, W, gen, device):
    import torch

    weights, biases, fan_in = [], [], C_in
    for _ in range(D + 1):
        bound = 1.0 / np.sqrt(fan_in)
        weights.append((torch.rand(W, fan_in, generator=gen) * 2 - 1).mul_(bound).to(device))
        biases.append((torch.rand(W, generator=gen) * 2 - 1).mul_(bound).to(device))
        fan_in = W
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


def call_ms(fn, inner=100):
    """Per-call time of back-to-back eager calls, host work included (what
    the render loop pays), ms."""
    for _ in range(10):
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
    return _timed(graph.replay) / inner


def phase_kernel():
    import torch

    from lab4d_tpu_torch.ops.mlp_kernel import fused_relu_mlp, mlp_reference

    gen = torch.Generator().manual_seed(SEED)
    results = []
    for label, rows, C_in, D, W in K3_SHAPES:
        weights, biases = _mlp_params(C_in, D, W, gen, "cuda")
        x = torch.randn(rows, C_in, generator=gen).cuda()
        got = fused_relu_mlp(x, weights, biases, (), True)
        want = mlp_reference(x, weights, biases, (), True)
        sync()
        if not got.is_cuda or got.shape != want.shape:
            fail(f"K3f {label}: output {got.shape} on {got.device}")
        err = float((got - want).abs().max())
        if not err <= KERNEL_TOL:
            fail(f"K3f {label} disagrees with its plain version: {err} > {KERNEL_TOL}")
        kernel = lambda: fused_relu_mlp(x, weights, biases, (), True)  # noqa: E731
        plain = lambda: mlp_reference(x, weights, biases, (), True)  # noqa: E731
        r = {"label": label, "max_abs_err": err, "ms": device_ms(kernel),
             "plain_ms": device_ms(plain), "call_ms": call_ms(kernel),
             "plain_call_ms": call_ms(plain)}
        sync()
        print(f"[kernel] K3f {label}: rows={rows} max_abs_err={err:.3e} (tol {KERNEL_TOL:g}) "
              f"device kernel {r['ms'] * 1e3:.2f} us / plain {r['plain_ms'] * 1e3:.2f} us; "
              f"eager call kernel {r['call_ms'] * 1e3:.2f} us / plain "
              f"{r['plain_call_ms'] * 1e3:.2f} us")
        results.append(r)
    return results


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


def phase_reference(model, geo_state, data_info):
    """GPU evaluate_rays (kernel) vs the same weights on the CPU (plain)."""
    import torch

    from lab4d_tpu_torch.render import construct_batch_from_opts

    opts = {"inst_id": 0, "render_res": 16, "viewpoint": "ref", "freeze_id": 0,
            "num_frames": 1, "noskip": False}
    model_cpu = copy.deepcopy(model).cpu()
    outs = {}
    for name, m, dev in (("cuda", model, "cuda"), ("cpu", model_cpu, "cpu")):
        batch, _ = construct_batch_from_opts(opts, m, geo_state, data_info, dev)
        batch["geo"] = {"fg": {k: torch.as_tensor(v, device=dev)
                               for k, v in (("aabb", geo_state["fg"]["aabb"]),
                                            ("proxy_corners", geo_state["fg"]["corners"]))}}
        with torch.no_grad():
            outs[name] = m.evaluate_rays(m.prepare_eval_samples(batch))
    sync()
    for k, v in outs["cuda"].items():
        if not v.is_cuda:
            fail(f"reference: channel {k} is on {v.device}")
    worst = {}
    for k, (kind, tol) in REF_TOL.items():
        a, b = outs["cuda"][k].cpu().double(), outs["cpu"][k].double()
        err = (a - b).abs().max() if kind == "abs" else ((a - b).abs() / b.abs().clamp(min=1e-12)).max()
        worst[k] = float(err)
        if not worst[k] <= tol:
            fail(f"reference: channel {k} GPU vs CPU {kind} err {worst[k]} > {tol}")
    print("[reference] 256 rays, GPU vs CPU: "
          + " ".join(f"{k}={v:.2e}({REF_TOL[k][0]}<={REF_TOL[k][1]:g})" for k, v in worst.items()))


def phase_render(model, geo_state, data_info):
    import torch

    from lab4d_tpu_torch.ops.mlp_kernel import fused_relu_mlp
    from lab4d_tpu_torch.render import construct_batch_from_opts, render_batch

    opts = {"inst_id": 0, "render_res": RES, "viewpoint": "ref", "freeze_id": 0,
            "num_frames": N_FRAMES, "noskip": False}
    # warm-up at a small size: cuBLAS handles, allocator pools
    warm = dict(opts, render_res=32, num_frames=1)
    batch, _ = construct_batch_from_opts(warm, model, geo_state, data_info, "cuda")
    render_batch(model, batch, geo_state)
    sync()
    torch.cuda.reset_peak_memory_stats()

    fused_relu_mlp.launches = 0
    t = time.time()
    batch, _ = construct_batch_from_opts(opts, model, geo_state, data_info, "cuda")
    rendered = render_batch(model, batch, geo_state)
    sync()
    elapsed = time.time() - t
    launches = fused_relu_mlp.launches

    if launches <= 0:
        fail("the render ran no fused_relu_mlp kernel")
    if not all(v.is_cuda for v in batch.values() if torch.is_tensor(v)):
        fail("render batch is not on cuda")
    for k, v in rendered.items():
        if v.shape[:3] != (N_FRAMES, RES, RES) or not np.isfinite(v).all():
            fail(f"render: channel {k} has shape {v.shape} or non-finite values")
    mask = rendered["mask"]
    if not (mask.min() >= 0.0 and mask.max() <= 1.0 + 1e-6):
        fail(f"render: mask outside [0, 1]: [{mask.min()}, {mask.max()}]")
    ms_frame = elapsed / N_FRAMES * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[render] {N_FRAMES} frames at {RES}^2: {ms_frame:.1f} ms/frame, "
          f"K3f launches {launches}, peak memory {peak:.2f} GiB, "
          f"channels {sorted(rendered)}, mask mean {mask.mean():.4f}")
    return launches


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
    phase_build()
    sync()
    k3 = phase_kernel()
    data_info = make_scene()
    model, geo_state = phase_model(data_info)
    phase_reference(model, geo_state, data_info)
    launches = phase_render(model, geo_state, data_info)
    sync()
    jax_loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "lab4d_tpu"))
    if jax_loaded:
        fail(f"the smoke run loaded JAX or the JAX package: {jax_loaded[:5]}")
    print(f"[done] total {time.time() - t0:.1f} s")

    main_shape = k3[0]
    print(json.dumps({"kernels": [{
        "name": "fused_relu_mlp_fwd",
        "route": "cuda",
        "source": "lab4d_tpu_torch/csrc/fused_relu_mlp.cu",
        "replaces": "lab4d_tpu/ops/mlp_kernel.py:111",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in k3),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
