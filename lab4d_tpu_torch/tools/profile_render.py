"""Where the time of a 512^2 render frame goes, on one CUDA device.

    python3 -m lab4d_tpu_torch.tools.profile_render [--out FILE]

Run from the root of a checkout. It builds the smoke model of
chip_smoke.py (flagship fg / skel-quad at full width, random weights from
seed 0, one in-process orbit video) and then:

1. renders one frame `--reps` times at the render CLI's chunk size and
   prints ms/frame for each (host clock, after a device synchronise);
2. sweeps the ray chunk size, in the given order and then in reverse,
   printing ms/frame and peak device memory for each;
3. traces one frame with torch.profiler and prints, per op, the device
   time of the kernels it launched itself and their share of the summed
   kernel time, then that sum, the frame's wall time and the device's
   idle share of the frame.

`--out` also writes the profiler's full table to FILE.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--res", type=int, default=512)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--chunks", type=int, nargs="*", default=[8192, 16384, 32768, 65536])
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_render: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import chip_smoke
    from lab4d_tpu_torch.render import DEFAULT_CHUNK, construct_batch_from_opts, render_batch

    card = chip_smoke.phase_env()
    data_info = chip_smoke.make_scene()
    model, geo = chip_smoke.phase_model(data_info)
    opts = {"inst_id": 0, "render_res": args.res, "viewpoint": "ref", "freeze_id": 0,
            "num_frames": 1, "noskip": False}
    batch, _ = construct_batch_from_opts(opts, model, geo, data_info, "cuda")
    warm, _ = construct_batch_from_opts(dict(opts, render_res=32), model, geo, data_info, "cuda")
    render_batch(model, warm, geo)
    torch.cuda.synchronize()

    def frame_ms(chunk):
        torch.cuda.synchronize()
        t = time.perf_counter()
        render_batch(model, batch, geo, chunk=chunk)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    print(f"[frame] {args.res}^2, chunk {DEFAULT_CHUNK}: "
          + " ".join(f"{frame_ms(DEFAULT_CHUNK):.1f}" for _ in range(args.reps)) + f" ms/frame ({card})")
    for chunk in args.chunks + args.chunks[::-1]:
        torch.cuda.reset_peak_memory_stats()
        ms = frame_ms(chunk)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[chunk] {chunk}: {ms:.1f} ms/frame, peak {peak:.2f} GiB")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = frame_ms(DEFAULT_CHUNK)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.device_time for e in kernels)
    k3 = [e.device_time for e in kernels if "fused_relu_mlp" in e.name]
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    for e in ops[: args.top]:
        print(f"[op] {e.key}: {e.self_device_time_total / 1e3:.1f} ms device, "
              f"{100 * e.self_device_time_total / device_us:.1f}%, {e.count} calls")
    print(f"[op] K3f fused_relu_mlp_fwd_kernel: {sum(k3) / 1e3:.2f} ms device, "
          f"{100 * sum(k3) / device_us:.2f}%, {len(k3)} calls")
    print(f"[profile] device time {device_us / 1e3:.1f} ms of a {wall:.1f} ms frame "
          f"(traced), idle share {1 - device_us / 1e3 / wall:.3f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=80))


if __name__ == "__main__":
    main()
