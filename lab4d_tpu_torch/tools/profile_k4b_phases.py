"""Where the time of K4b goes on the bg base field, on one CUDA device.

    python3 -m lab4d_tpu_torch.tools.profile_k4b_phases [--reps N]

Run from the root of a checkout. It compiles copies of
csrc/fused_pe_mlp.cu, each with one phase of the row-tiled backward in
csrc/mlp_tiles.cuh switched off, into build/lab4d_tpu_torch/k4b_phases/
(one nvcc each, all at once), and times each copy's K4b at the base
field's shape of a training step: 262,144 points, 6 frequencies with a
window, D5 W128, a skip at layer 4. (K1 and K2, which no longer share
this code, have their own profiler: tools/profile_heads_phases.py.) The
copies:

- full: the kernel as it is;
- no_recompute: without the forward recompute of the hidden layers;
- no_din: without dIn = g . W, the backprop through each layer;
- no_wgrad: without the weight-gradient products and their workspace
  updates;
- no_rmw: with the weight-gradient products but without the workspace
  read-modify-write (the stores stay behind a test that never holds, so
  the products are not dropped as dead code).

A copy with a phase off computes wrong gradients; only its time is read.
Each round times every copy in turn (CUDA events around 5 back-to-back
calls, after one warm-up call); the median over `--reps` rounds is
printed with its difference from `full`, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

# (anchor in mlp_tiles.cuh, its replacement) per copy
PATCHES = {
    "full": [],
    "no_recompute": [(
        "      tm_gemm<true>(a.w[l], a.out_dim[l], a.in_dim[l], in, tr, as, a.stage_ld,\n"
        "                    TmEpiHidden{hs[l], a.b[l], ts});",
        "      if (0) tm_gemm<true>(a.w[l], a.out_dim[l], a.in_dim[l], in, tr, as, a.stage_ld,\n"
        "                    TmEpiHidden{hs[l], a.b[l], ts});",
    )],
    "no_din": [(
        "      tm_gemm<false>(a.w[l], a.in_dim[l], a.out_dim[l],",
        "      if (0) tm_gemm<false>(a.w[l], a.in_dim[l], a.out_dim[l],",
    )],
    "no_wgrad": [(
        "      tm_weight_grads(dwl, dbl,",
        "      if (0) tm_weight_grads(dwl, dbl,",
    )],
    "no_rmw": [
        ("    if (!first) {\n#pragma unroll\n      for (int i = 0; i < 4; ++i)",
         "    if (0) {\n#pragma unroll\n      for (int i = 0; i < 4; ++i)"),
        ("        if (j < n_o && k < K) dw[(size_t)j * K + k] = acc[i][q];",
         "        if (j < n_o && k < K && acc[i][q] == 12345.f) dw[(size_t)j * K + k] = acc[i][q];"),
    ],
}


def build_copies(out_dir):
    """Compile fused_pe_mlp.cu against every copy of PATCHES; returns
    {name: ctypes library}."""
    from lab4d_tpu_torch.ops.build import CSRC_DIR, NVCC_FLAGS, find_nvcc

    header = (CSRC_DIR / "mlp_tiles.cuh").read_text()
    procs = {}
    for name, patches in PATCHES.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        text = header
        for anchor, repl in patches:
            if text.count(anchor) != 1:
                raise RuntimeError(f"{name}: the anchor {anchor[:40]!r}... is not in mlp_tiles.cuh once")
            text = text.replace(anchor, repl)
        with open(os.path.join(d, "mlp_tiles.cuh"), "w") as f:
            f.write(text)
        with open(os.path.join(d, "fused_pe_mlp.cu"), "w") as f:
            f.write((CSRC_DIR / "fused_pe_mlp.cu").read_text())
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", os.path.join(d, "libfused_pe_mlp.so"),
               os.path.join(d, "fused_pe_mlp.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy of fused_pe_mlp.cu:\n{err}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, name, "libfused_pe_mlp.so"))
    return libs


def _time_rounds(runs, reps):
    """{name: median ms per call} of each run() in turns: per round one
    warm-up call, then CUDA events around 5 back-to-back calls."""
    import numpy as np
    import torch

    times = {name: [] for name in runs}
    for _ in range(reps):
        for name, run in runs.items():
            run()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / 5)
    return {name: float(np.median(ts)) for name, ts in times.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_k4b_phases: no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke
    from lab4d_tpu_torch.ops import mlp_kernel as K
    from lab4d_tpu_torch.ops.build import BUILD_DIR

    card = chip_smoke.phase_env()
    libs = build_copies(str(BUILD_DIR / "k4b_phases"))
    ref = K._kernel_lib("fused_pe_mlp")
    for lib in libs.values():
        lib.lab4d_fused_pe_mlp_bwd.argtypes = ref.lab4d_fused_pe_mlp_bwd.argtypes
        lib.lab4d_fused_pe_mlp_bwd.restype = ctypes.c_int
        lib.lab4d_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lab4d_cuda_error_string.restype = ctypes.c_char_p

    label, rows, n_freqs, widths, skips, _, _ = chip_smoke.K4_SHAPES[0]
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    c_x = 3 * (2 * n_freqs + 1)
    weights, biases = chip_smoke._mlp_params(c_x, 0, 0, gen, "cuda", widths=list(widths), skips=skips)
    x = ((torch.rand(rows, 3, generator=gen) * 2 - 1) * 0.5).cuda()
    g = torch.randn(rows, widths[-1], generator=gen).cuda()
    freqs = tuple(float(2.0**i) for i in range(n_freqs))
    pe = K._freq_args(freqs, torch.linspace(0.3, 1.0, n_freqs).cuda(), x)
    n_sm, stream = K._n_sm(x.device), K._stream(x.device)

    def k4b(lib):
        return lambda: K._launch_tile_bwd(lib, lib.lab4d_fused_pe_mlp_bwd, x, g, weights, biases,
                                          skips, n_sm, stream, pe)

    times = _time_rounds({name: k4b(libs[name]) for name in PATCHES}, args.reps)
    print(f"[k4b] {label}, {rows} rows; median of {args.reps} rounds, ms per call:")
    for name, ms in times.items():
        print(f"[k4b] {name}: {ms:.3f} ms (full - this: {times['full'] - ms:.3f} ms)")
    print(card)


if __name__ == "__main__":
    main()
