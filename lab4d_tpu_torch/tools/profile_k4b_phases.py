"""Where the time of K4f and K4b goes on the bg field's MLPs, and of K3f
and K3b on the TimeMLPs and the warps' CondMLPs, on one CUDA device.

    python3 -m lab4d_tpu_torch.tools.profile_k4b_phases [--reps N] [--parent DIR] [--k3_only]
    python3 -m lab4d_tpu_torch.tools.profile_k4b_phases --k3_sweep [--reps N]

Run from the root of a checkout. At the 262,144-point shapes of
chip_smoke.K4_SHAPES, K4_CATEGORY_SHAPES and K4_RAGGED (the base, colour
and visibility MLPs of a bg training step, the category step's feature
field, the base MLP at 262,143 points):

- K4f by anatomy copies: patched copies of csrc/fused_pe_mlp.cu with the
  tile engine of csrc/wg_engine.cuh (one nvcc each, all at once, into
  build/lab4d_tpu_torch/k4_phases/), the copies of K1's profiler
  (profile_heads_phases.K1_COPIES: the pass and the ring are the same)
  and K4f's own, timed in turns, each saving its hidden outputs as
  training runs it:
  - full: the kernel as it is (checked against
    pe_mlp_forward_saved_reference); no-save: the same library, without
    saving;
  - no-math: without the products (the weight slabs' stream through the
    ring, A's loads and splits, the epilogues, the stores);
  - mm-1x: one TF32 product per k8 step instead of three, which prices the
    3xTF32 split; timed only, it misses the kernels' tolerance;
  - no-wstage: without the TMA copies of the weight slabs (the slots keep
    stale values): what streaming the weights from L2 costs;
  - no-ladder: the embedding without sin / cos; no-epi: a hidden layer's
    pass without its epilogue; bare: the ring alone (none of no-math,
    no-wstage, no-ladder, no-epi's parts).
- K4b by launch: a CUDA event after each of its 4 launches gives each its
  share (the split of W^T, the dIn engine, dW, the reduction), on the
  full kernel, on K4f's copies and on K4b's own: K2's (dw-no-math,
  dw-no-a, din-no-masks, din-no-gput: profile_heads_phases) and
  din-no-dx (dIn without dx and the embedding for dW).

A copy with a phase off computes other outputs; only `full` is checked.

K3f and K3b by anatomy copies of csrc/fused_relu_mlp.cu, each timed by
CUDA-graph replay (chip_smoke.device_ms), `full` checked against the plain
versions. On the cluster engine, at the TimeMLPs' shapes
(chip_smoke.K3_PROFILE: D5 W256 at 1, 256 and 512 rows, D2 W64 at 256):
  - empty: K3f returns at its start (a cluster launch with its shared
    memory); no-wstage: without the weight staging; no-remote: each block
    stores a layer's outputs into its own shared memory only (no
    distributed shared memory); no-sync: a block barrier in place of the
    cluster barrier between layers (the last one kept, so that no block
    leaves while another stores into it); no-math: without the layers'
    products and their stores; barriers: neither staging nor math (the
    launch, x and the barriers);
  - K3b's dIn launch alone (din-only) and its dW launch alone (dw-only).
On the row engine, at the warps' 262,144 rows (chip_smoke.K3_WARP_SHAPES:
the dense map and the post-warp):
  - rw-no-math: K3f and K3b's dIn without their wgmma products;
    rw-no-wstage: without the weight slabs' bulk copies (the slots keep
    stale values); rw-mma-1x: one product per k8 step instead of three;
    rw-no-split: A's fragments not loaded nor split; rw-no-drain: no wait
    for a slab's products before its slot is released; rw-no-epi: a hidden
    layer's pass without its epilogue; no-save: K3f without saving;
  - K3b's dIn alone (din-only), its dW alone (dw-only), K3b without dW's
    products (rw-dw-no-math), without writing G's slabs for dW
    (rw-no-gput), without loading the ReLU masks (rw-no-mask).

--parent DIR: the root of a checkout of an earlier commit. Its
fused_pe_mlp.cu and fused_relu_mlp.cu are built from DIR, its wrapper
DIR/lab4d_tpu_torch/ops/mlp_kernel.py loaded under another name, checked
against its plain versions, and its K4f / K4b (at every shape of
chip_smoke.K4_SHAPES and K4_CATEGORY_SHAPES and the ragged K4_RAGGED; the
512 and 2,048-point ones get the turns only; a parent whose K4b takes
K4f's saved outputs runs its saving K4f and that K4b, the row-tiled one of
commit 450f66c its recomputing K4b) and K3f (saving) / K3b (from its own
K3f's saved outputs) timed in turns with this checkout's: parent, new,
new, parent in every round, at every K3 shape above, beside the plain
versions; whether K3f / K3b give bitwise the parent's results is printed.
--k3_only: only the K3 parts; --k4_only: only the K4 parts.

--k3_sweep: K3f and K3b on both engines in turns (cluster, rows, rows,
cluster), and their plain versions, at 256 to 262,144 rows at the dense
map's and the post-warp's widths; it prints the crossover, the fewest
swept rows from which the row engine wins at every larger count and both
shapes (relu_mlp_plan's K3_ROWS_MIN is set from it).

Each round times every run in turn: at 262,144 points, CUDA events around
5 back-to-back calls after one warm-up call; at 512 points, where the
host's launches would outlast the kernels, 100 calls captured into one
CUDA graph and replayed (chip_smoke.device_ms; K3: 3 calls past 4,096
rows). The median over `--reps` rounds is printed, then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import os
import sys

from lab4d_tpu_torch.tools import profile_heads_phases as PH

# K4f's anatomy copies, (file, anchor, replacement) per copy: K1's, whose
# pass and weight ring (csrc/wg_engine.cuh) K4f runs, and its own
_NO_LADDER = [("fused_pe_mlp.cu", "      sincosf(row[c] * fr, &s, &co);",
               "      s = co = row[c] * fr;")]
_NO_EPI = [("fused_pe_mlp.cu",
            "  nh_bar();  // every thread of the warpgroup is done reading the pass's input\n"
            "  rw_each<NW>(sum,",
            "  nh_bar();  // every thread of the warpgroup is done reading the pass's input\n"
            "  if (a.rows < 0) rw_each<NW>(sum,")]
K4F_COPIES = {
    **PH.K1_COPIES,
    # the embedding without sin / cos (the angle itself)
    "no-ladder": _NO_LADDER,
    # a hidden layer's pass without its epilogue (bias, ReLU, the stores)
    "no-epi": _NO_EPI,
    # the ring alone: no products, no weight copies, no epilogues, no sin / cos
    "bare": PH.K1_COPIES["no-math"] + PH.K1_COPIES["no-wstage"] + _NO_LADDER + _NO_EPI,
}
# K4b's: K2's (the same dW and the same dIn helpers), and dIn without its
# epilogue's dx and embedding (din-no-dx); K4b is also timed on K4f's copies
K4B_COPIES = {
    **PH.K2_COPIES,
    "din-no-dx": [("fused_pe_mlp.cu", "    for (int e = wt; e < nr * F; e += 128) {",
                   "    for (int e = wt; e < 0; e += 128) {"),
                  ("fused_pe_mlp.cu", "    for (int e = wt; e < nr * C; e += 128) {",
                   "    for (int e = wt; e < 0; e += 128) {")],
}
# K3f / K3b's anatomy copies of csrc/fused_relu_mlp.cu
K3_COPIES = {
    "full": [],
    "empty": [(
        "fused_relu_mlp.cu",
        "  auto stage = [&](int l) {  // the block's rows of W_l into slab l % S\n",
        "  if (a.rows > 0) return;\n  auto stage = [&](int l) {  // the block's rows of W_l into slab l % S\n",
    )],
    "no-wstage": [(
        "fused_relu_mlp.cu",
        "        hm_cp16(dst + n * ldb + k, W + (size_t)n * K + k);",
        "        if (0) hm_cp16(dst + n * ldb + k, W + (size_t)n * K + k);",
    )],
    "no-remote": [(
        "fused_relu_mlp.cu",
        "#pragma unroll\n      for (int p = 0; p < RM_CLUSTER; ++p) peer[p][off] = v;",
        "      smem[off] = v;",
    )],
    "no-sync": [(
        "fused_relu_mlp.cu",
        "    cluster.sync();  // layer l complete in every block before layer l + 1 reads it",
        "    if (l == L - 1) cluster.sync(); else __syncthreads();",
    )],
    "no-math": [(
        "fused_relu_mlp.cu",
        "    if (cnt > 0) {\n      if constexpr (FMA)",
        "    if (cnt < 0) {\n      if constexpr (FMA)",
    )],
    "barriers": [
        ("fused_relu_mlp.cu",
         "        hm_cp16(dst + n * ldb + k, W + (size_t)n * K + k);",
         "        if (0) hm_cp16(dst + n * ldb + k, W + (size_t)n * K + k);"),
        ("fused_relu_mlp.cu",
         "    if (cnt > 0) {\n      if constexpr (FMA)",
         "    if (cnt < 0) {\n      if constexpr (FMA)"),
    ],
    "din-only": [
        ("fused_relu_mlp.cu", "    rm_dw_rows_kernel<<<", "    if (0) rm_dw_rows_kernel<<<"),
        ("fused_relu_mlp.cu", "    rm_dw_kernel<<<", "    if (0) rm_dw_kernel<<<"),
        ("fused_relu_mlp.cu", "  rw_dw_kernel<<<", "  if (0) rw_dw_kernel<<<"),
    ],
    "dw-only": [
        ("fused_relu_mlp.cu", "  rm_din_kernel<<<tiles * RM_CLUSTER",
         "  if (0) rm_din_kernel<<<tiles * RM_CLUSTER"),
        ("fused_relu_mlp.cu", "  rw_kernel<true><<<", "  if (0) rw_kernel<true><<<"),
    ],
    # the row engine: K3f and K3b's dIn without their products (the weight
    # streaming, the barriers and the epilogues), or without the weight
    # streaming (the slabs keep stale values; the products, A's loads and
    # the epilogues); K3b's dW without its products
    "rw-no-math": [(
        "fused_relu_mlp.cu",
        "      rw_mma<NW>(acc, al[j], dh, j);\n      rw_mma<NW>(acc, ah[j], dl, 1);\n"
        "      rw_mma<NW>(acc, ah[j], dh, 1);",
        "      if (0) {\n      rw_mma<NW>(acc, al[j], dh, j);\n      rw_mma<NW>(acc, ah[j], dl, 1);\n"
        "      rw_mma<NW>(acc, ah[j], dh, 1);\n      }",
    )],
    "rw-no-wstage": [(
        "fused_relu_mlp.cu",
        "      rw_bulk_load(ring + i * RW_SLAB, src, bytes, full + i);",
        "      asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\" ::\"r\"(rw_addr(full + i)));",
    ), (
        "fused_relu_mlp.cu",
        "    rw_bulk_load(ring + slot * RW_SLAB, src, bytes, full + slot);",
        "    asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\" ::\"r\"(rw_addr(full + slot)));",
    )],
    "rw-mma-1x": [(
        "fused_relu_mlp.cu",
        "      rw_mma<NW>(acc, al[j], dh, j);\n      rw_mma<NW>(acc, ah[j], dl, 1);\n"
        "      rw_mma<NW>(acc, ah[j], dh, 1);",
        "      rw_mma<NW>(acc, ah[j], dh, j);",
    )],
    "rw-no-split": [(
        "fused_relu_mlp.cu",
        "    rw_frag_a(A, RW_KS * s, mw, ah[0], al[0]);\n"
        "    rw_frag_a(A, RW_KS * s + 8, mw, ah[1], al[1]);",
        "    for (int q = 0; q < 4; ++q) ah[0][q] = ah[1][q] = al[0][q] = al[1][q] = 0x3c000000u + s;",
    )],
    "rw-no-drain": [(
        "fused_relu_mlp.cu",
        "    rw_wait0();\n    rw_own(acc);\n    rw_own(ah[0]);",
        "    rw_own(acc);\n    rw_own(ah[0]);",
    )],
    "rw-no-epi": [(
        "fused_relu_mlp.cu",
        "          __syncthreads();  // every warp is done reading hs\n          rw_each<RW_NW>(sum,",
        "          __syncthreads();  // every warp is done reading hs\n          if (a.m.rows < 0) rw_each<RW_NW>(sum,",
    )],
    "rw-no-gput": [(
        "fused_relu_mlp.cu",
        "          rw_gput(hs, ldh, kh, save + a.gimg[l - 1], a.nwo[l - 1], a.n_ot[l - 1], row0);",
        "",
    )],
    "rw-no-mask": [(
        "fused_relu_mlp.cu",
        "              mk[j][h] = make_float2(0.f, 0.f);\n              if (m >= nr || c >= kh) continue;",
        "              mk[j][h] = make_float2(1.f, 1.f);\n              continue;",
    )],
    "rw-dw-no-math": [(
        "fused_relu_mlp.cu",
        "      rw_mma<NWO>(acc, al[j], dh, j);\n      rw_mma<NWO>(acc, ah[j], dl, 1);\n"
        "      rw_mma<NWO>(acc, ah[j], dh, 1);",
        "      if (0) {\n      rw_mma<NWO>(acc, al[j], dh, j);\n      rw_mma<NWO>(acc, ah[j], dl, 1);\n"
        "      rw_mma<NWO>(acc, ah[j], dh, 1);\n      }",
    )],
}
# the copies timed per engine: K3f's, K3b's
_K3_ENGINE_COPIES = {
    "cluster": (("full", "empty", "no-wstage", "no-remote", "no-sync", "no-math", "barriers"),
                ("full", "din-only", "dw-only")),
    "rows": (("full", "rw-no-math", "rw-no-wstage", "rw-mma-1x", "rw-no-split", "rw-no-drain",
              "rw-no-epi"),
             ("full", "din-only", "dw-only", "rw-no-math", "rw-no-wstage", "rw-dw-no-math",
              "rw-no-gput", "rw-no-mask")),
}

# what each kind of K4b launch is (csrc/fused_pe_mlp.cu:lab4d_pe_mlp_bwd)
K4B_KINDS = ("weight split", "dIn", "dW", "reduction")


def _time_rounds(runs, reps, graph_ms=None):
    """{name: median ms per call} of each run() in turns: per round one
    warm-up call, then CUDA events around 5 back-to-back calls; or, given
    graph_ms (chip_smoke.device_ms), graph_ms(run)."""
    import numpy as np
    import torch

    times = {name: [] for name in runs}
    for _ in range(reps):
        for name, run in runs.items():
            if graph_ms is not None:
                times[name].append(graph_ms(run))
                continue
            run()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / 5)
    return {name: float(np.median(ts)) for name, ts in times.items()}


def k4b_phases(K, lib, args, g, acts, stream, reps):
    """{kind: median ms per K4b call} from CUDA events between its launches
    (after one warm-up call), and the launches of one call, as 'launches'.
    args: fused_pe_mlp's (x, window, weights, biases, freqs, skips, ...)."""
    import numpy as np
    import torch

    x, win, weights, biases, freqs, skips = args[:6]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(64)]
    for e in events:  # creates each event
        e.record()
    per = []
    for _ in range(reps + 1):
        kinds = K._launch_pe_bwd(lib, x, g, win, weights, biases, freqs, skips, acts, stream,
                                 events=events)[-1]
        torch.cuda.synchronize()
        t = {k: 0.0 for k in K4B_KINDS}
        for i, kind in enumerate(kinds):
            t[K4B_KINDS[kind]] += events[i].elapsed_time(events[i + 1])
        t["total"] = events[0].elapsed_time(events[len(kinds)])
        per.append(t)
    out = {k: float(np.median([t[k] for t in per[1:]])) for k in per[0]}
    out["launches"] = len(kinds)
    return out


def _anatomy(K, libs, fargs, g, acts, stream, reps, label):
    """Print K4f's anatomy copies' times and K4b's by kind of launch on
    every copy at one shape."""
    runs = {"full": lambda: K._launch_pe_fwd(libs["full"], *fargs, stream, True)}
    runs["no-save"] = lambda: K._launch_pe_fwd(libs["full"], *fargs, stream, False)
    for name in K4F_COPIES:
        if name != "full":
            runs[name] = lambda lib=libs[name]: K._launch_pe_fwd(lib, *fargs, stream, True)
    times = _time_rounds(runs, reps)
    for name, ms in times.items():
        print(f"[k4f] {label} {name}: {ms:.3f} ms (full - this: {times['full'] - ms:.3f} ms)")
    for name, lib in libs.items():
        phases = k4b_phases(K, lib, fargs, g, acts, stream, reps)
        print(f"[k4b] {label} {name}: {phases.pop('launches')} CUDA launches per call; by kind, ms: "
              + " ".join(f"{k}={v:.3f}" for k, v in phases.items()))


def load_parent_mlp_kernel(root, libs):
    """DIR/lab4d_tpu_torch/ops/mlp_kernel.py as the module
    parent_mlp_kernel, its kernels bound to libs ({name: the parent's
    <name>.cu built from DIR}) through its own _kernel_lib."""
    from lab4d_tpu_torch.ops import build

    path = os.path.join(root, "lab4d_tpu_torch", "ops", "mlp_kernel.py")
    spec = importlib.util.spec_from_file_location("parent_mlp_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kept = build.load_library
    build.load_library = lambda name: libs[name]
    try:
        for name in libs:
            mod._kernel_lib(name)
    finally:
        build.load_library = kept
    return mod


def _k3_inputs(chip_smoke, gen, rows, C, widths, skips):
    """K3's weights, x and an output gradient at one shape, as chip_smoke
    makes them."""
    import torch

    ws, bs = chip_smoke._mlp_params(C, 0, 0, gen, "cuda", widths=list(widths), skips=skips)
    x = torch.randn(rows, C, generator=gen).cuda()
    g = torch.randn(rows, widths[-1], generator=gen).cuda()
    return x, ws, bs, g


def _k3_shapes(chip_smoke):
    """(label, rows, C_in, widths, skips, final_act) of every shape K3 is
    profiled at: the TimeMLPs' (chip_smoke.K3_PROFILE, which get the anatomy
    copies) and the warps' (chip_smoke.K3_WARP_SHAPES, on the row engine)."""
    return ([(label, rows, C, (W,) * (D + 1), (), True) for label, rows, C, D, W in
             chip_smoke.K3_PROFILE] + [s for s in chip_smoke.K3_WARP_SHAPES if s[1] == 262144])


def k3_profile(chip_smoke, K, libs, pmk, reps):
    """K3f / K3b's anatomy copies (libs: {copy: library of
    fused_relu_mlp.cu}) at the TimeMLP shapes of chip_smoke.K3_PROFILE,
    `full` checked against the plain versions (at the warps' shapes too);
    with pmk (the parent's mlp_kernel), K3f (saving, as training runs it)
    and K3b from saved outputs in turns with the parent's at every shape."""
    import torch

    tol = chip_smoke.KERNEL_TOL
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    for label, rows, C, widths, skips, final_act in _k3_shapes(chip_smoke):
        x, ws, bs, g = _k3_inputs(chip_smoke, gen, rows, C, widths, skips)
        fargs = (x, ws, bs, skips, final_act)
        want, want_acts = K.mlp_forward_saved_reference(*fargs)
        out, acts, _ = K._launch_k3f(libs["full"], x, ws, bs, skips, final_act,
                                     K._stream(x.device), True)
        got_b = K._launch_k3b(libs["full"], x, g, ws, bs, skips, acts, K._stream(x.device))[:3]
        want_b = K.mlp_backward_saved_reference(x, g, ws, bs, skips, acts)
        torch.cuda.synchronize()
        err = max(float((out - want).abs().max()), float((acts - want_acts).abs().max()))
        rel_b = chip_smoke._bwd_errs(list(got_b), list(want_b))[1]
        engine = K._k3_plan(x, ws).engine
        print(f"[k3] {label} ({engine} engine): full vs plain: K3f abs err {err:.3e}, K3b rel err "
              f"{rel_b:.3e} (tol {tol:g})")
        if not max(err, rel_b) <= tol:
            sys.exit(f"profile_k4b_phases: K3f / K3b {label} disagree with their plain versions")
        # the stream is looked up per call, as the wrappers do: under CUDA
        # graph capture it is the capturing stream
        f_copies, b_copies = _K3_ENGINE_COPIES[engine]
        fwd = {name: (lambda lib=libs[name]: K._launch_k3f(lib, x, ws, bs, skips, final_act,
                                                           K._stream(x.device), True))
               for name in f_copies}
        bwd = {name: (lambda lib=libs[name]: K._launch_k3b(lib, x, g, ws, bs, skips, acts,
                                                           K._stream(x.device)))
               for name in b_copies}
        inner = 3 if rows > 4096 else 100
        graph_ms = lambda fn: chip_smoke.device_ms(fn, inner)  # noqa: E731
        fwd["no-save"] = lambda: K._launch_k3f(libs["full"], x, ws, bs, skips, final_act,
                                               K._stream(x.device), False)
        times = _time_rounds({**{f"K3f {k}": v for k, v in fwd.items()},
                              **{f"K3b {k}": v for k, v in bwd.items()}}, reps, graph_ms)
        print(f"[k3] {label}, us: " + " ".join(f"{k}={v * 1e3:.2f}" for k, v in times.items()))
        if pmk is None:
            continue
        _, pacts = pmk.mlp_forward_saved(x, ws, bs, skips, final_act)
        old_f = lambda: pmk.mlp_forward_saved(*fargs)  # noqa: E731
        old_b = lambda: pmk.fused_relu_mlp_backward(x, g, ws, bs, skips, saved=pacts)  # noqa: E731
        pwant_b = K.mlp_backward_saved_reference(x, g, ws, bs, skips, pacts)
        perr = max(float((old_f()[0] - want).abs().max()),
                   chip_smoke._bwd_errs(list(old_b()), list(pwant_b))[1])
        same = PH.tensors_equal((old_f(), old_b()), (fwd["full"]()[:2], bwd["full"]()[:3]))
        torch.cuda.synchronize()
        print(f"[parent] {label}: parent K3f abs err / K3b rel err vs plain, worst {perr:.3e}; "
              f"K3f / K3b bitwise equal to the parent's: {same}")
        if not perr <= tol:
            sys.exit(f"profile_k4b_phases: the parent's K3f / K3b {label} disagree with plain")
        turns = _time_rounds({"K3f parent 1": old_f, "K3f 1": fwd["full"], "K3f 2": fwd["full"],
                              "K3f parent 2": old_f, "K3b parent 1": old_b, "K3b 1": bwd["full"],
                              "K3b 2": bwd["full"], "K3b parent 2": old_b,
                              "K3f plain": lambda: K.mlp_forward_saved_reference(*fargs),
                              "K3b plain": lambda: K.mlp_backward_saved_reference(
                                  x, g, ws, bs, skips, acts)}, reps, graph_ms)
        print(f"[turns] {label}, us (parent, new, new, parent; plain): " + " ".join(
            f"{k}={v * 1e3:.2f}" for k, v in turns.items()))


# the row counts of the engines' crossover sweep
K3_SWEEP_ROWS = (256, 1024, 4096, 16384, 65536, 70001, 262144)


def k3_sweep(chip_smoke, K, lib, reps):
    """K3f (saving) and K3b (from saved outputs) on both engines, in turns
    (cluster, rows, rows, cluster), and their plain versions, at every row
    count of K3_SWEEP_ROWS and the widths of the warps' CondMLPs (the dense
    map and the post-warp, chip_smoke.K3_WARP_SHAPES), each timed by
    CUDA-graph replay; then the crossover: the fewest swept rows from which
    the row engine's K3f + K3b beat the cluster engine's at every larger
    count and both shapes."""
    import torch

    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    shapes = [s for s in chip_smoke.K3_WARP_SHAPES if s[1] == 262144]
    wins = {}
    for label, _, C, widths, skips, final_act in shapes:
        for rows in K3_SWEEP_ROWS:
            x, ws, bs, g = _k3_inputs(chip_smoke, gen, rows, C, widths, skips)
            acts = {e: K._launch_k3f(lib, x, ws, bs, skips, final_act, K._stream(x.device), True,
                                     engine=e)[1] for e in ("cluster", "rows")}

            def f(e):
                return lambda: K._launch_k3f(lib, x, ws, bs, skips, final_act,
                                             K._stream(x.device), True, engine=e)

            def b(e):
                return lambda: K._launch_k3b(lib, x, g, ws, bs, skips, acts[e],
                                             K._stream(x.device), engine=e)

            inner = 3 if rows > 4096 else 20
            t = _time_rounds({"K3f cluster 1": f("cluster"), "K3f rows 1": f("rows"),
                              "K3f rows 2": f("rows"), "K3f cluster 2": f("cluster"),
                              "K3b cluster 1": b("cluster"), "K3b rows 1": b("rows"),
                              "K3b rows 2": b("rows"), "K3b cluster 2": b("cluster"),
                              "K3f plain": lambda: K.mlp_forward_saved_reference(
                                  x, ws, bs, skips, final_act),
                              "K3b plain": lambda: K.mlp_backward_saved_reference(
                                  x, g, ws, bs, skips, acts["rows"])},
                             reps, lambda fn: chip_smoke.device_ms(fn, inner))
            cl = min(t["K3f cluster 1"], t["K3f cluster 2"]) + min(t["K3b cluster 1"],
                                                                    t["K3b cluster 2"])
            rw = max(t["K3f rows 1"], t["K3f rows 2"]) + max(t["K3b rows 1"], t["K3b rows 2"])
            wins[(label, rows)] = rw < cl
            print(f"[k3-sweep] {label} rows={rows}, ms: " + " ".join(
                f"{k}={v:.4f}" for k, v in t.items())
                + f"; K3f+K3b cluster {cl:.4f} (best turn) / rows {rw:.4f} (worst turn)")
    cross = next((r for r in K3_SWEEP_ROWS
                  if all(wins[(s[0], q)] for s in shapes for q in K3_SWEEP_ROWS if q >= r)), None)
    print(f"[k3-sweep] crossover: the row engine wins from {cross} rows on at both shapes "
          f"(relu_mlp_plan's K3_ROWS_MIN: {K.K3_ROWS_MIN})")


def _shape_inputs(chip_smoke, gen, shape):
    """fused_pe_mlp's arguments at one of chip_smoke.K4_SHAPES, and an output
    gradient, as chip_smoke makes them."""
    import torch

    label, rows, n_freqs, widths, skips, final_act, window = shape
    c_x = 3 * (2 * n_freqs + 1)
    weights, biases = chip_smoke._mlp_params(c_x, 0, 0, gen, "cuda", widths=list(widths), skips=skips)
    x = ((torch.rand(rows, 3, generator=gen) * 2 - 1) * 0.5).cuda()
    win = torch.linspace(0.3, 1.0, n_freqs).cuda() if window else None
    freqs = tuple(float(2.0**i) for i in range(n_freqs))
    g = torch.randn(rows, widths[-1], generator=gen).cuda()
    return (x, win, weights, biases, freqs, skips, final_act), g


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--parent", default=None, help="root of a checkout to time in turns")
    parser.add_argument("--k3_only", action="store_true", help="profile K3f / K3b only")
    parser.add_argument("--k4_only", action="store_true", help="profile K4f / K4b only")
    parser.add_argument("--k3_sweep", action="store_true",
                        help="time K3's two engines across row counts (then stop)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_k4b_phases: no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from pathlib import Path

    import chip_smoke
    from lab4d_tpu_torch.ops import mlp_kernel as K
    from lab4d_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR

    card = chip_smoke.phase_env()
    if args.k3_sweep:
        k3_sweep(chip_smoke, K, K._kernel_lib("fused_relu_mlp"), args.reps)
        print(card)
        return
    out_dir = str(BUILD_DIR / "k4_phases")
    main_src = "fused_pe_mlp.cu"
    pdir = Path(args.parent) / "lab4d_tpu_torch" / "csrc" if args.parent else None
    mains = (() if args.k4_only else ("fused_relu_mlp.cu",)) + (() if args.k3_only else (main_src,))
    procs = {}
    if not args.k4_only:
        procs["k3"] = PH.start_copies(CSRC_DIR, K3_COPIES, os.path.join(out_dir, "k3"),
                                      "fused_relu_mlp.cu")
    if not args.k3_only:
        procs["k4"] = PH.start_copies(CSRC_DIR, {**K4F_COPIES, **K4B_COPIES},
                                      os.path.join(out_dir, "new"), main_src)
    pprocs = {m: PH.start_copies(pdir, {"parent": []}, os.path.join(out_dir, "parent", m), m)
              for m in mains} if pdir else {}
    pmk = None
    if pdir:
        plibs = {m[:-3]: PH.finish_copies(pprocs[m], os.path.join(out_dir, "parent", m), m)["parent"]
                 for m in mains}
        pmk = load_parent_mlp_kernel(args.parent, plibs)
    if not args.k4_only:
        k3_libs = PH.finish_copies(procs["k3"], os.path.join(out_dir, "k3"), "fused_relu_mlp.cu")
        for lib in k3_libs.values():
            K.bind_signatures("fused_relu_mlp", lib)
        k3_profile(chip_smoke, K, k3_libs, pmk, args.reps)
    if args.k3_only:
        print(card)
        return
    libs = PH.finish_copies(procs["k4"], os.path.join(out_dir, "new"), main_src)
    for lib in libs.values():
        K.bind_signatures("fused_pe_mlp", lib)
    stream = K._stream(torch.device("cuda"))
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    tol = chip_smoke.KERNEL_TOL

    for shape in chip_smoke.K4_SHAPES + chip_smoke.K4_CATEGORY_SHAPES + [chip_smoke.K4_RAGGED]:
        label, rows = shape[:2]
        small = rows < 4096
        if small and pmk is None:
            continue
        fargs, g = _shape_inputs(chip_smoke, gen, shape)
        x, win, weights, biases, freqs, skips, final_act = fargs
        want, want_acts = K.pe_mlp_forward_saved_reference(*fargs)
        got, acts, _ = K._launch_pe_fwd(libs["full"], *fargs, stream, True)
        torch.cuda.synchronize()
        err = max(float((got - want).abs().max()), float((acts - want_acts).abs().max()))
        print(f"[k4f] {label}: full vs plain, output and saved outputs: max abs err {err:.3e} "
              f"(tol {tol:g})")
        if not err <= tol:
            sys.exit(f"profile_k4b_phases: K4f {label} disagrees with its plain version")
        if not small:
            _anatomy(K, libs, fargs, g, acts, stream, args.reps, label)
        if pmk is None:
            continue
        # a parent whose K4b runs from K4f's saved outputs (PR 5 on) times
        # its saving K4f and that K4b; the row-tiled one recomputes them
        # (checked against the plain VJP from its own saved outputs, as K4b
        # is: a recomputed forward differs at the ReLU ties)
        kw = {}
        if "saved" in inspect.signature(pmk.fused_pe_mlp_backward).parameters:
            kw["saved"] = pmk.pe_mlp_forward_saved(*fargs)[1]
            pwant = K.pe_mlp_backward_saved_reference(x, g, win, weights, biases, freqs, skips,
                                                      kw["saved"])
        else:
            pwant = K.pe_mlp_backward_reference(x, g, win, weights, biases, freqs, skips)
        pgot = pmk.fused_pe_mlp_backward(x, g, win, weights, biases, freqs, skips, **kw)
        perr = max(float((pmk.fused_pe_mlp(*fargs) - want).abs().max()),
                   chip_smoke._bwd_errs(pgot, pwant)[1])
        torch.cuda.synchronize()
        print(f"[parent] {label}: the parent's K4f abs err / K4b rel err vs plain, worst {perr:.3e} "
              f"(tol {tol:g})")
        if not perr <= tol:
            sys.exit(f"profile_k4b_phases: the parent's K4f / K4b {label} disagree with plain")
        # the stream is looked up per call, as the wrappers do: under CUDA
        # graph capture (graph_ms) it is the capturing stream
        new_f = lambda: K._launch_pe_fwd(libs["full"], *fargs, K._stream(x.device), True)  # noqa: E731
        new_b = lambda: K._launch_pe_bwd(libs["full"], x, g, win, weights, biases, freqs,  # noqa: E731
                                         skips, acts, K._stream(x.device))
        old_f = (lambda: pmk.pe_mlp_forward_saved(*fargs)) if kw else (lambda: pmk.fused_pe_mlp(*fargs))
        old_b = lambda: pmk.fused_pe_mlp_backward(x, g, win, weights, biases, freqs, skips, **kw)  # noqa: E731
        turns = _time_rounds({"K4f parent 1": old_f, "K4f 1": new_f, "K4f 2": new_f,
                              "K4f parent 2": old_f, "K4b parent 1": old_b, "K4b 1": new_b,
                              "K4b 2": new_b, "K4b parent 2": old_b}, args.reps,
                             chip_smoke.device_ms if small else None)
        print(f"[turns] {label}, ms (parent, new, new, parent): " + " ".join(
            f"{k}={v:.4f}" for k, v in turns.items()))
    print(card)


if __name__ == "__main__":
    main()
