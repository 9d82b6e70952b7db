"""Where the time of K1 and K2 goes at the flagship fg step, on one CUDA
device: the port of scripts/perf/bench_kernel_anatomy.py as a phase
profiler.

    python3 -m lab4d_tpu_torch.tools.profile_heads_phases [--reps N] [--parent DIR]

Run from the root of a checkout. It compiles patched copies of
csrc/nerf_heads.cu (one nvcc each, all at once) into
build/lab4d_tpu_torch/heads_phases/ and times them in turns at the
flagship step's shape (chip_smoke.py's _flagship_heads: 262,144 points,
1024 per pair, heads D5 W128). K1's copies, as the TPU harness named them:

- full: the kernel as it is;
- emb: without the final elementwise work (the density's Laplace CDF,
  the sigmoid, the feature's L2 normalisation);
- mm: as emb, and the embeddings without sin / cos (the angle itself):
  the matmul chain;
- mmpure: the same multiply-adds per point as 14 plain 128 x 128 layers
  (no skips, no narrow layers, no embedding);
- mmwide: as mm, with the narrow layers (rgb2, the visibility and
  feature outputs) 128 wide;
- mm-tf32: as mm, in plain 1xTF32 (one product per k-step instead of
  three): the reduced-precision counterpart on this card, which prices
  the 3xTF32 split. Timed only: it misses the kernels' tolerance;
- no-wstage: the full kernel without its weight staging (the slabs keep
  stale values): what streaming the weights from L2 costs.

A copy with a phase off computes other outputs; only `full` is checked
(against nerf_heads_reference, at chip_smoke.KERNEL_TOL) and the others
are timed. K2 is a sequence of launches; one call with a CUDA event after
each launch gives each kind of launch its share (the output cotangents,
the embeddings, dW, dIn, the dx fold, the appearance pass, the reduction).

--parent DIR: the root of a checkout whose K1 / K2 are the row-tiled fp32
FMA design (nerf_heads.cu on mlp_tiles.cuh, as at commit 8c61d93). Its K1 anatomy copies (full, emb, mm,
mmpure) and its K2 copies (full; no_rmw: without the workspace
read-modify-write; no_wgrad: without the weight-gradient products) are
built from DIR and timed too, and its K1 / K2 are timed in turns with
this checkout's (parent, new, new, parent per round). Its wrapper,
DIR/lab4d_tpu_torch/ops/field_kernel.py, is loaded under another name.

Each round times every copy in turn (CUDA events around 5 back-to-back
calls, after one warm-up call); the median over `--reps` rounds is
printed, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

# The anatomy copies of the row-tiled fp32 FMA design: (file, anchor,
# replacement) per copy; the files are DIR's nerf_heads.cu and mlp_tiles.cuh.
_TM_EMB = [
    ("nerf_heads.cu",
     "      density[row0 + r] = (0.5f + 0.5f * nh_sign(s) * expm1f(-fabsf(s) * ib)) * ib;",
     "      density[row0 + r] = s * ib;"),
    ("nerf_heads.cu",
     "    y[(size_t)(row0 + r) * NH_RGB + o] = nh_sigmoid(v + __ldg(b + o));",
     "    y[(size_t)(row0 + r) * NH_RGB + o] = v + __ldg(b + o);"),
    ("nerf_heads.cu",
     "      const float denom = fmaxf(sqrtf(ss + 1e-12f), 1e-6f);\n"
     "      for (int j = 0; j < a.feat_dim; ++j)\n        feat[",
     "      const float denom = 1.f + 0.f * ss;\n"
     "      for (int j = 0; j < a.feat_dim; ++j)\n        feat["),
]
_TM_MM = _TM_EMB + [
    ("nerf_heads.cu", "      v = k < C + FC ? sinf(ang) : cosf(ang);", "      v = ang;"),
]
TM_K1 = {
    "full": [],
    "emb": _TM_EMB,
    "mm": _TM_MM,
    "mmpure": _TM_MM + [(
        "nerf_heads.cu",
        "    // base MLP -> feat (final ReLU) in F; density from the sdf head\n",
        "    for (int l = 0; l < 14; ++l)\n"
        "      tm_gemm<true>(hb.w1[1], 128, 128, KSegs{pp[(l + 1) & 1], 128, pp[(l + 1) & 1], 0, ts},\n"
        "                    tr, as, a.stage_ld, TmEpiHidden{pp[l & 1], hb.b[1], ts});\n"
        "    if (threadIdx.x < tr) vis[row0 + threadIdx.x] = pp[1][threadIdx.x];\n"
        "    continue;\n",
    )],
}
TM_K2 = {
    "full": [],
    "no_rmw": [
        ("mlp_tiles.cuh",
         "    if (!first) {\n#pragma unroll\n      for (int i = 0; i < 4; ++i)",
         "    if (0) {\n#pragma unroll\n      for (int i = 0; i < 4; ++i)"),
        ("mlp_tiles.cuh",
         "        if (j < n_o && k < K) dw[(size_t)j * K + k] = acc[i][q];",
         "        if (j < n_o && k < K && acc[i][q] == 12345.f) dw[(size_t)j * K + k] = acc[i][q];"),
    ],
    "no_wgrad": [
        ("mlp_tiles.cuh",
         "  const int n_jt = (n_o + 3) / 4, n_kb = (K + 127) / 128;",
         "  if (n_o > 0) return;\n  const int n_jt = (n_o + 3) / 4, n_kb = (K + 127) / 128;"),
    ],
}

# The anatomy copies of this checkout's K1 (csrc/nerf_heads.cu on
# csrc/heads_mma.cuh).
_MMA_EMB = [
    ("nerf_heads.cu",
     "    density[row0 + r] = (0.5f + 0.5f * nh_sign(s) * expm1f(-fabsf(s) * ib)) * ib;",
     "    density[row0 + r] = s * ib;"),
    ("nerf_heads.cu",
     "    y[(size_t)(row0 + m) * NH_RGB + n] = nh_sigmoid(v + __ldg(b + n));",
     "    y[(size_t)(row0 + m) * NH_RGB + n] = v + __ldg(b + n);"),
    ("nerf_heads.cu",
     "    const float denom = fmaxf(sqrtf(ss + 1e-12f), 1e-6f);\n"
     "    for (int j = 0; j < a.feat_dim; ++j) feat[",
     "    const float denom = 1.f + 0.f * ss;\n"
     "    for (int j = 0; j < a.feat_dim; ++j) feat["),
]
_MMA_MM = _MMA_EMB + [
    ("nerf_heads.cu", "  float v = k < C + FC ? sinf(ang) : cosf(ang);", "  float v = ang;"),
]
MMA_K1 = {
    "full": [],
    "emb": _MMA_EMB,
    "mm": _MMA_MM,
    "mmpure": _MMA_MM + [(
        "nerf_heads.cu",
        "  // base MLP -> feat (final ReLU) in F; density from the sdf head\n",
        "  for (int l = 0; l < 14; ++l)\n"
        "    nh_layer(NhActIn{pp[(l + 1) & 1], ldh, 128, pp[(l + 1) & 1], ldh, 128},\n"
        "             nh_pk(wpk, hb, 1), 128, 128, wsl, NhEpiRelu{pp[l & 1], ldh, hb.b[1]});\n"
        "  if (threadIdx.x < NH_TR) vis[row0 + threadIdx.x] = pp[1][threadIdx.x * ldh];\n"
        "  return;\n",
    )],
    # the last layers of the heads and rgb2 128 wide, on the base head's
    # 128 x 128 layer-1 weight
    "mmwide": _MMA_MM + [
        ("nerf_heads.cu",
         "      nh_layer(in, nh_pk(wpk, h, l), h.out_dim[l], h.in_dim[l], wsl, epi_last);",
         "      nh_layer(in, NhPk{wpk + a.head[0].pk_off[1], nh_kp(h.in_dim[l])}, 128, h.in_dim[l],\n"
         "               wsl, epi_last);"),
        ("nerf_heads.cu",
         "    if (y != nullptr) y[(size_t)(row0 + m) * n_out + n] = o;",
         "    if (y != nullptr && n < n_out) y[(size_t)(row0 + m) * n_out + n] = o;"),
        ("nerf_heads.cu",
         "           NhPk{wpk + a.pk_rgb2, nh_kp(a.rgb_hidden)}, NH_RGB, a.rgb_hidden, wsl,\n"
         "           NhEpiSigmoidOut{rgb, a.b_rgb2, row0});",
         "           NhPk{wpk + hb.pk_off[1], nh_kp(a.rgb_hidden)}, 128, a.rgb_hidden, wsl,\n"
         "           NhEpiOut{rgb, pp[0], ldh, hb.b[1], row0, NH_RGB});"),
    ],
    "mm-tf32": _MMA_MM + [
        ("heads_mma.cuh",
         "  hm_mma0(t, al, bh0, bh1);\n  hm_mma(t, ah, bl0, bl1);\n  hm_mma(t, ah, bh0, bh1);\n",
         "  hm_mma0(t, ah, bh0, bh1);\n"),
    ],
    # a diagnostic: the weight slabs are never loaded (stale shared memory)
    "no-wstage": [(
        "nerf_heads.cu",
        "      hm_cp16(dst + half * NH_NMAX * NH_LDS + n * NH_LDS + q,",
        "      if (0) hm_cp16(dst + half * NH_NMAX * NH_LDS + n * NH_LDS + q,",
    )],
}
# what each kind of K2 launch is (csrc/nerf_heads.cu:lab4d_nerf_heads_bwd)
K2_KINDS = ("output cotangents", "embedding", "dW", "dIn", "dx fold", "appearance", "reduction",
            "weight split")


def patched_sources(csrc, patches, main="nerf_heads.cu"):
    """{file name: text} of csrc's `main` source and headers with the
    patches applied; each anchor must occur exactly once."""
    texts = {p.name: p.read_text() for p in sorted(csrc.glob("*.cuh"))}
    texts[main] = (csrc / main).read_text()
    for fname, anchor, repl in patches:
        if texts[fname].count(anchor) != 1:
            raise RuntimeError(f"the anchor {anchor[:50]!r}... is not in {fname} exactly once")
        texts[fname] = texts[fname].replace(anchor, repl)
    return texts


def start_copies(csrc, copies, out_dir, main="nerf_heads.cu"):
    """Write csrc's `main` source and headers once per copy ({name:
    patches}) into out_dir/<name>/ and start one nvcc on each; returns
    {name: process}."""
    from lab4d_tpu_torch.ops.build import NVCC_FLAGS, find_nvcc

    stem = main.rsplit(".", 1)[0]
    procs = {}
    for name, patches in copies.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for fname, text in patched_sources(csrc, patches, main).items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", os.path.join(d, f"lib{stem}.so"),
               os.path.join(d, main)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return procs


def finish_copies(procs, out_dir, main="nerf_heads.cu"):
    """Wait for start_copies' compilers; returns {name: CDLL}."""
    stem = main.rsplit(".", 1)[0]
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy of {main}:\n{err}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, name, f"lib{stem}.so"))
    return libs


def build_copies(csrc, copies, out_dir, main="nerf_heads.cu"):
    """Compile `main` of csrc once per copy, all at once; returns {name:
    CDLL}."""
    return finish_copies(start_copies(csrc, copies, out_dir, main), out_dir, main)


def anatomy_round(FK, libs, heads, stream, reps):
    """K1's anatomy copies (libs, bound by FK.bind_signatures): `full`
    against nerf_heads_reference, then {copy: median ms} over reps rounds;
    returns (max abs error of full, times)."""
    from lab4d_tpu_torch.tools.profile_k4b_phases import _time_rounds

    err = check_full(FK, libs["full"], heads, stream)
    runs = {n: (lambda lib=lib: FK._launch_fwd(lib, *heads, stream, save=False))
            for n, lib in libs.items()}
    return err, _time_rounds(runs, reps)


def load_parent_wrapper(root):
    """DIR/lab4d_tpu_torch/ops/field_kernel.py as the module
    parent_field_kernel (it imports this checkout's unchanged modules)."""
    path = os.path.join(root, "lab4d_tpu_torch", "ops", "field_kernel.py")
    spec = importlib.util.spec_from_file_location("parent_field_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _print(tag, what, times, base="full"):
    for name, ms in times.items():
        print(f"[{tag}] {what} {name}: {ms:.3f} ms ({base} - this: {times[base] - ms:.3f} ms)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--parent", default=None, help="root of a checkout of the row-tiled K1 / K2")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_heads_phases: no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from pathlib import Path

    import chip_smoke
    from lab4d_tpu_torch.ops import mlp_kernel as K
    from lab4d_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR
    from lab4d_tpu_torch.tools.profile_k4b_phases import _time_rounds

    card = chip_smoke.phase_env()
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    heads, g = chip_smoke._flagship_heads(gen)
    x, P = heads[0], heads[0].shape[0]
    n_sm, stream = K._n_sm(x.device), K._stream(x.device)
    out_dir = BUILD_DIR / "heads_phases"

    if args.parent:
        pfk = load_parent_wrapper(args.parent)
        pcsrc = Path(args.parent) / "lab4d_tpu_torch" / "csrc"
        libs = build_copies(pcsrc, {**{f"k1-{n}": p for n, p in TM_K1.items()},
                                    **{f"k2-{n}": p for n, p in TM_K2.items() if n != "full"}},
                            str(out_dir / "parent"))
        for lib in libs.values():
            pfk.bind_signatures(lib)
        libs_parent_full = libs["k1-full"]
        want = pfk.nerf_heads_reference(*heads)
        got = pfk._launch_fwd(libs["k1-full"], *heads, stream)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        print(f"[parent] K1 full vs plain: max abs err {err:.3e} (tol {chip_smoke.KERNEL_TOL:g})")
        if not err <= chip_smoke.KERNEL_TOL:
            sys.exit("profile_heads_phases: the parent's K1 disagrees with its plain version")
        k1 = {n: (lambda lib=libs[f"k1-{n}"]: pfk._launch_fwd(lib, *heads, stream)) for n in TM_K1}
        _print("parent-k1", f"{P} points", _time_rounds(k1, args.reps))
        k2 = {n: (lambda lib=libs[f"k1-full" if n == "full" else f"k2-{n}"]:
                  pfk._launch_bwd(lib, x, g, *heads[1:], n_sm, stream)) for n in TM_K2}
        _print("parent-k2", f"{P} points", _time_rounds(k2, args.reps))

    from lab4d_tpu_torch.ops import field_kernel as FK

    libs = build_copies(CSRC_DIR, MMA_K1, str(out_dir / "new"))
    for lib in libs.values():
        FK.bind_signatures(lib)
    err, times = anatomy_round(FK, libs, heads, stream, args.reps)
    print(f"[heads-anatomy] K1 full vs plain: max abs err {err:.3e} (tol {chip_smoke.KERNEL_TOL:g})")
    if not err <= chip_smoke.KERNEL_TOL:
        sys.exit("profile_heads_phases: K1 disagrees with its plain version")
    _print("heads-anatomy", f"K1, {P} points", times)

    lib = FK._kernel_lib()
    *outs, acts = FK._launch_fwd(lib, *heads, stream, save=True)
    phases = k2_phases(FK, lib, heads, g, acts, outs[1], stream, args.reps)
    print(f"[k2-phases] {phases.pop('launches')} CUDA launches per call")
    for name, ms in phases.items():
        print(f"[k2-phases] {name}: {ms:.3f} ms")
    if args.parent:  # the row-tiled kernels and this checkout's in turns
        runs = {
            "K1 row-tiled": lambda: pfk._launch_fwd(libs_parent_full, *heads, stream),
            "K1 (saving for K2)": lambda: FK._launch_fwd(lib, *heads, stream, save=True),
            "K1 (no saving)": lambda: FK._launch_fwd(lib, *heads, stream, save=False),
            "K2 row-tiled": lambda: pfk._launch_bwd(libs_parent_full, x, g, *heads[1:], n_sm, stream),
            "K2": lambda: FK._launch_bwd(lib, x, g, *heads[1:], acts, outs[1], stream),
        }
        for name, ms in _time_rounds(runs, args.reps).items():
            print(f"[turns] {name}: {ms:.3f} ms")
    print(card)


def check_full(FK, lib, heads, stream):
    """Max abs error of a K1 copy against nerf_heads_reference."""
    import torch

    got = FK._launch_fwd(lib, *heads, stream)
    want = FK.nerf_heads_reference(*heads)
    torch.cuda.synchronize()
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def k2_phases(FK, lib, heads, g, acts, rgb, stream, reps):
    """{kind: median ms per K2 call} from CUDA events between its launches
    (after one warm-up call), and the launches of one call, as 'launches'."""
    import numpy as np
    import torch

    x = heads[0]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(64)]
    for e in events:  # creates each event
        e.record()
    per = []
    for _ in range(reps + 1):
        kinds = FK._launch_bwd(lib, x, g, *heads[1:], acts, rgb, stream, events=events)[-1]
        torch.cuda.synchronize()
        t = {k: 0.0 for k in K2_KINDS}
        for i, kind in enumerate(kinds):
            t[K2_KINDS[kind]] += events[i].elapsed_time(events[i + 1])
        t["total"] = events[0].elapsed_time(events[len(kinds)])
        per.append(t)
    out = {k: float(np.median([t[k] for t in per[1:]])) for k in per[0]}
    out["launches"] = len(kinds)
    return out


if __name__ == "__main__":
    main()
