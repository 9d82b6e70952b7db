"""Where the time of K1 and K2 goes at the flagship fg step, on one CUDA
device: the port of scripts/perf/bench_kernel_anatomy.py as a phase
profiler.

    python3 -m lab4d_tpu_torch.tools.profile_heads_phases [--reps N] [--parent DIR]

Run from the root of a checkout. It compiles patched copies of
csrc/nerf_heads.cu (one nvcc each, all at once) into
build/lab4d_tpu_torch/heads_phases/ and times them in turns at the
flagship step's shape (chip_smoke.py's _flagship_heads: 262,144 points,
1024 per pair, heads D5 W128). K1's copies of the wgmma engine:

- full: the kernel as it is;
- no-math: without its products (the weight slabs' stream through the
  ring, A's loads and splits, the epilogues and the stores);
- mm-1x: one TF32 product per k8 step instead of three: the
  reduced-precision counterpart on this card, which prices the 3xTF32
  split. Timed only: it misses the kernels' tolerance;
- no-wstage: without the TMA copies of the weight slabs (each slot's
  barrier completes at once and the slabs keep stale values): what
  streaming the weights from L2 costs.

Each copy runs as training does, saving its layer outputs for K2, and
`no-save` is the full kernel without saving. A copy with a phase off
computes other outputs; only `full` is checked (against
nerf_heads_reference, at chip_smoke.KERNEL_TOL). K2 is 4 launches; one
call with a CUDA event after each launch gives each its share (the weight
split, the dIn engine, dW with the appearance pairs, the reduction), on
the full kernel and on every copy: K1's (whose products and weight stream
K2's dIn shares) and K2's own: dw-no-math (dW without its products),
dw-no-a (without A's copies), din-no-masks (dIn without the ReLU masks'
loads), din-no-gput (without storing G for dW).

--parent DIR: the root of a checkout of an earlier commit (e.g. `git
archive HEAD~1 | tar -x -C tmp/parent`; the mma.sync K1 / K2 are
1683f23). Its nerf_heads.cu is built from DIR with DIR's headers and
its wrapper, DIR/lab4d_tpu_torch/ops/field_kernel.py, is loaded under
another name; whether its K1 (outputs and saved layer outputs) and K2
give bitwise the results of this checkout's is printed, and its K1
(saving, and without saving) and its K2 are timed in turns with this
checkout's (parent, new, new, parent per round).

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

# The anatomy copies of K1 (csrc/nerf_heads.cu): (file, anchor, replacement);
# the pass and the weight ring are csrc/wg_engine.cuh's, which K4f / K4b
# share
_PRODUCTS = ("      rw_mma<NW>(acc, al[j], dh, j);\n      rw_mma<NW>(acc, ah[j], dl, 1);\n"
             "      rw_mma<NW>(acc, ah[j], dh, 1);")
K1_COPIES = {
    "full": [],
    "no-math": [("wg_engine.cuh", _PRODUCTS, "      if (0) {\n" + _PRODUCTS + "\n      }")],
    "mm-1x": [("wg_engine.cuh", _PRODUCTS, "      rw_mma<NW>(acc, ah[j], dh, j);")],
    "no-wstage": [(
        "wg_engine.cuh",
        "      rw_bulk_load(ring + i * Feed::kSlot, src, bytes, full + i);",
        "      asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\" ::\"r\"(rw_addr(full + i)));",
    ), (
        "wg_engine.cuh",
        "    rw_bulk_load(ring + slot * Feed::kSlot, src, bytes, full + slot);",
        "    asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\" ::\"r\"(rw_addr(full + slot)));",
    )],
}
# K2's anatomy copies; K2 is also timed on K1's copies, whose products and
# weight stream are those of K2's dIn too
_DW_PRODUCTS = ("      rw_mma<NWO>(acc, al[j], dh, j);\n      rw_mma<NWO>(acc, ah[j], dl, 1);\n"
                "      rw_mma<NWO>(acc, ah[j], dh, 1);")
K2_COPIES = {
    # dW without its products; without A's copies (the tiles keep stale values)
    "dw-no-math": [("wg_engine.cuh", _DW_PRODUCTS, "      if (0) {\n" + _DW_PRODUCTS + "\n      }")],
    "dw-no-a": [
        ("wg_engine.cuh", "    for (int i = 0; i < S.n; ++i) bytes += slab_rows * 4u * S.ld[i];", ""),
        ("wg_engine.cuh", "  if (t < S.n && nr > 0)\n    nh_bulk(", "  if (0)\n    nh_bulk("),
    ],
    # dIn without the ReLU masks' loads (every unit on); without storing G for dW
    "din-no-masks": [("wg_engine.cuh",
                      "      w[i] = row < nr && k < n ? __ldg(act + (size_t)(r0 + row) * n + k) : 0.f;",
                      "      w[i] = row < nr && k < n ? 1.f : 0.f;")],
    "din-no-gput": [("wg_engine.cuh",
                     "  for (int e = threadIdx.x & 127; e < (NH_HALF / 4) * nwo; e += 128) {",
                     "  for (int e = threadIdx.x & 127; e < 0; e += 128) {")],
}
# what each kind of K2 launch is (csrc/nerf_heads.cu:lab4d_nerf_heads_bwd)
K2_KINDS = {7: "weight split", 3: "dIn engine", 2: "dW and appearance pairs", 6: "reduction"}


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
    """K1's anatomy copies (libs, bound by FK.bind_signatures), each saving
    its layer outputs, and `no-save` (full without saving): `full` against
    nerf_heads_reference, then {copy: median ms} over reps rounds; returns
    (max abs error of full, times)."""
    from lab4d_tpu_torch.tools.profile_k4b_phases import _time_rounds

    err = check_full(FK, libs["full"], heads, stream)
    runs = {n: (lambda lib=lib: FK._launch_fwd(lib, *heads, stream, save=True))
            for n, lib in libs.items()}
    runs["no-save"] = lambda: FK._launch_fwd(libs["full"], *heads, stream, save=False)
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
    parser.add_argument("--parent", default=None, help="root of a checkout of an earlier commit")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_heads_phases: no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from pathlib import Path

    import chip_smoke
    from lab4d_tpu_torch.ops import field_kernel as FK
    from lab4d_tpu_torch.ops import mlp_kernel as K
    from lab4d_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR
    from lab4d_tpu_torch.tools.profile_k4b_phases import _time_rounds

    card = chip_smoke.phase_env()
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    heads, g = chip_smoke._flagship_heads(gen)
    x, P = heads[0], heads[0].shape[0]
    stream = K._stream(x.device)
    out_dir = BUILD_DIR / "heads_phases"
    procs = start_copies(CSRC_DIR, {**K1_COPIES, **K2_COPIES}, str(out_dir / "new"))
    if args.parent:
        pprocs = start_copies(Path(args.parent) / "lab4d_tpu_torch" / "csrc", {"full": []},
                              str(out_dir / "parent"))
    libs = finish_copies(procs, str(out_dir / "new"))
    for lib in libs.values():
        FK.bind_signatures(lib)
    err, times = anatomy_round(FK, {n: libs[n] for n in K1_COPIES}, heads, stream, args.reps)
    print(f"[heads-anatomy] K1 full vs plain: max abs err {err:.3e} (tol {chip_smoke.KERNEL_TOL:g})")
    if not err <= chip_smoke.KERNEL_TOL:
        sys.exit("profile_heads_phases: K1 disagrees with its plain version")
    _print("heads-anatomy", f"K1, {P} points", times)

    lib = FK._kernel_lib()
    *outs, acts = FK._launch_fwd(lib, *heads, stream, save=True)
    for name, clib in libs.items():  # K2 by launch on every copy (from the same saved outputs)
        phases = k2_phases(FK, clib, heads, g, acts, outs[1], stream, args.reps)
        n = phases.pop("launches")
        print(f"[k2-phases] {name}: {n} CUDA launches; "
              + ", ".join(f"{k} {ms:.3f} ms" for k, ms in phases.items()))
    if args.parent:  # PR 4 / 5's mma.sync kernels and this checkout's in turns
        pfk = load_parent_wrapper(args.parent)
        plib = pfk.bind_signatures(finish_copies(pprocs, str(out_dir / "parent"))["full"])
        pouts = pfk._launch_fwd(plib, *heads, stream, save=True)
        want = FK.nerf_heads_reference(*heads)
        perr = max(float((a - b).abs().max()) for a, b in zip(pouts[:4], want))
        print(f"[parent] K1 vs plain: max abs err {perr:.3e} (tol {chip_smoke.KERNEL_TOL:g})")
        if not perr <= chip_smoke.KERNEL_TOL:
            sys.exit("profile_heads_phases: the parent's K1 disagrees with its plain version")
        pgrad = pfk._launch_bwd(plib, x, g, *heads[1:], pouts[4], pouts[1], stream)
        ngrad = FK._launch_bwd(lib, x, g, *heads[1:], acts, outs[1], stream)
        print(f"[parent] bitwise equal to the parent: K1 {tensors_equal(pouts, (*outs, acts))}, "
              f"K2 {tensors_equal(pgrad, ngrad)}")
        for what, old, new in (
            ("K1 (saving for K2)", lambda: pfk._launch_fwd(plib, *heads, stream, save=True),
             lambda: FK._launch_fwd(lib, *heads, stream, save=True)),
            ("K1 (no saving)", lambda: pfk._launch_fwd(plib, *heads, stream, save=False),
             lambda: FK._launch_fwd(lib, *heads, stream, save=False)),
            ("K2", lambda: pfk._launch_bwd(plib, x, g, *heads[1:], pouts[4], pouts[1], stream),
             lambda: FK._launch_bwd(lib, x, g, *heads[1:], acts, outs[1], stream)),
        ):
            t = _time_rounds({"parent a": old, "new a": new, "new b": new, "parent b": old}, args.reps)
            print(f"[turns] {what}: parent {t['parent a']:.3f} / new {t['new a']:.3f} / "
                  f"new {t['new b']:.3f} / parent {t['parent b']:.3f} ms")
    print(card)


def tensors_equal(a, b):
    """Whether every tensor of two nested sequences (other items skipped)
    is bitwise equal to its counterpart."""
    import torch

    def flat(v):
        if torch.is_tensor(v):
            return [v]
        if isinstance(v, (list, tuple)):
            return [t for u in v for t in flat(u)]
        if isinstance(v, dict):
            return [t for k in sorted(v) for t in flat(v[k])]
        return []

    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(torch.equal(u, w) for u, w in zip(fa, fb))


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
    events = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    for e in events:  # creates each event
        e.record()
    per = []
    for _ in range(reps + 1):
        kinds = FK._launch_bwd(lib, x, g, *heads[1:], acts, rgb, stream, events=events)[-1]
        torch.cuda.synchronize()
        t = {k: 0.0 for k in K2_KINDS.values()}
        for i, kind in enumerate(kinds):
            t[K2_KINDS[kind]] += events[i].elapsed_time(events[i + 1])
        t["total"] = events[0].elapsed_time(events[len(kinds)])
        per.append(t)
    out = {k: float(np.median([t[k] for t in per[1:]])) for k in per[0]}
    out["launches"] = len(kinds)
    return out


if __name__ == "__main__":
    main()
