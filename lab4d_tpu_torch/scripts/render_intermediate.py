"""Turntable videos of the per-round intermediate geometry (proxy meshes,
camera frusta) that the trainer exports, through the port's splat
rasterizer (utils/raster.py): the port of scripts/render_intermediate.py,
the same flags (absl's boolean forms too: --show_cams, --noshow_cams,
--show_cams=true).

    python -m lab4d_tpu_torch.scripts.render_intermediate --testdir logdir/<seq>-<log> \\
        [--data_class fg] [--res 512] [--show_cams]

Writes <testdir>/intermediate-<data_class>.mp4 (one png per frame where
OpenCV has no video backend).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--testdir", default="", help="run dir, e.g. logdir/seq-log")
    p.add_argument("--data_class", default="fg", help="fg | bg")
    p.add_argument("--res", type=int, default=512, help="render resolution")
    p.add_argument("--num_views", type=int, default=12, help="turntable frames per round")
    p.add_argument("--show_cams", action=argparse.BooleanOptionalAction, default=False,
                   help="composite camera frusta mesh")
    return p


def render_intermediate(testdir, data_class="fg", res=512, num_views=12, show_cams=False):
    """One frame per round's "<round>-<data_class>-proxy.obj", the camera
    circling the run; returns the uint8 frames."""
    from lab4d_tpu_torch.meshlib import concatenate, load_obj
    from lab4d_tpu_torch.utils.io import save_video
    from lab4d_tpu_torch.utils.raster import look_at, render_mesh

    proxy_paths = sorted(glob.glob(f"{testdir}/*-{data_class}-proxy.obj"))
    if not proxy_paths:
        print(f"no proxy meshes for {data_class} under {testdir}")
        return []

    frames = []
    for round_idx, path in enumerate(proxy_paths):
        mesh = load_obj(path)
        if show_cams:
            cam_path = path.replace("proxy", "cams")
            if os.path.exists(cam_path):
                mesh = concatenate([mesh, load_obj(cam_path)])
        verts = np.asarray(mesh.vertices)
        if len(verts) == 0:
            continue
        center = (verts.max(0) + verts.min(0)) / 2
        radius = max(float(np.linalg.norm(verts - center, axis=-1).max()), 1e-3)
        K = np.array([res, res, res / 2, res / 2], float)
        ang = 2 * np.pi * round_idx / max(len(proxy_paths), 1)
        eye = center + 2.5 * radius * np.array(
            [np.sin(ang) * 0.97, 0.26, -np.cos(ang) * 0.97]
        )
        img = render_mesh(verts, np.asarray(mesh.faces), look_at(eye, center), K, res)
        frames.append((img * 255).astype(np.uint8))

    out = f"{testdir}/intermediate-{data_class}.mp4"
    save_video(np.stack(frames), out)
    print(f"saved {len(frames)} intermediate frames to {out}")
    return frames


def main(argv=None):
    from lab4d_tpu_torch.flagfile import parse_opts

    opts = parse_opts(parser(), argv)
    return render_intermediate(opts["testdir"], opts["data_class"], opts["res"],
                               opts["num_views"], opts["show_cams"])


if __name__ == "__main__":
    main()
