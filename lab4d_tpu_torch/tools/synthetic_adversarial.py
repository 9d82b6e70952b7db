"""The adversarial synthetic scene of the port: the same articulated,
textured, self-occluding object under a fast orbit, with noisy camera
priors, in the database/processed/** layout, as tests/synthetic_adversarial.py
writes it, without the JAX package (JPEGs through utils/io.imwrite, byte for
byte what imageio writes; meshes through lab4d_tpu_torch.meshlib).

- **Articulated foreground**: a body sphere plus a limb sphere swinging
  around a joint on the body surface (several full swing cycles per
  video). A skeleton/bob warp has to fit a genuinely non-rigid motion.
- **High-frequency texture**: multi-band procedural stripes + checker on
  canonical surface coordinates.
- **Fast motion**: full camera orbit + vertical bobbing over the video
  and a fast limb swing produce flows of tens of pixels/frame at 256 px.
- **Occlusions**: the limb crosses in front of the body every cycle and
  the object self-occludes under the orbit; flow uncertainty is computed
  by depth-consistency (occluded pixels get uct=0).
- **Imperfect camera priors**: rotation noise on the prior cameras (the
  trainer's CameraMLP must correct them).

render_frame takes the camera as `cam_rt=` (the orbit's pose at t by
default), which the viewpoint trainer uses for its random views.

    python -m lab4d_tpu_torch.tools.synthetic_adversarial <root> [num_frames] [res]
"""

from __future__ import annotations

import os

import numpy as np

BODY_R = 0.5
LIMB_R = 0.24
JOINT = np.array([0.0, 0.0, BODY_R * 0.9])  # joint near body surface
LIMB_OFFSET = np.array([0.0, 0.0, LIMB_R * 1.5])  # rest: limb past joint


def limb_angle(t: float) -> float:
    """Swing angle (radians) at normalized time t in [0,1): 2.5 cycles,
    +/-75 degrees — fast, periodic, sign-changing."""
    return np.deg2rad(75.0) * np.sin(2 * np.pi * 2.5 * t)


def _rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def limb_center(t: float) -> np.ndarray:
    return JOINT + _rot_x(limb_angle(t)) @ LIMB_OFFSET


def cam_pose(t: float, dist: float = 2.6) -> np.ndarray:
    """Object-to-camera SE(3): fast orbit + vertical bobbing."""
    ang = 2 * np.pi * t
    elev = np.deg2rad(25.0) * np.sin(2 * np.pi * 1.5 * t)
    R_y = np.array(
        [
            [np.cos(ang), 0, -np.sin(ang)],
            [0, 1, 0],
            [np.sin(ang), 0, np.cos(ang)],
        ]
    )
    ce, se = np.cos(elev), np.sin(elev)
    R_x = np.array([[1, 0, 0], [0, ce, -se], [0, se, ce]])
    rt = np.eye(4)
    rt[:3, :3] = R_x @ R_y
    rt[2, 3] = dist
    return rt


def texture(pts_c: np.ndarray, part: np.ndarray) -> np.ndarray:
    """High-frequency procedural albedo from canonical coordinates."""
    x, y, z = pts_c[..., 0], pts_c[..., 1], pts_c[..., 2]
    stripes = 0.5 + 0.5 * np.sin(22 * x + 3 * np.sin(9 * y))
    checker = ((np.floor(7 * x) + np.floor(7 * y) + np.floor(7 * z)) % 2)
    rings = 0.5 + 0.5 * np.sin(30 * z)
    base = np.stack(
        [
            0.15 + 0.7 * stripes,
            0.2 + 0.6 * checker,
            0.25 + 0.6 * rings,
        ],
        -1,
    )
    limb_tint = np.array([0.9, 0.5, 0.25])
    return np.where(part[..., None] == 1, base * limb_tint, base)


def _sphere_hit(origin, dirs, center, radius):
    """Smallest positive ray parameter for |o + s d - c| = r (inf if miss)."""
    oc = origin - center
    b = 2 * dirs @ oc
    a = np.sum(dirs * dirs, -1)
    c = oc @ oc - radius**2
    disc = b**2 - 4 * a * c
    s = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), np.inf)
    return np.where(s > 1e-6, s, np.inf)


def render_frame(t: float, K, res: int, cam_rt=None):
    """Ray-trace the articulated union at normalized time t, seen from
    `cam_rt` (object-to-camera SE(3); cam_pose(t) when None).

    Returns rgb (res,res,3), mask, z-depth, canonical points, part ids
    (0=body, 1=limb), and deformed-space surface points.
    """
    rt = cam_pose(t) if cam_rt is None else cam_rt
    xs, ys = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
    fx, fy, cx, cy = K
    d = np.stack(
        [(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, dtype=np.float64)], -1
    )
    R = rt[:3, :3]
    tvec = rt[:3, 3]
    origin = -R.T @ tvec
    dirs = d @ R

    lc = limb_center(t)
    s_body = _sphere_hit(origin, dirs, np.zeros(3), BODY_R)
    s_limb = _sphere_hit(origin, dirs, lc, LIMB_R)
    s = np.minimum(s_body, s_limb)
    hit = np.isfinite(s)
    part = (s_limb < s_body).astype(np.int32)
    s_safe = np.where(hit, s, 0.0)
    pts = origin + s_safe[..., None] * dirs  # deformed/object space

    # canonical coordinates: body is rigid; limb un-rotates around joint
    Rl_inv = _rot_x(-limb_angle(t))
    pts_limb_c = (pts - JOINT) @ Rl_inv.T + JOINT
    pts_c = np.where(part[..., None] == 1, pts_limb_c, pts)

    # shading normals in deformed space
    n_body = pts / BODY_R
    n_limb = (pts - lc) / LIMB_R
    normal = np.where(part[..., None] == 1, n_limb, n_body)

    light = np.array([0.5, 0.7, 0.5])
    lam = np.clip(normal @ light, 0, 1)
    albedo = texture(pts_c, part)
    rgb = albedo * (0.35 + 0.65 * lam[..., None])
    rgb = np.where(hit[..., None], rgb, 0.0)
    depth = np.where(hit, s_safe * d[..., 2], 0.0)
    return (
        rgb.astype(np.float32),
        hit,
        depth.astype(np.float32),
        pts_c,
        part,
        pts,
    )


def deform_to(pts_c: np.ndarray, part: np.ndarray, t: float) -> np.ndarray:
    """Map canonical points of the given parts into deformed space at t."""
    Rl = _rot_x(limb_angle(t))
    pts_limb = (pts_c - JOINT) @ Rl.T + JOINT
    return np.where(part[..., None] == 1, pts_limb, pts_c)


def make_adversarial_dataset(
    root: str,
    seqname: str = "adversarial",
    num_vids: int = 1,
    num_frames: int = 64,
    res: int = 256,
    feat_res: int = 64,
    cam_noise_deg: float = 2.0,
    seed: int = 0,
):
    """Generate the dataset in database/processed/** layout; returns root."""
    from lab4d_tpu_torch.meshlib import uv_sphere
    from lab4d_tpu_torch.utils.io import imwrite

    rng = np.random.default_rng(seed)
    os.makedirs(f"{root}/configs", exist_ok=True)
    proc = f"{root}/processed"
    deltas = [1, 2, 4, 8]
    cfg_lines = ["[data]", ""]

    for vid in range(num_vids):
        vidname = f"{seqname}-{vid:04d}"
        dirs = {}
        for sub in (
            ["JPEGImages", "JPEGImagesRaw", "Annotations", "Depth", "Features",
             "Cameras"]
            + [f"FlowFW_{d}" for d in deltas]
            + [f"FlowBW_{d}" for d in deltas]
        ):
            dirs[sub] = f"{proc}/{sub}/Full-Resolution/{vidname}"
            os.makedirs(dirs[sub], exist_ok=True)

        K = np.array([1.3 * res, 1.3 * res, res / 2, res / 2], np.float64)
        times = [(i + 7 * vid) / num_frames for i in range(num_frames)]
        rts = np.stack([cam_pose(t) for t in times])

        frames = [render_frame(t, K, res) for t in times]
        rgbs = [f[0] for f in frames]
        masks = [f[1] for f in frames]
        depths = [f[2] for f in frames]

        def project(pts, rt):
            p = pts @ rt[:3, :3].T + rt[:3, 3]
            fx, fy, cx, cy = K
            uv = np.stack(
                [
                    fx * p[..., 0] / np.maximum(p[..., 2], 1e-6) + cx,
                    fy * p[..., 1] / np.maximum(p[..., 2], 1e-6) + cy,
                ],
                -1,
            )
            return uv, p[..., 2]

        xs, ys = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
        base_xy = np.stack([xs, ys], -1).astype(np.float32)

        def flow_with_occlusion(i: int, j: int) -> np.ndarray:
            """GT flow i->j (articulated correspondence) with
            depth-consistency occlusion handling in the uct channel."""
            _, hit, _, pts_c, part, _ = frames[i]
            pts_j = deform_to(pts_c, part, times[j])
            uv, z = project(pts_j, rts[j])
            flow = (uv - base_xy).astype(np.float32)
            # occluded if the target frame sees something nearer there
            ui = np.clip(np.round(uv[..., 0]).astype(int), 0, res - 1)
            vi = np.clip(np.round(uv[..., 1]).astype(int), 0, res - 1)
            z_seen = depths[j][vi, ui]
            visible = (depths[j][vi, ui] > 0) & (z < z_seen + 0.05)
            inb = (
                (uv[..., 0] >= 0) & (uv[..., 0] < res)
                & (uv[..., 1] >= 0) & (uv[..., 1] < res)
            )
            uct = (hit & visible & inb).astype(np.float32)
            return np.concatenate([flow, uct[..., None]], -1)

        flows_fw = {d: [] for d in deltas}
        flows_bw = {d: [] for d in deltas}
        for d in deltas:
            for i in range(0, num_frames - d, d):
                flows_fw[d].append(flow_with_occlusion(i, i + d))
                flows_bw[d].append(flow_with_occlusion(i + d, i))

        for i in range(num_frames):
            frame8 = (np.clip(rgbs[i], 0, 1) * 255).astype(np.uint8)
            imwrite(f"{dirs['JPEGImages']}/{i:05d}.jpg", frame8)
            imwrite(f"{dirs['JPEGImagesRaw']}/{i:05d}.jpg", frame8)

        prefix = f"crop-{res}"
        np.save(
            f"{dirs['JPEGImages']}/{prefix}.npy",
            np.stack(rgbs).astype(np.float16),
        )
        mask2 = np.stack(
            [np.stack([m, np.ones_like(m)], -1).astype(bool) for m in masks]
        )
        np.save(f"{dirs['Annotations']}/{prefix}.npy", mask2)
        np.save(
            f"{dirs['Annotations']}/{prefix}-crop2raw.npy",
            np.tile(np.array([1.0, 1.0, 0.0, 0.0], np.float32), (num_frames, 1)),
        )
        np.save(
            f"{dirs['Annotations']}/{prefix}-is_detected.npy",
            np.ones(num_frames, np.float32),
        )
        np.save(
            f"{dirs['Depth']}/{prefix}.npy", np.stack(depths).astype(np.float16)
        )
        for d in deltas:
            if flows_fw[d]:
                np.save(f"{dirs[f'FlowFW_{d}']}/{prefix}.npy",
                        np.stack(flows_fw[d]))
                np.save(f"{dirs[f'FlowBW_{d}']}/{prefix}.npy",
                        np.stack(flows_bw[d]))

        # features: unit descriptors of canonical position (what a
        # perfectly-consistent DINOv2 would give), at feature resolution
        feats = []
        Kf = K * feat_res / res
        for i, t in enumerate(times):
            _, hit, _, pts_c, part, _ = render_frame(t, Kf, feat_res)
            f = np.concatenate(
                [
                    pts_c / BODY_R,
                    np.sin(5 * pts_c),
                    np.cos(5 * pts_c),
                    part[..., None].astype(np.float64),
                    np.sin(11 * pts_c),
                    np.cos(11 * pts_c),
                ],
                -1,
            )[..., :16]
            f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-6)
            feats.append(np.where(hit[..., None], f, 0.0))
        np.save(
            f"{dirs['Features']}/{prefix}-dinov2-01.npy",
            np.stack(feats).astype(np.float16),
        )

        # camera priors: GT + rotation noise (imperfect like Procrustes
        # chains); frame 0 kept exact as the anchoring convention
        rts_noisy = rts.copy()
        for i in range(1, num_frames):
            ax = rng.normal(size=3)
            ax /= np.linalg.norm(ax)
            ang = np.deg2rad(cam_noise_deg) * rng.normal()
            kx = np.array(
                [
                    [0, -ax[2], ax[1]],
                    [ax[2], 0, -ax[0]],
                    [-ax[1], ax[0], 0],
                ]
            )
            Rn = (
                np.eye(3)
                + np.sin(ang) * kx
                + (1 - np.cos(ang)) * kx @ kx
            )
            rts_noisy[i, :3, :3] = Rn @ rts_noisy[i, :3, :3]
        np.save(f"{dirs['Cameras']}/00.npy", rts_noisy.astype(np.float32))
        np.save(
            f"{dirs['Cameras']}/01-canonical.npy", rts_noisy.astype(np.float32)
        )

        uv_sphere(radius=BODY_R, count=[12, 12]).export(
            f"{dirs['Cameras']}/mesh-00-centered.obj"
        )
        uv_sphere(radius=BODY_R, count=[12, 12]).export(
            f"{dirs['Cameras']}/mesh-01-centered.obj"
        )

        cfg_lines += [
            f"[data_{vid}]",
            f"img_path = {dirs['JPEGImages']}",
            f"ks = {K[0]} {K[1]} {K[2]} {K[3]}",
            f"shape = {res} {res}",
            "",
        ]

    with open(f"{root}/configs/{seqname}.config", "w") as f:
        f.write("\n".join(cfg_lines))
    return root


if __name__ == "__main__":
    import sys

    a = sys.argv[1:]
    make_adversarial_dataset(a[0], num_frames=int(a[1]) if len(a) > 1 else 64,
                             res=int(a[2]) if len(a) > 2 else 256)
