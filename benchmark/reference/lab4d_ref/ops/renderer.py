"""Volume rendering primitives in torch.

Port of lab4d_tpu/ops/renderer.py. The TPU's layout tricks stay out:
gathers are `torch.gather`, the inverse-CDF bucket search is
`torch.searchsorted`, and integration is a weighted sum per channel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.lab4d_ref.parallel import dist


def sample_cam_rays(
    hxy: torch.Tensor,
    Kinv: torch.Tensor,
    near_far: torch.Tensor,
    n_depth: int = 64,
    depth: Optional[torch.Tensor] = None,
):
    """Deterministic samples along camera rays.

    Args:
        hxy: (M, N, 3) homogeneous pixel coordinates
        Kinv: (M, 3, 3) inverse intrinsics
        near_far: (M, 2) near/far planes
        n_depth: samples per ray (ignored if depth given)
        depth: optional (M, N, D, 1) fixed depths
    Returns:
        xyz (M,N,D,3) camera-space points, dir (M,N,D,3) unit directions,
        deltas (M,N,D,1) inter-sample distances, depth (M,N,D,1)
    """
    raydir = torch.einsum("mni,mji->mnj", hxy, Kinv)
    dir_norm = torch.linalg.norm(raydir, dim=-1, keepdim=True)
    if depth is None:
        z = torch.linspace(0.0, 1.0, n_depth, device=hxy.device, dtype=hxy.dtype)
        depth = near_far[:, None, 0:1] * (1 - z) + near_far[:, None, 1:2] * z
        depth = depth[:, :, :, None].expand(hxy.shape[0], hxy.shape[1], n_depth, 1)
    xyz = raydir[:, :, None, :] * depth
    deltas = depth[:, :, 1:] - depth[:, :, :-1]
    deltas = torch.cat([deltas, deltas[:, :, -1:]], dim=2)
    deltas = deltas * dir_norm[:, :, None, :]
    unit_dir = raydir / torch.clamp(dir_norm, min=1e-12)
    unit_dir = unit_dir[:, :, None, :].expand(xyz.shape)
    return xyz, unit_dir, deltas, depth


def compute_weights(density: torch.Tensor, deltas: torch.Tensor):
    """weights_i = alpha_i * prod_{j<i}(1 - alpha_j) and the inclusive
    transmittance, both (M, N, D)."""
    tau = deltas[..., 0] * density[..., 0]
    alpha = 1.0 - torch.exp(-tau)
    transmit_incl = torch.exp(-torch.cumsum(tau, dim=-1))
    transmit_excl = torch.cat(
        [torch.ones_like(transmit_incl[..., :1]), transmit_incl[..., :-1]], dim=-1
    )
    return alpha * transmit_excl, transmit_incl


# keys integrated with frozen (detached) normalized weights
_KEY_FREEZE = ("cyc_dist", "xyz_cam", "skin_entropy")
# keys not integrated (handled specially or left per-sample)
_KEY_SKIP = (
    "density", "vis", "flow", "eikonal", "xy_reproj", "xyz_reproj", "gauss_density",
)


def render_pixel(field_dict: Dict[str, torch.Tensor], deltas: torch.Tensor):
    """Volume-render per-sample field outputs along rays."""
    weights, transmit = compute_weights(field_dict["density"], deltas)
    rendered = integrate(field_dict, weights)
    if "eikonal" in field_dict:
        rendered["eikonal"] = field_dict["eikonal"].mean(dim=(-1, -2))
    if "delta_skin" in field_dict:
        rendered["delta_skin"] = field_dict["delta_skin"].mean(dim=(-1, -2))
    if "vis" in field_dict:
        # visibility BCE normalized by the mean transmittance of the chunk
        # (of the global batch, where the batch is one rank's block)
        is_visible = transmit.detach()
        vis_loss = -torch.mean(
            F.logsigmoid(field_dict["vis"][..., 0]) * is_visible, dim=-1, keepdim=True
        )
        if dist.batch_shards()[1] > 1:
            vis_sum, count = dist.global_sum(torch.stack([
                is_visible.sum(), is_visible.new_tensor(float(is_visible.numel()))]))
            mean_visible = vis_sum / count
        else:
            mean_visible = is_visible.mean()
        rendered["vis"] = vis_loss / torch.clamp(mean_visible, min=1e-6)
    if "gauss_density" in field_dict:
        gauss_weights, _ = compute_weights(field_dict["gauss_density"], deltas)
        rendered["gauss_mask"] = torch.sum(gauss_weights, dim=-1, keepdim=True)
    return rendered


def integrate(field_dict: Dict[str, torch.Tensor], weights: torch.Tensor):
    """Per-sample values -> per-ray values, with the normal renormalized
    and density_* turned into composition masks mask_*."""
    rendered = {}
    mask = torch.sum(weights, dim=-1, keepdim=True)
    rendered["mask"] = mask
    w_norm = weights / (mask + 1e-6)
    for k, v in field_dict.items():
        if k in _KEY_SKIP:
            continue
        wt = w_norm.detach() if k in _KEY_FREEZE else w_norm
        rendered[k] = torch.sum(wt[..., None] * v, dim=-2)
    if "flow" in field_dict:
        w_flow = weights * field_dict["flow"][..., 2]
        w_flow = w_flow / (torch.sum(w_flow, dim=-1, keepdim=True) + 1e-6)
        rendered["flow"] = torch.sum(w_flow[..., None] * field_dict["flow"][..., :2], dim=-2)
    if "normal" in rendered:
        n = rendered["normal"]
        rendered["normal"] = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-6)
    dens_keys = [k for k in rendered if k.startswith("density_")]
    if dens_keys:
        total = sum(rendered[k] for k in dens_keys) + 1e-6
        for k in dens_keys:
            rendered["mask_" + k[len("density_"):]] = rendered.pop(k) / total
    return rendered


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               eps: float = 1e-5):
    """Deterministic inverse-CDF importance sampling along rays: evenly
    spaced quantiles (the eval path's `det=True`; random draws are a
    training feature, not ported yet).

    Args:
        bins: (R, S-1) depth bin midpoints; weights: (R, S-2)
    Returns:
        (R, n_importance) sampled depths
    """
    R, S = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1).contiguous()  # (R, S+1)
    u = torch.linspace(0.0, 1.0, n_importance, device=bins.device, dtype=bins.dtype)
    u = u.expand(R, n_importance).contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, 0, S)
    above = torch.clamp(inds, 0, S)
    # bins edge-padded to S+1 entries, so clamped indices read its last entry
    B = bins.shape[1]
    if B < S + 1:
        bins = torch.cat([bins, bins[:, -1:].expand(R, S + 1 - B)], dim=-1)
    else:
        bins = bins[:, : S + 1]
    cdf_b, cdf_a = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_b, bins_a = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)
