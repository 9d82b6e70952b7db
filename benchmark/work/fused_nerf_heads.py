"""K1: fused_nerf_heads(x, appr_rows, win_b, win_c, nets, ibeta, cfg, spp).

Every head's layers at every point, except the appearance code's columns
of rgb1's first layer, which multiply a code constant over each pair's spp
points: those products are counted once per pair."""

from benchmark.work.common import F32, numel


def head_macs(nets, appr_cols: int, spp: int):
    """(products per point, products per pair) of one call's nets."""
    per_point, per_pair = 0, 0
    for name, wb in nets.items():
        for w in wb[0::2]:
            per_point += numel(w)
    w_rgb1 = nets["rgb1"][0]
    per_point -= w_rgb1.shape[0] * appr_cols
    per_pair += w_rgb1.shape[0] * appr_cols
    return per_point, per_pair


def work(args, kwargs):
    x, appr, win_b, win_c, nets, ibeta, cfg, spp = args[:8]
    points = x.shape[0]
    per_point, per_pair = head_macs(nets, appr.shape[1], spp)
    flops = 2.0 * (points * per_point + (points // spp) * per_pair)
    params = sum(numel(t) for wb in nets.values() for t in wb)
    outputs = points * (1 + 3 + 1 + 16)
    nbytes = F32 * (numel(x) + numel(appr) + numel(win_b) + numel(win_c) + params
                    + numel(ibeta) + outputs)
    return flops, nbytes
