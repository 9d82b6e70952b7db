"""K2: fused_nerf_heads_backward(x, g, appr_rows, win_b, win_c, nets, ibeta, cfg, spp, saved)."""

from benchmark.work.common import F32, numel
from benchmark.work.fused_nerf_heads import head_macs


def work(args, kwargs):
    x, g, appr, win_b, win_c, nets, ibeta, cfg, spp = args[:9]
    points = x.shape[0]
    per_point, per_pair = head_macs(nets, appr.shape[1], spp)
    flops = 4.0 * (points * per_point + (points // spp) * per_pair)
    params = sum(numel(t) for wb in nets.values() for t in wb)
    nbytes = F32 * (2 * numel(x) + sum(numel(t) for t in g) + 2 * numel(appr) + 2 * params
                    + 2 * numel(ibeta))
    return flops, nbytes
