"""K3f: fused_relu_mlp(x, weights, biases, skip_idx, final_act)."""

from benchmark.work.common import F32, mlp_macs, numel


def work(args, kwargs):
    x, weights, biases = args[0], args[1], args[2]
    rows = x.shape[0]
    flops = 2.0 * rows * mlp_macs(weights)
    nbytes = F32 * (numel(x) + mlp_macs(weights) + mlp_macs(biases) + rows * weights[-1].shape[0])
    return flops, nbytes
