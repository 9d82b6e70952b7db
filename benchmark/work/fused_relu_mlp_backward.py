"""K3b: fused_relu_mlp_backward(x, g, weights, biases, skip_idx, saved)."""

from benchmark.work.common import F32, mlp_macs, numel


def work(args, kwargs):
    x, g, weights, biases = args[0], args[1], args[2], args[3]
    rows = x.shape[0]
    flops = 4.0 * rows * mlp_macs(weights)
    nbytes = F32 * (2 * numel(x) + numel(g) + 2 * mlp_macs(weights) + mlp_macs(biases))
    return flops, nbytes
