"""K4f: fused_pe_mlp(x, window, weights, biases, freqs, skip_idx, final_act);
the Fourier embedding is elementwise work and not counted as products."""

from benchmark.work.common import F32, mlp_macs, numel


def work(args, kwargs):
    x, window, weights, biases = args[0], args[1], args[2], args[3]
    rows = x.shape[0]
    flops = 2.0 * rows * mlp_macs(weights)
    nbytes = F32 * (numel(x) + numel(window) + mlp_macs(weights) + mlp_macs(biases)
                    + rows * weights[-1].shape[0])
    return flops, nbytes
