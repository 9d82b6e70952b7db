"""Operations and bytes of the kernel entries, counted from the call's
shapes: each input byte read once, each output byte written once (fp32),
the products of the math once (no recomputation). A backward counts the
products of dX and dW, twice the forward's, and reads x, the output
gradient and the weights and writes dx, dW and db; what a kernel saves
for its backward or recomputes is its own business and not counted."""

F32 = 4


def numel(t) -> int:
    return int(t.numel()) if t is not None else 0


def mlp_macs(weights) -> int:
    return sum(numel(w) for w in weights)
