"""The reference runs in one process: the few collectives that the
program's sharded training step calls (its parallel/dist.py) are those of
world size 1 here, where each leaves the local tensors as they are."""

from __future__ import annotations


def batch_shards():
    """(rank, world size) of the training forward's batch."""
    return (0, 1)


def block(array, rank_: int, world: int):
    """Rows [rank * m, (rank + 1) * m) of the leading axis, m = rows /
    world: the rank's block of a global batch."""
    m = array.shape[0] // world
    return array[rank_ * m:(rank_ + 1) * m]


def global_sum(t):
    """t summed over the ranks: t itself."""
    return t


def all_gather(t):
    """(world, *t.shape): t of every rank, stacked."""
    return t[None]
