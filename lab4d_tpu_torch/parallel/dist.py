"""Training over several processes, one per card: the process group, the
rank's block of a global batch, and the few collectives the sharded
training step needs.

Port of lab4d_tpu/parallel/mesh_utils.py on torch.distributed. The JAX
package jits the one-device step on the global batch over a ("data",
"video") mesh and lets XLA insert the reductions; here each rank runs the
step on its block of the same global batch, and the step's batch
reductions are made global by hand, so that the sum of the ranks'
gradients is the gradient of the one-process step on the global batch:

- a loss term's nonzero-mean takes its count over all ranks (global_sum),
  its numerator stays the rank's own;
- the mask-balance sums and the visibility normalisation are global sums;
- the random draws of the step are made at the global shape from the
  same generator state on every rank, then each rank takes its block
  (eikonal rays, instance-code swaps) or, for the global match, gathers
  the candidates from their ranks with their gradient (all_gather);
- a term that does not depend on the batch enters the gradient once, from
  rank 0.

These collectives run only inside the training forward
(`sharded_batch()`); outside it (eval, prior fits, marching cubes) every
function here acts on the local tensors, as at world size 1, where each
is a no-op.

The mesh's "video" axis shards the per-video parameter tables
(PER_VIDEO_PARAM_TOKENS) in the JAX package, for memory; the port keeps
them replicated (a few KB each) and takes from the axis only the loader's
rule: block j of the global batch draws its pairs from video group
j % video_shards (dataloader/data_utils.py TrainBatchLoader).

gloo is the backend on the CPU. It reduces CUDA tensors too (two ranks
sharing one card, where NCCL refuses); each collective then runs on host
copies of its tensors.
"""

from __future__ import annotations

import contextlib
import os
import socket
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

# parameter-name tokens of the per-video tables (leading dim = the video
# count): instance codes, camera base rotations and translations,
# intrinsics base focal length and principal point
PER_VIDEO_PARAM_TOKENS = (
    "inst_embedding",
    "base_quat",
    "base_logfocal",
    "base_ppoint",
    "base_trans",
)

# whether the batch of the running training forward is this rank's block
# of a global batch: a mode of the process like torch's grad mode, set
# only within sharded_batch(), which the layers of the forward read where
# the batch meets a reduction or a draw (no argument threaded through them)
_batch_sharded = False


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def env_world() -> Optional[Dict[str, object]]:
    """The process group the environment describes, or None: torchrun's
    RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT, or the JAX
    package's explicit rendezvous (LAB4D_MULTIHOST=1 with
    LAB4D_COORDINATOR=host:port, LAB4D_NUM_PROCESSES, LAB4D_PROCESS_ID; the
    local rank is the process id modulo the cards of the host)."""
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:
        return {"init_method": "env://", "world_size": int(env["WORLD_SIZE"]),
                "rank": int(env["RANK"]), "local_rank": int(env.get("LOCAL_RANK", env["RANK"]))}
    if env.get("LAB4D_MULTIHOST", "0") == "1" and env.get("LAB4D_COORDINATOR"):
        r = int(env["LAB4D_PROCESS_ID"])
        cards = max(torch.cuda.device_count(), 1)
        return {"init_method": "tcp://" + env["LAB4D_COORDINATOR"],
                "world_size": int(env["LAB4D_NUM_PROCESSES"]), "rank": r, "local_rank": r % cards}
    return None


def init_distributed(device: str = "cuda", init_method: Optional[str] = None,
                     world: Optional[int] = None, rank_: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group that the arguments, else the environment
    (env_world), describe, and return this rank's device: cuda:<local
    rank>, or the CPU. The backend is NCCL on the card and gloo on the CPU
    unless `backend` names one. Without a group described, none is made
    and `device` is returned as it is."""
    if init_method is None:
        found = env_world()
        if found is None:
            return torch.device(device)
        init_method, world = found["init_method"], found["world_size"]
        rank_, local_rank = found["rank"], found["local_rank"]
    local_rank = rank_ if local_rank is None else local_rank
    on_card = torch.device(device).type == "cuda"
    if on_card:
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    tdist.init_process_group(backend or ("nccl" if on_card else "gloo"), init_method=init_method,
                             world_size=world, rank=rank_)
    return dev


def shutdown():
    if is_initialized():
        tdist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ the batch


@contextlib.contextmanager
def sharded_batch(on: bool = True):
    """Within it, the training forward's batch is this rank's block of the
    global batch: batch_shards() reports the group, and the step's
    reductions and draws are global."""
    global _batch_sharded
    prev, _batch_sharded = _batch_sharded, on and world_size() > 1
    try:
        yield
    finally:
        _batch_sharded = prev


def batch_shards():
    """(rank, world size) of the running training forward's batch: (0, 1)
    outside sharded_batch()."""
    return (rank(), world_size()) if _batch_sharded else (0, 1)


def block(array, rank_: int, world: int):
    """Rows [rank * m, (rank + 1) * m) of the leading axis, m = rows /
    world: the rank's block of a global batch."""
    n = array.shape[0]
    if n % world:
        raise ValueError(f"a batch of {n} rows does not split over {world} ranks")
    m = n // world
    return array[rank_ * m:(rank_ + 1) * m]


def batch_block(batch: Dict[str, np.ndarray], rank_: int, world: int):
    """Each array of a global batch cut to the rank's block."""
    return {k: block(v, rank_, world) for k, v in batch.items()}


# -------------------------------------------------------- collectives


def _staged(t: torch.Tensor):
    """gloo runs on host copies of CUDA tensors; NCCL on the tensors."""
    return t.is_cuda and tdist.get_backend() == "gloo"


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    if _staged(t):
        host = t.detach().cpu()
        tdist.all_reduce(host)
        t.copy_(host)
    else:
        tdist.all_reduce(t)
    return t


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks of the running sharded forward (a new
    tensor, no gradient): a count or a sum of the global batch."""
    if batch_shards()[1] == 1:
        return t
    return _all_reduce_(t.detach().clone())


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        world = world_size()
        if _staged(t):
            parts = [torch.empty_like(t, device="cpu") for _ in range(world)]
            tdist.all_gather(parts, t.detach().cpu())
            return torch.stack(parts).to(t.device)
        parts = [torch.empty_like(t) for _ in range(world)]
        tdist.all_gather(parts, t.detach().contiguous())
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss read the whole gathered tensor: the gradient of
        # this rank's part is the sum over ranks of the gradients of that part
        return _all_reduce_(grad.contiguous().clone())[rank()]


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape): t of every rank of the running sharded forward,
    stacked in rank order, with its gradient carried back to each rank."""
    if batch_shards()[1] == 1:
        return t[None]
    return _AllGather.apply(t)


def all_reduce_grads_(params: Sequence[torch.Tensor]) -> int:
    """Sum the gradients of `params` over all ranks, in place, in one
    collective (the gradients flattened into one buffer). Returns the
    bytes reduced (0 at world size 1)."""
    if world_size() == 1:
        return 0
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce_(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat.numel() * flat.element_size()


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """t summed over all ranks, in place (identity at world size 1)."""
    return t if world_size() == 1 else _all_reduce_(t)


def broadcast_tensors_(tensors: Sequence[torch.Tensor], src: int = 0):
    """Overwrite each tensor with rank src's, in one collective."""
    if world_size() == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
    if _staged(flat):
        host = flat.cpu()
        tdist.broadcast(host, src)
        flat = host.to(flat.device)
    else:
        tdist.broadcast(flat, src)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_object(obj, src: int = 0):
    """Rank src's `obj` (picklable) on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src)
    return box[0]


def checksum(tensors: Sequence[torch.Tensor]) -> float:
    """A float64 checksum of tensors (their values weighted by position,
    so that a swap of two values shows), read back once."""
    total = None
    for i, t in enumerate(tensors):
        v = t.detach().reshape(-1).to(torch.float64)
        w = 1.0 + 1e-3 * torch.arange(1, v.numel() + 1, device=v.device, dtype=torch.float64)
        part = (v * w).sum() * (i + 1)
        total = part if total is None else total + part.to(total.device)
    return 0.0 if total is None else float(total.item())


def rng_state_checksum(device: torch.device) -> float:
    """A checksum of torch's default generator on `device`, the source of
    the training step's random draws."""
    state = torch.cuda.get_rng_state(device) if device.type == "cuda" else torch.get_rng_state()
    return checksum([state.to(torch.float64)])


def check_in_sync(named: Dict[str, float]):
    """Raise unless every rank holds the same values (e.g. checksums of
    the params and the generators): ranks that drifted apart would train
    silently on different models."""
    if world_size() == 1:
        return
    names = sorted(named)
    table = [None] * world_size()
    tdist.all_gather_object(table, [named[k] for k in names])
    table = np.asarray(table, np.float64)
    bad = [k for i, k in enumerate(names) if not np.all(table[:, i] == table[0, i])]
    if bad:
        raise RuntimeError("ranks out of sync in " + ", ".join(
            f"{k}: {table[:, names.index(k)].tolist()}" for k in bad))
