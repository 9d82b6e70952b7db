"""Fourier position/time embeddings and learnable instance codes.

Port of lab4d_tpu/nnutils/embedding.py. In training the instance codes
of a multi-video model are swapped at random (InstEmbedding), with the
draws taken from a SwapDraws source: pairs a test hands in, else the
training step's swap key, from which each embedding draws at its flax
scope (`InstEmbedding.scope`, set by DVRModel) as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from benchmark.reference.lab4d_ref.nnutils.linear import TorchDense
from benchmark.reference.lab4d_ref.parallel import dist
from benchmark.reference.lab4d_ref.utils import flax_rng
from benchmark.reference.lab4d_ref.utils import jax_random as jr


class FrameInfo:
    """Static per-dataset frame metadata (host-side numpy).

    Args:
        frame_offset: (V+1,) cumulative counts of filtered frames per video
        frame_offset_raw: (V+1,) cumulative counts of raw frames per video
        frame_mapping: (M,) absolute raw frame id of each filtered frame
    """

    def __init__(self, frame_offset, frame_offset_raw, frame_mapping):
        self.frame_offset = np.asarray(frame_offset, dtype=np.int64)
        self.frame_offset_raw = np.asarray(frame_offset_raw, dtype=np.int64)
        self.frame_mapping = np.asarray(frame_mapping, dtype=np.int64)
        self.num_frames = int(self.frame_offset[-1])
        self.num_frames_raw = int(self.frame_offset_raw[-1])
        self.num_vids = len(self.frame_offset) - 1
        raw_fid = np.arange(self.num_frames_raw)
        self.raw_fid_to_vid = (
            np.searchsorted(self.frame_offset_raw, raw_fid, side="right") - 1
        ).astype(np.int64)
        self.raw_fid_to_vstart = self.frame_offset_raw[self.raw_fid_to_vid]
        self.raw_fid_to_vidlen = (
            self.frame_offset_raw[self.raw_fid_to_vid + 1] - self.raw_fid_to_vstart
        )
        self.max_ts = int((self.frame_offset_raw[1:] - self.frame_offset_raw[:-1]).max())
        self.frame_to_vid = self.raw_fid_to_vid[self.frame_mapping]

    @classmethod
    def single_video(cls, num_frames: int) -> "FrameInfo":
        return cls([0, num_frames], [0, num_frames], list(range(num_frames)))


def fourier_embed_dim(in_channels: int, n_freqs: int) -> int:
    if n_freqs == -1:
        return 0
    return in_channels * (2 * n_freqs + 1)


def fourier_embed(x: torch.Tensor, freqs, window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fourier features in the layout [x, sin blocks (F x C), cos blocks
    (F x C)], with an optional (F,) coarse-to-fine window: the layout every
    module on BaseMLP's pe_spec path consumes (it differs from
    PosEmbedding.forward's interleaved order; the two are never mixed).
    freqs: (F,) tensor or F Python floats; each angle is x * freq,
    elementwise."""
    if torch.is_tensor(freqs):
        ang = x[..., None, :] * freqs[:, None]  # (..., F, C)
    else:
        ang = torch.stack([x * f for f in freqs], dim=-2)
    sin_b, cos_b = torch.sin(ang), torch.cos(ang)
    if window is not None:
        sin_b = sin_b * window[:, None]
        cos_b = cos_b * window[:, None]
    flat_shape = x.shape[:-1] + (ang.shape[-2] * x.shape[-1],)
    return torch.cat([x, sin_b.reshape(flat_shape), cos_b.reshape(flat_shape)], dim=-1)


class PosEmbedding(nn.Module):
    """Fourier features. Called directly it returns [x, then per-frequency
    (sin, cos) blocks] over full bands; through `pe_spec(alpha)` it hands
    BaseMLP its frequencies and annealing window for the
    [x, sin blocks, cos blocks] layout."""

    def __init__(self, in_channels: int, n_freqs: int, logscale: bool = True):
        super().__init__()
        self.in_channels = in_channels
        self.n_freqs = n_freqs
        self.out_channels = fourier_embed_dim(in_channels, n_freqs)
        bands = np.zeros((0,), np.float32)
        if n_freqs > 0:
            if logscale:
                bands = 2.0 ** np.linspace(0, n_freqs - 1, n_freqs)
            else:
                bands = np.linspace(1, 2 ** (n_freqs - 1), n_freqs)
        self.freq_bands = np.asarray(bands, np.float32)
        self.register_buffer("freqs", torch.as_tensor(self.freq_bands), persistent=False)

    def get_window(self, alpha: Optional[float]) -> Optional[torch.Tensor]:
        """(F,) coarse-to-fine weights of the frequency bands at annealing
        progress alpha in [0, 1], or None (full bands) when alpha is None."""
        if alpha is None or self.n_freqs <= 0:
            return None
        bands = torch.arange(self.n_freqs, dtype=torch.float32, device=self.freqs.device)
        window = torch.clamp(torch.tensor(alpha, dtype=torch.float32) * self.n_freqs - bands,
                             0.0, 1.0)
        return 0.5 * (1 + torch.cos(np.pi * window + np.pi))

    def pe_spec(self, alpha: Optional[float] = None):
        """(frequencies as Python floats, window or None) for BaseMLP's
        pe_spec path, or None when this embedding is an identity/empty map."""
        if self.n_freqs <= 0:
            return None
        return tuple(float(f) for f in self.freq_bands), self.get_window(alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.n_freqs == -1:
            return x[..., :0]
        if self.n_freqs == 0:
            return x
        ang = x[..., None, :] * self.freqs[:, None]  # (..., F, C)
        bands = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2)  # (..., F, 2, C)
        flat = bands.reshape(x.shape[:-1] + (2 * self.n_freqs * self.in_channels,))
        return torch.cat([x, flat], dim=-1)


class SwapDraws:
    """The random draws of the instance-code swaps of one training forward:
    one (rand_id (R,), u (inst_id's shape)) pair per InstEmbedding call that
    swaps. The pairs given are taken first, in call order (a test's); then
    each call draws as the JAX package's InstEmbedding does from the step's
    swap root `key`: split(make_rng("swap")) at the embedding's flax scope,
    counted per scope (utils/flax_rng.py), randint ids and uniform u, on
    the host. Where the rows are one rank's block of a sharded batch
    (parallel/dist.py), the pairs are the global batch's (given or drawn
    so) and the rank takes the rows of its block."""

    def __init__(self, pairs=(), key=None):
        self.pairs = list(pairs)
        self.key = key
        self.counts: dict = {}

    def take(self, inst_id: torch.Tensor, num_inst: int, scope: Tuple[str, ...] = ()):
        rank, world = dist.batch_shards()
        if self.pairs:
            rand_id, u = self.pairs.pop(0)
        elif self.key is None:
            raise ValueError("an instance-code swap without draws: give its pairs or the "
                             "step's swap key")
        else:
            count = self.counts[scope] = self.counts.get(scope, 0) + 1
            r_id, r_mask = jr.split(flax_rng.make_rng(self.key, scope, count))
            rows = inst_id.shape[0] * world
            rand_id = torch.from_numpy(jr.randint(r_id, (rows,), 0, num_inst).astype(np.int64))
            u = torch.from_numpy(jr.uniform(r_mask, (rows,) + tuple(inst_id.shape[1:])))
        if world > 1:
            rand_id, u = dist.block(rand_id, rank, world), dist.block(u, rank, world)
        return rand_id.to(inst_id.device), u.to(inst_id.device)


class InstEmbedding(nn.Module):
    """Learnable per-video instance code, with code-swap regularization in
    training. `scope`: the embedding's flax scope path, from which its
    swap draws derive."""

    scope: Tuple[str, ...] = ()

    def __init__(self, num_inst: int, inst_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_inst = num_inst
        self.inst_channels = inst_channels
        if inst_channels > 0:
            self.mapping = nn.Embedding(num_inst, inst_channels)
            with torch.no_grad():  # flax nn.Embed's init: std 1 / sqrt(features)
                self.mapping.weight.normal_(0.0, 1.0 / np.sqrt(inst_channels), generator=generator)

    def forward(self, inst_id: torch.Tensor, beta_prob: Optional[float] = None,
                train: bool = False, swap: Optional[SwapDraws] = None) -> torch.Tensor:
        """Codes of inst_id (R, ...). In training with a beta_prob, each
        element takes, with probability beta_prob, the id drawn for its
        leading row (one random id per row, broadcast over the row); swap:
        the draws' source (SwapDraws; without one a swap raises). One
        instance has no swap."""
        if self.inst_channels == 0:
            return torch.zeros(inst_id.shape + (0,), device=inst_id.device)
        if self.num_inst == 1:
            return self.mapping(torch.zeros_like(inst_id))
        if train and beta_prob is not None:
            rand_id, u = (swap or SwapDraws()).take(inst_id, self.num_inst, self.scope)
            rand_id = rand_id.reshape((inst_id.shape[0],) + (1,) * (inst_id.ndim - 1))
            inst_id = torch.where(u < beta_prob, rand_id.expand(inst_id.shape), inst_id)
        return self.mapping(inst_id)

    def mean(self) -> torch.Tensor:
        return self.mapping.weight.mean(dim=0)


class TimeEmbedding(nn.Module):
    """Fourier-time + instance-code embedding per frame. `frame_id`
    indexes raw frame ids; time is normalized to [-1, 1] within each
    video and scaled by the longest video."""

    def __init__(self, num_freq_t: int, frame_info: FrameInfo, out_channels: int = 128,
                 time_scale: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.frame_info = frame_info
        self.out_channels = out_channels
        self.time_scale = time_scale
        self.fourier = PosEmbedding(1, num_freq_t)
        self.inst_embedding = InstEmbedding(frame_info.num_vids, out_channels, generator)
        self.mapping1 = TorchDense(self.fourier.out_channels, out_channels, generator)
        self.mapping2 = TorchDense(2 * out_channels, out_channels, generator)
        fi = frame_info
        for name in ("raw_fid_to_vid", "raw_fid_to_vstart", "raw_fid_to_vidlen", "frame_mapping"):
            self.register_buffer(name, torch.as_tensor(getattr(fi, name)), persistent=False)

    def frame_to_tid(self, frame_id: torch.Tensor) -> torch.Tensor:
        vidlen = self.raw_fid_to_vidlen[frame_id]
        tid_sub = frame_id - self.raw_fid_to_vstart[frame_id]
        tid = (tid_sub - vidlen / 2.0) / self.frame_info.max_ts * 2.0
        return (tid * self.time_scale).float()

    def forward(self, frame_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(...,) raw frame ids, or None for all filtered frames ->
        (..., out_channels)."""
        if frame_id is None:
            frame_id = self.frame_mapping
        inst_id = self.raw_fid_to_vid[frame_id]
        coeff = self.mapping1(self.fourier(self.frame_to_tid(frame_id)[..., None]))
        inst_code = self.inst_embedding(inst_id)
        return self.mapping2(torch.cat([coeff, inst_code], dim=-1))

    def mean_embedding(self) -> torch.Tensor:
        """Mean embedding over all filtered frames, (1, out_channels)."""
        return self.forward(None).mean(dim=0, keepdim=True)
