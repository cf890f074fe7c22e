"""EpochConfiguration as weight tensors: the port of
``librabft_simulator_tpu/core/config.py`` (single-device author math; the
mesh-sharded psum path waits for the multi-GPU slice).

Voting rights are an int32 tensor ``weights[B, N]`` (index = author).
"""

from __future__ import annotations

import torch

from ..utils import hashing as H

I32 = torch.int32


def total_votes(weights):
    return weights.sum(dim=-1, dtype=I32)


def quorum_threshold(weights):
    """2N/3 + 1 (configuration.rs:52-56)."""
    return torch.div(2 * total_votes(weights), 3, rounding_mode="floor") + 1


def validity_threshold(weights):
    """(N + 2) / 3 (configuration.rs:58-62)."""
    return torch.div(total_votes(weights) + 2, 3, rounding_mode="floor")


def count_votes(weights, author_mask):
    """Sum of voting rights over a boolean author mask (configuration.rs:43)."""
    return torch.where(author_mask, weights, 0).sum(dim=-1, dtype=I32)


def pick_author(weights, seed_u32):
    """Weighted author choice: first author with cumweight > target
    (configuration.rs:65-75).  ``seed_u32`` is a uint32 draw (int32 bit
    pattern); the modulus is taken on its unsigned value."""
    total = H.as_u32(total_votes(weights))
    target = (H.as_u32(seed_u32) % total).to(I32)
    cum = torch.cumsum(weights, dim=-1, dtype=I32)
    return (cum <= target.unsqueeze(-1)).sum(dim=-1, dtype=I32)


def leader_of_round(weights, round_):
    """PacemakerState::leader: hash the round, pick an author weighted by
    voting rights."""
    return pick_author(weights, H.fold(H.TAG_LEADER, round_))
