"""Interleaved group streams from per-lane word slabs, as tensor ops:
counterpart of huffman_tpu/ops/device_interleave.py.

The decoder simulation of the v2 protocol in closed form: a lane's refill
count after step t is ``r_t = cum_bits[l, t] >> 5``; its refill indicator
is ``r_t - r_{t-1}``; a refill's stream slot is the exclusive count of
indicators in (step, lane) order within its group; and the word it
carries is slab word ``r_t + 1`` (words 0 and 1 are the preload).
"""

from __future__ import annotations

import torch

from ..constants import GROUP_LANES, PRELOAD_WORDS
from ..u32 import narrow, widen
from .cuda_encode import step_major


def build_streams_device(
    slab: torch.Tensor,      # (n_lanes, W) int32 bits of per-lane packed words
    eff_lens: torch.Tensor,  # (n_lanes, B) int32 per-step consumed bits
    n_real: int,             # lanes at or past this never refill
    words_cap: int,          # body words per group
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (streams (ngroups, 2048 + words_cap) int32 bits, counts
    (ngroups,) int64 words per group, preload included): the contract of
    ``build_streams_device``. ``words_cap`` must bound every group's body
    words; past it a group's words run into the next group's region, and
    past the last group they are dropped, as in the JAX package."""
    n_lanes, W = slab.shape
    ngroups = n_lanes // GROUP_LANES
    dev = slab.device
    lane = torch.arange(n_lanes, device=dev)
    cum = torch.cumsum(eff_lens, dim=1, dtype=torch.int32)
    r = torch.where((lane < n_real)[:, None], cum >> 5, 0).to(torch.int64)
    ind = torch.diff(r, dim=1, prepend=torch.zeros_like(r[:, :1]))

    word = slab.gather(1, (r + 1).clamp(max=W - 1))
    word = torch.where((r + 1 < W) & (ind > 0), widen(word), 0)

    ind_g = step_major(ind)
    incl = torch.cumsum(ind_g, dim=1)
    goff = torch.arange(ngroups, device=dev)[:, None] * words_cap
    pos = (incl - ind_g + goff).reshape(-1)
    n_body = ngroups * words_cap
    body = torch.zeros(n_body + 1, dtype=torch.int64, device=dev)
    body.index_add_(0, torch.where(pos < n_body, pos, n_body), step_major(word).reshape(-1))
    streams = torch.cat(
        [step_major(slab[:, :PRELOAD_WORDS]), narrow(body[:n_body]).reshape(ngroups, words_cap)],
        dim=1,
    )
    return streams, incl[:, -1] + PRELOAD_WORDS * GROUP_LANES
