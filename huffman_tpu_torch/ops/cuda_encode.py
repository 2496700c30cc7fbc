"""Lane packing (K4) and stream assembly: counterpart of
huffman_tpu/ops/pallas_encode.py.

``pack_lanes`` is the kernel (``csrc/pack.cu`` for CUDA tensors,
``pack_lanes_plain`` for CPU tensors): per lane, the word completed at each
step and the final left-aligned partial word. ``pack_streams`` assembles
the interleaved group streams from it with vectorised tensor ops, as
``pack_streams_pallas`` does with XLA around its Pallas packer.
``encode_streams`` is what both compress routes call: protocol lengths,
a bucketed ``words_cap`` from the groups' word totals, and the pack.

Stream identity (docs/FORMATS.md §3): with one bit cumsum driving both
encoder and decoder, the decoder consumes a lane's word j at the step the
encoder completes its word j-2. So the consumption slot of a lane's fire k
(the step where its word k completes) receives word k+2 of that lane; the
partial word stands in as word R (R = the lane's completed words) and
word R+1 is zero. Slots are numbered step-major, lane-minor within a group
after the 2 * 1024 preload words, which are each lane's words 0 and 1.
"""

from __future__ import annotations

import torch

from ..constants import GROUP_LANES, PRELOAD_WORDS
from ..runtime import kernels
from ..u32 import narrow, shl, widen


def pack_lanes(codes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """``codes``/``lens``: (n_lanes, B) int32 (codes as u32 bits). Returns
    (n_lanes, B + 1) int32 staging: column t the word completed at step t
    (0 if none), column B the final left-aligned partial word."""
    dev = codes.device
    kernels.check(codes, torch.int32, dev, "codes")
    kernels.check(lens, torch.int32, dev, "lens")
    if codes.dim() != 2 or lens.shape != codes.shape:
        raise ValueError("codes and lens must both be (n_lanes, B)")
    n_lanes, B = codes.shape
    if dev.type == "cuda":
        staging = torch.empty((n_lanes, B + 1), dtype=torch.int32, device=dev)
        kernels.launch(
            "pack_lanes", codes.data_ptr(), lens.data_ptr(), n_lanes, B,
            staging.data_ptr(),
        )
        return staging
    if dev.type == "cpu":
        return pack_lanes_plain(codes, lens)
    raise ValueError(f"pack_lanes: unsupported device {dev}")


def pack_lanes_plain(codes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the pack kernel: its arithmetic as vector
    ops over all lanes, one Python iteration per step."""
    n_lanes, B = codes.shape
    c_all = widen(codes)
    l_all = lens.to(torch.int64)
    out = torch.empty((n_lanes, B + 1), dtype=torch.int64, device=codes.device)
    buf = torch.zeros(n_lanes, dtype=torch.int64, device=codes.device)
    f = torch.zeros_like(buf)
    for t in range(B):
        c, L = c_all[:, t], l_all[:, t]
        total = f + L
        add = torch.where(
            total <= 32, shl(c, (32 - total) & 31), c >> ((total - 32) & 31)
        )
        word = buf | torch.where(L == 0, 0, add)
        emit = total >= 32
        out[:, t] = torch.where(emit, word, 0)
        spill = torch.where(total > 32, shl(c, (64 - total) & 31), 0)
        buf = torch.where(emit, spill, word)
        f = total & 31
    out[:, B] = buf
    return narrow(out)


def pack_streams(
    codes: torch.Tensor,     # (n_lanes, B) int32 codewords (0 on garbage steps)
    eff_lens: torch.Tensor,  # (n_lanes, B) int32 protocol lengths (min_len
                             # with code 0 on garbage steps)
    n_real: int,             # real lanes; the rest are pads
    words_cap: int,          # bound on every group's body words
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack and interleave. Returns (streams (ngroups, 2048 + words_cap)
    int32 bits, counts (ngroups,) int64 words per group, preload
    included): the contract of ``pack_streams_pallas``. Raises
    ``ValueError`` if a group's body exceeds ``words_cap``."""
    n_lanes, B = codes.shape
    if n_lanes % GROUP_LANES:
        raise ValueError("n_lanes must be a multiple of GROUP_LANES")
    ngroups = n_lanes // GROUP_LANES
    dev = codes.device
    st = pack_lanes(codes, eff_lens)

    lane = torch.arange(n_lanes, device=dev)
    cum = torch.where(
        (lane < n_real)[:, None], torch.cumsum(eff_lens, dim=1, dtype=torch.int32), 0
    )
    r = cum >> 5  # words completed after each step
    fire = torch.empty_like(r, dtype=torch.bool)
    fire[:, 0] = r[:, 0] > 0
    fire[:, 1:] = r[:, 1:] > r[:, :-1]

    # Words of each lane by index: word k at column k, the partial word at
    # column R, zeros after it; column B + 2 takes the non-fire writes.
    spare = B + 2
    by_index = torch.zeros((n_lanes, B + 3), dtype=torch.int32, device=dev)
    by_index.scatter_(1, torch.where(fire, r - 1, spare).long(), st[:, :B])
    by_index.scatter_(1, r[:, -1:].long(), st[:, B:])
    later = by_index.gather(1, torch.where(fire, r + 1, spare).long())

    def step_major(a: torch.Tensor) -> torch.Tensor:
        return a.reshape(ngroups, GROUP_LANES, -1).transpose(1, 2).reshape(ngroups, -1)

    fire_g = step_major(fire)
    counts = fire_g.sum(dim=1)
    body_max = int(counts.max()) if ngroups else 0
    if body_max > words_cap:
        raise ValueError(f"words_cap {words_cap} < a group's {body_max} body words")
    g_idx, s_idx = fire_g.nonzero(as_tuple=True)  # row-major: slot order
    slot = torch.cumsum(fire_g, dim=1, dtype=torch.int32)[g_idx, s_idx] - 1
    body = torch.zeros((ngroups, words_cap), dtype=torch.int32, device=dev)
    body[g_idx, slot.long()] = step_major(later)[g_idx, s_idx]
    streams = torch.cat([step_major(by_index[:, :PRELOAD_WORDS]), body], dim=1)
    return streams, counts + PRELOAD_WORDS * GROUP_LANES


def bucket_words(w: int) -> int:
    """Round a stream buffer's word count up to a quarter-octave bucket
    (2^k x {1, 1.25, 1.5, 1.75}), the JAX package's ``_bucket_words``."""
    w = max(w, 8)
    p = 8
    while p * 2 < w:
        p <<= 1
    for m in (4, 5, 6, 7, 8):
        if w <= p * m // 4:
            return p * m // 4
    return p * 2


def encode_streams(
    codes: torch.Tensor,    # (n_lanes, B) int32 codewords (0 past the data)
    lens: torch.Tensor,     # (n_lanes, B) int32 code lengths (0 past the data)
    n_pairs: int,           # real symbols (row-major)
    min_len,                # shortest code length: int or 0-dim tensor
    n_real: int,            # real block lanes
) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved group streams of a coded block grid: ``pack_streams``
    with the protocol lengths (garbage steps past the data consume
    ``min_len`` zero bits) and the bucketed ``words_cap`` of the host
    container path. Reads the groups' largest word total to the host."""
    n_lanes, B = codes.shape
    dev = codes.device
    pos = torch.arange(n_lanes * B, device=dev).reshape(n_lanes, B)
    eff = torch.where(pos < n_pairs, lens, min_len).to(torch.int32)
    lane = torch.arange(n_lanes, device=dev)
    bits = torch.where(lane < n_real, eff.sum(dim=1), 0)
    gwords = (bits >> 5).reshape(-1, GROUP_LANES).sum(dim=1)
    cap = bucket_words(max(int(gwords.max()), 128))
    return pack_streams(codes, eff, n_real, cap)
