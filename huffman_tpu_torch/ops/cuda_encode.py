"""Lane packing (K4), stream assembly and the in-kernel deposit (K10):
counterpart of huffman_tpu/ops/pallas_encode.py.

``pack_lanes`` is K4 (``csrc/pack.cu`` for CUDA tensors,
``pack_lanes_plain`` for CPU tensors): per lane, the word completed at each
step and the final left-aligned partial word. Two stream assemblies build
the interleaved group streams from it, as the JAX package has two:

* ``pack_streams_kernel_deposit``, counterpart of the function of that
  name: the fire bits packed 32 steps to a word, then ``deposit_streams``
  (K10, ``csrc/deposit.cu``; counterpart of ``deposit_streams_pallas``),
  which stores every word in its stream slot: blocks walk runs of steps
  backward on their own, from slot bases that are suffix sums of the fire
  counts. Both compress routes assemble their streams this way, through
  ``encode_streams`` (protocol lengths, a bucketed ``words_cap`` from the
  groups' word totals, K4 and K10): on the H100 it takes a third of
  ``pack_streams``' time (PERF.md §6, the route A/Bs).
* ``pack_streams``, counterpart of ``pack_streams_pallas``: the reverse
  lookahead and the deposit as vectorised tensor ops, where the JAX package
  runs an XLA scan and a sorted scatter around its Pallas packer (the
  TPU's faster form). No compress route runs it; it stays as the
  counterpart the tests hold.

``pack_blocks`` (counterpart of ``pack_blocks_pallas``) scatters the
staging into per-block ``(nblocks, W)`` slabs: the v1 container's payload.

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
    (0 if none), column B the final left-aligned partial word.

    Precondition, not checked: ``0 <= L <= 32`` and ``code < 2**L`` at
    every step. Every caller meets it (the gathers write right-justified
    codes; garbage steps carry code 0; ``pack_blocks`` pads with length
    0), and the kernel's prefix-sum form equals the serial walk of
    ``pack_lanes_plain`` under it."""
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


def pack_blocks(
    codes: torch.Tensor,  # (nblocks, B) int32 bits of right-justified codes
    lens: torch.Tensor,   # (nblocks, B) int32 lengths (0 = padding)
    words_per_block: int,
) -> torch.Tensor:
    """(nblocks, words_per_block) int32 slab, each block's stream from bit
    0 of its row: K4 on the real lengths, then word j of a lane, completed
    at the step where its bit total reaches 32 (j + 1), and the final
    partial word scattered into the lane's row. Indices clamp into the row
    and the scatter adds in int64, as ``pack_blocks_pallas`` does in
    uint32."""
    nblocks, B = codes.shape
    W = words_per_block
    st = widen(pack_lanes(codes, lens))
    cum = torch.cumsum(lens, dim=1, dtype=torch.int32).to(torch.int64)
    r = cum >> 5
    emit = torch.diff(r, dim=1, prepend=torch.zeros_like(r[:, :1])) > 0
    row = torch.arange(nblocks, device=codes.device)[:, None] * W
    slab = torch.zeros(nblocks * W, dtype=torch.int64, device=codes.device)
    slab.index_add_(
        0, (row + (r - 1).clamp(0, W - 1)).reshape(-1),
        torch.where(emit, st[:, :B], 0).reshape(-1),
    )
    total = cum[:, -1:]
    slab.index_add_(
        0, (row + (total >> 5).clamp(0, W - 1)).reshape(-1),
        torch.where((total & 31) > 0, st[:, B:], 0).reshape(-1),
    )
    return narrow(slab).reshape(nblocks, W)


def step_major(a: torch.Tensor) -> torch.Tensor:
    """(n_lanes, K) lane-major -> (ngroups, K * GROUP_LANES), in (step,
    lane) order within each group."""
    ngroups = a.shape[0] // GROUP_LANES
    return a.reshape(ngroups, GROUP_LANES, -1).transpose(1, 2).reshape(ngroups, -1)


def _fires(eff_lens: torch.Tensor, n_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(r, fire): words completed after each step (0 on pad lanes), and
    whether a word completed at the step."""
    lane = torch.arange(eff_lens.shape[0], device=eff_lens.device)
    cum = torch.cumsum(eff_lens, dim=1, dtype=torch.int32)
    r = torch.where((lane < n_real)[:, None], cum, 0) >> 5
    fire = torch.diff(r, dim=1, prepend=torch.zeros_like(r[:, :1])) > 0
    return r, fire


def _check_cap(body_max: int, words_cap: int) -> None:
    if body_max > words_cap:
        raise ValueError(f"words_cap {words_cap} < a group's {body_max} body words")


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
    r, fire = _fires(eff_lens, n_real)

    # Words of each lane by index: word k at column k, the partial word at
    # column R, zeros after it; column B + 2 takes the non-fire writes.
    spare = B + 2
    by_index = torch.zeros((n_lanes, B + 3), dtype=torch.int32, device=dev)
    by_index.scatter_(1, torch.where(fire, r - 1, spare).long(), st[:, :B])
    by_index.scatter_(1, r[:, -1:].long(), st[:, B:])
    later = by_index.gather(1, torch.where(fire, r + 1, spare).long())

    fire_g = step_major(fire)
    counts = fire_g.sum(dim=1)
    _check_cap(int(counts.max()) if ngroups else 0, words_cap)
    g_idx, s_idx = fire_g.nonzero(as_tuple=True)  # row-major: slot order
    slot = torch.cumsum(fire_g, dim=1, dtype=torch.int32)[g_idx, s_idx] - 1
    body = torch.zeros((ngroups, words_cap), dtype=torch.int32, device=dev)
    body[g_idx, slot.long()] = step_major(later)[g_idx, s_idx]
    streams = torch.cat([step_major(by_index[:, :PRELOAD_WORDS]), body], dim=1)
    return streams, counts + PRELOAD_WORDS * GROUP_LANES


def _mask_bits(fire: torch.Tensor) -> torch.Tensor:
    """(n_lanes, ceil(B / 32)) int32: the (n_lanes, B) bool fire bits
    packed 32 steps to a word, bit t & 31 of word t >> 5. Eight steps'
    bools read as one little-endian int64; in each half, four 0/1 bytes
    times 0x204081 put byte k's bit at bit 21 + k (the partial products
    never overlap and stay below 2**47), so two nibbles make a byte and
    four bytes a word. The cheapest of four equal forms on the H100
    (PERF.md §6, the route A/Bs)."""
    n_lanes, B = fire.shape
    mb = -(-B // 32)
    if B % 32:
        fire = torch.nn.functional.pad(fire, (0, mb * 32 - B))
    v = fire.contiguous().view(torch.int64)
    lo = (((v & 0xFFFFFFFF) * 0x204081) >> 21) & 15
    hi = (((v >> 32) * 0x204081) >> 21) & 15
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int32)


def _deposit_inputs(codes: torch.Tensor, eff_lens: torch.Tensor, n_real: int):
    """(staging, mask_bits, body_words (ngroups,) int32): K4's staging,
    the packed fire bits and each group's body words, as K10 takes them.
    A step completes a word when its bits carry the lane's running total
    past a multiple of 32 (at most one word: lengths are at most 32), which
    is ``_fires``' test without the per-step word counts."""
    if codes.shape[0] % GROUP_LANES:
        raise ValueError("n_lanes must be a multiple of GROUP_LANES")
    st = pack_lanes(codes, eff_lens)
    cum = torch.cumsum(eff_lens, dim=1, dtype=torch.int32)
    fire = (cum & 31) < eff_lens
    fire[n_real:] = False  # pad lanes
    words = cum[:, -1] >> 5
    words[n_real:] = 0
    body_words = words.reshape(-1, GROUP_LANES).sum(dim=1, dtype=torch.int32)
    return st, _mask_bits(fire), body_words


def pack_streams_kernel_deposit(
    codes: torch.Tensor,     # (n_lanes, B) int32 codewords (0 on garbage steps)
    eff_lens: torch.Tensor,  # (n_lanes, B) int32 protocol lengths
    n_real: int,             # real lanes; the rest are pads
    words_cap: int,          # bound on every group's body words
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack and interleave with the deposit in K10. Returns (streams
    (ngroups, 2048 + cap') int32 bits, cap' = ``words_cap`` rounded up to a
    multiple of 1024, and counts (ngroups,) int64 words per group, preload
    included): the contract of the JAX ``pack_streams_kernel_deposit``.
    Equal to ``pack_streams`` up to each group's count and zero after it.
    Raises ``ValueError`` if a group's body exceeds ``words_cap``."""
    st, mask_bits, body_words = _deposit_inputs(codes, eff_lens, n_real)
    streams = deposit_streams(st, mask_bits, body_words, words_cap)
    return streams, body_words.to(torch.int64) + PRELOAD_WORDS * GROUP_LANES


def deposit_streams(
    staging: torch.Tensor,     # (n_lanes, B + 1) int32: K4's staging
    mask_bits: torch.Tensor,   # (n_lanes, ceil(B / 32)) int32 packed fire bits
    body_words: torch.Tensor,  # (ngroups,) int32 body words per group
    words_cap: int,            # bound on every group's body words
) -> torch.Tensor:
    """Interleaved streams (ngroups, 2048 + cap') int32 bits from the
    staging and the fire bits, cap' = ``words_cap`` rounded up to a
    multiple of 1024; every slot past a group's words is zero. The
    contract of ``deposit_streams_pallas`` with lane-major inputs (the JAX
    function takes them as (8, 128) tiles)."""
    dev = staging.device
    kernels.check(staging, torch.int32, dev, "staging")
    kernels.check(mask_bits, torch.int32, dev, "mask_bits")
    kernels.check(body_words, torch.int32, dev, "body_words")
    n_lanes, B1 = staging.shape
    ngroups = n_lanes // GROUP_LANES
    if n_lanes % GROUP_LANES or mask_bits.shape != (n_lanes, -(-(B1 - 1) // 32)):
        raise ValueError("staging must be (n_lanes, B + 1), mask_bits (n_lanes, ceil(B / 32))")
    if body_words.shape != (ngroups,):
        raise ValueError("body_words must be (ngroups,)")
    _check_cap(int(body_words.max()) if ngroups else 0, words_cap)
    return _deposit(staging, mask_bits, body_words, words_cap)


def _deposit(staging, mask_bits, body_words, words_cap: int) -> torch.Tensor:
    """K10 (the plain version for CPU tensors) on inputs that
    ``deposit_streams`` has checked, or that ``encode_streams`` built with
    ``words_cap`` bounding every group by construction."""
    dev = staging.device
    if dev.type == "cuda":
        n_lanes, B1 = staging.shape
        ngroups = n_lanes // GROUP_LANES
        cap = -(-words_cap // GROUP_LANES) * GROUP_LANES
        out = torch.empty((ngroups, PRELOAD_WORDS * GROUP_LANES + cap), dtype=torch.int32, device=dev)
        kernels.launch(
            "deposit_streams", staging.data_ptr(), B1 - 1, mask_bits.data_ptr(),
            mask_bits.shape[1], body_words.data_ptr(), ngroups, cap, out.data_ptr(),
        )
        return out
    if dev.type == "cpu":
        return deposit_streams_plain(staging, mask_bits, body_words, words_cap)
    raise ValueError(f"deposit_streams: unsupported device {dev}")


def deposit_streams_plain(
    staging: torch.Tensor, mask_bits: torch.Tensor, body_words: torch.Tensor, words_cap: int
) -> torch.Tensor:
    """Plain PyTorch version of K10: its backward walk as vector ops over
    all lanes, one Python iteration per step."""
    cap = -(-words_cap // GROUP_LANES) * GROUP_LANES
    n_lanes, B1 = staging.shape
    ngroups = n_lanes // GROUP_LANES
    dev = staging.device
    st = widen(staging)
    masks = widen(mask_bits)
    pre = PRELOAD_WORDS * GROUP_LANES
    out = torch.zeros((ngroups, pre + cap), dtype=torch.int64, device=dev)
    v1, v2 = st[:, B1 - 1].clone(), torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    head = body_words.to(torch.int64)[:, None]
    for t in range(B1 - 2, -1, -1):
        fired = ((masks[:, t >> 5] >> (t & 31)) & 1).bool()
        f = fired.reshape(ngroups, GROUP_LANES).to(torch.int64)
        head = head - f.sum(dim=1, keepdim=True)
        slot = head + torch.cumsum(f, dim=1) - f
        keep = (f > 0) & (slot >= 0) & (slot < cap)
        g, l = keep.nonzero(as_tuple=True)
        out[g, pre + slot[g, l]] = v2.reshape(ngroups, GROUP_LANES)[g, l]
        v2 = torch.where(fired, v1, v2)
        v1 = torch.where(fired, st[:, t], v1)
    out[:, :GROUP_LANES] = v1.reshape(ngroups, GROUP_LANES)
    out[:, GROUP_LANES:pre] = v2.reshape(ngroups, GROUP_LANES)
    return narrow(out)


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
    """Interleaved group streams of a coded block grid, as
    ``pack_streams_kernel_deposit`` builds them (K4, then K10): the
    protocol lengths (garbage steps past the data consume ``min_len`` zero
    bits) and the bucketed ``words_cap`` of the host container path.
    Returns (streams (ngroups, 2048 + cap') int32 bits, counts (ngroups,)
    int64); readers trim each group to its count. The groups' largest body
    is read to the host once, to size the buffer, which then bounds every
    group by construction."""
    eff = lens.to(torch.int32, memory_format=torch.contiguous_format, copy=True)
    eff.view(-1)[n_pairs:].fill_(min_len)  # positions are row-major
    st, mask_bits, body_words = _deposit_inputs(codes, eff, n_real)
    cap = bucket_words(max(int(body_words.max()), 128))
    streams = _deposit(st, mask_bits, body_words, cap)
    return streams, body_words.to(torch.int64) + PRELOAD_WORDS * GROUP_LANES
