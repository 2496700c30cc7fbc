"""The benchmark's inputs, made on the device from the run's seed.

Every seed gets the same work. An input is drawn once from its content
kind, with the generator seeded by the content's own ``base_seed``, and the
run's seed only shuffles it in whole ``shuffle_bytes`` pieces (one
interleaved group of 1,024 blocks at the configuration's settings), with
``torch.randperm`` on the device. So the codebook, every group's streams
and every buffer's size are the same from seed to seed, and the bytes'
order is not: with the pair values or the counts drawn anew, sizes moved by
a few hundred bytes, and the codec's speed on an H100 by up to 2.3x with
them (its host buffers against glibc's heap thresholds). Within
the draw each rank of the distribution occurs its expected number of times
(rounded by largest remainders), in an order drawn from the generator. One
input takes a few large calls, whatever its size. The same seed, index and
device give the same bytes.

* ``silesia_like``: the share ``text_share`` of the pairs follows
  Zipf(``text_zipf``) over ``text_pairs`` distinct pairs drawn from the
  pair values below ``text_alphabet``, the rest
  is uniform over ``noise_pairs`` distinct pairs of the whole alphabet;
  text first, then noise, and an odd size ends in one uniform byte. About
  4,000 distinct pairs and a ratio near 0.56 at the defaults.
* ``zipf_pairs``: Zipf(``zipf``) over ``n_unique`` distinct pairs, ranked in
  a random order.
"""

from __future__ import annotations

import hashlib

import torch


def input_seed(seed: int, index: int) -> int:
    """The generator seed of input ``index`` of a run seeded ``seed``."""
    digest = hashlib.sha256(f"{seed}:{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _zipf_ranks(n: int, n_unique: int, expo: float, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """``n`` ranks in [0, n_unique), rank k occurring n * (k + 1) ** -expo /
    sum times, rounded by largest remainders, in an order drawn from
    ``gen``."""
    weights = torch.arange(1, n_unique + 1, dtype=torch.float64, device=device) ** -expo
    share = weights * (n / weights.sum())
    counts = share.floor().to(torch.int64)
    short = n - int(counts.sum())
    counts[torch.argsort(counts - share, stable=True)[:short]] += 1
    ranks = torch.repeat_interleave(torch.arange(n_unique, device=device), counts)
    return ranks[torch.randperm(n, generator=gen, device=device)]


def _pairs_to_bytes(pairs: torch.Tensor) -> torch.Tensor:
    p = pairs.to(torch.int32)
    return torch.stack([p & 0xFF, p >> 8], dim=1).to(torch.uint8).reshape(-1)


def silesia_like(n_bytes: int, gen: torch.Generator, device: torch.device, text_share: float,
                 text_pairs: int, text_zipf: float, text_alphabet: int,
                 noise_pairs: int) -> torch.Tensor:
    n_text = int(n_bytes * text_share) // 2
    n_noise = n_bytes // 2 - n_text
    alphabet = torch.randperm(text_alphabet, generator=gen, device=device)[:text_pairs]
    text = alphabet[_zipf_ranks(n_text, text_pairs, text_zipf, gen, device)]
    noise_alphabet = torch.randperm(1 << 16, generator=gen, device=device)[:noise_pairs]
    noise = noise_alphabet[_zipf_ranks(n_noise, noise_pairs, 0.0, gen, device)]
    parts = [_pairs_to_bytes(torch.cat([text, noise]))]
    if n_bytes % 2:
        parts.append(torch.randint(0, 256, (1,), generator=gen, device=device).to(torch.uint8))
    return torch.cat(parts)


def zipf_pairs(n_bytes: int, gen: torch.Generator, device: torch.device, n_unique: int,
               zipf: float) -> torch.Tensor:
    alphabet = torch.randperm(1 << 16, generator=gen, device=device)[:n_unique]
    parts = [_pairs_to_bytes(alphabet[_zipf_ranks(n_bytes // 2, n_unique, zipf, gen, device)])]
    if n_bytes % 2:
        parts.append(torch.randint(0, 256, (1,), generator=gen, device=device).to(torch.uint8))
    return torch.cat(parts)


KINDS = {"silesia_like": silesia_like, "zipf_pairs": zipf_pairs}


def make(content: dict, n_bytes: int, seed: int, index: int,
         device: torch.device) -> torch.Tensor:
    """Input ``index`` of a run: ``n_bytes`` uint8 on ``device``, of the
    content kind and parameters that ``content`` gives, in the order that
    ``seed`` draws."""
    params = dict(content)
    kind = KINDS[params.pop("kind")]
    piece = params.pop("shuffle_bytes")
    gen = torch.Generator(device=device)
    gen.manual_seed(params.pop("base_seed"))
    data = kind(n_bytes, gen, device, **params)
    n_pieces = n_bytes // piece
    if n_pieces > 1:
        gen.manual_seed(input_seed(seed, index))
        order = torch.randperm(n_pieces, generator=gen, device=device)
        head = data[: n_pieces * piece].view(n_pieces, piece)[order].reshape(-1)
        data = torch.cat([head, data[n_pieces * piece:]])
    return data
