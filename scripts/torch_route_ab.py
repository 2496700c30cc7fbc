#!/usr/bin/env python3
"""Route A/B of three choices on the port's main path, on one CUDA card:

    python3 scripts/torch_route_ab.py [--reps N]

The A/Bs are ``chip_smoke.route_abs`` (the smoke runs them with 5
repetitions), here with ``--reps`` (default 7):

(a) stream assembly in ``cuda_encode.encode_streams``: the tensor-op
    ``pack_streams`` (the form the JAX package chose for the TPU) against
    K4 + K10, on the arguments the fused encode hands it on the bench's
    three 32 MiB rungs; K10's inputs as the deposit path first built them
    against the package's; the whole fused encode (the bench's encode
    line) with each assembly. Here also the deposit route's pieces, each
    timed alone (the protocol lengths, K4, the fire bits, the body words,
    the host read, the mask packing, K10), and the mask packing's four
    forms (int64 and int32 shift-sums, a weighted byte sum, and the
    package's multiply that gathers four bool bytes into a nibble).
(b) the gather boundary ``fused.CANON_GATHER_MIN_CAP``: the whole
    ``tiered_code_gather`` with K8 and with K9, and its gather stage from
    the canonical tables on, at tier 4096 (silesia-like) and tier 16384
    (``zipf_pairs(32 MiB, 12000, rng(13))``); the encode line with each at
    tier 4096.
(c) the translate boundary ``cuda_decode.TRANSLATE_MAX_ALPHABET``: K1 in
    rank mode + K2 against K1 in translate mode, on the v2 containers of
    silesia-like (~4k symbols), the 12,000-symbol input, wide30k
    (30,000), the full alphabet (65,536), ``zipf_pairs(8 MiB, 300,
    rng(5))`` and ``zipf_pairs(8 MiB, 30000, rng(3))`` (8 groups each), at
    their own groups and with their streams repeated five
    times (160 groups at 32 MiB: more blocks than SMs). Translate mode is
    also held against its plain version at the inputs' own groups.

Each comparison prints one ``ab`` line: the median ms a call and the
spread (slowest - fastest repetition) of each form, the difference, and
whether the second form wins by more than the larger spread (the
switching rule). The last line is a JSON record of every comparison with
the card's name and power limit. Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import huffman_tpu_torch as ht  # noqa: E402
from huffman_tpu_torch.constants import GROUP_LANES  # noqa: E402
from huffman_tpu_torch.container import block_format as bf  # noqa: E402
from huffman_tpu_torch.corpus import silesia_like, wide30k, zipf_pairs  # noqa: E402
from huffman_tpu_torch.ops import cuda_decode, cuda_encode, fused  # noqa: E402
from huffman_tpu_torch.runtime import kernels  # noqa: E402
from huffman_tpu_torch.u32 import narrow  # noqa: E402
from huffman_tpu_torch.utils.benchmark import device_line  # noqa: E402

BIG = 32 << 20


def mask_int64(fire):
    n_lanes, B = fire.shape
    mb = -(-B // 32)
    padded = torch.nn.functional.pad(fire, (0, mb * 32 - B)).reshape(n_lanes, mb, 32)
    return narrow((padded.to(torch.int64) << torch.arange(32, device=fire.device)).sum(dim=2))


def mask_int32(fire):
    n_lanes, B = fire.shape
    mb = -(-B // 32)
    padded = torch.nn.functional.pad(fire, (0, mb * 32 - B)).reshape(n_lanes, mb, 32)
    bit = torch.arange(32, dtype=torch.int32, device=fire.device)
    return (padded.to(torch.int32) << bit).sum(dim=2, dtype=torch.int32)


def mask_bytes(fire):
    """Eight steps to a byte by a weighted uint8 sum; four bytes read as
    one little-endian int32."""
    n_lanes, B = fire.shape
    mb = -(-B // 32)
    if B % 32:
        fire = torch.nn.functional.pad(fire, (0, mb * 32 - B))
    weight = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8, device=fire.device)
    return (fire.contiguous().view(torch.uint8).reshape(n_lanes, 4 * mb, 8) * weight).sum(
        dim=2, dtype=torch.uint8).view(torch.int32)


def pieces(records: list, case: str, args, iters: int, reps: int, card: str) -> None:
    """The deposit route's pieces, each timed alone, and the mask
    packing's forms in turns."""
    codes, lens, n_pairs, min_len, n_real = args
    eff = lens.to(torch.int32, copy=True)
    eff.view(-1)[n_pairs:].fill_(min_len)
    st, mask, body = cuda_encode._deposit_inputs(codes, eff, n_real)
    cum = torch.cumsum(eff, dim=1, dtype=torch.int32)
    fire = (cum & 31) < eff
    fire[n_real:] = False
    if not all(torch.equal(mask, f(fire)) for f in (mask_int64, mask_int32, mask_bytes)):
        raise AssertionError(f"{case}: the mask packing's forms differ")
    cap = cuda_encode.bucket_words(max(int(body.max()), 128))

    def fires():
        c = torch.cumsum(eff, dim=1, dtype=torch.int32)
        f = (c & 31) < eff
        f[n_real:] = False
        return c, f

    def body_words():
        words = cum[:, -1] >> 5
        words[n_real:] = 0
        return words.reshape(-1, GROUP_LANES).sum(dim=1, dtype=torch.int32)

    def protocol_lengths():
        e = lens.to(torch.int32, copy=True)
        e.view(-1)[n_pairs:].fill_(min_len)
        return e

    parts = {
        "protocol lengths": protocol_lengths,
        "K4 pack_lanes": lambda: cuda_encode.pack_lanes(codes, eff),
        "fire bits (int32 cumsum)": fires,
        "body words": body_words,
        "host read of the largest body": lambda: int(body.max()),
        "mask packing": lambda: cuda_encode._mask_bits(fire),
        "K10 deposit": lambda: cuda_encode._deposit(st, mask, body, cap),
    }
    out = {}
    for name, fn in parts.items():
        ms, spread = cs.in_turns({name: fn}, iters, reps)[name]
        out[name] = [ms, spread]
        print(f"piece deposit route [{case}] {name}: {ms:.4f} ms (spread {spread:.4f}) ({card})", flush=True)
    records.append({"choice": "a pieces", "case": case, **out})
    cs.ab(records, "a mask packing", case, {"int64": lambda: mask_int64(fire),
                                            "int32": lambda: mask_int32(fire)}, iters, reps, card)
    cs.ab(records, "a mask packing", case, {"int32": lambda: mask_int32(fire),
                                            "bytes": lambda: mask_bytes(fire)}, iters, reps, card)
    cs.ab(records, "a mask packing", case, {"bytes": lambda: mask_bytes(fire),
                                            "multiply": lambda: cuda_encode._mask_bits(fire)}, iters, reps, card)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_route_ab: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = device_line(dev)
    print(card)
    _, log = kernels.build()
    kernels.load()
    cs.check_k1_shared_memory(log)
    inputs = {
        "silesia_like": silesia_like(BIG, seed=7).tobytes(),
        "zipf12000": zipf_pairs(BIG, 12000, np.random.default_rng(13)).tobytes(),
        "wide30k": wide30k(BIG).tobytes(),
        "full_alphabet": zipf_pairs(BIG, 65536, np.random.default_rng(11)).tobytes(),
        "zipf300_8MiB": zipf_pairs(8 << 20, 300, np.random.default_rng(5)).tobytes(),
        "zipf30000_8MiB": zipf_pairs(8 << 20, 30000, np.random.default_rng(3)).tobytes(),
    }
    blobs, enc_args, gather_args = {}, {}, {}
    for name, data in inputs.items():
        calls = [(fused, "encode_streams"), (fused, "encode_from_histogram")]
        blob, seen = cs.capture(calls, ht.compress, data, dev)
        if blob != ht.compress(data, "cpu"):
            raise AssertionError(f"{name}: the card's container differs from the CPU path's")
        blobs[name] = blob
        if name in ("silesia_like", "wide30k", "full_alphabet"):
            enc_args[name] = seen["encode_streams"]
        sym, n_valid, hist, _ = seen["encode_from_histogram"]
        gather_args[name] = (hist, int((hist > 0).sum()), sym, n_valid)
        print(f"input {name}: {len(data)} B, {gather_args[name][1]} symbols, "
              f"tier {fused.tier_for(gather_args[name][1])}", flush=True)
        streams, n_real, tables, B = bf.v2_device_inputs(bf.ParsedContainer(blob), dev)
        got = cuda_decode.decode_groups(streams, n_real, tables, B, True)
        if not torch.equal(got, cuda_decode.decode_groups_plain(streams, n_real, tables, B, True)):
            raise AssertionError(f"{name}: K1 translate differs from its plain version")
    del gather_args["zipf300_8MiB"], gather_args["zipf30000_8MiB"]

    records = cs.route_abs(enc_args, gather_args, blobs, dev, card, opts.reps)
    for name, args in enc_args.items():
        pieces(records, name, args, 10, opts.reps, card)
    print(json.dumps({"route_ab": records, "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
