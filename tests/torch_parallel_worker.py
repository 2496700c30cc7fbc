"""One rank of the two-rank gloo group that tests/test_torch_parallel.py
starts: it runs the port's distribution layer (huffman_tpu_torch.parallel)
on the CPU and imports no JAX and nothing of huffman_tpu.

    python tests/torch_parallel_worker.py <dir> <rank> <world>

Reads the cases' inputs from <dir>/inputs.npz (arrays named
"<case>.<field>"), joins the group through the file store <dir>/store,
and writes its outputs to <dir>/rank<rank>.npz, named the same way. Each
encoder gets its rank's shard of the whole input (``pipeline.shard``),
as the JAX package's mesh shards it.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from huffman_tpu_torch.codebook import Codebook  # noqa: E402
from huffman_tpu_torch.container import sharded  # noqa: E402
from huffman_tpu_torch.ops.tables import tables_from_codebook  # noqa: E402
from huffman_tpu_torch.parallel import pipeline as pp  # noqa: E402

CPU = torch.device("cpu")


def _i16(a: np.ndarray) -> torch.Tensor:
    """u16 symbols (held in any integer dtype) as the port's int16 bits."""
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.uint16)).view(np.int16))


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _tables(inp: dict, case: str):
    cb = Codebook.from_lengths(inp[f"{case}.lengths"].astype(np.uint8))
    return tables_from_codebook(cb, CPU)


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


def run(inp: dict, rank: int, world: int) -> dict:
    out = {}

    sym = inp["hist.symbols"]
    mine = sym[rank * sym.size // world : (rank + 1) * sym.size // world]
    out["hist.hist"] = pp.distributed_histogram(_i16(mine)).numpy()

    c = "step"
    hist, slab, bits, ok = pp.compress_decompress_step(
        pp.shard(_i16(inp[f"{c}.padded"])), int(inp[f"{c}.n_pairs"]),
        _tables(inp, c), int(inp[f"{c}.W"]),
    )
    out.update({f"{c}.hist": hist.numpy(), f"{c}.slab": slab.numpy(),
                f"{c}.bits": bits.numpy(), f"{c}.ok": ok.numpy()})

    c = "encdec"
    t = _tables(inp, c)
    B = inp[f"{c}.padded"].shape[1]
    slab, bits = pp.distributed_encode(
        pp.shard(_i16(inp[f"{c}.padded"])), int(inp[f"{c}.n_pairs"]), t, B
    )
    out.update({f"{c}.slab": slab.numpy(), f"{c}.bits": bits.numpy(),
                f"{c}.decoded": pp.distributed_decode(slab, t, B).numpy()})

    for c in ("groups_translate", "groups_rank6000", "groups_rank_full"):
        t = _tables(inp, c)
        streams, n_real = pp.shard(_i32(inp[f"{c}.streams"])), pp.shard(_i32(inp[f"{c}.n_real"]))
        n_steps, translate = int(inp[f"{c}.n_steps"]), bool(inp[f"{c}.translate"])
        for packed in (True, False):
            out[f"{c}.packed{int(packed)}"] = pp.distributed_decode_groups(
                streams, n_real, t, n_steps, translate, packed_out=packed
            ).numpy()

    for c in ("streams_200", "streams_deep", "streams_12k", "streams_full"):
        streams, counts, lengths, ok = pp.distributed_encode_streams(
            pp.shard(_i16(inp[f"{c}.padded"])), int(inp[f"{c}.n_pairs"]),
            max_len=int(inp[f"{c}.max_len"]),
        )
        out.update({f"{c}.streams": streams.numpy(), f"{c}.counts": counts.numpy(),
                    f"{c}.lengths": lengths.numpy(), f"{c}.ok": ok.numpy()})

    data = inp["htpx.data"].tobytes()
    blob = sharded.compress(data, n_shards=4, codebook_mode="global",
                            group=dist.group.WORLD, device="cpu")
    out["htpx.blob"] = np.frombuffer(blob, np.uint8)

    lanes = (rank + 1) * 1024  # a different shard size on each rank
    out["errors.unequal_shards"] = np.array(_raises(lambda: pp.distributed_encode_streams(
        torch.zeros((lanes, 4), dtype=torch.int16), 100)))
    out["errors.partial_group"] = np.array(_raises(lambda: pp.distributed_encode_streams(
        torch.zeros((512, 4), dtype=torch.int16), 100)))
    out["errors.uneven_split"] = np.array(_raises(lambda: pp.shard(torch.zeros(3, 128))))
    out["errors.device"] = np.array(_raises(lambda: pp.distributed_histogram(
        torch.zeros(8, dtype=torch.int16, device="meta"))))
    # The group still works after every rank raised together.
    out["errors.after"] = pp.distributed_histogram(_i16(np.array([rank]))).numpy()[:world]

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "huffman_tpu"))
    out["modules.foreign"] = np.array(" ".join(loaded))
    return out


def main() -> int:
    d, rank, world = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    inp = dict(np.load(d / "inputs.npz"))
    dist.init_process_group(
        "gloo", init_method=f"file://{d / 'store'}", rank=rank, world_size=world
    )
    try:
        out = run(inp, rank, world)
    finally:
        dist.destroy_process_group()
    np.savez(d / f"rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
