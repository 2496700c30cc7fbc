"""Command-line interface of the port: counterpart of huffman_tpu/cli.py,
with the same verbs, flags, output names, messages and exit codes, and
``--device {cuda,cpu}`` in place of ``--backend``. The device work runs on
the card unless ``--device cpu`` asks for the plain PyTorch versions;
without a card the default fails (exit code 2), it never falls back.

Commands
--------
archive    — file -> <file>.compressed (reference-interop format)
extract    — <file>.compressed -> DECOMPRESSED_FILE (reference semantics,
             including rename-on-collision) or -o <path>; the reference
             format's decode is host code, so it takes no device
compress   — file -> <file>.htpu (native block container; ``--shards N``
             writes an HTPX archive, ``--stream-mb N`` an HTPS stream)
decompress — <file>.htpu -> original (default strips .htpu or -o <path>)
info       — container metadata
verify     — decode in memory and check integrity
transcode  — convert between the native and the reference format

``--time`` prints per-stage wall times and throughput.

    python -m huffman_tpu_torch compress big.bin --stream-mb 16
    python -m huffman_tpu_torch decompress big.bin.htpu -o big.out --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def _unique_path(base: Path) -> Path:
    """DECOMPRESSED_FILE, DECOMPRESSED_FILE(1), ... (the reference's
    collision behavior)."""
    if not base.exists():
        return base
    i = 1
    while True:
        cand = base.with_name(f"{base.name}({i})")
        if not cand.exists():
            return cand
        i += 1


class _Timer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._t0 = time.perf_counter()

    def stage(self, name: str, nbytes: int | None = None) -> None:
        if not self.enabled:
            return
        dt = time.perf_counter() - self._t0
        rate = f", {nbytes / dt / 1e6:.1f} MB/s" if nbytes else ""
        print(f"{name} took {dt * 1e3:.2f} ms{rate}", file=sys.stderr)
        self._t0 = time.perf_counter()


def _report(in_size: int, out_size: int) -> None:
    """Size/ratio report, with the inflation warning."""
    pct = 100.0 * out_size / in_size if in_size else 0.0
    print(f"{in_size} bytes -> {out_size} bytes ({pct:.2f}%)")
    if out_size > in_size:
        print(
            "WARNING: output is larger than input (incompressible data)",
            file=sys.stderr,
        )


def cmd_archive(args) -> int:
    from . import api

    src = Path(args.file)
    data = src.read_bytes()
    t = _Timer(args.time)
    blob = api.compress_reference(data, device=args.device)
    t.stage("compress", len(data))
    out = Path(args.output) if args.output else src.with_name(src.name + ".compressed")
    out.write_bytes(blob)
    _report(len(data), len(blob))
    return 0


def cmd_extract(args) -> int:
    from . import api

    blob = Path(args.file).read_bytes()
    t = _Timer(args.time)
    data = api.decompress_reference(blob)
    t.stage("decompress", len(data))
    out = Path(args.output) if args.output else _unique_path(Path("DECOMPRESSED_FILE"))
    out.write_bytes(data)
    print(f"wrote {out} ({len(data)} bytes)")
    return 0


def cmd_compress(args) -> int:
    from . import api

    src = Path(args.file)
    out = Path(args.output) if args.output else src.with_name(src.name + ".htpu")
    if args.stream_mb:
        if args.shards > 1 or args.mode != "interleaved":
            raise ValueError("--stream-mb cannot combine with --shards/--mode")
        # Bounded-memory chunked path for inputs of any size.
        from .container import streaming

        t = _Timer(args.time)
        with open(src, "rb") as f_in, open(out, "wb") as f_out:
            written = streaming.compress_stream(
                f_in, f_out, chunk_bytes=args.stream_mb << 20,
                device=args.device, block_symbols=args.block_symbols,
            )
        in_size = src.stat().st_size
        t.stage("compress", in_size)
        _report(in_size, written)
        return 0
    data = src.read_bytes()
    t = _Timer(args.time)
    blob = api.compress(
        data,
        device=args.device,
        block_symbols=args.block_symbols,
        mode=args.mode,
        n_shards=args.shards,
    )
    t.stage("compress", len(data))
    out.write_bytes(blob)
    _report(len(data), len(blob))
    return 0


def cmd_decompress(args) -> int:
    from . import api

    src = Path(args.file)
    if args.output:
        out = Path(args.output)
    elif src.suffix == ".htpu":
        out = _unique_path(src.with_suffix(""))
    else:
        out = _unique_path(Path("DECOMPRESSED_FILE"))

    with open(src, "rb") as f:
        head = f.read(4)
    if _detect(head) == "htps":
        # HTPS: stream chunk by chunk, bounded memory. Write through a
        # temp file so a corrupt stream never clobbers an existing output.
        from .container import streaming

        t = _Timer(args.time)
        tmp = out.with_name(out.name + ".tmp")
        try:
            with open(src, "rb") as f_in, open(tmp, "wb") as f_out:
                n = streaming.decompress_stream(f_in, f_out, device=args.device)
            tmp.replace(out)
        finally:
            tmp.unlink(missing_ok=True)
        t.stage("decompress", n)
        print(f"wrote {out} ({n} bytes)")
        return 0

    blob = src.read_bytes()
    t = _Timer(args.time)
    data = api.decompress(blob, device=args.device)
    t.stage("decompress", len(data))
    out.write_bytes(data)
    print(f"wrote {out} ({len(data)} bytes)")
    return 0


def _detect(blob: bytes) -> str:
    from .container import detect

    return detect(blob)


def cmd_info(args) -> int:
    blob = Path(args.file).read_bytes()
    kind = _detect(blob)
    if kind == "htpu":
        from .container.block_format import ParsedContainer

        try:
            c = ParsedContainer(blob)
        except ValueError as e:
            if "externally" not in str(e):
                raise
            print("format: HTPU (external codebook shard)")
            return 0
        mode = (
            "stored" if c.stored
            else {1: "block slabs", 2: "interleaved groups"}[c.version]
        )
        print(f"format: HTPU v{c.version} ({mode})")
        print(f"original size: {c.original_size}")
        print(f"compressed size: {len(blob)} ({100*len(blob)/max(c.original_size,1):.2f}%)")
        if not c.stored:
            print(f"blocks: {c.num_blocks} x {c.block_symbols} symbols")
            print(f"codebook: {c.n_unique} symbols, max code length {c.max_len}")
        print(f"crc32: {c.crc32:08x}")
    elif kind == "htps":
        n_records = 0
        total_comp = len(blob)
        pos = 8
        while pos + 4 <= len(blob):
            size = int.from_bytes(blob[pos : pos + 4], "little")
            pos += 4
            if size == 0:
                break
            n_records += 1
            pos += size
        original = int.from_bytes(blob[pos : pos + 8], "little") if pos + 8 <= len(blob) else 0
        print(f"format: HTPS streaming container v{blob[4]}")
        print(f"original size: {original}")
        print(f"compressed size: {total_comp} ({100*total_comp/max(original,1):.2f}%)")
        print(f"chunks: {n_records}")
    elif kind == "htpx":
        n_shards = int.from_bytes(blob[8:12], "little")
        original = int.from_bytes(blob[12:20], "little")
        mode = "global codebook" if blob[5] == 1 else "per-shard codebooks"
        print(f"format: HTPX sharded archive v{blob[4]} ({mode})")
        print(f"original size: {original}")
        print(f"compressed size: {len(blob)} ({100*len(blob)/max(original,1):.2f}%)")
        print(f"shards: {n_shards}")
    else:
        from .container.reference_format import parse_header

        h = parse_header(blob)
        print("format: reference .compressed (single bitstream)")
        print(f"original size: {h.file_size}")
        print(f"compressed size: {len(blob)} ({100*len(blob)/max(h.file_size,1):.2f}%)")
        print(f"codebook: {h.symbols.size} symbols, max code length {int(h.lengths.max(initial=0))}")
    return 0


def cmd_verify(args) -> int:
    from . import api

    blob = Path(args.file).read_bytes()
    kind = _detect(blob)
    t = _Timer(True)
    if kind == "reference":
        data = api.decompress_reference(blob)
        note = "roundtrip decode ok (format has no integrity field)"
    else:
        data = api.decompress(blob, device=args.device)
        note = "CRC32 verified"
    t.stage("verify", len(data))
    print(f"OK: {len(data)} bytes, {note}")
    return 0


def cmd_transcode(args) -> int:
    from . import api

    blob = Path(args.file).read_bytes()
    kind = _detect(blob)
    t = _Timer(args.time)
    if kind == "reference":
        data = api.decompress_reference(blob)
    else:
        data = api.decompress(blob, device=args.device)
    if args.to == "htpu":
        out_blob = api.compress(data, device=args.device)
        suffix = ".htpu"
    else:
        out_blob = api.compress_reference(data, device=args.device)
        suffix = ".compressed"
    t.stage("transcode", len(data))
    src = Path(args.file)
    out = Path(args.output) if args.output else src.with_suffix(suffix)
    out.write_bytes(out_blob)
    print(
        f"{kind} ({len(blob)} B) -> {args.to} ({len(out_blob)} B), "
        f"original {len(data)} B -> {out}"
    )
    return 0


def _device_flag(sp) -> None:
    sp.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="run the device work on the card (default; fails without one) "
        "or on the CPU",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="huffman_tpu_torch",
        description="PyTorch/CUDA Huffman codec (byte-pair alphabet)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("file", help="input path")
        sp.add_argument("-o", "--output", help="output path")
        _device_flag(sp)
        sp.add_argument(
            "--time", action="store_true", help="print per-stage timings"
        )

    sp = sub.add_parser("archive", help="compress to reference .compressed format")
    common(sp)
    sp.set_defaults(fn=cmd_archive)

    sp = sub.add_parser("extract", help="decompress a reference .compressed file")
    common(sp)
    sp.set_defaults(fn=cmd_extract)

    sp = sub.add_parser("compress", help="compress to the native block container")
    common(sp)
    sp.add_argument(
        "--block-symbols",
        type=int,
        default=None,
        help="symbols per independently decodable block",
    )
    sp.add_argument(
        "--mode",
        choices=["interleaved", "blocks"],
        default="interleaved",
        help="container profile (v2 interleaved / v1 block slabs)",
    )
    sp.add_argument(
        "--shards",
        type=int,
        default=1,
        help="split into N independently decodable shards (HTPX archive)",
    )
    sp.add_argument(
        "--stream-mb",
        type=int,
        default=0,
        help="stream in N-MiB chunks with bounded memory (HTPS container)",
    )
    sp.set_defaults(fn=cmd_compress)

    sp = sub.add_parser("decompress", help="decompress a native .htpu container")
    common(sp)
    sp.set_defaults(fn=cmd_decompress)

    sp = sub.add_parser("info", help="print container metadata")
    sp.add_argument("file")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser(
        "verify", help="decode in memory and check integrity (no output file)"
    )
    sp.add_argument("file")
    _device_flag(sp)
    sp.set_defaults(fn=cmd_verify)

    sp = sub.add_parser(
        "transcode",
        help="convert between container formats (e.g. reference .compressed "
        "-> native .htpu; the migration path for reference users)",
    )
    common(sp)
    sp.add_argument(
        "--to",
        choices=["htpu", "reference"],
        default="htpu",
        help="target format (default: native htpu)",
    )
    sp.set_defaults(fn=cmd_transcode)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "block_symbols", None) is None and hasattr(args, "block_symbols"):
        from .constants import DEFAULT_BLOCK_SYMBOLS

        args.block_symbols = DEFAULT_BLOCK_SYMBOLS
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (ValueError, RuntimeError, EOFError, IndexError) as e:
        # RuntimeError covers a CUDA device asked for without a card, and
        # failed kernel builds or launches; EOFError/IndexError cover
        # truncated headers in the magic-less reference format.
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
