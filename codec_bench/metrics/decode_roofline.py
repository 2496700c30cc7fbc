"""The decompress calls' kernels against the card's bandwidth: the least
time their bytes need (``roofline.decode_bytes``: each stream byte read
once, each restored byte written once) over the summed device time of
every kernel the calls launch, in %."""

from codec_bench import roofline

NEEDS = {"profile"}


def read(t, qualifier: str):
    if t.direction != "decompress" or t.device is None or t.pass_stream_words is None:
        return None
    n_bytes = roofline.decode_bytes(t.pass_bytes, t.pass_stream_words)
    return roofline.share_pct(n_bytes, t.device.seconds("kernel"), t.card)
