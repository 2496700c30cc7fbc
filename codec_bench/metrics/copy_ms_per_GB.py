"""Device milliseconds of copies and fills (``torch.profiler``'s memcpy
and memset events: uploads, downloads, zeroing) per GB of input
(compress) or output (decompress): the codec's device glue."""

NEEDS = {"profile"}


def read(t, qualifier: str):
    if qualifier != t.direction or t.device is None:
        return None
    copy_s = t.device.seconds("copy")
    return copy_s * 1e3 / (t.pass_bytes / 1e9) if copy_s else None
