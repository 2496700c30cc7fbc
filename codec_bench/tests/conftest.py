"""Sizes of the tiny root for the configurations that ``tiny.SIZES`` does
not name: each input's size, odd so that the tail byte is in.

``zipf65536_resident`` takes 3 MiB + 1 bytes and not ``bench_headline``'s
300,001: at that size 65,536 distinct pairs do not pay for their codebook,
the container is stored raw, and the control, which leaves out the reorder,
would then read it right."""

from codec_bench.tests import tiny

tiny.SIZES.setdefault("zipf65536_resident", lambda i, b: 3 * 2**20 + 1)
