"""The share of the profiled calls' wall time in which no kernel, copy or
fill runs on the card, in %: the union of ``torch.profiler``'s device
intervals, inside the benchmark's range around each call."""

NEEDS = {"profile"}


def read(t, qualifier: str):
    if qualifier != t.direction or t.device is None or not t.device.device:
        return None
    return 100.0 * (1.0 - t.device.busy_s / t.device.window_s)
