"""The device's idle share of the traced slice, in %: 1 - (union of the
kernel, memcpy and memset intervals) / (the slice's length), from
torch.profiler's trace. Nothing where no slice was traced."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
