"""The host's waits for the card per traced call: the program's counter
``host_waits`` (``kiri_tpu_torch.utils.profiling.counters()``, counted
only while the slice's profiler records: each fetch, each ``spec_decode``
round flag, each step-loop poll, each wait for a DB map) over the traced
calls. Nothing where no call was traced or the program has no counter."""


def read(rec):
    if not rec["traced"]:
        return None
    try:
        from kiri_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    waits = counters().get("host_waits")
    return None if waits is None else waits / len(rec["traced"])
