"""The share, in %, of the decoder's step-loop steps that the traced calls
replayed in a CUDA graph: the program's counters ``decode.graph_steps``
over ``decode.graph_steps`` + ``decode.eager_steps``
(``kiri_tpu_torch.utils.profiling.counters()``, counted only while the
slice's profiler records). Nothing where no call was traced, no step loop
ran, or the program has no such counters."""


def read(rec):
    if not rec["traced"]:
        return None
    try:
        from kiri_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    graph = c.get("decode.graph_steps", 0)
    steps = graph + c.get("decode.eager_steps", 0)
    return 100.0 * graph / steps if steps else None
