"""The bf16 stem's share of its roofline, in %: the least time of the
traced calls' stems (``flops/stem.py``: their real rows at their width
buckets) over the device time of ``stem_conv01_kernel`` and
``stem_layer_kernel`` in the trace. Nothing where the trace has neither."""
KERNELS = ("stem_conv01_kernel", "stem_layer_kernel")


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    spent = sum(s for name, s in tr["kernels"].items()
                if any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    return 100.0 * sum(c["stem_least_s"] for c in rec["traced"]) / spent
