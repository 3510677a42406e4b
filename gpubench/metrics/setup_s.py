"""Seconds from the process's start to the first timed call: imports, the
card, the kernels' load (and build, in a fresh checkout), the checkpoints,
the traffic, the warm-up."""


def read(rec):
    return rec["setup_s"]
