"""The whole step's share of the chip's bf16 peak, in %: the model FLOP
the untraced calls' inputs need (``flops/recognizer.py`` and the
configuration's detector, ``flops/detectors/<method>.py``; DB runs in
float32 but is held to the same bf16 peak) over the calls' wall seconds x
989e12 (host clock)."""
from flops import PEAK_BF16


def read(rec):
    calls = rec["untraced"]
    wall = sum(c["t1"] - c["t0"] for c in calls)
    if not calls or wall <= 0:
        return None
    return 100.0 * sum(c["flops"] for c in calls) / (wall * PEAK_BF16)
