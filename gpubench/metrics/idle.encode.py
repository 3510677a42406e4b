"""The device's idle, in % of the traced slice, while the engine's
``engine.encode`` span was the innermost host range open: the launches of
the stem, the encoder layers, the CTC head, ``greedy_ctc_stats`` and
``mem_project`` (device trace, gaps put to ranges by ``harness.trace``).
Nothing where no slice was traced or the program has no spans."""
from harness.spans import idle_share


def read(rec):
    return idle_share(rec, names=("engine.encode",))
