"""The device's idle, in % of the traced slice, under every ``decode.*``
span: ``decode.spec`` and its ``decode.round`` passes (each with the
host's look at the active flag), and ``decode.step_loop`` (the step loop of
the rows ``spec_decode`` left unfinished). Nothing where no slice was
traced or the program has no spans."""
from harness.spans import idle_share


def read(rec):
    return idle_share(rec, prefixes=("decode.",))
