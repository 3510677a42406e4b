"""The device's idle, in % of the traced slice, under every ``engine.*``
and ``decode.*`` span: the recognizer's share of a page call's idle.
Nothing where no slice was traced or the program has no spans."""
from harness.spans import idle_share


def read(rec):
    return idle_share(rec, prefixes=("engine.", "decode."))
