"""The device's idle, in % of the traced slice, under the engine's host
spans: ``engine.group`` (width bucketing and chunking), ``engine.upload``
(padding, pageable copies to the card), ``engine.fetch`` (the wait for the
card and the copy back) and ``engine.texts`` (token ids to text, row by
row). Nothing where no slice was traced or the program has no spans."""
from harness.spans import idle_share


def read(rec):
    return idle_share(rec, names=("engine.group", "engine.upload",
                                  "engine.fetch", "engine.texts"))
