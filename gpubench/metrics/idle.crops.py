"""The device's idle, in % of the traced slice, under the pipeline's
``preprocess`` stage with no finer span open: cutting each page's crops
and preprocessing them on the host. Nothing where no slice was traced or
the program has no spans."""
from harness.spans import idle_share


def read(rec):
    return idle_share(rec, names=("preprocess",))
