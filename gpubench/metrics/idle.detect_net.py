"""The device's idle, in % of the traced slice, under ``detect.forward``:
the canvases' stacking and copy to the card and the launches of DB's
forward. Nothing where no slice was traced or the program has no spans."""
from harness.spans import idle_share


def read(rec):
    return idle_share(rec, names=("detect.forward",))
