"""The device's idle, in % of the traced slice, under the detector's host
spans: ``detect.resize`` (gray, invert, canvas resize), ``detect.wait``
(the map's arrival), ``detect.boxes`` (threshold, components, min boxes,
unclip) and ``detect.layout`` (padding, reading order, column split).
Nothing where no slice was traced or the program has no spans."""
from harness.spans import idle_share


def read(rec):
    return idle_share(rec, names=("detect.resize", "detect.wait",
                                  "detect.boxes", "detect.layout"))
