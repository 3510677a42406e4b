"""The share of lines, in %, that ``spec_decode`` left unfinished and the
engine decoded again in its step loop (``RecognizerEngine.fallback_rows``
over the lines of the untraced calls)."""


def read(rec):
    calls = rec["untraced"]
    n = sum(c["items"] for c in calls)
    return 100.0 * sum(c["fallback"] for c in calls) / n if n else None
