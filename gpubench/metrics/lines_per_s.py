"""lines/s: every line recognized in the window over the time from the
first call's start to the last call's end (host clock)."""


def read(rec):
    calls = rec["calls"]
    return sum(c["items"] for c in calls) / (calls[-1]["t1"] - calls[0]["t0"])
