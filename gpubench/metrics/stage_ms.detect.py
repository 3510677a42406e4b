"""The mean ms a page spends in the pipeline's ``detect`` stage
(``OCR.last_timer.totals["detect"]`` after each untraced call; host
clock)."""


def read(rec):
    v = [c["stages"]["detect"] for c in rec["untraced"]
         if "detect" in c.get("stages", {})]
    return 1e3 * sum(v) / len(v) if v else None
