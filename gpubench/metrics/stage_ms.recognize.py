"""The mean ms a page spends in the pipeline's ``recognize`` stage
(``OCR.last_timer.totals["recognize"]`` after each untraced call; host
clock)."""


def read(rec):
    v = [c["stages"]["recognize"] for c in rec["untraced"]
         if "recognize" in c.get("stages", {})]
    return 1e3 * sum(v) / len(v) if v else None
