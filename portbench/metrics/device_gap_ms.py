"""Mean device idle before a batch, between the previous batch's landing
event and an event recorded before this batch's first enqueue (0 for a
batch queued behind the previous one), over every gap that ended in the
window (engine.device_gap spans; none after an idle wait for work)."""


def read(r):
    gaps = [(e - s) * 1e3 for n, s, e in r.spans
            if n == "engine.device_gap" and r.t0 <= e <= r.t1]
    return sum(gaps) / len(gaps) if gaps else None
