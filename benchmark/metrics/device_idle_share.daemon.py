"""Percent of the window in which the card ran no batch: 1 minus the sum of
the window's flight records' ``device_interval_s`` (CUDA events from a
batch's first launch to its last's end) over the window.  A lower bound on
idle: the intervals include the card's waits between a batch's launches."""


def read(run):
    rec = run["record"]
    recs = rec.get("flight_records")
    if not recs:
        return None
    busy = sum(r["device_interval_s"] for r in recs)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / rec["flight_window_s"])
