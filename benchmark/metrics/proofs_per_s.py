"""Proofs verified in the window's whole batches over the time from the
window's start to the end of its last batch."""


def read(run):
    rec = run["record"]
    if "rows_done" not in rec or rec["window_s"] <= 0:
        return None
    return rec["rows_done"] / rec["window_s"]
