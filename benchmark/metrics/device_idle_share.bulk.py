"""Percent of the traced window (whole batches) in which no operation ran
on the card: 1 minus the union of the profiler's device intervals."""


def read(run):
    tr = run["record"].get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
