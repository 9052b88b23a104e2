"""Entries per device batch over every batch the daemon's flight recorder
kept in the window."""


def read(run):
    recs = run["record"].get("flight_records")
    if not recs:
        return None
    return sum(r["batch"] for r in recs) / len(recs)
