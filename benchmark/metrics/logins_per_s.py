"""Logins due in the window that were answered with the right verdict, over
the window's seconds."""


def read(run):
    rec = run["record"]
    if "logins_right" not in rec:
        return None
    return rec["logins_right"] / rec["window_s"]
