"""Mean server-side ``VerifyProofBatch`` milliseconds over the window: the
deltas of the daemon's ``rpc.duration{rpc}`` sum and count."""


def read(run):
    total, count = run["record"].get("rpc", {}).get("VerifyProofBatch", (0.0, 0.0))
    return 1e3 * total / count if count else None
