"""Mean milliseconds an entry waited in the dynamic batcher's queue over the
window: the deltas of the daemon's ``tpu.batch.queue_wait`` sum and count."""


def read(run):
    total, count = run["record"].get("queue_wait", (0.0, 0.0))
    return 1e3 * total / count if count else None
