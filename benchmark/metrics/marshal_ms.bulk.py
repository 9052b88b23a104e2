"""Mean milliseconds the backend reports marshalling a batch
(``flightrec.note_marshal`` into the benchmark's ``DeviceSink``)."""


def read(run):
    vals = [b["marshal_s"] for b in run["record"].get("batches", ()) if b.get("marshal_s") is not None]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
