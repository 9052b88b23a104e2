"""Mean milliseconds a batch spends parsing its wires (the benchmark's span
around ``Proof.from_bytes_batch`` and the statements'
``Ristretto255.element_from_bytes``)."""


def read(run):
    spans = run["record"].get("spans", {}).get("parse")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
