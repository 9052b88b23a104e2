"""Mean milliseconds of ``BatchVerifier.verify``'s ``pad_and_pack`` stage
(screening, Fiat-Shamir challenges on the host core, RLC draws) a batch."""


def read(run):
    spans = run["record"].get("spans", {}).get("pad_and_pack")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
