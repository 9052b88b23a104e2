"""The drivers of the benchmark's entries, one module an entry."""
