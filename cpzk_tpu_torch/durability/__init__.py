"""The port's durability package, so far the two pieces the daemon needs.

- :mod:`.recovery` — ``quarantine_file``, which moves an unreadable
  snapshot aside so the daemon boots empty instead of crash-looping;
- :mod:`.wal` — the ``length u32 | crc32 u32 | payload`` frame header
  that the ingest shards' unix-socket seam speaks.

The write-ahead log, crash recovery and ``DurabilityManager`` of
``cpzk_tpu/durability`` are not ported yet; ``[durability] enabled`` stops
the daemon at boot.
"""
