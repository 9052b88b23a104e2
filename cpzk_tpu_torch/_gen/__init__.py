"""Protobuf message modules for ``proto/auth.proto``,
``proto/health.proto`` and ``proto/replication.proto``, committed and
imported by their package-qualified names
(``cpzk_tpu_torch._gen.auth_pb2``): nothing here is generated or put on
``sys.path`` at run time."""
