# -*- coding: utf-8 -*-
# Generated protocol buffer code for replication.proto (built from the
# FileDescriptorProto because protoc is unavailable in this environment;
# see cpzk_tpu/server/proto.py — regenerate with protoc when present).
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x11replication.proto\x12\x0breplication"\xcd\x01\n\x12ShipSegmentRequest\x12\r\n\x05epoch\x18\x01 \x01(\x04\x12\x15\n\rsegment_index\x18\x02 \x01(\x04\x12\x11\n\tfirst_seq\x18\x03 \x01(\x04\x12\x10\n\x08last_seq\x18\x04 \x01(\x04\x12\x0e\n\x06frames\x18\x05 \x01(\x0c\x12\r\n\x05crc32\x18\x06 \x01(\x07\x12\x0e\n\x06sealed\x18\x07 \x01(\x08\x12\x13\n\x0bprimary_seq\x18\x08 \x01(\x04\x12\x14\n\x0csent_unix_ms\x18\t \x01(\x04\x12\x12\n\x04kind\x18\n \x01(\tR\x04kind"\\\n\x13ShipSegmentResponse\x12\x10\n\x08accepted\x18\x01 \x01(\x08\x12\x13\n\x0bapplied_seq\x18\x02 \x01(\x04\x12\r\n\x05epoch\x18\x03 \x01(\x04\x12\x0f\n\x07message\x18\x04 \x01(\t"S\n\x18ReplicationStatusRequest\x12\r\n\x05epoch\x18\x01 \x01(\x04\x12\x13\n\x0brenew_lease\x18\x02 \x01(\x08\x12\x13\n\x0bprimary_seq\x18\x03 \x01(\x04"\x98\x01\n\x19ReplicationStatusResponse\x12\x0c\n\x04role\x18\x01 \x01(\t\x12\r\n\x05epoch\x18\x02 \x01(\x04\x12\x13\n\x0bapplied_seq\x18\x03 \x01(\x04\x12\x13\n\x0blag_records\x18\x04 \x01(\x04\x12\x19\n\x11lease_remaining_s\x18\x05 \x01(\x01\x12\x19\n\x11segments_received\x18\x06 \x01(\x04"R\n\x0fHandoverRequest\x12\r\n\x05phase\x18\x01 \x01(\t\x12\r\n\x05epoch\x18\x02 \x01(\x04\x12\x11\n\tfence_seq\x18\x03 \x01(\x04\x12\x0e\n\x06reason\x18\x04 \x01(\t"\x88\x01\n\x10HandoverResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0c\n\x04role\x18\x02 \x01(\t\x12\r\n\x05epoch\x18\x03 \x01(\x04\x12\x13\n\x0bapplied_seq\x18\x04 \x01(\x04\x12\x0f\n\x07message\x18\x05 \x01(\t\x12\x11\n\tfence_seq\x18\x06 \x01(\x04\x12\x12\n\nduration_s\x18\x07 \x01(\x012\x93\x02\n\x12ReplicationService\x12P\n\x0bShipSegment\x12\x1f.replication.ShipSegmentRequest\x1a .replication.ShipSegmentResponse\x12b\n\x11ReplicationStatus\x12%.replication.ReplicationStatusRequest\x1a&.replication.ReplicationStatusResponse\x12G\n\x08Handover\x12\x1c.replication.HandoverRequest\x1a\x1d.replication.HandoverResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cpzk_tpu_torch._gen.replication_pb2', globals())
