# -*- coding: utf-8 -*-
# Generated protocol buffer code for proto/auth.proto.
#
# The serialized descriptor below must stay byte-identical to the one in
# cpzk_tpu/_gen/auth_pb2.py: both register the file "auth.proto" in the
# process-wide default descriptor pool, which accepts a second identical
# copy and raises "duplicate file name auth.proto" on any difference.
# protoc 3.21.12 run on proto/auth.proto emits the same messages with
# RegistrationResult last (tests/test_torch_two_packages.py holds the
# two equal after sorting the messages by name), so this module keeps the
# reference's bytes.  The gRPC plumbing is hand-wired from grpcio's generic
# handlers (cpzk_tpu_torch/server/service.py): no *_pb2_grpc module.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nauth.proto\x12\x04auth">\n\x13RegistrationRequest\x12\x0f\n\x07user_id\x18\x01 \x01(\t\x12\n\n\x02y1\x18\x02 \x01(\x0c\x12\n\n\x02y2\x18\x03 \x01(\x0c"8\n\x14RegistrationResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t"#\n\x10ChallengeRequest\x12\x0f\n\x07user_id\x18\x01 \x01(\t"=\n\x11ChallengeResponse\x12\x14\n\x0cchallenge_id\x18\x01 \x01(\x0c\x12\x12\n\nexpires_at\x18\x02 \x01(\x03"K\n\x13VerificationRequest\x12\x0f\n\x07user_id\x18\x01 \x01(\t\x12\x14\n\x0cchallenge_id\x18\x02 \x01(\x0c\x12\r\n\x05proof\x18\x03 \x01(\x0c"f\n\x14VerificationResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x1a\n\rsession_token\x18\x03 \x01(\tH\x00\x88\x01\x01B\x10\n\x0e_session_token"S\n\x18BatchVerificationRequest\x12\x10\n\x08user_ids\x18\x01 \x03(\t\x12\x15\n\rchallenge_ids\x18\x02 \x03(\x0c\x12\x0e\n\x06proofs\x18\x03 \x03(\x0c"F\n\x19BatchVerificationResponse\x12)\n\x07results\x18\x01 \x03(\x0b2\x18.auth.VerificationResult"d\n\x12VerificationResult\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x1a\n\rsession_token\x18\x03 \x01(\tH\x00\x88\x01\x01B\x10\n\x0e_session_token"R\n\x18BatchRegistrationRequest\x12\x10\n\x08user_ids\x18\x01 \x03(\t\x12\x11\n\ty1_values\x18\x02 \x03(\x0c\x12\x11\n\ty2_values\x18\x03 \x03(\x0c"F\n\x19BatchRegistrationResponse\x12)\n\x07results\x18\x01 \x03(\x0b2\x18.auth.RegistrationResult"6\n\x12RegistrationResult\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t"r\n\x13StreamVerifyRequest\x12\x0b\n\x03ids\x18\x01 \x03(\x04\x12\x10\n\x08user_ids\x18\x02 \x03(\t\x12\x15\n\rchallenge_ids\x18\x03 \x03(\x0c\x12\x0e\n\x06proofs\x18\x04 \x03(\x0c\x12\x15\n\rmint_sessions\x18\x05 \x01(\x08"v\n\x14StreamVerifyResponse\x12\x0b\n\x03ids\x18\x01 \x03(\x04\x12\x0f\n\x07success\x18\x02 \x03(\x08\x12\x10\n\x08messages\x18\x03 \x03(\t\x12\x16\n\x0esession_tokens\x18\x04 \x03(\t\x12\x16\n\x0eretry_after_ms\x18\x05 \x01(\r2\xd1\x03\n\x0bAuthService\x12A\n\x08Register\x12\x19.auth.RegistrationRequest\x1a\x1a.auth.RegistrationResponse\x12P\n\rRegisterBatch\x12\x1e.auth.BatchRegistrationRequest\x1a\x1f.auth.BatchRegistrationResponse\x12B\n\x0fCreateChallenge\x12\x16.auth.ChallengeRequest\x1a\x17.auth.ChallengeResponse\x12D\n\x0bVerifyProof\x12\x19.auth.VerificationRequest\x1a\x1a.auth.VerificationResponse\x12S\n\x10VerifyProofBatch\x12\x1e.auth.BatchVerificationRequest\x1a\x1f.auth.BatchVerificationResponse\x12N\n\x11VerifyProofStream\x12\x19.auth.StreamVerifyRequest\x1a\x1a.auth.StreamVerifyResponse(\x010\x01b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cpzk_tpu_torch._gen.auth_pb2', globals())
