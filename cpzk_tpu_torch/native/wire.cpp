// Native protobuf wire scanner for the three hot request messages
// (cpzk_tpu_torch/server/wire.py is the Python owner of this seam).  A copy
// of cpzk_tpu/native/wire.cpp, built into the port's host core library.
//
// This is NOT a general protobuf decoder.  It recognizes exactly the
// field layouts of auth.ChallengeRequest, auth.BatchVerificationRequest
// and auth.StreamVerifyRequest, and it reports "punt" (return 0) for
// ANYTHING it is not bit-for-bit sure the Python protobuf runtime would
// decode the same way: unknown field numbers, unexpected wire types,
// truncated varints, over-long varints, lengths past the buffer, and
// invalid UTF-8 in string fields.  On punt the Python caller re-parses
// with the real protobuf runtime, so accept/reject semantics and field
// values are definitionally identical — tests/test_torch_wire.py holds
// the accepted-path equivalence against the protobuf runtime.
//
// Two-pass protocol (per message):
//   cpzk_wire_scan(kind, buf, len, counts[4])  -> 1 ok / 0 punt
//   cpzk_wire_fill(kind, buf, len, offs0, lens0, offs1, lens1,
//                  offs2, lens2, vals, flags)
// Length-delimited occurrences of the known fields land in up to three
// per-field BUCKETS of (offset, length) rows in document order (repeated
// append order; a singular string field simply takes the last row):
//
//   kind 1 ChallengeRequest:        bucket 0 = user_id (field 1)
//   kind 2 BatchVerificationRequest: 0 = user_ids (1), 1 = challenge_ids
//                                    (2), 2 = proofs (3)
//   kind 3 StreamVerifyRequest:      0 = user_ids (2), 1 = challenge_ids
//                                    (3), 2 = proofs (4); the uint64 ids
//                                    (field 1, packed or not) decode into
//                                    vals, and flags[0] carries the final
//                                    mint_sessions bool (field 5)
//
// counts[0..2] are the bucket sizes, counts[3] the vals count.  The fill
// pass re-runs the same walk, so its verdict can never diverge from the
// scan's.
//
// cpzk_wire_gather concatenates (offset, length) ranges into a caller
// buffer — the zero-copy hop from socket bytes into the per-thread proof
// staging buffer the parse/marshal stages reuse.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// message kinds (mirrored in cpzk_tpu_torch/core/_native.py)
enum {
    WIRE_CHALLENGE = 1,       // auth.ChallengeRequest
    WIRE_BATCH_VERIFY = 2,    // auth.BatchVerificationRequest
    WIRE_STREAM_CHUNK = 3,    // auth.StreamVerifyRequest
};

// wire types we understand; anything else punts
static const int WT_VARINT = 0;
static const int WT_LEN = 2;

// Strict RFC 3629 UTF-8 validation: rejects overlong encodings,
// surrogates and > U+10FFFF — exactly the byte strings CPython's utf-8
// decoder (and the protobuf runtime's string fields) accept.
static int utf8_valid(const uint8_t *s, size_t len) {
    size_t i = 0;
    while (i < len) {
        uint8_t c = s[i];
        if (c < 0x80) { i += 1; continue; }
        if (c < 0xC2) return 0;  // continuation byte or overlong 2-byte
        if (c < 0xE0) {          // 2-byte
            if (i + 1 >= len || (s[i + 1] & 0xC0) != 0x80) return 0;
            i += 2; continue;
        }
        if (c < 0xF0) {          // 3-byte
            if (i + 2 >= len) return 0;
            uint8_t c1 = s[i + 1], c2 = s[i + 2];
            if ((c1 & 0xC0) != 0x80 || (c2 & 0xC0) != 0x80) return 0;
            if (c == 0xE0 && c1 < 0xA0) return 0;          // overlong
            if (c == 0xED && c1 >= 0xA0) return 0;         // surrogate
            i += 3; continue;
        }
        if (c < 0xF5) {          // 4-byte
            if (i + 3 >= len) return 0;
            uint8_t c1 = s[i + 1], c2 = s[i + 2], c3 = s[i + 3];
            if ((c1 & 0xC0) != 0x80 || (c2 & 0xC0) != 0x80 ||
                (c3 & 0xC0) != 0x80) return 0;
            if (c == 0xF0 && c1 < 0x90) return 0;          // overlong
            if (c == 0xF4 && c1 >= 0x90) return 0;         // > U+10FFFF
            i += 4; continue;
        }
        return 0;
    }
    return 1;
}

// Decode one varint at buf[*pos]; advances *pos.  Returns 1 on success,
// 0 on truncation or a value that does not fit uint64 exactly (a 10th
// byte above 0x01 encodes bits past 2^64 — the runtimes disagree on
// those, so we punt).
static int read_varint(const uint8_t *buf, size_t len, size_t *pos,
                       uint64_t *out) {
    uint64_t v = 0;
    int shift = 0;
    size_t i = *pos;
    for (int k = 0; k < 10; ++k) {
        if (i >= len) return 0;
        uint8_t b = buf[i++];
        if (k == 9 && b > 0x01) return 0;
        v |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) { *pos = i; *out = v; return 1; }
        shift += 7;
    }
    return 0;  // 10 continuation bytes: malformed
}

// (field, wiretype) -> bucket index for one kind; -2 = punt,
// -1 = handled elsewhere (ids / mint varint paths).
static int classify(int kind, uint64_t field, int wt,
                    int *is_string, int *is_ids, int *is_mint) {
    *is_string = 0; *is_ids = 0; *is_mint = 0;
    if (kind == WIRE_CHALLENGE) {
        if (field == 1 && wt == WT_LEN) { *is_string = 1; return 0; }
        return -2;
    }
    if (kind == WIRE_BATCH_VERIFY) {
        if (field == 1 && wt == WT_LEN) { *is_string = 1; return 0; }
        if (field == 2 && wt == WT_LEN) return 1;
        if (field == 3 && wt == WT_LEN) return 2;
        return -2;
    }
    if (kind == WIRE_STREAM_CHUNK) {
        if (field == 1 && (wt == WT_LEN || wt == WT_VARINT)) {
            *is_ids = 1; return -1;
        }
        if (field == 2 && wt == WT_LEN) { *is_string = 1; return 0; }
        if (field == 3 && wt == WT_LEN) return 1;
        if (field == 4 && wt == WT_LEN) return 2;
        if (field == 5 && wt == WT_VARINT) { *is_mint = 1; return -1; }
        return -2;
    }
    return -2;
}

// One scan over a message.  When counting (offs[0] == nullptr) it only
// tallies; when filling it writes the bucket rows/vals.  1 ok / 0 punt.
static int wire_walk(int kind, const uint8_t *buf, size_t len,
                     size_t counts[4],
                     uint64_t *offs[3], uint64_t *lens[3],
                     uint64_t *vals, uint8_t *flags) {
    size_t pos = 0, nb[3] = {0, 0, 0}, nv = 0;
    uint64_t mint = 0;
    int fill = offs != nullptr && offs[0] != nullptr;
    while (pos < len) {
        uint64_t tag;
        if (!read_varint(buf, len, &pos, &tag)) return 0;
        uint64_t field = tag >> 3;
        int wt = (int)(tag & 7);
        if (field == 0 || field > 0x1FFFFFFF) return 0;

        int is_string, is_ids, is_mint;
        int bucket = classify(kind, field, wt, &is_string, &is_ids, &is_mint);
        if (bucket == -2) return 0;

        if (is_mint) {
            uint64_t v;
            if (!read_varint(buf, len, &pos, &v)) return 0;
            mint = v;  // last occurrence wins (proto3 singular)
            continue;
        }
        if (is_ids && wt == WT_VARINT) {
            uint64_t v;
            if (!read_varint(buf, len, &pos, &v)) return 0;
            if (fill) vals[nv] = v;
            nv++;
            continue;
        }
        // length-delimited payload (string / bytes / packed ids)
        uint64_t flen;
        if (!read_varint(buf, len, &pos, &flen)) return 0;
        if (flen > len - pos) return 0;  // truncated payload
        if (is_ids) {  // packed varint block: must consume flen exactly
            size_t end = pos + (size_t)flen;
            while (pos < end) {
                uint64_t v;
                if (!read_varint(buf, end, &pos, &v)) return 0;
                if (fill) vals[nv] = v;
                nv++;
            }
            continue;
        }
        if (is_string && !utf8_valid(buf + pos, (size_t)flen)) return 0;
        if (fill) {
            offs[bucket][nb[bucket]] = (uint64_t)pos;
            lens[bucket][nb[bucket]] = flen;
        }
        nb[bucket]++;
        pos += (size_t)flen;
    }
    if (counts) {
        counts[0] = nb[0]; counts[1] = nb[1]; counts[2] = nb[2];
        counts[3] = nv;
    }
    if (flags) flags[0] = mint ? 1 : 0;
    return 1;
}

// Pass 1: bucket counts.  1 = the message is in this parser's recognized
// subset (counts filled), 0 = punt to the Python protobuf runtime.
int cpzk_wire_scan(int kind, const uint8_t *buf, size_t len,
                   size_t counts[4]) {
    return wire_walk(kind, buf, len, counts, nullptr, nullptr,
                     nullptr, nullptr);
}

// Pass 2: fill the arrays sized by pass 1.  Same walk, same verdict.
int cpzk_wire_fill(int kind, const uint8_t *buf, size_t len,
                   uint64_t *offs0, uint64_t *lens0,
                   uint64_t *offs1, uint64_t *lens1,
                   uint64_t *offs2, uint64_t *lens2,
                   uint64_t *vals, uint8_t *flags) {
    uint64_t *offs[3] = {offs0, offs1, offs2};
    uint64_t *lens[3] = {lens0, lens1, lens2};
    return wire_walk(kind, buf, len, nullptr, offs, lens, vals, flags);
}

// Concatenate n (offset, length) ranges of buf into out (caller sized
// it as the sum of lengths); returns bytes written.  The ranges come
// from cpzk_wire_fill, so they are in-bounds by construction — but the
// bound is re-checked anyway (buf_len) so a confused caller cannot
// make this read out of bounds.
size_t cpzk_wire_gather(const uint8_t *buf, size_t buf_len,
                        const uint64_t *offs, const uint64_t *lens,
                        size_t n, uint8_t *out) {
    size_t w = 0;
    for (size_t i = 0; i < n; ++i) {
        uint64_t off = offs[i], l = lens[i];
        if (off > buf_len || l > buf_len - off) return w;
        memcpy(out + w, buf + off, (size_t)l);
        w += (size_t)l;
    }
    return w;
}

}  // extern "C"
