// Host crypto core: Keccak-f[1600] + STROBE-128 + Merlin transcript framing.
//
// Byte-identical twin of the Python implementation in
// cpzk_tpu_torch/core/{keccak,strobe,transcript}.py, which itself mirrors the
// merlin 3.0.0 crate used by the reference (src/primitives/transcript.rs). The batch entry point derives Fiat-Shamir challenges for
// whole proof batches on a thread pool — the host hot loop of batch
// verification (reference analog: src/verifier/batch.rs:239-260).
//
// C ABI only; bound from Python via ctypes (cpzk_tpu_torch/core/_native.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

constexpr int kStrobeR = 166;

constexpr uint64_t kRoundConstants[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

constexpr int kRho[25] = {
    0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43,
    25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14,
};

inline uint64_t rotl64(uint64_t v, int n) {
  n &= 63;
  return n == 0 ? v : (v << n) | (v >> (64 - n));
}

void keccak_f1600(uint64_t a[25]) {
  uint64_t b[25], c[5], d[5];
  for (uint64_t rc : kRoundConstants) {
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d[x];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], kRho[x + 5 * y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= rc;
  }
}

struct Strobe128 {
  uint8_t state[200];
  uint8_t pos = 0;
  uint8_t pos_begin = 0;
  uint8_t cur_flags = 0;

  static constexpr uint8_t FLAG_I = 0x01, FLAG_A = 0x02, FLAG_C = 0x04,
                           FLAG_M = 0x10, FLAG_K = 0x20;

  explicit Strobe128(const uint8_t* label, size_t label_len) {
    std::memset(state, 0, sizeof(state));
    const uint8_t init[6] = {1, kStrobeR + 2, 1, 0, 1, 12 * 8};
    std::memcpy(state, init, 6);
    std::memcpy(state + 6, "STROBEv1.0.2", 12);
    permute();
    meta_ad(label, label_len, false);
  }

  void permute() {
    uint64_t lanes[25];
    for (int i = 0; i < 25; i++) {
      uint64_t v = 0;
      for (int j = 7; j >= 0; j--) v = (v << 8) | state[8 * i + j];
      lanes[i] = v;
    }
    keccak_f1600(lanes);
    for (int i = 0; i < 25; i++)
      for (int j = 0; j < 8; j++) state[8 * i + j] = (lanes[i] >> (8 * j)) & 0xFF;
  }

  void run_f() {
    state[pos] ^= pos_begin;
    state[pos + 1] ^= 0x04;
    state[kStrobeR + 1] ^= 0x80;
    permute();
    pos = 0;
    pos_begin = 0;
  }

  void absorb(const uint8_t* data, size_t n) {
    for (size_t i = 0; i < n; i++) {
      state[pos] ^= data[i];
      if (++pos == kStrobeR) run_f();
    }
  }

  void squeeze(uint8_t* out, size_t n) {
    for (size_t i = 0; i < n; i++) {
      out[i] = state[pos];
      state[pos] = 0;
      if (++pos == kStrobeR) run_f();
    }
  }

  void begin_op(uint8_t flags, bool more) {
    if (more) return;  // flag mismatch is a programming error; callers fixed
    uint8_t old_begin = pos_begin;
    pos_begin = pos + 1;
    cur_flags = flags;
    const uint8_t hdr[2] = {old_begin, flags};
    absorb(hdr, 2);
    if ((flags & (FLAG_C | FLAG_K)) != 0 && pos != 0) run_f();
  }

  void meta_ad(const uint8_t* data, size_t n, bool more) {
    begin_op(FLAG_M | FLAG_A, more);
    absorb(data, n);
  }
  void ad(const uint8_t* data, size_t n, bool more) {
    begin_op(FLAG_A, more);
    absorb(data, n);
  }
  void prf(uint8_t* out, size_t n) {
    begin_op(FLAG_I | FLAG_A | FLAG_C, false);
    squeeze(out, n);
  }
};

struct MerlinTranscript {
  Strobe128 strobe;

  explicit MerlinTranscript(const uint8_t* label, size_t label_len)
      : strobe(reinterpret_cast<const uint8_t*>("Merlin v1.0"), 11) {
    append_message(reinterpret_cast<const uint8_t*>("dom-sep"), 7, label, label_len);
  }

  void append_message(const uint8_t* label, size_t label_len,
                      const uint8_t* msg, size_t msg_len) {
    uint8_t len_le[4] = {
        static_cast<uint8_t>(msg_len & 0xFF),
        static_cast<uint8_t>((msg_len >> 8) & 0xFF),
        static_cast<uint8_t>((msg_len >> 16) & 0xFF),
        static_cast<uint8_t>((msg_len >> 24) & 0xFF),
    };
    strobe.meta_ad(label, label_len, false);
    strobe.meta_ad(len_le, 4, true);
    strobe.ad(msg, msg_len, false);
  }

  void challenge_bytes(const uint8_t* label, size_t label_len,
                       uint8_t* out, size_t n) {
    uint8_t len_le[4] = {
        static_cast<uint8_t>(n & 0xFF),
        static_cast<uint8_t>((n >> 8) & 0xFF),
        static_cast<uint8_t>((n >> 16) & 0xFF),
        static_cast<uint8_t>((n >> 24) & 0xFF),
    };
    strobe.meta_ad(label, label_len, false);
    strobe.meta_ad(len_le, 4, true);
    strobe.prf(out, n);
  }
};

constexpr char kProtocolLabel[] = "Chaum-Pedersen ZKP v1.0.0";
constexpr char kProtocolDst[] = "chaum-pedersen-ristretto255";

// One full Chaum-Pedersen challenge derivation
// (reference transcript sequence, src/primitives/transcript.rs:29-71).
void derive_one(const uint8_t* ctx, size_t ctx_len, bool has_ctx,
                const uint8_t* g, const uint8_t* h, const uint8_t* y1,
                const uint8_t* y2, const uint8_t* r1, const uint8_t* r2,
                uint8_t out[64]) {
  auto B = [](const char* s) { return reinterpret_cast<const uint8_t*>(s); };
  MerlinTranscript t(B(kProtocolLabel), sizeof(kProtocolLabel) - 1);
  t.append_message(B("protocol"), 8, B(kProtocolDst), sizeof(kProtocolDst) - 1);
  if (has_ctx) t.append_message(B("context"), 7, ctx, ctx_len);
  t.append_message(B("generator-g"), 11, g, 32);
  t.append_message(B("generator-h"), 11, h, 32);
  t.append_message(B("y1"), 2, y1, 32);
  t.append_message(B("y2"), 2, y2, 32);
  t.append_message(B("r1"), 2, r1, 32);
  t.append_message(B("r2"), 2, r2, 32);
  t.challenge_bytes(B("challenge"), 9, out, 64);
}

}  // namespace

extern "C" {

// --- incremental transcript API (ctypes handles) ---

void* cpzk_transcript_new(const uint8_t* protocol_label, size_t label_len) {
  return new MerlinTranscript(protocol_label, label_len);
}

void cpzk_transcript_free(void* t) {
  delete static_cast<MerlinTranscript*>(t);
}

void cpzk_transcript_append(void* t, const uint8_t* label, size_t label_len,
                            const uint8_t* msg, size_t msg_len) {
  static_cast<MerlinTranscript*>(t)->append_message(label, label_len, msg, msg_len);
}

void cpzk_transcript_challenge(void* t, const uint8_t* label, size_t label_len,
                               uint8_t* out, size_t n) {
  static_cast<MerlinTranscript*>(t)->challenge_bytes(label, label_len, out, n);
}

// --- batched Chaum-Pedersen challenge derivation (thread pool) ---
//
// ctxs: concatenated context bytes with ctx_offsets[n+1] prefix offsets;
// ctx_offsets == nullptr means "no context" for every row.  Point args are
// [n*32] contiguous compressed encodings; out is [n*64].
void cpzk_challenge_batch(size_t n, const uint8_t* ctxs,
                          const uint32_t* ctx_offsets, const uint8_t* has_ctx,
                          const uint8_t* gs, const uint8_t* hs,
                          const uint8_t* y1s, const uint8_t* y2s,
                          const uint8_t* r1s, const uint8_t* r2s,
                          uint8_t* out, int threads) {
  if (threads <= 0) {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 1;
  }
  if (static_cast<size_t>(threads) > n) threads = static_cast<int>(n ? n : 1);

  auto worker = [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; i++) {
      const uint8_t* ctx = nullptr;
      size_t ctx_len = 0;
      bool hc = false;
      if (ctx_offsets != nullptr && has_ctx != nullptr && has_ctx[i]) {
        ctx = ctxs + ctx_offsets[i];
        ctx_len = ctx_offsets[i + 1] - ctx_offsets[i];
        hc = true;
      }
      derive_one(ctx, ctx_len, hc, gs + 32 * i, hs + 32 * i, y1s + 32 * i,
                 y2s + 32 * i, r1s + 32 * i, r2s + 32 * i, out + 64 * i);
    }
  };

  if (threads == 1) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> pool;
  size_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; t++) {
    size_t lo = t * chunk;
    size_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back(worker, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
