// Threaded-workload driver for sanitizer runs.  core/_native.py's
// build_sanitizer_driver() links it with the host core's own SOURCES under
// -fsanitize=thread or -fsanitize=address,undefined; a clean exit with no
// sanitizer report is the gate (tests/test_torch_sanitizers.py).
//
// Exercises every concurrent path in the native core:
//   1. cpzk_verify_rows      — work-stealing pthread row pool
//   2. cpzk_challenge_batch  — threaded Merlin challenge derivation
//   3. cpzk_double_basemul   — comb-table rwlock under generator churn
//
// Inputs are synthetic: the ristretto basepoint encoding for points and
// small scalars.  Correctness of the outputs is asserted loosely (the
// differential tests own exactness); the sanitizer owns the memory model.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <pthread.h>

extern "C" {
int cpzk_verify_rows(size_t n, const uint8_t *g, const uint8_t *h,
                     const uint8_t *y1, const uint8_t *y2,
                     const uint8_t *r1, const uint8_t *r2,
                     const uint8_t *s, const uint8_t *c,
                     uint8_t *out, int n_threads);
void cpzk_challenge_batch(size_t n, const uint8_t *ctx_blob,
                          const uint32_t *ctx_offsets, const uint8_t *has_ctx,
                          const uint8_t *gs, const uint8_t *hs,
                          const uint8_t *y1s, const uint8_t *y2s,
                          const uint8_t *r1s, const uint8_t *r2s,
                          uint8_t *out, int n_threads);
int cpzk_basemul_init(const uint8_t *g_wire, const uint8_t *h_wire);
int cpzk_double_basemul(const uint8_t *g_wire, const uint8_t *h_wire,
                        const uint8_t *scalar, uint8_t *out1, uint8_t *out2);
int cpzk_scalarmul(const uint8_t *point, const uint8_t *scalar, uint8_t *out);
}

// ristretto255 basepoint, canonical encoding
static const uint8_t BP[32] = {
    0xe2, 0xf2, 0xae, 0x0a, 0x6a, 0xbc, 0x4e, 0x71, 0xa8, 0x84, 0xa9, 0x61,
    0xc5, 0x00, 0x51, 0x5f, 0x58, 0xe3, 0x0b, 0x6a, 0xa5, 0x82, 0xdd, 0x8d,
    0xb6, 0xa6, 0x59, 0x45, 0xe0, 0x8d, 0x2d, 0x76};

struct churn_arg {
    const uint8_t *g2;
    const uint8_t *h2;
    int which;
    int ok;
};

static void *churn_worker(void *p) {
    churn_arg *a = (churn_arg *)p;
    uint8_t s[32] = {0}, o1[32], o2[32];
    a->ok = 1;
    for (int i = 0; i < 40; i++) {
        s[0] = (uint8_t)(i + 1);
        s[1] = (uint8_t)a->which;
        const uint8_t *g = (i + a->which) % 2 ? a->g2 : BP;
        const uint8_t *h = (i + a->which) % 2 ? a->h2 : a->g2;
        // 0 is a legal transient result under churn (pair swapped between
        // build and read) — the Python caller falls back; no race either way
        cpzk_double_basemul(g, h, s, o1, o2);
    }
    return nullptr;
}

int main() {
    const size_t n = 64;
    uint8_t cols[6][64 * 32];
    for (int c = 0; c < 6; c++)
        for (size_t i = 0; i < n; i++) memcpy(cols[c] + 32 * i, BP, 32);
    uint8_t scal[64 * 32];
    memset(scal, 0, sizeof scal);
    for (size_t i = 0; i < n; i++) scal[32 * i] = (uint8_t)(i + 1);

    // 1. row pool (4 workers racing the shared cursor)
    uint8_t out[64];
    cpzk_verify_rows(n, BP, BP, cols[0], cols[1], cols[2], cols[3],
                     scal, scal, out, 4);

    // 2. threaded challenge derivation
    uint32_t offs[65];
    for (size_t i = 0; i <= n; i++) offs[i] = (uint32_t)i;  // 1-byte contexts
    uint8_t ctx[64], has[64], ch[64 * 64];
    memset(ctx, 0x5a, sizeof ctx);
    memset(has, 1, sizeof has);
    cpzk_challenge_batch(n, ctx, offs, has, cols[0], cols[1], cols[2],
                         cols[3], cols[4], cols[5], ch, 4);

    // 3. comb rwlock churn: two generator pairs, 4 threads
    uint8_t g2[32], h2[32], two[32] = {2}, three[32] = {3};
    if (!cpzk_scalarmul(BP, two, g2) || !cpzk_scalarmul(BP, three, h2)) {
        fprintf(stderr, "setup scalarmul failed\n");
        return 1;
    }
    pthread_t tids[4];
    churn_arg args[4];
    for (int t = 0; t < 4; t++) {
        args[t] = {g2, h2, t, 0};
        pthread_create(&tids[t], nullptr, churn_worker, &args[t]);
    }
    for (int t = 0; t < 4; t++) pthread_join(tids[t], nullptr);

    printf("tsan driver done: rows[0]=%d ch[0]=%02x\n", out[0], ch[0]);
    return 0;
}
