/* Batched word-level Levenshtein distance — host-side WER kernel.
 *
 * The reference computes WER through HF `evaluate`/jiwer on Python lists
 * inside the hot loop (reference: src/core/loss_helpers.py:25-32). Here
 * WER runs on the host over integer word-id sequences produced by the
 * on-device greedy decode; this C kernel makes the host side O(batch)
 * cheap so scoring never stalls the TPU feed.
 *
 * Interface (ctypes, see paa_tpu_torch/ops/wer.py):
 *   batched_edit_distance(
 *       const int32_t* a,    flattened hypothesis word ids
 *       const int64_t* a_off n+1 offsets into `a`
 *       const int32_t* b,    flattened reference word ids
 *       const int64_t* b_off n+1 offsets into `b`
 *       int64_t n,           number of pairs
 *       int64_t* out)        per-pair distances
 *
 * Uses the classic two-row DP; memory bounded by the longest reference.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static int64_t min3(int64_t a, int64_t b, int64_t c) {
    int64_t m = a < b ? a : b;
    return m < c ? m : c;
}

static int64_t edit_distance(const int32_t* a, int64_t na,
                             const int32_t* b, int64_t nb,
                             int64_t* buf /* 2*(nb+1) */) {
    if (na == 0) return nb;
    if (nb == 0) return na;
    int64_t* prev = buf;
    int64_t* curr = buf + (nb + 1);
    for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
    for (int64_t i = 1; i <= na; ++i) {
        curr[0] = i;
        int32_t ai = a[i - 1];
        for (int64_t j = 1; j <= nb; ++j) {
            int64_t sub = prev[j - 1] + (ai != b[j - 1]);
            curr[j] = min3(sub, prev[j] + 1, curr[j - 1] + 1);
        }
        int64_t* tmp = prev; prev = curr; curr = tmp;
    }
    return prev[nb];
}

void batched_edit_distance(const int32_t* a, const int64_t* a_off,
                           const int32_t* b, const int64_t* b_off,
                           int64_t n, int64_t* out) {
    /* find max reference length for one shared scratch buffer */
    int64_t max_nb = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t nb = b_off[i + 1] - b_off[i];
        if (nb > max_nb) max_nb = nb;
    }
    int64_t* buf = (int64_t*)malloc(sizeof(int64_t) * 2 * (max_nb + 1));
    if (!buf) { for (int64_t i = 0; i < n; ++i) out[i] = -1; return; }
    for (int64_t i = 0; i < n; ++i) {
        out[i] = edit_distance(a + a_off[i], a_off[i + 1] - a_off[i],
                               b + b_off[i], b_off[i + 1] - b_off[i], buf);
    }
    free(buf);
}
