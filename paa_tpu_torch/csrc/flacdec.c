/* Native FLAC decoder — the same 16-bit-era subset as the pure-numpy
 * reference implementation in paa_tpu_torch/data/flac.py (which remains the
 * fallback and the behavioral oracle; tests assert bit-identical output
 * on every fixture stream).
 *
 * Why native: corpus ingestion decodes thousands of multi-second clips
 * (stock LibriSpeech is FLAC; reference consumes it out of the box,
 * src/training_utils/build.py:118-133). The Python decoder's LPC/Rice
 * inner loops cost ~1 s per 10 s clip — ~10 h for a reference-scale 30k
 * corpus; this kernel does the same work in milliseconds.
 *
 * Subset (identical to flac.py):
 *   - STREAMINFO + skipped metadata blocks
 *   - fixed/variable blocking, all blocksize codes
 *   - CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes
 *   - Rice residuals: 4- and 5-bit params, escape partitions, any order
 *   - wasted bits; 8/12/16/20/24-bit samples
 *   - independent channels + left/side, right/side, mid/side stereo
 * CRCs are parsed but not verified (trusted local corpora). Anything
 * outside the subset returns an error and the caller falls back to the
 * Python decoder for its precise FlacError message.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define FLAC_ERR(code) return (code)
enum {
    FLAC_OK = 0,
    FLAC_E_MARKER = -1,     /* not a fLaC stream */
    FLAC_E_TRUNC = -2,      /* unexpected end of stream */
    FLAC_E_STREAMINFO = -3, /* missing/short STREAMINFO */
    FLAC_E_FORMAT = -4,     /* field outside supported subset */
    FLAC_E_SYNC = -5,       /* lost frame sync */
    FLAC_E_NOMEM = -6,
    FLAC_E_NOFRAMES = -7,
};

typedef struct {
    const uint8_t *data;
    int64_t nbits;
    int64_t pos; /* bit index */
} BitReader;

static int br_read(BitReader *br, int n, uint64_t *out) {
    if (br->pos + n > br->nbits) return FLAC_E_TRUNC;
    uint64_t v = 0;
    int64_t p = br->pos;
    /* byte-at-a-time with head/tail masking */
    int got = 0;
    while (got < n) {
        int64_t byte = p >> 3;
        int off = (int)(p & 7);
        int take = 8 - off;
        if (take > n - got) take = n - got;
        uint8_t b = br->data[byte];
        uint8_t chunk = (uint8_t)((b >> (8 - off - take)) & ((1u << take) - 1u));
        v = (v << take) | chunk;
        got += take;
        p += take;
    }
    br->pos = p;
    *out = v;
    return FLAC_OK;
}

static int br_read_signed(BitReader *br, int n, int64_t *out) {
    uint64_t v;
    int rc = br_read(br, n, &v);
    if (rc) return rc;
    if (n < 64 && (v & (1ull << (n - 1)))) {
        *out = (int64_t)v - (1ll << n);
    } else {
        *out = (int64_t)v;
    }
    return FLAC_OK;
}

static int br_unary(BitReader *br, uint32_t *out) {
    /* count zero bits until (and consuming) the next 1 bit */
    int64_t p = br->pos;
    uint32_t q = 0;
    while (p < br->nbits) {
        int64_t byte = p >> 3;
        int off = (int)(p & 7);
        uint8_t b = (uint8_t)(br->data[byte] << off); /* remaining bits high */
        if (b == 0) {
            q += 8 - off;
            p += 8 - off;
            continue;
        }
        /* index of highest set bit from the top */
        int lead = 0;
        while (!(b & 0x80)) {
            b <<= 1;
            lead++;
        }
        q += lead;
        br->pos = p + lead + 1;
        *out = q;
        return FLAC_OK;
    }
    return FLAC_E_TRUNC;
}

static void br_align(BitReader *br) { br->pos = (br->pos + 7) / 8 * 8; }

static int read_utf8_number(BitReader *br) {
    uint64_t first;
    int rc = br_read(br, 8, &first);
    if (rc) return rc;
    if (first < 0x80) return FLAC_OK;
    int n_extra = 0;
    uint32_t mask = 0x40;
    while (first & mask) {
        n_extra++;
        mask >>= 1;
    }
    if (n_extra < 1 || n_extra > 6) return FLAC_E_FORMAT;
    for (int i = 0; i < n_extra; i++) {
        uint64_t b;
        rc = br_read(br, 8, &b);
        if (rc) return rc;
        if ((b & 0xC0) != 0x80) return FLAC_E_FORMAT;
    }
    return FLAC_OK;
}

static int read_residual(BitReader *br, int blocksize, int order, int64_t *out) {
    uint64_t method, po, param64;
    int rc = br_read(br, 2, &method);
    if (rc) return rc;
    if (method > 1) return FLAC_E_FORMAT;
    int plen = method == 0 ? 4 : 5;
    uint32_t escape = (1u << plen) - 1u;
    rc = br_read(br, 4, &po);
    if (rc) return rc;
    int n_part = 1 << po;
    if (blocksize % n_part) return FLAC_E_FORMAT;
    int64_t w = 0;
    for (int part = 0; part < n_part; part++) {
        int n = blocksize / n_part - (part == 0 ? order : 0);
        if (n < 0) return FLAC_E_FORMAT;
        rc = br_read(br, plen, &param64);
        if (rc) return rc;
        uint32_t param = (uint32_t)param64;
        if (param == escape) {
            uint64_t raw;
            rc = br_read(br, 5, &raw);
            if (rc) return rc;
            for (int k = 0; k < n; k++) {
                if (raw) {
                    rc = br_read_signed(br, (int)raw, &out[w + k]);
                    if (rc) return rc;
                } else {
                    out[w + k] = 0;
                }
            }
        } else {
            for (int k = 0; k < n; k++) {
                uint32_t q;
                rc = br_unary(br, &q);
                if (rc) return rc;
                uint64_t lo = 0;
                if (param) {
                    rc = br_read(br, (int)param, &lo);
                    if (rc) return rc;
                }
                uint64_t v = ((uint64_t)q << param) | lo;
                /* zigzag */
                out[w + k] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
            }
        }
        w += n;
    }
    return FLAC_OK;
}

/* FIXED prediction: x[n] = sum of binomial-weighted previous samples + r */
static void fixed_restore(int64_t *x, int blocksize, int order) {
    /* x[0..order) holds warmup, x[order..) holds residuals in place */
    for (int n = order; n < blocksize; n++) {
        int64_t pred = 0;
        switch (order) {
            case 0: pred = 0; break;
            case 1: pred = x[n - 1]; break;
            case 2: pred = 2 * x[n - 1] - x[n - 2]; break;
            case 3: pred = 3 * x[n - 1] - 3 * x[n - 2] + x[n - 3]; break;
            case 4:
                pred = 4 * x[n - 1] - 6 * x[n - 2] + 4 * x[n - 3] - x[n - 4];
                break;
        }
        x[n] = pred + x[n];
    }
}

static void lpc_restore(int64_t *x, int blocksize, int order,
                        const int64_t *coefs, int shift) {
    for (int n = order; n < blocksize; n++) {
        int64_t acc = 0;
        for (int j = 0; j < order; j++) acc += coefs[j] * x[n - 1 - j];
        x[n] = (acc >> shift) + x[n];
    }
}

/* Decode one subframe into out[0..blocksize) (int64 workspace). */
static int read_subframe(BitReader *br, int blocksize, int bps, int64_t *out) {
    uint64_t bit, ftype64;
    int rc = br_read(br, 1, &bit);
    if (rc) return rc;
    if (bit != 0) return FLAC_E_FORMAT;
    rc = br_read(br, 6, &ftype64);
    if (rc) return rc;
    int ftype = (int)ftype64;
    rc = br_read(br, 1, &bit);
    if (rc) return rc;
    int wasted = 0;
    if (bit) {
        uint32_t q;
        rc = br_unary(br, &q);
        if (rc) return rc;
        wasted = (int)q + 1;
        bps -= wasted;
    }
    if (bps <= 0 || bps > 33) return FLAC_E_FORMAT;

    if (ftype == 0) { /* CONSTANT */
        int64_t v;
        rc = br_read_signed(br, bps, &v);
        if (rc) return rc;
        for (int i = 0; i < blocksize; i++) out[i] = v;
    } else if (ftype == 1) { /* VERBATIM */
        for (int i = 0; i < blocksize; i++) {
            rc = br_read_signed(br, bps, &out[i]);
            if (rc) return rc;
        }
    } else if (ftype >= 8 && ftype <= 12) { /* FIXED */
        int order = ftype - 8;
        for (int i = 0; i < order; i++) {
            rc = br_read_signed(br, bps, &out[i]);
            if (rc) return rc;
        }
        rc = read_residual(br, blocksize, order, out + order);
        if (rc) return rc;
        fixed_restore(out, blocksize, order);
    } else if (ftype >= 32) { /* LPC */
        int order = ftype - 31;
        for (int i = 0; i < order; i++) {
            rc = br_read_signed(br, bps, &out[i]);
            if (rc) return rc;
        }
        uint64_t prec64;
        rc = br_read(br, 4, &prec64);
        if (rc) return rc;
        int precision = (int)prec64 + 1;
        if (precision == 16) return FLAC_E_FORMAT;
        int64_t shift;
        rc = br_read_signed(br, 5, &shift);
        if (rc) return rc;
        if (shift < 0) return FLAC_E_FORMAT;
        int64_t coefs[32];
        for (int i = 0; i < order; i++) {
            rc = br_read_signed(br, precision, &coefs[i]);
            if (rc) return rc;
        }
        rc = read_residual(br, blocksize, order, out + order);
        if (rc) return rc;
        lpc_restore(out, blocksize, order, coefs, (int)shift);
    } else {
        return FLAC_E_FORMAT;
    }

    if (wasted) {
        for (int i = 0; i < blocksize; i++) out[i] <<= wasted;
    }
    return FLAC_OK;
}

static const int BLOCKSIZE_FROM_CODE[16] = {
    /* 0 */ 0,   192,  576,  1152, 2304, 4608, /* 6,7: coded in frame */ 0, 0,
    /* 8 */ 256, 512,  1024, 2048, 4096, 8192, 16384, 32768,
};
static const int SAMPLE_SIZE_FROM_CODE[8] = {0, 8, 12, 0, 16, 20, 24, 32};

/* Decode a whole stream.  On success (return 0):
 *   *out_samples  malloc'd (frames*channels) int32, interleaved; caller
 *                 frees with flac_free
 *   *out_frames, *out_channels, *out_rate, *out_bps filled in.
 * Negative return = error (caller falls back to the Python decoder). */
int64_t flac_decode(const uint8_t *data, int64_t len, int32_t **out_samples,
                    int64_t *out_frames, int32_t *out_channels,
                    int32_t *out_rate, int32_t *out_bps) {
    if (len < 8 || memcmp(data, "fLaC", 4) != 0) return FLAC_E_MARKER;
    int64_t pos = 4;
    const uint8_t *streaminfo = NULL;
    int64_t si_len = 0;
    for (;;) {
        if (pos + 4 > len) return FLAC_E_TRUNC;
        uint8_t hdr = data[pos];
        int last = hdr & 0x80;
        int btype = hdr & 0x7F;
        int64_t length = ((int64_t)data[pos + 1] << 16) |
                         ((int64_t)data[pos + 2] << 8) | data[pos + 3];
        if (pos + 4 + length > len) return FLAC_E_TRUNC;
        if (btype == 0) {
            streaminfo = data + pos + 4;
            si_len = length;
        }
        pos += 4 + length;
        if (last) break;
    }
    if (!streaminfo || si_len < 34) return FLAC_E_STREAMINFO;

    BitReader si = {streaminfo, si_len * 8, 0};
    uint64_t tmp, sr64, ch64, bps64, total64;
    br_read(&si, 16, &tmp);
    br_read(&si, 16, &tmp);
    br_read(&si, 24, &tmp);
    br_read(&si, 24, &tmp);
    br_read(&si, 20, &sr64);
    br_read(&si, 3, &ch64);
    br_read(&si, 5, &bps64);
    br_read(&si, 36, &total64);
    int sample_rate = (int)sr64;
    int channels = (int)ch64 + 1;
    int bps_stream = (int)bps64 + 1;
    int64_t total_samples = (int64_t)total64;
    if (sample_rate == 0) return FLAC_E_FORMAT;
    if (bps_stream != 8 && bps_stream != 12 && bps_stream != 16 &&
        bps_stream != 20 && bps_stream != 24)
        return FLAC_E_FORMAT;

    BitReader br = {data + pos, (len - pos) * 8, 0};
    int64_t cap = total_samples ? total_samples : (1 << 20);
    int32_t *samples = (int32_t *)malloc((size_t)(cap * channels) * sizeof(int32_t));
    int64_t *work = NULL; /* per-channel int64 workspace, realloc'd to blocksize */
    int64_t *chan[8] = {0};
    int work_cap = 0;
    if (!samples) return FLAC_E_NOMEM;
    int64_t decoded = 0;
    int rc = FLAC_OK;

#define FAIL(code)            \
    do {                      \
        rc = (code);          \
        goto done;            \
    } while (0)

    while ((total_samples == 0 || decoded < total_samples) &&
           br.nbits - br.pos >= 16) {
        uint64_t sync;
        if ((rc = br_read(&br, 14, &sync))) goto done;
        if (sync != 0x3FFE) FAIL(FLAC_E_SYNC);
        if ((rc = br_read(&br, 1, &tmp))) goto done; /* reserved */
        if ((rc = br_read(&br, 1, &tmp))) goto done; /* blocking strategy */
        uint64_t bs_code, sr_code, ch_assign, ss_code;
        if ((rc = br_read(&br, 4, &bs_code))) goto done;
        if ((rc = br_read(&br, 4, &sr_code))) goto done;
        if ((rc = br_read(&br, 4, &ch_assign))) goto done;
        if ((rc = br_read(&br, 3, &ss_code))) goto done;
        if ((rc = br_read(&br, 1, &tmp))) goto done; /* reserved */
        if ((rc = read_utf8_number(&br))) goto done;
        int blocksize;
        if (bs_code == 0) {
            FAIL(FLAC_E_FORMAT);
        } else if (bs_code == 6) {
            if ((rc = br_read(&br, 8, &tmp))) goto done;
            blocksize = (int)tmp + 1;
        } else if (bs_code == 7) {
            if ((rc = br_read(&br, 16, &tmp))) goto done;
            blocksize = (int)tmp + 1;
        } else {
            blocksize = BLOCKSIZE_FROM_CODE[bs_code];
        }
        if (sr_code == 12) {
            if ((rc = br_read(&br, 8, &tmp))) goto done;
        } else if (sr_code == 13 || sr_code == 14) {
            if ((rc = br_read(&br, 16, &tmp))) goto done;
        } else if (sr_code == 15) {
            FAIL(FLAC_E_FORMAT);
        }
        int bps = SAMPLE_SIZE_FROM_CODE[ss_code];
        if (bps == 0) bps = bps_stream;
        if ((rc = br_read(&br, 8, &tmp))) goto done; /* header CRC-8 */

        /* (re)allocate per-channel workspace (stereo decorrelation needs
         * 2 lanes even for what STREAMINFO calls 1 channel — never hit,
         * but size defensively) */
        int nch_ws = channels < 2 ? 2 : channels;
        if (blocksize > work_cap) {
            free(work);
            work = (int64_t *)malloc((size_t)blocksize * nch_ws * sizeof(int64_t));
            if (!work) FAIL(FLAC_E_NOMEM);
            work_cap = blocksize;
        }
        for (int c = 0; c < nch_ws; c++) chan[c] = work + (int64_t)c * blocksize;

        int frame_channels;
        if (ch_assign < 8) {
            frame_channels = (int)ch_assign + 1;
            if (frame_channels != channels) FAIL(FLAC_E_FORMAT);
            for (int c = 0; c < frame_channels; c++) {
                if ((rc = read_subframe(&br, blocksize, bps, chan[c]))) goto done;
            }
        } else if (ch_assign <= 10) {
            if (channels != 2) FAIL(FLAC_E_FORMAT);
            frame_channels = 2;
            if (ch_assign == 8) { /* left/side */
                if ((rc = read_subframe(&br, blocksize, bps, chan[0]))) goto done;
                if ((rc = read_subframe(&br, blocksize, bps + 1, chan[1]))) goto done;
                for (int i = 0; i < blocksize; i++) chan[1][i] = chan[0][i] - chan[1][i];
            } else if (ch_assign == 9) { /* right/side */
                if ((rc = read_subframe(&br, blocksize, bps + 1, chan[0]))) goto done;
                if ((rc = read_subframe(&br, blocksize, bps, chan[1]))) goto done;
                for (int i = 0; i < blocksize; i++) chan[0][i] = chan[1][i] + chan[0][i];
            } else { /* mid/side */
                if ((rc = read_subframe(&br, blocksize, bps, chan[0]))) goto done;
                if ((rc = read_subframe(&br, blocksize, bps + 1, chan[1]))) goto done;
                for (int i = 0; i < blocksize; i++) {
                    int64_t mid = chan[0][i], side = chan[1][i];
                    int64_t m2 = (mid << 1) | (side & 1);
                    chan[0][i] = (m2 + side) >> 1;
                    chan[1][i] = (m2 - side) >> 1;
                }
            }
        } else {
            FAIL(FLAC_E_FORMAT);
        }

        br_align(&br);
        if ((rc = br_read(&br, 16, &tmp))) goto done; /* frame CRC-16 */

        if (decoded + blocksize > cap) {
            int64_t new_cap = cap * 2;
            while (decoded + blocksize > new_cap) new_cap *= 2;
            int32_t *ns = (int32_t *)realloc(
                samples, (size_t)(new_cap * channels) * sizeof(int32_t));
            if (!ns) FAIL(FLAC_E_NOMEM);
            samples = ns;
            cap = new_cap;
        }
        for (int c = 0; c < frame_channels; c++) {
            int32_t *dst = samples + decoded * channels + c;
            const int64_t *src = chan[c];
            for (int i = 0; i < blocksize; i++) dst[(int64_t)i * channels] = (int32_t)src[i];
        }
        decoded += blocksize;
    }

    if (decoded == 0) FAIL(FLAC_E_NOFRAMES);
    if (total_samples && decoded > total_samples) decoded = total_samples;
    rc = FLAC_OK;

done:
    free(work);
    if (rc != FLAC_OK) {
        free(samples);
        return rc;
    }
    *out_samples = samples;
    *out_frames = decoded;
    *out_channels = channels;
    *out_rate = sample_rate;
    *out_bps = bps_stream;
    return FLAC_OK;
}

void flac_free(int32_t *p) { free(p); }
