// zstdtpu_core — native host engine for the serial byte-stream stages.
//
// The device owns the data-parallel compute (match candidates, histograms,
// bit-packing scans); these routines cover the per-block serial state
// machines that a host CPU finishes faster than a Python loop:
//   * Huffman X1 stream decode   (HufDecompress.cs:264 role)
//   * FSE 3-state sequence decode incl. repcodes (ZstdDecompressBlock.cs:2360)
//   * sequence execution (LZ copy, ZstdDecompressBlock.cs:2187)
//   * greedy fast match finder   (ZstdFast.cs:96 role)
//   * interleaved sequence bitstream encode (ZstdCompressSequences.cs:585)
//   * backward bitstream pack for Huffman streams
//
// Exposed as a plain C ABI for ctypes.  No libzstd code is used; the logic
// mirrors the Python reference modules in zstdsharp_tpu/ (the bit-exactness
// oracle), which are themselves validated against RFC 8878 frames.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cstdlib>
#include <ctime>
#include <cstdio>
#include <cmath>
#ifdef __BMI2__
#include <immintrin.h>
#endif

// Low-nb-bits extraction: one bzhi on BMI2 hosts, mask arithmetic
// otherwise.  nb may legally be 0..63.
static inline uint64_t bits_lo(uint64_t w, int nb) {
#ifdef __BMI2__
    return _bzhi_u64(w, (unsigned)nb);
#else
    return w & ((1ULL << nb) - 1);
#endif
}

// Stage profiler (ZT_PROF=1): nanoseconds per codec stage, printed at
// frame end.  Zero overhead when disabled (single branch per stage).
static int64_t g_prof[4];
static inline int64_t prof_now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1000000000LL + ts.tv_nsec;
}
static bool prof_on() {
    static const int v = getenv("ZT_PROF") ? 1 : 0;  // magic-static: thread-safe init
    return v == 1;
}

extern "C" {

// ---------------------------------------------------------------------------
// Bit reading (backward streams)
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* buf;   // padded: 16 zero bytes precede payload
    int64_t pos;          // bit position (0 = stream start)
};

static inline uint64_t read_window(const uint8_t* p) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    return w;  // little-endian hosts only (x86/ARM LE)
}

static inline uint64_t br_field(const uint8_t* padded, int64_t pos, int nbits) {
    // bits [pos, pos+nbits) of the stream; PAD=16 zero bytes in front
    int64_t p = pos + 16 * 8;
    if (p < 0) return 0;
    const uint64_t w = read_window(padded + (p >> 3));
    return (w >> (p & 7)) & ((nbits >= 64) ? ~0ULL : ((1ULL << nbits) - 1));
}

// Initialize: returns total payload bits (end mark stripped), or -1 on error.
static int64_t br_init(const uint8_t* payload, int64_t size) {
    if (size <= 0) return -1;
    uint8_t last = payload[size - 1];
    if (last == 0) return -1;
    int hb = 31 - __builtin_clz((uint32_t)last);
    return (size - 1) * 8 + hb;
}

// ---------------------------------------------------------------------------
// Huffman X1 decode: one stream, table-driven
// ---------------------------------------------------------------------------

// padded = 16 zero bytes + payload.  Returns 0 on success, -1 on corruption.
int64_t huf_decode_stream(const uint8_t* padded, int64_t payload_size,
                          const uint8_t* tbl_sym, const uint8_t* tbl_nb,
                          int table_log, uint8_t* out, int64_t n_out) {
    int64_t pos = br_init(padded + 16, payload_size);
    if (pos < 0) return -1;
    const uint64_t mask = (1ULL << table_log) - 1;
    for (int64_t i = 0; i < n_out; i++) {
        int64_t p = pos - table_log + 16 * 8;
        uint64_t idx;
        if (p >= 0) {
            idx = (read_window(padded + (p >> 3)) >> (p & 7)) & mask;
        } else {
            idx = 0;
        }
        out[i] = tbl_sym[idx];
        pos -= tbl_nb[idx];
    }
    return pos == 0 ? 0 : -1;
}

// Decode 4 streams with shared table; sizes/outputs per stream.
int64_t huf_decode_4streams(const uint8_t* const* padded, const int64_t* sizes,
                            const uint8_t* tbl_sym, const uint8_t* tbl_nb,
                            int table_log, uint8_t* out, const int64_t* out_sizes) {
    int64_t off = 0;
    for (int s = 0; s < 4; s++) {
        int64_t rc = huf_decode_stream(padded[s], sizes[s], tbl_sym, tbl_nb,
                                       table_log, out + off, out_sizes[s]);
        if (rc != 0) return -1 - s;
        off += out_sizes[s];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// FSE sequence decode (3 interleaved states + repcodes)
// ---------------------------------------------------------------------------

// Tables are struct-of-arrays: base (u32), add_bits (u8), next_state (u16),
// state_bits (u8); logs are the table logs.
int64_t fse_decode_sequences(
    const uint8_t* padded, int64_t payload_size, int64_t nb_seq,
    const uint32_t* ll_base, const uint8_t* ll_add, const uint16_t* ll_ns, const uint8_t* ll_sb, int ll_log,
    const uint32_t* of_base, const uint8_t* of_add, const uint16_t* of_ns, const uint8_t* of_sb, int of_log,
    const uint32_t* ml_base, const uint8_t* ml_add, const uint16_t* ml_ns, const uint8_t* ml_sb, int ml_log,
    uint32_t* rep,  /* in/out [3] */
    uint32_t* out_ll, uint32_t* out_ml, uint32_t* out_of) {

    int64_t pos = br_init(padded + 16, payload_size);
    if (pos < 0) return -1;

    pos -= ll_log; uint32_t s_ll = (uint32_t)br_field(padded, pos, ll_log);
    pos -= of_log; uint32_t s_of = (uint32_t)br_field(padded, pos, of_log);
    pos -= ml_log; uint32_t s_ml = (uint32_t)br_field(padded, pos, ml_log);

    uint64_t r0 = rep[0], r1 = rep[1], r2 = rep[2];

    // Rolling 57-bit window: one unaligned load covers several fields
    // (BIT_DStream reload discipline; the old per-field loads cost ~7
    // memcpy+shift chains per sequence).
    int64_t wpos = 0;
    uint64_t win = 0;
    auto reload = [&](int64_t at) {
        wpos = at - 57;
        if (wpos < -120) wpos = -120;
        const int64_t pb = wpos + 16 * 8;
        win = read_window(padded + (pb >> 3)) >> (pb & 7);
    };
    reload(pos);

    for (int64_t i = 0; i < nb_seq; i++) {
        const uint32_t llB = ll_base[s_ll]; const int llb = ll_add[s_ll];
        const uint32_t mlB = ml_base[s_ml]; const int mlb = ml_add[s_ml];
        const uint32_t ofB = of_base[s_of]; const int ofb = of_add[s_of];

        if (pos - ofb < wpos) reload(pos);
        if (pos - ofb < wpos) return -2;

        uint64_t offset;
        if (ofb > 1) {
            pos -= ofb;
            offset = ofB + bits_lo(win >> (pos - wpos), ofb);
            r2 = r1; r1 = r0; r0 = offset;
        } else {
            const int ll0 = (llB == 0);
            if (ofb == 0) {
                offset = ll0 ? r1 : r0;
                if (ll0) { uint64_t t = r0; r0 = r1; r1 = t; }
            } else {
                pos -= 1;
                uint64_t idx = ofB + ll0 + ((win >> (pos - wpos)) & 1);
                uint64_t t = (idx == 3) ? r0 - 1 : (idx == 1 ? r1 : r2);
                if (t == 0) t = 1;
                if (idx != 1) r2 = r1;
                r1 = r0; r0 = offset = t;
            }
        }

        if (pos - (mlb + llb) < wpos) reload(pos);
        if (pos - (mlb + llb) < wpos) return -2;
        uint64_t ml = mlB;
        if (mlb) { pos -= mlb; ml += bits_lo(win >> (pos - wpos), mlb); }
        uint64_t ll = llB;
        if (llb) { pos -= llb; ll += bits_lo(win >> (pos - wpos), llb); }

        out_ll[i] = (uint32_t)ll;
        out_ml[i] = (uint32_t)ml;
        out_of[i] = (uint32_t)offset;

        if (i != nb_seq - 1) {
            const int nb1 = ll_sb[s_ll], nb2 = ml_sb[s_ml], nb3 = of_sb[s_of];
            if (pos - (nb1 + nb2 + nb3) < wpos) reload(pos);
            if (pos - (nb1 + nb2 + nb3) < wpos) return -2;
            pos -= nb1; s_ll = ll_ns[s_ll] + (uint32_t)bits_lo(win >> (pos - wpos), nb1);
            pos -= nb2; s_ml = ml_ns[s_ml] + (uint32_t)bits_lo(win >> (pos - wpos), nb2);
            pos -= nb3; s_of = of_ns[s_of] + (uint32_t)bits_lo(win >> (pos - wpos), nb3);
            if (pos < 0) return -2;
        }
    }
    if (pos != 0) return -3;
    rep[0] = (uint32_t)r0; rep[1] = (uint32_t)r1; rep[2] = (uint32_t)r2;
    return 0;
}

// ---------------------------------------------------------------------------
// Sequence execution (LZ copy into frame-wide output)
// ---------------------------------------------------------------------------

// 16-byte chunked copy; may write up to 15 bytes past dst+n (callers
// guarantee slack — ZSTD_wildcopy role).
static inline void wildcopy16(uint8_t* dst, const uint8_t* src, int64_t n) {
    do {
        std::memcpy(dst, src, 16);
        dst += 16; src += 16; n -= 16;
    } while (n > 0);
}

int64_t execute_sequences(uint8_t* out, int64_t out_pos, int64_t out_cap,
                          int64_t prefix_start,
                          const uint8_t* literals, int64_t n_literals,
                          const uint32_t* ll, const uint32_t* ml,
                          const uint32_t* of, int64_t nb_seq) {
    int64_t lit_pos = 0;
    // lookahead prefetch of match sources (ZSTD_decompressSequencesLong
    // role for the staged path): hides the window-read miss for long
    // offsets by running K sequences ahead of the copy loop
    const int64_t K = 4;
    int64_t pf_pos = out_pos;
    for (int64_t j = 0; j < K && j < nb_seq; j++) {
        pf_pos += ll[j];
        __builtin_prefetch(out + pf_pos - of[j]);
        pf_pos += ml[j];
    }
    for (int64_t i = 0; i < nb_seq; i++) {
        if (i + K < nb_seq) {
            pf_pos += ll[i + K];
            __builtin_prefetch(out + pf_pos - of[i + K]);
            __builtin_prefetch(out + pf_pos - of[i + K] + 64);
            pf_pos += ml[i + K];
        }
        const int64_t l = ll[i], m = ml[i], o = of[i];
        if (lit_pos + l > n_literals) return -1;
        if (out_pos + l + m > out_cap) return -2;
        const bool slack = out_pos + l + m + 31 <= out_cap;
        if (l) {
            if (slack) wildcopy16(out + out_pos, literals + lit_pos, l);
            else std::memcpy(out + out_pos, literals + lit_pos, (size_t)l);
            out_pos += l; lit_pos += l;
        }
        if (o <= 0 || o > out_pos - prefix_start) return -3;
        const uint8_t* src = out + out_pos - o;
        uint8_t* dst = out + out_pos;
        if (o >= 16 && slack) {
            wildcopy16(dst, src, m);
        } else if (o >= m) {
            std::memcpy(dst, src, (size_t)m);
        } else {
            // overlapped: write the pattern bytewise until a multiple-of-o
            // read distance >= 16 exists, then chunk from that distance
            // (reads then never overlap a pending 16-byte write)
            if (slack) {
                const int64_t O = o * ((16 + o - 1) / o);
                const int64_t head = m < O ? m : O;
                for (int64_t k = 0; k < head; k++) dst[k] = src[k];
                if (m > head) wildcopy16(dst + head, dst + head - O, m - head);
            } else {
                for (int64_t k = 0; k < m; k++) dst[k] = src[k];
            }
        }
        out_pos += m;
    }
    const int64_t rest = n_literals - lit_pos;
    if (rest < 0 || out_pos + rest > out_cap) return -4;
    std::memcpy(out + out_pos, literals + lit_pos, (size_t)rest);
    return out_pos + rest;
}

// Execute one (litLength, matchLength, offset) against the output window.
// Returns the new out_pos or -1.
static inline int64_t zt_exec_one(uint8_t* out, int64_t out_pos,
                                  int64_t out_cap, int64_t prefix_start,
                                  const uint8_t* lit, int64_t* lit_pos,
                                  int64_t n_literals, uint64_t l, uint64_t m,
                                  int64_t o) {
    // Fast path (ZSTD_execSequence's single-branch core): one 16-byte
    // literal copy, one 16-byte match copy, and a wild tail for longer
    // matches — covers every sequence with a short literal run and a
    // non-overlapping (>=16) offset.  Overshoot lands in slack the general
    // path would also write; lit buffer carries >=32B slack
    // (decode_literals_c pads).
    if (l <= 16 && o >= 16 &&
        out_pos + (int64_t)(l + m) + 32 <= out_cap &&
        *lit_pos + (int64_t)l <= n_literals &&
        o <= out_pos + (int64_t)l - prefix_start) {
        std::memcpy(out + out_pos, lit + *lit_pos, 16);
        out_pos += l;
        *lit_pos += l;
        uint8_t* const dst = out + out_pos;
        const uint8_t* const ms = dst - o;
        std::memcpy(dst, ms, 16);
        if (m > 16) wildcopy16(dst + 16, ms + 16, (int64_t)m - 16);
        return out_pos + m;
    }
    if (*lit_pos + (int64_t)l > n_literals) return -1;
    if (out_pos + (int64_t)(l + m) > out_cap) return -1;
    const bool slack = out_pos + (int64_t)(l + m) + 31 <= out_cap;
    if (l) {
        if (slack) wildcopy16(out + out_pos, lit + *lit_pos, (int64_t)l);
        else std::memcpy(out + out_pos, lit + *lit_pos, (size_t)l);
        out_pos += l; *lit_pos += l;
    }
    if (o <= 0 || o > out_pos - prefix_start) return -1;
    const uint8_t* cs = out + out_pos - o;
    uint8_t* dst = out + out_pos;
    if (o >= 16 && slack) {
        wildcopy16(dst, cs, (int64_t)m);
    } else if (o >= (int64_t)m) {
        std::memcpy(dst, cs, (size_t)m);
    } else if (slack) {
        // smallest multiple of o that is >= 16, from a table (o in 1..15)
        static const int8_t kSpan16[16] = {0, 16, 16, 18, 16, 20, 18, 21,
                                           16, 18, 20, 22, 24, 26, 28, 30};
        const int64_t O = kSpan16[o];
        const int64_t head = (int64_t)m < O ? (int64_t)m : O;
        for (int64_t k = 0; k < head; k++) dst[k] = cs[k];
        if ((int64_t)m > head) wildcopy16(dst + head, dst + head - O, m - head);
    } else {
        for (int64_t k = 0; k < (int64_t)m; k++) dst[k] = cs[k];
    }
    return out_pos + m;
}

// Fused sequence decode + execute: one pass, no intermediate (ll, ml, of)
// arrays (ZSTD_decompressSequences_body role — decode a sequence, run it).
// Tables are struct-of-arrays as in fse_decode_sequences; literals are
// consumed sequentially from lit; copies use the wildcopy discipline.
}  // pause extern "C" for the template

// Out-of-line continuation for the rare execute shapes (literal run > 16,
// offset < 16 / overlapping, or within 32 bytes of the output cap).  Kept
// noinline so the hot loop's register allocation is not constrained by
// this path's live values.  Returns the advanced write pointer, or null
// on a bounds violation.
struct ZtOpLp { uint8_t* op; const uint8_t* lp; };  // two-register return

__attribute__((noinline))
static ZtOpLp zt_exec_cold(uint8_t* op, uint8_t* const oend,
                           const uint8_t* const prefix,
                           const uint8_t* lp, const uint8_t* const lend,
                           uint64_t l, uint64_t m, int64_t o) {
    if (lp + l > lend) return {nullptr, lp};
    if (op + l + m > oend) return {nullptr, lp};
    const bool slack = op + (int64_t)(l + m) + 31 <= oend;
    if (l) {
        if (slack) wildcopy16(op, lp, (int64_t)l);
        else std::memcpy(op, lp, (size_t)l);
        op += l; lp += l;
    }
    if (o <= 0 || o > op - prefix) return {nullptr, lp};
    const uint8_t* cs = op - o;
    if (o >= 16 && slack) {
        wildcopy16(op, cs, (int64_t)m);
    } else if (o >= (int64_t)m) {
        std::memcpy(op, cs, (size_t)m);
    } else if (slack) {
        // smallest multiple of o that is >= 16, from a table (o in 1..15)
        static const int8_t kSpan16[16] = {0, 16, 16, 18, 16, 20, 18, 21,
                                           16, 18, 20, 22, 24, 26, 28, 30};
        const int64_t O = kSpan16[o];
        const int64_t head = (int64_t)m < O ? (int64_t)m : O;
        for (int64_t k = 0; k < head; k++) op[k] = cs[k];
        if ((int64_t)m > head) wildcopy16(op + head, op + head - O, m - head);
    } else {
        for (int64_t k = 0; k < (int64_t)m; k++) op[k] = cs[k];
    }
    return {op + m, lp};
}

template <int long_mode>
__attribute__((optimize("O3")))
static int64_t decode_execute_sequences_t(
    const uint8_t* padded, int64_t payload_size, int64_t nb_seq,
    const uint64_t* ll_f, int ll_log,
    const uint64_t* of_f, int of_log,
    const uint64_t* ml_f, int ml_log,
    uint32_t* rep,
    uint8_t* out, int64_t out_pos, int64_t out_cap, int64_t prefix_start,
    const uint8_t* lit, int64_t n_literals) {

    int64_t pos = br_init(padded + 16, payload_size);
    if (pos < 0) return -1;

    pos -= ll_log; uint32_t s_ll = (uint32_t)br_field(padded, pos, ll_log);
    pos -= of_log; uint32_t s_of = (uint32_t)br_field(padded, pos, of_log);
    pos -= ml_log; uint32_t s_ml = (uint32_t)br_field(padded, pos, ml_log);

    uint64_t r0 = rep[0], r1 = rep[1], r2 = rep[2];

    // Pointer-form output/literal state (one live pointer each instead of
    // base+index pairs; the compare-only bounds stay cold).
    uint8_t* op = out + out_pos;
    uint8_t* const oend = out + out_cap;
    const uint8_t* const prefix = out + prefix_start;
    const uint8_t* lp = lit;
    const uint8_t* const lend = lit + n_literals;

    // Bit window: `win` holds the 57 stream bits below the anchor position
    // `pos`; `bleft` counts how many remain unconsumed, so the next field
    // sits at win >> (bleft - nb) and the current absolute bit position is
    // always pos - 57 + bleft.  Field validity is one subtraction+compare
    // against bleft instead of a position/watermark compare.
    uint64_t win = 0;
    int64_t bleft = 57;  // so the first reanchor lands at `pos` exactly
    // Only corrupt streams can drive the position below -63 (valid data
    // never over-consumes); starve the window there (every subsequent
    // field check then fails) instead of clamping on the address chain.
    auto reanchor = [&]() {
        pos += bleft - 57;
        bleft = 57;
        const int64_t w = pos - 57;
        if (__builtin_expect(w < -120, 0)) { win = 0; bleft = 0; return; }
        const int64_t pb = w + 16 * 8;
        win = read_window(padded + (pb >> 3)) >> (pb & 7);
    };
    reanchor();

    // Long-offset prefetch pipeline (ZSTD_decompressSequencesLong_body
    // role, ZstdDecompressBlock.cs:2796): decoded sequences stage through
    // an 8-deep ring; the match source is prefetched at decode time and
    // the copy runs 8 sequences behind, hiding the window-read miss.
    uint64_t ring_l[8], ring_m[8];
    int64_t ring_o[8];
    uint8_t* pf = op;

    // Software-pipelined entry loads: the three table entries for the NEXT
    // sequence are fetched right where the next states are computed, so
    // their load latency overlaps this sequence's copy work instead of
    // serializing at the loop top.
    uint64_t eL = ll_f[s_ll], eM = ml_f[s_ml], eO = of_f[s_of];
    for (int64_t i = nb_seq - 1; i >= 0; --i) {
        const uint32_t llB = (uint32_t)eL; const int llb = (int)((eL >> 32) & 0xFF);
        const uint32_t mlB = (uint32_t)eM; const int mlb = (int)((eM >> 32) & 0xFF);
        const uint32_t ofB = (uint32_t)eO; const int ofb = (int)((eO >> 32) & 0xFF);

        // One anchor covers of+ml+ll when ofb+mlb+llb <= 57 (all offsets
        // below ~32MB); the rare long-offset case re-anchors once more
        // before the literals field.
        reanchor();
        if (bleft < ofb + mlb) return -2;

        uint64_t offset;
        if (ofb > 1) {
            bleft -= ofb;
            offset = ofB + bits_lo(win >> bleft, ofb);
            r2 = r1; r1 = r0; r0 = offset;
        } else {
            const int ll0 = (llB == 0);
            if (ofb == 0) {
                offset = ll0 ? r1 : r0;
                if (ll0) { uint64_t t = r0; r0 = r1; r1 = t; }
            } else {
                bleft -= 1;
                uint64_t idx = ofB + ll0 + ((win >> bleft) & 1);
                uint64_t t = (idx == 3) ? r0 - 1 : (idx == 1 ? r1 : r2);
                if (t == 0) t = 1;
                if (idx != 1) r2 = r1;
                r1 = r0; r0 = offset = t;
            }
        }

        uint64_t m = mlB;
        if (mlb) { bleft -= mlb; m += bits_lo(win >> bleft, mlb); }

        if (bleft < llb) {
            reanchor();
            if (bleft < llb) return -2;
        }
        uint64_t l = llB;
        if (llb) { bleft -= llb; l += bits_lo(win >> bleft, llb); }

        if (i != 0) {
            const int nb1 = (int)(eL >> 56), nb2 = (int)(eM >> 56), nb3 = (int)(eO >> 56);
            if (bleft < nb1 + nb2 + nb3) {
                reanchor();
                if (bleft < nb1 + nb2 + nb3) return -2;
            }
            bleft -= nb1; const uint32_t nsll = (uint32_t)((eL >> 40) & 0xFFFF) + (uint32_t)bits_lo(win >> bleft, nb1);
            bleft -= nb2; const uint32_t nsml = (uint32_t)((eM >> 40) & 0xFFFF) + (uint32_t)bits_lo(win >> bleft, nb2);
            bleft -= nb3; const uint32_t nsof = (uint32_t)((eO >> 40) & 0xFFFF) + (uint32_t)bits_lo(win >> bleft, nb3);
            eL = ll_f[nsll]; eM = ml_f[nsml]; eO = of_f[nsof];
        }

        // ---- execute (ll=l, ml=m, offset) ----
        if (long_mode) {
            const int64_t fwd = nb_seq - 1 - i;
            const int64_t slot = fwd & 7;
            if (fwd >= 8) {
                const uint64_t rl = ring_l[slot], rm = ring_m[slot];
                const int64_t ro = ring_o[slot];
                uint8_t* const ole = op + rl;
                if (rl <= 16 && ro >= 16 && op + (rl + rm) + 32 <= oend &&
                    lp + rl <= lend && ro <= ole - prefix) {
                    std::memcpy(op, lp, 16);
                    lp += rl;
                    const uint8_t* ms = ole - ro;
                    std::memcpy(ole, ms, 16);
                    if (rm > 16) wildcopy16(ole + 16, ms + 16, (int64_t)rm - 16);
                    op = ole + rm;
                } else {
                    const ZtOpLp c = zt_exec_cold(op, oend, prefix, lp, lend,
                                                  rl, rm, ro);
                    op = c.op; lp = c.lp;
                    if (!op) return -3;
                }
            }
            ring_l[slot] = l;
            ring_m[slot] = m;
            ring_o[slot] = (int64_t)offset;
            pf += (int64_t)l;
            __builtin_prefetch(pf - (int64_t)offset);
            __builtin_prefetch(pf - (int64_t)offset + 64);
            pf += (int64_t)m;
        } else {
            // r0 == offset in every decode branch above; reusing it keeps
            // one less value live across the copy.
            uint8_t* const ole = op + l;
            if (l <= 16 && (int64_t)r0 >= 16 &&
                op + (l + m) + 32 <= oend && lp + l <= lend &&
                (int64_t)r0 <= ole - prefix) {
                // fast shape (ZSTD_execSequence single-branch core): one
                // 16B literal copy, one 16B match copy, wild tail.  The
                // literal buffer carries >= 32B slack (decode_literals_c).
                std::memcpy(op, lp, 16);
                lp += l;
                const uint8_t* ms = ole - r0;
                std::memcpy(ole, ms, 16);
                if (m > 16) wildcopy16(ole + 16, ms + 16, (int64_t)m - 16);
                op = ole + m;
            } else {
                const ZtOpLp c = zt_exec_cold(op, oend, prefix, lp, lend,
                                              l, m, (int64_t)r0);
                op = c.op; lp = c.lp;
                if (!op) return -3;
            }
        }
    }
    if (long_mode) {
        const int64_t from = nb_seq > 8 ? nb_seq - 8 : 0;
        for (int64_t i = from; i < nb_seq; i++) {
            const int64_t slot = i & 7;
            const ZtOpLp c = zt_exec_cold(op, oend, prefix, lp, lend,
                                          ring_l[slot], ring_m[slot],
                                          ring_o[slot]);
            op = c.op; lp = c.lp;
            if (!op) return -3;
        }
    }
    if (pos + bleft - 57 != 0) return -1;
    rep[0] = (uint32_t)r0; rep[1] = (uint32_t)r1; rep[2] = (uint32_t)r2;

    const int64_t rest = lend - lp;
    if (op + rest > oend) return -3;
    std::memcpy(op, lp, (size_t)rest);
    return (op - out) + rest;
}

// Two-pass variant: a lean FSE pass fills (ll, ml, of) arrays, then a
// lean execute pass runs them with lookahead prefetch.  Fewer live
// registers per loop than the fused form; selected via ZT_STAGED.
__attribute__((optimize("O3")))
static int64_t decode_sequences_to_arrays(
    const uint8_t* padded, int64_t payload_size, int64_t nb_seq,
    const uint64_t* ll_f, int ll_log, const uint64_t* of_f, int of_log,
    const uint64_t* ml_f, int ml_log, uint32_t* rep, uint32_t* o_ll,
    uint32_t* o_ml, uint32_t* o_of) {
    int64_t pos = br_init(padded + 16, payload_size);
    if (pos < 0) return -1;
    pos -= ll_log; uint32_t s_ll = (uint32_t)br_field(padded, pos, ll_log);
    pos -= of_log; uint32_t s_of = (uint32_t)br_field(padded, pos, of_log);
    pos -= ml_log; uint32_t s_ml = (uint32_t)br_field(padded, pos, ml_log);
    uint64_t r0 = rep[0], r1 = rep[1], r2 = rep[2];
    int64_t wpos = 0;
    uint64_t win = 0;
    auto reload = [&](int64_t at) {
        wpos = at - 57;
        if (wpos < -120) wpos = -120;
        const int64_t pb = wpos + 16 * 8;
        win = read_window(padded + (pb >> 3)) >> (pb & 7);
    };
    for (int64_t i = 0; i < nb_seq; i++) {
        const uint64_t eL = ll_f[s_ll], eM = ml_f[s_ml], eO = of_f[s_of];
        const uint32_t llB = (uint32_t)eL; const int llb = (int)((eL >> 32) & 0xFF);
        const uint32_t mlB = (uint32_t)eM; const int mlb = (int)((eM >> 32) & 0xFF);
        const uint32_t ofB = (uint32_t)eO; const int ofb = (int)((eO >> 32) & 0xFF);
        reload(pos);
        if (pos - (ofb + mlb) < wpos) return -2;
        uint64_t offset;
        if (ofb > 1) {
            pos -= ofb;
            offset = ofB + bits_lo(win >> (pos - wpos), ofb);
            r2 = r1; r1 = r0; r0 = offset;
        } else {
            const int ll0 = (llB == 0);
            if (ofb == 0) {
                offset = ll0 ? r1 : r0;
                if (ll0) { uint64_t t = r0; r0 = r1; r1 = t; }
            } else {
                pos -= 1;
                uint64_t idx = ofB + ll0 + ((win >> (pos - wpos)) & 1);
                uint64_t t = (idx == 3) ? r0 - 1 : (idx == 1 ? r1 : r2);
                if (t == 0) t = 1;
                if (idx != 1) r2 = r1;
                r1 = r0; r0 = offset = t;
            }
        }
        uint64_t m = mlB;
        if (mlb) { pos -= mlb; m += bits_lo(win >> (pos - wpos), mlb); }
        if (pos - llb < wpos) {
            reload(pos);
            if (pos - llb < wpos) return -2;
        }
        uint64_t l = llB;
        if (llb) { pos -= llb; l += bits_lo(win >> (pos - wpos), llb); }
        o_ll[i] = (uint32_t)l;
        o_ml[i] = (uint32_t)m;
        o_of[i] = (uint32_t)offset;
        if (i != nb_seq - 1) {
            const int nb1 = (int)((eL >> 56) & 0xFF);
            const int nb2 = (int)((eM >> 56) & 0xFF);
            const int nb3 = (int)((eO >> 56) & 0xFF);
            if (pos - (nb1 + nb2 + nb3) < wpos) {
                reload(pos);
                if (pos - (nb1 + nb2 + nb3) < wpos) return -2;
            }
            pos -= nb1; s_ll = (uint32_t)((eL >> 40) & 0xFFFF) + (uint32_t)bits_lo(win >> (pos - wpos), nb1);
            pos -= nb2; s_ml = (uint32_t)((eM >> 40) & 0xFFFF) + (uint32_t)bits_lo(win >> (pos - wpos), nb2);
            pos -= nb3; s_of = (uint32_t)((eO >> 40) & 0xFFFF) + (uint32_t)bits_lo(win >> (pos - wpos), nb3);
            if (pos < 0) return -2;
        }
    }
    if (pos != 0) return -1;
    rep[0] = (uint32_t)r0; rep[1] = (uint32_t)r1; rep[2] = (uint32_t)r2;
    return 0;
}

extern "C" {
static int64_t decode_execute_sequences(
    const uint8_t* padded, int64_t payload_size, int64_t nb_seq,
    const uint64_t* ll_f, int ll_log, const uint64_t* of_f, int of_log,
    const uint64_t* ml_f, int ml_log, uint32_t* rep, uint8_t* out,
    int64_t out_pos, int64_t out_cap, int64_t prefix_start,
    const uint8_t* lit, int64_t n_literals, int long_mode) {
    if (long_mode)
        return decode_execute_sequences_t<1>(padded, payload_size, nb_seq,
                                             ll_f, ll_log, of_f, of_log,
                                             ml_f, ml_log, rep, out, out_pos,
                                             out_cap, prefix_start, lit,
                                             n_literals);
    return decode_execute_sequences_t<0>(padded, payload_size, nb_seq, ll_f,
                                         ll_log, of_f, of_log, ml_f, ml_log,
                                         rep, out, out_pos, out_cap,
                                         prefix_start, lit, n_literals);
}

// ---------------------------------------------------------------------------
// Greedy fast match finder (single hash table)
// ---------------------------------------------------------------------------

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v; std::memcpy(&v, p, 4); return v;
}

static inline uint32_t hash32(uint32_t v, int hlog) {
    return (v * 2654435761u) >> (32 - hlog);
}

static inline uint64_t read64_fwd(const uint8_t* p) {
    uint64_t v; std::memcpy(&v, p, 8); return v;
}

// Hash mls bytes from a preloaded little-endian u64 (one load serves both
// the hash and the 4-byte verification value).
static inline uint32_t hash_mls_v(uint64_t v, int hlog, int mls) {
    switch (mls) {
        case 5: return (uint32_t)(((v << 24) * 0x9E3779B185EBCA87ULL) >> (64 - hlog));
        case 6: return (uint32_t)(((v << 16) * 0xC2B2AE3D27D4EB4FULL) >> (64 - hlog));
        case 7: return (uint32_t)(((v << 8)  * 0x165667B19E3779F9ULL) >> (64 - hlog));
        case 8: return (uint32_t)((v * 0xCF1BBCDCB7A56463ULL) >> (64 - hlog));
        default: return hash32((uint32_t)v, hlog);
    }
}

// Hash the first `mls` bytes at p (mls in 4..8).  Wider hashes cut collisions
// for the fast strategy's high min-match levels (ZSTD_hashPtr:423 role).
static inline uint32_t hash_mls(const uint8_t* p, int hlog, int mls) {
    switch (mls) {
        case 5: return (uint32_t)(((read64_fwd(p) << 24) * 0x9E3779B185EBCA87ULL) >> (64 - hlog));
        case 6: return (uint32_t)(((read64_fwd(p) << 16) * 0xC2B2AE3D27D4EB4FULL) >> (64 - hlog));
        case 7: return (uint32_t)(((read64_fwd(p) << 8)  * 0x165667B19E3779F9ULL) >> (64 - hlog));
        case 8: return (uint32_t)((read64_fwd(p) * 0xCF1BBCDCB7A56463ULL) >> (64 - hlog));
        default: {
            uint32_t v; std::memcpy(&v, p, 4);
            return hash32(v, hlog);
        }
    }
}

static inline int64_t count_match(const uint8_t* src, int64_t a, int64_t b,
                                  int64_t end) {
    int64_t len = 0;
    const int64_t n = end - a;
    while (len + 8 <= n) {
        uint64_t x = read_window(src + a + len) ^ read_window(src + b + len);
        if (x) return len + (__builtin_ctzll(x) >> 3);
        len += 8;
    }
    while (len < n && src[a + len] == src[b + len]) len++;
    return len;
}

// Emits sequences for [start, end) of src; table: int64[1<<hlog] holding
// absolute positions (-1 = empty), persists across blocks.
// rep: in/out [2].  Returns nb_seq (capacity guarded) or -1.
//
// Search profile mirrors ZSTD_compressBlock_fast_noDict_generic (ZstdFast.cs:96
// role, re-derived): every position pair (p, p+1) is probed at stride `step`,
// step escalates +1 each 128 bytes without a match, rep0 is probed at p+step,
// and hashes cover `mls` bytes (4..8) while match verification stays 4-byte.
int64_t fast_find_matches(const uint8_t* src, int64_t src_len,
                          int64_t start, int64_t end, int64_t window_start,
                          int64_t window_size,
                          int64_t* table, int hlog, int mls,
                          uint32_t* rep_io,
                          uint32_t* out_ll, uint32_t* out_ml, uint32_t* out_ob,
                          int64_t max_seq, int64_t* out_last_lit,
                          int acceleration) {
    if (end - start < 16) { *out_last_lit = end - start; return 0; }
    const int64_t limit = end - 8;  // read64/read32(+4) safe for p <= limit
    static const int64_t kIncr = getenv("ZT_STEPINCR") ? atoi(getenv("ZT_STEPINCR")) : 384;
    const int64_t step0 = acceleration > 1 ? acceleration + 1 : 2;
    int64_t rep0 = rep_io[0], rep1 = rep_io[1];
    int64_t pos = start + (window_start == 0 && start == 0 ? 1 : 0);
    int64_t anchor = start;
    int64_t n_seq = 0;

    while (n_seq + 4 < max_seq) {
        int64_t step = step0;
        int64_t next_step = pos + kIncr;
        int64_t mp = -1, mc = -1;   // match position / source
        int64_t ml = 0;
        uint32_t ob = 0;

        // search loop: two consecutive probes per stride
        while (pos + 1 <= limit) {
            // rep0 probe at pos + step (ip2 role)
            const int64_t p2 = pos + step;
            if (p2 <= limit && p2 - rep0 >= window_start &&
                read32(src + p2) == read32(src + p2 - rep0)) {
                // the probe position still enters the table (ZstdFast.cs:166)
                table[hash_mls(src + pos, hlog, mls)] = pos;
                mp = p2; mc = p2 - rep0;
                if (mp > anchor && mc > window_start &&
                    src[mp - 1] == src[mc - 1]) { mp--; mc--; }
                ml = (p2 - mp) + 4 +
                     count_match(src, p2 + 4, p2 + 4 - rep0, end);
                ob = 1;
                break;
            }
            // hash probe at pos
            {
                const uint32_t hv = hash_mls(src + pos, hlog, mls);
                const int64_t cand = table[hv];
                table[hv] = pos;
                if (cand >= window_start && cand >= pos - (window_size - 1) &&
                    read32(src + cand) == read32(src + pos)) {
                    mp = pos; mc = cand;
                    break;
                }
            }
            // hash probe at pos + 1
            if (pos + 1 <= limit) {
                const int64_t p1 = pos + 1;
                const uint32_t hv = hash_mls(src + p1, hlog, mls);
                const int64_t cand = table[hv];
                table[hv] = p1;
                if (cand >= window_start && cand >= p1 - (window_size - 1) &&
                    read32(src + cand) == read32(src + p1)) {
                    mp = p1; mc = cand;
                    break;
                }
            }
            pos += step;
            if (pos >= next_step) { step++; next_step += kIncr; }
        }
        if (mp < 0) break;  // no more matches in this block

        if (ob == 0) {  // real offset: backward extend + forward count
            ml = 4 + count_match(src, mp + 4, mc + 4, end);
            while (mp > anchor && mc > window_start &&
                   src[mp - 1] == src[mc - 1]) { mp--; mc--; ml++; }
            const int64_t offset = mp - mc;
            ob = (uint32_t)(offset + 3);
            rep1 = rep0; rep0 = offset;
        }
        out_ll[n_seq] = (uint32_t)(mp - anchor);
        out_ml[n_seq] = (uint32_t)ml;
        out_ob[n_seq] = ob;
        n_seq++;
        pos = mp + ml; anchor = pos;

        if (pos <= limit) {
            // seed the table around the match (ZstdFast.cs:262 role)
            if (mp + 2 <= limit) table[hash_mls(src + mp + 2, hlog, mls)] = mp + 2;
            if (pos - 2 > start) table[hash_mls(src + pos - 2, hlog, mls)] = pos - 2;
            // rep1 continuation
            while (pos <= limit && n_seq < max_seq &&
                   pos - rep1 >= window_start &&
                   read32(src + pos) == read32(src + pos - rep1)) {
                const int64_t ml2 = 4 + count_match(src, pos + 4, pos + 4 - rep1, end);
                const int64_t t = rep0; rep0 = rep1; rep1 = t;
                table[hash_mls(src + pos, hlog, mls)] = pos;
                out_ll[n_seq] = 0; out_ml[n_seq] = (uint32_t)ml2; out_ob[n_seq] = 1;
                n_seq++;
                pos += ml2; anchor = pos;
            }
        }
        if (pos + 1 > limit) break;
    }
    rep_io[0] = (uint32_t)rep0; rep_io[1] = (uint32_t)rep1;
    *out_last_lit = end - anchor;
    return n_seq;
}


// u32 hash-table variant of fast_find_matches (positions stored +1, 0 =
// empty): half the table footprint -> better cache residency for the
// level-1/2 hot path.  Same search profile as the int64 version.
int64_t fast_find_matches32(const uint8_t* src, int64_t src_len,
                            int64_t start, int64_t end, int64_t window_start,
                            int64_t window_size,
                            uint32_t* table, int hlog, int mls,
                            uint32_t* rep_io,
                            uint32_t* out_ll, uint32_t* out_ml, uint32_t* out_ob,
                            int64_t max_seq, int64_t* out_last_lit,
                            int acceleration) {
    if (end - start < 16) { *out_last_lit = end - start; return 0; }
    const int64_t limit = end - 8;
    static const int64_t kIncr32 = getenv("ZT_STEPINCR") ? atoi(getenv("ZT_STEPINCR")) : 384;
    const int64_t step0 = acceleration > 1 ? acceleration + 1 : 2;
    int64_t rep0 = rep_io[0], rep1 = rep_io[1];
    int64_t pos = start + (window_start == 0 && start == 0 ? 1 : 0);
    int64_t anchor = start;
    int64_t n_seq = 0;

    while (n_seq + 4 < max_seq) {
        int64_t step = step0;
        int64_t next_step = pos + kIncr32;
        int64_t mp = -1, mc = -1;
        int64_t ml = 0;
        uint32_t ob = 0;

        while (pos + 1 <= limit) {
            const int64_t p2 = pos + step;
            if (p2 <= limit && p2 - rep0 >= window_start &&
                read32(src + p2) == read32(src + p2 - rep0)) {
                // the probe position still enters the table (ZstdFast.cs:166)
                table[hash_mls(src + pos, hlog, mls)] = (uint32_t)(pos + 1);
                mp = p2; mc = p2 - rep0;
                if (mp > anchor && mc > window_start &&
                    src[mp - 1] == src[mc - 1]) { mp--; mc--; }
                ml = (p2 - mp) + 4 +
                     count_match(src, p2 + 4, p2 + 4 - rep0, end);
                ob = 1;
                break;
            }
            {
                const uint64_t v = read64_fwd(src + pos);
                const uint32_t hv = hash_mls_v(v, hlog, mls);
                const int64_t cand = (int64_t)table[hv] - 1;
                table[hv] = (uint32_t)(pos + 1);
                if (cand >= window_start && cand >= pos - (window_size - 1) &&
                    read32(src + cand) == (uint32_t)v) {
                    mp = pos; mc = cand;
                    break;
                }
            }
            // at acceleration > 1 the paired probe costs more than its
            // finds are worth (the negative levels trade ratio for speed)
            if (acceleration <= 1 && pos + 1 <= limit) {
                const int64_t p1 = pos + 1;
                const uint64_t v = read64_fwd(src + p1);
                const uint32_t hv = hash_mls_v(v, hlog, mls);
                const int64_t cand = (int64_t)table[hv] - 1;
                table[hv] = (uint32_t)(p1 + 1);
                if (cand >= window_start && cand >= p1 - (window_size - 1) &&
                    read32(src + cand) == (uint32_t)v) {
                    mp = p1; mc = cand;
                    break;
                }
            }
            pos += step;
            if (pos >= next_step) { step++; next_step += kIncr32; }
        }
        if (mp < 0) break;

        if (ob == 0) {
            ml = 4 + count_match(src, mp + 4, mc + 4, end);
            while (mp > anchor && mc > window_start &&
                   src[mp - 1] == src[mc - 1]) { mp--; mc--; ml++; }
            const int64_t offset = mp - mc;
            ob = (uint32_t)(offset + 3);
            rep1 = rep0; rep0 = offset;
        }
        out_ll[n_seq] = (uint32_t)(mp - anchor);
        out_ml[n_seq] = (uint32_t)ml;
        out_ob[n_seq] = ob;
        n_seq++;
        pos = mp + ml; anchor = pos;

        if (pos <= limit) {
            if (mp + 2 <= limit) table[hash_mls(src + mp + 2, hlog, mls)] = (uint32_t)(mp + 3);
            if (pos - 2 > start) table[hash_mls(src + pos - 2, hlog, mls)] = (uint32_t)(pos - 1);
            while (pos <= limit && n_seq < max_seq &&
                   pos - rep1 >= window_start &&
                   read32(src + pos) == read32(src + pos - rep1)) {
                const int64_t ml2 = 4 + count_match(src, pos + 4, pos + 4 - rep1, end);
                const int64_t t = rep0; rep0 = rep1; rep1 = t;
                table[hash_mls(src + pos, hlog, mls)] = (uint32_t)(pos + 1);
                out_ll[n_seq] = 0; out_ml[n_seq] = (uint32_t)ml2; out_ob[n_seq] = 1;
                n_seq++;
                pos += ml2; anchor = pos;
            }
        }
        if (pos + 1 > limit) break;
    }
    rep_io[0] = (uint32_t)rep0; rep_io[1] = (uint32_t)rep1;
    *out_last_lit = end - anchor;
    return n_seq;
}

// ---------------------------------------------------------------------------
// Double-fast match finder (levels 3-4; ZstdDoubleFast.cs role)
// ---------------------------------------------------------------------------

static inline uint64_t read64(const uint8_t* p) {
    uint64_t v; std::memcpy(&v, p, 8); return v;
}

static inline uint32_t hash64(uint64_t v, int hlog) {
    return (uint32_t)((v * 0xCF1BBCDCB7A56463ULL) >> (64 - hlog));
}

// tableL: long (8-byte) hash heads; tableS: short (4-byte).  Greedy with
// long-match priority and the lazy "check long at ip+1" trick.
int64_t dfast_find_matches(const uint8_t* src, int64_t src_len,
                           int64_t start, int64_t end, int64_t window_start,
                           int64_t window_size,
                           int64_t* tableL, int hlogL,
                           int64_t* tableS, int hlogS, int mls,
                           uint32_t* rep_io,
                           uint32_t* out_ll, uint32_t* out_ml, uint32_t* out_ob,
                           int64_t max_seq, int64_t* out_last_lit) {
    if (end - start < 16) { *out_last_lit = end - start; return 0; }
    const int64_t limit = end - 8;
    int64_t rep0 = rep_io[0], rep1 = rep_io[1];
    int64_t pos = start + (window_start == 0 && start == 0 ? 1 : 0);
    int64_t anchor = start;
    int64_t n_seq = 0;

    while (pos < limit && n_seq + 4 < max_seq) {
        const uint64_t cur8 = read64(src + pos);
        const uint32_t cur4 = (uint32_t)cur8;
        const uint32_t hL = hash64(cur8, hlogL);
        const uint32_t hS = hash_mls(src + pos, hlogS, mls);
        const int64_t candL = tableL[hL];
        const int64_t candS = tableS[hS];
        tableL[hL] = pos;
        tableS[hS] = pos;
        const int64_t low = pos - (window_size - 1) > window_start
                            ? pos - (window_size - 1) : window_start;

        // rep0 probe at pos+1
        if (pos + 1 < limit && pos + 1 - rep0 >= window_start &&
            read32(src + pos + 1) == read32(src + pos + 1 - rep0)) {
            const int64_t p = pos + 1;
            const int64_t ml = 4 + count_match(src, p + 4, p + 4 - rep0, end);
            out_ll[n_seq] = (uint32_t)(p - anchor);
            out_ml[n_seq] = (uint32_t)ml;
            out_ob[n_seq] = 1;
            n_seq++;
            pos = p + ml; anchor = pos;
            goto dfast_tail;
        }
        {
            int64_t ml = 0, cand = -1;
            if (candL >= low && read64(src + candL) == cur8) {
                ml = 8 + count_match(src, pos + 8, candL + 8, end);
                cand = candL;
            } else if (candS >= low && read32(src + candS) == cur4) {
                // try upgrading via long hash at pos+1
                int64_t c = candS;
                int64_t m = 4 + count_match(src, pos + 4, c + 4, end);
                if (pos + 1 < limit) {
                    const uint64_t nxt8 = read64(src + pos + 1);
                    const uint32_t hL1 = hash64(nxt8, hlogL);
                    const int64_t candL1 = tableL[hL1];
                    tableL[hL1] = pos + 1;
                    if (candL1 >= low && read64(src + candL1) == nxt8) {
                        const int64_t m1 = 8 + count_match(src, pos + 9, candL1 + 8, end);
                        if (m1 > m) { pos += 1; c = candL1; m = m1; }
                    }
                }
                ml = m; cand = c;
            }
            if (ml >= 4) {
                int64_t cc = cand;
                while (pos > anchor && cc > window_start &&
                       src[pos - 1] == src[cc - 1]) { pos--; cc--; ml++; }
                const int64_t offset = pos - cc;
                out_ll[n_seq] = (uint32_t)(pos - anchor);
                out_ml[n_seq] = (uint32_t)ml;
                out_ob[n_seq] = (uint32_t)(offset + 3);
                n_seq++;
                rep1 = rep0; rep0 = offset;
                pos += ml; anchor = pos;
                if (pos + 8 < limit) {
                    tableL[hash64(read64(src + pos - 2), hlogL)] = pos - 2;
                    tableS[hash_mls(src + pos - 2, hlogS, mls)] = pos - 2;
                }
                goto dfast_tail;
            }
        }
        pos += 1 + ((pos - anchor) >> 8);
        continue;

    dfast_tail:
        while (pos < limit && n_seq < max_seq && pos - rep1 >= window_start &&
               read32(src + pos) == read32(src + pos - rep1)) {
            const int64_t ml2 = 4 + count_match(src, pos + 4, pos + 4 - rep1, end);
            const int64_t t = rep0; rep0 = rep1; rep1 = t;
            tableS[hash_mls(src + pos, hlogS, mls)] = pos;
            if (pos + 8 < limit) tableL[hash64(read64(src + pos), hlogL)] = pos;
            out_ll[n_seq] = 0; out_ml[n_seq] = (uint32_t)ml2; out_ob[n_seq] = 1;
            n_seq++;
            pos += ml2; anchor = pos;
        }
    }
    rep_io[0] = (uint32_t)rep0; rep_io[1] = (uint32_t)rep1;
    *out_last_lit = end - anchor;
    return n_seq;
}

// ---------------------------------------------------------------------------
// Hybrid selection: greedy parse over device-provided candidates
// ---------------------------------------------------------------------------

// cand[i] = best previous position with the same hash for block position i
// (computed on the device via the sort-based candidate stage), -1 if none.
// This loop validates, extends, probes repcodes, and emits sequences —
// the serial half of the device/host split.
int64_t hybrid_select(const uint8_t* src, int64_t n_valid,
                      const int32_t* cand, uint32_t* rep_io,
                      uint32_t* out_ll, uint32_t* out_ml, uint32_t* out_ob,
                      int64_t max_seq, int64_t* out_last_lit) {
    if (n_valid < 16) { *out_last_lit = n_valid; return 0; }
    const int64_t limit = n_valid - 8;
    int64_t rep0 = rep_io[0], rep1 = rep_io[1];
    int64_t pos = 1, anchor = 0, n_seq = 0;

    while (pos < limit && n_seq + 4 < max_seq) {
        // rep0 probe at pos+1 (guarantees litLength >= 1)
        if (pos + 1 < limit && pos + 1 - rep0 >= 0 &&
            read32(src + pos + 1) == read32(src + pos + 1 - rep0)) {
            int64_t p = pos + 1;
            int64_t ml = 4 + count_match(src, p + 4, p + 4 - rep0, n_valid);
            out_ll[n_seq] = (uint32_t)(p - anchor);
            out_ml[n_seq] = (uint32_t)ml;
            out_ob[n_seq] = 1;
            n_seq++;
            pos = p + ml; anchor = pos;
            goto rep_continuation;
        }
        {
            int64_t c = cand[pos];
            if (c >= 0 && c < pos && read32(src + c) == read32(src + pos)) {
                int64_t ml = 4 + count_match(src, pos + 4, c + 4, n_valid);
                while (pos > anchor && c > 0 && src[pos - 1] == src[c - 1]) {
                    pos--; c--; ml++;
                }
                const int64_t offset = pos - c;
                out_ll[n_seq] = (uint32_t)(pos - anchor);
                out_ml[n_seq] = (uint32_t)ml;
                out_ob[n_seq] = (uint32_t)(offset + 3);
                n_seq++;
                rep1 = rep0; rep0 = offset;
                pos += ml; anchor = pos;
                goto rep_continuation;
            }
        }
        pos += 1 + ((pos - anchor) >> 6);
        continue;

    rep_continuation:
        while (pos < limit && n_seq < max_seq && pos - rep1 >= 0 &&
               read32(src + pos) == read32(src + pos - rep1)) {
            int64_t ml2 = 4 + count_match(src, pos + 4, pos + 4 - rep1, n_valid);
            int64_t t = rep0; rep0 = rep1; rep1 = t;
            out_ll[n_seq] = 0; out_ml[n_seq] = (uint32_t)ml2; out_ob[n_seq] = 1;
            n_seq++;
            pos += ml2; anchor = pos;
        }
    }
    rep_io[0] = (uint32_t)rep0; rep_io[1] = (uint32_t)rep1;
    *out_last_lit = n_valid - anchor;
    return n_seq;
}

// ---------------------------------------------------------------------------
// Hash-chain lazy match finder (greedy/lazy/lazy2; ZstdLazy.cs:1743 role)
// ---------------------------------------------------------------------------

struct LazyCtx {
    const uint8_t* src;
    int64_t* table;       // hash heads (abs positions, -1 empty)
    int64_t* chain;       // chain links indexed by pos & chain_mask
    int64_t chain_mask;
    int hlog;
    int64_t window_start;
    int64_t window_size;
    int64_t attempts;
    int64_t insert_from;
    int64_t limit;
    int mls = 4;          // hash width (min_match clamped to 4..8)
};

static inline void lazy_insert_upto(LazyCtx* c, int64_t p) {
    int64_t stop = p < c->limit ? p : c->limit;
    for (int64_t i = c->insert_from; i < stop; i++) {
        const uint32_t hv = hash_mls(c->src + i, c->hlog, c->mls);
        c->chain[i & c->chain_mask] = c->table[hv];
        c->table[hv] = i;
    }
    if (stop > c->insert_from) c->insert_from = stop;
}

static inline int64_t lazy_search(LazyCtx* c, int64_t p, int64_t end,
                                  int64_t* best_off) {
    lazy_insert_upto(c, p);
    const uint32_t cur = read32(c->src + p);
    int64_t cand = c->table[hash_mls(c->src + p, c->hlog, c->mls)];
    const int64_t low = (p - (c->window_size - 1)) > c->window_start
                        ? p - (c->window_size - 1) : c->window_start;
    int64_t best_len = 0; *best_off = 0;
    for (int64_t a = 0; a < c->attempts; a++) {
        if (cand < low) break;
        if (read32(c->src + cand) == cur) {
            int64_t len = 4 + count_match(c->src, p + 4, cand + 4, end);
            if (len > best_len) { best_len = len; *best_off = p - cand; }
        }
        int64_t nxt = c->chain[cand & c->chain_mask];
        if (nxt >= cand) break;
        cand = nxt;
    }
    return best_len;
}

static inline int64_t rep_length(const uint8_t* src, int64_t p, int64_t r,
                                 int64_t ws, int64_t end) {
    if (r <= 0 || p - r < ws || p + 4 > end) return 0;
    if (read32(src + p) != read32(src + p - r)) return 0;
    return 4 + count_match(src, p + 4, p + 4 - r, end);
}

// ---------------------------------------------------------------------------
// Binary-tree matcher (ZSTD_updateDUBT / ZSTD_insertBtAndGetAllMatches role)
// ---------------------------------------------------------------------------
//
// Each position is a node of a binary tree of suffixes sharing a hash head;
// node links live in bt[2*(pos & bt_mask)] (smaller) / +1 (larger).  A walk
// simultaneously re-links the tree with the new position as root and
// collects every match that beats the best length so far — the all-matches
// enumeration the optimal parser prices.  A hash3 side table supplies one
// 3-byte candidate at min_match 3 (ZSTD_insertAndFindFirstIndexHash3 role).

struct BtMatch { int64_t len; int64_t off; };

struct BtCtx {
    const uint8_t* src;
    int64_t* table;       // hash heads (abs positions, -1 empty)
    int32_t* bt;          // 2 * (bt_mask + 1) links
    int64_t bt_mask;
    int64_t* h3;          // hash3 heads (most recent position, -1 empty)
    int h3log;
    int hlog;
    int mls;              // hash width for the main table (>= 4)
    int64_t window_start;
    int64_t window_size;
    int64_t attempts;
    int64_t insert_from;
    int64_t limit;        // last insertable position (end - 8)
    int64_t end;          // source end for match extension
    bool skip_in_matches = true;  // nextToUpdate jump (opt: on, btlazy: off)
};

static inline uint32_t hash3_bt(const uint8_t* p, int h3log) {
    uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
    return (v * 2654435761u) >> (32 - h3log);
}

// DUBT scheme (ZSTD_updateDUBT:20 / ZSTD_insertDUBT1:64 /
// ZSTD_DUBT_findBestMatch:223 roles): inserts are O(1) prepends to an
// unsorted per-bucket list (slot0 = next candidate, slot1 = unsorted mark);
// a search reverses the unsorted run, re-inserts each element into the
// sorted tree, then walks the tree collecting matches while re-linking the
// probed position as the new root.  Candidates never searched are never
// sorted.  Position 0 doubles as the null link (never inserted), matching
// the reference's convention; a match is always re-verified by byte
// comparison, so stale links can only cost parse quality, not correctness.

static const int32_t kBtNull = 0;
static const int32_t kBtUnsorted = 1;

static inline void bt_insert_upto(BtCtx* c, int64_t p) {
    const int64_t stop = p < c->limit ? p : c->limit;
    for (int64_t i = c->insert_from; i < stop; i++) {
        if (i == 0) continue;
        const uint32_t hv = hash_mls(c->src + i, c->hlog, c->mls);
        const int64_t head = c->table[hv];
        int32_t* node = &c->bt[2 * (i & c->bt_mask)];
        node[0] = head > 0 ? (int32_t)head : kBtNull;
        node[1] = kBtUnsorted;
        c->table[hv] = i;
        if (c->h3) c->h3[hash3_bt(c->src + i, c->h3log)] = i;
    }
    if (stop > c->insert_from) c->insert_from = stop;
}

// Sort one unsorted position into the subtree hanging off its own chain
// link (ZSTD_insertDUBT1 role).
static void bt_sort_one(BtCtx* c, int64_t curr, int64_t nb_compares,
                        int64_t window_low, int64_t bt_low) {
    const uint8_t* src = c->src;
    int64_t com_s = 0, com_l = 0;
    int32_t* smaller = &c->bt[2 * (curr & c->bt_mask)];
    int32_t* larger = smaller + 1;
    int64_t m_idx = *smaller;
    int32_t dummy;
    while (nb_compares-- > 0 && m_idx > window_low && m_idx < curr) {
        int32_t* nextPtr = &c->bt[2 * (m_idx & c->bt_mask)];
        int64_t m = com_s < com_l ? com_s : com_l;
        m += count_match(src, curr + m, m_idx + m, c->end);
        if (curr + m >= c->end) break;
        if (src[m_idx + m] < src[curr + m]) {
            *smaller = (int32_t)m_idx;
            com_s = m;
            if (m_idx <= bt_low) { smaller = &dummy; break; }
            smaller = nextPtr + 1;
            m_idx = nextPtr[1];
        } else {
            *larger = (int32_t)m_idx;
            com_l = m;
            if (m_idx <= bt_low) { larger = &dummy; break; }
            larger = nextPtr;
            m_idx = nextPtr[0];
        }
    }
    *smaller = kBtNull;
    *larger = kBtNull;
}

// Collect all matches at p with strictly increasing length, sorting the
// pending unsorted candidates first and re-linking p as the new root.
static int bt_get_all_matches(BtCtx* c, int64_t p, int min_match,
                              BtMatch* out, int cap) {
    const uint8_t* src = c->src;
    bt_insert_upto(c, p);
    if (p > c->limit || p == 0) return 0;
    const uint32_t hv = hash_mls(src + p, c->hlog, c->mls);
    const int64_t bt_low = p > c->bt_mask ? p - c->bt_mask : 0;
    const int64_t win_low = (p - (c->window_size - 1)) > c->window_start
                            ? p - (c->window_size - 1) : c->window_start;
    const int64_t unsort_limit = bt_low > win_low ? bt_low : win_low;

    // phase 1: reverse the unsorted run (mark slot becomes back-link)
    int64_t m_idx = c->table[hv] > 0 ? c->table[hv] : 0;
    int64_t prev = 0;
    int64_t nb_compares = c->attempts;
    int64_t nb_cand = nb_compares;
    while (m_idx > unsort_limit &&
           c->bt[2 * (m_idx & c->bt_mask) + 1] == kBtUnsorted && nb_cand > 1) {
        int32_t* node = &c->bt[2 * (m_idx & c->bt_mask)];
        const int64_t nxt = node[0];
        node[1] = (int32_t)prev;
        prev = m_idx;
        m_idx = nxt;
        nb_cand--;
    }
    if (m_idx > unsort_limit &&
        c->bt[2 * (m_idx & c->bt_mask) + 1] == kBtUnsorted) {
        // candidate budget exhausted: drop the older tail
        c->bt[2 * (m_idx & c->bt_mask)] = kBtNull;
        c->bt[2 * (m_idx & c->bt_mask) + 1] = kBtNull;
    }
    // phase 2: sort reversed candidates oldest-first
    m_idx = prev;
    while (m_idx != 0) {
        const int64_t nxt = c->bt[2 * (m_idx & c->bt_mask) + 1];
        bt_sort_one(c, m_idx, nb_cand, win_low, unsort_limit);
        m_idx = nxt;
        nb_cand++;
    }

    int n = 0;
    int64_t best = min_match - 1;
    // hash3 candidate: nearest 3-byte match (only useful while best < 3)
    if (c->h3 && min_match == 3 && p + 3 <= c->end) {
        const uint32_t h3v = hash3_bt(src + p, c->h3log);
        const int64_t cand3 = c->h3[h3v];
        c->h3[h3v] = p;
        if (cand3 >= win_low && cand3 > 0 && cand3 < p &&
            src[cand3] == src[p] && src[cand3 + 1] == src[p + 1] &&
            src[cand3 + 2] == src[p + 2]) {
            const int64_t m = 3 + count_match(src, p + 3, cand3 + 3, c->end);
            if (m > best && n < cap) {
                out[n].len = m; out[n].off = p - cand3; n++;
                best = m;
            }
        }
    }
    // phase 3: tree search + re-link with p as root
    int32_t* smaller = &c->bt[2 * (p & c->bt_mask)];
    int32_t* larger = smaller + 1;
    int64_t com_s = 0, com_l = 0;
    int64_t match_end_idx = p + 9;
    int32_t dummy;
    m_idx = c->table[hv] > 0 ? c->table[hv] : 0;
    c->table[hv] = p;
    while (nb_compares-- > 0 && m_idx > win_low && m_idx < p) {
        int32_t* nextPtr = &c->bt[2 * (m_idx & c->bt_mask)];
        int64_t m = com_s < com_l ? com_s : com_l;
        m += count_match(src, p + m, m_idx + m, c->end);
        if (m > best && n < cap) {
            out[n].len = m; out[n].off = p - m_idx; n++;
            best = m;
            if (m_idx + m > match_end_idx) match_end_idx = m_idx + m;
            if (p + m >= c->end) break;  // cannot extend further
        }
        if (p + m >= c->end) break;
        if (src[m_idx + m] < src[p + m]) {
            *smaller = (int32_t)m_idx;
            com_s = m;
            if (m_idx <= bt_low) { smaller = &dummy; break; }
            smaller = nextPtr + 1;
            m_idx = nextPtr[1];
        } else {
            *larger = (int32_t)m_idx;
            com_l = m;
            if (m_idx <= bt_low) { larger = &dummy; break; }
            larger = nextPtr;
            m_idx = nextPtr[0];
        }
    }
    *smaller = kBtNull;
    *larger = kBtNull;
    // skip re-inserting positions covered by a long match (nextToUpdate role)
    if (c->skip_in_matches && c->insert_from < match_end_idx - 8)
        c->insert_from = match_end_idx - 8;
    if (c->insert_from <= p) c->insert_from = p + 1;
    return n;
}

// ---------------------------------------------------------------------------
// Row-hash matcher (ZSTD_RowFindBestMatch:1101 role): rows of 16 entries,
// one 8-bit tag per entry, SSE2 tag compare -> candidate bitmask.  The
// newest-first probe order comes from a per-row rotating head.
// ---------------------------------------------------------------------------

#include <immintrin.h>

struct RowCtx {
    const uint8_t* src;
    uint32_t* pos;        // [n_rows][16] positions + 1 (0 = empty)
    uint8_t* tags;        // [n_rows][16]
    uint8_t* heads;       // [n_rows] rotating insert cursor
    int row_log;          // log2(n_rows)
    int mls;
    int64_t window_start;
    int64_t window_size;
    int64_t attempts;
    int64_t insert_from;
    int64_t limit;
};

static inline void row_hash(const uint8_t* p, int row_log, int mls,
                            uint32_t* row, uint8_t* tag) {
    // one multiplicative hash supplies both the row and the 8-bit tag
    const uint64_t v = read64_fwd(p);
    uint64_t h;
    switch (mls) {
        case 5: h = (v << 24) * 0x9E3779B185EBCA87ULL; break;
        case 6: h = (v << 16) * 0xC2B2AE3D27D4EB4FULL; break;
        case 7: h = (v << 8) * 0x165667B19E3779F9ULL; break;
        case 8: h = v * 0xCF1BBCDCB7A56463ULL; break;
        default: h = (uint64_t)((uint32_t)v * 2654435761u) << 32; break;
    }
    *row = (uint32_t)(h >> (64 - row_log));
    *tag = (uint8_t)((h >> (64 - row_log - 8)) & 0xFF);
}

static inline void row_insert_one(RowCtx* c, int64_t p) {
    uint32_t row; uint8_t tag;
    row_hash(c->src + p, c->row_log, c->mls, &row, &tag);
    const uint32_t base = row * 16;
    const uint8_t h = (uint8_t)((c->heads[row] - 1) & 15);
    c->heads[row] = h;
    c->tags[base + h] = tag;
    c->pos[base + h] = (uint32_t)(p + 1);
}

static inline void row_insert_upto(RowCtx* c, int64_t p) {
    const int64_t stop = p < c->limit ? p : c->limit;
    for (int64_t i = c->insert_from; i < stop; i++) row_insert_one(c, i);
    if (stop > c->insert_from) c->insert_from = stop;
}

static inline int64_t row_search(RowCtx* c, int64_t p, int64_t end,
                                 int64_t* best_off) {
    row_insert_upto(c, p);
    const uint8_t* src = c->src;
    uint32_t row; uint8_t tag;
    row_hash(src + p, c->row_log, c->mls, &row, &tag);
    const uint32_t base = row * 16;
    const __m128i tags = _mm_loadu_si128((const __m128i*)(c->tags + base));
    const __m128i want = _mm_set1_epi8((char)tag);
    uint32_t mask = (uint32_t)_mm_movemask_epi8(_mm_cmpeq_epi8(tags, want));
    const int64_t low = (p - (c->window_size - 1)) > c->window_start
                        ? p - (c->window_size - 1) : c->window_start;
    const uint32_t cur32 = read32(src + p);
    int64_t best_len = 0;
    *best_off = 0;
    int64_t budget = c->attempts;
    const uint8_t head = c->heads[row];
    // probe newest-first: rotate the mask so bit 0 is the head slot
    mask = ((mask >> head) | (mask << (16 - head))) & 0xFFFF;
    while (mask && budget-- > 0) {
        const int r = __builtin_ctz(mask);
        mask &= mask - 1;
        const int slot = (r + head) & 15;
        const int64_t cand = (int64_t)c->pos[base + slot] - 1;
        if (cand < low || cand >= p) continue;
        if (read32(src + cand) != cur32) continue;
        const int64_t len = 4 + count_match(src, p + 4, cand + 4, end);
        if (len > best_len) {
            best_len = len;
            *best_off = p - cand;
            if (p + len >= end) break;
        }
    }
    // insert p itself
    const uint8_t h = (uint8_t)((head - 1) & 15);
    c->heads[row] = h;
    c->tags[base + h] = tag;
    c->pos[base + h] = (uint32_t)(p + 1);
    if (c->insert_from <= p) c->insert_from = p + 1;
    return best_len;
}

static void row_insert_upto_v(RowCtx* c, int64_t p) { row_insert_upto(c, p); }
static int64_t row_search_v(RowCtx* c, int64_t p, int64_t end, int64_t* off) {
    return row_search(c, p, end, off);
}

// Best single match via the binary tree (ZSTD_DUBT_findBestMatch role).
}  // pause extern "C": templates below

static inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

static inline int64_t bt_search(BtCtx* c, int64_t p, int64_t end,
                                int64_t* best_off) {
    BtMatch mt[32];
    const int nm = bt_get_all_matches(c, p, 4, mt, 32);
    if (nm == 0) { *best_off = 0; return 0; }
    *best_off = mt[nm - 1].off;
    return mt[nm - 1].len;
}

// Lazy parse core, generic over the search backend (hash-chain for
// greedy/lazy/lazy2, binary tree for btlazy2; ZSTD_compressBlock_lazy_generic
// role).  depth 0/1/2 = lookahead.
template <typename Ctx,
          int64_t (*SEARCH)(Ctx*, int64_t, int64_t, int64_t*),
          void (*INSERT)(Ctx*, int64_t)>
static int64_t lazy_core(Ctx* c, const uint8_t* src,
                         int64_t start, int64_t end, int64_t window_start,
                         int depth, uint32_t* rep_io,
                         uint32_t* out_ll, uint32_t* out_ml, uint32_t* out_ob,
                         int64_t max_seq, int64_t* out_last_lit) {
    int64_t rep0 = rep_io[0], rep1 = rep_io[1];
    int64_t pos = start + (window_start == 0 && start == 0 ? 1 : 0);
    int64_t anchor = start;
    int64_t n_seq = 0;
    const int64_t limit = c->limit;

    // Candidate quality is compared in quarter-bit "worth" units:
    // 4*length minus the offset's bit cost (reps charge ~nothing).  A
    // deferred match must beat the held one by a worth margin that grows
    // with lookahead distance, so far offsets stop displacing near/rep
    // matches they barely out-length (decision weights match
    // ZSTD_compressBlock_lazy_generic, ZstdLazy.cs:1233).
    const auto worth = [](int64_t len, int64_t off_raw) {
        const uint32_t ob = off_raw ? (uint32_t)(off_raw + 3) : 1u;
        return 4 * len - (int64_t)highbit32(ob);
    };
    while (pos < limit && n_seq + 2 < max_seq) {
        // Held candidate: rep0 one literal ahead (ll>=1 keeps offset_value
        // 1 meaning rep0 for the decoder), then the backend search here.
        int64_t ml = rep_length(src, pos + 1, rep0, window_start, end);
        int64_t off = 0;
        int64_t mstart = pos + 1;
        if (ml >= 4 && depth == 0) goto _hold;  // greedy takes reps on sight
        {
            int64_t offF;
            const int64_t mlF = SEARCH(c, pos, end, &offF);
            if (mlF > ml) { ml = mlF; off = offF; mstart = pos; }
        }
        if (ml < 4) {
            pos += 1 + ((pos - anchor) >> 8);
            continue;
        }
        // Lookahead: each round steps one position (two at depth 2) and
        // re-bids; rep bids are priced in 3/4-worth at the first step so
        // a same-length rep one byte later still displaces a real offset.
        while (depth > 0 && pos + 1 < limit) {
            pos++;
            {
                const int64_t rl = rep_length(src, pos, rep0, window_start, end);
                if (rl >= 4 && 3 * rl > 3 * ml - highbit32(off ? (uint32_t)(off + 3) : 1u) + 1) {
                    ml = rl; off = 0; mstart = pos;
                }
            }
            {
                int64_t off2;
                const int64_t ml2 = SEARCH(c, pos, end, &off2);
                if (ml2 >= 4 && worth(ml2, off2) > worth(ml, off) + 4) {
                    ml = ml2; off = off2; mstart = pos;
                    continue;  // keep bidding from the new hold
                }
            }
            if (depth == 2 && pos + 1 < limit) {
                pos++;
                {
                    const int64_t rl = rep_length(src, pos, rep0, window_start, end);
                    if (rl >= 4 && 4 * rl > worth(ml, off) + 1) {
                        ml = rl; off = 0; mstart = pos;
                    }
                }
                {
                    int64_t off2;
                    const int64_t ml2 = SEARCH(c, pos, end, &off2);
                    if (ml2 >= 4 && worth(ml2, off2) > worth(ml, off) + 7) {
                        ml = ml2; off = off2; mstart = pos;
                        continue;
                    }
                }
            }
            break;  // no better bid: emit the hold
        }
    _hold:
        if (off > 0) {
            int64_t cand = mstart - off;
            while (mstart > anchor && cand > window_start &&
                   src[mstart - 1] == src[cand - 1]) {
                mstart--; cand--; ml++;
            }
            rep1 = rep0; rep0 = off;
            out_ob[n_seq] = (uint32_t)(off + 3);
        } else {
            out_ob[n_seq] = 1;
        }
        pos = mstart;
        out_ll[n_seq] = (uint32_t)(pos - anchor);
        out_ml[n_seq] = (uint32_t)ml;
        n_seq++;
        pos += ml; anchor = pos;
        INSERT(c, pos);
        while (pos < limit && n_seq < max_seq) {
            int64_t rl2 = rep_length(src, pos, rep1, window_start, end);
            if (rl2 < 4) break;
            int64_t t = rep0; rep0 = rep1; rep1 = t;
            out_ll[n_seq] = 0; out_ml[n_seq] = (uint32_t)rl2; out_ob[n_seq] = 1;
            n_seq++;
            pos += rl2; anchor = pos;
            INSERT(c, pos);
        }
    }
    rep_io[0] = (uint32_t)rep0; rep_io[1] = (uint32_t)rep1;
    *out_last_lit = end - anchor;
    return n_seq;
}

static void lazy_insert_upto_v(LazyCtx* c, int64_t p) { lazy_insert_upto(c, p); }
static void bt_insert_upto_v(BtCtx* c, int64_t p) { bt_insert_upto(c, p); }
static int64_t lazy_search_v(LazyCtx* c, int64_t p, int64_t end, int64_t* off) {
    return lazy_search(c, p, end, off);
}

extern "C" {

int64_t lazy_find_matches(const uint8_t* src, int64_t src_len,
                          int64_t start, int64_t end, int64_t window_start,
                          int64_t window_size,
                          int64_t* table, int hlog,
                          int64_t* chain, int64_t chain_size, int64_t attempts,
                          int depth, int64_t* insert_from_io,
                          uint32_t* rep_io,
                          uint32_t* out_ll, uint32_t* out_ml, uint32_t* out_ob,
                          int64_t max_seq, int64_t* out_last_lit, int mls) {
    if (end - start < 16) { *out_last_lit = end - start; return 0; }
    LazyCtx c{src, table, chain, chain_size - 1, hlog, window_start,
              window_size, attempts, *insert_from_io, end - 8,
              mls < 4 ? 4 : (mls > 8 ? 8 : mls)};
    int64_t n = lazy_core<LazyCtx, lazy_search_v, lazy_insert_upto_v>(
        &c, src, start, end, window_start, depth, rep_io,
        out_ll, out_ml, out_ob, max_seq, out_last_lit);
    *insert_from_io = c.insert_from;
    return n;
}

// Dictionary attach-mode lazy matcher (ZSTD_dictMatchState role,
// ZstdCompress.cs:2738 attach decision; ZstdLazy.cs dictMatchState search):
// the dictionary's hash/chain tables are read-only and shared across
// frames; per-frame state is an epoch-tagged local head table and a local
// chain, so starting a frame costs no table copy or wipe.
struct AttachLazyCtx {
    const uint8_t* src;        // [dict content | frame bytes]
    int64_t clen;              // frame starts at src + clen
    const int64_t* dict_tbl;   // dict hash heads (abs pos, -1 empty)
    const int64_t* dict_chain; // dict chain links (pos & dict_cmask)
    int64_t dict_cmask;
    uint32_t* l_pos;           // local heads (abs pos - clen)
    uint32_t* l_ep;            // epoch tag per local head
    uint32_t epoch;
    int64_t* l_chain;          // local chain links ((pos-clen) & l_cmask)
    int64_t l_cmask;
    int hlog;
    int64_t window_size;
    int64_t attempts;
    int64_t insert_from;
    int64_t limit;
    int mls = 4;
};

static inline void attach_insert_upto(AttachLazyCtx* c, int64_t p) {
    const int64_t stop = p < c->limit ? p : c->limit;
    for (int64_t i = c->insert_from; i < stop; i++) {
        const uint32_t hv = hash_mls(c->src + i, c->hlog, c->mls);
        const int64_t prev = c->l_ep[hv] == c->epoch
                                 ? (int64_t)c->l_pos[hv] + c->clen
                                 : c->dict_tbl[hv];
        c->l_chain[(i - c->clen) & c->l_cmask] = prev;
        c->l_pos[hv] = (uint32_t)(i - c->clen);
        c->l_ep[hv] = c->epoch;
    }
    if (stop > c->insert_from) c->insert_from = stop;
}

static inline int64_t attach_search(AttachLazyCtx* c, int64_t p, int64_t end,
                                    int64_t* best_off) {
    attach_insert_upto(c, p);
    const uint32_t cur = read32(c->src + p);
    const uint32_t hv = hash_mls(c->src + p, c->hlog, c->mls);
    int64_t cand = c->l_ep[hv] == c->epoch ? (int64_t)c->l_pos[hv] + c->clen
                                           : c->dict_tbl[hv];
    const int64_t low = p - (c->window_size - 1) > 0
                            ? p - (c->window_size - 1) : 0;
    int64_t best_len = 0;
    *best_off = 0;
    for (int64_t a = 0; a < c->attempts; a++) {
        if (cand < low) break;
        if (read32(c->src + cand) == cur) {
            const int64_t len = 4 + count_match(c->src, p + 4, cand + 4, end);
            if (len > best_len) { best_len = len; *best_off = p - cand; }
        }
        const int64_t nxt = cand >= c->clen
                                ? c->l_chain[(cand - c->clen) & c->l_cmask]
                                : c->dict_chain[cand & c->dict_cmask];
        if (nxt >= cand) break;
        cand = nxt;
    }
    return best_len;
}

static void attach_insert_upto_v(AttachLazyCtx* c, int64_t p) {
    attach_insert_upto(c, p);
}
static int64_t attach_search_v(AttachLazyCtx* c, int64_t p, int64_t end,
                               int64_t* off) {
    return attach_search(c, p, end, off);
}

static int64_t lazy_attach_find(const uint8_t* all, int64_t start, int64_t end,
                                int64_t clen, int64_t window_size,
                                const int64_t* dict_tbl,
                                const int64_t* dict_chain, int64_t dict_csize,
                                uint32_t* l_pos, uint32_t* l_ep,
                                uint32_t epoch, int64_t* l_chain,
                                int64_t l_csize, int hlog, int64_t attempts,
                                int depth, int64_t* insert_from_io,
                                uint32_t* rep_io, uint32_t* out_ll,
                                uint32_t* out_ml, uint32_t* out_ob,
                                int64_t max_seq, int64_t* out_last_lit,
                                int mls) {
    if (end - start < 16) { *out_last_lit = end - start; return 0; }
    AttachLazyCtx c{all, clen, dict_tbl, dict_chain, dict_csize - 1, l_pos,
                    l_ep, epoch, l_chain, l_csize - 1, hlog, window_size,
                    attempts, *insert_from_io, end - 8,
                    mls < 4 ? 4 : (mls > 8 ? 8 : mls)};
    int64_t n = lazy_core<AttachLazyCtx, attach_search_v, attach_insert_upto_v>(
        &c, all, start, end, 0, depth, rep_io, out_ll, out_ml, out_ob,
        max_seq, out_last_lit);
    *insert_from_io = c.insert_from;
    return n;
}

extern "C" {
// Row-matcher lazy parse (ZSTD_RowFindBestMatch under the lazy driver;
// levels 5-12 default in the reference).  pos/tags/heads persist across
// blocks like the other tables.
int64_t row_lazy_find_matches(const uint8_t* src, int64_t src_len,
                              int64_t start, int64_t end, int64_t window_start,
                              int64_t window_size,
                              uint32_t* row_pos, uint8_t* row_tags,
                              uint8_t* row_heads, int row_log, int mls,
                              int64_t attempts, int depth,
                              int64_t* insert_from_io, uint32_t* rep_io,
                              uint32_t* out_ll, uint32_t* out_ml,
                              uint32_t* out_ob,
                              int64_t max_seq, int64_t* out_last_lit) {
    if (end - start < 16) { *out_last_lit = end - start; return 0; }
    RowCtx c{src, row_pos, row_tags, row_heads, row_log,
             mls < 4 ? 4 : (mls > 8 ? 8 : mls), window_start, window_size,
             attempts, *insert_from_io, end - 8};
    int64_t n = lazy_core<RowCtx, row_search_v, row_insert_upto_v>(
        &c, src, start, end, window_start, depth, rep_io,
        out_ll, out_ml, out_ob, max_seq, out_last_lit);
    *insert_from_io = c.insert_from;
    return n;
}
}  // extern "C"

// btlazy2 (ZSTD_compressBlock_btlazy2 role): lazy depth-2 parse over the
// binary-tree best-match search.
int64_t btlazy_find_matches(const uint8_t* src, int64_t src_len,
                            int64_t start, int64_t end, int64_t window_start,
                            int64_t window_size,
                            int64_t* table, int hlog,
                            int32_t* bt, int64_t bt_size, int64_t attempts,
                            int depth, int64_t* insert_from_io,
                            uint32_t* rep_io,
                            uint32_t* out_ll, uint32_t* out_ml, uint32_t* out_ob,
                            int64_t max_seq, int64_t* out_last_lit) {
    if (end - start < 16) { *out_last_lit = end - start; return 0; }
    BtCtx c{src, table, bt, bt_size - 1, nullptr, 0, hlog, 4, window_start,
            window_size, attempts, *insert_from_io, end - 8, end, false};
    int64_t n = lazy_core<BtCtx, bt_search, bt_insert_upto_v>(
        &c, src, start, end, window_start, depth, rep_io,
        out_ll, out_ml, out_ob, max_seq, out_last_lit);
    *insert_from_io = c.insert_from;
    return n;
}


// ---------------------------------------------------------------------------
// Bitstream writer + FSE sequence encode
// ---------------------------------------------------------------------------

struct BitWriterC {
    uint8_t* out;
    int64_t  cap;
    int64_t  nbytes;
    uint64_t acc;
    int      nbits;
};

// Drain whole bytes from the accumulator.  Fast path: one unaligned 8-byte
// store per ~7 bytes of output (BIT_flushBits role); falls back to byte
// stores near the capacity limit.
static inline int bw_flush(BitWriterC* w) {
    const int bytes = w->nbits >> 3;
    if (bytes == 0) return 0;
    if (w->nbytes + 8 <= w->cap) {
        std::memcpy(w->out + w->nbytes, &w->acc, 8);
        w->nbytes += bytes;
        w->acc = bytes >= 8 ? 0 : w->acc >> (bytes * 8);  // >>64 is UB
        w->nbits &= 7;
        return 0;
    }
    while (w->nbits >= 8) {
        if (w->nbytes >= w->cap) return -1;
        w->out[w->nbytes++] = (uint8_t)(w->acc & 0xFF);
        w->acc >>= 8;
        w->nbits -= 8;
    }
    return 0;
}

static inline int bw_add(BitWriterC* w, uint64_t v, int n) {
    if (n == 0) return 0;  // zero-width field: a shift by nbits==64 is UB
    if (w->nbits + n > 64) {
        if (bw_flush(w)) return -1;   // leaves nbits <= 7
    }
    w->acc |= (v & ((n >= 64) ? ~0ULL : ((1ULL << n) - 1))) << w->nbits;
    w->nbits += n;
    return 0;
}

static inline int64_t bw_close(BitWriterC* w) {
    if (bw_add(w, 1, 1)) return -1;
    if (bw_flush(w)) return -1;
    if (w->nbits) {
        if (w->nbytes >= w->cap) return -1;
        w->out[w->nbytes++] = (uint8_t)(w->acc & ((1u << w->nbits) - 1));
        w->acc = 0; w->nbits = 0;
    }
    return w->nbytes;
}

struct FseEnc {
    const uint16_t* state_table;
    const uint32_t* delta_nb;
    const int32_t*  delta_fs;
    uint32_t value;
    int table_log;
};

static inline void fse_init(FseEnc* e, uint32_t sym) {
    uint32_t nb = (e->delta_nb[sym] + (1u << 15)) >> 16;
    uint32_t v = (nb << 16) - e->delta_nb[sym];
    e->value = e->state_table[(v >> nb) + e->delta_fs[sym]];
}

static inline int fse_enc(FseEnc* e, BitWriterC* w, uint32_t sym) {
    uint32_t nb = (e->value + e->delta_nb[sym]) >> 16;
    if (bw_add(w, e->value, (int)nb)) return -1;
    e->value = e->state_table[(e->value >> nb) + e->delta_fs[sym]];
    return 0;
}

// Encode the interleaved sequence bitstream.  ll/mlv are raw values
// (litLength, matchLength-3), ob = offBase.  Code arrays + extra-bit width
// tables supplied by caller.  Returns payload size or -1.
__attribute__((optimize("O3")))
int64_t encode_sequences(
    const uint32_t* ll, const uint32_t* mlv, const uint32_t* ob,
    const uint8_t* llc, const uint8_t* mlc, const uint8_t* ofc,
    const uint8_t* ll_bits_tab, const uint8_t* ml_bits_tab,
    int64_t nb_seq,
    const uint16_t* ll_st, const uint32_t* ll_dnb, const int32_t* ll_dfs, int ll_log,
    const uint16_t* of_st, const uint32_t* of_dnb, const int32_t* of_dfs, int of_log,
    const uint16_t* ml_st, const uint32_t* ml_dnb, const int32_t* ml_dfs, int ml_log,
    uint8_t* out, int64_t out_cap) {

    BitWriterC w{out, out_cap, 0, 0, 0};
    FseEnc e_ll{ll_st, ll_dnb, ll_dfs, 0, ll_log};
    FseEnc e_of{of_st, of_dnb, of_dfs, 0, of_log};
    FseEnc e_ml{ml_st, ml_dnb, ml_dfs, 0, ml_log};

    const int64_t n = nb_seq;
    fse_init(&e_ml, mlc[n - 1]);
    fse_init(&e_of, ofc[n - 1]);
    fse_init(&e_ll, llc[n - 1]);
    if (bw_add(&w, ll[n - 1], ll_bits_tab[llc[n - 1]])) return -1;
    if (bw_add(&w, mlv[n - 1], ml_bits_tab[mlc[n - 1]])) return -1;
    if (bw_add(&w, ob[n - 1], ofc[n - 1])) return -1;
    if (bw_flush(&w)) return -1;

    // Register-resident hot loop: two unconditional 8-byte flushes per
    // sequence (state bits + ll extra <= 49 bits incl. residue, ml + ob
    // extras <= 54), one capacity check and one fused table load per
    // channel per sequence.
    {
        uint64_t acc = w.acc;
        int nb = w.nbits;
        uint8_t* o = w.out + w.nbytes;
        uint8_t* const oend = w.out + w.cap - 16;
        uint32_t v_of = e_of.value, v_ml = e_ml.value, v_ll = e_ll.value;
        // fused (delta_nb | (delta_fs+32768)<<32) per symbol, built locally
        // (the export ABI carries split arrays)
        uint64_t of_f[64], ml_f[64], ll_f[64];
        for (int sy = 0; sy < 64; sy++) {
            of_f[sy] = (uint64_t)of_dnb[sy & 31] |
                       ((uint64_t)(uint32_t)(of_dfs[sy & 31] + 32768) << 32);
            ml_f[sy] = (uint64_t)ml_dnb[sy % 53] |
                       ((uint64_t)(uint32_t)(ml_dfs[sy % 53] + 32768) << 32);
            ll_f[sy] = (uint64_t)ll_dnb[sy % 36] |
                       ((uint64_t)(uint32_t)(ll_dfs[sy % 36] + 32768) << 32);
        }
        for (int64_t i = n - 2; i >= 0; i--) {
            if (o >= oend) return -1;
            const uint32_t co = ofc[i], cm = mlc[i], cl = llc[i];
            const uint64_t fo = of_f[co], fm = ml_f[cm], fl = ll_f[cl];
            // state emissions (order: of, ml, ll)
            uint32_t b;
            b = (v_of + (uint32_t)fo) >> 16;
            acc |= (uint64_t)(v_of & ((1u << b) - 1)) << nb; nb += (int)b;
            v_of = of_st[(v_of >> b) + (int32_t)((uint32_t)(fo >> 32)) - 32768];
            b = (v_ml + (uint32_t)fm) >> 16;
            acc |= (uint64_t)(v_ml & ((1u << b) - 1)) << nb; nb += (int)b;
            v_ml = ml_st[(v_ml >> b) + (int32_t)((uint32_t)(fm >> 32)) - 32768];
            b = (v_ll + (uint32_t)fl) >> 16;
            acc |= (uint64_t)(v_ll & ((1u << b) - 1)) << nb; nb += (int)b;
            v_ll = ll_st[(v_ll >> b) + (int32_t)((uint32_t)(fl >> 32)) - 32768];
            // ll extra
            const int lb = ll_bits_tab[cl];
            acc |= (uint64_t)(ll[i] & ((lb >= 32) ? 0xFFFFFFFFu : ((1u << lb) - 1))) << nb;
            nb += lb;
            std::memcpy(o, &acc, 8); o += nb >> 3;
            acc = (nb & ~7) >= 64 ? 0 : acc >> (nb & ~7); nb &= 7;
            // ml + ob extras
            const int mb = ml_bits_tab[cm];
            acc |= (uint64_t)(mlv[i] & ((1u << mb) - 1)) << nb; nb += mb;
            acc |= (uint64_t)(ob[i] & ((co >= 32) ? ~0u : ((1u << co) - 1))) << nb;
            nb += (int)co;
            std::memcpy(o, &acc, 8); o += nb >> 3;
            acc = (nb & ~7) >= 64 ? 0 : acc >> (nb & ~7); nb &= 7;
        }
        w.acc = acc; w.nbits = nb; w.nbytes = o - w.out;
        e_of.value = v_of; e_ml.value = v_ml; e_ll.value = v_ll;
    }
    if (bw_add(&w, e_ml.value, ml_log)) return -1;
    if (bw_add(&w, e_of.value, of_log)) return -1;
    if (bw_add(&w, e_ll.value, ll_log)) return -1;
    return bw_close(&w);
}

// Huffman 1X encode: symbols back-to-front through the bit writer.
int64_t huf_encode_stream(const uint8_t* symbols, int64_t n,
                          const uint16_t* code, const uint8_t* nbits,
                          uint8_t* out, int64_t out_cap) {
    BitWriterC w{out, out_cap, 0, 0, 0};
    for (int64_t i = n - 1; i >= 0; i--) {
        const uint8_t s = symbols[i];
        if (bw_add(&w, code[s], nbits[s])) return -1;
    }
    return bw_close(&w);
}

// Encode the standard 4-segment split with the four bit-writers advancing in
// lockstep (independent accumulator chains = ILP).  Writes jump table +
// streams into payload; returns total payload size, -1 on error/overflow.
int64_t huf_encode_4streams(const uint8_t* lit, int64_t n,
                            const uint16_t* code, const uint8_t* nbits,
                            uint8_t* payload, int64_t cap) {
    const int64_t seg = (n + 3) / 4;
    const int64_t len[4] = {seg, seg, seg, n - 3 * seg};
    if (len[3] <= 0) return -1;
    uint32_t enc[256];
    for (int s = 0; s < 256; s++)
        enc[s] = (uint32_t)code[s] | ((uint32_t)nbits[s] << 16);
    const int64_t scap = (seg * 11) / 8 + 64;  // worst case: 11 bits/symbol
    uint8_t* scratch = (uint8_t*)malloc((size_t)(4 * scap));
    if (!scratch) return -1;
    BitWriterC w[4];
    const uint8_t* base[4];
    for (int k = 0; k < 4; k++) {
        w[k] = BitWriterC{scratch + k * scap, scap, 0, 0, 0};
        base[k] = lit + k * seg;
    }
    // stream 3 may be up to 3 symbols shorter; drain the longer tails first
    const int64_t rounds = len[3];
    int rc = 0;
    for (int k = 0; k < 3 && rc == 0; k++)
        for (int64_t i = len[k] - 1; i >= rounds && rc == 0; i--) {
            const uint32_t e = enc[base[k][i]];
            rc = bw_add(&w[k], e & 0xFFFF, (int)(e >> 16));
        }
    // 5 unconditional adds per flush: 5*11 bits + 7 residual <= 62, so no
    // per-symbol overflow checks are needed between flushes.  Drain any
    // residue from the tail loop first (bw_add can leave up to 64 bits),
    // then run the lockstep rounds on register-resident writer state.
    for (int k = 0; k < 4; k++) rc |= bw_flush(&w[k]);
    int64_t r = rounds;
    if (rc == 0) {
        uint64_t a0 = w[0].acc, a1 = w[1].acc, a2 = w[2].acc, a3 = w[3].acc;
        int n0 = w[0].nbits, n1 = w[1].nbits, n2 = w[2].nbits, n3 = w[3].nbits;
        uint8_t* o0 = w[0].out + w[0].nbytes;
        uint8_t* o1 = w[1].out + w[1].nbytes;
        uint8_t* o2 = w[2].out + w[2].nbytes;
        uint8_t* o3 = w[3].out + w[3].nbytes;
        const uint8_t* b0 = base[0];
        const uint8_t* b1 = base[1];
        const uint8_t* b2 = base[2];
        const uint8_t* b3 = base[3];
        while (r >= 5) {
            for (int j = 0; j < 5; j++) {
                const int64_t i = r - 1 - j;
                const uint32_t e0 = enc[b0[i]];
                const uint32_t e1 = enc[b1[i]];
                const uint32_t e2 = enc[b2[i]];
                const uint32_t e3 = enc[b3[i]];
                a0 |= (uint64_t)(e0 & 0xFFFF) << n0; n0 += (int)(e0 >> 16);
                a1 |= (uint64_t)(e1 & 0xFFFF) << n1; n1 += (int)(e1 >> 16);
                a2 |= (uint64_t)(e2 & 0xFFFF) << n2; n2 += (int)(e2 >> 16);
                a3 |= (uint64_t)(e3 & 0xFFFF) << n3; n3 += (int)(e3 >> 16);
            }
            // scratch segments have 64B slack: unchecked 8-byte stores
            std::memcpy(o0, &a0, 8); o0 += n0 >> 3; a0 >>= (n0 & ~7); n0 &= 7;
            std::memcpy(o1, &a1, 8); o1 += n1 >> 3; a1 >>= (n1 & ~7); n1 &= 7;
            std::memcpy(o2, &a2, 8); o2 += n2 >> 3; a2 >>= (n2 & ~7); n2 &= 7;
            std::memcpy(o3, &a3, 8); o3 += n3 >> 3; a3 >>= (n3 & ~7); n3 &= 7;
            r -= 5;
        }
        w[0].acc = a0; w[0].nbits = n0; w[0].nbytes = o0 - w[0].out;
        w[1].acc = a1; w[1].nbits = n1; w[1].nbytes = o1 - w[1].out;
        w[2].acc = a2; w[2].nbits = n2; w[2].nbytes = o2 - w[2].out;
        w[3].acc = a3; w[3].nbits = n3; w[3].nbytes = o3 - w[3].out;
    }
    while (r > 0 && rc == 0) {
        const int64_t i = r - 1;
        for (int k = 0; k < 4; k++) {
            const uint32_t e = enc[base[k][i]];
            rc |= bw_add(&w[k], e & 0xFFFF, (int)(e >> 16));
        }
        r--;
    }
    if (rc) { free(scratch); return -1; }
    int64_t sizes[4];
    int64_t total = 6;
    for (int k = 0; k < 4; k++) {
        sizes[k] = bw_close(&w[k]);
        if (sizes[k] < 0 || (k < 3 && sizes[k] > 65535)) { free(scratch); return -1; }
        total += sizes[k];
    }
    if (total > cap) { free(scratch); return -1; }
    for (int k = 0; k < 3; k++) {
        payload[2 * k] = (uint8_t)sizes[k];
        payload[2 * k + 1] = (uint8_t)(sizes[k] >> 8);
    }
    int64_t off = 6;
    for (int k = 0; k < 4; k++) {
        std::memcpy(payload + off, scratch + k * scap, (size_t)sizes[k]);
        off += sizes[k];
    }
    free(scratch);
    return total;
}

// XXH64 (frame checksums; used when the Python xxhash module is absent).
uint64_t xxh64(const uint8_t* p, int64_t len, uint64_t seed) {
    const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;
    const uint8_t* end = p + len;
    uint64_t h;
    auto rotl = [](uint64_t x, int r) { return (x << r) | (x >> (64 - r)); };
    auto round = [&](uint64_t acc, uint64_t inp) {
        acc += inp * P2; acc = rotl(acc, 31); return acc * P1;
    };
    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        do {
            v1 = round(v1, read_window(p)); p += 8;
            v2 = round(v2, read_window(p)); p += 8;
            v3 = round(v3, read_window(p)); p += 8;
            v4 = round(v4, read_window(p)); p += 8;
        } while (p + 32 <= end);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = (h ^ round(0, v1)) * P1 + P4;
        h = (h ^ round(0, v2)) * P1 + P4;
        h = (h ^ round(0, v3)) * P1 + P4;
        h = (h ^ round(0, v4)) * P1 + P4;
    } else {
        h = seed + P5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        h ^= round(0, read_window(p));
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        uint32_t v; std::memcpy(&v, p, 4);
        h ^= (uint64_t)v * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p) * P5;
        h = rotl(h, 11) * P1;
        p++;
    }
    h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
    return h;
}


// ===========================================================================
// Full block codec: entropy table construction, literals & sequences
// sections, whole-frame encode/decode loops.
//
// Encode mirrors zstdsharp_tpu/encode/block.py (the reference path);
// decode mirrors zstdsharp_tpu/decode/block.py.  Python remains the
// correctness oracle; these loops are the production host engine.
// ===========================================================================

#include <cstdlib>

// ------------------------- format constant tables -------------------------

static const uint32_t kLLBase[36] = {
    0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,18,20,22,24,28,32,40,48,64,
    0x80,0x100,0x200,0x400,0x800,0x1000,0x2000,0x4000,0x8000,0x10000};
static const uint8_t kLLBits[36] = {
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1,2,2,3,3,4,6,7,8,9,10,11,12,13,14,15,16};
static const int16_t kLLNorm[36] = {
    4,3,2,2,2,2,2,2,2,2,2,2,2,1,1,1,2,2,2,2,2,2,2,2,2,3,2,1,1,1,1,1,-1,-1,-1,-1};
static const uint32_t kMLBase[53] = {
    3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,21,22,23,24,25,26,27,28,29,30,
    31,32,33,34,35,37,39,41,43,47,51,59,67,83,99,131,259,515,1027,2051,4099,8195,
    16387,32771,65539};
static const uint8_t kMLBits[53] = {
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    1,1,1,1,2,2,3,3,4,4,5,7,8,9,10,11,12,13,14,15,16};
static const int16_t kMLNorm[53] = {
    1,4,3,2,2,2,2,2,2,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,
    1,1,1,1,1,1,1,1,1,1,1,1,1,-1,-1,-1,-1,-1,-1,-1};
static const int16_t kOFNorm[29] = {
    1,1,1,1,1,1,2,2,2,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,-1,-1,-1,-1,-1};
static uint32_t kOFBase[32];
static uint8_t kOFBits[32];
static const uint32_t kRtb[8] = {0, 473195, 504333, 520860, 550000,
                                 700000, 750000, 830000};
enum { kLLNormLog = 6, kMLNormLog = 6, kOFNormLog = 5 };
enum { kMaxLL = 35, kMaxML = 52, kMaxOFF = 31, kDefaultMaxOFF = 28 };
enum { kLLFseLog = 9, kMLFseLog = 9, kOFFseLog = 8 };


// ----------------------------- FSE encode side ----------------------------

static int fse_min_table_log(int64_t src_size, int max_sym) {
    int min_src = highbit32((uint32_t)src_size) + 1;
    int min_sym = highbit32((uint32_t)(max_sym > 0 ? max_sym : 1)) + 2;
    return min_src < min_sym ? min_src : min_sym;
}

static int fse_optimal_table_log(int max_tlog, int64_t src_size, int max_sym) {
    int tlog = max_tlog ? max_tlog : 11;
    int max_bits_src = highbit32((uint32_t)(src_size - 1)) - 2;
    if (max_bits_src < tlog) tlog = max_bits_src;
    int mb = fse_min_table_log(src_size, max_sym);
    if (mb > tlog) tlog = mb;
    if (tlog < 5) tlog = 5;
    if (tlog > 12) tlog = 12;
    return tlog;
}

// Exact port of FSE_normalizeCount + M2 fallback.  Returns 0 / -1.
static int fse_normalize(int16_t* norm, int tlog, const uint32_t* count,
                         int64_t total, int max_sym, int use_low_prob) {
    const int16_t low_prob = use_low_prob ? -1 : 1;
    const int scale = 62 - tlog;
    const uint64_t step = (1ULL << 62) / (uint64_t)total;
    const uint64_t v_step = 1ULL << (scale - 20);
    int64_t still = 1 << tlog;
    int largest = 0;
    int16_t largest_p = 0;
    uint32_t low_thresh = (uint32_t)(total >> tlog);
    for (int s = 0; s <= max_sym; s++) {
        if (count[s] == (uint64_t)total) return -1;  // RLE upstream
        if (count[s] == 0) { norm[s] = 0; continue; }
        if (count[s] <= low_thresh) {
            norm[s] = low_prob; still--; continue;
        }
        int16_t proba = (int16_t)(((uint64_t)count[s] * step) >> scale);
        if (proba < 8) {
            uint64_t rtb = v_step * kRtb[proba];
            if ((uint64_t)count[s] * step - ((uint64_t)proba << scale) > rtb) proba++;
        }
        if (proba > largest_p) { largest_p = proba; largest = s; }
        norm[s] = proba;
        still -= proba;
    }
    if (-still >= (norm[largest] >> 1)) {
        // M2 fallback
        const int16_t NOT_YET = -2;
        int64_t tot = total;
        int distributed = 0;
        uint32_t low1 = (uint32_t)((tot * 3) >> (tlog + 1));
        for (int s = 0; s <= max_sym; s++) {
            if (count[s] == 0) { norm[s] = 0; continue; }
            if (count[s] <= low_thresh) { norm[s] = low_prob; distributed++; tot -= count[s]; continue; }
            if (count[s] <= low1) { norm[s] = 1; distributed++; tot -= count[s]; continue; }
            norm[s] = NOT_YET;
        }
        int64_t to_dist = (1 << tlog) - distributed;
        if (to_dist == 0) return 0;
        if (to_dist && (tot / to_dist) > low1) {
            low1 = (uint32_t)((tot * 3) / (to_dist * 2));
            for (int s = 0; s <= max_sym; s++) {
                if (norm[s] == NOT_YET && count[s] <= low1) {
                    norm[s] = 1; distributed++; tot -= count[s];
                }
            }
            to_dist = (1 << tlog) - distributed;
        }
        if (distributed == max_sym + 1) {
            uint32_t maxC = 0; int maxV = 0;
            for (int s = 0; s <= max_sym; s++)
                if (count[s] > maxC) { maxC = count[s]; maxV = s; }
            norm[maxV] += (int16_t)to_dist;
            return 0;
        }
        if (tot == 0) {
            for (int s = 0; to_dist > 0; s = (s + 1) % (max_sym + 1))
                if (norm[s] > 0) { to_dist--; norm[s]++; }
            return 0;
        }
        const int vlog = 62 - tlog;
        const uint64_t mid = (1ULL << (vlog - 1)) - 1;
        const uint64_t r_step = ((1ULL << vlog) * (uint64_t)to_dist + mid) / (uint64_t)tot;
        uint64_t tmp_tot = mid;
        for (int s = 0; s <= max_sym; s++) {
            if (norm[s] == NOT_YET) {
                uint64_t end = tmp_tot + count[s] * r_step;
                uint32_t w = (uint32_t)((end >> vlog) - (tmp_tot >> vlog));
                if (w < 1) return -1;
                norm[s] = (int16_t)w;
                tmp_tot = end;
            }
        }
        return 0;
    }
    norm[largest] += (int16_t)still;
    return 0;
}

// NCount serialization; returns bytes written or -1.
static int64_t fse_write_ncount(uint8_t* out, int64_t cap, const int16_t* norm,
                                int max_sym, int tlog) {
    int64_t nbytes = 0;
    uint64_t acc = 0;
    int bit_count = 0;
    auto push = [&](uint32_t v, int nbits) -> int {
        acc |= (uint64_t)(v & ((1u << nbits) - 1)) << bit_count;
        bit_count += nbits;
        while (bit_count >= 16) {
            if (nbytes + 2 > cap) return -1;
            out[nbytes++] = (uint8_t)acc;
            out[nbytes++] = (uint8_t)(acc >> 8);
            acc >>= 16;
            bit_count -= 16;
        }
        return 0;
    };
    const int tsize = 1 << tlog;
    if (push(tlog - 5, 4)) return -1;
    int remaining = tsize + 1;
    int threshold = tsize;
    int nb_bits = tlog + 1;
    int symbol = 0;
    bool prev0 = false;
    while (remaining > 1) {
        if (prev0) {
            int start = symbol;
            while (symbol <= max_sym && norm[symbol] == 0) symbol++;
            if (symbol > max_sym) return -1;
            while (symbol >= start + 24) { start += 24; if (push(0xFFFF, 16)) return -1; }
            while (symbol >= start + 3) { start += 3; if (push(3, 2)) return -1; }
            if (push(symbol - start, 2)) return -1;
        }
        int count = norm[symbol++];
        const int capv = (2 * threshold - 1) - remaining;
        remaining -= count < 0 ? -count : count;
        count++;
        if (count >= threshold) count += capv;
        if (push((uint32_t)count, count >= capv ? nb_bits : nb_bits - 1)) return -1;
        prev0 = (count == 1);
        if (remaining < 1) return -1;
        while (remaining < threshold) { nb_bits--; threshold >>= 1; }
    }
    while (bit_count > 0) {
        if (nbytes >= cap) return -1;
        out[nbytes++] = (uint8_t)acc;
        acc >>= 8;
        bit_count -= 8;
    }
    return nbytes;
}

// NCount parse (forward bitstream).  Returns bytes consumed or -1.
static int64_t fse_read_ncount(int16_t* norm, int* max_sym_out, int* tlog_out,
                               const uint8_t* src, int64_t size,
                               int max_sym_limit, int max_tlog) {
    if (size < 1) return -1;
    uint8_t padded[512 + 8];
    int64_t n = size < 512 ? size : 512;
    std::memcpy(padded, src, (size_t)n);
    std::memset(padded + n, 0, 8);
    auto field = [&](int64_t bitpos, int nbits) -> uint32_t {
        uint64_t w = read_window(padded + (bitpos >> 3));
        return (uint32_t)((w >> (bitpos & 7)) & ((1u << nbits) - 1));
    };
    int64_t bitpos = 0;
    int tlog = (int)field(0, 4) + 5;
    bitpos = 4;
    if (tlog > max_tlog) return -1;
    int remaining = (1 << tlog) + 1;
    int threshold = 1 << tlog;
    int nb_bits = tlog + 1;
    int charnum = 0;
    bool prev0 = false;
    std::memset(norm, 0, sizeof(int16_t) * (max_sym_limit + 1));
    const int64_t max_bits = size * 8 + 7;
    while (remaining > 1 && charnum <= max_sym_limit) {
        if (prev0) {
            int n0 = charnum;
            while (field(bitpos, 16) == 0xFFFF) {
                n0 += 24; bitpos += 16;
                if (bitpos > max_bits) return -1;
            }
            while (field(bitpos, 2) == 3) {
                n0 += 3; bitpos += 2;
                if (bitpos > max_bits) return -1;
            }
            n0 += field(bitpos, 2);
            bitpos += 2;
            if (n0 > max_sym_limit) return -1;
            charnum = n0;
        }
        const int capv = 2 * threshold - 1 - remaining;
        int count = (int)field(bitpos, nb_bits);
        if ((count & (threshold - 1)) < capv) {
            count &= threshold - 1;
            bitpos += nb_bits - 1;
        } else {
            if (count >= threshold) count -= capv;
            bitpos += nb_bits;
        }
        count--;
        remaining -= count < 0 ? -count : count;
        if (charnum > max_sym_limit) return -1;
        norm[charnum++] = (int16_t)count;
        prev0 = (count == 0);
        while (remaining < threshold) { nb_bits--; threshold >>= 1; }
        if (bitpos > max_bits) return -1;
    }
    if (remaining != 1) return -1;
    if (bitpos > size * 8) return -1;
    *max_sym_out = charnum - 1;
    *tlog_out = tlog;
    return (bitpos + 7) >> 3;
}

// Symbol spread shared by table builds.
static void fse_spread(const int16_t* norm, int max_sym, int tlog,
                       uint8_t* table_sym) {
    const int tsize = 1 << tlog;
    const int mask = tsize - 1;
    const int step = (tsize >> 1) + (tsize >> 3) + 3;
    int high = tsize - 1;
    for (int s = 0; s <= max_sym; s++)
        if (norm[s] == -1) table_sym[high--] = (uint8_t)s;
    int position = 0;
    for (int s = 0; s <= max_sym; s++) {
        for (int i = 0; i < norm[s]; i++) {
            table_sym[position] = (uint8_t)s;
            position = (position + step) & mask;
            while (position > high) position = (position + step) & mask;
        }
    }
}

struct FseCTableC {
    uint16_t state_table[1 << 12];
    uint32_t delta_nb[256];
    int32_t delta_fs[256];
    int tlog;
};

static void fse_build_ctable_c(FseCTableC* ct, const int16_t* norm,
                               int max_sym, int tlog) {
    const int tsize = 1 << tlog;
    ct->tlog = tlog;
    uint8_t tsym[1 << 12];
    fse_spread(norm, max_sym, tlog, tsym);
    int cumul[257];
    cumul[0] = 0;
    for (int s = 1; s <= max_sym + 1; s++) {
        int prev = norm[s - 1];
        cumul[s] = cumul[s - 1] + (prev == -1 ? 1 : (prev > 0 ? prev : 0));
    }
    for (int u = 0; u < tsize; u++)
        ct->state_table[cumul[tsym[u]]++] = (uint16_t)(tsize + u);
    int total = 0;
    for (int s = 0; s <= max_sym; s++) {
        const int n = norm[s];
        if (n == 0) {
            ct->delta_nb[s] = ((tlog + 1) << 16) - tsize;
            ct->delta_fs[s] = 0;
        } else if (n == -1 || n == 1) {
            ct->delta_nb[s] = (tlog << 16) - tsize;
            ct->delta_fs[s] = total - 1;
            total++;
        } else {
            const int mbo = tlog - highbit32((uint32_t)(n - 1));
            ct->delta_nb[s] = (uint32_t)((mbo << 16) - (n << mbo));
            ct->delta_fs[s] = total - n;
            total += n;
        }
    }
}

struct FseDTableC {
    uint32_t base[1 << 10];
    uint8_t add_bits[1 << 10];
    uint16_t next_state[1 << 10];
    uint8_t state_bits[1 << 10];
    // base | add<<32 | next_state<<40 | state_bits<<56 — one load per step
    uint64_t fused[1 << 10];
    int tlog;
};

static void fse_fuse_dtable(FseDTableC* dt) {
    for (int i = 0; i < (1 << dt->tlog); i++)
        dt->fused[i] = (uint64_t)dt->base[i] |
                       ((uint64_t)dt->add_bits[i] << 32) |
                       ((uint64_t)dt->next_state[i] << 40) |
                       ((uint64_t)dt->state_bits[i] << 56);
}

static void fse_build_dtable_c(FseDTableC* dt, const int16_t* norm, int max_sym,
                               int tlog, const uint32_t* base_tab,
                               const uint8_t* bits_tab) {
    const int tsize = 1 << tlog;
    dt->tlog = tlog;
    uint8_t tsym[1 << 10];
    fse_spread(norm, max_sym, tlog, tsym);
    uint32_t next[256];
    for (int s = 0; s <= max_sym; s++)
        next[s] = norm[s] == -1 ? 1 : (norm[s] > 0 ? (uint32_t)norm[s] : 0);
    for (int u = 0; u < tsize; u++) {
        const int s = tsym[u];
        const uint32_t ns = next[s]++;
        const int nb = tlog - highbit32(ns);
        const uint16_t nst = (uint16_t)((ns << nb) - tsize);
        dt->state_bits[u] = (uint8_t)nb;
        dt->next_state[u] = nst;
        dt->base[u] = base_tab[s];
        dt->add_bits[u] = bits_tab[s];
        dt->fused[u] = (uint64_t)base_tab[s] |
                       ((uint64_t)bits_tab[s] << 32) |
                       ((uint64_t)nst << 40) | ((uint64_t)(uint8_t)nb << 56);
    }
}

// RLE single-cell sequence table.
static void fse_rle_dtable_c(FseDTableC* dt, int symbol,
                             const uint32_t* base_tab, const uint8_t* bits_tab) {
    dt->tlog = 0;
    dt->base[0] = base_tab[symbol];
    dt->add_bits[0] = bits_tab[symbol];
    dt->next_state[0] = 0;
    dt->state_bits[0] = 0;
    dt->fused[0] = (uint64_t)base_tab[symbol] |
                   ((uint64_t)bits_tab[symbol] << 32);
}

// ------------------------- Huffman encode side ----------------------------

struct HufCTableC {
    uint16_t code[256];
    uint8_t nbits[256];
    int tlog;
    int max_sym;
};

// Optimal code lengths via two-queue merge; symbols sorted by (count asc).
// Returns max length, or 0 on failure (needs >= 2 distinct symbols).
static int huf_lengths(const uint32_t* counts, int max_sym, uint8_t* lengths) {
    struct Node { uint64_t w; int parent; };
    int syms[256];
    int n = 0;
    for (int s = 0; s <= max_sym; s++) {
        lengths[s] = 0;
        if (counts[s]) syms[n++] = s;
    }
    if (n < 2) return 0;
    // insertion sort by (count asc, symbol asc) — n <= 256
    for (int i = 1; i < n; i++) {
        int key = syms[i];
        int j = i - 1;
        while (j >= 0 && (counts[syms[j]] > counts[key] ||
                          (counts[syms[j]] == counts[key] && syms[j] > key))) {
            syms[j + 1] = syms[j];
            j--;
        }
        syms[j + 1] = key;
    }
    Node nodes[512];
    for (int i = 0; i < n; i++) nodes[i] = {counts[syms[i]], -1};
    int li = 0, ii = n, nn = n;
    for (int k = 0; k < n - 1; k++) {
        int picks[2];
        for (int p = 0; p < 2; p++) {
            if (li < n && (ii >= nn || nodes[li].w <= nodes[ii].w)) picks[p] = li++;
            else picks[p] = ii++;
        }
        nodes[nn] = {nodes[picks[0]].w + nodes[picks[1]].w, -1};
        nodes[picks[0]].parent = nn;
        nodes[picks[1]].parent = nn;
        nn++;
    }
    int depth[512];
    depth[2 * n - 2] = 0;
    for (int k = 2 * n - 3; k >= 0; k--) depth[k] = depth[nodes[k].parent] + 1;
    int maxd = 0;
    for (int i = 0; i < n; i++) {
        lengths[syms[i]] = (uint8_t)depth[i];
        if (depth[i] > maxd) maxd = depth[i];
    }
    return maxd;
}

// Height-limit to max_bits keeping Kraft equality (setMaxHeight role).
static void huf_limit(uint8_t* lengths, const uint32_t* counts, int max_sym,
                      int max_bits) {
    int64_t kraft = 0;
    for (int s = 0; s <= max_sym; s++) {
        if (!lengths[s]) continue;
        if (lengths[s] > max_bits) lengths[s] = (uint8_t)max_bits;
        kraft += 1LL << (max_bits - lengths[s]);
    }
    int64_t debt = kraft - (1LL << max_bits);
    while (debt > 0) {
        // lengthen the lowest-count symbol whose length < max_bits
        int best = -1;
        for (int s = 0; s <= max_sym; s++) {
            if (lengths[s] && lengths[s] < max_bits &&
                (best < 0 || counts[s] < counts[best] ||
                 (lengths[s] > lengths[best] && counts[s] <= counts[best])))
                best = s;
        }
        lengths[best]++;
        debt -= 1LL << (max_bits - lengths[best]);
    }
    while (debt < 0) {
        // shorten the highest-count symbol whose gain fits
        int best = -1;
        for (int s = 0; s <= max_sym; s++) {
            if (lengths[s] > 1 && (1LL << (max_bits - lengths[s])) <= -debt &&
                (best < 0 || counts[s] > counts[best]))
                best = s;
        }
        if (best < 0) break;
        lengths[best]--;
        debt += 1LL << (max_bits - lengths[best] - 1);
    }
}

static void huf_canonical(HufCTableC* ct, const uint8_t* lengths, int max_sym) {
    int tlog = 0;
    for (int s = 0; s <= max_sym; s++)
        if (lengths[s] > tlog) tlog = lengths[s];
    ct->tlog = tlog;
    ct->max_sym = max_sym;
    int nb_per_rank[16] = {0};
    for (int s = 0; s <= max_sym; s++) nb_per_rank[lengths[s]]++;
    int val_per_rank[16] = {0};
    int mn = 0;
    for (int l = tlog; l > 0; l--) {
        val_per_rank[l] = mn;
        mn += nb_per_rank[l];
        mn >>= 1;
    }
    for (int s = 0; s <= max_sym; s++) {
        ct->nbits[s] = lengths[s];
        ct->code[s] = lengths[s] ? (uint16_t)val_per_rank[lengths[s]]++ : 0;
    }
}

// FSE 2-state compress for huffman weights (FSE_compress_usingCTable shape).
static int64_t fse_compress_2state(const uint8_t* sym, int64_t n,
                                   const FseCTableC* ct, uint8_t* out,
                                   int64_t cap) {
    BitWriterC w{out, cap, 0, 0, 0};
    struct St { uint32_t value; };
    auto init = [&](St* st, uint8_t s) {
        uint32_t nb = (ct->delta_nb[s] + (1u << 15)) >> 16;
        uint32_t v = (nb << 16) - ct->delta_nb[s];
        st->value = ct->state_table[(v >> nb) + ct->delta_fs[s]];
    };
    auto enc = [&](St* st, uint8_t s) -> int {
        uint32_t nb = (st->value + ct->delta_nb[s]) >> 16;
        if (bw_add(&w, st->value, (int)nb)) return -1;
        st->value = ct->state_table[(st->value >> nb) + ct->delta_fs[s]];
        return 0;
    };
    St c1, c2;
    int64_t ip = n;
    if (n & 1) {
        init(&c1, sym[--ip]);
        init(&c2, sym[--ip]);
        if (enc(&c1, sym[--ip])) return -1;
    } else {
        init(&c2, sym[--ip]);
        init(&c1, sym[--ip]);
    }
    if ((n - 2) & 2) {
        if (enc(&c2, sym[ip - 1])) return -1;
        if (enc(&c1, sym[ip - 2])) return -1;
        ip -= 2;
    }
    while (ip > 0) {
        if (enc(&c2, sym[ip - 1])) return -1;
        if (enc(&c1, sym[ip - 2])) return -1;
        if (enc(&c2, sym[ip - 3])) return -1;
        if (enc(&c1, sym[ip - 4])) return -1;
        ip -= 4;
    }
    if (bw_add(&w, c2.value, ct->tlog)) return -1;
    if (bw_add(&w, c1.value, ct->tlog)) return -1;
    return bw_close(&w);
}

// FSE 2-state decompress (weights).  Returns output size or -1.
static int64_t fse_decompress_2state(const uint8_t* payload, int64_t size,
                                     const uint8_t* dsym, const uint8_t* dnb,
                                     const uint16_t* dns, int tlog,
                                     uint8_t* out, int64_t max_out) {
    uint8_t padded[300 + 16];
    if (size > 300) return -1;
    std::memset(padded, 0, 16);
    std::memcpy(padded + 16, payload, (size_t)size);
    int64_t pos = br_init(payload, size);
    if (pos < 0) return -1;
    pos -= tlog; uint32_t s1 = (uint32_t)br_field(padded, pos, tlog);
    pos -= tlog; uint32_t s2 = (uint32_t)br_field(padded, pos, tlog);
    int64_t n = 0;
    for (;;) {
        if (n > max_out - 2) return -1;
        uint8_t sym = dsym[s1];
        int nb = dnb[s1];
        pos -= nb;
        s1 = dns[s1] + (uint32_t)br_field(padded, pos, nb);
        out[n++] = sym;
        if (pos < 0) { out[n++] = dsym[s2]; break; }
        sym = dsym[s2];
        nb = dnb[s2];
        pos -= nb;
        s2 = dns[s2] + (uint32_t)br_field(padded, pos, nb);
        out[n++] = sym;
        if (pos < 0) { out[n++] = dsym[s1]; break; }
    }
    return n;
}

// Serialize huffman table as weights.  Returns bytes or -1.
static int64_t huf_write_ctable(const HufCTableC* ct, uint8_t* out, int64_t cap) {
    const int max_sym = ct->max_sym;
    uint8_t weights[256];
    for (int s = 0; s < max_sym; s++)
        weights[s] = ct->nbits[s] ? (uint8_t)(ct->tlog + 1 - ct->nbits[s]) : 0;
    // Try FSE compression of weights (maxSym<=12, tlog<=6, lowprob off).
    if (max_sym > 1) {
        uint32_t wcount[13] = {0};
        int wmax = 0;
        for (int s = 0; s < max_sym; s++) {
            wcount[weights[s]]++;
            if (weights[s] > wmax) wmax = weights[s];
        }
        uint32_t maxc = 0;
        for (int wv = 0; wv <= wmax; wv++) if (wcount[wv] > maxc) maxc = wcount[wv];
        if (maxc < (uint32_t)max_sym && maxc > 1) {
            int tlog = fse_optimal_table_log(6, max_sym, wmax);
            int16_t norm[13];
            if (fse_normalize(norm, tlog, wcount, max_sym, wmax, 0) == 0) {
                uint8_t buf[160];
                int64_t h = fse_write_ncount(buf, sizeof buf, norm, wmax, tlog);
                if (h > 0) {
                    FseCTableC wct;
                    fse_build_ctable_c(&wct, norm, wmax, tlog);
                    int64_t b = fse_compress_2state(weights, max_sym, &wct,
                                                    buf + h, (int64_t)sizeof buf - h);
                    if (b > 0 && h + b > 1 && h + b < max_sym / 2 && h + b < 128 &&
                        h + b + 1 <= cap) {
                        out[0] = (uint8_t)(h + b);
                        std::memcpy(out + 1, buf, (size_t)(h + b));
                        return h + b + 1;
                    }
                }
            }
        }
    }
    // Raw nibbles.
    if (max_sym >= 128) return -1;
    const int64_t nb = ((max_sym + 1) / 2) + 1;
    if (nb > cap) return -1;
    out[0] = (uint8_t)(128 + max_sym - 1);
    weights[max_sym] = 0;
    for (int s = 0; s < max_sym; s += 2)
        out[s / 2 + 1] = (uint8_t)((weights[s] << 4) + weights[s + 1]);
    return nb;
}

// Parse weights; builds X1 dtable.  Returns bytes consumed or -1.
struct HufDTableC {
    uint8_t sym[1 << 12];
    uint8_t nb[1 << 12];
    uint16_t fused[1 << 12];  // nb | sym<<8 — one load per decode
    // X2 double-symbol table (HUF_decompress4X2 role), built on demand:
    // sym1 | sym2<<8 | nb_total<<16 | nb_first<<21 | npairs<<26
    uint32_t fused2[1 << 12];
    uint8_t weights_[256];
    int nsym_;
    bool x2_valid;
    int tlog;
    bool valid;
};

static int64_t huf_read_and_build_dtable(const uint8_t* src, int64_t size,
                                         HufDTableC* dt) {
    if (size < 1) return -1;
    uint8_t weights[256];
    int64_t consumed;
    int n_weights;
    const int i_size = src[0];
    if (i_size >= 128) {
        n_weights = i_size - 127;
        consumed = ((n_weights + 1) / 2) + 1;
        if (size < consumed) return -1;
        for (int i = 0; i < n_weights; i++) {
            uint8_t b = src[1 + i / 2];
            weights[i] = (i & 1) ? (b & 15) : (b >> 4);
        }
    } else {
        consumed = i_size + 1;
        if (size < consumed) return -1;
        int16_t norm[13];
        int wmax, wlog;
        int64_t h = fse_read_ncount(norm, &wmax, &wlog, src + 1, i_size, 12, 6);
        if (h < 0) return -1;
        FseDTableC wdt;
        static const uint32_t zb[13] = {0};
        static const uint8_t zbits[13] = {0};
        fse_build_dtable_c(&wdt, norm, wmax, wlog, zb, zbits);
        // decode weights with the 2-state machine; symbol table comes from
        // the same spread as the dtable build
        uint8_t tsym[64];
        fse_spread(norm, wmax, wlog, tsym);
        int64_t nw = fse_decompress_2state(src + 1 + h, i_size - h, tsym,
                                           wdt.state_bits, wdt.next_state, wlog,
                                           weights, 255);
        if (nw < 1) return -1;
        n_weights = (int)nw;
    }
    // Implied last weight.
    uint64_t total = 0;
    for (int i = 0; i < n_weights; i++) {
        if (weights[i] > 12) return -1;
        if (weights[i]) total += 1ULL << (weights[i] - 1);
    }
    if (total == 0) return -1;
    const int tlog = highbit32((uint32_t)total) + 1;
    if (tlog > 12) return -1;
    const uint64_t rest = (1ULL << tlog) - total;
    if (rest & (rest - 1)) return -1;  // must be a power of two
    weights[n_weights] = (uint8_t)(highbit32((uint32_t)rest) + 1);
    const int nsym = n_weights + 1;
    // Canonical fill.
    int rank_start[14] = {0};
    for (int w = 1; w <= tlog; w++) {
        int cnt = 0;
        for (int s = 0; s < nsym; s++) if (weights[s] == w) cnt++;
        rank_start[w + 1] = rank_start[w] + cnt * (1 << (w - 1));
    }
    if (rank_start[tlog + 1] != (1 << tlog)) return -1;
    int fill[14];
    std::memcpy(fill, rank_start, sizeof fill);
    for (int s = 0; s < nsym; s++) {
        const int w = weights[s];
        if (!w) continue;
        const int len = 1 << (w - 1);
        const int p = fill[w];
        std::memset(dt->sym + p, s, (size_t)len);
        std::memset(dt->nb + p, tlog + 1 - w, (size_t)len);
        fill[w] += len;
    }
    dt->tlog = tlog;
    dt->valid = true;
    dt->x2_valid = false;
    dt->nsym_ = nsym;
    std::memcpy(dt->weights_, weights, (size_t)nsym);
    for (int u = 0; u < (1 << tlog); u++)
        dt->fused[u] = (uint16_t)(dt->nb[u] | ((uint16_t)dt->sym[u] << 8));
    return consumed;
}

// Build the double-symbol table: each T-bit window decodes one symbol and,
// when a complete second code fits in the remaining bits, a second one
// (HUF_fillDTableX2 role).
static void huf_build_x2(HufDTableC* dt) {
    const int tlog = dt->tlog;
    const int nsym = dt->nsym_;
    const uint8_t* w = dt->weights_;
    // canonical (start, len, L) per symbol, replaying the X1 fill order
    int fill[14];
    {
        int rank_start[14] = {0};
        for (int wt = 1; wt <= tlog; wt++) {
            int cnt = 0;
            for (int s2 = 0; s2 < nsym; s2++) if (w[s2] == wt) cnt++;
            rank_start[wt + 1] = rank_start[wt] + cnt * (1 << (wt - 1));
        }
        std::memcpy(fill, rank_start, sizeof fill);
    }
    int start[256], len[256], L[256];
    int lmin = tlog;
    for (int s2 = 0; s2 < nsym; s2++) {
        if (!w[s2]) { len[s2] = 0; continue; }
        L[s2] = tlog + 1 - w[s2];
        len[s2] = 1 << (w[s2] - 1);
        start[s2] = fill[w[s2]];
        fill[w[s2]] += len[s2];
        if (L[s2] < lmin) lmin = L[s2];
    }
    for (int s1 = 0; s1 < nsym; s1++) {
        if (!len[s1]) continue;
        const int rem = tlog - L[s1];
        const uint32_t single = (uint32_t)s1 | ((uint32_t)L[s1] << 16) |
                                ((uint32_t)L[s1] << 21) | (1u << 26);
        if (rem < lmin) {
            for (int u = start[s1]; u < start[s1] + len[s1]; u++)
                dt->fused2[u] = single;
            continue;
        }
        // default to single, then overlay complete pairs
        for (int u = start[s1]; u < start[s1] + len[s1]; u++)
            dt->fused2[u] = single;
        for (int s2 = 0; s2 < nsym; s2++) {
            if (!len[s2] || L[s2] > rem) continue;
            // code2 = top L2 bits of s2's T-bit range
            const int code2 = start[s2] >> (tlog - L[s2]);
            const int sub = rem - L[s2];                 // free low bits
            const int lo = start[s1] + (code2 << sub);
            const uint32_t pair = (uint32_t)s1 | ((uint32_t)s2 << 8) |
                                  ((uint32_t)(L[s1] + L[s2]) << 16) |
                                  ((uint32_t)L[s1] << 21) | (2u << 26);
            for (int u = lo; u < lo + (1 << sub); u++) dt->fused2[u] = pair;
        }
    }
    dt->x2_valid = true;
}

// 4-stream interleaved double-symbol decode.  Layout/pointer discipline
// matches huf_decode_4x; the fast loop needs rem >= 11 so an unconditional
// 2-byte store never crosses into the next stream's region.
static int huf_decode_4x2(const uint8_t* pad, const int64_t* offs,
                          const int64_t* sizes, const uint32_t* D, int tlog,
                          uint8_t* out, const int64_t* osz) {
    int64_t pos[4], rem[4];
    const uint8_t* sb[4];
    uint8_t* op[4];
    int64_t ooff = 0;
    for (int k = 0; k < 4; k++) {
        pos[k] = br_init(pad + 16 + offs[k], sizes[k]);
        if (pos[k] < 0) return -1;
        sb[k] = pad + offs[k];
        op[k] = out + ooff;
        rem[k] = osz[k];
        ooff += osz[k];
    }
    const uint64_t mask = (1ULL << tlog) - 1;
    const int per = tlog <= 11 ? 5 : 4;
    {
        int64_t p0 = pos[0], p1 = pos[1], p2 = pos[2], p3 = pos[3];
        int64_t r0 = rem[0], r1 = rem[1], r2 = rem[2], r3 = rem[3];
        uint8_t *q0 = op[0], *q1 = op[1], *q2 = op[2], *q3 = op[3];
        const uint8_t *b0 = sb[0], *b1 = sb[1], *b2 = sb[2], *b3 = sb[3];
        while (p0 >= 56 && p1 >= 56 && p2 >= 56 && p3 >= 56 &&
               r0 >= 11 && r1 >= 11 && r2 >= 11 && r3 >= 11) {
            const int64_t a0 = p0 - 56 + 128, a1 = p1 - 56 + 128;
            const int64_t a2 = p2 - 56 + 128, a3 = p3 - 56 + 128;
            // MSB-aligned containers (same trick as the X1 loop): one
            // constant shift indexes the pair table, one u16 store writes
            // both symbols (overshoot lands in output slack), one variable
            // shift consumes the coded bits.
            uint64_t V0 = (read_window(b0 + (a0 >> 3)) >> (a0 & 7)) << 8;
            uint64_t V1 = (read_window(b1 + (a1 >> 3)) >> (a1 & 7)) << 8;
            uint64_t V2 = (read_window(b2 + (a2 >> 3)) >> (a2 & 7)) << 8;
            uint64_t V3 = (read_window(b3 + (a3 >> 3)) >> (a3 & 7)) << 8;
            int u0 = 0, u1 = 0, u2 = 0, u3 = 0;
            uint8_t *o0 = q0, *o1 = q1, *o2 = q2, *o3 = q3;
            for (int j = 0; j < per; j++) {
                const uint32_t e0 = D[V0 >> (64 - tlog)];
                const uint32_t e1 = D[V1 >> (64 - tlog)];
                const uint32_t e2 = D[V2 >> (64 - tlog)];
                const uint32_t e3 = D[V3 >> (64 - tlog)];
                uint16_t w0 = (uint16_t)e0, w1 = (uint16_t)e1;
                uint16_t w2 = (uint16_t)e2, w3 = (uint16_t)e3;
                std::memcpy(o0, &w0, 2);
                std::memcpy(o1, &w1, 2);
                std::memcpy(o2, &w2, 2);
                std::memcpy(o3, &w3, 2);
                uint32_t n0 = (e0 >> 16) & 31, n1 = (e1 >> 16) & 31;
                uint32_t n2 = (e2 >> 16) & 31, n3 = (e3 >> 16) & 31;
                o0 += (e0 >> 26); V0 <<= n0; u0 += (int)n0;
                o1 += (e1 >> 26); V1 <<= n1; u1 += (int)n1;
                o2 += (e2 >> 26); V2 <<= n2; u2 += (int)n2;
                o3 += (e3 >> 26); V3 <<= n3; u3 += (int)n3;
            }
            r0 -= o0 - q0; r1 -= o1 - q1; r2 -= o2 - q2; r3 -= o3 - q3;
            q0 = o0; q1 = o1; q2 = o2; q3 = o3;
            p0 -= u0; p1 -= u1; p2 -= u2; p3 -= u3;
        }
        pos[0] = p0; pos[1] = p1; pos[2] = p2; pos[3] = p3;
        rem[0] = r0; rem[1] = r1; rem[2] = r2; rem[3] = r3;
        op[0] = q0; op[1] = q1; op[2] = q2; op[3] = q3;
    }
    for (int k = 0; k < 4; k++) {
        while (rem[k] > 0) {
            if (pos[k] <= 0) return -1;
            const int64_t p = pos[k] - tlog + 16 * 8;
            const uint64_t idx = (read_window(sb[k] + (p >> 3)) >> (p & 7)) & mask;
            const uint32_t e = D[idx];
            if ((e >> 26) == 2 && rem[k] >= 2) {
                op[k][0] = (uint8_t)e;
                op[k][1] = (uint8_t)(e >> 8);
                op[k] += 2; rem[k] -= 2;
                pos[k] -= (int)((e >> 16) & 31);
            } else {
                op[k][0] = (uint8_t)e;
                op[k] += 1; rem[k] -= 1;
                pos[k] -= (int)((e >> 21) & 31);
            }
        }
        if (pos[k] != 0) return -1;
    }
    return 0;
}

// ------------------------- literals section codec --------------------------

static int64_t write_lit_header(uint8_t* out, int lit_type, int size_format,
                                int64_t regen, int64_t comp) {
    if (lit_type <= 1) {  // raw / rle
        if (size_format == 0) { out[0] = (uint8_t)(lit_type | (regen << 3)); return 1; }
        if (size_format == 1) {
            uint32_t v = (uint32_t)(lit_type | (1 << 2) | (regen << 4));
            out[0] = (uint8_t)v; out[1] = (uint8_t)(v >> 8);
            return 2;
        }
        uint32_t v = (uint32_t)(lit_type | (3 << 2) | (regen << 4));
        out[0] = (uint8_t)v; out[1] = (uint8_t)(v >> 8); out[2] = (uint8_t)(v >> 16);
        return 3;
    }
    uint64_t v = (uint64_t)(lit_type | (size_format << 2)) | ((uint64_t)regen << 4);
    if (size_format <= 1) {
        v |= (uint64_t)comp << 14;
        out[0] = (uint8_t)v; out[1] = (uint8_t)(v >> 8); out[2] = (uint8_t)(v >> 16);
        return 3;
    }
    if (size_format == 2) {
        v |= (uint64_t)comp << 18;
        for (int i = 0; i < 4; i++) out[i] = (uint8_t)(v >> (8 * i));
        return 4;
    }
    v |= (uint64_t)comp << 22;
    for (int i = 0; i < 5; i++) out[i] = (uint8_t)(v >> (8 * i));
    return 5;
}

static int64_t raw_literals(const uint8_t* lit, int64_t n, uint8_t* out,
                            int64_t cap) {
    int sf = n < 32 ? 0 : (n < 4096 ? 1 : 3);
    int64_t h = write_lit_header(out, 0, sf, n, 0);
    if (h + n > cap) return -1;
    std::memcpy(out + h, lit, (size_t)n);
    return h + n;
}

// Encode literals (raw/RLE/compressed choice).  Returns bytes or -1.
// Cross-block encoder entropy state (repeat modes: HUF_repeat role for
// literals, FSE mode 3 for the three sequence channels).
struct EncEntropyC {
    HufCTableC huf;
    bool huf_valid;
    FseCTableC ll_ct, of_ct, ml_ct;
    int16_t ll_norm[64], of_norm[64], ml_norm[64];
    int ll_max, of_max, ml_max;
    int ll_log, of_log, ml_log;
    bool ll_valid, of_valid, ml_valid;
};

static void enc_entropy_reset(EncEntropyC* e) {
    e->huf_valid = false;
    e->ll_valid = e->of_valid = e->ml_valid = false;
}

static int64_t encode_literals_c(const uint8_t* lit, int64_t n, uint8_t* out,
                                 int64_t cap, EncEntropyC* est) {
    if (n == 0) { out[0] = 0; return 1; }
    bool all_same = true;
    for (int64_t i = 1; i < n; i++) if (lit[i] != lit[0]) { all_same = false; break; }
    if (all_same && n >= 2) {
        int sf = n < 32 ? 0 : (n < 4096 ? 1 : 3);
        int64_t h = write_lit_header(out, 1, sf, n, 0);
        out[h] = lit[0];
        return h + 1;
    }
    if (n <= 63) return raw_literals(lit, n, out, cap);

    uint32_t counts[256] = {0};
    if (n >= 1024) {
        uint32_t c0[256] = {0}, c1[256] = {0}, c2[256] = {0}, c3[256] = {0};
        int64_t i = 0;
        for (; i + 4 <= n; i += 4) {
            c0[lit[i]]++; c1[lit[i + 1]]++; c2[lit[i + 2]]++; c3[lit[i + 3]]++;
        }
        for (; i < n; i++) c0[lit[i]]++;
        for (int s = 0; s < 256; s++) counts[s] = c0[s] + c1[s] + c2[s] + c3[s];
    } else {
        for (int64_t i = 0; i < n; i++) counts[lit[i]]++;
    }
    int max_sym = 255;
    while (max_sym > 0 && counts[max_sym] == 0) max_sym--;

    // preferRepeat (HUF_compress4X_repeat role): for small blocks with a
    // valid previous/dictionary table, skip the fresh tree build entirely
    // when the repeat table covers the block within ~1% of its entropy.
    if (est && est->huf_valid && n < 4096) {
        uint64_t rep_bits = 0;
        bool coverable = true;
        for (int sy = 0; sy <= max_sym && coverable; sy++) {
            if (!counts[sy]) continue;
            if (sy > est->huf.max_sym || est->huf.nbits[sy] == 0) coverable = false;
            else rep_bits += (uint64_t)counts[sy] * est->huf.nbits[sy];
        }
        const int64_t comp_est = (int64_t)(rep_bits / 8) + 1;
        const int64_t min_gain = (n >> 6) + 2;
        if (coverable && comp_est < n - min_gain) {
            uint8_t* payload = (uint8_t*)malloc((size_t)((n * 11) / 8 + 96));
            if (!payload) return -1;
            const bool single = n < 256;
            int64_t psize;
            if (single)
                psize = huf_encode_stream(lit, n, est->huf.code,
                                          est->huf.nbits, payload,
                                          (n * 11) / 8 + 96);
            else
                psize = huf_encode_4streams(lit, n, est->huf.code,
                                            est->huf.nbits, payload,
                                            (n * 11) / 8 + 96);
            if (psize >= 0 && psize < n - min_gain) {
                int sf;
                if (single) sf = 0;
                else if (n < 1024 && psize < 1024) sf = 1;
                else if (n < 16384 && psize < 16384) sf = 2;
                else sf = 3;
                int64_t h = write_lit_header(out, 3, sf, n, psize);
                if (h + psize <= cap) {
                    std::memcpy(out + h, payload, (size_t)psize);
                    free(payload);
                    return h + psize;
                }
            }
            free(payload);
        }
    }

    uint8_t lengths[256];
    int maxd = huf_lengths(counts, max_sym, lengths);
    if (maxd == 0) return raw_literals(lit, n, out, cap);
    if (maxd > 11) { huf_limit(lengths, counts, max_sym, 11); }
    HufCTableC ct;
    huf_canonical(&ct, lengths, max_sym);

    uint8_t table_buf[200];
    int64_t tsize = huf_write_ctable(&ct, table_buf, sizeof table_buf);
    if (tsize < 0) return raw_literals(lit, n, out, cap);

    // Repeat-table candidate: reuse the previous block's table (type 3, no
    // header) when its estimated payload beats fresh table + payload.
    bool use_repeat = false;
    if (est && est->huf_valid) {
        uint64_t fresh_bits = 0, rep_bits = 0;
        bool coverable = true;
        for (int sy = 0; sy <= max_sym && coverable; sy++) {
            if (!counts[sy]) continue;
            fresh_bits += (uint64_t)counts[sy] * ct.nbits[sy];
            if (sy > est->huf.max_sym || est->huf.nbits[sy] == 0) coverable = false;
            else rep_bits += (uint64_t)counts[sy] * est->huf.nbits[sy];
        }
        if (coverable && rep_bits / 8 + 1 < fresh_bits / 8 + (uint64_t)tsize)
            use_repeat = true;
    }
    if (use_repeat) ct = est->huf;

    uint8_t* payload = (uint8_t*)malloc((size_t)(n + 64));
    if (!payload) return -1;
    int64_t psize;
    const bool single = n < 256;
    if (single) {
        psize = huf_encode_stream(lit, n, ct.code, ct.nbits, payload, n + 64);
    } else {
        psize = huf_encode_4streams(lit, n, ct.code, ct.nbits, payload, n + 64);
        if (psize < 0) { free(payload); return raw_literals(lit, n, out, cap); }
    }
    if (psize < 0) { free(payload); return raw_literals(lit, n, out, cap); }
    const int64_t hdr_t = use_repeat ? 0 : tsize;
    const int64_t comp = hdr_t + psize;
    const int64_t min_gain = (n >> 6) + 2;
    if (comp >= n - min_gain) { free(payload); return raw_literals(lit, n, out, cap); }
    const int lit_type = use_repeat ? 3 : 2;
    int sf;
    if (single) sf = 0;                              // 1 stream
    else if (n < 1024 && comp < 1024) sf = 1;
    else if (n < 16384 && comp < 16384) sf = 2;
    else sf = 3;
    int64_t h = write_lit_header(out, lit_type, sf, n, comp);
    if (h + comp > cap) { free(payload); return -1; }
    if (!use_repeat) std::memcpy(out + h, table_buf, (size_t)tsize);
    std::memcpy(out + h + hdr_t, payload, (size_t)psize);
    free(payload);
    if (est && !use_repeat) { est->huf = ct; est->huf_valid = true; }
    return h + comp;
}

// ------------------------- sequences section codec -------------------------

static uint8_t kLLCodeLut[(1 << 17) + 1];
static uint8_t kMLCodeLut[(1 << 17) + 1];
static FseCTableC kLLDefaultCT, kMLDefaultCT, kOFDefaultCT;
static FseDTableC kLLDefaultDT, kMLDefaultDT, kOFDefaultDT;
static bool kInited = false;

static void codec_init() {
    if (kInited) return;
    for (int c = 0; c < 32; c++) {
        kOFBits[c] = (uint8_t)c;
        kOFBase[c] = c < 2 ? (uint32_t)c : (1u << c) - 3;
    }
    for (int c = 0; c <= kMaxLL; c++) {
        const uint32_t lo = kLLBase[c];
        const uint32_t hi = c < kMaxLL ? kLLBase[c + 1] : (1u << 17) + 1;
        for (uint32_t v = lo; v < hi && v <= (1u << 17); v++) kLLCodeLut[v] = (uint8_t)c;
    }
    for (int c = 0; c <= kMaxML; c++) {
        const uint32_t lo = kMLBase[c];
        const uint32_t hi = c < kMaxML ? kMLBase[c + 1] : (1u << 17) + 3;
        for (uint32_t v = lo; v < hi && v <= (1u << 17); v++) kMLCodeLut[v] = (uint8_t)c;
    }
    fse_build_ctable_c(&kLLDefaultCT, kLLNorm, kMaxLL, kLLNormLog);
    fse_build_ctable_c(&kMLDefaultCT, kMLNorm, kMaxML, kMLNormLog);
    fse_build_ctable_c(&kOFDefaultCT, kOFNorm, kDefaultMaxOFF, kOFNormLog);
    fse_build_dtable_c(&kLLDefaultDT, kLLNorm, kMaxLL, kLLNormLog, kLLBase, kLLBits);
    fse_build_dtable_c(&kMLDefaultDT, kMLNorm, kMaxML, kMLNormLog, kMLBase, kMLBits);
    fse_build_dtable_c(&kOFDefaultDT, kOFNorm, kDefaultMaxOFF, kOFNormLog, kOFBase, kOFBits);
    fse_fuse_dtable(&kLLDefaultDT);
    fse_fuse_dtable(&kMLDefaultDT);
    fse_fuse_dtable(&kOFDefaultDT);
    kInited = true;
}

// Estimated bits of `counts` under `norm` (cross-entropy); +inf -> -1.
static double fse_cost_bits(const uint32_t* counts, int max_code,
                            const int16_t* norm, int norm_max, int tlog) {
    double bits = 0;
    for (int s = 0; s <= max_code; s++) {
        if (!counts[s]) continue;
        if (s > norm_max || norm[s] == 0) return -1;
        const double p = (norm[s] < 0 ? 1.0 : (double)norm[s]) / (double)(1 << tlog);
        bits += counts[s] * -(__builtin_log2(p));
    }
    return bits;
}

// Select + serialize one channel's table.  Returns header bytes written,
// sets *mode and fills ct (possibly the default).  -1 on failure.
static int64_t select_channel(const uint8_t* codes, int64_t n, int max_allowed,
                              const int16_t* dnorm, int dmax, int dlog,
                              const FseCTableC* dct, int max_log,
                              bool default_ok, uint8_t* out, int* mode,
                              FseCTableC* scratch, const FseCTableC** ct_out,
                              const FseCTableC* prev_ct = nullptr,
                              const int16_t* prev_norm = nullptr,
                              int prev_max = 0, int prev_log = 0,
                              // out: fresh norm recorded for the caller's
                              // repeat state (valid when *mode == 2)
                              int16_t* fresh_norm = nullptr,
                              int* fresh_max = nullptr,
                              int* fresh_log = nullptr,
                              const uint32_t* pre_counts = nullptr) {
    uint32_t counts[64];
    if (pre_counts) std::memcpy(counts, pre_counts, sizeof counts);
    else {
        std::memset(counts, 0, sizeof counts);
        for (int64_t i = 0; i < n; i++) counts[codes[i]]++;
    }
    int max_code = max_allowed;
    while (max_code > 0 && counts[max_code] == 0) max_code--;
    int distinct = 0;
    for (int s = 0; s <= max_code; s++) if (counts[s]) distinct++;

    if (distinct == 1) {
        *mode = 1;  // RLE
        out[0] = codes[0];
        // tlog-0 ctable: all-zero deltas
        std::memset(scratch->delta_nb, 0, sizeof scratch->delta_nb);
        std::memset(scratch->delta_fs, 0, sizeof scratch->delta_fs);
        scratch->state_table[0] = 0;
        scratch->tlog = 0;
        *ct_out = scratch;
        return 1;
    }
    double dcost = default_ok ? fse_cost_bits(counts, max_code, dnorm, dmax, dlog) : -1;
    // repeat previous table (mode 3, no header)
    double rcost = -1;
    if (prev_ct && max_code <= prev_max)
        rcost = fse_cost_bits(counts, max_code, prev_norm, prev_max, prev_log);
    // preferRepeat: tiny blocks skip the fresh normalize+build when the
    // previous table already beats (or matches) the predefined one
    if (n < 64 && rcost >= 0 && (dcost < 0 || rcost <= dcost + 8)) {
        *mode = 3;
        *ct_out = prev_ct;
        return 0;
    }
    // fresh FSE
    double fcost = -1;
    int16_t norm[64];
    int tlog = 0;
    uint8_t hdr[128];
    int64_t hsize = 0;
    if (n >= 2) {
        tlog = fse_optimal_table_log(max_log, n, max_code);
        if (fse_normalize(norm, tlog, counts, n, max_code, n >= 2048) == 0) {
            hsize = fse_write_ncount(hdr, sizeof hdr, norm, max_code, tlog);
            if (hsize > 0) {
                double c = fse_cost_bits(counts, max_code, norm, max_code, tlog);
                if (c >= 0) fcost = c + hsize * 8;
            }
        }
    }
    const bool fresh_best = fcost >= 0 && (dcost < 0 || fcost < dcost) &&
                            (rcost < 0 || fcost < rcost);
    if (fresh_best) {
        *mode = 2;  // FSE
        fse_build_ctable_c(scratch, norm, max_code, tlog);
        std::memcpy(out, hdr, (size_t)hsize);
        *ct_out = scratch;
        if (fresh_norm) {
            std::memcpy(fresh_norm, norm, sizeof norm);
            *fresh_max = max_code;
            *fresh_log = tlog;
        }
        return hsize;
    }
    if (rcost >= 0 && (dcost < 0 || rcost < dcost)) {
        *mode = 3;  // repeat
        *ct_out = prev_ct;
        return 0;
    }
    if (dcost < 0) return -1;
    *mode = 0;  // predefined
    *ct_out = dct;
    return 0;
}

// Encode a full compressed-block body.  Returns size or -1 (emit raw).

// Mirror the decoder's repeat semantics: mode 3 reuses whatever table the
// previous block USED (fresh, predefined or RLE alike), so the encoder
// state must update on every mode.
static void enc_update_channel(FseCTableC* dst_ct, int16_t* dst_norm,
                               int* dst_max, int* dst_log, bool* dst_valid,
                               int mode, const FseCTableC* used,
                               const int16_t* fresh_norm, int fresh_max,
                               int fresh_log, const int16_t* dnorm, int dmax,
                               int dlog, int rle_sym) {
    if (mode == 3) return;  // unchanged
    *dst_ct = *used;
    *dst_valid = true;
    if (mode == 2) {
        std::memcpy(dst_norm, fresh_norm, 64 * sizeof(int16_t));
        *dst_max = fresh_max;
        *dst_log = fresh_log;
    } else if (mode == 0) {
        std::memset(dst_norm, 0, 64 * sizeof(int16_t));
        std::memcpy(dst_norm, dnorm, (size_t)(dmax + 1) * sizeof(int16_t));
        *dst_max = dmax;
        *dst_log = dlog;
    } else {  // RLE: only this symbol, zero bits
        std::memset(dst_norm, 0, 64 * sizeof(int16_t));
        dst_norm[rle_sym] = 1;
        *dst_max = rle_sym;
        *dst_log = 0;
    }
}

static int64_t encode_block_body_c(const uint8_t* block, int64_t nv,
                                   const uint32_t* ll, const uint32_t* mlv,
                                   const uint32_t* ob, int64_t n_seq,
                                   int64_t last_lit, uint8_t* out, int64_t cap,
                                   EncEntropyC* est = nullptr) {
    codec_init();
    const bool eprof = prof_on();
    int64_t t0 = eprof ? prof_now() : 0;
    // Literals: gather uncovered bytes.
    int64_t lit_total = last_lit;
    for (int64_t i = 0; i < n_seq; i++) lit_total += ll[i];
    uint8_t* lit = (uint8_t*)malloc((size_t)(lit_total + 16));
    if (!lit) return -1;
    {
        int64_t pos = 0, lp = 0;
        for (int64_t i = 0; i < n_seq; i++) {
            const int64_t l = ll[i];
            // wildcopy: the +16 slack on lit and the in-block source bound
            // make the unconditional 16-byte chunks safe for short runs
            if (l && pos + l + 16 <= nv)
                wildcopy16(lit + lp, block + pos, l);
            else
                std::memcpy(lit + lp, block + pos, (size_t)l);
            lp += l;
            pos += l + mlv[i];
        }
        std::memcpy(lit + lp, block + nv - last_lit, (size_t)last_lit);
    }
    if (eprof) { int64_t t = prof_now(); g_prof[0] += t - t0; t0 = t; }
    int64_t size = encode_literals_c(lit, lit_total, out, cap, est);
    free(lit);
    if (eprof) { int64_t t = prof_now(); g_prof[1] += t - t0; t0 = t; }
    if (size < 0) return -1;

    // nbSeq header
    if (n_seq < 128) {
        out[size++] = (uint8_t)n_seq;
    } else if (n_seq < 0x7F00) {
        out[size++] = (uint8_t)((n_seq >> 8) + 128);
        out[size++] = (uint8_t)n_seq;
    } else {
        out[size++] = 255;
        out[size++] = (uint8_t)(n_seq - 0x7F00);
        out[size++] = (uint8_t)((n_seq - 0x7F00) >> 8);
    }
    if (n_seq == 0) {
        const int64_t max_size = nv - (nv >> 6) - 3;
        return size < max_size ? size : -1;
    }

    // Codes + histograms in one pass (the channel selector reuses them).
    uint8_t* llc = (uint8_t*)malloc((size_t)n_seq * 3);
    uint8_t* mlc = llc + n_seq;
    uint8_t* ofc = mlc + n_seq;
    uint32_t* mlbase = (uint32_t*)malloc((size_t)n_seq * 4);
    if (!llc || !mlbase) { free(llc); free(mlbase); return -1; }
    uint32_t cnt_ll[64] = {0}, cnt_ml[64] = {0}, cnt_of[64] = {0};
    bool of_default_ok = true;
    for (int64_t i = 0; i < n_seq; i++) {
        const uint8_t cl = kLLCodeLut[ll[i]];
        const uint8_t cm = kMLCodeLut[mlv[i]];
        const int oc = highbit32(ob[i]);
        llc[i] = cl;
        mlc[i] = cm;
        mlbase[i] = mlv[i] - 3;
        ofc[i] = (uint8_t)oc;
        cnt_ll[cl]++; cnt_ml[cm]++; cnt_of[oc]++;
        if (oc > kDefaultMaxOFF) of_default_ok = false;
    }

    const int64_t mode_pos = size++;
    FseCTableC sc_ll, sc_of, sc_ml;
    const FseCTableC *ct_ll, *ct_of, *ct_ml;
    int m_ll, m_of, m_ml;
    int16_t fn[64];
    int fmax, flog;
    int64_t h;
    h = select_channel(llc, n_seq, kMaxLL, kLLNorm, kMaxLL, kLLNormLog,
                       &kLLDefaultCT, kLLFseLog, true, out + size, &m_ll,
                       &sc_ll, &ct_ll,
                       est && est->ll_valid ? &est->ll_ct : nullptr,
                       est ? est->ll_norm : nullptr,
                       est ? est->ll_max : 0, est ? est->ll_log : 0,
                       fn, &fmax, &flog, cnt_ll);
    if (h < 0) { free(llc); free(mlbase); return -1; }
    if (est)
        enc_update_channel(&est->ll_ct, est->ll_norm, &est->ll_max,
                           &est->ll_log, &est->ll_valid, m_ll, ct_ll, fn,
                           fmax, flog, kLLNorm, kMaxLL, kLLNormLog,
                           n_seq ? llc[0] : 0);
    size += h;
    h = select_channel(ofc, n_seq, kMaxOFF, kOFNorm, kDefaultMaxOFF, kOFNormLog,
                       &kOFDefaultCT, kOFFseLog, of_default_ok, out + size,
                       &m_of, &sc_of, &ct_of,
                       est && est->of_valid ? &est->of_ct : nullptr,
                       est ? est->of_norm : nullptr,
                       est ? est->of_max : 0, est ? est->of_log : 0,
                       fn, &fmax, &flog, cnt_of);
    if (h < 0) { free(llc); free(mlbase); return -1; }
    if (est)
        enc_update_channel(&est->of_ct, est->of_norm, &est->of_max,
                           &est->of_log, &est->of_valid, m_of, ct_of, fn,
                           fmax, flog, kOFNorm, kDefaultMaxOFF, kOFNormLog,
                           n_seq ? ofc[0] : 0);
    size += h;
    h = select_channel(mlc, n_seq, kMaxML, kMLNorm, kMaxML, kMLNormLog,
                       &kMLDefaultCT, kMLFseLog, true, out + size, &m_ml,
                       &sc_ml, &ct_ml,
                       est && est->ml_valid ? &est->ml_ct : nullptr,
                       est ? est->ml_norm : nullptr,
                       est ? est->ml_max : 0, est ? est->ml_log : 0,
                       fn, &fmax, &flog, cnt_ml);
    if (h < 0) { free(llc); free(mlbase); return -1; }
    if (est)
        enc_update_channel(&est->ml_ct, est->ml_norm, &est->ml_max,
                           &est->ml_log, &est->ml_valid, m_ml, ct_ml, fn,
                           fmax, flog, kMLNorm, kMaxML, kMLNormLog,
                           n_seq ? mlc[0] : 0);
    size += h;
    out[mode_pos] = (uint8_t)((m_ll << 6) | (m_of << 4) | (m_ml << 2));
    if (eprof) { int64_t t = prof_now(); g_prof[2] += t - t0; t0 = t; }

    int64_t bs = encode_sequences(ll, mlbase, ob, llc, mlc, ofc, kLLBits,
                                  kMLBits, n_seq,
                                  ct_ll->state_table, ct_ll->delta_nb, ct_ll->delta_fs, ct_ll->tlog,
                                  ct_of->state_table, ct_of->delta_nb, ct_of->delta_fs, ct_of->tlog,
                                  ct_ml->state_table, ct_ml->delta_nb, ct_ml->delta_fs, ct_ml->tlog,
                                  out + size, cap - size);
    free(llc); free(mlbase);
    if (eprof) g_prof[3] += prof_now() - t0;
    if (bs < 0) return -1;
    size += bs;
    const int64_t max_size = nv - (nv >> 6) - 3;
    return size < max_size ? size : -1;
}


}  // pause extern "C": exact-encoder templates below

// ===========================================================================
// EXACT ENCODER — reproduces the reference encoder's output byte-for-byte
// for the fast/dfast strategies (levels <=4 and negative levels).
//
// Role map (reference file:line):
//   parse:    ZSTD_compressBlock_fast_noDict_generic      ZstdFast.cs:96
//             ZSTD_compressBlock_doubleFast_noDict_generic ZstdDoubleFast.cs:51
//   literals: ZSTD_compressLiterals / HUF_compress_internal
//             ZstdCompressLiterals.cs:86, HufCompress.cs:1360
//   huffman:  HUF_sort:635, HUF_buildTree:689, HUF_setMaxHeight:377,
//             HUF_writeCTable_wksp:168
//   seqs:     ZSTD_buildSequencesStatistics ZstdCompress.cs:3127,
//             ZSTD_selectEncodingType ZstdCompressSequences.cs:400,
//             ZSTD_buildCTable:471
//   frame:    ZSTD_compress_frameChunk:4690, ZSTD_writeFrameHeader:4817,
//             ZSTD_writeEpilogue:5598, params Clevels.cs:8 +
//             ZSTD_adjustCParams_internal:2023
// ===========================================================================

struct ZxCP { uint32_t wlog, clog, hlog, slog, mml, tlen, strat; };

static const ZxCP kZxCParams[4][23] = {
    {{19,12,13,1,6,1,1},{19,13,14,1,7,0,1},{20,15,16,1,6,0,1},{21,16,17,1,5,0,2},{21,18,18,1,5,0,2},{21,18,19,3,5,2,3},{21,18,19,3,5,4,4},{21,19,20,4,5,8,4},{21,19,20,4,5,16,5},{22,20,21,4,5,16,5},{22,21,22,5,5,16,5},{22,21,22,6,5,16,5},{22,22,23,6,5,32,5},{22,22,22,4,5,32,6},{22,22,23,5,5,32,6},{22,23,23,6,5,32,6},{22,22,22,5,5,48,7},{23,23,22,5,4,64,7},{23,23,22,6,3,64,8},{23,24,22,7,3,256,9},{25,25,23,7,3,256,9},{26,26,24,7,3,512,9},{27,27,25,9,3,999,9}},
    {{18,12,13,1,5,1,1},{18,13,14,1,6,0,1},{18,14,14,1,5,0,2},{18,16,16,1,4,0,2},{18,16,17,3,5,2,3},{18,17,18,5,5,2,3},{18,18,19,3,5,4,4},{18,18,19,4,4,4,4},{18,18,19,4,4,8,5},{18,18,19,5,4,8,5},{18,18,19,6,4,8,5},{18,18,19,5,4,12,6},{18,19,19,7,4,12,6},{18,18,19,4,4,16,7},{18,18,19,4,3,32,7},{18,18,19,6,3,128,7},{18,19,19,6,3,128,8},{18,19,19,8,3,256,8},{18,19,19,6,3,128,9},{18,19,19,8,3,256,9},{18,19,19,10,3,512,9},{18,19,19,12,3,512,9},{18,19,19,13,3,999,9}},
    {{17,12,12,1,5,1,1},{17,12,13,1,6,0,1},{17,13,15,1,5,0,1},{17,15,16,2,5,0,2},{17,17,17,2,4,0,2},{17,16,17,3,4,2,3},{17,16,17,3,4,4,4},{17,16,17,3,4,8,5},{17,16,17,4,4,8,5},{17,16,17,5,4,8,5},{17,16,17,6,4,8,5},{17,17,17,5,4,8,6},{17,18,17,7,4,12,6},{17,18,17,3,4,12,7},{17,18,17,4,3,32,7},{17,18,17,6,3,256,7},{17,18,17,6,3,128,8},{17,18,17,8,3,256,8},{17,18,17,10,3,512,8},{17,18,17,5,3,256,9},{17,18,17,7,3,512,9},{17,18,17,9,3,512,9},{17,18,17,11,3,999,9}},
    {{14,12,13,1,5,1,1},{14,14,15,1,5,0,1},{14,14,15,1,4,0,1},{14,14,15,2,4,0,2},{14,14,14,4,4,2,3},{14,14,14,3,4,4,4},{14,14,14,4,4,8,5},{14,14,14,6,4,8,5},{14,14,14,8,4,8,5},{14,15,14,5,4,8,6},{14,15,14,9,4,8,6},{14,15,14,3,4,12,7},{14,15,14,4,3,24,7},{14,15,14,5,3,32,8},{14,15,15,6,3,64,8},{14,15,15,7,3,256,8},{14,15,15,5,3,48,9},{14,15,15,6,3,128,9},{14,15,15,7,3,256,9},{14,15,15,8,3,256,9},{14,15,15,8,3,512,9},{14,15,15,9,3,512,9},{14,15,15,10,3,999,9}}
};

static const uint32_t kZxInvProbLog256[256] = {
    0,2048,1792,1642,1536,1453,1386,1329,1280,1236,1197,1162,1130,1100,1073,1047,
    1024,1001,980,960,941,923,906,889,874,859,844,830,817,804,791,779,
    768,756,745,734,724,714,704,694,685,676,667,658,650,642,633,626,
    618,610,603,595,588,581,574,567,561,554,548,542,535,529,523,517,
    512,506,500,495,489,484,478,473,468,463,458,453,448,443,438,434,
    429,424,420,415,411,407,402,398,394,390,386,382,377,373,370,366,
    362,358,354,350,347,343,339,336,332,329,325,322,318,315,311,308,
    305,302,298,295,292,289,286,282,279,276,273,270,267,264,261,258,
    256,253,250,247,244,241,239,236,233,230,228,225,222,220,217,215,
    212,209,207,204,202,199,197,194,192,190,187,185,182,180,178,175,
    173,171,168,166,164,162,159,157,155,153,151,149,146,144,142,140,
    138,136,134,132,130,128,126,123,121,119,117,115,114,112,110,108,
    106,104,102,100,98,96,94,93,91,89,87,85,83,82,80,78,
    76,74,73,71,69,67,66,64,62,61,59,57,55,54,52,50,
    49,47,46,44,42,41,39,37,36,34,33,31,30,28,26,25,
    23,22,20,19,17,16,14,13,11,10,8,7,5,4,2,1,
};

static const uint8_t kZxLL_Code[64] = {
    0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,
    16,16,17,17,18,18,19,19,20,20,20,20,21,21,21,21,
    22,22,22,22,22,22,22,22,23,23,23,23,23,23,23,23,
    24,24,24,24,24,24,24,24,24,24,24,24,24,24,24,24,
};
static const uint8_t kZxML_Code[128] = {
    0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,
    16,17,18,19,20,21,22,23,24,25,26,27,28,29,30,31,
    32,32,33,33,34,34,35,35,36,36,36,36,37,37,37,37,
    38,38,38,38,38,38,38,38,39,39,39,39,39,39,39,39,
    40,40,40,40,40,40,40,40,40,40,40,40,40,40,40,40,
    41,41,41,41,41,41,41,41,41,41,41,41,41,41,41,41,
    42,42,42,42,42,42,42,42,42,42,42,42,42,42,42,42,
    42,42,42,42,42,42,42,42,42,42,42,42,42,42,42,42,
};

static inline uint32_t zx_llcode(uint32_t v) {
    return v > 63 ? (uint32_t)highbit32(v) + 19 : kZxLL_Code[v];
}
static inline uint32_t zx_mlcode(uint32_t v) {
    return v > 127 ? (uint32_t)highbit32(v) + 36 : kZxML_Code[v];
}

// ZSTD_getCParams_internal + ZSTD_adjustCParams_internal (srcSize known).
static ZxCP zx_get_cparams(int level, uint64_t srcSize) {
    const uint64_t rSize = srcSize;  // dictSize 0, known srcSize
    const int tableID = (rSize <= 256 * 1024) + (rSize <= 128 * 1024) +
                        (rSize <= 16 * 1024);
    int row = level == 0 ? 3 : level < 0 ? 0 : level > 22 ? 22 : level;
    ZxCP cp = kZxCParams[tableID][row];
    if (level < 0) {
        const int clamped = level < -(1 << 17) ? -(1 << 17) : level;
        cp.tlen = (uint32_t)(-clamped);
    }
    // adjust (ZstdCompress.cs:2023); maxWindowResize = 1<<30
    if (srcSize < (1ULL << 30)) {
        const uint32_t tSize = (uint32_t)srcSize;
        const uint32_t srcLog =
            tSize < 64 ? 6 : (uint32_t)highbit32(tSize - 1) + 1;
        if (cp.wlog > srcLog) cp.wlog = srcLog;
    }
    {
        const uint32_t dawLog = cp.wlog;  // dictSize 0
        const uint32_t cycleLog = cp.clog - (cp.strat >= 6);  // ZSTD_cycleLog
        if (cp.hlog > dawLog + 1) cp.hlog = dawLog + 1;
        if (cycleLog > dawLog) cp.clog -= cycleLog - dawLog;
    }
    if (cp.wlog < 10) cp.wlog = 10;
    return cp;
}

// Exact hash family (ZSTD_hashPtr, ZstdCompressInternal.cs:423).
static inline size_t zx_hash(const uint8_t* p, uint32_t hBits, uint32_t mls) {
    switch (mls) {
        default:
        case 4: return (size_t)((read32(p) * 2654435761U) >> (32 - hBits));
        case 5: return (size_t)(((read64_fwd(p) << 24) * 889523592379ULL) >> (64 - hBits));
        case 6: return (size_t)(((read64_fwd(p) << 16) * 227718039650203ULL) >> (64 - hBits));
        case 7: return (size_t)(((read64_fwd(p) << 8) * 58295818150454627ULL) >> (64 - hBits));
        case 8: return (size_t)((read64_fwd(p) * 0xCF1BBCDCB7A56463ULL) >> (64 - hBits));
    }
}

// Longest common prefix (ZSTD_count semantics).
static inline size_t zx_count(const uint8_t* pIn, const uint8_t* pMatch,
                              const uint8_t* pInLimit) {
    const uint8_t* const s = pIn;
    while (pIn + 8 <= pInLimit) {
        uint64_t a, b;
        std::memcpy(&a, pIn, 8);
        std::memcpy(&b, pMatch, 8);
        const uint64_t d = a ^ b;
        if (d) return (size_t)(pIn - s) + ((size_t)__builtin_ctzll(d) >> 3);
        pIn += 8;
        pMatch += 8;
    }
    while (pIn < pInLimit && *pIn == *pMatch) { pIn++; pMatch++; }
    return (size_t)(pIn - s);
}

// seqStore with the reference's u16 truncation + long-length tracking
// (ZSTD_storeSeq, ZstdCompressInternal.cs:204).
struct ZxSeq { uint16_t ll, ml; uint32_t offBase; };
struct ZxStore {
    uint8_t* lit;
    int64_t nlit;
    ZxSeq* seq;
    int64_t nseq;
    int llt;        // 0 none, 1 literalLength, 2 matchLength
    int64_t lltPos;
};

static inline void zx_store_seq(ZxStore* ss, const uint8_t* literals,
                                size_t litLength, uint32_t offCode,
                                size_t mlBase) {
    std::memcpy(ss->lit + ss->nlit, literals, litLength);
    ss->nlit += (int64_t)litLength;
    if (litLength > 0xFFFF) { ss->llt = 1; ss->lltPos = ss->nseq; }
    if (mlBase > 0xFFFF) { ss->llt = 2; ss->lltPos = ss->nseq; }
    ss->seq[ss->nseq].ll = (uint16_t)litLength;
    ss->seq[ss->nseq].ml = (uint16_t)mlBase;
    ss->seq[ss->nseq].offBase = offCode + 1;
    ss->nseq++;
}

// Greedy fast matcher (levels 1-2), zstd v1.5.1 decision semantics
// (ZstdFast.cs:96 documents the required behavior).  Reformulated in this
// repo's idiom: absolute int64 positions and one structured loop per
// emitted sequence.  The reference's software pipeline is restated as a
// scan over ADJACENT POSITION PAIRS: visit (t, t+1), then jump a stride
// that grows by one every 128 scanned bytes; each pair additionally
// probes one repcode candidate at r = t + stride, which is exactly where
// the next pair will start.  Table discipline (behavior-critical): a
// probe's hash-table candidate is loaded before that probe's own insert
// and after every earlier probe's insert.
template <uint32_t kMls, int kHasStep>
static int64_t zx_fast_block(const uint8_t* base, uint32_t* hashTable,
                             uint32_t hlog, uint32_t dictLimit, uint32_t wlog,
                             uint32_t tlen, const uint8_t* istart,
                             int64_t srcSize, uint32_t* rep, ZxStore* ss) {
    const int64_t init_stride =
        kHasStep ? (int64_t)tlen + (tlen == 0 ? 1 : 0) + 1 : 2;
    const uint32_t endIndex = (uint32_t)((istart - base) + srcSize);
    const uint32_t maxDistance = 1u << wlog;
    const uint32_t prefixIdx =
        (endIndex - dictLimit > maxDistance) ? endIndex - maxDistance
                                             : dictLimit;
    const int64_t iend = (istart - base) + srcSize;
    const int64_t scan_end = iend - 8;  // probes read up to 8 bytes ahead
    const int64_t kGrowEvery = 128;

    int64_t anchor = istart - base;
    int64_t t = anchor + (anchor == (int64_t)prefixIdx ? 1 : 0);

    uint32_t rep1 = rep[0], rep2 = rep[1];
    uint32_t parked = 0;  // an out-of-window rep, restored on exit
    {
        const uint32_t here = (uint32_t)t;
        const uint32_t low = (here - dictLimit > maxDistance)
                                 ? here - maxDistance
                                 : dictLimit;
        const uint32_t span = here - low;
        if (rep2 > span) { parked = rep2; rep2 = 0; }
        if (rep1 > span) { parked = rep1; rep1 = 0; }
    }

    for (;;) {  // one iteration per segment (anchor .. next stored seq)
        int64_t s = init_stride;
        int64_t grow_at = t + kGrowEvery;
        int64_t r = t + s;

        // facts about the match that ends this segment
        int64_t m_start = 0, m_len = 0, next_probe = 0, last_probe = 0;
        uint32_t off_code = 0;
        bool found = false;

        if (r + 1 < scan_end) {
            // The candidate for the pair's first probe is loaded one pair
            // ahead (at the previous advance) so the table read is off the
            // compare's critical path; the last write before each load is
            // the previous pair's second insert, so ordering is unchanged.
            // rep1 is loop-invariant here (it only changes on match
            // emission); folding it into a shifted base keeps the rep
            // probe to one addressed load instead of a stack reload + sub.
            const uint8_t* const rep_b = base - rep1;
            const bool rep_ok = rep1 > 0;
            size_t hash_t = zx_hash(base + t, hlog, kMls);
            uint32_t cand0 = hashTable[hash_t];
            for (;;) {
                // ---- probe t (plus the stride-ahead repcode check) ----
                const uint32_t r_word = read32(base + r);
                const uint32_t r_prev = read32(rep_b + r);
                // probe t+1's candidate, hoisted off the critical path:
                // loaded before t's insert lands, so patch the one case
                // where that insert should have been visible (same bucket)
                const size_t hash_u = zx_hash(base + t + 1, hlog, kMls);
                uint32_t cand1 = hashTable[hash_u];
                hashTable[hash_t] = (uint32_t)t;
                if (hash_u == hash_t) cand1 = (uint32_t)t;
                if (rep_ok && r_word == r_prev) {
                    // rep hit at r; try a single byte of backward extension
                    const int64_t back =
                        base[r - 1] == base[r - 1 - rep1] ? 1 : 0;
                    m_start = r - back;
                    m_len = 4 + back;
                    off_code = 0;
                    next_probe = t + 1;
                    last_probe = t;
                    found = true;
                    break;
                }
                if (cand0 >= prefixIdx &&
                    read32(base + cand0) == read32(base + t)) {
                    m_start = t;
                    rep2 = rep1;
                    rep1 = (uint32_t)(t - cand0);
                    off_code = rep1 + 2;
                    int64_t mp = cand0;
                    while (m_start > anchor && mp > (int64_t)prefixIdx &&
                           base[m_start - 1] == base[mp - 1]) {
                        m_start--;
                        mp--;
                    }
                    m_len = 4 + (t - m_start);
                    next_probe = t + 1;
                    last_probe = t;
                    found = true;
                    break;
                }
                // ---- probe t + 1 (candidate pre-loaded above) ----
                hashTable[hash_u] = (uint32_t)(t + 1);
                if (cand1 >= prefixIdx &&
                    read32(base + cand1) == read32(base + t + 1)) {
                    m_start = t + 1;
                    rep2 = rep1;
                    rep1 = (uint32_t)(t + 1 - cand1);
                    off_code = rep1 + 2;
                    int64_t mp = cand1;
                    while (m_start > anchor && mp > (int64_t)prefixIdx &&
                           base[m_start - 1] == base[mp - 1]) {
                        m_start--;
                        mp--;
                    }
                    m_len = 4 + (t + 1 - m_start);
                    next_probe = r;  // the pair we never reached
                    last_probe = t + 1;
                    found = true;
                    break;
                }
                // ---- advance to the next pair ----
                const int64_t r2 = r + s;  // next rep probe, current stride
                if (r2 >= grow_at) {
                    s++;
                    grow_at += kGrowEvery;
                }
                if (r2 + 1 >= scan_end) break;
                t = r;
                r = r2;
                hash_t = zx_hash(base + t, hlog, kMls);
                cand0 = hashTable[hash_t];
            }
        }
        if (!found) break;

        // forward extension (the match distance is rep1 on every path)
        m_len += (int64_t)zx_count(base + m_start + m_len,
                                   base + m_start + m_len - rep1,
                                   base + iend);
        zx_store_seq(ss, base + anchor, (size_t)(m_start - anchor), off_code,
                     (size_t)(m_len - 3));
        int64_t pos = m_start + m_len;
        anchor = pos;
        if (next_probe < pos)
            hashTable[zx_hash(base + next_probe, hlog, kMls)] =
                (uint32_t)next_probe;
        if (pos <= scan_end) {
            // seed the table around the gap, then chase immediate rep2 hits
            hashTable[zx_hash(base + last_probe + 2, hlog, kMls)] =
                (uint32_t)(last_probe + 2);
            hashTable[zx_hash(base + pos - 2, hlog, kMls)] =
                (uint32_t)(pos - 2);
            if (rep2 > 0) {
                while (pos <= scan_end &&
                       read32(base + pos) == read32(base + pos - rep2)) {
                    const int64_t rlen =
                        4 + (int64_t)zx_count(base + pos + 4,
                                              base + pos + 4 - rep2,
                                              base + iend);
                    const uint32_t swp = rep2;
                    rep2 = rep1;
                    rep1 = swp;
                    hashTable[zx_hash(base + pos, hlog, kMls)] =
                        (uint32_t)pos;
                    pos += rlen;
                    zx_store_seq(ss, base + anchor, 0, 0,
                                 (size_t)(rlen - 3));
                    anchor = pos;
                }
            }
        }
        t = pos;
    }

    rep[0] = rep1 ? rep1 : parked;
    rep[1] = rep2 ? rep2 : parked;
    return iend - anchor;
}

// Double-fast matcher (dfast strategy), zstd v1.5.1 decision semantics
// (ZstdDoubleFast.cs:51 documents the required behavior; the 1.5.7 oracle
// rewrote this matcher's visit/insert schedule after 1.5.1, so outputs
// agree with 1.5.4-and-earlier libzstd and can differ from 1.5.7 by a
// sequence choice on some inputs).  Reformulated like zx_fast_block:
// absolute positions, a structured segment loop, and the long-hash
// lookahead carried explicitly.  Each visited position p (lookahead
// q = p + stride, stride growing every 256 bytes) is checked in priority
// order: repcode at p+1, 8-byte long-table match at p, then a 4-byte
// short-table hit at p which is only taken if an 8-byte long match at q
// doesn't supersede it.
// kTwoWay: keep two entries per short-hash slot (recent + previous) — a
// cheap depth upgrade over the reference's single-slot table that claws
// back the ratio its rewritten 1.5.7 dfast gains; layout [2*h]=recent,
// [2*h+1]=previous (caller allocates 2<<hBitsS entries).
template <uint32_t kMls, int kTwoWay = 0>
static int64_t zx_dfast_block(const uint8_t* base, uint32_t* hashLong,
                              uint32_t hBitsL, uint32_t* hashSmall,
                              uint32_t hBitsS, uint32_t dictLimit,
                              uint32_t wlog, const uint8_t* istart,
                              int64_t srcSize, uint32_t* rep, ZxStore* ss) {
    const uint32_t endIndex = (uint32_t)((istart - base) + srcSize);
    const uint32_t maxDistance = 1u << wlog;
    const uint32_t prefixIdx =
        (endIndex - dictLimit > maxDistance) ? endIndex - maxDistance
                                             : dictLimit;
    const int64_t iend = (istart - base) + srcSize;
    const int64_t scan_end = iend - 8;
    const int64_t kGrowEvery = 256;

    // one short-table insert, honoring the optional two-deep layout
    const auto small_put = [&](size_t h, uint32_t v) {
        if (kTwoWay) {
            hashSmall[2 * h + 1] = hashSmall[2 * h];
            hashSmall[2 * h] = v;
        } else {
            hashSmall[h] = v;
        }
    };

    int64_t anchor = istart - base;
    int64_t p = anchor + (anchor == (int64_t)prefixIdx ? 1 : 0);

    uint32_t rep1 = rep[0], rep2 = rep[1];
    uint32_t parked = 0;
    {
        const uint32_t here = (uint32_t)p;
        const uint32_t low = (here - dictLimit > maxDistance)
                                 ? here - maxDistance
                                 : dictLimit;
        const uint32_t span = here - low;
        if (rep2 > span) { parked = rep2; rep2 = 0; }
        if (rep1 > span) { parked = rep1; rep1 = 0; }
    }

    for (;;) {  // one iteration per stored sequence
        int64_t s = 1;
        int64_t grow_at = p + kGrowEvery;
        int64_t q = p + s;

        int64_t m_start = 0, m_len = 0, m_dist = 0;
        uint32_t last_pos = 0;   // last visited p (seeds the +2 reinsert)
        bool is_rep = false, found = false;

        if (q <= scan_end) {
            size_t hp_long = zx_hash(base + p, hBitsL, 8);
            uint32_t cand_pl = hashLong[hp_long];
            for (;;) {
                const size_t hp_small = zx_hash(base + p, hBitsS, kMls);
                const uint32_t cand_ps = hashSmall[kTwoWay ? 2 * hp_small
                                                           : hp_small];
                const uint32_t cand_ps2 =
                    kTwoWay ? hashSmall[2 * hp_small + 1] : 0;
                last_pos = (uint32_t)p;
                hashLong[hp_long] = (uint32_t)p;
                small_put(hp_small, (uint32_t)p);

                if (rep1 > 0 &&
                    read32(base + p + 1 - rep1) == read32(base + p + 1)) {
                    m_len = 4 + (int64_t)zx_count(base + p + 1 + 4,
                                                  base + p + 1 + 4 - rep1,
                                                  base + iend);
                    m_start = p + 1;
                    is_rep = true;
                    found = true;
                    break;
                }
                const size_t hq_long = zx_hash(base + q, hBitsL, 8);
                if (cand_pl > prefixIdx &&
                    read64_fwd(base + cand_pl) == read64_fwd(base + p)) {
                    m_len = 8 + (int64_t)zx_count(base + p + 8,
                                                  base + cand_pl + 8,
                                                  base + iend);
                    m_dist = p - cand_pl;
                    m_start = p;
                    int64_t mp = cand_pl;
                    while (m_start > anchor && mp > (int64_t)prefixIdx &&
                           base[m_start - 1] == base[mp - 1]) {
                        m_start--;
                        mp--;
                        m_len++;
                    }
                    // seed the lookahead's long hash while strides are short
                    if (s < 4) hashLong[hq_long] = (uint32_t)q;
                    found = true;
                    break;
                }
                const uint32_t cand_ql = hashLong[hq_long];
                const uint32_t short_hit =
                    (cand_ps > prefixIdx &&
                     read32(base + cand_ps) == read32(base + p))
                        ? cand_ps
                        : (kTwoWay && cand_ps2 > prefixIdx &&
                           read32(base + cand_ps2) == read32(base + p))
                              ? cand_ps2
                              : 0;
                if (short_hit) {
                    // an 8-byte long match at the lookahead beats the
                    // 4-byte short match at p
                    if (cand_ql > prefixIdx &&
                        read64_fwd(base + cand_ql) == read64_fwd(base + q)) {
                        m_len = 8 + (int64_t)zx_count(base + q + 8,
                                                      base + cand_ql + 8,
                                                      base + iend);
                        m_dist = q - cand_ql;
                        m_start = q;
                        int64_t mp = cand_ql;
                        while (m_start > anchor && mp > (int64_t)prefixIdx &&
                               base[m_start - 1] == base[mp - 1]) {
                            m_start--;
                            mp--;
                            m_len++;
                        }
                    } else {
                        m_len = 4 + (int64_t)zx_count(base + p + 4,
                                                      base + short_hit + 4,
                                                      base + iend);
                        m_dist = p - short_hit;
                        m_start = p;
                        int64_t mp = short_hit;
                        while (m_start > anchor && mp > (int64_t)prefixIdx &&
                               base[m_start - 1] == base[mp - 1]) {
                            m_start--;
                            mp--;
                            m_len++;
                        }
                    }
                    // seed the lookahead's long hash while strides are short
                    if (s < 4) hashLong[hq_long] = (uint32_t)q;
                    found = true;
                    break;
                }
                // ---- advance ----
                if (q >= grow_at) {
                    s++;
                    grow_at += kGrowEvery;
                }
                p = q;
                q += s;
                hp_long = hq_long;
                cand_pl = cand_ql;
                if (q > scan_end) break;
            }
        }
        if (!found) break;

        if (is_rep) {
            zx_store_seq(ss, base + anchor, (size_t)(m_start - anchor), 0,
                         (size_t)(m_len - 3));
        } else {
            rep2 = rep1;
            rep1 = (uint32_t)m_dist;
            zx_store_seq(ss, base + anchor, (size_t)(m_start - anchor),
                         (uint32_t)m_dist + 2, (size_t)(m_len - 3));
        }
        int64_t pos = m_start + m_len;
        anchor = pos;
        if (pos <= scan_end) {
            const int64_t seed = (int64_t)last_pos + 2;
            hashLong[zx_hash(base + seed, hBitsL, 8)] = (uint32_t)seed;
            hashLong[zx_hash(base + pos - 2, hBitsL, 8)] =
                (uint32_t)(pos - 2);
            small_put(zx_hash(base + seed, hBitsS, kMls), (uint32_t)seed);
            small_put(zx_hash(base + pos - 1, hBitsS, kMls),
                      (uint32_t)(pos - 1));
            while (pos <= scan_end && rep2 > 0 &&
                   read32(base + pos) == read32(base + pos - rep2)) {
                const int64_t rlen =
                    4 + (int64_t)zx_count(base + pos + 4,
                                          base + pos + 4 - rep2,
                                          base + iend);
                const uint32_t swp = rep2;
                rep2 = rep1;
                rep1 = swp;
                small_put(zx_hash(base + pos, hBitsS, kMls), (uint32_t)pos);
                hashLong[zx_hash(base + pos, hBitsL, 8)] = (uint32_t)pos;
                zx_store_seq(ss, base + anchor, 0, 0, (size_t)(rlen - 3));
                pos += rlen;
                anchor = pos;
            }
        }
        p = pos;
    }

    rep[0] = rep1 ? rep1 : parked;
    rep[1] = rep2 ? rep2 : parked;
    return iend - anchor;
}

// --------------------------- exact Huffman build ---------------------------
// nodeElt_s (HufCompress.cs): count/parent/byte/nbBits.
// ---- Huffman code-length construction (compress side) ---------------------
// Contract: identical integer decisions to zstd v1.5.1's builder (the
// behaviors documented at HufCompress.cs:518/635/689/377: count-bucketed
// descending order with an unstable in-bucket sort above the crossover, a
// two-queue O(n) merge whose ties prefer already-merged nodes, and the
// Kraft-debt depth-limit repair).  The expression is this repo's own:
// parallel arrays instead of node structs, explicit queue-emptiness tests
// instead of sentinel elements, and the repair written from the Kraft-sum
// derivation.

// Bucket id for the descending counting sort: one bucket per exact count
// below the crossover, log2 buckets above it.  The crossover constant is
// format-behavioral (it decides which equal-count groups get the unstable
// sort and therefore the exact code assignment).
static inline uint32_t huf_bucket_of(uint32_t count) {
    const uint32_t kLogBase = 158;
    const uint32_t kCross = kLogBase + (uint32_t)highbit32(kLogBase);
    return count < kCross ? count : kLogBase + (uint32_t)highbit32(count);
}

static inline void huf_swap2(uint32_t* c, uint8_t* s, int a, int b) {
    const uint32_t tc = c[a]; c[a] = c[b]; c[b] = tc;
    const uint8_t ts = s[a]; s[a] = s[b]; s[b] = ts;
}

// Descending insertion sort over a short parallel-array run; equal keys
// keep their arrival order.
static void huf_sort_run_desc(uint32_t* c, uint8_t* s, int n) {
    for (int i = 1; i < n; i++) {
        const uint32_t kc = c[i];
        const uint8_t ks = s[i];
        int j = i;
        while (j > 0 && c[j - 1] < kc) {
            c[j] = c[j - 1];
            s[j] = s[j - 1];
            j--;
        }
        c[j] = kc;
        s[j] = ks;
    }
}

// Descending hybrid quicksort for one log-bucket [lo, hi].  Last-element
// partition, small runs finished by insertion sort; the resulting layout
// of equal counts is what the format's code assignment depends on.
static void huf_sort_bucket_desc(uint32_t* c, uint8_t* s, int lo, int hi) {
    while (hi - lo >= 8) {
        const uint32_t pivot = c[hi];
        int split = lo;
        for (int j = lo; j < hi; j++)
            if (c[j] > pivot) {
                huf_swap2(c, s, split, j);
                split++;
            }
        huf_swap2(c, s, split, hi);
        if (split - lo < hi - split) {
            huf_sort_bucket_desc(c, s, lo, split - 1);
            lo = split + 1;
        } else {
            huf_sort_bucket_desc(c, s, split + 1, hi);
            hi = split - 1;
        }
    }
    if (hi > lo) huf_sort_run_desc(c + lo, s + lo, hi - lo + 1);
}

// Order all symbols 0..max_sym by descending count into (l_cnt, l_sym):
// counting sort over huf_bucket_of, ascending symbol within a bucket,
// then the unstable descending sort inside each log bucket.
static void huf_order_leaves(uint32_t* l_cnt, uint8_t* l_sym,
                             const uint32_t* count, uint32_t max_sym) {
    uint32_t first[192];
    uint32_t at[192];
    {
        uint32_t sizes[192] = {0};
        for (uint32_t s = 0; s <= max_sym; s++)
            sizes[huf_bucket_of(count[s])]++;
        uint32_t acc = 0;
        for (int b = 191; b >= 0; b--) {
            first[b] = at[b] = acc;
            acc += sizes[b];
        }
    }
    for (uint32_t s = 0; s <= max_sym; s++) {
        const uint32_t pos = at[huf_bucket_of(count[s])]++;
        l_cnt[pos] = count[s];
        l_sym[pos] = (uint8_t)s;
    }
    const uint32_t kCross = 158 + (uint32_t)highbit32(158);
    for (uint32_t b = kCross; b < 191; b++)
        if (at[b] - first[b] > 1)
            huf_sort_bucket_desc(l_cnt, l_sym, (int)first[b],
                                 (int)at[b] - 1);
}

// Two-queue Huffman merge over the sorted leaves.  The leaf queue is the
// array consumed from its tail (ascending count); the merge queue holds
// internal nodes in creation order, which is ascending by weight by
// construction.  A tie takes the internal node.  Writes each leaf's code
// length into l_len and returns the index of the cheapest live leaf.
static int huf_merge_tree(const uint32_t* l_cnt, uint8_t* l_len,
                          uint32_t max_sym) {
    uint32_t nd_weight[256];
    uint16_t nd_up[256];
    uint8_t nd_depth[256];
    uint16_t leaf_up[256];

    int last = (int)max_sym;
    while (l_cnt[last] == 0) last--;  // callers guarantee >= 2 live symbols
    if (last == 0) {                  // defensive: degenerate single leaf
        l_len[0] = 1;
        return 0;
    }
    const int n_nodes = last;         // a tree over last+1 leaves
    int leaf = last;                  // next (cheapest) unconsumed leaf
    int take = 0;                     // next unconsumed internal node
    for (int made = 0; made < n_nodes; made++) {
        uint32_t w = 0;
        for (int half = 0; half < 2; half++) {
            const bool node_ok = take < made;
            if (leaf >= 0 && !(node_ok && nd_weight[take] <= l_cnt[leaf])) {
                w += l_cnt[leaf];
                leaf_up[leaf] = (uint16_t)made;
                leaf--;
            } else {
                w += nd_weight[take];
                nd_up[take] = (uint16_t)made;
                take++;
            }
        }
        nd_weight[made] = w;
    }
    nd_depth[n_nodes - 1] = 0;  // root
    for (int k = n_nodes - 2; k >= 0; k--)
        nd_depth[k] = (uint8_t)(nd_depth[nd_up[k]] + 1);
    for (int i = 0; i <= last; i++)
        l_len[i] = (uint8_t)(nd_depth[leaf_up[i]] + 1);
    return last;
}

// Depth-limit repair.  Clamping every over-deep leaf to `cap` bits makes
// the Kraft sum exceed 1 by `debt` units of 2^-cap after normalization;
// deepening a leaf sitting at depth cap-k by one bit releases 2^(k-1)
// units.  Policy (behavior-exact): pay with the largest denomination
// <= debt, stepping down while the candidate leaf's count is more than
// twice the next denomination's candidate; if overpaid, re-shorten
// cap-depth leaves starting from the cheapest.
static uint32_t huf_limit_depth(const uint32_t* l_cnt, uint8_t* l_len,
                                int last, uint32_t cap) {
    const uint32_t deepest = l_len[last];
    if (deepest <= cap) return deepest;

    const int over = (int)(deepest - cap);
    int debt = 0;
    int i = last;
    for (; l_len[i] > cap; i--) {
        debt += (1 << over) - (1 << (deepest - l_len[i]));
        l_len[i] = (uint8_t)cap;
    }
    while (l_len[i] == cap) i--;
    debt >>= over;

    // edge[k] = highest index (cheapest leaf) currently at depth cap-k,
    // or -1 when that depth is unoccupied.
    int edge[14];
    for (int k = 0; k < 14; k++) edge[k] = -1;
    {
        uint32_t depth = cap;
        for (int pos = i; pos >= 0; pos--) {
            if (l_len[pos] >= depth) continue;
            depth = l_len[pos];
            edge[cap - depth] = pos;
        }
    }

    while (debt > 0) {
        uint32_t k = (uint32_t)highbit32((uint32_t)debt) + 1;
        for (; k > 1; k--) {
            const int cand = edge[k];
            const int below = edge[k - 1];
            if (cand < 0) continue;
            if (below < 0) break;
            if (l_cnt[cand] <= 2 * l_cnt[below]) break;
        }
        while (k <= 12 && edge[k] < 0) k++;
        debt -= 1 << (k - 1);
        const int move = edge[k];
        l_len[move]++;  // now at depth cap-k+1
        if (edge[k - 1] < 0) edge[k - 1] = move;
        if (move == 0) {
            edge[k] = -1;
        } else {
            edge[k] = move - 1;
            if (l_len[move - 1] != (uint8_t)(cap - k)) edge[k] = -1;
        }
    }
    while (debt < 0) {
        // give a bit back: prefer the tracked cap-depth edge, else rescan
        if (edge[1] < 0) {
            while (l_len[i] == cap) i--;
            l_len[i + 1]--;
            edge[1] = i + 1;
        } else {
            l_len[edge[1] + 1]--;
            edge[1]++;
        }
        debt++;
    }
    return cap;
}

// Full pipeline into HufCTableC.  Returns the used table log or -1.
static int zx_huf_build_ctable(HufCTableC* ct, const uint32_t* count,
                               uint32_t maxSymbolValue, uint32_t maxNbBits) {
    if (maxNbBits == 0) maxNbBits = 11;
    if (maxSymbolValue > 255) return -1;
    uint32_t l_cnt[256];
    uint8_t l_sym[256];
    uint8_t l_len[256] = {0};
    huf_order_leaves(l_cnt, l_sym, count, maxSymbolValue);
    const int last = huf_merge_tree(l_cnt, l_len, maxSymbolValue);
    maxNbBits = huf_limit_depth(l_cnt, l_len, last, maxNbBits);
    if (maxNbBits > 12) return -1;
    uint8_t lengths[256] = {0};
    for (int n = 0; n <= last; n++) lengths[l_sym[n]] = l_len[n];
    huf_canonical(ct, lengths, (int)maxSymbolValue);
    ct->tlog = (int)maxNbBits;  // exact cap, even if below the observed max
    return (int)maxNbBits;
}

// FSE_optimalTableLog_internal:397 (minus=2 for FSE, 1 for HUF).
static uint32_t zx_optimal_table_log(uint32_t maxTableLog, uint64_t srcSize,
                                     uint32_t maxSymbolValue, uint32_t minus) {
    uint32_t maxBitsSrc = (uint32_t)highbit32((uint32_t)(srcSize - 1)) - minus;
    uint32_t tableLog = maxTableLog;
    const uint32_t minBitsSrc = (uint32_t)highbit32((uint32_t)srcSize) + 1;
    const uint32_t minBitsSymbols = (uint32_t)highbit32(maxSymbolValue) + 2;
    const uint32_t minBits =
        minBitsSrc < minBitsSymbols ? minBitsSrc : minBitsSymbols;
    if (tableLog == 0) tableLog = 11;
    if (maxBitsSrc < tableLog) tableLog = maxBitsSrc;
    if (minBits > tableLog) tableLog = minBits;
    if (tableLog < 5) tableLog = 5;
    if (tableLog > 12) tableLog = 12;
    return tableLog;
}

// HUF_estimateCompressedSize:877 / HUF_validateCTable:889.
static uint64_t zx_huf_estimate(const HufCTableC* ct, const uint32_t* count,
                                uint32_t maxSymbolValue) {
    uint64_t nbBits = 0;
    for (uint32_t s = 0; s <= maxSymbolValue; s++)
        nbBits += (uint64_t)ct->nbits[s] * count[s];
    return nbBits >> 3;
}
static int zx_huf_validate(const HufCTableC* ct, const uint32_t* count,
                           uint32_t maxSymbolValue) {
    if ((uint32_t)ct->max_sym < maxSymbolValue) return 0;
    for (uint32_t s = 0; s <= maxSymbolValue; s++)
        if (count[s] != 0 && ct->nbits[s] == 0) return 0;
    return 1;
}

// HUF_writeCTable_wksp:168 (exact flow, incl. HUF_compressWeights:40).
static int64_t zx_huf_write_ctable(uint8_t* op, int64_t cap,
                                   const HufCTableC* ct,
                                   uint32_t maxSymbolValue, uint32_t huffLog) {
    // weight = huffLog + 1 - nbits (0 stays 0): shorter codes weigh more
    uint8_t wt[256 + 1];
    uint8_t len_to_weight[13];
    len_to_weight[0] = 0;
    for (uint32_t n = 1; n < huffLog + 1; n++)
        len_to_weight[n] = (uint8_t)(huffLog + 1 - n);
    for (uint32_t n = 0; n < maxSymbolValue; n++)
        wt[n] = len_to_weight[ct->nbits[n]];
    if (cap < 1) return -1;
    // HUF_compressWeights: FSE with maxSymbolValue<=12, tableLog start 6.
    {
        const int64_t wtSize = (int64_t)maxSymbolValue;
        if (wtSize > 1) {
            uint32_t wcount[13] = {0};
            uint32_t wmax = 0, maxCount = 0;
            for (int64_t i = 0; i < wtSize; i++) {
                wcount[wt[i]]++;
                if (wt[i] > wmax) wmax = wt[i];
            }
            for (uint32_t w = 0; w <= wmax; w++)
                if (wcount[w] > maxCount) maxCount = wcount[w];
            if (maxCount != (uint32_t)wtSize && maxCount != 1) {
                const uint32_t tableLog =
                    zx_optimal_table_log(6, (uint64_t)wtSize, wmax, 2);
                int16_t norm[13];
                uint8_t buf[256];
                if (fse_normalize(norm, (int)tableLog, wcount,
                                  wtSize, (int)wmax, 0) == 0) {
                    const int64_t nc = fse_write_ncount(
                        buf, sizeof buf, norm, (int)wmax, (int)tableLog);
                    if (nc > 0) {
                        FseCTableC wct;
                        fse_build_ctable_c(&wct, norm, (int)wmax,
                                           (int)tableLog);
                        const int64_t b = fse_compress_2state(
                            wt, wtSize, &wct, buf + nc,
                            (int64_t)sizeof buf - nc);
                        if (b > 0 && nc + b < wtSize) {
                            const int64_t hSize = nc + b;
                            if (hSize > 1 &&
                                hSize < (int64_t)(maxSymbolValue / 2)) {
                                if (hSize + 1 > cap) return -1;
                                op[0] = (uint8_t)hSize;
                                std::memcpy(op + 1, buf, (size_t)hSize);
                                return hSize + 1;
                            }
                        }
                    }
                }
            }
        }
    }
    if (maxSymbolValue > 128) return -1;
    const int64_t nb = ((int64_t)maxSymbolValue + 1) / 2 + 1;
    if (nb > cap) return -1;
    op[0] = (uint8_t)(128 + (maxSymbolValue - 1));
    wt[maxSymbolValue] = 0;
    for (uint32_t n = 0; n < maxSymbolValue; n += 2)
        op[n / 2 + 1] = (uint8_t)((wt[n] << 4) + wt[n + 1]);
    return nb;
}

// HUF stream encode via the oracle-validated writers; applies the
// per-segment <=65535 checks and the compressCTable_internal bail-outs.
static int64_t zx_huf_streams(uint8_t* op, int64_t cap, const uint8_t* src,
                              int64_t srcSize, int fourStreams,
                              const HufCTableC* ct, int64_t tableHeaderSize) {
    int64_t cSize;
    if (!fourStreams) {
        if (cap < 8) return 0;
        cSize = huf_encode_stream(src, srcSize, ct->code, ct->nbits, op, cap);
        if (cSize < 0) return 0;
    } else {
        if (cap < 6 + 1 + 1 + 1 + 8) return 0;
        if (srcSize < 12) return 0;
        cSize = huf_encode_4streams(src, srcSize, ct->code, ct->nbits, op, cap);
        if (cSize < 0) return 0;
    }
    if (cSize == 0) return 0;
    // HUF_compressCTable_internal:1332 — table bytes count toward the bound
    if (tableHeaderSize + cSize >= srcSize - 1) return 0;
    return cSize;
}

// HUF_compress_internal:1360 driver.  Returns the literal payload size
// (0 = incompressible, 1 = RLE), updates *hufCT/*repeat like the reference
// updates oldHufTable/repeat.  usedRepeat reports whether the emitted
// stream used the previous table (hType = set_repeat).
static int64_t zx_huf_compress(uint8_t* op, int64_t cap, const uint8_t* src,
                               int64_t srcSize, int fourStreams,
                               HufCTableC* hufCT, int* repeat,
                               int preferRepeat, int suspectUncompressible,
                               int* usedRepeat) {
    *usedRepeat = 0;
    if (srcSize == 0 || cap == 0) return 0;
    if (preferRepeat && *repeat == 2) {
        *usedRepeat = 1;
        return zx_huf_streams(op, cap, src, srcSize, fourStreams, hufCT, 0);
    }
    if (suspectUncompressible && srcSize >= 4096 * 10) {
        uint64_t largestTotal = 0;
        for (int half = 0; half < 2; half++) {
            const uint8_t* p = half ? src + srcSize - 4096 : src;
            uint32_t cnt[256] = {0};
            uint32_t largest = 0;
            for (int i = 0; i < 4096; i++) cnt[p[i]]++;
            for (int s = 0; s < 256; s++)
                if (cnt[s] > largest) largest = cnt[s];
            largestTotal += largest;
        }
        if (largestTotal <= ((2 * 4096) >> 7) + 4) return 0;
    }
    uint32_t cnt4[4][256] = {{0}};
    {
        int64_t i = 0;
        for (; i + 4 <= srcSize; i += 4) {
            cnt4[0][src[i]]++;
            cnt4[1][src[i + 1]]++;
            cnt4[2][src[i + 2]]++;
            cnt4[3][src[i + 3]]++;
        }
        for (; i < srcSize; i++) cnt4[0][src[i]]++;
    }
    uint32_t count[256];
    for (int s = 0; s < 256; s++)
        count[s] = cnt4[0][s] + cnt4[1][s] + cnt4[2][s] + cnt4[3][s];
    uint32_t maxSymbolValue = 255;
    while (maxSymbolValue > 0 && count[maxSymbolValue] == 0) maxSymbolValue--;
    uint32_t largest = 0;
    for (uint32_t s = 0; s <= maxSymbolValue; s++)
        if (count[s] > largest) largest = count[s];
    if ((int64_t)largest == srcSize) {
        op[0] = src[0];
        return 1;
    }
    if ((int64_t)largest <= (srcSize >> 7) + 4) return 0;
    if (*repeat == 1 && !zx_huf_validate(hufCT, count, maxSymbolValue))
        *repeat = 0;
    if (preferRepeat && *repeat != 0) {
        *usedRepeat = 1;
        return zx_huf_streams(op, cap, src, srcSize, fourStreams, hufCT, 0);
    }
    uint32_t huffLog =
        zx_optimal_table_log(11, (uint64_t)srcSize, maxSymbolValue, 1);
    HufCTableC newCT;
    std::memset(&newCT, 0, sizeof newCT);
    const int maxBits =
        zx_huf_build_ctable(&newCT, count, maxSymbolValue, huffLog);
    if (maxBits < 0) return -1;
    huffLog = (uint32_t)maxBits;
    const int64_t hSize =
        zx_huf_write_ctable(op, cap, &newCT, maxSymbolValue, huffLog);
    if (hSize < 0) return -1;
    if (*repeat != 0) {
        const uint64_t oldSize = zx_huf_estimate(hufCT, count, maxSymbolValue);
        const uint64_t newSize = zx_huf_estimate(&newCT, count, maxSymbolValue);
        if (oldSize <= (uint64_t)hSize + newSize ||
            hSize + 12 >= srcSize) {
            *usedRepeat = 1;
            return zx_huf_streams(op, cap, src, srcSize, fourStreams, hufCT, 0);
        }
    }
    if (hSize + 12 >= srcSize) return 0;
    *repeat = 0;
    *hufCT = newCT;
    const int64_t c = zx_huf_streams(op + hSize, cap - hSize, src, srcSize,
                                     fourStreams, &newCT, hSize);
    if (c == 0) return 0;
    return hSize + c;
}

// Per-channel FSE state carried across blocks.
struct ZxFseCh {
    FseCTableC ct;
    int maxSym;   // max symbol the table supports (for fseBitCost)
    int rep;      // 0 none, 1 check, 2 valid
};
struct ZxHufS {
    HufCTableC ct;
    int rep;
};
struct ZxEntropy {
    ZxHufS huf;
    ZxFseCh ll, of, ml;
    uint32_t repcodes[3];
};

// Table-mode cost model.  Four candidate encodings per sequence channel
// (predefined / RLE / fresh FSE / repeat previous); each cost below is an
// estimated payload size in bytes for one candidate, all derived from the
// same 1/256-granular -log2 lookup so the comparisons are exact integer
// decisions (behavior documented at ZstdCompressSequences.cs:314-467).
static const int64_t kZxErr = (int64_t)1 << 60;

// bytes if coded with an ideal table built from these very counts
static int64_t cost_fresh_table(const uint32_t* count, uint32_t max,
                                uint64_t total) {
    uint64_t bits256 = 0;
    for (uint32_t s = 0; s <= max; s++) {
        uint32_t p256 = (uint32_t)((256 * (uint64_t)count[s]) / total);
        if (count[s] != 0 && p256 == 0) p256 = 1;
        bits256 += (uint64_t)count[s] * kZxInvProbLog256[p256];
    }
    return (int64_t)(bits256 >> 8);
}

// bytes if coded with the format's predefined distribution
static int64_t cost_predefined(const int16_t* norm, uint32_t normLog,
                               const uint32_t* count, uint32_t max) {
    const uint32_t widen = 8 - normLog;  // rescale norm to 1/256 units
    uint64_t bits256 = 0;
    for (uint32_t s = 0; s <= max; s++) {
        const uint32_t w = norm[s] != -1 ? (uint32_t)norm[s] : 1;
        bits256 += (uint64_t)count[s] * kZxInvProbLog256[w << widen];
    }
    return (int64_t)(bits256 >> 8);
}

// bytes if coded with the previous block's live table (kZxErr when that
// table cannot represent a present symbol or prices one absurdly)
static int64_t cost_prev_table(const ZxFseCh* ch, const uint32_t* count,
                               uint32_t max) {
    if ((uint32_t)ch->maxSym < max) return kZxErr;
    const uint32_t tlog = (uint32_t)ch->ct.tlog;
    uint64_t bits256 = 0;
    for (uint32_t s = 0; s <= max; s++) {
        if (count[s] == 0) continue;
        // per-symbol fractional bit cost recovered from the CTable's
        // deltaNbBits encoding: cost = maxNbBits - frac(states below the
        // threshold), in 1/256 bit units
        const uint32_t dnb = ch->ct.delta_nb[s];
        const uint32_t floor_bits = dnb >> 16;
        const uint32_t thresh = (floor_bits + 1) << 16;
        const uint32_t below = thresh - (dnb + (1u << tlog));
        const uint32_t frac256 = (below << 8) >> tlog;
        const uint32_t bits = ((floor_bits + 1) << 8) - frac256;
        if (bits >= ((tlog + 1) << 8)) return kZxErr;
        bits256 += (uint64_t)count[s] * bits;
    }
    return (int64_t)(bits256 >> 8);
}

// serialized NCount header size for a fresh table over these counts
static int64_t cost_table_header(const uint32_t* count, uint32_t max,
                                 uint64_t nbSeq, uint32_t fseLog) {
    const uint32_t tlog = zx_optimal_table_log(fseLog, nbSeq, max, 2);
    int16_t norm[53];
    uint32_t cnt[53];
    std::memcpy(cnt, count, sizeof(uint32_t) * (max + 1));
    if (fse_normalize(norm, (int)tlog, cnt, (int64_t)nbSeq, (int)max,
                      nbSeq >= 2048 ? 1 : 0) != 0)
        return kZxErr;
    uint8_t wksp[512];
    const int64_t sz =
        fse_write_ncount(wksp, sizeof wksp, norm, (int)max, (int)tlog);
    return sz < 0 ? kZxErr : sz;
}

// Pick a channel's table mode.  Fast strategies decide by cheap count
// heuristics; btlazy+ strategies price all candidates through the cost
// model above.  Returns 0 basic, 1 rle, 2 compressed, 3 repeat, and
// updates the channel's repeat state.
static int zx_select_encoding(int* repeatMode, const uint32_t* count,
                              uint32_t max, uint64_t peak, uint64_t nbSeq,
                              uint32_t fseLog, const ZxFseCh* prevCh,
                              const int16_t* defaultNorm,
                              uint32_t defaultNormLog, int defaultAllowed,
                              int strategy) {
    if (peak == nbSeq) {  // single distinct symbol
        *repeatMode = 0;
        // tiny single-symbol runs fit the predefined table's header-free
        // coding better than an RLE byte
        return (defaultAllowed && nbSeq <= 2) ? 0 : 1;
    }
    if (strategy < 4 /* < ZSTD_lazy: heuristic tier */) {
        if (defaultAllowed) {
            const uint64_t kRepeatSeqMax = 1000;
            // a fresh table amortizes only past this many sequences,
            // scaled by how cheap the strategy is
            const uint64_t freshFloor =
                ((1ULL << defaultNormLog) * (uint64_t)(10 - strategy)) >> 3;
            if (*repeatMode == 2 && nbSeq < kRepeatSeqMax) return 3;
            if (nbSeq < freshFloor ||
                peak < (nbSeq >> (defaultNormLog - 1))) {
                *repeatMode = 0;
                return 0;
            }
        }
    } else {
        const int64_t c_basic =
            defaultAllowed
                ? cost_predefined(defaultNorm, defaultNormLog, count, max)
                : kZxErr;
        const int64_t c_repeat =
            *repeatMode != 0 ? cost_prev_table(prevCh, count, max) : kZxErr;
        const int64_t c_fresh =
            (cost_table_header(count, max, nbSeq, fseLog) << 3)
            + cost_fresh_table(count, max, nbSeq);
        if (c_basic <= c_repeat && c_basic <= c_fresh) {
            *repeatMode = 0;
            return 0;
        }
        if (c_repeat <= c_fresh) return 3;
    }
    *repeatMode = 1;  // fresh table: verify before reuse next block
    return 2;
}

// FSE_buildCTable_rle role.
static void zx_fse_rle_ctable(FseCTableC* ct, uint8_t symbol) {
    std::memset(ct->state_table, 0, sizeof(uint16_t) * 2);
    ct->delta_nb[symbol] = 0;
    ct->delta_fs[symbol] = 0;
    ct->tlog = 0;
}

// ZSTD_buildCTable:471 — writes the NCount header (if any) and fills the
// channel's CTable.  Returns header bytes or -1.
static int64_t zx_build_seq_ctable(uint8_t* op, int64_t cap, ZxFseCh* ch,
                                   uint32_t FSELog, int type, uint32_t* count,
                                   uint32_t max, uint8_t firstCode,
                                   uint8_t lastCode,
                                   uint64_t nbSeq, const int16_t* defaultNorm,
                                   uint32_t defaultNormLog,
                                   uint32_t defaultMax) {
    switch (type) {
        case 1: {  // set_rle
            if (cap == 0) return -1;
            zx_fse_rle_ctable(&ch->ct, (uint8_t)max);
            ch->maxSym = (int)max;
            *op = firstCode;
            return 1;
        }
        case 3:  // set_repeat: keep previous table (already in ch)
            return 0;
        case 0: {  // set_basic
            fse_build_ctable_c(&ch->ct, defaultNorm, (int)defaultMax,
                               (int)defaultNormLog);
            ch->maxSym = (int)defaultMax;
            return 0;
        }
        default: {  // set_compressed
            uint64_t nbSeq_1 = nbSeq;
            const uint32_t tableLog =
                zx_optimal_table_log(FSELog, nbSeq, max, 2);
            if (count[lastCode] > 1) {
                count[lastCode]--;
                nbSeq_1--;
            }
            int16_t norm[53];
            if (fse_normalize(norm, (int)tableLog, count, (int64_t)nbSeq_1,
                              (int)max, nbSeq_1 >= 2048 ? 1 : 0) != 0)
                return -1;
            const int64_t NCountSize =
                fse_write_ncount(op, cap, norm, (int)max, (int)tableLog);
            if (NCountSize < 0) return -1;
            fse_build_ctable_c(&ch->ct, norm, (int)max, (int)tableLog);
            ch->maxSym = (int)max;
            return NCountSize;
        }
    }
}

// ZSTD_minGain:137.
static inline int64_t zx_min_gain(int64_t srcSize, int strat) {
    const int minlog = strat >= 8 /* btultra */ ? strat - 1 : 6;
    return (srcSize >> minlog) + 2;
}

// ZSTD_compressLiterals (ZstdCompressLiterals.cs:86).  prev/next semantics:
// nextHuf starts as a copy of prevHuf and is restored on raw/rle outcomes.
static int64_t zx_compress_literals(const ZxHufS* prevHuf, ZxHufS* nextHuf,
                                    int strategy, uint8_t* op, int64_t cap,
                                    const uint8_t* lit, int64_t srcSize,
                                    int suspectUncompressible,
                                    int litDisabled) {
    const int64_t minGain = zx_min_gain(srcSize, strategy);
    const int64_t lhSize =
        3 + (srcSize >= 1024 ? 1 : 0) + (srcSize >= 16 * 1024 ? 1 : 0);
    int singleStream = srcSize < 256;
    int hType = 2;  // set_compressed
    int64_t cLitSize;
    *nextHuf = *prevHuf;
    // ZSTD_literalsCompressionIsDisabled auto rule (CompressInternal.cs:168):
    // fast strategy with targetLength > 0 (negative levels) stores raw.
    if (litDisabled) goto _raw;
    {
        const int64_t minLitSize = prevHuf->rep == 2 ? 6 : 63;
        if (srcSize <= minLitSize)
            goto _raw;
    }
    if (cap < lhSize + 1) return -1;
    {
        int repeat = prevHuf->rep;
        const int preferRepeat =
            strategy < 4 /* lazy */ ? (srcSize <= 1024) : 0;
        if (repeat == 2 && lhSize == 3) singleStream = 1;
        int usedRepeat = 0;
        cLitSize = zx_huf_compress(op + lhSize, cap - lhSize, lit, srcSize,
                                   singleStream ? 0 : 1, &nextHuf->ct, &repeat,
                                   preferRepeat, suspectUncompressible,
                                   &usedRepeat);
        nextHuf->rep = repeat;
        if (usedRepeat && repeat != 0) hType = 3;  // set_repeat
    }
    if (cLitSize <= 0 || cLitSize >= srcSize - minGain) {
        *nextHuf = *prevHuf;
        goto _raw;
    }
    if (cLitSize == 1) {
        *nextHuf = *prevHuf;
        // RLE literals block (ZSTD_compressRleLiteralsBlock:49)
        const int64_t flSize =
            1 + (srcSize > 31 ? 1 : 0) + (srcSize > 4095 ? 1 : 0);
        if (flSize == 1)
            op[0] = (uint8_t)(1 /*set_rle*/ + (srcSize << 3));
        else if (flSize == 2) {
            const uint16_t v = (uint16_t)(1 + (1 << 2) + (srcSize << 4));
            std::memcpy(op, &v, 2);
        } else {
            const uint32_t v = (uint32_t)(1 + (3 << 2) + (srcSize << 4));
            std::memcpy(op, &v, 4);
        }
        op[flSize] = lit[0];
        return flSize + 1;
    }
    if (hType == 2) nextHuf->rep = 1;  // HUF_repeat_check
    switch (lhSize) {
        case 3: {
            const uint32_t lhc = (uint32_t)(hType + ((singleStream ? 0 : 1) << 2)) +
                                 ((uint32_t)srcSize << 4) +
                                 ((uint32_t)cLitSize << 14);
            op[0] = (uint8_t)lhc;
            op[1] = (uint8_t)(lhc >> 8);
            op[2] = (uint8_t)(lhc >> 16);
            break;
        }
        case 4: {
            const uint32_t lhc = (uint32_t)(hType + (2 << 2)) +
                                 ((uint32_t)srcSize << 4) +
                                 ((uint32_t)cLitSize << 18);
            std::memcpy(op, &lhc, 4);
            break;
        }
        default: {
            const uint32_t lhc = (uint32_t)(hType + (3 << 2)) +
                                 ((uint32_t)srcSize << 4) +
                                 ((uint32_t)cLitSize << 22);
            std::memcpy(op, &lhc, 4);
            op[4] = (uint8_t)(cLitSize >> 10);
            break;
        }
    }
    return lhSize + cLitSize;

_raw: {
    // ZSTD_noCompressLiterals:8
    const int64_t flSize =
        1 + (srcSize > 31 ? 1 : 0) + (srcSize > 4095 ? 1 : 0);
    if (srcSize + flSize > cap) return -1;
    if (flSize == 1)
        op[0] = (uint8_t)(0 /*set_basic*/ + (srcSize << 3));
    else if (flSize == 2) {
        const uint16_t v = (uint16_t)(0 + (1 << 2) + (srcSize << 4));
        std::memcpy(op, &v, 2);
    } else {
        const uint32_t v = (uint32_t)(0 + (3 << 2) + (srcSize << 4));
        std::memcpy(op, &v, 4);
    }
    std::memcpy(op + flSize, lit, (size_t)srcSize);
    return srcSize + flSize;
}
}

// ZSTD_entropyCompressSeqStore_internal:3236 + the :3357 wrapper.
static int64_t zx_entropy_compress(const ZxStore* ss, const ZxEntropy* prev,
                                   ZxEntropy* next, int strategy,
                                   uint8_t* dst, int64_t cap,
                                   int64_t srcSize, int litDisabled = 0) {
    codec_init();
    uint8_t* const ostart = dst;
    uint8_t* op = dst;
    const int64_t nbSeq = ss->nseq;
    int64_t tail_count_fix = 0;

    // literals
    {
        const uint64_t numLiterals = (uint64_t)ss->nlit;
        const int suspect =
            (nbSeq == 0) ||
            (numLiterals / (uint64_t)(nbSeq ? nbSeq : 1) >= 20);
        const int64_t t0 = prof_on() ? prof_now() : 0;
        const int64_t cSize = zx_compress_literals(
            &prev->huf, &next->huf, strategy, op, cap, ss->lit, ss->nlit,
            suspect, litDisabled);
        if (prof_on()) g_prof[2] += prof_now() - t0;
        if (cSize < 0) return -1;
        op += cSize;
    }
    // nbSeq header
    if (cap - (op - ostart) < 4) return -1;
    if (nbSeq < 128) {
        *op++ = (uint8_t)nbSeq;
    } else if (nbSeq < 0x7F00) {
        op[0] = (uint8_t)((nbSeq >> 8) + 0x80);
        op[1] = (uint8_t)nbSeq;
        op += 2;
    } else {
        op[0] = 0xFF;
        const uint16_t v = (uint16_t)(nbSeq - 0x7F00);
        std::memcpy(op + 1, &v, 2);
        op += 3;
    }
    if (nbSeq == 0) {
        next->ll = prev->ll;
        next->of = prev->of;
        next->ml = prev->ml;
        return op - ostart;
    }

    // seqToCodes (ZstdCompress.cs:3069)
    static thread_local uint8_t llc[(1 << 17) / 3 + 64];
    static thread_local uint8_t ofc[(1 << 17) / 3 + 64];
    static thread_local uint8_t mlc[(1 << 17) / 3 + 64];
    static thread_local uint32_t llv[(1 << 17) / 3 + 64];
    static thread_local uint32_t mlv[(1 << 17) / 3 + 64];
    static thread_local uint32_t obv[(1 << 17) / 3 + 64];
    // two-lane split counters keep the histogram increments off the
    // store-forwarding critical path (HIST_count_parallel_wksp rationale)
    uint32_t llcnt[36] = {0}, ofcnt[32] = {0}, mlcnt[53] = {0};
    {
        uint32_t ll2[36] = {0}, of2[32] = {0}, ml2[53] = {0};
        int64_t i = 0;
        for (; i + 2 <= nbSeq; i += 2) {
            const ZxSeq a = ss->seq[i], b = ss->seq[i + 1];
            const uint8_t la = (uint8_t)zx_llcode(a.ll);
            const uint8_t oa = (uint8_t)highbit32(a.offBase);
            const uint8_t ma = (uint8_t)zx_mlcode(a.ml);
            const uint8_t lb = (uint8_t)zx_llcode(b.ll);
            const uint8_t ob_ = (uint8_t)highbit32(b.offBase);
            const uint8_t mb = (uint8_t)zx_mlcode(b.ml);
            llc[i] = la; ofc[i] = oa; mlc[i] = ma;
            llv[i] = a.ll; mlv[i] = a.ml; obv[i] = a.offBase;
            llc[i + 1] = lb; ofc[i + 1] = ob_; mlc[i + 1] = mb;
            llv[i + 1] = b.ll; mlv[i + 1] = b.ml; obv[i + 1] = b.offBase;
            llcnt[la]++; ofcnt[oa]++; mlcnt[ma]++;
            ll2[lb]++; of2[ob_]++; ml2[mb]++;
        }
        for (; i < nbSeq; i++) {
            const ZxSeq a = ss->seq[i];
            const uint8_t la = (uint8_t)zx_llcode(a.ll);
            const uint8_t oa = (uint8_t)highbit32(a.offBase);
            const uint8_t ma = (uint8_t)zx_mlcode(a.ml);
            llc[i] = la; ofc[i] = oa; mlc[i] = ma;
            llv[i] = a.ll; mlv[i] = a.ml; obv[i] = a.offBase;
            llcnt[la]++; ofcnt[oa]++; mlcnt[ma]++;
        }
        for (int s = 0; s < 36; s++) llcnt[s] += ll2[s];
        for (int s = 0; s < 32; s++) ofcnt[s] += of2[s];
        for (int s = 0; s < 53; s++) mlcnt[s] += ml2[s];
    }
    if (ss->llt == 1) {
        llcnt[llc[ss->lltPos]]--;
        llc[ss->lltPos] = 35;
        llcnt[35]++;
    }
    if (ss->llt == 2) {
        mlcnt[mlc[ss->lltPos]]--;
        mlc[ss->lltPos] = 52;
        mlcnt[52]++;
    }

    uint8_t* const seqHead = op++;
    // One pass per sequence channel, table-driven (the reference spells the
    // three channels out longhand; the decisions per channel are identical).
    int chMode[3];
    {
        struct ChanDesc {
            uint32_t* hist;         // raw code histogram for this block
            uint32_t nSym;          // histogram size
            const ZxFseCh* prevCh;
            ZxFseCh* nextCh;
            const uint8_t* codes;
            uint32_t fseLog;
            const int16_t* defNorm;
            uint32_t defLog;
            uint32_t defMax;
        };
        ChanDesc chan[3] = {
            {llcnt, 36, &prev->ll, &next->ll, llc, 9, kLLNorm, 6, 35},
            {ofcnt, 32, &prev->of, &next->of, ofc, 8, kOFNorm, 5, 28},
            {mlcnt, 53, &prev->ml, &next->ml, mlc, 9, kMLNorm, 6, 52},
        };
        for (int ci = 0; ci < 3; ci++) {
            ChanDesc* const d = &chan[ci];
            uint32_t count[53];
            std::memcpy(count, d->hist, sizeof(uint32_t) * d->nSym);
            uint32_t max = d->nSym - 1;
            while (max > 0 && count[max] == 0) max--;
            uint32_t peak = 0;
            for (uint32_t s = 0; s <= max; s++)
                if (count[s] > peak) peak = count[s];
            // the offset channel loses its predefined table beyond 28
            // distance codes (the default norm doesn't cover them)
            const int defaultAllowed = ci == 1 ? max <= d->defMax : 1;
            *d->nextCh = *d->prevCh;
            chMode[ci] = zx_select_encoding(
                &d->nextCh->rep, count, max, peak, (uint64_t)nbSeq,
                d->fseLog, d->prevCh, d->defNorm, d->defLog, defaultAllowed,
                strategy);
            const int64_t hdrSize = zx_build_seq_ctable(
                op, cap - (op - ostart), d->nextCh, d->fseLog, chMode[ci],
                count, max, d->codes[0], d->codes[nbSeq - 1],
                (uint64_t)nbSeq, d->defNorm, d->defLog, d->defMax);
            if (hdrSize < 0) return -1;
            if (chMode[ci] == 2) tail_count_fix = hdrSize;
            op += hdrSize;
        }
    }
    const int LLtype = chMode[0], Offtype = chMode[1], MLtype = chMode[2];
    *seqHead = (uint8_t)((LLtype << 6) + (Offtype << 4) + (MLtype << 2));

    // interleaved FSE bitstream via the oracle-validated writer
    {
        const int64_t t1 = prof_on() ? prof_now() : 0;
        const int64_t bitstreamSize = encode_sequences(
            llv, mlv, obv, llc, mlc, ofc, kLLBits, kMLBits, nbSeq,
            next->ll.ct.state_table, next->ll.ct.delta_nb,
            next->ll.ct.delta_fs, next->ll.ct.tlog,
            next->of.ct.state_table, next->of.ct.delta_nb,
            next->of.ct.delta_fs, next->of.ct.tlog,
            next->ml.ct.state_table, next->ml.ct.delta_nb,
            next->ml.ct.delta_fs, next->ml.ct.tlog, op,
            cap - (op - ostart));
        if (prof_on()) g_prof[3] += prof_now() - t1;
        if (bitstreamSize < 0) return -1;
        op += bitstreamSize;
        if (tail_count_fix != 0 && tail_count_fix + bitstreamSize < 4)
            return 0;
    }
    return op - ostart;
}


// ---------------------------------------------------------------------------
// TRUE SUPERBLOCK EMISSION (targetCBlockSize; ZstdCompressSuperblock.cs:
// ZSTD_compressSuperBlock:584, ZSTD_compressSubBlock_multi:445,
// ZSTD_compressSubBlock_literal:27, ZSTD_compressSubBlock_sequences:155,
// ZSTD_buildBlockEntropyStats_literals role).  One entropy table set is
// built for the whole block; sub-blocks around targetCBlockSize share it —
// the first carries the serialized tables, the rest use repeat modes.
// ---------------------------------------------------------------------------

static inline void zx_updateRep3(const uint32_t* rep, uint32_t offset,
                                 uint32_t ll0, uint32_t* out);

struct ZxSbMeta {
    int hType;               // 0 basic, 1 rle, 2 compressed, 3 repeat
    uint8_t hufDes[200];
    int64_t huf_hdr_bytes;
    int llType, ofType, mlType;
    uint8_t fseTables[256];
    int64_t fse_hdr_bytes;
    int64_t tail_count_fix;
};

// ZSTD_buildBlockEntropyStats_literals (ZstdCompress.cs) over a
// pre-computed byte histogram (the splitter estimates chunks from counts).
static int zx_stats_lit_counts(const uint32_t* count, int64_t litSize,
                               const ZxHufS* prevHuf, ZxHufS* nextHuf,
                               ZxSbMeta* m) {
    *nextHuf = *prevHuf;
    m->huf_hdr_bytes = 0;
    const int64_t minLitSize = prevHuf->rep == 2 ? 6 : 63;
    if (litSize <= minLitSize) { m->hType = 0; return 0; }
    uint32_t maxSym = 255;
    while (maxSym > 0 && count[maxSym] == 0) maxSym--;
    uint64_t largest = 0;
    for (uint32_t s = 0; s <= maxSym; s++)
        if (count[s] > largest) largest = count[s];
    if ((int64_t)largest == litSize) { m->hType = 1; return 0; }
    if ((int64_t)largest <= (litSize >> 7) + 4) { m->hType = 0; return 0; }
    int repeat = prevHuf->rep;
    if (repeat == 1 && !zx_huf_validate(&prevHuf->ct, count, maxSym))
        repeat = 0;
    uint32_t huffLog =
        zx_optimal_table_log(11, (uint64_t)litSize, maxSym, 1);
    HufCTableC newCT;
    std::memset(&newCT, 0, sizeof newCT);
    const int maxBits = zx_huf_build_ctable(&newCT, count, maxSym, huffLog);
    if (maxBits < 0) return -1;
    huffLog = (uint32_t)maxBits;
    const uint64_t newCSize = zx_huf_estimate(&newCT, count, maxSym);
    const int64_t hSize =
        zx_huf_write_ctable(m->hufDes, sizeof m->hufDes, &newCT, maxSym,
                            huffLog);
    if (hSize < 0) return -1;
    if (repeat != 0) {
        const uint64_t oldCSize = zx_huf_estimate(&prevHuf->ct, count, maxSym);
        if (oldCSize < (uint64_t)litSize &&
            (oldCSize <= (uint64_t)hSize + newCSize ||
             hSize + 12 >= litSize)) {
            *nextHuf = *prevHuf;
            m->hType = 3;
            return 0;
        }
    }
    if (newCSize + (uint64_t)hSize >= (uint64_t)litSize) {
        *nextHuf = *prevHuf;
        m->hType = 0;
        return 0;
    }
    nextHuf->ct = newCT;
    nextHuf->rep = 1;  // HUF_repeat_check
    m->hType = 2;
    m->huf_hdr_bytes = hSize;
    return 0;
}

static int zx_sb_build_lit(const uint8_t* lit, int64_t litSize,
                           const ZxHufS* prevHuf, ZxHufS* nextHuf,
                           ZxSbMeta* m) {
    uint32_t count[256] = {0};
    for (int64_t i = 0; i < litSize; i++) count[lit[i]]++;
    return zx_stats_lit_counts(count, litSize, prevHuf, nextHuf, m);
}

// ZSTD_compressSubBlock_literal:27.
static int64_t zx_sb_emit_lit(const HufCTableC* ct, const ZxSbMeta* m,
                              const uint8_t* lit, int64_t litSize,
                              int writeEntropy, int* entropyWritten,
                              uint8_t* op, int64_t cap) {
    *entropyWritten = 0;
    const int64_t header = writeEntropy ? 200 : 0;
    const int64_t lhSize = 3 + (litSize >= 1024 - header ? 1 : 0) +
                           (litSize >= 16 * 1024 - header ? 1 : 0);
    const int singleStream = lhSize == 3;
    const int hType = writeEntropy ? m->hType : 3 /*repeat*/;
    int64_t cLitSize = 0;
    if (litSize == 0 || m->hType == 0 /*basic*/) {
        // ZSTD_noCompressLiterals
        const int64_t flSize =
            1 + (litSize > 31 ? 1 : 0) + (litSize > 4095 ? 1 : 0);
        if (litSize + flSize > cap) return -1;
        if (flSize == 1) op[0] = (uint8_t)(0 + (litSize << 3));
        else if (flSize == 2) {
            const uint16_t v = (uint16_t)(0 + (1 << 2) + (litSize << 4));
            std::memcpy(op, &v, 2);
        } else {
            const uint32_t v = (uint32_t)(0 + (3 << 2) + (litSize << 4));
            std::memcpy(op, &v, 4);
        }
        std::memcpy(op + flSize, lit, (size_t)litSize);
        return flSize + litSize;
    }
    if (m->hType == 1 /*rle*/) {
        const int64_t flSize =
            1 + (litSize > 31 ? 1 : 0) + (litSize > 4095 ? 1 : 0);
        if (cap < flSize + 1) return -1;
        if (flSize == 1) op[0] = (uint8_t)(1 + (litSize << 3));
        else if (flSize == 2) {
            const uint16_t v = (uint16_t)(1 + (1 << 2) + (litSize << 4));
            std::memcpy(op, &v, 2);
        } else {
            const uint32_t v = (uint32_t)(1 + (3 << 2) + (litSize << 4));
            std::memcpy(op, &v, 4);
        }
        op[flSize] = lit[0];
        return flSize + 1;
    }
    uint8_t* const ostart = op;
    uint8_t* p = op + lhSize;
    const int64_t oend = cap;
    if (writeEntropy && m->hType == 2) {
        if (lhSize + m->huf_hdr_bytes > cap) return -1;
        std::memcpy(p, m->hufDes, (size_t)m->huf_hdr_bytes);
        p += m->huf_hdr_bytes;
        cLitSize += m->huf_hdr_bytes;
    }
    {
        const int64_t c = zx_huf_streams(p, oend - (p - ostart), lit, litSize,
                                         singleStream ? 0 : 1, ct, 0);
        if (c == 0) return 0;  // not compressible under the shared table
        p += c;
        cLitSize += c;
        if (!writeEntropy && cLitSize >= litSize) {
            // no gain without the table: fall back to raw literals
            const int64_t flSize =
                1 + (litSize > 31 ? 1 : 0) + (litSize > 4095 ? 1 : 0);
            if (litSize + flSize > cap) return -1;
            if (flSize == 1) ostart[0] = (uint8_t)(0 + (litSize << 3));
            else if (flSize == 2) {
                const uint16_t v = (uint16_t)(0 + (1 << 2) + (litSize << 4));
                std::memcpy(ostart, &v, 2);
            } else {
                const uint32_t v = (uint32_t)(0 + (3 << 2) + (litSize << 4));
                std::memcpy(ostart, &v, 4);
            }
            std::memcpy(ostart + flSize, lit, (size_t)litSize);
            return flSize + litSize;
        }
        if (lhSize < 3 + (cLitSize >= 1024 ? 1 : 0) +
                         (cLitSize >= 16 * 1024 ? 1 : 0))
            return 0;  // compressed larger than the header field allows
    }
    switch (lhSize) {
        case 3: {
            const uint32_t lhc =
                (uint32_t)(hType + ((singleStream ? 0 : 1) << 2)) +
                ((uint32_t)litSize << 4) + ((uint32_t)cLitSize << 14);
            ostart[0] = (uint8_t)lhc;
            ostart[1] = (uint8_t)(lhc >> 8);
            ostart[2] = (uint8_t)(lhc >> 16);
            break;
        }
        case 4: {
            const uint32_t lhc = (uint32_t)(hType + (2 << 2)) +
                                 ((uint32_t)litSize << 4) +
                                 ((uint32_t)cLitSize << 18);
            std::memcpy(ostart, &lhc, 4);
            break;
        }
        default: {
            const uint32_t lhc = (uint32_t)(hType + (3 << 2)) +
                                 ((uint32_t)litSize << 4) +
                                 ((uint32_t)cLitSize << 22);
            std::memcpy(ostart, &lhc, 4);
            ostart[4] = (uint8_t)(cLitSize >> 10);
            break;
        }
    }
    *entropyWritten = 1;
    return p - ostart;
}

// ZSTD_compressSubBlock_sequences:155.
static int64_t zx_sb_emit_seq(const ZxEntropy* ent, const ZxSbMeta* m,
                              const uint32_t* llv, const uint32_t* mlv,
                              const uint32_t* obv, const uint8_t* llc,
                              const uint8_t* mlc, const uint8_t* ofc,
                              int64_t nbSeq, int writeEntropy,
                              int* entropyWritten, uint8_t* op, int64_t cap) {
    *entropyWritten = 0;
    uint8_t* const ostart = op;
    if (cap < 4) return -1;
    if (nbSeq < 0x7F) {
        *op++ = (uint8_t)nbSeq;
    } else if (nbSeq < 0x7F00) {
        op[0] = (uint8_t)((nbSeq >> 8) + 0x80);
        op[1] = (uint8_t)nbSeq;
        op += 2;
    } else {
        op[0] = 0xFF;
        const uint16_t v = (uint16_t)(nbSeq - 0x7F00);
        std::memcpy(op + 1, &v, 2);
        op += 3;
    }
    if (nbSeq == 0) return op - ostart;
    uint8_t* const seqHead = op++;
    if (writeEntropy) {
        *seqHead = (uint8_t)((m->llType << 6) + (m->ofType << 4) +
                             (m->mlType << 2));
        if (cap - (op - ostart) < m->fse_hdr_bytes) return -1;
        std::memcpy(op, m->fseTables, (size_t)m->fse_hdr_bytes);
        op += m->fse_hdr_bytes;
    } else {
        *seqHead = (uint8_t)((3u << 6) + (3u << 4) + (3u << 2));
    }
    {
        const int64_t bitstreamSize = encode_sequences(
            llv, mlv, obv, llc, mlc, ofc, kLLBits, kMLBits, nbSeq,
            ent->ll.ct.state_table, ent->ll.ct.delta_nb, ent->ll.ct.delta_fs,
            ent->ll.ct.tlog, ent->of.ct.state_table, ent->of.ct.delta_nb,
            ent->of.ct.delta_fs, ent->of.ct.tlog, ent->ml.ct.state_table,
            ent->ml.ct.delta_nb, ent->ml.ct.delta_fs, ent->ml.ct.tlog, op,
            cap - (op - ostart));
        if (bitstreamSize < 0) return -1;
        op += bitstreamSize;
        if (writeEntropy && m->tail_count_fix != 0 &&
            m->tail_count_fix + bitstreamSize < 4)
            return 0;
    }
    if (op - seqHead < 4) return 0;
    *entropyWritten = 1;
    return op - ostart;
}

// Sub-block cost model (ZSTD_estimateSubBlockSize role) over running
// histograms — same signal, incrementally maintained.
struct ZxSbEst {
    uint32_t litCnt[256];
    uint32_t llCnt[36], ofCnt[32], mlCnt[53];
    uint64_t extraBits;    // accumulated ll/ml extra + of code bits
    int64_t litSize;
    int64_t nbSeq;
};

static int64_t zx_sb_estimate(const ZxSbEst* e, const ZxEntropy* ent,
                              const ZxSbMeta* m, int writeLit, int writeSeq) {
    int64_t est = 3;  // block header
    // literals
    if (m->hType == 0) est += e->litSize;
    else if (m->hType == 1) est += 1;
    else {
        uint32_t maxSym = 255;
        while (maxSym > 0 && e->litCnt[maxSym] == 0) maxSym--;
        est += (int64_t)zx_huf_estimate(&ent->huf.ct, e->litCnt, maxSym) +
               (writeLit ? m->huf_hdr_bytes : 0) + 3;
    }
    // sequences
    est += 3;
    if (e->nbSeq) {
        int64_t bits = (int64_t)e->extraBits;
        struct Ch {
            int type;
            const ZxFseCh* ch;
            const uint32_t* cnt;
            uint32_t maxCode;
            const int16_t* defNorm;
            uint32_t defLog;
        };
        const Ch chans[3] = {
            {m->ofType, &ent->of, e->ofCnt, 31, kOFNorm, 5},
            {m->llType, &ent->ll, e->llCnt, 35, kLLNorm, 6},
            {m->mlType, &ent->ml, e->mlCnt, 52, kMLNorm, 6},
        };
        for (const Ch& c : chans) {
            uint32_t max = c.maxCode;
            while (max > 0 && c.cnt[max] == 0) max--;
            int64_t b;
            if (c.type == 1) b = 0;
            else if (c.type == 0)
                b = cost_predefined(c.defNorm, c.defLog, c.cnt, max);
            else
                b = cost_prev_table(c.ch, c.cnt, max);
            if (b < 0 || b >= kZxErr) b = e->nbSeq * 10 * 8;
            bits += b;
        }
        est += bits / 8;
        if (writeSeq) est += m->fse_hdr_bytes;
    }
    return est;
}

// ZSTD_compressSubBlock_multi:445 over the zx seqStore.  Returns total
// emitted bytes, 0 if the superblock could not be formed (caller falls
// back to a raw block), or -1 on error.  rep_start holds the block-start
// repcodes; *next's repcodes are set to the decoder-visible history.
static int64_t zx_superblock_emit(const ZxStore* ss, const uint8_t* block,
                                  int64_t blockSize, const ZxEntropy* prev,
                                  ZxEntropy* next, int strategy,
                                  int64_t targetCBlockSize, int lastBlock,
                                  const uint32_t* rep_start, uint8_t* out,
                                  int64_t cap) {
    (void)strategy;
    ZxSbMeta m;
    std::memset(&m, 0, sizeof m);
    // --- literals stats ---
    if (zx_sb_build_lit(ss->lit, ss->nlit, &prev->huf, &next->huf, &m) < 0)
        return -1;
    // --- sequence codes + stats (ZSTD_buildBlockEntropyStats_sequences) ---
    const int64_t nbSeq = ss->nseq;
    static thread_local uint8_t llc[(1 << 17) / 3 + 64];
    static thread_local uint8_t ofc[(1 << 17) / 3 + 64];
    static thread_local uint8_t mlc[(1 << 17) / 3 + 64];
    static thread_local uint32_t llv[(1 << 17) / 3 + 64];
    static thread_local uint32_t mlv[(1 << 17) / 3 + 64];
    static thread_local uint32_t obv[(1 << 17) / 3 + 64];
    uint32_t llcnt[36] = {0}, ofcnt[32] = {0}, mlcnt[53] = {0};
    for (int64_t i = 0; i < nbSeq; i++) {
        const uint32_t ll = ss->seq[i].ll;
        const uint32_t ml = ss->seq[i].ml;
        const uint32_t ob = ss->seq[i].offBase;
        llc[i] = (uint8_t)zx_llcode(ll);
        ofc[i] = (uint8_t)highbit32(ob);
        mlc[i] = (uint8_t)zx_mlcode(ml);
        llv[i] = ll;
        mlv[i] = ml;
        obv[i] = ob;
        llcnt[llc[i]]++;
        ofcnt[ofc[i]]++;
        mlcnt[mlc[i]]++;
    }
    if (ss->llt == 1) {
        llcnt[llc[ss->lltPos]]--;
        llc[ss->lltPos] = 35;
        llcnt[35]++;
    }
    if (ss->llt == 2) {
        mlcnt[mlc[ss->lltPos]]--;
        mlc[ss->lltPos] = 52;
        mlcnt[52]++;
    }
    m.tail_count_fix = 0;
    m.fse_hdr_bytes = 0;
    if (nbSeq > 0) {
        uint8_t* p = m.fseTables;
        const int64_t pcap = (int64_t)sizeof m.fseTables;
        // LL
        {
            uint32_t count[36];
            std::memcpy(count, llcnt, sizeof count);
            uint32_t max = 35;
            while (max > 0 && count[max] == 0) max--;
            uint32_t mostFrequent = 0;
            for (uint32_t s = 0; s <= max; s++)
                if (count[s] > mostFrequent) mostFrequent = count[s];
            next->ll = prev->ll;
            m.llType = zx_select_encoding(&next->ll.rep, count, max,
                                          mostFrequent, (uint64_t)nbSeq, 9,
                                          &prev->ll, kLLNorm, 6, 1, strategy);
            const int64_t cs = zx_build_seq_ctable(
                p, pcap - (p - m.fseTables), &next->ll, 9, m.llType, count,
                max, llc[0], llc[nbSeq - 1], (uint64_t)nbSeq, kLLNorm, 6,
                35);
            if (cs < 0) return -1;
            if (m.llType == 2) m.tail_count_fix = cs;
            p += cs;
        }
        // OF
        {
            uint32_t count[32];
            std::memcpy(count, ofcnt, sizeof count);
            uint32_t max = 31;
            while (max > 0 && count[max] == 0) max--;
            uint32_t mostFrequent = 0;
            for (uint32_t s = 0; s <= max; s++)
                if (count[s] > mostFrequent) mostFrequent = count[s];
            const int defaultAllowed = max <= 28;
            next->of = prev->of;
            m.ofType = zx_select_encoding(&next->of.rep, count, max,
                                          mostFrequent, (uint64_t)nbSeq, 8,
                                          &prev->of, kOFNorm, 5,
                                          defaultAllowed, strategy);
            const int64_t cs = zx_build_seq_ctable(
                p, pcap - (p - m.fseTables), &next->of, 8, m.ofType, count,
                max, ofc[0], ofc[nbSeq - 1], (uint64_t)nbSeq, kOFNorm, 5,
                28);
            if (cs < 0) return -1;
            if (m.ofType == 2) m.tail_count_fix = cs;
            p += cs;
        }
        // ML
        {
            uint32_t count[53];
            std::memcpy(count, mlcnt, sizeof count);
            uint32_t max = 52;
            while (max > 0 && count[max] == 0) max--;
            uint32_t mostFrequent = 0;
            for (uint32_t s = 0; s <= max; s++)
                if (count[s] > mostFrequent) mostFrequent = count[s];
            next->ml = prev->ml;
            m.mlType = zx_select_encoding(&next->ml.rep, count, max,
                                          mostFrequent, (uint64_t)nbSeq, 9,
                                          &prev->ml, kMLNorm, 6, 1, strategy);
            const int64_t cs = zx_build_seq_ctable(
                p, pcap - (p - m.fseTables), &next->ml, 9, m.mlType, count,
                max, mlc[0], mlc[nbSeq - 1], (uint64_t)nbSeq, kMLNorm, 6,
                52);
            if (cs < 0) return -1;
            if (m.mlType == 2) m.tail_count_fix = cs;
            p += cs;
        }
        m.fse_hdr_bytes = p - m.fseTables;
    } else {
        m.llType = m.ofType = m.mlType = 0;
        next->ll = prev->ll;
        next->of = prev->of;
        next->ml = prev->ml;
    }

    // --- partition + emit (ZSTD_compressSubBlock_multi) ---
    int lit_tables_due = m.hType == 2;
    int seq_tables_due = 1;
    int tail_reached = 0;
    int64_t sp = 0;        // consumed sequences
    int64_t lp = 0;        // consumed literal bytes
    int64_t ip = 0;        // consumed source bytes
    int64_t op = 0;
    int64_t seqCount = 0;
    ZxSbEst est;
    std::memset(&est, 0, sizeof est);
    // per-sequence source position for decompressedSize accounting
    do {
        if (sp + seqCount >= nbSeq) {
            tail_reached = 1;
        } else {
            const int64_t i = sp + seqCount;
            tail_reached = i == nbSeq - 1;
            const uint32_t llRaw =
                (ss->llt == 1 && ss->lltPos == i) ? llv[i] + 0x10000
                                                  : ss->seq[i].ll;
            est.litSize += llRaw;
            for (uint32_t u = 0; u < llRaw; u++)
                est.litCnt[ss->lit[lp + est.litSize - llRaw + u]]++;
            est.llCnt[llc[i]]++;
            est.ofCnt[ofc[i]]++;
            est.mlCnt[mlc[i]]++;
            est.extraBits += kLLBits[llc[i]] + kMLBits[mlc[i]] + ofc[i];
            est.nbSeq++;
            seqCount++;
        }
        if (tail_reached) {
            // trailing literals join the final sub-block
            const int64_t rest = ss->nlit - lp;
            for (int64_t u = est.litSize; u < rest; u++)
                est.litCnt[ss->lit[lp + u]]++;
            est.litSize = rest;
        }
        const int64_t cEst =
            zx_sb_estimate(&est, next, &m, lit_tables_due, seq_tables_due);
        if (cEst > targetCBlockSize || tail_reached) {
            int litWritten = 0, seqWritten = 0;
            // decompressed bytes covered by this sub-block
            int64_t decompressedSize = est.litSize;
            for (int64_t i = sp; i < sp + seqCount; i++)
                decompressedSize += mlv[i] + 3;
            if (ss->llt == 2 && ss->lltPos >= sp && ss->lltPos < sp + seqCount)
                decompressedSize += 0x10000;  // u16-truncated long match
            const int subLast = lastBlock && tail_reached;
            // emit: [header][literals][sequences]
            if (cap - op < 8) return -1;
            int64_t sub = 3;
            {
                const int64_t c = zx_sb_emit_lit(
                    &next->huf.ct, &m, ss->lit + lp, est.litSize,
                    lit_tables_due, &litWritten, out + op + sub,
                    cap - op - sub);
                if (c < 0) return -1;
                if (c == 0) goto _advance_only;
                sub += c;
            }
            {
                const int64_t c = zx_sb_emit_seq(
                    next, &m, llv + sp, mlv + sp, obv + sp, llc + sp,
                    mlc + sp, ofc + sp, seqCount, seq_tables_due,
                    &seqWritten, out + op + sub, cap - op - sub);
                if (c < 0) return -1;
                if (c == 0) goto _advance_only;
                sub += c;
            }
            if (sub - 3 > 0 && sub - 3 < decompressedSize) {
                const uint32_t bh = (uint32_t)(subLast + (2u << 1) +
                                               ((uint32_t)(sub - 3) << 3));
                out[op] = (uint8_t)bh;
                out[op + 1] = (uint8_t)(bh >> 8);
                out[op + 2] = (uint8_t)(bh >> 16);
                op += sub;
                ip += decompressedSize;
                sp += seqCount;
                lp += est.litSize;
                seqCount = 0;
                std::memset(&est, 0, sizeof est);
                if (litWritten) lit_tables_due = 0;
                if (seqWritten) seq_tables_due = 0;
            }
        _advance_only:;
        }
    } while (!tail_reached);

    if (lit_tables_due) next->huf = prev->huf;  // table never reached stream
    if (seq_tables_due &&
        (m.llType == 1 || m.llType == 2 || m.ofType == 1 || m.ofType == 2 ||
         m.mlType == 1 || m.mlType == 2))
        return 0;  // sub-blocks need tables that were never written
    if (ip < blockSize) {
        // trailing raw sub-block; rewind reps over the consumed prefix only
        if (cap - op < 3 + (blockSize - ip)) return -1;
        const uint32_t bh = (uint32_t)(lastBlock + (0u << 1) +
                                       ((uint32_t)(blockSize - ip) << 3));
        out[op] = (uint8_t)bh;
        out[op + 1] = (uint8_t)(bh >> 8);
        out[op + 2] = (uint8_t)(bh >> 16);
        std::memcpy(out + op + 3, block + ip, (size_t)(blockSize - ip));
        op += 3 + (blockSize - ip);
        if (sp < nbSeq) {
            uint32_t rep[3] = {rep_start[0], rep_start[1], rep_start[2]};
            for (int64_t i = 0; i < sp; i++) {
                uint32_t nr[3];
                zx_updateRep3(rep, obv[i] - 1, llv[i] == 0, nr);
                std::memcpy(rep, nr, 12);
            }
            std::memcpy(next->repcodes, rep, 12);
        }
    }
    return op;
}

// Array-interface wrapper for the superblock emitter (any finder's
// (ll, ml, offBase) arrays + trailing literals).
static int64_t zx_superblock_from_arrays(
    const uint8_t* block, int64_t bn, const uint32_t* ll, const uint32_t* mlv,
    const uint32_t* ob, int64_t n_seq, int64_t last_lit, const ZxEntropy* prev,
    ZxEntropy* next, int strategy, int64_t tcbs, int lastBlock,
    const uint32_t* rep_start, uint8_t* out, int64_t cap) {
    static thread_local uint8_t* litbuf = nullptr;
    static thread_local ZxSeq* seqbuf = nullptr;
    if (!litbuf) {
        litbuf = (uint8_t*)malloc((1 << 17) + 64);
        seqbuf = (ZxSeq*)malloc(((1 << 17) / 3 + 64) * sizeof(ZxSeq));
        if (!litbuf || !seqbuf) return -1;
    }
    ZxStore ss{litbuf, 0, seqbuf, 0, 0, 0};
    int64_t p = 0;
    for (int64_t i = 0; i < n_seq; i++) {
        zx_store_seq(&ss, block + p, ll[i], ob[i] - 1, (int64_t)mlv[i] - 3);
        p += (int64_t)ll[i] + mlv[i];
    }
    std::memcpy(ss.lit + ss.nlit, block + bn - last_lit, (size_t)last_lit);
    ss.nlit += last_lit;
    return zx_superblock_emit(&ss, block, bn, prev, next, strategy, tcbs,
                              lastBlock, rep_start, out, cap);
}

// Content-adaptive block pre-split (role of libzstd 1.5.7's zstd_preSplit;
// the reference v1.5.1 has no analog).  A 128KB block mixing regimes
// (text | random | runs) compresses worse than its parts, so blocks are cut
// where the byte/bigram distribution shifts.  The oracle's decision function
// was reconstructed BLACK-BOX (no source available in this image): crafted
// corpora were compressed with libzstd 1.5.7, frames parsed to recover the
// input-side block boundaries, and a parameterized model fitted to exact
// agreement over ~1,500 observed windows at every strategy tier
// (tools/fit_presplit.py / tools/diag_presplit.py).  Fitted structure:
//   - fast strategy: a cheap head/tail/middle 512-byte histogram probe that
//     only ever cuts at the 32/64/96KB quarter points of a 128KB window;
//   - dfast and up: an 8KB-chunk scan comparing each next chunk's sampled
//     bigram-hash fingerprint against the accumulated past, with sampling
//     rate/hash width per strategy tier and a decaying leniency penalty;
//   - both gated on the frame's running compression savings (an
//     incompressible prefix disables splitting until >=3 bytes saved).
// Cross-normalized L1 distance between event histograms; all integer.
static inline uint64_t zx_fp_dist(const uint32_t* a, uint64_t na,
                                  const uint32_t* b, uint64_t nb, int n) {
    uint64_t dist = 0;
    for (int i = 0; i < n; i++) {
        const int64_t d = (int64_t)((uint64_t)a[i] * nb) -
                          (int64_t)((uint64_t)b[i] * na);
        dist += (uint64_t)(d < 0 ? -d : d);
    }
    return dist;
}

static int64_t zx_presplit_borders(const uint8_t* ip) {
    enum { SEG = 512, W = 128 << 10 };
    uint32_t head[256] = {0}, tail[256] = {0};
    for (int i = 0; i < SEG; i++) head[ip[i]]++;
    for (int i = 0; i < SEG; i++) tail[ip[W - SEG + i]]++;
    const uint64_t p50 = (uint64_t)SEG * SEG;
    if (zx_fp_dist(head, SEG, tail, SEG, 256) < p50 * 14 / 16) return W;
    uint32_t mid[256] = {0};
    const uint8_t* mp = ip + W / 2 - SEG / 2;
    for (int i = 0; i < SEG; i++) mid[mp[i]]++;
    const uint64_t d_head = zx_fp_dist(head, SEG, mid, SEG, 256);
    const uint64_t d_tail = zx_fp_dist(tail, SEG, mid, SEG, 256);
    const uint64_t gap = d_head > d_tail ? d_head - d_tail : d_tail - d_head;
    if (gap < p50 / 3) return 64 << 10;
    return d_head > d_tail ? (32 << 10) : (96 << 10);
}

// Sampled fingerprint of one 8KB chunk.  HLOG==8 takes the raw leading
// byte; wider tables hash the bigram.  Returns the event-count credit,
// which is the floor-division count (one less than the samples taken when
// RATE does not divide the scan span — a fitted detail, kept exactly).
template <int RATE, int HLOG>
static inline uint64_t zx_fp_record(uint32_t* ev, const uint8_t* p) {
    enum { CHUNK = 8 << 10 };
    std::memset(ev, 0, sizeof(uint32_t) << HLOG);
    const int64_t limit = CHUNK - 2 + 1;
    for (int64_t i = 0; i < limit; i += RATE) {
        if (HLOG == 8) {
            ev[p[i]]++;
        } else {
            const uint32_t v = (uint32_t)p[i] | ((uint32_t)p[i + 1] << 8);
            ev[(v * 0x9E3779B9u) >> (32 - HLOG)]++;
        }
    }
    return (uint64_t)(limit / RATE);
}

template <int RATE, int HLOG>
static int64_t zx_presplit_chunks(const uint8_t* ip) {
    enum { CHUNK = 8 << 10, W = 128 << 10, NB = 1 << HLOG };
    uint32_t past[NB], cur[NB];
    uint64_t n_past = zx_fp_record<RATE, HLOG>(past, ip);
    int penalty = 3;
    for (int64_t pos = CHUNK; pos <= W - CHUNK; pos += CHUNK) {
        const uint64_t n_cur = zx_fp_record<RATE, HLOG>(cur, ip + pos);
        const uint64_t thr = n_past * n_cur * (uint64_t)(14 + penalty) / 16;
        if (zx_fp_dist(past, n_past, cur, n_cur, NB) >= thr) return pos;
        for (int i = 0; i < NB; i++) past[i] += cur[i];
        n_past += n_cur;
        if (penalty > 0) penalty--;
    }
    return W;
}

static int64_t zx_presplit(const uint8_t* ip, int64_t remaining,
                           int64_t block_max, int strat, int64_t savings) {
    const int64_t lim = remaining < block_max ? remaining : block_max;
    if (block_max != (128 << 10) || remaining < (128 << 10)) return lim;
    if (savings < 3) return 128 << 10;  // incompressible-so-far gate
    if (strat <= 1) return zx_presplit_borders(ip);
    if (strat == 2) return zx_presplit_chunks<43, 8>(ip);
    if (strat <= 4) return zx_presplit_chunks<11, 9>(ip);
    if (strat <= 6) return zx_presplit_chunks<5, 10>(ip);
    return zx_presplit_chunks<1, 10>(ip);
}


// ===========================================================================
// EXACT OPTIMAL PARSER — btopt / btultra / btultra2 (ZstdOpt.cs, verbatim
// semantics: fracWeight price model ZSTD_rescaleFreqs:96, BT match
// enumeration ZSTD_insertBtAndGetAllMatches:560, DP parse
// ZSTD_compressBlock_opt_generic:1046, btultra2 two-pass seeding
// ZSTD_initStats_ultra:1362).  noDict, no-LDM path.
// ===========================================================================

static const uint32_t kZx_baseLLfreqs[36] = {
    4,2,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1};
static const uint32_t kZx_baseOFCfreqs[32] = {
    6,2,1,1,2,3,4,4,4,3,2,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1};

struct ZxOptMatch { uint32_t off, len; };

struct ZxOptCtx {
    const uint8_t* base;   // window base (src - 2 at frame start)
    const uint8_t* src0;   // frame start (fixed; base shifts on initStats)
    const uint8_t* frame_end;  // true input end: block-local limits stop
                               // match reporting, but suffix ORDERING may
                               // read on, so early breaks need not chop
    uint32_t dictLimit;    // == lowLimit (noDict)
    uint32_t nextToUpdate;
    uint32_t wlog, clog, hlog, slog, tlen, mml;
    int optLevel;          // 0 btopt, 2 btultra(2)
    int is_ultra2;
    uint32_t hashLog3;
    uint32_t* hashTable;
    uint32_t* bt;          // 2^clog u32 (pairs at 2*(idx & btMask))
    uint32_t* hash3;
    // optState_t freqs
    uint32_t litFreq[256], llFreq[36], mlFreq[53], ofFreq[32];
    uint32_t litSum, llSum, mlSum, ofSum;
    uint32_t litSumBase, llSumBase, mlSumBase, ofSumBase;
    int priceType;         // 0 dynamic, 1 predef
    // DP row, SoA: price to arrive at each offset of the current segment,
    // the arriving step (via_len 0 = literal run), the literals carried in
    // front of that step, and the repcode history after arriving.
    int32_t* row_price;    // [4099]
    uint32_t* row_vlen;    // [4099]
    uint32_t* row_voff;    // [4099]
    uint32_t* row_lead;    // [4099]
    uint32_t* row_rep;     // [3 * 4099]
    ZxOptMatch* matches;   // [4099]
};

static inline uint32_t zx_bitWeight(uint32_t stat) {
    return (uint32_t)highbit32(stat + 1) << 8;
}
static inline uint32_t zx_fracWeight(uint32_t rawStat) {
    const uint32_t stat = rawStat + 1;
    const uint32_t hb = (uint32_t)highbit32(stat);
    const uint32_t BWeight = hb << 8;
    const uint32_t FWeight = (stat << 8) >> hb;
    return BWeight + FWeight;
}
static inline uint32_t zx_weight(const ZxOptCtx* c, uint32_t s) {
    return c->optLevel ? zx_fracWeight(s) : zx_bitWeight(s);
}

static void zx_opt_setBasePrices(ZxOptCtx* c) {
    c->litSumBase = zx_weight(c, c->litSum);
    c->llSumBase = zx_weight(c, c->llSum);
    c->mlSumBase = zx_weight(c, c->mlSum);
    c->ofSumBase = zx_weight(c, c->ofSum);
}

static uint32_t zx_downscaleStats(uint32_t* t, uint32_t last, uint32_t shift) {
    uint32_t sum = 0;
    for (uint32_t s = 0; s <= last; s++) {
        t[s] = 1 + (t[s] >> shift);
        sum += t[s];
    }
    return sum;
}

static uint32_t zx_scaleStats(uint32_t* t, uint32_t last, uint32_t logTarget) {
    uint32_t prevsum = 0;
    for (uint32_t s = 0; s <= last; s++) prevsum += t[s];
    const uint32_t factor = prevsum >> logTarget;
    if (factor <= 1) return prevsum;
    return zx_downscaleStats(t, last, (uint32_t)highbit32(factor));
}

struct ZxOptTune { int litlog, lenlog, litshift, litadd; };
static ZxOptTune zx_opt_tune() {
    static const ZxOptTune t = [] {
        const char* e = getenv("ZT_OPT_TUNE");  // "litlog,lenlog,litshift,litadd"
        // litshift 9 measured best across the real-file sweep (ELF -0.4..-1%,
        // text within noise); 8 was the 1.5.1 value (tools/opt_grid.py).
        ZxOptTune v = {12, 11, 9, 2};
        if (e) sscanf(e, "%d,%d,%d,%d", &v.litlog, &v.lenlog, &v.litshift, &v.litadd);
        return v;
    }();
    return t;
}

static void zx_opt_rescaleFreqs(ZxOptCtx* c, const uint8_t* src,
                                int64_t srcSize) {
    c->priceType = 0;  // zop_dynamic
    if (c->llSum == 0) {  // first block
        if (srcSize <= 1024) c->priceType = 1;  // zop_predef
        // noDict: no valid symbolCosts -> raw-count literal init
        {
            uint32_t cnt[256] = {0};
            for (int64_t i = 0; i < srcSize; i++) cnt[src[i]]++;
            std::memcpy(c->litFreq, cnt, sizeof cnt);
            c->litSum = zx_downscaleStats(c->litFreq, 255,
                                          (uint32_t)zx_opt_tune().litshift);
        }
        std::memcpy(c->llFreq, kZx_baseLLfreqs, sizeof c->llFreq);
        c->llSum = 0;
        for (int s = 0; s < 36; s++) c->llSum += kZx_baseLLfreqs[s];
        for (int s = 0; s < 53; s++) c->mlFreq[s] = 1;
        c->mlSum = 53;
        std::memcpy(c->ofFreq, kZx_baseOFCfreqs, sizeof c->ofFreq);
        c->ofSum = 0;
        for (int s = 0; s < 32; s++) c->ofSum += kZx_baseOFCfreqs[s];
    } else {
        const ZxOptTune t = zx_opt_tune();
        c->litSum = zx_scaleStats(c->litFreq, 255, (uint32_t)t.litlog);
        c->llSum = zx_scaleStats(c->llFreq, 35, (uint32_t)t.lenlog);
        c->mlSum = zx_scaleStats(c->mlFreq, 52, (uint32_t)t.lenlog);
        c->ofSum = zx_scaleStats(c->ofFreq, 31, (uint32_t)t.lenlog);
    }
    zx_opt_setBasePrices(c);
}

static uint32_t zx_rawLiteralsCost(const uint8_t* lit, uint32_t litLength,
                                   const ZxOptCtx* c) {
    if (litLength == 0) return 0;
    if (c->priceType == 1) return litLength * 6 * (1 << 8);
    uint32_t price = litLength * c->litSumBase;
    for (uint32_t u = 0; u < litLength; u++)
        price -= zx_weight(c, c->litFreq[lit[u]]);
    return price;
}

static uint32_t zx_litLengthPrice(uint32_t litLength, const ZxOptCtx* c) {
    if (c->priceType == 1) return zx_weight(c, litLength);
    const uint32_t llCode = zx_llcode(litLength);
    return ((uint32_t)kLLBits[llCode] << 8) + c->llSumBase
           - zx_weight(c, c->llFreq[llCode]);
}

static uint32_t zx_getMatchPrice(uint32_t offset, uint32_t matchLength,
                                 const ZxOptCtx* c) {
    uint32_t price;
    const uint32_t offCode = (uint32_t)highbit32(offset + 1);
    const uint32_t mlBase = matchLength - 3;
    if (c->priceType == 1)
        return zx_weight(c, mlBase) + ((16 + offCode) << 8);
    price = (offCode << 8) + (c->ofSumBase - zx_weight(c, c->ofFreq[offCode]));
    if (c->optLevel < 2 && offCode >= 20)
        price += (offCode - 19) * 2 * (1 << 8);
    {
        const uint32_t mlCode = zx_mlcode(mlBase);
        price += ((uint32_t)kMLBits[mlCode] << 8)
                 + (c->mlSumBase - zx_weight(c, c->mlFreq[mlCode]));
    }
    price += (1 << 8) / 5;
    return price;
}

static void zx_opt_updateStats(ZxOptCtx* c, uint32_t litLength,
                               const uint8_t* literals, uint32_t offsetCode,
                               uint32_t matchLength) {
    const uint32_t add = (uint32_t)zx_opt_tune().litadd;
    for (uint32_t u = 0; u < litLength; u++) c->litFreq[literals[u]] += add;
    c->litSum += litLength * add;
    {
        const uint32_t llCode = zx_llcode(litLength);
        c->llFreq[llCode]++;
        c->llSum++;
    }
    {
        const uint32_t offCode = (uint32_t)highbit32(offsetCode + 1);
        c->ofFreq[offCode]++;
        c->ofSum++;
    }
    {
        const uint32_t mlCode = zx_mlcode(matchLength - 3);
        c->mlFreq[mlCode]++;
        c->mlSum++;
    }
}

static inline uint32_t zx_readMINMATCH(const uint8_t* p, uint32_t length) {
    if (length == 3) return read32(p) << 8;
    return read32(p);
}

static inline uint32_t zx_hash3(const uint8_t* p, uint32_t h) {
    return ((read32(p) << (32 - 24)) * 506832829U) >> (32 - h);
}

// Fill the 3-byte hash heads up to (excluding) ip, return the head for ip.
static uint32_t opt_hash3_probe(ZxOptCtx* c, uint32_t* fill3_from,
                                const uint8_t* ip) {
    const uint32_t at = (uint32_t)(ip - c->base);
    for (uint32_t i = *fill3_from; i < at; i++)
        c->hash3[zx_hash3(c->base + i, c->hashLog3)] = i;
    *fill3_from = at;
    return c->hash3[zx_hash3(ip, c->hashLog3)];
}

static inline uint32_t zx_getLowestMatchIndex(const ZxOptCtx* c,
                                              uint32_t curr) {
    const uint32_t maxDistance = 1u << c->wlog;
    const uint32_t lowestValid = c->dictLimit;  // lowLimit == dictLimit
    return (curr - lowestValid > maxDistance) ? curr - maxDistance
                                              : lowestValid;
}

// ---- suffix-ordered binary tree -------------------------------------------
// Every window position owns a two-slot node (bt[2*(pos & half_mask)]):
// slot 0 links the largest suffix sorting BELOW it, slot 1 the smallest
// sorting ABOVE.  Threading a new position walks down from the hash head,
// re-parenting each visited candidate onto the pending link of its side —
// the two sides are symmetric, so one direction bit drives both the link
// update and the descent (the reference expresses this as separate
// smaller/larger pointer juggling; behavior is identical, incl. the
// depth budget, the reach-based skip hint, and this repo's own
// frame-suffix ordering that preserves subtrees at block boundaries).

// Thread `ip` into the tree without collecting matches.  Returns how many
// following positions may skip their own threading (a long match makes
// the covered tail redundant).
static uint32_t bt_thread_suffix(ZxOptCtx* c, const uint8_t* ip,
                                 const uint8_t* iend, uint32_t target,
                                 uint32_t mls) {
    const size_t h = zx_hash(ip, c->hlog, mls);
    uint32_t* const bt = c->bt;
    const uint32_t half_mask = (1u << (c->clog - 1)) - 1;
    const uint8_t* const base = c->base;
    const uint32_t at = (uint32_t)(ip - base);
    const uint32_t reach_floor = half_mask >= at ? 0 : at - half_mask;
    const uint32_t win_floor =
        (target - c->dictLimit > (1u << c->wlog)) ? target - (1u << c->wlog)
                                                  : c->dictLimit;
    uint32_t cand = c->hashTable[h];
    c->hashTable[h] = at;

    uint32_t* const node = bt + 2 * (at & half_mask);
    uint32_t* link[2] = {node, node + 1};  // [0] below-side, [1] above-side
    size_t agree[2] = {0, 0};              // verified shared prefix per side
    uint32_t depth = 1u << c->slog;
    uint32_t reach = at + 8 + 1;           // rightmost byte a match touched
    size_t best = 8;
    uint32_t sink;                         // absorbs writes past the cutoff

    while (depth-- && cand >= win_floor) {
        uint32_t* const cnode = bt + 2 * (cand & half_mask);
        // cover the next random node/byte accesses with the count work
        __builtin_prefetch(bt + 2 * (cnode[0] & half_mask), 0, 1);
        __builtin_prefetch(bt + 2 * (cnode[1] & half_mask), 0, 1);
        const uint8_t* const cp = base + cand;
        size_t len = agree[0] < agree[1] ? agree[0] : agree[1];
        len += zx_count(ip + len, cp + len, iend);
        if (len > best) {
            best = len;
            if (len > reach - cand) reach = cand + (uint32_t)len;
        }
        size_t tl = len;
        if (ip + tl == iend) {
            // The reference chops the remaining subtree at every block
            // boundary (ZSTD_insertBt1:490).  The block limit only bounds
            // match REPORTING; suffix order may consult the frame's real
            // continuation, so the tree survives.
            if (c->frame_end == nullptr || iend >= c->frame_end) break;
            tl += zx_count(ip + tl, cp + tl, c->frame_end);
            if (ip + tl >= c->frame_end) break;
        }
        const int d = cp[tl] < ip[tl] ? 0 : 1;
        *link[d] = cand;
        agree[d] = len;
        if (cand <= reach_floor) { link[d] = &sink; break; }
        link[d] = &cnode[1 - d];
        cand = cnode[1 - d];
    }
    *link[0] = *link[1] = 0;
    uint32_t skip = 0;
    if (best > 384)
        skip = best - 384 < 192 ? (uint32_t)(best - 384) : 192;
    const uint32_t ahead = reach - (at + 8);
    return skip > ahead ? skip : ahead;
}

static void bt_fill_to(ZxOptCtx* c, const uint8_t* ip, const uint8_t* iend,
                       uint32_t mls) {
    const uint32_t target = (uint32_t)(ip - c->base);
    uint32_t idx = c->nextToUpdate;
    while (idx < target)
        idx += bt_thread_suffix(c, c->base + idx, iend, target, mls);
    c->nextToUpdate = target;
}

// Thread `ip` AND collect every strictly-improving candidate: the three
// repcode slots first (rep search order depends on whether literals
// precede), an optional 3-byte probe, then the tree walk reporting each
// new best.  Candidates land in `out` ordered by increasing length, with
// off encoded as repcode-index (0..2) or distance + 2.
static uint32_t bt_collect_matches(ZxOptMatch* out, ZxOptCtx* c,
                                   uint32_t* fill3_from, const uint8_t* ip,
                                   const uint8_t* iLimit, const uint32_t* rep,
                                   uint32_t ll0, uint32_t lengthToBeat,
                                   uint32_t mls) {
    if (ip < c->base + c->nextToUpdate) return 0;
    bt_fill_to(c, ip, iLimit, mls);

    const uint32_t early_out_len =
        c->tlen < ((1u << 12) - 1) ? c->tlen : ((1u << 12) - 1);
    const uint8_t* const base = c->base;
    const uint32_t at = (uint32_t)(ip - base);
    const uint32_t minMatch = mls == 3 ? 3 : 4;
    const uint32_t win_floor = zx_getLowestMatchIndex(c, at);
    const uint32_t cand_floor = win_floor ? win_floor : 1;
    uint32_t n_out = 0;
    size_t best = lengthToBeat - 1;

    // repcode candidates: slots ll0..2, plus the rep[0]-1 probe when no
    // literals precede
    for (uint32_t slot = ll0; slot < 3 + ll0; slot++) {
        const uint32_t rdist = slot == 3 ? rep[0] - 1 : rep[slot];
        const uint32_t rpos = at - rdist;
        uint32_t rlen = 0;
        if (rdist - 1 < at - c->dictLimit &&  // 1 <= rdist <= span
            rpos >= win_floor &&
            zx_readMINMATCH(ip, minMatch)
                == zx_readMINMATCH(ip - rdist, minMatch)) {
            rlen = (uint32_t)zx_count(ip + minMatch, ip + minMatch - rdist,
                                      iLimit)
                   + minMatch;
        }
        if (rlen > best) {
            best = rlen;
            out[n_out].off = slot - ll0;
            out[n_out].len = rlen;
            n_out++;
            if (rlen > early_out_len || ip + rlen == iLimit) return n_out;
        }
    }

    if (mls == 3 && best < mls) {
        const uint32_t h3cand = opt_hash3_probe(c, fill3_from, ip);
        if (h3cand >= cand_floor && at - h3cand < (1u << 18)) {
            const size_t len3 = zx_count(ip, base + h3cand, iLimit);
            if (len3 >= mls) {
                best = len3;
                out[0].off = (at - h3cand) + 2;
                out[0].len = (uint32_t)len3;
                n_out = 1;
                if (len3 > early_out_len || ip + len3 == iLimit) {
                    c->nextToUpdate = at + 1;
                    return 1;
                }
            }
        }
    }

    const size_t h = zx_hash(ip, c->hlog, mls);
    uint32_t* const bt = c->bt;
    const uint32_t half_mask = (1u << (c->clog - 1)) - 1;
    const uint32_t reach_floor = half_mask >= at ? 0 : at - half_mask;
    uint32_t cand = c->hashTable[h];
    c->hashTable[h] = at;

    uint32_t* const node = bt + 2 * (at & half_mask);
    uint32_t* link[2] = {node, node + 1};
    size_t agree[2] = {0, 0};
    uint32_t depth = 1u << c->slog;
    uint32_t reach = at + 8 + 1;
    uint32_t sink;
    int silent = 0;  // keep re-threading without reporting (see below)

    while (depth-- && cand >= cand_floor) {
        uint32_t* const cnode = bt + 2 * (cand & half_mask);
        __builtin_prefetch(bt + 2 * (cnode[0] & half_mask), 0, 1);
        __builtin_prefetch(bt + 2 * (cnode[1] & half_mask), 0, 1);
        const uint8_t* const cp = base + cand;
        size_t len = agree[0] < agree[1] ? agree[0] : agree[1];
        len += zx_count(ip + len, cp + len, iLimit);
        if (!silent && len > best) {
            if (len > reach - cand) reach = cand + (uint32_t)len;
            best = len;
            out[n_out].off = (at - cand) + 2;
            out[n_out].len = (uint32_t)len;
            n_out++;
            // The reference stops here on a >4KB match ("drop, to preserve
            // bt consistency", ZSTD_insertBtAndGetAllMatches:750), zeroing
            // the child slots — on repetitive data the tree loses its
            // long-reach nodes within blocks.  Walk on silently instead.
            if (len > (1u << 12)) silent = 1;
        }
        size_t tl = len;
        if (ip + tl >= iLimit) {
            if (c->frame_end == nullptr || iLimit >= c->frame_end) break;
            tl += zx_count(ip + tl, cp + tl, c->frame_end);
            if (ip + tl >= c->frame_end) break;
        }
        const int d = cp[tl] < ip[tl] ? 0 : 1;
        *link[d] = cand;
        agree[d] = len;
        if (cand <= reach_floor) { link[d] = &sink; break; }
        link[d] = &cnode[1 - d];
        cand = cnode[1 - d];
    }
    *link[0] = *link[1] = 0;
    c->nextToUpdate = reach - 8;
    return n_out;
}

// Repcode history after a step (ZSTD_updateRep semantics): off >= 3 is a
// fresh distance (off - 2); smaller values select a history slot, shifted
// by one when the step had no leading literals (slot 3 = rep[0] - 1).
static inline void zx_updateRep3(const uint32_t* rep, uint32_t offset,
                                 uint32_t ll0, uint32_t* out) {
    if (offset >= 3) {
        out[2] = rep[1];
        out[1] = rep[0];
        out[0] = offset - 2;
        return;
    }
    const uint32_t slot = offset + ll0;
    if (slot == 0) {
        out[0] = rep[0];
        out[1] = rep[1];
        out[2] = rep[2];
        return;
    }
    const uint32_t dist = slot == 3 ? rep[0] - 1 : rep[slot];
    out[2] = slot >= 2 ? rep[1] : rep[2];
    out[1] = rep[0];
    out[0] = dist;
}

// ---- optimal parse ---------------------------------------------------------
// One DP per segment: row_price[i] is the cheapest way to reach offset i
// from the segment start, extended either by one literal or by any
// collected match.  A "sufficient length" candidate ends the segment
// immediately; otherwise the DP runs to its horizon and the arrival chain
// is unwound into stored sequences.  All price comparisons, iteration
// orders, and early-exit conditions are behavior-exact
// (ZSTD_compressBlock_opt_generic:1046 documents the required decisions).
static int64_t zx_opt_block(ZxOptCtx* c, const uint8_t* istart,
                            int64_t srcSize, uint32_t* rep, uint32_t* s_ll,
                            uint32_t* s_ml, uint32_t* s_ob, int64_t seq_cap,
                            int64_t* last_lit) {
    const uint8_t* ip = istart;
    const uint8_t* anchor = istart;
    const uint8_t* const iend = istart + srcSize;
    const uint8_t* const ilimit = iend - 8;
    const uint8_t* const prefixStart = c->base + c->dictLimit;
    const uint32_t early_out_len =
        c->tlen < ((1u << 12) - 1) ? c->tlen : ((1u << 12) - 1);
    const uint32_t mls = 3 > (c->mml < 6 ? c->mml : 6)
                             ? 3
                             : (c->mml < 6 ? c->mml : 6);
    const uint32_t minMatch = mls == 3 ? 3 : 4;
    uint32_t fill3_from = c->nextToUpdate;
    int32_t* const price = c->row_price;
    uint32_t* const vlen = c->row_vlen;
    uint32_t* const voff = c->row_voff;
    uint32_t* const lead = c->row_lead;
    uint32_t* const rrow = c->row_rep;
    ZxOptMatch* const found = c->matches;
    const int32_t kUnreached = 1 << 30;
    int64_t n_seq = 0;

    zx_opt_rescaleFreqs(c, istart, srcSize);
    ip += (ip == prefixStart) ? 1 : 0;

    while (ip < ilimit) {
        // the step that ends this segment, and the row it departs from
        uint32_t cut_lead = 0, cut_mlen = 0, cut_off = 0;
        uint32_t from = 0;
        int have_cut = 0;
        uint32_t horizon = 0;

        // ---- seed the row at the segment head ----
        {
            const uint32_t litrun = (uint32_t)(ip - anchor);
            uint32_t n = bt_collect_matches(found, c, &fill3_from, ip, iend,
                                            rep, litrun == 0, minMatch, mls);
            if (n == 0) {
                ip++;
                continue;
            }
            rrow[0] = rep[0];
            rrow[1] = rep[1];
            rrow[2] = rep[2];
            vlen[0] = 0;
            lead[0] = litrun;
            price[0] = (int32_t)zx_litLengthPrice(litrun, c);
            if (found[n - 1].len > early_out_len) {
                cut_lead = litrun;
                cut_mlen = found[n - 1].len;
                cut_off = found[n - 1].off;
                from = 0;
                have_cut = 1;
            } else {
                const uint32_t open_price =
                    (uint32_t)price[0] + zx_litLengthPrice(0, c);
                uint32_t pos = 1;
                for (; pos < minMatch; pos++) price[pos] = kUnreached;
                for (uint32_t k = 0; k < n; k++) {
                    const uint32_t off = found[k].off;
                    const uint32_t end = found[k].len;
                    for (; pos <= end; pos++) {
                        vlen[pos] = pos;
                        voff[pos] = off;
                        lead[pos] = litrun;
                        price[pos] = (int32_t)(open_price +
                                               zx_getMatchPrice(off, pos, c));
                    }
                }
                horizon = pos - 1;
            }
        }

        // ---- relax forward ----
        if (!have_cut) {
            uint32_t at;
            for (at = 1; at <= horizon; at++) {
                const uint8_t* const here = ip + at;
                // arriving by one more literal
                {
                    const uint32_t run = vlen[at - 1] == 0
                                             ? lead[at - 1] + 1
                                             : 1;
                    const int32_t p =
                        price[at - 1]
                        + (int32_t)zx_rawLiteralsCost(here - 1, 1, c)
                        + (int32_t)zx_litLengthPrice(run, c)
                        - (int32_t)zx_litLengthPrice(run - 1, c);
                    if (p <= price[at]) {
                        vlen[at] = 0;
                        voff[at] = 0;
                        lead[at] = run;
                        price[at] = p;
                    }
                }
                // repcode history for this row
                if (vlen[at] != 0) {
                    const uint32_t src_row = at - vlen[at];
                    zx_updateRep3(rrow + 3 * src_row, voff[at],
                                  lead[at] == 0, rrow + 3 * at);
                } else {
                    rrow[3 * at] = rrow[3 * (at - 1)];
                    rrow[3 * at + 1] = rrow[3 * (at - 1) + 1];
                    rrow[3 * at + 2] = rrow[3 * (at - 1) + 2];
                }
                if (here > ilimit) continue;
                if (at == horizon) break;
                if (c->optLevel == 0
                    && price[at + 1] <= price[at] + (1 << 8) / 2)
                    continue;  // btopt speed shortcut: skip covered rows
                {
                    const uint32_t ll0 = vlen[at] != 0;
                    const uint32_t litrun = vlen[at] == 0 ? lead[at] : 0;
                    const uint32_t open_price =
                        (uint32_t)price[at] + zx_litLengthPrice(0, c);
                    const uint32_t n = bt_collect_matches(
                        found, c, &fill3_from, here, iend, rrow + 3 * at,
                        ll0, minMatch, mls);
                    if (n == 0) continue;
                    const uint32_t top = found[n - 1].len;
                    if (top > early_out_len || at + top >= (1u << 12)) {
                        cut_mlen = top;
                        cut_off = found[n - 1].off;
                        cut_lead = litrun;
                        from = at - (vlen[at] == 0 ? lead[at] : 0);
                        if (from > (1u << 12)) from = 0;
                        have_cut = 1;
                        break;
                    }
                    for (uint32_t k = 0; k < n; k++) {
                        const uint32_t off = found[k].off;
                        const uint32_t top_len = found[k].len;
                        const uint32_t low_len =
                            k > 0 ? found[k - 1].len + 1 : minMatch;
                        for (uint32_t ml = top_len; ml >= low_len; ml--) {
                            const uint32_t to = at + ml;
                            const int32_t p =
                                (int32_t)(open_price
                                          + zx_getMatchPrice(off, ml, c));
                            if (to > horizon || p < price[to]) {
                                while (horizon < to) {
                                    horizon++;
                                    price[horizon] = kUnreached;
                                }
                                vlen[to] = ml;
                                voff[to] = off;
                                lead[to] = litrun;
                                price[to] = p;
                            } else if (c->optLevel == 0) {
                                break;  // btopt: shorter lengths won't win
                            }
                        }
                    }
                }
            }
            if (!have_cut) {
                // the horizon row itself ends the segment
                cut_lead = lead[horizon];
                cut_mlen = vlen[horizon];
                cut_off = voff[horizon];
                from = horizon > cut_lead + cut_mlen
                           ? horizon - (cut_lead + cut_mlen)
                           : 0;
            }
        }

        // ---- resolve the final repcode history ----
        if (cut_mlen != 0) {
            uint32_t nr[3];
            zx_updateRep3(rrow + 3 * from, cut_off, cut_lead == 0, nr);
            rep[0] = nr[0];
            rep[1] = nr[1];
            rep[2] = nr[2];
        } else {
            rep[0] = rrow[3 * from];
            rep[1] = rrow[3 * from + 1];
            rep[2] = rrow[3 * from + 2];
        }

        // ---- unwind the arrival chain into forward order ----
        {
            const uint32_t top = from + 1;
            uint32_t lo = top;
            uint32_t walk = from;
            vlen[top] = cut_mlen;
            voff[top] = cut_off;
            lead[top] = cut_lead;
            while (walk > 0) {
                const uint32_t back = lead[walk] + vlen[walk];
                lo--;
                vlen[lo] = vlen[walk];
                voff[lo] = voff[walk];
                lead[lo] = lead[walk];
                walk = walk > back ? walk - back : 0;
            }
            for (uint32_t k = lo; k <= top; k++) {
                const uint32_t llen = lead[k];
                const uint32_t mlen = vlen[k];
                if (mlen == 0) {
                    ip = anchor + llen;  // trailing literals, no step
                    continue;
                }
                zx_opt_updateStats(c, llen, anchor, voff[k], mlen);
                if (n_seq >= seq_cap) return -1;
                s_ll[n_seq] = llen;
                s_ml[n_seq] = mlen;
                s_ob[n_seq] = voff[k] + 1;
                n_seq++;
                anchor += llen + mlen;
                ip = anchor;
            }
            zx_opt_setBasePrices(c);
        }
    }
    *last_lit = iend - anchor;
    return n_seq;
}

// btultra2 two-pass (ZSTD_initStats_ultra:1362 + ZSTD_compressBlock_btultra2).
static int64_t zx_opt_parse(ZxOptCtx* c, const uint8_t* block,
                            int64_t srcSize, uint32_t* rep, uint32_t* s_ll,
                            uint32_t* s_ml, uint32_t* s_ob, int64_t seq_cap,
                            int64_t* last_lit) {
    const uint32_t curr = (uint32_t)(block - c->base);
    if (c->is_ultra2 && c->llSum == 0 && curr == c->dictLimit
        && srcSize > 1024) {
        uint32_t tmpRep[3] = {rep[0], rep[1], rep[2]};
        int64_t ll_dummy;
        if (zx_opt_block(c, block, srcSize, tmpRep, s_ll, s_ml, s_ob,
                         seq_cap, &ll_dummy) < 0)
            return -1;
        c->base -= srcSize;
        c->dictLimit += (uint32_t)srcSize;
        c->nextToUpdate = c->dictLimit;
    }
    return zx_opt_block(c, block, srcSize, rep, s_ll, s_ml, s_ob, seq_cap,
                        last_lit);
}

static ZxOptCtx* zx_opt_create(const uint8_t* src, uint32_t wlog,
                               uint32_t clog, uint32_t hlog, uint32_t slog,
                               uint32_t tlen, uint32_t mml, int strat) {
    ZxOptCtx* c = (ZxOptCtx*)calloc(1, sizeof(ZxOptCtx));
    if (!c) return nullptr;
    c->base = src - 2;
    c->src0 = src;
    c->dictLimit = 2;
    c->nextToUpdate = 2;
    c->wlog = wlog; c->clog = clog; c->hlog = hlog; c->slog = slog;
    c->tlen = tlen; c->mml = mml;
    // fracWeight pricing for btopt too: the reference's opt0 tier trades
    // ~0.5% ratio for ~10% speed via coarse prices + skip shortcuts;
    // measured on the mixed corpus, the accurate prices win at both L16
    // and L17 while staying within ~0.9x of the oracle's speed.
    c->optLevel = 2;
    // First-block stats seeding also pays for btultra (the reference gates
    // it to btultra2; measured -0.11% at L18 on the mixed corpus).
    c->is_ultra2 = strat >= 8;
    const uint32_t mls = 3 > (mml < 6 ? mml : 6) ? 3 : (mml < 6 ? mml : 6);
    c->hashLog3 = mls == 3 ? (17 < wlog ? 17 : wlog) : 0;
    c->hashTable = (uint32_t*)calloc((size_t)1 << hlog, 4);
    c->bt = (uint32_t*)calloc((size_t)1 << clog, 4);
    c->hash3 = c->hashLog3
                   ? (uint32_t*)calloc((size_t)1 << c->hashLog3, 4)
                   : nullptr;
    c->row_price = (int32_t*)malloc(4 * 4099 * (sizeof(int32_t) + 4));
    c->matches = (ZxOptMatch*)malloc(sizeof(ZxOptMatch) * 4099);
    if (!c->hashTable || !c->bt || (c->hashLog3 && !c->hash3)
        || !c->row_price || !c->matches) {
        free(c->hashTable); free(c->bt); free(c->hash3); free(c->row_price);
        free(c->matches); free(c);
        return nullptr;
    }
    c->row_vlen = (uint32_t*)(c->row_price + 4099);
    c->row_voff = c->row_vlen + 4099;
    c->row_lead = c->row_voff + 4099;
    c->row_rep = c->row_lead + 4099;
    return c;
}

static void zx_opt_free(ZxOptCtx* c) {
    if (!c) return;
    free(c->hashTable); free(c->bt); free(c->hash3); free(c->row_price);
    free(c->matches); free(c);
}

// ZSTD_isRLE:3671.
static int zx_is_rle(const uint8_t* ip, int64_t length) {
    const uint8_t value = ip[0];
    for (int64_t i = 1; i < length; i++)
        if (ip[i] != value) return 0;
    return 1;
}

// Bridge: run the exact entropy pipeline over a seqstore produced by any
// of the match finders (ll/ml = raw lengths, ob = offBase).  Returns the
// body size, or -1 when a raw block wins (maxCSize bail included); the
// caller swaps prev/next on success.
static int64_t zx_block_from_arrays(const uint8_t* block, int64_t bn,
                                    const uint32_t* ll, const uint32_t* mlv,
                                    const uint32_t* ob, int64_t n_seq,
                                    int64_t last_lit, ZxEntropy* prev,
                                    ZxEntropy* next, int strategy,
                                    uint8_t* out, int64_t cap) {
    static thread_local uint8_t* litbuf = nullptr;
    static thread_local ZxSeq* seqbuf = nullptr;
    if (!litbuf) {
        litbuf = (uint8_t*)malloc((1 << 17) + 64);
        seqbuf = (ZxSeq*)malloc(((1 << 17) / 3 + 64) * sizeof(ZxSeq));
        if (!litbuf || !seqbuf) return -1;
    }
    ZxStore ss{litbuf, 0, seqbuf, 0, 0, 0};
    int64_t p = 0;
    for (int64_t i = 0; i < n_seq; i++) {
        zx_store_seq(&ss, block + p, ll[i], ob[i] - 1,
                     (int64_t)mlv[i] - 3);
        p += (int64_t)ll[i] + mlv[i];
    }
    std::memcpy(ss.lit + ss.nlit, block + bn - last_lit, (size_t)last_lit);
    ss.nlit += last_lit;
    const int64_t c =
        zx_entropy_compress(&ss, prev, next, strategy, out, cap, bn);
    if (c <= 0) return -1;
    if (c >= bn - zx_min_gain(bn, strategy)) return -1;
    return c;
}

// ---------------------------------------------------------------------------
// EXACT BLOCK SPLITTER (ZSTD_compressBlock_splitBlock_internal:4390,
// ZSTD_seqStore_resolveOffCodes:4197, ZSTD_deriveBlockSplitsHelper:4328).
// Partitions a parsed block at sequence boundaries; partitions that do not
// compress are emitted raw/RLE, with the decoder-visible repcode history
// (dRep) tracked separately from the parse history (cRep) and divergent
// repcode references materialised to literal offsets.
// ---------------------------------------------------------------------------

// ZSTD_resolveRepcodeToRawOffset:4173.
static inline uint32_t zx_rep_to_raw(const uint32_t* rep, uint32_t offCode,
                                     uint32_t ll0) {
    const uint32_t adjusted = offCode + ll0;
    if (adjusted == 3) return rep[0] - 1;
    return rep[adjusted];
}

// Mutates ob[] (offBase form) in place.
static void zx_resolve_offcodes(uint32_t* seen_rep, uint32_t* parse_rep,
                                const uint32_t* ll_arr, uint32_t* ob,
                                int64_t nbSeq) {
    for (int64_t i = 0; i < nbSeq; i++) {
        const uint32_t ll0 = ll_arr[i] == 0;
        const uint32_t offCode = ob[i] - 1;
        if (offCode <= 2) {
            const uint32_t seen_dist = zx_rep_to_raw(seen_rep, offCode, ll0);
            const uint32_t parse_dist = zx_rep_to_raw(parse_rep, offCode, ll0);
            if (seen_dist != parse_dist) ob[i] = parse_dist + 3;
        }
        uint32_t nd[3], nc[3];
        zx_updateRep3(seen_rep, ob[i] - 1, ll0, nd);
        zx_updateRep3(parse_rep, offCode, ll0, nc);
        std::memcpy(seen_rep, nd, 12);
        std::memcpy(parse_rep, nc, 12);
    }
}

// Chunk cost for the split search: the reference's entropy-statistics
// estimate (ZSTD_buildEntropyStatisticsAndEstimateSubBlockSize +
// ZSTD_estimateBlockSize family, ZstdCompress.cs:3943-4080).  The chunk's
// encoding types are selected against the running frame entropy, candidate
// tables are built for their header sizes, and the payload is priced in
// fractional bits without encoding anything.  Matching the estimator (not
// a trial encode) matters: its rounding and header charges drive the
// oracle's split decisions, and it is several times cheaper per chunk.
static int64_t zx_chunk_cost(const uint8_t* block, int64_t blockSize,
                             const uint32_t* ll, const uint32_t* mlv,
                             const uint32_t* ob, const int64_t* seq_start,
                             int64_t nseq, int64_t last_lit, int64_t a,
                             int64_t b, const ZxEntropy* prev, int strategy) {
    static thread_local ZxEntropy* scratch = nullptr;
    if (!scratch) {
        scratch = (ZxEntropy*)malloc(sizeof(ZxEntropy));
        if (!scratch) return -1;
    }
    const int64_t nbSeq = b - a;
    // ---- chunk histograms: literal bytes, channel codes, extra bits ----
    uint32_t litCnt[256] = {0}, llCnt[36] = {0}, ofCnt[32] = {0},
             mlCnt[53] = {0};
    uint64_t llXtra = 0, ofXtra = 0, mlXtra = 0;
    // first/last channel codes: RLE emits the first, the compressed-table
    // normalizer discounts the last (ZSTD_buildCTable's nbSeq-1 rule)
    uint8_t llC0 = 0, ofC0 = 0, mlC0 = 0, llCL = 0, ofCL = 0, mlCL = 0;
    int64_t litSize = 0;
    for (int64_t i = a; i < b; i++) {
        const uint8_t* lp = block + seq_start[i];
        const uint32_t l = ll[i];
        for (uint32_t u = 0; u < l; u++) litCnt[lp[u]]++;
        litSize += l;
        const uint8_t lc = (uint8_t)zx_llcode(l);
        const uint8_t oc = (uint8_t)highbit32(ob[i]);
        const uint8_t mc = (uint8_t)zx_mlcode(mlv[i]);
        if (i == a) { llC0 = lc; ofC0 = oc; mlC0 = mc; }
        llCL = lc; ofCL = oc; mlCL = mc;
        llCnt[lc]++; ofCnt[oc]++; mlCnt[mc]++;
        llXtra += kLLBits[lc]; ofXtra += oc; mlXtra += kMLBits[mc];
    }
    if (b == nseq) {  // final chunk carries the trailing literals
        const uint8_t* lp = block + blockSize - last_lit;
        for (int64_t u = 0; u < last_lit; u++) litCnt[lp[u]]++;
        litSize += last_lit;
    }
    // ---- literals: type selection + size estimate ----
    ZxSbMeta m;
    m.huf_hdr_bytes = 0;
    m.fse_hdr_bytes = 0;
    m.tail_count_fix = 0;
    if (zx_stats_lit_counts(litCnt, litSize, &prev->huf, &scratch->huf, &m) <
        0)
        return -1;
    int64_t litEst;
    if (m.hType == 0) {
        litEst = litSize;
    } else if (m.hType == 1) {
        litEst = 1;
    } else {
        uint32_t maxSym = 255;
        while (maxSym > 0 && litCnt[maxSym] == 0) maxSym--;
        int64_t e = (int64_t)zx_huf_estimate(&scratch->huf.ct, litCnt, maxSym);
        if (m.hType == 2) e += m.huf_hdr_bytes;  // lit_tables_due
        if (litSize >= 256) e += 6;           // 4-stream jump table
        litEst = e + 3 + (litSize >= 1024) + (litSize >= 16 * 1024);
    }
    // ---- sequences: per-channel selection, table build, bit pricing ----
    // Selection order mirrors ZSTD_buildBlockEntropyStats_sequences
    // (LL, OF, ML); each channel's bits are floored to bytes separately
    // (ZSTD_estimateBlockSize_symbolType rounds per channel).
    uint8_t tbl[256];
    uint8_t* p = tbl;
    int64_t chBytes[3];
    struct Ch {
        uint32_t* cnt;
        uint32_t maxCode, fseLog;
        const int16_t* defNorm;
        uint32_t defLog, defMax;
        ZxFseCh* prevCh;
        ZxFseCh* outCh;
        uint8_t code0;
        uint8_t codeL;
        uint64_t xtra;
    };
    Ch chans[3] = {
        {llCnt, 35, 9, kLLNorm, 6, 35, (ZxFseCh*)&prev->ll, &scratch->ll,
         llC0, llCL, llXtra},
        {ofCnt, 31, 8, kOFNorm, 5, 28, (ZxFseCh*)&prev->of, &scratch->of,
         ofC0, ofCL, ofXtra},
        {mlCnt, 52, 9, kMLNorm, 6, 52, (ZxFseCh*)&prev->ml, &scratch->ml,
         mlC0, mlCL, mlXtra},
    };
    for (int k = 0; k < 3; k++) {
        Ch& c = chans[k];
        uint32_t max = c.maxCode;
        while (max > 0 && c.cnt[max] == 0) max--;
        uint32_t mostFrequent = 0;
        for (uint32_t s = 0; s <= max; s++)
            if (c.cnt[s] > mostFrequent) mostFrequent = c.cnt[s];
        const int defaultAllowed = max <= c.defMax;
        *c.outCh = *c.prevCh;
        const int type = zx_select_encoding(&c.outCh->rep, c.cnt, max,
                                            mostFrequent, (uint64_t)nbSeq,
                                            c.fseLog, c.prevCh, c.defNorm,
                                            c.defLog, defaultAllowed,
                                            strategy);
        uint32_t cntCopy[53];
        std::memcpy(cntCopy, c.cnt, sizeof(uint32_t) * (max + 1));
        const int64_t cs = zx_build_seq_ctable(
            p, (int64_t)(sizeof tbl - (p - tbl)), c.outCh, c.fseLog, type,
            cntCopy, max, c.code0, c.codeL, (uint64_t)nbSeq, c.defNorm,
            c.defLog, c.defMax);
        if (cs < 0) return -1;
        p += cs;
        int64_t fbits;
        if (type == 1)
            fbits = 0;
        else if (type == 0)
            fbits = cost_predefined(c.defNorm, c.defLog, c.cnt, max);
        else
            fbits = cost_prev_table(c.outCh, c.cnt, max);
        chBytes[k] = (fbits < 0 || fbits >= kZxErr)
                         ? nbSeq * 10
                         : (int64_t)(((uint64_t)fbits + c.xtra) >> 3);
    }
    const int64_t seqHeader = 1 + 1 + (nbSeq >= 128) + (nbSeq >= 0x7F00);
    return litEst + chBytes[0] + chBytes[1] + chBytes[2] + (p - tbl) +
           seqHeader + 3;
}

struct ZxSplits { int64_t loc[200]; int n; };

static void zx_derive_splits(ZxSplits* sp, int64_t first_seq, int64_t end_seq,
                             const uint8_t* block, int64_t blockSize,
                             const uint32_t* ll, const uint32_t* mlv,
                             const uint32_t* ob, const int64_t* seq_start,
                             int64_t nseq, int64_t last_lit,
                             const ZxEntropy* prev, int strategy) {
    static const int64_t min_seqs = [] {
        const char* e = getenv("ZT_SB_MIN");
        return e ? atoll(e) : 300LL;
    }();
    if (end_seq - first_seq < min_seqs || sp->n >= 196) return;
    const int64_t mid = (first_seq + end_seq) / 2;
    const int64_t full = zx_chunk_cost(block, blockSize, ll, mlv, ob,
                                       seq_start, nseq, last_lit, first_seq,
                                       end_seq, prev, strategy);
    const int64_t lo = zx_chunk_cost(block, blockSize, ll, mlv, ob, seq_start,
                                     nseq, last_lit, first_seq, mid, prev,
                                     strategy);
    const int64_t hi = zx_chunk_cost(block, blockSize, ll, mlv, ob, seq_start,
                                     nseq, last_lit, mid, end_seq, prev,
                                     strategy);
    if (full < 0 || lo < 0 || hi < 0) return;
    if (lo + hi < full) {
        zx_derive_splits(sp, first_seq, mid, block, blockSize, ll, mlv, ob,
                         seq_start, nseq, last_lit, prev, strategy);
        sp->loc[sp->n++] = mid;
        zx_derive_splits(sp, mid, end_seq, block, blockSize, ll, mlv, ob,
                         seq_start, nseq, last_lit, prev, strategy);
    }
}

// Emits one parsed block as 1..N partitions.  Returns emitted bytes or -1;
// on success, ent2[*prevIdxP].repcodes hold the decoder-visible history.
static int64_t zx_split_block_emit(const uint8_t* block, int64_t blockSize,
                                   int lastBlock, int isFirstBlock,
                                   uint32_t* ll, uint32_t* mlv, uint32_t* ob,
                                   int64_t nseq, int64_t last_lit,
                                   ZxEntropy* ent2, int* prevIdxP,
                                   int strategy, uint8_t* out, int64_t cap) {
    int64_t* seq_start = (int64_t*)malloc((size_t)(nseq + 1) * 8);
    if (!seq_start) return -1;
    {
        int64_t curp = 0;
        for (int64_t i = 0; i < nseq; i++) {
            seq_start[i] = curp;
            curp += (int64_t)ll[i] + mlv[i];
        }
        seq_start[nseq] = curp;
    }
    ZxSplits sp;
    sp.n = 0;
    if (nseq > 4)
        zx_derive_splits(&sp, 0, nseq, block, blockSize, ll, mlv, ob,
                         seq_start, nseq, last_lit, &ent2[*prevIdxP],
                         strategy);
    sp.loc[sp.n] = nseq;
    uint32_t seen_rep[3], parse_rep[3];
    std::memcpy(seen_rep, ent2[*prevIdxP].repcodes, 12);
    std::memcpy(parse_rep, ent2[*prevIdxP].repcodes, 12);
    int64_t op = 0;
    int64_t a = 0;
    for (int k = 0; k <= sp.n; k++) {
        const int64_t b = sp.loc[k];
        const int64_t pa = seq_start[a];
        const int64_t pb = k == sp.n ? blockSize : seq_start[b];
        const int64_t pbn = pb - pa;
        const int64_t plast = k == sp.n ? last_lit : 0;
        const int lastPart = (k == sp.n) && lastBlock;
        uint32_t seen_rep_orig[3];
        std::memcpy(seen_rep_orig, seen_rep, 12);
        if (sp.n > 0)  // isPartition (ZSTD_compressSeqStore_singleBlock:4238)
            zx_resolve_offcodes(seen_rep, parse_rep, ll + a, ob + a, b - a);
        if (cap - op < 3 + pbn + 32) {
            free(seq_start);
            return -1;
        }
        const int64_t c = zx_block_from_arrays(
            block + pa, pbn, ll + a, mlv + a, ob + a, b - a, plast,
            &ent2[*prevIdxP], &ent2[*prevIdxP ^ 1], strategy, out + op + 3,
            cap - op - 3 - 8);
        if (c >= 0 && !isFirstBlock && c < 25 && zx_is_rle(block + pa, pbn)) {
            // RLE partition: decoder executes no sequences -> revert seen_rep
            const uint32_t bh =
                (uint32_t)(lastPart + (1u << 1) + ((uint32_t)pbn << 3));
            out[op] = (uint8_t)bh;
            out[op + 1] = (uint8_t)(bh >> 8);
            out[op + 2] = (uint8_t)(bh >> 16);
            out[op + 3] = block[pa];
            op += 4;
            std::memcpy(seen_rep, seen_rep_orig, 12);
        } else if (c < 0) {
            // raw partition
            const uint32_t bh =
                (uint32_t)(lastPart + (0u << 1) + ((uint32_t)pbn << 3));
            out[op] = (uint8_t)bh;
            out[op + 1] = (uint8_t)(bh >> 8);
            out[op + 2] = (uint8_t)(bh >> 16);
            std::memcpy(out + op + 3, block + pa, (size_t)pbn);
            op += 3 + pbn;
            std::memcpy(seen_rep, seen_rep_orig, 12);
        } else {
            *prevIdxP ^= 1;  // confirm repcodes + entropy tables
            const uint32_t bh =
                (uint32_t)(lastPart + (2u << 1) + ((uint32_t)c << 3));
            out[op] = (uint8_t)bh;
            out[op + 1] = (uint8_t)(bh >> 8);
            out[op + 2] = (uint8_t)(bh >> 16);
            op += 3 + c;
        }
        a = b;
    }
    // Split case: the decoder-visible history replaces the parse's reps
    // (ZSTD_compressBlock_splitBlock_internal:4460 memcpy of seen_rep).  The
    // unsplit case returns early in the reference — reps flow through the
    // confirm-swap from the parse — so they must not be overwritten here.
    if (sp.n > 0) std::memcpy(ent2[*prevIdxP].repcodes, seen_rep, 12);
    free(seq_start);
    return op;
}

extern "C" {

// ---------------------------------------------------------------------------
// Long-distance matcher (ZstdLdm.cs role: gear rolling hash + bucket table)
// ---------------------------------------------------------------------------
//
// A gear hash is fed byte-by-byte (ZSTD_ldm_gear_feed:84); positions where
// (hash & mask) == 0 become anchors inserted into / probed against a bucket
// table, yielding matches across windows far beyond the chain table reach.
// Emitted candidates are merged with the short-range parser per block.

static uint64_t kGear[256];
static bool kGearInit = false;

static void ldm_init() {
    if (kGearInit) return;
    // Arithmetic gear shared with the device scan (ops/ldm.py): anchor
    // placement is encoder-internal, and a multiplicative-hash gear keeps
    // the device path gather-free.  Values masked to rate_log+8 bits so
    // the device's int32 arithmetic is exact (rate_log default 7).
    for (int i = 0; i < 256; i++) {
        const uint32_t v = ((uint32_t)(i + 1)) * 0x9E3779B1u;
        kGear[i] = (v >> 12) & 0x7FFFu;
    }
    kGearInit = true;
}

struct LdmMatch { int64_t pos; int64_t len; int64_t dist; };

// Scan [start, end) emitting non-overlapping long matches (>= min_len).
// bucket table: hash_log buckets x 4 entries of positions (-1 empty).
static int64_t ldm_scan(const uint8_t* src, int64_t start, int64_t end,
                        int64_t window_start, int64_t* buckets, int hash_log,
                        int rate_log, int64_t min_len,
                        LdmMatch* out, int64_t cap) {
    ldm_init();
    const uint64_t mask = (1ULL << rate_log) - 1;
    const int64_t nbuck = 1LL << hash_log;
    uint64_t h = 0;
    int64_t n_out = 0;
    int64_t next_free = start;
    for (int64_t i = start; i + 8 < end; i++) {
        h = (h << 1) + kGear[src[i]];
        if ((h & mask) != 0) continue;
        const int64_t b = (int64_t)((h >> rate_log) & (uint64_t)(nbuck - 1)) * 4;
        int64_t best_len = 0, best_dist = 0;
        if (i >= next_free && n_out < cap) {
            for (int e = 0; e < 4; e++) {
                const int64_t cand = buckets[b + e];
                if (cand < window_start || cand >= i) continue;
                if (read64(src + cand) != read64(src + i)) continue;
                int64_t len = 8 + count_match(src, i + 8, cand + 8, end);
                // backward extension up to next_free
                int64_t s = i, cs = cand;
                while (s > next_free && cs > window_start &&
                       src[s - 1] == src[cs - 1]) { s--; cs--; len++; }
                if (len > best_len) { best_len = len; best_dist = s - cs;
                                      out[n_out].pos = s; }
            }
        }
        // insert (rotate bucket)
        buckets[b + 3] = buckets[b + 2];
        buckets[b + 2] = buckets[b + 1];
        buckets[b + 1] = buckets[b + 0];
        buckets[b + 0] = i;
        if (best_len >= min_len) {
            out[n_out].len = best_len;
            out[n_out].dist = best_dist;
            next_free = out[n_out].pos + best_len;
            n_out++;
        }
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// Optimal parser (btopt/btultra role, levels 13+; ZstdOpt.cs:1046 shape)
// ---------------------------------------------------------------------------
//
// Forward DP over the block with fixed-point prices (1/32 bit units):
// literal prices from the block histogram, match prices from the predefined
// OF/ML code distributions + extra bits + a flat per-sequence overhead.
// Candidates come from the hash chain (all attempts, not first-best) plus
// the three repcodes; lengths are relaxed at ml-code boundaries only, which
// preserves optimality of the step-function price model at O(codes) cost.

static const uint32_t kInfPrice = 0x3FFFFFFF;

struct OptCell {
    uint32_t price;
    int32_t from;       // previous position
    uint32_t ml;        // 0 = literal step
    uint32_t off_base;  // offBase when ml > 0
    uint32_t lits;      // literal-run length ending at this cell
    uint32_t rep[3];
};

// Adaptive symbol statistics for the optimal parser (ZSTD_rescaleFreqs /
// ZSTD_initStats_ultra role).  Counts carry across blocks with decay; price
// tables are 1/32-bit fixed point code costs (extra bits added separately).
struct OptStats {
    uint32_t llc[36], mlc[53], ofc[32];
    uint32_t ll_price[36], ml_price[53], of_price[32];
    bool inited;
};

static void opt_build_prices(OptStats* st) {
    auto build = [](const uint32_t* cnt, uint32_t* price, int n) {
        uint64_t total = 0;
        for (int i = 0; i < n; i++) total += cnt[i];
        const float lt = __builtin_log2f((float)(total + (uint64_t)n));
        for (int i = 0; i < n; i++) {
            float bits = lt - __builtin_log2f((float)(cnt[i] + 1));
            if (bits > 20.f) bits = 20.f;
            if (bits < 0.125f) bits = 0.125f;
            price[i] = (uint32_t)(bits * 256.f + 0.5f);  // 1/256-bit units
        }
    };
    build(st->llc, st->ll_price, 36);
    build(st->mlc, st->ml_price, 53);
    build(st->ofc, st->of_price, 32);
}

// Seed from the predefined FSE distributions (first block, first pass).
static void opt_seed_default(OptStats* st) {
    for (int i = 0; i < 36; i++) st->llc[i] = (uint32_t)(kLLNorm[i] < 1 ? 1 : kLLNorm[i]) * 8;
    for (int i = 0; i < 53; i++) st->mlc[i] = (uint32_t)(kMLNorm[i] < 1 ? 1 : kMLNorm[i]) * 8;
    for (int i = 0; i < 32; i++)
        st->ofc[i] = i <= kDefaultMaxOFF && kOFNorm[i] >= 1 ? (uint32_t)kOFNorm[i] * 8 : 1;
    st->inited = false;
    opt_build_prices(st);
}

// Fold a block's emitted sequences into the running stats.
static void opt_update_stats(OptStats* st, const uint32_t* ll,
                             const uint32_t* mlv, const uint32_t* ob,
                             int64_t n_seq, bool decay) {
    if (decay) {
        static const int kShift =
            getenv("ZT_OPT_DECAY") ? atoi(getenv("ZT_OPT_DECAY")) : 2;
        for (int i = 0; i < 36; i++) st->llc[i] -= st->llc[i] >> kShift;
        for (int i = 0; i < 53; i++) st->mlc[i] -= st->mlc[i] >> kShift;
        for (int i = 0; i < 32; i++) st->ofc[i] -= st->ofc[i] >> kShift;
    }
    const uint32_t vmax = (1u << 17) - 1;
    for (int64_t i = 0; i < n_seq; i++) {
        st->llc[kLLCodeLut[ll[i] < vmax ? ll[i] : vmax]]++;
        st->mlc[kMLCodeLut[mlv[i] < vmax ? mlv[i] : vmax]]++;
        st->ofc[highbit32(ob[i])]++;
    }
    st->inited = true;
    opt_build_prices(st);
}

static inline uint32_t of_code_price32(int of_code) {
    // -log2(norm/32) for the predefined OF distribution, in 1/32 bits,
    // plus the extra bits the offset consumes.
    static const int16_t norm[29] = {1,1,1,1,1,1,2,2,2,1,1,1,1,1,1,1,1,1,
                                     1,1,1,1,1,1,1,1,1,1,1};
    const int code_bits = of_code <= 28 && norm[of_code] == 2 ? 4 : 5;
    return (uint32_t)(code_bits + of_code) * 32;
}

static inline uint32_t ml_price32(uint32_t mlv) {
    // ml code cost ~6 bits (predefined log) + extra bits
    const uint32_t base = mlv - 3;
    int extra = 0;
    if (base >= 32) {
        uint32_t c = kMLCodeLut[mlv < (1u << 17) ? mlv : (1u << 17) - 1];
        extra = kMLBits[c];
    }
    return (uint32_t)(6 + extra) * 32;
}

static inline uint32_t ll_price32(uint32_t llv) {
    int extra = 0;
    if (llv >= 16) {
        uint32_t c = kLLCodeLut[llv < (1u << 17) ? llv : (1u << 17) - 1];
        extra = kLLBits[c];
    }
    return (uint32_t)(6 + extra) * 32;
}

// Returns nb_seq or -1.  Uses the shared hash/chain tables like lazy.
// Prices come from OptStats (adaptive, carried across blocks); literal-run
// LL-code cost is added incrementally per literal step (ZSTD_litLengthPrice
// role), match steps add ML/OF code prices + extra bits.
int64_t opt_find_matches(const uint8_t* src, int64_t src_len,
                         int64_t start, int64_t end, int64_t window_start,
                         int64_t window_size,
                         int64_t* table, int hlog,
                         int32_t* bt, int64_t bt_size, int64_t attempts,
                         int64_t* h3, int h3log, int min_match,
                         int64_t* insert_from_io, uint32_t* rep_io,
                         OptStats* st,
                         uint32_t* out_ll, uint32_t* out_ml, uint32_t* out_ob,
                         int64_t max_seq, int64_t* out_last_lit) {
    const int64_t bn = end - start;
    if (bn < 32) { *out_last_lit = bn; return 0; }
    codec_init();
    if (min_match < 3) min_match = 3;
    const int bt_mls = min_match > 4 ? (min_match > 8 ? 8 : min_match) : 4;
    BtCtx c{src, table, bt, bt_size - 1, min_match == 3 ? h3 : nullptr, h3log,
            hlog, bt_mls, window_start, window_size, attempts,
            *insert_from_io, end - 8, end};

    // Literal prices from block histogram (floor 1/8 bit, cap 14 bits).
    uint32_t counts[256];
    std::memset(counts, 0, sizeof counts);
    for (int64_t i = start; i < end; i++) counts[src[i]]++;
    uint32_t lit_price[256];
    for (int s = 0; s < 256; s++) {
        if (!counts[s]) { lit_price[s] = 14 * 256; continue; }
        const double bits = -__builtin_log2((double)counts[s] / (double)bn);
        uint32_t p = (uint32_t)(bits * 256.0 + 0.5);
        if (p < 32) p = 32;
        if (p > 14 * 256) p = 14 * 256;
        lit_price[s] = p;
    }
    const uint32_t vmax = (1u << 17) - 1;
    auto LLP = [&](int64_t l) -> int64_t {
        const uint32_t code = kLLCodeLut[(uint64_t)l < vmax ? l : vmax];
        return (int64_t)st->ll_price[code] + (int64_t)kLLBits[code] * 256;
    };
    auto MLP = [&](int64_t m) -> int64_t {
        const uint32_t code = kMLCodeLut[(uint64_t)m < vmax ? m : vmax];
        return (int64_t)st->ml_price[code] + (int64_t)kMLBits[code] * 256;
    };
    auto OFP = [&](int oc) -> int64_t {
        return (int64_t)st->of_price[oc & 31] + (int64_t)(oc & 31) * 256;
    };

    OptCell* opt = (OptCell*)malloc(sizeof(OptCell) * (size_t)(bn + 1));
    if (!opt) return -1;
    for (int64_t i = 0; i <= bn; i++) opt[i].price = kInfPrice;
    opt[0].price = 0;
    opt[0].from = -1;
    opt[0].ml = 0;
    opt[0].lits = 0;
    opt[0].rep[0] = rep_io[0]; opt[0].rep[1] = rep_io[1]; opt[0].rep[2] = rep_io[2];

    // `dist` is always the true match distance; repcode values are
    // re-resolved against the real encoder state during emission, so the
    // per-cell rep triple only steers pricing/candidate generation.
    auto relax = [&](int64_t to, int64_t price64, int64_t from, uint32_t ml,
                     uint32_t dist, uint32_t lits, const uint32_t* rep) {
        const uint32_t price = price64 < 0 ? 0
                               : price64 >= kInfPrice ? kInfPrice - 1
                               : (uint32_t)price64;
        if (price < opt[to].price) {
            opt[to].price = price;
            opt[to].from = (int32_t)from;
            opt[to].ml = ml;
            opt[to].off_base = dist;
            opt[to].lits = lits;
            if (ml == 0 || dist == rep[0]) {
                opt[to].rep[0] = rep[0]; opt[to].rep[1] = rep[1]; opt[to].rep[2] = rep[2];
            } else {
                opt[to].rep[0] = dist; opt[to].rep[1] = rep[0]; opt[to].rep[2] = rep[1];
            }
        }
    };

    static const int64_t kSufficientLen =
        getenv("ZT_SUFLEN") ? atoi(getenv("ZT_SUFLEN")) : 192;
    // immediate-take shortcut (zstd btopt targetLength role): avoids
    // O(run^2) rep scanning inside runs.
    const int64_t dp_limit = bn - 8;
    for (int64_t i = 0; i < dp_limit; i++) {
        if (opt[i].price >= kInfPrice) continue;
        const int64_t p = start + i;
        const int64_t base_price = opt[i].price;
        const uint32_t* rep = opt[i].rep;
        const int64_t lits = opt[i].lits;
        // literal step (incremental LL-code price)
        relax(i + 1, base_price + lit_price[src[p]] +
                     LLP(lits + 1) - (lits > 0 ? LLP(lits) : 0),
              i, 0, 0, (uint32_t)(lits + 1), rep);
        const int64_t seq_base = base_price + (lits == 0 ? LLP(0) : 0);
        // sufficient-length shortcut: take a very long rep immediately
        {
            int64_t big = 0, big_dist = 0, big_vcode = 0;
            for (int r = 0; r < 3; r++) {
                const int64_t rl = rep_length(src, p, (int64_t)rep[r], window_start, end);
                if (rl > big) { big = rl; big_dist = rep[r]; big_vcode = r; }
            }
            if (big >= kSufficientLen) {
                const int64_t L = big < (int64_t)(bn - i) ? big : bn - i;
                relax(i + L, seq_base + MLP(L) + OFP(big_vcode == 0 ? 0 : 1),
                      i, (uint32_t)L, (uint32_t)big_dist, 0, rep);
                i += L - 1;
                continue;
            }
        }
        // rep matches (values 1..3 with ll>=1 semantics approximated)
        for (int r = 0; r < 3; r++) {
            const int64_t rl = rep_length(src, p, (int64_t)rep[r], window_start, end);
            if (rl >= 4) {
                const int64_t cap_len = rl < (int64_t)(bn - i) ? rl : bn - i;
                const int64_t op = OFP(r == 0 ? 0 : 1);
                // relax at ml-code boundaries + max
                for (int64_t L = cap_len; L >= 4; ) {
                    const uint32_t code = kMLCodeLut[L];
                    relax(i + L, seq_base + MLP(L) + op,
                          i, (uint32_t)L, rep[r], 0, rep);
                    if (code == 0) break;
                    const int64_t next_top = (int64_t)kMLBase[code] - 1;
                    if (next_top >= L) break;
                    L = next_top >= 4 ? next_top : 0;
                }
            }
        }
        // tree matches: all-candidates enumeration with increasing length
        if (p + 4 <= end - 4) {
            BtMatch mt[64];
            const int nm = bt_get_all_matches(&c, p, min_match, mt, 64);
            int64_t best_so_far = 0;
            int64_t lb = min_match;
            static const int kFullRelax =
                getenv("ZT_FULLRELAX") ? atoi(getenv("ZT_FULLRELAX")) : 0;
            for (int q = 0; q < nm; q++) {
                const int64_t len = mt[q].len;
                const int64_t off = mt[q].off;
                best_so_far = len;
                const int oc = highbit32((uint32_t)(off + 3));
                const int64_t op = OFP(oc);
                const int64_t cap_len = len < (int64_t)(bn - i) ? len : bn - i;
                if (kFullRelax && cap_len - lb <= kFullRelax) {
                    for (int64_t L = cap_len; L >= lb; L--)
                        relax(i + L, seq_base + MLP(L) + op, i, (uint32_t)L,
                              (uint32_t)off, 0, rep);
                } else {
                    for (int64_t L = cap_len; L >= lb; ) {
                        const uint32_t code = kMLCodeLut[L];
                        relax(i + L, seq_base + MLP(L) + op, i, (uint32_t)L,
                              (uint32_t)off, 0, rep);
                        if (code == 0) break;
                        const int64_t next_top = (int64_t)kMLBase[code] - 1;
                        if (next_top >= L) break;
                        L = next_top >= lb ? next_top : lb - 1;
                    }
                }
                lb = len + 1;  // shorter lengths already priced (closer offsets)
            }
            // sufficient-length shortcut for tree matches
            if (best_so_far >= kSufficientLen) {
                i += (best_so_far < (int64_t)(bn - i) ? best_so_far : bn - i) - 1;
                continue;
            }
        } else {
            bt_insert_upto(&c, p);
        }
    }
    // Find the furthest reachable cell; the remainder becomes last literals.
    int64_t cut = -1;
    for (int64_t i = bn; i >= 0; i--) {
        if (opt[i].price < kInfPrice) { cut = i; break; }
    }
    if (cut < 0) { free(opt); return -1; }

    // Backtrack: collect (ml, ob) steps.
    int64_t n_steps = 0;
    for (int64_t i = cut; i > 0; i = opt[i].from) n_steps++;
    // First pass gave steps in reverse; rebuild forward emitting sequences.
    int64_t* stack = (int64_t*)malloc(sizeof(int64_t) * (size_t)(n_steps + 1));
    if (!stack) { free(opt); return -1; }
    int64_t sp = 0;
    for (int64_t i = cut; i > 0; i = opt[i].from) stack[sp++] = i;
    int64_t n_seq = 0;
    int64_t anchor = 0;
    uint32_t rep[3] = {rep_io[0], rep_io[1], rep_io[2]};
    for (int64_t k = sp - 1; k >= 0; k--) {
        const int64_t i = stack[k];
        const OptCell* cell = &opt[i];
        if (cell->ml == 0) continue;  // literal step
        const int64_t pos = i - cell->ml;
        const uint32_t ll = (uint32_t)(pos - anchor);
        const uint32_t dist = cell->off_base;  // true distance
        // Map distance -> offset_value against the REAL emit-time rep state
        // (RFC 8878 §3.1.1.5), then update reps exactly like the decoder.
        const bool ll0 = ll == 0;
        uint32_t value;
        if (!ll0) {
            value = dist == rep[0] ? 1 : dist == rep[1] ? 2
                    : dist == rep[2] ? 3 : dist + 3;
        } else {
            value = dist == rep[1] ? 1 : dist == rep[2] ? 2
                    : (rep[0] > 1 && dist == rep[0] - 1) ? 3 : dist + 3;
        }
        if (value > 3) {
            rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = dist;
        } else if (value == 1) {
            if (ll0) { uint32_t t = rep[0]; rep[0] = rep[1]; rep[1] = t; }
        } else {
            const uint32_t idx = value - 1 + (ll0 ? 1 : 0);  // 1..3
            if (idx != 1) rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = dist;
        }
        if (n_seq >= max_seq) { free(stack); free(opt); return -1; }
        out_ll[n_seq] = ll;
        out_ml[n_seq] = cell->ml;
        out_ob[n_seq] = value;
        n_seq++;
        anchor = i;
    }
    *out_last_lit = bn - anchor;
    free(stack);
    free(opt);
    bt_insert_upto(&c, end - 8);
    *insert_from_io = c.insert_from;
    rep_io[0] = rep[0]; rep_io[1] = rep[1]; rep_io[2] = rep[2];
    return n_seq;
}


int64_t ldm_scan_debug(const uint8_t* src, int64_t n, int64_t* out_pos,
                       int64_t* out_len, int64_t* out_dist, int64_t cap) {
    const int hash_log = 20;
    const int64_t nb = (1LL << hash_log) * 4;
    int64_t* buckets = (int64_t*)malloc((size_t)nb * 8);
    for (int64_t i = 0; i < nb; i++) buckets[i] = -1;
    LdmMatch* m = (LdmMatch*)malloc(sizeof(LdmMatch) * (size_t)cap);
    int64_t k = ldm_scan(src, 0, n, 0, buckets, hash_log, 7, 64, m, cap);
    for (int64_t i = 0; i < k; i++) {
        out_pos[i] = m[i].pos; out_len[i] = m[i].len; out_dist[i] = m[i].dist;
    }
    free(buckets); free(m);
    return k;
}

// Whole-frame encode: all blocks incl. headers, NOT the frame header.
// strategy: 1-2 fast+dfast, 3-6 lazy, 7+ optimal.  use_ldm adds the gear
// long-distance pre-pass (matches merged as forced sequences; the
// short-range matcher parses the gaps).  Returns size or -1.
int64_t compress_frame_body_ldm_c(const uint8_t* src, int64_t n, int strategy,
                                  int hash_log, int chain_log, int search_log,
                                  int window_log, int accel, int use_ldm,
                                  int min_match, int split_mode,
                                  int target_cblock, uint8_t* out, int64_t cap);

int64_t compress_frame_body_c(const uint8_t* src, int64_t n, int strategy,
                              int hash_log, int chain_log, int search_log,
                              int window_log, int accel, uint8_t* out,
                              int64_t cap) {
    return compress_frame_body_ldm_c(src, n, strategy, hash_log, chain_log,
                                     search_log, window_log, accel, 0, 4,
                                     strategy >= 7, 0, out, cap);
}

// ---------------------------------------------------------------------------
// Block splitter (ZSTD_deriveBlockSplitsHelper:4328 role)
// ---------------------------------------------------------------------------
//
// Recursively split a block's sequence range at the midpoint whenever the
// estimated cost of the halves beats the whole.  Estimates are Shannon
// entropy of the literal bytes and LL/ML/OF code histograms plus fixed
// header charges.  Repcode semantics survive splitting because offset
// values are resolved against the decoder's cross-block rep state.

struct SplitView {
    const uint8_t* block;
    const uint32_t *ll, *ml, *ob;
    int64_t n_seq, last_lit, bn;
    const int64_t* seq_start;  // byte offset of each sequence's literals
};

static double split_entropy(const uint32_t* cnt, int n) {
    int64_t total = 0;
    for (int i = 0; i < n; i++) total += cnt[i];
    if (total == 0) return 0.0;
    const double lt = __builtin_log2((double)total);
    double bits = 0.0;
    for (int i = 0; i < n; i++)
        if (cnt[i]) bits += (double)cnt[i] * (lt - __builtin_log2((double)cnt[i]));
    return bits;
}

// Estimated compressed bytes of sequences [a, b) (+ trailing literals if
// b == n_seq).
static double split_cost(const SplitView* v, int64_t a, int64_t b) {
    uint32_t lit[256] = {0}, llc[36] = {0}, mlc[53] = {0}, ofc[32] = {0};
    const uint32_t vmax = (1u << 17) - 1;
    const int64_t byte_a = v->seq_start[a];
    const int64_t byte_b = b < v->n_seq ? v->seq_start[b] : v->bn;
    int64_t cursor = byte_a;
    for (int64_t i = a; i < b; i++) {
        for (int64_t k = 0; k < v->ll[i]; k++) lit[v->block[cursor + k]]++;
        cursor += v->ll[i] + v->ml[i];
        llc[kLLCodeLut[v->ll[i] < vmax ? v->ll[i] : vmax]]++;
        mlc[kMLCodeLut[v->ml[i] < vmax ? v->ml[i] : vmax]]++;
        ofc[highbit32(v->ob[i])]++;
    }
    if (b == v->n_seq)
        for (int64_t k = byte_b - v->last_lit; k < byte_b; k++) lit[v->block[k]]++;
    double bits = split_entropy(lit, 256) + split_entropy(llc, 36) +
                  split_entropy(mlc, 53) + split_entropy(ofc, 32);
    // extra bits of ll/ml/of values
    for (int64_t i = a; i < b; i++) {
        bits += kLLBits[kLLCodeLut[v->ll[i] < vmax ? v->ll[i] : vmax]];
        bits += kMLBits[kMLCodeLut[v->ml[i] < vmax ? v->ml[i] : vmax]];
        bits += highbit32(v->ob[i]);
    }
    return bits / 8.0 + 80.0 + 3.0;  // entropy headers + block header charge
}

// Subdivide until each partition's estimated compressed size is near the
// requested targetCBlockSize (ZSTD_compressSuperBlock:584 role).
static void split_derive_target(const SplitView* v, int64_t a, int64_t b,
                                double target, int64_t* bounds, int* nb,
                                int depth) {
    if (*nb >= 195 || depth >= 10 || b - a < 16 ||
        split_cost(v, a, b) <= target * 1.25) {
        bounds[(*nb)++] = b;
        return;
    }
    const int64_t mid = (a + b) / 2;
    split_derive_target(v, a, mid, target, bounds, nb, depth + 1);
    split_derive_target(v, mid, b, target, bounds, nb, depth + 1);
}

static void split_derive(const SplitView* v, int64_t a, int64_t b,
                         int64_t* bounds, int* nb, int depth) {
    if (b - a < 300 || *nb >= 195 || depth >= 8) {
        bounds[(*nb)++] = b;
        return;
    }
    const int64_t mid = (a + b) / 2;
    if (split_cost(v, a, mid) + split_cost(v, mid, b) < split_cost(v, a, b)) {
        split_derive(v, a, mid, bounds, nb, depth + 1);
        split_derive(v, mid, b, bounds, nb, depth + 1);
    } else {
        bounds[(*nb)++] = b;
    }
}

int64_t compress_frame_body_ldm_c(const uint8_t* src, int64_t n, int strategy,
                                  int hash_log, int chain_log, int search_log,
                                  int window_log, int accel, int use_ldm,
                                  int min_match, int split_mode,
                                  int target_cblock, uint8_t* out, int64_t cap) {
    if (prof_on()) { g_prof[0] = g_prof[1] = g_prof[2] = g_prof[3] = 0; }
    const int mls = min_match < 4 ? 4 : (min_match > 8 ? 8 : min_match);
    codec_init();
    const int64_t block_size = (1 << 17) < (1LL << window_log)
                                   ? (1 << 17) : (1LL << window_log);
    const int64_t tbl_n = 1LL << hash_log;
    int64_t* table = (int64_t*)malloc((size_t)tbl_n * 8);
    if (!table) return -1;
    for (int64_t i = 0; i < tbl_n; i++) table[i] = -1;
    // level-1 fast path: compact u32 table (positions stored +1), hashed
    // into 2^16 entries regardless of the level-table hashLog — real-data
    // ratio improves ~2.5% at equal speed (the level tables tuned hashLog
    // for 2008-era cache sizes).
    const int fast_hlog = strategy <= 1 && hash_log < 16 ? 16 : hash_log;
    uint32_t* table32 = nullptr;
    if (strategy <= 1 && !use_ldm && n < (1LL << 31) &&
        !(strategy == 1 && hash_log >= 15 && accel <= 1) &&
        !(getenv("ZT_FAST64"))) {
        table32 = (uint32_t*)calloc((size_t)1 << fast_hlog, 4);
        if (!table32) { free(table); return -1; }
    }
    int64_t* chain = nullptr;
    if ((strategy >= 2 && strategy < 6) || (use_ldm && strategy < 6)) {
        chain = (int64_t*)malloc((size_t)(1LL << chain_log) * 8);
        if (!chain) { free(table); return -1; }
        for (int64_t i = 0; i < (1LL << chain_log); i++) chain[i] = -1;
    }
    // row-matcher tables (levels 5-12 role; ZSTD_RowFindBestMatch)
    uint32_t* row_pos = nullptr;
    uint8_t* row_tags = nullptr;
    uint8_t* row_heads = nullptr;
    int row_log = hash_log - 4;
    if (row_log < 8) row_log = 8;
    if (row_log > 21) row_log = 21;
    // 16-entry rows cover up to ~32 attempts; deeper searches keep chains.
    // The dfast levels (strategy 2) also route here: row-greedy with 4
    // attempts beats libzstd's ratio at levels 3-4 (dfast stays the
    // fallback for small windows / LDM).
    // Level 2 (fast with hashLog 16) also routes here: its speed contract
    // is looser than level 1's, and the row's ratio wins (level 1 keeps
    // the greedy fast loop: hashLog 14 + accel identify it).
    const bool l2_shape = strategy == 1 && hash_log >= 15 && accel <= 1;
    const bool use_row = (l2_shape || (strategy >= 2 && strategy <= 5)) &&
                         window_log >= 14 && search_log <= 5 && !use_ldm &&
                         !(getenv("ZT_ROW") && atoi(getenv("ZT_ROW")) == 0);
    if (use_row) {
        const int64_t n_rows = 1LL << row_log;
        row_pos = (uint32_t*)calloc((size_t)n_rows * 16, 4);
        row_tags = (uint8_t*)calloc((size_t)n_rows * 16, 1);
        row_heads = (uint8_t*)calloc((size_t)n_rows, 1);
        if (!row_pos || !row_tags || !row_heads) {
            free(row_pos); free(row_tags); free(row_heads);
            row_pos = nullptr; row_tags = nullptr; row_heads = nullptr;
        }
    }
    // binary-tree links + hash3 heads for the optimal parser
    int32_t* bt = nullptr;
    int64_t* h3 = nullptr;
    const int h3log = 16;
    const int64_t bt_size = 1LL << chain_log;
    if (strategy >= 6) {
        bt = (int32_t*)malloc((size_t)(2 * bt_size) * 4);
        h3 = (int64_t*)malloc((size_t)(1LL << h3log) * 8);
        if (!bt || !h3) { free(table); free(chain); free(bt); free(h3); return -1; }
        std::memset(bt, 0xFF, (size_t)(2 * bt_size) * 4);
        for (int64_t i = 0; i < (1LL << h3log); i++) h3[i] = -1;
    }
    const int64_t max_seq_cap = block_size / 3 + 16;
    uint32_t* s_ll = (uint32_t*)malloc((size_t)max_seq_cap * 12);
    uint32_t* s_ml = s_ll + max_seq_cap;
    uint32_t* s_ob = s_ml + max_seq_cap;
    if (!s_ll) { free(table); free(chain); return -1; }

    uint32_t rep[3] = {1, 4, 8};
    int64_t insert_from = 0;
    int64_t size = 0;
    int64_t pos = 0;
    int rc = 0;

    OptStats* ost = nullptr;
    if (strategy >= 7) {
        ost = (OptStats*)malloc(sizeof(OptStats));
        if (!ost) { free(table); free(chain); free(s_ll); return -1; }
        opt_seed_default(ost);
    }
    static thread_local ZxEntropy zx_ents[2];
    std::memset(zx_ents, 0, sizeof zx_ents);
    int zx_prev = 0;

    // LDM state: bucket table + per-frame candidate list.
    const int ldm_hash_log = 20;
    int64_t* ldm_buckets = nullptr;
    LdmMatch* ldm = nullptr;
    int64_t n_ldm = 0, ldm_cursor = 0;
    if (use_ldm) {
        const int64_t nb = (1LL << ldm_hash_log) * 4;
        ldm_buckets = (int64_t*)malloc((size_t)nb * 8);
        ldm = (LdmMatch*)malloc(sizeof(LdmMatch) * (size_t)(n / 512 + 64));
        if (!ldm_buckets || !ldm) { free(table); free(chain); free(s_ll);
                                    free(ldm_buckets); free(ldm); return -1; }
        for (int64_t i = 0; i < nb; i++) ldm_buckets[i] = -1;
        n_ldm = ldm_scan(src, 0, n, 0, ldm_buckets, ldm_hash_log, 7, 64,
                         ldm, n / 512 + 64);
    }

    // Gap parser for the LDM merge: same strategy family as the block
    // parser so long-window mode keeps optimal/btlazy parse quality
    // (ZSTD_ldm_blockCompress:761 hands gaps to the selected compressor).
    auto parse_gap = [&](int64_t from, int64_t to, uint32_t* gll,
                         uint32_t* gml, uint32_t* gob, int64_t budget,
                         int64_t* gl) -> int64_t {
        if (strategy >= 7)
            return opt_find_matches(src, n, from, to, 0, 1LL << window_log,
                                    table, hash_log, bt, bt_size,
                                    1LL << search_log, h3, h3log, min_match,
                                    &insert_from, rep, ost, gll, gml, gob,
                                    budget, gl);
        if (strategy == 6)
            return btlazy_find_matches(src, n, from, to, 0, 1LL << window_log,
                                       table, hash_log, bt, bt_size,
                                       1LL << search_log, 2, &insert_from,
                                       rep, gll, gml, gob, budget, gl);
        return lazy_find_matches(src, n, from, to, 0, 1LL << window_log,
                                 table, hash_log, chain, 1LL << chain_log,
                                 1LL << search_log, strategy >= 5 ? 2 : 1,
                                 &insert_from, rep, gll, gml, gob, budget, gl,
                                 min_match);
    };

    if (n == 0) {
        if (cap < 3) rc = -1;
        else { out[0] = 1; out[1] = 0; out[2] = 0; size = 3; }
    }
    static thread_local ZxEntropy zx_snap;
    uint32_t rep_snap[3];
    while (pos < n && rc == 0) {
        // Content-adaptive block boundary (zstd_preSplit role), gated on
        // the running savings (consumed minus produced = pos - size here,
        // since this function emits the frame body only).
        const int64_t end =
            pos + zx_presplit(src + pos, n - pos, block_size, strategy,
                              pos - size);
        const int last = end == n;
        const int64_t bn = end - pos;
        if (size + 3 + bn + 32 > cap) { rc = -1; break; }
        // Snapshot decoder-visible state: a raw-block fallback must not
        // advance repcodes or repeat-mode entropy tables, or every later
        // block's rep/repeat references desync from the decoder
        // (ZSTD_confirmRepcodesAndEntropyTables role).
        rep_snap[0] = rep[0]; rep_snap[1] = rep[1]; rep_snap[2] = rep[2];
        zx_snap = zx_ents[zx_prev];
        // RLE block?
        bool all_same = bn > 1;
        for (int64_t i = pos + 1; i < end && all_same; i++)
            if (src[i] != src[pos]) all_same = false;
        if (all_same) {
            const uint32_t bh = (uint32_t)(last | (1 << 1) | (bn << 3));
            out[size] = (uint8_t)bh; out[size + 1] = (uint8_t)(bh >> 8);
            out[size + 2] = (uint8_t)(bh >> 16);
            out[size + 3] = src[pos];
            size += 4;
            insert_from = end;
            pos = end;
            continue;
        }
        int64_t last_lit;
        int64_t n_seq;
        if (use_ldm) {
            // Merge: [gap parse][ldm seq] ... within this block; long LDM
            // matches are split at block boundaries (a sequence cannot
            // produce past its block's regenerated size).
            n_seq = 0;
            int64_t cursor = pos;
            while (ldm_cursor < n_ldm && n_seq + 4 < max_seq_cap) {
                LdmMatch m = ldm[ldm_cursor];
                if (m.pos + m.len <= cursor || m.dist >= (1LL << window_log)) {
                    ldm_cursor++;
                    continue;
                }
                if (m.pos < cursor) {  // trim the already-consumed front
                    const int64_t trim = cursor - m.pos;
                    m.pos += trim;
                    m.len -= trim;
                }
                if (m.pos >= end) break;
                const int64_t take = m.len < end - m.pos ? m.len : end - m.pos;
                if (take < 4) break;  // tail continues in the next block
                // parse the gap [cursor, m.pos)
                int64_t gl = 0;
                if (m.pos > cursor) {
                    int64_t k = parse_gap(cursor, m.pos, s_ll + n_seq,
                                          s_ml + n_seq, s_ob + n_seq,
                                          max_seq_cap - n_seq - 2, &gl);
                    if (k < 0) { n_seq = -1; break; }
                    n_seq += k;
                }
                s_ll[n_seq] = (uint32_t)gl;
                s_ml[n_seq] = (uint32_t)take;
                s_ob[n_seq] = (uint32_t)(m.dist + 3);
                rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = (uint32_t)m.dist;
                n_seq++;
                cursor = m.pos + take;
                insert_from = insert_from > cursor ? insert_from : cursor;
                if (take < m.len) {  // remainder goes to the next block
                    ldm[ldm_cursor].pos = m.pos + take;
                    ldm[ldm_cursor].len = m.len - take;
                    break;
                }
                ldm_cursor++;
            }
            if (n_seq >= 0) {
                int64_t gl = end - cursor;
                if (cursor < end - 16) {
                    int64_t k = parse_gap(cursor, end, s_ll + n_seq,
                                          s_ml + n_seq, s_ob + n_seq,
                                          max_seq_cap - n_seq, &gl);
                    if (k < 0) n_seq = -1;
                    else n_seq += k;
                }
                last_lit = gl;
            }
            if (n_seq > 0 && ost)
                opt_update_stats(ost, s_ll, s_ml, s_ob, n_seq, true);
                } else if (strategy == 2 && chain && !row_pos) {
            n_seq = dfast_find_matches(src, n, pos, end, 0, 1LL << window_log,
                                       table, hash_log, chain, chain_log, mls,
                                       rep, s_ll, s_ml, s_ob, max_seq_cap,
                                       &last_lit);
        } else if (strategy <= 1 && table32 && !row_pos) {
            n_seq = fast_find_matches32(src, n, pos, end, 0, 1LL << window_log,
                                        table32, fast_hlog, mls, rep, s_ll,
                                        s_ml, s_ob, max_seq_cap, &last_lit,
                                        accel);
        } else if (strategy <= 2 && !row_pos) {
            n_seq = fast_find_matches(src, n, pos, end, 0, 1LL << window_log,
                                      table, hash_log, mls, rep, s_ll, s_ml,
                                      s_ob, max_seq_cap, &last_lit, accel);
        } else if (strategy >= 7) {
            const uint32_t rep_in[3] = {rep[0], rep[1], rep[2]};
            n_seq = opt_find_matches(src, n, pos, end, 0, 1LL << window_log,
                                     table, hash_log, bt, bt_size,
                                     1LL << search_log, h3, h3log, min_match,
                                     &insert_from, rep, ost,
                                     s_ll, s_ml, s_ob, max_seq_cap, &last_lit);
            if (n_seq > 0 && !ost->inited) {
                // btultra2 seeding (ZSTD_initStats_ultra role): fold the
                // first parse's choices into the prices and re-parse.
                opt_update_stats(ost, s_ll, s_ml, s_ob, n_seq, false);
                rep[0] = rep_in[0]; rep[1] = rep_in[1]; rep[2] = rep_in[2];
                // Rewind matcher state so the re-parse replays the same
                // inserts (tree roots otherwise point past the parse
                // position).
                for (int64_t t = 0; t < tbl_n; t++) table[t] = -1;
                std::memset(bt, 0xFF, (size_t)(2 * bt_size) * 4);
                for (int64_t t = 0; t < (1LL << h3log); t++) h3[t] = -1;
                insert_from = pos;
                n_seq = opt_find_matches(src, n, pos, end, 0,
                                         1LL << window_log, table, hash_log,
                                         bt, bt_size, 1LL << search_log,
                                         h3, h3log, min_match,
                                         &insert_from, rep,
                                         ost, s_ll, s_ml, s_ob, max_seq_cap,
                                         &last_lit);
            }
            if (n_seq >= 0)
                opt_update_stats(ost, s_ll, s_ml, s_ob, n_seq, true);
        } else if (strategy == 6) {
            // double the attempt budget: the DUBT candidate cut costs the
            // lazy parse more than zstd's eager tree, and 2x still beats
            // the reference's btlazy2 on both ratio and speed here
            n_seq = btlazy_find_matches(src, n, pos, end, 0, 1LL << window_log,
                                        table, hash_log, bt, bt_size,
                                        2LL << search_log, 2, &insert_from,
                                        rep, s_ll, s_ml, s_ob, max_seq_cap,
                                        &last_lit);
        } else if (row_pos) {
            const int depth = strategy >= 5 ? 2 : strategy >= 3 ? strategy - 3 : 0;
            const int64_t att = strategy <= 2 ? 4 : 1LL << search_log;
            n_seq = row_lazy_find_matches(src, n, pos, end, 0,
                                          1LL << window_log, row_pos,
                                          row_tags, row_heads, row_log,
                                          min_match, att, depth,
                                          &insert_from, rep, s_ll, s_ml, s_ob,
                                          max_seq_cap, &last_lit);
        } else {
            const int depth = strategy >= 5 ? 2 : strategy - 3;
            n_seq = lazy_find_matches(src, n, pos, end, 0, 1LL << window_log,
                                      table, hash_log, chain, 1LL << chain_log,
                                      1LL << search_log, depth, &insert_from,
                                      rep, s_ll, s_ml, s_ob, max_seq_cap,
                                      &last_lit, min_match);
        }
        if (n_seq < 0) { rc = -1; break; }
        // targetCBlockSize: true superblock emission — sub-blocks sharing
        // one entropy table set (ZSTD_compressSuperBlock role).
        if (target_cblock > 0) {
            ZxEntropy* const sb_prev = &zx_ents[zx_prev];
            ZxEntropy* const sb_next = &zx_ents[zx_prev ^ 1];
            std::memcpy(sb_next->repcodes, rep, 12);  // post-parse reps
            const int64_t em = zx_superblock_from_arrays(
                src + pos, bn, s_ll, s_ml, s_ob, n_seq, last_lit, sb_prev,
                sb_next, strategy, target_cblock, last, rep_snap,
                out + size, cap - size);
            if (em < 0) { rc = -1; break; }
            if (em > 0 && em < bn - zx_min_gain(bn, strategy) + 3) {
                rep[0] = sb_next->repcodes[0];
                rep[1] = sb_next->repcodes[1];
                rep[2] = sb_next->repcodes[2];
                zx_prev ^= 1;  // confirm entropy tables
                size += em;
                pos = end;
                continue;
            }
            // superblock not formed: raw block (reference fallback)
            rep[0] = rep_snap[0]; rep[1] = rep_snap[1]; rep[2] = rep_snap[2];
            zx_ents[zx_prev] = zx_snap;
            if (size + 3 + bn > cap) { rc = -1; break; }
            const uint32_t bh = (uint32_t)(last | (0 << 1) | (bn << 3));
            out[size] = (uint8_t)bh;
            out[size + 1] = (uint8_t)(bh >> 8);
            out[size + 2] = (uint8_t)(bh >> 16);
            std::memcpy(out + size + 3, src + pos, (size_t)bn);
            size += 3 + bn;
            pos = end;
            continue;
        }
        // Optional block split (btopt+): partitions with homogeneous
        // statistics compress better than one mixed block.
        int64_t bounds[200];
        int nb = 1;
        bounds[0] = n_seq;
        if (split_mode && n_seq >= 600) {
            int64_t* seq_start = (int64_t*)malloc((size_t)(n_seq + 1) * 8);
            if (seq_start) {
                int64_t cur = 0;
                for (int64_t i2 = 0; i2 < n_seq; i2++) {
                    seq_start[i2] = cur;
                    cur += s_ll[i2] + s_ml[i2];
                }
                seq_start[n_seq] = cur;
                SplitView v{src + pos, s_ll, s_ml, s_ob, n_seq, last_lit, bn,
                            seq_start};
                nb = 0;
                if (target_cblock > 0)
                    split_derive_target(&v, 0, n_seq, (double)target_cblock,
                                        bounds, &nb, 0);
                else
                    split_derive(&v, 0, n_seq, bounds, &nb, 0);
                // emit partitions
                int64_t a = 0;
                bool fail = false;
                int64_t size0 = size;
                for (int k = 0; k < nb && !fail; k++) {
                    const int64_t b2 = bounds[k];
                    const int64_t pa = seq_start[a];
                    const int64_t pb = k == nb - 1 ? bn : seq_start[b2];
                    const int64_t pbn = pb - pa;
                    const int64_t plast = k == nb - 1 ? last_lit : 0;
                    const int plast_flag = last && k == nb - 1;
                    if (size + 3 + pbn + 32 > cap) { fail = true; break; }
                    int64_t pbody = zx_block_from_arrays(
                        src + pos + pa, pbn, s_ll + a, s_ml + a, s_ob + a,
                        b2 - a, plast, &zx_ents[zx_prev],
                        &zx_ents[zx_prev ^ 1], strategy, out + size + 3,
                        cap - size - 3 - 8);
                    if (pbody >= 0) zx_prev ^= 1;
                    if (pbody < 0) {
                        // a raw partition would desync later partitions'
                        // repcodes; abandon the split entirely
                        fail = true;
                        break;
                    }
                    const uint32_t bh = (uint32_t)(plast_flag | (2 << 1) | (pbody << 3));
                    out[size] = (uint8_t)bh; out[size + 1] = (uint8_t)(bh >> 8);
                    out[size + 2] = (uint8_t)(bh >> 16);
                    size += 3 + pbody;
                    a = b2;
                }
                free(seq_start);
                if (!fail) { pos = end; continue; }
                size = size0;  // fall through to single-block emission
                zx_ents[zx_prev] = zx_snap;
            }
        }
        int64_t body = zx_block_from_arrays(src + pos, bn, s_ll, s_ml, s_ob,
                                            n_seq, last_lit,
                                            &zx_ents[zx_prev],
                                            &zx_ents[zx_prev ^ 1], strategy,
                                            out + size + 3,
                                            cap - size - 3 - 8);
        if (body >= 0) zx_prev ^= 1;
        if (body < 0) {
            rep[0] = rep_snap[0]; rep[1] = rep_snap[1]; rep[2] = rep_snap[2];
            zx_ents[zx_prev] = zx_snap;
            const uint32_t bh = (uint32_t)(last | (0 << 1) | (bn << 3));
            out[size] = (uint8_t)bh; out[size + 1] = (uint8_t)(bh >> 8);
            out[size + 2] = (uint8_t)(bh >> 16);
            std::memcpy(out + size + 3, src + pos, (size_t)bn);
            size += 3 + bn;
        } else {
            const uint32_t bh = (uint32_t)(last | (2 << 1) | (body << 3));
            out[size] = (uint8_t)bh; out[size + 1] = (uint8_t)(bh >> 8);
            out[size + 2] = (uint8_t)(bh >> 16);
            size += 3 + body;
        }
        pos = end;
    }
    if (prof_on())
        fprintf(stderr, "ZT_PROF encode ns: gather=%lld literals=%lld "
                "codes+tables=%lld fse=%lld\n", (long long)g_prof[0],
                (long long)g_prof[1], (long long)g_prof[2],
                (long long)g_prof[3]);
    free(table);
    free(table32);
    free(chain);
    free(bt);
    free(h3);
    free(row_pos);
    free(row_tags);
    free(row_heads);
    free(s_ll);
    free(ldm_buckets);
    free(ldm);
    free(ost);
    return rc == 0 ? size : -1;
}

// ----------------------------- block decode -------------------------------

struct EntropyStateC {
    HufDTableC huf;
    FseDTableC ll, of, ml;
    bool ll_valid, of_valid, ml_valid;
    // Which table the channel currently uses: 0 = the own struct above,
    // 1 = the static predefined table (mode 0 blocks no longer copy the
    // 16KB default struct; repeat mode resolves through this flag).
    uint8_t ll_src, of_src, ml_src;
    uint32_t rep[3];
};

// Hot inner loop of the 4-stream X1 decode: PER symbols per stream per
// iteration (fully unrolled), one container reload per stream per
// iteration.  Updates positions/outputs in place, returns symbols written
// per stream.  Bit validity is re-checked per iteration (p >= 56); output
// space by the rmin countdown.
}  // pause extern "C" for the template
template <int PER>
__attribute__((optimize("O3")))
static inline int64_t huf_4x_fast_loop(
    const uint16_t* D, int tlog, int64_t rmin,
    int64_t& p0, int64_t& p1, int64_t& p2, int64_t& p3,
    const uint8_t* b0, const uint8_t* b1, const uint8_t* b2,
    const uint8_t* b3, uint8_t*& q0, uint8_t*& q1, uint8_t*& q2,
    uint8_t*& q3) {
    int64_t done = 0;
    const int shift = 64 - tlog;
    while (p0 >= 56 && p1 >= 56 && p2 >= 56 && p3 >= 56 && rmin >= PER) {
        const int64_t a0 = p0 - 56 + 128, a1 = p1 - 56 + 128;
        const int64_t a2 = p2 - 56 + 128, a3 = p3 - 56 + 128;
        uint64_t V0 = ((read_window(b0 + (a0 >> 3)) >> (a0 & 7)) << 8) | 0x80;
        uint64_t V1 = ((read_window(b1 + (a1 >> 3)) >> (a1 & 7)) << 8) | 0x80;
        uint64_t V2 = ((read_window(b2 + (a2 >> 3)) >> (a2 & 7)) << 8) | 0x80;
        uint64_t V3 = ((read_window(b3 + (a3 >> 3)) >> (a3 & 7)) << 8) | 0x80;
        for (int j = 0; j < PER; j++) {
            const uint16_t e0 = D[V0 >> shift];
            const uint16_t e1 = D[V1 >> shift];
            const uint16_t e2 = D[V2 >> shift];
            const uint16_t e3 = D[V3 >> shift];
            q0[j] = (uint8_t)(e0 >> 8); V0 <<= (e0 & 0xFF);
            q1[j] = (uint8_t)(e1 >> 8); V1 <<= (e1 & 0xFF);
            q2[j] = (uint8_t)(e2 >> 8); V2 <<= (e2 & 0xFF);
            q3[j] = (uint8_t)(e3 >> 8); V3 <<= (e3 & 0xFF);
        }
        q0 += PER; q1 += PER; q2 += PER; q3 += PER;
        p0 -= __builtin_ctzll(V0) - 7; p1 -= __builtin_ctzll(V1) - 7;
        p2 -= __builtin_ctzll(V2) - 7; p3 -= __builtin_ctzll(V3) - 7;
        rmin -= PER;
        done += PER;
    }
    return done;
}

#if defined(__x86_64__) && defined(__BMI2__) && \
    !defined(__SANITIZE_ADDRESS__) && !defined(__SANITIZE_THREAD__)
#define ZT_HUF_ASM 1
// Hand-scheduled x86-64 core for the same loop (tlog <= 11 so 5 symbols
// per stream fit in the 56 payload bits).  The compiler build of
// huf_4x_fast_loop spills the 4-stream state to the stack; this form keeps
// all of it in registers:
//   - per-stream state is ONE absolute bit cursor A = ptr*8 + bitpos
//     (byte address = A>>3, intra-byte shift = A&7), not {base, pos} pairs
//   - the refill marker rides at bit 0, so tzcnt(V) IS the bits consumed
//   - table entries are sym<<8 | nb: `movb %%ah` stores the symbol and
//     shlx reads nb from the same register (low 6 bits), 4 uops/symbol
//   - output pointers live in rbx/rcx/rdx/rsi because the %%ah store
//     encoding forbids REX registers
// Runs exactly (qend - q0)/5 iterations; the caller guarantees every
// stream has >= 5*tlog bits and 5 output slots per iteration.
#define ZT_HRLD(Vn, An)                          \
    "mov %[" An "], %%rax\n\t"                   \
    "shr $3, %%rax\n\t"                          \
    "mov (%%rax), %[" Vn "]\n\t"                 \
    "mov %[" An "], %%rax\n\t"                   \
    "and $7, %%eax\n\t"                          \
    "shrx %%rax, %[" Vn "], %[" Vn "]\n\t"       \
    "shl $8, %[" Vn "]\n\t"                      \
    "or $1, %[" Vn "]\n\t"
#define ZT_HSYM(Vn, Qn, J)                       \
    "shrx %[sh], %[" Vn "], %%rax\n\t"           \
    "movzwl (%[D], %%rax, 2), %%eax\n\t"         \
    "shlx %%rax, %[" Vn "], %[" Vn "]\n\t"       \
    "movb %%ah, " J "(%[" Qn "])\n\t"
#define ZT_HROW(J)                               \
    ZT_HSYM("v0", "q0", J) ZT_HSYM("v1", "q1", J) \
    ZT_HSYM("v2", "q2", J) ZT_HSYM("v3", "q3", J)
#define ZT_HACC(Vn, An)                          \
    "tzcnt %[" Vn "], %%rax\n\t"                 \
    "sub %%rax, %[" An "]\n\t"

// omit-frame-pointer pinned: the loop needs all 15 GPRs (a sanitizer or
// -O0 build keeps rbp and cannot allocate the operands; those builds take
// the C loop via the ZT_HUF_ASM gate instead)
__attribute__((noinline, optimize("O2", "omit-frame-pointer")))
static void huf_4x_asm_block(const uint16_t* D, uint64_t sh,
                             uint64_t& A0, uint64_t& A1, uint64_t& A2,
                             uint64_t& A3, uint8_t*& q0, uint8_t*& q1,
                             uint8_t*& q2, uint8_t*& q3,
                             const uint8_t* qend) {
    uint64_t v0, v1, v2, v3;
    asm volatile(
        ".p2align 4\n"
        "1:\n\t"
        ZT_HRLD("v0", "a0") ZT_HRLD("v1", "a1")
        ZT_HRLD("v2", "a2") ZT_HRLD("v3", "a3")
        ZT_HROW("0") ZT_HROW("1") ZT_HROW("2") ZT_HROW("3") ZT_HROW("4")
        ZT_HACC("v0", "a0") ZT_HACC("v1", "a1")
        ZT_HACC("v2", "a2") ZT_HACC("v3", "a3")
        "add $5, %[q0]\n\t"
        "add $5, %[q1]\n\t"
        "add $5, %[q2]\n\t"
        "add $5, %[q3]\n\t"
        "cmp %[qend], %[q0]\n\t"
        "jb 1b\n\t"
        : [a0] "+r"(A0), [a1] "+r"(A1), [a2] "+r"(A2), [a3] "+r"(A3),
          [q0] "+b"(q0), [q1] "+c"(q1), [q2] "+d"(q2), [q3] "+S"(q3),
          [v0] "=&r"(v0), [v1] "=&r"(v1), [v2] "=&r"(v2), [v3] "=&r"(v3)
        : [D] "r"(D), [sh] "r"(sh), [qend] "m"(qend)
        : "rax", "cc", "memory");
}
#undef ZT_HRLD
#undef ZT_HSYM
#undef ZT_HROW
#undef ZT_HACC
#endif  // ZT_HUF_ASM

extern "C" {

// Decode literals section.  Writes into lit (cap >= 1<<17 + 32).
// Returns bytes consumed, sets *lit_size; -1 on error.
// 4-stream interleaved Huffman decode (HUF_decompress4X1 role).  One padded
// buffer holds the whole payload; each stream's reader may touch up to 16
// bytes before its own start (the previous stream's bytes / the zero prefix)
// — those bits are don't-care by canonical-table construction, so only
// memory validity matters.  Streams advance in lockstep for ILP.
__attribute__((optimize("O3")))
static int huf_decode_4x(const uint8_t* pad, const int64_t* offs,
                         const int64_t* sizes, const uint16_t* D, int tlog,
                         uint8_t* out, const int64_t* osz) {
    int64_t pos[4], rem[4];
    const uint8_t* sb[4];
    uint8_t* op[4];
    int64_t ooff = 0;
    for (int k = 0; k < 4; k++) {
        pos[k] = br_init(pad + 16 + offs[k], sizes[k]);
        if (pos[k] < 0) return -1;
        sb[k] = pad + offs[k];
        op[k] = out + ooff;
        rem[k] = osz[k];
        ooff += osz[k];
    }
    const uint64_t mask = (1ULL << tlog) - 1;
    {
        // register-resident stream state (the array form spills)
        int64_t p0 = pos[0], p1 = pos[1], p2 = pos[2], p3 = pos[3];
        int64_t rmin = rem[0];
        if (rem[1] < rmin) rmin = rem[1];
        if (rem[2] < rmin) rmin = rem[2];
        if (rem[3] < rmin) rmin = rem[3];
        uint8_t *q0 = op[0], *q1 = op[1], *q2 = op[2], *q3 = op[3];
        const uint8_t *b0 = sb[0], *b1 = sb[1], *b2 = sb[2], *b3 = sb[3];
        // MSB-aligned containers: the next code sits in the top tlog bits,
        // so each symbol is one constant shift + load + one variable shift.
        // A marker bit at position 7 (below the 56 payload bits) rides the
        // shifts; the bits consumed this round are tzcnt(V) - 7, killing
        // the per-symbol consumed-bits adds (the libzstd asm loop's trick,
        // HufDecompress.cs:342 role).  Streams decode in lockstep; the
        // symbol loop is compile-time unrolled per tableLog class.
        int64_t done = 0;
#ifdef ZT_HUF_ASM
        if (tlog <= 11) {
            // Batched register-resident core: run it for the largest
            // iteration count provably safe from the worst-case bit
            // consumption (5*tlog bits/stream/iter), then re-derive.
            const uint64_t sh64 = (uint64_t)(64 - tlog);
            const uint64_t bias0 = ((uint64_t)(uintptr_t)b0 << 3) + 72;
            const uint64_t bias1 = ((uint64_t)(uintptr_t)b1 << 3) + 72;
            const uint64_t bias2 = ((uint64_t)(uintptr_t)b2 << 3) + 72;
            const uint64_t bias3 = ((uint64_t)(uintptr_t)b3 << 3) + 72;
            uint64_t A0 = bias0 + (uint64_t)p0, A1 = bias1 + (uint64_t)p1;
            uint64_t A2 = bias2 + (uint64_t)p2, A3 = bias3 + (uint64_t)p3;
            for (;;) {
                int64_t pm = p0 < p1 ? p0 : p1;
                if (p2 < pm) pm = p2;
                if (p3 < pm) pm = p3;
                if (pm < 56) break;
                int64_t it = (pm - 56) / (5 * tlog) + 1;
                const int64_t it_out = rmin / 5;
                if (it > it_out) it = it_out;
                if (it <= 0) break;
                huf_4x_asm_block(D, sh64, A0, A1, A2, A3, q0, q1, q2, q3,
                                 q0 + it * 5);
                rmin -= it * 5;
                done += it * 5;
                p0 = (int64_t)(A0 - bias0); p1 = (int64_t)(A1 - bias1);
                p2 = (int64_t)(A2 - bias2); p3 = (int64_t)(A3 - bias3);
            }
        }
#endif
        done +=
            tlog <= 11
                ? huf_4x_fast_loop<5>(D, tlog, rmin, p0, p1, p2, p3,
                                      b0, b1, b2, b3, q0, q1, q2, q3)
                : huf_4x_fast_loop<4>(D, tlog, rmin, p0, p1, p2, p3,
                                      b0, b1, b2, b3, q0, q1, q2, q3);
        pos[0] = p0; pos[1] = p1; pos[2] = p2; pos[3] = p3;
        rem[0] -= done; rem[1] -= done; rem[2] -= done; rem[3] -= done;
        op[0] = q0; op[1] = q1; op[2] = q2; op[3] = q3;
    }
    for (int k = 0; k < 4; k++) {
        while (rem[k] > 0) {
            if (pos[k] <= 0) return -1;  // over-consumed: corrupt
            const int64_t p = pos[k] - tlog + 16 * 8;
            const uint64_t idx = (read_window(sb[k] + (p >> 3)) >> (p & 7)) & mask;
            const uint16_t e = D[idx];
            *op[k]++ = (uint8_t)(e >> 8);
            pos[k] -= (int)(e & 0xFF);
            rem[k]--;
        }
        if (pos[k] != 0) return -1;
    }
    return 0;
}

static int64_t decode_literals_c(const uint8_t* src, int64_t size,
                                 EntropyStateC* ent, uint8_t* lit,
                                 int64_t* lit_size) {
    if (size < 1) return -1;
    const int b0 = src[0];
    const int lit_type = b0 & 3;
    const int sf = (b0 >> 2) & 3;
    if (lit_type <= 1) {  // raw / rle
        int64_t n, h;
        if (sf == 0 || sf == 2) { n = b0 >> 3; h = 1; }
        else if (sf == 1) {
            if (size < 2) return -1;
            n = (b0 >> 4) + ((int64_t)src[1] << 4); h = 2;
        } else {
            if (size < 3) return -1;
            n = (b0 >> 4) + ((int64_t)src[1] << 4) + ((int64_t)src[2] << 12); h = 3;
        }
        if (n > (1 << 17)) return -1;
        *lit_size = n;
        if (lit_type == 0) {
            if (size < h + n) return -1;
            std::memcpy(lit, src + h, (size_t)n);
            return h + n;
        }
        if (size < h + 1) return -1;
        std::memset(lit, src[h], (size_t)n);
        return h + 1;
    }
    // compressed / repeat
    int64_t regen, comp, h;
    int streams;
    if (size < 5) return -1;
    if (sf == 0 || sf == 1) {
        uint32_t v = (uint32_t)src[0] | ((uint32_t)src[1] << 8) | ((uint32_t)src[2] << 16);
        regen = (v >> 4) & 0x3FF;
        comp = (v >> 14) & 0x3FF;
        h = 3;
        streams = sf == 0 ? 1 : 4;
    } else if (sf == 2) {
        uint32_t v;
        std::memcpy(&v, src, 4);
        regen = (v >> 4) & 0x3FFF;
        comp = (v >> 18) & 0x3FFF;
        h = 4;
        streams = 4;
    } else {
        uint64_t v = 0;
        std::memcpy(&v, src, 5);
        regen = (v >> 4) & 0x3FFFF;
        comp = (v >> 22) & 0x3FFFF;
        h = 5;
        streams = 4;
    }
    if (size < h + comp || regen > (1 << 17)) return -1;
    const uint8_t* payload = src + h;
    int64_t psize = comp;
    if (lit_type == 2) {
        int64_t whdr = huf_read_and_build_dtable(payload, psize, &ent->huf);
        if (whdr < 0) return -1;
        payload += whdr;
        psize -= whdr;
    } else if (!ent->huf.valid) {
        return -1;
    }
    *lit_size = regen;
    // Backward readers may touch up to 16 bytes before a stream's start;
    // the frame loop guarantees those bytes are readable (frame-level
    // padded copy), and canonical-table don't-care bits make their values
    // irrelevant for valid streams — so streams decode in place.
    int rc = 0;
    if (streams == 1) {
        rc = (int)huf_decode_stream(payload - 16, psize, ent->huf.sym,
                                    ent->huf.nb, ent->huf.tlog, lit, regen);
    } else {
        if (psize < 6 + 3) return -1;
        const int64_t l1 = payload[0] | (payload[1] << 8);
        const int64_t l2 = payload[2] | (payload[3] << 8);
        const int64_t l3 = payload[4] | (payload[5] << 8);
        const int64_t l4 = psize - 6 - l1 - l2 - l3;
        if (l4 <= 0) return -1;
        const int64_t seg = (regen + 3) / 4;
        const int64_t osz[4] = {seg, seg, seg, regen - 3 * seg};
        const int64_t isz[4] = {l1, l2, l3, l4};
        if (osz[3] < 0) return -1;
        const uint8_t* pad = payload + 6 - 16;
        const int64_t offs[4] = {0, l1, l1 + l2, l1 + l2 + l3};
        // Decoder selection (HUF_selectDecoder role): double-symbol X2 wins
        // when two typical codes fit in one tableLog window:
        // 2 * avgBits = 2 * 8*comp/regen <= tlog.
        const int x2_env = getenv("ZT_HUF_X2") ? atoi(getenv("ZT_HUF_X2")) : -1;
        // X2 only pays when pairs fit MOST lookups (avg code <= tlog/3):
        // its table is 2-4x the X1 footprint and each lookup costs more
        // uops, so near the 2-in-tlog boundary X1 measures ~2x faster.
        const bool use_x2 = x2_env >= 0 ? x2_env != 0
            : (regen >= 1024 && comp * 24 <= regen * (int64_t)ent->huf.tlog);
        if (use_x2) {
            if (!ent->huf.x2_valid) huf_build_x2(&ent->huf);
            rc = huf_decode_4x2(pad, offs, isz, ent->huf.fused2,
                                ent->huf.tlog, lit, osz);
        } else {
            rc = huf_decode_4x(pad, offs, isz, ent->huf.fused, ent->huf.tlog,
                               lit, osz);
        }
    }
    if (rc != 0) return -1;
    return h + comp;
}

// Builds one channel's decode table per its mode.  Returns consumed or -1.
// `*use` receives the table to decode with: the static predefined table
// for mode 0 (no 16KB copy), the channel's own struct otherwise;
// `*src_flag` records which so repeat mode can resolve it next block.
static int64_t build_seq_table_c(int mode, const uint8_t* src, int64_t size,
                                 FseDTableC* dt, bool* valid,
                                 uint8_t* src_flag, const FseDTableC** use,
                                 const FseDTableC* def, const uint32_t* base,
                                 const uint8_t* bits, int max_sym, int max_log) {
    codec_init();
    if (mode == 0) {
        *valid = true;
        *src_flag = 1;
        *use = def;
        return 0;
    }
    if (mode == 1) {
        if (size < 1 || src[0] > max_sym) return -1;
        fse_rle_dtable_c(dt, src[0], base, bits);
        *valid = true;
        *src_flag = 0;
        *use = dt;
        return 1;
    }
    if (mode == 2) {
        int16_t norm[64];
        int ms, tl;
        int64_t h = fse_read_ncount(norm, &ms, &tl, src, size, max_sym, max_log);
        if (h < 0) return -1;
        fse_build_dtable_c(dt, norm, ms, tl, base, bits);
        *valid = true;
        *src_flag = 0;
        *use = dt;
        return 0 + h;
    }
    // repeat
    if (!*valid) return -1;
    *use = *src_flag ? def : dt;
    return 0;
}

// Decode one compressed block into out at out_pos.  Returns new out_pos, -1.
// dirty (nullable): bit0 huf, bit1 ll, bit2 of, bit3 ml set when the block
// overwrites that table (dictionary scratch restoration).
static int64_t decode_block_c(const uint8_t* src, int64_t size,
                              EntropyStateC* ent, uint8_t* out,
                              int64_t out_pos, int64_t out_cap,
                              int64_t prefix_start, uint8_t* lit_buf,
                              uint32_t* seq_buf, int64_t max_seq,
                              int* dirty = nullptr) {
    int64_t lit_size;
    const bool prof = prof_on();
    int64_t t0 = prof ? prof_now() : 0;
    if (dirty && size >= 1 && (src[0] & 3) == 2) *dirty |= 1;  // fresh huf
    int64_t consumed = decode_literals_c(src, size, ent, lit_buf, &lit_size);
    if (prof) { int64_t t = prof_now(); g_prof[0] += t - t0; t0 = t; }
    if (consumed < 0) return -1;
    src += consumed;
    size -= consumed;
    // nbSeq
    if (size < 1) return -1;
    int64_t nb_seq;
    if (src[0] < 128) { nb_seq = src[0]; src += 1; size -= 1; }
    else if (src[0] < 255) {
        if (size < 2) return -1;
        nb_seq = ((int64_t)(src[0] - 128) << 8) + src[1];
        src += 2; size -= 2;
    } else {
        if (size < 3) return -1;
        nb_seq = src[1] + ((int64_t)src[2] << 8) + 0x7F00;
        src += 3; size -= 3;
    }
    if (nb_seq == 0) {
        if (out_pos + lit_size > out_cap) return -1;
        std::memcpy(out + out_pos, lit_buf, (size_t)lit_size);
        return out_pos + lit_size;
    }
    if (nb_seq > max_seq) return -1;
    if (size < 1) return -1;
    const int mode_byte = src[0];
    if (mode_byte & 3) return -1;
    if (dirty) {
        if ((mode_byte >> 6) != 3) *dirty |= 2;          // ll overwritten
        if (((mode_byte >> 4) & 3) != 3) *dirty |= 4;    // of
        if (((mode_byte >> 2) & 3) != 3) *dirty |= 8;    // ml
    }
    src += 1; size -= 1;
    int64_t h;
    const FseDTableC *llu, *ofu, *mlu;
    h = build_seq_table_c(mode_byte >> 6, src, size, &ent->ll, &ent->ll_valid,
                          &ent->ll_src, &llu,
                          &kLLDefaultDT, kLLBase, kLLBits, kMaxLL, kLLFseLog);
    if (h < 0) return -1;
    src += h; size -= h;
    h = build_seq_table_c((mode_byte >> 4) & 3, src, size, &ent->of, &ent->of_valid,
                          &ent->of_src, &ofu,
                          &kOFDefaultDT, kOFBase, kOFBits, kMaxOFF, kOFFseLog);
    if (h < 0) return -1;
    src += h; size -= h;
    h = build_seq_table_c((mode_byte >> 2) & 3, src, size, &ent->ml, &ent->ml_valid,
                          &ent->ml_src, &mlu,
                          &kMLDefaultDT, kMLBase, kMLBits, kMaxML, kMLFseLog);
    if (h < 0) return -1;
    src += h; size -= h;
    if (prof) { int64_t t = prof_now(); g_prof[1] += t - t0; t0 = t; }

    // Long-offset pipeline selection (ZSTD_getLongOffsetsShare role,
    // ZstdDecompressBlock.cs:3062): with >16MB of history and >=7% of OF
    // table states carrying >22 extra bits, matches likely miss cache and
    // the prefetch decoder wins.
    int long_mode = 0;
    static const int lm_force = [] {
        const char* e = getenv("ZT_LONGMODE");
        return e ? atoi(e) : -1;
    }();
    if (lm_force >= 0) long_mode = lm_force;
    else if (out_pos > (1 << 24) && nb_seq > 8) {
        const int64_t tsize = 1LL << ofu->tlog;
        int64_t longs = 0;
        for (int64_t t = 0; t < tsize; t++)
            if (((ofu->fused[t] >> 32) & 0xFF) > 22) longs++;
        long_mode = longs * 100 >= tsize * 7;
    }
    static const int staged = [] {
        const char* e = getenv("ZT_STAGED");
        return e ? atoi(e) : 0;
    }();
    int64_t r2;
    if (staged) {
        uint32_t* a_ll = seq_buf;
        uint32_t* a_ml = seq_buf + max_seq;
        uint32_t* a_of = seq_buf + 2 * max_seq;
        const int64_t rc2 = decode_sequences_to_arrays(
            src - 16, size, nb_seq, llu->fused, llu->tlog,
            ofu->fused, ofu->tlog, mlu->fused, mlu->tlog,
            ent->rep, a_ll, a_ml, a_of);
        if (rc2 < 0) return -1;
        if (prof) { int64_t t = prof_now(); g_prof[2] += t - t0; t0 = t; }
        r2 = execute_sequences(out, out_pos, out_cap, prefix_start, lit_buf,
                               lit_size, a_ll, a_ml, a_of, nb_seq);
        if (prof) { int64_t t = prof_now(); g_prof[3] += t - t0; t0 = t; }
    } else {
        r2 = decode_execute_sequences(
            src - 16, size, nb_seq, llu->fused, llu->tlog,
            ofu->fused, ofu->tlog, mlu->fused, mlu->tlog,
            ent->rep, out, out_pos, out_cap, prefix_start, lit_buf, lit_size,
            long_mode);
    }
    if (prof) { int64_t t = prof_now(); g_prof[2] += t - t0; t0 = t; }
    return r2 < 0 ? -1 : r2;
}

// Whole-frame block loop: src points after the frame header.  Returns
// produced bytes; sets *consumed (excl. checksum).  -1/-2.. on error.
// Block loop shared by the plain and dictionary paths: `ent` is the
// (possibly dictionary-preloaded) entropy state, `out_start` is where
// frame content begins in `out` (bytes below it are match history).
static int64_t decode_frame_blocks(const uint8_t* src, int64_t size,
                                   EntropyStateC* ent, uint8_t* out,
                                   int64_t out_start, int64_t out_cap,
                                   int64_t* consumed_out, int* dirty = nullptr);

int64_t decode_frame_body_c(const uint8_t* src, int64_t size, uint8_t* out,
                            int64_t out_cap, int64_t* consumed_out) {
    codec_init();
    if (prof_on()) { g_prof[0] = g_prof[1] = g_prof[2] = g_prof[3] = 0; }
    EntropyStateC* ent = (EntropyStateC*)malloc(sizeof(EntropyStateC));
    if (!ent) return -1;
    ent->huf.valid = false;
    ent->ll_valid = ent->of_valid = ent->ml_valid = false;
    ent->ll_src = ent->of_src = ent->ml_src = 0;
    ent->rep[0] = 1; ent->rep[1] = 4; ent->rep[2] = 8;
    // One padded copy for the whole frame: backward bit-readers may touch
    // up to 16 bytes before any payload, so blocks decode in place here.
    uint8_t* fpad = (uint8_t*)malloc((size_t)size + 24);
    if (!fpad) { free(ent); return -1; }
    std::memset(fpad, 0, 16);
    std::memcpy(fpad + 16, src, (size_t)size);
    int64_t r = decode_frame_blocks(fpad + 16, size, ent, out, 0, out_cap,
                                    consumed_out);
    free(fpad);
    free(ent);
    return r;
}

static int64_t decode_frame_blocks(const uint8_t* src, int64_t size,
                                   EntropyStateC* ent, uint8_t* out,
                                   int64_t out_start, int64_t out_cap,
                                   int64_t* consumed_out, int* dirty) {
    const int64_t max_seq = (1 << 17) / 3 + 16;
    uint8_t* lit_buf = (uint8_t*)malloc((1 << 17) + 64);
    uint32_t* seq_buf = (uint32_t*)malloc((size_t)max_seq * 12);
    int64_t pos = 0, out_pos = out_start;
    int64_t rc = 0;
    if (!lit_buf || !seq_buf) rc = -1;
    while (rc == 0) {
        if (size - pos < 3) { rc = -2; break; }
        const uint32_t bh = (uint32_t)src[pos] | ((uint32_t)src[pos + 1] << 8)
                            | ((uint32_t)src[pos + 2] << 16);
        pos += 3;
        const int last = bh & 1;
        const int btype = (bh >> 1) & 3;
        const int64_t bsize = bh >> 3;
        if (btype == 0) {
            if (size - pos < bsize || out_pos + bsize > out_cap) { rc = -3; break; }
            std::memcpy(out + out_pos, src + pos, (size_t)bsize);
            out_pos += bsize;
            pos += bsize;
        } else if (btype == 1) {
            if (size - pos < 1 || out_pos + bsize > out_cap) { rc = -4; break; }
            std::memset(out + out_pos, src[pos], (size_t)bsize);
            out_pos += bsize;
            pos += 1;
        } else if (btype == 2) {
            if (size - pos < bsize || bsize > (1 << 17) + 32) { rc = -5; break; }
            int64_t np = decode_block_c(src + pos, bsize, ent, out, out_pos,
                                        out_cap, 0, lit_buf, seq_buf, max_seq,
                                        dirty);
            if (np < 0) { rc = -6; break; }
            out_pos = np;
            pos += bsize;
        } else {
            rc = -7;
            break;
        }
        if (last) break;
    }
    if (prof_on())
        fprintf(stderr, "ZT_PROF decode ns: literals=%lld tables=%lld "
                "seqdec=%lld execute=%lld\n", (long long)g_prof[0],
                (long long)g_prof[1], (long long)g_prof[2],
                (long long)g_prof[3]);
    free(lit_buf);
    free(seq_buf);
    if (rc != 0) return rc;
    *consumed_out = pos;
    return out_pos - out_start;
}


// ===========================================================================
// Native dictionary contexts (ZSTD_CDict / ZSTD_DDict roles).
// Wire format (ZSTD_loadDEntropy, ZstdDecompress.cs:1770):
// [magic EC30A437][dictID u32][HUF weights][OF NCount][ML NCount][LL NCount]
// [rep0..2 u32][content].  Raw-content dictionaries (no magic) carry only
// history bytes.
// ===========================================================================

// Read a Huffman weights header (direct 4-bit or FSE-compressed) into
// weights[]; returns bytes consumed and sets *n_weights, or -1.
static int64_t huf_read_weights_c(const uint8_t* src, int64_t size,
                                  uint8_t* weights, int* n_weights) {
    if (size < 1) return -1;
    const int i_size = src[0];
    if (i_size >= 128) {
        const int nw = i_size - 127;
        const int64_t consumed = ((nw + 1) / 2) + 1;
        if (size < consumed) return -1;
        for (int i = 0; i < nw; i++) {
            uint8_t b = src[1 + i / 2];
            weights[i] = (i & 1) ? (b & 15) : (b >> 4);
        }
        *n_weights = nw;
        return consumed;
    }
    const int64_t consumed = i_size + 1;
    if (size < consumed) return -1;
    int16_t norm[13];
    int wmax, wlog;
    int64_t h = fse_read_ncount(norm, &wmax, &wlog, src + 1, i_size, 12, 6);
    if (h < 0) return -1;
    FseDTableC* wdt = (FseDTableC*)malloc(sizeof(FseDTableC));
    if (!wdt) return -1;
    static const uint32_t zb[13] = {0};
    static const uint8_t zbits[13] = {0};
    fse_build_dtable_c(wdt, norm, wmax, wlog, zb, zbits);
    uint8_t tsym[64];
    fse_spread(norm, wmax, wlog, tsym);
    int64_t nw = fse_decompress_2state(src + 1 + h, i_size - h, tsym,
                                       wdt->state_bits, wdt->next_state, wlog,
                                       weights, 255);
    free(wdt);
    if (nw < 1) return -1;
    *n_weights = (int)nw;
    return consumed;
}

// Canonical compress table from weights (incl. implied last weight).
static int huf_ctable_from_weights(const uint8_t* weights_in, int n_weights,
                                   HufCTableC* ct) {
    uint8_t weights[257];
    std::memcpy(weights, weights_in, (size_t)n_weights);
    uint64_t total = 0;
    for (int i = 0; i < n_weights; i++) {
        if (weights[i] > 12) return -1;
        if (weights[i]) total += 1ULL << (weights[i] - 1);
    }
    if (total == 0) return -1;
    const int tlog = highbit32((uint32_t)total) + 1;
    if (tlog > 12) return -1;
    const uint64_t rest = (1ULL << tlog) - total;
    if (rest & (rest - 1)) return -1;
    weights[n_weights] = (uint8_t)(highbit32((uint32_t)rest) + 1);
    const int nsym = n_weights + 1;
    uint8_t lengths[257];
    for (int i = 0; i < nsym; i++)
        lengths[i] = weights[i] ? (uint8_t)(tlog + 1 - weights[i]) : 0;
    huf_canonical(ct, lengths, nsym - 1);
    return 0;
}

// Attach-mode matchers (ZSTD_dictMatchState role): the dictionary's
// prefilled tables are read-only; frame-local inserts go to a small local
// table sized for the input, so per-frame setup is O(local table) instead
// of copying the dictionary state.  Candidates probe local first (more
// recent), then the dictionary.

static int64_t fast_attach_find(const uint8_t* all, int64_t clen,
                                int64_t end_all, int64_t wsize,
                                const uint32_t* dict_tbl, int dict_hlog,
                                uint32_t* loc_tbl, int loc_hlog, int mls,
                                uint32_t* rep_io,
                                uint32_t* out_ll, uint32_t* out_ml,
                                uint32_t* out_ob, int64_t max_seq,
                                int64_t* out_last_lit) {
    const int64_t start = clen, end = end_all;
    if (end - start < 16) { *out_last_lit = end - start; return 0; }
    const int64_t limit = end - 8;
    int64_t rep0 = rep_io[0], rep1 = rep_io[1];
    int64_t pos = start, anchor = start, n_seq = 0;

    auto probe = [&](int64_t p) -> int64_t {
        const uint32_t hl = hash_mls(all + p, loc_hlog, mls);
        const int64_t lc = (int64_t)loc_tbl[hl] - 1;
        loc_tbl[hl] = (uint32_t)(p + 1);
        if (lc >= 0 && p - lc < wsize && read32(all + lc) == read32(all + p))
            return lc;
        const int64_t dc =
            (int64_t)dict_tbl[hash_mls(all + p, dict_hlog, mls)] - 1;
        if (dc >= 0 && dc < clen && p - dc < wsize &&
            read32(all + dc) == read32(all + p)) return dc;
        return -1;
    };

    while (n_seq + 4 < max_seq) {
        int64_t step = 2, next_step = pos + 128;
        int64_t mp = -1, mc = -1, ml = 0;
        uint32_t ob = 0;
        while (pos + 1 <= limit) {
            const int64_t p2 = pos + step;
            if (p2 <= limit && p2 - rep0 >= 0 && rep0 <= wsize &&
                read32(all + p2) == read32(all + p2 - rep0)) {
                mp = p2; mc = p2 - rep0;
                if (mp > anchor && mc > 0 && all[mp - 1] == all[mc - 1]) {
                    mp--; mc--;
                }
                ml = (p2 - mp) + 4 + count_match(all, p2 + 4, p2 + 4 - rep0, end);
                ob = 1;
                break;
            }
            int64_t cand = probe(pos);
            if (cand >= 0) { mp = pos; mc = cand; break; }
            if (pos + 1 <= limit) {
                cand = probe(pos + 1);
                if (cand >= 0) { mp = pos + 1; mc = cand; break; }
            }
            pos += step;
            if (pos >= next_step) { step++; next_step += 128; }
        }
        if (mp < 0) break;
        if (ob == 0) {
            ml = 4 + count_match(all, mp + 4, mc + 4, end);
            while (mp > anchor && mc > 0 && all[mp - 1] == all[mc - 1]) {
                mp--; mc--; ml++;
            }
            const int64_t off = mp - mc;
            ob = (uint32_t)(off + 3);
            rep1 = rep0; rep0 = off;
        }
        out_ll[n_seq] = (uint32_t)(mp - anchor);
        out_ml[n_seq] = (uint32_t)ml;
        out_ob[n_seq] = ob;
        n_seq++;
        pos = mp + ml; anchor = pos;
        while (pos <= limit && n_seq < max_seq && pos - rep1 >= 0 &&
               rep1 <= wsize &&
               read32(all + pos) == read32(all + pos - rep1)) {
            const int64_t ml2 = 4 + count_match(all, pos + 4, pos + 4 - rep1, end);
            const int64_t t = rep0; rep0 = rep1; rep1 = t;
            out_ll[n_seq] = 0; out_ml[n_seq] = (uint32_t)ml2; out_ob[n_seq] = 1;
            n_seq++;
            pos += ml2; anchor = pos;
        }
        if (pos + 1 > limit) break;
    }
    rep_io[0] = (uint32_t)rep0; rep_io[1] = (uint32_t)rep1;
    *out_last_lit = end - anchor;
    return n_seq;
}

struct CDictC {
    uint8_t* buf;          // [content | src...] working buffer
    int64_t buf_cap;
    int64_t clen;
    uint32_t rep[3];
    EncEntropyC entropy;
    int strategy, hlog, clog, slog, wlog, mls;
    uint32_t* fast32;      // strategy 1-2: read-only attach table (pos+1)
    int64_t* tbl;          // lazy: read-only dict hash heads
    int64_t* chain;        // lazy: read-only dict chain
    uint32_t* loc;         // frame-local attach table scratch
    int loc_hlog;
    // lazy attach-mode per-frame state (epoch-tagged; no per-frame copy)
    uint32_t* l_pos;
    uint32_t* l_ep;
    int64_t* l_chain;
    uint32_t epoch;
};

// Parse entropy tables into (enc, dec) states; returns content offset or -1.
static int64_t dict_parse_common(const uint8_t* d, int64_t n,
                                 EncEntropyC* enc, EntropyStateC* dec,
                                 uint32_t* rep) {
    codec_init();
    if (n < 8 || read32(d) != 0xEC30A437u) return 0;  // raw content dict
    int64_t pos = 8;
    uint8_t weights[256];
    int nw;
    int64_t h = huf_read_weights_c(d + pos, n - pos, weights, &nw);
    if (h < 0) return -1;
    if (enc && huf_ctable_from_weights(weights, nw, &enc->huf) != 0) return -1;
    if (dec && huf_read_and_build_dtable(d + pos, n - pos, &dec->huf) < 0)
        return -1;
    pos += h;
    // OF, ML, LL NCounts
    struct Chan { int max_sym, max_log; };
    const Chan chans[3] = {{kMaxOFF, kOFFseLog}, {kMaxML, kMLFseLog},
                           {kMaxLL, kLLFseLog}};
    int16_t norms[3][64];
    int maxs[3], logs[3];
    for (int c = 0; c < 3; c++) {
        std::memset(norms[c], 0, sizeof norms[c]);
        int64_t hh = fse_read_ncount(norms[c], &maxs[c], &logs[c], d + pos,
                                     n - pos, chans[c].max_sym,
                                     chans[c].max_log);
        if (hh < 0) return -1;
        pos += hh;
    }
    if (enc) {
        fse_build_ctable_c(&enc->of_ct, norms[0], maxs[0], logs[0]);
        std::memcpy(enc->of_norm, norms[0], sizeof norms[0]);
        enc->of_max = maxs[0]; enc->of_log = logs[0]; enc->of_valid = true;
        fse_build_ctable_c(&enc->ml_ct, norms[1], maxs[1], logs[1]);
        std::memcpy(enc->ml_norm, norms[1], sizeof norms[1]);
        enc->ml_max = maxs[1]; enc->ml_log = logs[1]; enc->ml_valid = true;
        fse_build_ctable_c(&enc->ll_ct, norms[2], maxs[2], logs[2]);
        std::memcpy(enc->ll_norm, norms[2], sizeof norms[2]);
        enc->ll_max = maxs[2]; enc->ll_log = logs[2]; enc->ll_valid = true;
        enc->huf_valid = true;
    }
    if (dec) {
        fse_build_dtable_c(&dec->of, norms[0], maxs[0], logs[0], kOFBase, kOFBits);
        fse_build_dtable_c(&dec->ml, norms[1], maxs[1], logs[1], kMLBase, kMLBits);
        fse_build_dtable_c(&dec->ll, norms[2], maxs[2], logs[2], kLLBase, kLLBits);
        dec->of_valid = dec->ml_valid = dec->ll_valid = true;
        dec->of_src = dec->ml_src = dec->ll_src = 0;
    }
    if (n < pos + 12) return -1;
    for (int i = 0; i < 3; i++) {
        uint32_t r;
        std::memcpy(&r, d + pos + 4 * i, 4);
        rep[i] = r;
    }
    pos += 12;
    return pos;
}

void zt_cdict_free(void* h);

void* zt_cdict_create(const uint8_t* dict, int64_t dlen, int strategy,
                      int hlog, int clog, int slog, int wlog, int min_match) {
    // The bt strategies (6-9) attach through the deepest hash-chain
    // searcher with a doubled attempt budget: dictionary payloads are
    // record-sized, where chain search with the bt levels' budget reaches
    // within ~1% of the bt parse at ~50x the speed of rebuilding bt state
    // per record (ZSTD_shouldAttachDict role: attach always wins for small
    // inputs).
    int attempt_boost = 0;
    if (strategy > 5) {
        attempt_boost = strategy >= 8 ? 3 : 2;
        strategy = 5;
    }
    CDictC* c = (CDictC*)calloc(1, sizeof(CDictC));
    if (!c) return nullptr;
    enc_entropy_reset(&c->entropy);
    c->rep[0] = 1; c->rep[1] = 4; c->rep[2] = 8;
    int64_t coff = dict_parse_common(dict, dlen, &c->entropy, nullptr, c->rep);
    if (coff < 0) { free(c); return nullptr; }
    if (coff == 0) {  // raw dict: no entropy
        enc_entropy_reset(&c->entropy);
        c->rep[0] = 1; c->rep[1] = 4; c->rep[2] = 8;
    }
    c->clen = dlen - coff;
    c->strategy = strategy; c->hlog = hlog; c->clog = clog;
    c->slog = slog + attempt_boost;
    c->wlog = wlog;
    c->mls = min_match < 4 ? 4 : (min_match > 8 ? 8 : min_match);
    c->buf_cap = c->clen + (1 << 18);
    c->buf = (uint8_t*)malloc((size_t)c->buf_cap);
    if (!c->buf) { free(c); return nullptr; }
    std::memcpy(c->buf, dict + coff, (size_t)c->clen);
    const uint8_t* src = c->buf;
    const int64_t lim = c->clen - 8;
    if (strategy <= 1) {
        // fast keeps the one-shot attach path for small frames: one
        // read-only table over the dictionary, tiny local table per frame
        // (large frames route to the chain-attach matcher below, where
        // parse quality dominates the dictionary's head start)
        c->fast32 = (uint32_t*)calloc((size_t)1 << hlog, 4);
        if (!c->fast32) { free(c->buf); free(c); return nullptr; }
        for (int64_t i = 0; i < lim; i++)
            c->fast32[hash_mls(src + i, hlog, c->mls)] = (uint32_t)(i + 1);
        c->loc_hlog = 12;
        c->loc = (uint32_t*)malloc(((size_t)1 << c->loc_hlog) * 4);
        if (!c->loc) { free(c->fast32); free(c->buf); free(c); return nullptr; }
    }
    {
        c->tbl = (int64_t*)malloc(((size_t)1 << hlog) * 8);
        c->chain = (int64_t*)malloc(((size_t)1 << clog) * 8);
        if (!c->tbl || !c->chain) {
            zt_cdict_free(c);
            return nullptr;
        }
        for (int64_t i = 0; i < (1LL << hlog); i++) c->tbl[i] = -1;
        const int64_t cmask = (1LL << clog) - 1;
        for (int64_t i = 0; i < (1LL << clog); i++) c->chain[i] = -1;
        for (int64_t i = 0; i < lim; i++) {
            const uint32_t hv = hash_mls(src + i, hlog, c->mls);
            c->chain[i & cmask] = c->tbl[hv];
            c->tbl[hv] = i;
        }
        // attach-mode local state (ZSTD_shouldAttachDict role: the dict
        // tables above stay read-only; frames never copy them)
        c->l_pos = (uint32_t*)calloc((size_t)1 << hlog, 4);
        c->l_ep = (uint32_t*)calloc((size_t)1 << hlog, 4);
        c->l_chain = (int64_t*)malloc(((size_t)1 << clog) * 8);
        c->epoch = 0;
        if (!c->l_pos || !c->l_ep || !c->l_chain) {
            zt_cdict_free(c);
            return nullptr;
        }
    }
    return c;
}

void zt_cdict_free(void* h) {
    if (!h) return;
    CDictC* c = (CDictC*)h;
    free(c->fast32); free(c->tbl); free(c->chain); free(c->loc);
    free(c->l_pos); free(c->l_ep); free(c->l_chain); free(c->buf);
    free(c);
}

// Compress one frame body against the dictionary.  Scratch tables are
// copies of the prefilled ones, so calls are independent.
int64_t zt_compress_frame_body_cdict(void* h, const uint8_t* src, int64_t n,
                                     uint8_t* out, int64_t cap) {
    CDictC* c = (CDictC*)h;
    if (!c || n == 0) return -1;
    if (c->clen + n > c->buf_cap) {
        const int64_t need = c->clen + n;
        uint8_t* nb = (uint8_t*)realloc(c->buf, (size_t)need);
        if (!nb) return -1;
        c->buf = nb;
        c->buf_cap = need;
    }
    std::memcpy(c->buf + c->clen, src, (size_t)n);
    const uint8_t* all = c->buf;
    const int64_t end_all = c->clen + n;
    const int64_t wsize = 1LL << c->wlog;

    const int64_t block_size = (1 << 17) < wsize ? (1 << 17) : wsize;
    int64_t max_seq_cap = (block_size < n ? block_size : n) / 3 + 16;
    uint32_t* s_ll = (uint32_t*)malloc((size_t)max_seq_cap * 12);
    if (!s_ll) return -1;
    uint32_t* s_ml = s_ll + max_seq_cap;
    uint32_t* s_ob = s_ml + max_seq_cap;

    // attach mode: wipe only the small local table
    if (c->loc)
        std::memset(c->loc, 0, ((size_t)1 << c->loc_hlog) * 4);
    if (c->tbl) {
        // attach mode: new epoch invalidates all local heads at O(1);
        // wrap-around wipes the tag array instead
        c->epoch++;
        if (c->epoch == 0) {
            std::memset(c->l_ep, 0, ((size_t)1 << c->hlog) * 4);
            c->epoch = 1;
        }
    }
    EncEntropyC est = c->entropy;
    uint32_t rep[3] = {c->rep[0], c->rep[1], c->rep[2]};
    // fast32 path carries only rep0/rep1 in its io array
    int64_t insert_from = c->clen;
    int64_t size = 0;
    int64_t pos = c->clen;
    int rc = 0;
    EncEntropyC est_snap2;
    uint32_t rep_in[3];
    const int64_t body_start = pos;
    while (pos < end_all && rc == 0) {
        // Same content-adaptive boundary as the plain drivers; savings are
        // frame-body bytes consumed minus produced so far.
        const int64_t end =
            pos + zx_presplit(all + pos, end_all - pos, block_size,
                              c->strategy, (pos - body_start) - size);
        const int last = end == end_all;
        const int64_t bn = end - pos;
        if (size + 3 + bn + 32 > cap) { rc = -1; break; }
        rep_in[0] = rep[0]; rep_in[1] = rep[1]; rep_in[2] = rep[2];
        est_snap2 = est;
        int64_t last_lit = 0;
        int64_t n_seq = 0;
        if (c->strategy <= 1 && n < (256 << 10)) {
            n_seq = fast_attach_find(all, pos, end, wsize, c->fast32,
                                     c->hlog, c->loc, c->loc_hlog, c->mls,
                                     rep, s_ll, s_ml, s_ob, max_seq_cap,
                                     &last_lit);
        } else {
            // dfast (strategy 2) rides the chain-attach matcher at depth 0:
            // greedy over exact chains beats the one-probe fast schedule on
            // dictionary workloads at the same level (L3 large-input ratio
            // x1.165 -> measured below parity after this routing)
            const int depth =
                c->strategy >= 5 ? 2 : (c->strategy >= 4 ? 1 : 0);
            n_seq = lazy_attach_find(all, pos, end, c->clen, wsize, c->tbl,
                                     c->chain, 1LL << c->clog, c->l_pos,
                                     c->l_ep, c->epoch, c->l_chain,
                                     1LL << c->clog, c->hlog, 1LL << c->slog,
                                     depth, &insert_from, rep, s_ll, s_ml,
                                     s_ob, max_seq_cap, &last_lit, c->mls);
        }
        if (n_seq < 0) { rc = -1; break; }
        int64_t body = encode_block_body_c(all + pos, bn, s_ll, s_ml, s_ob,
                                           n_seq, last_lit, out + size + 3,
                                           cap - size - 3 - 8, &est);
        if (body < 0) {
            rep[0] = rep_in[0]; rep[1] = rep_in[1]; rep[2] = rep_in[2];
            est = est_snap2;
            const uint32_t bh = (uint32_t)(last | (0 << 1) | (bn << 3));
            out[size] = (uint8_t)bh; out[size + 1] = (uint8_t)(bh >> 8);
            out[size + 2] = (uint8_t)(bh >> 16);
            std::memcpy(out + size + 3, all + pos, (size_t)bn);
            size += 3 + bn;
        } else {
            const uint32_t bh = (uint32_t)(last | (2 << 1) | (body << 3));
            out[size] = (uint8_t)bh; out[size + 1] = (uint8_t)(bh >> 8);
            out[size + 2] = (uint8_t)(bh >> 16);
            size += 3 + body;
        }
        pos = end;
    }
    free(s_ll);
    return rc == 0 ? size : -1;
}

// Entropy statistics for dictionary finalization (ZDICT_countEStats:21
// role): parse each sample against the dictionary with the same attach
// matcher the production path uses, and histogram the seqStore's
// literals, ll/ml/of codes, and leading offsets.
int64_t zt_cdict_stats(void* h, const uint8_t* concat, const int64_t* lens,
                       int64_t n_samples, int64_t* lit_counts,
                       int64_t* ll_counts, int64_t* ml_counts,
                       int64_t* of_counts, int64_t* rep_off) {
    CDictC* c = (CDictC*)h;
    if (!c) return -1;
    const int64_t wsize = 1LL << c->wlog;
    int64_t max_seq_cap = (1 << 17) / 3 + 16;
    uint32_t* s_ll = (uint32_t*)malloc((size_t)max_seq_cap * 12);
    if (!s_ll) return -1;
    uint32_t* s_ml = s_ll + max_seq_cap;
    uint32_t* s_ob = s_ml + max_seq_cap;
    int64_t ip = 0;
    for (int64_t si = 0; si < n_samples; si++) {
        int64_t n = lens[si];
        const uint8_t* sample = concat + ip;
        ip += n;
        if (n < 8) continue;
        if (n > (1 << 17)) n = 1 << 17;
        if (c->clen + n > c->buf_cap) {
            uint8_t* nb = (uint8_t*)realloc(c->buf, (size_t)(c->clen + n));
            if (!nb) { free(s_ll); return -1; }
            c->buf = nb;
            c->buf_cap = c->clen + n;
        }
        std::memcpy(c->buf + c->clen, sample, (size_t)n);
        uint32_t rep[3] = {1, 4, 8};
        int64_t last_lit = 0;
        int64_t n_seq;
        if (c->strategy <= 1) {
            std::memset(c->loc, 0, ((size_t)1 << c->loc_hlog) * 4);
            n_seq = fast_attach_find(c->buf, c->clen, c->clen + n, wsize,
                                     c->fast32, c->hlog, c->loc, c->loc_hlog,
                                     c->mls, rep, s_ll, s_ml, s_ob,
                                     max_seq_cap, &last_lit);
        } else {
            c->epoch++;
            if (c->epoch == 0) {
                std::memset(c->l_ep, 0, ((size_t)1 << c->hlog) * 4);
                c->epoch = 1;
            }
            int64_t insert_from = c->clen;
            const int depth =
                c->strategy >= 5 ? 2 : (c->strategy >= 4 ? 1 : 0);
            n_seq = lazy_attach_find(c->buf, c->clen, c->clen + n, c->clen,
                                     wsize, c->tbl, c->chain, 1LL << c->clog,
                                     c->l_pos, c->l_ep, c->epoch, c->l_chain,
                                     1LL << c->clog, c->hlog, 1LL << c->slog,
                                     depth, &insert_from, rep, s_ll, s_ml,
                                     s_ob, max_seq_cap, &last_lit, c->mls);
        }
        if (n_seq < 0) continue;
        int64_t pos = 0;
        for (int64_t i = 0; i < n_seq; i++) {
            for (uint32_t u = 0; u < s_ll[i]; u++)
                lit_counts[sample[pos + u]]++;
            ll_counts[kLLCodeLut[s_ll[i] < 65535 ? s_ll[i] : 65535]]++;
            {
                const uint32_t mlb = s_ml[i] - 3;
                ml_counts[kMLCodeLut[mlb < 65535 ? mlb : 65535]]++;
            }
            {
                int oc = highbit32(s_ob[i]);
                if (oc > 28) oc = 28;
                of_counts[oc]++;
            }
            pos += s_ll[i] + s_ml[i];
        }
        for (int64_t u = pos; u < n; u++) lit_counts[sample[u]]++;
        if (n_seq >= 2) {
            const int64_t o1 = (int64_t)s_ob[0] - 3;
            const int64_t o2 = (int64_t)s_ob[1] - 3;
            rep_off[(o1 > 0 && o1 < 1024) ? o1 : 0] += 3;
            rep_off[(o2 > 0 && o2 < 1024) ? o2 : 0] += 1;
        }
    }
    free(s_ll);
    return 0;
}

struct DDictC {
    uint8_t* content;
    int64_t clen;
    EntropyStateC ent;        // pristine (as loaded)
    EntropyStateC scratch;    // per-call working copy, dirty-restored
    int scratch_dirty;        // bit0 huf, 1 ll, 2 of, 3 ml; -1 = all
    bool has_entropy;
};

void* zt_ddict_create(const uint8_t* dict, int64_t dlen) {
    DDictC* d = (DDictC*)calloc(1, sizeof(DDictC));
    if (!d) return nullptr;
    d->ent.huf.valid = false;
    d->ent.ll_valid = d->ent.of_valid = d->ent.ml_valid = false;
    d->ent.ll_src = d->ent.of_src = d->ent.ml_src = 0;
    d->ent.rep[0] = 1; d->ent.rep[1] = 4; d->ent.rep[2] = 8;
    int64_t coff = dict_parse_common(dict, dlen, nullptr, &d->ent, d->ent.rep);
    if (coff < 0) { free(d); return nullptr; }
    d->has_entropy = coff > 0;
    d->clen = dlen - coff;
    d->content = (uint8_t*)malloc((size_t)(d->clen > 0 ? d->clen : 1));
    if (!d->content) { free(d); return nullptr; }
    std::memcpy(d->content, dict + coff, (size_t)d->clen);
    d->scratch = d->ent;
    d->scratch_dirty = 0;
    return d;
}

void zt_ddict_free(void* h) {
    if (!h) return;
    DDictC* d = (DDictC*)h;
    free(d->content);
    free(d);
}

// Decode one frame body with dictionary history + entropy.  `out` must have
// room for clen + content; returns content bytes (excluding the prefix,
// which occupies out[0..clen)), sets *consumed.
int64_t zt_decode_frame_body_ddict(const uint8_t* src, int64_t size, void* h,
                                   uint8_t* out, int64_t out_cap,
                                   int64_t* consumed_out) {
    DDictC* d = (DDictC*)h;
    if (!d || out_cap < d->clen) return -1;
    std::memcpy(out, d->content, (size_t)d->clen);
    // Restore only what the previous frame overwrote (tables are large).
    if (d->scratch_dirty & 1) d->scratch.huf = d->ent.huf;
    if (d->scratch_dirty & 2) d->scratch.ll = d->ent.ll;
    if (d->scratch_dirty & 4) d->scratch.of = d->ent.of;
    if (d->scratch_dirty & 8) d->scratch.ml = d->ent.ml;
    d->scratch.ll_valid = d->ent.ll_valid;
    d->scratch.of_valid = d->ent.of_valid;
    d->scratch.ml_valid = d->ent.ml_valid;
    d->scratch.ll_src = d->ent.ll_src;
    d->scratch.of_src = d->ent.of_src;
    d->scratch.ml_src = d->ent.ml_src;
    d->scratch.huf.valid = d->ent.huf.valid;
    std::memcpy(d->scratch.rep, d->ent.rep, sizeof d->scratch.rep);
    d->scratch_dirty = 0;
    uint8_t* fpad = (uint8_t*)malloc((size_t)size + 24);
    if (!fpad) return -1;
    std::memset(fpad, 0, 16);
    std::memcpy(fpad + 16, src, (size_t)size);
    int64_t r = decode_frame_blocks(fpad + 16, size, &d->scratch, out, d->clen,
                                    out_cap, consumed_out, &d->scratch_dirty);
    free(fpad);
    return r;
}


// ---------------------------------------------------------------------------
// Batch dictionary codec (the 10K-small-records shape): one call per batch,
// frame headers written/parsed natively.
// ---------------------------------------------------------------------------

static int64_t write_frame_header_c(uint8_t* out, int64_t src_size, int wlog,
                                    uint32_t dict_id, int checksum) {
    const uint32_t magic = 0xFD2FB528u;
    std::memcpy(out, &magic, 4);
    int64_t p = 5;
    const int64_t wsize = 1LL << wlog;
    const int single = src_size <= wsize;
    int fcs_code = (src_size >= 256) + (src_size >= 65536 + 256) +
                   (src_size > 0xFFFFFFFFLL);
    const int did = dict_id == 0 ? 0 : (dict_id < 256 ? 1 : dict_id < 65536 ? 2 : 3);
    out[4] = (uint8_t)((fcs_code << 6) | (single << 5) | (checksum << 2) | did);
    if (!single) out[p++] = (uint8_t)((wlog - 10) << 3);
    if (did == 1) { out[p++] = (uint8_t)dict_id; }
    else if (did == 2) { std::memcpy(out + p, &dict_id, 2); p += 2; }
    else if (did == 3) { std::memcpy(out + p, &dict_id, 4); p += 4; }
    if (fcs_code == 0) {
        if (single) out[p++] = (uint8_t)src_size;
    } else if (fcs_code == 1) {
        const uint16_t v = (uint16_t)(src_size - 256);
        std::memcpy(out + p, &v, 2); p += 2;
    } else if (fcs_code == 2) {
        const uint32_t v = (uint32_t)src_size;
        std::memcpy(out + p, &v, 4); p += 4;
    } else {
        const uint64_t v = (uint64_t)src_size;
        std::memcpy(out + p, &v, 8); p += 8;
    }
    return p;
}

// Compress n_items records (concatenated) into framed outputs.  out_lens[i]
// receives each frame's size; returns total bytes or -1.
int64_t zt_compress_many_cdict(void* h, const uint8_t* concat,
                               const int64_t* lens, int64_t n_items,
                               uint32_t dict_id, uint8_t* out, int64_t cap,
                               int64_t* out_lens) {
    CDictC* c = (CDictC*)h;
    if (!c) return -1;
    int64_t ip = 0, op = 0;
    for (int64_t i = 0; i < n_items; i++) {
        const int64_t n = lens[i];
        if (op + n + 64 > cap) return -1;
        const int64_t h0 = write_frame_header_c(out + op, n, c->wlog, dict_id, 0);
        int64_t body;
        if (n == 0) {
            out[op + h0] = 1; out[op + h0 + 1] = 0; out[op + h0 + 2] = 0;
            body = 3;
        } else {
            body = zt_compress_frame_body_cdict(h, concat + ip, n,
                                                out + op + h0,
                                                cap - op - h0);
            if (body < 0) return -1;
        }
        out_lens[i] = h0 + body;
        op += h0 + body;
        ip += n;
    }
    return op;
}

// Parse a frame header: returns header size, sets *fcs (-1 unknown),
// *has_cksum, and *dict_id (0 when absent).  -1 on error.
static int64_t parse_frame_header_c(const uint8_t* src, int64_t size,
                                    int64_t* fcs, int* has_cksum,
                                    uint32_t* dict_id) {
    if (size < 5) return -1;
    uint32_t magic;
    std::memcpy(&magic, src, 4);
    if (magic != 0xFD2FB528u) return -1;
    const uint8_t fhd = src[4];
    const int fcs_code = fhd >> 6;
    const int single = (fhd >> 5) & 1;
    *has_cksum = (fhd >> 2) & 1;
    const int did = fhd & 3;
    int64_t p = 5;
    if (!single) p += 1;
    const int did_bytes = did == 0 ? 0 : did == 1 ? 1 : did == 2 ? 2 : 4;
    if (size < p + did_bytes) return -1;
    *dict_id = 0;
    if (did_bytes) std::memcpy(dict_id, src + p, (size_t)did_bytes);
    p += did_bytes;
    if (fcs_code == 0) {
        if (single) { if (size < p + 1) return -1; *fcs = src[p]; p += 1; }
        else *fcs = -1;
    } else if (fcs_code == 1) {
        uint16_t v; if (size < p + 2) return -1;
        std::memcpy(&v, src + p, 2); *fcs = v + 256; p += 2;
    } else if (fcs_code == 2) {
        uint32_t v; if (size < p + 4) return -1;
        std::memcpy(&v, src + p, 4); *fcs = v; p += 4;
    } else {
        int64_t v; if (size < p + 8) return -1;
        std::memcpy(&v, src + p, 8); *fcs = v; p += 8;
    }
    return p;
}

// Decompress n_items frames (concatenated, sizes in flens) into concatenated
// outputs; out_lens[i] receives each content size.  Returns the total, or
// -(i + 2) when frame i cannot be decoded here (parse failure, dictID
// mismatch, bad checksum...): out/out_lens then hold frames [0, i) and the
// caller decodes frame i element-wise and resumes the batch after it
// (ZstdDecompress.cs:1216 multi-frame loop semantics, one frame's failure
// does not invalidate its neighbours).  -1 = invalid args / OOM only.
// The handle scratch is always left pristine on failure exits, so one bad
// frame never poisons later calls on the same dictionary.
int64_t zt_decompress_many_ddict(void* h, const uint8_t* concat_in,
                                 const int64_t* flens, int64_t n_items,
                                 uint32_t expect_dict_id,
                                 uint8_t* out, int64_t out_cap,
                                 int64_t* out_lens) {
    DDictC* d = (DDictC*)h;
    if (!d) return -1;
    int64_t total_in = 0;
    for (int64_t i = 0; i < n_items; i++) total_in += flens[i];
    uint8_t* cpad = (uint8_t*)malloc((size_t)total_in + 24);
    if (!cpad) return -1;
    std::memset(cpad, 0, 16);
    std::memcpy(cpad + 16, concat_in, (size_t)total_in);
    const uint8_t* concat = cpad + 16;
    const int64_t clen = d->clen;
    uint8_t* work = nullptr;
    int64_t work_cap = 0;
    int64_t ip = 0, op = 0;
    // Any failure exit must leave the handle reusable: reset the working
    // entropy copy to the pristine dictionary state (a half-decoded frame
    // may have overwritten tables AND the repeat-mode source markers).
    auto fail_frame = [&](int64_t i) -> int64_t {
        d->scratch = d->ent;
        d->scratch_dirty = 0;
        free(work); free(cpad);
        return -(i + 2);
    };
    for (int64_t i = 0; i < n_items; i++) {
        const int64_t fl = flens[i];
        int64_t fcs;
        int cksum;
        uint32_t frame_did;
        const int64_t h0 = parse_frame_header_c(concat + ip, fl, &fcs, &cksum,
                                                &frame_did);
        if (h0 < 0 || fcs < 0) return fail_frame(i);
        // A frame that names a different dictionary must not silently decode
        // against this one (ZSTD_decodeFrameHeader dictionary_wrong role);
        // punt it to the element-wise path, which raises the proper error.
        if (frame_did != 0 && frame_did != expect_dict_id) return fail_frame(i);
        const int64_t need = clen + fcs + 64;
        if (need > work_cap) {
            free(work);
            work_cap = need * 2;
            work = (uint8_t*)malloc((size_t)work_cap);
            if (!work) { free(cpad); return -1; }
        }
        // Restore the dirty-tracked scratch, INCLUDING the repeat-mode
        // table-source markers — a prior frame that switched a channel to
        // its own FSE table must not leak that choice into the next
        // frame's Repeat_Mode resolution.
        if (d->scratch_dirty & 1) d->scratch.huf = d->ent.huf;
        if (d->scratch_dirty & 2) d->scratch.ll = d->ent.ll;
        if (d->scratch_dirty & 4) d->scratch.of = d->ent.of;
        if (d->scratch_dirty & 8) d->scratch.ml = d->ent.ml;
        d->scratch.ll_valid = d->ent.ll_valid;
        d->scratch.of_valid = d->ent.of_valid;
        d->scratch.ml_valid = d->ent.ml_valid;
        d->scratch.ll_src = d->ent.ll_src;
        d->scratch.of_src = d->ent.of_src;
        d->scratch.ml_src = d->ent.ml_src;
        d->scratch.huf.valid = d->ent.huf.valid;
        std::memcpy(d->scratch.rep, d->ent.rep, sizeof d->scratch.rep);
        d->scratch_dirty = 0;
        std::memcpy(work, d->content, (size_t)clen);
        int64_t consumed = 0;
        const int64_t r = decode_frame_blocks(concat + ip + h0, fl - h0,
                                              &d->scratch, work, clen,
                                              clen + fcs, &consumed,
                                              &d->scratch_dirty);
        if (r != fcs) return fail_frame(i);
        // Verify the XXH64 content checksum when the frame carries one
        // (ZSTD_decompressFrame checksum verify role); the epilogue must
        // also account for the frame length.
        if (cksum) {
            if (h0 + consumed + 4 > fl) return fail_frame(i);
            uint32_t stored;
            std::memcpy(&stored, concat + ip + h0 + consumed, 4);
            const uint32_t calc =
                (uint32_t)xxh64(work + clen, r, 0);
            if (stored != calc) return fail_frame(i);
        }
        if (op + r > out_cap) return fail_frame(i);
        std::memcpy(out + op, work + clen, (size_t)r);
        out_lens[i] = r;
        op += r;
        ip += fl;
    }
    free(work);
    free(cpad);
    return op;
}



// Exact one-shot frame compression with zstd v1.5.1 semantics for the
// fast/dfast strategies.  Returns the frame size, or
//   -1 on internal error / capacity, -2 when the (level, srcSize) resolves
//   to a strategy this path does not cover yet (caller falls back).
// ---------------------------------------------------------------------------
// DP pipeline frame body: one native pass over all blocks of a frame,
// consuming the device parse's per-position candidates (hybrid_select)
// and running the exact-path entropy encoder per block.  Replaces the
// per-block host-Python loop of parallel/pipeline.py (VERDICT r2 item 3).
// Returns emitted body bytes (block headers included) or -1.
// ---------------------------------------------------------------------------
int64_t zt_dp_frame_body(const uint8_t* src, int64_t n, const int32_t* cand,
                         int64_t block_size, uint8_t* out, int64_t cap) {
    codec_init();
    if (n <= 0) return -1;
    if (block_size <= 0 || block_size > (1 << 17)) return -1;
    const int64_t seq_cap = block_size / 3 + 64;
    uint32_t* ll = (uint32_t*)malloc((size_t)seq_cap * 12);
    if (!ll) return -1;
    uint32_t* ml = ll + seq_cap;
    uint32_t* ob = ml + seq_cap;
    ZxEntropy ent[2];
    std::memset(ent, 0, sizeof ent);
    ent[0].repcodes[0] = 1; ent[0].repcodes[1] = 4; ent[0].repcodes[2] = 8;
    int prevIdx = 0;
    uint32_t rep2[2] = {1, 4};
    int64_t ip = 0, op = 0;

    while (ip < n) {
        const int64_t bs = block_size < n - ip ? block_size : n - ip;
        const int lastBlock = ip + bs == n;
        if (cap - op < bs + 32) { free(ll); return -1; }
        // RLE block
        int is_rle = bs > 1;
        for (int64_t i = 1; is_rle && i < bs; i++)
            if (src[ip + i] != src[ip]) is_rle = 0;
        if (is_rle) {
            const uint32_t bh = (uint32_t)(lastBlock + (1u << 1) +
                                           ((uint32_t)bs << 3));
            out[op] = (uint8_t)bh;
            out[op + 1] = (uint8_t)(bh >> 8);
            out[op + 2] = (uint8_t)(bh >> 16);
            out[op + 3] = src[ip];
            op += 4;
            ip += bs;
            continue;
        }
        const uint32_t rep_snap[2] = {rep2[0], rep2[1]};
        int64_t last_lit = bs;
        int64_t nseq = hybrid_select(src + ip, bs, cand + ip, rep2,
                                     ll, ml, ob, seq_cap - 8, &last_lit);
        int64_t c = -1;
        if (nseq > 0)
            c = zx_block_from_arrays(src + ip, bs, ll, ml, ob, nseq,
                                     last_lit, &ent[prevIdx],
                                     &ent[prevIdx ^ 1], 1, out + op + 3,
                                     cap - op - 3 - 8);
        if (c < 0) {
            // raw block: the decoder sees no sequences, so the selector's
            // rep advance must be rolled back and entropy stays put
            rep2[0] = rep_snap[0];
            rep2[1] = rep_snap[1];
            const uint32_t bh = (uint32_t)(lastBlock + (0u << 1) +
                                           ((uint32_t)bs << 3));
            out[op] = (uint8_t)bh;
            out[op + 1] = (uint8_t)(bh >> 8);
            out[op + 2] = (uint8_t)(bh >> 16);
            std::memcpy(out + op + 3, src + ip, (size_t)bs);
            op += 3 + bs;
        } else {
            const uint32_t bh = (uint32_t)(lastBlock + (2u << 1) +
                                           ((uint32_t)c << 3));
            out[op] = (uint8_t)bh;
            out[op + 1] = (uint8_t)(bh >> 8);
            out[op + 2] = (uint8_t)(bh >> 16);
            op += 3 + c;
            prevIdx ^= 1;
        }
        ip += bs;
    }
    free(ll);
    return op;
}

int64_t zt_compress_exact_params(const uint8_t* src, int64_t n,
                                 int wlog, int clog, int hlog, int slog,
                                 int mml, int tlen, int strat,
                                 int checksum_flag, uint8_t* out,
                                 int64_t cap);

int64_t zt_compress_exact(const uint8_t* src, int64_t n, int level,
                          int checksum_flag, uint8_t* out, int64_t cap) {
    codec_init();
    const ZxCP cp = zx_get_cparams(level, (uint64_t)n);
    return zt_compress_exact_params(src, n, (int)cp.wlog, (int)cp.clog,
                                    (int)cp.hlog, (int)cp.slog, (int)cp.mml,
                                    (int)cp.tlen, (int)cp.strat,
                                    checksum_flag, out, cap);
}

// Same pipeline with explicit (already adjusted) compression parameters.
int64_t zt_compress_exact_params(const uint8_t* src, int64_t n,
                                 int wlog, int clog, int hlog, int slog,
                                 int mml, int tlen, int strat,
                                 int checksum_flag, uint8_t* out,
                                 int64_t cap) {
    codec_init();
    if (prof_on()) { g_prof[0] = g_prof[1] = g_prof[2] = g_prof[3] = 0; }
    ZxCP cp;
    cp.wlog = (uint32_t)wlog; cp.clog = (uint32_t)clog;
    cp.hlog = (uint32_t)hlog; cp.slog = (uint32_t)slog;
    cp.mml = (uint32_t)mml; cp.tlen = (uint32_t)tlen;
    cp.strat = (uint32_t)strat;
    (void)slog;
    // fast/dfast and the bt-optimal family; lazy strategies (3-6) route to
    // the legacy pipeline.
    if ((cp.strat > 2 && cp.strat < 7) || cp.strat > 9) return -2;
    // The exact path uses u32 window indices without the reference's
    // overflow correction; very large inputs route to the legacy driver,
    // whose indices are 64-bit.
    if (n >= (1LL << 30)) return -2;

    const uint64_t windowSize = 1ULL << cp.wlog;
    const int64_t blockSizeMax =
        (int64_t)(windowSize < (1u << 17) ? windowSize : (1u << 17));

    // ---- frame header (ZSTD_writeFrameHeader:4817; contentSize known) ----
    int64_t op = 0;
    {
        const uint32_t singleSegment = windowSize >= (uint64_t)n;
        const uint32_t fcsCode = (n >= 256) + (n >= 65536 + 256) +
                                 (n >= (int64_t)0xFFFFFFFFLL);
        if (cap < 18) return -1;
        const uint32_t magic = 0xFD2FB528u;
        std::memcpy(out, &magic, 4);
        op = 4;
        out[op++] = (uint8_t)((fcsCode << 6) + (singleSegment << 5) +
                              ((checksum_flag ? 1 : 0) << 2));
        if (!singleSegment) out[op++] = (uint8_t)((cp.wlog - 10) << 3);
        if (fcsCode == 0) {
            if (singleSegment) out[op++] = (uint8_t)n;
        } else if (fcsCode == 1) {
            const uint16_t v = (uint16_t)(n - 256);
            std::memcpy(out + op, &v, 2);
            op += 2;
        } else if (fcsCode == 2) {
            const uint32_t v = (uint32_t)n;
            std::memcpy(out + op, &v, 4);
            op += 4;
        } else {
            const uint64_t v = (uint64_t)n;
            std::memcpy(out + op, &v, 8);
            op += 8;
        }
    }

    if (n == 0) {
        // empty frame: last raw empty block (ZSTD_writeEpilogue:5598)
        if (cap < op + 3 + 4) return -1;
        out[op++] = 1;
        out[op++] = 0;
        out[op++] = 0;
        if (checksum_flag) {
            const uint32_t c = (uint32_t)xxh64(src, 0, 0);
            std::memcpy(out + op, &c, 4);
            op += 4;
        }
        return op;
    }

    // ---- state ----
    const uint8_t* const base = src - 2;  // ZSTD_WINDOW_START_INDEX == 2
    uint32_t dictLimit = 2;
    uint32_t* hashTable = nullptr;
    uint32_t* chainTable = nullptr;
    ZxOptCtx* optc = nullptr;
    uint32_t* os_ll = nullptr;  // opt scratch (llen, mlen, offBase) arrays
    const int64_t opt_seq_cap = blockSizeMax / 3 + 64;
    if (cp.strat >= 7) {
        optc = zx_opt_create(src, cp.wlog, cp.clog, cp.hlog, cp.slog,
                             cp.tlen, cp.mml, (int)cp.strat);
        // ZT_TREE_PRESERVE=0 restores the reference's block-boundary tree
        // chop (ZSTD_insertBt1:490) so bt-level output can be byte-compared
        // against a pinned libzstd; preservation (default) is this repo's
        // ratio improvement and is asserted separately.
        static const int keep_tree = [] {
            const char* e = getenv("ZT_TREE_PRESERVE");
            return e ? atoi(e) : 1;
        }();
        if (optc && keep_tree) optc->frame_end = src + n;
        os_ll = (uint32_t*)malloc((size_t)opt_seq_cap * 12);
        if (!optc || !os_ll) {
            zx_opt_free(optc);
            free(os_ll);
            return -1;
        }
    } else {
        hashTable = (uint32_t*)calloc((size_t)1 << cp.hlog, 4);
        chainTable = cp.strat == 2
                         ? (uint32_t*)calloc((size_t)2 << cp.clog, 4)
                         : nullptr;
        if (!hashTable || (cp.strat == 2 && !chainTable)) {
            free(hashTable);
            free(chainTable);
            return -1;
        }
    }
    uint32_t* const os_ml = os_ll ? os_ll + opt_seq_cap : nullptr;
    uint32_t* const os_ob = os_ml ? os_ml + opt_seq_cap : nullptr;
    ZxEntropy ent[2];
    std::memset(ent, 0, sizeof ent);
    ent[0].repcodes[0] = 1; ent[0].repcodes[1] = 4; ent[0].repcodes[2] = 8;
    int prevIdx = 0;
    int isFirstBlock = 1;

    ZxStore ss;
    ss.lit = (uint8_t*)malloc((size_t)blockSizeMax + 32);
    ss.seq = (ZxSeq*)malloc(((size_t)blockSizeMax / 3 + 64) * sizeof(ZxSeq));
    if (!ss.lit || !ss.seq) {
        free(hashTable); free(chainTable); free(ss.lit); free(ss.seq);
        zx_opt_free(optc); free(os_ll);
        return -1;
    }

    int rc = 0;
    int64_t remaining = n;
    int64_t savings = 0;  // running (consumed - produced), gates the splitter
    const uint8_t* ip = src;
    while (remaining > 0 && rc == 0) {
        const int64_t blockSize = zx_presplit(ip, remaining, blockSizeMax,
                                              (int)cp.strat, savings);
        const int lastBlock = blockSize == remaining;
        // ZSTD_window_enforceMaxDist with srcEnd = block start
        if (optc) {
            // the opt ctx owns the window (its base shifts on btultra2's
            // initStats pass, ZSTD_initStats_ultra:1362)
            const uint32_t blockStartIdx = (uint32_t)(ip - optc->base);
            if (blockStartIdx > (uint32_t)windowSize) {
                const uint32_t newLow = blockStartIdx - (uint32_t)windowSize;
                if (optc->dictLimit < newLow) optc->dictLimit = newLow;
            }
        } else {
            const uint32_t blockStartIdx = (uint32_t)(ip - base);
            if (blockStartIdx > (uint32_t)windowSize) {
                const uint32_t newLow = blockStartIdx - (uint32_t)windowSize;
                if (dictLimit < newLow) dictLimit = newLow;
            }
        }
        ZxEntropy* const prev = &ent[prevIdx];
        ZxEntropy* const next = &ent[prevIdx ^ 1];
        int64_t cSize;
        if (blockSize < 1 + 1 + 1 + 3 + 1) {
            cSize = 0;  // ZSTDbss_noCompress
        } else {
            // buildSeqStore: copy reps prev->next, parse updates next's
            next->repcodes[0] = prev->repcodes[0];
            next->repcodes[1] = prev->repcodes[1];
            next->repcodes[2] = prev->repcodes[2];
            ss.nlit = 0;
            ss.nseq = 0;
            ss.llt = 0;
            ss.lltPos = 0;
            if (prof_on()) g_prof[0] -= prof_now();
            int64_t lastLLSize;
            if (cp.strat >= 7) {
                const int64_t nseq =
                    zx_opt_parse(optc, ip, blockSize, next->repcodes, os_ll,
                                 os_ml, os_ob, opt_seq_cap, &lastLLSize);
                if (nseq < 0) { rc = -1; break; }
                if (prof_on()) g_prof[0] += prof_now();
                // The 1.5.7 oracle enables the block splitter at the
                // bt-optimal levels; emit through the exact splitter
                // (raw/RLE partitions allowed, dRep/cRep tracked).
                const int64_t t_ent2 = prof_on() ? prof_now() : 0;
                const int64_t em = zx_split_block_emit(
                    ip, blockSize, lastBlock, isFirstBlock, os_ll, os_ml,
                    os_ob, nseq, lastLLSize, ent, &prevIdx, (int)cp.strat,
                    out + op, cap - op);
                if (prof_on()) g_prof[1] += prof_now() - t_ent2;
                if (em < 0) { rc = -1; break; }
                op += em;
                savings += blockSize - em;
                ip += blockSize;
                remaining -= blockSize;
                isFirstBlock = 0;
                continue;
            } else if (cp.strat == 1) {
                const int hasStep = cp.tlen > 1;
                switch (cp.mml) {
                    case 5:
                        lastLLSize = hasStep
                            ? zx_fast_block<5, 1>(base, hashTable, cp.hlog,
                                                  dictLimit, cp.wlog, cp.tlen,
                                                  ip, blockSize,
                                                  next->repcodes, &ss)
                            : zx_fast_block<5, 0>(base, hashTable, cp.hlog,
                                                  dictLimit, cp.wlog, cp.tlen,
                                                  ip, blockSize,
                                                  next->repcodes, &ss);
                        break;
                    case 6:
                        lastLLSize = hasStep
                            ? zx_fast_block<6, 1>(base, hashTable, cp.hlog,
                                                  dictLimit, cp.wlog, cp.tlen,
                                                  ip, blockSize,
                                                  next->repcodes, &ss)
                            : zx_fast_block<6, 0>(base, hashTable, cp.hlog,
                                                  dictLimit, cp.wlog, cp.tlen,
                                                  ip, blockSize,
                                                  next->repcodes, &ss);
                        break;
                    case 7:
                        lastLLSize = hasStep
                            ? zx_fast_block<7, 1>(base, hashTable, cp.hlog,
                                                  dictLimit, cp.wlog, cp.tlen,
                                                  ip, blockSize,
                                                  next->repcodes, &ss)
                            : zx_fast_block<7, 0>(base, hashTable, cp.hlog,
                                                  dictLimit, cp.wlog, cp.tlen,
                                                  ip, blockSize,
                                                  next->repcodes, &ss);
                        break;
                    default:
                        lastLLSize = hasStep
                            ? zx_fast_block<4, 1>(base, hashTable, cp.hlog,
                                                  dictLimit, cp.wlog, cp.tlen,
                                                  ip, blockSize,
                                                  next->repcodes, &ss)
                            : zx_fast_block<4, 0>(base, hashTable, cp.hlog,
                                                  dictLimit, cp.wlog, cp.tlen,
                                                  ip, blockSize,
                                                  next->repcodes, &ss);
                        break;
                }
            } else {
                switch (cp.mml) {
                    case 5:
                        lastLLSize = zx_dfast_block<5, 0>(
                            base, hashTable, cp.hlog, chainTable, cp.clog,
                            dictLimit, cp.wlog, ip, blockSize, next->repcodes,
                            &ss);
                        break;
                    case 6:
                        lastLLSize = zx_dfast_block<6, 0>(
                            base, hashTable, cp.hlog, chainTable, cp.clog,
                            dictLimit, cp.wlog, ip, blockSize, next->repcodes,
                            &ss);
                        break;
                    case 7:
                        lastLLSize = zx_dfast_block<7, 0>(
                            base, hashTable, cp.hlog, chainTable, cp.clog,
                            dictLimit, cp.wlog, ip, blockSize, next->repcodes,
                            &ss);
                        break;
                    default:
                        lastLLSize = zx_dfast_block<4, 0>(
                            base, hashTable, cp.hlog, chainTable, cp.clog,
                            dictLimit, cp.wlog, ip, blockSize, next->repcodes,
                            &ss);
                        break;
                }
            }
            // last literals
            std::memcpy(ss.lit + ss.nlit, ip + blockSize - lastLLSize,
                        (size_t)lastLLSize);
            ss.nlit += lastLLSize;
            if (prof_on()) g_prof[0] += prof_now();

            // entropy stage (into op+3, leaving room for the block header)
            if (cap - op < blockSize + 32) { rc = -1; break; }
            const int64_t t_ent = prof_on() ? prof_now() : 0;
            cSize = zx_entropy_compress(&ss, prev, next, (int)cp.strat,
                                        out + op + 3, cap - op - 3 - 8,
                                        blockSize,
                                        cp.strat == 1 && cp.tlen > 0);
            if (prof_on()) g_prof[1] += prof_now() - t_ent;
            if (cSize < 0) { rc = -1; break; }
            if (cSize != 0) {
                // ZSTD_entropyCompressSeqStore:3357 bail-out
                const int64_t maxCSize =
                    blockSize - zx_min_gain(blockSize, (int)cp.strat);
                if (cSize >= maxCSize) cSize = 0;
            }
            // frameChunk RLE check (compressBlock_internal:4564)
            if (!isFirstBlock && cSize != 0 && cSize < 25 &&
                zx_is_rle(ip, blockSize)) {
                cSize = 1;
                out[op + 3] = ip[0];
            }
            if (cSize > 1) prevIdx ^= 1;  // confirm repcodes+entropy
        }
        // offcode repeat valid -> check on the (possibly swapped) prev
        if (ent[prevIdx].of.rep == 2) ent[prevIdx].of.rep = 1;

        // emit block
        if (cSize == 0) {
            // raw block
            if (cap - op < 3 + blockSize) { rc = -1; break; }
            const uint32_t bh =
                (uint32_t)(lastBlock + (0 << 1) + ((uint32_t)blockSize << 3));
            out[op] = (uint8_t)bh;
            out[op + 1] = (uint8_t)(bh >> 8);
            out[op + 2] = (uint8_t)(bh >> 16);
            std::memcpy(out + op + 3, ip, (size_t)blockSize);
            op += 3 + blockSize;
            savings -= 3;
        } else {
            const uint32_t bh =
                cSize == 1
                    ? (uint32_t)(lastBlock + (1u << 1) +
                                 ((uint32_t)blockSize << 3))
                    : (uint32_t)(lastBlock + (2u << 1) +
                                 ((uint32_t)cSize << 3));
            out[op] = (uint8_t)bh;
            out[op + 1] = (uint8_t)(bh >> 8);
            out[op + 2] = (uint8_t)(bh >> 16);
            op += 3 + cSize;
            savings += blockSize - (3 + cSize);
        }
        ip += blockSize;
        remaining -= blockSize;
        isFirstBlock = 0;
    }

    if (rc == 0 && checksum_flag) {
        if (cap - op < 4) {
            rc = -1;
        } else {
            const uint32_t c = (uint32_t)xxh64(src, n, 0);
            std::memcpy(out + op, &c, 4);
            op += 4;
        }
    }

    free(hashTable);
    free(chainTable);
    zx_opt_free(optc);
    free(os_ll);
    free(ss.lit);
    free(ss.seq);
    if (prof_on())
        fprintf(stderr,
                "zt_exact prof: parse %.1fms entropy %.1fms "
                "(lit %.1fms fsebits %.1fms)\n",
                g_prof[0] / 1e6, g_prof[1] / 1e6, g_prof[2] / 1e6,
                g_prof[3] / 1e6);
    return rc == 0 ? op : -1;
}

// ---------------------------------------------------------------------------
// Resumable streaming encoder (ZSTD_compressStream_generic role): the
// legacy driver's per-block machinery lifted into a persistent context so
// CompressionStream runs at native speed.  Frame header/checksum stay on
// the Python side; this emits block bytes only.  Unsupported shapes
// (dictionary, LDM, targetCBlockSize) stay on the Python tier.
// ---------------------------------------------------------------------------

struct EStreamC {
    int strategy, hlog, clog, slog, wlog, mls, accel;
    int use_row, row_log, fast_hlog;
    int64_t block_size;
    uint8_t* buf;
    int64_t cap, filled, emitted;
    int64_t* table;       // 64-bit hash heads (fast/dfast-long/lazy/bt/opt)
    uint32_t* table32;    // compact fast path (pos+1)
    int64_t* chain;       // hash chains / dfast short table
    uint32_t* row_pos;    // [rows][16] pos+1
    uint8_t* row_tags;
    uint8_t* row_heads;
    int32_t* bt;          // DUBT links (strat >= 6)
    int64_t* h3;          // 3-byte heads (opt)
    OptStats* ost;
    int64_t insert_from;
    int64_t savings;
    uint32_t rep[3];
    ZxEntropy ents[2];
    ZxEntropy ent_snap;
    int ent_prev;
    uint32_t* s_ll;       // seq scratch (ll/ml/ob)
    int64_t max_seq_cap;
    int last_sent;
    // targetCBlockSize (superblock emission) — 0 off
    int64_t tcbs;
    // long-distance matcher state (persists across feeds; positions are
    // buffer offsets, rebased on trim like every other table)
    int ldm_on;
    int64_t* ldm_buckets;
    int ldm_hlog;
    LdmMatch* ldm;
    int64_t ldm_cap, n_ldm, ldm_cursor, ldm_scanned;
};

void* zt_estream_new2(int strategy, int hash_log, int chain_log,
                      int search_log, int window_log, int min_match,
                      int accel, int64_t tcbs, int ldm_on) {
    if (strategy < 1 || strategy > 9) return nullptr;
    codec_init();
    EStreamC* c = (EStreamC*)calloc(1, sizeof(EStreamC));
    if (!c) return nullptr;
    c->strategy = strategy;
    c->hlog = hash_log;
    c->clog = chain_log;
    c->slog = search_log;
    c->wlog = window_log;
    c->mls = min_match < 4 ? 4 : (min_match > 8 ? 8 : min_match);
    c->accel = accel < 1 ? 1 : accel;
    c->block_size = (1 << 17) < (1LL << window_log) ? (1 << 17)
                                                    : (1LL << window_log);
    c->cap = (1LL << window_log) + 4 * c->block_size + (1 << 16);
    c->buf = (uint8_t*)malloc((size_t)c->cap);
    c->rep[0] = 1; c->rep[1] = 4; c->rep[2] = 8;
    c->max_seq_cap = c->block_size / 3 + 16;
    c->s_ll = (uint32_t*)malloc((size_t)c->max_seq_cap * 12);
    bool ok = c->buf && c->s_ll;
    c->tcbs = tcbs > 0 ? tcbs : 0;
    c->ldm_on = ldm_on ? 1 : 0;
    if (c->ldm_on) {
        c->ldm_hlog = 20;
        c->ldm_buckets = (int64_t*)malloc(((size_t)4 << c->ldm_hlog) * 8);
        c->ldm_cap = 4096;
        c->ldm = (LdmMatch*)malloc((size_t)c->ldm_cap * sizeof(LdmMatch));
        ok = ok && c->ldm_buckets && c->ldm;
        if (c->ldm_buckets)
            std::memset(c->ldm_buckets, 0xFF, ((size_t)4 << c->ldm_hlog) * 8);
    }
    // routing mirrors compress_frame_body_ldm_c
    const bool l2_shape = strategy == 1 && hash_log >= 15 && c->accel <= 1;
    c->use_row = (l2_shape || (strategy >= 2 && strategy <= 5)) &&
                 window_log >= 14 && search_log <= 5;
    c->fast_hlog = strategy <= 1 && hash_log < 16 ? 16 : hash_log;
    if (c->use_row) {
        c->row_log = hash_log - 4;
        if (c->row_log < 8) c->row_log = 8;
        if (c->row_log > 21) c->row_log = 21;
        const int64_t nr = 1LL << c->row_log;
        c->row_pos = (uint32_t*)calloc((size_t)nr * 16, 4);
        c->row_tags = (uint8_t*)calloc((size_t)nr * 16, 1);
        c->row_heads = (uint8_t*)calloc((size_t)nr, 1);
        ok = ok && c->row_pos && c->row_tags && c->row_heads;
    } else if (strategy <= 1 && !l2_shape) {
        c->table32 = (uint32_t*)calloc((size_t)1 << c->fast_hlog, 4);
        ok = ok && c->table32;
    }
    if (!c->use_row || strategy >= 6) {
        c->table = (int64_t*)malloc(((size_t)1 << hash_log) * 8);
        ok = ok && c->table;
        if (c->table)  // -1 is all-ones: memset rides the fast fill path
            std::memset(c->table, 0xFF, ((size_t)1 << hash_log) * 8);
    }
    if (!c->use_row && strategy >= 2 && strategy < 6) {
        c->chain = (int64_t*)malloc(((size_t)1 << chain_log) * 8);
        ok = ok && c->chain;
        if (c->chain)
            std::memset(c->chain, 0xFF, ((size_t)1 << chain_log) * 8);
    }
    if (strategy >= 6) {
        c->bt = (int32_t*)malloc(((size_t)2 << chain_log) * 4);
        ok = ok && c->bt;
        if (c->bt) std::memset(c->bt, 0xFF, ((size_t)2 << chain_log) * 4);
    }
    if (strategy >= 7) {
        c->h3 = (int64_t*)malloc(((size_t)1 << 16) * 8);
        c->ost = (OptStats*)malloc(sizeof(OptStats));
        ok = ok && c->h3 && c->ost;
        if (c->h3)
            std::memset(c->h3, 0xFF, ((size_t)1 << 16) * 8);
        if (c->ost) opt_seed_default(c->ost);
    }
    if (!ok) {
        free(c->buf); free(c->s_ll); free(c->table); free(c->table32);
        free(c->chain); free(c->row_pos); free(c->row_tags);
        free(c->row_heads); free(c->bt); free(c->h3); free(c->ost);
        free(c->ldm_buckets); free(c->ldm);
        free(c);
        return nullptr;
    }
    return c;
}

void* zt_estream_new(int strategy, int hash_log, int chain_log,
                     int search_log, int window_log, int min_match,
                     int accel) {
    return zt_estream_new2(strategy, hash_log, chain_log, search_log,
                           window_log, min_match, accel, 0, 0);
}

// Load a zstd dictionary into a fresh stream context: the content
// becomes match history (prefix semantics, ZSTD_CCtx_refPrefix +
// entropy/repcode seeding of ZSTD_compress_insertDictionary:4517), the
// matcher tables are prefilled (dtlm_full role: explicit inserts for the
// direct-hash matchers, lazy insert_from replay for chained/tree ones),
// and the repeat-mode entropy starts from the dictionary tables.
int64_t zt_estream_preload(void* h, const uint8_t* dict, int64_t dlen) {
    EStreamC* c = (EStreamC*)h;
    if (!c || c->filled != 0 || c->last_sent || dlen <= 0) return -1;
    EncEntropyC enc;
    enc_entropy_reset(&enc);
    uint32_t rep[3] = {1, 4, 8};
    const int64_t off = dict_parse_common(dict, dlen, &enc, nullptr, rep);
    if (off < 0) return -1;
    const uint8_t* content = dict + off;
    int64_t clen = dlen - off;
    const int64_t wsize = 1LL << c->wlog;
    if (clen > wsize) {  // only the last window of content can ever match
        content += clen - wsize;
        clen = wsize;
    }
    if (clen > c->cap) return -1;
    std::memcpy(c->buf, content, (size_t)clen);
    c->filled = clen;
    c->emitted = clen;
    c->insert_from = 0;
    c->rep[0] = rep[0]; c->rep[1] = rep[1]; c->rep[2] = rep[2];
    if (off > 0) {
        // entropy repeat-mode seed (HUF_repeat_check class: the emitters
        // re-validate coverage before referencing the dict tables)
        ZxEntropy* e = &c->ents[c->ent_prev];
        e->huf.ct = enc.huf;
        e->huf.rep = 1;
        e->ll.ct = enc.ll_ct; e->ll.maxSym = enc.ll_max; e->ll.rep = 1;
        e->of.ct = enc.of_ct; e->of.maxSym = enc.of_max; e->of.rep = 1;
        e->ml.ct = enc.ml_ct; e->ml.maxSym = enc.ml_max; e->ml.rep = 1;
        e->repcodes[0] = rep[0]; e->repcodes[1] = rep[1];
        e->repcodes[2] = rep[2];
    }
    // direct-hash matcher tables have no lazy-insert replay: fill now
    if (c->table32) {
        for (int64_t i = 0; i + 8 <= clen; i++)
            c->table32[hash_mls(c->buf + i, c->fast_hlog, c->mls)] =
                (uint32_t)(i + 1);
        c->insert_from = clen;
    } else if (c->strategy == 2 && !c->use_row && c->table && c->chain) {
        for (int64_t i = 0; i + 8 <= clen; i++) {
            c->table[hash64(read64(c->buf + i), c->hlog)] = i;
            c->chain[hash_mls(c->buf + i, c->clog, c->mls)] = i;
        }
        c->insert_from = clen;
    } else if (c->strategy <= 2 && !c->use_row && c->table) {
        for (int64_t i = 0; i + 8 <= clen; i++)
            c->table[hash_mls(c->buf + i, c->hlog, c->mls)] = i;
        c->insert_from = clen;
    }
    if (c->ldm_on)  // warm buckets over the prefix (no match emission)
        (void)ldm_scan(c->buf, 0, clen, 0, c->ldm_buckets, c->ldm_hlog, 7,
                       64, c->ldm, 0), c->ldm_scanned = clen;
    return clen;
}

int64_t zt_estream_pending(void* h) {
    EStreamC* c = (EStreamC*)h;
    return c ? c->filled - c->emitted : -1;
}

int64_t zt_estream_bufcap(void* h) {
    EStreamC* c = (EStreamC*)h;
    return c ? c->cap : -1;  // O(window) invariant observable from tests
}

void zt_estream_free(void* h) {
    if (!h) return;
    EStreamC* c = (EStreamC*)h;
    free(c->buf); free(c->s_ll); free(c->table); free(c->table32);
    free(c->chain); free(c->row_pos); free(c->row_tags); free(c->row_heads);
    free(c->bt); free(c->h3); free(c->ost);
    free(c->ldm_buckets); free(c->ldm);
    free(c);
}

// Round-buffer discipline: once the compressed prefix exceeds
// window + block slack, slide the buffer and rebase every stored position.
// Chain/bt tables index by pos & (size-1), so the slide amount is a
// multiple of the chain size; bt/opt state instead resets (cheap, rare).
static void estream_trim(EStreamC* c) {
    const int64_t keep = (1LL << c->wlog) + c->block_size;
    int64_t unit = c->block_size;
    if (c->chain) unit = unit > (1LL << c->clog) ? unit : (1LL << c->clog);
    const int64_t excess = c->emitted - keep;
    if (excess < unit) return;
    const int64_t delta = (excess / unit) * unit;
    std::memmove(c->buf, c->buf + delta, (size_t)(c->filled - delta));
    c->filled -= delta;
    c->emitted -= delta;
    c->insert_from = c->insert_from > delta ? c->insert_from - delta : 0;
    if (c->table)
        for (int64_t i = 0; i < (1LL << c->hlog); i++)
            c->table[i] = c->table[i] >= delta ? c->table[i] - delta : -1;
    if (c->chain)
        for (int64_t i = 0; i < (1LL << c->clog); i++)
            c->chain[i] = c->chain[i] >= delta ? c->chain[i] - delta : -1;
    if (c->table32)
        for (int64_t i = 0; i < (1LL << c->fast_hlog); i++)
            c->table32[i] = c->table32[i] > (uint32_t)delta
                                ? c->table32[i] - (uint32_t)delta : 0;
    if (c->row_pos) {
        const int64_t n = (1LL << c->row_log) * 16;
        for (int64_t i = 0; i < n; i++)
            c->row_pos[i] = c->row_pos[i] > (uint32_t)delta
                                ? c->row_pos[i] - (uint32_t)delta : 0;
    }
    if (c->bt) {  // positions are ambiguous after a slide: start fresh
        std::memset(c->bt, 0xFF, ((size_t)2 << c->clog) * 4);
        if (c->table)
            std::memset(c->table, 0xFF, ((size_t)1 << c->hlog) * 8);
        if (c->h3)
            std::memset(c->h3, 0xFF, ((size_t)1 << 16) * 8);
        c->insert_from = c->emitted;
    }
    if (c->ldm_on) {
        for (int64_t i = 0; i < (4LL << c->ldm_hlog); i++)
            c->ldm_buckets[i] =
                c->ldm_buckets[i] >= delta ? c->ldm_buckets[i] - delta : -1;
        // compact pending matches (consumed ones drop, the rest rebase)
        int64_t w = 0;
        for (int64_t i = c->ldm_cursor; i < c->n_ldm; i++) {
            if (c->ldm[i].pos + c->ldm[i].len <= delta) continue;
            LdmMatch m = c->ldm[i];
            if (m.pos < delta) {
                m.len -= delta - m.pos;
                m.pos = delta;
            }
            m.pos -= delta;
            // matches whose source slid out of the buffer are dropped
            if (m.pos - m.dist < 0) continue;
            c->ldm[w++] = m;
        }
        c->n_ldm = w;
        c->ldm_cursor = 0;
        c->ldm_scanned = c->ldm_scanned > delta ? c->ldm_scanned - delta : 0;
    }
}

// One matcher dispatch over [from, to) of the stream buffer (the same
// strategy routing as the one-shot drivers).  allow_seed enables the
// btultra2 first-block re-parse; gap parses inside the LDM merge must
// not rewind tables mid-block.
static int64_t estream_parse(EStreamC* c, int64_t from, int64_t to,
                             uint32_t* s_ll, uint32_t* s_ml, uint32_t* s_ob,
                             int64_t budget, int64_t* last_lit,
                             int allow_seed) {
    const uint8_t* src = c->buf;
    const int64_t n = c->filled;
    const int64_t wsize = 1LL << c->wlog;
    int64_t n_seq;
    if (c->strategy >= 7) {
        const uint32_t rep_in[3] = {c->rep[0], c->rep[1], c->rep[2]};
        n_seq = opt_find_matches(src, n, from, to, 0, wsize, c->table,
                                 c->hlog, c->bt, 1LL << c->clog,
                                 1LL << c->slog, c->h3, 16, c->mls,
                                 &c->insert_from, c->rep, c->ost, s_ll, s_ml,
                                 s_ob, budget, last_lit);
        if (allow_seed && n_seq > 0 && !c->ost->inited) {
            // btultra2 first-block seeding (ZSTD_initStats_ultra role)
            opt_update_stats(c->ost, s_ll, s_ml, s_ob, n_seq, false);
            c->rep[0] = rep_in[0]; c->rep[1] = rep_in[1];
            c->rep[2] = rep_in[2];
            std::memset(c->table, 0xFF, ((size_t)1 << c->hlog) * 8);
            std::memset(c->bt, 0xFF, ((size_t)2 << c->clog) * 4);
            std::memset(c->h3, 0xFF, ((size_t)1 << 16) * 8);
            c->insert_from = from;
            n_seq = opt_find_matches(src, n, from, to, 0, wsize, c->table,
                                     c->hlog, c->bt, 1LL << c->clog,
                                     1LL << c->slog, c->h3, 16, c->mls,
                                     &c->insert_from, c->rep, c->ost, s_ll,
                                     s_ml, s_ob, budget, last_lit);
        }
        if (allow_seed && n_seq >= 0)
            opt_update_stats(c->ost, s_ll, s_ml, s_ob, n_seq, true);
    } else if (c->strategy == 6) {
        n_seq = btlazy_find_matches(src, n, from, to, 0, wsize, c->table,
                                    c->hlog, c->bt, 1LL << c->clog,
                                    2LL << c->slog, 2, &c->insert_from,
                                    c->rep, s_ll, s_ml, s_ob, budget,
                                    last_lit);
    } else if (c->use_row) {
        const int depth =
            c->strategy >= 5 ? 2 : (c->strategy >= 3 ? c->strategy - 3 : 0);
        const int64_t att = c->strategy <= 2 ? 4 : 1LL << c->slog;
        n_seq = row_lazy_find_matches(src, n, from, to, 0, wsize, c->row_pos,
                                      c->row_tags, c->row_heads, c->row_log,
                                      c->mls, att, depth, &c->insert_from,
                                      c->rep, s_ll, s_ml, s_ob,
                                      budget, last_lit);
    } else if (c->strategy == 2) {
        n_seq = dfast_find_matches(src, n, from, to, 0, wsize, c->table,
                                   c->hlog, c->chain, c->clog, c->mls,
                                   c->rep, s_ll, s_ml, s_ob, budget,
                                   last_lit);
    } else if (c->strategy <= 1 && c->table32) {
        n_seq = fast_find_matches32(src, n, from, to, 0, wsize, c->table32,
                                    c->fast_hlog, c->mls, c->rep, s_ll, s_ml,
                                    s_ob, budget, last_lit,
                                    c->accel);
    } else if (c->strategy <= 2) {
        n_seq = fast_find_matches(src, n, from, to, 0, wsize, c->table,
                                  c->hlog, c->mls, c->rep, s_ll, s_ml, s_ob,
                                  budget, last_lit, c->accel);
    } else {
        const int depth = c->strategy >= 5 ? 2 : c->strategy - 3;
        n_seq = lazy_find_matches(src, n, from, to, 0, wsize, c->table,
                                  c->hlog, c->chain, 1LL << c->clog,
                                  1LL << c->slog, depth, &c->insert_from,
                                  c->rep, s_ll, s_ml, s_ob, budget,
                                  last_lit, c->mls);
    }
    return n_seq;
}

// Compress one block [pos, end) of c->buf into out; returns bytes written.
static int64_t estream_block(EStreamC* c, int64_t pos, int64_t end, int last,
                             uint8_t* out, int64_t cap) {
    const int64_t bn = end - pos;
    if (cap < 3 + bn + 32) return -1;
    uint32_t rep_snap[3] = {c->rep[0], c->rep[1], c->rep[2]};
    c->ent_snap = c->ents[c->ent_prev];
    bool all_same = bn > 1;
    for (int64_t i = pos + 1; i < end && all_same; i++)
        if (c->buf[i] != c->buf[pos]) all_same = false;
    if (all_same) {
        const uint32_t bh = (uint32_t)(last | (1 << 1) | (bn << 3));
        out[0] = (uint8_t)bh; out[1] = (uint8_t)(bh >> 8);
        out[2] = (uint8_t)(bh >> 16);
        out[3] = c->buf[pos];
        c->insert_from = end;
        return 4;
    }
    const uint8_t* src = c->buf;
    uint32_t* s_ll = c->s_ll;
    uint32_t* s_ml = s_ll + c->max_seq_cap;
    uint32_t* s_ob = s_ml + c->max_seq_cap;
    int64_t last_lit = 0;
    int64_t n_seq;
    if (c->ldm_on) {
        // LDM merge: [gap parse][ldm seq]... (ZSTD_ldm_blockCompress:761
        // role, same shape as the one-shot driver)
        n_seq = 0;
        int64_t cursor = pos;
        while (c->ldm_cursor < c->n_ldm && n_seq + 4 < c->max_seq_cap) {
            LdmMatch m = c->ldm[c->ldm_cursor];
            if (m.pos + m.len <= cursor || m.dist >= (1LL << c->wlog)) {
                c->ldm_cursor++;
                continue;
            }
            if (m.pos < cursor) {
                const int64_t trim = cursor - m.pos;
                m.pos += trim;
                m.len -= trim;
            }
            if (m.pos >= end) break;
            const int64_t take = m.len < end - m.pos ? m.len : end - m.pos;
            if (take < 4) break;
            int64_t gl = 0;
            if (m.pos > cursor) {
                int64_t k = estream_parse(c, cursor, m.pos, s_ll + n_seq,
                                          s_ml + n_seq, s_ob + n_seq,
                                          c->max_seq_cap - n_seq - 2, &gl, 0);
                if (k < 0) { n_seq = -1; break; }
                n_seq += k;
            }
            s_ll[n_seq] = (uint32_t)gl;
            s_ml[n_seq] = (uint32_t)take;
            s_ob[n_seq] = (uint32_t)(m.dist + 3);
            c->rep[2] = c->rep[1]; c->rep[1] = c->rep[0];
            c->rep[0] = (uint32_t)m.dist;
            n_seq++;
            cursor = m.pos + take;
            if (c->insert_from < cursor) c->insert_from = cursor;
            if (take < m.len) {
                c->ldm[c->ldm_cursor].pos = m.pos + take;
                c->ldm[c->ldm_cursor].len = m.len - take;
                break;
            }
            c->ldm_cursor++;
        }
        if (n_seq >= 0) {
            int64_t gl = end - cursor;
            if (cursor < end - 16) {
                int64_t k = estream_parse(c, cursor, end, s_ll + n_seq,
                                          s_ml + n_seq, s_ob + n_seq,
                                          c->max_seq_cap - n_seq, &gl, 0);
                if (k < 0) n_seq = -1;
                else n_seq += k;
            }
            last_lit = gl;
        }
        if (n_seq > 0 && c->ost)
            opt_update_stats(c->ost, s_ll, s_ml, s_ob, n_seq, true);
    } else {
        n_seq = estream_parse(c, pos, end, s_ll, s_ml, s_ob, c->max_seq_cap,
                              &last_lit, 1);
    }
    if (n_seq < 0) return -1;
    // targetCBlockSize: superblock emission — sub-blocks sharing one
    // entropy table set (ZSTD_compressSuperBlock role)
    if (c->tcbs > 0) {
        ZxEntropy* const sb_prev = &c->ents[c->ent_prev];
        ZxEntropy* const sb_next = &c->ents[c->ent_prev ^ 1];
        std::memcpy(sb_next->repcodes, c->rep, 12);
        const int64_t em = zx_superblock_from_arrays(
            src + pos, bn, s_ll, s_ml, s_ob, n_seq, last_lit, sb_prev,
            sb_next, c->strategy, c->tcbs, last, rep_snap, out, cap - 8);
        if (em < 0) return -1;
        if (em > 0 && em < bn - zx_min_gain(bn, c->strategy) + 3) {
            c->rep[0] = sb_next->repcodes[0];
            c->rep[1] = sb_next->repcodes[1];
            c->rep[2] = sb_next->repcodes[2];
            c->ent_prev ^= 1;
            return em;
        }
        // superblock not formed: raw block (reference fallback)
        c->rep[0] = rep_snap[0]; c->rep[1] = rep_snap[1];
        c->rep[2] = rep_snap[2];
        c->ents[c->ent_prev] = c->ent_snap;
        const uint32_t bh = (uint32_t)(last | (0 << 1) | (bn << 3));
        out[0] = (uint8_t)bh; out[1] = (uint8_t)(bh >> 8);
        out[2] = (uint8_t)(bh >> 16);
        std::memcpy(out + 3, src + pos, (size_t)bn);
        return 3 + bn;
    }
    // bt-level block split (same auto rule as the one-shot drivers):
    // partitions with homogeneous statistics beat one mixed block
    if (c->strategy >= 7 && n_seq >= 600) {
        int64_t bounds[200];
        int nb = 0;
        int64_t* seq_start = (int64_t*)malloc((size_t)(n_seq + 1) * 8);
        if (seq_start) {
            int64_t cur = 0;
            for (int64_t i2 = 0; i2 < n_seq; i2++) {
                seq_start[i2] = cur;
                cur += s_ll[i2] + s_ml[i2];
            }
            seq_start[n_seq] = cur;
            SplitView v{src + pos, s_ll, s_ml, s_ob, n_seq, last_lit, bn,
                        seq_start};
            split_derive(&v, 0, n_seq, bounds, &nb, 0);
            if (nb > 1) {
                int64_t a = 0, op2 = 0;
                bool fail = false;
                for (int k = 0; k < nb && !fail; k++) {
                    const int64_t b2 = bounds[k];
                    const int64_t pa = seq_start[a];
                    const int64_t pb = k == nb - 1 ? bn : seq_start[b2];
                    const int64_t pbn = pb - pa;
                    const int64_t plast = k == nb - 1 ? last_lit : 0;
                    const int plast_flag = last && k == nb - 1;
                    if (op2 + 3 + pbn + 32 > cap) { fail = true; break; }
                    const int64_t pbody = zx_block_from_arrays(
                        src + pos + pa, pbn, s_ll + a, s_ml + a, s_ob + a,
                        b2 - a, plast, &c->ents[c->ent_prev],
                        &c->ents[c->ent_prev ^ 1], c->strategy,
                        out + op2 + 3, cap - op2 - 3 - 8);
                    if (pbody < 0) { fail = true; break; }
                    c->ent_prev ^= 1;
                    const uint32_t bh = (uint32_t)(plast_flag | (2 << 1) |
                                                   ((uint32_t)pbody << 3));
                    out[op2] = (uint8_t)bh;
                    out[op2 + 1] = (uint8_t)(bh >> 8);
                    out[op2 + 2] = (uint8_t)(bh >> 16);
                    op2 += 3 + pbody;
                    a = b2;
                }
                free(seq_start);
                if (!fail) return op2;
                // abandoned split: restore the CURRENT entropy side to the
                // pre-block snapshot (repcodes stay post-parse — the
                // single-block emission below reuses the same sequences)
                c->ents[c->ent_prev] = c->ent_snap;
            } else {
                free(seq_start);
            }
        }
    }
    ZxEntropy* const prev = &c->ents[c->ent_prev];
    ZxEntropy* const next = &c->ents[c->ent_prev ^ 1];
    const int64_t body = zx_block_from_arrays(src + pos, bn, s_ll, s_ml,
                                              s_ob, n_seq, last_lit, prev,
                                              next, c->strategy, out + 3,
                                              cap - 3 - 8);
    if (body < 0) {
        c->rep[0] = rep_snap[0]; c->rep[1] = rep_snap[1];
        c->rep[2] = rep_snap[2];
        c->ents[c->ent_prev] = c->ent_snap;
        const uint32_t bh = (uint32_t)(last | (0 << 1) | (bn << 3));
        out[0] = (uint8_t)bh; out[1] = (uint8_t)(bh >> 8);
        out[2] = (uint8_t)(bh >> 16);
        std::memcpy(out + 3, src + pos, (size_t)bn);
        return 3 + bn;
    }
    c->ent_prev ^= 1;
    const uint32_t bh = (uint32_t)(last | (2 << 1) | ((uint32_t)body << 3));
    out[0] = (uint8_t)bh; out[1] = (uint8_t)(bh >> 8);
    out[2] = (uint8_t)(bh >> 16);
    return 3 + body;
}

// ---------------------------------------------------------------------------
// Resumable streaming decoder: persistent entropy state + scratch for the
// Python stage machine's per-block decode, so DecompressionStream runs at
// engine speed.  The output window buffer stays on the Python side (its
// slide/rebase discipline is already there).
// ---------------------------------------------------------------------------

struct DStreamC {
    EntropyStateC ent;
    uint8_t* lit_buf;
    uint32_t* seq_buf;
    uint8_t* pad;       // 16-byte-prefixed copy of the block payload
    int64_t pad_cap;
};

void* zt_dstream_new(void) {
    codec_init();
    DStreamC* c = (DStreamC*)malloc(sizeof(DStreamC));
    if (!c) return nullptr;
    c->ent.huf.valid = false;
    c->ent.ll_valid = c->ent.of_valid = c->ent.ml_valid = false;
    c->ent.ll_src = c->ent.of_src = c->ent.ml_src = 0;
    c->ent.rep[0] = 1; c->ent.rep[1] = 4; c->ent.rep[2] = 8;
    const int64_t max_seq = (1 << 17) / 3 + 16;
    c->lit_buf = (uint8_t*)malloc((1 << 17) + 64);
    c->seq_buf = (uint32_t*)malloc((size_t)max_seq * 12);
    c->pad_cap = (1 << 17) + 64;
    c->pad = (uint8_t*)malloc((size_t)c->pad_cap + 24);
    if (!c->lit_buf || !c->seq_buf || !c->pad) {
        free(c->lit_buf); free(c->seq_buf); free(c->pad); free(c);
        return nullptr;
    }
    std::memset(c->pad, 0, 16);
    return c;
}

void zt_dstream_free(void* h) {
    if (!h) return;
    DStreamC* c = (DStreamC*)h;
    free(c->lit_buf); free(c->seq_buf); free(c->pad);
    free(c);
}

// Decode one compressed block into out at out_pos (history below it is
// valid match window from prefix_start).  Returns the new out_pos, or a
// negative error.
int64_t zt_dstream_block(void* h, const uint8_t* src, int64_t n,
                         uint8_t* out, int64_t out_pos, int64_t out_cap,
                         int64_t prefix_start) {
    DStreamC* c = (DStreamC*)h;
    if (!c || n < 0 || n > c->pad_cap) return -1;
    std::memcpy(c->pad + 16, src, (size_t)n);
    const int64_t max_seq = (1 << 17) / 3 + 16;
    return decode_block_c(c->pad + 16, n, &c->ent, out, out_pos, out_cap,
                          prefix_start, c->lit_buf, c->seq_buf, max_seq);
}

// Drain every COMPLETE block (header + body) from src in one call: walks
// block headers like the frame loop, decodes raw/RLE/compressed blocks,
// and stops cleanly at a partial tail or after the last-flag block.
// Writes consumed input bytes to *consumed and 1 to *saw_last when the
// final block was processed.  Returns the new out_pos (possibly needing a
// larger `out`: stops early when fewer than 128KB of room remain) or a
// negative error.
int64_t zt_dstream_drain(void* h, const uint8_t* src, int64_t n,
                         uint8_t* out, int64_t out_pos, int64_t out_cap,
                         int64_t prefix_start, int64_t* consumed,
                         int* saw_last) {
    DStreamC* c = (DStreamC*)h;
    if (!c) return -1;
    int64_t pos = 0;
    *saw_last = 0;
    const int64_t max_seq = (1 << 17) / 3 + 16;
    while (n - pos >= 3 && !*saw_last) {
        const uint32_t bh = (uint32_t)src[pos] | ((uint32_t)src[pos + 1] << 8)
                            | ((uint32_t)src[pos + 2] << 16);
        const int last = bh & 1;
        const int btype = (bh >> 1) & 3;
        const int64_t bsize = bh >> 3;
        if (btype == 3) return -2;            // reserved
        if (bsize > (1 << 17)) return -2;     // Block_Maximum_Size bound
        const int64_t need = btype == 1 ? 1 : bsize;
        if (n - pos - 3 < need) break;           // partial body: wait
        if (out_pos + (btype == 2 ? (1 << 17) : bsize) > out_cap)
            break;                               // caller must grow out
        if (btype == 0) {
            std::memcpy(out + out_pos, src + pos + 3, (size_t)bsize);
            out_pos += bsize;
        } else if (btype == 1) {
            std::memset(out + out_pos, src[pos + 3], (size_t)bsize);
            out_pos += bsize;
        } else {
            if (bsize > c->pad_cap) return -1;
            std::memcpy(c->pad + 16, src + pos + 3, (size_t)bsize);
            const int64_t r = decode_block_c(c->pad + 16, bsize, &c->ent,
                                             out, out_pos, out_cap,
                                             prefix_start, c->lit_buf,
                                             c->seq_buf, max_seq);
            if (r < 0) return -3;
            out_pos = r;
        }
        pos += 3 + need;
        if (last) *saw_last = 1;
    }
    *consumed = pos;
    return out_pos;
}

// mode: 0 = accumulate (compress only full blocks), 1 = flush (also emit
// the partial tail as a non-last block), 2 = end (emit everything; the
// final block carries the last flag, an empty raw block if nothing is
// pending).  Returns bytes written to out, or -1.
int64_t zt_estream_feed(void* h, const uint8_t* src, int64_t n, int mode,
                        uint8_t* out, int64_t cap) {
    EStreamC* c = (EStreamC*)h;
    if (!c || c->last_sent) return -1;
    if (n > 0) {
        while (c->filled + n > c->cap) {
            estream_trim(c);
            if (c->filled + n <= c->cap) break;
            const int64_t ncap = (c->filled + n) + (c->cap >> 1);
            uint8_t* nb = (uint8_t*)realloc(c->buf, (size_t)ncap);
            if (!nb) return -1;
            c->buf = nb;
            c->cap = ncap;
            break;
        }
        std::memcpy(c->buf + c->filled, src, (size_t)n);
        c->filled += n;
    }
    if (c->ldm_on && c->filled > c->ldm_scanned) {
        // Incremental long-distance scan of the new bytes.  Each segment
        // starts the gear hash cold, so anchors within the first ~64
        // bytes of a feed boundary can be missed — a bounded ratio cost
        // of streaming (the buckets and matches persist and are rebased
        // with the buffer).
        const int64_t need = c->n_ldm + (c->filled - c->ldm_scanned) / 64 + 8;
        if (need > c->ldm_cap) {
            int64_t ncap = c->ldm_cap * 2 > need ? c->ldm_cap * 2 : need;
            LdmMatch* nl =
                (LdmMatch*)realloc(c->ldm, (size_t)ncap * sizeof(LdmMatch));
            if (!nl) return -1;
            c->ldm = nl;
            c->ldm_cap = ncap;
        }
        const int64_t k = ldm_scan(c->buf, c->ldm_scanned, c->filled, 0,
                                   c->ldm_buckets, c->ldm_hlog, 7, 64,
                                   c->ldm + c->n_ldm, c->ldm_cap - c->n_ldm);
        if (k > 0) c->n_ldm += k;
        c->ldm_scanned = c->filled;
    }
    int64_t op = 0;
    for (;;) {
        const int64_t avail = c->filled - c->emitted;
        if (avail <= 0) break;
        if (avail < c->block_size && mode == 0) break;
        // content-adaptive boundary needs the full lookahead window; with a
        // partial tail (flush/end) just take what is there
        const int64_t bsize =
            avail >= c->block_size
                ? zx_presplit(c->buf + c->emitted, avail, c->block_size,
                              c->strategy, c->savings)
                : avail;
        const int last = mode == 2 && bsize == avail;
        const int64_t w = estream_block(c, c->emitted, c->emitted + bsize,
                                        last, out + op, cap - op);
        if (w < 0) return -1;
        c->savings += bsize - w;
        op += w;
        c->emitted += bsize;
        if (last) c->last_sent = 1;
        if (mode == 0 && c->filled - c->emitted < c->block_size) break;
    }
    if (mode == 2 && !c->last_sent) {
        if (cap - op < 3) return -1;
        out[op] = 1; out[op + 1] = 0; out[op + 2] = 0;  // empty raw last
        op += 3;
        c->last_sent = 1;
    }
    estream_trim(c);
    return op;
}

// ---------------------------------------------------------------------------
// Device-plane batch planner (decode/device_pipeline.py host pass in native
// code).  The Python plan + prepare_batch pair measured ~850ms per 256-frame
// batch — 99% of steady-state device-decode time (the Pallas kernels run in
// single-digit ms).  This section packs the per-lane device operands
// (Huffman canonical tables + bit planes, coded FSE tables, stream words)
// straight into caller-owned numpy buffers, one frame per call.
//
// Scope: single-block no-dictionary frames (the record-batch deployment
// shape).  Everything else returns a routing code and the Python planner
// keeps its existing behavior (multi-block dependent rounds, dict frames,
// oversized sections).  Mirrors plan_batch's envelope rules exactly.
// ---------------------------------------------------------------------------

struct ZtDPlaneCtx {
    // scalars first (all int64 so the ctypes mirror is trivial)
    int64_t pool_cap, pool_off;
    int64_t huf_cap, n_huf;
    int64_t fse_cap, n_fse;
    int64_t huf_maxw, fse_maxw;   // word rows per lane column
    int64_t s_cap;                // device max sequences per lane
    int64_t huf_wmax, fse_wmax;   // running max used words (outputs)
    int64_t max_seq, max_out;     // running maxima (outputs)
    // All per-lane arrays are LANE-MAJOR (one contiguous row per lane):
    // a batch of N frames packs with ~N sequential memcpys instead of
    // millions of cap-strided stores (measured 56ms -> ~4ms per 256-frame
    // plan), and the device transposes into kernel layout (HBM-rate).
    uint8_t* raw_pool;
    uint32_t* huf_words;          // [huf_cap, huf_maxw]
    int32_t* huf_limits;          // [huf_cap, 16]
    int32_t* huf_bases;           // [huf_cap, 16]
    int32_t* huf_offs;            // [huf_cap, 16]
    int32_t* huf_shifts;          // [huf_cap, 16]
    int32_t* huf_planes;          // [huf_cap, 64]
    int32_t* huf_pos;             // [huf_cap]
    int32_t* huf_nsym;            // [huf_cap]
    int32_t* huf_wlen;            // [huf_cap]
    uint32_t* fse_words;          // [fse_cap, fse_maxw]
    int32_t* fse_ll;              // [fse_cap, 512]
    int32_t* fse_of;              // [fse_cap, 256]
    int32_t* fse_ml;              // [fse_cap, 512]
    int32_t* fse_logs;            // [fse_cap, 3]
    int32_t* fse_pos;             // [fse_cap]
    int32_t* fse_rep;             // [fse_cap, 3]
    int32_t* fse_nseq;            // [fse_cap]
    int32_t* fse_wlen;            // [fse_cap]
    int32_t* fse_st;              // [fse_cap, 8]: resolved initial kernel
                                  // state (pos after the 3-state preamble,
                                  // r0, r1, r2, st_ll, st_of, st_ml, 0)
};

// Routing codes shared with Python (_NATIVE_ROUTE in device_pipeline.py).
enum {
    ZT_DP_OK = 0,
    ZT_DP_NO_FCS = 1,
    ZT_DP_DICT = 2,
    ZT_DP_CAPS = 3,
    ZT_DP_TRUNC = 4,
    ZT_DP_BLOCKSIZE = 5,
    ZT_DP_LITBOUNDS = 6,
    ZT_DP_TREELESS = 7,
    ZT_DP_RESERVED = 8,
    ZT_DP_BADHUF = 9,
    ZT_DP_BADSEQ = 10,
    ZT_DP_PY = -1,   // outside native scope: Python planner handles it
};

// Pack a bitstream into a lane row (one memcpy + zeroed tail word).
// Returns word count or -1 (empty / zero last byte / longer than maxw).
static int64_t dplane_words(uint32_t* words, int64_t cap, int64_t maxw,
                            int64_t lane, const uint8_t* p, int64_t len,
                            int32_t* pos_out) {
    (void)cap;
    if (len <= 0 || p[len - 1] == 0) return -1;
    const int64_t nw = (len + 3) >> 2;
    if (nw > maxw) return -1;
    uint32_t* row = words + lane * maxw;
    row[nw - 1] = 0;
    std::memcpy(row, p, (size_t)len);
    *pos_out = (int32_t)((len - 1) * 8 + highbit32(p[len - 1]));
    return nw;
}

// Read nb bits ending at *pos (exclusive) from a packed lane row, moving
// *pos down — the backward FSE bit order (BitStream.cs initDStream role).
static uint32_t dplane_bits(const uint32_t* row, int64_t nw, int32_t* pos,
                            int nb) {
    const int32_t p0 = *pos - nb;
    *pos = p0;
    if (nb == 0) return 0;
    const int32_t k = p0 >> 5;
    const int32_t sh = p0 & 31;
    const uint32_t w0 = (k >= 0 && k < nw) ? row[k] : 0;
    const uint32_t w1 = (k + 1 >= 0 && k + 1 < nw) ? row[k + 1] : 0;
    const uint32_t v = sh == 0 ? w0 : ((w0 >> sh) | (w1 << (32 - sh)));
    return v & ((nb >= 32) ? 0xFFFFFFFFu : ((1u << nb) - 1));
}

// Resolve the kernel's initial state vector for a packed FSE lane: the
// three table-state preamble reads, in LL/OF/ML order (the format's
// initial-state order, ZstdDecompressBlock.cs decodeSeqSlow preamble).
static void dplane_fse_states(ZtDPlaneCtx* c, int64_t lane, int ll_log,
                              int of_log, int ml_log, int32_t r0, int32_t r1,
                              int32_t r2) {
    const uint32_t* row = c->fse_words + lane * c->fse_maxw;
    const int64_t nw = c->fse_wlen[lane];
    int32_t pos = c->fse_pos[lane];
    const uint32_t st_ll = dplane_bits(row, nw, &pos, ll_log);
    const uint32_t st_of = dplane_bits(row, nw, &pos, of_log);
    const uint32_t st_ml = dplane_bits(row, nw, &pos, ml_log);
    int32_t* st = c->fse_st + lane * 8;
    st[0] = pos;
    st[1] = r0; st[2] = r1; st[3] = r2;
    st[4] = (int32_t)st_ll; st[5] = (int32_t)st_of; st[6] = (int32_t)st_ml;
    st[7] = 0;
}

// Canonical-arithmetic operands for one Huffman lane (device_huf.py
// canonical_from_weights + prepare_batch, per lane).  weights includes the
// implied last symbol; n_out is the lane's symbol count.
static int64_t dplane_pack_huf_lane(ZtDPlaneCtx* c, const uint8_t* p,
                                    int64_t len, const uint8_t* weights,
                                    int nsym_w, int tlog, int64_t n_out) {
    if (c->n_huf >= c->huf_cap) return -1;
    // Kernel envelope: 11-bit peek window (device_huf.py MAXLOG); the
    // zt_dplane_pack_huf fallback path must refuse what it cannot decode.
    if (tlog < 1 || tlog > 11 || nsym_w < 1 || nsym_w > 256) return -1;
    const int64_t lane = c->n_huf;
    int32_t pos = 0;
    const int64_t nw = dplane_words(c->huf_words, c->huf_cap, c->huf_maxw,
                                    lane, p, len, &pos);
    if (nw < 0) return -1;
    const int sc = 11 - tlog;
    int32_t lim[16], bas[16], off[16], shf[16];
    for (int k = 0; k < 16; k++) { lim[k] = 1 << 11; bas[k] = 0; off[k] = 0;
                                   shf[k] = 0; }
    uint32_t planes[8][8] = {{0}};
    int rank = 0;
    int64_t cum = 0;
    for (int w = 1; w <= tlog && w <= 11; w++) {
        const int64_t start_w = cum;
        const int base_r = rank;
        for (int s = 0; s < nsym_w && rank < 256; s++)
            if (weights[s] == w) {
                for (int j = 0; j < 8; j++)
                    if ((s >> j) & 1) planes[j][rank >> 5] |= 1u << (rank & 31);
                rank++;
            }
        cum += (int64_t)(rank - base_r) << (w - 1);
        lim[w - 1] = (int32_t)(cum << sc);
        bas[w - 1] = base_r;
        off[w - 1] = (int32_t)(start_w << sc);
        shf[w - 1] = (w - 1) + sc;
    }
    std::memcpy(c->huf_limits + lane * 16, lim, sizeof lim);
    std::memcpy(c->huf_bases + lane * 16, bas, sizeof bas);
    std::memcpy(c->huf_offs + lane * 16, off, sizeof off);
    std::memcpy(c->huf_shifts + lane * 16, shf, sizeof shf);
    std::memcpy(c->huf_planes + lane * 64, planes, sizeof planes);
    c->huf_pos[lane] = pos;
    c->huf_nsym[lane] = (int32_t)n_out;
    c->huf_wlen[lane] = (int32_t)nw;
    if (nw > c->huf_wmax) c->huf_wmax = nw;
    c->n_huf++;
    return lane;
}

// Coded FSE table (sym | next_state<<8 | state_bits<<20) into a
// contiguous lane row.
static void dplane_coded_fill(int32_t* out, const int16_t* norm,
                              int max_sym, int tlog) {
    const int tsize = 1 << tlog;
    uint8_t tsym[1 << 9];
    fse_spread(norm, max_sym, tlog, tsym);
    uint32_t next[256];
    for (int s = 0; s <= max_sym; s++)
        next[s] = norm[s] == -1 ? 1 : (norm[s] > 0 ? (uint32_t)norm[s] : 0);
    for (int u = 0; u < tsize; u++) {
        const int s = tsym[u];
        const uint32_t ns = next[s]++;
        const int nb = tlog - highbit32(ns);
        const uint32_t nst = (ns << nb) - (uint32_t)tsize;
        out[u] = (int32_t)((uint32_t)s | (nst << 8) | ((uint32_t)nb << 20));
    }
}

// Predefined coded tables (mode 0), built once.  Initialization is
// guarded by a magic-static: decode_batch_device is called concurrently
// from per-device shard threads (parallel/pipeline.py), so the lazy fill
// must be race-free.
static int32_t kCodedLLDef[1 << kLLNormLog];
static int32_t kCodedMLDef[1 << kMLNormLog];
static int32_t kCodedOFDef[1 << kOFNormLog];

static void dplane_coded_defaults() {
    static const bool init = [] {
        dplane_coded_fill(kCodedLLDef, kLLNorm, kMaxLL, kLLNormLog);
        dplane_coded_fill(kCodedMLDef, kMLNorm, kMaxML, kMLNormLog);
        dplane_coded_fill(kCodedOFDef, kOFNorm, kDefaultMaxOFF, kOFNormLog);
        return true;
    }();
    (void)init;
}

// One channel of the sequence-table header for a FRESH frame (no repeat
// state).  Fills the coded lane row (contiguous); returns bytes consumed
// or -1.
static int64_t dplane_seq_table(int mode, const uint8_t* src, int64_t size,
                                int32_t* out,
                                const int32_t* coded_def, int def_log,
                                int max_sym, int max_log, int* tlog_out) {
    dplane_coded_defaults();
    if (mode == 0) {
        std::memcpy(out, coded_def, sizeof(int32_t) << def_log);
        *tlog_out = def_log;
        return 0;
    }
    if (mode == 1) {
        if (size < 1 || src[0] > max_sym) return -1;
        out[0] = src[0];  // tlog 0: single state, nb 0, nst 0
        *tlog_out = 0;
        return 1;
    }
    if (mode == 2) {
        int16_t norm[64];
        int ms, tl;
        const int64_t h = fse_read_ncount(norm, &ms, &tl, src, size,
                                          max_sym, max_log);
        if (h < 0) return -1;
        dplane_coded_fill(out, norm, ms, tl);
        *tlog_out = tl;
        return h;
    }
    return -1;  // repeat mode on a fresh frame is corrupt
}

// Huffman weight read incl. implied-last completion (huf_read_weights_c +
// the completion logic of huf_read_and_build_dtable).  Returns header bytes
// consumed, or -1.  weights must hold 257 entries.
static int64_t dplane_read_weights(const uint8_t* src, int64_t size,
                                   uint8_t* weights, int* nsym_out,
                                   int* tlog_out) {
    int nw = 0;
    const int64_t consumed = huf_read_weights_c(src, size, weights, &nw);
    if (consumed < 0) return -1;
    uint64_t total = 0;
    for (int i = 0; i < nw; i++) {
        if (weights[i] > 12) return -1;
        if (weights[i]) total += 1ULL << (weights[i] - 1);
    }
    if (total == 0) return -1;
    const int tlog = highbit32((uint32_t)total) + 1;
    // The device kernel peeks MAXLOG=11 bits (device_huf.py:36); a valid
    // frame with tableLog 12 (format allows up to HUF_TABLELOG_MAX=12)
    // must be HOST-routed, not mis-decoded with a negative shift count.
    if (tlog > 11) return -1;
    const uint64_t rest = (1ULL << tlog) - total;
    if (rest == 0 || (rest & (rest - 1))) return -1;
    weights[nw] = (uint8_t)(highbit32((uint32_t)rest) + 1);
    *nsym_out = nw + 1;
    *tlog_out = tlog;
    return consumed;
}

// Python-fallback lane packers: the Python planner (multi-block frames,
// dict batches) routes its lanes through these so every lane of a batch
// lives in one packed numbering.
int64_t zt_dplane_pack_huf(ZtDPlaneCtx* c, const uint8_t* p, int64_t len,
                           const uint8_t* weights, int64_t nsym_w,
                           int64_t tlog, int64_t n_out) {
    return dplane_pack_huf_lane(c, p, len, weights, (int)nsym_w, (int)tlog,
                                n_out);
}

int64_t zt_dplane_pack_fse(ZtDPlaneCtx* c, const uint8_t* p, int64_t len,
                           const int32_t* ll_tbl, const int32_t* of_tbl,
                           const int32_t* ml_tbl, int64_t ll_log,
                           int64_t of_log, int64_t ml_log,
                           const int32_t* rep3, int64_t nseq) {
    if (c->n_fse >= c->fse_cap) return -1;
    // Python passes arrays of exactly 2^table_log entries; copy only that
    // many (zero-filling the column tail) — reading a fixed 512/256/512
    // would walk past the caller's buffer for the small default tables.
    if (ll_log < 0 || ll_log > 9 || of_log < 0 || of_log > 8 ||
        ml_log < 0 || ml_log > 9) return -1;
    const int64_t lane = c->n_fse;
    int32_t pos = 0;
    const int64_t nw = dplane_words(c->fse_words, c->fse_cap, c->fse_maxw,
                                    lane, p, len, &pos);
    if (nw < 0) return -1;
    const int64_t nll = 1LL << ll_log, nof = 1LL << of_log,
                  nml = 1LL << ml_log;
    std::memcpy(c->fse_ll + lane * 512, ll_tbl, (size_t)nll * 4);
    std::memset(c->fse_ll + lane * 512 + nll, 0, (size_t)(512 - nll) * 4);
    std::memcpy(c->fse_of + lane * 256, of_tbl, (size_t)nof * 4);
    std::memset(c->fse_of + lane * 256 + nof, 0, (size_t)(256 - nof) * 4);
    std::memcpy(c->fse_ml + lane * 512, ml_tbl, (size_t)nml * 4);
    std::memset(c->fse_ml + lane * 512 + nml, 0, (size_t)(512 - nml) * 4);
    c->fse_logs[lane * 3 + 0] = (int32_t)ll_log;
    c->fse_logs[lane * 3 + 1] = (int32_t)of_log;
    c->fse_logs[lane * 3 + 2] = (int32_t)ml_log;
    c->fse_pos[lane] = pos;
    for (int k = 0; k < 3; k++) c->fse_rep[lane * 3 + k] = rep3[k];
    c->fse_nseq[lane] = (int32_t)nseq;
    c->fse_wlen[lane] = (int32_t)nw;
    dplane_fse_states(c, lane, (int)ll_log, (int)of_log, (int)ml_log,
                      rep3[0], rep3[1], rep3[2]);
    if (nw > c->fse_wmax) c->fse_wmax = nw;
    if (nseq > c->max_seq) c->max_seq = nseq;
    c->n_fse++;
    return lane;
}

// Plan one frame.  meta[12] = [lit_kind, pool_base, pool_len, huf_lane0,
// huf_seg, seq_kind, fse_lane, host_row, n_seq, lit_regen, out_len,
// checksum].  Returns ZT_DP_OK / a host-route code / ZT_DP_PY.
int zt_dplane_frame(ZtDPlaneCtx* c, const uint8_t* frame, int64_t n,
                    int32_t* meta) {
    codec_init();
    // rollback state: a frame either plans fully or leaves no trace
    const int64_t pool0 = c->pool_off, huf0 = c->n_huf, fse0 = c->n_fse;
    const int64_t hw0 = c->huf_wmax, fw0 = c->fse_wmax, ms0 = c->max_seq;
#define ZT_DP_FAIL(code) do { c->pool_off = pool0; c->n_huf = huf0; \
    c->n_fse = fse0; c->huf_wmax = hw0; c->fse_wmax = fw0; \
    c->max_seq = ms0; return (code); } while (0)
    int64_t fcs = -1;
    int has_cksum = 0;
    uint32_t dict_id = 0;
    const int64_t hdr = parse_frame_header_c(frame, n, &fcs, &has_cksum,
                                             &dict_id);
    if (hdr < 0) return ZT_DP_TRUNC;
    if (fcs < 0) return ZT_DP_NO_FCS;
    if (dict_id != 0) return ZT_DP_DICT;
    const int64_t content = fcs;
    if (content > (1LL << 22)) return ZT_DP_CAPS;
    int64_t p = hdr;
    if (p + 3 > n) return ZT_DP_TRUNC;
    const uint32_t bh = (uint32_t)frame[p] | ((uint32_t)frame[p + 1] << 8) |
                        ((uint32_t)frame[p + 2] << 16);
    const int last = bh & 1;
    const int btype = (bh >> 1) & 3;
    const int64_t bsize = bh >> 3;
    if (!last) return ZT_DP_PY;           // multi-block: Python plan
    // Single-block envelope: the exec buckets top out at 128KB
    // (device_pipeline.py _O_BUCKETS); a frame claiming more content in
    // one block (format-invalid, but reachable in crafted input) must be
    // host-routed, not allowed to abort the whole batch in _bucket().
    if (content > (1LL << 17)) return ZT_DP_CAPS;
    if (btype == 3) return ZT_DP_RESERVED;
    const int64_t body_len = btype == 1 ? 1 : bsize;
    const int64_t tail = has_cksum ? 4 : 0;
    if (p + 3 + body_len + tail > n) return ZT_DP_TRUNC;
    int32_t cksum = -1;
    if (has_cksum) {
        uint32_t v;
        std::memcpy(&v, frame + p + 3 + body_len, 4);
        cksum = (int32_t)v;
    }
    // meta defaults
    int32_t lit_kind = 0, huf_lane0 = -1, huf_seg = 0;
    int32_t seq_kind = 0, fse_lane = -1, n_seq = 0;
    int64_t pool_base = c->pool_off, pool_len = 0, lit_regen = 0;
    const uint8_t* body = frame + p + 3;
    if (btype == 0) {          // raw block
        if (bsize != content) return ZT_DP_BLOCKSIZE;
        if (c->pool_off + bsize > c->pool_cap) return ZT_DP_PY;
        std::memcpy(c->raw_pool + c->pool_off, body, (size_t)bsize);
        c->pool_off += bsize;
        pool_len = bsize;
        lit_regen = bsize;
    } else if (btype == 1) {   // RLE block
        if (bsize != content) return ZT_DP_BLOCKSIZE;
        if (c->pool_off + 1 > c->pool_cap) return ZT_DP_PY;
        c->raw_pool[c->pool_off++] = body[0];
        pool_len = 1;
        lit_regen = content;
    } else {                   // compressed block
        if (bsize < 1) return ZT_DP_TRUNC;
        const int b0 = body[0];
        const int lt = b0 & 3, sf = (b0 >> 2) & 3;
        int64_t regen, comp = 0, lh;
        if (lt <= 1) {
            if (sf == 0 || sf == 2) { regen = b0 >> 3; lh = 1; }
            else if (sf == 1) {
                if (bsize < 2) return ZT_DP_LITBOUNDS;
                regen = (b0 >> 4) + ((int64_t)body[1] << 4); lh = 2;
            } else {
                if (bsize < 3) return ZT_DP_LITBOUNDS;
                regen = (b0 >> 4) + ((int64_t)body[1] << 4) +
                        ((int64_t)body[2] << 12); lh = 3;
            }
        } else {
            if (bsize < 3) return ZT_DP_LITBOUNDS;
            if (sf == 0 || sf == 1) {
                const uint32_t v = (uint32_t)body[0] |
                    ((uint32_t)body[1] << 8) | ((uint32_t)body[2] << 16);
                regen = (v >> 4) & 0x3FF; comp = (v >> 14) & 0x3FF; lh = 3;
            } else if (sf == 2) {
                if (bsize < 4) return ZT_DP_LITBOUNDS;
                uint32_t v; std::memcpy(&v, body, 4);
                regen = (v >> 4) & 0x3FFF; comp = (v >> 18) & 0x3FFF; lh = 4;
            } else {
                if (bsize < 5) return ZT_DP_LITBOUNDS;
                uint64_t v = 0; std::memcpy(&v, body, 5);
                regen = (int64_t)((v >> 4) & 0x3FFFF);
                comp = (int64_t)((v >> 22) & 0x3FFFF); lh = 5;
            }
        }
        if (regen > content || lh + (lt >= 2 ? comp : 0) > bsize)
            return ZT_DP_LITBOUNDS;
        lit_regen = regen;
        int64_t lit_end;
        if (lt == 0) {
            if (lh + regen > bsize) return ZT_DP_LITBOUNDS;
            if (c->pool_off + regen > c->pool_cap) return ZT_DP_PY;
            std::memcpy(c->raw_pool + c->pool_off, body + lh, (size_t)regen);
            c->pool_off += regen;
            pool_len = regen;
            lit_end = lh + regen;
        } else if (lt == 1) {
            if (lh + 1 > bsize) return ZT_DP_LITBOUNDS;
            if (c->pool_off + 1 > c->pool_cap) return ZT_DP_PY;
            c->raw_pool[c->pool_off++] = body[lh];
            pool_len = 1;
            lit_end = lh + 1;
        } else if (lt == 3) {
            return ZT_DP_TREELESS;   // no dict table in the native scope
        } else {
            uint8_t weights[257];
            int nsym_w = 0, tlog = 0;
            const int64_t whdr = dplane_read_weights(body + lh, comp,
                                                     weights, &nsym_w, &tlog);
            if (whdr < 0) return ZT_DP_BADHUF;
            const uint8_t* streams = body + lh + whdr;
            const int64_t slen = comp - whdr;
            if (sf != 0) {  // 4-stream
                if (slen < 10) ZT_DP_FAIL(ZT_DP_PY);
                const int64_t s1 = streams[0] | (streams[1] << 8);
                const int64_t s2 = streams[2] | (streams[3] << 8);
                const int64_t s3 = streams[4] | (streams[5] << 8);
                const int64_t s4 = slen - 6 - s1 - s2 - s3;
                const int64_t seg = (regen + 3) / 4;
                const int64_t szs[4] = {s1, s2, s3, s4};
                const int64_t outs[4] = {seg, seg, seg, regen - 3 * seg};
                for (int k = 0; k < 4; k++)
                    if (szs[k] <= 0 || outs[k] <= 0 ||
                        szs[k] > c->huf_maxw * 4)
                        ZT_DP_FAIL(ZT_DP_PY);
                if (c->n_huf + 4 > c->huf_cap) ZT_DP_FAIL(ZT_DP_PY);
                huf_lane0 = (int32_t)c->n_huf;
                huf_seg = (int32_t)seg;
                int64_t o = 6;
                for (int k = 0; k < 4; k++) {
                    if (dplane_pack_huf_lane(c, streams + o, szs[k], weights,
                                             nsym_w, tlog, outs[k]) < 0)
                        ZT_DP_FAIL(ZT_DP_TRUNC);  // zero last byte: corrupt
                    o += szs[k];
                }
            } else {        // 1-stream
                if (slen <= 0 || slen > c->huf_maxw * 4 || regen <= 0 ||
                    regen > 4096)
                    ZT_DP_FAIL(ZT_DP_PY);
                huf_lane0 = (int32_t)c->n_huf;
                huf_seg = (int32_t)regen;
                if (dplane_pack_huf_lane(c, streams, slen, weights, nsym_w,
                                         tlog, regen) < 0)
                    ZT_DP_FAIL(ZT_DP_TRUNC);
            }
            lit_kind = 1;
            lit_end = lh + comp;
        }
        // ---- sequence section ----
        const uint8_t* rest = body + lit_end;
        int64_t rsize = bsize - lit_end;
        if (rsize < 1) ZT_DP_FAIL(ZT_DP_BADSEQ);
        int64_t nbseq;
        if (rest[0] < 128) { nbseq = rest[0]; rest += 1; rsize -= 1; }
        else if (rest[0] < 255) {
            if (rsize < 2) ZT_DP_FAIL(ZT_DP_BADSEQ);
            nbseq = ((int64_t)(rest[0] - 128) << 8) + rest[1];
            rest += 2; rsize -= 2;
        } else {
            if (rsize < 3) ZT_DP_FAIL(ZT_DP_BADSEQ);
            nbseq = rest[1] + ((int64_t)rest[2] << 8) + 0x7F00;
            rest += 3; rsize -= 3;
        }
        if (nbseq > 0) {
            if (rsize < 1) ZT_DP_FAIL(ZT_DP_BADSEQ);
            const int mode_byte = rest[0];
            if (mode_byte & 3) ZT_DP_FAIL(ZT_DP_BADSEQ);
            rest += 1; rsize -= 1;
            if (nbseq > c->s_cap || c->n_fse >= c->fse_cap)
                ZT_DP_FAIL(ZT_DP_PY);
            const int64_t lane = c->n_fse;
            int ll_log = 0, of_log = 0, ml_log = 0;
            int64_t h = dplane_seq_table(mode_byte >> 6, rest, rsize,
                                         c->fse_ll + lane * 512, kCodedLLDef,
                                         kLLNormLog, kMaxLL, 9, &ll_log);
            if (h < 0) ZT_DP_FAIL(ZT_DP_BADSEQ);
            rest += h; rsize -= h;
            h = dplane_seq_table((mode_byte >> 4) & 3, rest, rsize,
                                 c->fse_of + lane * 256, kCodedOFDef,
                                 kOFNormLog, kMaxOFF, 8, &of_log);
            if (h < 0) ZT_DP_FAIL(ZT_DP_BADSEQ);
            rest += h; rsize -= h;
            h = dplane_seq_table((mode_byte >> 2) & 3, rest, rsize,
                                 c->fse_ml + lane * 512, kCodedMLDef,
                                 kMLNormLog, kMaxML, 9, &ml_log);
            if (h < 0) ZT_DP_FAIL(ZT_DP_BADSEQ);
            rest += h; rsize -= h;
            if (rsize <= 0 || rsize > c->fse_maxw * 4) ZT_DP_FAIL(ZT_DP_PY);
            int32_t pos = 0;
            const int64_t nw = dplane_words(c->fse_words, c->fse_cap,
                                            c->fse_maxw, lane, rest, rsize,
                                            &pos);
            if (nw < 0) ZT_DP_FAIL(ZT_DP_TRUNC);
            c->fse_logs[lane * 3 + 0] = ll_log;
            c->fse_logs[lane * 3 + 1] = of_log;
            c->fse_logs[lane * 3 + 2] = ml_log;
            c->fse_pos[lane] = pos;
            c->fse_rep[lane * 3 + 0] = 1;
            c->fse_rep[lane * 3 + 1] = 4;
            c->fse_rep[lane * 3 + 2] = 8;
            c->fse_nseq[lane] = (int32_t)nbseq;
            c->fse_wlen[lane] = (int32_t)nw;
            dplane_fse_states(c, lane, ll_log, of_log, ml_log, 1, 4, 8);
            if (nw > c->fse_wmax) c->fse_wmax = nw;
            if (nbseq > c->max_seq) c->max_seq = nbseq;
            c->n_fse++;
            seq_kind = 1;
            fse_lane = (int32_t)lane;
            n_seq = (int32_t)nbseq;
        }
    }
    if (content > c->max_out) c->max_out = content;
    meta[0] = lit_kind;
    meta[1] = (int32_t)pool_base;
    meta[2] = (int32_t)pool_len;
    meta[3] = huf_lane0;
    meta[4] = huf_seg;
    meta[5] = seq_kind;
    meta[6] = fse_lane;
    // meta[7] doubles as the has-checksum flag (host_row is unused on this
    // path): a frame whose real xxh32 low word is 0xFFFFFFFF must still be
    // verified, so "absent" cannot be encoded as -1 in meta[11] alone.
    meta[7] = has_cksum;
    meta[8] = n_seq;
    meta[9] = (int32_t)lit_regen;
    meta[10] = (int32_t)content;
    meta[11] = cksum;
    return ZT_DP_OK;
#undef ZT_DP_FAIL
}

// Plan a whole batch in one call (the per-call ctypes marshalling of
// zt_dplane_frame costs ~40us/frame; a 256-frame batch plans in one hop).
// buf holds the concatenated frames; frame i spans [offs[i], offs[i+1]).
int64_t zt_dplane_batch(ZtDPlaneCtx* c, const uint8_t* buf,
                        const int64_t* offs, int64_t n_frames,
                        int32_t* metas, int32_t* rcs) {
    for (int64_t i = 0; i < n_frames; i++)
        rcs[i] = zt_dplane_frame(c, buf + offs[i], offs[i + 1] - offs[i],
                                 metas + i * 12);
    return 0;
}

}  // extern "C"

