// The encode's chunk assembly, in int32: every element's header tokens,
// shift-byte block and Rice rows, the per-lane escape select, the tails
// and the END tag, written as the (B, T) chunk image and the (B, n_t)
// tails that the merge kernel (merge.cu) takes.
//
// Replaces: no TPU kernel.  The glue of alacjax/codec.py:696
// mixed_chunks and the END tag of _encode_packet_chunks (XLA there), in
// the port about 150 (stereo) to 870 (5.1) int64 torch operations a call
// before this kernel: the header token images (bitpack.assemble's cumsum
// and scatter_add), the shift-byte blocks (pack_fields, place_segment),
// the escape streams and select, the per-element and cross-element
// concatenations.  Plain version: alacjax_torch/ops/assemble.py :: chunks.
//
// Bound: bytes.  Every column of the image is written once (value and
// key, 8 bytes), each channel's Rice rows of rice_encode_words read once
// (8 bytes a slot), the shift-byte rows read once (4 bytes a sample and
// channel), an escaped lane's samples read once, the per-lane fields and
// the tails once: at B = S = 4096 about 1.1 GB on stereo-16 (0.33 ms at
// 3.35 TB/s) and 3.8 GB on 24-bit 5.1 (1.1 ms).  The kernel computes
// nothing but shifts and selects.
//
// Design.  The image's columns are the plain version's, element after
// element: the compressed form (header words, the shift-byte block's
// placed words, each channel's Rice rows of R slots) or, on a lane whose
// element escaped, the escape form (header words, the raw samples'
// placed words), each padded with (0, -1) to the element's width.  A
// block is ATHREADS threads of one lane and one tile of TILE_COLS columns
// of one element (blockIdx.x: lane, then the call's tiles), so the
// lane's form, its header fields and its bit offsets are block-uniform
// and each warp instruction stores 32 consecutive columns (128 bytes) of
// one row; a thread takes ACOLS columns ATHREADS apart and issues their
// loads together.  16-byte stores would need each row to start at a
// multiple of 4 columns, and a 5.1 row is 55,374 columns wide.  Every
// word is computed where it is stored, from the fields that overlap it:
// a header word from at most the 23-bit header, the 32-bit numSamples
// and three 16-bit tokens at closed-form offsets (after the first 23 or
// 55 bits every token is 16 bits wide); a shift-block word from at most
// five 8-bit fields (three 16-bit) and a raw word from at most three, at
// the lane's phase; so each column is written once, with no atomics and
// no int64 arithmetic.  Block tile 0 of an element also writes the
// element's tails, and tile 0 of the last element the END tag's two
// tails and the total bits.  Templated on the bytes shifted (the block's
// field width) and on whether per-lane sample counts are given; the
// element's width, its forms and the depth of its escape samples are
// block-uniform arguments.
#include "common.cuh"

namespace alac {

constexpr int ATHREADS = 256;
constexpr int ACOLS = 4;                      // columns per thread
constexpr int TILE_COLS = ATHREADS * ACOLS;
constexpr int MAX_ELEMS = 8;
constexpr int DESC = 26;                      // int64 slots per element

struct Elem {
    const long long* start;      // (B,) the element's first bit
    const unsigned char* esc;    // (B,) use_escape, or nullptr: no lane
    const long long* mixres;     // (B,) a CPE's, or nullptr (SCE)
    const long long* order[2];   // (B,) per channel
    const long long* mode[2];
    const int* coefs[2];         // (B, 16) the winning order's start
    const int* los[2];           // (B, S) shifted-off low bytes
    const int* chans[2];         // (B, .) samples, row stride chan_stride
    long long chan_stride;
    int width, hdr, hdr_esc;     // 23-bit headers: compressed, escape
    int col0, T;                 // the element's columns of the image
    int Hw, Bw, EHw, RW;         // header, shift block, escape header, raw
    int tail0, comp, row0;       // first tail; compressed form; Rice row
    int piece0;                  // the element's first tile of the call
};

struct AsmArgs {
    Elem e[MAX_ELEMS];
    const int* cw;               // (L, R) Rice words, or nullptr (no comp)
    const int* ck;               // (L, R) their keys
    const int* ctv;              // (L,) tail words
    const int* ctk;              // (L,) tail keys
    const long long* nums;       // (B,) or nullptr
    const long long* total;      // (B,) bits before the END tag
    int* vals;                   // (B, T)
    int* keys;                   // (B, T)
    int* tv;                     // (B, n_t)
    int* tk;                     // (B, n_t)
    int* bits;                   // (B,) total bits, END included
    int B, T, n_t, S, depth, R, n_elem, pieces, mixhi, param;
};

// The n-bit value v (masked) placed at bit rel of a 32-bit word (0: its
// most significant bit); what of it falls inside the word.
__device__ __forceinline__ unsigned put(unsigned v, int n, int rel) {
    if (rel >= 32 || rel + n <= 0) return 0u;
    const int sh = 32 - rel - n;
    return sh >= 0 ? v << sh : v >> -sh;
}

// Word j of a block of d-bit fields placed at bit phase ph: fields f <
// nf of rows r0 (and, interleaved, r1 for a CPE), masked to d bits.
__device__ __forceinline__ unsigned field_word(const int* r0, const int* r1,
                                               int d, unsigned mask, int nf,
                                               int ph, int j) {
    const int s0 = 32 * j - ph;
    const int f_lo = s0 < 0 ? 0 : s0 / d;
    int f_hi = (s0 + 31) / d;
    if (f_hi > nf - 1) f_hi = nf - 1;
    unsigned w = 0u;
    for (int f = f_lo; f <= f_hi; ++f) {
        const int x = r1 ? __ldg((f & 1 ? r1 : r0) + (f >> 1)) : __ldg(r0 + f);
        w |= put((unsigned)x & mask, d, f * d - s0);
    }
    return w;
}

// The compressed header's fields of one lane
struct Head {
    int st, ph, pb, nl, o0, o1, hbits;
    bool partial;
};

// 16-bit header token t after the first 23 (+ 32) bits: the mix token,
// then per channel its parameter word and order coefficients
__device__ __forceinline__ unsigned token16(const Elem& E, const AsmArgs& a,
                                            const Head& h, int b, int t) {
    if (t == 0)
        return E.mixres ? ((unsigned)a.mixhi | ((unsigned)__ldg(E.mixres + b) & 0xFFu))
                        : 0u;
    int u = t - 1, c = 0;
    if (u > h.o0) { u -= h.o0 + 1; c = 1; }
    if (u == 0)
        return ((unsigned)__ldg(E.mode[c] + b) << 12 | (unsigned)a.param
                | (unsigned)__ldg(E.order[c] + b)) & 0xFFFFu;
    return (unsigned)__ldg(E.coefs[c] + (size_t)b * 16 + (u - 1)) & 0xFFFFu;
}

// Word j of the header image (relative to the element's first word):
// the 23-bit header, numSamples on a partial lane, then (compressed form
// only) the 16-bit tokens
__device__ __forceinline__ unsigned header_word(const Elem& E,
                                                const AsmArgs& a,
                                                const Head& h, int b, int j,
                                                bool comp) {
    const int base = 32 * j;
    unsigned w = put(((unsigned)(comp ? E.hdr : E.hdr_esc)
                      | (h.partial ? 8u : 0u)) & 0x7FFFFFu, 23, h.ph - base);
    if (h.partial) w |= put((unsigned)h.nl, 32, h.ph + 23 - base);
    if (comp) {
        const int p0 = h.ph + 23 + h.pb;
        const int n16 = 1 + E.width + h.o0 + h.o1;
        int t_lo = (base - p0) >> 4;
        int t_hi = (base + 31 - p0) >> 4;
        if (t_lo < 0) t_lo = 0;
        if (t_hi > n16 - 1) t_hi = n16 - 1;
        for (int t = t_lo; t <= t_hi; ++t)
            w |= put(token16(E, a, h, b, t), 16, p0 + 16 * t - base);
    }
    return w;
}

template <int BS, bool NUMS>
__global__ void __launch_bounds__(ATHREADS)
assemble_kernel(const __grid_constant__ AsmArgs a) {
    const int b = blockIdx.x / a.pieces;
    const int p = blockIdx.x - b * a.pieces;
    int ei = 0;
    while (ei + 1 < a.n_elem && p >= a.e[ei + 1].piece0) ++ei;
    const Elem& E = a.e[ei];
    const int tile = p - E.piece0;
    const int tid = threadIdx.x;
    const int S = a.S;

    Head h;
    h.st = (int)__ldg(E.start + b);
    h.ph = h.st & 31;
    h.nl = NUMS ? (int)__ldg(a.nums + b) : S;
    h.partial = NUMS && h.nl < S;
    h.pb = h.partial ? 32 : 0;
    const bool comp = E.comp && !(E.esc && __ldg(E.esc + b));
    h.o0 = comp ? (int)__ldg(E.order[0] + b) : 0;
    h.o1 = comp && E.width == 2 ? (int)__ldg(E.order[1] + b) : 0;
    h.hbits = comp ? 23 + h.pb + 16 + 16 * E.width + 16 * (h.o0 + h.o1)
                   : 23 + h.pb;
    const int nf = E.width * h.nl;                    // fields a block holds
    const int bstart = h.st + h.hbits;                // shift or raw block
    const int bph = bstart & 31;
    const int* r0 = nullptr;
    const int* r1 = nullptr;
    int d = 8 * BS;
    unsigned mask = (1u << (8 * BS)) - 1u;
    if (comp && BS) {
        r0 = E.los[0] + (size_t)b * S;
        if (E.width == 2) r1 = E.los[1] + (size_t)b * S;
    } else if (!comp) {
        r0 = E.chans[0] + (size_t)b * E.chan_stride;
        if (E.width == 2) r1 = E.chans[1] + (size_t)b * E.chan_stride;
        d = a.depth;
        mask = d == 32 ? 0xFFFFFFFFu : (1u << d) - 1u;
    }
    const int hw = comp ? E.Hw : E.EHw;               // header columns
    const int bw = comp ? E.Bw : E.RW;                // block columns
    const int h_done = (h.ph + h.hbits) >> 5;         // complete header words
    const int b_done = (bph + nf * d) >> 5;           // complete block words
    const int rice0 = hw + bw;
    const int rice_end = comp ? rice0 + E.width * a.R : rice0;

    const size_t row = (size_t)b * a.T + E.col0;
    unsigned v[ACOLS];
    int k[ACOLS];
#pragma unroll
    for (int i = 0; i < ACOLS; ++i) {
        const int j = tile * TILE_COLS + i * ATHREADS + tid;
        v[i] = 0u;
        k[i] = -1;
        if (j >= E.T) continue;
        if (j < hw) {
            v[i] = header_word(E, a, h, b, j, comp);
            k[i] = j < h_done ? (h.st >> 5) + j : -1;
        } else if (j < rice0) {
            const int jj = j - hw;
            v[i] = field_word(r0, r1, d, mask, nf, bph, jj);
            k[i] = jj < b_done ? (bstart >> 5) + jj : -1;
        } else if (j < rice_end) {
            int jr = j - rice0, c = 0;
            if (jr >= a.R) { jr -= a.R; c = 1; }
            const size_t at = ((size_t)E.row0 + (size_t)c * a.B + b) * a.R + jr;
            v[i] = (unsigned)__ldg(a.cw + at);
            k[i] = __ldg(a.ck + at);
        }
    }
#pragma unroll
    for (int i = 0; i < ACOLS; ++i) {
        const int j = tile * TILE_COLS + i * ATHREADS + tid;
        if (j < E.T) {
            a.vals[row + j] = (int)v[i];
            a.keys[row + j] = k[i];
        }
    }
    if (tile != 0) return;

    // the element's tails: the header's, the block's, each channel's
    // Rice tail (an escaped lane: its header's and raw block's, then
    // empty ones)
    const int n_tails = E.comp ? 1 + (BS ? 1 : 0) + E.width : 2;
    if (tid < n_tails) {
        unsigned tvv = 0u;
        int tkk = -1;
        if (tid == 0) {
            const int img = h.ph + h.hbits;
            if ((img & 31) && h_done < hw) tvv = header_word(E, a, h, b, h_done, comp);
            tkk = (h.st >> 5) + h_done;
        } else if (tid == 1 && (!comp || BS)) {
            if ((bph + nf * d) & 31) tvv = field_word(r0, r1, d, mask, nf, bph, b_done);
            tkk = (bstart >> 5) + b_done;
        } else if (comp) {
            const size_t at = (size_t)E.row0 + (size_t)(tid - 1 - (BS ? 1 : 0)) * a.B + b;
            tvv = (unsigned)__ldg(a.ctv + at);
            tkk = __ldg(a.ctk + at);
        }
        const size_t tr = (size_t)b * a.n_t + E.tail0 + tid;
        a.tv[tr] = (int)tvv;
        a.tk[tr] = tkk;
    }
    // the END tag (3 bits) at the packet's end: two tails; the total bits
    if (ei == a.n_elem - 1 && (tid == 64 || tid == 65)) {
        const int tot = (int)__ldg(a.total + b);
        const int ph = tot & 31;
        const size_t tr = (size_t)b * a.n_t + a.n_t - 2;
        if (tid == 64) {
            a.tv[tr] = (int)(0xE0000000u >> ph);
            a.tk[tr] = tot >> 5;
            a.bits[b] = tot + 3;
        } else {
            a.tv[tr + 1] = ph > 29 ? (int)(7u << (61 - ph)) : 0;
            a.tk[tr + 1] = ph > 29 ? (tot >> 5) + 1 : -1;
        }
    }
}

template <int BS, bool NUMS>
int launch_assemble(const AsmArgs& a, cudaStream_t st) {
    const long long grid = (long long)a.B * a.pieces;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    assemble_kernel<BS, NUMS><<<(unsigned)grid, ATHREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace alac

// One call's assembly.  desc is a host array of n_elem x DESC int64
// slots per element, in Elem's order up to row0 (pointers as integers;
// null where the element has no such input).  cw, ck (L, R) and ctv, ctk
// (L,) are rice_encode_words's outputs over every channel, or all null
// where no element has the compressed form (every lane escaped); nums
// (B,) or null; total (B,) the bits before the END tag.  Writes vals,
// keys (B, T), tv, tk (B, n_t) and bits (B,).
extern "C" int alac_assemble(const long long* desc, const int* cw,
                             const int* ck, const int* ctv, const int* ctk,
                             const long long* nums, const long long* total,
                             int* vals, int* keys, int* tv, int* tk,
                             int* bits, int n_elem, int B, int T, int n_t,
                             int S, int depth, int bs, int R, int mixhi,
                             int param, void* stream) {
    using alac::Elem;
    if (B <= 0) return (int)cudaGetLastError();
    if (n_elem < 1 || n_elem > alac::MAX_ELEMS || bs < 0 || bs > 2
        || depth < 1 || depth > 32 || S <= 0 || R < 0 || T <= 0 || n_t < 2
        || desc == nullptr || total == nullptr || vals == nullptr
        || keys == nullptr || tv == nullptr || tk == nullptr
        || bits == nullptr)
        return (int)cudaErrorInvalidValue;
    alac::AsmArgs a{};
    int pieces = 0, cols = 0, tails = 0;
    for (int i = 0; i < n_elem; ++i) {
        const long long* s = desc + (size_t)i * alac::DESC;
        Elem& e = a.e[i];
        e.start = (const long long*)s[0];
        e.esc = (const unsigned char*)s[1];
        e.mixres = (const long long*)s[2];
        for (int c = 0; c < 2; ++c) {
            e.order[c] = (const long long*)s[3 + c];
            e.mode[c] = (const long long*)s[5 + c];
            e.coefs[c] = (const int*)s[7 + c];
            e.los[c] = (const int*)s[9 + c];
            e.chans[c] = (const int*)s[11 + c];
        }
        e.chan_stride = s[13];
        e.width = (int)s[14];
        e.hdr = (int)s[15];
        e.hdr_esc = (int)s[16];
        e.col0 = (int)s[17];
        e.T = (int)s[18];
        e.Hw = (int)s[19];
        e.Bw = (int)s[20];
        e.EHw = (int)s[21];
        e.RW = (int)s[22];
        e.tail0 = (int)s[23];
        e.comp = (int)s[24];
        e.row0 = (int)s[25];
        e.piece0 = pieces;
        const int w = e.width;
        const bool esc_form = !e.comp || e.esc != nullptr;
        if ((w != 1 && w != 2) || e.start == nullptr || e.col0 != cols
            || e.T <= 0 || e.tail0 != tails
            || (e.comp && (cw == nullptr || ck == nullptr || ctv == nullptr
                           || ctk == nullptr || e.order[0] == nullptr
                           || e.mode[0] == nullptr || e.coefs[0] == nullptr
                           || (w == 2 && (e.order[1] == nullptr
                                          || e.mode[1] == nullptr
                                          || e.coefs[1] == nullptr
                                          || e.mixres == nullptr))
                           || (bs && (e.los[0] == nullptr
                                      || (w == 2 && e.los[1] == nullptr)))))
            || (esc_form && (e.chans[0] == nullptr
                             || (w == 2 && e.chans[1] == nullptr))))
            return (int)cudaErrorInvalidValue;
        cols += e.T;
        tails += e.comp ? 1 + (bs ? 1 : 0) + w : 2;
        pieces += (e.T + alac::TILE_COLS - 1) / alac::TILE_COLS;
    }
    if (cols != T || tails + 2 != n_t) return (int)cudaErrorInvalidValue;
    a.cw = cw; a.ck = ck; a.ctv = ctv; a.ctk = ctk;
    a.nums = nums; a.total = total;
    a.vals = vals; a.keys = keys; a.tv = tv; a.tk = tk; a.bits = bits;
    a.B = B; a.T = T; a.n_t = n_t; a.S = S; a.depth = depth; a.R = R;
    a.n_elem = n_elem; a.pieces = pieces; a.mixhi = mixhi; a.param = param;
    const cudaStream_t st = (cudaStream_t)stream;
    const bool nm = nums != nullptr;
    switch (bs * 2 + (nm ? 1 : 0)) {
        case 0: return alac::launch_assemble<0, false>(a, st);
        case 1: return alac::launch_assemble<0, true>(a, st);
        case 2: return alac::launch_assemble<1, false>(a, st);
        case 3: return alac::launch_assemble<1, true>(a, st);
        case 4: return alac::launch_assemble<2, false>(a, st);
        default: return alac::launch_assemble<2, true>(a, st);
    }
}
