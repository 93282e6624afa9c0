// Fused channel decode: adaptive-Rice codewords and zero runs, the
// mode != 0 first-difference stage and the TAPS-wide adaptive FIR, one
// sample per substep, a whole channel (or, stacked, every channel of a
// packet) per launch.  One source, three instances of the full decode:
// TAPS = 8 (the production program), 16 and 30 (the codec's retry
// ladder; 30 covers every legal 5-bit order); and two of the Rice warp
// alone: the cursor (end bits and err only, no samples: the first pass
// of the stacked multichannel decode) and the raw decode (the signed
// residuals, no FIR).
//
// Replaces, at TAPS = 8: alacjax/ops/pallas/decode_step.py :: _step_kernel
// (pallas_call in decode_step_pallas, one launch per scan step of G
// substeps plus the cache shift).  At TAPS = 16 and 30:
// alacjax/ops/pallas/decode_pallas.py :: _decode_kernel (the whole-loop
// decode at a static tap count with per-lane chanbits, decode_pallas.py
// :381).  The cursor instance replaces alacjax/ops/fused_decode.py ::
// cursor_scan (an XLA scan, :337), the raw instance the raw=True mode of
// its decode_channel behind alacjax/ops/rice.py :: rice_decode (:427).
// Plain versions: alacjax_torch/ops/fused_decode.py :: decode_channel
// (raw=False and raw=True) and cursor_scan.
//
// Lanes and rows.  Lane l reads packet row l % rows of the (rows, W)
// word image: rows = L for one channel, rows = B for a stacked launch
// whose L = n_ch * B lanes are the packet's channels, channel-major
// (alacjax/codec.py:1410), each with its own start bit, chanbits and
// parameters.  The image is read in place, not repeated per channel.
//
// Bound: the per-lane serial bit cursor (each codeword's position depends
// on every earlier length) and the FIR recurrence, so the latency of one
// lane's chain; there are only B lanes per channel (4096 = 128 warps at
// B=4096), too few to fill the card's 132 SMs x 4 schedulers, so each
// warp has a scheduler to itself and every dependent instruction costs
// its whole latency.  The walk costs a multiply-add and a sign-sign step
// per tap of the lane's order per sample.
//
// Design.  Per 32 lanes, a Rice warp decodes tile p's residuals (TILE
// samples of each lane) into a shared ring, an FIR warp walks tile p - 1
// into a shared output tile, and a store warp writes tile p - 2 to (L, S)
// row by row, 128 coalesced bytes per store (tiles 32 lanes x 32 samples,
// pitch 33: no bank conflicts either way); a named barrier ends each
// phase, so the bit cursor's chain, the walk and the stores overlap.
//
// The FIR warp (Fir, fir_warp) keeps its lane's state in registers and
// walks straight-line code, no tap under a predicate:
//   - a warp walks at the narrowest width NW of 4, 8, 16, 30 (up to TAPS)
//     that covers its walking lanes' orders; taps from a lane's order up
//     hold a zero coefficient and a zero step weight, so no tap takes a
//     predicate;
//   - the sign-sign adaptation is in prefix form (the plain version's
//     reversed cumulative sum and product): each tap's step depends on
//     its own lag alone, the error tap k sees is x less the steps above
//     it (one running sum from the top tap down), and a bit mask of the
//     taps that find it on the wrong side, cut at its highest bit (clz),
//     gives the taps that act; a coefficient's update waits on the mask,
//     not on the taps above it;
//   - the lag `top` (lags[na], a per-lane index) is read from a 32-slot
//     shared history of the lane's outputs ([slot][lane], bank = lane),
//     two steps ahead, not picked by a chain of TAPS + 1 selects;
//   - every step walks, so the lags rotate unconditionally (a lane's
//     outputs past its count, where the reference's state stops, repeat
//     one output, held by a select); the step loop is not unrolled, since
//     unrolled bodies, whose lags are renamed and not moved, ran slower;
//   - the warm-up (steps t <= the warp's largest order) takes a copy of
//     the step with its selects, the rest none.
// PERF.md §6 records each step measured on the way (the FIR step table).
//
// The Rice decoder (Bits, RiceDec) is one for all five instances, and
// keeps device memory off its chain.  Each lane stages its row's words in
// a ring of RING words in shared memory, [slot][lane] at a pitch of 32
// words, so lane i always reads bank i whatever its cursor: no bank
// conflict for any mix of positions.  The copies are cp.async 4-byte
// copies of the lane's own row (rows need not be 16-byte aligned), and
// clamp as a direct read did: past W-1 word W-1, below 0 word 0.  A step
// reads one window, the 96 bits at the cursor from four staged words: the
// value codeword (at most 32 bits unless it escapes), the escape payload
// and the zero-run codeword after either (9 + 33 + 32 bits at most) all
// lie in it, so a step makes one round of shared loads.  Who fills the
// ring depends on the kernel (RiceDec's STAGED):
//   - with a store warp beside it (the full and raw decodes), the ring is
//     filled between phases.  At each phase's end the Rice warp publishes
//     its lanes' cursor words; in the next phase lane i of the store warp
//     copies the words of Rice lane i's row from that word on, a ring's
//     worth, and waits for them before the barrier.  So in a phase the
//     Rice lane reads only words that landed before it began, from the
//     words both of the last two publications cover (Bits::open); the
//     common step has no copy, no wait and no branch on its codeword.  A
//     window outside them (escapes past 30 bits a codeword on average,
//     a hostile zero-run length) reads its four words from the row in
//     device memory, that step only: a copy of its own would race the
//     store warp's copies into the same column;
//   - the cursor, one warp with no phases, refills its own ring: NPART
//     parts of PART words ahead of the cursor; entering the next part, a
//     lane refills the part it left and waits only for the part after
//     the cursor's, issued NPART - 2 parts earlier, and a cursor that
//     jumps past the staged parts restages the ring there.  A lane reads
//     only what it copied itself, so no barrier is needed.
// The value codeword's arms are selects; the zero-run codeword is decoded
// only in a step where the lane may trigger a run, by a bound of the mean
// known before the window (RUN_OFF), so its branch does not wait on the
// codeword; the warp steps together (the cursor runs every lane to the
// warp's longest count).  The step is a chain of dependent operations,
// not of loads (PERF.md §6).  chanbits is
// per lane (a stacked batch may mix SCE and CPE channels of several
// depths); the sign extensions at that width go through sext_sh, so a
// width of 33 gives 0 as alacjax does.  End bits and the error flag
// (zero-run overrun, or an order the walk does not cover) come out per
// lane.  PERF.md §6 records the steps measured on the way: a register
// reservoir refilled from device memory (slower than direct reads), then
// the one window, the ring, a warp-wide refill by the Rice warp itself
// (slower than each lane's own: dropped), a vote on the trigger, the raw
// decode's store warp, then the store warp's refill and the guard in
// place of the vote.
//
// The cursor instance is one warp per block of 32 lanes, the Rice warp
// alone: it walks each lane's codewords and writes its end bit (a `skip`
// lane does not move: its end is its start) and err (the zero-run
// overrun; it walks no FIR, so no order to flag).  The raw decode pairs
// the Rice warp with a store warp, as the full decode pairs it with the
// FIR warp: the Rice warp writes tile p's signed residuals to a shared
// [lane][sample] tile while the store warp writes tile p - 1 to (L, S)
// row by row, so the stores are off the chain.  Their bound is the Rice
// chain alone (the codeword lengths' serial dependence).
//
// `cycles` (or nullptr) receives each Rice warp's clock64 cycles inside
// its decode loop (and, for the full decode, each FIR warp's inside its
// walk, a second row): PERF.md §6 reads them as cycles per codeword.
// Three rows follow, the Rice warp's counts of lane-steps per block: those
// on which the zero-run guard fired, those on which a run began, and
// those whose window was not staged (read from device memory; for the
// cursor, its restages).
#include <climits>

#include "common.cuh"

namespace alac {

constexpr int MAX_TAPS = 30;

struct DecodeArgs {
    const unsigned* words;          // (rows, W): lane l reads row l % rows
    const int* start_bits;          // (L,)
    const int* chanbits;            // (L,)
    const int* pb;                  // (L,)
    const int* coefs0;              // (L, coef_n)
    int coef_n;
    const int* mode;                // (L,)
    const int* numactive;           // (L,)
    const int* denshift;            // (L,)
    const int* num;                 // (L,) or nullptr (S on every lane)
    const int* skip;                // (L,) or nullptr: cursor lanes that stay
    int* samples;                   // (L, S): samples, or residuals (raw)
    int* end_bits;                  // (L,)
    int* err;                       // (L,)
    long long* cycles;              // per block clock64 counts, or nullptr
    int L, rows, W, S;
    unsigned mb0;
    int kb;
    unsigned wb;
};

// x << n with PTX's shift, which gives 0 for n >= 32
__device__ __forceinline__ unsigned shl_clamp(unsigned x, unsigned n) {
    unsigned r;
    asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(n));
    return r;
}

// leading-ones prefix length of the window and the k bits after its
// terminating zero
__device__ __forceinline__ void codeword(unsigned stream, int k, int& pre,
                                         unsigned& v) {
    pre = clz32(~stream);
    const unsigned body = shl_clamp(stream, (unsigned)pre + 1u);
    v = body >> ((32 - k) & 31);
}

constexpr int RING = 64;               // staged words per lane
constexpr int PART = 16;               // words per refill (the cursor's)
constexpr int PART_BITS = 5 + 4;       // log2 of a part's bits
constexpr int NPART = RING / PART;
constexpr int WINDOW = 4;              // words a step reads

// One warp's staged words: lane i's word j in w[j % RING][i].
struct RiceRing {
    unsigned w[RING][LANES];
};

// a cp.async of one word that the compiler keeps in order with the
// ring's loads
__device__ __forceinline__ void stage4(unsigned* dst, const unsigned* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr unsigned FULL = 0xFFFFFFFFu;   // every lane of a warp

// word w of a row of W words, clamped into it
__device__ __forceinline__ const unsigned* row_word(const unsigned* row,
                                                    int w, int W) {
    return row + (w < 0 ? 0 : (w > W - 1 ? W - 1 : w));
}

// words from .. to (inclusive) of a row into a lane's column of the ring
__device__ __forceinline__ void stage_words(unsigned* col,
                                            const unsigned* row, int W,
                                            int from, int to) {
#pragma unroll 4
    for (int w = from; w <= to; ++w)
        stage4(col + (w & (RING - 1)) * LANES, row_word(row, w, W));
}

// The store warp's lane, between phases: the words [b, b + RING - 1] of
// its Rice lane's row (b the cursor's word the Rice lane published last)
// that the ring, which holds [a, a + RING - 1] (a the one before), lacks;
// issued and committed, not waited for.  Each word goes to its own slot,
// so a slot the copies write holds a word of [a, a + RING - 1] outside
// [b, b + RING - 1]: the Rice lane reads neither in this phase
// (Bits::open).
__device__ __forceinline__ void stage_ahead(unsigned* col,
                                            const unsigned* row, int W,
                                            int a, int b) {
    if (b >= a)
        stage_words(col, row, W, max(b, a + RING), b + RING - 1);
    else
        stage_words(col, row, W, b, min(b + RING - 1, a - 1));
    cp_async_commit();
}

// A lane's bit cursor over its staged words.
//   STAGED (a store warp fills the ring between phases): in a phase the
//   window may start at words first .. first + span - 1, the words that
//   both the ring's contents and the store warp's copies of the phase
//   keep in place (open); a window elsewhere is read from the row.
//   !STAGED (the lane refills its own ring): part j is the row's words
//   j*PART .. j*PART + PART - 1 (indices clamped to the row); the ring
//   holds parts part .. part + NPART - 1, of which part and part + 1 have
//   landed whenever the cursor's word lies in part `part`.
template <bool STAGED>
struct Bits {
    const unsigned* row;
    unsigned* col;                  // the lane's column of the ring
    int W, bitpos, part, first;
    unsigned span;
    unsigned fell;                  // steps not read from the ring

    __device__ __forceinline__ void copy_part(int j) {
#pragma unroll
        for (int i = 0; i < PART; ++i) {
            const int w = j * PART + i;
            stage4(col + (w & (RING - 1)) * LANES, row_word(row, w, W));
        }
    }

    // every part from p on, once no older copy is in flight
    __device__ __forceinline__ void restage(int p) {
        stage_wait<0>();
#pragma unroll 1
        for (int j = 0; j < NPART; ++j) copy_part(p + j);
        cp_async_commit();
        stage_wait<0>();
        part = p;
    }

    // STAGED: the ring holds [a, a + RING - 1] as a phase begins and the
    // store warp copies [b, b + RING - 1] into it during the phase, so
    // the words both cover stay in place; a window needs WINDOW of them.
    __device__ __forceinline__ void open(int a, int b) {
        const int d = a > b ? a - b : b - a;
        first = max(a, b);
        span = d > RING - WINDOW ? 0u : (unsigned)(RING - WINDOW + 1 - d);
    }

    __device__ __forceinline__ void init(const unsigned* r, unsigned* c,
                                         int w, int start) {
        row = r;
        col = c;
        W = w;
        bitpos = start;
        fell = 0u;
        if constexpr (STAGED) {
            const int s = start >> 5;
            stage_words(col, row, W, s, s + RING - 1);
            cp_async_commit();
            stage_wait<0>();
            open(s, s);
        } else {
            restage(start >> PART_BITS);
        }
    }

    // !STAGED, after a step: entering the next part refills the one left
    // with the part NPART ahead and waits for the part after the cursor's
    __device__ __forceinline__ void advance() {
        if constexpr (STAGED) return;
        const int p = bitpos >> PART_BITS;
        if (p == part) return;
        if (p == part + 1) {
            copy_part(part + NPART);
            cp_async_commit();
            stage_wait<NPART - 2>();
            part = p;
        } else {
            restage(p);
            ++fell;
        }
    }

    // no copy may land once the lane is done
    __device__ __forceinline__ void drain() { stage_wait<0>(); }

    // the 96 bits at the cursor, most significant first
    __device__ __forceinline__ void window(unsigned& hi, unsigned& mid,
                                          unsigned& lo) {
        const int w = bitpos >> 5, sh = bitpos & 31;
        unsigned a0 = col[(w & (RING - 1)) * LANES];
        unsigned a1 = col[((w + 1) & (RING - 1)) * LANES];
        unsigned a2 = col[((w + 2) & (RING - 1)) * LANES];
        unsigned a3 = col[((w + 3) & (RING - 1)) * LANES];
        if (STAGED && (unsigned)(w - first) >= span) {
            a0 = __ldg(row_word(row, w, W));
            a1 = __ldg(row_word(row, w + 1, W));
            a2 = __ldg(row_word(row, w + 2, W));
            a3 = __ldg(row_word(row, w + 3, W));
            ++fell;
        }
        hi = __funnelshift_l(a1, a0, sh);
        mid = __funnelshift_l(a2, a1, sh);
        lo = __funnelshift_l(a3, a2, sh);
    }
};

// The zero-run guard, a bound of the trigger known from the mean alone.
// The step's update is mb_upd = pb * nd + g (mod 2**32), with
// g = mb - ((pb * mb) >> PBSHIFT) and nd = n + zmode, and a lane triggers
// only if (mb_upd << MMULSHIFT) < QB.  Where n > N_MAX_MEAN_CLAMP the
// update is N_MEAN_CLAMP_VAL, whose (0xFFFF << 2) >= QB triggers nothing;
// elsewhere nd <= 0xFFFF + 1, so for pb <= 255 (an ALAC stream's field
// has 8 bits) 4 * pb * nd <= 4 * 255 * 2**16 < RUN_OFF = 2**26.  Then,
// with x = g << 2 and all of it mod 2**32, 4 * mb_upd = x + 4 * pb * nd
// lies below QB only if x < QB (no wrap: the sum is at least x) or
// x >= 2**32 - RUN_OFF (the sum wraps past 2**32), which is
// x + RUN_OFF (mod 2**32) < RUN_OFF + QB: one add and one compare, a
// superset of the trigger for any mean and any codeword.  A lane with a
// larger pb always enters the run block (run_lim = ~0).  Where the guard
// fires and the lane does not trigger, the block leaves it as it was.
constexpr unsigned RUN_OFF = 1u << 26;

// The adaptive-Rice side of a substep (_rice_substep): one residual per
// call, 0 inside a zero run or past the lane's sample count.  The value
// codeword, its escape payload and the zero-run codeword come from one
// window.  A lane decodes the zero-run codeword in a step where its guard
// fires, a branch of its own: a vote of the warp on the guard, taken
// before the window, cost 24 cycles a codeword more than the vote on the
// trigger after it that the guard replaced (PERF.md §6).
template <bool STAGED>
struct RiceDec {
    Bits<STAGED> bits;
    unsigned mb, zmode, run_rem, pb, wb, run_lim;
    int c, n_eff, cb, kb;
    unsigned fired, triggered;      // steps of the run block; of a run
    bool err;

    __device__ __forceinline__ void init(const DecodeArgs& a, int lane,
                                         int n, RiceRing& ring) {
        bits.init(a.words + (size_t)(lane % a.rows) * a.W,
                  &ring.w[0][threadIdx.x & 31], a.W, a.start_bits[lane]);
        mb = a.mb0;
        zmode = 0u;
        run_rem = 0u;
        pb = (unsigned)a.pb[lane];
        wb = a.wb;
        run_lim = pb <= 255u ? RUN_OFF + QB - 1u : ~0u;
        c = 0;
        n_eff = n;
        cb = a.chanbits[lane];
        kb = a.kb;
        fired = 0u;
        triggered = 0u;
        err = false;
    }

    __device__ __forceinline__ int next() {
        const bool active = c < n_eff;
        const bool decode = active && run_rem == 0u;
        // the guard, from the state before the step (RUN_OFF)
        const unsigned g = mb - ((pb * mb) >> PBSHIFT);
        const bool may = decode && (c + 1 < n_eff)
                         && (g << MMULSHIFT) + RUN_OFF <= run_lim;
        unsigned hi, mid, lo;
        bits.window(hi, mid, lo);

        int k = 31 - clz32((mb >> QBSHIFT) + 3u);
        if (k > kb) k = kb;
        const unsigned m = (1u << k) - 1u;
        int pre;
        unsigned v;
        codeword(hi, k, pre, v);
        const bool esc = pre >= MAX_PREFIX_32;
        const unsigned payload = __funnelshift_l(mid, hi, MAX_PREFIX_32);
        const unsigned n_esc = (payload >> ((32 - cb) & 31))
                               & (cb >= 32 ? ~0u : (1u << cb) - 1u);
        const bool use_v = k != 1;
        const bool vge2 = v >= 2u;
        const unsigned n = esc ? n_esc
                               : (unsigned)pre * m
                                     + (use_v && vge2 ? v - 1u : 0u);
        const int len = esc ? MAX_PREFIX_32 + cb
                            : pre + 1 + (use_v ? (vge2 ? k : k - 1) : 0);
        const unsigned ndecode = n + zmode;
        const int half = (int)(ndecode >> 1);
        const int res = (ndecode & 1u) ? wneg(wadd(half, 1)) : half;

        unsigned mb_upd = pb * ndecode + g;
        if (n > N_MAX_MEAN_CLAMP) mb_upd = N_MEAN_CLAMP_VAL;

        // the zero-run codeword at `len` bits into the window (len <= 42),
        // decoded only by a lane whose guard fires
        int adv = decode ? len : 0;
        unsigned rr = decode ? 0u : (active ? run_rem - 1u : run_rem);
        unsigned zm = decode ? 0u : zmode;
        unsigned mbn = decode ? mb_upd : mb;
        if (may) {
            const bool trigger =
                decode && ((mb_upd << MMULSHIFT) < QB) && (c + 1 < n_eff);
            ++fired;
            triggered += trigger ? 1u : 0u;
            const int kz = clz32(mb_upd) - 24 + (int)((mb_upd + 16u) >> 6);
            const int kzc = kz < 0 ? 0 : (kz > 31 ? 31 : kz);
            const unsigned mz = ((1u << kzc) - 1u) & wb;
            const bool far = len >= 32;
            const unsigned run = __funnelshift_l(far ? lo : mid,
                                                 far ? mid : hi, len);
            int pre2;
            unsigned v2;
            codeword(run, kzc, pre2, v2);
            const bool esc2 = pre2 >= MAX_PREFIX_16;
            const bool v2ge2 = v2 >= 2u;
            const unsigned nz = esc2 ? (run << MAX_PREFIX_16) >> 16
                                     : (unsigned)pre2 * (mz == 0u ? 1u : mz)
                                           + (kz != 1 && v2ge2 ? v2 - 1u
                                                               : 0u);
            const int len2 = esc2 ? MAX_PREFIX_16 + 16
                                  : pre2 + 1
                                        + (kz != 1 ? (v2ge2 ? kz : kz - 1)
                                                   : 0);
            const bool overrun =
                trigger && (unsigned)(c + 1) + nz > (unsigned)n_eff;
            err = err || overrun;
            const unsigned nz_safe = overrun ? 0u : nz;
            rr = trigger ? nz_safe : rr;
            zm = (trigger && nz_safe < 65535u && !overrun) ? 1u : zm;
            mbn = trigger ? 0u : mbn;
            adv = trigger ? adv + len2 : adv;
        }
        run_rem = rr;
        zmode = zm;
        mb = mbn;
        bits.bitpos = wadd(bits.bitpos, adv);
        c += active ? 1 : 0;
        bits.advance();
        return decode ? res : 0;
    }

    // the warp's three counts after `cycles`'s first `rows` rows
    __device__ __forceinline__ void counts(long long* cycles, int rows) {
        const unsigned n[3] = {__reduce_add_sync(FULL, fired),
                               __reduce_add_sync(FULL, triggered),
                               __reduce_add_sync(FULL, bits.fell)};
        if ((threadIdx.x & 31) == 0)
            for (int i = 0; i < 3; ++i)
                cycles[(size_t)(rows + i) * gridDim.x + blockIdx.x] = n[i];
    }
};

// the low 16 bits, sign-extended (sext(x, 16)) in one instruction: prmt
// copies bytes 0 and 1 and fills bytes 2 and 3 with byte 1's sign
__device__ __forceinline__ int sext16(int x) {
    int r;
    asm("prmt.b32 %0, %1, 0, 0x9910;" : "=r"(r) : "r"(x));
    return r;
}

constexpr int HIST = 32;             // the history ring's slots: > MAX_TAPS

// The inverse predictor of a substep (_substep_core): residual -> sample,
// for a lane whose walk is at most NW taps wide.  Every step walks: the
// reference's state stops at the lane's count, so its outputs past the
// count all equal its output at step `last` (the first step past the
// count; for order 31, whose running sum stops there, the step before),
// held by `held`.  Taps from the lane's order up carry a zero coefficient
// and a zero step weight, so they take no predicates.
template <int NW>
struct Fir {
    int lags[NW];                   // the last NW samples, newest first
    int coefs[NW];                  // 16-bit values; 0 from the order up
    int negw[NW];                   // k - na below the order, else 0
    int na, den, half, last;
    unsigned sh, on;                // sh = 32 - chanbits; on: the taps
    bool mode_nz, is0, is31;
    int s1_acc, acc31, held, top0, top1;
    int* hist;                      // the lane's column of the ring

    __device__ __forceinline__ void init(const DecodeArgs& a, int lane,
                                         int n, int na_k, int* col) {
        const int order = a.numactive[lane];
        is0 = order == 0;
        is31 = order == 31;
        na = na_k < NW ? na_k : NW;     // below na_k only on 0/31 lanes
        den = a.denshift[lane] < 1 ? 1 : a.denshift[lane];
        half = 1 << (den - 1);
        mode_nz = a.mode[lane] != 0;
        sh = 32u - (unsigned)a.chanbits[lane];
        last = is31 ? n - 1 : n;
        on = (1u << na) - 1u;
        s1_acc = 0;
        acc31 = 0;
        held = 0;
        top0 = 0;
        top1 = 0;
        hist = col;
#pragma unroll
        for (int i = 0; i < HIST; ++i) hist[i * LANES] = 0;
#pragma unroll
        for (int k = 0; k < NW; ++k) {
            lags[k] = 0;
            coefs[k] = k < na && k < a.coef_n
                           ? sext16(a.coefs0[(size_t)lane * a.coef_n + k])
                           : 0;
            negw[k] = k < na ? k - na : 0;
        }
    }

    // sample t of the lane; WARM: t may lie in some lane's warm-up
    // (t <= na), else t > na on every lane
    template <bool WARM>
    __device__ __forceinline__ int step(int res, int t) {
        s1_acc = wadd(s1_acc, res);
        const int x = mode_nz ? sext_sh(s1_acc, sh) : res;
        acc31 = wadd(acc31, x);
        const int top = top0;
        int dd[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) dd[k] = wsub(top, lags[k]);
        // sum1 = half - sum c_k dd_k, in two partial sums, the newest lag's
        // term (tap 0, which waits on the last output) added last
        int pa = 0, pb = 0;
#pragma unroll
        for (int k = NW - 1; k > 0; --k) {
            if (k & 1)
                pa = wadd(pa, wmul(coefs[k], dd[k]));
            else
                pb = wadd(pb, wmul(coefs[k], dd[k]));
        }
        const int dot = wadd(wadd(pa, pb), wmul(coefs[0], dd[0]));
        const int pred = wsub(half, dot) >> den;
        int out = sext_sh(wadd(wadd(x, top), pred), sh);
        if (WARM) {
            if (t <= na) out = sext_sh(wadd(x, lags[0]), sh);
            if (t == 0) out = x;
        }
        // special-mode overlays (mode 0: pass-through; mode 31: cumsum)
        if (is0)
            out = x;
        else if (is31)
            out = sext_sh(acc31, sh);
        held = t > last ? held : out;

        // the ring: this output in; the lag `top` of step t + 2, the output
        // of step t + 1 - na (na >= 1: this step's at the latest), out
        hist[(t & (HIST - 1)) * LANES] = out;
        top0 = top1;
        top1 = hist[((t + 1 - na) & (HIST - 1)) * LANES];

        // Sign-sign adaptation in prefix form.  Tap k's step is
        // (na - k) * (dd_k * v_k >> den), v_k = +-sign(dd_k) by the side of
        // the error, and does not depend on the taps above it; the error
        // tap k sees is x less the steps of the taps above it (a running
        // sum from the top tap down, all of which acted if k acts).  Tap
        // k fails when that error leaves x's side: err <= 0 for x > 0,
        // err >= 0 for x < 0, i.e. (unsigned)(err + bias) >= thr.  The taps
        // that act are those above the highest failure.
        const int sg = sign_of(x);
        unsigned live = sg != 0 ? on : 0u;
        if (WARM && t <= na) live = 0u;
        const int sgp = sg > 0 ? 1 : -1;
        const int bias = sg > 0 ? -1 : INT_MIN;
        const unsigned thr = sg > 0 ? 0x7FFFFFFFu : 0x80000000u;
        int h = wadd(x, bias);
        unsigned fails = 0u;
        int v[NW];
#pragma unroll
        for (int k = NW - 1; k >= 0; --k) {
            v[k] = sgp * max(min(dd[k], 1), -1);
            if ((unsigned)h >= thr) fails |= 1u << k;
            if (k > 0) h = wadd(h, wmul(negw[k], wmul(dd[k], v[k]) >> den));
        }
        const unsigned acts = live & (~0u << (32 - clz32(fails & live)));
#pragma unroll
        for (int k = 0; k < NW; ++k)
            if (acts & (1u << k)) coefs[k] = sext16(wsub(coefs[k], v[k]));
#pragma unroll
        for (int k = NW - 1; k > 0; --k) lags[k] = lags[k - 1];
        lags[0] = out;
        return held;
    }
};

// One warp stores a [lane][sample] tile of its 32 lanes to (L, S), row by
// row: cnt consecutive samples of one lane per store instruction.
__device__ __forceinline__ void store_rows(const int (*tile)[PITCH],
                                           const DecodeArgs& a, int lane0,
                                           int t0, int cnt, int lid) {
    if (lid >= cnt) return;
    int* base = a.samples + t0 + lid;
    for (int r = 0; r < 32 && lane0 + r < a.L; ++r)
        base[(size_t)(lane0 + r) * a.S] = tile[r][lid];
}

constexpr int DECODE_THREADS = 96;   // the Rice, FIR and store warps

// The FIR warp at walk width NW: tile p - 1's samples in phase p, the
// steps of the warm-up (t <= the warp's largest order) through the step
// with its selects, the rest through the one without.  The loops are not
// unrolled: a body of 4 or 8 steps (lags renamed, not moved) ran slower
// than one step at every width (PERF.md §6, the FIR step table).
// Returns its clock64 cycles inside the walk.
template <int NW>
__device__ __forceinline__ long long fir_warp(const DecodeArgs& a, int ln,
                                           int n_eff, int na_k,
                                           const int (*ring)[TILE][PITCH],
                                           int (*otile)[TILE][PITCH],
                                           int* col, int lid) {
    Fir<NW> f;
    f.init(a, ln, n_eff, na_k, col);
    const int warm = (int)__reduce_max_sync(FULL, (unsigned)f.na) + 1;
    const int n_tiles = (a.S + TILE - 1) / TILE;
    long long cyc = 0;
    for (int p = 0; p <= n_tiles + 1; ++p) {
        if (p > 0 && p <= n_tiles) {
            const long long c0 = clock64();
            const int t0 = (p - 1) * TILE, cnt = min(TILE, a.S - t0);
            const int (*in)[PITCH] = ring[(p - 1) & 1];
            int (*out)[PITCH] = otile[(p - 1) & 1];
            int j = 0;
            if (p == 1) {
#pragma unroll 1
                for (; j < min(warm, cnt); ++j)
                    out[lid][j] = f.template step<true>(in[j][lid], j);
            }
#pragma unroll 1
            for (; j < cnt; ++j)
                out[lid][j] = f.template step<false>(in[j][lid], t0 + j);
            cyc += clock64() - c0;
        }
        phase_barrier(DECODE_THREADS);
    }
    return cyc;
}

// The Rice warp beside a store warp: tile p's residuals in phase p of the
// block's `phases` (p < the tiles), to out[p & 1] at [sample][lane], or
// at [lane][sample] where LANE_MAJOR; at each phase's end it publishes
// its lanes' cursor words to pub[p & 1] for the store warp (Stager) and
// opens the words it may read in the next phase.  Returns its clock64
// cycles inside its decode loop.
template <bool LANE_MAJOR>
__device__ __forceinline__ long long rice_warp(RiceDec<true>& r,
                                               int (*out)[TILE][PITCH],
                                               int (*pub)[LANES], int S,
                                               int phases, int nthreads,
                                               int lid) {
    const int n_tiles = (S + TILE - 1) / TILE;
    int prev = r.bits.bitpos >> 5;
    long long cyc = 0;
    for (int p = 0; p < phases; ++p) {
        if (p < n_tiles) {
            const long long c0 = clock64();
            const int cnt = min(TILE, S - p * TILE);
            int (*tile)[PITCH] = out[p & 1];
#pragma unroll 2
            for (int j = 0; j < cnt; ++j) {
                const int x = r.next();
                if (LANE_MAJOR)
                    tile[lid][j] = x;
                else
                    tile[j][lid] = x;
            }
            cyc += clock64() - c0;
            const int cw = r.bits.bitpos >> 5;
            pub[p & 1][lid] = cw;
            r.bits.open(prev, cw);
            prev = cw;
        }
        phase_barrier(nthreads);
    }
    return cyc;
}

// whether the store warp stages words in phase p: those of phase p + 1,
// where the Rice warp decodes (p + 1 < n_tiles) and has published (p >= 1)
__device__ __forceinline__ bool stage_due(int p, int n_tiles) {
    return p >= 1 && p + 1 < n_tiles;
}

// Lane i of the store warp fills Rice lane i's ring between phases: in
// phase p (stage_due) the words the Rice lane reads in
// phase p + 1, from the cursor word it published at the end of phase
// p - 1 (stage_ahead), landed before the phase's barrier.  A dead lane
// reads lane 0's row, as its Rice lane does.
struct Stager {
    const unsigned* row;
    unsigned* col;
    int W, held;                    // the ring holds [held, held + RING - 1]

    __device__ __forceinline__ void init(const DecodeArgs& a, int lane,
                                         RiceRing& ring, int lid) {
        row = a.words + (size_t)(lane % a.rows) * a.W;
        col = &ring.w[0][lid];
        W = a.W;
        held = a.start_bits[lane] >> 5;
    }

    __device__ __forceinline__ void issue(int cw) {
        stage_ahead(col, row, W, held, cw);
        held = cw;
    }
};

// Warp 0 of a block decodes its 32 lanes' residuals, warp 1 walks them,
// warp 2 stores the samples and stages warp 0's words.
template <int TAPS>
__global__ void decode_kernel(const DecodeArgs a) {
    __shared__ int ring[2][TILE][PITCH];
    __shared__ int otile[2][TILE][PITCH];
    __shared__ int hist[HIST][LANES];
    __shared__ RiceRing staged;
    __shared__ int pub[2][LANES];
    const int warp = threadIdx.x >> 5, lid = threadIdx.x & 31;
    const int lane0 = blockIdx.x * 32, lane = lane0 + lid;
    const bool live = lane < a.L;
    const int ln = live ? lane : 0;         // a dead lane reads lane 0 ...
    const int n_eff = !live ? 0 : (a.num ? a.num[ln] : a.S);  // ... never
    const int S = a.S;
    const int n_tiles = (S + TILE - 1) / TILE;
    const int na = a.numactive[ln];
    const bool bad_order = na > TAPS && na != 31;

    if (warp == 0) {
        // tile p's residuals in phase p
        RiceDec<true> r;
        r.init(a, ln, n_eff, staged);
        const long long cyc = rice_warp<false>(r, ring, pub, S, n_tiles + 2,
                                               DECODE_THREADS, lid);
        r.bits.drain();
        if (a.cycles) {
            if (lid == 0) a.cycles[blockIdx.x] = cyc;
            r.counts(a.cycles, 2);
        }
        if (live) {
            a.end_bits[lane] = r.bits.bitpos;
            a.err[lane] = (r.err || bad_order) ? 1 : 0;
        }
    } else if (warp == 1) {
        int na_k = na < 1 ? 1 : (na > MAX_TAPS ? MAX_TAPS : na);
        if (na_k > TAPS) na_k = TAPS;
        // the warp walks at the narrowest width that covers its walking
        // lanes' orders (lanes of order 0 and 31 need no walk)
        const bool walks = live && na != 0 && na != 31;
        const int width =
            (int)__reduce_max_sync(FULL, walks ? (unsigned)na_k : 0u);
        int* col = &hist[0][lid];
        long long cyc;
        if (TAPS > 16 && width > 16)
            cyc = fir_warp<TAPS>(a, ln, n_eff, na_k, ring, otile, col, lid);
        else if (TAPS > 8 && width > 8)
            cyc = fir_warp<(TAPS < 16 ? TAPS : 16)>(a, ln, n_eff, na_k, ring,
                                                    otile, col, lid);
        else if (width > 4)
            cyc = fir_warp<8>(a, ln, n_eff, na_k, ring, otile, col, lid);
        else
            cyc = fir_warp<4>(a, ln, n_eff, na_k, ring, otile, col, lid);
        if (a.cycles && lid == 0) a.cycles[gridDim.x + blockIdx.x] = cyc;
    } else {
        // tile p - 2's samples to (L, S) in phase p, and warp 0's words
        Stager st;
        st.init(a, ln, staged, lid);
        for (int p = 0; p <= n_tiles + 1; ++p) {
            const bool due = stage_due(p, n_tiles);
            if (due) st.issue(pub[(p - 1) & 1][lid]);
            if (p >= 2) {
                const int t0 = (p - 2) * TILE;
                store_rows(otile[(p - 2) & 1], a, lane0, t0,
                           min(TILE, S - t0), lid);
            }
            if (due) stage_wait<0>();
            phase_barrier(DECODE_THREADS);
        }
    }
}

// The Rice warp alone, one per block: each lane's end bit and err.
__global__ void cursor_kernel(const DecodeArgs a) {
    __shared__ RiceRing staged;
    const int lane = blockIdx.x * 32 + threadIdx.x;
    const bool live = lane < a.L;
    const int ln = live ? lane : 0;         // a dead lane reads lane 0 ...
    const int n_eff = (!live || (a.skip && a.skip[ln])) ? 0    // ... never
                      : (a.num ? a.num[ln] : a.S);
    RiceDec<false> r;
    r.init(a, ln, n_eff, staged);
    // the warp steps together; past a lane's count its substeps idle
    const int steps = __reduce_max_sync(FULL, (unsigned)min(n_eff, a.S));
    const long long c0 = clock64();
    for (int t = 0; t < steps; ++t) r.next();
    const long long cyc = clock64() - c0;
    r.bits.drain();
    if (a.cycles) {
        if (threadIdx.x == 0) a.cycles[blockIdx.x] = cyc;
        r.counts(a.cycles, 1);
    }
    if (live) {
        a.end_bits[lane] = r.bits.bitpos;
        a.err[lane] = r.err ? 1 : 0;
    }
}

// The Rice warp and a store warp per block: warp 0 decodes tile p's
// signed residuals into a shared [lane][sample] tile in phase p, warp 1
// stores tile p - 1 to (L, S) and stages warp 0's words; then each lane's
// end bit and err.
__global__ void raw_kernel(const DecodeArgs a) {
    __shared__ int tiles[2][TILE][PITCH];
    __shared__ RiceRing staged;
    __shared__ int pub[2][LANES];
    const int warp = threadIdx.x >> 5, lid = threadIdx.x & 31;
    const int lane0 = blockIdx.x * 32, lane = lane0 + lid;
    const bool live = lane < a.L;
    const int ln = live ? lane : 0;
    const int n_eff = !live ? 0 : (a.num ? a.num[ln] : a.S);
    const int n_tiles = (a.S + TILE - 1) / TILE;
    if (warp == 0) {
        RiceDec<true> r;
        r.init(a, ln, n_eff, staged);
        const long long cyc = rice_warp<true>(r, tiles, pub, a.S, n_tiles + 1,
                                              64, lid);
        r.bits.drain();
        if (a.cycles) {
            if (lid == 0) a.cycles[blockIdx.x] = cyc;
            r.counts(a.cycles, 1);
        }
        if (live) {
            a.end_bits[lane] = r.bits.bitpos;
            a.err[lane] = r.err ? 1 : 0;
        }
    } else {
        Stager st;
        st.init(a, ln, staged, lid);
        for (int p = 0; p <= n_tiles; ++p) {
            const bool due = stage_due(p, n_tiles);
            if (due) st.issue(pub[(p - 1) & 1][lid]);
            if (p > 0) {
                const int t0 = (p - 1) * TILE;
                store_rows(tiles[(p - 1) & 1], a, lane0, t0,
                           min(TILE, a.S - t0), lid);
            }
            if (due) stage_wait<0>();
            phase_barrier(64);
        }
    }
}

template <int TAPS>
int launch(const DecodeArgs& a, cudaStream_t st) {
    decode_kernel<TAPS><<<(a.L + 31) / 32, DECODE_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}

// the arguments every instance checks: a lane's row, the image, and
// chanbits_max in 1..33 (33: a width one past a 32-bit channel)
static int check(int L, int rows, int W, int chanbits_max) {
    if (W <= 0 || rows <= 0 || L % rows != 0 || chanbits_max < 1
        || chanbits_max > 33)
        return (int)cudaErrorInvalidValue;
    return 0;
}

}  // namespace alac

// taps selects the instance (8, 16 or 30); every lane's chanbits must lie
// in 1..chanbits_max, and chanbits_max in 1..33.  Lane l of the L lanes
// reads row l % rows of the (rows, W) image (rows = L: one row per lane;
// rows = B: a stacked launch of L / B channels).
extern "C" int alac_decode(const int* words, const int* start_bits,
                           const int* chanbits, const int* pb,
                           const int* coefs0, int coef_n, const int* mode,
                           const int* numactive, const int* denshift,
                           const int* num, int* samples, int* end_bits,
                           int* err, long long* cycles, int L, int rows,
                           int W, int S, int taps,
                           int chanbits_max, unsigned mb0, int kb,
                           unsigned wb, void* stream) {
    if (L <= 0 || S <= 0) return (int)cudaGetLastError();
    if (coef_n < 0) return (int)cudaErrorInvalidValue;
    if (const int bad = alac::check(L, rows, W, chanbits_max)) return bad;
    const alac::DecodeArgs a{(const unsigned*)words, start_bits, chanbits,
                             pb, coefs0, coef_n, mode, numactive, denshift,
                             num, nullptr, samples, end_bits, err, cycles,
                             L, rows, W, S, mb0, kb, wb};
    const cudaStream_t st = (cudaStream_t)stream;
    switch (taps) {
        case 8: return alac::launch<8>(a, st);
        case 16: return alac::launch<16>(a, st);
        case 30: return alac::launch<30>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The cursor: (L,) end bits and err of S-sample Rice streams (num: (L,)
// sample counts or nullptr; skip: (L,) lanes that stay, or nullptr).
extern "C" int alac_decode_cursor(const int* words, const int* start_bits,
                                  const int* chanbits, const int* pb,
                                  const int* skip, const int* num,
                                  int* end_bits, int* err, long long* cycles,
                                  int L, int rows, int W, int S,
                                  int chanbits_max,
                                  unsigned mb0, int kb, unsigned wb,
                                  void* stream) {
    if (L <= 0 || S <= 0) return (int)cudaGetLastError();
    if (const int bad = alac::check(L, rows, W, chanbits_max)) return bad;
    const alac::DecodeArgs a{(const unsigned*)words, start_bits, chanbits,
                             pb, nullptr, 0, nullptr, nullptr, nullptr,
                             num, skip, nullptr, end_bits, err, cycles, L,
                             rows, W, S, mb0, kb, wb};
    alac::cursor_kernel<<<(L + 31) / 32, 32, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// The raw decode: (L, S) signed residuals, (L,) end bits and err;
// chanbits is the escape payload width.
extern "C" int alac_decode_raw(const int* words, const int* start_bits,
                               const int* chanbits, const int* pb,
                               const int* num, int* res, int* end_bits,
                               int* err, long long* cycles, int L, int rows,
                               int W, int S,
                               int chanbits_max, unsigned mb0, int kb,
                               unsigned wb, void* stream) {
    if (L <= 0 || S <= 0) return (int)cudaGetLastError();
    if (const int bad = alac::check(L, rows, W, chanbits_max)) return bad;
    const alac::DecodeArgs a{(const unsigned*)words, start_bits, chanbits,
                             pb, nullptr, 0, nullptr, nullptr, nullptr,
                             num, nullptr, res, end_bits, err, cycles, L,
                             rows, W, S, mb0, kb, wb};
    alac::raw_kernel<<<(L + 31) / 32, 64, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
