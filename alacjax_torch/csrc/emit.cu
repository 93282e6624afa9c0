// Adaptive-Rice emission: the ag_enc token machine feeding a phase-seeded
// 32-bit word accumulator that writes every completed word with its
// absolute word key.
//
// Replaces: alacjax/ops/pallas/emit_pallas.py :: _emit_kernel (pallas_call
// in _emit_pallas_call, entered through rice_encode_words_pallas).  Plain
// version: alacjax_torch/ops/rice.py :: rice_encode_words
// (emit_flush=False).
//
// Bound: bytes.  A lane reads its S residuals and writes 2 (S + 1) slot
// words and as many keys: on the main path (L=8192, S=4096) 134 MB in and
// 537 MB out, 671 MB or 0.200 ms at 3.35 TB/s; the function's own
// operations (about 42 per lane-sample) take a fifth of that.  Each lane
// is a serial recurrence (the machine's state and the accumulator's bit
// phase carry from sample to sample), so the latency of one lane's chain
// per sample is what holds a kernel above that bound.
//
// Design.  A block holds 32 lanes and four warps, in a pipeline of three
// stages a 32-step tile apart, each phase ended by a named barrier:
//   - a state warp runs the machine's state (the mean, the zero-run
//     state) and writes each step's coding parameters (the folded value,
//     k, the run's count and kz, two flags) into a three-tile shared ring;
//   - two coder warps, even and odd steps, turn a tile's parameters into
//     each step's merged token in place (the run's codeword, then the
//     residual's or its escape, at most 57 bits, with their length):
//     the codewords depend on the state alone, not on the previous step;
//   - a packer warp appends each step's merged token to the lane's
//     partial word in one branch-free step over a 96-bit window, writes
//     the step's two slots into a shared [lane][slot] tile and its first
//     key with its word count into a [lane][step] tile, stores the tile
//     to the lane's row (32 consecutive words, 128 bytes, per store
//     instruction), and stages the next tile of (L, S) input with cp.async
//     while the others work.
// So the per-step chain is the longest of three stages instead of their
// sum: the state warp's loop-carried chain (the mean's update and the run
// trigger), the coders' codeword work (each coder half the steps) and the
// packer's word accumulator; no step waits on device memory, and the
// wrapper transposes nothing.  PERF.md §6 records the design steps that
// led here and what each bought on an H100.  The bit size (the escape
// payload, the lane's chanbits) and the sample count num (partial
// frames) are per lane; every admitted bit size gives N_SLOTS = 2 slots
// per step.
#include "common.cuh"

namespace alac {

constexpr int N_SLOTS = 2;                    // rice.emit_slots(cap), cap <= 23
constexpr int CODERS = 2;                     // coder warps (even, odd steps)
constexpr int THREADS = 32 * (2 + CODERS);    // state, coders, packer
constexpr int PACKER = 1 + CODERS;            // the packer's warp index
constexpr int SPITCH = N_SLOTS * TILE + 1;    // slot tile row pitch, in words
constexpr int KPITCH = TILE + 1;              // key tile row pitch, in words

struct EmitArgs {
    const int* x;              // (L, S)
    const int* start_bits;     // (L,)
    const int* bs;             // (L,) bit sizes
    const int* num;            // (L,) or nullptr (S on every lane)
    unsigned* words;           // (L, N_SLOTS * (S + 1))
    unsigned* keys;            // (L, N_SLOTS * (S + 1))
    int* end_bits;             // (L,)
    unsigned* tail_val;        // (L,)
    unsigned* tail_key;        // (L,)
    int L, S;
    unsigned mb0, pb;
    int kb;
    unsigned wb;
};

struct Tiles {
    int x[2][TILE][PITCH];                     // staged input, double-buffered
    unsigned long long ring[3][TILE][LANES];   // parameters, then tokens
    unsigned w[LANES][SPITCH];                 // a tile's slot words
    unsigned k[LANES][KPITCH];                 // per step: slots << 30 | key
};

// The state half of rice_step (common.cuh): step t's coding parameters,
// the folded value n in the low word and above it the run's count nz (16
// bits), its kz (5 bits; 1..10 on a run), the value's k (5 bits),
// code_now and emit_run.
__device__ __forceinline__ unsigned long long state_step(RiceState& st, int x,
                                                         int t, int S,
                                                         unsigned pb, int kb) {
    const bool valid = t < S;
    const bool nonzero = x != 0;
    const bool run_end_nonzero = st.in_run && nonzero && valid;
    const unsigned run_len_new = st.run_len + 1u;
    const bool cap = st.in_run && !nonzero && valid && run_len_new >= 65535u;
    const bool flush = st.in_run && !valid;
    const bool emit_run = run_end_nonzero || cap || flush;
    const unsigned nz = cap ? run_len_new : st.run_len;
    const int run_kz = st.run_kz;
    const bool code_now = valid && (!st.in_run || run_end_nonzero);
    const unsigned zmode = run_end_nonzero ? 1u : 0u;
    int k = lg3a(st.mb >> QBSHIFT);
    if (k > kb) k = kb;
    const unsigned absx = x < 0 ? 0u - (unsigned)x : (unsigned)x;
    const unsigned n = absx * 2u - (x < 0 ? 1u : 0u) - zmode;
    unsigned mb1 = st.mb;
    if (code_now) {
        unsigned mb_upd = pb * (n + zmode) + st.mb - ((pb * st.mb) >> PBSHIFT);
        if (n > N_MAX_MEAN_CLAMP) mb_upd = N_MEAN_CLAMP_VAL;
        mb1 = mb_upd;
    }
    const bool trigger = code_now && ((mb1 << MMULSHIFT) < QB) && (t + 1 < S);
    const bool continuing = st.in_run && !nonzero && valid && !cap;
    if (trigger) {
        st.run_kz = clz32(mb1) - BITOFF + (int)((mb1 + MOFF) >> MDENSHIFT);
        mb1 = 0u;
    }
    st.mb = mb1;
    st.in_run = continuing || trigger;
    st.run_len = continuing ? run_len_new : 0u;
    const unsigned meta = (nz & 0xFFFFu) | ((unsigned)(run_kz & 31) << 16)
                          | ((unsigned)k << 21) | (code_now ? 1u << 26 : 0u)
                          | (emit_run ? 1u << 27 : 0u);
    return ((unsigned long long)meta << 32) | n;
}

// The coding half: a step's two tokens from its parameters (dyn_code_16
// for the run, dyn_code_32 and the escape payload for the value), merged
// into one of at most 25 + 32 = 57 bits with its length in the top 7 bits.
// The run's codeword sits behind a branch: a warp rarely ends a run.
__device__ __forceinline__ unsigned long long code_step(unsigned long long s,
                                                        int bit_size,
                                                        unsigned wb) {
    const unsigned n = (unsigned)s, meta = (unsigned)(s >> 32);
    const int k = (int)((meta >> 21) & 31u);
    const bool code_now = meta & (1u << 26);
    unsigned rv = 0u;
    int rl = 0;
    if (meta & (1u << 27)) {
        const int kz = (int)((meta >> 16) & 31u);
        dyn_code_16(((1u << kz) - 1u) & wb, kz, meta & 0xFFFFu, rv, rl);
    }
    const unsigned m = (1u << k) - 1u;
    int div;
    unsigned mod;
    divmod_capped(n, m, div, mod);
    const int de = mod == 0u ? 1 : 0;
    const int nb = div + k + 1 - de;
    const bool esc = div >= MAX_PREFIX_32 || nb > MAX_RICE_NUMBITS;
    const unsigned code = (((1u << div) - 1u) << (nb - div)) + mod + 1u
                          - (unsigned)de;
    const unsigned payload = (((1u << MAX_PREFIX_32) - 1u) << bit_size)
                             | (n & ((1u << bit_size) - 1u));   // bit_size < 32
    unsigned v = !code_now ? 0u : (esc ? payload : code);
    const int l = !code_now ? 0 : (esc ? MAX_PREFIX_32 + bit_size : nb);
    v &= l >= 32 ? 0xFFFFFFFFu : ((1u << l) - 1u);
    rv &= (1u << rl) - 1u;                                   // rl <= 25
    return ((unsigned long long)(rl + l) << 57)
           | ((unsigned long long)rv << l) | v;
}

// The partial word acc (its top fill bits) followed by a step's merged
// token, with no branch: the step's N_SLOTS slot words (completed words,
// then zeros), its key entry (the number of completed words << 30 | the
// first one's key) and the new partial word (rice._append_bits twice).
__device__ __forceinline__ void pack_step(unsigned& acc, int& fill,
                                          unsigned& wcount,
                                          unsigned long long e, unsigned* w,
                                          unsigned* k, unsigned base) {
    const int n = (int)(e >> 57);
    const unsigned long long tok = e & ((1ull << 57) - 1ull);
    const unsigned long long tl = n ? tok << (64 - n) : 0ull;  // left-aligned
    const unsigned long long hi = ((unsigned long long)acc << 32) | (tl >> fill);
    const unsigned long long lo = fill ? tl << (64 - fill) : 0ull;
    const unsigned w0 = (unsigned)(hi >> 32), w1 = (unsigned)hi;
    const int total = fill + n;                                // <= 88
    const int ne = total >> 5;                                 // words completed
    w[0] = ne >= 1 ? w0 : 0u;
    w[1] = ne >= 2 ? w1 : 0u;
    *k = ((unsigned)ne << 30) | (base + wcount);               // key < 2^27
    acc = ne == 0 ? w0 : (ne == 1 ? w1 : (unsigned)(lo >> 32));
    fill = total & 31;
    wcount += (unsigned)ne;
}

// The packer stores a tile's slots, steps t0 .. t0 + cnt - 1 of its 32
// lanes: each lane's N_SLOTS * cnt slots are contiguous in its row, 32
// consecutive words per store instruction; empty slots get INF_KEY.
__device__ __forceinline__ void store_slots(const Tiles& sm,
                                            const EmitArgs& a, int lane0,
                                            int t0, int cnt, int lid) {
    const size_t row = (size_t)(a.S + 1) * N_SLOTS;
    const int rows = min(LANES, a.L - lane0);
    const unsigned si = (unsigned)(lid & 1);
    if (cnt == TILE && rows == LANES) {       // a whole tile, unrolled
#pragma unroll 8
        for (int r = 0; r < LANES; ++r) {
            const size_t o = (size_t)(lane0 + r) * row + (size_t)t0 * N_SLOTS
                             + lid;
            const unsigned m0 = sm.k[r][lid >> 1], m1 = sm.k[r][16 + (lid >> 1)];
            a.words[o] = sm.w[r][lid];
            a.words[o + 32] = sm.w[r][32 + lid];
            a.keys[o] = si < (m0 >> 30) ? (m0 & 0x3FFFFFFFu) + si : INF_KEY;
            a.keys[o + 32] = si < (m1 >> 30) ? (m1 & 0x3FFFFFFFu) + si
                                             : INF_KEY;
        }
        return;
    }
    for (int r = 0; r < rows; ++r) {          // the ragged edge
        const size_t o = (size_t)(lane0 + r) * row + (size_t)t0 * N_SLOTS;
        for (int c = lid; c < N_SLOTS * cnt; c += 32) {
            const unsigned m = sm.k[r][c >> 1];
            a.words[o + c] = sm.w[r][c];
            a.keys[o + c] = si < (m >> 30) ? (m & 0x3FFFFFFFu) + si : INF_KEY;
        }
    }
}

// Phase p: the state warp fills ring[p % 3] with tile p's parameters, the
// coders turn tile p - 1's into tokens, the packer packs tile p - 2 and
// loads tile p + 1 of the input.
__global__ void __launch_bounds__(THREADS) emit_kernel(const EmitArgs a) {
    __shared__ Tiles sm;
    const int warp = threadIdx.x >> 5, lid = threadIdx.x & 31;
    const int lane0 = blockIdx.x * LANES, lane = lane0 + lid;
    const bool live = lane < a.L;
    const int steps = a.S + 1;                 // the last is the virtual end
    const int n_tiles = (steps + TILE - 1) / TILE;
    const int last = n_tiles + 1;              // phases 0 .. last

    if (warp == PACKER) {
        load_tile(sm.x[0], a.x, a.L, a.S, lane0, 0, lid, 32);
        cp_async_wait_all();
    }
    phase_barrier(THREADS);
    if (warp == 0) {
        RiceState st = rice_init(a.mb0);
        const int n = live && a.num ? a.num[lane] : a.S;   // past n: nothing
        for (int p = 0; p <= last; ++p) {
            if (p < n_tiles) {
                const int (*xt)[PITCH] = sm.x[p & 1];
                unsigned long long (*out)[LANES] = sm.ring[p % 3];
                const int t0 = p * TILE, cnt = min(TILE, steps - t0);
#pragma unroll 4
                for (int j = 0; j < cnt; ++j)
                    out[j][lid] = state_step(st, xt[j][lid], t0 + j, n, a.pb,
                                             a.kb);
            }
            phase_barrier(THREADS);
        }
    } else if (warp < PACKER) {
        const int c = warp - 1;
        const int bit_size = live ? a.bs[lane] : 16;
        for (int p = 0; p <= last; ++p) {
            if (p >= 1 && p <= n_tiles) {
                const int q = p - 1;
                unsigned long long (*rg)[LANES] = sm.ring[q % 3];
                const int cnt = min(TILE, steps - q * TILE);
#pragma unroll 4
                for (int j = c; j < cnt; j += CODERS)
                    rg[j][lid] = code_step(rg[j][lid], bit_size, a.wb);
            }
            phase_barrier(THREADS);
        }
    } else {
        const int start = live ? a.start_bits[lane] : 0;
        const unsigned base = (unsigned)(start >> 5);
        unsigned acc = 0u, wcount = 0u;
        int fill = start & 31;
        for (int p = 0; p <= last; ++p) {
            if (p + 1 < n_tiles)
                load_tile(sm.x[(p + 1) & 1], a.x, a.L, a.S, lane0, p + 1, lid,
                          32);
            if (p >= 2) {
                const int q = p - 2;
                const unsigned long long (*rg)[LANES] = sm.ring[q % 3];
                const int t0 = q * TILE, cnt = min(TILE, steps - t0);
#pragma unroll 4
                for (int j = 0; j < cnt; ++j)
                    pack_step(acc, fill, wcount, rg[j][lid],
                              &sm.w[lid][N_SLOTS * j], &sm.k[lid][j], base);
                __syncwarp();
                store_slots(sm, a, lane0, t0, cnt, lid);
                __syncwarp();
            }
            cp_async_wait_all();
            phase_barrier(THREADS);
        }
        if (live) {
            a.end_bits[lane] = (int)((base + wcount) * 32u + (unsigned)fill);
            a.tail_val[lane] = fill > 0 ? acc : 0u;
            a.tail_key[lane] = base + wcount;
        }
    }
}

}  // namespace alac

// x: (L, S) int32 residuals; bs: (L,) per-lane bit sizes, each at most
// bit_size_cap; num: (L,) per-lane sample counts, or nullptr for S.
// Outputs: words and keys (L, 2 (S + 1)), end_bits, tail_val, tail_key
// (L,).
extern "C" int alac_emit(const int* x, const int* start_bits, const int* bs,
                         const int* num, int* words, int* keys, int* end_bits,
                         int* tail_val, int* tail_key, int L, int S,
                         int bit_size_cap, unsigned mb0, unsigned pb, int kb,
                         unsigned wb, void* stream) {
    // the escape token (9-bit prefix + payload) is one <= 32-bit append,
    // and N_SLOTS slots hold every step's completed words
    if (bit_size_cap < 1 || bit_size_cap + alac::MAX_PREFIX_32 > 32 ||
        (65 + bit_size_cap) / 32 != alac::N_SLOTS || S < 0)
        return (int)cudaErrorInvalidValue;
    if (L <= 0) return (int)cudaGetLastError();
    const alac::EmitArgs a{x, start_bits, bs, num, (unsigned*)words,
                           (unsigned*)keys, end_bits, (unsigned*)tail_val,
                           (unsigned*)tail_key, L, S, mb0, pb, kb, wb};
    alac::emit_kernel<<<(L + alac::LANES - 1) / alac::LANES, alac::THREADS, 0,
                        (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
