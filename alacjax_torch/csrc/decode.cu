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
// B=4096), too few to fill the card's 132 SMs x 4 schedulers.  The walk
// costs TAPS multiply-adds and TAPS adaptation steps per sample whatever
// the lane's order, so the 30-tap instance does about 4x the 8-tap work.
//
// Design.  Per 32 lanes, a Rice warp decodes tile p's residuals (TILE
// samples of each lane) into a shared ring while an FIR warp walks tile
// p - 1; a named barrier ends each phase, so the bit cursor's chain and
// the walk overlap.  Each thread keeps its lane's state in registers: the
// Rice warp the cursor and the adaptive mean, the FIR warp the TAPS+1
// lags and the TAPS coefficients, walked by fully unrolled predicate
// chains (every array index is a compile-time constant).  On the TPU a
// lane's bits arrive through a row-prefetched sliding cache with a drift
// budget; here the Rice thread reads its row's words directly (two __ldg
// per cut, indices clamped to the image: past W-1 reads word W-1, below 0
// word 0), which a warp's rows mostly find in L1.  The FIR warp fills a
// 32-lane x 32-sample shared tile (pitch 33: no bank conflicts either
// way) and stores it to (L, S) row by row, 128 coalesced bytes per store.
// PERF.md §6 records the steps measured on the way, among them a bit
// reservoir in registers that was slower than the direct reads.
// chanbits is per lane (a stacked batch may mix SCE and CPE channels of
// several depths); the sign extensions at that width go through sext_sh,
// so a width of 33 gives 0 as alacjax does.  End bits and the error flag
// (zero-run overrun, or an order the walk does not cover) come out per
// lane.
//
// The cursor and raw instances are one warp per block of 32 lanes, the
// Rice warp alone: the cursor walks each lane's codewords and writes its
// end bit (a `skip` lane does not move: its end is its start) and err
// (the zero-run overrun; it walks no FIR, so no order to flag); the raw
// decode also stages its residuals in a 32 x 32 shared tile and stores
// them to (L, S) row by row, as the FIR warp does.  Their bound is the
// Rice chain alone (the codeword lengths' serial dependence).
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
    int L, rows, W, S;
    unsigned mb0;
    int kb;
    unsigned wb;
};

// leading-ones prefix length of the window and the k bits after its
// terminating zero
__device__ __forceinline__ void codeword(unsigned stream, int k, int& pre,
                                         unsigned& v) {
    pre = clz32(~stream);
    const unsigned body = pre + 1 >= 32 ? 0u : (stream << (pre + 1));
    v = body >> ((32 - k) & 31);
}

// A lane's bit cursor over its row: each cut reads the two words under
// the cursor directly, by clamped indices.
struct Bits {
    const unsigned* row;
    int W, bitpos;

    __device__ __forceinline__ void init(const unsigned* r, int w,
                                         int start) {
        row = r;
        W = w;
        bitpos = start;
    }

    __device__ __forceinline__ unsigned peek32() const {
        const int w = bitpos >> 5, sh = bitpos & 31;
        const int i0 = w < 0 ? 0 : (w > W - 1 ? W - 1 : w);
        const unsigned a = __ldg(row + i0);
        if (sh == 0) return a;
        const int i1 = w + 1 < 0 ? 0 : (w + 1 > W - 1 ? W - 1 : w + 1);
        return (a << sh) | (__ldg(row + i1) >> (32 - sh));
    }

    __device__ __forceinline__ unsigned peek(int nb) const {
        return peek32() >> ((32 - nb) & 31) & (nb >= 32 ? ~0u : (1u << nb) - 1u);
    }

    __device__ __forceinline__ void skip(int k) { bitpos += k; }
};

// The adaptive-Rice side of a substep (_rice_substep): one residual per
// call, 0 inside a zero run or past the lane's sample count.
struct RiceDec {
    Bits bits;
    unsigned mb, zmode, run_rem, pb, wb;
    int c, n_eff, cb, kb;
    bool err;

    __device__ __forceinline__ void init(const DecodeArgs& a, int lane,
                                         int n) {
        bits.init(a.words + (size_t)(lane % a.rows) * a.W, a.W,
                  a.start_bits[lane]);
        mb = a.mb0;
        zmode = 0u;
        run_rem = 0u;
        pb = (unsigned)a.pb[lane];
        wb = a.wb;
        c = 0;
        n_eff = n;
        cb = a.chanbits[lane];
        kb = a.kb;
        err = false;
    }

    __device__ __forceinline__ int next() {
        const bool active = c < n_eff;
        int res = 0;
        if (active && run_rem == 0u) {
            int k = 31 - clz32((mb >> QBSHIFT) + 3u);
            if (k > kb) k = kb;
            const unsigned m = (1u << k) - 1u;
            int pre;
            unsigned v;
            codeword(bits.peek32(), k, pre, v);
            unsigned n;
            if (pre >= MAX_PREFIX_32) {
                bits.skip(MAX_PREFIX_32);
                    n = bits.peek(cb);
                bits.skip(cb);
            } else {
                const bool use_v = k != 1;
                const bool vge2 = v >= 2u;
                n = (unsigned)pre * m + (use_v && vge2 ? v - 1u : 0u);
                bits.skip(pre + 1 + (use_v ? (vge2 ? k : k - 1) : 0));
            }
            const unsigned ndecode = n + zmode;
            const int half = (int)(ndecode >> 1);
            res = (ndecode & 1u) ? wneg(wadd(half, 1)) : half;

            unsigned mb_upd = pb * ndecode + mb - ((pb * mb) >> PBSHIFT);
            if (n > N_MAX_MEAN_CLAMP) mb_upd = N_MEAN_CLAMP_VAL;
            const bool trigger =
                ((mb_upd << MMULSHIFT) < QB) && (c + 1 < n_eff);
            unsigned nz_safe = 0u;
            bool overrun = false;
            if (trigger) {
                const int kz = clz32(mb_upd) - 24 + (int)((mb_upd + 16u) >> 6);
                const int kzc = kz < 0 ? 0 : (kz > 31 ? 31 : kz);
                const unsigned mz = ((1u << kzc) - 1u) & wb;
                    int pre2;
                unsigned v2;
                codeword(bits.peek32(), kzc, pre2, v2);
                unsigned nz;
                if (pre2 >= MAX_PREFIX_16) {
                    bits.skip(MAX_PREFIX_16);
                    nz = bits.peek(16);
                    bits.skip(16);
                } else {
                    const bool v2ge2 = v2 >= 2u;
                    nz = (unsigned)pre2 * (mz == 0u ? 1u : mz)
                         + (kz != 1 && v2ge2 ? v2 - 1u : 0u);
                    bits.skip(pre2 + 1
                              + (kz != 1 ? (v2ge2 ? kz : kz - 1) : 0));
                }
                overrun = (unsigned)(c + 1) + nz > (unsigned)n_eff;
                err = err || overrun;
                nz_safe = overrun ? 0u : nz;
            }
            run_rem = trigger ? nz_safe : 0u;
            zmode = (trigger && nz_safe < 65535u && !overrun) ? 1u : 0u;
            mb = trigger ? 0u : mb_upd;
        } else if (active) {
            run_rem -= 1u;
        }
        if (active) ++c;
        return res;
    }
};

// The inverse predictor of a substep (_substep_core): residual -> sample.
template <int TAPS>
struct Fir {
    int lags[TAPS + 1], coefs[TAPS];
    int na_k, den, c, n_eff, s1_acc, acc31;
    unsigned sh;                    // 32 - chanbits: sext_sh's shift
    bool mode_nz, is0, is31;

    __device__ __forceinline__ void init(const DecodeArgs& a, int lane,
                                         int n) {
        const int na = a.numactive[lane];
        na_k = na < 1 ? 1 : (na > MAX_TAPS ? MAX_TAPS : na);
        if (na_k > TAPS) na_k = TAPS;
        den = a.denshift[lane] < 1 ? 1 : a.denshift[lane];
        mode_nz = a.mode[lane] != 0;
        is0 = na == 0;
        is31 = na == 31;
        sh = 32u - (unsigned)a.chanbits[lane];
        c = 0;
        n_eff = n;
        s1_acc = 0;
        acc31 = 0;
#pragma unroll
        for (int i = 0; i <= TAPS; ++i) lags[i] = 0;
#pragma unroll
        for (int k = 0; k < TAPS; ++k)
            coefs[k] = k < a.coef_n ? a.coefs0[(size_t)lane * a.coef_n + k]
                                    : 0;
    }

    __device__ __forceinline__ int step(int res) {
        const bool active = c < n_eff;
        const int s1_acc2 = active ? wadd(s1_acc, res) : s1_acc;
        const int x_t = mode_nz ? sext_sh(s1_acc2, sh) : res;
        int top = 0;
#pragma unroll
        for (int j = 0; j <= TAPS; ++j)
            top = select_opaque(na_k == j, lags[j], top);
        const bool in_warm = c <= na_k;
        int sum1 = 1 << (den - 1);
#pragma unroll
        for (int kk = 0; kk < TAPS; ++kk)
            if (kk < na_k)
                sum1 = wadd(sum1, wmul(coefs[kk], wsub(lags[kk], top)));
        const int pred_adj = sum1 >> den;
        int out;
        if (c == 0)
            out = x_t;
        else if (in_warm)
            out = sext_sh(wadd(x_t, lags[0]), sh);
        else
            out = sext_sh(wadd(wadd(x_t, top), pred_adj), sh);

        // sign-sign adaptation from the last tap down, in place: tap kk's
        // coefficient is read only by its own step of this walk
        const bool adapt = active && !in_warm;
        const int sg = sign_of(x_t);
        int del0 = x_t;
#pragma unroll
        for (int kk = TAPS - 1; kk >= 0; --kk) {
            const bool going = sg > 0 ? del0 > 0 : del0 < 0;
            const bool act_k = adapt && sg != 0 && going && kk < na_k;
            const int dd = wsub(top, lags[kk]);
            const int sgn = sign_of(dd);
            const int upd = sg > 0 ? -sgn : sgn;
            if (active) coefs[kk] = sext(wadd(coefs[kk], act_k ? upd : 0), 16);
            const int mag = wmul(sgn, dd);
            const int term = sg > 0 ? (mag >> den) : (wneg(mag) >> den);
            if (act_k) del0 = wsub(del0, wmul(na_k - kk, term));
        }

        // special-mode overlays (mode 0: pass-through; mode 31: cumsum)
        const int acc31_2 = active ? wadd(acc31, x_t) : acc31;
        if (is0)
            out = x_t;
        else if (is31)
            out = sext_sh(acc31_2, sh);
        if (active) {
#pragma unroll
            for (int j = TAPS; j > 0; --j) lags[j] = lags[j - 1];
            lags[0] = out;
            c += 1;
        }
        s1_acc = s1_acc2;
        acc31 = acc31_2;
        return out;
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

// Warp 0 of a block decodes its 32 lanes' residuals, warp 1 walks them.
template <int TAPS>
__global__ void decode_kernel(const DecodeArgs a) {
    __shared__ int ring[2][TILE][PITCH];
    __shared__ int otile[TILE][PITCH];
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
        RiceDec r;
        r.init(a, ln, n_eff);
        for (int p = 0; p <= n_tiles; ++p) {
            if (p < n_tiles) {
                const int t0 = p * TILE, cnt = min(TILE, S - t0);
                for (int j = 0; j < cnt; ++j) ring[p & 1][j][lid] = r.next();
            }
            phase_barrier(64);
        }
        if (live) {
            a.end_bits[lane] = r.bits.bitpos;
            a.err[lane] = (r.err || bad_order) ? 1 : 0;
        }
    } else {
        // tile p - 1's samples in phase p
        Fir<TAPS> f;
        f.init(a, ln, n_eff);
        for (int p = 0; p <= n_tiles; ++p) {
            if (p > 0) {
                const int t0 = (p - 1) * TILE, cnt = min(TILE, S - t0);
                for (int j = 0; j < cnt; ++j)
                    otile[lid][j] = f.step(ring[(p - 1) & 1][j][lid]);
                __syncwarp();
                store_rows(otile, a, lane0, t0, cnt, lid);
                __syncwarp();
            }
            phase_barrier(64);
        }
    }
}

// The Rice warp alone, one per block: each lane's end bit and err.
__global__ void cursor_kernel(const DecodeArgs a) {
    const int lane = blockIdx.x * 32 + threadIdx.x;
    if (lane >= a.L) return;
    const int n_eff = (a.skip && a.skip[lane]) ? 0
                      : (a.num ? a.num[lane] : a.S);
    RiceDec r;
    r.init(a, lane, n_eff);
    const int steps = min(n_eff, a.S);     // past it every substep idles
    for (int t = 0; t < steps; ++t) r.next();
    a.end_bits[lane] = r.bits.bitpos;
    a.err[lane] = r.err ? 1 : 0;
}

// The Rice warp alone, one per block: each lane's signed residuals to
// (L, S) through a shared tile, and its end bit and err.
__global__ void raw_kernel(const DecodeArgs a) {
    __shared__ int otile[TILE][PITCH];
    const int lid = threadIdx.x;
    const int lane0 = blockIdx.x * 32, lane = lane0 + lid;
    const bool live = lane < a.L;
    const int ln = live ? lane : 0;
    const int n_eff = !live ? 0 : (a.num ? a.num[ln] : a.S);
    RiceDec r;
    r.init(a, ln, n_eff);
    for (int t0 = 0; t0 < a.S; t0 += TILE) {
        const int cnt = min(TILE, a.S - t0);
        for (int j = 0; j < cnt; ++j) otile[lid][j] = r.next();
        __syncwarp();
        store_rows(otile, a, lane0, t0, cnt, lid);
        __syncwarp();
    }
    if (live) {
        a.end_bits[lane] = r.bits.bitpos;
        a.err[lane] = r.err ? 1 : 0;
    }
}

template <int TAPS>
int launch(const DecodeArgs& a, cudaStream_t st) {
    decode_kernel<TAPS><<<(a.L + 31) / 32, 64, 0, st>>>(a);
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
                           int* err, int L, int rows, int W, int S, int taps,
                           int chanbits_max, unsigned mb0, int kb,
                           unsigned wb, void* stream) {
    if (L <= 0 || S <= 0) return (int)cudaGetLastError();
    if (coef_n < 0) return (int)cudaErrorInvalidValue;
    if (const int bad = alac::check(L, rows, W, chanbits_max)) return bad;
    const alac::DecodeArgs a{(const unsigned*)words, start_bits, chanbits,
                             pb, coefs0, coef_n, mode, numactive, denshift,
                             num, nullptr, samples, end_bits, err, L, rows,
                             W, S, mb0, kb, wb};
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
                                  int* end_bits, int* err, int L, int rows,
                                  int W, int S, int chanbits_max,
                                  unsigned mb0, int kb, unsigned wb,
                                  void* stream) {
    if (L <= 0 || S <= 0) return (int)cudaGetLastError();
    if (const int bad = alac::check(L, rows, W, chanbits_max)) return bad;
    const alac::DecodeArgs a{(const unsigned*)words, start_bits, chanbits,
                             pb, nullptr, 0, nullptr, nullptr, nullptr,
                             num, skip, nullptr, end_bits, err, L, rows, W,
                             S, mb0, kb, wb};
    alac::cursor_kernel<<<(L + 31) / 32, 32, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// The raw decode: (L, S) signed residuals, (L,) end bits and err;
// chanbits is the escape payload width.
extern "C" int alac_decode_raw(const int* words, const int* start_bits,
                               const int* chanbits, const int* pb,
                               const int* num, int* res, int* end_bits,
                               int* err, int L, int rows, int W, int S,
                               int chanbits_max, unsigned mb0, int kb,
                               unsigned wb, void* stream) {
    if (L <= 0 || S <= 0) return (int)cudaGetLastError();
    if (const int bad = alac::check(L, rows, W, chanbits_max)) return bad;
    const alac::DecodeArgs a{(const unsigned*)words, start_bits, chanbits,
                             pb, nullptr, 0, nullptr, nullptr, nullptr,
                             num, nullptr, res, end_bits, err, L, rows, W,
                             S, mb0, kb, wb};
    alac::raw_kernel<<<(L + 31) / 32, 32, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
