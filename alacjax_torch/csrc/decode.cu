// Fused channel decode: adaptive-Rice codewords and zero runs, the
// mode != 0 first-difference stage and the TAPS-wide adaptive FIR, one
// sample per substep, a whole channel per launch.  One source, three
// instances: TAPS = 8 (the production program), 16 and 30 (the codec's
// retry ladder; 30 covers every legal 5-bit order).
//
// Replaces, at TAPS = 8: alacjax/ops/pallas/decode_step.py :: _step_kernel
// (pallas_call in decode_step_pallas, one launch per scan step of G
// substeps plus the cache shift).  At TAPS = 16 and 30:
// alacjax/ops/pallas/decode_pallas.py :: _decode_kernel (the whole-loop
// decode at a static tap count with per-lane chanbits, decode_pallas.py
// :381).  Plain version: alacjax_torch/ops/fused_decode.py ::
// decode_channel.
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
// way) and stores it to (B, S) row by row, 128 coalesced bytes per store.
// PERF.md §6 records the steps measured on the way, among them a bit
// reservoir in registers that was slower than the direct reads.
// chanbits is per lane (a stacked batch may mix SCE and CPE channels of
// several depths).  End bits and the error flag (zero-run overrun, or an
// order the walk does not cover) come out per lane.
#include "common.cuh"

namespace alac {

constexpr int MAX_TAPS = 30;

struct DecodeArgs {
    const unsigned* words;          // (B, W)
    const int* start_bits;          // (B,)
    const int* chanbits;            // (B,)
    const int* pb;                  // (B,)
    const int* coefs0;              // (B, coef_n)
    int coef_n;
    const int* mode;                // (B,)
    const int* numactive;           // (B,)
    const int* denshift;            // (B,)
    const int* num;                 // (B,) or nullptr (S on every lane)
    int* samples;                   // (B, S)
    int* end_bits;                  // (B,)
    int* err;                       // (B,)
    int B, W, S;
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
        bits.init(a.words + (size_t)lane * a.W, a.W, a.start_bits[lane]);
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
    int cb, na_k, den, c, n_eff, s1_acc, acc31;
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
        cb = a.chanbits[lane];
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
        const int x_t = mode_nz ? sext(s1_acc2, cb) : res;
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
            out = sext(wadd(x_t, lags[0]), cb);
        else
            out = sext(wadd(wadd(x_t, top), pred_adj), cb);

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
            out = sext(acc31_2, cb);
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

// One warp stores a [lane][sample] tile of its 32 lanes to (B, S), row by
// row: cnt consecutive samples of one lane per store instruction.
__device__ __forceinline__ void store_rows(const int (*tile)[PITCH],
                                           const DecodeArgs& a, int lane0,
                                           int t0, int cnt, int lid) {
    if (lid >= cnt) return;
    int* base = a.samples + t0 + lid;
    for (int r = 0; r < 32 && lane0 + r < a.B; ++r)
        base[(size_t)(lane0 + r) * a.S] = tile[r][lid];
}

// Warp 0 of a block decodes its 32 lanes' residuals, warp 1 walks them.
template <int TAPS>
__global__ void decode_kernel(const DecodeArgs a) {
    __shared__ int ring[2][TILE][PITCH];
    __shared__ int otile[TILE][PITCH];
    const int warp = threadIdx.x >> 5, lid = threadIdx.x & 31;
    const int lane0 = blockIdx.x * 32, lane = lane0 + lid;
    const bool live = lane < a.B;
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

template <int TAPS>
int launch(const DecodeArgs& a, cudaStream_t st) {
    decode_kernel<TAPS><<<(a.B + 31) / 32, 64, 0, st>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace alac

// taps selects the instance (8, 16 or 30); every lane's chanbits must lie
// in 1..chanbits_max, and chanbits_max in 1..32.
extern "C" int alac_decode(const int* words, const int* start_bits,
                           const int* chanbits, const int* pb,
                           const int* coefs0, int coef_n, const int* mode,
                           const int* numactive, const int* denshift,
                           const int* num, int* samples, int* end_bits,
                           int* err, int B, int W, int S, int taps,
                           int chanbits_max, unsigned mb0, int kb,
                           unsigned wb, void* stream) {
    if (B <= 0 || S <= 0) return (int)cudaGetLastError();
    if (W <= 0 || coef_n < 0 || chanbits_max < 1 || chanbits_max > 32)
        return (int)cudaErrorInvalidValue;
    const alac::DecodeArgs a{(const unsigned*)words, start_bits, chanbits,
                             pb, coefs0, coef_n, mode, numactive, denshift,
                             num, samples, end_bits, err, B, W, S, mb0, kb,
                             wb};
    const cudaStream_t st = (cudaStream_t)stream;
    switch (taps) {
        case 8: return alac::launch<8>(a, st);
        case 16: return alac::launch<16>(a, st);
        case 30: return alac::launch<30>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
