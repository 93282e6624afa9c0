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
// Design: one thread per lane runs all S substeps with the Rice state,
// the TAPS+1 lags and the TAPS coefficients in registers, walked by fully
// unrolled predicate chains (every array index is a compile-time
// constant, so nothing goes to local memory unless ptxas spills).  On the
// TPU a lane's bits arrive through a row-prefetched sliding cache with a
// drift budget; here a thread reads its own words directly through the
// read-only cache, by an index clamped to the image, so there is no
// refill, no cache shift and no underrun flag.  chanbits is per lane (a
// stacked batch may mix SCE and CPE channels of several depths).  Samples
// are written (S, B) so a warp's stores coalesce; end bits and the error
// flag (zero-run overrun, or an order the walk does not cover) come out
// per lane.
#include "common.cuh"

namespace alac {

constexpr int MAX_TAPS = 30;

__device__ __forceinline__ unsigned read32(const unsigned* __restrict__ row,
                                           int W, int bitpos) {
    const int w = bitpos >> 5, sh = bitpos & 31;
    const int i0 = w < 0 ? 0 : (w > W - 1 ? W - 1 : w);
    const unsigned a = __ldg(row + i0);
    if (sh == 0) return a;
    const int i1 = w + 1 < 0 ? 0 : (w + 1 > W - 1 ? W - 1 : w + 1);
    return (a << sh) | (__ldg(row + i1) >> (32 - sh));
}

__device__ __forceinline__ unsigned read_bits(const unsigned* __restrict__ row,
                                              int W, int bitpos, int nbits) {
    const unsigned mask = nbits >= 32 ? 0xFFFFFFFFu : ((1u << nbits) - 1u);
    return (read32(row, W, bitpos) >> ((32 - nbits) & 31)) & mask;
}

// leading-ones prefix length of the window and the k bits after its
// terminating zero
__device__ __forceinline__ void codeword(unsigned stream, int k, int& pre,
                                         unsigned& v) {
    pre = clz32(~stream);
    const unsigned body = pre + 1 >= 32 ? 0u : (stream << (pre + 1));
    v = body >> ((32 - k) & 31);
}

template <int TAPS>
__global__ void decode_kernel(const unsigned* __restrict__ words,
                              const int* __restrict__ start_bits,
                              const int* __restrict__ chanbits,
                              const int* __restrict__ pb_lane,
                              const int* __restrict__ coefs0, int coef_n,
                              const int* __restrict__ mode,
                              const int* __restrict__ numactive,
                              const int* __restrict__ denshift,
                              const int* __restrict__ num,
                              int* __restrict__ samples_t,
                              int* __restrict__ end_bits,
                              int* __restrict__ err_out, int B, int W, int S,
                              unsigned mb0, int kb, unsigned wb) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    const unsigned* row = words + (size_t)lane * W;
    const int cb = chanbits[lane];
    const int n_eff = num ? num[lane] : S;
    const unsigned pb = (unsigned)pb_lane[lane];
    const int na = numactive[lane];
    int na_k = na < 1 ? 1 : (na > MAX_TAPS ? MAX_TAPS : na);
    if (na_k > TAPS) na_k = TAPS;
    const int den = denshift[lane] < 1 ? 1 : denshift[lane];
    const int denhalf = 1 << (den - 1);
    const bool mode_nz = mode[lane] != 0;
    const bool is0 = na == 0, is31 = na == 31;

    int bitpos = start_bits[lane];
    unsigned mb = mb0, zmode = 0u, run_rem = 0u;
    int c = 0;
    bool err = false;
    int lags[TAPS + 1], coefs[TAPS];
#pragma unroll
    for (int i = 0; i <= TAPS; ++i) lags[i] = 0;
#pragma unroll
    for (int k = 0; k < TAPS; ++k)
        coefs[k] = k < coef_n ? coefs0[(size_t)lane * coef_n + k] : 0;
    int s1_acc = 0, acc31 = 0;

    for (int i = 0; i < S; ++i) {
        // ---- Rice codeword or zero-run sample (_rice_substep) ----
        const bool active = c < n_eff;
        const bool in_run = run_rem > 0u;
        const bool decode_now = active && !in_run;
        int res = 0;
        if (decode_now) {
            int k = 31 - clz32((mb >> QBSHIFT) + 3u);
            if (k > kb) k = kb;
            const unsigned m = (1u << k) - 1u;
            int pre;
            unsigned v;
            codeword(read32(row, W, bitpos), k, pre, v);
            const bool esc = pre >= MAX_PREFIX_32;
            const bool use_v = k != 1 && !esc;
            const bool vge2 = v >= 2u;
            unsigned n;
            int adv;
            if (esc) {
                n = read_bits(row, W, bitpos + MAX_PREFIX_32, cb);
                adv = MAX_PREFIX_32 + cb;
            } else {
                n = (unsigned)pre * m + (use_v && vge2 ? v - 1u : 0u);
                adv = pre + 1 + (use_v ? (vge2 ? k : k - 1) : 0);
            }
            const unsigned ndecode = n + zmode;
            const int half = (int)(ndecode >> 1);
            res = (ndecode & 1u) ? wneg(wadd(half, 1)) : half;

            unsigned mb_upd = pb * ndecode + mb - ((pb * mb) >> PBSHIFT);
            if (n > N_MAX_MEAN_CLAMP) mb_upd = N_MEAN_CLAMP_VAL;
            const bool trigger =
                ((mb_upd << MMULSHIFT) < QB) && (c + 1 < n_eff);
            int adv2 = 0;
            unsigned nz_safe = 0u;
            bool overrun = false;
            if (trigger) {
                const int kz = clz32(mb_upd) - 24 + (int)((mb_upd + 16u) >> 6);
                const int kzc = kz < 0 ? 0 : (kz > 31 ? 31 : kz);
                const unsigned mz = ((1u << kzc) - 1u) & wb;
                const int pos2 = bitpos + adv;
                int pre2;
                unsigned v2;
                codeword(read32(row, W, pos2), kzc, pre2, v2);
                const bool v2ge2 = v2 >= 2u;
                unsigned nz;
                if (pre2 >= MAX_PREFIX_16) {
                    nz = read_bits(row, W, pos2 + MAX_PREFIX_16, 16);
                    adv2 = MAX_PREFIX_16 + 16;
                } else {
                    nz = (unsigned)pre2 * (mz == 0u ? 1u : mz)
                         + (kz != 1 && v2ge2 ? v2 - 1u : 0u);
                    adv2 = pre2 + 1 + (kz != 1 ? (v2ge2 ? kz : kz - 1) : 0);
                }
                overrun = (unsigned)(c + 1) + nz > (unsigned)n_eff;
                err = err || overrun;
                nz_safe = overrun ? 0u : nz;
            }
            run_rem = trigger ? nz_safe : 0u;
            zmode = (trigger && nz_safe < 65535u && !overrun) ? 1u : 0u;
            mb = trigger ? 0u : mb_upd;
            bitpos = bitpos + adv + (trigger ? adv2 : 0);
        } else if (active) {
            run_rem -= 1u;
        }

        // ---- inverse predictor (_substep_core) ----
        const int s1_acc2 = active ? wadd(s1_acc, res) : s1_acc;
        const int x_t = mode_nz ? sext(s1_acc2, cb) : res;
        int top = 0;
#pragma unroll
        for (int j = 0; j <= TAPS; ++j)
            if (na_k == j) top = lags[j];
        const bool in_warm = c <= na_k;
        int sum1 = denhalf;
#pragma unroll
        for (int kk = 0; kk < TAPS; ++kk)
            if (kk < na_k) sum1 = wadd(sum1, wmul(coefs[kk], wsub(lags[kk], top)));
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
        samples_t[(size_t)i * B + lane] = out;

        if (active) {
#pragma unroll
            for (int j = TAPS; j > 0; --j) lags[j] = lags[j - 1];
            lags[0] = out;
            c += 1;
        }
        s1_acc = s1_acc2;
        acc31 = acc31_2;
    }
    end_bits[lane] = bitpos;
    err_out[lane] = (err || (na > TAPS && na != 31)) ? 1 : 0;
}

template <int TAPS>
int launch(const int* words, const int* start_bits, const int* chanbits,
           const int* pb, const int* coefs0, int coef_n, const int* mode,
           const int* numactive, const int* denshift, const int* num,
           int* samples_t, int* end_bits, int* err, int B, int W, int S,
           unsigned mb0, int kb, unsigned wb, cudaStream_t stream) {
    const int threads = 32;
    decode_kernel<TAPS><<<(B + threads - 1) / threads, threads, 0, stream>>>(
        (const unsigned*)words, start_bits, chanbits, pb, coefs0, coef_n,
        mode, numactive, denshift, num, samples_t, end_bits, err, B, W, S,
        mb0, kb, wb);
    return (int)cudaGetLastError();
}

}  // namespace alac

// taps selects the instance (8, 16 or 30); every lane's chanbits must lie
// in 1..chanbits_max, and chanbits_max in 1..32.
extern "C" int alac_decode(const int* words, const int* start_bits,
                           const int* chanbits, const int* pb,
                           const int* coefs0, int coef_n, const int* mode,
                           const int* numactive, const int* denshift,
                           const int* num, int* samples_t, int* end_bits,
                           int* err, int B, int W, int S, int taps,
                           int chanbits_max, unsigned mb0, int kb,
                           unsigned wb, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    if (W <= 0 || coef_n < 0 || chanbits_max < 1 || chanbits_max > 32)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define ALAC_DECODE_ARGS                                                    \
    words, start_bits, chanbits, pb, coefs0, coef_n, mode, numactive,      \
        denshift, num, samples_t, end_bits, err, B, W, S, mb0, kb, wb, st
    switch (taps) {
        case 8: return alac::launch<8>(ALAC_DECODE_ARGS);
        case 16: return alac::launch<16>(ALAC_DECODE_ARGS);
        case 30: return alac::launch<30>(ALAC_DECODE_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef ALAC_DECODE_ARGS
}
