// Fused adaptive-FIR prediction + adaptive-Rice cost: the encoder's
// search scan.
//
// Replaces: alacjax/ops/pallas/cost_pallas.py :: _kernel (pallas_call in
// _cost2_pallas_call, entered through pc_block_cost2_pallas).  Plain
// version: alacjax_torch/ops/predict.py.
//
// Bound: each lane is a serial recurrence over S samples (the predictor
// walk and both Rice machines depend on the previous sample), so the
// kernel is bound by the latency of that dependency chain, not by
// memory (8 bytes per sample per lane) or arithmetic throughput.
//
// Design: one thread per lane with the whole S loop inside; the lags,
// coefficients and both Rice states live in registers; the order (4 or
// 8) is a template parameter so the FIR and adaptation loops unroll and
// the lag rotation is register renaming.  chanbits is a per-lane vector
// (one launch holds SCE and CPE channels of any depth, the TPU kernel's
// cb row) and so is the sample count num (partial frames, the num row):
// the Rice machines stop at the lane's num, the walk runs all S.  Input
// and residuals are laid out (S, L), so a warp's loads and stores at
// step t coalesce.  Small blocks (32 threads) spread the few thousand
// lanes over many SMs.
#include "common.cuh"

namespace alac {

template <int NA, bool DUAL>
__global__ void cost_kernel(const int* __restrict__ xt,
                            const int* __restrict__ coefs0,
                            const int* __restrict__ cb,
                            const int* __restrict__ num,
                            int* __restrict__ res_t, int* __restrict__ cost1,
                            int* __restrict__ cost2,
                            int* __restrict__ coefs_out, int L, int S,
                            int denshift, unsigned mb0, unsigned pb, int kb,
                            unsigned wb) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= L) return;
    const int chanbits = cb[lane];
    const int n = num ? num[lane] : S;     // the Rice machines' sample count
    const int den = denshift < 1 ? 1 : denshift;
    const int denhalf = 1 << (den - 1);

    int lags[NA + 1];
    int coefs[NA];
#pragma unroll
    for (int i = 0; i <= NA; ++i) lags[i] = 0;
#pragma unroll
    for (int k = 0; k < NA; ++k) coefs[k] = coefs0[(size_t)lane * 16 + k];

    RiceState r1 = rice_init(mb0), r2 = rice_init(mb0);
    int tot1 = 0, tot2 = 0, prev_out = 0;
    unsigned rv, vv;
    int rb, vl;

    for (int t = 0; t < S; ++t) {
        const int x_t = xt[(size_t)t * L + lane];
        const int top = lags[NA];
        const bool in_warm = t <= NA;
        int sum1 = denhalf;
#pragma unroll
        for (int k = 0; k < NA; ++k)
            sum1 = wadd(sum1, wmul(coefs[k], wsub(lags[k], top)));
        const int pred_adj = sum1 >> den;
        int out;
        if (t == 0)
            out = x_t;
        else if (in_warm)
            out = sext(wsub(x_t, lags[0]), chanbits);
        else
            out = sext(wsub(wsub(x_t, top), pred_adj), chanbits);
        res_t[(size_t)t * L + lane] = out;

        // sign-sign adaptation; the walk stops acting at the first tap
        // whose step flips the error's side (dp_enc.c early exit)
        const int sg = sign_of(out);
        int del0 = out;
#pragma unroll
        for (int k = NA - 1; k >= 0; --k) {
            const bool going = sg > 0 ? del0 > 0 : del0 < 0;
            const bool active = !in_warm && sg != 0 && going;
            const int dd = wsub(top, lags[k]);
            const int sgn = sign_of(dd);
            const int upd = sg > 0 ? -sgn : sgn;
            coefs[k] = sext(wadd(coefs[k], active ? upd : 0), 16);
            const int mag = wmul(sgn, dd);
            const int term = sg > 0 ? (mag >> den) : (wneg(mag) >> den);
            if (active) del0 = wsub(del0, wmul(NA - k, term));
        }
#pragma unroll
        for (int i = NA; i > 0; --i) lags[i] = lags[i - 1];
        lags[0] = x_t;

        tot1 += rice_step(r1, out, t, n, chanbits, pb, kb, wb, rv, rb, vv, vl);
        if (DUAL) {
            const int d = t == 0 ? out : sext(wsub(out, prev_out), chanbits);
            tot2 += rice_step(r2, d, t, n, chanbits, pb, kb, wb, rv, rb, vv, vl);
            prev_out = out;
        }
    }
    // virtual end step (t == S): flush a pending zero-run token (a lane
    // with num < S flushed at t == num and emits nothing here)
    tot1 += rice_step(r1, 1, S, n, chanbits, pb, kb, wb, rv, rb, vv, vl);
    cost1[lane] = tot1;
    if (DUAL) {
        tot2 += rice_step(r2, 1, S, n, chanbits, pb, kb, wb, rv, rb, vv, vl);
        cost2[lane] = tot2;
    }
    // columns >= NA never adapt: they leave as they came in
#pragma unroll
    for (int k = 0; k < NA; ++k) coefs_out[(size_t)lane * 16 + k] = coefs[k];
    for (int k = NA; k < 16; ++k)
        coefs_out[(size_t)lane * 16 + k] = coefs0[(size_t)lane * 16 + k];
}

template <int NA, bool DUAL>
static void launch(const int* xt, const int* coefs0, const int* cb,
                   const int* num, int* res_t, int* cost1, int* cost2,
                   int* coefs_out, int L, int S, int denshift, unsigned mb0,
                   unsigned pb, int kb, unsigned wb, cudaStream_t stream) {
    const int threads = 32;
    const int blocks = (L + threads - 1) / threads;
    cost_kernel<NA, DUAL><<<blocks, threads, 0, stream>>>(
        xt, coefs0, cb, num, res_t, cost1, cost2, coefs_out, L, S, denshift,
        mb0, pb, kb, wb);
}

}  // namespace alac

// cb: (L,) per-lane chanbits; num: (L,) per-lane sample counts, or
// nullptr for S on every lane.
extern "C" int alac_cost(const int* xt, const int* coefs0, const int* cb,
                         const int* num, int* res_t, int* cost1, int* cost2,
                         int* coefs_out, int L, int S, int order, int dual,
                         int denshift, unsigned mb0, unsigned pb, int kb,
                         unsigned wb, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (L <= 0) return (int)cudaGetLastError();
#define ALAC_COST_ARGS xt, coefs0, cb, num, res_t, cost1, cost2, coefs_out, \
        L, S, denshift, mb0, pb, kb, wb, s
    if (order == 4 && dual)
        alac::launch<4, true>(ALAC_COST_ARGS);
    else if (order == 4)
        alac::launch<4, false>(ALAC_COST_ARGS);
    else if (order == 8 && dual)
        alac::launch<8, true>(ALAC_COST_ARGS);
    else if (order == 8)
        alac::launch<8, false>(ALAC_COST_ARGS);
    else
        return (int)cudaErrorInvalidValue;
#undef ALAC_COST_ARGS
    return (int)cudaGetLastError();
}
