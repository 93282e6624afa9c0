// Adaptive-FIR prediction alone (pc_block at a static order, no cost
// machine), and a cost-only adaptive-Rice machine: the encoder's
// standalone-predictor route, which prices the residuals in a second
// pass instead of inside the prediction scan.
//
// Replaces: alacjax/ops/pallas/predict_pallas.py :: _kernel (pallas_call
// in pc_block_pallas).  Plain versions: alacjax_torch/ops/predict.py ::
// pc_block and alacjax_torch/ops/rice.py :: rice_cost (an XLA scan in
// alacjax, not a Pallas kernel, but the route's second pass; without a
// kernel here it would run as S steps of small torch ops).
//
// Bound: each lane is a serial recurrence over S samples (the walk's
// lags and coefficients, and the Rice machine's mean and run state,
// depend on the previous sample), so the latency of that chain, not
// memory (8 bytes per sample per lane) or arithmetic throughput.
//
// Design: cost.cu's walk without the Rice machines.  One thread per
// lane with the whole S loop inside and the lags and coefficients in
// registers; the order is a template parameter (an instance for each
// static order 1..16) so the FIR and adaptation loops unroll and the
// lag rotation is register renaming.  chanbits is a per-lane vector, so
// one launch holds SCE and CPE channels of any depth.  Input and
// residuals are laid out (S, L): a warp's loads and stores at step t
// coalesce.  The cost machine reads the same layout, with a per-lane
// chanbits and sample count.
#include "common.cuh"

namespace alac {

template <int NA>
__global__ void predict_kernel(const int* __restrict__ xt,
                               const int* __restrict__ coefs0,
                               const int* __restrict__ cb,
                               int* __restrict__ res_t,
                               int* __restrict__ coefs_out, int L, int S,
                               int denshift) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= L) return;
    const int chanbits = cb[lane];
    const int den = denshift < 1 ? 1 : denshift;
    const int denhalf = 1 << (den - 1);

    int lags[NA + 1];
    int coefs[NA];
#pragma unroll
    for (int i = 0; i <= NA; ++i) lags[i] = 0;
#pragma unroll
    for (int k = 0; k < NA; ++k) coefs[k] = coefs0[(size_t)lane * 16 + k];

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
    }
    // columns >= NA never adapt: they leave as they came in
#pragma unroll
    for (int k = 0; k < NA; ++k) coefs_out[(size_t)lane * 16 + k] = coefs[k];
    for (int k = NA; k < 16; ++k)
        coefs_out[(size_t)lane * 16 + k] = coefs0[(size_t)lane * 16 + k];
}

// rice.rice_cost: the token machine's bit count over each lane's first
// num samples (num == nullptr: all S), plus the virtual end step.
__global__ void rice_cost_kernel(const int* __restrict__ xt,
                                 const int* __restrict__ cb,
                                 const int* __restrict__ num,
                                 int* __restrict__ cost, int L, int S,
                                 unsigned mb0, unsigned pb, int kb,
                                 unsigned wb) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= L) return;
    const int bit_size = cb[lane];
    const int n = num ? num[lane] : S;
    RiceState st = rice_init(mb0);
    int total = 0;
    unsigned rv, vv;
    int rb, vl;
    for (int t = 0; t < S; ++t)
        total += rice_step(st, xt[(size_t)t * L + lane], t, n, bit_size, pb,
                           kb, wb, rv, rb, vv, vl);
    total += rice_step(st, 1, S, n, bit_size, pb, kb, wb, rv, rb, vv, vl);
    cost[lane] = total;
}

template <int NA>
static void launch(const int* xt, const int* coefs0, const int* cb,
                   int* res_t, int* coefs_out, int L, int S, int denshift,
                   cudaStream_t stream) {
    const int threads = 32;
    const int blocks = (L + threads - 1) / threads;
    predict_kernel<NA><<<blocks, threads, 0, stream>>>(
        xt, coefs0, cb, res_t, coefs_out, L, S, denshift);
}

}  // namespace alac

extern "C" int alac_predict(const int* xt, const int* coefs0, const int* cb,
                            int* res_t, int* coefs_out, int L, int S,
                            int order, int denshift, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (order < 1 || order > 16) return (int)cudaErrorInvalidValue;
    if (L <= 0) return (int)cudaGetLastError();
    switch (order) {
#define ALAC_PREDICT_CASE(N)                                                  \
    case N:                                                                   \
        alac::launch<N>(xt, coefs0, cb, res_t, coefs_out, L, S, denshift, s); \
        break;
        ALAC_PREDICT_CASE(1) ALAC_PREDICT_CASE(2) ALAC_PREDICT_CASE(3)
        ALAC_PREDICT_CASE(4) ALAC_PREDICT_CASE(5) ALAC_PREDICT_CASE(6)
        ALAC_PREDICT_CASE(7) ALAC_PREDICT_CASE(8) ALAC_PREDICT_CASE(9)
        ALAC_PREDICT_CASE(10) ALAC_PREDICT_CASE(11) ALAC_PREDICT_CASE(12)
        ALAC_PREDICT_CASE(13) ALAC_PREDICT_CASE(14) ALAC_PREDICT_CASE(15)
        ALAC_PREDICT_CASE(16)
#undef ALAC_PREDICT_CASE
    }
    return (int)cudaGetLastError();
}

extern "C" int alac_rice_cost(const int* xt, const int* cb, const int* num,
                              int* cost, int L, int S, unsigned mb0,
                              unsigned pb, int kb, unsigned wb, void* stream) {
    if (L <= 0) return (int)cudaGetLastError();
    const int threads = 32;
    const int blocks = (L + threads - 1) / threads;
    alac::rice_cost_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        xt, cb, num, cost, L, S, mb0, pb, kb, wb);
    return (int)cudaGetLastError();
}
