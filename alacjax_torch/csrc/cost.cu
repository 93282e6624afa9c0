// Fused adaptive-FIR prediction + adaptive-Rice cost: the encoder's
// search scan, every order of a search in one launch.
//
// Replaces: alacjax/ops/pallas/cost_pallas.py :: _kernel (pallas_call in
// _cost2_pallas_call, entered through pc_block_cost2_pallas).  Plain
// version: alacjax_torch/kernels/cost.py :: plain (alacjax_torch/ops/
// predict.py once per order).
//
// Bound: each lane is a serial recurrence over S samples.  The walk's
// coefficients depend on the previous sample's residual (FIR sum ->
// residual -> the sign-sign walk through del0 -> coefficients), and each
// Rice machine's mean on its previous codeword, so one lane's chain, not
// memory (8 bytes per sample) or arithmetic throughput, bounds it.  The
// lanes (one per channel, frame and order: 16,384 at B=4096 stereo) are
// the only parallelism, a few warps per SM.
//
// Design:
//   - one launch for every order of a search: a block of 32 lanes runs
//     each order's warps over the same x;
//   - (L, S) in and out through shared-memory tiles: the block stages
//     TILE-sample tiles of x with cp.async, double-buffered, so the next
//     tile is in flight while this one is walked; every order's walker
//     reads the same tile (x is read once for every order); residuals go
//     to a shared tile and back to (L, S) with coalesced row stores.
//     Tiles are [sample][lane] with a pitch of 33 words, so the per-lane
//     walk and the per-row copies are both free of bank conflicts;
//   - warp specialisation: per order a walker warp (FIR prediction and
//     the sign-sign adaptation) fills a residual tile, and one Rice warp
//     per cost machine prices the walker's previous tile; the machines
//     depend on the residuals alone.  Phases end at a named barrier, so
//     the per-sample chain is the walk alone, with 3 x n_orders warps
//     per block (dual) or 2 x n_orders.
//   - the starting coefficients are one (L, 16) block for every order
//     (independent frames), or one block per order (persistent banks:
//     each order walks from its own bank); a stride of 0 or L * 16
//     words selects the block, so the first case reads what it always
//     did.
// PERF.md §6 records what each of the three steps bought on an H100.
// The order (4 or 8) is a template parameter of each warp's code, so the
// FIR and the walk unroll and the lag rotation is register renaming;
// chanbits and the Rice machines' sample count num are per lane.
#include "common.cuh"

namespace alac {

constexpr int MAX_ORDERS = 2;

struct CostArgs {
    const int* x;          // (L, S)
    const int* coefs0;     // (L, 16), or (n_orders, L, 16): c0_stride
    const int* cb;         // (L,) chanbits
    const int* num;        // (L,) or nullptr (S on every lane)
    int* res;              // (n_orders, L, S)
    int* cost1;            // (n_orders, L)
    int* cost2;            // (n_orders, L), written when dual
    int* coefs_out;        // (n_orders, L, 16)
    int L, S, denshift;
    int c0_stride;         // words from one order's coefs0 to the next: 0
                           // (every order starts from one row) or L * 16
    unsigned mb0, pb;
    int kb;
    unsigned wb;
    int n_orders;
    int orders[MAX_ORDERS];
};

// The predictor walk of one lane (dp_enc.c :: pc_block, encode branch):
// lags hold the last NA+1 inputs, coefs adapt by sign-sign steps.
template <int NA>
struct Walker {
    int lags[NA + 1];
    int coefs[NA];
    int den, denhalf;
    unsigned sh;           // 32 - chanbits: sext_sh's shift

    __device__ __forceinline__ void init(const int* c0, int denshift,
                                         int cb) {
#pragma unroll
        for (int i = 0; i <= NA; ++i) lags[i] = 0;
#pragma unroll
        for (int k = 0; k < NA; ++k) coefs[k] = c0[k];
        den = denshift < 1 ? 1 : denshift;
        denhalf = 1 << (den - 1);
        sh = 32u - (unsigned)cb;
    }

    // sample t -> its residual
    __device__ __forceinline__ int step(int x_t, int t) {
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
            out = sext_sh(wsub(x_t, lags[0]), sh);
        else
            out = sext_sh(wsub(wsub(x_t, top), pred_adj), sh);

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
        return out;
    }

    // columns >= NA never adapt: they leave as they came in
    __device__ __forceinline__ void store(int* out, const int* c0) const {
#pragma unroll
        for (int k = 0; k < NA; ++k) out[k] = coefs[k];
        for (int k = NA; k < 16; ++k) out[k] = c0[k];
    }
};

// One adaptive-Rice cost machine: the mode-0 residuals (DIFF false) or
// their first difference (DIFF true).
template <bool DIFF>
struct Pricer {
    RiceState st;
    int tot, prev, n, chanbits;
    unsigned sh;           // 32 - chanbits: sext_sh's shift
    unsigned pb, wb;
    int kb;

    __device__ __forceinline__ void init(const CostArgs& a, int n_lane,
                                         int cb) {
        st = rice_init(a.mb0);
        tot = 0;
        prev = 0;
        n = n_lane;
        chanbits = cb;
        sh = 32u - (unsigned)cb;
        pb = a.pb;
        kb = a.kb;
        wb = a.wb;
    }

    __device__ __forceinline__ void step(int out, int t) {
        unsigned rv, vv;
        int rb, vl;
        int v = out;
        if (DIFF) {
            v = t == 0 ? out : sext_sh(wsub(out, prev), sh);
            prev = out;
        }
        tot += rice_step(st, v, t, n, chanbits, pb, kb, wb, rv, rb, vv, vl);
    }

    // the virtual end step (t == S) flushes a pending zero-run token (a
    // lane with num < S flushed at t == num and emits nothing here)
    __device__ __forceinline__ int finish(int S) {
        unsigned rv, vv;
        int rb, vl;
        return tot + rice_step(st, 1, S, n, chanbits, pb, kb, wb, rv, rb, vv,
                               vl);
    }
};

// ---------------------------------------------------------------------------
// (L, S) through shared-memory tiles, a walker warp and a warp per machine
// ---------------------------------------------------------------------------
struct Tiles {
    int x[2][TILE][PITCH];                  // staged input, double-buffered
    int r[MAX_ORDERS][2][TILE][PITCH];      // residual tiles per order
};

// One warp writes a residual tile back to (L, S): row by row, 32
// consecutive samples per store instruction.
__device__ __forceinline__ void store_tile(const int (*buf)[PITCH],
                                           const CostArgs& a, int o,
                                           int lane0, int tile, int lid) {
    const int t = tile * TILE + lid;
    if (t >= a.S) return;
    int* base = a.res + (size_t)o * a.L * a.S + t;
    for (int r = 0; r < LANES && lane0 + r < a.L; ++r)
        base[(size_t)(lane0 + r) * a.S] = buf[lid][r];
}

// A warp's whole life: `role` 0 walks tile p in phase p, role 1 + m runs
// cost machine m over tile p - 1 (so every warp runs one phase more than
// there are tiles); machine 0's warp also stores the residual tile.
template <int NA, bool DUAL>
__device__ void tiled_warp(Tiles& sm, const CostArgs& a, int o, int role) {
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int lid = tid & 31;
    const int lane0 = blockIdx.x * LANES;
    const int lane = lane0 + lid;
    const bool live = lane < a.L;
    const int S = a.S;
    const int n_tiles = (S + TILE - 1) / TILE;
    const int* c0 = a.coefs0 + (size_t)o * a.c0_stride
                    + (size_t)(live ? lane : 0) * 16;
    const int cb = live ? a.cb[lane] : 16;
    const int n = live && a.num ? a.num[lane] : S;

    Walker<NA> w;
    Pricer<false> p1;
    Pricer<true> p2;
    w.init(c0, a.denshift, cb);
    p1.init(a, n, cb);
    p2.init(a, n, cb);

    for (int p = 0; p <= n_tiles; ++p) {
        if (p + 1 < n_tiles)
            load_tile(sm.x[(p + 1) & 1], a.x, a.L, S, lane0, p + 1, tid,
                      nthreads);
        if (role == 0 && p < n_tiles) {
            const int (*xs)[PITCH] = sm.x[p & 1];
            int (*rs)[PITCH] = sm.r[o][p & 1];
            const int t0 = p * TILE;
            const int cnt = min(TILE, S - t0);
            for (int j = 0; j < cnt; ++j) rs[j][lid] = w.step(xs[j][lid], t0 + j);
        }
        if (role > 0 && p > 0) {
            const int (*rs)[PITCH] = sm.r[o][(p - 1) & 1];
            const int t0 = (p - 1) * TILE;
            const int cnt = min(TILE, S - t0);
            if (role == 1) {
                for (int j = 0; j < cnt; ++j) p1.step(rs[j][lid], t0 + j);
                store_tile(rs, a, o, lane0, p - 1, lid);
            } else {
                for (int j = 0; j < cnt; ++j) p2.step(rs[j][lid], t0 + j);
            }
        }
        cp_async_wait_all();
        phase_barrier(nthreads);
    }
    if (!live) return;
    const size_t ol = (size_t)o * a.L + lane;
    if (role == 0) w.store(a.coefs_out + ol * 16, c0);
    if (role == 1) a.cost1[ol] = p1.finish(S);
    if (DUAL && role == 2) a.cost2[ol] = p2.finish(S);
}

template <bool DUAL>
__global__ void cost_tiled(const CostArgs a) {
    __shared__ Tiles sm;
    const int warp = threadIdx.x >> 5;
    const int per_order = DUAL ? 3 : 2;
    const int o = warp / per_order, role = warp % per_order;
    load_tile(sm.x[0], a.x, a.L, a.S, blockIdx.x * LANES, 0, threadIdx.x,
              blockDim.x);
    cp_async_wait_all();
    phase_barrier(blockDim.x);
    if (select_opaque(o == 0, a.orders[0], a.orders[1]) == 4)
        tiled_warp<4, DUAL>(sm, a, o, role);
    else
        tiled_warp<8, DUAL>(sm, a, o, role);
}

}  // namespace alac

// x: (L, S) int32; orders: n_orders (1 or 2) values, each 4 or 8; cb:
// (L,) chanbits; num: (L,) sample counts, or nullptr for S on every lane;
// coefs0: (L, 16) for every order (c0_stride 0) or one (L, 16) row block
// per order (c0_stride L * 16, persistent coefficient banks).
// Outputs per order: res (L, S), cost1 and cost2 (L,), coefs_out (L, 16).
extern "C" int alac_cost(const int* x, const int* coefs0, const int* cb,
                         const int* num, int* res, int* cost1, int* cost2,
                         int* coefs_out, int L, int S, int order0,
                         int order1, int n_orders, int dual, int denshift,
                         int c0_stride, unsigned mb0, unsigned pb, int kb,
                         unsigned wb,
                         void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (L <= 0 || S <= 0) return (int)cudaGetLastError();
    if (n_orders < 1 || n_orders > alac::MAX_ORDERS)
        return (int)cudaErrorInvalidValue;
    if (c0_stride != 0 && c0_stride != L * 16)
        return (int)cudaErrorInvalidValue;
    alac::CostArgs a{x,  coefs0,   cb,  num, res, cost1, cost2, coefs_out,
                     L,  S,        denshift, c0_stride, mb0, pb, kb, wb,
                     n_orders, {order0, order1}};
    for (int i = 0; i < n_orders; ++i)
        if (a.orders[i] != 4 && a.orders[i] != 8)
            return (int)cudaErrorInvalidValue;
    const int blocks = (L + alac::LANES - 1) / alac::LANES;
    const int threads = 32 * (dual ? 3 : 2) * n_orders;
    if (dual)
        alac::cost_tiled<true><<<blocks, threads, 0, s>>>(a);
    else
        alac::cost_tiled<false><<<blocks, threads, 0, s>>>(a);
    return (int)cudaGetLastError();
}
