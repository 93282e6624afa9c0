// Adaptive-FIR prediction alone (pc_block at static orders, no cost
// machine), and cost-only adaptive-Rice machines: the encoder's
// standalone-predictor route, which prices the residuals in a second
// pass instead of inside the prediction scan.
//
// Replaces: alacjax/ops/pallas/predict_pallas.py :: _kernel (pallas_call
// in pc_block_pallas).  Plain versions: alacjax_torch/kernels/predict.py
// :: plain_pc_block and plain_rice_cost (alacjax_torch/ops/predict.py ::
// pc_block once per order; ops/rice.py :: rice_cost of the residuals
// and, dual, of their first difference: an XLA scan in alacjax, not a
// Pallas kernel, but the route's second pass).
//
// Bound: each lane is a serial recurrence over S samples (the walk's
// coefficients depend on the previous sample's residual, each Rice
// machine's mean and run state on its previous codeword), so a lane's
// chain or the instructions its warp issues per sample, not memory (8
// bytes per sample per order), bound a launch; the lanes are the only
// parallelism.  Measured (PERF.md §6): a walker warp issues about one
// instruction a clock, so its instruction count per sample sets its
// time.
//
// Design:
//   - (L, S) in and out through shared-memory tiles: the block stages
//     TILE-sample tiles of the input with cp.async, double-buffered, so
//     the next tile is in flight while this one is walked; residuals go
//     to a shared tile and back to (L, S) with coalesced row stores.
//     Tiles are [sample][lane] at a pitch of 33 words (common.cuh);
//   - pc_block has no copy warp: warp 0 issues the next tile's cp.async
//     before it walks this one and waits for it at the phase's end, and
//     each walker stores its own residual tile, so no warp waits on
//     memory inside a tile.  A block is one warp per order: with a copy
//     warp beside one or two walkers, two walkers of co-resident blocks
//     shared a scheduler and each ran at half its issue rate;
//   - rice_cost keeps a copy warp beside its one or two machine warps:
//     measured both ways, the dual pass, the route's longest launch,
//     ran faster with it and the single pass slower (PERF.md §6);
//   - pc_block: every order of a search in one launch, one walker warp
//     per order over the same x tile (x is read once); the starting
//     coefficients are one (L, 16) block for every order or one block
//     per order (a stride of 0 or L * 16 words);
//   - rice_cost: one machine warp prices the tile, and with `dual` a
//     second prices its first difference (sample 0 as it is, then
//     sext(r[t] - r[t-1], chanbits)) from the same tile;
//   - the walker's per-sample chain is short: the terms of the lags
//     alone (the FIR differences, each tap's sign and |d|) are computed
//     off it, and each tap's weighted step and new coefficient hang off
//     the residual's sign alone, so a tap of the sign-sign walk adds one
//     compare and one select to the chain; the FIR is summed from the
//     last tap down, the order in which the walk settles the
//     coefficients;
//   - orders 1..16 are template instances, so the FIR and the walk
//     unroll and the lags and coefficients stay in registers; chanbits
//     and the machines' sample count num are per lane;
//   - `cycles` (or nullptr) receives each walker warp's clock64 cycles
//     inside its walk: PERF.md §6 reads them as cycles per step.
#include "common.cuh"

namespace alac {

constexpr int MAX_PREDICT_ORDERS = 2;

struct PredictArgs {
    const int* x;          // (L, S)
    const int* coefs0;     // (L, 16), or (n_orders, L, 16): c0_stride
    const int* cb;         // (L,) chanbits
    int* res;              // (n_orders, L, S)
    int* coefs_out;        // (n_orders, L, 16)
    long long* cycles;     // (n_orders, blocks) or nullptr
    int L, S, denshift;
    int c0_stride;         // words from one order's coefs0 to the next
    int n_orders;
    int orders[MAX_PREDICT_ORDERS];
};

// The predictor walk of one lane (dp_enc.c :: pc_block, encode branch):
// lags hold the last NA+1 inputs (lags[0] the newest), coefs adapt by
// sign-sign steps.
template <int NA>
struct Walk {
    int lags[NA + 1];
    int coefs[NA];
    int den, denhalf;
    unsigned sh;

    __device__ __forceinline__ void init(const int* c0, int denshift,
                                         int chanbits) {
#pragma unroll
        for (int i = 0; i <= NA; ++i) lags[i] = 0;
#pragma unroll
        for (int k = 0; k < NA; ++k) coefs[k] = sext(c0[k], 16);
        den = denshift < 1 ? 1 : denshift;
        denhalf = 1 << (den - 1);
        sh = 32u - (unsigned)chanbits;
    }

    __device__ __forceinline__ void push(int x_t) {
#pragma unroll
        for (int i = NA; i > 0; --i) lags[i] = lags[i - 1];
        lags[0] = x_t;
    }

    // warm-up, t <= NA: the sample itself (t == 0), then its first
    // difference; no adaptation
    __device__ __forceinline__ int warm(int x_t, int t) {
        const int out = t == 0 ? x_t : sext_sh(wsub(x_t, lags[0]), sh);
        push(x_t);
        return out;
    }

    // t > NA: the FIR residual, then the walk
    __device__ __forceinline__ int step(int x_t) {
        const int top = lags[NA];
        // off the chain: the lags' terms
        int d[NA], sgn[NA], mag[NA];
#pragma unroll
        for (int k = 0; k < NA; ++k) {
            d[k] = wsub(lags[k], top);
            const int dd = wneg(d[k]);              // top - lags[k]
            sgn[k] = sign_of(dd);
            mag[k] = wmul(sgn[k], dd);
        }
        int sum = denhalf;
#pragma unroll
        for (int k = NA - 1; k >= 0; --k)
            sum = wadd(sum, wmul(coefs[k], d[k]));
        const int out = sext_sh(wsub(wsub(x_t, top), sum >> den), sh);

        // sign-sign adaptation from the last tap down; the walk stops at
        // the first tap whose step would flip the error's side (dp_enc.c
        // early exit).  It tracks f = del0 (out > 0) or ~del0 (out < 0),
        // so a tap acts while f >= th and f falls by its weighted step
        // (~ is exact: every compare is the reference's); out == 0 gives
        // f = -1 < th = 0, and no tap acts.  Each tap's step and new
        // coefficient hang off the sign s alone, so the chain through
        // the taps is a compare and a select each.
        const bool pos = out > 0;
        const int s = pos ? 1 : -1;
        int f = pos ? out : ~out;
        const int th = pos ? 1 : 0;
#pragma unroll
        for (int k = NA - 1; k >= 0; --k) {
            const int q = wmul(s, mag[k]) >> den;
            const int w = wmul(wmul(s, NA - k), q);
            const int c = sext(wsub(coefs[k], wmul(s, sgn[k])), 16);
            const bool act = f >= th;
            f = act ? wsub(f, w) : f;
            coefs[k] = act ? c : coefs[k];
        }
        push(x_t);
        return out;
    }

    // columns >= NA never adapt: they leave as they came in
    __device__ __forceinline__ void store(int* out, const int* c0) const {
#pragma unroll
        for (int k = 0; k < NA; ++k) out[k] = coefs[k];
        for (int k = NA; k < 16; ++k) out[k] = c0[k];
    }
};

struct PredictTiles {
    int x[2][TILE][PITCH];                          // staged input
    int r[MAX_PREDICT_ORDERS][TILE][PITCH];         // residuals per order
};

// One warp writes a [sample][lane] tile back to rows of an (L, S) array:
// 32 consecutive samples of one row per store instruction.
__device__ __forceinline__ void store_rows(const int (*buf)[PITCH], int* out,
                                           int L, int S, int lane0, int tile,
                                           int lid) {
    const int t = tile * TILE + lid;
    if (t >= S) return;
    int* base = out + t;
    for (int r = 0; r < LANES && lane0 + r < L; ++r)
        base[(size_t)(lane0 + r) * S] = buf[lid][r];
}

// Warp o walks order o: in phase p it walks tile p into its residual
// tile and stores that tile's rows; warp 0 also stages tile p + 1.
template <int NA>
__device__ void predict_walk_warp(PredictTiles& sm, const PredictArgs& a,
                                  int o) {
    const int lid = threadIdx.x & 31;
    const int lane0 = blockIdx.x * LANES;
    const int lane = lane0 + lid;
    const bool live = lane < a.L;
    const int n_tiles = (a.S + TILE - 1) / TILE;
    const int* c0 = a.coefs0 + (size_t)o * a.c0_stride
                    + (size_t)(live ? lane : 0) * 16;
    int* res = a.res + (size_t)o * a.L * a.S;
    Walk<NA> w;
    w.init(c0, a.denshift, live ? a.cb[lane] : 16);
    long long cyc = 0;
    for (int p = 0; p < n_tiles; ++p) {
        if (o == 0 && p + 1 < n_tiles)
            load_tile(sm.x[(p + 1) & 1], a.x, a.L, a.S, lane0, p + 1, lid, 32);
        const long long c_start = clock64();
        const int (*xs)[PITCH] = sm.x[p & 1];
        int (*rs)[PITCH] = sm.r[o];
        const int cnt = min(TILE, a.S - p * TILE);
        int j = 0;
        if (p == 0)
            for (; j <= NA && j < cnt; ++j) rs[j][lid] = w.warm(xs[j][lid], j);
#pragma unroll 2
        for (; j < cnt; ++j) rs[j][lid] = w.step(xs[j][lid]);
        cyc += clock64() - c_start;
        __syncwarp();
        store_rows(rs, res, a.L, a.S, lane0, p, lid);
        cp_async_wait_all();
        phase_barrier(blockDim.x);
    }
    if (a.cycles && lid == 0)
        a.cycles[(size_t)o * gridDim.x + blockIdx.x] = cyc;
    if (live) w.store(a.coefs_out + ((size_t)o * a.L + lane) * 16, c0);
}

__global__ void __launch_bounds__(32 * MAX_PREDICT_ORDERS)
predict_tiled(const PredictArgs a) {
    __shared__ PredictTiles sm;
    const int o = threadIdx.x >> 5;
    if (o == 0) {
        load_tile(sm.x[0], a.x, a.L, a.S, blockIdx.x * LANES, 0,
                  threadIdx.x, 32);
        cp_async_wait_all();
    }
    phase_barrier(blockDim.x);
    switch (select_opaque(o == 0, a.orders[0], a.orders[1])) {
#define ALAC_WALK_CASE(N) \
    case N: predict_walk_warp<N>(sm, a, o); break;
        ALAC_WALK_CASE(1) ALAC_WALK_CASE(2) ALAC_WALK_CASE(3)
        ALAC_WALK_CASE(4) ALAC_WALK_CASE(5) ALAC_WALK_CASE(6)
        ALAC_WALK_CASE(7) ALAC_WALK_CASE(8) ALAC_WALK_CASE(9)
        ALAC_WALK_CASE(10) ALAC_WALK_CASE(11) ALAC_WALK_CASE(12)
        ALAC_WALK_CASE(13) ALAC_WALK_CASE(14) ALAC_WALK_CASE(15)
        ALAC_WALK_CASE(16)
#undef ALAC_WALK_CASE
    }
}

// ---------------------------------------------------------------------------
// the cost-only Rice machines
// ---------------------------------------------------------------------------
struct RiceArgs {
    const int* x;          // (L, S)
    const int* cb;         // (L,) bit sizes
    const int* num;        // (L,) or nullptr (S on every lane)
    int* cost;             // (L,), dual (2, L)
    int L, S;
    unsigned mb0, pb;
    int kb;
    unsigned wb;
};

// rice.rice_cost: the token machine's bit count over each lane's first
// num samples, of the residuals (DIFF false) or their first difference.
template <bool DIFF>
struct Machine {
    RiceState st;
    int tot, prev, n, bits;
    unsigned sh;

    __device__ __forceinline__ void init(unsigned mb0, int n_lane, int cb) {
        st = rice_init(mb0);
        tot = 0;
        prev = 0;
        n = n_lane;
        bits = cb;
        sh = 32u - (unsigned)cb;
    }

    __device__ __forceinline__ void step(const RiceArgs& a, int r, int t) {
        unsigned rv, vv;
        int rb, vl;
        int v = r;
        if (DIFF) {
            v = t == 0 ? r : sext_sh(wsub(r, prev), sh);
            prev = r;
        }
        tot += rice_step(st, v, t, n, bits, a.pb, a.kb, a.wb, rv, rb, vv, vl);
    }

    // the virtual end step (t == S) flushes a pending zero-run token
    __device__ __forceinline__ int finish(const RiceArgs& a) {
        unsigned rv, vv;
        int rb, vl;
        return tot + rice_step(st, 1, a.S, n, bits, a.pb, a.kb, a.wb, rv, rb,
                               vv, vl);
    }
};

// Warp 1 prices the residuals, warp 2 (dual) their first difference,
// tile p in phase p.
template <bool DIFF>
__device__ void rice_machine_warp(int (*xs)[TILE][PITCH], const RiceArgs& a,
                                  int* cost) {
    const int lid = threadIdx.x & 31;
    const int lane = blockIdx.x * LANES + lid;
    const bool live = lane < a.L;
    const int n_tiles = (a.S + TILE - 1) / TILE;
    Machine<DIFF> m;
    m.init(a.mb0, live && a.num ? a.num[lane] : a.S, live ? a.cb[lane] : 16);
    for (int p = 0; p < n_tiles; ++p) {
        const int (*rs)[PITCH] = xs[p & 1];
        const int t0 = p * TILE;
        const int cnt = min(TILE, a.S - t0);
        for (int j = 0; j < cnt; ++j) m.step(a, rs[j][lid], t0 + j);
        phase_barrier(blockDim.x);
    }
    if (live) cost[lane] = m.finish(a);
}

// warp 0 stages tile p + 1 while the machine warps price tile p
template <bool DUAL>
__global__ void __launch_bounds__(96) rice_tiled(const RiceArgs a) {
    __shared__ int xs[2][TILE][PITCH];
    const int warp = threadIdx.x >> 5;
    const int lane0 = blockIdx.x * LANES;
    const int n_tiles = (a.S + TILE - 1) / TILE;
    if (warp == 0) {
        load_tile(xs[0], a.x, a.L, a.S, lane0, 0, threadIdx.x, 32);
        cp_async_wait_all();
    }
    phase_barrier(blockDim.x);
    if (warp == 0) {
        for (int p = 0; p < n_tiles; ++p) {
            if (p + 1 < n_tiles)
                load_tile(xs[(p + 1) & 1], a.x, a.L, a.S, lane0, p + 1,
                          threadIdx.x, 32);
            cp_async_wait_all();
            phase_barrier(blockDim.x);
        }
    } else if (warp == 1) {
        rice_machine_warp<false>(xs, a, a.cost);
    } else if (DUAL) {
        rice_machine_warp<true>(xs, a, a.cost + a.L);
    }
}

}  // namespace alac

// x: (L, S) int32; orders: n_orders (1 or 2) distinct values in 1..16;
// cb: (L,) chanbits; coefs0: (L, 16) for every order (c0_stride 0) or
// one (L, 16) block per order (c0_stride L * 16).  Outputs per order:
// res (L, S) and coefs_out (L, 16); cycles: (n_orders, ceil(L / 32))
// int64 walk cycles per walker warp, or nullptr.
extern "C" int alac_predict(const int* x, const int* coefs0, const int* cb,
                            int* res, int* coefs_out, long long* cycles,
                            int L, int S, int order0, int order1,
                            int n_orders, int denshift, int c0_stride,
                            void* stream) {
    if (n_orders < 1 || n_orders > alac::MAX_PREDICT_ORDERS)
        return (int)cudaErrorInvalidValue;
    if (c0_stride != 0 && c0_stride != L * 16)
        return (int)cudaErrorInvalidValue;
    alac::PredictArgs a{x, coefs0, cb, res, coefs_out, cycles, L, S,
                        denshift, c0_stride, n_orders, {order0, order1}};
    for (int i = 0; i < n_orders; ++i)
        if (a.orders[i] < 1 || a.orders[i] > 16)
            return (int)cudaErrorInvalidValue;
    if (L <= 0) return (int)cudaGetLastError();
    const int blocks = (L + alac::LANES - 1) / alac::LANES;
    alac::predict_tiled<<<blocks, 32 * n_orders, 0,
                          (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// x: (L, S) int32 residuals; cb: (L,) bit sizes; num: (L,) sample
// counts, or nullptr for S on every lane.  cost: (L,) bits, or with dual
// (2, L): the residuals' and their first difference's.
extern "C" int alac_rice_cost(const int* x, const int* cb, const int* num,
                              int* cost, int L, int S, int dual,
                              unsigned mb0, unsigned pb, int kb, unsigned wb,
                              void* stream) {
    if (L <= 0) return (int)cudaGetLastError();
    const alac::RiceArgs a{x, cb, num, cost, L, S, mb0, pb, kb, wb};
    const int blocks = (L + alac::LANES - 1) / alac::LANES;
    const cudaStream_t s = (cudaStream_t)stream;
    if (dual)
        alac::rice_tiled<true><<<blocks, 96, 0, s>>>(a);
    else
        alac::rice_tiled<false><<<blocks, 64, 0, s>>>(a);
    return (int)cudaGetLastError();
}
