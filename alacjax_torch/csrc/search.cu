// The encode search's stream glue, in int32 with the reference's wraps:
// the stereo mixes of every CPE (the mixres trial's dilated candidate
// streams, and the chosen mix written into the search's stacked input),
// then each searched stream's winning (order, stage) and its residual row.
//
// Replaces: no TPU kernel.  The torch glue of the encode's search
// (alacjax/codec.py :: _mixres_select, _search_channels and the mix of
// each CPE before the search, XLA there), in the port about 190 int64
// torch operations and 9 host syncs a stereo call (each Python int that
// matrix.mix took crossed to the card in a pageable copy).  Plain
// versions: alacjax_torch/ops/search.py.
//
// Bound: memory, no dependence between samples.  mix_kernel, trial form:
// each CPE's two (B, S) channels read once (the reads at stride 4 touch
// every sector) and (MAX_RES + 3) rows of S / 4 written, about 0.075 ms a
// B = S = 4096 CPE at 3.35 TB/s; full form: two channels read, U and V
// written, 0.08 ms a CPE.  pick_kernel: the winning order's residual row
// read and one row written, 0.04 ms a B = S = 4096 stream.
//
// Design: a block is SEARCH_THREADS threads of one lane, so its loads and
// stores coalesce and each per-lane argument is one load that the block
// shares.  A thread takes V = 4 neighbouring samples (16-byte loads and
// stores) where the row length is a multiple of 4 and every pointer is
// 16-byte aligned (every codec call at S = 4096), else one.  mix_kernel
// serves every CPE of a call in one launch, a job each (blockIdx.y); the
// ints that matrix.mix took as tensors (mixbits, a constant mixres) are
// kernel arguments.  pick_kernel reads its lane's candidate costs, takes
// the first minimum (torch.argmin's), and reads only the winning order's
// residual row; a stage-2 lane writes its first difference at the lane's
// chanbits through sext_sh (0 at 33 bits, as sign_extend gives).  Its
// row loads wait on the cost loads, so a thread takes four groups of V
// samples and issues their loads together (on an H100 one group a
// thread reached 64% of the bytes bound, the mixes 90%).
#include "common.cuh"

namespace alac {

constexpr int SEARCH_THREADS = 256;
constexpr int MAX_MIX_JOBS = 16;

struct MixArgs {
    const int* l[MAX_MIX_JOBS];          // (B, S) per job
    const int* r[MAX_MIX_JOBS];
    const long long* mixres[MAX_MIX_JOBS];  // (B,) per lane, or nullptr
    int* out[MAX_MIX_JOBS];              // trial: the job's row blocks;
                                         // full: U's rows, V's B rows on
    int mr[MAX_MIX_JOBS];                // the job's mixres, mixres[j] null
    int B, S, So, mixbits, nres, dil, sblocks;
};

struct PickArgs {
    const int* res;                      // (n, L, S), a row block per order
    const int* cost1;                    // (n, L) stage 1
    const int* cost2;                    // (n, L) stage 2, or nullptr
    const int* chanbits;                 // (L,), or nullptr: cb
    int* out;                            // (L, S)
    long long* sel;                      // (3, L): order, mode, Rice bits
    int L, S, n, od0, od1, cb, sblocks;
};

// matrix.mix's U where mixres != 0: (mixres*L + ((1<<mixbits)-mixres)*R)
// >> mixbits, the sum wrapped to 32 bits, the shift arithmetic
__device__ __forceinline__ int mix_u(int l, int r, int mr, int m2, int sh) {
    return wadd(wmul(mr, l), wmul(m2, r)) >> sh;
}

// TRIAL: the job's candidate rows at every dil-th sample: L, R, U at
// mixres 1..nres, V (a block of B rows each, So columns).  Else: the job's
// U and V at the lane's mixres (L and R where it is 0).
template <bool TRIAL, int V>
__global__ void __launch_bounds__(SEARCH_THREADS) mix_kernel(const MixArgs a) {
    const int j = blockIdx.y;
    const int b = blockIdx.x / a.sblocks;
    const int c0 = ((blockIdx.x - b * a.sblocks) * SEARCH_THREADS + threadIdx.x) * V;
    if (c0 >= a.So) return;
    const size_t S = a.S;
    const int* lp = a.l[j] + b * S;
    const int* rp = a.r[j] + b * S;
    const int sh = a.mixbits;
    int l[V], r[V], u[V], v[V];
    if constexpr (TRIAL) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const size_t at = (size_t)(c0 + k) * a.dil;
            l[k] = __ldg(lp + at);
            r[k] = __ldg(rp + at);
            v[k] = wsub(l[k], r[k]);
        }
        const size_t blk = (size_t)a.B * a.So;
        int* o = a.out[j] + (size_t)b * a.So + c0;
        store_v<V>(o, l);
        store_v<V>(o + blk, r);
        for (int m = 1; m <= a.nres; ++m) {
            const int m2 = (int)((1u << sh) - (unsigned)m);
#pragma unroll
            for (int k = 0; k < V; ++k) u[k] = mix_u(l[k], r[k], m, m2, sh);
            store_v<V>(o + (size_t)(1 + m) * blk, u);
        }
        store_v<V>(o + (size_t)(a.nres + 2) * blk, v);
    } else {
        load_v<V>(l, lp + c0);
        load_v<V>(r, rp + c0);
        const long long mr64 = a.mixres[j] ? __ldg(a.mixres[j] + b) : a.mr[j];
        if (mr64 != 0) {
            const int mr = (int)mr64;
            const int m2 = (int)((1u << sh) - (unsigned)mr);
#pragma unroll
            for (int k = 0; k < V; ++k) {
                u[k] = mix_u(l[k], r[k], mr, m2, sh);
                v[k] = wsub(l[k], r[k]);
            }
        } else {
#pragma unroll
            for (int k = 0; k < V; ++k) { u[k] = l[k]; v[k] = r[k]; }
        }
        int* o = a.out[j] + b * S + c0;
        store_v<V>(o, u);
        store_v<V>(o + (size_t)a.B * S, v);
    }
}

// V samples a thread in each of CH chunks SEARCH_THREADS * V apart: the
// chunks' loads issue together once the lane's choice is known (its
// address waits on the cost loads)
template <int V, int CH>
__global__ void __launch_bounds__(SEARCH_THREADS) pick_kernel(const PickArgs a) {
    const int b = blockIdx.x / a.sblocks;
    const int s0 = ((blockIdx.x - b * a.sblocks) * SEARCH_THREADS * CH
                    + threadIdx.x) * V;
    if (s0 >= a.S) return;
    // candidates (order, stage) in torch.argmin's order; the first minimum
    long long best = 0;
    int bi = 0, bmode = 0, brice = 0;
    for (int i = 0; i < a.n; ++i) {
        const int od = i ? a.od1 : a.od0;
        for (int stage = 0; stage < (a.cost2 ? 2 : 1); ++stage) {
            const int rc = __ldg((stage ? a.cost2 : a.cost1) + (size_t)i * a.L + b);
            const long long c = 16 + 16LL * od + rc;
            if ((i == 0 && stage == 0) || c < best) {
                best = c; bi = i; bmode = stage ? 15 : 0; brice = rc;
            }
        }
    }
    if (s0 == 0) {
        a.sel[b] = bi ? a.od1 : a.od0;
        a.sel[(size_t)a.L + b] = bmode;
        a.sel[2 * (size_t)a.L + b] = brice;
    }
    const size_t S = a.S;
    const int* src = a.res + ((size_t)bi * a.L + b) * S;
    int* dst = a.out + b * S;
    constexpr int STEP = SEARCH_THREADS * V;
    int x[CH][V], prev[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
        const int s = s0 + c * STEP;
        if (s < a.S) {
            load_v<V>(x[c], src + s);
            prev[c] = s ? __ldg(src + s - 1) : 0;
        }
    }
    // stage 2: predict.wrap_diff, the first sample as it is
    const unsigned sh = (unsigned)(32 - (a.chanbits ? __ldg(a.chanbits + b) : a.cb));
#pragma unroll
    for (int c = 0; c < CH; ++c) {
        const int s = s0 + c * STEP;
        if (s >= a.S) break;
        if (bmode) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const int d = (s + k) ? sext_sh(wsub(x[c][k], prev[c]), sh) : x[c][k];
                prev[c] = x[c][k];
                x[c][k] = d;
            }
        }
        store_v<V>(dst + s, x[c]);
    }
}

static int blocks_for(int rows, int cols, int per_thread, int& sblocks) {
    const int per_block = SEARCH_THREADS * per_thread;
    sblocks = (cols + per_block - 1) / per_block;
    if ((long long)rows * sblocks > 0x7fffffffLL) return -1;
    return rows * sblocks;
}

template <bool TRIAL, int V>
int launch_mix(MixArgs a, int n, cudaStream_t st) {
    const int grid = blocks_for(a.B, a.So, V, a.sblocks);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    mix_kernel<TRIAL, V><<<dim3(grid, n), SEARCH_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}

template <int V, int CH>
int launch_pick(PickArgs a, cudaStream_t st) {
    const int grid = blocks_for(a.L, a.S, V * CH, a.sblocks);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    pick_kernel<V, CH><<<grid, SEARCH_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace alac

// Every job j of one call: a CPE's (B, S) channels l[j], r[j].  trial:
// out[j] takes (nres + 3) blocks of B rows of So = ceil(S / dil) columns
// (L, R, U at mixres 1..nres, V at every dil-th sample).  Else: out[j]
// takes U's B rows of S, then V's, at the lane's mixres[j][b] (int64) or,
// where mixres[j] is null, at mr[j].  The arrays are host arrays of n.
extern "C" int alac_search_mix(const int* const* l, const int* const* r,
                               const long long* const* mixres,
                               const int* mr, int* const* out, int n, int B,
                               int S, int So, int mixbits, int nres, int dil,
                               int trial, void* stream) {
    if (n <= 0 || B <= 0 || S <= 0) return (int)cudaGetLastError();
    if (n > alac::MAX_MIX_JOBS || mixbits < 0 || mixbits > 31
        || (trial && (nres < 1 || dil < 1 || So != (S + dil - 1) / dil))
        || (!trial && So != S))
        return (int)cudaErrorInvalidValue;
    alac::MixArgs a{};
    bool vec = So % 4 == 0;
    for (int j = 0; j < n; ++j) {
        if (l[j] == nullptr || r[j] == nullptr || out[j] == nullptr)
            return (int)cudaErrorInvalidValue;
        a.l[j] = l[j];
        a.r[j] = r[j];
        a.mixres[j] = trial ? nullptr : mixres[j];
        a.mr[j] = trial ? 0 : mr[j];
        a.out[j] = out[j];
        vec = vec && alac::aligned16(out[j])
              && (trial || (alac::aligned16(l[j]) && alac::aligned16(r[j])));
    }
    a.B = B; a.S = S; a.So = So; a.mixbits = mixbits; a.nres = nres;
    a.dil = dil;
    const cudaStream_t st = (cudaStream_t)stream;
    if (trial)
        return vec ? alac::launch_mix<true, 4>(a, n, st)
                   : alac::launch_mix<true, 1>(a, n, st);
    return vec ? alac::launch_mix<false, 4>(a, n, st)
               : alac::launch_mix<false, 1>(a, n, st);
}

// L lanes of a search over n (1 or 2) orders od0, od1: res (n, L, S) and
// cost1 (n, L) from the cost kernel, cost2 (n, L) or null (stage 1 only);
// chanbits (L,) or null (then cb).  out (L, S) takes each lane's winning
// residual row (its first difference where stage 2 won), sel (3, L) its
// order, mode (0 or 15) and Rice bits.
extern "C" int alac_search_pick(const int* res, const int* cost1,
                                const int* cost2, const int* chanbits,
                                int* out, long long* sel, int L, int S, int n,
                                int od0, int od1, int cb, void* stream) {
    if (L <= 0 || S <= 0) return (int)cudaGetLastError();
    if (n < 1 || n > 2 || res == nullptr || cost1 == nullptr
        || out == nullptr || sel == nullptr)
        return (int)cudaErrorInvalidValue;
    const alac::PickArgs a{res, cost1, cost2, chanbits, out, sel, L, S, n,
                           od0, n == 2 ? od1 : od0, cb, 0};
    const bool vec = S % 4 == 0 && alac::aligned16(res) && alac::aligned16(out);
    const cudaStream_t st = (cudaStream_t)stream;
    return vec ? alac::launch_pick<4, 4>(a, st) : alac::launch_pick<1, 1>(a, st);
}
