// Adaptive-Rice emission: the ag_enc token machine feeding a phase-seeded
// 32-bit word accumulator that writes every completed word with its
// absolute word key.
//
// Replaces: alacjax/ops/pallas/emit_pallas.py :: _emit_kernel (pallas_call
// in _emit_pallas_call, entered through rice_encode_words_pallas).  Plain
// version: alacjax_torch/ops/rice.py :: rice_encode_words
// (emit_flush=False).
//
// Bound: a serial recurrence per lane (the token machine's state and the
// accumulator's bit phase carry from sample to sample), so latency of the
// per-sample chain; the (S+1) * n_slots output slots per lane, 16 bytes
// per step, are the only large memory traffic.
//
// Design: one thread per lane runs the whole S + 1 step loop (the last
// step is the virtual end step that flushes a pending zero run) with the
// machine and the accumulator in registers.  A lane writes its completed
// words and keys into its own row of (S+1) * n_slots slots, empty slots
// 0 / 0xFFFFFFFF, in exactly rice.py's slot layout, and its final partial
// word as the tail (end bits, tail value, tail key).  The bit size (the
// escape payload, the lane's chanbits) and the sample count num (partial
// frames) are per-lane vectors, so one launch emits every channel of
// every element; the slot count comes from the largest bit size.  Input
// is laid out (S, L) so the loads coalesce.
#include "common.cuh"

namespace alac {

// Append the low L bits (0 <= L <= 32) of v to the MSB-first accumulator;
// returns true and the completed word when one fills (rice._append_bits).
__device__ __forceinline__ bool append_bits(unsigned& acc, int& fill,
                                            unsigned& wcount, unsigned v,
                                            int L, unsigned& out) {
    v &= L >= 32 ? 0xFFFFFFFFu : ((1u << L) - 1u);
    const int total = fill + L;
    if (total >= 32) {
        const int over = total - 32;              // 0..31
        out = acc | (v >> over);
        acc = over == 0 ? 0u : (v << (32 - over));
        fill = over;
        wcount += 1u;
        return true;
    }
    if (L > 0) acc |= v << (32 - total);
    fill = total;
    return false;
}

constexpr int MAX_SLOTS = 3;

__global__ void emit_kernel(const int* __restrict__ xt,
                            const int* __restrict__ start_bits,
                            const int* __restrict__ bs,
                            const int* __restrict__ num,
                            unsigned* __restrict__ words,
                            unsigned* __restrict__ keys,
                            int* __restrict__ end_bits,
                            unsigned* __restrict__ tail_val,
                            unsigned* __restrict__ tail_key, int L, int S,
                            int n_slots, unsigned mb0, unsigned pb, int kb,
                            unsigned wb) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= L) return;
    const int start = start_bits[lane];
    const int bit_size = bs[lane];
    const int n = num ? num[lane] : S;     // past n the lane emits nothing
    const unsigned base_word = (unsigned)(start >> 5);
    const size_t row = (size_t)lane * (size_t)(S + 1) * n_slots;

    RiceState st = rice_init(mb0);
    unsigned acc = 0u, wcount = 0u;
    int fill = start & 31;
    for (int t = 0; t <= S; ++t) {
        const int x = t < S ? xt[(size_t)t * L + lane] : 1;
        unsigned tok_v[2];
        int tok_l[2];
        rice_step(st, x, t, n, bit_size, pb, kb, wb, tok_v[0], tok_l[0],
                  tok_v[1], tok_l[1]);
        unsigned slot_w[MAX_SLOTS], slot_k[MAX_SLOTS];
#pragma unroll
        for (int si = 0; si < MAX_SLOTS; ++si) {
            slot_w[si] = 0u;
            slot_k[si] = INF_KEY;
        }
        int ne = 0;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const unsigned key = base_word + wcount;
            unsigned w;
            if (append_bits(acc, fill, wcount, tok_v[j], tok_l[j], w)) {
#pragma unroll
                for (int si = 0; si < MAX_SLOTS; ++si)
                    if (ne == si) {
                        slot_w[si] = w;
                        slot_k[si] = key;
                    }
                ++ne;
            }
        }
        const size_t o = row + (size_t)t * n_slots;
#pragma unroll
        for (int si = 0; si < MAX_SLOTS; ++si)
            if (si < n_slots) {
                words[o + si] = slot_w[si];
                keys[o + si] = slot_k[si];
            }
    }
    end_bits[lane] = (int)((base_word + wcount) * 32u + (unsigned)fill);
    tail_val[lane] = fill > 0 ? acc : 0u;
    tail_key[lane] = base_word + wcount;
}

}  // namespace alac

// bs: (L,) per-lane bit sizes, each at most bit_size_cap, which sizes
// the n_slots; num: (L,) per-lane sample counts, or nullptr for S.
extern "C" int alac_emit(const int* xt, const int* start_bits, const int* bs,
                         const int* num, int* words, int* keys, int* end_bits,
                         int* tail_val, int* tail_key, int L, int S,
                         int bit_size_cap, int n_slots, unsigned mb0,
                         unsigned pb, int kb, unsigned wb, void* stream) {
    // the escape token (9-bit prefix + payload) is one <= 32-bit append
    if (n_slots < 1 || n_slots > alac::MAX_SLOTS ||
        bit_size_cap + alac::MAX_PREFIX_32 > 32)
        return (int)cudaErrorInvalidValue;
    if (L <= 0) return (int)cudaGetLastError();
    const int threads = 32;
    const int blocks = (L + threads - 1) / threads;
    alac::emit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        xt, start_bits, bs, num, (unsigned*)words, (unsigned*)keys, end_bits,
        (unsigned*)tail_val, (unsigned*)tail_key, L, S, n_slots, mb0, pb, kb,
        wb);
    return (int)cudaGetLastError();
}
