// Packet merge: compacts the per-lane sparse chunk streams (words with
// absolute word keys) into the dense (B, W) packet image, then ORs the
// per-lane boundary ("tail") words on top.
//
// Replaces: alacjax/ops/pallas/merge.py :: _merge_kernel (pallas_call in
// merge_compact_pallas) plus the tail OR that bitpack.merge_sorted_chunks
// runs after it.  Plain version: alacjax_torch/ops/bitpack.py ::
// merge_sorted_chunks.
//
// Bound: memory.  Every chunk slot is read once (value + key, 8 bytes)
// and every output word written once: about 0.6 GB at B=4096, S=4096.
//
// Design: the merge invariant (bitpack.merge_sorted_chunks) makes each
// non-empty key its word's own output index, so compaction is a direct
// scatter out[b, key] = val (grid: column blocks x lanes) into an image
// the wrapper zeroes; the TPU's radix shuffle existed only because Mosaic has no
// scatter.  Keys >= W (the empty-slot 0xFFFFFFFF among them) drop.  A
// second kernel ORs the n_t tails, one thread per lane walking its tails
// in order, so repeated tail keys need no atomics.
#include "common.cuh"

namespace alac {

__global__ void merge_scatter(const unsigned* __restrict__ vals,
                              const unsigned* __restrict__ keys,
                              unsigned* __restrict__ out, int T, int W) {
    const size_t b = blockIdx.y;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < T;
         j += gridDim.x * blockDim.x) {
        const unsigned key = keys[b * T + j];
        if (key < (unsigned)W) out[b * W + key] = vals[b * T + j];
    }
}

__global__ void merge_tails(const unsigned* __restrict__ tail_vals,
                            const unsigned* __restrict__ tail_keys,
                            unsigned* __restrict__ out, int B, int n_t,
                            int W) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    for (int t = 0; t < n_t; ++t) {
        const unsigned key = tail_keys[(size_t)b * n_t + t];
        if (key < (unsigned)W) out[(size_t)b * W + key] |= tail_vals[(size_t)b * n_t + t];
    }
}

}  // namespace alac

extern "C" int alac_merge(const int* vals, const int* keys,
                          const int* tail_vals, const int* tail_keys,
                          int* out, int B, int T, int n_t, int W,
                          void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (B <= 0) return (int)cudaGetLastError();
    if (B > 65535) return (int)cudaErrorInvalidValue;
    if (T > 0) {
        const int threads = 256;
        const int bx = (T + threads - 1) / threads;
        alac::merge_scatter<<<dim3(bx < 64 ? bx : 64, B), threads, 0, s>>>(
            (const unsigned*)vals, (const unsigned*)keys, (unsigned*)out, T, W);
    }
    if (n_t > 0) {
        const int threads = 128;
        alac::merge_tails<<<(B + threads - 1) / threads, threads, 0, s>>>(
            (const unsigned*)tail_vals, (const unsigned*)tail_keys,
            (unsigned*)out, B, n_t, W);
    }
    return (int)cudaGetLastError();
}
