// The decode's pcm stage: one element's channels of the call's (B, C, S)
// int32 output from its reconstructed streams, in one launch: unmix (a
// CPE), shift-byte re-insert, escape select and tail mask.
//
// Replaces: no TPU kernel.  The torch glue between the decode launches
// and the output (alacjax/codec.py :: decode_frames_device's per-element
// unmix, shift_in and escape select, then the final stack and mask, XLA
// there), about 68 torch operations an SCE and 112 a CPE, each shift-byte
// block widening the whole word image to int64.  Plain version:
// alacjax_torch/ops/pcm.py :: element_pcm.
//
// Bound: memory.  Per output sample its reconstructed sample (4 bytes),
// its shift bits (bs bytes) and its store (4 bytes): about 0.91 GB for a
// B=4096 24-bit 5.1 decode (0.27 ms at 3.35 TB/s), 0.27 GB for 16-bit
// stereo (0.08 ms).
//
// Design: a thread takes V neighbouring samples of one lane, every
// channel of the element, so a CPE's unmix stays in registers; a block is
// PCM_THREADS threads of one lane, so the stream loads and the output
// stores coalesce, and each per-lane argument is one load that the
// block's threads share.  V = 4 where S is a multiple of 4 and the
// streams and the output are 16-byte aligned (every call of the codec):
// one 16-byte load per stream and one store per channel, and the four
// samples' shift bytes, WIDTH * 4 fields of 8 * bs bits, fill WIDTH * bs
// whole words at the lane's bit phase, so WIDTH * bs + 1 word loads and
// one funnel shift per word give them all.  Otherwise V = 1, and each
// field of the word image is two words and a funnel shift.  Either way a
// word past W reads 0 and one before 0 reads word 0, as
// bitpack.extract_segment does; an escape sample (rare) is read field by
// field.  The per-lane arguments are the parse kernel's int32 rows and
// bool flags (csrc/parse.cu), so the codec converts nothing.
#include "common.cuh"

namespace alac {

constexpr int PCM_THREADS = 256;

struct PcmArgs {
    const unsigned* words;              // (B, W) word image
    const int* r0;                      // (B, S) streams, or nullptr
    const int* r1;                      //   (a CPE's second)
    const int* mixbits;                 // (B,) a CPE's, else nullptr
    const int* mixres;
    const int* pos_shift;               // (B,) bit of the shift-byte block
    const int* pos_esc;                 // (B,) bit of the escape samples
    const unsigned char* esc;           // (B,) escape lanes
    const int* num;                     // (B,) samples per lane
    int* out;                           // (B, C, S)
    int W, S, C, c0, bs, depth, unescape, sblocks;
};

// V samples a thread (1 or 4); BS the bytes shifted where V = 4 (V = 1
// reads a.bs at run time).
template <int WIDTH, int V, int BS>
__global__ void __launch_bounds__(PCM_THREADS) pcm_kernel(const PcmArgs a) {
    const int b = blockIdx.x / a.sblocks;
    const int s0 = ((blockIdx.x - b * a.sblocks) * PCM_THREADS + threadIdx.x) * V;
    if (s0 >= a.S) return;
    const size_t S = a.S;
    const unsigned* row = a.words + (size_t)b * a.W;
    int x[WIDTH][V];
    if (a.unescape && a.esc[b]) {
        const long long q = a.pos_esc[b] + (long long)s0 * WIDTH * a.depth;
#pragma unroll
        for (int k = 0; k < WIDTH * V; ++k)
            x[k % WIDTH][k / WIDTH] = sext(
                (int)image_field(row, q + (long long)k * a.depth, a.depth, a.W),
                a.depth);
    } else if (a.r0 == nullptr) {
#pragma unroll
        for (int k = 0; k < WIDTH * V; ++k) x[k % WIDTH][k / WIDTH] = 0;
    } else {
        const size_t at = (size_t)b * S + s0;
        load_v<V>(x[0], a.r0 + at);
        if constexpr (WIDTH == 2) {
            load_v<V>(x[1], a.r1 + at);
            // matrix.unmix: r = u - ((mixres * v) >> mixbits), l = v + r;
            // a shift past 31 (or below 0) fills with the sign, as the
            // plain version's int64 shift of an int32 value does
            const int mr = a.mixres[b];
            if (mr != 0) {
                const unsigned mb = (unsigned)a.mixbits[b];
                const int sh = mb > 31 ? 31 : (int)mb;
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    const int r = wsub(x[0][v], wmul(mr, x[1][v]) >> sh);
                    x[0][v] = wadd(x[1][v], r);
                    x[1][v] = r;
                }
            }
        }
        if constexpr (V == 1) {
            if (a.bs) {
                const int d = 8 * a.bs;
                const long long q = a.pos_shift[b] + (long long)s0 * WIDTH * d;
#pragma unroll
                for (int ci = 0; ci < WIDTH; ++ci)
                    x[ci][0] = (int)(((unsigned)x[ci][0] << d)
                                     | image_field(row, q + ci * d, d, a.W));
            }
        } else if constexpr (BS > 0) {
            // fields k = v * WIDTH + ci of D bits from bit q, a multiple
            // of 32 bits past the lane's block start: NW words at its phase
            constexpr int D = 8 * BS, NW = WIDTH * BS;
            const long long q = a.pos_shift[b] + (long long)s0 * WIDTH * D;
            const long long i0 = q >> 5;
            const unsigned ph = (unsigned)(q & 31);
            unsigned w[NW + 1];
#pragma unroll
            for (int j = 0; j <= NW; ++j) w[j] = image_word(row, i0 + j, a.W);
#pragma unroll
            for (int j = 0; j < NW; ++j) w[j] = __funnelshift_l(w[j + 1], w[j], ph);
#pragma unroll
            for (int k = 0; k < WIDTH * V; ++k) {
                const int bit = k * D;
                const unsigned f = (w[bit / 32] >> (32 - bit % 32 - D))
                                   & ((1u << D) - 1u);
                int& y = x[k % WIDTH][k / WIDTH];
                y = (int)(((unsigned)y << D) | f);
            }
        }
    }
    const int n = a.num[b];
#pragma unroll
    for (int v = 0; v < V; ++v) {
        if (s0 + v >= n) {
#pragma unroll
            for (int ci = 0; ci < WIDTH; ++ci) x[ci][v] = 0;
        }
    }
    int* o = a.out + ((size_t)b * a.C + a.c0) * S + s0;
#pragma unroll
    for (int ci = 0; ci < WIDTH; ++ci) store_v<V>(o + ci * S, x[ci]);
}

template <int WIDTH, int V, int BS>
int launch_pcm(PcmArgs a, int B, cudaStream_t st) {
    constexpr int per_block = PCM_THREADS * V;
    a.sblocks = (a.S + per_block - 1) / per_block;
    if ((long long)B * a.sblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    pcm_kernel<WIDTH, V, BS><<<B * a.sblocks, PCM_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}

template <int WIDTH>
int launch_width(const PcmArgs& a, int B, bool vec, cudaStream_t st) {
    if (!vec) return launch_pcm<WIDTH, 1, 0>(a, B, st);
    switch (a.bs) {
        case 0: return launch_pcm<WIDTH, 4, 0>(a, B, st);
        case 1: return launch_pcm<WIDTH, 4, 1>(a, B, st);
        default: return launch_pcm<WIDTH, 4, 2>(a, B, st);
    }
}

}  // namespace alac

// One element: channels c0 .. c0 + width - 1 of out (B, C, S).  r0 (and
// r1 for width 2) are the (B, S) reconstructed streams, r0 nullptr for an
// element whose every lane escaped; mixbits and mixres are read for width
// 2 alone; bs is the bytes shifted (0..2), depth the escape samples' bits.
extern "C" int alac_pcm(const int* words, const int* r0, const int* r1,
                        const int* mixbits, const int* mixres,
                        const int* pos_shift, const int* pos_esc,
                        const unsigned char* esc, const int* num,
                        int* out, int B, int W, int S, int C, int c0,
                        int width, int bs, int depth, int unescape,
                        void* stream) {
    if (B <= 0 || S <= 0) return (int)cudaGetLastError();
    if (width < 1 || width > 2 || c0 < 0 || c0 + width > C || W < 0
        || bs < 0 || bs > 2 || depth < 1 || depth > 32
        || (width == 2 && (mixbits == nullptr || mixres == nullptr
                           || (r0 != nullptr && r1 == nullptr))))
        return (int)cudaErrorInvalidValue;
    const alac::PcmArgs a{(const unsigned*)words, r0, r1, mixbits, mixres,
                          pos_shift, pos_esc, esc, num, out,
                          W, S, C, c0, bs, depth, unescape, 0};
    const bool vec = S % 4 == 0 && alac::aligned16(r0) && alac::aligned16(r1)
                     && alac::aligned16(out);
    const cudaStream_t st = (cudaStream_t)stream;
    return width == 2 ? alac::launch_width<2>(a, B, vec, st)
                      : alac::launch_width<1>(a, B, vec, st);
}
