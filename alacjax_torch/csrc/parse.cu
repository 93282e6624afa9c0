// The decode's element parse: one element's 23-bit header, its partial
// frame's 32-bit numSamples, a CPE's mix token and every channel's param
// header and coefficients, read at each lane's element start from the
// int32 (B, W) word image, in one launch.
//
// Replaces: no TPU kernel.  The torch glue before each element's channel
// decodes (alacjax/codec.py :: decode_frames_device's per-element parse,
// XLA there): some hundred torch operations an element on an int64 copy
// of the whole image.  Plain version: alacjax_torch/ops/parse.py ::
// parse_element, whose fields this kernel writes bit for bit.
//
// Bound: latency.  A lane reads at most 3 header words and a window of 37
// (a CPE at 30 coefficients: 1,110 bits from the word of its start) and
// writes 6 + 4 * WIDTH rows and WIDTH * MAXORD coefficients: about 1.8 MB
// at B = 4096 (0.55 us at 3.35 TB/s), so the time is the launch and two
// dependent loads.
//
// Design: one warp a lane, PARSE_WARPS lanes a block.  The warp loads 64
// words from the word of the lane's start into shared memory, two
// coalesced loads a thread, while every thread reads the header with the
// clamped index of fused_decode._read_bits (the same words, from L1); every
// field after the header is a funnel shift of two shared words.  Thread t
// extracts coefficient t of each channel, so each lane's coefficients go
// out as one coalesced row; thread 0 writes the lane's rows.  A per-lane
// start of null reads at bit 0, the packet's first element: one path for
// every element of every layout.  The element's readout, its flags (a
// lane coded, a lane escaped) and its counts (the lanes escaped, the
// lanes whose header carries the sample count), goes into the four ints
// the entry point zeroes first: a block counts its lanes with
// __syncthreads_count (thread 0 of each lane's warp votes; a warp is one
// lane, so a warp's ballot would count one), then thread 0 sets a flag
// with an atomicOr and adds a nonzero count with an atomicAdd.
#include "common.cuh"

namespace alac {

constexpr int PARSE_WARPS = 8;              // lanes a block, a warp each
constexpr int WIN = 64;                     // window words a lane
constexpr int ELEMENT_ROWS = 6, CHANNEL_ROWS = 4;   // ops/parse.py's rows
enum { NUM, POS_ESC, POS_SHIFT, RICE, MIXBITS, MIXRES };
enum { PB, MODE, ORDER, DEN };
constexpr int TAG_SCE = 0, TAG_LFE = 3;     // types.ElementTag
constexpr int C_PH0 = 23 + 16;              // channel 0's param header

struct ParseArgs {
    const unsigned* words;              // (B, W) word image
    const int* bitpos;                  // (B,) element starts, or nullptr
    const int* num;                     // (B,) first element's, or nullptr
    int* lanes;                         // (6 + 4 * WIDTH, B) rows
    int* coefs;                         // (WIDTH, B, MAXORD)
    int* flags;                         // (4,): a lane coded, one escaped,
                                        // lanes escaped, lanes sized
    unsigned char* bits;                // (2, B): esc, err
    int B, W, S, tag, bs, pb;
};

// fused_decode._read_bits' 32 bits at bit q: word indices clamped to the
// row.  The plain version reads the header and numSamples so, and the
// window zero-pads; the two differ for a header within two words of the
// row's end, which test_torch_parse.py's "random" and "short-image"
// crafted-header cases pin.
__device__ __forceinline__ unsigned read32_clamped(const unsigned* row,
                                                   long long q, int W) {
    const long long i = q >> 5;
    const long long i0 = i < 0 ? 0 : (i > W - 1 ? W - 1 : i);
    const long long i1 = i + 1 < 0 ? 0 : (i + 1 > W - 1 ? W - 1 : i + 1);
    return __funnelshift_l(__ldg(row + i1), __ldg(row + i0),
                           (unsigned)(q & 31));
}

struct ChannelHeader {
    int mode, den, pbf, order;
    bool perr;
};

template <int MAXORD>
__device__ __forceinline__ ChannelHeader channel_header(unsigned ph) {
    ChannelHeader c;
    c.mode = (ph >> 12) & 0xF;
    c.den = (ph >> 8) & 0xF;
    c.pbf = (ph >> 5) & 0x7;
    c.order = ph & 0x1F;
    c.perr = (c.order > MAXORD && c.order != 31)
             || (c.den == 0 && c.order != 0 && c.order != 31);
    return c;
}

template <int WIDTH, int MAXORD>
__global__ void __launch_bounds__(PARSE_WARPS * 32) parse_kernel(const ParseArgs a) {
    __shared__ unsigned win_s[PARSE_WARPS][WIN];
    const int t = threadIdx.x & 31, wi = threadIdx.x >> 5;
    const int b = blockIdx.x * PARSE_WARPS + wi;
    const bool live = b < a.B;
    bool esc = false, partial = false;
    if (live) {
        const unsigned* row = a.words + (size_t)b * a.W;
        const long long bp = a.bitpos ? a.bitpos[b] : 0;
        // the window: the words from bp's own, as extract_segment reads them
        unsigned* win = win_s[wi];
        win[t] = image_word(row, (bp >> 5) + t, a.W);
        win[t + 32] = image_word(row, (bp >> 5) + 32 + t, a.W);
        const unsigned hdr = read32_clamped(row, bp, a.W) >> 9;
        const unsigned nsf = read32_clamped(row, bp + 23, a.W);
        __syncwarp();

        const int rtag = hdr >> 20;
        partial = (hdr >> 3) & 1;
        const int bs_f = (hdr >> 1) & 3;
        esc = hdr & 1;
        // a mono slot takes an SCE or an LFE tag
        const bool tag_ok = WIDTH == 1 ? (rtag == TAG_SCE || rtag == TAG_LFE)
                                       : rtag == a.tag;
        bool err = !tag_ok || ((hdr >> 4) & 0xFFF) != 0
                   || (esc ? bs_f != 0 : bs_f != a.bs);
        const bool bad_num = partial && (nsf == 0 || nsf > (unsigned)a.S);
        const int num_el = partial && !bad_num ? (int)nsf : a.S;
        err = err || bad_num;
        int num = num_el;
        if (a.num) {
            num = a.num[b];
            err = err || num_el != num;
        }
        const long long pos_esc = bp + 23 + (partial ? 32 : 0);
        // window bit of the element's start, past the partial field
        const int r0 = (int)(bp & 31) + (partial ? 32 : 0);
        auto field16 = [&](int off) -> unsigned {
            const int q = r0 + off;
            return __funnelshift_l(win[(q >> 5) + 1], win[q >> 5],
                                   (unsigned)(q & 31)) >> 16;
        };

        const ChannelHeader c0 = channel_header<MAXORD>(field16(C_PH0));
        bool perr = c0.perr;
        long long end = C_PH0 + 16 + 16 * c0.order;
        int* coefs = a.coefs + (size_t)b * MAXORD;
        const size_t cstride = (size_t)a.B * MAXORD;
        if (t < MAXORD) coefs[t] = sext((int)field16(C_PH0 + 16 + 16 * t), 16);
        ChannelHeader c1 = c0;
        if constexpr (WIDTH == 2) {
            // orders outside 0..MAXORD and 31 read as order 0 (perr flags
            // those lanes), as the reference's select does
            const int o_sel = c0.order <= MAXORD || c0.order == 31 ? c0.order : 0;
            const int at = C_PH0 + 16 + 16 * o_sel;
            c1 = channel_header<MAXORD>(field16(at));
            perr = perr || c1.perr;
            end += 16 + 16 * c1.order;
            if (t < MAXORD)
                coefs[cstride + t] = sext((int)field16(at + 16 + 16 * t), 16);
        }
        err = err || (!esc && perr);
        const long long pos_shift = esc ? pos_esc : pos_esc - 23 + end;
        const long long rice = pos_shift + (esc ? 0 : (long long)WIDTH * 8 * a.bs * num);

        if (t == 0) {
            int* lanes = a.lanes + b;
            const size_t B = a.B;
            lanes[NUM * B] = num;
            lanes[POS_ESC * B] = (int)pos_esc;
            lanes[POS_SHIFT * B] = (int)pos_shift;
            lanes[RICE * B] = (int)rice;
            unsigned mixtok = 0;
            if constexpr (WIDTH == 2) mixtok = esc ? 0u : field16(23);
            lanes[MIXBITS * B] = (int)(mixtok >> 8);
            lanes[MIXRES * B] = sext((int)(mixtok & 0xFF), 8);
#pragma unroll
            for (int ci = 0; ci < WIDTH; ++ci) {
                const ChannelHeader& c = ci == 0 ? c0 : c1;
                int* ch = lanes + (ELEMENT_ROWS + CHANNEL_ROWS * ci) * B;
                ch[PB * B] = (a.pb * c.pbf) >> 2;      // floor: pb * pbf // 4
                ch[MODE * B] = c.mode;
                ch[ORDER * B] = esc ? 0 : c.order;
                ch[DEN * B] = c.den;
            }
            a.bits[b] = esc;
            a.bits[B + b] = err;
        }
    }
    const bool vote = live && t == 0;
    const int n_esc = __syncthreads_count(vote && esc);
    const int n_coded = __syncthreads_count(vote && !esc);
    const int n_sized = __syncthreads_count(vote && partial);
    if (threadIdx.x == 0) {
        if (n_coded) atomicOr(a.flags, 1);
        if (n_esc) {
            atomicOr(a.flags + 1, 1);
            atomicAdd(a.flags + 2, n_esc);
        }
        if (n_sized) atomicAdd(a.flags + 3, n_sized);
    }
}

template <int WIDTH, int MAXORD>
int launch_parse(const ParseArgs& a, cudaStream_t st) {
    const int blocks = (a.B + PARSE_WARPS - 1) / PARSE_WARPS;
    parse_kernel<WIDTH, MAXORD><<<blocks, PARSE_WARPS * 32, 0, st>>>(a);
    return (int)cudaGetLastError();
}

template <int WIDTH>
int launch_width(const ParseArgs& a, int max_ord, cudaStream_t st) {
    return max_ord == 16 ? launch_parse<WIDTH, 16>(a, st)
                         : launch_parse<WIDTH, 30>(a, st);
}

}  // namespace alac

// One element: bitpos (the element starts) nullptr reads at bit 0, num
// (the packet's frame lengths) nullptr takes this element's own; width 1
// or 2 channels, max_ord 16 or 30 coefficients, tag the element's
// ElementTag, bs its bytes shifted (0..2), pb the config's Rice modifier.
// Zeroes the four ints of flags, then launches (nothing more for B = 0).
extern "C" int alac_parse(const int* words, const int* bitpos, const int* num,
                          int* lanes, int* coefs, int* flags,
                          unsigned char* bits, int B, int W, int S, int width,
                          int max_ord, int tag, int bs, int pb, void* stream) {
    if (B < 0 || W < 1 || S < 1 || width < 1 || width > 2
        || (max_ord != 16 && max_ord != 30) || bs < 0 || bs > 2)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t e = cudaMemsetAsync(flags, 0, 4 * sizeof(int), st);
    if (e != cudaSuccess || B == 0) return (int)e;
    const alac::ParseArgs a{(const unsigned*)words, bitpos, num, lanes, coefs,
                            flags, bits, B, W, S, tag, bs, pb};
    return width == 2 ? alac::launch_width<2>(a, max_ord, st)
                      : alac::launch_width<1>(a, max_ord, st);
}
