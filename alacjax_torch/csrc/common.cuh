// Shared device helpers for the alacjax_torch kernels: exact C-reference
// integer semantics (int32 wraps, arithmetic >> on signed, logical on
// unsigned) and the adaptive-Rice token machine of ag_enc.c.
//
// Signed wraparound is written through unsigned arithmetic (wadd/wsub/
// wmul) so no step relies on signed overflow, which C++ leaves undefined.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace alac {

// aglib.h constants (alacjax/types.py)
constexpr int QBSHIFT = 9;
constexpr unsigned QB = 1u << QBSHIFT;
constexpr int PBSHIFT = 9;
constexpr int MMULSHIFT = 2;
constexpr int MDENSHIFT = QBSHIFT - MMULSHIFT - 1;   // 6
constexpr unsigned MOFF = 1u << (MDENSHIFT - 2);     // 16
constexpr int BITOFF = 24;
constexpr int MAX_PREFIX_16 = 9;
constexpr int MAX_PREFIX_32 = 9;
constexpr unsigned N_MAX_MEAN_CLAMP = 0xFFFFu;
constexpr unsigned N_MEAN_CLAMP_VAL = 0xFFFFu;
constexpr int MAX_RICE_NUMBITS = 25;
constexpr unsigned INF_KEY = 0xFFFFFFFFu;

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ int wneg(int a) { return (int)(0u - (unsigned)a); }

// (x << (32-bits)) >> (32-bits): low `bits` bits, sign-extended, at a
// width known to lie in 1..32 (16 for the coefficients); a per-lane
// width goes through sext_sh
__device__ __forceinline__ int sext(int x, int bits) {
    int sh = 32 - bits;
    return (int)((unsigned)x << sh) >> sh;
}

// sext at a per-lane width, the shift sh = 32 - bits given: the C idiom
// with PTX's shifts, which clamp an amount past 31.  A width of 33 (one
// past a 32-bit channel) gives 0, as alacjax's XLA shifts and the plain
// versions do; sext's C shifts would be undefined there.
__device__ __forceinline__ int sext_sh(int x, unsigned sh) {
    int r;
    asm("{\n\t.reg .b32 t;\n\tshl.b32 t, %1, %2;\n\tshr.s32 %0, t, %2;\n\t}"
        : "=r"(r) : "r"(x), "r"(sh));
    return r;
}

__device__ __forceinline__ int sign_of(int x) { return (x > 0) - (x < 0); }

// V (1 or 4) neighbouring int32 values: a 16-byte load or store where V
// is 4 (the pointer 16-byte aligned), else one value
template <int V>
__device__ __forceinline__ void load_v(int (&x)[V], const int* p) {
    if constexpr (V == 4) {
        const int4 t = __ldg(reinterpret_cast<const int4*>(p));
        x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else {
        x[0] = __ldg(p);
    }
}

template <int V>
__device__ __forceinline__ void store_v(int* p, const int (&x)[V]) {
    if constexpr (V == 4)
        *reinterpret_cast<int4*>(p) = make_int4(x[0], x[1], x[2], x[3]);
    else
        p[0] = x[0];
}

inline bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

// Word i of a (B, W) word image's row as bitpack.extract_segment reads
// it: 0 past W, word 0 before 0.
__device__ __forceinline__ unsigned image_word(const unsigned* row,
                                               long long i, int W) {
    return i < W ? __ldg(row + (i < 0 ? 0 : i)) : 0u;
}

// The n-bit field (1 <= n <= 32) at bit q of a row of the image.
__device__ __forceinline__ unsigned image_field(const unsigned* row,
                                                long long q, int n, int W) {
    const long long i = q >> 5;
    return __funnelshift_l(image_word(row, i + 1, W), image_word(row, i, W),
                           (unsigned)(q & 31)) >> (32 - n);
}

// c ? a : b, opaque to the compiler.  A chain of plain selects over an
// array's constant indices (or over two fields of the kernel's argument
// struct) may be folded into one dynamically indexed load, which moves
// the array (or the struct) to local memory; an asm select cannot be.
__device__ __forceinline__ int select_opaque(bool c, int a, int b) {
    int r;
    asm("{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %3, 0;\n\t"
        "selp.b32 %0, %1, %2, p;\n\t}"
        : "=r"(r) : "r"(a), "r"(b), "r"((int)c));
    return r;
}

// leading zeros of a u32; clz32(0) == 32 (the _clz32 contract)
__device__ __forceinline__ int clz32(unsigned x) { return __clz((int)x); }

__device__ __forceinline__ int lg3a(unsigned x) { return 31 - clz32(x + 3u); }

// min(n / m, 9) and n - m * that: the threshold count of rice.py
// (m <= 16383, so 9 * m cannot wrap).  The nine compares are summed as a
// tree: a running count compiles to a chain of nine dependent increments.
__device__ __forceinline__ void divmod_capped(unsigned n, unsigned m, int& div,
                                              unsigned& mod) {
    const int a = (int)(n >= m) + (int)(n >= 2u * m) + (int)(n >= 3u * m);
    const int b = (int)(n >= 4u * m) + (int)(n >= 5u * m) + (int)(n >= 6u * m);
    const int c = (int)(n >= 7u * m) + (int)(n >= 8u * m) + (int)(n >= 9u * m);
    div = a + b + c;
    mod = n - m * (unsigned)div;
}

// ag_enc.c :: dyn_code_32bit (non-escape codeword or the 9-ones prefix)
__device__ __forceinline__ bool dyn_code_32(unsigned m, int k, unsigned n,
                                            unsigned& val, int& len) {
    int div;
    unsigned mod;
    divmod_capped(n, m, div, mod);
    int de = (mod == 0u) ? 1 : 0;
    int nb = div + k + 1 - de;
    if (div >= MAX_PREFIX_32 || nb > MAX_RICE_NUMBITS) {
        val = (1u << MAX_PREFIX_32) - 1u;
        len = MAX_PREFIX_32;
        return true;
    }
    val = ((((1u << div) - 1u) << (nb - div)) + mod + 1u - (unsigned)de);
    len = nb;
    return false;
}

// ag_enc.c :: dyn_code (zero-run lengths; n <= 65535)
__device__ __forceinline__ void dyn_code_16(unsigned m, int k, unsigned n,
                                            unsigned& val, int& len) {
    if (m == 0u) m = 1u;
    int div;
    unsigned mod;
    divmod_capped(n, m, div, mod);
    if (div >= MAX_PREFIX_16) {
        val = (((1u << MAX_PREFIX_16) - 1u) << 16) | n;
        len = MAX_PREFIX_16 + 16;
        return;
    }
    int de = (mod == 0u) ? 1 : 0;
    int nb = div + k + 1 - de;
    int sh = nb - div > 0 ? nb - div : 0;
    val = ((((1u << div) - 1u) << sh) + mod + 1u - (unsigned)de);
    len = nb;
}

struct RiceState {
    unsigned mb;
    bool in_run;
    unsigned run_len;
    int run_kz;
    unsigned run_mz;
};

__device__ __forceinline__ RiceState rice_init(unsigned mb0) {
    RiceState s;
    s.mb = mb0;
    s.in_run = false;
    s.run_len = 0u;
    s.run_kz = 0;
    s.run_mz = 0u;
    return s;
}

// One step of the ag_enc token machine (rice._encode_step_tokens).
// Tokens in stream order: the pending zero-run codeword (run_val,
// run_len) and the residual codeword (val, len) — on escape the 9-ones
// prefix followed by the raw bit_size-bit payload, merged into one token
// of 9 + bit_size <= 32 bits.  t == S is the virtual end step that
// flushes a pending run.  Returns the bits this step spends.
__device__ __forceinline__ int rice_step(RiceState& st, int x, int t, int S,
                                         int bit_size, unsigned pb, int kb,
                                         unsigned wb, unsigned& run_val,
                                         int& run_bits, unsigned& val,
                                         int& len) {
    const bool valid = t < S;
    const bool nonzero = x != 0;
    const bool run_end_nonzero = st.in_run && nonzero && valid;
    const unsigned run_len_new = st.run_len + 1u;
    const bool cap = st.in_run && !nonzero && valid && run_len_new >= 65535u;
    const bool flush = st.in_run && !valid;
    run_val = 0u;
    run_bits = 0;
    if (run_end_nonzero || cap || flush)
        dyn_code_16(st.run_mz, st.run_kz, cap ? run_len_new : st.run_len,
                    run_val, run_bits);

    const bool code_now = valid && (!st.in_run || run_end_nonzero);
    const unsigned zmode = run_end_nonzero ? 1u : 0u;
    val = 0u;
    len = 0;
    unsigned mb1 = st.mb;
    if (code_now) {
        int k = lg3a(st.mb >> QBSHIFT);
        if (k > kb) k = kb;
        const unsigned m = (1u << k) - 1u;
        const unsigned absx = x < 0 ? 0u - (unsigned)x : (unsigned)x;
        const unsigned n = absx * 2u - (x < 0 ? 1u : 0u) - zmode;
        if (dyn_code_32(m, k, n, val, len)) {
            if (bit_size < 32)
                val = (val << bit_size) | (n & ((1u << bit_size) - 1u));
            len += bit_size;
        }
        unsigned mb_upd = pb * (n + zmode) + st.mb - ((pb * st.mb) >> PBSHIFT);
        if (n > N_MAX_MEAN_CLAMP) mb_upd = N_MEAN_CLAMP_VAL;
        mb1 = mb_upd;
    }
    const bool trigger = code_now && ((mb1 << MMULSHIFT) < QB) && (t + 1 < S);
    const bool continuing = st.in_run && !nonzero && valid && !cap;
    if (trigger) {
        int kz = clz32(mb1) - BITOFF + (int)((mb1 + MOFF) >> MDENSHIFT);
        int kzc = kz < 0 ? 0 : (kz > 31 ? 31 : kz);
        st.run_kz = kz;
        st.run_mz = ((1u << kzc) - 1u) & wb;
        mb1 = 0u;
    }
    st.mb = mb1;
    st.in_run = continuing || trigger;
    st.run_len = continuing ? run_len_new : 0u;
    return run_bits + len;
}

// ---------------------------------------------------------------------------
// (L, S) rows through shared-memory tiles: a tile holds TILE samples of
// LANES lanes, [sample][lane] at a pitch of PITCH words, so a per-lane
// walk down a tile and a row copy across it are both free of bank
// conflicts.
// ---------------------------------------------------------------------------
constexpr int TILE = 32;              // samples per staged tile
constexpr int LANES = 32;             // lanes per block
constexpr int PITCH = LANES + 1;      // shared tile row pitch, in words

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// every thread of the block: the phase's end
__device__ __forceinline__ void phase_barrier(int nthreads) {
    asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

// Threads tid = 0..nthreads-1 copy tile `tile` of lanes lane0.. of the
// (L, S) array x into buf with cp.async (zeros past L and S): each warp
// instruction moves 32 consecutive samples of one row (128 bytes).
__device__ __forceinline__ void load_tile(int (*buf)[PITCH], const int* x,
                                          int L, int S, int lane0, int tile,
                                          int tid, int nthreads) {
    const int t0 = tile * TILE;
    for (int i = tid; i < LANES * TILE; i += nthreads) {
        const int r = i / TILE, j = i % TILE;
        const int lane = lane0 + r, t = t0 + j;
        if (lane < L && t < S)
            cp_async4(&buf[j][r], x + (size_t)lane * S + t);
        else
            buf[j][r] = 0;
    }
    cp_async_commit();
}

}  // namespace alac
