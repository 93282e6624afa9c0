// Native host codec — single-threaded C++ implementation of the ALAC
// pipeline, written from this repo's oracle spec (alacjax/oracle/*; the
// stage semantics mirror the reference codec/ALACEncoder.cpp,
// matrix_{enc,dec}.c, dp_{enc,dec}.c, ag_{enc,dec}.c — see SURVEY.md §2).
//
// Three roles:
//   1. the framework's native runtime component (host fallback for
//      partial frames / low-latency single-stream paths),
//   2. a reference-class single-core CPU baseline that bench.py measures
//      live for vs_baseline,
//   3. an independent cross-implementation check for the oracle/JAX paths
//      (tests assert byte-identical packets).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// constants (see alacjax/types.py)
// ---------------------------------------------------------------------------
constexpr int kMaxCoefs = 16;
constexpr int kDenshift = 9;
constexpr uint32_t QBSHIFT = 9, QB = 1u << QBSHIFT, PBSHIFT = 9;
constexpr uint32_t MMULSHIFT = 2, MDENSHIFT = QBSHIFT - MMULSHIFT - 1;
constexpr uint32_t MOFF = 1u << (MDENSHIFT - 2), BITOFF = 24;
constexpr uint32_t MAX_PREFIX = 9, MAX_RICE_NUMBITS = 25;
constexpr uint32_t N_MAX_MEAN_CLAMP = 0xFFFF, N_MEAN_CLAMP_VAL = 0xFFFF;
constexpr int DEFAULT_MIX_BITS = 2, MAX_RES = 4, PB_FACTOR = 4;
constexpr int SEARCH_ORDERS[2] = {4, 8};
constexpr int FAST_ORDER = 8, FAST_MIX_RES = 2, MIXRES_DILATE = 4;
constexpr int AINIT = 38, BINIT = -29, CINIT = -2;

constexpr int ID_SCE = 0, ID_CPE = 1, ID_LFE = 3, ID_END = 7;

struct Config {
  int32_t frame_length, bit_depth, pb, mb, kb, num_channels, max_run;
  int32_t fast_mode;
  int32_t exhaustive;  // full-rate mixres trials (compression upper bound)
};

inline int32_t sign_extend(int64_t v, int bits) {
  uint64_t m = (bits >= 64) ? ~0ull : ((1ull << bits) - 1);
  uint64_t x = (uint64_t)v & m;
  if (bits < 64 && (x & (1ull << (bits - 1)))) x -= (1ull << bits);
  return (int32_t)(int64_t)x;
}
inline int sign_of(int32_t v) { return (v > 0) - (v < 0); }
inline int clz32(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline int lg3a(uint32_t x) { return 31 - clz32(x + 3); }

// ---------------------------------------------------------------------------
// BitBuffer (MSB-first; see alacjax/bitbuffer.py)
// ---------------------------------------------------------------------------
struct BitWriter {
  uint8_t* buf;
  size_t cap;
  size_t bitpos = 0;
  bool overflow = false;

  void write(uint32_t v, int nbits) {
    if (nbits <= 0) return;
    if ((bitpos + nbits + 7) / 8 > cap) { overflow = true; return; }
    if (nbits < 32) v &= (1u << nbits) - 1;
    int remaining = nbits;
    while (remaining > 0) {
      size_t byte = bitpos >> 3;
      int bit_in = bitpos & 7;
      int take = 8 - bit_in;
      if (take > remaining) take = remaining;
      int shift = remaining - take;
      uint8_t chunk = (uint8_t)((v >> shift) & ((1u << take) - 1));
      int dst_shift = 8 - bit_in - take;
      buf[byte] = (uint8_t)((buf[byte] & ~(((1u << take) - 1) << dst_shift))
                            | (chunk << dst_shift));
      bitpos += take;
      remaining -= take;
    }
  }
  void byte_align() {
    int rem = bitpos & 7;
    if (rem) write(0, 8 - rem);
  }
};

struct BitReader {
  const uint8_t* buf;
  size_t nbytes;
  size_t bitpos = 0;
  bool error = false;

  uint32_t read(int nbits) {
    if (nbits <= 0) return 0;
    if (bitpos + nbits > nbytes * 8) { error = true; return 0; }
    uint32_t r = 0;
    size_t pos = bitpos;
    int remaining = nbits;
    while (remaining > 0) {
      size_t byte = pos >> 3;
      int bit_in = pos & 7;
      int take = 8 - bit_in;
      if (take > remaining) take = remaining;
      uint32_t chunk = (buf[byte] >> (8 - bit_in - take)) & ((1u << take) - 1);
      r = (r << take) | chunk;
      pos += take;
      remaining -= take;
    }
    bitpos += nbits;
    return r;
  }
  uint32_t peek32() const {
    uint64_t w = 0;
    size_t byte = bitpos >> 3;
    for (int i = 0; i < 5; i++)
      w = (w << 8) | (byte + i < nbytes ? buf[byte + i] : 0);
    return (uint32_t)(w >> (8 - (bitpos & 7)));
  }
  void advance(size_t n) {
    bitpos += n;
    if (bitpos > nbytes * 8) error = true;
  }
};

// ---------------------------------------------------------------------------
// predictor (see alacjax/oracle/dp.py)
// ---------------------------------------------------------------------------
void init_coefs(int16_t* c) {
  int den = 1 << kDenshift;
  c[0] = (int16_t)((AINIT * den) >> 4);
  c[1] = (int16_t)((BINIT * den) >> 4);
  c[2] = (int16_t)((CINIT * den) >> 4);
  for (int k = 3; k < kMaxCoefs; k++) c[k] = 0;
}

void pc_block(const int32_t* in, int32_t* out, int num, int16_t* coefs,
              int numactive, int chanbits, int denshift) {
  if (num > 0) out[0] = in[0];
  if (numactive == 0) { memcpy(out, in, num * 4); return; }
  if (numactive == 31) {
    for (int j = 1; j < num; j++)
      out[j] = sign_extend((int64_t)in[j] - in[j - 1], chanbits);
    return;
  }
  const int lim = numactive + 1;
  const int32_t denhalf = 1 << (denshift - 1);
  for (int j = 1; j < lim && j < num; j++)
    out[j] = sign_extend((int64_t)in[j] - in[j - 1], chanbits);

  for (int j = lim; j < num; j++) {
    int32_t top = in[j - lim];
    int32_t sum1 = denhalf;
    for (int k = 0; k < numactive; k++)
      sum1 += (int32_t)((int64_t)coefs[k] * (int32_t)((uint32_t)in[j - 1 - k] - (uint32_t)top));
    int32_t pred_adj = sum1 >> denshift;
    int32_t del = sign_extend((int64_t)in[j] - top - pred_adj, chanbits);
    out[j] = del;
    int32_t del0 = del;
    int sg = sign_of(del);
    if (sg > 0) {
      for (int k = numactive - 1; k >= 0; k--) {
        int32_t dd = (int32_t)((uint32_t)top - (uint32_t)in[j - 1 - k]);
        int sgn = sign_of(dd);
        coefs[k] = (int16_t)(coefs[k] - sgn);
        del0 -= (numactive - k) * ((sgn * dd) >> denshift);
        if (del0 <= 0) break;
      }
    } else if (sg < 0) {
      for (int k = numactive - 1; k >= 0; k--) {
        int32_t dd = (int32_t)((uint32_t)top - (uint32_t)in[j - 1 - k]);
        int sgn = sign_of(dd);
        coefs[k] = (int16_t)(coefs[k] + sgn);
        del0 -= (numactive - k) * ((-sgn * dd) >> denshift);
        if (del0 >= 0) break;
      }
    }
  }
}

void unpc_block(const int32_t* in, int32_t* out, int num, int16_t* coefs,
                int numactive, int chanbits, int denshift) {
  if (num > 0) out[0] = in[0];
  if (numactive == 0) { if (out != in) memcpy(out, in, num * 4); return; }
  if (numactive == 31) {
    int32_t prev = out[0];
    for (int j = 1; j < num; j++) {
      prev = sign_extend((int64_t)prev + in[j], chanbits);
      out[j] = prev;
    }
    return;
  }
  const int lim = numactive + 1;
  const int32_t denhalf = 1 << (denshift - 1);
  for (int j = 1; j < lim && j < num; j++)
    out[j] = sign_extend((int64_t)in[j] + out[j - 1], chanbits);

  for (int j = lim; j < num; j++) {
    int32_t top = out[j - lim];
    int32_t sum1 = denhalf;
    for (int k = 0; k < numactive; k++)
      sum1 += (int32_t)((int64_t)coefs[k] * (int32_t)((uint32_t)out[j - 1 - k] - (uint32_t)top));
    int32_t pred_adj = sum1 >> denshift;
    int32_t del = in[j];
    out[j] = sign_extend((int64_t)del + top + pred_adj, chanbits);
    int32_t del0 = del;
    int sg = sign_of(del);
    if (sg > 0) {
      for (int k = numactive - 1; k >= 0; k--) {
        int32_t dd = (int32_t)((uint32_t)top - (uint32_t)out[j - 1 - k]);
        int sgn = sign_of(dd);
        coefs[k] = (int16_t)(coefs[k] - sgn);
        del0 -= (numactive - k) * ((sgn * dd) >> denshift);
        if (del0 <= 0) break;
      }
    } else if (sg < 0) {
      for (int k = numactive - 1; k >= 0; k--) {
        int32_t dd = (int32_t)((uint32_t)top - (uint32_t)out[j - 1 - k]);
        int sgn = sign_of(dd);
        coefs[k] = (int16_t)(coefs[k] + sgn);
        del0 -= (numactive - k) * ((-sgn * dd) >> denshift);
        if (del0 >= 0) break;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// adaptive Rice (see alacjax/oracle/ag.py)
// ---------------------------------------------------------------------------
struct AgParams {
  uint32_t mb0, pb, kb, wb;
};

inline void run_kz_mz(uint32_t mb, uint32_t wb, uint32_t* kz, uint32_t* mz) {
  *kz = (uint32_t)(clz32(mb) - (int)BITOFF + (int)((mb + MOFF) >> MDENSHIFT));
  *mz = ((1u << *kz) - 1) & wb;
}

// 16-bit-escape codeword (run lengths)
inline void dyn_code16(uint32_t m, uint32_t k, uint32_t n, uint32_t* val,
                       int* nbits) {
  uint32_t div = n / m;
  if (div >= MAX_PREFIX) {
    *nbits = MAX_PREFIX + 16;
    *val = (((1u << MAX_PREFIX) - 1) << 16) + n;
  } else {
    uint32_t mod = n % m;
    uint32_t de = (mod == 0);
    *nbits = (int)(div + k + 1 - de);
    *val = (((1u << div) - 1) << (*nbits - div)) + mod + 1 - de;
  }
}

// returns true if escaped (caller then writes n with bit_size raw bits)
inline bool dyn_code32(uint32_t m, uint32_t k, uint32_t n, uint32_t* val,
                       int* nbits) {
  uint32_t div = n / m;
  if (div < MAX_PREFIX) {
    uint32_t mod = n - m * div;
    uint32_t de = (mod == 0);
    uint32_t nb = div + k + 1 - de;
    if (nb <= MAX_RICE_NUMBITS) {
      *nbits = (int)nb;
      *val = (((1u << div) - 1) << (nb - div)) + mod + 1 - de;
      return false;
    }
  }
  *nbits = MAX_PREFIX;
  *val = (1u << MAX_PREFIX) - 1;
  return true;
}

void dyn_comp(const AgParams& p, BitWriter& bw, const int32_t* in, int num,
              int bit_size) {
  uint32_t mb = p.mb0;
  uint32_t zmode = 0;
  int c = 0;
  while (c < num) {
    uint32_t m = mb >> QBSHIFT;
    uint32_t k = (uint32_t)lg3a(m);
    if (k > p.kb) k = p.kb;
    m = (1u << k) - 1;

    int32_t del = in[c];
    uint32_t n = ((uint32_t)(del < 0 ? -(int64_t)del : del) << 1)
                 - (del < 0 ? 1u : 0u) - zmode;

    uint32_t val; int nbits;
    bool esc = dyn_code32(m, k, n, &val, &nbits);
    bw.write(val, nbits);
    if (esc) bw.write(n, bit_size);

    c++;
    mb = p.pb * (n + zmode) + mb - ((p.pb * mb) >> PBSHIFT);
    if (n > N_MAX_MEAN_CLAMP) mb = N_MEAN_CLAMP_VAL;
    zmode = 0;

    if (((mb << MMULSHIFT) < QB) && c < num) {
      zmode = 1;
      uint32_t nz = 0;
      while (c < num && in[c] == 0) {
        nz++; c++;
        if (nz >= 65535) { zmode = 0; break; }
      }
      uint32_t kz, mz;
      run_kz_mz(mb, p.wb, &kz, &mz);
      dyn_code16(mz, kz, nz, &val, &nbits);
      bw.write(val, nbits);
      mb = 0;
    }
  }
}

int dyn_decomp(const AgParams& p, BitReader& br, int32_t* out, int num,
               int max_size) {
  uint32_t mb = p.mb0;
  uint32_t zmode = 0;
  int c = 0;
  while (c < num) {
    uint32_t m = mb >> QBSHIFT;
    uint32_t k = (uint32_t)lg3a(m);
    if (k > p.kb) k = p.kb;
    m = (1u << k) - 1;

    uint32_t stream = br.peek32();
    uint32_t pre = (uint32_t)clz32(~stream);
    uint32_t n;
    if (pre >= MAX_PREFIX) {
      br.advance(MAX_PREFIX);
      n = br.read(max_size);
    } else {
      n = pre * m;
      br.advance(pre + 1);
      if (k != 1) {
        uint32_t v = (stream << (pre + 1)) >> (32 - k);
        if (v >= 2) { n += v - 1; br.advance(k); }
        else br.advance(k - 1);
      }
    }
    if (br.error) return -1;

    uint32_t ndecode = n + zmode;
    uint32_t half = ndecode >> 1;
    out[c++] = (ndecode & 1) ? -(int32_t)(half + 1) : (int32_t)half;

    mb = p.pb * ndecode + mb - ((p.pb * mb) >> PBSHIFT);
    if (n > N_MAX_MEAN_CLAMP) mb = N_MEAN_CLAMP_VAL;
    zmode = 0;

    if (((mb << MMULSHIFT) < QB) && c < num) {
      zmode = 1;
      uint32_t kz, mz;
      run_kz_mz(mb, p.wb, &kz, &mz);
      uint32_t stream2 = br.peek32();
      uint32_t pre2 = (uint32_t)clz32(~stream2);
      uint32_t nz;
      if (pre2 >= MAX_PREFIX) {
        br.advance(MAX_PREFIX);
        nz = br.read(16);
      } else {
        nz = pre2 * mz;
        br.advance(pre2 + 1);
        if (kz != 1) {
          uint32_t v = (stream2 << (pre2 + 1)) >> (32 - kz);
          if (v >= 2) { nz += v - 1; br.advance(kz); }
          else br.advance(kz - 1);
        }
      }
      if (br.error || c + (int64_t)nz > num) return -1;
      for (uint32_t j = 0; j < nz; j++) out[c++] = 0;
      if (nz >= 65535) zmode = 0;
      mb = 0;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// element encode/decode (see alacjax/oracle/encoder.py / decoder.py)
// ---------------------------------------------------------------------------
inline int bytes_shifted_for_depth(int d) { return d == 32 ? 2 : d == 24 ? 1 : 0; }

struct CoefBank {
  int16_t c[2][kMaxCoefs];  // per order index {4, 8}
  bool init = false;
};

struct EncState {
  std::vector<CoefBank> banks;  // per channel
};

void ensure_banks(EncState* st, int nch) {
  if ((int)st->banks.size() < nch) st->banks.resize(nch);
  for (auto& b : st->banks)
    if (!b.init) { init_coefs(b.c[0]); init_coefs(b.c[1]); b.init = true; }
}

void write_header(BitWriter& bw, int tag, int instance, bool partial,
                  int bs, bool escape, int num, int frame_length) {
  bw.write((uint32_t)tag, 3);
  bw.write((uint32_t)instance, 4);
  bw.write(0, 12);
  bw.write(partial ? 1 : 0, 1);
  bw.write((uint32_t)bs, 2);
  bw.write(escape ? 1 : 0, 1);
  if (partial) bw.write((uint32_t)num, 32);
}

// v2 search dialect (mirrors alacjax.oracle.encoder; reference structure:
// codec/ALACEncoder.cpp :: EncodeStereo — subsampled stereo-mode trial,
// exact trials over predictor configurations)
AgParams standard_ag(const Config& cfg) {
  return AgParams{(uint32_t)cfg.mb, (uint32_t)(cfg.pb * PB_FACTOR / 4),
                  (uint32_t)cfg.kb, (1u << cfg.kb) - 1};
}

size_t rice_cost_bits(const Config& cfg, const int32_t* res, int num,
                      int chanbits) {
  std::vector<uint8_t> scratch((size_t)num * 6 + 64, 0);
  BitWriter bw{scratch.data(), scratch.size()};
  AgParams ag = standard_ag(cfg);
  dyn_comp(ag, bw, res, num, chanbits);
  return bw.bitpos;
}

void mix_streams(const int32_t* l, const int32_t* r, int32_t* u, int32_t* v,
                 int num, int mixres) {
  if (mixres == 0) {
    memcpy(u, l, (size_t)num * 4);
    memcpy(v, r, (size_t)num * 4);
    return;
  }
  const int32_t m2 = (1 << DEFAULT_MIX_BITS) - mixres;
  for (int j = 0; j < num; j++) {
    u[j] = (int32_t)((uint32_t)mixres * (uint32_t)l[j] +
                     (uint32_t)m2 * (uint32_t)r[j]) >> DEFAULT_MIX_BITS;
    v[j] = (int32_t)((uint32_t)l[j] - (uint32_t)r[j]);
  }
}

// exact dilated stereo-mode trial: mix every MIXRES_DILATE-th sample,
// predict with fresh order-8 coefs, Rice-cost both streams; argmin
// (first minimum wins)
int mixres_trial(const Config& cfg, const std::vector<int32_t>& l_hi,
                 const std::vector<int32_t>& r_hi, int num, int chanbits) {
  const int nd = (num + MIXRES_DILATE - 1) / MIXRES_DILATE;
  std::vector<int32_t> ld(nd), rd(nd), u(nd), v(nd), res(nd);
  for (int j = 0; j < nd; j++) {
    ld[j] = l_hi[(size_t)j * MIXRES_DILATE];
    rd[j] = r_hi[(size_t)j * MIXRES_DILATE];
  }
  int best_mr = 0;
  size_t best_cost = 0;
  for (int mr = 0; mr <= MAX_RES; mr++) {
    mix_streams(ld.data(), rd.data(), u.data(), v.data(), nd, mr);
    size_t cost = 0;
    for (const auto* s : {&u, &v}) {
      int16_t coefs[kMaxCoefs];
      init_coefs(coefs);
      pc_block(s->data(), res.data(), nd, coefs, FAST_ORDER, chanbits,
               kDenshift);
      cost += rice_cost_bits(cfg, res.data(), nd, chanbits);
    }
    if (mr == 0 || cost < best_cost) { best_cost = cost; best_mr = mr; }
  }
  return best_mr;
}

struct ChWin {
  int mode = 0, order = 0;
  size_t cost = 0;  // chparam + coef + rice bits for this channel
  int16_t coefs0[kMaxCoefs];
  int16_t coefs_adapted[kMaxCoefs];
  std::vector<int32_t> res;
};

// per-channel candidate search over order x stage; candidate order
// (4,1),(4,2),(8,1),(8,2), first minimum wins
void search_channel(const Config& cfg, EncState* st, const int32_t* stream,
                    int num, int chanbits, int ch_index, ChWin* win) {
  int orders[2], n_ord, n_stage;
  if (cfg.fast_mode) {
    orders[0] = FAST_ORDER; n_ord = 1; n_stage = 1;
  } else {
    orders[0] = SEARCH_ORDERS[0]; orders[1] = SEARCH_ORDERS[1];
    n_ord = 2; n_stage = 2;
  }
  bool have = false;
  std::vector<int32_t> res1(num), res2(num);
  for (int oi = 0; oi < n_ord; oi++) {
    const int order = orders[oi];
    const int bank = (order == SEARCH_ORDERS[0] && !cfg.fast_mode) ? 0 : 1;
    int16_t coefs0[kMaxCoefs], coefs[kMaxCoefs];
    memcpy(coefs0, st->banks[ch_index].c[bank], sizeof(coefs0));
    memcpy(coefs, coefs0, sizeof(coefs));
    pc_block(stream, res1.data(), num, coefs, order, chanbits, kDenshift);
    for (int stage = 1; stage <= n_stage; stage++) {
      const int32_t* res = res1.data();
      int mode = 0;
      if (stage == 2) {
        pc_block(res1.data(), res2.data(), num, nullptr, 31, chanbits, 0);
        res = res2.data();
        mode = 15;  // reference wire value for the two-stage cascade
      }
      size_t cost =
          16 + 16 * (size_t)order + rice_cost_bits(cfg, res, num, chanbits);
      if (!have || cost < win->cost) {
        have = true;
        win->cost = cost;
        win->mode = mode;
        win->order = order;
        memcpy(win->coefs0, coefs0, sizeof(coefs0));
        memcpy(win->coefs_adapted, coefs, sizeof(coefs));
        win->res.assign(res, res + num);
      }
    }
  }
}

void encode_element(const Config& cfg, EncState* st, BitWriter& bw,
                    int tag, int instance, const int32_t* const* chans,
                    int nch, int ch_index, int num, bool independent) {
  const bool partial = num != cfg.frame_length;
  const int bs = bytes_shifted_for_depth(cfg.bit_depth);
  const int chanbits = cfg.bit_depth - 8 * bs + (nch == 2 ? 1 : 0);
  const bool is_cpe = nch == 2;

  std::vector<int32_t> hi_buf[2];
  std::vector<uint16_t> lo_buf[2];
  std::vector<int32_t> u(num), v(num);

  // shift-off
  for (int ci = 0; ci < nch; ci++) {
    hi_buf[ci].resize(num);
    lo_buf[ci].resize(num);
    const int shift = bs * 8;
    const uint32_t mask = bs ? ((1u << shift) - 1) : 0;
    for (int j = 0; j < num; j++) {
      int32_t s = chans[ci][j];
      lo_buf[ci][j] = (uint16_t)(s & (int32_t)mask);
      hi_buf[ci][j] = bs ? (s >> shift) : s;
    }
  }

  // stereo mode + per-channel (order x stage) candidate search
  ChWin win[2];
  int mixres = 0;
  if (is_cpe && !cfg.fast_mode && cfg.exhaustive) {
    // exhaustive: full-rate exact trials over every mixres (the
    // compression-benchmark upper bound; oracle search="exhaustive")
    bool have = false;
    size_t best_total = 0;
    for (int mr = 0; mr <= MAX_RES; mr++) {
      mix_streams(hi_buf[0].data(), hi_buf[1].data(), u.data(), v.data(),
                  num, mr);
      ChWin cw[2];
      search_channel(cfg, st, u.data(), num, chanbits, ch_index, &cw[0]);
      search_channel(cfg, st, v.data(), num, chanbits, ch_index + 1, &cw[1]);
      size_t total = cw[0].cost + cw[1].cost;
      if (!have || total < best_total) {
        have = true;
        best_total = total;
        mixres = mr;
        win[0] = cw[0];
        win[1] = cw[1];
      }
    }
  } else {
    if (is_cpe) {
      mixres = cfg.fast_mode
                   ? FAST_MIX_RES
                   : mixres_trial(cfg, hi_buf[0], hi_buf[1], num, chanbits);
    }
    const int32_t* hi[2] = {hi_buf[0].data(),
                            nch == 2 ? hi_buf[1].data() : nullptr};
    if (is_cpe && mixres != 0) {
      mix_streams(hi_buf[0].data(), hi_buf[1].data(), u.data(), v.data(),
                  num, mixres);
      hi[0] = u.data();
      hi[1] = v.data();
    }
    for (int ci = 0; ci < nch; ci++)
      search_channel(cfg, st, hi[ci], num, chanbits, ch_index + ci, &win[ci]);
  }
  // 16 = mixBits/mixRes: present in EVERY non-escape element (mono
  // writes them as 0,0) — the reference decoder reads them blind;
  // confirmed vs libavcodec (tests/test_ffmpeg_interop.py)
  size_t body_bits = 16;
  for (int ci = 0; ci < nch; ci++) body_bits += win[ci].cost;
  body_bits += (size_t)num * nch * 8 * bs;

  size_t escape_bits = (size_t)num * cfg.bit_depth * nch;
  if (body_bits >= escape_bits) {
    write_header(bw, tag, instance, partial, 0, true, num, cfg.frame_length);
    for (int j = 0; j < num; j++)
      for (int ci = 0; ci < nch; ci++)
        bw.write((uint32_t)chans[ci][j], cfg.bit_depth);
    return;
  }

  if (!independent) {
    for (int ci = 0; ci < nch; ci++) {
      int bank =
          (win[ci].order == SEARCH_ORDERS[0] && !cfg.fast_mode) ? 0 : 1;
      memcpy(st->banks[ch_index + ci].c[bank], win[ci].coefs_adapted,
             sizeof(win[ci].coefs_adapted));
    }
  }

  write_header(bw, tag, instance, partial, bs, false, num, cfg.frame_length);
  if (is_cpe) {
    bw.write((uint32_t)DEFAULT_MIX_BITS, 8);
    bw.write((uint32_t)mixres & 0xFF, 8);
  } else {
    bw.write(0, 8);  // mixBits (mono: always 0)
    bw.write(0, 8);  // mixRes  (mono: always 0)
  }
  for (int ci = 0; ci < nch; ci++) {
    bw.write((uint32_t)((win[ci].mode << 4) | kDenshift), 8);
    bw.write((uint32_t)((PB_FACTOR << 5) | win[ci].order), 8);
    for (int k = 0; k < win[ci].order; k++)
      bw.write((uint16_t)win[ci].coefs0[k], 16);
  }
  if (bs) {
    for (int j = 0; j < num; j++)
      for (int ci = 0; ci < nch; ci++) bw.write(lo_buf[ci][j], bs * 8);
  }
  AgParams ag = standard_ag(cfg);
  for (int ci = 0; ci < nch; ci++)
    dyn_comp(ag, bw, win[ci].res.data(), num, chanbits);
}

int decode_element_channels(const Config& cfg, BitReader& br, int32_t* out0,
                            int32_t* out1, int nch, int* num_io) {
  int num = *num_io;
  const bool is_cpe = nch == 2;
  (void)br.read(4);  // element instance
  if (br.read(12) != 0) return -1;
  uint32_t hb = br.read(4);
  int partial = (int)(hb >> 3);
  int bs = (int)((hb >> 1) & 3);
  int esc = (int)(hb & 1);
  if (bs == 3) return -1;
  if (partial) num = (int)br.read(32);
  if (num <= 0 || num > cfg.frame_length) return -1;
  *num_io = num;

  if (esc) {
    int depth = cfg.bit_depth;
    for (int j = 0; j < num; j++) {
      out0[j] = sign_extend(br.read(depth), depth);
      if (is_cpe) out1[j] = sign_extend(br.read(depth), depth);
    }
    return br.error ? -1 : 0;
  }

  int chanbits = cfg.bit_depth - 8 * bs + (is_cpe ? 1 : 0);
  int mixbits = 0, mixres = 0;
  if (is_cpe) {
    mixbits = (int)br.read(8);
    mixres = sign_extend(br.read(8), 8);
  } else {
    br.read(8);  // mixBits: present in mono too, read and ignore
    br.read(8);  // mixRes
  }
  struct ChP { int mode, den, pbf, order; int16_t coefs[32]; } chp[2];
  for (int ci = 0; ci < nch; ci++) {
    uint32_t b1 = br.read(8);
    chp[ci].mode = (int)(b1 >> 4);
    chp[ci].den = (int)(b1 & 0xF);
    uint32_t b2 = br.read(8);
    chp[ci].pbf = (int)(b2 >> 5);
    chp[ci].order = (int)(b2 & 0x1F);
    for (int k = 0; k < chp[ci].order; k++)
      chp[ci].coefs[k] = (int16_t)br.read(16);
  }
  if (br.error) return -1;

  size_t shift_pos = br.bitpos;
  if (bs) br.advance((size_t)num * bs * 8 * nch);

  std::vector<int32_t> res(num);
  int32_t* outs[2] = {out0, out1};
  for (int ci = 0; ci < nch; ci++) {
    AgParams ag{(uint32_t)cfg.mb, (uint32_t)(cfg.pb * chp[ci].pbf / 4),
                (uint32_t)cfg.kb, (1u << cfg.kb) - 1};
    if (dyn_decomp(ag, br, res.data(), num, chanbits) != 0) return -1;
    if (chp[ci].mode != 0)
      unpc_block(res.data(), res.data(), num, nullptr, 31, chanbits, 0);
    int den = chp[ci].den;
    if (den == 0 && chp[ci].order != 0 && chp[ci].order != 31) return -1;
    unpc_block(res.data(), outs[ci], num, chp[ci].coefs, chp[ci].order,
               chanbits, den == 0 ? 1 : den);
  }

  // unmix + shift re-insert
  std::vector<uint32_t> sl, sr;
  if (bs) {
    BitReader sh{br.buf, br.nbytes};
    sh.bitpos = shift_pos;
    sl.resize(num);
    if (is_cpe) sr.resize(num);
    for (int j = 0; j < num; j++) {
      sl[j] = sh.read(bs * 8);
      if (is_cpe) sr[j] = sh.read(bs * 8);
    }
  }
  if (is_cpe) {
    for (int j = 0; j < num; j++) {
      int32_t uu = out0[j], vv = out1[j];
      int32_t l, r;
      if (mixres != 0) {
        r = (int32_t)((uint32_t)uu - (uint32_t)((int32_t)((uint32_t)mixres * (uint32_t)vv) >> mixbits));
        l = (int32_t)((uint32_t)vv + (uint32_t)r);
      } else { l = uu; r = vv; }
      if (bs) { l = (l << (bs * 8)) | (int32_t)sl[j]; r = (r << (bs * 8)) | (int32_t)sr[j]; }
      out0[j] = l; out1[j] = r;
    }
  } else if (bs) {
    for (int j = 0; j < num; j++)
      out0[j] = (out0[j] << (bs * 8)) | (int32_t)sl[j];
  }
  return br.error ? -1 : 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

void* alac_encoder_new() { return new EncState(); }
void alac_encoder_free(void* st) { delete (EncState*)st; }

// pcm: planar int32 (num_channels x num_samples).  Returns bytes written
// or negative on error.
// fast_mode: 0 = standard search, 1 = fast, 2 = exhaustive (bench bound)
int alac_encode_packet(void* state, const int32_t* pcm, int num_samples,
                       int frame_length, int bit_depth, int num_channels,
                       int pb, int mb, int kb, int max_run, int fast_mode,
                       int independent, uint8_t* out, int out_cap) {
  if (num_channels < 1 || num_channels > 8) return -50;
  if (num_samples < 1 || num_samples > frame_length) return -50;
  Config cfg{frame_length, bit_depth, pb, mb, kb, num_channels, max_run,
             fast_mode == 1, fast_mode == 2};
  EncState* st = (EncState*)state;
  EncState local;
  if (!st) st = &local;
  ensure_banks(st, num_channels);

  memset(out, 0, out_cap);
  BitWriter bw{out, (size_t)out_cap};

  static const int layouts[9][5] = {
      {}, {1, 0, 0, 0, 0}, {2, 0, 0, 0, 0}, {1, 2, 0, 0, 0},
      {1, 2, 1, 0, 0}, {1, 2, 2, 0, 0}, {1, 2, 2, -1, 0},
      {1, 2, 2, 1, -1}, {1, 2, 2, 2, -1}};
  int ch = 0;
  int inst_count[8] = {0};
  for (int e = 0; e < 5 && layouts[num_channels][e] != 0; e++) {
    int w = layouts[num_channels][e];
    bool lfe = w < 0;
    if (lfe) w = 1;
    int tag = w == 2 ? ID_CPE : (lfe ? ID_LFE : ID_SCE);
    const int32_t* chans[2] = {pcm + (size_t)ch * num_samples,
                               pcm + (size_t)(ch + 1) * num_samples};
    int instance = inst_count[tag]++;
    encode_element(cfg, st, bw, tag, instance, chans, w, ch, num_samples,
                   independent != 0);
    ch += w;
  }
  bw.write(ID_END, 3);
  bw.byte_align();
  if (bw.overflow) return -108;
  return (int)(bw.bitpos / 8);
}

// Returns decoded sample count or negative on error.
int alac_decode_packet(const uint8_t* data, int nbytes, int frame_length,
                       int bit_depth, int num_channels, int pb, int mb,
                       int kb, int max_run, int32_t* out /* planar */) {
  Config cfg{frame_length, bit_depth, pb, mb, kb, num_channels, max_run, 0,
             0};
  BitReader br{data, (size_t)nbytes};
  int ch = 0;
  int got = frame_length;
  while (true) {
    uint32_t tag = br.read(3);
    if (br.error) return -50;
    if (tag == ID_END) break;
    if (tag == ID_SCE || tag == ID_LFE || tag == ID_CPE) {
      int w = tag == ID_CPE ? 2 : 1;
      if (ch + w > num_channels) return -50;
      int num = frame_length;
      int32_t* o0 = out + (size_t)ch * frame_length;
      int32_t* o1 = w == 2 ? out + (size_t)(ch + 1) * frame_length : o0;
      int rc = decode_element_channels(cfg, br, o0, o1, w, &num);
      if (rc != 0) return -50;
      got = num;
      ch += w;
    } else if (tag == 4) {  // DSE
      (void)br.read(4);
      uint32_t align = br.read(1);
      uint32_t count = br.read(8);
      if (count == 255) count += br.read(8);
      if (align) br.advance((8 - (br.bitpos & 7)) & 7);
      br.advance(count * 8);
    } else if (tag == 6) {  // FIL
      uint32_t count = br.read(4);
      if (count == 15) count += br.read(8) - 1;
      br.advance(count * 8);
    } else {
      return -4;  // CCE/PCE unsupported
    }
    if (br.error) return -50;
  }
  if (ch != num_channels) return -50;
  return got;
}

}  // extern "C"
