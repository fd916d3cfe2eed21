// The dropout masks of the training pass, evaluated in registers: the
// counter-based generator of ops/dropout_rng.py (Philox4x32-10) on the card.
// Included by attn_softmax.cu (F3) and fused_layer.cu (F2 and the site
// kernel); ops/_cuda.py hashes it into both libraries' names.
//
// The keep bit of element n of a dropout site (n its flat index in the whole
// site) depends on the site's seed, n and dropout_bits only:
//   key = (seed low word, seed high word), counter = (q low, q high, 0, 0),
//   q = n / m with m = 4 (32 bits), 8 (16) or 16 (8) masks a call;
//   8, 16 bits: field n % m of the four output words in order, each word
//     little-endian; keep iff field >= t;
//   32 bits: word n % 4, keep iff (w >> 8) < t, t = ceil(f32(keep_p) * 2^24)
//     (the same as (w >> 8) * 2^-24 < keep_p in float32).
// The wrapper passes t (ops/dropout_rng.py `compare_threshold`) and the key.
//
// What it costs: a call is 10 rounds of two 32 x 32 -> 64-bit products
// (__umulhi and the low product) and two three-input xors, the key bumped
// between rounds. A run of K consecutive elements with n % K == 0 needs
// ceil(K / m) calls: two for an eight-element vector at 32 bits, one at 16
// and half of one at 8. The keep bits of a run come back as one word of
// bits (bit i: element n + i), not as an array of bools, which would hold a
// register each. The 8- and 16-bit fields of a word are compared at once
// (`fields_ge`), and where the two lanes of a pair hold the two halves of
// an 8-bit call, each evaluates one call of two and they swap two words
// (`pair_bits8`).

#pragma once

#include <stdint.h>

namespace dropout_rng {

// A dropout site's generator and threshold; nbits 0 is no dropout.
struct Site {
  uint32_t k0, k1;     // Philox key: the seed's low and high words
  uint32_t t;          // the integer threshold (see above)
  int nbits;           // 8, 16, 32, or 0
  float inv_keep_p;    // 1 / keep_p in f32, the kept values' scale
};

inline Site make_site(uint32_t seed_lo, uint32_t seed_hi, int nbits, uint32_t t,
                      float keep_p) {
  return Site{seed_lo, seed_hi, t, nbits, nbits == 0 ? 1.0f : 1.0f / keep_p};
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four output words of call q of the site, as an array.
__device__ __forceinline__ void call_words(const Site& s, unsigned long long q,
                                           uint32_t w[4]) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)q, (uint32_t)(q >> 32), 0u, 0u), s.k0, s.k1);
  w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
}

// w[i] for a run-time i < 4, by selects (no indexed local memory).
__device__ __forceinline__ uint32_t pick(const uint32_t w[4], unsigned i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// Whether mask field f of a word (already shifted down) keeps its element.
template <int NBITS>
__device__ __forceinline__ uint32_t kept(uint32_t f, uint32_t t) {
  if constexpr (NBITS == 32) return (f >> 8) < t;
  else return (f & ((1u << NBITS) - 1u)) >= t;
}

// The keep bits of the K elements n .. n + K - 1 of the site at NBITS bits
// (bit i: element n + i), n % K == 0, K a power of two up to 16. A call
// holds M = 128 / NBITS masks, PER = 32 / NBITS a word; a run of K >= PER
// elements starts on a word, so each field's place in its word is known at
// compile time and only the first word (K < M) is picked at run time.
template <int NBITS, int K>
__device__ __forceinline__ uint32_t keep_bits(const Site& s, unsigned long long n) {
  constexpr int M = 128 / NBITS, PER = 32 / NBITS;
  uint32_t bits = 0;
#pragma unroll
  for (int c = 0; c < (K + M - 1) / M; ++c) {
    uint32_t w[4];
    call_words(s, n / M + c, w);
    // The run's first field in this call (0 when the run covers calls).
    const unsigned sub0 = K < M ? (unsigned)(n % M) : 0u;
#pragma unroll
    for (int i = 0; i < (K < M ? K : M); ++i) {
      uint32_t f;
      if (K >= PER) {     // the run starts on a word: fields at fixed places
        const uint32_t word = K >= M ? w[i / PER] : pick(w, sub0 / PER + i / PER);
        f = NBITS == 32 ? word : word >> (NBITS * (i % PER));
      } else {            // one field of a word at a run-time place
        const unsigned sub = sub0 + i;
        f = pick(w, sub / PER) >> (NBITS * (sub % PER));
      }
      bits |= kept<NBITS>(f, s.t) << (M * c + i);
    }
  }
  return bits;
}

// keep_bits at the site's dropout_bits (8, 16 or 32; a warp-uniform branch).
template <int K>
__device__ __forceinline__ uint32_t keep_run(const Site& s, unsigned long long n) {
  if (s.nbits == 32) return keep_bits<32, K>(s, n);
  if (s.nbits == 16) return keep_bits<16, K>(s, n);
  return keep_bits<8, K>(s, n);
}

// Whether each field of w (4 of 8 bits, or 2 of 16: F) is >= t, compared
// all at once: with H the fields' top bits, (w | H) - (t's low bits in
// every field) has a field's top bit set where w's low bits are >= t's
// (no borrow crosses a field), and w >= t where w's top bit is set and
// t's not, or both equal and that bit set. Bit i of the result: field i.
template <int F>
__device__ __forceinline__ uint32_t fields_ge(uint32_t w, uint32_t t) {
  constexpr uint32_t H = F == 8 ? 0x80808080u : 0x80008000u;
  constexpr uint32_t ONES = F == 8 ? 0x01010101u : 0x00010001u;
  const uint32_t lo = (t & (H / ONES - 1)) * ONES;     // t's low bits, every field
  const uint32_t hi = t & (H / ONES) ? H : 0u;         // t's top bit, every field
  const uint32_t low_ge = (w | H) - lo;
  const uint32_t ge = ((w & ~hi) | (~(w ^ hi) & low_ge)) & H;
  if constexpr (F == 8) return ((ge >> 7) * 0x01020408u) >> 24;   // bits 0, 8, 16, 24 gathered
  else return (ge >> 15 & 1u) | ge >> 30;
}

// The keep bits (bit k: element k) at 8 bits of an 8-element run from two of
// a call's words: fields 0 .. 3 of w0, then of w1.
__device__ __forceinline__ uint32_t bits8(uint32_t w0, uint32_t w1, uint32_t t) {
  return fields_ge<8>(w0, t) | fields_ge<8>(w1, t) << 4;
}

// The keep bits of an 8-element run starting at n (n % 8 == 0) at NB bits:
// two calls at 32 bits, one at 16, half of one at 8; the bits of
// keep_bits<NB, 8>, with 8- and 16-bit fields compared a word at a time.
template <int NB>
__device__ __forceinline__ uint32_t lane_bits(const Site& s, unsigned long long n) {
  if constexpr (NB == 32) {   // a compare a word (faster than w < t * 256)
    return keep_bits<32, 8>(s, n);
  } else {
    uint32_t w[4];
    call_words(s, n / (128 / NB), w);
    if constexpr (NB == 8) {  // fields n % 16 .. + 7 of the call: words 0, 1 or 2, 3
      return n % 16 ? bits8(w[2], w[3], s.t) : bits8(w[0], w[1], s.t);
    } else {
      uint32_t bits = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) bits |= fields_ge<16>(w[i], s.t) << (2 * i);
      return bits;
    }
  }
}

// 8-bit masks of two runs of 16 elements a lane pair, each one Philox call
// (n0 % 16 == n1 % 16 == 0): lanes 2i and 2i + 1 (of a full warp) hold, in
// run c, elements n_c .. n_c + 7 and n_c + 8 .. n_c + 15, and both pass the
// same n0, n1. The even lane evaluates run 0's call, the odd lane run 1's,
// and each takes the two words it lacks from the other by a shuffle: one
// call a lane for two runs. Returns the lane's bits of both (bit 8 c + k).
// F3 passes a row's chunks 8 LPR keys apart, F2 a lane pair's adjacent
// vectors 32 vectors apart.
__device__ __forceinline__ uint32_t pair_bits8(const Site& s, unsigned long long n0,
                                               unsigned long long n1, bool odd) {
  uint32_t w[4];
  call_words(s, (odd ? n1 : n0) / 16, w);
  const uint32_t a = __shfl_xor_sync(0xffffffffu, odd ? w[0] : w[2], 1);
  const uint32_t b = __shfl_xor_sync(0xffffffffu, odd ? w[1] : w[3], 1);
  return odd ? bits8(a, b, s.t) | bits8(w[2], w[3], s.t) << 8
             : bits8(w[0], w[1], s.t) | bits8(a, b, s.t) << 8;
}

}  // namespace dropout_rng
