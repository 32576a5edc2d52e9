// ChaCha20 block function (RFC 7539), shared by the keystream kernel
// (chacha20.cu), the fused decrypt-in-matmul kernels (sealed_matmul*.cu)
// and the kernels that make pads where they are used (chacha20_*.cu).
// Ports the rounds of src/repro/kernels/chacha20.py::_chacha_rounds / _qr.
// Below them, the Carter-Wegman MAC pieces (src/repro/core/mac.py) that the
// cache tags (chacha20_cache.cu) and the weight tags (chacha20_weights.cu)
// share.
#pragma once
#include <cstdint>

namespace seal {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);  // one SHF instruction
}

#define SEAL_CHACHA_QR(a, b, c, d) \
  a += b; d ^= a; d = rotl32(d, 16); \
  c += d; b ^= c; b = rotl32(b, 12); \
  a += b; d ^= a; d = rotl32(d, 8);  \
  c += d; b ^= c; b = rotl32(b, 7);

// One 64-byte keystream block: 20 rounds plus the feed-forward add.
// The state lives in 16 registers; `out` is fully unrolled into registers.
__device__ __forceinline__ void chacha20_block(const uint32_t key[8],
                                               uint32_t counter, uint32_t n0,
                                               uint32_t n1, uint32_t n2,
                                               uint32_t out[16]) {
  const uint32_t c0 = 0x61707865u, c1 = 0x3320646eu, c2 = 0x79622d32u,
                 c3 = 0x6b206574u;  // "expand 32-byte k"
  uint32_t x0 = c0, x1 = c1, x2 = c2, x3 = c3;
  uint32_t x4 = key[0], x5 = key[1], x6 = key[2], x7 = key[3];
  uint32_t x8 = key[4], x9 = key[5], x10 = key[6], x11 = key[7];
  uint32_t x12 = counter, x13 = n0, x14 = n1, x15 = n2;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    SEAL_CHACHA_QR(x0, x4, x8, x12)
    SEAL_CHACHA_QR(x1, x5, x9, x13)
    SEAL_CHACHA_QR(x2, x6, x10, x14)
    SEAL_CHACHA_QR(x3, x7, x11, x15)
    SEAL_CHACHA_QR(x0, x5, x10, x15)
    SEAL_CHACHA_QR(x1, x6, x11, x12)
    SEAL_CHACHA_QR(x2, x7, x8, x13)
    SEAL_CHACHA_QR(x3, x4, x9, x14)
  }
  out[0] = x0 + c0;       out[1] = x1 + c1;
  out[2] = x2 + c2;       out[3] = x3 + c3;
  out[4] = x4 + key[0];   out[5] = x5 + key[1];
  out[6] = x6 + key[2];   out[7] = x7 + key[3];
  out[8] = x8 + key[4];   out[9] = x9 + key[5];
  out[10] = x10 + key[6]; out[11] = x11 + key[7];
  out[12] = x12 + counter; out[13] = x13 + n0;
  out[14] = x14 + n1;     out[15] = x15 + n2;
}

#undef SEAL_CHACHA_QR

// ---- Carter-Wegman MACs (core/mac.py) ----
//
// tag = uhash(message) XOR pad. uhash is sum(r_i * m_i) mod (2^31 - 1) over
// the message's 16-bit halves m_i (low half of a word first) with keys
// r_i < 2^31. Each product is below 2^47 and a message has at most 2^16
// halves, so the sum is exact in 64 bits and the same in any order: one
// wide multiply-add a half, one modulo a tag. The reference's u32 folds
// compute the same value (they reduce the exact sum mod p).

constexpr uint32_t kP31 = 0x7FFFFFFFu;

// The hash terms of one word: its low and high halves times their keys.
__device__ __forceinline__ unsigned long long mac_word_terms(uint32_t w,
                                                             uint32_t k_lo,
                                                             uint32_t k_hi) {
  return static_cast<unsigned long long>(k_lo) * (w & 0xFFFFu) +
         static_cast<unsigned long long>(k_hi) * (w >> 16);
}

// The terms of four words at message position 4q from their eight keys,
// two 16-byte loads at keys + 8q (16-byte aligned).
__device__ __forceinline__ unsigned long long mac_quad_terms(
    const uint4& w, const uint32_t* __restrict__ keys, long long q) {
  const uint4* k4 = reinterpret_cast<const uint4*>(keys) + 2 * q;
  const uint4 ka = __ldg(k4), kb = __ldg(k4 + 1);
  return mac_word_terms(w.x, ka.x, ka.y) + mac_word_terms(w.y, ka.z, ka.w) +
         mac_word_terms(w.z, kb.x, kb.y) + mac_word_terms(w.w, kb.z, kb.w);
}

// The pad: word 0 of ChaCha20(MAC key, counter = addr, nonce = (n0, n1,
// n2)), the unit's layer id and write counter already XORed into n0, n1.
__device__ __forceinline__ uint32_t mac_pad(const uint32_t key[8],
                                            uint32_t addr, uint32_t n0,
                                            uint32_t n1, uint32_t n2) {
  uint32_t p[16];
  chacha20_block(key, addr, n0, n1, n2, p);
  return p[0];
}

// The sum of every thread's acc over a block of NT threads (a multiple of
// 32), returned to thread 0 (other threads get a partial sum).
template <int NT>
__device__ __forceinline__ unsigned long long mac_block_sum(
    unsigned long long acc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xFFFFFFFFu, acc, o);
  __shared__ unsigned long long part[NT / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 1; j < NT / 32; ++j) acc += part[j];
  }
  return acc;
}

// A finished tag from its exact hash sum and its pad.
__device__ __forceinline__ uint32_t mac_tag(unsigned long long sum,
                                            uint32_t pad) {
  return static_cast<uint32_t>(sum % kP31) ^ pad;
}

}  // namespace seal
