// ChaCha20 block function (RFC 7539), shared by the keystream kernel
// (chacha20.cu) and the fused decrypt-in-matmul kernel (sealed_matmul.cu).
// Ports the rounds of src/repro/kernels/chacha20.py::_chacha_rounds / _qr.
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

}  // namespace seal
