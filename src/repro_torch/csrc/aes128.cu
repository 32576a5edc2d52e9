// AES-128 ECB on 16-byte blocks (sm_90a): the Direct engine's cipher.
//
// Replaces no Pallas kernel: the reference runs AES as plain jnp,
// src/repro/core/cipher.py::aes128_encrypt_blocks / aes128_decrypt_blocks
// (the S-box by gather), called by core/engine.py::DirectEngine on every
// line of every leaf. Two entry points, one template:
//
//   aes128_encrypt  n_blocks blocks of ciphertext from the first n_in words
//                   of `in` (zero-padded past them): sealing a leaf (its
//                   lines, flags given) or any run of blocks (flags NULL);
//   aes128_decrypt  the first n_out plaintext words of n_blocks blocks: a
//                   Direct leaf back to its words in every dispatch.
//
// Layout: a block is 4 consecutive u32 words, its bytes little-endian, the
// AES state column-major (word c is column c, row r in bits 8r..8r+7), as
// the reference's byte views of its words. A 128-byte line is 8 blocks;
// when `flags` is given, a block is ciphered only if bit 0 of its line's
// flag is set, else copied (SE bypass, paper §3.3). Words past n_out are
// not written, so a leaf's padding never reaches its output.
//
// Design (first version, correct and simple): 32-bit T-tables. Each
// thread block stages in shared memory the four tables of its direction
// (Te0..Te3 = MixColumns x S-box, or Td0..Td3 = InvMixColumns x inverse
// S-box; Tj = Te0 rotated by 8j bits), the S-box (or its inverse) for the
// last round, and the 44 round-key words (for the inverse cipher, FIPS-197
// §5.3.5's equivalent keys: InvMixColumns of rounds 1-9). The tables are
// made in the block from the 256-byte S-box, 4.4 KB in all. One thread
// takes one block at a time with one 16-byte load and store, in a
// grid-stride loop over a grid of 8 blocks per SM, so the staging is paid
// about 1000 times per launch and not once per 4 KB of data.
//
// What bounds it on this card: each enciphered block costs 160 table
// lookups (16 per round), and shared memory serves 32 words per clock per
// SM (8.36e12 a second), against 32 bytes moved per block at 3.35 TB/s:
// the lookups bound it at about 1.2x the bytes for a fully enciphered leaf.
// Random indices into 256-word tables hit 32 banks with conflicts (about
// 3.5-way for a warp), which this version takes as they come.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;      // one thread a table entry while staging
constexpr int kBlocksPerSM = 8;

struct Tables {
  uint32_t t[4][256];   // Te0..Te3 or Td0..Td3
  uint8_t s[256];       // S-box, or the inverse S-box
  uint32_t k[44];       // round-key words, round r at [4r, 4r + 4)
};

__device__ __forceinline__ uint32_t xtime(uint32_t b) {
  return ((b << 1) ^ ((b & 0x80u) ? 0x1Bu : 0u)) & 0xFFu;
}

__device__ __forceinline__ uint32_t gmul(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // b < 16: 9, 11, 13, 14
    if (b & 1u) r ^= a;
    a = xtime(a);
    b >>= 1;
  }
  return r;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

// InvMixColumns column of x: rows (14x, 9x, 13x, 11x)
__device__ __forceinline__ uint32_t inv_col(uint32_t x) {
  return gmul(x, 14) | (gmul(x, 9) << 8) | (gmul(x, 13) << 16) |
         (gmul(x, 11) << 24);
}

// InvMixColumns of one state column (a round-key word)
__device__ __forceinline__ uint32_t inv_mix_column(uint32_t w) {
  return inv_col(w & 0xFFu) ^ rotl(inv_col((w >> 8) & 0xFFu), 8) ^
         rotl(inv_col((w >> 16) & 0xFFu), 16) ^ rotl(inv_col(w >> 24), 24);
}

template <bool INV>
__device__ __forceinline__ void stage(Tables& sm, const uint8_t* sbox,
                                      const uint32_t* rk) {
  const int i = threadIdx.x;
  const uint32_t s = __ldg(sbox + i);
  uint32_t t0;
  if (!INV) {
    sm.s[i] = static_cast<uint8_t>(s);
    const uint32_t s2 = xtime(s);     // MixColumns column: (2s, s, s, 3s)
    t0 = s2 | (s << 8) | (s << 16) | ((s2 ^ s) << 24);
  } else {
    sm.s[s] = static_cast<uint8_t>(i);  // the inverse S-box
    __syncthreads();
    t0 = inv_col(sm.s[i]);
  }
  sm.t[0][i] = t0;
  sm.t[1][i] = rotl(t0, 8);
  sm.t[2][i] = rotl(t0, 16);
  sm.t[3][i] = rotl(t0, 24);
  if (i < 44) {
    const uint32_t w = __ldg(rk + i);
    sm.k[i] = (INV && i >= 4 && i < 40) ? inv_mix_column(w) : w;
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t byte_of(uint32_t x, int j) {
  return (x >> (8 * j)) & 0xFFu;
}

// The cipher (INV false) or the equivalent inverse cipher on one block.
// Column c of a round reads row j from column c + j (ShiftRows) or c - j
// (InvShiftRows).
template <bool INV>
__device__ __forceinline__ void cipher(const Tables& sm, uint32_t s[4]) {
  constexpr int D = INV ? 3 : 1;
  const int first = INV ? 40 : 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] ^= sm.k[first + c];
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    const int kr = INV ? 40 - 4 * r : 4 * r;
    uint32_t t[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      t[c] = sm.t[0][byte_of(s[c], 0)] ^
             sm.t[1][byte_of(s[(c + D) & 3], 1)] ^
             sm.t[2][byte_of(s[(c + 2 * D) & 3], 2)] ^
             sm.t[3][byte_of(s[(c + 3 * D) & 3], 3)] ^ sm.k[kr + c];
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = t[c];
  }
  const int last = INV ? 0 : 40;
  uint32_t t[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    t[c] = (static_cast<uint32_t>(sm.s[byte_of(s[c], 0)]) |
            (static_cast<uint32_t>(sm.s[byte_of(s[(c + D) & 3], 1)]) << 8) |
            (static_cast<uint32_t>(sm.s[byte_of(s[(c + 2 * D) & 3], 2)])
             << 16) |
            (static_cast<uint32_t>(sm.s[byte_of(s[(c + 3 * D) & 3], 3)])
             << 24)) ^
           sm.k[last + c];
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = t[c];
}

template <bool INV>
__global__ void __launch_bounds__(kThreads)
aes128_kernel(const uint8_t* __restrict__ sbox,
              const uint32_t* __restrict__ rk,
              const uint32_t* __restrict__ in, long long n_in,
              const uint32_t* __restrict__ flags, long long n_blocks,
              uint32_t* __restrict__ out, long long n_out) {
  __shared__ Tables sm;
  stage<INV>(sm, sbox, rk);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long b = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       b < n_blocks; b += stride) {
    const long long w0 = 4 * b;
    if (w0 >= n_out) break;
    uint32_t s[4];
    if (w0 + 4 <= n_in) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(in) + b);
      s[0] = v.x;
      s[1] = v.y;
      s[2] = v.z;
      s[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = w0 + j < n_in ? __ldg(in + w0 + j) : 0u;
    }
    if (flags == nullptr || (__ldg(flags + (b >> 3)) & 1u)) cipher<INV>(sm, s);
    if (w0 + 4 <= n_out) {
      reinterpret_cast<uint4*>(out)[b] = make_uint4(s[0], s[1], s[2], s[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (w0 + j < n_out) out[w0 + j] = s[j];
    }
  }
}

template <bool INV>
int launch(const void* sbox, const void* rk, const void* in, long long n_in,
           const void* flags, long long n_blocks, void* out, long long n_out,
           void* stream) {
  const long long used = (n_out + 3) / 4 < n_blocks ? (n_out + 3) / 4
                                                    : n_blocks;
  if (used <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (used + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSM;
  const int grid = static_cast<int>(want < cap ? want : cap);
  aes128_kernel<INV><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sbox), static_cast<const uint32_t*>(rk),
      static_cast<const uint32_t*>(in), n_in,
      static_cast<const uint32_t*>(flags), n_blocks,
      static_cast<uint32_t*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sbox: the 256-byte AES S-box; rk: the 44 encryption round-key words
// ((11, 16) bytes); in: n_in u32 words, 16-byte aligned; flags: one u32 per
// 128-byte line (8 blocks), bit 0 set = cipher, or NULL (every block);
// out: 4 * n_blocks u32 words, 16-byte aligned. Device pointers; launches
// on `stream`; returns the launch's cudaError_t.
extern "C" int aes128_encrypt(const void* sbox, const void* rk,
                              const void* in, long long n_in,
                              const void* flags, long long n_blocks, void* out,
                              void* stream) {
  return launch<false>(sbox, rk, in, n_in, flags, n_blocks, out,
                       4 * n_blocks, stream);
}

// in: 4 * n_blocks u32 words of ciphertext, 16-byte aligned; out: the first
// n_out (<= 4 * n_blocks) plaintext words, 16-byte aligned; the rest as for
// aes128_encrypt (rk is the encryption schedule: the kernel makes the
// inverse cipher's keys).
extern "C" int aes128_decrypt(const void* sbox, const void* rk,
                              const void* in, const void* flags,
                              long long n_blocks, long long n_out, void* out,
                              void* stream) {
  return launch<true>(sbox, rk, in, 4 * n_blocks, flags, n_blocks, out,
                      n_out, stream);
}
