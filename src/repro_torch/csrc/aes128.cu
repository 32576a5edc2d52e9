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
// What bounds it on this card: each enciphered block costs 160 table
// lookups (16 per round), and shared memory serves one 32-bit word per bank
// per clock, 32 banks an SM (8.36e12 lookups a second), against 32 bytes
// moved per block at 3.35 TB/s: the lookups bound it, at about 1.2x the
// bytes for a leaf of the Direct image.
//
// Design: T-tables replicated once per bank (Tezcan, "Optimization of
// Advanced Encryption Standard on Graphics Processing Units", IEEE Access
// 2021), so that no lookup of a warp replays. Shared memory is cut into
// 64 KB regions of 256 entries x 256 bytes; an entry holds two table slots
// of 32 words each, one word per bank. Lane l reads entry x of slot s at
// byte
//     (s / 2) * 65536 + x * 256 + (s % 2) * 128 + 4 * l,
// which is bank l whatever x is. x * 256 + 4 * l is one byte permute
// (PRMT) of the state word and the lane's offset, and the slot's part is
// the load's immediate offset, so a lookup costs one PRMT and one LDS.
// Slots 0..3 hold T0..T3 (Tj = T0 rotated left by 8j bits: Te for the
// cipher, MixColumns x S-box; Td for the inverse, InvMixColumns x inverse
// S-box), so a column of a middle round is four lookups and three XORs.
// The cipher's last round takes S[x] from byte 1 of Te0[x]; the inverse's
// takes the inverse S-box from slot 4 (one byte a word). Four bytes of a
// column's last round are joined by three PRMTs. The tables come from the
// (5, 256) words that kernels/aes128.py builds once per device (T0..T3 and
// the S-box of each direction) and are staged by each block of threads.
// The 44 round-key words (for the inverse cipher, FIPS-197 §5.3.5's
// equivalent keys: InvMixColumns of rounds 1-9, made while staging) are
// read as one 16-byte broadcast a round.
//
// The regions make 128 KB (cipher) or 192 KB (inverse) of dynamic shared
// memory, one block of 1024 threads an SM. Staging one or two tables and
// making the others by rotation in registers was no faster (PERF.md §6).
// A thread takes one 16-byte block at a time with one 16-byte load and
// store, in a grid-stride loop that loads its next block before it ciphers
// this one.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kRegion = 65536;      // bytes: 256 entries x 2 slots x 32 banks
constexpr int kMaxDevices = 64;

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

// table slots staged: T0..T3, and the inverse S-box for the inverse cipher
template <bool INV>
constexpr int kSlots = INV ? 5 : 4;

template <bool INV>
constexpr int kSmem = (kSlots<INV> + 1) / 2 * kRegion;

// x * 256 + lane4, x byte j of w: entry x of a table for this lane
__device__ __forceinline__ uint32_t entry(uint32_t w, uint32_t lane4, int j) {
  return __byte_perm(w, lane4, 0x5504u | (static_cast<uint32_t>(j) << 4));
}

__device__ __forceinline__ uint32_t lookup(const unsigned char* sm,
                                           uint32_t e, int slot) {
  return *reinterpret_cast<const uint32_t*>(
      sm + e + (slot >> 1) * kRegion + (slot & 1) * 128);
}

template <bool INV>
__device__ __forceinline__ void stage(unsigned char* sm, uint32_t* keys,
                                      const uint32_t* __restrict__ tab,
                                      const uint32_t* __restrict__ rk) {
  constexpr int slots = kSlots<INV>;
  constexpr int quads = kSmem<INV> / 16;
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    const int w = 4 * q;                      // the quad's first word
    const int slot = 2 * (w >> 14) + ((w >> 5) & 1);
    if (slot >= slots) continue;
    const uint32_t v = __ldg(tab + 256 * slot + ((w >> 6) & 255));
    reinterpret_cast<uint4*>(sm)[q] = make_uint4(v, v, v, v);
  }
  const int i = threadIdx.x;
  if (i < 44) {
    const uint32_t w = __ldg(rk + i);
    keys[i] = (INV && i >= 4 && i < 40) ? inv_mix_column(w) : w;
  }
  __syncthreads();
}

// The cipher (INV false) or the equivalent inverse cipher on one block.
// Column c of a round reads row j from column c + j (ShiftRows) or c - j
// (InvShiftRows).
template <bool INV>
__device__ __forceinline__ void cipher(const unsigned char* sm,
                                       const uint4* keys, uint32_t lane4,
                                       uint32_t s[4]) {
  constexpr int D = INV ? 3 : 1;
  uint4 k = keys[INV ? 10 : 0];
  s[0] ^= k.x;
  s[1] ^= k.y;
  s[2] ^= k.z;
  s[3] ^= k.w;
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    k = keys[INV ? 10 - r : r];
    const uint32_t kc[4] = {k.x, k.y, k.z, k.w};
    uint32_t t[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      t[c] = lookup(sm, entry(s[c], lane4, 0), 0) ^
             lookup(sm, entry(s[(c + D) & 3], lane4, 1), 1) ^
             lookup(sm, entry(s[(c + 2 * D) & 3], lane4, 2), 2) ^
             lookup(sm, entry(s[(c + 3 * D) & 3], lane4, 3), 3) ^ kc[c];
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = t[c];
  }
  // last round: byte r of column c is the S-box (inverse S-box) of byte r
  // of column c + r (c - r); the cipher's S[x] is byte 1 of Te0[x], the
  // inverse S-box byte 0 of slot 4
  k = keys[INV ? 0 : 10];
  const uint32_t kc[4] = {k.x, k.y, k.z, k.w};
  constexpr int slot = INV ? 4 : 0;
  constexpr uint32_t p = INV ? 0u : 1u;
  uint32_t t[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t w0 = lookup(sm, entry(s[c], lane4, 0), slot);
    const uint32_t w1 = lookup(sm, entry(s[(c + D) & 3], lane4, 1), slot);
    const uint32_t w2 = lookup(sm, entry(s[(c + 2 * D) & 3], lane4, 2), slot);
    const uint32_t w3 = lookup(sm, entry(s[(c + 3 * D) & 3], lane4, 3), slot);
    const uint32_t lo = __byte_perm(w0, w1, p | ((p + 4) << 4));
    const uint32_t hi = __byte_perm(w2, w3, p | ((p + 4) << 4));
    t[c] = __byte_perm(lo, hi, 0x5410u) ^ kc[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = t[c];
}

struct Block {
  uint32_t s[4];
  bool on;        // cipher it (its line's flag), else copy it
};

__device__ __forceinline__ Block load_block(const uint32_t* __restrict__ in,
                                            long long n_in,
                                            const uint32_t* __restrict__ flags,
                                            long long b) {
  Block x;
  const long long w0 = 4 * b;
  if (w0 + 4 <= n_in) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(in) + b);
    x.s[0] = v.x;
    x.s[1] = v.y;
    x.s[2] = v.z;
    x.s[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x.s[j] = w0 + j < n_in ? __ldg(in + w0 + j) : 0u;
  }
  x.on = flags == nullptr || (__ldg(flags + (b >> 3)) & 1u);
  return x;
}

template <bool INV>
__global__ void __launch_bounds__(kThreads, 1)
aes128_kernel(const uint32_t* __restrict__ tab,
              const uint32_t* __restrict__ rk,
              const uint32_t* __restrict__ in, long long n_in,
              const uint32_t* __restrict__ flags, long long used,
              uint32_t* __restrict__ out, long long n_out) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ __align__(16) uint32_t keys[44];
  stage<INV>(sm, keys, tab, rk);
  const uint32_t lane4 = 4u * (threadIdx.x & 31u);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= used) return;
  Block x = load_block(in, n_in, flags, b);
  for (;;) {
    const long long nb = b + stride;
    Block nx;
    if (nb < used) nx = load_block(in, n_in, flags, nb);
    if (x.on) cipher<INV>(sm, reinterpret_cast<const uint4*>(keys), lane4,
                          x.s);
    const long long w0 = 4 * b;
    if (w0 + 4 <= n_out) {
      reinterpret_cast<uint4*>(out)[b] =
          make_uint4(x.s[0], x.s[1], x.s[2], x.s[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (w0 + j < n_out) out[w0 + j] = x.s[j];
    }
    if (nb >= used) break;
    b = nb;
    x = nx;
  }
}

template <bool INV>
int launch(const void* tab, const void* rk, const void* in, long long n_in,
           const void* flags, long long n_blocks, void* out, long long n_out,
           void* stream) {
  // blocks with a word below n_out
  const long long used = (n_out + 3) / 4 < n_blocks ? (n_out + 3) / 4
                                                    : n_blocks;
  if (used <= 0) return 0;
  auto kernel = aes128_kernel<INV>;
  constexpr int smem = kSmem<INV>;
  // resident blocks of threads on the whole card, found once per device
  static int resident[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int cap = device < kMaxDevices ? resident[device] : 0;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cap = sms * per_sm;
    if (device < kMaxDevices) resident[device] = cap;
  }
  const long long want = (used + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < cap ? want : cap);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tab), static_cast<const uint32_t*>(rk),
      static_cast<const uint32_t*>(in), n_in,
      static_cast<const uint32_t*>(flags), used,
      static_cast<uint32_t*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables: the (5, 256) u32 words of the cipher's direction (Te0..Te3, the
// S-box), kernels/aes128.py::kernel_tables; rk: the 44 encryption
// round-key words ((11, 16) bytes); in: n_in u32 words, 16-byte aligned;
// flags: one u32 per 128-byte line (8 blocks), bit 0 set = cipher, or NULL
// (every block); out: 4 * n_blocks u32 words, 16-byte aligned. Device
// pointers; launches on `stream`; returns the launch's cudaError_t.
extern "C" int aes128_encrypt(const void* tables, const void* rk,
                              const void* in, long long n_in,
                              const void* flags, long long n_blocks, void* out,
                              void* stream) {
  return launch<false>(tables, rk, in, n_in, flags, n_blocks, out,
                       4 * n_blocks, stream);
}

// tables: the inverse direction's (5, 256) words (Td0..Td3, the inverse
// S-box); in: 4 * n_blocks u32 words of ciphertext, 16-byte aligned; out:
// the first n_out (<= 4 * n_blocks) plaintext words, 16-byte aligned; the
// rest as for aes128_encrypt (rk is the encryption schedule: the kernel
// makes the inverse cipher's keys).
extern "C" int aes128_decrypt(const void* tables, const void* rk,
                              const void* in, const void* flags,
                              long long n_blocks, long long n_out, void* out,
                              void* stream) {
  return launch<true>(tables, rk, in, 4 * n_blocks, flags, n_blocks, out,
                      n_out, stream);
}
