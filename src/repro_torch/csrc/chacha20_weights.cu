// The sealed weight image's Carter-Wegman tags, pads made in the kernel
// (sm_90a).
//
// Replaces, for the weight MACs, the Pallas kernel
// src/repro/kernels/chacha20.py::chacha20_keystream (_keystream_kernel) as
// the reference applies it through src/repro/core/mac.py::tile_tags and
// ::line_tags (mac_pads), with the hash (uhash) it composes around them, in
// sealed_store.py::verify_params and at sealing. Two entry points:
//
//   tile_tags  one tag per (bk, bn) tile of a tile-sealed (K, N) weight, for
//              every stack slice: the tile's words row-major with the SE
//              bypass rows zeroed, hashed, XOR word 0 of ChaCha20(MAC key,
//              counter = tile address ti * (N / bn) + tj, nonce = (m0,
//              m1 ^ wc[slice], m2));
//   line_tags  one tag per 128-byte line record of a line-sealed leaf: the
//              full stored record (ColoE: 34 words, counter and flags in
//              it; counter layout: 32 data words and the separate counter
//              word appended), hashed, XOR word 0 of ChaCha20(MAC key,
//              counter = line address, nonce = (m0, m1, m2)).
// (m0, m1, m2) is the MAC domain's nonce XOR the leaf's tweak; the hash and
// pad pieces are chacha20.cuh's mac_*.
//
// What bounds it on this card. tile_tags: a tile's encrypted rows, read
// once (a zeroed bypass row adds nothing to sum(r_i * m_i), so its words
// are not read at all), about 3 integer operations a half, and one pad a
// tile: the bytes. The sweep over internlm2-1.8B at SE 0.5 reads about
// 0.9 G words of 1.7 G. line_tags: 136 (ColoE) or 132 bytes a line against
// one pad a line, 640 ALU-pipe operations at 16.7e12/s: the pads and the
// bytes about level (5.9 M lines for the embedding). The composition it
// replaces built int64 halves of every word and int64 counter and nonce
// arrays for every pad: tens of GB of temporaries at full width.
//
// tile_tags: one block of threads a (tile, slice), each thread taking
// 16-byte quads of the tile's rows in turn (a warp covers 512 contiguous
// bytes of a row when bn = 128), the row's SE flag read first; the hash
// keys (2 * bk * bn words, shared by every tile) come from L2. line_tags:
// one thread a line; a block stages its 128 records in shared memory with
// coalesced loads (rows of an odd stride, so the threads' reads of their
// own records do not conflict), makes its line's pad, and hashes.
#include <cuda_runtime.h>
#include <cstdint>

#include "chacha20.cuh"

namespace {

constexpr int kThreads = 256;       // tile_tags: threads a tile
constexpr int kLines = 128;         // line_tags: lines (threads) a block

struct Nonce {
  uint32_t w[3];
};

__device__ __forceinline__ void load_key(const uint32_t* __restrict__ key,
                                         uint32_t k[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) k[j] = __ldg(key + j);
}

// Block (t, s): the tag of tile t of slice s. ct: (S, K, N) words, mask
// (S, K) bytes, wc (S,), out (S, nk * nn). bn = 1 << log_bn; VEC: 16-byte
// quads (bn % 4 == 0, every row start 16-byte aligned, hkeys too).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
tile_tags_kernel(const uint32_t* __restrict__ key,
                 const uint32_t* __restrict__ hkeys,
                 const uint32_t* __restrict__ ct,
                 const unsigned char* __restrict__ mask,
                 const uint32_t* __restrict__ wc, uint32_t* __restrict__ out,
                 int k, int n, int bk, int log_bn, Nonce m) {
  const int bn = 1 << log_bn;
  const int nn = n / bn;
  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const int ti = t / nn, tj = t - ti * nn;
  const long long slice = static_cast<long long>(k) * n;
  const uint32_t* base = ct + s * slice + static_cast<long long>(ti) * bk * n +
                         static_cast<long long>(tj) * bn;
  const unsigned char* rows = mask + static_cast<long long>(s) * k + ti * bk;
  uint32_t pad = 0u;
  if (threadIdx.x == 0) {           // the pad overlaps the other loads
    uint32_t kw[8];
    load_key(key, kw);
    pad = seal::mac_pad(kw, static_cast<uint32_t>(t), m.w[0],
                        m.w[1] ^ __ldg(wc + s), m.w[2]);
  }
  unsigned long long acc = 0;
  if (VEC) {
    const int log_q = log_bn - 2;   // quads a row: bn / 4
    const int quads = bk << log_q;
#pragma unroll 4
    for (int q = threadIdx.x; q < quads; q += kThreads) {
      const int r = q >> log_q;
      if (!__ldg(rows + r)) continue;
      const int c = (q & ((1 << log_q) - 1)) * 4;
      const uint4 w = *reinterpret_cast<const uint4*>(
          base + static_cast<long long>(r) * n + c);
      acc += seal::mac_quad_terms(w, hkeys, q);
    }
  } else {
    const int words = bk << log_bn;
#pragma unroll 4
    for (int q = threadIdx.x; q < words; q += kThreads) {
      const int r = q >> log_bn;
      if (!__ldg(rows + r)) continue;
      const uint32_t w = base[static_cast<long long>(r) * n + (q & (bn - 1))];
      acc += seal::mac_word_terms(w, __ldg(hkeys + 2 * q),
                                  __ldg(hkeys + 2 * q + 1));
    }
  }
  acc = seal::mac_block_sum<kThreads>(acc);
  if (threadIdx.x == 0)
    out[static_cast<long long>(s) * gridDim.x + t] = seal::mac_tag(acc, pad);
}

// Thread i of block b: the tag of line l = b * kLines + i, at address
// line0 + l. COLOE: payload (L, 34) records, 8-byte aligned; else payload
// (L, 32) data lines, 16-byte aligned, and counters (L,).
template <bool COLOE>
__global__ void __launch_bounds__(kLines)
line_tags_kernel(const uint32_t* __restrict__ key,
                 const uint32_t* __restrict__ hkeys,
                 const uint32_t* __restrict__ payload,
                 const uint32_t* __restrict__ counters, long long n_lines,
                 uint32_t line0, Nonce m, uint32_t* __restrict__ out) {
  constexpr int W = COLOE ? 34 : 33;        // message words a line
  constexpr int S = W | 1;                  // odd shared stride
  __shared__ uint32_t rec[kLines * S];
  __shared__ uint32_t hk[2 * W];
  const long long l0 = static_cast<long long>(blockIdx.x) * kLines;
  const int nl = static_cast<int>(min(static_cast<long long>(kLines),
                                      n_lines - l0));
  const int i = threadIdx.x;
  for (int j = i; j < 2 * W; j += kLines) hk[j] = __ldg(hkeys + j);
  if (COLOE) {
    const uint2* src = reinterpret_cast<const uint2*>(payload + l0 * 34);
    for (int v = i; v < nl * 17; v += kLines) {
      const uint2 x = __ldg(src + v);
      const int r = v / 17, c = 2 * (v - r * 17);
      rec[r * S + c] = x.x;
      rec[r * S + c + 1] = x.y;
    }
  } else {
    const uint4* src = reinterpret_cast<const uint4*>(payload + l0 * 32);
    for (int v = i; v < nl * 8; v += kLines) {
      const uint4 x = __ldg(src + v);
      uint32_t* d = rec + (v >> 3) * S + (v & 7) * 4;
      d[0] = x.x;
      d[1] = x.y;
      d[2] = x.z;
      d[3] = x.w;
    }
    if (i < nl) rec[i * S + 32] = __ldg(counters + l0 + i);
  }
  uint32_t pad = 0u;
  if (i < nl) {                     // the pad overlaps other warps' loads
    uint32_t kw[8];
    load_key(key, kw);
    pad = seal::mac_pad(kw, line0 + static_cast<uint32_t>(l0 + i), m.w[0],
                        m.w[1], m.w[2]);
  }
  __syncthreads();
  if (i >= nl) return;
  unsigned long long acc = 0;
#pragma unroll
  for (int j = 0; j < W; ++j)
    acc += seal::mac_word_terms(rec[i * S + j], hk[2 * j], hk[2 * j + 1]);
  out[l0 + i] = seal::mac_tag(acc, pad);
}

}  // namespace

// key (8,) u32 MAC key; hkeys (2*bk*bn,) u32 hash keys in [1, 2^31 - 1); ct
// (slices, K, N) u32, contiguous; mask (slices, K) bytes (non-zero: the row
// is encrypted); wc (slices,) u32; out (slices, K/bk, N/bn) u32. bk, bn
// powers of two dividing K and N, bk * bn <= 32768; m0..m2 the MAC nonce
// XOR the leaf's tweak. vec != 0: bn % 4 == 0 and ct and hkeys 16-byte
// aligned. Device pointers; launches on `stream`; returns the launch's
// cudaError_t.
extern "C" int tile_tags(const void* key, const void* hkeys, const void* ct,
                         const void* mask, const void* wc, void* out,
                         int slices, int k, int n, int bk, int bn,
                         unsigned m0, unsigned m1, unsigned m2, int vec,
                         void* stream) {
  if (slices <= 0 || k <= 0 || n <= 0) return 0;
  int log_bn = 0;
  while ((1 << log_bn) < bn) ++log_bn;
  const Nonce m{{m0, m1, m2}};
  const dim3 grid((k / bk) * (n / bn), slices);
  auto launch = vec ? tile_tags_kernel<true> : tile_tags_kernel<false>;
  launch<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(hkeys),
      static_cast<const uint32_t*>(ct),
      static_cast<const unsigned char*>(mask),
      static_cast<const uint32_t*>(wc), static_cast<uint32_t*>(out), k, n, bk,
      log_bn, m);
  return static_cast<int>(cudaGetLastError());
}

// key (8,) u32 MAC key; hkeys (2*W,) u32 hash keys (W = 34 ColoE, 33
// counter layout); payload: ColoE (L, 34) records (counters == NULL, 8-byte
// aligned) or (L, 32) data lines (16-byte aligned) with counters (L,) u32;
// out (L,) u32; the line of row l sits at address line0 + l. Device
// pointers; launches on `stream`; returns the launch's cudaError_t.
extern "C" int line_tags(const void* key, const void* hkeys,
                         const void* payload, const void* counters,
                         long long n_lines, unsigned line0, unsigned m0,
                         unsigned m1, unsigned m2, void* out, void* stream) {
  if (n_lines <= 0) return 0;
  const Nonce m{{m0, m1, m2}};
  const long long blocks = (n_lines + kLines - 1) / kLines;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* k = static_cast<const uint32_t*>(key);
  const uint32_t* h = static_cast<const uint32_t*>(hkeys);
  const uint32_t* p = static_cast<const uint32_t*>(payload);
  const uint32_t* c = static_cast<const uint32_t*>(counters);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (c == nullptr)
    line_tags_kernel<true><<<static_cast<unsigned>(blocks), kLines, 0, st>>>(
        k, h, p, c, n_lines, line0, m, o);
  else
    line_tags_kernel<false><<<static_cast<unsigned>(blocks), kLines, 0, st>>>(
        k, h, p, c, n_lines, line0, m, o);
  return static_cast<int>(cudaGetLastError());
}
