// The line layout's ChaCha20 pads, made where they are used (sm_90a).
//
// Replaces, for line-sealed weights, the Pallas kernel
// src/repro/kernels/chacha20.py::chacha20_keystream (_keystream_kernel) as
// the reference applies it through core/engine.py::_line_otp in the
// engines' decrypt. Two entry points:
//
//   lines_unseal       a whole line-sealed leaf back to its words (the norm
//                      leaves of the serving view): one launch per leaf;
//   lines_gather_rows  only the lines that hold rows `tokens` of a (V, D)
//                      leaf, written as (tokens..., D) in the compute dtype
//                      (the embedding gather of a dispatch): no plaintext
//                      embedding ever reaches device memory.
//
// Keystream contract (_line_otp): line l (32 words, 128 bytes) under write
// counter wc XORs two ChaCha20 blocks, counter wc*2 + h for its half h,
// nonce (l, nonce2[0], nonce2[1]), u32 with wrap-around, when its flag is
// set (SE bypass otherwise). The two layouts keep wc and the flag apart:
//   ColoE    a 34-word record [32 data words | wc | flags], flag = bit 0:
//            data, counter and flag arrive in one read (the paper's
//            colocation);
//   counter  (L, 32) data lines and a separate (L,) counter word, flag =
//            bit 31, wc = its low 31 bits.
// Words past orig_len (the padding of a final partial line) are not written.
//
// What bounds it on this card: per half line 64 bytes read and written and
// one ChaCha block, whose 640 XORs and rotations issue only on the ALU pipe
// (16.7e12 lane operations a second against 3.35 TB/s): the pads bound it,
// at about 2.4x the bytes. The composition it replaces decrypted the 758 MB
// embedding each dispatch to gather four rows, after building int64 counter
// and nonce arrays for 11.85 M blocks. Here one thread takes one half line:
// it reads wc and the flag where the layout keeps them, makes the pad in
// registers and XORs it into the words it moves; the gather visits only the
// half lines of the wanted rows and rounds to bf16 as `.to(torch.bfloat16)`
// does (round to nearest even).
#include <cassert>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "chacha20.cuh"

namespace {

constexpr int kThreads = 256;

struct Lines {
  const uint32_t* payload;   // ColoE (L, 34) records or (L, 32) data lines
  const uint32_t* counters;  // counter layout: (L,); ColoE: nullptr
  const uint32_t* key;       // 8 words
  uint32_t n0, n1;           // nonce2
};

// The 16 words of half line u, unsealed when its line's flag is set.
__device__ __forceinline__ void unseal_half(const Lines& s, long long u,
                                            uint32_t w[16]) {
  const long long l = u >> 1;
  const uint32_t h = static_cast<uint32_t>(u & 1);
  uint32_t wc;
  bool enc;
  if (s.counters == nullptr) {
    // ColoE: a record is 136 bytes, so its halves are 8-byte aligned
    const uint32_t* rec = s.payload + l * 34;
    const uint2* src = reinterpret_cast<const uint2*>(rec + 16 * h);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint2 v = __ldg(src + q);
      w[2 * q] = v.x;
      w[2 * q + 1] = v.y;
    }
    const uint2 meta = __ldg(reinterpret_cast<const uint2*>(rec + 32));
    wc = meta.x;
    enc = meta.y & 1u;
  } else {
    const uint4* src =
        reinterpret_cast<const uint4*>(s.payload + l * 32 + 16 * h);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = __ldg(src + q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    const uint32_t cw = __ldg(s.counters + l);
    wc = cw & 0x7FFFFFFFu;
    enc = cw >> 31;
  }
  if (enc) {
    uint32_t k[8], p[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = __ldg(s.key + j);
    seal::chacha20_block(k, wc * 2u + h, static_cast<uint32_t>(l), s.n0,
                         s.n1, p);
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] ^= p[j];
  }
}

__global__ void __launch_bounds__(kThreads)
lines_unseal_kernel(Lines s, long long n_lines, long long orig_len,
                    uint32_t* __restrict__ out) {
  const long long u = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long w0 = 16 * u;
  if (u >= 2 * n_lines || w0 >= orig_len) return;
  uint32_t w[16];
  unseal_half(s, u, w);
  uint32_t* dst = out + w0;
  if (w0 + 16 <= orig_len) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (w0 + j < orig_len) dst[j] = w[j];
  }
}

// element q of a half line's words: 16 f32 or 32 bf16 (low half first)
template <bool SRC_BF16>
__device__ __forceinline__ uint32_t element(const uint32_t w[16], int q) {
  if (SRC_BF16) return (w[q >> 1] >> (16 * (q & 1))) & 0xFFFFu;
  return w[q];
}

// an element's bits in the output type
template <bool SRC_BF16, bool OUT_BF16>
__device__ __forceinline__ uint32_t convert(uint32_t v) {
  if (SRC_BF16 == OUT_BF16) return v;
  if (SRC_BF16) return v << 16;                       // bf16 -> f32, exact
  return __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(v)));
}

// Thread i: half line j of the row of token r. A row is elements
// [t*D, t*D + D) of the leaf; ALIGNED when D fills whole half lines (each
// row starts on one), else a row may share its first and last half lines
// with its neighbours and each element is placed on its own.
template <bool SRC_BF16, bool OUT_BF16, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
lines_gather_kernel(Lines s, const long long* __restrict__ tokens,
                    long long rows, long long vocab, long long d,
                    int per_row, void* __restrict__ out) {
  constexpr int EPH = SRC_BF16 ? 32 : 16;   // elements per half line
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= rows * per_row) return;
  const long long r = i / per_row;
  const int j = static_cast<int>(i % per_row);
  const long long t = __ldg(tokens + r);
  assert(t >= 0 && t < vocab);             // as PyTorch's indexing checks
  const long long e0 = t * d;               // the row's first element
  const long long u = e0 / EPH + j;         // this thread's half line
  const long long ue = u * EPH;             // its first element
  if (!ALIGNED && ue >= e0 + d) return;
  uint32_t w[16];
  unseal_half(s, u, w);
  if (ALIGNED) {
    // EPH elements to out[r*D + j*EPH ...], 16-byte aligned: pack and store
    constexpr int OUT_WORDS = OUT_BF16 ? EPH / 2 : EPH;
    uint32_t o[OUT_WORDS];
#pragma unroll
    for (int q = 0; q < OUT_WORDS; ++q) {
      if (OUT_BF16)
        o[q] = convert<SRC_BF16, true>(element<SRC_BF16>(w, 2 * q)) |
               (convert<SRC_BF16, true>(element<SRC_BF16>(w, 2 * q + 1))
                << 16);
      else
        o[q] = convert<SRC_BF16, false>(element<SRC_BF16>(w, q));
    }
    const long long first = r * d + static_cast<long long>(j) * EPH;
    uint4* dst = reinterpret_cast<uint4*>(
        OUT_BF16 ? static_cast<void*>(static_cast<uint16_t*>(out) + first)
                 : static_cast<void*>(static_cast<uint32_t*>(out) + first));
#pragma unroll
    for (int q = 0; q < OUT_WORDS / 4; ++q)
      dst[q] = make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < EPH; ++q) {
      const long long e = ue + q;
      if (e < e0 || e >= e0 + d) continue;
      const uint32_t v = convert<SRC_BF16, OUT_BF16>(element<SRC_BF16>(w, q));
      const long long at = r * d + (e - e0);
      if (OUT_BF16)
        static_cast<uint16_t*>(out)[at] = static_cast<uint16_t>(v);
      else
        static_cast<uint32_t*>(out)[at] = v;
    }
  }
}

template <bool SRC_BF16, bool OUT_BF16>
int launch_gather(const Lines& s, const long long* tokens, long long rows,
                  long long vocab, long long d, void* out,
                  cudaStream_t stream) {
  constexpr int EPH = SRC_BF16 ? 32 : 16;
  const bool aligned = d % EPH == 0;
  // half lines a row touches: d / EPH when aligned, else at most one more
  // than those its elements fill
  const int per_row = static_cast<int>(aligned ? d / EPH
                                               : (d + EPH - 1) / EPH + 1);
  const long long n = rows * per_row;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  if (aligned)
    lines_gather_kernel<SRC_BF16, OUT_BF16, true>
        <<<blocks, kThreads, 0, stream>>>(s, tokens, rows, vocab, d, per_row,
                                          out);
  else
    lines_gather_kernel<SRC_BF16, OUT_BF16, false>
        <<<blocks, kThreads, 0, stream>>>(s, tokens, rows, vocab, d, per_row,
                                          out);
  return static_cast<int>(cudaGetLastError());
}

Lines make_lines(const void* key, const void* payload, const void* counters,
                 unsigned n0, unsigned n1) {
  Lines s;
  s.payload = static_cast<const uint32_t*>(payload);
  s.counters = static_cast<const uint32_t*>(counters);
  s.key = static_cast<const uint32_t*>(key);
  s.n0 = n0;
  s.n1 = n1;
  return s;
}

}  // namespace

// key (8,) u32; payload: ColoE (L, 34) records
// (counters == NULL) or (L, 32) data lines with counters (L,), u32, 16-byte
// aligned (ColoE: 8); out (orig_len,) u32, 16-byte aligned. Device
// pointers; launches on `stream`; returns the launch's cudaError_t.
extern "C" int lines_unseal(const void* key, const void* payload,
                            const void* counters, long long n_lines,
                            long long orig_len, unsigned n0, unsigned n1,
                            void* out, void* stream) {
  if (n_lines <= 0 || orig_len <= 0) return 0;
  const Lines s = make_lines(key, payload, counters, n0, n1);
  const long long units = 2 * n_lines;
  lines_unseal_kernel<<<static_cast<int>((units + kThreads - 1) / kThreads),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, n_lines, orig_len, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The rows `tokens` (rows,) int64 of a (vocab, d) leaf of f32 (src_bf16 ==
// 0) or bf16 elements, line-sealed as for lines_unseal, into out (rows, d)
// f32 (out_bf16 == 0) or bf16, 16-byte aligned. A token outside [0, vocab)
// fails a device-side assert. Returns the launch's cudaError_t.
extern "C" int lines_gather_rows(const void* key, const void* payload,
                                 const void* counters, unsigned n0,
                                 unsigned n1, const void* tokens,
                                 long long rows, long long vocab, long long d,
                                 int src_bf16, int out_bf16, void* out,
                                 void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const Lines s = make_lines(key, payload, counters, n0, n1);
  const long long* tk = static_cast<const long long*>(tokens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (src_bf16)
    return out_bf16
               ? launch_gather<true, true>(s, tk, rows, vocab, d, out, st)
               : launch_gather<true, false>(s, tk, rows, vocab, d, out, st);
  return out_bf16
             ? launch_gather<false, true>(s, tk, rows, vocab, d, out, st)
             : launch_gather<false, false>(s, tk, rows, vocab, d, out, st);
}
