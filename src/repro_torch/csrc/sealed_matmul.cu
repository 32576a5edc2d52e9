// Fused decrypt-in-matmul over tile-sealed weights, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/sealed_matmul.py::sealed_matmul
// (_make_kernel):  y = x @ f32(w_ct XOR pad), the pad XORed only on rows whose
// SE row_mask is set, both operands rounded to the compute dtype (bf16 or
// f32) and accumulated in f32.
//
// Keystream contract (kernels/ref.py::tile_counters). The word at (i, j) of a
// (K, N) leaf sealed with tiles (bk, bn) lies in tile
// t = (i/bk)*(N/bn) + j/bn, at word w = t*bk*bn + (i%bk)*bn + j%bn, and takes
// lane w%16 of ChaCha block  wc*(K*N/16) + w/16  (mod 2^32). The compute tile
// here (BK x BN) need not match the seal's (bk, bn): every block works out its
// counters per 16-word unit. For bn >= 16 a unit is 16 consecutive words of
// one row; for bn == 8 it is 8 words of an even tile row and 8 of the next.
//
// What bounds it on this card. At decode M is 4..16, so each weight word is
// read once (4 bytes) and, if its row is encrypted, needs 1/16 of a ChaCha
// block (62 32-bit integer ops). At the H100's 3.35 TB/s and its issue rate
// of 33.5e12 32-bit lane operations per second, the integer work sets the
// bound where more than about 65% of rows are encrypted, and the weight
// reads below that (SE ratio 0.5). The design therefore:
//   * makes each pad once per weight word: one block owns a column strip for
//     all M rows (M up to 64 per block, ragged M masked, never padded to a
//     large tile) and K is split across blocks (deterministic second pass)
//     so that small N still fills 132 SMs;
//   * skips the ChaCha work of plaintext rows: a warp ballot gives the slab's
//     row mask and threads take only the units of encrypted rows, so at SE
//     ratio 0.5 about half the integer work is done;
//   * keeps the ciphertext tile in shared memory, XORs the pad there, and
//     runs the f32 FMA over the rounded operands from shared memory.
// wgmma, TMA and a producer/consumer pipeline are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "chacha20.cuh"

namespace {

constexpr int BK = 32;   // weight rows per K step (one warp ballot of mask)
constexpr int BN = 64;   // output columns per block
constexpr int NT = 128;  // threads per block

__device__ __forceinline__ float round_cdt(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <int BM>
__global__ void __launch_bounds__(NT)
sealed_matmul_kernel(const float* __restrict__ x,
                     const uint32_t* __restrict__ w,
                     const uint8_t* __restrict__ row_mask,
                     const uint32_t* __restrict__ key,
                     const uint32_t* __restrict__ nonce,
                     const uint32_t* __restrict__ wc_ptr,
                     float* __restrict__ out,  // (splits, M, N)
                     int M, int K, int N, int bk, int bn, int k_per_split,
                     int bf16) {
  __shared__ float xs[BM][BK];
  __shared__ __align__(16) uint32_t ws[BK][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.y * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int m0 = blockIdx.z * BM;

  uint32_t kw[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) kw[j] = __ldg(key + j);
  const uint32_t nz0 = __ldg(nonce), nz1 = __ldg(nonce + 1),
                 nz2 = __ldg(nonce + 2);
  const uint32_t uniq = static_cast<uint32_t>(
      static_cast<uint64_t>(K) * static_cast<uint64_t>(N) / 16);
  const uint32_t base = __ldg(wc_ptr) * uniq;  // wraps mod 2^32 like u32
  const uint32_t nn_tiles = static_cast<uint32_t>(N / bn);
  const bool wide = bn >= 16;
  const int unit_cols = wide ? 16 : 8;
  const int units_per_row = BN / unit_cols;

  const int col = tid % BN;
  const int rg = tid / BN;  // NT / BN = 2 row groups
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    // activations, rounded to the compute dtype; rows >= M and K-tail are 0
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int m = idx / BK, kk = idx % BK;
      float v = 0.f;
      if (m0 + m < M && k0 + kk < K)
        v = x[static_cast<size_t>(m0 + m) * K + k0 + kk];
      xs[m][kk] = round_cdt(v, bf16);
    }
    // ciphertext tile, 16-byte loads (N % 8 == 0: a chunk is wholly in/out)
    for (int idx = tid; idx < BK * BN / 4; idx += NT) {
      const int r = idx / (BN / 4), c4 = idx % (BN / 4);
      const int gk = k0 + r, gn = n0 + 4 * c4;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gk < K && gn < N)
        v = __ldg(reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(gk) * N + gn));
      *reinterpret_cast<uint4*>(&ws[r][4 * c4]) = v;
    }
    // encrypted rows of this slab; every warp computes the same word
    const bool enc = (k0 + lane < K) && row_mask[k0 + lane] != 0;
    const unsigned rows = __ballot_sync(0xffffffffu, enc);
    // units that need a pad: one per encrypted row (wide), or one per even
    // row whose pair holds an encrypted row (bn == 8)
    const unsigned unit_rows = wide ? rows : ((rows | (rows >> 1)) & 0x55555555u);
    const int nunits = __popc(unit_rows) * units_per_row;
    __syncthreads();

    for (int u = tid; u < nunits; u += NT) {
      const int ridx = u / units_per_row, cg = u % units_per_row;
      unsigned rest = unit_rows;
      for (int q = 0; q < ridx; ++q) rest &= rest - 1;  // drop lower set bits
      const int r = __ffs(rest) - 1;
      const int gk = k0 + r, gn = n0 + cg * unit_cols;
      if (gn >= N) continue;
      const uint32_t t = static_cast<uint32_t>(gk / bk) * nn_tiles +
                         static_cast<uint32_t>(gn / bn);
      const uint32_t wid = t * static_cast<uint32_t>(bk * bn) +
                           static_cast<uint32_t>((gk % bk) * bn + gn % bn);
      uint32_t ks[16];
      seal::chacha20_block(kw, base + wid / 16, nz0, nz1, nz2, ks);
      if (wide) {
#pragma unroll
        for (int j = 0; j < 16; ++j) ws[r][cg * 16 + j] ^= ks[j];
      } else {
        const bool e0 = (rows >> r) & 1u, e1 = (rows >> (r + 1)) & 1u;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (e0) ws[r][cg * 8 + j] ^= ks[j];
          if (e1) ws[r + 1][cg * 8 + j] ^= ks[8 + j];
        }
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float wv = round_cdt(__uint_as_float(ws[kk][col]), bf16);
#pragma unroll
      for (int i = 0; i < BM / 2; ++i)
        acc[i] = fmaf(xs[rg + 2 * i][kk], wv, acc[i]);
    }
    __syncthreads();
  }

  if (n0 + col < N) {
    float* o = out + static_cast<size_t>(blockIdx.y) * M * N;
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const int m = m0 + rg + 2 * i;
      if (m < M) o[static_cast<size_t>(m) * N + n0 + col] = acc[i];
    }
  }
}

// out[i] = sum over splits, in split order (deterministic)
__global__ void splitk_reduce(const float* __restrict__ part,
                              float* __restrict__ out, int splits, int mn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[static_cast<size_t>(sp) * mn + i];
  out[i] = s;
}

template <int BM>
void launch(dim3 grid, cudaStream_t st, const float* x, const uint32_t* w,
            const uint8_t* mask, const uint32_t* key, const uint32_t* nonce,
            const uint32_t* wc, float* out, int M, int K, int N, int bk,
            int bn, int kps, int bf16) {
  sealed_matmul_kernel<BM><<<grid, NT, 0, st>>>(x, w, mask, key, nonce, wc,
                                                out, M, K, N, bk, bn, kps, bf16);
}

}  // namespace

// x (M, K) f32; w (K, N) u32 tile-sealed; row_mask (K,) u8; key (8,) u32;
// nonce (3,) u32; wc (1,) u32 -- all device pointers. `part` is the
// (splits, M, N) f32 scratch when splits > 1 (else unused) and `out` the
// (M, N) f32 result. K, N multiples of 8 and of (bk, bn); k_per_split a
// multiple of 32; bm, the rows of M per block, one of 8, 16, 32, 64 (the
// wrapper picks it and the split). Returns the cudaError_t of the launches.
extern "C" int sealed_matmul(const void* x, const void* w, const void* row_mask,
                             const void* key, const void* nonce, const void* wc,
                             void* part, void* out, int M, int K, int N,
                             int bk, int bn, int bm, int splits,
                             int k_per_split, int bf16, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (bm != 8 && bm != 16 && bm != 32 && bm != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, splits, (M + bm - 1) / bm);
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  const float* xp = static_cast<const float*>(x);
  const uint32_t* wp = static_cast<const uint32_t*>(w);
  const uint8_t* mp = static_cast<const uint8_t*>(row_mask);
  const uint32_t* kp = static_cast<const uint32_t*>(key);
  const uint32_t* np_ = static_cast<const uint32_t*>(nonce);
  const uint32_t* cp = static_cast<const uint32_t*>(wc);
  switch (bm) {
    case 8:  launch<8>(grid, st, xp, wp, mp, kp, np_, cp, dst, M, K, N, bk, bn, k_per_split, bf16); break;
    case 16: launch<16>(grid, st, xp, wp, mp, kp, np_, cp, dst, M, K, N, bk, bn, k_per_split, bf16); break;
    case 32: launch<32>(grid, st, xp, wp, mp, kp, np_, cp, dst, M, K, N, bk, bn, k_per_split, bf16); break;
    case 64: launch<64>(grid, st, xp, wp, mp, kp, np_, cp, dst, M, K, N, bk, bn, k_per_split, bf16); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const int mn = M * N;
  splitk_reduce<<<(mn + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), splits, mn);
  return static_cast<int>(cudaGetLastError());
}
