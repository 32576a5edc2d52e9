// Fused decrypt-in-matmul on Hopper's tensor cores, bf16, for M > 64
// (sm_90a).
//
// Replaces, for compute dtype bf16, M > 64, N % 128 == 0 and seal tiles
// bn >= 16, the Pallas kernel src/repro/kernels/sealed_matmul.py::
// sealed_matmul (_make_kernel):  y = bf16(x) @ bf16(f32(w_ct XOR pad)), the
// pad XORed only on rows whose SE row_mask is set, products summed in f32.
// Every other case (decode M <= 64, f32, bn == 8) runs sealed_matmul.cu.
// The keystream contract is sealed_matmul.cu's: the word at (i, j) of a
// (K, N) leaf sealed with tiles (bk, bn) lies in tile t = (i/bk)*(N/bn) +
// j/bn, at word w = t*bk*bn + (i%bk)*bn + j%bn, and takes lane w%16 of ChaCha
// block wc*(K*N/16) + w/16 (mod 2^32). With bn >= 16 a 16-word unit is 16
// consecutive words of one row, and one ChaCha block pads it.
//
// No plaintext weight ever reaches device memory: each ciphertext slab is
// decrypted into shared memory, rounded to bf16 there and consumed by the
// tensor cores.
//
// What bounds it on this card. At a group prefill (M = 3560 rows) the bf16
// products take 2*M*K*N / 989e12 s (10.9 ms for the 1.51 G weight words of
// internlm2-1.8B), and the pads 976 integer operations per 16 encrypted
// words per pass over the weights; a block of BM rows of M makes each pad
// once, so the pads cost ceil(M/BM) passes (at SE 0.5 and BM = 256 about
// 20 ms at the card's 33.5e12 32-bit operations per second, 39 ms at
// BM = 128). The pads, not the products, set the pace, which is why a block
// takes 256 rows of M (sealed_matmul.cu took 64). The design:
//   * one block per 256 x 128 output tile, 544 threads: four consumer
//     warpgroups of 64 rows each and one producer warp; blocks along M run
//     side by side so the 14 blocks of one column strip share its
//     ciphertext through L2;
//   * the producer streams, per K step of 64, the bf16 x tile (256 x 64)
//     and the ciphertext slab (64 x 128 u32, as four 32-column boxes) by
//     TMA, both in the 128-byte swizzle, into a ring of 3 stages guarded by
//     mbarriers;
//   * the 512 consumer threads decrypt the slab, one 16-word unit each: a
//     warp ballot gives the slab's 64-row SE mask and units are ranked
//     encrypted rows first, so no thread makes more than one ChaCha block
//     per step whatever the mask (at SE 0.5 half of them make one); the key
//     and nonce are read from shared memory, which keeps the 64
//     accumulators and the ChaCha state within the 96 registers that 544
//     threads leave. Each XORs in registers, rounds f32 -> bf16 (round to
//     nearest even, as the reference's cast) and stores into a bf16 B tile
//     in the swizzled MN-major layout; then fence.proxy.async and a named
//     barrier hand the tile to the tensor cores;
//   * each warpgroup runs wgmma m64n128k16 (A = its 64 rows of x from
//     shared memory, K-major; B = the decrypted tile, MN-major) into 64 f32
//     accumulators per thread. B is double-buffered, so the ChaCha of step
//     k+1 overlaps the wgmma of step k;
//   * no split-K: 3560/256 x N/128 >= 224 tiles fill 132 SMs, and the
//     result is deterministic.
// Not yet: a cluster of blocks along M sharing one decrypted tile through
// distributed shared memory, to cut the pad passes further.
#include "chacha20.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 256;  // rows of M per block (four warpgroups of 64)
constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // weight rows per K step
constexpr int NS = 3;    // ring stages (a stage is freed one step after its use)
constexpr int CT = 512;  // consumer threads: one 16-word unit each per step
constexpr int NT = CT + 32;           // + one producer warp
constexpr int X_BYTES = BM * BK * 2;  // bf16 x tile, 128-byte swizzle
constexpr int W_BYTES = BK * BN * 4;  // ciphertext slab: 4 quarters of 32
                                      // columns, 128-byte swizzle
constexpr int B_BYTES = BK * BN * 2;  // bf16 B tile: two 64-column halves
constexpr int OFF_X = 0;
constexpr int OFF_W = OFF_X + NS * X_BYTES;
constexpr int OFF_B = OFF_W + NS * W_BYTES;
constexpr int OFF_BAR = OFF_B + 2 * B_BYTES;
constexpr int OFF_ROWS = OFF_BAR + 8 * 2 * NS;  // per stage: the slab's
                                                // 64-row SE mask, 2 words
constexpr int OFF_KEY = OFF_ROWS + 8 * NS;  // key (8), nonce (3), pad base
constexpr int SMEM_BYTES = OFF_KEY + 4 * 12 + 1024;  // + alignment
static_assert(CT == BK * BN / 16, "one unit per consumer thread");

struct Args {
  const uint8_t* mask;
  const uint32_t* key;
  const uint32_t* nonce;
  const uint32_t* wc;
  float* out;
  int M, K, N, bk, bn;
};

// position of the n-th (from 0) set bit of m; the bit must exist
__device__ __forceinline__ int nth_bit(uint32_t m, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const uint32_t low = m & ((1u << w) - 1u);
    const int c = __popc(low);
    if (n >= c) {
      n -= c;
      m >>= w;
      pos += w;
    } else {
      m = low;
    }
  }
  return pos;
}

__device__ __forceinline__ int nth_bit64(uint32_t lo, uint32_t hi, int n) {
  const int c = __popc(lo);
  return n < c ? nth_bit(lo, n) : 32 + nth_bit(hi, n - c);
}

__global__ void __launch_bounds__(NT, 1)
sealed_matmul_tc_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + OFF_BAR);
  uint64_t* empty = full + NS;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (a.K + BK - 1) / BK;

  // the key and nonce stay in shared memory: the ChaCha rounds read them at
  // the start and the end of a block, and registers are scarce beside the
  // accumulators
  uint32_t* kn = reinterpret_cast<uint32_t*>(sm + OFF_KEY);
  uint32_t* rows = reinterpret_cast<uint32_t*>(sm + OFF_ROWS);
  if (tid < 8) {
    kn[tid] = __ldg(a.key + tid);
  } else if (tid < 11) {
    kn[tid] = __ldg(a.nonce + tid - 8);
  } else if (tid == 11) {  // the first ChaCha counter of this write counter
    const uint32_t uniq = static_cast<uint32_t>(
        static_cast<uint64_t>(a.K) * static_cast<uint64_t>(a.N) / 16);
    kn[11] = __ldg(a.wc) * uniq;  // wraps mod 2^32 like u32
  }
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], CT / 32);  // lane 0 of each consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CT / 32) {  // producer
    for (int it = 0; it < nk; ++it) {
      const int st = it % NS;
      hop::mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);
      // the slab's encrypted rows (rows past K count as plaintext and are
      // zeroed), read here so that the consumers never wait on the mask
      const int k0 = it * BK, ka = k0 + lane, kb = k0 + 32 + lane;
      const unsigned lo = __ballot_sync(0xffffffffu,
                                        ka < a.K && a.mask[ka] != 0);
      const unsigned hi = __ballot_sync(0xffffffffu,
                                        kb < a.K && a.mask[kb] != 0);
      if (lane == 0) {
        rows[2 * st] = lo;
        rows[2 * st + 1] = hi;
        // arriving releases the words above to the consumers that wait
        hop::mbar_expect_tx(&full[st], X_BYTES + W_BYTES);
        hop::tma_load_2d(sm + OFF_X + st * X_BYTES, &tx, &full[st], k0, m0);
        for (int qt = 0; qt < 4; ++qt)
          hop::tma_load_2d(sm + OFF_W + st * W_BYTES + qt * (W_BYTES / 4),
                           &tw, &full[st], n0 + 32 * qt, k0);
      }
    }
    return;
  }

  // consumers: warpgroup wg takes rows m0 + 64 wg .. + 63
  const int wg = warp / 4, wl = warp % 4;
  // the seal's tiles are powers of two (sealed_store._pick_block)
  const int lbk = __ffs(a.bk) - 1, lbn = __ffs(a.bn) - 1;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t x_base = hop::smem_u32(sm + OFF_X) + wg * 64 * 128;

  for (int it = 0; it < nk; ++it) {
    const int st = it % NS;
    const int k0 = it * BK;
    hop::mbar_wait(&full[st], (it / NS) & 1);

    const uint32_t enc_lo = rows[2 * st], enc_hi = rows[2 * st + 1];
    const int nenc = __popc(enc_lo) + __popc(enc_hi);
    const uint8_t* ws = sm + OFF_W + st * W_BYTES;
    uint8_t* bt = sm + OFF_B + (it & 1) * B_BYTES;

    // unit `tid` of the slab's 512 units of 16 words, encrypted rows' units
    // ranked first
    {
      const int rs = tid >> 3, cg = tid & 7;
      const bool enc = rs < nenc;
      const int r = enc ? nth_bit64(enc_lo, enc_hi, rs)
                        : nth_bit64(~enc_lo, ~enc_hi, rs - nenc);
      const int gk = k0 + r;
      uint32_t ks[16];
      if (enc) {
        const int gn = n0 + cg * 16;
        const uint32_t t =
            static_cast<uint32_t>(gk >> lbk) * static_cast<uint32_t>(a.N >> lbn) +
            static_cast<uint32_t>(gn >> lbn);
        const uint32_t wid = (t << (lbk + lbn)) +
                             static_cast<uint32_t>(((gk & (a.bk - 1)) << lbn) +
                                                   (gn & (a.bn - 1)));
        seal::chacha20_block(kn, kn[11] + wid / 16, kn[8], kn[9], kn[10], ks);
      }
      // Half h of the unit (words 8h .. 8h+7) is two 16-byte chunks of the
      // slab's quarter cg / 2 (TMA wrote chunk c of row r at c ^ (r % 8),
      // so the 8 units of a row spread over the banks) and becomes one
      // 16-byte chunk of the B tile: MN-major, 128-byte swizzle, row r of
      // the 64-column half cg / 4, chunk 2 (cg % 4) + h.
      const uint8_t* wrow = ws + (cg >> 1) * (W_BYTES / 4) + r * 128;
      uint8_t* brow = bt + (cg >> 2) * (B_BYTES / 2) + r * 128;
      const int sw = r & 7, cw = 4 * (cg & 1), cb = 2 * (cg & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 lo =
            *reinterpret_cast<const uint4*>(wrow + (((cw + 2 * h) ^ sw) << 4));
        const uint4 hi = *reinterpret_cast<const uint4*>(
            wrow + (((cw + 2 * h + 1) ^ sw) << 4));
        uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (enc) {
#pragma unroll
          for (int j = 0; j < 8; ++j) w[j] ^= ks[8 * h + j];
        }
        uint4 out = make_uint4(0u, 0u, 0u, 0u);  // past K: zero
        if (gk < a.K)
          out = make_uint4(
              hop::pack_bf16(__uint_as_float(w[0]), __uint_as_float(w[1])),
              hop::pack_bf16(__uint_as_float(w[2]), __uint_as_float(w[3])),
              hop::pack_bf16(__uint_as_float(w[4]), __uint_as_float(w[5])),
              hop::pack_bf16(__uint_as_float(w[6]), __uint_as_float(w[7])));
        *reinterpret_cast<uint4*>(brow + (((cb + h) ^ sw) << 4)) = out;
      }
    }
    hop::fence_proxy_async();  // the B tile is read by wgmma next
    hop::bar_sync(1, CT);

    const uint32_t xa = x_base + st * X_BYTES;
    const uint32_t ba = hop::smem_u32(bt);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hop::wgmma_n128_ss_mn(acc, hop::desc_sw128(xa + kk * 32, 16, 1024),
                            hop::desc_sw128(ba + kk * 2048, B_BYTES / 2, 1024),
                            1);
    hop::wgmma_commit();
    hop::wgmma_wait<1>();  // the previous step's products are done
    if (it > 0 && lane == 0) hop::mbar_arrive(&empty[(it - 1) % NS]);
    // nobody overwrites the other B buffer before every warpgroup is done
    // reading it
    hop::bar_sync(1, CT);
  }
  hop::wgmma_wait<0>();
  hop::reg_fence(acc);

  const int row_a = m0 + 64 * wg + 16 * wl + lane / 4, row_b = row_a + 8;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int col = n0 + 8 * c + 2 * (lane % 4);
    if (row_a < a.M)
      *reinterpret_cast<float2*>(a.out + static_cast<size_t>(row_a) * a.N +
                                 col) = make_float2(acc[4 * c], acc[4 * c + 1]);
    if (row_b < a.M)
      *reinterpret_cast<float2*>(a.out + static_cast<size_t>(row_b) * a.N +
                                 col) =
          make_float2(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

}  // namespace

// x (M, K) bf16; w (K, N) u32 tile-sealed; row_mask (K,) u8; key (8,) u32;
// nonce (3,) u32; wc (1,) u32; out (M, N) f32 -- all device pointers, x and
// w 16-byte aligned. N % 128 == 0, K % 8 == 0, K and N multiples of the
// seal's (bk, bn), which are powers of two with bk >= 8 and bn >= 16. Returns 0, a cudaError_t, or one of the
// tensor-map codes of hopper.cuh.
extern "C" int sealed_matmul_tc(const void* x, const void* w,
                                const void* row_mask, const void* key,
                                const void* nonce, const void* wc, void* out,
                                int M, int K, int N, int bk, int bn,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (N % BN || K % 8 || bk < 8 || bn < 16 || (bk & (bk - 1)) ||
      (bn & (bn - 1)) || K % bk || N % bn)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(K),
                            static_cast<cuuint64_t>(M)};
  const cuuint64_t xs[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xb[2] = {BK, BM};
  int rc = hop::encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs,
                           xb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const cuuint64_t wd[2] = {static_cast<cuuint64_t>(N),
                            static_cast<cuuint64_t>(K)};
  const cuuint64_t wst[1] = {static_cast<cuuint64_t>(N) * 4};
  const cuuint32_t wb[2] = {BN / 4, BK};
  rc = hop::encode_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, w, wd, wst, wb,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        sealed_matmul_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  Args a{static_cast<const uint8_t*>(row_mask),
         static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(nonce),
         static_cast<const uint32_t*>(wc), static_cast<float*>(out), M, K, N,
         bk, bn};
  dim3 grid((M + BM - 1) / BM, N / BN);
  sealed_matmul_tc_kernel<<<grid, NT, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(mx, mw, a);
  return static_cast<int>(cudaGetLastError());
}
