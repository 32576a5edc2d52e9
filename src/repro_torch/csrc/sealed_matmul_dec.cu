// Fused decrypt-in-matmul at decode sizes on Hopper's tensor cores: bf16,
// 1 <= M <= 64 (sm_90a).
//
// Replaces, for compute dtype bf16, M <= 64, N % 64 == 0 and seal tiles that
// are powers of two with bn >= 16, the Pallas kernel
// src/repro/kernels/sealed_matmul.py:94 (sealed_matmul, _make_kernel):
// y = bf16(x) @ bf16(f32(w_ct XOR pad)), the pad XORed only on rows whose SE
// row_mask is set, products summed in f32. M > 64 runs sealed_matmul_tc.cu;
// f32 compute, bn == 8 and other shapes run sealed_matmul.cu. The keystream
// contract is sealed_matmul.cu's: the word at (i, j) of a (K, N) leaf sealed
// with tiles (bk, bn) lies in tile t = (i/bk)*(N/bn) + j/bn, at word
// w = t*bk*bn + (i%bk)*bn + j%bn, and takes lane w%16 of ChaCha block
// wc*(K*N/16) + w/16 (mod 2^32); with bn >= 16 a 16-word unit is 16
// consecutive words of one row and one ChaCha block pads it. The write
// counter wc is read on the device.
//
// No plaintext weight reaches device memory: each ciphertext slab is
// decrypted into a bf16 tile in shared memory and consumed there by wgmma.
//
// What bounds it on this card. At decode every weight word is read once
// (4 bytes) and, if its row is encrypted, needs 1/16 of a ChaCha block; the
// products are a rounding error on the tensor cores. A ChaCha block is 976
// 32-bit operations, of which the 320 XORs and 320 rotations (LOP3, SHF)
// issue only on the ALU pipe, 64 lanes a clock per SM, while the adds go to
// the FMA pipe as IMAD.IADD: so the pads are bound by 640 ALU operations
// per block (plus 16 XORs of the data) at 16.7e12 a second. On MLP wi
// (2048 x 8192) at M = 4 and SE 0.5 that is 0.0201 ms of reads at
// 3.35 TB/s against 0.0201 ms of pads: the ciphertext must stream at full
// rate while the pads are made. The design:
//   * one block per (64-column strip, K range): one producer warp streams
//     each 64-row slab of ciphertext (64 x 64 u32, two 32-column boxes) and
//     the slab's bf16 x tile (NW rows of M, NW = M rounded up to 8, 16, 32
//     or 64) by TMA, both in the 128-byte swizzle, into a ring of 4-8
//     stages (17-24 KB each) guarded by mbarriers; with two blocks on an SM
//     (one at NW = 64) 128-192 KB is in flight per SM. The producer also
//     ranks the slab's rows, encrypted ones first (a ballot of the SE mask);
//   * two consumer warpgroups take alternate slabs. In a slab each thread
//     takes two of its 256 units of 16 words, by rank, so pads are made only
//     for encrypted rows and fill whole warps; which warps get a slab's
//     extra pads turns from slab to slab. A unit is XORed in registers and
//     rounded to bf16 (round to nearest even, the reference's cast); once
//     the warpgroup has read the slab, the bf16 tile is written over it in
//     the swizzled MN-major layout the wgmma descriptor names (no bank
//     conflicts, no second buffer);
//   * products with swapped operands on the tensor cores,
//     out^T (64 x NW) += W^T (64 x 16) . x^T (16 x NW), wgmma m64nNWk16 with
//     A the decrypted tile and B the x tile, both in the stage: M = 32
//     costs no FMA issue slots beside the pads. The stage is freed as soon
//     as the slab's products are done; at the end warpgroup 1 hands its sums
//     to warpgroup 0, which adds them in a fixed order;
//   * split K across blocks so that every main-path leaf gives one to two
//     blocks per SM slot (the wrapper picks the split, ``dec_geometry``),
//     reduced inside the launch: each block writes its partial sums to a
//     workspace as its threads hold them, and the last block of a strip to
//     arrive (an integer counter per strip, which that block resets) adds
//     the partials in split order. Deterministic, no float atomics, no second
//     kernel.
#include "chacha20.cuh"
#include "hopper.cuh"

namespace {

constexpr int BN = 64;   // output columns per block: the wgmma's 64 rows
constexpr int BK = 64;   // weight rows per slab
constexpr int WGS = 2;   // consumer warpgroups, taking alternate slabs
constexpr int CT = 128;  // threads of a consumer warpgroup
constexpr int NT = WGS * CT + 32;        // + one producer warp
constexpr int W_BYTES = BK * BN * 4;     // ciphertext slab: two 32-column
                                         // boxes, 128-byte swizzle
constexpr int A_BYTES = BK * BN * 2;     // bf16 A tile, MN-major, swizzled,
                                         // written over the slab's first box
constexpr int UNITS = BK * BN / 16;      // 16-word units per slab
static_assert(UNITS == 2 * CT, "two units per consumer thread");

template <int NW>
struct Geo {
  // blocks per SM: two, but one at NW = 64, whose accumulators need more
  // registers than two blocks of 288 threads leave
  static constexpr int BLOCKS = NW <= 32 ? 2 : 1;
  static constexpr int X_BYTES = NW * BK * 2;  // bf16 x tile, K-major
  static constexpr int STAGE = W_BYTES + X_BYTES;
  // ring stages: as many as the blocks of an SM leave room for, and even,
  // so that each stage serves one warpgroup (warpgroup g takes the slabs
  // it = g mod 2, in stage it mod NS). With an odd count a warpgroup could
  // wait on a stage two phases ahead of its barrier while the other
  // warpgroup's load is still in flight, and the parity would pass.
  static constexpr int NS = NW <= 16 ? 6 : NW == 32 ? 4 : 8;
  static_assert(NS % 2 == 0, "each stage serves one warpgroup");
  static constexpr int OFF_BAR = NS * STAGE;
  // per stage: the slab's rows, encrypted ones first (64 bytes), and how
  // many are encrypted
  static constexpr int OFF_ROWS = OFF_BAR + 8 * 2 * NS;
  static constexpr int OFF_NENC = OFF_ROWS + BK * NS;
  static constexpr int OFF_KEY = OFF_NENC + 4 * NS;  // key (8), nonce (3),
                                                     // first pad counter
  static constexpr int OFF_FLAG = OFF_KEY + 4 * 12;
  static constexpr int SMEM = OFF_FLAG + 16 + 1024;  // + alignment
  static_assert(STAGE % 1024 == 0, "swizzle atoms start on 1 KB");
  static_assert(BLOCKS * (SMEM + 1024) <= 228 * 1024, "shared memory");
  static_assert(CT * NW / 2 * 4 <= STAGE, "the second warpgroup's sums");
};

struct Args {
  const uint8_t* mask;
  const uint32_t* key;
  const uint32_t* nonce;
  const uint32_t* wc;
  float* out;       // (M, N)
  float* part;      // (splits, N / 64, 128, NW / 2) partial sums, as the
                    // threads of warpgroup 0 hold them, when splits > 1
  int* counters;    // one per strip, 0 between launches
  int M, K, N, bk, bn, kps;
};

template <int NW>
__global__ void __launch_bounds__(NT, Geo<NW>::BLOCKS)
sealed_matmul_dec_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         const Args a) {
  using G = Geo<NW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G::OFF_BAR);
  uint64_t* empty = full + G::NS;
  uint8_t* rows = sm + G::OFF_ROWS;
  int* nencs = reinterpret_cast<int*>(sm + G::OFF_NENC);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.y * a.kps;
  const int kend = min(a.K, kbeg + a.kps);
  const int nk = (kend - kbeg + BK - 1) / BK;

  // the key and nonce stay in shared memory: the ChaCha rounds read them at
  // the start and the end of a block, and registers are scarce beside the
  // accumulators (a spill between a wgmma and its wait would read the
  // accumulators before the tensor cores have written them)
  uint32_t* kn = reinterpret_cast<uint32_t*>(sm + G::OFF_KEY);
  if (tid < 8) {
    kn[tid] = __ldg(a.key + tid);
  } else if (tid < 11) {
    kn[tid] = __ldg(a.nonce + tid - 8);
  } else if (tid == 11) {  // the first ChaCha counter of this write counter
    kn[11] = __ldg(a.wc) * static_cast<uint32_t>(
        static_cast<uint64_t>(a.K) * static_cast<uint64_t>(a.N) / 16);
  } else if (tid == 32) {
    for (int s = 0; s < G::NS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], CT / 32);  // the warps of one warpgroup
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp == WGS * CT / 32) {  // producer
    for (int it = 0; it < nk; ++it) {
      const int st = it % G::NS;
      hop::mbar_wait(&empty[st], ((it / G::NS) & 1) ^ 1);
      // the slab's encrypted rows (rows past K count as plaintext: TMA
      // reads them as zero)
      const int k0 = kbeg + it * BK, ka = k0 + lane, kb = ka + 32;
      const unsigned lo = __ballot_sync(0xffffffffu,
                                        ka < kend && a.mask[ka] != 0);
      const unsigned hi = __ballot_sync(0xffffffffu,
                                        kb < kend && a.mask[kb] != 0);
      // rank the slab's rows, encrypted first: lane l places rows l and
      // l + 32
      const int nlo = __popc(lo), nenc = nlo + __popc(hi);
      const unsigned below = (1u << lane) - 1u;
      const int ea = __popc(lo & below), eb = nlo + __popc(hi & below);
      uint8_t* order = rows + st * BK;
      order[(lo >> lane) & 1u ? ea : nenc + lane - ea] =
          static_cast<uint8_t>(lane);
      order[(hi >> lane) & 1u ? eb : nenc + lane + 32 - eb] =
          static_cast<uint8_t>(lane + 32);
      __syncwarp();
      if (lane == 0) {
        nencs[st] = nenc;
        uint8_t* stage = sm + st * G::STAGE;
        // arriving releases the words above to the consumers that wait
        hop::mbar_expect_tx(&full[st], G::STAGE);
        hop::tma_load_2d(stage, &tw, &full[st], n0, k0);
        hop::tma_load_2d(stage + W_BYTES / 2, &tw, &full[st], n0 + 32, k0);
        hop::tma_load_2d(stage + W_BYTES, &tx, &full[st], k0, 0);
      }
    }
    return;
  }

  // consumers: warpgroup wg takes slabs wg, wg + 2, ...
  const int wg = warp / 4, t = tid % CT, wl = warp % 4;
  // the seal's tiles are powers of two (sealed_store._pick_block)
  const int lbk = __ffs(a.bk) - 1, lbn = __ffs(a.bn) - 1;
  const uint32_t tiles_n = static_cast<uint32_t>(a.N >> lbn);

  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;

  for (int it = wg; it < nk; it += WGS) {
    const int st = it % G::NS;
    const int k0 = kbeg + it * BK;
    hop::mbar_wait(&full[st], (it / G::NS) & 1);
    const int nenc = nencs[st];
    const uint8_t* order = rows + st * BK;
    uint8_t* stage = sm + st * G::STAGE;

    // this thread's two units of the slab (unit `rank`, encrypted rows'
    // units first; four 16-column units per row), XORed and rounded to bf16
    // in registers: packed[j] holds unit j's 16 values. A slab with more
    // than 128 encrypted units gives some warps a second pad; which warps
    // turns with the slab and the strip, so that no SM sub-partition takes
    // the extra pads of every slab while the others wait at the barrier.
    const int vt = (((wl + it + blockIdx.x) & 3) << 5) | lane;
    uint4 packed[2][2];
    int row_of[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int rank = vt + CT * j;
      const int rs = rank >> 2, cg = rank & 3;
      const bool enc = rs < nenc;
      const int r = order[rs];
      row_of[j] = r;
      uint32_t ks[16];
      if (enc) {
        const int gk = k0 + r, gn = n0 + cg * 16;
        const uint32_t tt =
            static_cast<uint32_t>(gk >> lbk) * tiles_n +
            static_cast<uint32_t>(gn >> lbn);
        const uint32_t wid = (tt << (lbk + lbn)) +
                             static_cast<uint32_t>(((gk & (a.bk - 1)) << lbn) +
                                                   (gn & (a.bn - 1)));
        seal::chacha20_block(kn, kn[11] + wid / 16, kn[8], kn[9], kn[10], ks);
      }
      // half h of the unit (words 8h .. 8h+7) is two 16-byte chunks of the
      // slab's box cg / 2 (TMA wrote chunk c of row r at c ^ (r % 8))
      const uint8_t* wrow = stage + (cg >> 1) * (W_BYTES / 2) + r * 128;
      const int sw = r & 7, cw = 4 * (cg & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 lo =
            *reinterpret_cast<const uint4*>(wrow + (((cw + 2 * h) ^ sw) << 4));
        const uint4 hi = *reinterpret_cast<const uint4*>(
            wrow + (((cw + 2 * h + 1) ^ sw) << 4));
        uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (enc) {
#pragma unroll
          for (int q = 0; q < 8; ++q) w[q] ^= ks[8 * h + q];
        }
        packed[j][h] = make_uint4(
            hop::pack_bf16(__uint_as_float(w[0]), __uint_as_float(w[1])),
            hop::pack_bf16(__uint_as_float(w[2]), __uint_as_float(w[3])),
            hop::pack_bf16(__uint_as_float(w[4]), __uint_as_float(w[5])),
            hop::pack_bf16(__uint_as_float(w[6]), __uint_as_float(w[7])));
      }
    }
    // every thread of the warpgroup has read the ciphertext: the bf16 A
    // tile goes over the slab's first box, row r, chunk 2 cg + h at
    // (2 cg + h) ^ (r % 8) (the layout the wgmma descriptor names)
    hop::bar_sync(1 + wg, CT);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cg = lane & 3, r = row_of[j];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint4*>(stage + r * 128 +
                                  (((2 * cg + h) ^ (r & 7)) << 4)) =
            packed[j][h];
    }
    hop::fence_proxy_async();  // the A tile is read by wgmma next
    hop::bar_sync(1 + wg, CT);

    const uint32_t aa = hop::smem_u32(stage);
    const uint32_t xa = hop::smem_u32(stage + W_BYTES);
    hop::reg_fence(acc);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hop::wgmma_ss_tk<NW>(acc, hop::desc_sw128(aa + kk * 2048, A_BYTES, 1024),
                           hop::desc_sw128(xa + kk * 32, 16, 1024), 1);
    hop::wgmma_commit();
    // a few k16 products: waiting for them frees the stage at once
    hop::wgmma_wait<0>();
    hop::reg_fence(acc);
    if (lane == 0) hop::mbar_arrive(&empty[st]);
  }

  // warpgroup 1 hands its sums to warpgroup 0 through the ring, idle once
  // both are done with it; warpgroup 0 adds them to its own:
  // acc(slabs 0, 2, ..) + acc(slabs 1, 3, ..), in that order
  float* xchg = reinterpret_cast<float*>(sm) + t * (NW / 2);
  hop::bar_sync(3, WGS * CT);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < NW / 2; i += 4)
      *reinterpret_cast<float4*>(xchg + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  }
  hop::bar_sync(3, WGS * CT);
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < NW / 2; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(xchg + i);
    acc[i] += v.x;
    acc[i + 1] += v.y;
    acc[i + 2] += v.z;
    acc[i + 3] += v.w;
  }

  // acc[4c + e] holds out[m][n0 + n]: n = 16 wl + lane / 4 + 8 (e / 2),
  // m = 8 c + 2 (lane % 4) + e % 2
  const int n_a = n0 + 16 * wl + lane / 4;
  const int splits = gridDim.y;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      const int m = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
      const int n = n_a + 8 * ((i / 2) & 1);
      if (m < a.M) a.out[static_cast<size_t>(m) * a.N + n] = acc[i];
    }
    return;
  }

  // split K: this block's sums go to the workspace as the threads hold
  // them (contiguous, 16-byte stores); the last block of the strip to
  // finish adds every split's, in split order
  const size_t per_split = static_cast<size_t>(gridDim.x) * CT * (NW / 2);
  const size_t mine = static_cast<size_t>(blockIdx.x) * CT * (NW / 2) +
                      static_cast<size_t>(t) * (NW / 2);
  float* own = a.part + blockIdx.y * per_split + mine;
#pragma unroll
  for (int i = 0; i < NW / 2; i += 4)
    *reinterpret_cast<float4*>(own + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  __threadfence();
  hop::bar_sync(1, CT);
  int* last = reinterpret_cast<int*>(sm + G::OFF_FLAG);
  if (t == 0) *last = atomicAdd(a.counters + blockIdx.x, 1) == splits - 1;
  hop::bar_sync(1, CT);
  if (!*last) return;
  __threadfence();
  float sum[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) sum[i] = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = a.part + sp * per_split + mine;
    const bool self = sp == static_cast<int>(blockIdx.y);
#pragma unroll
    for (int i = 0; i < NW / 2; i += 4) {
      const float4 v =
          self ? make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3])
               : __ldcg(reinterpret_cast<const float4*>(p + i));
      sum[i] += v.x;
      sum[i + 1] += v.y;
      sum[i + 2] += v.z;
      sum[i + 3] += v.w;
    }
  }
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int m = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
    const int n = n_a + 8 * ((i / 2) & 1);
    if (m < a.M) a.out[static_cast<size_t>(m) * a.N + n] = sum[i];
  }
  if (t == 0) a.counters[blockIdx.x] = 0;  // ready for the next launch
}

template <int NW>
int launch(const void* x, const void* w, const Args& a, int splits,
           cudaStream_t stream) {
  CUtensorMap mx, mw;
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(a.K),
                            static_cast<cuuint64_t>(a.M)};
  const cuuint64_t xs[1] = {static_cast<cuuint64_t>(a.K) * 2};
  const cuuint32_t xb[2] = {BK, NW};  // rows past M read as zero
  int rc = hop::encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs,
                           xb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const cuuint64_t wd[2] = {static_cast<cuuint64_t>(a.N),
                            static_cast<cuuint64_t>(a.K)};
  const cuuint64_t wst[1] = {static_cast<cuuint64_t>(a.N) * 4};
  const cuuint32_t wb[2] = {BN / 2, BK};
  rc = hop::encode_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, w, wd, wst, wb,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        sealed_matmul_dec_kernel<NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<NW>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(a.N / BN, splits);
  sealed_matmul_dec_kernel<NW><<<grid, NT, Geo<NW>::SMEM, stream>>>(mx, mw,
                                                                      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) bf16; w (K, N) u32 tile-sealed; row_mask (K,) u8; key (8,) u32;
// nonce (3,) u32; wc (1,) u32; part (splits * N * NW) f32 workspace, NW = M
// rounded up to 8, 16, 32 or 64 (unused when splits == 1); counters
// (N / 64,) int32, zero, left zero; out (M, N) f32 -- all device pointers, x and w 16-byte aligned. 1 <= M <= 64; N % 64 == 0;
// K % 8 == 0; K and N multiples of the seal's (bk, bn), powers of two with
// bk >= 8 and bn >= 16; k_per_split a multiple of 64 with
// (splits - 1) * k_per_split < K <= splits * k_per_split. One launch at a
// time per workspace (the wrapper keeps one per device; launches on one
// stream). Returns 0, a cudaError_t, or one of the tensor-map codes of
// hopper.cuh.
extern "C" int sealed_matmul_dec(const void* x, const void* w,
                                 const void* row_mask, const void* key,
                                 const void* nonce, const void* wc, void* part,
                                 void* counters, void* out, int M, int K,
                                 int N, int bk, int bn, int splits,
                                 int k_per_split, void* stream) {
  if (N <= 0 || K <= 0 || M == 0) return 0;
  if (M < 0 || M > 64 || N % BN || K % 8 || bk < 8 || bn < 16 ||
      (bk & (bk - 1)) || (bn & (bn - 1)) || K % bk || N % bn || splits < 1 ||
      k_per_split <= 0 || k_per_split % BK ||
      static_cast<long long>(splits - 1) * k_per_split >= K ||
      static_cast<long long>(splits) * k_per_split < K)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint8_t*>(row_mask),
         static_cast<const uint32_t*>(key),
         static_cast<const uint32_t*>(nonce),
         static_cast<const uint32_t*>(wc),
         static_cast<float*>(out),
         static_cast<float*>(part),
         static_cast<int*>(counters),
         M, K, N, bk, bn, k_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch<8>(x, w, a, splits, st);
  if (M <= 16) return launch<16>(x, w, a, splits, st);
  if (M <= 32) return launch<32>(x, w, a, splits, st);
  return launch<64>(x, w, a, splits, st);
}
