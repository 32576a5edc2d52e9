// Causal flash attention (forward) on Hopper's tensor cores, bf16, head dim
// 256 (sm_90a).
//
// Replaces, for bf16 q/k/v with head dim 256 (gemma2-2b, RecurrentGemma-9B),
// the Pallas kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _kernel). Head dims 64 and 128 run flash_attention_tc.cu, f32 and
// every other head dim flash_attention.cu. The contract is
// flash_attention_tc.cu's:
//   * scores = f32(q . k) * scale, the product of bf16 q and k summed in f32
//     by the tensor cores, the scale applied to the f32 score;
//     softcap * tanh(scores / softcap) when softcap > 0 (the accurate tanhf:
//     an approximate tanh's 2^-11 times softcap 50 would be of the order of
//     the gate's 2^-8);
//   * key j live for query i iff j <= i (and i - j < window when window > 0);
//     dead scores -1e30, keys at or past t -inf; the running max starts at
//     -inf; kv tiles are visited in order, from the window's first live tile
//     of the block up to the tile of its last row's diagonal;
//   * probabilities rounded to bf16 before P . V, row sums in f32;
//   * out = acc / max(l, 1e-30) in bf16.
// kernels/flash_attention.py::bf16_gate holds it to that contract.
//
// What bounds it on this card: at RecurrentGemma's group prefill (b 2,
// s 2,223, 16 q heads on one kv head, window 2048) 80.5 GFLOP of live
// (row, key) pairs, 0.081 ms on the bf16 tensor cores against 0.003 ms of
// bytes; at gemma2's 4 x 198 (8 q heads on 4 kv heads) the bytes, 0.003 ms,
// and in practice the latency of a few tiles. The design:
//   * shared memory: a block holds two q tiles of 64 rows x 256, one a
//     consumer warpgroup (64 KB), and a ring of 2 stages of 64 keys of K
//     and of V (2 x (32 + 32) KB): 192 KB plus the mbarriers, inside the
//     227 KB a block may use, one block an SM. (The 64/128 layout of
//     flash_attention_tc.cu, 128-key tiles, would need 320 KB at 256.) TMA
//     fills every tile as boxes of 64 head-dim columns x 64 rows in the
//     128-byte swizzle that wgmma reads;
//   * threads and registers: two consumer warpgroups of 64 q rows and one
//     producer warpgroup (384 threads); setmaxnreg gives each producer
//     thread 40 registers and each consumer thread 232 (40 x 128 +
//     232 x 256 = 64,512 of 65,536). A consumer thread holds O (64 x 256
//     f32 a warpgroup: 128 registers), S of one tile (32) and P in bf16
//     (16). One thread of the producer issues the loads; K and V of a
//     stage have a "full" mbarrier each, so S = Q K^T starts before V has
//     landed, and one "empty" mbarrier (an arrival per consumer warp) gives
//     the stage back;
//   * wgmma: S = Q K^T by m64n64k16 over 16 steps of the head dim (both
//     operands from shared memory, K-major); O += P V by m64n256k16 over 4
//     steps of 16 keys, P from registers as the A fragment (the accumulator
//     fragment of S is the A fragment of P V), V from shared memory
//     (MN-major); the two warpgroups run out of step, so one's softmax
//     overlaps the other's products;
//   * the grid: when hq / hkv is even (gemma2 2:1, RecurrentGemma 16:1) the
//     two warpgroups of a block take the same 64 rows of two q heads of one
//     kv head, so both need the same kv tiles; when the group is odd, or
//     that grid would leave SMs idle, a block runs one warpgroup on 64 rows
//     of one head. At gemma2's 4 x 198 the pairs make 4 x 4 x 4 = 64
//     blocks, so it runs 4 x 4 x 8 = 128 one-warpgroup blocks on 128 of the
//     132 SMs; at RecurrentGemma's 2 x 2,223, 35 x 2 x 8 = 560 blocks of
//     two warpgroups, 4.2 waves of one block an SM. The caller may force
//     either grid (chip_smoke.py times both at those two shapes). Blocks
//     are ordered latest q tile first (the heaviest).
// Not yet: softmax overlapped with wgmma inside a warpgroup, one block
// walking several tiles (persistent), TMA multicast across a cluster.
#include "hopper.cuh"

namespace {

constexpr int DH = 256;
constexpr int SUB = DH / 64;    // 64-column sub-tiles of a row block
constexpr int BM = 64;          // q rows of a consumer warpgroup
constexpr int BKV = 64;         // keys of a kv tile
constexpr int NS = 2;           // K/V ring stages
constexpr int NT = 384;         // 2 consumer warpgroups + 1 producer one
constexpr int TILE = 64 * 128;  // bytes of 64 rows x 64 head-dim columns
constexpr int Q_OFF = 0;                       // [warpgroup][sub]
constexpr int K_OFF = Q_OFF + 2 * SUB * TILE;  // [stage][sub]
constexpr int V_OFF = K_OFF + NS * SUB * TILE;  // [stage][sub]
constexpr int BAR_OFF = V_OFF + NS * SUB * TILE;
constexpr int SMEM = BAR_OFF + 8 * (3 * NS + 1) + 1024;  // + alignment
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float DEAD = -1e30f;

struct Args {
  void* o;
  int B, S, T, HQ, HKV;
  long long o_sb, o_ss, o_sh;  // element strides of the output
  float scale, softcap;
  int window;
  int nwg;  // consumer warpgroups with rows: 1, or 2 on two q heads
};

__global__ void __launch_bounds__(NT, 1)
flash_attention_tc256_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
  uint64_t* full_v = full_k + NS;
  uint64_t* empty = full_v + NS;
  uint64_t* qbar = empty + NS;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // the block's rows q0 .. q0 + 63 of q heads h0 .. h0 + nwg - 1, one a
  // warpgroup
  const int hunits = a.HQ / a.nwg;
  const int units = a.B * hunits;
  const int ntile = (a.S + BM - 1) / BM;
  const int tile = ntile - 1 - static_cast<int>(blockIdx.x) / units;
  const int u = static_cast<int>(blockIdx.x) % units;
  const int b = u / hunits;
  const int h0 = (u % hunits) * a.nwg;
  const int hk = h0 / (a.HQ / a.HKV);
  const int q0 = tile * BM;
  // the block's kv tiles: from the window's first live tile of its first
  // row to the tile of its last row's diagonal
  const int n_kv = (a.T + BKV - 1) / BKV;
  const int j_end = min((min(q0 + BM, a.S) - 1) / BKV + 1, n_kv);
  const int j_beg = a.window > 0 ? max(q0 - a.window + 1, 0) / BKV : 0;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&full_k[s], 1);
      hop::mbar_init(&full_v[s], 1);
      hop::mbar_init(&empty[s], 4 * a.nwg);  // lane 0 of each consumer warp
    }
    hop::mbar_init(qbar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one thread issues every load
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 256) {
      hop::mbar_expect_tx(qbar, a.nwg * SUB * TILE);
      for (int w = 0; w < a.nwg; ++w)
        for (int sub = 0; sub < SUB; ++sub)
          hop::tma_load_4d(sm + Q_OFF + (w * SUB + sub) * TILE, &tq, qbar,
                           64 * sub, h0 + w, q0, b);
      for (int j = j_beg, it = 0; j < j_end; ++j, ++it) {
        const int st = it % NS;
        hop::mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);
        hop::mbar_expect_tx(&full_k[st], SUB * TILE);
        for (int sub = 0; sub < SUB; ++sub)
          hop::tma_load_4d(sm + K_OFF + (st * SUB + sub) * TILE, &tk,
                           &full_k[st], 64 * sub, hk, j * BKV, b);
        hop::mbar_expect_tx(&full_v[st], SUB * TILE);
        for (int sub = 0; sub < SUB; ++sub)
          hop::tma_load_4d(sm + V_OFF + (st * SUB + sub) * TILE, &tv,
                           &full_v[st], 64 * sub, hk, j * BKV, b);
      }
    }
  } else {  // consumers
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, wl = warp % 4;
    if (wg < a.nwg) {
      const int head = h0 + wg;
      // each thread owns rows r_a and r_b = r_a + 8 of the accumulator
      // fragments, and columns 8c + cq, 8c + cq + 1
      const int r_a = q0 + 16 * wl + lane / 4, r_b = r_a + 8;
      const int cq = 2 * (lane % 4);
      const uint32_t q_base = hop::smem_u32(sm + Q_OFF + wg * SUB * TILE);
      // scores are kept in the log2 domain, x * log2(e), so that each
      // exponential is one exp2f; dead and past-t scores keep their values
      constexpr float LOG2E = 1.4426950408889634f;
      const bool capped = a.softcap > 0.f;
      const float s_scale = capped ? a.scale : a.scale * LOG2E;

      float o[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      // S of one kv tile: s[4c + e] is row (e < 2 ? r_a : r_b), key
      // k0 + 8c + cq + (e & 1)
      float s[BKV / 2];
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

      hop::mbar_wait(qbar, 0);
      for (int j = j_beg, it = 0; j < j_end; ++j, ++it) {
        const int st = it % NS;
        const uint32_t par = (it / NS) & 1;
        hop::mbar_wait(&full_k[st], par);
        const uint32_t k_base = hop::smem_u32(sm + K_OFF + st * SUB * TILE);
        const uint32_t v_base = hop::smem_u32(sm + V_OFF + st * SUB * TILE);

        hop::reg_fence(s);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          hop::wgmma_n64_ss_kk(
              s,
              hop::desc_sw128(q_base + (kk / 4) * TILE + (kk % 4) * 32, 16,
                              1024),
              hop::desc_sw128(k_base + (kk / 4) * TILE + (kk % 4) * 32, 16,
                              1024),
              kk > 0);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::reg_fence(s);

        // scale, softcap and (on edge tiles) masks, in the log2 domain
        const int k0 = j * BKV;
        const bool edge = k0 + BKV - 1 > q0 ||
                          (a.window > 0 && q0 + BM - 1 - k0 >= a.window) ||
                          k0 + BKV > a.T;
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int c = 0; c < BKV / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * c + e] * s_scale;
            if (capped) x = a.softcap * tanhf(x / a.softcap) * LOG2E;
            if (edge) {
              const int row = e < 2 ? r_a : r_b;
              const int key = k0 + 8 * c + cq + (e & 1);
              const bool live =
                  key <= row && (a.window <= 0 || row - key < a.window);
              x = live ? x : DEAD;
              if (key >= a.T) x = -INFINITY;  // past t: no weight at all
            }
            s[4 * c + e] = x;
            if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
          }
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        // finite: a visited tile holds a key below t
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
        uint32_t pa[BKV / 16][4];  // P as bf16 A fragments, 16 keys each
#pragma unroll
        for (int c = 0; c < BKV / 8; ++c) {
          const float p0 = exp2f(s[4 * c + 0] - mn_a);
          const float p1 = exp2f(s[4 * c + 1] - mn_a);
          const float p2 = exp2f(s[4 * c + 2] - mn_b);
          const float p3 = exp2f(s[4 * c + 3] - mn_b);
          sum_a += p0 + p1;
          sum_b += p2 + p3;
          pa[c / 2][2 * (c & 1)] = hop::pack_bf16(p0, p1);
          pa[c / 2][2 * (c & 1) + 1] = hop::pack_bf16(p2, p3);
        }
        l_a = l_a * al_a + sum_a;  // this thread's share; the quad sums last
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int c = 0; c < DH / 8; ++c) {
          o[4 * c + 0] *= al_a;
          o[4 * c + 1] *= al_a;
          o[4 * c + 2] *= al_b;
          o[4 * c + 3] *= al_b;
        }

        hop::mbar_wait(&full_v[st], par);
        hop::reg_fence(o);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          hop::wgmma_n256_rs_mn(
              o, pa[kk], hop::desc_sw128(v_base + kk * 2048, TILE, 1024), 1);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::reg_fence(o);
        if (lane == 0) hop::mbar_arrive(&empty[st]);
      }

      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
      __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb +
                          head * a.o_sh;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        const int col = 8 * c + cq;
        if (r_a < a.S)
          *reinterpret_cast<__nv_bfloat162*>(op + r_a * a.o_ss + col) =
              __floats2bfloat162_rn(o[4 * c] / den_a, o[4 * c + 1] / den_a);
        if (r_b < a.S)
          *reinterpret_cast<__nv_bfloat162*>(op + r_b * a.o_ss + col) =
              __floats2bfloat162_rn(o[4 * c + 2] / den_b,
                                    o[4 * c + 3] / den_b);
      }
    }
  }
}

// (dh, heads, seq, batch) view of a (b, seq, heads, 256) bf16 tensor with
// the given element strides; boxes of 64 head-dim columns x 64 rows of one
// head
int encode_view(CUtensorMap* m, const void* base, int heads, int seq,
                int batch, long long sb, long long ss, long long sh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return hop::encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// q (B, S, HQ, 256), k and v (B, T, HKV, 256), o (B, S, HQ, 256): bf16
// device pointers with the given element strides of batch, sequence and
// head (the head dim contiguous; bases and strides 16-byte aligned, as TMA
// needs). HQ % HKV == 0. The argument list is flash_attention_tc's (dh must
// be 256) and then warpgroups: the consumer warpgroups of a block, 1, or 2
// on two q heads of one kv head (an even HQ / HKV), or 0 to pick by the
// grid's size. Returns 0, a cudaError_t, or one of the tensor-map codes of
// hopper.cuh.
extern "C" int flash_attention_tc256(
    const void* q, const void* k, const void* v, void* o, int B, int S, int T,
    int HQ, int HKV, int dh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, float softcap, int window, int warpgroups,
    void* stream) {
  if (B <= 0 || S <= 0 || T <= 0) return 0;
  const bool even = HKV > 0 && HQ % HKV == 0 && (HQ / HKV) % 2 == 0;
  if (dh != DH || HKV <= 0 || HQ % HKV != 0 || warpgroups < 0 ||
      warpgroups > 2 || (warpgroups == 2 && !even))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int rc = encode_view(&mq, q, HQ, S, B, q_sb, q_ss, q_sh);
  if (rc == 0) rc = encode_view(&mk, k, HKV, T, B, k_sb, k_ss, k_sh);
  if (rc == 0) rc = encode_view(&mv, v, HKV, T, B, v_sb, v_ss, v_sh);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static unsigned long long configured = 0;  // per device: the attribute
  if (dev < 64 && !(configured >> dev & 1ull)) {
    e = cudaFuncSetAttribute(flash_attention_tc256_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << dev;
  }
  // two q heads a block when the group size is even, unless that grid
  // leaves SMs idle
  const long long tiles = (S + BM - 1) / BM;
  const int nwg = warpgroups ? warpgroups
                             : even && tiles * B * (HQ / 2) >= sms ? 2 : 1;
  Args a{o, B, S, T, HQ, HKV, o_sb, o_ss, o_sh, scale, softcap, window, nwg};
  flash_attention_tc256_kernel<<<static_cast<unsigned>(tiles * B * HQ / nwg),
                                 NT, SMEM,
                                 static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}
