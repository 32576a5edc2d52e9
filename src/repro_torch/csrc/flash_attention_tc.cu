// Causal flash attention (forward) on Hopper's tensor cores, bf16 (sm_90a).
//
// Replaces, for bf16 q/k/v with head dim 64 or 128, the Pallas kernel
// src/repro/kernels/flash_attention.py::flash_attention (body _kernel); every
// other case runs flash_attention.cu (the f32 contract). The contract is
// flash_attention.cu's, with one change:
//   * scores = f32(q . k) * scale, the product of bf16 q and k summed in f32
//     by the tensor cores, the scale applied to the f32 score (q is not
//     re-rounded); softcap * tanh(scores / softcap) when softcap > 0;
//   * key j live for query i iff j <= i (and i - j < window when window > 0);
//     dead scores -1e30, keys at or past t -inf; the running max starts at
//     -inf, and kv tiles are visited from the window's first live tile of the
//     block up to the tile of its last row's diagonal, as flash_attention.cu;
//   * THE CHANGE: the probabilities are rounded to bf16 before P . V (the
//     row sums stay f32). That is what the reference's serving attention
//     does (src/repro/models/layers.py::_sdpa casts the normalised
//     probabilities to q's dtype before the value einsum), and what every
//     tensor-core flash kernel does. Its error is at most 2^-9 of sum p|v|/l
//     per output element; kernels/flash_attention.py::bf16_gate holds the
//     kernel to twice that, plus one bf16 rounding of the output;
//   * out = acc / max(l, 1e-30) in bf16.
//
// What bounds it on this card: at the group prefill's shape (b 4, s 890,
// 16/8 heads of 128) 13 GFLOP of causal work, 0.013 ms on the bf16 tensor
// cores against 0.005 ms for the q, k, v and out bytes; at one 8192-token
// sequence 275 GFLOP, 0.28 ms. So the arithmetic bounds it, and it has to
// run on the tensor cores. The design:
//   * one block per (batch x q head, 128-row q tile), q tiles heaviest
//     (latest) first; two consumer warpgroups of 64 q rows each and one
//     producer warp (288 threads, one block per SM);
//   * the producer issues TMA loads: the q tile once, then the K and V tiles
//     of 128 keys into a ring of 2 stages, each stage guarded by a "full"
//     mbarrier (transaction bytes) and an "empty" one (one arrival per
//     consumer warp). TMA reads the model's strided (b, s, h, dh) views
//     through a 4-d tensor map and zero-fills rows past s or t; it writes
//     the tiles in the 128-byte swizzle that wgmma reads (hopper.cuh);
//   * S = Q K^T by wgmma m64n128k16 from shared memory (both K-major), f32
//     accumulators in registers; the online softmax runs on the accumulator
//     fragment (each thread owns 2 rows x 32 keys; row max over the 4 lanes
//     of a quad by shuffles), in the log2 domain (one exp2f per score);
//     masks are computed only on tiles that cross the diagonal, the window's
//     edge or t;
//   * O += P V by wgmma m64n{dh}k16 with P from registers as bf16 (the
//     accumulator fragment of S is the A fragment of P V) and V from shared
//     memory (MN-major); O stays in registers for the whole kv loop; the
//     two warpgroups run out of step, so one's softmax overlaps the other's
//     products;
//   * GQA: q head h reads kv head h / (hq / hkv) in place.
// Not yet: softmax overlapped with wgmma inside a warpgroup (a second set of
// score registers does not fit beside O at 128 keys), setmaxnreg, sharing a
// K/V ring among the q heads of one kv head, head dim 256.
#include "hopper.cuh"

namespace {

constexpr int BQ = 128;   // q rows per block: two consumer warpgroups
constexpr int BKV = 128;  // keys per kv tile
constexpr int NS = 2;     // K/V ring stages
constexpr int NT = 288;   // 8 consumer warps + 1 producer warp
constexpr int QT = 64 * 128;    // bytes of 64 q rows x 64 head-dim columns
constexpr int KVT = BKV * 128;  // bytes of BKV keys x 64 head-dim columns
constexpr float DEAD = -1e30f;

template <int DH>
struct Layout {  // shared-memory byte offsets, from a 1024-aligned base
  static constexpr int SUB = DH / 64;  // 64-column sub-tiles of a row block
  static constexpr int Q = 0;          // [warpgroup][sub]
  static constexpr int K = Q + 2 * SUB * QT;    // [stage][sub]
  static constexpr int V = K + NS * SUB * KVT;  // [stage][sub]
  static constexpr int BAR = V + NS * SUB * KVT;
  static constexpr int BYTES = BAR + 8 * (2 * NS + 1) + 1024;  // + alignment
};

struct Args {
  void* o;
  int B, S, T, HQ, HKV;
  long long o_sb, o_ss, o_sh;  // element strides of the output
  float scale, softcap;
  int window;
};

template <int DH>
__global__ void __launch_bounds__(NT, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Args a) {
  using L = Layout<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ntile = (a.S + BQ - 1) / BQ;
  const int bhn = a.B * a.HQ;
  const int tile = ntile - 1 - static_cast<int>(blockIdx.x) / bhn;
  const int bh = static_cast<int>(blockIdx.x) % bhn;
  const int b = bh / a.HQ, h = bh % a.HQ;
  const int hk = h / (a.HQ / a.HKV);
  const int q0 = tile * BQ;
  // live kv tiles of the block, in the reference's order
  const int last_row = min(q0 + BQ, a.S) - 1;
  const int j_end = min(last_row / BKV + 1, (a.T + BKV - 1) / BKV);
  const int j_beg = a.window > 0 ? max(q0 - a.window + 1, 0) / BKV : 0;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hop::mbar_init(qbar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      hop::mbar_expect_tx(qbar, 2 * L::SUB * QT);
      for (int wg = 0; wg < 2; ++wg)
        for (int sub = 0; sub < L::SUB; ++sub)
          hop::tma_load_4d(sm + L::Q + (wg * L::SUB + sub) * QT, &tq, qbar,
                           64 * sub, h, q0 + 64 * wg, b);
      for (int j = j_beg, it = 0; j < j_end; ++j, ++it) {
        const int st = it % NS;
        hop::mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);
        hop::mbar_expect_tx(&full[st], 2 * L::SUB * KVT);
        for (int sub = 0; sub < L::SUB; ++sub) {
          hop::tma_load_4d(sm + L::K + (st * L::SUB + sub) * KVT, &tk,
                           &full[st], 64 * sub, hk, j * BKV, b);
          hop::tma_load_4d(sm + L::V + (st * L::SUB + sub) * KVT, &tv,
                           &full[st], 64 * sub, hk, j * BKV, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes q rows q0 + 64 wg .. + 63; each thread
  // owns rows r_a and r_b = r_a + 8 of the accumulator fragments
  const int wg = warp / 4, wl = warp % 4;
  const int row0 = q0 + 64 * wg;
  const int r_a = row0 + 16 * wl + lane / 4, r_b = r_a + 8;
  const int cq = 2 * (lane % 4);
  const uint32_t q_base = hop::smem_u32(sm + L::Q + wg * L::SUB * QT);
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
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  hop::mbar_wait(qbar, 0);
  for (int j = j_beg, it = 0; j < j_end; ++j, ++it) {
    const int st = it % NS;
    hop::mbar_wait(&full[st], (it / NS) & 1);
    const uint32_t k_base = hop::smem_u32(sm + L::K + st * L::SUB * KVT);
    const uint32_t v_base = hop::smem_u32(sm + L::V + st * L::SUB * KVT);

    hop::reg_fence(s);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hop::wgmma_n128_ss_kk(
          s, hop::desc_sw128(q_base + (kk / 4) * QT + (kk % 4) * 32, 16, 1024),
          hop::desc_sw128(k_base + (kk / 4) * KVT + (kk % 4) * 32, 16, 1024),
          kk > 0);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::reg_fence(s);

    // scale, softcap and (on edge tiles) masks, in the log2 domain
    const int k0 = j * BKV;
    const bool edge = k0 + BKV - 1 > row0 ||
                      (a.window > 0 && row0 + 63 - k0 >= a.window) ||
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
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);  // finite
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t pa[BKV / 16][4];  // P as bf16 A fragments, one per 16 keys
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
    l_a = l_a * al_a + sum_a;  // this thread's share; the quad sums at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      o[4 * c + 0] *= al_a;
      o[4 * c + 1] *= al_a;
      o[4 * c + 2] *= al_b;
      o[4 * c + 3] *= al_b;
    }

    hop::reg_fence(o);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t db = hop::desc_sw128(v_base + kk * 2048, KVT, 1024);
      if constexpr (DH == 128)
        hop::wgmma_n128_rs_mn(o, pa[kk], db, 1);
      else
        hop::wgmma_n64_rs_mn(o, pa[kk], db, 1);
    }
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
                      h * a.o_sh;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = 8 * c + cq;
    if (r_a < a.S)
      *reinterpret_cast<__nv_bfloat162*>(op + r_a * a.o_ss + col) =
          __floats2bfloat162_rn(o[4 * c] / den_a, o[4 * c + 1] / den_a);
    if (r_b < a.S)
      *reinterpret_cast<__nv_bfloat162*>(op + r_b * a.o_ss + col) =
          __floats2bfloat162_rn(o[4 * c + 2] / den_b, o[4 * c + 3] / den_b);
  }
}

// (dh, heads, seq, batch) view of a (b, seq, heads, dh) bf16 tensor with the
// given element strides; boxes of 64 head-dim columns x `rows` rows of one
// head
int encode_view(CUtensorMap* m, const void* base, int dh, int heads, int seq,
                int batch, long long sb, long long ss, long long sh,
                int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return hop::encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DH>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           const Args& a, cudaStream_t st) {
  const int bytes = Layout<DH>::BYTES;
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long blocks =
      static_cast<long long>((a.S + BQ - 1) / BQ) * a.B * a.HQ;
  flash_attention_tc_kernel<DH><<<static_cast<unsigned>(blocks), NT, bytes,
                                   st>>>(mq, mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, HQ, dh), k and v (B, T, HKV, dh), o (B, S, HQ, dh): bf16 device
// pointers with the given element strides of batch, sequence and head (the
// head dim contiguous; bases and strides 16-byte aligned, as TMA needs).
// dh 64 or 128, HQ % HKV == 0. Returns 0, a cudaError_t, or one of the
// tensor-map codes of hopper.cuh.
extern "C" int flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, int B, int S, int T,
    int HQ, int HKV, int dh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, float softcap, int window, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0) return 0;
  if ((dh != 64 && dh != 128) || HKV <= 0 || HQ % HKV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int rc = encode_view(&mq, q, dh, HQ, S, B, q_sb, q_ss, q_sh, 64);
  if (rc == 0) rc = encode_view(&mk, k, dh, HKV, T, B, k_sb, k_ss, k_sh, BKV);
  if (rc == 0) rc = encode_view(&mv, v, dh, HKV, T, B, v_sb, v_ss, v_sh, BKV);
  if (rc != 0) return rc;
  Args a{o, B, S, T, HQ, HKV, o_sb, o_ss, o_sh, scale, softcap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dh == 128 ? launch<128>(mq, mk, mv, a, st)
                   : launch<64>(mq, mk, mv, a, st);
}
