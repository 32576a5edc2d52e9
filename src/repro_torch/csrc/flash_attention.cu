// Causal flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _kernel). Contract, as the Pallas kernel's:
//   q (b, s, hq, dh), k and v (b, t, hkv, dh), f32 or bf16, positions
//   arange(s) for q and arange(t) for k (top-left causal);
//   scores = (f32(q) * scale) . f32(k), then softcap * tanh(scores / softcap)
//   when softcap > 0; key j is live for query i iff j <= i (and i - j <
//   window when window > 0); dead scores are set to -1e30; online softmax
//   and p @ v in f32; out = acc / max(l, 1e-30) in q's dtype.
// Unlike the Pallas kernel, s and t are arbitrary: the ragged q tail is never
// written and keys at or past t take no weight at all.
//
// Masking semantics kept from the reference: the running max starts at
// -inf and dead scores are -1e30, so in a tile where a row has only dead
// keys every dead key weighs exp(0) = 1 until the row meets a live key and
// the rescale exp(-1e30 - m) = 0 wipes that weight exactly. The kv loop
// therefore visits tiles in the reference's order, from the window's first
// live tile up to the tile holding the q tile's last diagonal.
//
// What bounds it on this card: at the group prefill's shape (b 4, s 1000,
// 16/8 heads of 128) attention reads and writes about 49 MB (4 us at
// 3.35 TB/s) and does 16.4 GFLOP of causal work (17 us on the bf16 tensor
// cores), so the bound is the arithmetic. This first kernel runs that
// arithmetic as f32 FMAs on the CUDA cores (67 TFLOP/s peak), which also
// keeps f32 inputs exact to the f32 contract. The design:
//   * one block per (batch * q head, 64-row q tile), 128 threads; q tiles
//     are issued heaviest (latest) first so the causal tail does not trail;
//   * the scaled q tile stays in shared memory (transposed, f32) for the
//     whole kv loop; each 64-key K tile and then V tile is staged in one
//     shared buffer (f32), so dh 128 takes 87 KB and two blocks fit per SM;
//   * each thread owns 4 q rows x 8 keys of the score tile and 4 rows x dh/8
//     columns of the (64, dh) f32 accumulator, in registers; the row max and
//     denominator are reduced across the 8 threads of a row by warp shuffles
//     and kept in registers for the whole loop;
//   * GQA: q head h reads kv head h / (hq / hkv) in place (no repeated K/V).
// wgmma, TMA and a pipelined K/V ring are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BQ = 64;     // q rows per block
constexpr int BKV = 64;    // keys per kv tile
constexpr int NT = 128;    // threads per block: 16 row groups x 8 column groups
constexpr int LD = BQ + 4; // row stride (floats) of the transposed tiles
constexpr float DEAD = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, HQ, HKV, dh;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // element strides of batch, seq, head
  float scale, softcap;
  int window;
};

// shared floats for head-dim capacity DH: q^T (DH x LD), one K^T/V buffer
// (max(DH x LD, BKV x DH)), P^T (BKV x LD)
template <int DH>
constexpr int smem_floats() {
  return DH * LD + (DH * LD > BKV * DH ? DH * LD : BKV * DH) + BKV * LD;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [DH][LD]: qs[d][row]
  float* kv = qs + DH * LD;                     // K^T [DH][LD] or V [BKV][DH]
  float* ps = kv + (DH * LD > BKV * DH ? DH * LD : BKV * DH);  // [BKV][LD]

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows 4*rg .. 4*rg+3 of the tile
  const int cg = tid & 7;   // keys / columns cg*4 + 32*jj + e
  const int bh = blockIdx.x;
  const int b = bh / a.HQ, h = bh % a.HQ;
  const int hk = h / (a.HQ / a.HKV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // latest tiles first
  const int dh = a.dh;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // scaled q tile, transposed; rows >= S and columns >= dh are 0
  for (int idx = tid; idx < BQ * DH; idx += NT) {
    const int row = idx / DH, d = idx % DH;
    float x = 0.f;
    if (q0 + row < a.S && d < dh)
      x = load_f32(qp + (q0 + row) * a.q_ss + d) * a.scale;
    qs[d * LD + row] = x;
  }

  // live kv tiles: from the window's first live tile to the tile holding the
  // last real row's diagonal, never past t
  const int last_row = min(q0 + BQ, a.S) - 1;
  const int j_end = min(last_row / BKV + 1, (a.T + BKV - 1) / BKV);
  const int j_beg = a.window > 0 ? max(q0 - a.window + 1, 0) / BKV : 0;

  float acc[4][DH / 8];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) acc[i][c] = 0.f;
  }
  const int dloop = (dh + 3) & ~3;

  for (int j = j_beg; j < j_end; ++j) {
    const int k0 = j * BKV;
    __syncthreads();  // q tile written / last tile's V and P reads done
    for (int idx = tid; idx < BKV * DH; idx += NT) {
      const int key = idx / DH, d = idx % DH;
      float x = 0.f;
      if (k0 + key < a.T && d < dh) x = load_f32(kp + (k0 + key) * a.k_ss + d);
      kv[d * LD + key] = x;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dloop; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * LD + 4 * rg);
      const float4 k_a =
          *reinterpret_cast<const float4*>(kv + d * LD + 4 * cg);
      const float4 k_b =
          *reinterpret_cast<const float4*>(kv + d * LD + 4 * cg + 32);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kc[8] = {k_a.x, k_a.y, k_a.z, k_a.w,
                           k_b.x, k_b.y, k_b.z, k_b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = fmaf(qr[i], kc[c], s[i][c]);
    }

    // softcap, causal/window mask, online softmax over this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int key = k0 + 4 * cg + 32 * (c >> 2) + (c & 3);
        float x = s[i][c];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const bool live =
            key <= row && (a.window <= 0 || row - key < a.window);
        x = live ? x : DEAD;
        if (key >= a.T) x = -INFINITY;  // past t: no weight at all
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);  // finite: key k0 < t
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(s[i][c] - m_new);
        s[i][c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done reading K^T

    // P^T to shared memory, V tile into the K buffer
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int key = 4 * cg + 32 * (c >> 2) + (c & 3);
      *reinterpret_cast<float4*>(ps + key * LD + 4 * rg) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    for (int idx = tid; idx < BKV * DH; idx += NT) {
      const int key = idx / DH, d = idx % DH;
      float x = 0.f;
      if (k0 + key < a.T && d < dh) x = load_f32(vp + (k0 + key) * a.v_ss + d);
      kv[key * DH + d] = x;
    }
    __syncthreads();

#pragma unroll 2
    for (int key = 0; key < BKV; ++key) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + key * LD + 4 * rg);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c4 = 0; c4 < DH / 32; ++c4) {
        const float4 vv =
            *reinterpret_cast<const float4*>(kv + key * DH + 4 * cg + 32 * c4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c4 + 0] = fmaf(pr[i], vv.x, acc[i][4 * c4 + 0]);
          acc[i][4 * c4 + 1] = fmaf(pr[i], vv.y, acc[i][4 * c4 + 1]);
          acc[i][4 * c4 + 2] = fmaf(pr[i], vv.z, acc[i][4 * c4 + 2]);
          acc[i][4 * c4 + 3] = fmaf(pr[i], vv.w, acc[i][4 * c4 + 3]);
        }
      }
    }
  }

  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= a.S) continue;
    const float den = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      const int d = 4 * cg + 32 * (c >> 2) + (c & 3);
      if (d < dh) store_f32(op + row * a.o_ss + d, acc[i][c] / den);
    }
  }
}

template <typename T, int DH>
int launch(const Args& a, int B, cudaStream_t st) {
  const int bytes = smem_floats<DH>() * static_cast<int>(sizeof(float));
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(B * a.HQ, (a.S + BQ - 1) / BQ);
  flash_attention_kernel<T, DH><<<grid, NT, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int B, cudaStream_t st) {
  if (a.dh <= 32) return launch<T, 32>(a, B, st);
  if (a.dh <= 64) return launch<T, 64>(a, B, st);
  if (a.dh <= 128) return launch<T, 128>(a, B, st);
  return launch<T, 256>(a, B, st);
}

}  // namespace

// q (B, S, HQ, dh), k and v (B, T, HKV, dh), o (B, S, HQ, dh): device
// pointers with the given element strides of batch, sequence and head (the
// head dimension is contiguous); bf16 = 1 for bfloat16 data, 0 for float32.
// 1 <= dh <= 256, HQ % HKV == 0. Returns the cudaError_t of the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int S, int T,
    int HQ, int HKV, int dh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, float softcap, int window, int bf16,
    void* stream) {
  if (B <= 0 || S <= 0 || T <= 0) return 0;
  if (dh < 1 || dh > 256 || HKV <= 0 || HQ % HKV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,    k,    v,    o,    S,    T,    HQ,   HKV,   dh,      q_sb,
         q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,  o_sb,    o_ss,
         o_sh, scale, softcap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, B, st) : dispatch<float>(a, B, st);
}
