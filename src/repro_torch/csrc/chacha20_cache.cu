// The paged KV cache's ChaCha20 pads, made where they are used (sm_90a).
//
// Replaces, for the KV cache, the Pallas kernel
// src/repro/kernels/chacha20.py::chacha20_keystream (_keystream_kernel) as
// the reference applies it through kernels/ref.py::cache_block_otp in
// models/paged.py::_dense_view (the read), ::append_tokens (the write) and
// ::copy_blocks (the copy-on-write), and as src/repro/core/mac.py::
// MacContext.tags applies it to the cache blocks' MAC pads. Five entry
// points:
//
//   cache_view    one layer's k and v blocks gathered through the block
//                 tables into dense (B, MB*wpb) words, unsealed, and zeroed
//                 at and past each slot's length: one launch per layer;
//   cache_splice  every layer of a stack, k and v, in place on the pools:
//                 each touched (row, span) block is unsealed under wc[pb],
//                 the new token words spliced in where they fall, and the
//                 block re-sealed under wc[pb] + 1: one launch per write;
//   cache_copy    the copy-on-write of K (src, dst) pairs over every layer,
//                 k and v, in place: each unit of src unsealed under
//                 (src, wc[src]) and re-sealed into dst under
//                 (dst, wc[dst] + 1), so no plaintext reaches the pool;
//   cache_tags    one Carter-Wegman tag per (layer, stream, block) of a
//                 list: uhash(ciphertext) XOR word 0 of ChaCha20(MAC key,
//                 counter = block, nonce = (m0 ^ lid, m1 ^ wc[block], m2));
//   cache_verify  a pass's check of every layer, k and v, in one launch:
//                 each resident block of each slot's table re-tagged as
//                 cache_tags does and held against its stored tag, the
//                 slot's verdict cleared by an atomicAnd where one fails.
//
// Keystream contract (cache_block_otp): 16-word unit c of pool block b in
// layer lid, under write counter wc, XORs the ChaCha20 block with
//   counter = b * ceil(wpb/16) + c,  nonce = (n0 ^ lid, n1 ^ wc, n2),
// all u32 with wrap-around; a final unit of a block whose wpb is not a
// multiple of 16 uses the first wpb % 16 words of its block.
//
// What bounds it on this card: per unit 64 bytes read and 64 written, and
// one ChaCha block (two in the splice), whose 640 XORs and rotations issue
// only on the integer ALU pipe (16.7e12 lane operations a second on 132
// SMs) against 128 bytes at 3.35 TB/s: the pads and the bytes take about
// the same time in the view, the pads twice as long in the splice. The
// composition these kernels replace wrote every pad to device memory, read
// it back for a separate XOR and built int64 counters and nonce arrays
// first, some 50 launches per layer.
// Here one thread takes one unit: it derives the counter and nonce from the
// table entry, makes the pad in registers and XORs it into the words it
// moves (16-byte loads and stores where the geometry allows), so no
// keystream, counter or nonce array reaches device memory. A unit with no
// live word writes zeros and makes no pad; an untouched splice unit writes
// nothing; a splice unit whose words are all new skips the unseal's pad.
// A copy thread likewise makes both pads of its unit in registers: 128
// bytes and two pads a unit, so the pads bound it.
//
// The tag's hash (chacha20.cuh, mac_*) is exact in 64 bits: a block of
// threads a tag, each thread accumulating its words' products with one wide
// multiply-add a half, a warp-shuffle and shared-memory reduction, and one
// modulo and one pad at the end. Per tag that is the block's bytes, read
// once, against about 3 integer operations a half and one pad: the bytes
// bound it. The verify runs one such block of threads per (table entry,
// layer, stream), some thousands a pass, so one launch fills the card where
// a launch a layer (a hundred blocks of threads) did not; the compare and
// the AND over layers happen in the kernel, so a pass's check is one launch
// and no PyTorch op. (A block of threads over four layers, k and v, that
// loads each hash key once for eight rows was slower: too few blocks of
// threads in flight; PERF.md §6.)
#include <cuda_runtime.h>
#include <cstdint>

#include "chacha20.cuh"

namespace {

constexpr int kThreads = 256;

struct Nonce {
  uint32_t w[3];
};

struct Key {
  uint32_t w[8];
};

__device__ __forceinline__ Key load_key(const uint32_t* __restrict__ key) {
  Key k;
#pragma unroll
  for (int j = 0; j < 8; ++j) k.w[j] = __ldg(key + j);
  return k;
}

// The pad of unit c of pool block blk (cache_block_otp's derivation).
__device__ __forceinline__ void cache_pad(const Key& k, uint32_t blk,
                                          uint32_t cpb, uint32_t c,
                                          uint32_t lid, uint32_t wc,
                                          const Nonce& n, uint32_t p[16]) {
  seal::chacha20_block(k.w, blk * cpb + c, n.w[0] ^ lid, n.w[1] ^ wc, n.w[2],
                       p);
}

// 16 words at p (16-byte aligned when VEC, else the first nw of them).
template <bool VEC>
__device__ __forceinline__ void load16(const uint32_t* p, int nw,
                                       uint32_t w[16]) {
  if (VEC) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 4 * q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = j < nw ? p[j] : 0u;
  }
}

template <bool VEC>
__device__ __forceinline__ void store16(uint32_t* p, int nw,
                                        const uint32_t w[16]) {
  if (VEC) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<uint4*>(p + 4 * q) =
          make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < nw) p[j] = w[j];
  }
}

// Thread i: unit c of block m of slot b, for k (kv = 0) or v (kv = 1);
// out is (2, B, MB*wpb).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
cache_view_kernel(const uint32_t* __restrict__ key,
                  const uint32_t* __restrict__ pool_k,
                  const uint32_t* __restrict__ pool_v, long long stride_k,
                  long long stride_v, const uint32_t* __restrict__ lid_p,
                  const long long* __restrict__ tables,
                  const long long* __restrict__ lengths,
                  const uint32_t* __restrict__ wc, uint32_t* __restrict__ out,
                  int slots, int mb, int wpb, int wpt, Nonce nk, Nonce nv) {
  const int cpb = (wpb + 15) / 16;
  const long long per_kv = static_cast<long long>(slots) * mb * cpb;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= 2 * per_kv) return;
  const int kv = i >= per_kv;
  const long long r = i - kv * per_kv;
  const int c = static_cast<int>(r % cpb);
  const long long sm = r / cpb;                 // b * MB + m
  const int m = static_cast<int>(sm % mb);
  const int b = static_cast<int>(sm / mb);
  const int w0 = 16 * c;
  const int nw = min(16, wpb - w0);
  // words of this unit at a token position below the slot's length
  const long long live_words = __ldg(lengths + b) * wpt -
                               static_cast<long long>(m) * wpb - w0;
  const int live = static_cast<int>(
      max(0LL, min(static_cast<long long>(nw), live_words)));
  uint32_t* dst = out + (kv * static_cast<long long>(slots) * mb + sm) * wpb +
                  w0;
  uint32_t w[16];
  if (live > 0) {
    const long long blk = __ldg(tables + sm);
    const uint32_t* src =
        (kv ? pool_v + blk * stride_v : pool_k + blk * stride_k) + w0;
    load16<VEC>(src, nw, w);
    uint32_t p[16];
    cache_pad(load_key(key), static_cast<uint32_t>(blk), cpb, c,
              __ldg(lid_p), __ldg(wc + blk), kv ? nv : nk, p);
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = j < live ? w[j] ^ p[j] : 0u;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = 0u;
  }
  store16<VEC>(dst, nw, w);
}

// Thread i: unit c of span s of row b in layer l, for k (kv = 0) or v.
// pools (n, NB, wpb) with strides (ls, rs); fresh words (n, B, C, wpt).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
cache_splice_kernel(const uint32_t* __restrict__ key,
                    uint32_t* __restrict__ pool_k,
                    uint32_t* __restrict__ pool_v,
                    long long ls_k, long long rs_k, long long ls_v,
                    long long rs_v, const uint32_t* __restrict__ lids,
                    const uint32_t* __restrict__ new_k,
                    const uint32_t* __restrict__ new_v,
                    const long long* __restrict__ tables,
                    const long long* __restrict__ lengths,
                    const long long* __restrict__ counts,
                    const uint32_t* __restrict__ wc, int layers, int rows,
                    int mb, int wpb, int wpt, int bs, int ctok, int nspan,
                    Nonce nk, Nonce nv) {
  const int cpb = (wpb + 15) / 16;
  const long long per_kv =
      static_cast<long long>(layers) * rows * nspan * cpb;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= 2 * per_kv) return;
  const int kv = i >= per_kv;
  long long r = i - kv * per_kv;
  const int c = static_cast<int>(r % cpb);
  r /= cpb;
  const int s = static_cast<int>(r % nspan);
  r /= nspan;
  const int b = static_cast<int>(r % rows);
  const int l = static_cast<int>(r / rows);
  const long long cnt = __ldg(counts + b);
  if (cnt <= 0) return;
  const long long len = __ldg(lengths + b);
  const long long o = len % bs;
  // the write covers tokens [o, o + cnt) of the window of nspan blocks
  if (!(s * bs < o + cnt && (s + 1) * bs > o)) return;
  const long long span = min(len / bs + s, static_cast<long long>(mb - 1));
  const long long pb = __ldg(tables + static_cast<long long>(b) * mb + span);
  const int w0 = 16 * c;
  const int nw = min(16, wpb - w0);
  // unit words [sel_lo, sel_hi) take fresh words: window word g = s*wpb + w
  // is new for o*wpt <= g < (o + cnt)*wpt, and reads fresh word g - o*wpt
  const long long g0 = static_cast<long long>(s) * wpb + w0;
  const long long sel_lo = o * wpt - g0;
  const long long sel_hi = (o + cnt) * wpt - g0;
  const bool all_new = sel_lo <= 0 && sel_hi >= nw;
  uint32_t* blkp =
      (kv ? pool_v + l * ls_v + pb * rs_v : pool_k + l * ls_k + pb * rs_k) +
      w0;
  const uint32_t* fresh = (kv ? new_v : new_k) +
                          (static_cast<long long>(l) * rows + b) * ctok * wpt;
  const Key k = load_key(key);
  const Nonce& n = kv ? nv : nk;
  const uint32_t lid = __ldg(lids + l);
  const uint32_t wcb = __ldg(wc + pb);
  uint32_t w[16];
  if (all_new) {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = 0u;
  } else {
    load16<VEC>(blkp, nw, w);
    uint32_t p[16];
    cache_pad(k, static_cast<uint32_t>(pb), cpb, c, lid, wcb, n, p);
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] ^= p[j];
  }
  // a count above C reads zeros past the fresh words, as the reference's
  // zero-padded window does
  const long long fresh_words = static_cast<long long>(ctok) * wpt;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const long long f = g0 + j - o * wpt;
    if (j < nw && j >= sel_lo && j < sel_hi)
      w[j] = f < fresh_words ? __ldg(fresh + f) : 0u;
  }
  uint32_t p[16];
  cache_pad(k, static_cast<uint32_t>(pb), cpb, c, lid, wcb + 1u, n, p);
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] ^= p[j];
  store16<VEC>(blkp, nw, w);
}

// Thread i: unit c of pair p in layer l, for k (kv = 0) or v; masked-off
// pairs write nothing.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
cache_copy_kernel(const uint32_t* __restrict__ key, uint32_t* pool_k,
                  uint32_t* pool_v, long long ls_k, long long rs_k,
                  long long ls_v, long long rs_v,
                  const uint32_t* __restrict__ lids,
                  const long long* __restrict__ src,
                  const long long* __restrict__ dst,
                  const unsigned char* __restrict__ mask,
                  const uint32_t* __restrict__ wc, int layers, int pairs,
                  int wpb, Nonce nk, Nonce nv) {
  const int cpb = (wpb + 15) / 16;
  const long long per_kv = static_cast<long long>(layers) * pairs * cpb;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= 2 * per_kv) return;
  const int kv = i >= per_kv;
  long long r = i - kv * per_kv;
  const int c = static_cast<int>(r % cpb);
  r /= cpb;
  const int p = static_cast<int>(r % pairs);
  const int l = static_cast<int>(r / pairs);
  if (!__ldg(mask + p)) return;
  const long long sb = __ldg(src + p), db = __ldg(dst + p);
  const int w0 = 16 * c;
  const int nw = min(16, wpb - w0);
  uint32_t* base = kv ? pool_v + l * ls_v : pool_k + l * ls_k;
  const long long rs = kv ? rs_v : rs_k;
  const Key k = load_key(key);
  const Nonce& n = kv ? nv : nk;
  const uint32_t lid = __ldg(lids + l);
  uint32_t w[16], p0[16], p1[16];
  load16<VEC>(base + sb * rs + w0, nw, w);
  cache_pad(k, static_cast<uint32_t>(sb), cpb, c, lid, __ldg(wc + sb), n, p0);
  cache_pad(k, static_cast<uint32_t>(db), cpb, c, lid, __ldg(wc + db) + 1u, n,
            p1);
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] ^= p0[j] ^ p1[j];
  store16<VEC>(base + db * rs + w0, nw, w);
}

// The tag of one cache block's words `row` (pool block blk, layer id lid,
// write counter wcb, stream nonce n), returned to thread 0 of the block of
// threads; the other threads get nothing of use.
template <bool VEC>
__device__ __forceinline__ uint32_t block_tag(
    const uint32_t* __restrict__ key, const uint32_t* __restrict__ hkeys,
    const uint32_t* row, long long blk, uint32_t lid, uint32_t wcb,
    const Nonce& n, int wpb) {
  uint32_t pad0 = 0u;
  if (threadIdx.x == 0)             // the pad overlaps the other loads
    pad0 = seal::mac_pad(load_key(key).w, static_cast<uint32_t>(blk),
                         n.w[0] ^ lid, n.w[1] ^ wcb, n.w[2]);
  unsigned long long acc = 0;
  if (VEC) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int q = threadIdx.x; q < wpb / 4; q += kThreads)
      acc += seal::mac_quad_terms(row4[q], hkeys, q);
  } else {
    for (int q = threadIdx.x; q < wpb; q += kThreads)
      acc += seal::mac_word_terms(row[q], __ldg(hkeys + 2 * q),
                                  __ldg(hkeys + 2 * q + 1));
  }
  acc = seal::mac_block_sum<kThreads>(acc);
  return seal::mac_tag(acc, pad0);
}

// Block (e, 2*l + kv): the tag of entry e in layer l, stream kv; out is
// (layers, 2, entries). A dead entry writes 0 and reads nothing.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
cache_tags_kernel(const uint32_t* __restrict__ key,
                  const uint32_t* __restrict__ hkeys,
                  const uint32_t* __restrict__ pool_k,
                  const uint32_t* __restrict__ pool_v, long long ls_k,
                  long long rs_k, long long ls_v, long long rs_v,
                  const uint32_t* __restrict__ lids,
                  const long long* __restrict__ blocks,
                  const unsigned char* __restrict__ live,
                  const uint32_t* __restrict__ wc, uint32_t* __restrict__ out,
                  int entries, int wpb, Nonce mk, Nonce mv) {
  const int e = blockIdx.x;
  const int kv = blockIdx.y & 1;
  const int l = blockIdx.y >> 1;
  uint32_t* dst = out + (2LL * l + kv) * entries + e;
  if (!__ldg(live + e)) {
    if (threadIdx.x == 0) *dst = 0u;
    return;
  }
  const long long blk = __ldg(blocks + e);
  const uint32_t* row =
      kv ? pool_v + l * ls_v + blk * rs_v : pool_k + l * ls_k + blk * rs_k;
  const uint32_t tag = block_tag<VEC>(key, hkeys, row, blk, __ldg(lids + l),
                                      __ldg(wc + blk), kv ? mv : mk, wpb);
  if (threadIdx.x == 0) *dst = tag;
}

// Block (e, 2*l + kv): table entry e = b * MB + m of slot b, in layer l,
// stream kv. A resident entry (m < ceil(lengths[b] / bs)) recomputes its
// block's tag over the ciphertext as cache_tags does and, where it differs
// from the stored tag, clears ok[b]; the others return at once. No tag
// reaches memory.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
cache_verify_kernel(const uint32_t* __restrict__ key,
                    const uint32_t* __restrict__ hkeys,
                    const uint32_t* __restrict__ pool_k,
                    const uint32_t* __restrict__ pool_v, long long ls_k,
                    long long rs_k, long long ls_v, long long rs_v,
                    const uint32_t* __restrict__ mac_k,
                    const uint32_t* __restrict__ mac_v, long long mls_k,
                    long long mls_v, const uint32_t* __restrict__ lids,
                    const long long* __restrict__ tables,
                    const long long* __restrict__ lengths,
                    const uint32_t* __restrict__ wc, int* __restrict__ ok,
                    int mb, int wpb, int bs, Nonce mk, Nonce mv) {
  const int e = blockIdx.x;
  const int kv = blockIdx.y & 1;
  const int l = blockIdx.y >> 1;
  const int b = e / mb;
  if (e - b * mb >= (__ldg(lengths + b) + bs - 1) / bs) return;
  const long long blk = __ldg(tables + e);
  const uint32_t* row =
      kv ? pool_v + l * ls_v + blk * rs_v : pool_k + l * ls_k + blk * rs_k;
  const uint32_t tag = block_tag<VEC>(key, hkeys, row, blk, __ldg(lids + l),
                                      __ldg(wc + blk), kv ? mv : mk, wpb);
  if (threadIdx.x == 0) {
    const uint32_t* stored = kv ? mac_v + l * mls_v : mac_k + l * mls_k;
    if (tag != __ldg(stored + blk)) atomicAnd(ok + b, 0);
  }
}

int blocks_for(long long units) {
  return static_cast<int>((units + kThreads - 1) / kThreads);
}

}  // namespace

// key (8,) u32; pool_k, pool_v: one layer's (NB, wpb) u32 words with row
// strides stride_k, stride_v (in words); lid: one u32 word; tables (B, MB)
// and lengths (B,) int64; wc (NB,) u32; out (2, B, MB*wpb) u32. vec != 0:
// wpb % 16 == 0 and every row start and out 16-byte aligned. Device
// pointers; launches on `stream`; returns the launch's cudaError_t.
extern "C" int cache_view(const void* key, const void* pool_k,
                          const void* pool_v, long long stride_k,
                          long long stride_v, const void* lid,
                          const void* tables, const void* lengths,
                          const void* wc, void* out, int slots, int mb,
                          int wpb, int wpt, unsigned nk0, unsigned nk1,
                          unsigned nk2, unsigned nv0, unsigned nv1,
                          unsigned nv2, int vec, void* stream) {
  const long long units =
      2LL * slots * mb * ((wpb + 15) / 16);
  if (units <= 0) return 0;
  const Nonce nk{{nk0, nk1, nk2}}, nv{{nv0, nv1, nv2}};
  auto launch = vec ? cache_view_kernel<true> : cache_view_kernel<false>;
  launch<<<blocks_for(units), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(pool_k),
      static_cast<const uint32_t*>(pool_v), stride_k, stride_v,
      static_cast<const uint32_t*>(lid), static_cast<const long long*>(tables),
      static_cast<const long long*>(lengths),
      static_cast<const uint32_t*>(wc), static_cast<uint32_t*>(out), slots,
      mb, wpb, wpt, nk, nv);
  return static_cast<int>(cudaGetLastError());
}

// key (8,) u32; pool_k, pool_v: (n, NB, wpb) u32 words with layer strides
// ls_* and row strides rs_* (in words), updated in place; lids (n,) u32;
// new_k, new_v (n, B, C, wpt) u32; tables (B, MB), lengths (B,), counts (B,)
// int64; wc (NB,) u32, read only (the caller bumps it after the launch).
// vec != 0: wpb % 16 == 0 and every row start 16-byte aligned. Device
// pointers; launches on `stream`; returns the launch's cudaError_t.
extern "C" int cache_splice(const void* key, void* pool_k, void* pool_v,
                            long long ls_k, long long rs_k, long long ls_v,
                            long long rs_v, const void* lids,
                            const void* new_k, const void* new_v,
                            const void* tables, const void* lengths,
                            const void* counts, const void* wc, int layers,
                            int rows, int mb, int wpb, int wpt, int bs,
                            int ctok, int nspan, unsigned nk0, unsigned nk1,
                            unsigned nk2, unsigned nv0, unsigned nv1,
                            unsigned nv2, int vec, void* stream) {
  const long long units =
      2LL * layers * rows * nspan * ((wpb + 15) / 16);
  if (units <= 0) return 0;
  const Nonce nk{{nk0, nk1, nk2}}, nv{{nv0, nv1, nv2}};
  auto launch = vec ? cache_splice_kernel<true> : cache_splice_kernel<false>;
  launch<<<blocks_for(units), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<uint32_t*>(pool_k),
      static_cast<uint32_t*>(pool_v), ls_k, rs_k, ls_v, rs_v,
      static_cast<const uint32_t*>(lids), static_cast<const uint32_t*>(new_k),
      static_cast<const uint32_t*>(new_v),
      static_cast<const long long*>(tables),
      static_cast<const long long*>(lengths),
      static_cast<const long long*>(counts),
      static_cast<const uint32_t*>(wc), layers, rows, mb, wpb, wpt, bs, ctok,
      nspan, nk, nv);
  return static_cast<int>(cudaGetLastError());
}

// key (8,) u32; pool_k, pool_v: (n, NB, wpb) u32 words with layer strides
// ls_* and row strides rs_* (in words), updated in place; lids (n,) u32;
// src, dst (K,) int64 block ids, disjoint among the masked pairs; mask (K,)
// bool; wc (NB,) u32, read only (the caller bumps wc[dst] after the
// launch). vec != 0: wpb % 16 == 0 and every row start 16-byte aligned.
// Device pointers; launches on `stream`; returns the launch's cudaError_t.
extern "C" int cache_copy(const void* key, void* pool_k, void* pool_v,
                          long long ls_k, long long rs_k, long long ls_v,
                          long long rs_v, const void* lids, const void* src,
                          const void* dst, const void* mask, const void* wc,
                          int layers, int pairs, int wpb, unsigned nk0,
                          unsigned nk1, unsigned nk2, unsigned nv0,
                          unsigned nv1, unsigned nv2, int vec, void* stream) {
  const long long units = 2LL * layers * pairs * ((wpb + 15) / 16);
  if (units <= 0) return 0;
  const Nonce nk{{nk0, nk1, nk2}}, nv{{nv0, nv1, nv2}};
  auto launch = vec ? cache_copy_kernel<true> : cache_copy_kernel<false>;
  launch<<<blocks_for(units), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<uint32_t*>(pool_k),
      static_cast<uint32_t*>(pool_v), ls_k, rs_k, ls_v, rs_v,
      static_cast<const uint32_t*>(lids), static_cast<const long long*>(src),
      static_cast<const long long*>(dst),
      static_cast<const unsigned char*>(mask),
      static_cast<const uint32_t*>(wc), layers, pairs, wpb, nk, nv);
  return static_cast<int>(cudaGetLastError());
}

// key (8,) u32 MAC key; hkeys (2*wpb,) u32 hash keys in [1, 2^31 - 1);
// pool_k, pool_v: (n, NB, wpb) u32 words with layer strides ls_* and row
// strides rs_* (in words); lids (n,) u32; blocks (E,) int64; live (E,)
// bool; wc (NB,) u32; out (n, 2, E) u32 tags, 0 where not live. mk, mv: the
// k and v streams' MAC nonces. vec != 0: wpb % 4 == 0 and every row start
// and hkeys 16-byte aligned. Device pointers; launches on `stream`; returns
// the launch's cudaError_t.
extern "C" int cache_tags(const void* key, const void* hkeys,
                          const void* pool_k, const void* pool_v,
                          long long ls_k, long long rs_k, long long ls_v,
                          long long rs_v, const void* lids,
                          const void* blocks, const void* live,
                          const void* wc, void* out, int layers, int entries,
                          int wpb, unsigned mk0, unsigned mk1, unsigned mk2,
                          unsigned mv0, unsigned mv1, unsigned mv2, int vec,
                          void* stream) {
  if (layers <= 0 || entries <= 0) return 0;
  const Nonce mk{{mk0, mk1, mk2}}, mv{{mv0, mv1, mv2}};
  auto launch = vec ? cache_tags_kernel<true> : cache_tags_kernel<false>;
  launch<<<dim3(entries, 2 * layers), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(hkeys),
      static_cast<const uint32_t*>(pool_k),
      static_cast<const uint32_t*>(pool_v), ls_k, rs_k, ls_v, rs_v,
      static_cast<const uint32_t*>(lids), static_cast<const long long*>(blocks),
      static_cast<const unsigned char*>(live),
      static_cast<const uint32_t*>(wc), static_cast<uint32_t*>(out), entries,
      wpb, mk, mv);
  return static_cast<int>(cudaGetLastError());
}

// key (8,) u32 MAC key; hkeys (2*wpb,) u32 hash keys; pool_k, pool_v: (n,
// NB, wpb) u32 words with layer strides ls_* and row strides rs_* (in
// words); mac_k, mac_v: the stored tags, (n, NB) u32 with layer strides
// mls_*; lids (n,) u32; tables (B, MB) and lengths (B,) int64, entries =
// B * MB; wc (NB,) u32; ok (B,) int32, set to 1 by the caller: entry b is
// cleared to 0 when a resident block of slot b (table column below
// ceil(lengths[b] / bs)) in any layer, k or v, fails its tag. mk, mv: the
// k and v streams' MAC nonces. vec as for cache_tags. Device pointers;
// launches on `stream`; returns the launch's cudaError_t.
extern "C" int cache_verify(const void* key, const void* hkeys,
                            const void* pool_k, const void* pool_v,
                            long long ls_k, long long rs_k, long long ls_v,
                            long long rs_v, const void* mac_k,
                            const void* mac_v, long long mls_k,
                            long long mls_v, const void* lids,
                            const void* tables, const void* lengths,
                            const void* wc, void* ok, int layers, int entries,
                            int mb, int wpb, int bs, unsigned mk0,
                            unsigned mk1, unsigned mk2, unsigned mv0,
                            unsigned mv1, unsigned mv2, int vec,
                            void* stream) {
  if (layers <= 0 || entries <= 0) return 0;
  const Nonce mk{{mk0, mk1, mk2}}, mv{{mv0, mv1, mv2}};
  auto launch = vec ? cache_verify_kernel<true> : cache_verify_kernel<false>;
  launch<<<dim3(entries, 2 * layers), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(hkeys),
      static_cast<const uint32_t*>(pool_k),
      static_cast<const uint32_t*>(pool_v), ls_k, rs_k, ls_v, rs_v,
      static_cast<const uint32_t*>(mac_k),
      static_cast<const uint32_t*>(mac_v), mls_k, mls_v,
      static_cast<const uint32_t*>(lids),
      static_cast<const long long*>(tables),
      static_cast<const long long*>(lengths),
      static_cast<const uint32_t*>(wc), static_cast<int*>(ok), mb, wpb, bs,
      mk, mv);
  return static_cast<int>(cudaGetLastError());
}
