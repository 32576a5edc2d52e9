// ChaCha20 keystream kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/chacha20.py::chacha20_keystream
// (_keystream_kernel). One thread makes one 64-byte block: counter i, under
// one key, with a nonce that is shared (3 words) or per block (n x 3 words),
// so the line OTP (nonce = line address) and the KV-cache OTP (nonce folds
// layer id and write counter) use the same kernel. Output is (n, 16) words,
// block-major; the Python wrapper transposes to the reference's (16, n).
//
// Bound: 976 32-bit integer operations per block against 64 bytes written
// (80 with the counter and a per-block nonce read): at 33.5e12 lane
// operations per second and 3.35 TB/s the arithmetic bounds it, just ahead
// of device memory. The design keeps the 16-word state in registers and
// writes each block as four 16-byte stores.
#include <cuda_runtime.h>
#include <cstdint>

#include "chacha20.cuh"

namespace {

__global__ void __launch_bounds__(256)
chacha20_blocks_kernel(const uint32_t* __restrict__ key,
                       const uint32_t* __restrict__ counters,
                       const uint32_t* __restrict__ nonces, int per_block,
                       uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t k[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) k[j] = __ldg(key + j);
  const uint32_t* nz = per_block ? nonces + 3 * static_cast<size_t>(i) : nonces;
  uint32_t o[16];
  seal::chacha20_block(k, __ldg(counters + i), __ldg(nz), __ldg(nz + 1),
                       __ldg(nz + 2), o);
  uint4* dst = reinterpret_cast<uint4*>(out + 16 * static_cast<size_t>(i));
  dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
  dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
  dst[2] = make_uint4(o[8], o[9], o[10], o[11]);
  dst[3] = make_uint4(o[12], o[13], o[14], o[15]);
}

}  // namespace

// key (8,), counters (n,), nonces (3,) or (n, 3) when per_block != 0; out
// (n, 16). All u32, device pointers. Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int chacha20_blocks(const void* key, const void* counters,
                               const void* nonces, int per_block, void* out,
                               int n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  chacha20_blocks_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(counters),
      static_cast<const uint32_t*>(nonces), per_block,
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
