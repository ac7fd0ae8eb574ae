// Spark murmur3 hash of an int32 plane (Spark hashInt): murmur3_x86_32 of
// each 4-byte value with a 32-bit seed, then fmix with len = 4.
//
// Replaces: spark_rapids_tpu/ops/pallas_kernels.py murmur3_int32_pallas
// (body _mm3_kernel), the TPU kernel behind every hash exchange.
//
// What bounds it on an H100: memory. Each row reads 4 bytes (8 with a
// per-row seed plane) and writes 4; the ~20 integer operations per row are
// far below what the SMs can issue for that traffic. At 32M rows that is
// 256 MB, about 0.08 ms at 3.35 TB/s.
//
// Design: one thread per element in a grid-stride loop over any n; the
// loop bound masks the ragged tail, so the TPU's 1024-row block alignment
// is not needed. Neighbouring threads read neighbouring words, so every
// warp load is one coalesced 128-byte transaction. The optional per-row
// seed plane (the chained multi-column case) is a second coalesced
// stream; the TPU package kept that case off its kernel only because of a
// compiler fault there. The kernel allocates nothing and runs on the
// caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t hash_int(uint32_t k1, uint32_t h1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1B873593u;
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  h1 = h1 * 5u + 0xE6546B64u;
  h1 ^= 4u;  // fmix(h1 ^ len), len = 4
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  h1 ^= h1 >> 16;
  return h1;
}

__global__ void murmur3_int32_kernel(const uint32_t* __restrict__ x,
                                     const uint32_t* __restrict__ seeds,
                                     uint32_t seed, uint32_t* __restrict__ out,
                                     int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = hash_int(x[i], seeds != nullptr ? seeds[i] : seed);
  }
}

}  // namespace

// x, seeds (may be null) and out are int32 device planes of n elements;
// returns the cudaError_t of the launch.
extern "C" int murmur3_int32_launch(const void* x, const void* seeds,
                                    unsigned int seed, void* out,
                                    long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // 32 blocks per SM, then loop
  murmur3_int32_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)seeds, (uint32_t)seed,
      (uint32_t*)out, (int64_t)n);
  return (int)cudaGetLastError();
}
