// ASCII case map over a string byte plane: upper moves [a-z] down by 32,
// lower moves [A-Z] up by 32, and every other byte, non-ASCII UTF-8 bytes
// and the zero padding included, passes through unchanged:
//
//   out[i] = in[i] + delta * ((unsigned)(in[i] - lo) < 26)
//
// with (lo, delta) = ('a', -32) for upper and ('A', +32) for lower. The
// test is branch-free: a byte below lo wraps to a large unsigned value.
// Upper/Lower of expr/strings.py run it over a flat column's whole byte
// plane, or over a dictionary column's vocabulary.
//
// Replaces: spark_rapids_tpu/ops/pallas_kernels.py ascii_case_map_pallas
// (SWAR body _swar_case_kernel), which packs four bytes per u32 lane
// because the TPU's Mosaic does not lower u8 lanes. Byte loads are native
// here, so the SWAR carry arithmetic is gone: each byte is tested alone.
//
// What bounds it on an H100: memory. Each byte is read once and written
// once, 2 x n bytes over 3.35 TB/s: 0.641 ms for a 2^30-byte plane. The
// handful of integer operations per byte is far below what the SMs execute
// for that traffic.
//
// Design: a grid-stride loop in which each thread maps 16 bytes through
// one 16-byte load and one 16-byte store (uint4) when both planes start on
// a 16-byte boundary; the n % 16 tail, and the whole plane when a base is
// not aligned (a view at an odd offset), go byte by byte in the same
// launch. Any n works, so the TPU's 4096-byte block rule does not apply.
// The output is a separate plane: the input may be a vocabulary other
// columns share. The kernel allocates nothing and runs on the caller's
// stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t map_byte(uint32_t b, uint32_t lo,
                                             int32_t delta) {
  return (uint32_t)((int32_t)b + delta * (int32_t)((b - lo) < 26u)) & 0xFFu;
}

__device__ __forceinline__ uint32_t map_word(uint32_t w, uint32_t lo,
                                             int32_t delta) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out |= map_byte((w >> (8 * k)) & 0xFFu, lo, delta) << (8 * k);
  }
  return out;
}

__global__ void case_map_kernel(const uint8_t* __restrict__ in,
                                uint8_t* __restrict__ out, int64_t n,
                                int vectorized, uint32_t lo, int32_t delta) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vectorized) {
    const int64_t nvec = n >> 4;
    const uint4* __restrict__ vin = reinterpret_cast<const uint4*>(in);
    uint4* __restrict__ vout = reinterpret_cast<uint4*>(out);
    for (int64_t i = tid; i < nvec; i += stride) {
      uint4 v = __ldg(vin + i);
      v.x = map_word(v.x, lo, delta);
      v.y = map_word(v.y, lo, delta);
      v.z = map_word(v.z, lo, delta);
      v.w = map_word(v.w, lo, delta);
      vout[i] = v;
    }
    done = nvec << 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    out[i] = (uint8_t)map_byte(in[i], lo, delta);
  }
}

}  // namespace

// in, out: uint8[n] device planes (out a separate allocation); upper != 0
// maps to upper case, else to lower case. Returns the cudaError_t of the
// launch.
extern "C" int case_map_launch(const void* in, void* out, long long n,
                               int upper, void* stream) {
  if (n <= 0) return 0;
  const int vectorized =
      ((((uintptr_t)in) | ((uintptr_t)out)) & 15u) == 0 ? 1 : 0;
  const int threads = 256;
  const long long work = vectorized ? (n + 15) / 16 : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // 32 blocks per SM, then loop
  case_map_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, (int64_t)n, vectorized,
      upper ? (uint32_t)'a' : (uint32_t)'A', upper ? -32 : 32);
  return (int)cudaGetLastError();
}
