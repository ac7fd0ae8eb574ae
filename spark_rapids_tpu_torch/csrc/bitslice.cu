// Unaligned bit-field extraction for device-side Parquet decode: for every
// element i, the field of up to 32 bits that starts at bit bitoff[i] of a
// little-endian u32 word plane, masked to mask[i]:
//
//   widx = clamp(bitoff >> 5, 0, W - 2), sh = bitoff & 31
//   out  = (words[widx] >> sh | words[widx + 1] << (32 - sh)) & mask
//
// with the sh == 0 case folded to words[widx] & mask (a shift by 32 is
// undefined). Every dictionary-code, boolean, definition-level and
// delta-miniblock expansion of ops/decode.py goes through it.
//
// Replaces: spark_rapids_tpu/ops/pallas_decode.py bitslice_u32_pallas
// (body _bitslice_kernel), together with the two word gathers and the bit
// offset split that its caller _gather_bits does outside the TPU kernel.
//
// What bounds it on an H100: memory. Each element reads an 8-byte offset
// and a 4-byte mask and writes 4 bytes; the word plane is read once more
// (W x 4 bytes). The bound is n x (8 + 4 + 4) + W x 4 bytes over
// 3.35 TB/s: one 2^20-row batch of 12-bit codes (W ~ 393,000 words) moves
// about 18.4 MB, about 5.5 us. The few integer operations per element are
// far below what the SMs issue for that traffic.
//
// Design: one thread per element in a grid-stride loop over any n; the
// loop bound masks the tail, so the TPU's 1024-row block rule does not
// apply. Offsets and masks are read coalesced; the two word reads of a
// warp fall on neighbouring words when the offsets increase (a packed
// run), so they are served from the same few cache lines. The word plane
// is the encoded byte pool viewed as int32 (its size is a whole number of
// words, with 8 guard bytes), so no byte-combine pass precedes the
// kernel. The kernel allocates nothing and runs on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bitslice_kernel(const uint32_t* __restrict__ words,
                                int64_t n_words,
                                const int64_t* __restrict__ bitoff,
                                const uint32_t* __restrict__ mask,
                                uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t last = n_words - 2;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t b = bitoff[i];
    int64_t widx = b >> 5;
    widx = widx < 0 ? 0 : (widx > last ? last : widx);
    const uint32_t sh = (uint32_t)(b & 31);
    const uint32_t lo = __ldg(words + widx) >> sh;
    const uint32_t hi = sh == 0 ? 0u : (__ldg(words + widx + 1) << (32u - sh));
    out[i] = (lo | hi) & mask[i];
  }
}

}  // namespace

// words: int32[n_words] (n_words >= 2); bitoff: int64[n]; mask, out:
// int32[n]; all device planes. Returns the cudaError_t of the launch.
extern "C" int bitslice_launch(const void* words, long long n_words,
                               const void* bitoff, const void* mask,
                               void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // 32 blocks per SM, then loop
  bitslice_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int64_t)n_words, (const int64_t*)bitoff,
      (const uint32_t*)mask, (uint32_t*)out, (int64_t)n);
  return (int)cudaGetLastError();
}
