// Per-id sums of P payload lanes over sorted dense group ids.
//
// Replaces: spark_rapids_tpu/ops/pallas_segsum.py segsum_window (body
// _kernel_factory), the group-by sum kernel of the hash aggregate.
//
// Inputs: gid int32[N] (sorted ascending by the caller), payload
// bf16[P, N] lane-major (one contiguous plane per lane, as the caller
// builds them), out f32[outcap, P] zero-filled by the caller.
// out[g, p] += payload[p, r] for every row r with gid[r] == g; ids outside
// [0, outcap) are skipped (dead rows sort last and may carry id outcap).
//
// What bounds it on an H100: memory. Each row reads 4 bytes of id and
// 2*P bytes of payload; the output is a few MB. At the q72shfl chunk shape
// (N = 8M, P = 10 lanes) that is about 212 MB, 0.063 ms at 3.35 TB/s.
//
// Design: the TPU kernel turns each 1024-row tile into a one-hot matmul
// to avoid scatters; on Hopper atomics are cheap, so this kernel reduces
// runs of equal ids directly. A block holds 256 threads laid out as
// (256 / P) segments x P lanes. Each thread walks the 64 consecutive rows
// of its segment in its own lane plane, keeps the running sum of the
// current id in a register, and issues one atomicAdd per (run, lane,
// segment) when the id changes. It reads its 64 payload values as eight
// 16-byte loads and its 64 ids as sixteen, all independent of the sums,
// so they are in flight together (reading one bf16 at a time ran 3x
// slower: every warp load touched 32 sectors for 64 useful bytes). There
// is no scalar path: n must be a multiple of 8 and the bases 16-byte
// aligned, which the wrapper checks.
//
// Exactness: the lanes hold 8-bit integer digits and groups are bounded by
// 2^16 rows (the caller falls back past that), so every partial and total
// is an integer below 2^24: the f32 sums are exact and the order of the
// atomics cannot change the result. Unsorted ids give the same sums, with
// more atomics. Zero partial sums are not written. The kernel allocates
// nothing and runs on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegRows = 64;

__device__ __forceinline__ float bf16_to_f32(uint32_t h) {
  return __uint_as_float(h << 16);
}

struct Run {
  int cur;
  float acc;
};

__device__ __forceinline__ void flush(float* out, const Run& run, int lane,
                                      int P, int64_t outcap) {
  if (run.acc != 0.0f && run.cur >= 0 && (int64_t)run.cur < outcap) {
    atomicAdd(out + (int64_t)run.cur * P + lane, run.acc);
  }
}

__device__ __forceinline__ void step(Run& run, int g, float v, float* out,
                                     int lane, int P, int64_t outcap) {
  if (g != run.cur) {
    flush(out, run, lane, P, outcap);
    run.cur = g;
    run.acc = 0.0f;
  }
  run.acc += v;
}

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int32_t* __restrict__ gid,
              const uint16_t* __restrict__ pay, float* __restrict__ out,
              int64_t n, int P, int64_t outcap, int segs) {
  const int seg = threadIdx.x / P;
  const int lane = threadIdx.x % P;
  if (seg >= segs) return;
  const int64_t start = ((int64_t)blockIdx.x * segs + seg) * kSegRows;
  if (start >= n) return;
  // 8-row steps in this segment: 8 unless it is the last, shorter one
  // (n is a multiple of 8, so every step is whole)
  const int steps = (int)((n - start < kSegRows ? n - start : kSegRows) / 8);
  // 16-byte loads: 8 bf16 of the plane, 4 ids (start is 64-row aligned,
  // and the host checked n and the bases)
  const uint4* pv = reinterpret_cast<const uint4*>(
      pay + (int64_t)lane * n + start);
  const int4* gv = reinterpret_cast<const int4*>(gid + start);
  uint4 w[kSegRows / 8];
  int4 ids[kSegRows / 4];
#pragma unroll
  for (int c = 0; c < kSegRows / 8; ++c) {
    if (c < steps) w[c] = pv[c];
  }
#pragma unroll
  for (int c = 0; c < kSegRows / 8; ++c) {
    if (c < steps) {
      ids[2 * c] = gv[2 * c];
      ids[2 * c + 1] = gv[2 * c + 1];
    }
  }
  Run run{ids[0].x, 0.0f};
#pragma unroll
  for (int c = 0; c < kSegRows / 8; ++c) {
    if (c >= steps) break;
    const uint32_t h[4] = {w[c].x, w[c].y, w[c].z, w[c].w};
    const int4 a = ids[2 * c];
    const int4 b = ids[2 * c + 1];
    const int g[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t bits = (h[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
      step(run, g[j], bf16_to_f32(bits), out, lane, P, outcap);
    }
  }
  flush(out, run, lane, P, outcap);
}

}  // namespace

// gid: int32[n]; payload: bf16[P, n] (1 <= P <= 256); out: f32[outcap, P],
// zero-filled. n must be a multiple of 8 and gid and payload 16-byte
// aligned (every caller passes fresh tensors whose length is a multiple of
// 1024). Returns the cudaError_t of the launch.
extern "C" int segsum_launch(const void* gid, const void* payload, void* out,
                             long long n, int P, long long outcap,
                             void* stream) {
  if (n <= 0) return 0;
  if (P < 1 || P > kThreads || n % 8 != 0 || (uintptr_t)gid % 16 != 0
      || (uintptr_t)payload % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int segs = kThreads / P;
  const long long rows_per_block = (long long)segs * kSegRows;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  segsum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)gid, (const uint16_t*)payload, (float*)out,
      (int64_t)n, P, (int64_t)outcap, segs);
  return (int)cudaGetLastError();
}
