// Per-id sums of P payload lanes over sorted group ids.
//
// Replaces: spark_rapids_tpu/ops/pallas_segsum.py segsum_window (body
// _kernel_factory), the group-by sum kernel of the hash aggregate.
//
// Inputs: gid int32[N] sorted ascending, payload bf16[P, N] lane-major
// (one contiguous plane per lane, as the caller builds them), out
// f32[outcap, P] zero-filled by the caller. out[g, p] is the sum of
// payload[p, r] over the rows r with gid[r] == g; ids outside [0, outcap)
// are dropped (dead rows sort last and may carry id outcap). The ids must
// be sorted: a run of equal ids that lies inside a tile is written with a
// plain store, so an id may not occur in two places.
//
// What bounds it on an H100: memory. A row reads 4 bytes of id and 2*P
// bytes of payload, and a slot of the output is 4*P bytes; at the q72shfl
// chunk shape (N = 2^23, P = 10, outcap = 2^18) that is 212 MB, 0.063 ms
// at 3.35 TB/s. The work is one add per 2-byte value, about 0.5
// operations a byte against the card's bf16 ridge of ~295, so the TPU
// kernel's one-hot matmul has no use here: tensor cores would only add
// work to a kernel that waits on memory.
//
// Design. A block takes a tile of segs x 64 rows (1,472-1,792 rows at
// P = 9-11) with exactly segs x P threads, segs = min(32, floor(256 / P))
// or fewer where the tile would not fit in 46 KB of shared memory, so no
// thread idles whatever P is.
// - Ids and lanes: the block copies the tile's ids once and each lane's
//   plane into shared memory with 16-byte cp.async, neighbouring threads
//   on neighbouring bytes. Every lane reads the same staged ids.
// - Runs: thread (segment, lane), lanes fastest, walks its segment's 64
//   rows of its lane from shared memory, comparing ids as it goes, and
//   writes each run that lies inside the segment with one plain store
//   (the P threads of a segment store the P floats of one output row
//   together). It leaves the partial sums of its segment's first and last
//   run in shared memory.
// - Join: after one barrier, one thread a lane walks the tile's segments
//   in order and writes each run that crosses segments once, with a plain
//   store; only the tile's first run (which may have begun in the tile
//   before) and its last (which may go on in the next) take an atomicAdd.
//   So a tile issues at most 2 atomics per lane, however long its groups:
//   a group of 2^23 rows costs one or two a tile and lane, where a walk of
//   64-row segments issued an atomic per segment and lane onto the same
//   few bytes.
// - Tile edges: a run that ends on a tile's last row, or starts on its
//   first, or covers tiles from edge to edge, is summed by atomics from
//   each tile it touches; the output is zero-filled, so the order does not
//   matter.
// - Overlap: the kernel keeps 32 registers and 41 KB of shared memory a
//   block (P = 10), so 5 blocks share an SM and one block's copies run
//   while another reduces; there is no ring inside a block.
// ptxas (sm_90a): 32 registers, no spills, 1 barrier.
//
// Exactness: the lanes hold 8-bit integer digits and groups are bounded by
// 2^16 rows (the caller falls back past that), so every partial and total
// is an integer below 2^24: the f32 sums are exact and neither the order
// of the adds nor that of the atomics can change the result. Zero sums are
// not written. The kernel allocates nothing and runs on the caller's
// stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSegRows = 64;           // rows a thread walks
constexpr int kMaxSegs = 32;           // segments a tile: the join's walk
constexpr int kSmemBytes = 46 * 1024;  // a tile's ids, planes and partials

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void put(float* out, int g, int p, int P,
                                    int64_t outcap, float v, bool atomic) {
  if (v != 0.0f && g >= 0 && (int64_t)g < outcap) {
    float* dst = out + (int64_t)g * P + p;
    if (atomic) {
      atomicAdd(dst, v);
    } else {
      *dst = v;
    }
  }
}

// bytes of a plane in shared memory: padded by 16 so that the threads of
// one segment, which read the same rows of neighbouring planes, fall on
// different banks
__host__ __device__ __forceinline__ int plane_bytes(int rows) {
  return rows * 2 + 16;
}

__host__ __device__ __forceinline__ int smem_bytes(int segs, int P) {
  const int rows = segs * kSegRows;
  return rows * 4 + P * plane_bytes(rows) + segs * P * 8 + segs * 8;
}

__global__ void __launch_bounds__(kMaxThreads)
segsum_kernel(const int32_t* __restrict__ gid,
              const uint16_t* __restrict__ pay, float* __restrict__ out,
              int64_t n, int P, int64_t outcap, int segs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = segs * kSegRows;
  const int pstride = plane_bytes(rows);
  int32_t* ids_s = reinterpret_cast<int32_t*>(smem);
  unsigned char* pay_s = smem + rows * 4;
  float* head_s = reinterpret_cast<float*>(pay_s + P * pstride);
  float* tail_s = head_s + segs * P;
  int* first_s = reinterpret_cast<int*>(tail_s + segs * P);
  int* last_s = first_s + segs;

  const int t = threadIdx.x;
  const int nthreads = blockDim.x;  // segs * P: one (segment, lane) each
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int here = n - row0 < rows ? (int)(n - row0) : rows;  // mult. of 8
  // stage the tile: ids once for every lane, then each plane, 16 bytes a
  // thread, neighbouring threads on neighbouring bytes
  for (int c = t; c < here / 4; c += nthreads) {
    cp_async16(ids_s + 4 * c, gid + row0 + 4 * c);
  }
  const int chunks = here / 8;
  for (int c = t; c < P * chunks; c += nthreads) {
    const int p = c / chunks;
    const int k = c - p * chunks;
    cp_async16(pay_s + p * pstride + 16 * k, pay + (int64_t)p * n + row0
               + 8 * k);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
  __syncthreads();

  // walk: thread (segment, lane), lanes fastest
  const int seg = t / P;
  const int lane = t - seg * P;
  const int nseg = (here + kSegRows - 1) / kSegRows;
  if (seg < nseg) {
    const int r0 = seg * kSegRows;
    const int steps = (here - r0 < kSegRows ? here - r0 : kSegRows) / 8;
    const uint4* pv = reinterpret_cast<const uint4*>(
        pay_s + lane * pstride + 2 * r0);
    const int4* gv = reinterpret_cast<const int4*>(ids_s + r0);
    const int g_first = ids_s[r0];
    int cur = g_first;
    float acc = 0.0f, head = 0.0f;
    bool in_head = true;
    for (int c = 0; c < steps; ++c) {
      const uint4 w = pv[c];
      const int4 a = gv[2 * c];
      const int4 b = gv[2 * c + 1];
      const uint32_t h[4] = {w.x, w.y, w.z, w.w};
      const int g[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (g[j] != cur) {
          if (in_head) {
            head = acc;  // the first run may have begun before the segment
            in_head = false;
          } else {
            put(out, cur, lane, P, outcap, acc, false);  // inside
          }
          cur = g[j];
          acc = 0.0f;
        }
        acc += __uint_as_float((j & 1) ? (h[j >> 1] & 0xFFFF0000u)
                                       : (h[j >> 1] << 16));
      }
    }
    head_s[t] = in_head ? acc : head;  // one run over the whole segment
    tail_s[t] = in_head ? 0.0f : acc;
    if (lane == 0) {
      first_s[seg] = g_first;
      last_s[seg] = cur;
    }
  }
  __syncthreads();
  // join: one thread a lane walks the segments in order and writes each
  // run that crosses segments once. The tile's first run may have begun in
  // the tile before and its last may go on in the next: those two take an
  // atomic, every other run a plain store.
  if (t < P) {
    int key = first_s[0];
    float acc = 0.0f;
    bool first = true;
    for (int s = 0; s < nseg; ++s) {
      const int a = first_s[s];
      const int b = last_s[s];
      if (a != key) {
        put(out, key, t, P, outcap, acc, first);
        first = false;
        key = a;
        acc = 0.0f;
      }
      acc += head_s[s * P + t];
      if (b != a) {  // the first run ends inside segment s
        put(out, key, t, P, outcap, acc, first);
        first = false;
        key = b;
        acc = tail_s[s * P + t];
      }
    }
    put(out, key, t, P, outcap, acc, true);
  }
}

}  // namespace

// gid: int32[n] sorted ascending; payload: bf16[P, n] (1 <= P <= 256);
// out: f32[outcap, P], zero-filled. n must be a multiple of 8 and gid and
// payload 16-byte aligned (every caller passes fresh tensors whose length
// is a multiple of 1024). Returns the cudaError_t of the launch.
extern "C" int segsum_launch(const void* gid, const void* payload, void* out,
                             long long n, int P, long long outcap,
                             void* stream) {
  if (n <= 0) return 0;
  if (P < 1 || P > kMaxThreads || n % 8 != 0 || (uintptr_t)gid % 16 != 0
      || (uintptr_t)payload % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // as many 64-row segments a tile as 256 threads and the shared memory
  // hold, one thread per (segment, lane), and at most kMaxSegs: the join
  // walks a tile's segments one after another
  int segs = kMaxThreads / P < kMaxSegs ? kMaxThreads / P : kMaxSegs;
  while (segs > 1 && smem_bytes(segs, P) > kSmemBytes) --segs;
  const long long rows = (long long)segs * kSegRows;
  const long long blocks = (n + rows - 1) / rows;
  segsum_kernel<<<(unsigned)blocks, segs * P, smem_bytes(segs, P),
                  (cudaStream_t)stream>>>(
      (const int32_t*)gid, (const uint16_t*)payload, (float*)out,
      (int64_t)n, P, (int64_t)outcap, segs);
  return (int)cudaGetLastError();
}
