// K7: rows of many tensors copied in one launch.  A multiplexer's tick steps
// a few rows of a batched state of some 25 leaves (``serve.py``): it gathers
// those rows of every leaf from the pool and writes the stepped rows back.
// One ``index_select`` or ``index_copy_`` a leaf is some 25 launches each way,
// about 2 us apiece on the card for a row or two: more than the bytes take.
// It replaces no TPU kernel: the JAX package's tick runs every row.
//
// A segment is one tensor pair: row r of a tensor starts ``r * stride`` bytes
// after its base, and each row is ``bytes`` contiguous bytes (the leaf's
// trailing dimensions, contiguous).  Every pool tensor (the sources of a
// gather, the destinations of a scatter) has ``pool_rows`` rows.  For
// i < count, with r = rows[i]:
//   gather:  row i of each destination = row (r >= 0 ? r : ~r) of its source;
//   scatter: row r of each destination = row i of its source, where r >= 0.
// A row outside the pool is skipped, so no launch reads or writes outside a
// tensor.  Grid (chunks, segments, count): a block copies chunks of a row in
// 16-byte words where the row's two ends and its length allow, else in 4-byte
// words, else in bytes; the chunks of a long row are spread over gridDim.x
// blocks.  The table of segments is a kernel parameter, so a CUDA graph that
// captured the launch keeps it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSegments = 96;  // 96 x 40 B of parameters: within the 4 KiB of a launch
constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;  // 16-byte words a thread copies in a chunk
constexpr long long kChunk = static_cast<long long>(kThreads) * kWordsPerThread * 16;
constexpr int kMaxChunkBlocks = 64;

struct Segment {
  const char* src;
  char* dst;
  long long src_stride, dst_stride, bytes;
};

struct Segments {
  Segment s[kMaxSegments];
};

template <typename W>
__device__ __forceinline__ void copy_words(const char* __restrict__ src, char* __restrict__ dst,
                                           long long bytes) {
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  const long long n = bytes / static_cast<long long>(sizeof(W));
  const long long words_per_chunk = kChunk / static_cast<long long>(sizeof(W));
  for (long long c = blockIdx.x * words_per_chunk; c < n;
       c += static_cast<long long>(gridDim.x) * words_per_chunk) {
    const long long end = c + words_per_chunk < n ? c + words_per_chunk : n;
    for (long long j = c + threadIdx.x; j < end; j += kThreads) d[j] = s[j];
  }
}

__global__ void __launch_bounds__(kThreads) row_copy_kernel(
    const Segments segs, const long long* __restrict__ rows, long long pool_rows, int scatter) {
  const long long i = blockIdx.z;
  long long r = rows[i];
  if (scatter && r < 0) return;
  if (r < 0) r = ~r;
  if (r >= pool_rows) return;
  const Segment g = segs.s[blockIdx.y];
  const char* src = g.src + (scatter ? i : r) * g.src_stride;
  char* dst = g.dst + (scatter ? r : i) * g.dst_stride;
  const uintptr_t ends = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)
                         | static_cast<uintptr_t>(g.bytes);
  if (ends % 16 == 0) {
    copy_words<uint4>(src, dst, g.bytes);
  } else if (ends % 4 == 0) {
    copy_words<uint32_t>(src, dst, g.bytes);
  } else {
    copy_words<char>(src, dst, g.bytes);
  }
}

}  // namespace

// n <= kMaxSegments segments (src[k], dst[k], their row strides and a row's
// bytes), ``count`` int64 row indices on the device, the pool's rows, and
// whether to scatter (else gather), on stream.  Returns a CUDA error code
// (0 on success).
extern "C" int row_copy(int n, const void* const* src, void* const* dst,
                        const long long* src_stride, const long long* dst_stride,
                        const long long* bytes, const void* rows, int count, long long pool_rows,
                        int scatter, void* stream) {
  if (n < 0 || n > kMaxSegments || count < 0 || count > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Segments segs;
  long long most = 0;
  for (int k = 0; k < n; ++k) {
    segs.s[k] = {static_cast<const char*>(src[k]), static_cast<char*>(dst[k]), src_stride[k],
                 dst_stride[k], bytes[k]};
    if (bytes[k] > most) most = bytes[k];
  }
  if (n == 0 || count == 0 || most == 0) return 0;
  const long long chunks = (most + kChunk - 1) / kChunk;
  const dim3 grid(static_cast<unsigned>(chunks < kMaxChunkBlocks ? chunks : kMaxChunkBlocks), n,
                  count);
  row_copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      segs, static_cast<const long long*>(rows), pool_rows, scatter);
  return static_cast<int>(cudaGetLastError());
}
