// K6: one token of causal multi-head attention over per-row KV rings (the
// mha bottleneck's streaming step, ``models/bottleneck_mha.py``).  It
// replaces no TPU kernel: the JAX package's step is a whole-ring `where`
// and softmax in XLA with one position for the batch, which cannot serve
// sessions of different ages.
//
// Row b of the batch is a session.  Its ring holds the keys and values of
// its last W tokens: slot m of the ring lies at ring + b * ldb + m * d, and
// pos[b] counts the tokens the row has written so far.  For each row the
// kernel writes this token's k and v at slot pos mod W and attends over the
// row's valid slots, min(pos + 1, W) of them, in fp32: scores q.k /
// sqrt(d_k), a softmax with its max subtracted, and the weighted sum of the
// values.  pos is not advanced here (the caller adds one to it once every
// layer has run).  A multiplexer's tick steps the rows it gathered, a copy
// of its pool's (serve.py), so a padding row's write is never kept.
//
// What bounds it: the bytes of the rows' windows (a full window of one
// head is 625 x 64 x 4 B of keys and as much of values), read once; at one
// row a tick that is too little work to fill the card, so the design
// is for latency.  Grid (kSplit, heads, rows), one thread block cluster of
// kSplit blocks a (row, head): block r takes slots [r * chunk, (r + 1) *
// chunk) of the valid window, one slot to each group of dk / 16 threads, so
// that every key and value of the block, and q, is requested in one round of
// 16-byte loads; the scores are summed across the group by shuffles, the block's
// max and sum of exps by a block reduction, its exp-weighted values by
// shuffles across the warp's slots; block 0 combines the cluster's parts
// from their shared memory.  The slot this token takes is read from k and
// v, not from the ring, so no block reads what another writes.

#include "common.cuh"

namespace {

constexpr int kSplit = 8;  // blocks a cluster: the window is split over them
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

// n values of T from p (16-byte aligned) into fp32, as 16-byte loads.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(N % kPer == 0, "a thread's share of a row is whole 16-byte words");
#pragma unroll
  for (int j = 0; j < N / kPer; ++j) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[j];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[j * kPer + i] = to_f32(e[i]);
  }
}

template <typename T, int DK>
__global__ void __launch_bounds__(kMaxThreads) kv_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    T* __restrict__ k_ring, T* __restrict__ v_ring, long long ldb, const int* __restrict__ pos,
    T* __restrict__ out, int W, int d) {
  constexpr int VEC = DK < 16 ? DK : 16;  // a thread's columns of a slot
  constexpr int TPP = DK / VEC;  // threads a slot
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32, lane = tid % 32;
  const size_t col = (size_t)b * d + (size_t)h * DK;
  const int p = pos[b];
  const int n_valid = min(p + 1, W), cur = p % W;
  const int chunk = (W + kSplit - 1) / kSplit;
  const int m0 = min(n_valid, rank * chunk), n = min(n_valid, m0 + chunk) - m0;
  const size_t row = (size_t)b * ldb + (size_t)h * DK;

  __shared__ float red[2][kMaxWarps];
  __shared__ float wsum[kMaxWarps][DK];
  __shared__ float mine[2 + DK];  // what block 0 reads of every block: [max, sum, values]

  if (cur >= m0 && cur < m0 + n) {  // this block's range holds the token's slot
    for (int c = tid; c < DK; c += nt) {
      k_ring[row + (size_t)cur * d + c] = k_new[col + c];
      v_ring[row + (size_t)cur * d + c] = v_new[col + c];
    }
  }

  // one slot to each group of TPP threads: its key and value, and its share
  // of q, in one round of loads
  const int m = tid / TPP, part = tid % TPP;
  const bool have = m < n;
  float kv[VEC], vv[VEC], qv[VEC];
  float dot = 0.f;
  if (have) {
    const int slot = m0 + m;
    const T* kr = slot == cur ? k_new + col : k_ring + row + (size_t)slot * d;
    const T* vr = slot == cur ? v_new + col : v_ring + row + (size_t)slot * d;
    load_row<T, VEC>(q + col + part * VEC, qv);
    load_row<T, VEC>(kr + part * VEC, kv);
    load_row<T, VEC>(vr + part * VEC, vv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dot = fmaf(kv[i], qv[i], dot);
  }
#pragma unroll
  for (int o = TPP / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  const float s = have ? dot / sqrtf((float)DK) : -INFINITY;

  // the block's max and sum of exps
  float mx = s;
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[0][warp] = mx;
  __syncthreads();
  mx = red[0][0];
  for (int w = 1; w < (nt + 31) / 32; ++w) mx = fmaxf(mx, red[0][w]);
  const float e = have ? expf(s - mx) : 0.f;
  float sum = part == 0 ? e : 0.f;
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) red[1][warp] = sum;

  // the exp-weighted values, summed over the warp's slots by shuffles
#pragma unroll
  for (int i = 0; i < VEC; ++i) vv[i] = have ? e * vv[i] : 0.f;
#pragma unroll
  for (int o = TPP; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) vv[i] += __shfl_xor_sync(0xffffffffu, vv[i], o);
  }
  if (lane < TPP) {  // lane == part here
#pragma unroll
    for (int i = 0; i < VEC; ++i) wsum[warp][lane * VEC + i] = vv[i];
  }
  __syncthreads();
  const int warps = (nt + 31) / 32;
  for (int c = tid; c < DK; c += nt) {
    float a = 0.f;
    for (int w = 0; w < warps; ++w) a += wsum[w][c];
    mine[2 + c] = a;
  }
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < warps; ++w) total += red[1][w];
    mine[0] = n > 0 ? mx : -INFINITY;
    mine[1] = total;
  }
  cluster_sync();  // every block's part is written
  if (rank == 0) {
    for (int c = tid; c < DK; c += nt) {
      float M = -INFINITY;
      for (int r = 0; r < kSplit; ++r) M = fmaxf(M, load_cluster(&mine[0], r));
      float l = 0.f, a = 0.f;
      for (int r = 0; r < kSplit; ++r) {
        const float mr = load_cluster(&mine[0], r);
        if (mr == -INFINITY) continue;  // a block with no slot
        const float w = expf(mr - M);
        l = fmaf(w, load_cluster(&mine[1], r), l);
        a = fmaf(w, load_cluster(&mine[2 + c], r), a);
      }
      out[col + c] = from_f32<T>(a / l);
    }
  }
  cluster_sync();  // block 0 has read every block's part
}

template <typename T, int DK>
cudaError_t launch(const void* q, const void* k, const void* v, void* k_ring, void* v_ring,
                   long long ldb, const int* pos, void* out, int B, int H, int W, int d,
                   cudaStream_t st) {
  constexpr int TPP = DK / (DK < 16 ? DK : 16);
  const int chunk = (W + kSplit - 1) / kSplit;
  const int threads = (chunk * TPP + 31) / 32 * 32;
  if (threads > kMaxThreads) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplit, H, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kv_attention_kernel<T, DK>, static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v),
                            static_cast<T*>(k_ring), static_cast<T*>(v_ring), ldb, pos,
                            static_cast<T*>(out), W, d);
}

}  // namespace

// K6.  dt: dtype code of q, k, v, the rings and out.  q, k, v, out: (B, d)
// contiguous; the rings: B rows of W slots of d values, row stride ldb;
// pos: (B,) int32.  d = H * dk, dk in {8, 16, 64} (the
// head widths of the models that stream mha: CleanUNet and E8's widths 64,
// the released small geometry 8, the test configurations 8 and 16);
// every row and slot 16-byte aligned; ceil(W / 8) * dk / min(dk, 16) <= 1024.
extern "C" int kv_attention(int dt, const void* q, const void* k, const void* v, void* k_ring,
                            void* v_ring, long long ldb, const void* pos, void* out, int B,
                            int H, int W, int d, void* stream) {
  if (B == 0) return 0;
  const int dk = d / H;
  if (H * dk != d || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ps = static_cast<const int*>(pos);
  cudaError_t e = cudaErrorInvalidValue;
  DISPATCH_DTYPE(dt, T, {
    switch (dk) {
      case 8: e = launch<T, 8>(q, k, v, k_ring, v_ring, ldb, ps, out, B, H, W, d, st); break;
      case 16: e = launch<T, 16>(q, k, v, k_ring, v_ring, ldb, ps, out, B, H, W, d, st); break;
      case 64: e = launch<T, 64>(q, k, v, k_ring, v_ring, ldb, ps, out, B, H, W, d, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  })
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
