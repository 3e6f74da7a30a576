// K3 and K4: the fused encoder and decoder levels of the single-frame
// streaming step, for Hopper, sm_90a.
//
// Replaces: cleanumamba_tpu/ops/pallas/stream_fused.py
//   K3 fused_encoder_level (def :297, pallas_call :318, body _enc_kernel :280):
//      h   = relu(win @ cw + cb)                       rounded to the compute dtype
//      out = (h @ mwa + mba) * act(h @ mwb + mbb)
//   K4 fused_decoder_level (def :365, pallas_call :399, body _dec_kernel :326):
//      g   = GLU((x + skip) @ mw + mb)                 rounded to the compute dtype
//      lo  = g @ cwlo, hi = g @ cwhi                   (ConvTranspose, K = 2S taps)
//      out[0] = lo[0] + cb + prev, out[t] = lo[t] + hi[t-1] + cb, optional ReLU
//      tail   = hi[T-1]                                (stored without the bias)
//   Weights are fp32 or bf16 (the pack's compute dtype); activations enter in
//   their own dtype (fp32 or bf16); products accumulate in fp32.
//
// What bounds them on this card: at block 1 a level sees T = 1..128 tokens
// (B*T rows) against weights of up to 3072x768 + 768x1536 (encoder) and
// 768x1536 + 2x768x1536 (decoder).  Each weight is used by at most a few
// rows, so the levels are matrix-vector products: bound by reading the
// weights from device memory (and, at the small levels, by launch latency),
// not by arithmetic.
//
// Design: every product is one tiled kernel shape.  A block of 256 threads
// owns kCols=32 output columns and kRows=8 rows; its 8 warps split the
// contraction dimension, each warp reading one 32-column row of a weight
// matrix per step (coalesced), the rows' inputs broadcast from shared memory
// (staged kChunk at a time, already rounded to the compute dtype as the TPU
// kernel casts them), and the 8 partial sums are reduced through shared
// memory before the epilogue.  Splitting the contraction over warps, not over
// blocks, keeps every sum in one block (no atomics, one order) while a
// 768-wide output still spreads over 24-48 blocks.  Each level is two
// launches on one stream: (1) the first product with its epilogue into a
// scratch buffer, (2) the second product(s).  The decoder's second launch
// computes both tap GEMMs for "virtual rows" (b, t) with t = 0..T: the lo
// taps read g[b, t], the hi taps read g[b, t-1], so the overlap-add and the
// tail (t = T) come out of one epilogue with no cross-block dependency.
// Output layouts match stream_fused.py's packs: the decoder's grouped
// (B, T, S*Cout) with column order k*Cout + cout.  No library GEMM is used.
#include "common.cuh"

namespace {

constexpr int kCols = 32;    // output columns per block: one warp wide
constexpr int kSlices = 8;   // warps splitting the contraction dimension
constexpr int kThreads = kCols * kSlices;
constexpr int kRows = 8;     // rows (tokens) per block
constexpr int kChunk = 128;  // contraction elements staged per pass
static_assert(kRows * kCols == kThreads, "one epilogue output per thread");

enum Act { kSigmoid = 0, kReLU = 1, kSiLU = 2, kGELU = 3 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kSigmoid: return 1.f / (1.f + expf(-x));
    case kReLU: return fmaxf(x, 0.f);
    case kSiLU: return x / (1.f + expf(-x));
    default: {  // GELU, tanh approximation (jax.nn.gelu's default)
      const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// acc[w][i] += sum_k xs[set(w)][i][k] * W[w][k, n] for k in [0, K), W row-major
// (K, N).  NI == 1: every weight reads input set 0; NI == NW: weight w reads
// set w.  `stage(k0, kn)` fills xs[..][i][0..kChunk) for contraction
// indices k0..k0+kn (zeros past kn and past the last row).
template <typename TW, int NI, int NW, typename Stage>
__device__ __forceinline__ void tile_gemm(const TW* const (&W)[NW], int K, int N, int n,
                                          Stage&& stage, float (&xs)[NI][kRows][kChunk],
                                          float (&acc)[NW][kRows]) {
  const int slice = threadIdx.x / kCols;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = min(kChunk, K - k0);
    __syncthreads();  // the previous pass has finished with xs
    stage(k0, kn);
    __syncthreads();
    if (n < N) {
      for (int k = slice; k < kn; k += kSlices) {
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const float wv = to_f32(W[w][(size_t)(k0 + k) * N + n]);
          const int set = NI == 1 ? 0 : w;
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[w][i] = fmaf(xs[set][i][k], wv, acc[w][i]);
        }
      }
    }
  }
}

// Sum the kSlices partial sums; thread t gets row t / kCols, column t % kCols.
template <int NW>
__device__ __forceinline__ void reduce_slices(const float (&acc)[NW][kRows],
                                              float (&red)[NW][kSlices][kRows][kCols],
                                              float (&out)[NW]) {
  const int slice = threadIdx.x / kCols, col = threadIdx.x % kCols;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < kRows; ++i) red[w][slice][i][col] = acc[w][i];
  __syncthreads();
  const int row = threadIdx.x / kCols;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    float s = 0.f;
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) s += red[w][sl][row][col];
    out[w] = s;
  }
}

// out (M, N) = relu(x (M, K) @ w (K, N) + bias), x rounded to TW first.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
conv_relu_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                 const float* __restrict__ bias, TW* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[1][kRows][kChunk];
  __shared__ float red[1][kSlices][kRows][kCols];
  const int m0 = blockIdx.y * kRows;
  const int n = blockIdx.x * kCols + threadIdx.x % kCols;
  float acc[1][kRows] = {};
  const TW* const W[1] = {w};
  tile_gemm<TW, 1, 1>(W, K, N, n, [&](int k0, int kn) {
    for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
      const int i = e / kChunk, k = e % kChunk, m = m0 + i;
      xs[0][i][k] = (m < M && k < kn) ? round_to<TW>(to_f32(x[(size_t)m * K + k0 + k])) : 0.f;
    }
  }, xs, acc);
  float v[1];
  reduce_slices<1>(acc, red, v);
  const int m = m0 + threadIdx.x / kCols;
  if (m < M && n < N) out[(size_t)m * N + n] = from_f32<TW>(fmaxf(v[0] + bias[n], 0.f));
}

// out (M, N) = (xin @ wa + ba) * act(xin @ wb + bb), xin = TW(x + skip) (skip
// may be null), the GLU with its 1x1 mix split into value and gate halves.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
glu_kernel(const TX* __restrict__ x, const TX* __restrict__ skip, const TW* __restrict__ wa,
           const TW* __restrict__ wb, const float* __restrict__ ba,
           const float* __restrict__ bb, int act, TW* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[1][kRows][kChunk];
  __shared__ float red[2][kSlices][kRows][kCols];
  const int m0 = blockIdx.y * kRows;
  const int n = blockIdx.x * kCols + threadIdx.x % kCols;
  float acc[2][kRows] = {};
  const TW* const W[2] = {wa, wb};
  tile_gemm<TW, 1, 2>(W, K, N, n, [&](int k0, int kn) {
    for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
      const int i = e / kChunk, k = e % kChunk, m = m0 + i;
      float v = 0.f;
      if (m < M && k < kn) {
        const size_t off = (size_t)m * K + k0 + k;
        v = to_f32(x[off]);
        if (skip != nullptr) v += to_f32(skip[off]);
        v = round_to<TW>(v);
      }
      xs[0][i][k] = v;
    }
  }, xs, acc);
  float v[2];
  reduce_slices<2>(acc, red, v);
  const int m = m0 + threadIdx.x / kCols;
  if (m < M && n < N)
    out[(size_t)m * N + n] = from_f32<TW>((v[0] + ba[n]) * activate(v[1] + bb[n], act));
}

// The transposed conv (K = 2S) with its overlap-add, over virtual rows
// r = b * (T + 1) + t, t = 0..T.  g (Bsz*T, K) holds the GLU output; wlo, whi
// (K, N) the lo/hi taps with N = S*Cout.  For t < T:
//   out[b, t] = g[b, t] @ wlo + g[b, t-1] @ whi + cb (+ prev[b] at t = 0),
// then ReLU if asked; for t = T: tail[b] = g[b, T-1] @ whi (no bias).
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
convt_kernel(const TW* __restrict__ g, const TW* __restrict__ wlo, const TW* __restrict__ whi,
             const float* __restrict__ cb, const TX* __restrict__ prev, int relu,
             TW* __restrict__ out, TW* __restrict__ tail, int Bsz, int T, int K, int N) {
  __shared__ float xs[2][kRows][kChunk];
  __shared__ float red[2][kSlices][kRows][kCols];
  const int Mv = Bsz * (T + 1);
  const int r0 = blockIdx.y * kRows;
  const int n = blockIdx.x * kCols + threadIdx.x % kCols;
  float acc[2][kRows] = {};
  const TW* const W[2] = {wlo, whi};
  tile_gemm<TW, 2, 2>(W, K, N, n, [&](int k0, int kn) {
    for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
      const int i = e / kChunk, k = e % kChunk, r = r0 + i;
      const int b = r / (T + 1), t = r % (T + 1);
      const bool ok = r < Mv && k < kn;
      const size_t row = (size_t)b * T + t;  // g row of (b, t)
      xs[0][i][k] = (ok && t < T) ? to_f32(g[row * K + k0 + k]) : 0.f;
      xs[1][i][k] = (ok && t >= 1) ? to_f32(g[(row - 1) * K + k0 + k]) : 0.f;
    }
  }, xs, acc);
  float v[2];
  reduce_slices<2>(acc, red, v);
  const int r = r0 + threadIdx.x / kCols;
  if (r >= Mv || n >= N) return;
  const int b = r / (T + 1), t = r % (T + 1);
  if (t == T) {
    tail[(size_t)b * N + n] = from_f32<TW>(v[1]);
    return;
  }
  float o = v[0] + v[1] + cb[n];
  if (t == 0 && prev != nullptr) o += to_f32(prev[(size_t)b * N + n]);
  if (relu) o = fmaxf(o, 0.f);
  out[((size_t)b * T + t) * N + n] = from_f32<TW>(o);
}

}  // namespace

// K3.  tx: dtype code of win; tw: of the packed weights, h and out.
// win (M, KC); cw (KC, C); cb (C); mwa, mwb (C, N2); mba, mbb (N2);
// h (M, C) scratch; out (M, N2).  All contiguous.  Returns cudaGetLastError().
extern "C" int fused_encoder_level(int tx, int tw, const void* win, const void* cw,
                                   const void* cb, const void* mwa, const void* mwb,
                                   const void* mba, const void* mbb, int act, void* h,
                                   void* out, int M, int KC, int C, int N2, void* stream) {
  if (M == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(tx, TX, DISPATCH_DTYPE(tw, TW, {
    conv_relu_kernel<TX, TW><<<dim3(cdiv(C, kCols), cdiv(M, kRows)), kThreads, 0, st>>>(
        static_cast<const TX*>(win), static_cast<const TW*>(cw),
        static_cast<const float*>(cb), static_cast<TW*>(h), M, KC, C);
    glu_kernel<TW, TW><<<dim3(cdiv(N2, kCols), cdiv(M, kRows)), kThreads, 0, st>>>(
        static_cast<const TW*>(h), nullptr, static_cast<const TW*>(mwa),
        static_cast<const TW*>(mwb), static_cast<const float*>(mba),
        static_cast<const float*>(mbb), act, static_cast<TW*>(out), M, C, N2);
  }))
  return static_cast<int>(cudaGetLastError());
}

// K4.  tx: dtype code of x, skip and prev; tw: of the packed weights, g, out
// and tail.  x, skip (Bsz*T, Cx); mwa, mwb (Cx, C); mba, mbb (C); g (Bsz*T, C)
// scratch; cwlo, cwhi (C, SC); cb (SC); prev (Bsz, SC) or null; out
// (Bsz, T, SC); tail (Bsz, SC).  All contiguous.  Returns cudaGetLastError().
extern "C" int fused_decoder_level(int tx, int tw, const void* x, const void* skip,
                                   const void* mwa, const void* mwb, const void* mba,
                                   const void* mbb, int act, void* g, const void* cwlo,
                                   const void* cwhi, const void* cb, const void* prev,
                                   int relu, void* out, void* tail, int Bsz, int T, int Cx,
                                   int C, int SC, void* stream) {
  if (Bsz == 0 || T == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = Bsz * T;
  DISPATCH_DTYPE(tx, TX, DISPATCH_DTYPE(tw, TW, {
    glu_kernel<TX, TW><<<dim3(cdiv(C, kCols), cdiv(M, kRows)), kThreads, 0, st>>>(
        static_cast<const TX*>(x), static_cast<const TX*>(skip), static_cast<const TW*>(mwa),
        static_cast<const TW*>(mwb), static_cast<const float*>(mba),
        static_cast<const float*>(mbb), act, static_cast<TW*>(g), M, Cx, C);
    convt_kernel<TX, TW><<<dim3(cdiv(SC, kCols), cdiv(Bsz * (T + 1), kRows)), kThreads, 0,
                           st>>>(
        static_cast<const TW*>(g), static_cast<const TW*>(cwlo), static_cast<const TW*>(cwhi),
        static_cast<const float*>(cb), static_cast<const TX*>(prev), relu,
        static_cast<TW*>(out), static_cast<TW*>(tail), Bsz, T, C, SC);
  }))
  return static_cast<int>(cudaGetLastError());
}
