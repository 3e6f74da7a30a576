// K1: forward selective scan (Mamba-1 SSM recurrence) for Hopper, sm_90a.
//
// Replaces: cleanumamba_tpu/ops/pallas/selective_scan.py::pallas_selective_scan
//   (def :169, pallas_call :222, kernel body _scan_kernel :116).  Forward
//   only; the chunk-boundary states that only the backward needs are not
//   produced.
//
//   h_t = exp(dt_t * A) (*) h_{t-1} + (dt_t * u_t) * B_t     (fp32 state)
//   y_t = <h_t, C_t> + D * u_t
//
// What bounds it on this card: each step of each (batch, channel) does one
// expf and two FMAs per state element and a reduction over d_state; the
// bytes are small (u, dt, y of B*L*d_inner and B, C of B*L*d_state).  At the
// serving shapes (B=1, d_inner=2048, d_state=64, L=16 per streaming block
// and ~63 per second offline) the time loop is sequential, so the kernel is
// bound by the latency of that loop and by how many SMs get work.
//
// Design: no time-parallel pair scan (the TPU kernel's _pair_scan is a
// Mosaic workaround for per-step loops); each thread group walks time with
// its state in registers.  To put work on all 132 SMs at batch 1, d_state is
// split over kLanes=16 threads per channel (NPT state elements each, chosen
// at launch from d_state) and y's reduction over d_state is a 4-step warp
// shuffle: d_inner=2048 gives 128 blocks of 256 threads.  B_t and C_t, shared
// by every channel of a block, are staged in shared memory kSteps at a time,
// together with u and dt (loaded coalesced along d_inner), and y is written
// back coalesced from shared memory.  Ragged d_inner and d_state are masked
// (A=0, h=0, B=C=0 rows are inert).  u, B and C are read in their own dtype
// (fp32 or bf16, a template), dt, A, D, h0 and h_last are fp32, and y is
// written in u's dtype.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                    // threads per channel (split d_state)
constexpr int kChannels = kThreads / kLanes;  // channels per block
constexpr int kSteps = 16;                    // time steps staged per pass

template <typename T, int NPT>
__global__ void __launch_bounds__(kThreads)
scan_fwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_last, int L, int Di, int Ds) {
  constexpr int kSP = kLanes * NPT;  // d_state padded to the lanes
  __shared__ float sB[kSteps][kSP];
  __shared__ float sC[kSteps][kSP];
  __shared__ float su[kSteps][kChannels];
  __shared__ float sdt[kSteps][kChannels];
  __shared__ float sy[kSteps][kChannels];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int lane = threadIdx.x % kLanes;
  const int cl = threadIdx.x / kLanes;
  const int c = c0 + cl;
  const bool cvalid = c < Di;

  // state element s = lane + j * kLanes: the 16 lanes of a channel read 16
  // consecutive floats of sB/sC (no bank conflicts)
  float h[NPT], Ac[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int s = lane + j * kLanes;
    const bool ok = cvalid && s < Ds;
    Ac[j] = ok ? A[(size_t)c * Ds + s] : 0.f;
    h[j] = ok ? h0[((size_t)b * Di + c) * Ds + s] : 0.f;
  }
  const float Dc = cvalid ? D[c] : 0.f;

  for (int t0 = 0; t0 < L; t0 += kSteps) {
    const int nt = min(kSteps, L - t0);
    __syncthreads();  // the previous pass has finished with the stage
    for (int i = threadIdx.x; i < kSteps * kSP; i += kThreads) {
      const int t = i / kSP, s = i % kSP;
      const bool ok = t < nt && s < Ds;
      const size_t off = ((size_t)b * L + t0 + t) * Ds + s;
      sB[t][s] = ok ? to_f32(Bm[off]) : 0.f;
      sC[t][s] = ok ? to_f32(Cm[off]) : 0.f;
    }
    for (int i = threadIdx.x; i < kSteps * kChannels; i += kThreads) {
      const int t = i / kChannels, k = i % kChannels;
      const bool ok = t < nt && c0 + k < Di;
      const size_t off = ((size_t)b * L + t0 + t) * Di + c0 + k;
      su[t][k] = ok ? to_f32(u[off]) : 0.f;
      sdt[t][k] = ok ? dt[off] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float dtv = sdt[t][cl], uv = su[t][cl];
      const float du = dtv * uv;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int s = lane + j * kLanes;
        h[j] = expf(dtv * Ac[j]) * h[j] + du * sB[t][s];
        acc += h[j] * sC[t][s];
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off, kLanes);
      if (lane == 0) sy[t][cl] = acc + Dc * uv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nt * kChannels; i += kThreads) {
      const int t = i / kChannels, k = i % kChannels;
      if (c0 + k < Di) y[((size_t)b * L + t0 + t) * Di + c0 + k] = from_f32<T>(sy[t][k]);
    }
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int s = lane + j * kLanes;
    if (cvalid && s < Ds) h_last[((size_t)b * Di + c) * Ds + s] = h[j];
  }
}

template <typename T, int NPT>
void launch(const void* u, const void* dt, const void* A, const void* Bm, const void* Cm,
            const void* D, const void* h0, void* y, void* h_last, int Bsz, int L, int Di,
            int Ds, cudaStream_t stream) {
  const dim3 grid((Di + kChannels - 1) / kChannels, Bsz);
  scan_fwd_kernel<T, NPT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(h_last), L, Di,
      Ds);
}

}  // namespace

// dtype: dtype code of u, B, C and y (kF32 or kBF16).  Shapes: u, dt, y
// (Bsz, L, Di); A (Di, Ds); B, C (Bsz, L, Ds); D (Di); h0, h_last
// (Bsz, Di, Ds); all contiguous.  1 <= Ds <= 256.  Returns cudaGetLastError().
extern "C" int selective_scan_fwd(int dtype, const void* u, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, const void* D,
                                  const void* h0, void* y, void* h_last, int Bsz, int L,
                                  int Di, int Ds, void* stream) {
  if (Ds < 1 || Ds > 16 * kLanes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dtype, T, {
    if (Ds <= kLanes) launch<T, 1>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bsz, L, Di, Ds, st);
    else if (Ds <= 2 * kLanes) launch<T, 2>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bsz, L, Di, Ds, st);
    else if (Ds <= 4 * kLanes) launch<T, 4>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bsz, L, Di, Ds, st);
    else if (Ds <= 8 * kLanes) launch<T, 8>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bsz, L, Di, Ds, st);
    else launch<T, 16>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bsz, L, Di, Ds, st);
  })
  return static_cast<int>(cudaGetLastError());
}
