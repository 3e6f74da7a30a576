// K1: forward selective scan (Mamba-1 SSM recurrence) for Hopper, sm_90a,
// and K2: its backward (the adjoint scan).
//
// K1 replaces: cleanumamba_tpu/ops/pallas/selective_scan.py::pallas_selective_scan
//   (def :169, pallas_call :222, kernel body _scan_kernel :116), including its
//   optional output of each chunk's incoming state (return_boundaries).
// K2 replaces: cleanumamba_tpu/ops/pallas/selective_scan.py::
//   pallas_selective_scan_bwd (def :341, pallas_call :388, kernel body
//   _scan_bwd_kernel :257), the backward of the selective_scan_auto VJP.
//
//   h_t = exp(dt_t * A) (*) h_{t-1} + (dt_t * u_t) * B_t     (fp32 state)
//   y_t = <h_t, C_t> + D * u_t
//
// K1.  What bounds it on this card: each step of each (batch, channel) does
// one expf and two FMAs per state element and a reduction over d_state; the
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
// written in u's dtype.  For training, K1 also writes the state entering
// every chunk of `chunk` steps (a multiple of kSteps, so the write falls
// between two staging passes) to h_starts (B, n_chunks, d_inner, d_state);
// with h_starts = nullptr the serving launch is unchanged.
//
// K2.  It computes gu, gdt, gA, gB, gC, gD and gh0 from gy, gh_last and
// K1's h_starts.  With lambda_t = dL/dh_t:
//   lambda_t = gy_t C_t + a_{t+1} lambda_{t+1}     (a_L lambda_L := gh_last)
//   gu_t  = dt_t <lambda_t, B_t> + D gy_t
//   gdt_t = <lambda_t h_{t-1} a_t, A> + u_t <lambda_t, B_t>
//   gB_t  = sum_i lambda_t dt_t u_t,  gC_t = sum_i h_t gy_t     (over d_inner)
//   gA    = sum_{b,t} lambda_t h_{t-1} a_t dt_t,  gD = sum_{b,t} gy_t u_t
//   gh0   = a_0 lambda_0
// What bounds it: the same sequential time loop as K1 walked twice per chunk
// (h recomputed forward, then the adjoint walked back), plus the reductions
// over d_inner for gB/gC, which cross blocks.  Design: the same (channel
// group, batch) grid and 16-lane split of d_state as K1.  Chunks are walked
// right to left with the carry a_{t+1} lambda_{t+1} in registers; in each
// chunk h is recomputed from h_starts and every h_{t-1} is kept in shared
// memory (chunk x NPT x 256 floats), then the chunk is walked back.  gu/gdt
// reduce over the 16 lanes by shuffle.  gB/gC reduce over the block's 16
// channels (a shuffle across the warp's two channels, then the 8 warps
// through shared memory, one barrier per step) into per-block partials
// (B, n_groups, L, d_state) fp32; gA/gD are summed over time in registers
// into per-batch partials.  A second launch sums the partials in one fixed
// order (no atomics: the result does not depend on scheduling).  u, B, C
// and gy are read in their own dtype; gu, gB, gC are written in it; gdt,
// gA, gD, gh0 are fp32.  d_state <= 128 (the h_{t-1} store of a 256-wide
// state does not fit in 227 KB of shared memory).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                    // threads per channel (split d_state)
constexpr int kChannels = kThreads / kLanes;  // channels per block
constexpr int kSteps = 16;                    // time steps staged per pass
constexpr int kWarps = kThreads / 32;

template <typename T, int NPT>
__global__ void __launch_bounds__(kThreads)
scan_fwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_last, float* __restrict__ h_starts, int L, int Di,
                int Ds, int chunk) {
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
  const int n_chunks = (L + chunk - 1) / chunk;

  for (int t0 = 0; t0 < L; t0 += kSteps) {
    const int nt = min(kSteps, L - t0);
    if (h_starts != nullptr && t0 % chunk == 0) {
      const size_t base = (((size_t)b * n_chunks + t0 / chunk) * Di + c) * Ds;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int s = lane + j * kLanes;
        if (cvalid && s < Ds) h_starts[base + s] = h[j];
      }
    }
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
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h_starts, const T* __restrict__ gy,
                const float* __restrict__ gh_last, T* __restrict__ gu,
                float* __restrict__ gdt, float* __restrict__ gB_part,
                float* __restrict__ gC_part, float* __restrict__ gA_part,
                float* __restrict__ gD_part, float* __restrict__ gh0, int L, int Di, int Ds,
                int chunk) {
  constexpr int kSP = kLanes * NPT;
  extern __shared__ float smem[];
  float* sH = smem;                          // [chunk][NPT][kThreads]: h_{t-1}
  float* sB = sH + chunk * NPT * kThreads;   // [chunk][kSP]
  float* sC = sB + chunk * kSP;              // [chunk][kSP]
  float* su = sC + chunk * kSP;              // [chunk][kChannels], and sdt, sgy,
  float* sdt = su + chunk * kChannels;       //   sgu, sgdt likewise
  float* sgy = sdt + chunk * kChannels;
  float* sgu = sgy + chunk * kChannels;
  float* sgdt = sgu + chunk * kChannels;
  float* sRed = sgdt + chunk * kChannels;    // [2 step parity][2 (B, C)][kWarps][kSP]
  float* sPart = sRed + 4 * kWarps * kSP;    // [2 (B, C)][chunk][kSP]

  const int b = blockIdx.y;
  const int grp = blockIdx.x, n_groups = gridDim.x;
  const int c0 = grp * kChannels;
  const int lane = threadIdx.x % kLanes;
  const int cl = threadIdx.x / kLanes;
  const int warp = threadIdx.x / 32;
  const bool lead = threadIdx.x % 32 < kLanes;  // the first channel of its warp
  const int c = c0 + cl;
  const bool cvalid = c < Di;
  const int n_chunks = (L + chunk - 1) / chunk;

  // carry[j] = a_{t+1} lambda_{t+1}: the adjoint reaching h_t from the right
  float Ac[NPT], carry[NPT], gAc[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int s = lane + j * kLanes;
    const bool ok = cvalid && s < Ds;
    Ac[j] = ok ? A[(size_t)c * Ds + s] : 0.f;
    carry[j] = ok ? gh_last[((size_t)b * Di + c) * Ds + s] : 0.f;
    gAc[j] = 0.f;
  }
  const float Dc = cvalid ? D[c] : 0.f;
  float gDc = 0.f;

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * chunk;
    const int nt = min(chunk, L - t0);
    __syncthreads();  // the previous chunk has finished with the stage
    for (int i = threadIdx.x; i < nt * kSP; i += kThreads) {
      const int t = i / kSP, s = i % kSP;
      const bool ok = s < Ds;
      const size_t off = ((size_t)b * L + t0 + t) * Ds + s;
      sB[i] = ok ? to_f32(Bm[off]) : 0.f;
      sC[i] = ok ? to_f32(Cm[off]) : 0.f;
    }
    for (int i = threadIdx.x; i < nt * kChannels; i += kThreads) {
      const int t = i / kChannels, kk = i % kChannels;
      const bool ok = c0 + kk < Di;
      const size_t off = ((size_t)b * L + t0 + t) * Di + c0 + kk;
      su[i] = ok ? to_f32(u[off]) : 0.f;
      sdt[i] = ok ? dt[off] : 0.f;
      sgy[i] = ok ? to_f32(gy[off]) : 0.f;
    }
    __syncthreads();

    // recompute the chunk forward from its saved incoming state, keeping
    // h_{t-1} of every step (each thread reads back only its own slots)
    {
      float h[NPT];
      const size_t base = (((size_t)b * n_chunks + k) * Di + c) * Ds;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int s = lane + j * kLanes;
        h[j] = (cvalid && s < Ds) ? h_starts[base + s] : 0.f;
      }
      for (int t = 0; t < nt; ++t) {
        const float dtv = sdt[t * kChannels + cl];
        const float du = dtv * su[t * kChannels + cl];
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          sH[(t * NPT + j) * kThreads + threadIdx.x] = h[j];
          h[j] = expf(dtv * Ac[j]) * h[j] + du * sB[t * kSP + lane + j * kLanes];
        }
      }
    }

    // walk the chunk back
    for (int t = nt - 1; t >= 0; --t) {
      const float dtv = sdt[t * kChannels + cl], uv = su[t * kChannels + cl];
      const float gyv = sgy[t * kChannels + cl];
      const float du = dtv * uv;
      float lamB = 0.f, lhaA = 0.f, pB[NPT], pC[NPT];
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int s = lane + j * kLanes;
        const float hp = sH[(t * NPT + j) * kThreads + threadIdx.x];
        const float a = expf(dtv * Ac[j]);
        const float Bs = sB[t * kSP + s];
        const float lam = gyv * sC[t * kSP + s] + carry[j];
        const float lha = lam * hp * a;
        lamB += lam * Bs;
        lhaA += lha * Ac[j];
        gAc[j] += lha * dtv;
        pB[j] = lam * du;
        pC[j] = (a * hp + du * Bs) * gyv;  // h_t * gy_t
        carry[j] = a * lam;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        lamB += __shfl_xor_sync(0xffffffffu, lamB, off, kLanes);
        lhaA += __shfl_xor_sync(0xffffffffu, lhaA, off, kLanes);
      }
      if (lane == 0) {
        sgu[t * kChannels + cl] = dtv * lamB + Dc * gyv;
        sgdt[t * kChannels + cl] = lhaA + lamB * uv;
      }
      gDc += gyv * uv;
      // gB_t, gC_t over the block's channels: the warp's two channels by
      // shuffle, then the warps through shared memory (double-buffered by
      // step parity, so one barrier per step suffices)
      float* red = sRed + (t & 1) * 2 * kWarps * kSP;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        pB[j] += __shfl_xor_sync(0xffffffffu, pB[j], kLanes);
        pC[j] += __shfl_xor_sync(0xffffffffu, pC[j], kLanes);
        if (lead) {
          red[warp * kSP + lane + j * kLanes] = pB[j];
          red[(kWarps + warp) * kSP + lane + j * kLanes] = pC[j];
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * kSP; i += kThreads) {
        const int which = i / kSP, s = i % kSP;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += red[(which * kWarps + w) * kSP + s];
        sPart[(which * chunk + t) * kSP + s] = acc;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < nt * kChannels; i += kThreads) {
      const int t = i / kChannels, kk = i % kChannels;
      if (c0 + kk < Di) {
        const size_t off = ((size_t)b * L + t0 + t) * Di + c0 + kk;
        gu[off] = from_f32<T>(sgu[i]);
        gdt[off] = sgdt[i];
      }
    }
    for (int i = threadIdx.x; i < 2 * nt * Ds; i += kThreads) {
      const int which = i / (nt * Ds), r = i % (nt * Ds);
      const int t = r / Ds, s = r % Ds;
      float* dst = which ? gC_part : gB_part;
      dst[(((size_t)b * n_groups + grp) * L + t0 + t) * Ds + s] =
          sPart[(which * chunk + t) * kSP + s];
    }
  }

#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int s = lane + j * kLanes;
    if (cvalid && s < Ds) {
      gh0[((size_t)b * Di + c) * Ds + s] = carry[j];  // a_0 lambda_0
      gA_part[((size_t)b * Di + c) * Ds + s] = gAc[j];
    }
  }
  if (lane == 0 && cvalid) gD_part[(size_t)b * Di + c] = gDc;
}

// out[o, r] = sum_k in[o, k, r] for k = 0..K-1 in order; in is (O, K, R) fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_middle_kernel(const float* __restrict__ in, T* __restrict__ out, int K, long long R) {
  const int o = blockIdx.y;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < R;
       r += (long long)gridDim.x * kThreads) {
    const float* p = in + (size_t)o * K * R + r;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += p[(size_t)k * R];
    out[(size_t)o * R + r] = from_f32<T>(acc);
  }
}

template <typename T>
void sum_middle(const float* in, T* out, int O, int K, long long R, cudaStream_t stream) {
  const long long blocks = (R + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(blocks < 1024 ? blocks : 1024), O);
  sum_middle_kernel<T><<<grid, kThreads, 0, stream>>>(in, out, K, R);
}

size_t bwd_smem_bytes(int npt, int chunk) {
  const int sp = kLanes * npt;
  return sizeof(float) * ((size_t)chunk * npt * kThreads + 4 * (size_t)chunk * sp +
                          5 * (size_t)chunk * kChannels + 4 * (size_t)kWarps * sp);
}

template <typename T, int NPT>
int launch_bwd(const void* u, const void* dt, const void* A, const void* Bm, const void* Cm,
               const void* D, const void* h_starts, const void* gy, const void* gh_last,
               void* gu, void* gdt, void* gB, void* gC, void* gA, void* gD, void* gh0,
               void* gB_part, void* gC_part, void* gA_part, void* gD_part, int Bsz, int L,
               int Di, int Ds, int chunk, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(NPT, chunk);
  cudaError_t err = cudaFuncSetAttribute(scan_bwd_kernel<T, NPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_groups = (Di + kChannels - 1) / kChannels;
  const dim3 grid(n_groups, Bsz);
  scan_bwd_kernel<T, NPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(h_starts), static_cast<const T*>(gy),
      static_cast<const float*>(gh_last), static_cast<T*>(gu), static_cast<float*>(gdt),
      static_cast<float*>(gB_part), static_cast<float*>(gC_part), static_cast<float*>(gA_part),
      static_cast<float*>(gD_part), static_cast<float*>(gh0), L, Di, Ds, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long LDs = (long long)L * Ds;
  sum_middle<T>(static_cast<const float*>(gB_part), static_cast<T*>(gB), Bsz, n_groups, LDs,
                stream);
  sum_middle<T>(static_cast<const float*>(gC_part), static_cast<T*>(gC), Bsz, n_groups, LDs,
                stream);
  sum_middle<float>(static_cast<const float*>(gA_part), static_cast<float*>(gA), 1, Bsz,
                    (long long)Di * Ds, stream);
  sum_middle<float>(static_cast<const float*>(gD_part), static_cast<float*>(gD), 1, Bsz, Di,
                    stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NPT>
void launch(const void* u, const void* dt, const void* A, const void* Bm, const void* Cm,
            const void* D, const void* h0, void* y, void* h_last, void* h_starts, int Bsz,
            int L, int Di, int Ds, int chunk, cudaStream_t stream) {
  const dim3 grid((Di + kChannels - 1) / kChannels, Bsz);
  scan_fwd_kernel<T, NPT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(h_last),
      static_cast<float*>(h_starts), L, Di, Ds, chunk);
}

}  // namespace

// dtype: dtype code of u, B, C and y (kF32 or kBF16).  Shapes: u, dt, y
// (Bsz, L, Di); A (Di, Ds); B, C (Bsz, L, Ds); D (Di); h0, h_last
// (Bsz, Di, Ds); h_starts (Bsz, ceil(L / chunk), Di, Ds) or nullptr; all
// contiguous.  1 <= Ds <= 256; with h_starts, chunk is a positive multiple
// of kSteps (16).  Returns cudaGetLastError().
extern "C" int selective_scan_fwd(int dtype, const void* u, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, const void* D,
                                  const void* h0, void* y, void* h_last, void* h_starts,
                                  int Bsz, int L, int Di, int Ds, int chunk, void* stream) {
  if (Ds < 1 || Ds > 16 * kLanes) return static_cast<int>(cudaErrorInvalidValue);
  if (h_starts != nullptr && (chunk < kSteps || chunk % kSteps != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h_starts == nullptr) chunk = kSteps;  // unused; keeps t0 % chunk defined
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dtype, T, {
    if (Ds <= kLanes)
      launch<T, 1>(u, dt, A, Bm, Cm, D, h0, y, h_last, h_starts, Bsz, L, Di, Ds, chunk, st);
    else if (Ds <= 2 * kLanes)
      launch<T, 2>(u, dt, A, Bm, Cm, D, h0, y, h_last, h_starts, Bsz, L, Di, Ds, chunk, st);
    else if (Ds <= 4 * kLanes)
      launch<T, 4>(u, dt, A, Bm, Cm, D, h0, y, h_last, h_starts, Bsz, L, Di, Ds, chunk, st);
    else if (Ds <= 8 * kLanes)
      launch<T, 8>(u, dt, A, Bm, Cm, D, h0, y, h_last, h_starts, Bsz, L, Di, Ds, chunk, st);
    else
      launch<T, 16>(u, dt, A, Bm, Cm, D, h0, y, h_last, h_starts, Bsz, L, Di, Ds, chunk, st);
  })
  return static_cast<int>(cudaGetLastError());
}

// dtype: dtype code of u, B, C, gy, gu, gB and gC.  Shapes as in
// selective_scan_fwd, plus gy, gu, gdt (Bsz, L, Di); gB, gC (Bsz, L, Ds); gA
// (Di, Ds); gD (Di); gh_last, gh0 (Bsz, Di, Ds); scratch gB_part, gC_part
// (Bsz, ceil(Di / 16), L, Ds), gA_part (Bsz, Di, Ds), gD_part (Bsz, Di), all
// fp32.  h_starts is K1's output at the same chunk.  1 <= Ds <= 128;
// 1 <= chunk and the shared memory of the chunk (bwd_smem_bytes) <= 227 KB.
// Returns the first CUDA error of its launches.
extern "C" int selective_scan_bwd(int dtype, const void* u, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, const void* D,
                                  const void* h_starts, const void* gy, const void* gh_last,
                                  void* gu, void* gdt, void* gB, void* gC, void* gA, void* gD,
                                  void* gh0, void* gB_part, void* gC_part, void* gA_part,
                                  void* gD_part, int Bsz, int L, int Di, int Ds, int chunk,
                                  void* stream) {
  if (Ds < 1 || Ds > 8 * kLanes || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int npt = Ds <= kLanes ? 1 : Ds <= 2 * kLanes ? 2 : Ds <= 4 * kLanes ? 4 : 8;
  if (bwd_smem_bytes(npt, chunk) > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K2_ARGS u, dt, A, Bm, Cm, D, h_starts, gy, gh_last, gu, gdt, gB, gC, gA, gD, gh0, \
                gB_part, gC_part, gA_part, gD_part, Bsz, L, Di, Ds, chunk, st
  DISPATCH_DTYPE(dtype, T, {
    switch (npt) {
      case 1: return launch_bwd<T, 1>(K2_ARGS);
      case 2: return launch_bwd<T, 2>(K2_ARGS);
      case 4: return launch_bwd<T, 4>(K2_ARGS);
      default: return launch_bwd<T, 8>(K2_ARGS);
    }
  })
#undef K2_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
