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
// What bounds them on this card.  The bytes are small (u, dt, y of B*L*d_inner
// and B, C of B*L*d_state); the work is one exponential and a handful of
// multiply-adds per state element and step, in a time loop that is serial in
// h only.  The floor of a step is the special-function unit (16 exponentials
// a cycle and SM); the first version sat far above it on instruction dispatch
// (a full-precision expf, scalar loads, a loop that was not unrolled), on
// staging that stopped the block three times every 16 steps, and in K2 on a
// block-wide barrier every step and 82 MB of partial sums.
//
// Design, both kernels.  No time-parallel pair scan (the TPU kernel's
// _pair_scan is a Mosaic workaround): a block of 256 threads walks time for
// 256 / LANES channels, each channel's d_state split over LANES threads (4, 8
// or 16, chosen by the wrapper from the shape: as few as still give every SM
// a block) with NPT state elements each in registers.
//  - One MUFU per exponential: A is kept as A * log2(e) and a = ex2.approx(dt * A2).
//  - The time loop runs in fixed, fully unrolled blocks of steps (16 in K1, 4
//    to 16 in K2) in which nothing is stored to shared memory before every
//    step is computed (a store would hold back the loads behind it): the
//    loads, exponentials and dt*u*B of later steps are started ahead of the
//    one serial multiply-add, and the sums over a channel's lanes are taken
//    for all the block's steps at once by a halving exchange (each round a
//    thread sends half of what it holds and keeps the other half: 14
//    shuffles for 16 steps on 8 lanes where a butterfly per step takes 48).
//    A ragged tail takes the same code one step at a time.
//  - B_t, C_t (shared by the block's channels) and the block's slivers of u,
//    dt (and gy) are staged in shared memory in their own dtype by 16-byte
//    cp.async, double buffered: the next stage is in flight while this one
//    computes, outputs leave through buffers of their own, and one barrier a
//    stage is left.  (Bulk copies on an mbarrier, one per sliver row, were
//    measured slower.)  Rows or pointers that are not 16-byte aligned (ragged
//    d_inner or d_state) take plain element copies at the same place.
//  - A thread's state elements are contiguous runs of up to 16 bytes of a
//    B/C row, interleaved across the lanes (conflict-free vector loads), and
//    contiguous float4 runs of h0, h_last and the chunk states.
// Ragged d_inner and d_state are masked (A = 0, h = 0, zeroed padding).  u, B,
// C (gy) are read in their own dtype (fp32 or bf16, a template); dt, A, D and
// every state are fp32.  D and h0 may be null (zeros).
//
// K1 writes y through shared memory (coalesced) and, for training, the state
// entering every chunk of `chunk` steps (a multiple of 16) to h_starts.
//
// K2.  With lambda_t = dL/dh_t:
//   lambda_t = gy_t C_t + a_{t+1} lambda_{t+1}     (a_L lambda_L := gh_last)
//   gu_t  = dt_t <lambda_t, B_t> + D gy_t
//   gdt_t = <lambda_t h_{t-1} a_t, A> + u_t <lambda_t, B_t>
//   gB_t  = sum_i lambda_t dt_t u_t,  gC_t = sum_i h_t gy_t     (over d_inner)
//   gA    = sum_{b,t} lambda_t h_{t-1} a_t dt_t,  gD = sum_{b,t} gy_t u_t
//   gh0   = a_0 lambda_0
// Chunks are walked right to left, a whole chunk staged at a time (the next
// one in flight, its saved state prefetched into registers), in unrolled
// blocks of 4 to 16 steps (fewer where a thread holds more elements).  In
// each chunk h is recomputed from h_starts with every h_{t-1} kept in shared
// memory in per-thread slots (nobody else reads them: no barrier), then the
// chunk is walked back with the carry a_{t+1} lambda_{t+1} in registers; h_t
// is the h_{t-1} the step before read, so each element costs one shared load
// and one exponential.  gu/gdt reduce over the lanes by shuffle and leave
// through shared memory in 16-byte stores.  gB_t/gC_t reduce over d_inner in
// four levels, none of which stops the walk:
//  1. over the warp's channels by the same halving exchange, parked in the
//     warp's own part of the h_{t-1} slots the steps have just read;
//  2. once a chunk, over the block's 8 warps in warp order;
//  3. over the blocks of a thread block cluster through distributed shared
//     memory in rank order, double buffered, the cluster barrier's arrive at
//     a chunk's end and its wait after the next chunk's recompute.  The
//     wrapper takes the largest cluster, up to 128 channels, that costs no
//     further wave: at the training shape 2 blocks (64 channels), because
//     the card holds only 30 clusters of 4 SMs at once where 32 are needed,
//     and the kernel then ran in two waves and took twice the time;
//  4. over the clusters by scan_bwd_finish_kernel from (2, B, n_clusters, L,
//     d_state) fp32 partials (one per cluster instead of one per 16
//     channels), in the same launch that sums gA and gD over the batch.
// Every sum has one fixed order (no atomics): a repeated call gives the same
// bits.  d_state <= 128 (NPT <= 8 keeps a chunk of h_{t-1} in 128 KB).
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // K1's block
constexpr int kBwdThreads = 256;  // K2's block (two of 128 on an SM were no faster)
constexpr int kStageThreads = 64;  // of them, the threads that start K2's stage copies
constexpr int kSteps = 16;  // time steps per unrolled block, and per K1 stage
constexpr int kMaxCluster = 8;  // blocks of a cluster (the portable limit)
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block may ask for
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// flags of what may be copied in 16-byte pieces
enum : int { kVecBC = 1, kVecCh = 2, kVecState = 4, kVecOut = 8, kVecPart = 16 };

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The cluster barrier in two halves: shared-memory writes made before the
// arrive are visible to the cluster's blocks after their wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// Four floats at `p` (16-byte aligned) in the shared memory of the cluster's
// block `rank`.
__device__ __forceinline__ float4 load_cluster4(const float* p, int rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote));
  return v;
}

// Four values to p as T, in one store (p aligned to four T).
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// How a block's threads split its channels and d_state.
template <typename T, int LANES_, int NPT, int NT = kThreads>
struct Split {
  static constexpr int LANES = LANES_;
  static constexpr int CH = NT / LANES;        // channels per block
  static constexpr int SP = LANES * NPT;       // d_state padded to the lanes
  static constexpr int VMAX = 16 / (int)sizeof(T);
  static constexpr int V = NPT < VMAX ? NPT : VMAX;  // elements per vector load of a B/C row
  static constexpr int NV = NPT / V;
  static constexpr int W = NPT < 4 ? NPT : 4;  // floats per vector of a thread's state
  // the state element that a lane's j-th register holds: runs of V, interleaved over the lanes
  __device__ static __forceinline__ int s_of(int lane, int j) {
    return (j / V) * (LANES * V) + lane * V + j % V;
  }
};

// V elements of T at p (aligned to their size) as floats.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* o) {
  constexpr int BYTES = (int)sizeof(T) * V;
  if constexpr (BYTES < 4) {
    o[0] = to_f32(p[0]);
  } else {
    constexpr int NW = BYTES / 4;
    uint32_t w[NW];
    if constexpr (NW == 4) {
      const uint4 r = *reinterpret_cast<const uint4*>(p);
      w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
    } else if constexpr (NW == 2) {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      w[0] = r.x, w[1] = r.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if constexpr (sizeof(T) == 4) {
        o[i] = __uint_as_float(w[i]);
      } else {  // two bf16: the low half is the first element
        o[2 * i] = __uint_as_float(w[i] << 16);
        o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// A lane's NPT elements of a staged B or C row.
template <typename SPL, typename T, int NPT>
__device__ __forceinline__ void load_row(const T* row, int lane, float (&o)[NPT]) {
#pragma unroll
  for (int v = 0; v < SPL::NV; ++v)
    load_vec<T, SPL::V>(row + (v * SPL::LANES + lane) * SPL::V, &o[v * SPL::V]);
}

// A lane's NPT elements of one channel's fp32 state row (Ds floats at `row`):
// zeros where `ok` is false, the row is null or the element is padding.
template <typename SPL, int NPT>
__device__ __forceinline__ void load_state(const float* row, int lane, int Ds, bool ok, bool vec,
                                           float (&h)[NPT]) {
#pragma unroll
  for (int j = 0; j < NPT; ++j) h[j] = 0.f;
  if (!ok || row == nullptr) return;
  if constexpr (NPT >= 4) {
    if (vec) {  // Ds % 4 == 0: a run of four is inside the row or outside it
#pragma unroll
      for (int j = 0; j < NPT; j += 4) {
        const int s = SPL::s_of(lane, j);
        if (s < Ds) {
          const float4 r = *reinterpret_cast<const float4*>(row + s);
          h[j] = r.x, h[j + 1] = r.y, h[j + 2] = r.z, h[j + 3] = r.w;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int s = SPL::s_of(lane, j);
    if (s < Ds) h[j] = row[s];
  }
}

template <typename SPL, int NPT>
__device__ __forceinline__ void store_state(float* row, int lane, int Ds, bool ok, bool vec,
                                            const float (&h)[NPT]) {
  if (!ok) return;
  if constexpr (NPT >= 4) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < NPT; j += 4) {
        const int s = SPL::s_of(lane, j);
        if (s < Ds)
          *reinterpret_cast<float4*>(row + s) = make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int s = SPL::s_of(lane, j);
    if (s < Ds) row[s] = h[j];
  }
}

// Stage `rows` rows of n elements (row stride gstride in device memory,
// sstride in shared memory): 16-byte cp.async pieces if `vec` (the caller
// has checked that every row is 16-byte aligned and a multiple of 16 bytes),
// plain element copies otherwise.  The block's first NT threads call it;
// piece i goes to thread (i + first) % NT, so that a caller's arrays can
// start at different warps.  Visible after cp_async_wait_all() and a barrier.
template <int NT, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int sstride, const T* src, size_t gstride,
                                           int rows, int n, bool vec, int first) {
  if (n <= 0) return;
  const int tid = (threadIdx.x - first) & (NT - 1);
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);
    const int per_row = n / E;
    if ((per_row & (per_row - 1)) == 0) {  // the usual case: no division
      const int shift = __ffs(per_row) - 1;
      for (int i = tid; i < rows * per_row; i += NT) {
        const int r = i >> shift, q = i & (per_row - 1);
        cp_async16(dst + r * sstride + q * E, src + r * gstride + q * E);
      }
      return;
    }
    for (int i = tid; i < rows * per_row; i += NT) {
      const int r = i / per_row, q = i - r * per_row;
      cp_async16(dst + r * sstride + q * E, src + r * gstride + q * E);
    }
  } else {
    for (int i = tid; i < rows * n; i += NT) {
      const int r = i / n, q = i - r * n;
      dst[r * sstride + q] = src[r * gstride + q];
    }
  }
}

__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  uint32_t* w = static_cast<uint32_t*>(p);
  for (int i = threadIdx.x; i < (int)(bytes / 4); i += blockDim.x) w[i] = 0u;
}

// Sum p[0..N) over the threads of a warp whose lane index differs in the bits
// OFF, 2 OFF, ... < END (the lanes of a channel, or the channels of a warp).
// Each round the two partners halve what they hold: one keeps the lower half
// and sends the upper, the other the reverse; when one value is left the
// rounds go on as an all-reduce.  On return p[0..max(N / threads, 1)) holds
// the sums of the caller's elements j0.., j0 from reduce_origin().
template <int N, int OFF, int END>
__device__ __forceinline__ void lanes_reduce(float* p, int wl) {
  if constexpr (OFF < END) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = wl & OFF;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = up ? p[j] : p[j + H];
        const float keep = up ? p[j + H] : p[j];
        p[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      lanes_reduce<H, OFF * 2, END>(p, wl);
    } else {
      p[0] += __shfl_xor_sync(0xffffffffu, p[0], OFF);
      lanes_reduce<1, OFF * 2, END>(p, wl);
    }
  }
}

// Where lanes_reduce<N, OFF, END> leaves a thread: the first element j0 of
// the caller's array that it holds, and whether it is the one copy that
// writes (all-reduce rounds leave the same value in both partners).
template <int N, int OFF, int END>
__device__ __forceinline__ void reduce_origin(int wl, int& j0, bool& writer) {
  if constexpr (OFF < END) {
    const bool up = wl & OFF;
    if constexpr (N > 1) {
      j0 += up ? N / 2 : 0;
      reduce_origin<N / 2, OFF * 2, END>(wl, j0, writer);
    } else {
      writer = writer && !up;
      reduce_origin<1, OFF * 2, END>(wl, j0, writer);
    }
  }
}

template <int U>
using Steps = std::integral_constant<int, U>;

// ------------------------------------------------------------------ K1 ----

template <typename T, int LANES, int NPT>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  using SPL = Split<T, LANES, NPT>;
  return 2 * kSteps * (2 * SPL::SP * sizeof(T) + SPL::CH * (sizeof(T) + 2 * sizeof(float)));
}

template <typename T, int LANES, int NPT>
__global__ void __launch_bounds__(kThreads)
scan_fwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_last,
                float* __restrict__ h_starts, int L, int Di, int Ds, int chunk, int flags) {
  using SPL = Split<T, LANES, NPT>;
  constexpr int CH = SPL::CH, SP = SPL::SP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);             // [2][kSteps][SP]
  T* sC = sB + 2 * kSteps * SP;                       // [2][kSteps][SP]
  T* su = sC + 2 * kSteps * SP;                       // [2][kSteps][CH]
  float* sdt = reinterpret_cast<float*>(su + 2 * kSteps * CH);  // [2][kSteps][CH]
  float* sy = sdt + 2 * kSteps * CH;                  // [2][kSteps][CH]

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int nch = min(CH, Di - c0);
  const int lane = threadIdx.x % LANES;
  const int cl = threadIdx.x / LANES;
  const int c = c0 + cl;
  const bool cvalid = c < Di;
  const bool vec_state = flags & kVecState, vec_bc = flags & kVecBC, vec_ch = flags & kVecCh;

  if (nch < CH || Ds < SP) {  // padding that no copy writes must read as zero
    zero_smem(smem_raw, fwd_smem_bytes<T, LANES, NPT>());
    __syncthreads();
  }

  const T* ub = u + (size_t)b * L * Di + c0;
  const float* dtb = dt + (size_t)b * L * Di + c0;
  const T* Bb = Bm + (size_t)b * L * Ds;
  const T* Cb = Cm + (size_t)b * L * Ds;
  auto fetch = [&](int k) {
    const int buf = k & 1, t0 = k * kSteps, nt = min(kSteps, L - t0);
    stage_rows<kThreads>(sB + buf * kSteps * SP, SP, Bb + (size_t)t0 * Ds, Ds, nt, Ds, vec_bc, 0);
    stage_rows<kThreads>(sC + buf * kSteps * SP, SP, Cb + (size_t)t0 * Ds, Ds, nt, Ds, vec_bc, 128);
    stage_rows<kThreads>(su + buf * kSteps * CH, CH, ub + (size_t)t0 * Di, Di, nt, nch, vec_ch, 192);
    stage_rows<kThreads>(sdt + buf * kSteps * CH, CH, dtb + (size_t)t0 * Di, Di, nt, nch, vec_ch, 64);
    cp_async_commit();
  };
  auto write_y = [&](int k) {
    const int t0 = k * kSteps, nt = min(kSteps, L - t0);
    const float* syb = sy + (k & 1) * kSteps * CH;
    if (flags & kVecOut) {  // four channels a store: nch is a multiple of 8 here
      for (int i = 4 * threadIdx.x; i < nt * CH; i += 4 * kThreads) {
        const int t = i / CH, kk = i % CH;
        if (kk < nch)
          store4(y + ((size_t)b * L + t0 + t) * Di + c0 + kk,
                 *reinterpret_cast<const float4*>(syb + i));
      }
      return;
    }
    for (int i = threadIdx.x; i < nt * CH; i += kThreads) {
      const int t = i / CH, kk = i % CH;
      if (kk < nch) y[((size_t)b * L + t0 + t) * Di + c0 + kk] = from_f32<T>(syb[i]);
    }
  };
  fetch(0);

  float h[NPT], A2[NPT];  // A2 = A log2(e): exp(dt A) = 2^(dt A2)
  load_state<SPL>(A + (size_t)c * Ds, lane, Ds, cvalid, false, A2);
#pragma unroll
  for (int j = 0; j < NPT; ++j) A2[j] *= kLog2e;
  load_state<SPL>(h0 == nullptr ? nullptr : h0 + ((size_t)b * Di + c) * Ds, lane, Ds, cvalid,
                  vec_state, h);
  const float Dc = (cvalid && D != nullptr) ? D[c] : 0.f;
  const int n_chunks = (L + chunk - 1) / chunk;
  const int n_stages = (L + kSteps - 1) / kSteps;

  for (int k = 0; k < n_stages; ++k) {
    const int buf = k & 1, t0 = k * kSteps, nt = min(kSteps, L - t0);
    cp_async_wait_all();
    __syncthreads();  // stage k has landed; everyone is done with stage k - 1
    if (k + 1 < n_stages) fetch(k + 1);
    if (k > 0) write_y(k - 1);
    if (h_starts != nullptr && t0 % chunk == 0)
      store_state<SPL>(h_starts + (((size_t)b * n_chunks + t0 / chunk) * Di + c) * Ds, lane, Ds,
                       cvalid, vec_state, h);
    const T* sBb = sB + buf * kSteps * SP;
    const T* sCb = sC + buf * kSteps * SP;
    const T* sub = su + buf * kSteps * CH;
    const float* sdtb = sdt + buf * kSteps * CH;
    float* syb = sy + buf * kSteps * CH;
    // U steps from tb.  Nothing is stored before every step is computed, so
    // the loads and exponentials of later steps are free to be started ahead
    // of the serial multiply-add; y's sums over the lanes are taken for all
    // U steps at once, each lane ending with U / LANES of them.
    auto block = [&](int tb, auto u_tag) {
      constexpr int U = decltype(u_tag)::value;
      constexpr int NY = U / LANES > 1 ? U / LANES : 1;
      float accs[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int t = tb + i;
        const float dtv = sdtb[t * CH + cl];
        const float du = dtv * to_f32(sub[t * CH + cl]);
        float Bv[NPT], Cv[NPT];
        load_row<SPL>(sBb + t * SP, lane, Bv);
        load_row<SPL>(sCb + t * SP, lane, Cv);
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          h[j] = fmaf(ex2(dtv * A2[j]), h[j], du * Bv[j]);
          if (j & 1) {
            acc1 = fmaf(h[j], Cv[j], acc1);
          } else {
            acc0 = fmaf(h[j], Cv[j], acc0);
          }
        }
        accs[i] = acc0 + acc1;
      }
      lanes_reduce<U, 1, LANES>(accs, lane);
      int i0 = 0;
      bool writer = true;
      reduce_origin<U, 1, LANES>(lane, i0, writer);
      if (writer) {
#pragma unroll
        for (int i = 0; i < NY; ++i) {
          const int t = tb + i0 + i;
          syb[t * CH + cl] = fmaf(Dc, to_f32(sub[t * CH + cl]), accs[i]);
        }
      }
    };
    if (nt == kSteps) {
      block(0, Steps<kSteps>{});
    } else {
      for (int t = 0; t < nt; ++t) block(t, Steps<1>{});
    }
  }
  __syncthreads();
  write_y(n_stages - 1);
  store_state<SPL>(h_last + ((size_t)b * Di + c) * Ds, lane, Ds, cvalid, vec_state, h);
}

// ------------------------------------------------------------------ K2 ----

// Shared memory of K2 for a split and a chunk, in bytes (mirrored by the
// wrapper's bwd_smem_bytes).
size_t bwd_smem_bytes(int lanes, int npt, int chunk, int esize) {
  const size_t ch = kBwdThreads / lanes, sp = (size_t)lanes * npt, ck = chunk;
  return ck * kBwdThreads * npt * 4      // h_{t-1} of the chunk (and the parked warp sums)
         + 2 * ck * 2 * sp * 4        // the block's gB/gC sums, two chunks
         + 2 * ck * ch * 4            // gu, gdt on their way out
         + 2 * ck * ch * 4            // dt, two stages
         + 2 * 2 * ck * sp * esize    // B, C, two stages
         + 2 * 2 * ck * ch * esize;   // u, gy, two stages
}

template <typename T, int LANES, int NPT>
__global__ void __launch_bounds__(kBwdThreads)
scan_bwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h_starts, const T* __restrict__ gy,
                const float* __restrict__ gh_last, T* __restrict__ gu,
                float* __restrict__ gdt, float* __restrict__ part,
                float* __restrict__ gA_part, float* __restrict__ gD_part,
                float* __restrict__ gh0, int L, int Di, int Ds, int chunk, int cluster,
                int flags) {
  using SPL = Split<T, LANES, NPT, kBwdThreads>;
  constexpr int CH = SPL::CH, SP = SPL::SP, W = SPL::W, NVH = NPT / W;
  constexpr int LC = 32 / LANES;                 // channels of a warp
  constexpr int NF = NPT / LC > 1 ? NPT / LC : 1;  // what a thread holds after channel_reduce
  // steps per unrolled block of the recompute and of the walk: as many as
  // leave their loaded rows and partial sums in registers
  constexpr int FWD_UNROLL = NPT >= 8 ? 4 : NPT == 4 ? 8 : kSteps;
  constexpr int UNROLL = NPT >= 8 ? 4 : NPT == 4 ? 8 : kSteps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sH = reinterpret_cast<float*>(smem_raw);   // [chunk][NVH][kBwdThreads][W]: h_{t-1}
  float* sRed = sH + (size_t)chunk * kBwdThreads * NPT;  // [2][chunk][2 (B, C)][SP]
  float* sgu = sRed + 4 * chunk * SP;               // [chunk][CH]
  float* sgdt = sgu + chunk * CH;                   // [chunk][CH]
  float* sdt = sgdt + chunk * CH;                   // [2][chunk][CH]
  T* sB = reinterpret_cast<T*>(sdt + 2 * chunk * CH);  // [2][chunk][SP]
  T* sC = sB + 2 * chunk * SP;                      // [2][chunk][SP]
  T* su = sC + 2 * chunk * SP;                      // [2][chunk][CH]
  T* sgy = su + 2 * chunk * CH;                     // [2][chunk][CH]

  const int b = blockIdx.y, Bsz = gridDim.y;
  const int c0 = blockIdx.x * CH;
  const int nch = min(CH, Di - c0);  // <= 0 in a block that only fills up its cluster
  const int lane = threadIdx.x % LANES;
  const int cl = threadIdx.x / LANES;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int c = c0 + cl;
  const bool cvalid = c < Di;
  const bool vec_state = flags & kVecState, vec_bc = flags & kVecBC, vec_ch = flags & kVecCh;
  const int n_chunks = (L + chunk - 1) / chunk;
  const int rank = cluster_rank();
  const int cid = blockIdx.x / cluster, n_clusters = gridDim.x / cluster;

  if (nch < CH || Ds < SP) {
    zero_smem(sdt, (size_t)2 * chunk * CH * 4 + (size_t)4 * chunk * (SP + CH) * sizeof(T));
    __syncthreads();
  }

  const size_t row0 = (size_t)b * L;
  auto fetch = [&](int k, int buf) {
    const int t0 = k * chunk, nt = min(chunk, L - t0);
    const size_t ch_off = (row0 + t0) * Di + c0, st_off = (row0 + t0) * Ds;
    // Two warps stage for the block.  Measured: with all eight sharing the
    // copies the kernel was 5 % slower (the warps then walk in step and
    // meet at the same units); with one warp, 1.5 % slower.
    if (threadIdx.x < kStageThreads) {
      stage_rows<kStageThreads>(sB + buf * chunk * SP, SP, Bm + st_off, Ds, nt, Ds, vec_bc, 0);
      stage_rows<kStageThreads>(sC + buf * chunk * SP, SP, Cm + st_off, Ds, nt, Ds, vec_bc, 0);
      stage_rows<kStageThreads>(su + buf * chunk * CH, CH, u + ch_off, Di, nt, nch, vec_ch, 0);
      stage_rows<kStageThreads>(sgy + buf * chunk * CH, CH, gy + ch_off, Di, nt, nch, vec_ch, 0);
      stage_rows<kStageThreads>(sdt + buf * chunk * CH, CH, dt + ch_off, Di, nt, nch, vec_ch, 0);
    }
    cp_async_commit();
  };
  auto chunk_state = [&](int k) {
    return h_starts + (((size_t)b * n_chunks + k) * Di + c) * Ds;
  };
  // a thread's h_{t-1} of step t: W floats at a time, consecutive threads adjacent
  auto slot = [&](int t, int v) { return sH + (((size_t)t * NVH + v) * kBwdThreads + threadIdx.x) * W; };
  // element p of the 2 SP sums (gB then gC) that warp w parks in step t's
  // slot, inside the part of it that w's own threads have just read
  auto park = [&](int t, int w, int p) {
    return sH + (((size_t)t * NVH + p / (32 * W)) * kBwdThreads + w * 32) * W + p % (32 * W);
  };
  // The cluster's sum of one chunk's gB/gC: each block takes an equal share
  // and reads it from every block in rank order.
  auto cluster_reduce = [&](int k, int parity) {
    const int t0 = k * chunk, n4 = min(chunk, L - t0) * 2 * SP / 4;  // in runs of four sums
    const int share = (n4 + cluster - 1) / cluster, end = min(n4, (rank + 1) * share);
    const float* mine = sRed + parity * chunk * 2 * SP;
    for (int i4 = rank * share + threadIdx.x; i4 < end; i4 += kBwdThreads) {
      const int i = 4 * i4;
      float4 v[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        v[q] = q < cluster ? load_cluster4(mine + i, q) : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 acc = v[0];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q)
        acc.x += v[q].x, acc.y += v[q].y, acc.z += v[q].z, acc.w += v[q].w;
      const int t = i / (2 * SP), which = (i / SP) & 1, s = i % SP;
      float* out = part + ((((size_t)which * Bsz + b) * n_clusters + cid) * L + t0 + t) * Ds + s;
      if (flags & kVecPart) {  // Ds % 4 == 0: the run is inside the row or outside it
        if (s < Ds) store4(out, acc);
      } else {
        const float a4[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s + e < Ds) out[e] = a4[e];
      }
    }
  };

  fetch(n_chunks - 1, 0);

  // carry[j] = a_{t+1} lambda_{t+1}: the adjoint reaching h_t from the right
  float A2[NPT], carry[NPT], gAc[NPT], hs[NPT];
  load_state<SPL>(A + (size_t)c * Ds, lane, Ds, cvalid, false, A2);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    A2[j] *= kLog2e;
    gAc[j] = 0.f;
  }
  load_state<SPL>(gh_last + ((size_t)b * Di + c) * Ds, lane, Ds, cvalid, vec_state, carry);
  load_state<SPL>(chunk_state(n_chunks - 1), lane, Ds, cvalid, vec_state, hs);
  const float Dc = (cvalid && D != nullptr) ? D[c] : 0.f;
  float gDc = 0.f;
  int j0 = 0;
  bool writer = true;
  reduce_origin<NPT, LANES, 32>(wl, j0, writer);

  for (int k = n_chunks - 1, it = 0; k >= 0; --k, ++it) {
    const int buf = it & 1, t0 = k * chunk, nt = min(chunk, L - t0);
    cp_async_wait_all();
    __syncthreads();  // chunk k has landed; everyone is done with the chunk before
    if (k > 0) fetch(k - 1, buf ^ 1);
    const T* sBb = sB + buf * chunk * SP;
    const T* sCb = sC + buf * chunk * SP;
    const T* sub = su + buf * chunk * CH;
    const T* sgyb = sgy + buf * chunk * CH;
    const float* sdtb = sdt + buf * chunk * CH;

    // recompute the chunk forward from its saved incoming state, keeping
    // h_{t-1} of every step
    float h[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) h[j] = hs[j];
    auto fwd_block = [&](int tb, auto u_tag) {
      constexpr int U = decltype(u_tag)::value;
      float Bs[U][NPT], dts[U], dus[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {  // the loads first: the stores below would hold them back
        const int t = tb + i;
        dts[i] = sdtb[t * CH + cl];
        dus[i] = dts[i] * to_f32(sub[t * CH + cl]);
        load_row<SPL>(sBb + t * SP, lane, Bs[i]);
      }
#pragma unroll
      for (int i = 0; i < U; ++i) {
#pragma unroll
        for (int v = 0; v < NVH; ++v) {
          float* p = slot(tb + i, v);
          if constexpr (W == 4) {
            *reinterpret_cast<float4*>(p) =
                make_float4(h[4 * v], h[4 * v + 1], h[4 * v + 2], h[4 * v + 3]);
          } else if constexpr (W == 2) {
            *reinterpret_cast<float2*>(p) = make_float2(h[0], h[1]);
          } else {
            p[0] = h[0];
          }
        }
#pragma unroll
        for (int j = 0; j < NPT; ++j) h[j] = fmaf(ex2(dts[i] * A2[j]), h[j], dus[i] * Bs[i][j]);
      }
    };
    const int n_fwd = nt / FWD_UNROLL * FWD_UNROLL;  // steps in whole unrolled blocks
    for (int tb = 0; tb < n_fwd; tb += FWD_UNROLL) fwd_block(tb, Steps<FWD_UNROLL>{});
    for (int t = n_fwd; t < nt; ++t) fwd_block(t, Steps<1>{});
    const int n_full = nt / UNROLL * UNROLL;
    // the next chunk's state, asked for now and used after the walk
    if (k > 0) load_state<SPL>(chunk_state(k - 1), lane, Ds, cvalid, vec_state, hs);
    if (it > 0) {  // the chunk before is summed over the cluster while this one walks
      cluster_wait();
      cluster_reduce(k + 1, buf ^ 1);
    }

    // walk the chunk back, U steps at a time; h holds h_t of the step being
    // walked.  A block's stores (gu, gdt, the parked sums) come after all its
    // steps, so that they do not hold back the loads of the steps behind
    // them, and its sums over the lanes are taken for all U steps at once.
    auto bwd_block = [&](int tb, auto u_tag) {
      constexpr int U = decltype(u_tag)::value;
      constexpr int NG = U / LANES > 1 ? U / LANES : 1;
      float lamBs[U], lhaAs[U], pBs[U][NF], pCs[U][NF];
#pragma unroll
      for (int i = U - 1; i >= 0; --i) {
        const int t = tb + i;
        const float dtv = sdtb[t * CH + cl], uv = to_f32(sub[t * CH + cl]);
        const float gyv = to_f32(sgyb[t * CH + cl]);
        const float du = dtv * uv;
        float Bv[NPT], Cv[NPT], hp[NPT], pB[NPT], pC[NPT];
        load_row<SPL>(sBb + t * SP, lane, Bv);
        load_row<SPL>(sCb + t * SP, lane, Cv);
#pragma unroll
        for (int v = 0; v < NVH; ++v) {
          const float* p = slot(t, v);
          if constexpr (W == 4) {
            const float4 r = *reinterpret_cast<const float4*>(p);
            hp[4 * v] = r.x, hp[4 * v + 1] = r.y, hp[4 * v + 2] = r.z, hp[4 * v + 3] = r.w;
          } else if constexpr (W == 2) {
            const float2 r = *reinterpret_cast<const float2*>(p);
            hp[0] = r.x, hp[1] = r.y;
          } else {
            hp[0] = p[0];
          }
        }
        float lamB = 0.f, lhaA = 0.f;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const float a = ex2(dtv * A2[j]);
          const float lam = fmaf(gyv, Cv[j], carry[j]);
          carry[j] = a * lam;
          const float lha = carry[j] * hp[j];  // lambda_t a_t h_{t-1}
          lamB = fmaf(lam, Bv[j], lamB);
          lhaA = fmaf(lha, A2[j], lhaA);
          gAc[j] = fmaf(lha, dtv, gAc[j]);
          pB[j] = lam * du;
          pC[j] = h[j] * gyv;
          h[j] = hp[j];
        }
        lamBs[i] = lamB, lhaAs[i] = lhaA;
        gDc = fmaf(gyv, uv, gDc);
        lanes_reduce<NPT, LANES, 32>(pB, wl);  // over the warp's channels
        lanes_reduce<NPT, LANES, 32>(pC, wl);
#pragma unroll
        for (int f = 0; f < NF; ++f) pBs[i][f] = pB[f], pCs[i][f] = pC[f];
      }
      lanes_reduce<U, 1, LANES>(lamBs, lane);  // over the channel's lanes
      lanes_reduce<U, 1, LANES>(lhaAs, lane);
      int i0 = 0;
      bool lane_writer = true;
      reduce_origin<U, 1, LANES>(lane, i0, lane_writer);
      __syncwarp();  // every lane has read its h_{t-1} of these steps
      if (lane_writer) {
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int t = tb + i0 + i;
          const float dtv = sdtb[t * CH + cl], uv = to_f32(sub[t * CH + cl]);
          const float gyv = to_f32(sgyb[t * CH + cl]);
          sgu[t * CH + cl] = fmaf(dtv, lamBs[i], Dc * gyv);
          // lhaA was summed against A log2(e)
          sgdt[t * CH + cl] = fmaf(kLn2, lhaAs[i], lamBs[i] * uv);
        }
      }
      if (writer) {
#pragma unroll
        for (int i = 0; i < U; ++i) {
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            const int s = SPL::s_of(lane, j0 + f);
            *park(tb + i, warp, s) = pBs[i][f];
            *park(tb + i, warp, SP + s) = pCs[i][f];
          }
        }
      }
    };
    for (int t = nt - 1; t >= n_full; --t) bwd_block(t, Steps<1>{});
    for (int tb = n_full - UNROLL; tb >= 0; tb -= UNROLL) bwd_block(tb, Steps<UNROLL>{});
    __syncthreads();  // the warps' sums are parked, gu and gdt staged

    float* red = sRed + buf * chunk * 2 * SP;
    if constexpr (W == 4) {  // four neighbouring sums are neighbours in the slot too
      for (int i = 4 * threadIdx.x; i < nt * 2 * SP; i += 4 * kBwdThreads) {
        const int t = i / (2 * SP), p = i % (2 * SP);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < kBwdThreads / 32; ++w) {
          const float4 r = *reinterpret_cast<const float4*>(park(t, w, p));
          acc.x += r.x, acc.y += r.y, acc.z += r.z, acc.w += r.w;
        }
        *reinterpret_cast<float4*>(red + i) = acc;
      }
    } else {
      for (int i = threadIdx.x; i < nt * 2 * SP; i += kBwdThreads) {
        const int t = i / (2 * SP), p = i % (2 * SP);
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kBwdThreads / 32; ++w) acc += *park(t, w, p);
        red[i] = acc;
      }
    }
    cluster_arrive();
    if (flags & kVecOut) {  // four channels a store: nch is a multiple of 8 here
      for (int i = 4 * threadIdx.x; i < nt * CH; i += 4 * kBwdThreads) {
        const int t = i / CH, kk = i % CH;
        if (kk < nch) {
          const size_t off = (row0 + t0 + t) * Di + c0 + kk;
          store4(gu + off, *reinterpret_cast<const float4*>(sgu + i));
          store4(gdt + off, *reinterpret_cast<const float4*>(sgdt + i));
        }
      }
    } else {
      for (int i = threadIdx.x; i < nt * CH; i += kBwdThreads) {
        const int t = i / CH, kk = i % CH;
        if (kk < nch) {
          const size_t off = (row0 + t0 + t) * Di + c0 + kk;
          gu[off] = from_f32<T>(sgu[i]);
          gdt[off] = sgdt[i];
        }
      }
    }
  }
  cluster_wait();
  cluster_reduce(0, (n_chunks - 1) & 1);
  cluster_arrive();  // no block leaves while another may still read its sums

  store_state<SPL>(gh0 + ((size_t)b * Di + c) * Ds, lane, Ds, cvalid, vec_state, carry);  // a_0 lambda_0
  store_state<SPL>(gA_part + ((size_t)b * Di + c) * Ds, lane, Ds, cvalid, vec_state, gAc);
  if (lane == 0 && cvalid) gD_part[(size_t)b * Di + c] = gDc;
  cluster_wait();
}

// The last level of K2's sums, each in index order: gB, gC (B, L, Ds) from
// part (2, B, n_clusters, L, Ds); gA (Di, Ds) and gD (Di) from the per-batch
// gA_part (B, Di, Ds) and gD_part (B, Di).
template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_bwd_finish_kernel(const float* __restrict__ part, const float* __restrict__ gA_part,
                       const float* __restrict__ gD_part, T* __restrict__ gB,
                       T* __restrict__ gC, float* __restrict__ gA, float* __restrict__ gD,
                       int Bsz, int n_clusters, long long LDs, long long DiDs, int Di) {
  const long long n_bc = 2LL * Bsz * LDs, total = n_bc + DiDs + Di;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    if (i < n_bc) {
      const long long wb = i / LDs, x = i % LDs;  // wb = which * Bsz + b
      const float* p = part + wb * n_clusters * LDs + x;
      float acc = 0.f;
      for (int q = 0; q < n_clusters; ++q) acc += p[q * LDs];
      T* out = wb < Bsz ? gB : gC;
      out[(wb % Bsz) * LDs + x] = from_f32<T>(acc);
    } else {
      const bool isA = i < n_bc + DiDs;
      const long long x = isA ? i - n_bc : i - n_bc - DiDs, n = isA ? DiDs : Di;
      const float* p = (isA ? gA_part : gD_part) + x;
      float acc = 0.f;
      for (int bb = 0; bb < Bsz; ++bb) acc += p[bb * n];
      (isA ? gA : gD)[x] = acc;
    }
  }
}

// ------------------------------------------------------------- launches ----

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <auto Kern>
cudaError_t allow_smem(size_t smem) {
  static size_t allowed = 48 * 1024;  // per kernel instantiation
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (e != cudaSuccess) return e;
    allowed = kSmemLimit;
  }
  return cudaSuccess;
}

int npt_of(int Ds, int lanes) {
  int npt = 1;
  while (npt * lanes < Ds) npt *= 2;
  return npt;
}

template <typename T, int LANES, int NPT>
cudaError_t launch_fwd(const void* u, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* D, const void* h0, void* y, void* h_last,
                       void* h_starts, int Bsz, int L, int Di, int Ds, int chunk, int flags,
                       cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, LANES, NPT>();
  const cudaError_t e = allow_smem<scan_fwd_kernel<T, LANES, NPT>>(smem);
  if (e != cudaSuccess) return e;
  constexpr int CH = kThreads / LANES;
  const dim3 grid((Di + CH - 1) / CH, Bsz);
  scan_fwd_kernel<T, LANES, NPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(h_last),
      static_cast<float*>(h_starts), L, Di, Ds, chunk, flags);
  return cudaGetLastError();
}

// K2's launch configuration: (n_clusters * cluster, Bsz) blocks in clusters of
// `cluster` along x, with the chunk's shared memory allowed.
template <typename T, int LANES, int NPT>
cudaError_t bwd_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int n_clusters,
                       int Bsz, int chunk, int cluster, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(LANES, NPT, chunk, sizeof(T));
  const cudaError_t e = allow_smem<scan_bwd_kernel<T, LANES, NPT>>(smem);
  if (e != cudaSuccess) return e;
  cfg->gridDim = dim3(n_clusters * cluster, Bsz);
  cfg->blockDim = dim3(kBwdThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int LANES, int NPT>
cudaError_t launch_bwd(const void* u, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* D, const void* h_starts, const void* gy,
                       const void* gh_last, void* gu, void* gdt, void* gB, void* gC, void* gA,
                       void* gD, void* gh0, void* part, void* gA_part, void* gD_part, int Bsz,
                       int L, int Di, int Ds, int chunk, int cluster, int flags,
                       cudaStream_t stream) {
  constexpr int CH = kBwdThreads / LANES;
  const int n_groups = (Di + CH - 1) / CH;
  const int n_clusters = (n_groups + cluster - 1) / cluster;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = bwd_config<T, LANES, NPT>(&cfg, attr, n_clusters, Bsz, chunk, cluster, stream);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(
      &cfg, scan_bwd_kernel<T, LANES, NPT>, static_cast<const T*>(u),
      static_cast<const float*>(dt), static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(h_starts), static_cast<const T*>(gy),
      static_cast<const float*>(gh_last), static_cast<T*>(gu), static_cast<float*>(gdt),
      static_cast<float*>(part), static_cast<float*>(gA_part), static_cast<float*>(gD_part),
      static_cast<float*>(gh0), L, Di, Ds, chunk, cluster, flags);
  if (e != cudaSuccess) return e;
  const long long LDs = (long long)L * Ds, DiDs = (long long)Di * Ds;
  const long long blocks = (2 * Bsz * LDs + DiDs + Di + kThreads - 1) / kThreads;
  scan_bwd_finish_kernel<T><<<(unsigned)(blocks < 2048 ? blocks : 2048), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(gA_part),
      static_cast<const float*>(gD_part), static_cast<T*>(gB), static_cast<T*>(gC),
      static_cast<float*>(gA), static_cast<float*>(gD), Bsz, n_clusters, LDs, DiDs, Di);
  return cudaGetLastError();
}

// Runs the statements that follow with LANES and NPT bound to the split
// (lanes, npt): DISPATCH_SPLIT_8 for NPT up to 8, DISPATCH_SPLIT_16 up to 16.
#define SPLIT_CASE(L_, N_, ...)           \
  if (lanes == L_ && npt == N_) {         \
    constexpr int LANES = L_, NPT = N_;   \
    __VA_ARGS__                           \
  }
#define SPLIT_LANES(N_, ...)        \
  SPLIT_CASE(4, N_, __VA_ARGS__)    \
  SPLIT_CASE(8, N_, __VA_ARGS__)    \
  SPLIT_CASE(16, N_, __VA_ARGS__)
#define DISPATCH_SPLIT_8(...)     \
  SPLIT_LANES(1, __VA_ARGS__)     \
  SPLIT_LANES(2, __VA_ARGS__)     \
  SPLIT_LANES(4, __VA_ARGS__)     \
  SPLIT_LANES(8, __VA_ARGS__)
#define DISPATCH_SPLIT_16(...)    \
  DISPATCH_SPLIT_8(__VA_ARGS__)   \
  SPLIT_LANES(16, __VA_ARGS__)

}  // namespace

// dtype: dtype code of u, B, C and y (kF32 or kBF16).  Shapes: u, dt, y
// (Bsz, L, Di); A (Di, Ds); B, C (Bsz, L, Ds); D (Di) or nullptr; h0 (Bsz, Di,
// Ds) or nullptr; h_last (Bsz, Di, Ds); h_starts (Bsz, ceil(L / chunk), Di,
// Ds) or nullptr; all contiguous.  lanes: threads per channel, 4, 8 or 16,
// with d_state <= 16 lanes; with h_starts, chunk is a positive multiple of
// 16.  Returns the launch's CUDA error.
extern "C" int selective_scan_fwd(int dtype, const void* u, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, const void* D,
                                  const void* h0, void* y, void* h_last, void* h_starts,
                                  int Bsz, int L, int Di, int Ds, int chunk, int lanes,
                                  void* stream) {
  if (Ds < 1 || (lanes != 4 && lanes != 8 && lanes != 16) || Ds > 16 * lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (h_starts != nullptr && (chunk < kSteps || chunk % kSteps != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h_starts == nullptr) chunk = kSteps;  // unused; keeps t0 % chunk defined
  const int npt = npt_of(Ds, lanes);
  const int esize = dtype == kBF16 ? 2 : 4;
  int flags = 0;
  if (aligned16(Bm) && aligned16(Cm) && Ds * esize % 16 == 0) flags |= kVecBC;
  if (aligned16(u) && aligned16(dt) && Di % 8 == 0) flags |= kVecCh;
  if (aligned16(h0) && aligned16(h_last) && aligned16(h_starts) && Ds % 4 == 0)
    flags |= kVecState;
  if (aligned16(y) && Di % 8 == 0) flags |= kVecOut;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dtype, T, {
    DISPATCH_SPLIT_16({
      return static_cast<int>((launch_fwd<T, LANES, NPT>(u, dt, A, Bm, Cm, D, h0, y, h_last,
                                                         h_starts, Bsz, L, Di, Ds, chunk, flags,
                                                         st)));
    })
  })
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many of K2's clusters the card holds at once (as the occupancy
// calculator sees it), for this dtype, d_state, chunk, lanes and cluster
// size; negative: minus the CUDA error.
extern "C" int selective_scan_bwd_clusters_at_once(int dtype, int Ds, int chunk, int lanes,
                                                   int cluster) {
  if (Ds < 1 || (lanes != 4 && lanes != 8 && lanes != 16) || Ds > 8 * lanes || chunk < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  const int npt = npt_of(Ds, lanes);
  DISPATCH_DTYPE(dtype, T, {
    DISPATCH_SPLIT_8({
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      cudaError_t e = bwd_config<T, LANES, NPT>(&cfg, attr, 1, 1, chunk, cluster, nullptr);
      int n = 0;
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveClusters(&n, scan_bwd_kernel<T, LANES, NPT>, &cfg);
      return e == cudaSuccess ? n : -static_cast<int>(e);
    })
  })
  return -static_cast<int>(cudaErrorInvalidValue);
}

// dtype: dtype code of u, B, C, gy, gu, gB and gC.  Shapes as in
// selective_scan_fwd, plus gy, gu, gdt (Bsz, L, Di); gB, gC (Bsz, L, Ds); gA
// (Di, Ds); gD (Di); gh_last, gh0 (Bsz, Di, Ds); fp32 scratch: part (2, Bsz,
// n_clusters, L, Ds) with n_clusters = ceil(ceil(Di / (256 / lanes)) /
// cluster), gA_part (Bsz, Di, Ds), gD_part (Bsz, Di).  h_starts is K1's
// output at the same chunk.  lanes 4, 8 or 16 with d_state <= 8 lanes;
// cluster (blocks that sum gB/gC through distributed shared memory) 1, 2, 4
// or 8; chunk >= 1 with bwd_smem_bytes <= 227 KB.  Returns the first CUDA
// error of its two launches.
extern "C" int selective_scan_bwd(int dtype, const void* u, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, const void* D,
                                  const void* h_starts, const void* gy, const void* gh_last,
                                  void* gu, void* gdt, void* gB, void* gC, void* gA, void* gD,
                                  void* gh0, void* part, void* gA_part, void* gD_part, int Bsz,
                                  int L, int Di, int Ds, int chunk, int lanes, int cluster,
                                  void* stream) {
  if (Ds < 1 || (lanes != 4 && lanes != 8 && lanes != 16) || Ds > 8 * lanes || chunk < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int npt = npt_of(Ds, lanes);
  const int esize = dtype == kBF16 ? 2 : 4;
  if (bwd_smem_bytes(lanes, npt, chunk, esize) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  int flags = 0;
  if (aligned16(Bm) && aligned16(Cm) && Ds * esize % 16 == 0) flags |= kVecBC;
  if (aligned16(u) && aligned16(dt) && aligned16(gy) && Di % 8 == 0) flags |= kVecCh;
  if (aligned16(h_starts) && aligned16(gh_last) && aligned16(gh0) && aligned16(gA_part) &&
      Ds % 4 == 0)
    flags |= kVecState;
  if (aligned16(gu) && aligned16(gdt) && Di % 8 == 0) flags |= kVecOut;
  if (aligned16(part) && Ds % 4 == 0) flags |= kVecPart;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dtype, T, {
    DISPATCH_SPLIT_8({
      return static_cast<int>((launch_bwd<T, LANES, NPT>(
          u, dt, A, Bm, Cm, D, h_starts, gy, gh_last, gu, gdt, gB, gC, gA, gD, gh0, part,
          gA_part, gD_part, Bsz, L, Di, Ds, chunk, cluster, flags, st)));
    })
  })
  return static_cast<int>(cudaErrorInvalidValue);
}
