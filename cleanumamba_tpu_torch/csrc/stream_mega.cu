// K5: one whole block-1 streaming frame in one launch, for Hopper, sm_90a.
//
// Replaces: cleanumamba_tpu/ops/pallas/stream_mega.py
//   mega_stream_step (def :727, pallas_call :796, body _mega_kernel :454).
//   Per stream and frame: D encoder levels (window product, bias, ReLU, 1x1
//   mix, GLU; the level's cache rolled), conv1, the bottleneck stack of one
//   of five families on one token (mamba, mamba2, lstm, mamba_s4, mha, each
//   with its state update), conv2, D decoder levels (skip-add, mix, GLU,
//   ConvTranspose as lo/hi taps, overlap-add of the carried tail, next tail).
//   Weights are fp32 or bf16 (the pack's compute dtype TW); activations are
//   rounded to TW where the TPU kernel rounds them (after each product);
//   biases, norms, transcendentals and every state are fp32.
//
// What bounds it on this card: one block runs on one of 132 SMs, and a frame
// is a chain of ~20-40 dependent stages (2-3 per level, 5-10 per bottleneck
// layer) with a block-wide barrier after each.  The bytes (every weight
// once per frame, 0.5-8 MB, from L2) and the operations (~7 M multiply-adds
// at the released 0.4 M-parameter geometry) are 1/400 of its time.  Measured
// (PERF.md): the time follows the multi-row products of the outer levels
// (rows x width^2; about two thirds of a frame at that geometry, at a sixth
// of one SM's fp32 rate) over a fixed part of the chain's latency; a
// bottleneck layer adds ~10 us.
//
// Design: one thread block per stream (grid = B), 512 threads, walking the
// levels in order.  The frame's activations live in three shared-memory
// buffers that rotate (input window, hidden, output); the encoder caches,
// which are the decoder's skips, are read from and written to device
// memory, into separate output buffers (a step is repeatable: the skip of a
// frame is the head of the OLD cache).  Weights are read straight from
// device memory, neighbouring threads on neighbouring output columns; they
// stay in L2 from frame to frame.  Every product is one loop shape: a thread
// owns one output column and 1 or 4 rows, accumulates in fp32 registers over
// the whole contraction (one order, no atomics), and applies the epilogue.
// The strided conv window, the channel splits of the projections and the
// decoder's ungrouping are index arithmetic (the TPU pack's one-hot
// selection matrices and lane splits have no counterpart).  The
// ConvTranspose runs over virtual rows t = 0..T as in K4, so overlap-add and
// the bias-free tail come out of one epilogue.  A table of int32 offsets and
// dimensions (ops/cuda/stream_mega.py::pack_mega) describes the model, since
// widths are per layer in a pruned model; state pointers come by value.
#include "common.cuh"

namespace {

// Layout of the table; mirrors ops/cuda/stream_mega.py.
constexpr int kHdr = 32, kMaxD = 12, kMaxL = 8, kRec = 16, kBRec = 24;
constexpr int kEncBase = kHdr;
constexpr int kDecBase = kEncBase + kMaxD * kRec;
constexpr int kBottBase = kDecBase + kMaxD * kRec;
constexpr int kNVec = 10;
constexpr int kMaxPtrs = 128;
constexpr int kMaxThreads = 512;
static_assert(4 * kMaxD + 6 * kMaxL + 2 <= kMaxPtrs, "state pointers fit the by-value table");

enum Kind { kMamba = 0, kMamba2 = 1, kLstm = 2, kS4 = 3, kMha = 4 };
enum Act { kSigmoid = 0, kReLU = 1, kSiLU = 2, kGELU = 3 };

struct Ptrs {
  void* p[kMaxPtrs];
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float silu_f(float x) { return x / (1.f + expf(-x)); }
__device__ __forceinline__ float softplus_f(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kSigmoid: return sigmoid_f(x);
    case kReLU: return fmaxf(x, 0.f);
    case kSiLU: return silu_f(x);
    default: {  // GELU, tanh approximation (the GLU gate's form)
      const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
    }
  }
}

// epi(t, n, acc) for t < T, n < N with acc[w] = sum_k in[t*ld + k] * W[w][k*ldw + n].
// `in` is shared memory; a thread owns column n of RT consecutive rows.
template <int RT, int NW, typename TW, typename Epi>
__device__ __forceinline__ void gemm_rt(const float* in, int ld, int T, const TW* const (&W)[NW],
                                        int ldw, int Kc, int N, Epi&& epi) {
  const int tiles = (T + RT - 1) / RT;
  for (int e = threadIdx.x; e < tiles * N; e += blockDim.x) {
    const int n = e % N, t0 = (e / N) * RT;
    const float* rows[RT];
    float acc[RT][NW];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      rows[r] = in + (size_t)min(t0 + r, T - 1) * ld;
#pragma unroll
      for (int w = 0; w < NW; ++w) acc[r][w] = 0.f;
    }
    for (int k = 0; k < Kc; ++k) {
      float wv[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) wv[w] = to_f32(W[w][(size_t)k * ldw + n]);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float xv = rows[r][k];
#pragma unroll
        for (int w = 0; w < NW; ++w) acc[r][w] = fmaf(xv, wv[w], acc[r][w]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (t0 + r < T) epi(t0 + r, n, acc[r]);
  }
}

// Four rows a thread where that still gives every thread work, else one.
template <int NW, typename TW, typename Epi>
__device__ __forceinline__ void gemm(const float* in, int ld, int T, const TW* const (&W)[NW],
                                     int ldw, int Kc, int N, Epi&& epi) {
  if (T % 4 == 0 && (T / 4) * N >= (int)blockDim.x)
    gemm_rt<4, NW>(in, ld, T, W, ldw, Kc, N, epi);
  else
    gemm_rt<1, NW>(in, ld, T, W, ldw, Kc, N, epi);
}

// The transposed conv (K = 2S) over virtual rows t = 0..T: epi(t, n, lo, hi) with
//   lo = g[t] . ct[:, n]  (0 at t = T),  hi = g[t-1] . ct[:, N + n]  (0 at t = 0),
// g (T, Cg) in shared memory, ct (Cg, 2N) the lo taps then the hi taps.
template <int RT, typename TW, typename Epi>
__device__ __forceinline__ void convt_rt(const float* g, int T, int Cg, const TW* ct, int N,
                                         Epi&& epi) {
  const int rows = T + 1, tiles = (rows + RT - 1) / RT;
  for (int e = threadIdx.x; e < tiles * N; e += blockDim.x) {
    const int n = e % N, t0 = (e / N) * RT;
    const float* gp[RT + 1];
    bool ok[RT + 1];
#pragma unroll
    for (int q = 0; q <= RT; ++q) {
      const int t = t0 - 1 + q;
      ok[q] = t >= 0 && t < T;
      gp[q] = g + (size_t)(ok[q] ? t : 0) * Cg;
    }
    float lo[RT], hi[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) lo[r] = hi[r] = 0.f;
    for (int k = 0; k < Cg; ++k) {
      const float wl = to_f32(ct[(size_t)k * 2 * N + n]);
      const float wh = to_f32(ct[(size_t)k * 2 * N + N + n]);
      float gv[RT + 1];
#pragma unroll
      for (int q = 0; q <= RT; ++q) gv[q] = ok[q] ? gp[q][k] : 0.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        lo[r] = fmaf(gv[r + 1], wl, lo[r]);
        hi[r] = fmaf(gv[r], wh, hi[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (t0 + r < rows) epi(t0 + r, n, lo[r], hi[r]);
  }
}

// out[i] = norm(in)[i] * scale[i] (+ bias[i]), i < n; RMSNorm or LayerNorm with
// fp32 statistics, which every thread computes for itself from shared
// memory (n is a model width: tens of values).  in and out are distinct.
template <typename TW>
__device__ __forceinline__ void norm_vec(float* out, const float* in, int n, const float* scale,
                                         const float* bias, bool rms, float eps, bool round) {
  float mu = 0.f, ss = 0.f;
  if (!rms) {
    for (int k = 0; k < n; ++k) mu += in[k];
    mu /= n;
  }
  for (int k = 0; k < n; ++k) ss += (in[k] - mu) * (in[k] - mu);
  const float inv = rsqrtf(ss / n + eps);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = (in[i] - mu) * inv * scale[i];
    if (bias != nullptr) v += bias[i];
    out[i] = round ? round_to<TW>(v) : v;
  }
}

// Roll a depthwise-conv window and convolve: win_out[k] = win_in[k+1] (rounded
// to TW), win_out[dc-1] = fresh; xc[c] = TW(silu(TW(sum_k win_out[k][c] * cw[k][c] + cb[c]))).
template <typename TW>
__device__ __forceinline__ void rolled_conv(const float* win_in, float* win_out,
                                            const float* fresh, const TW* cw, const float* cb,
                                            int dc, int C, float* xc) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < dc; ++k) {
      const float v = k < dc - 1 ? round_to<TW>(win_in[(k + 1) * C + c]) : fresh[c];
      win_out[k * C + c] = v;
      acc = fmaf(v, to_f32(cw[k * C + c]), acc);
    }
    xc[c] = round_to<TW>(silu_f(round_to<TW>(acc + cb[c])));
  }
}

// One selective-scan step of channel i: h' = exp(dt*A)*h + dt*x*B, y = <h', C> + D*x.
__device__ __forceinline__ float scan_channel(const float* h_in, float* h_out, const float* A,
                                              const float* Bv, const float* Cv, int ds,
                                              float dt, float xv, float Dv) {
  float y = 0.f;
  for (int s = 0; s < ds; ++s) {
    const float h = expf(dt * A[s]) * h_in[s] + dt * xv * Bv[s];
    h_out[s] = h;
    y = fmaf(h, Cv[s], y);
  }
  return y + xv * Dv;
}

template <typename TW>
__global__ void __launch_bounds__(kMaxThreads)
mega_kernel(const float* __restrict__ x, float* __restrict__ out, const TW* __restrict__ W,
            const float* __restrict__ F, const int* __restrict__ tab, const Ptrs ptrs) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int kind = tab[0], D = tab[1], K = tab[2], S = tab[3], FL = tab[4], TS = tab[5];
  const int act = tab[6], L = tab[8], dm = tab[9], Clast = tab[10];
  const int n_head = tab[11], bufN = tab[12], vecN = tab[13], max_len = tab[14];
  const bool rms = tab[7] != 0;
  const float eps = __int_as_float(tab[15]);
  float* const bufs[3] = {smem, smem + bufN, smem + 2 * bufN};
  float* const vecs = smem + 3 * bufN;
  float* const gdeep = vecs + kNVec * vecN;  // the deepest level's new row
#define VEC(i) (vecs + (i) * vecN)
#define PTR_F(i) (static_cast<float*>(ptrs.p[i]))
  auto R = [](float v) { return round_to<TW>(v); };

  // ---------------- encoder ----------------
  int in = 0, ob = 2;
  {
    const int rows = S * (tab[kEncBase] + 1);  // level 0's window of the frame
    for (int e = tid; e < rows; e += nt) bufs[0][e] = R(x[(size_t)b * FL + FL - rows + e]);
  }
  __syncthreads();
  for (int i = 0; i < D; ++i) {
    const int* r = tab + kEncBase + i * kRec;
    const int T = r[0], Cin = r[1], C = r[2], N2 = r[3], cache = r[4];
    const TW* const cw[1] = {W + r[5]};
    const float* cb = F + r[6];
    const TW* const mw[2] = {W + r[7], W + r[7] + N2};
    const float* mb = F + r[8];
    float* H = bufs[1];
    // window t is rows S*t .. S*t + K - 1 of the input, contiguous: ld = S*Cin
    gemm<1>(bufs[in], S * Cin, T, cw, C, K * Cin, C, [&](int t, int n, const float* a) {
      H[t * C + n] = R(fmaxf(a[0] + cb[n], 0.f));
    });
    __syncthreads();
    const float* old = cache > 0 ? PTR_F(i) + (size_t)b * cache * N2 : nullptr;
    float* fresh = cache > 0 ? PTR_F(D + i) + (size_t)b * cache * N2 : nullptr;
    // the new rows go behind S header rows of the next level's input window
    // (the deepest level's single row goes to gdeep) and to the cache's end
    float* G = i == D - 1 ? gdeep : bufs[ob] + S * N2;
    gemm<2>(H, C, T, mw, 2 * N2, C, N2, [&](int t, int n, const float* a) {
      const float g = R((a[0] + mb[n]) * activate(a[1] + mb[N2 + n], act));
      G[t * N2 + n] = g;
      if (fresh != nullptr) fresh[(size_t)(cache - T + t) * N2 + n] = g;
    });
    if (cache > 0) {
      for (int e = tid; e < (cache - T) * N2; e += nt) fresh[e] = R(old[e + T * N2]);
      if (i < D - 1)
        for (int e = tid; e < S * N2; e += nt) bufs[ob][e] = R(old[(cache - S) * N2 + e]);
    }
    __syncthreads();
    const int tmp = in;
    in = ob;
    ob = tmp;
  }

  // ---------------- bottleneck: one token ----------------
  {
    const TW* const c1w[1] = {W + tab[16]};
    const float* c1b = F + tab[17];
    gemm<1>(gdeep, Clast, 1, c1w, dm, Clast, dm,
            [&](int, int n, const float* a) { VEC(0)[n] = a[0] + c1b[n]; });
    __syncthreads();
  }
  const float* nfs = tab[20] >= 0 ? F + tab[20] : nullptr;
  const float* nfb = tab[21] >= 0 ? F + tab[21] : nullptr;
  const int pin = 4 * D, pout = 4 * D + 3 * L;
  int tok_dim = dm;  // width of the token handed to conv2, in VEC(2)

  if (kind == kLstm) {
    for (int n = tid; n < dm; n += nt) VEC(2)[n] = R(VEC(0)[n]);
    __syncthreads();
    for (int li = 0; li < L; ++li) {
      const int* r = tab + kBottBase + li * kBRec;
      const int H = r[0], In = r[1];
      const TW* const wx[1] = {W + r[4]};  // [w_ih; w_hh], (In + H, 4H)
      const float* bias = F + r[6];
      const float* h_in = PTR_F(pin + 3 * li) + (size_t)b * H;
      const float* c_in = PTR_F(pin + 3 * li + 1) + (size_t)b * H;
      float* h_out = PTR_F(pout + 3 * li) + (size_t)b * H;
      float* c_out = PTR_F(pout + 3 * li + 1) + (size_t)b * H;
      for (int n = tid; n < In + H; n += nt) VEC(4)[n] = n < In ? VEC(2)[n] : R(h_in[n - In]);
      __syncthreads();
      gemm<1>(VEC(4), In + H, 1, wx, 4 * H, In + H, 4 * H,
              [&](int, int n, const float* a) { VEC(3)[n] = R(a[0] + bias[n]); });
      __syncthreads();
      for (int j = tid; j < H; j += nt) {
        const float gi = VEC(3)[j], gf = VEC(3)[H + j], gg = VEC(3)[2 * H + j],
                    go = VEC(3)[3 * H + j];
        const float c = R(sigmoid_f(gf)) * c_in[j] + R(R(sigmoid_f(gi)) * R(tanhf(gg)));
        const float h = R(R(sigmoid_f(go)) * tanhf(c));
        c_out[j] = c;
        h_out[j] = h;
        VEC(2)[j] = h;
      }
      __syncthreads();
      tok_dim = H;
    }
  } else if (kind == kMha) {
    const int M = max_len;
    const int pos = *static_cast<const int*>(ptrs.p[4 * D + 6 * L]);
    const int slot = pos % M, n_valid = min(pos, M - 1) + 1;
    if (b == 0 && tid == 0) *static_cast<int*>(ptrs.p[4 * D + 6 * L + 1]) = pos + 1;
    float* logits = smem;             // (M, n_head), across the activation buffers
    float* partial = smem + M * n_head;
    norm_vec<TW>(VEC(2), VEC(0), dm, nfs, nfb, false, eps, true);  // the encoder's input norm
    __syncthreads();
    for (int li = 0; li < L; ++li) {
      const int* r = tab + kBottBase + li * kBRec;
      const int d = r[0], dff = r[1], dk = d / n_head;
      const float inv_sqrt_dk = rsqrtf((float)dk);
      const TW* const qkv[3] = {W + r[4], W + r[5], W + r[6]};
      const TW* const fc[1] = {W + r[7]};
      const TW* const f1[1] = {W + r[10]};
      const TW* const f2[1] = {W + r[12]};
      const float* f1b = F + r[11];
      const float* f2b = F + r[13];
      const size_t ring = (size_t)b * M * d;
      const float* k_in = PTR_F(pin + 3 * li) + ring;
      const float* v_in = PTR_F(pin + 3 * li + 1) + ring;
      float* k_out = PTR_F(pout + 3 * li) + ring;
      float* v_out = PTR_F(pout + 3 * li + 1) + ring;
      gemm<3>(VEC(2), d, 1, qkv, d, d, d, [&](int, int n, const float* a) {
        VEC(3)[n] = a[0];
        VEC(4)[n] = a[1];
        VEC(5)[n] = a[2];
      });
      __syncthreads();
      // logits of every ring slot and head, the K ring copied with this step's row
      for (int e = tid; e < M * n_head; e += nt) {
        const int m = e / n_head, h = e % n_head;
        float dot = 0.f;
        for (int c = h * dk; c < (h + 1) * dk; ++c) {
          const float kv = m == slot ? VEC(4)[c] : k_in[(size_t)m * d + c];
          k_out[(size_t)m * d + c] = kv;
          dot = fmaf(kv, VEC(3)[c], dot);
        }
        logits[e] = m < n_valid ? dot * inv_sqrt_dk : -1e9f;
      }
      __syncthreads();
      // softmax over the slots, one warp per head
      for (int h = tid / 32; h < n_head; h += nt / 32) {
        const int lane = tid % 32;
        float mx = -3.0e38f, sum = 0.f;
        for (int m = lane; m < M; m += 32) mx = fmaxf(mx, logits[m * n_head + h]);
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        for (int m = lane; m < M; m += 32) {
          const float p = expf(logits[m * n_head + h] - mx);
          logits[m * n_head + h] = p;
          sum += p;
        }
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float inv = 1.f / sum;
        for (int m = lane; m < M; m += 32) logits[m * n_head + h] *= inv;
      }
      __syncthreads();
      // a[c] = sum_m attn[m, head(c)] * v[m, c]: groups of d threads split the
      // slots; the V ring copied with this step's row
      const int groups = nt / d;
      if (tid < groups * d) {
        const int c = tid % d, grp = tid / d;
        float part = 0.f;
        for (int m = grp; m < M; m += groups) {
          const float vv = m == slot ? VEC(5)[c] : v_in[(size_t)m * d + c];
          v_out[(size_t)m * d + c] = vv;
          part = fmaf(logits[m * n_head + c / dk], vv, part);
        }
        partial[grp * d + c] = part;
      }
      __syncthreads();
      for (int c = tid; c < d; c += nt) {
        float a = 0.f;
        for (int grp = 0; grp < groups; ++grp) a += partial[grp * d + c];
        VEC(6)[c] = R(a);
      }
      __syncthreads();
      gemm<1>(VEC(6), d, 1, fc, d, d, d,
              [&](int, int n, const float* a) { VEC(7)[n] = a[0] + VEC(2)[n]; });
      __syncthreads();
      norm_vec<TW>(VEC(2), VEC(7), d, F + r[8], F + r[9], false, eps, true);
      __syncthreads();
      gemm<1>(VEC(2), d, 1, f1, dff, d, dff,
              [&](int, int n, const float* a) { VEC(3)[n] = R(fmaxf(a[0] + f1b[n], 0.f)); });
      __syncthreads();
      gemm<1>(VEC(3), dff, 1, f2, d, dff, d,
              [&](int, int n, const float* a) { VEC(7)[n] = a[0] + f2b[n] + VEC(2)[n]; });
      __syncthreads();
      norm_vec<TW>(VEC(2), VEC(7), d, F + r[14], F + r[15], false, eps, true);
      __syncthreads();
    }
  } else {
    // pre-norm residual blocks: VEC(0) residual, VEC(1) the mixer's output
    for (int li = 0; li < L; ++li) {
      const int* r = tab + kBottBase + li * kBRec;
      const int di = r[0], dc = r[3];
      const TW* const w_in[1] = {W + r[4]};
      const TW* conv_w = W + r[5];
      const float* conv_b = F + r[6];
      const TW* const w_out[1] = {W + r[12]};
      const float* ns = F + r[13];
      const float* nb = r[14] >= 0 ? F + r[14] : nullptr;
      if (li > 0) {
        for (int n = tid; n < dm; n += nt) VEC(0)[n] += VEC(1)[n];
        __syncthreads();
      }
      norm_vec<TW>(VEC(2), VEC(0), dm, ns, nb, rms, eps, true);
      __syncthreads();
      if (kind == kMamba) {
        const int ds = r[1], dr = r[2];
        const TW* const xp[1] = {W + r[7]};
        const TW* const dtw[1] = {W + r[8]};
        const float* dtb = F + r[9];
        const float* A = F + r[10];
        const float* Dv = F + r[11];
        const float* win_in = PTR_F(pin + 3 * li) + (size_t)b * dc * di;
        float* win_out = PTR_F(pout + 3 * li) + (size_t)b * dc * di;
        const float* h_in = PTR_F(pin + 3 * li + 1) + (size_t)b * di * ds;
        float* h_out = PTR_F(pout + 3 * li + 1) + (size_t)b * di * ds;
        gemm<1>(VEC(2), dm, 1, w_in, 2 * di, dm, 2 * di,
                [&](int, int n, const float* a) { VEC(3)[n] = R(a[0]); });  // x | z
        __syncthreads();
        rolled_conv<TW>(win_in, win_out, VEC(3), conv_w, conv_b, dc, di, VEC(4));
        __syncthreads();
        gemm<1>(VEC(4), di, 1, xp, dr + 2 * ds, di, dr + 2 * ds, [&](int, int n, const float* a) {
          VEC(5)[n] = n < dr ? R(a[0]) : a[0];  // dt (rounded) | B | C
        });
        __syncthreads();
        gemm<1>(VEC(5), dr, 1, dtw, di, dr, di,
                [&](int, int n, const float* a) { VEC(6)[n] = softplus_f(a[0] + dtb[n]); });
        __syncthreads();
        for (int i = tid; i < di; i += nt) {
          const float y = scan_channel(h_in + i * ds, h_out + i * ds, A + i * ds, VEC(5) + dr,
                                       VEC(5) + dr + ds, ds, VEC(6)[i], VEC(4)[i], Dv[i]);
          VEC(7)[i] = R(R(y) * R(silu_f(VEC(3)[di + i])));
        }
        __syncthreads();
        gemm<1>(VEC(7), di, 1, w_out, dm, di, dm,
                [&](int, int n, const float* a) { VEC(1)[n] = a[0]; });
      } else if (kind == kMamba2) {
        const int ds = r[1], nh = r[2], hd = di / nh, cc = di + 2 * ds, nin = 2 * di + 2 * ds + nh;
        const float* dtb = F + r[7];
        const float* A = F + r[10];
        const float* Dv = F + r[11];
        const float* nw = F + r[15];
        const float* win_in = PTR_F(pin + 3 * li) + (size_t)b * dc * cc;
        float* win_out = PTR_F(pout + 3 * li) + (size_t)b * dc * cc;
        const float* h_in = PTR_F(pin + 3 * li + 1) + (size_t)b * di * ds;
        float* h_out = PTR_F(pout + 3 * li + 1) + (size_t)b * di * ds;
        gemm<1>(VEC(2), dm, 1, w_in, nin, dm, nin, [&](int, int n, const float* a) {
          VEC(3)[n] = n < di + cc ? R(a[0]) : a[0];  // z | x B C (rounded) | dt per head
        });
        __syncthreads();
        rolled_conv<TW>(win_in, win_out, VEC(3) + di, conv_w, conv_b, dc, cc, VEC(4));
        __syncthreads();
        for (int i = tid; i < di; i += nt) {
          const float dt = softplus_f(VEC(3)[di + cc + i / hd] + dtb[i / hd]);
          const float y = scan_channel(h_in + i * ds, h_out + i * ds, A + i * ds, VEC(4) + di,
                                       VEC(4) + di + ds, ds, dt, VEC(4)[i], Dv[i]);
          VEC(7)[i] = y * silu_f(VEC(3)[i]);
        }
        __syncthreads();
        {  // gated RMSNorm, eps 1e-5
          float ss = 0.f;
          for (int k = 0; k < di; ++k) ss += VEC(7)[k] * VEC(7)[k];
          const float inv = rsqrtf(ss / di + 1e-5f);
          for (int i = tid; i < di; i += nt) VEC(5)[i] = R(VEC(7)[i] * inv * nw[i]);
        }
        __syncthreads();
        gemm<1>(VEC(5), di, 1, w_out, dm, di, dm,
                [&](int, int n, const float* a) { VEC(1)[n] = a[0]; });
      } else {  // mamba_s4
        const int Hh = r[1], Ns = r[2];
        const TW* const ulw[1] = {W + r[7]};
        const float* ulb = F + r[8];
        const float2* dAt = reinterpret_cast<const float2*>(F + r[9]);   // [h][n][m]
        const float2* dB = reinterpret_cast<const float2*>(F + r[10]);   // [h][m]
        const float2* dC = reinterpret_cast<const float2*>(F + r[11]);   // [h][n]
        const float* Dv = F + r[15];
        const TW* const olw[2] = {W + r[16], W + r[16] + di};
        const float* olb = F + r[17];
        const float* win_in = PTR_F(pin + 3 * li) + (size_t)b * dc * di;
        float* win_out = PTR_F(pout + 3 * li) + (size_t)b * dc * di;
        const float2* s_in =
            reinterpret_cast<const float2*>(PTR_F(pin + 3 * li + 1)) + (size_t)b * Hh * Ns;
        float2* s_out = reinterpret_cast<float2*>(PTR_F(pout + 3 * li + 1)) + (size_t)b * Hh * Ns;
        gemm<1>(VEC(2), dm, 1, w_in, 2 * di, dm, 2 * di,
                [&](int, int n, const float* a) { VEC(3)[n] = R(a[0]); });  // x | z
        __syncthreads();
        rolled_conv<TW>(win_in, win_out, VEC(3), conv_w, conv_b, dc, di, VEC(4));
        __syncthreads();
        gemm<1>(VEC(4), di, 1, ulw, Hh, di, Hh,
                [&](int, int n, const float* a) { VEC(5)[n] = R(a[0] + ulb[n]); });
        __syncthreads();
        // s'[h, m] = sum_n dA[h, m, n] s[h, n] + dB[h, m] u[h], complex, dense per head
        for (int e = tid; e < Hh * Ns; e += nt) {
          const int h = e / Ns, m = e % Ns;
          float re = 0.f, im = 0.f;
          for (int n = 0; n < Ns; ++n) {
            const float2 a = dAt[((size_t)h * Ns + n) * Ns + m];
            const float2 s = s_in[h * Ns + n];
            re += a.x * s.x - a.y * s.y;
            im += a.x * s.y + a.y * s.x;
          }
          const float u = VEC(5)[h];
          s_out[e] = make_float2(re + dB[e].x * u, im + dB[e].y * u);
        }
        __syncthreads();  // s_out (device memory) is read back by this block
        for (int h = tid; h < Hh; h += nt) {
          float y = 0.f;
          for (int n = 0; n < Ns; ++n) {
            const float2 c = dC[h * Ns + n], s = s_out[h * Ns + n];
            y += c.x * s.x - c.y * s.y;
          }
          y += VEC(5)[h] * Dv[h];
          VEC(6)[h] = R(0.5f * y * (1.f + erff(y * 0.7071067811865476f)));  // exact GELU
        }
        __syncthreads();
        gemm<2>(VEC(6), Hh, 1, olw, 2 * di, Hh, di, [&](int, int n, const float* a) {
          const float g = R((a[0] + olb[n]) * sigmoid_f(a[1] + olb[di + n]));
          VEC(7)[n] = R(g * R(silu_f(VEC(3)[di + n])));
        });
        __syncthreads();
        gemm<1>(VEC(7), di, 1, w_out, dm, di, dm,
                [&](int, int n, const float* a) { VEC(1)[n] = a[0]; });
      }
      __syncthreads();
    }
    for (int n = tid; n < dm; n += nt) VEC(0)[n] += VEC(1)[n];
    __syncthreads();
    norm_vec<TW>(VEC(2), VEC(0), dm, nfs, nfb, rms, eps, true);
    __syncthreads();
  }
  {
    const TW* const c2w[1] = {W + tab[18]};
    const float* c2b = F + tab[19];
    gemm<1>(VEC(2), tok_dim, 1, c2w, Clast, tok_dim, Clast,
            [&](int, int n, const float* a) { bufs[0][n] = R(a[0] + c2b[n]); });
    __syncthreads();
  }

  // ---------------- decoder ----------------
  int xb = 0, zb = 2;
  for (int j = 0; j < D; ++j) {
    const int* r = tab + kDecBase + j * kRec;
    const int T = r[0], C = r[1], Cg = r[2], Cout = r[3], enc_i = r[4];
    const TW* const mw[2] = {W + r[5], W + r[5] + Cg};
    const float* mb = F + r[6];
    const TW* ct = W + r[7];
    const float* cb = F + r[8];
    const int N = S * Cout;
    float* XD = bufs[xb];
    float* G = bufs[1];
    float* Z = bufs[zb];
    // the skip: the first T rows of the level's frame output, which lie in
    // the OLD cache (the deepest level's single row is this frame's)
    const int cache = tab[kEncBase + enc_i * kRec + 4];
    const float* skip = cache > 0 ? PTR_F(enc_i) + (size_t)b * cache * C : gdeep;
    for (int e = tid; e < T * C; e += nt) XD[e] = R(XD[e] + R(skip[e]));
    __syncthreads();
    gemm<2>(XD, C, T, mw, 2 * Cg, C, Cg, [&](int t, int n, const float* a) {
      G[t * Cg + n] = R((a[0] + mb[n]) * activate(a[1] + mb[Cg + n], act));
    });
    __syncthreads();
    const float* prev = PTR_F(2 * D + j) + (size_t)b * N;
    float* tail = PTR_F(3 * D + j) + (size_t)b * N;
    const bool last = j == D - 1;
    auto epi = [&](int t, int n, float lo, float hi) {
      if (t == T) {
        tail[n] = hi;  // the next frame's carry, stored without the bias
        return;
      }
      float z = lo + hi + cb[n % Cout];
      if (t == 0) z += prev[n];
      if (!last) z = fmaxf(z, 0.f);
      z = R(z);
      Z[t * N + n] = z;  // (T, S*Cout) is (T*S, Cout) token-major as it lies
      if (last && n % Cout == 0) out[(size_t)b * TS + t * S + n / Cout] = z;
    };
    if ((T + 1) >= 4 && ((T + 4) / 4) * N >= nt)
      convt_rt<4>(G, T, Cg, ct, N, epi);
    else
      convt_rt<1>(G, T, Cg, ct, N, epi);
    __syncthreads();
    const int tmp = xb;
    xb = zb;
    zb = tmp;
  }
#undef VEC
#undef PTR_F
}

}  // namespace

// K5.  tw: dtype code of the packed weights w.  x (B, frame_length) fp32;
// out (B, total_stride) fp32; f the fp32 pack; table the int32 description
// of the model; ptrs: n_ptrs = 128 host-side device pointers to the state
// (encoder caches in/out, decoder tails in/out, bottleneck state in/out, the
// MHA position in/out), all fp32 and contiguous.  One block of `threads`
// threads per stream with `smem_bytes` of dynamic shared memory.  Returns
// the CUDA error of the launch (0: none).
extern "C" int mega_stream_step(int tw, const void* x, void* out, const void* w, const void* f,
                                const void* table, const void* const* ptrs, int n_ptrs, int B,
                                int threads, int smem_bytes, void* stream) {
  if (B == 0) return 0;
  if (n_ptrs != kMaxPtrs || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Ptrs p;
  for (int i = 0; i < kMaxPtrs; ++i) p.p[i] = const_cast<void*>(ptrs[i]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(tw, TW, {
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          mega_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    mega_kernel<TW><<<B, threads, smem_bytes, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), static_cast<const TW*>(w),
        static_cast<const float*>(f), static_cast<const int*>(table), p);
  })
  return static_cast<int>(cudaGetLastError());
}
