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
//   biases, norms, transcendentals and every state are fp32.  Around it, the
//   input normalisation of cleanumamba_tpu/streaming.py::stream_step_mega
//   (the frame from the carried tail and the new samples, its population std
//   + 1e-3 folded into the running EMA, the frame scaled down and the output
//   up) runs inside the same launch when asked.
//
// What bounds it on this card: neither bytes (every weight once per frame,
// 0.5-8 MB, from L2) nor operations (~6 M multiply-adds at the released
// 0.4 M-parameter geometry) but latency: a frame is a chain of ~50 dependent
// products (two per level, 1-6 per bottleneck layer) and the stages between
// them.  The first version ran it on one block of one SM, each weight read
// from L2 at the moment of use, one serial contraction per thread; a per-stage
// clock (scripts/torch_k5_clock.py) put its time in the outer levels'
// multi-row products and in the single-token products' serial chains.  With
// those spread over a cluster, a product's fixed costs lead: its cluster
// barrier (~1,400 cycles), its epilogue's stores into the other blocks, a
// round trip to device memory.
//
// Design.
//  * A thread block cluster of C = 8, 4, 2 or 1 blocks per stream (the
//    wrapper takes the largest that costs no second wave of the card).  Every
//    block holds a copy of the frame's activations in shared memory.
//  * Each product is cut by a plan computed in Python at pack time
//    (ops/cuda/stream_mega.py::mega_plan) and read from an int32 table: a
//    large one into C blocks of rows x columns, whose outputs each block
//    writes into every block's copy (st.shared::cluster) before one cluster
//    barrier; a small one (<= 16 K multiply-adds; with bf16 weights also any
//    with no more outputs than a block has threads) whole in every block,
//    with no exchange and a block barrier only.  A cluster barrier precedes a
//    cut product only when the blocks did work of their own since the last
//    one; a level product only arrives at its barrier, and the next product
//    waits on it once that product's weights are in.
//  * Weights do not depend on activations, so each block's thread 0 copies
//    the slabs of its coming products (its columns of a product's weights,
//    laid out (K, weight set, columns) by the plan) with cp.async.bulk into a
//    ring of shared memory from the first microsecond, each completing on its
//    own mbarrier, and refills ring space as soon as the product that read it
//    has ended: several products ahead, never at the moment of use.  What
//    the encoder reads of its OLD caches is copied at the start too.
//  * A block's share of a product is contracted by one of a few shared
//    no-inline cores into a scratch of partial sums, then one epilogue loop
//    adds the parts in a fixed order.  SIMT cores: a thread owns a tile of
//    4 x 2, 2 x 2 or 1 x 1 outputs and, with fp32 weights, one of up to 32
//    strided parts of the contraction.  With fp32 weights, a level's product
//    of >= 8 rows a block runs on the tensor cores (mma m16n8k8, three TF32
//    products a step: fp32 accuracy).  With bf16 weights each output is one
//    thread's sum in k order (the first version's arithmetic): the tensor
//    cores' order moved a trained model's bf16 decoder tail past the checks'
//    bound.  No atomics: a repeated launch is bitwise equal.
//  * The stages between products (norms, depthwise conv, scan, LSTM cell) are
//    a few hundred operations and run in every block; only the owner of an
//    element writes it to device memory.  The attention splits the ring's
//    slots over the cluster (each block copies and scores its slots, then the
//    blocks' max, sum and weighted values are combined in rank order); the
//    dense S4 update splits its heads.
//  * The skip-add of a decoder level is folded into the previous product's
//    epilogue; overlap-add and the tail come out of the ConvTranspose's
//    epilogue over virtual rows t = 0..T as in K4.  State goes to new
//    tensors: the skip of a frame is the head of the OLD cache.
#include "common.cuh"

namespace {

// Layout of the model table; mirrors ops/cuda/stream_mega.py.
constexpr int kHdr = 32, kMaxD = 12, kMaxL = 8, kRec = 16, kBRec = 24;
constexpr int kEncBase = kHdr;
constexpr int kDecBase = kEncBase + kMaxD * kRec;
constexpr int kBottBase = kDecBase + kMaxD * kRec;
constexpr int kNVec = 10;
constexpr int kMaxPtrs = 128;
constexpr int kThreads = 512;
static_assert(4 * kMaxD + 6 * kMaxL + 2 <= kMaxPtrs, "state pointers fit the by-value table");
// Layout of the plan table (mega_plan): header, then per product and rank
// [split, first row, rows, first column, columns, slab offset in wk (elements),
//  slab bytes, ring offset (bytes; -1: read from wk), copied after product (-1: at start),
//  tensor cores (1) or not (0)].
constexpr int kPlanHdr = 16, kPlanRec = 10, kMaxProd = 96, kMaxCluster = 8;
constexpr int kTabLen = kBottBase + kMaxL * kBRec;
// Shared memory starts with the products' mbarriers (weights landed), then
// copies of the model table and of this block's plan records (read at every
// stage: no load from device memory on the chain), then the activations.
constexpr int kTabOff = 2048;
constexpr int kRecOff = kTabOff + 4 * kTabLen;
constexpr int kActOff = kRecOff + 4 * kMaxProd * kPlanRec;
static_assert(8 * kMaxProd <= kTabOff, "mbarriers fit before the tables");
static_assert(kActOff % 128 == 0, "the activations start aligned");

enum Kind { kMamba = 0, kMamba2 = 1, kLstm = 2, kS4 = 3, kMha = 4 };
enum Act { kSigmoid = 0, kReLU = 1, kSiLU = 2, kGELU = 3 };

struct Ptrs {
  void* p[kMaxPtrs];
};

// The frame's input and the normalisation state (nullptr where not asked).
struct IO {
  const float* tail;      // (B, FL - TS), row stride ld_tail
  const float* fresh;     // (B, TS), row stride ld_new
  const float* std_in;    // (B, 1)
  const int* frames_in;   // (B, 1)
  float* tail_out;        // (B, FL - TS)
  float* std_out;         // (B, 1)
  int* frames_out;        // (B, 1)
  float* out;             // (B, TS)
  int ld_tail, ld_new, normalize;
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

// Bring the line of p into L1: an epilogue's biases and skips, requested
// before the contraction so that their latency hides behind it.
__device__ __forceinline__ void prefetch(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

struct NoPrefetch {
  __device__ void operator()(int, int) const {}
};

// One block's view of the cluster and of its weight ring.
template <typename TW>
struct Ctx {
  unsigned char* smem;
  const int* recs;   // this block's plan records, in shared memory
  int nprod;
  const TW* wk;
  float* red;        // a split contraction's partial sums
  int red_n;         // their room, in floats
  const float* any;  // a readable row of shared memory, read in place of a missing row
  int rank, C, tid, nt;
  int next;          // thread 0: the next slab to copy
  bool split;        // the current product is cut over the cluster
  bool dirty;        // the block did work of its own since the last cluster barrier
  bool joined;       // a cluster barrier has passed: every block of the cluster runs
  bool pending;      // arrived at a cluster barrier whose wait is still to come

  __device__ const int* rec(int p) const { return recs + p * kPlanRec; }
  __device__ uint32_t bar(int p) const { return smem_addr(smem) + 8 * p; }

  // Thread 0: copy every slab whose ring space is free once product `done`
  // has ended (done = -1: at the start).
  __device__ void issue(int done) {
    for (; next < nprod; ++next) {
      const int* r = rec(next);
      if (r[7] < 0) continue;
      if (r[8] > done) break;
      mbar_expect_tx(bar(next), (uint32_t)r[6]);
      bulk_copy(smem_addr(smem + r[7]), wk + r[5], (uint32_t)r[6], bar(next));
    }
  }
  // v at p: in every block of the cluster for a cut product, else here.
  __device__ void put(float* p, float v) const {
    if (!split) {
      *p = v;
      return;
    }
    for (int r = 0; r < C; ++r) store_cluster(p, r, v);
  }
  // Whether this block writes output element e to device memory.
  __device__ bool owns(int e) const { return split || e % C == rank; }
  // The end of a stage that every block runs for itself.
  __device__ void local_sync() {
    __syncthreads();
    dirty = true;
  }
  __device__ void cluster_barrier() {
    settle();
    cluster_sync();
    dirty = false;
    joined = true;
  }
  // A cluster barrier in two halves: arrive now (what this block wrote into
  // the cluster is released), wait in settle() just before the block next
  // reads what the others wrote or writes into them.
  __device__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    pending = true;
    dirty = false;
    joined = true;
  }
  __device__ void settle() {
    if (!pending) return;
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    pending = false;
  }
  // Before the first store into another block's shared memory.
  __device__ void join() {
    if (!joined) cluster_barrier();
  }
};

// CT neighbouring staged weights as fp32.
template <int CT>
__device__ __forceinline__ void load_w(const float* p, float (&v)[CT]) {
  if constexpr (CT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *p;
  }
}
template <int CT>
__device__ __forceinline__ void load_w(const __nv_bfloat16* p, float (&v)[CT]) {
  if constexpr (CT == 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// Whether a product's contraction may be split over threads.  With bf16
// weights every output is one thread's sum in k order, as in the first version
// of this kernel: the activations are rounded to bf16 after each product, so a
// sum in another order flips a rounding now and then, and in a trained model
// such a flip can move a decoder tail by a few per cent of its largest value
// (the tensor cores' order moved the capstone checkpoint's by 2.09 %).
template <typename TW> constexpr bool kSplitK = true;
template <> constexpr bool kSplitK<__nv_bfloat16> = false;

// The input rows of a product: row t of weight set j is base + (t - lag * j) *
// stride, or a zero row (nullptr) outside [0, valid); a vector has stride 0.
struct Rows {
  const float* base;
  int stride, lag, valid;
  __device__ const float* at(int set, int t) const {
    const int g = t - lag * set;
    return g >= 0 && g < valid ? base + g * stride : nullptr;
  }
};
constexpr int kAnyRow = 1 << 30;
__device__ __forceinline__ Rows vector_rows(const float* v) { return Rows{v, 0, 0, kAnyRow}; }

// The contraction of a product: the block's rows t_begin .. t_begin + T and
// its nc columns, sum_k rows.at(set, t)[k] * w[k, j, c] for every weight set j
// (set 0, or j with NI = 2), into red[((part * T + t) * nc + c) * NW + j] for
// each of the returned number of parts of the contraction.  Each core is one
// function for every product of its shape: the frame's ~50 products run the
// same few cores from the instruction cache, where a copy inlined into each
// product (tens of KB of unrolled code each, once per frame) streams from L2.

// SIMT: a thread owns a tile of RT rows and CT neighbouring columns
// (neighbouring lanes on neighbouring tiles of a row: one load of CT weights
// and RT inputs feeds RT x CT x NW multiply-adds) and, with fp32 weights, one
// of ks strided parts of the contraction; ks grows while threads are idle and
// each part keeps 16 terms.
template <int RT, int CT, int NW, int NI, typename TW>
__device__ __noinline__ int simt_core(const TW* __restrict__ w, const Rows rows,
                                      const float* any, float* __restrict__ red, int red_n,
                                      int t_begin, int T, int nc, int Kc) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ct = nc / CT, items = (T + RT - 1) / RT * ct;
  int ks = 1;
  while (kSplitK<TW> && 2 * ks * items <= nt && 16 * ks <= Kc && 2 * ks * T * nc * NW <= red_n)
    ks *= 2;
  for (int e = tid; e < items * ks; e += nt) {
    const int item = e % items, part = e / items;
    const int c0 = (item % ct) * CT, t0 = (item / ct) * RT;
    const float* rp[NI][RT];
    bool ok[NI][RT];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        rp[i][r] = rows.at(i, t_begin + min(t0 + r, T - 1));
        ok[i][r] = rp[i][r] != nullptr;
        if (!ok[i][r]) rp[i][r] = any;  // the value read is not used
      }
    float acc[RT][CT][NW];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < CT; ++q)
#pragma unroll
        for (int j = 0; j < NW; ++j) acc[r][q][j] = 0.f;
    const TW* wc = w + c0;
#pragma unroll 4
    for (int k = part; k < Kc; k += ks) {
      float wv[NW][CT];
#pragma unroll
      for (int j = 0; j < NW; ++j) load_w<CT>(wc + (k * NW + j) * nc, wv[j]);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float x[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) x[i] = ok[i][r] ? rp[i][r][k] : 0.f;
#pragma unroll
        for (int q = 0; q < CT; ++q)
#pragma unroll
          for (int j = 0; j < NW; ++j)
            acc[r][q][j] = fmaf(x[NI == 1 ? 0 : j], wv[j][q], acc[r][q][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < CT; ++q)
        if (t0 + r < T)
#pragma unroll
          for (int j = 0; j < NW; ++j) red[((part * T + t0 + r) * nc + c0 + q) * NW + j] = acc[r][q][j];
  }
  return ks;
}

// ---- tensor cores, fp32 weights: three TF32 products a step keep fp32 accuracy ----

// D (16 x 8) += A (16 x 8) B (8 x 8) for k0 .. k0 + 7, transposed: the weights
// are A (16 output columns x k), the input rows B (k x 8 rows).  Lane
// (g = lane / 4, q = lane % 4) loads A's columns m_a = m0 + g, m_b = m0 + g + 8
// and B's row t0 + g (xr, read as zeros where xok is false); w(k, m) is
// w[k * ldw + m]; full: every k of the step lies within Kc (else the rest reads 0).
__device__ __forceinline__ void mma_step(float (&d)[4], const float* w, int ldw, int m_a, int m_b,
                                         const float* xr, bool xok, int k0, int q, int Kc,
                                         bool full) {
  const int k_a = k0 + q, k_b = k0 + q + 4;
  const bool ia = full || k_a < Kc, ib = full || k_b < Kc;
  float a[4], b[2];
  a[0] = ia ? w[k_a * ldw + m_a] : 0.f, a[1] = ia ? w[k_a * ldw + m_b] : 0.f;
  a[2] = ib ? w[k_b * ldw + m_a] : 0.f, a[3] = ib ? w[k_b * ldw + m_b] : 0.f;
  b[0] = ia && xok ? xr[k_a] : 0.f, b[1] = ib && xok ? xr[k_b] : 0.f;
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The tensor cores (the plan's choice for fp32 blocks of >= 8 rows): a warp
// owns tiles of 16 columns x 8 rows of one weight set and one of kp
// contiguous parts of the contraction.
template <int NW, int NI>
__device__ __noinline__ int mma_core(const float* __restrict__ w, const Rows rows,
                                     const float* any, float* __restrict__ red, int red_n,
                                     int t_begin, int T, int nc, int Kc) {
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int mt = (nc + 15) / 16, rt = (T + 7) / 8, units = mt * rt * NW;
  const int steps = (Kc + 7) / 8;
  int kp = 1;
  while (2 * kp * units <= warps && 4 * kp <= steps && 2 * kp * T * nc * NW <= red_n) kp *= 2;
  const int ldw = NW * nc;
  for (int u = warp; u < units * kp; u += warps) {
    const int unit = u % units, part = u / units;
    const int j = unit % NW, ti = (unit / NW) % rt, mi = unit / (NW * rt);
    const int m0 = 16 * mi, t0 = 8 * ti;
    const float* xr = rows.at(NI == 1 ? 0 : j, t_begin + min(t0 + g, T - 1));
    const bool ok = xr != nullptr;
    if (!ok) xr = any;
    // columns past nc read column nc - 1 and rows past T row T - 1: their sums are dropped
    const float* wj = w + j * nc;
    const int m_a = min(m0 + g, nc - 1), m_b = min(m0 + g + 8, nc - 1);
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    const int s1 = (part + 1) * steps / kp;
    for (int s = part * steps / kp; s < s1; ++s)
      mma_step(d, wj, ldw, m_a, m_b, xr, ok, 8 * s, q, Kc, 8 * s + 8 <= Kc);
    // d[i]: column m0 + g + 8 * (i / 2), row t0 + 2q + i % 2
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = m0 + g + 8 * (i / 2), t = t0 + 2 * q + i % 2;
      if (c < nc && t < T) red[((part * T + t) * nc + c) * NW + j] = d[i];
    }
  }
  return kp;
}

// Product p of the frame: epi(t, n, acc[NW]) for this block's rows and
// columns, acc[j] = sum_k rows.at(set, t)[k] * W_j[k, n] (set 0, or j with
// NI = 2), the contraction's parts added in one fixed order; pre(t, n) first
// prefetches what the epilogue will read.  Multi: the call site may have
// blocks of many rows, which the plan may send to the tensor cores (fp32).
// Rows go in chunks whose sums fit the reduction scratch.  Ends with a
// cluster barrier if the product is cut (only its arrival with defer: the
// next product waits once its weights are in), else a block barrier; then
// the ring space it read is refilled.  defer only where a product follows.
template <int NW, int NI, bool Multi = false, typename TW, typename Epi,
          typename Pre = NoPrefetch>
__device__ __forceinline__ void product(Ctx<TW>& cx, int p, int Kc, const Rows rows, Epi epi,
                                        Pre pre = Pre(), bool defer = false) {
  const int* r = cx.rec(p);
  cx.split = r[0] != 0;
  if (cx.split && cx.dirty) cx.cluster_barrier();  // nobody still reads what the blocks write
  const int t0 = r[1], T = r[2], n0 = r[3], nc = r[4];
  const TW* w = r[7] >= 0 ? reinterpret_cast<const TW*>(cx.smem + r[7]) : cx.wk + r[5];
  if (r[7] >= 0) mbar_wait(cx.bar(p), 0);
  for (int e = cx.tid; e < T * nc; e += cx.nt) pre(t0 + e / nc, n0 + e % nc);
  cx.settle();
  const int chunk = max(1, cx.red_n / max(1, nc * NW));
  for (int c0 = 0; c0 < T && nc > 0; c0 += chunk) {
    const int Tc = min(chunk, T - c0), tb = t0 + c0;
    int parts = 1;
    if (Multi && kSplitK<TW> && r[9] != 0) {
      if constexpr (Multi && kSplitK<TW>)
        parts = mma_core<NW, NI>(w, rows, cx.any, cx.red, cx.red_n, tb, Tc, nc, Kc);
    } else if (Tc >= 4 && nc % 2 == 0 && (kSplitK<TW> || (Tc + 3) / 4 * (nc / 2) >= cx.nt)) {
      // a larger tile where the split contraction keeps threads busy, or (bf16)
      // where there are still as many tiles as threads
      parts = simt_core<4, 2, NW, NI>(w, rows, cx.any, cx.red, cx.red_n, tb, Tc, nc, Kc);
    } else if (Tc >= 2 && nc % 2 == 0 && (kSplitK<TW> || (Tc + 1) / 2 * (nc / 2) >= cx.nt)) {
      parts = simt_core<2, 2, NW, NI>(w, rows, cx.any, cx.red, cx.red_n, tb, Tc, nc, Kc);
    } else {
      parts = simt_core<1, 1, NW, NI>(w, rows, cx.any, cx.red, cx.red_n, tb, Tc, nc, Kc);
    }
    __syncthreads();
    const int ps = Tc * nc * NW;  // floats between two parts' sums
    for (int e = cx.tid; e < Tc * nc; e += cx.nt) {
      float v[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        // parts q, q + 4, ... into one of four sums, then ((0 + 1) + (2 + 3))
        const float* s = cx.red + e * NW + j;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        int q = 0;
        for (; q + 4 <= parts; q += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u) a[u] += s[(q + u) * ps];
#pragma unroll
        for (int u = 0; u < 3; ++u)
          if (q + u < parts) a[u] += s[(q + u) * ps];
        v[j] = (a[0] + a[1]) + (a[2] + a[3]);
      }
      epi(tb + e / nc, n0 + e % nc, v);
    }
    if (c0 + chunk < T) __syncthreads();  // the next chunk's sums overwrite these
  }
  if (!cx.split)
    cx.local_sync();
  else if (defer)
    cx.cluster_arrive();
  else
    cx.cluster_barrier();
  if (cx.tid == 0) cx.issue(p);
}

// n floats of an OLD cache to copy from src to dst.
struct Span {
  const float* src;
  float* dst;
  int n;
};

// The concatenation of spans(0) .. spans(count - 1), rounded to TW: element
// g by the threads first, first + stride, ...  Eight elements' loads go out
// before their stores: a thread waits on device memory once per eight
// elements, not once per element.
template <typename TW, typename Spans>
__device__ __forceinline__ void gather_copy(Spans spans, int count, int first, int stride) {
  int total = 0;
  for (int i = 0; i < count; ++i) total += spans(i).n;
  for (int base = first; base < total; base += 8 * stride) {
    float v[8];
    float* dst[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      int g = base + u * stride, i = 0;
      dst[u] = nullptr;
      if (g >= total) continue;
      while (g >= spans(i).n) g -= spans(i++).n;
      const Span sp = spans(i);
      v[u] = sp.src[g];
      dst[u] = sp.dst + g;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (dst[u] != nullptr) *dst[u] = round_to<TW>(v[u]);
  }
}

// The sum of every thread's v, in one fixed order, returned to all threads.
// scratch: 32 floats of shared memory; ends with a block barrier.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warps = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < warps; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// out[i] = norm(in)[i] * scale[i] (+ bias[i]), i < n; RMSNorm or LayerNorm with
// fp32 statistics, which every thread computes for itself from shared
// memory (n is a model width: tens of values) in index order.  in and out
// are distinct.
template <typename TW>
__device__ __forceinline__ void norm_vec(float* out, const float* in, int n, const float* scale,
                                         const float* bias, bool rms, float eps) {
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
    out[i] = round_to<TW>(v);
  }
}

// Roll a depthwise-conv window and convolve: win_out[k] = win_in[k+1] (rounded
// to TW), win_out[dc-1] = fresh; xc[c] = TW(silu(TW(sum_k win_out[k][c] * cw[k][c] + cb[c]))).
// Every block computes xc; the owner of channel c writes its window.
template <typename TW>
__device__ __forceinline__ void rolled_conv(const Ctx<TW>& cx, const float* __restrict__ win_in,
                                            float* __restrict__ win_out, const float* fresh,
                                            const TW* cw, const float* cb, int dc, int C,
                                            float* xc) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const bool own = c % cx.C == cx.rank;
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < dc; ++k) {
      const float v = k < dc - 1 ? round_to<TW>(win_in[(k + 1) * C + c]) : fresh[c];
      if (own) win_out[k * C + c] = v;
      acc = fmaf(v, to_f32(cw[k * C + c]), acc);
    }
    xc[c] = round_to<TW>(silu_f(round_to<TW>(acc + cb[c])));
  }
}

// One selective-scan step of channel i: h' = exp(dt*A)*h + dt*x*B, y = <h', C> + D*x.
__device__ __forceinline__ float scan_channel(const float* __restrict__ h_in,
                                              float* __restrict__ h_out, bool own,
                                              const float* A, const float* Bv, const float* Cv,
                                              int ds, float dt, float xv, float Dv) {
  float y = 0.f;
#pragma unroll 8
  for (int s = 0; s < ds; ++s) {
    const float h = expf(dt * A[s]) * h_in[s] + dt * xv * Bv[s];
    if (own) h_out[s] = h;
    y = fmaf(h, Cv[s], y);
  }
  return y + xv * Dv;
}

template <typename TW>
__global__ void __launch_bounds__(kThreads)
mega_kernel(const IO io, const TW* __restrict__ wk, const TW* __restrict__ W,
            const float* __restrict__ F,
            const int* __restrict__ tab_g, const int* __restrict__ plan, const Ptrs ptrs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = plan[0], nprod = plan[1], rank = blockIdx.x % C, b = blockIdx.x / C;
  const int tid = threadIdx.x, nt = blockDim.x;
  int* const tab = reinterpret_cast<int*>(smem + kTabOff);
  int* const recs = reinterpret_cast<int*>(smem + kRecOff);
  for (int e = tid; e < kTabLen; e += nt) tab[e] = tab_g[e];
  for (int e = tid; e < nprod * kPlanRec; e += nt)
    recs[e] = plan[kPlanHdr + ((e / kPlanRec) * C + rank) * kPlanRec + e % kPlanRec];
  __syncthreads();
  const int kind = tab[0], D = tab[1], K = tab[2], S = tab[3], FL = tab[4], TS = tab[5];
  const int act = tab[6], L = tab[8], dm = tab[9], Clast = tab[10];
  const int n_head = tab[11], bufN = tab[12], vecN = tab[13], max_len = tab[14];
  const bool rms = tab[7] != 0;
  const float eps = __int_as_float(tab[15]);
  float* const act_base = reinterpret_cast<float*>(smem + kActOff);
  float* const bufs[3] = {act_base, act_base + bufN, act_base + 2 * bufN};
  float* const vecs = act_base + 3 * bufN;
  float* const gdeep = vecs + kNVec * vecN;  // the deepest level's new row
  float* const xch = reinterpret_cast<float*>(smem + plan[5]);
  const int xchN = plan[6];
#define VEC(i) (vecs + (i) * vecN)
#define PTR_F(i) (static_cast<float*>(ptrs.p[i]))
  auto R = [](float v) { return round_to<TW>(v); };

  // no cluster barrier yet: the first product cut over the cluster starts
  // with one (Ctx::dirty), and the attention's and S4's exchanges join first
  Ctx<TW> cx{smem, recs, nprod, wk, reinterpret_cast<float*>(smem + plan[4]),
             (plan[5] - plan[4]) / 4, act_base, rank, C, tid, nt, 0, false, true, C == 1,
             false};
  if (tid == 0) {
    for (int p = 0; p < nprod; ++p) mbar_init(cx.bar(p), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    cx.issue(-1);
  }
  // What the encoder reads of its OLD caches does not depend on the frame:
  // the rolled part of each new cache (copied by its owner) and the S header
  // rows of the next level's input window (into shared memory, every block),
  // copied here, off the chain of products.
  float* const hdr = reinterpret_cast<float*>(smem + plan[8]);
  auto old_level = [&](int i, bool head) -> Span {
    const int* r = tab + kEncBase + i * kRec;
    const int T = r[0], N2 = r[3], cache = r[4];
    const float* old = PTR_F(i) + (size_t)b * cache * N2;
    if (!head) return Span{old + T * N2, PTR_F(D + i) + (size_t)b * cache * N2, (cache - T) * N2};
    int h = 0;
    for (int j = 0; j < i; ++j) h += S * tab[kEncBase + j * kRec + 3];
    return Span{old + (cache - S) * N2, hdr + h, S * N2};
  };
  gather_copy<TW>([&](int i) { return old_level(i, false); }, D - 1, rank * nt + tid, C * nt);
  gather_copy<TW>([&](int i) { return old_level(i, true); }, D - 1, tid, nt);

  // ---------------- the frame, normalised ----------------
  const int cut = FL - TS;
  const float* tail = io.tail + (size_t)b * io.ld_tail;
  const float* fresh_in = io.fresh + (size_t)b * io.ld_new;
  auto frame = [&](int j) { return j < cut ? tail[j] : fresh_in[j - cut]; };
  float std_new = 1.f;
  if (io.std_in != nullptr) {
    const int frames = io.frames_in[b] + 1;
    std_new = io.std_in[b];
    if (io.normalize) {
      float s = 0.f;
      for (int j = tid; j < FL; j += nt) s += frame(j);
      const float mean = block_sum(s, cx.red) / FL;
      float q = 0.f;
      for (int j = tid; j < FL; j += nt) q += (frame(j) - mean) * (frame(j) - mean);
      const float std_now = sqrtf(block_sum(q, cx.red) / FL) + 1e-3f;
      const float inv_n = 1.f / (float)frames;
      std_new = std_now * inv_n + (1.f - inv_n) * std_new;
    }
    if (rank == 0 && tid == 0) {
      io.std_out[b] = std_new;
      io.frames_out[b] = frames;
    }
    for (int j = rank * nt + tid; j < cut; j += C * nt) io.tail_out[(size_t)b * cut + j] = frame(j + TS);
  }
  {
    const int rows = S * (tab[kEncBase] + 1);  // level 0's window of the frame
    for (int e = tid; e < rows; e += nt) {
      const float v = frame(FL - rows + e);
      bufs[0][e] = R(io.normalize ? v / std_new : v);
    }
  }
  cx.local_sync();

  int p = 0;  // the running product
  // ---------------- encoder ----------------
  int in = 0, ob = 2;
  const float* hdr_at = hdr;
  for (int i = 0; i < D; ++i) {
    const int* r = tab + kEncBase + i * kRec;
    const int T = r[0], Cin = r[1], Cc = r[2], N2 = r[3], cache = r[4];
    const float* cb = F + r[6];
    const float* mb = F + r[8];
    float* H = bufs[1];
    const float* X = bufs[in];
    // window t is rows S*t .. S*t + K - 1 of the input, contiguous: ld = S*Cin
    product<1, 1, true>(
        cx, p++, K * Cin, Rows{X, S * Cin, 0, kAnyRow},
        [&](int t, int n, const float* a) { cx.put(H + t * Cc + n, R(fmaxf(a[0] + cb[n], 0.f))); },
        [&](int, int n) { prefetch(cb + n); }, true);
    float* fresh = cache > 0 ? PTR_F(D + i) + (size_t)b * cache * N2 : nullptr;
    // the new rows go behind the S header rows of the next level's input
    // window (the deepest level's single row to gdeep) and to the cache's end
    float* G = i == D - 1 ? gdeep : bufs[ob] + S * N2;
    if (i < D - 1) {
      for (int e = tid; e < S * N2; e += nt) bufs[ob][e] = hdr_at[e];
      hdr_at += S * N2;
    }
    product<2, 1, true>(cx, p++, Cc, Rows{H, Cc, 0, kAnyRow},
                  [&](int t, int n, const float* a) {
                    const float g = R((a[0] + mb[n]) * activate(a[1] + mb[N2 + n], act));
                    cx.put(G + t * N2 + n, g);
                    if (fresh != nullptr && cx.owns(t * N2 + n))
                      fresh[(size_t)(cache - T + t) * N2 + n] = g;
                  },
                  [&](int, int n) {
                    prefetch(mb + n);
                    prefetch(mb + N2 + n);
                  },
                  true);
    const int tmp = in;
    in = ob;
    ob = tmp;
  }

  // ---------------- bottleneck: one token ----------------
  {
    const float* c1b = F + tab[17];
    product<1, 1>(cx, p++, Clast, vector_rows(gdeep),
                  [&](int, int n, const float* a) { cx.put(VEC(0) + n, a[0] + c1b[n]); },
                  [&](int, int n) { prefetch(c1b + n); });
  }
  const float* nfs = tab[20] >= 0 ? F + tab[20] : nullptr;
  const float* nfb = tab[21] >= 0 ? F + tab[21] : nullptr;
  const int pin = 4 * D, pout = 4 * D + 3 * L;
  int tok_dim = dm;  // width of the token handed to conv2, in VEC(2)

  if (kind == kLstm) {
    for (int n = tid; n < dm; n += nt) VEC(2)[n] = R(VEC(0)[n]);
    cx.local_sync();
    for (int li = 0; li < L; ++li) {
      const int* r = tab + kBottBase + li * kBRec;
      const int H = r[0], In = r[1];
      const float* bias = F + r[6];
      const float* h_in = PTR_F(pin + 3 * li) + (size_t)b * H;
      const float* c_in = PTR_F(pin + 3 * li + 1) + (size_t)b * H;
      float* h_out = PTR_F(pout + 3 * li) + (size_t)b * H;
      float* c_out = PTR_F(pout + 3 * li + 1) + (size_t)b * H;
      for (int n = tid; n < In + H; n += nt) VEC(4)[n] = n < In ? VEC(2)[n] : R(h_in[n - In]);
      cx.local_sync();
      product<1, 1>(cx, p++, In + H, vector_rows(VEC(4)),
                    [&](int, int n, const float* a) { cx.put(VEC(3) + n, R(a[0] + bias[n])); });
      for (int j = tid; j < H; j += nt) {
        const float gi = VEC(3)[j], gf = VEC(3)[H + j], gg = VEC(3)[2 * H + j],
                    go = VEC(3)[3 * H + j];
        const float c = R(sigmoid_f(gf)) * c_in[j] + R(R(sigmoid_f(gi)) * R(tanhf(gg)));
        const float h = R(R(sigmoid_f(go)) * tanhf(c));
        if (j % C == rank) {
          c_out[j] = c;
          h_out[j] = h;
        }
        VEC(2)[j] = h;
      }
      cx.local_sync();
      tok_dim = H;
    }
  } else if (kind == kMha) {
    const int M = max_len;
    // each stream's position; its rings lie L * M * d values apart (batch-leading)
    const int pos = static_cast<const int*>(ptrs.p[4 * D + 6 * L])[b];
    const int slot = pos % M, n_valid = min(pos, M - 1) + 1;
    if (rank == 0 && tid == 0) static_cast<int*>(ptrs.p[4 * D + 6 * L + 1])[b] = pos + 1;
    // this block's ring slots
    const int per = (M + C - 1) / C, m0 = min(M, rank * per), m1 = min(M, m0 + per), mn = m1 - m0;
    float* logits = bufs[0];  // (mn, n_head), across the activation buffers
    norm_vec<TW>(VEC(2), VEC(0), dm, nfs, nfb, false, eps);  // the encoder's input norm
    cx.local_sync();
    for (int li = 0; li < L; ++li) {
      const int* r = tab + kBottBase + li * kBRec;
      const int d = r[0], dff = r[1], dk = d / n_head;
      const float inv_sqrt_dk = rsqrtf((float)dk);
      const float* f1b = F + r[11];
      const float* f2b = F + r[13];
      const size_t ring = (size_t)b * L * M * d;
      const float* __restrict__ k_in = PTR_F(pin + 3 * li) + ring;
      const float* __restrict__ v_in = PTR_F(pin + 3 * li + 1) + ring;
      float* __restrict__ k_out = PTR_F(pout + 3 * li) + ring;
      float* __restrict__ v_out = PTR_F(pout + 3 * li + 1) + ring;
      product<3, 1>(cx, p++, d, vector_rows(VEC(2)), [&](int, int n, const float* a) {
        cx.put(VEC(3) + n, a[0]);
        cx.put(VEC(4) + n, a[1]);
        cx.put(VEC(5) + n, a[2]);
      });
      // logits of this block's slots and every head, the K ring's slots copied
      // with this step's row
      for (int e = tid; e < mn * n_head; e += nt) {
        const int m = m0 + e / n_head, h = e % n_head;
        float dot = 0.f;
#pragma unroll 8
        for (int c = h * dk; c < (h + 1) * dk; ++c) {
          const float kv = m == slot ? VEC(4)[c] : k_in[(size_t)m * d + c];
          k_out[(size_t)m * d + c] = kv;
          dot = fmaf(kv, VEC(3)[c], dot);
        }
        logits[e] = m < n_valid ? dot * inv_sqrt_dk : -1e9f;
      }
      __syncthreads();
      // this block's max and sum of exp per head, one warp a head
      float* mine = xch + ((li & 1) * kMaxCluster + rank) * xchN;  // [max | sum | values]
      float* partial = cx.red;
      for (int h = tid / 32; h < n_head; h += nt / 32) {
        const int lane = tid % 32;
        float mx = -3.0e38f, sum = 0.f;
        for (int m = lane; m < mn; m += 32) mx = fmaxf(mx, logits[m * n_head + h]);
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        for (int m = lane; m < mn; m += 32) {
          const float e = expf(logits[m * n_head + h] - mx);
          logits[m * n_head + h] = e;
          sum += e;
        }
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          partial[nt + h] = mx;
          partial[nt + n_head + h] = sum;
        }
      }
      __syncthreads();
      // a[c] = sum over this block's slots of e[m, head(c)] * v[m, c]: groups of d
      // threads split the slots; the V ring's slots copied with this step's row
      const int groups = nt / d;
      if (tid < groups * d) {
        const int c = tid % d, grp = tid / d;
        float part = 0.f;
#pragma unroll 4
        for (int mm = grp; mm < mn; mm += groups) {
          const int m = m0 + mm;
          const float vv = m == slot ? VEC(5)[c] : v_in[(size_t)m * d + c];
          v_out[(size_t)m * d + c] = vv;
          part = fmaf(logits[mm * n_head + c / dk], vv, part);
        }
        partial[grp * d + c] = part;
      }
      __syncthreads();
      cx.join();
      // this block's max, sum and values into every block's exchange slot
      for (int e = tid; e < 2 * n_head + d; e += nt) {
        float v;
        if (e < 2 * n_head) {
          v = partial[nt + e];
        } else {
          v = 0.f;
          for (int grp = 0; grp < groups; ++grp) v += partial[grp * d + e - 2 * n_head];
        }
        for (int q = 0; q < C; ++q) store_cluster(mine + e, q, v);
      }
      cx.cluster_barrier();
      // combined in rank order: softmax over all slots times the values
      const float* xl = xch + (li & 1) * kMaxCluster * xchN;
      for (int c = tid; c < d; c += nt) {
        const int h = c / dk;
        float mx = -3.0e38f;
        for (int q = 0; q < C; ++q) mx = fmaxf(mx, xl[q * xchN + h]);
        float sum = 0.f, a = 0.f;
        for (int q = 0; q < C; ++q) {
          const float s = expf(xl[q * xchN + h] - mx);
          sum += s * xl[q * xchN + n_head + h];
          a += s * xl[q * xchN + 2 * n_head + c];
        }
        VEC(6)[c] = R(a / sum);
      }
      cx.local_sync();
      product<1, 1>(cx, p++, d, vector_rows(VEC(6)),
                    [&](int, int n, const float* a) { cx.put(VEC(7) + n, a[0] + VEC(2)[n]); });
      norm_vec<TW>(VEC(2), VEC(7), d, F + r[8], F + r[9], false, eps);
      cx.local_sync();
      product<1, 1>(cx, p++, d, vector_rows(VEC(2)), [&](int, int n, const float* a) {
        cx.put(VEC(3) + n, R(fmaxf(a[0] + f1b[n], 0.f)));
      });
      product<1, 1>(cx, p++, dff, vector_rows(VEC(3)), [&](int, int n, const float* a) {
        cx.put(VEC(7) + n, a[0] + f2b[n] + VEC(2)[n]);
      });
      norm_vec<TW>(VEC(2), VEC(7), d, F + r[14], F + r[15], false, eps);
      cx.local_sync();
    }
  } else {
    // pre-norm residual blocks: VEC(0) residual, VEC(1) the mixer's output
    for (int li = 0; li < L; ++li) {
      const int* r = tab + kBottBase + li * kBRec;
      const int di = r[0], dc = r[3];
      const float* conv_b = F + r[6];
      const float* ns = F + r[13];
      const float* nb = r[14] >= 0 ? F + r[14] : nullptr;
      if (li > 0) {
        for (int n = tid; n < dm; n += nt) VEC(0)[n] += VEC(1)[n];
        cx.local_sync();
      }
      norm_vec<TW>(VEC(2), VEC(0), dm, ns, nb, rms, eps);
      cx.local_sync();
      if (kind == kMamba) {
        const int ds = r[1], dr = r[2];
        const TW* cw = W + r[5];
        const float* dtb = F + r[9];
        const float* A = F + r[10];
        const float* Dv = F + r[11];
        const float* win_in = PTR_F(pin + 3 * li) + (size_t)b * dc * di;
        float* win_out = PTR_F(pout + 3 * li) + (size_t)b * dc * di;
        const float* h_in = PTR_F(pin + 3 * li + 1) + (size_t)b * di * ds;
        float* h_out = PTR_F(pout + 3 * li + 1) + (size_t)b * di * ds;
        product<1, 1>(cx, p++, dm, vector_rows(VEC(2)),
                      [&](int, int n, const float* a) { cx.put(VEC(3) + n, R(a[0])); });  // x | z
        rolled_conv<TW>(cx, win_in, win_out, VEC(3), cw, conv_b, dc, di, VEC(4));
        cx.local_sync();
        product<1, 1>(cx, p++, di, vector_rows(VEC(4)), [&](int, int n, const float* a) {
          cx.put(VEC(5) + n, n < dr ? R(a[0]) : a[0]);  // dt (rounded) | B | C
        });
        product<1, 1>(cx, p++, dr, vector_rows(VEC(5)), [&](int, int n, const float* a) {
          cx.put(VEC(6) + n, softplus_f(a[0] + dtb[n]));
        });
        for (int i = tid; i < di; i += nt) {
          const float y = scan_channel(h_in + i * ds, h_out + i * ds, i % C == rank, A + i * ds,
                                       VEC(5) + dr, VEC(5) + dr + ds, ds, VEC(6)[i], VEC(4)[i],
                                       Dv[i]);
          VEC(7)[i] = R(R(y) * R(silu_f(VEC(3)[di + i])));
        }
        cx.local_sync();
        product<1, 1>(cx, p++, di, vector_rows(VEC(7)),
                      [&](int, int n, const float* a) { cx.put(VEC(1) + n, a[0]); });
      } else if (kind == kMamba2) {
        const int ds = r[1], nh = r[2], hd = di / nh, cc = di + 2 * ds;
        const TW* cw = W + r[5];
        const float* dtb = F + r[7];
        const float* A = F + r[10];
        const float* Dv = F + r[11];
        const float* nw = F + r[15];
        const float* win_in = PTR_F(pin + 3 * li) + (size_t)b * dc * cc;
        float* win_out = PTR_F(pout + 3 * li) + (size_t)b * dc * cc;
        const float* h_in = PTR_F(pin + 3 * li + 1) + (size_t)b * di * ds;
        float* h_out = PTR_F(pout + 3 * li + 1) + (size_t)b * di * ds;
        product<1, 1>(cx, p++, dm, vector_rows(VEC(2)), [&](int, int n, const float* a) {
          cx.put(VEC(3) + n, n < di + cc ? R(a[0]) : a[0]);  // z | x B C (rounded) | dt per head
        });
        rolled_conv<TW>(cx, win_in, win_out, VEC(3) + di, cw, conv_b, dc, cc, VEC(4));
        cx.local_sync();
        for (int i = tid; i < di; i += nt) {
          const float dt = softplus_f(VEC(3)[di + cc + i / hd] + dtb[i / hd]);
          const float y = scan_channel(h_in + i * ds, h_out + i * ds, i % C == rank, A + i * ds,
                                       VEC(4) + di, VEC(4) + di + ds, ds, dt, VEC(4)[i], Dv[i]);
          VEC(7)[i] = y * silu_f(VEC(3)[i]);
        }
        cx.local_sync();
        {  // gated RMSNorm, eps 1e-5
          float ss = 0.f;
          for (int k = 0; k < di; ++k) ss += VEC(7)[k] * VEC(7)[k];
          const float inv = rsqrtf(ss / di + 1e-5f);
          for (int i = tid; i < di; i += nt) VEC(5)[i] = R(VEC(7)[i] * inv * nw[i]);
        }
        cx.local_sync();
        product<1, 1>(cx, p++, di, vector_rows(VEC(5)),
                      [&](int, int n, const float* a) { cx.put(VEC(1) + n, a[0]); });
      } else {  // mamba_s4
        const int Hh = r[1], Ns = r[2];
        const TW* cw = W + r[5];
        const float* ulb = F + r[8];
        const float2* dAt = reinterpret_cast<const float2*>(F + r[9]);   // [h][n][m]
        const float2* dB = reinterpret_cast<const float2*>(F + r[10]);   // [h][m]
        const float2* dC = reinterpret_cast<const float2*>(F + r[11]);   // [h][n]
        const float* Dv = F + r[15];
        const float* olb = F + r[17];
        const float* win_in = PTR_F(pin + 3 * li) + (size_t)b * dc * di;
        float* win_out = PTR_F(pout + 3 * li) + (size_t)b * dc * di;
        const float2* s_in =
            reinterpret_cast<const float2*>(PTR_F(pin + 3 * li + 1)) + (size_t)b * Hh * Ns;
        float2* s_out = reinterpret_cast<float2*>(PTR_F(pout + 3 * li + 1)) + (size_t)b * Hh * Ns;
        product<1, 1>(cx, p++, dm, vector_rows(VEC(2)),
                      [&](int, int n, const float* a) { cx.put(VEC(3) + n, R(a[0])); });  // x | z
        rolled_conv<TW>(cx, win_in, win_out, VEC(3), cw, conv_b, dc, di, VEC(4));
        cx.local_sync();
        product<1, 1>(cx, p++, di, vector_rows(VEC(4)),
                      [&](int, int n, const float* a) { cx.put(VEC(5) + n, R(a[0] + ulb[n])); });
        // this block's heads: s'[h, m] = sum_n dA[h, m, n] s[h, n] + dB[h, m] u[h]
        // (complex, 4 threads an element), then y[h] into every block
        const int hper = (Hh + C - 1) / C, h0 = min(Hh, rank * hper), h1 = min(Hh, h0 + hper);
        float2* s_new = reinterpret_cast<float2*>(cx.red);  // [h - h0][m]
        const int n_el = (h1 - h0) * Ns * 4;
        for (int e = tid; e < (n_el + 31) / 32 * 32; e += nt) {  // whole warps: the shuffles
          const bool live = e < n_el;
          const int q = e % 4, hm = e / 4, h = h0 + hm / Ns, m = hm % Ns;
          float re = 0.f, im = 0.f;
          for (int n = q; live && n < Ns; n += 4) {
            const float2 a = dAt[((size_t)h * Ns + n) * Ns + m];
            const float2 s = s_in[h * Ns + n];
            re += a.x * s.x - a.y * s.y;
            im += a.x * s.y + a.y * s.x;
          }
          for (int o = 1; o < 4; o <<= 1) {
            re += __shfl_xor_sync(0xffffffffu, re, o);
            im += __shfl_xor_sync(0xffffffffu, im, o);
          }
          if (live && q == 0) {
            const float u = VEC(5)[h];
            const float2 v = make_float2(re + dB[h * Ns + m].x * u, im + dB[h * Ns + m].y * u);
            s_new[hm] = v;
            s_out[h * Ns + m] = v;
          }
        }
        __syncthreads();
        cx.join();
        float* yv = VEC(8 + (li & 1));  // by layer parity: no barrier needed before it
        for (int h = h0 + tid; h < h1; h += nt) {
          float y = 0.f;
          for (int n = 0; n < Ns; ++n) {
            const float2 c = dC[h * Ns + n], s = s_new[(h - h0) * Ns + n];
            y += c.x * s.x - c.y * s.y;
          }
          y += VEC(5)[h] * Dv[h];
          y = R(0.5f * y * (1.f + erff(y * 0.7071067811865476f)));  // exact GELU
          for (int q = 0; q < C; ++q) store_cluster(yv + h, q, y);
        }
        cx.cluster_barrier();
        product<2, 1>(cx, p++, Hh, vector_rows(yv), [&](int, int n, const float* a) {
          const float g = R((a[0] + olb[n]) * sigmoid_f(a[1] + olb[di + n]));
          cx.put(VEC(7) + n, R(g * R(silu_f(VEC(3)[di + n]))));
        });
        product<1, 1>(cx, p++, di, vector_rows(VEC(7)),
                      [&](int, int n, const float* a) { cx.put(VEC(1) + n, a[0]); });
      }
    }
    for (int n = tid; n < dm; n += nt) VEC(0)[n] += VEC(1)[n];
    cx.local_sync();
    norm_vec<TW>(VEC(2), VEC(0), dm, nfs, nfb, rms, eps);
    cx.local_sync();
  }

  // ---------------- decoder ----------------
  // a level's input is the previous output plus the level's skip: the first T
  // rows of the encoder level's frame output, in the OLD cache (the deepest
  // level's single row is this frame's); added where the previous product
  // writes it
  auto skip_of = [&](int j) -> const float* {
    const int enc_i = tab[kDecBase + j * kRec + 4];
    const int cache = tab[kEncBase + enc_i * kRec + 4];
    const int Cj = tab[kDecBase + j * kRec + 1];
    return cache > 0 ? PTR_F(enc_i) + (size_t)b * cache * Cj : gdeep;
  };
  {
    const float* c2b = F + tab[19];
    const float* skip = skip_of(0);
    product<1, 1>(cx, p++, tok_dim, vector_rows(VEC(2)), [&](int, int n, const float* a) {
      cx.put(bufs[0] + n, R(R(a[0] + c2b[n]) + R(skip[n])));
    }, [&](int, int n) { prefetch(c2b + n); });
  }
  int xb = 0, zb = 2;
  for (int j = 0; j < D; ++j) {
    const int* r = tab + kDecBase + j * kRec;
    const int T = r[0], Cg = r[2], Cout = r[3];
    const float* mb = F + r[6];
    const float* cb = F + r[8];
    const int N = S * Cout;
    const float* XD = bufs[xb];
    float* G = bufs[1];
    float* Z = bufs[zb];
    const int Cx = r[1];
    product<2, 1, true>(cx, p++, Cx, Rows{XD, Cx, 0, kAnyRow},
                  [&](int t, int n, const float* a) {
                    cx.put(G + t * Cg + n, R((a[0] + mb[n]) * activate(a[1] + mb[Cg + n], act)));
                  },
                  [&](int, int n) {
                    prefetch(mb + n);
                    prefetch(mb + Cg + n);
                  },
                  true);
    const float* prev = PTR_F(2 * D + j) + (size_t)b * N;
    float* tail_new = PTR_F(3 * D + j) + (size_t)b * N;
    const bool last = j == D - 1;
    const float* skip = last ? nullptr : skip_of(j + 1);
    const float scale = io.normalize ? std_new : 1.f;
    // virtual rows t = 0..T: lo taps (set 0) read g[t], hi taps (set 1) g[t-1]
    product<2, 2, true>(
        cx, p++, Cg, Rows{G, Cg, 1, T},
        [&](int t, int n, const float* a) {
          if (t == T) {
            if (cx.owns(n)) tail_new[n] = a[1];  // the next frame's carry, without the bias
            return;
          }
          float z = a[0] + a[1] + cb[n % Cout];
          if (t == 0) z += prev[n];
          if (!last) z = fmaxf(z, 0.f);
          z = R(z);
          if (last) {
            if (n % Cout == 0 && cx.owns(t * N + n))
              io.out[(size_t)b * TS + t * S + n / Cout] = z * scale;
          } else {
            // (T, S*Cout) is (T*S, Cout) token-major as it lies
            cx.put(Z + t * N + n, R(z + R(skip[t * N + n])));
          }
        },
        [&](int t, int n) {
          prefetch(cb + n % Cout);
          if (t == 0) prefetch(prev + n);
          if (!last && t < T) prefetch(skip + t * N + n);
        },
        !last);
    const int tmp = xb;
    xb = zb;
    zb = tmp;
  }
#undef VEC
#undef PTR_F
}

template <typename TW>
cudaError_t set_smem(int smem) {
  static int allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(mega_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

}  // namespace

// K5.  tw: dtype code of the packed weights wk (the plan's slabs).  The frame:
// tail (B, FL - TS) and fresh (B, TS) fp32 with row strides ld_tail, ld_new;
// std_in, frames_in, tail_out, std_out, frames_out: the normalisation state
// in and out (all null: the frame is normalised already and only `out` and
// the state behind `ptrs` are written); normalize: scale the frame by the
// running std and the output back.  out (B, TS) fp32; w the pack in TW (the
// depthwise conv weights are read from it), f the fp32 pack; table
// the int32 model description; plan this cluster size's plan; ptrs: n_ptrs =
// 128 device pointers to the state (encoder caches in/out, decoder tails
// in/out, bottleneck state in/out, the MHA position in/out).  B clusters of
// `cluster` blocks of `threads` threads with `smem_bytes` of dynamic shared
// memory.  Returns the CUDA error of the launch (0: none).
extern "C" int mega_stream_step(int tw, const void* tail, int ld_tail, const void* fresh,
                                int ld_new, const void* std_in, const void* frames_in,
                                void* tail_out, void* std_out, void* frames_out, int normalize,
                                void* out, const void* wk, const void* w, const void* f,
                                const void* table,
                                const void* plan, const void* const* ptrs, int n_ptrs, int B,
                                int cluster, int threads, int smem_bytes, void* stream) {
  if (B == 0) return 0;
  if (n_ptrs != kMaxPtrs || threads > kThreads || threads % 32 != 0 || cluster < 1 ||
      cluster > kMaxCluster || (std_in == nullptr && normalize))
    return static_cast<int>(cudaErrorInvalidValue);
  Ptrs p;
  for (int i = 0; i < kMaxPtrs; ++i) p.p[i] = const_cast<void*>(ptrs[i]);
  const IO io{static_cast<const float*>(tail), static_cast<const float*>(fresh),
              static_cast<const float*>(std_in), static_cast<const int*>(frames_in),
              static_cast<float*>(tail_out), static_cast<float*>(std_out),
              static_cast<int*>(frames_out), static_cast<float*>(out), ld_tail, ld_new,
              normalize};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  DISPATCH_DTYPE(tw, TW, {
    cudaError_t e = set_smem<TW>(smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaLaunchKernelEx(&cfg, mega_kernel<TW>, io, static_cast<const TW*>(wk),
                           static_cast<const TW*>(w), static_cast<const float*>(f), static_cast<const int*>(table),
                           static_cast<const int*>(plan), p);
    if (e != cudaSuccess) return static_cast<int>(e);
  })
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `cluster` K5 blocks the card holds at once (negative: -error).
extern "C" int mega_clusters_at_once(int tw, int cluster, int threads, int smem_bytes) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 132);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  DISPATCH_DTYPE(tw, TW, {
    cudaError_t e = set_smem<TW>(smem_bytes);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, mega_kernel<TW>, &cfg);
    if (e != cudaSuccess) return -static_cast<int>(e);
  })
  return n;
}
