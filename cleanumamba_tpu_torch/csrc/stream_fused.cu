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
//   Weights are stored in the pack's compute dtype (fp32 or bf16), or,
//   product by product, as bf16 in an fp32 pack (exact in fp32 and in TF32,
//   so an fp32 server of bf16-stored weights streams bf16 bytes), or
//   as int8 with a per-column fp32 scale in a bf16 pack: the TPU
//   kernel's _deq (:238) makes each weight bf16(float(q) * scale[col]) before
//   the product, and so does load_w2 here (applying the scale once in the
//   epilogue would round differently).  Activations enter in their own dtype
//   (fp32 or bf16); products accumulate in fp32.
//
// What bounds them on this card: at block 1 a level sees T = 1..128 tokens
// (B*T rows) against weights of up to 3072x768 + 768x1536 (encoder) and
// 768x1536 + 2x768x1536 (decoder), 7.1 MB in bf16.  Each weight meets at
// most a few rows, so a deep level is bound by streaming its weights once
// from device memory, which needs megabytes in flight on all 132 SMs; an
// outer level (level 0: 128 rows, 8 K weights) by the latency of its two
// launches.  Arithmetic bounds neither until the batch reaches tens of rows.
// A server's tick reaches them: 16 streams make 16..2064 rows a product,
// 5.2 GFLOP a frame, which the SIMT loop below ran at about a seventh of the
// fp32 peak (E8, fp32 compute over bf16 weights: 0.64 ms a frame against the
// per-op levels' 0.88 on an H100).  So an fp32 pack of bf16 weights fed fp32
// runs its products on the tensor cores (mma_group): each input split into
// two TF32 parts, the bf16 weight exact in TF32, so two TF32 products keep
// fp32 accuracy (7.4e-7 of max|ref| against the plain version), 0.38 ms a
// frame.  Every other pack keeps the SIMT loop, bit for bit.
//
// Design.  Every product of a level is one kernel shape, `split_product`:
//  * The pack stores each weight matrix (or pair: GLU value and gate, lo and
//    hi taps) tiled: for every tile of kTile = 64 output columns, all K
//    contraction rows, the pair interleaved per row, zero padded at the ragged
//    edge.  Any (column tile, contraction range) is therefore one contiguous,
//    16-byte aligned slab, whatever the widths of a pruned model.
//  * A block owns a column tile, a contraction range and a group of rows.
//    The blocks that share a tile and a row group, one per contraction range
//    (1, 2, 4 or 8), form a thread block cluster.  The wrapper splits the
//    contraction eight ways where that still leaves a range of 32 rows (a
//    3072x768 product: 12 tiles x 8 ranges of 48 KB), and splits rows only
//    while the grid is short of one block an SM or a block would take more
//    than 32, so the weights leave device memory once per launch at the
//    batches a server runs.
//  * Thread 0 asks for the block's whole slab at once: one bulk copy
//    (cp.async.bulk, no tensor map) into dynamic shared memory, completing on
//    an mbarrier.  The split keeps a slab within 96 KB, so nothing is ever
//    refilled and every byte of the level is in flight from the first
//    microsecond.  (A slab arriving in 2, 4 or 8 stages, each with its own
//    mbarrier so that the warps could start on the first, measured slower on
//    the H100 than one copy, the more stages the slower: with so few rows
//    the arithmetic hides nothing worth a barrier.)  Meanwhile the block
//    stages its rows of the input (rounded to the compute dtype as the TPU
//    kernel casts them) and loads the biases its epilogue will need.
//  * The 8 warps take the staged contraction rows in turn; a lane owns two
//    adjacent columns and up to R = 2, 4 or 8 rows of fp32 partial sums (R is
//    the smallest that covers the block's rows; more rows loop over the slab,
//    which stays in shared memory).  `load_w2` is the one place where a staged
//    weight becomes fp32.  An int8 slab carries its tile's NW x kTile scales,
//    staged by a second bulk copy on the same mbarrier; a lane keeps its two
//    columns' scales in registers and load_w2 decodes each pair.  int8 halves
//    a slab's bytes; the wrapper still splits the product as it splits a bf16
//    one (fewer splits left a level with 1/8 of the blocks, 1.6-1.9x slower).
//  * Partial sums are reduced in one fixed order and without atomics: across
//    the warps through shared memory, then across the cluster through
//    distributed shared memory.  After one cluster barrier each block takes
//    an equal share of the outputs (all rows of its group), reads that share
//    from every block of the cluster in rank order and runs the epilogue on
//    it: no workspace in device memory, no fence, nothing to reset between
//    launches.  (A first version went through an fp32 workspace with an
//    integer ticket for the last block to arrive; its stores' release, the
//    ticket and the read back were each a round trip to device memory and
//    together outlasted the weights' arrival.)  The same inputs give the
//    same bits.
//  * The tensor cores' path (mma_group) stages all of a group's rows at once
//    by cp.async (no registers held, every load in flight), row-major with
//    kblk + 4 floats a row so that the fragment loads meet 32 banks; a warp
//    owns a 16-column tile and every row tile, so only the two contraction
//    ranges of a one-weight product are added; the cluster's reduction and
//    the epilogue are the SIMT path's.
//  * A level is two launches on one stream.  The second is a programmatic
//    dependent launch: it starts while the first still runs, requests its own
//    weights, and only then waits for the first one's result
//    (griddepcontrol.wait), so the two products' weight streams overlap.
//  * The decoder's second launch computes both tap products for "virtual
//    rows" (b, t), t = 0..T: the lo taps read g[b, t], the hi taps g[b, t-1],
//    so the overlap-add and the tail (t = T) come out of one epilogue.
// Output layouts match stream_fused.py's packs: the decoder's grouped
// (B, T, S*Cout) with column order k*Cout + cout.  No library GEMM is used.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 64;       // output columns per block: two per lane
constexpr int kWarps = 8;       // warps taking the staged contraction rows in turn
constexpr int kThreads = 32 * kWarps;
constexpr int kHeader = 128;    // bytes of dynamic shared memory kept for the mbarrier
constexpr int kMaxSplits = 8;   // blocks of a cluster (the portable limit)
constexpr size_t kSmemLimit = 200 * 1024;  // dynamic shared memory a block may ask for
static_assert(kTile == 2 * 32, "a lane owns two adjacent columns");

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

// How one product is split over the grid (tile, split, group), from the
// wrapper's plan.
struct Split {
  int splits;  // blocks of a cluster: each a contraction range of one tile and row group
  int groups;  // row groups
  int kblk;    // contraction rows per block (the last ranges may be shorter, or empty)
  int rpb;     // rows per group
};

// Two adjacent staged weights as fp32: the one place a weight type is decoded.
// s: the two columns' scales (read by the int8 overload only).
__device__ __forceinline__ float2 load_w2(const float* p, float2) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_w2(const __nv_bfloat16* p, float2) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// int8 weights compute in bf16: bf16(float(q) * scale), as the TPU kernel's _deq.
__device__ __forceinline__ float2 load_w2(const int8_t* p, float2 s) {
  const char2 q = *reinterpret_cast<const char2*>(p);
  return make_float2(round_to<__nv_bfloat16>(__fmul_rn(static_cast<float>(q.x), s.x)),
                     round_to<__nv_bfloat16>(__fmul_rn(static_cast<float>(q.y), s.y)));
}

template <int R> __device__ __forceinline__ void load_rows(const float* p, float (&x)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
    }
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}

// The contraction ranges of the tensor cores' warps: a 16-column tile each.
__host__ __device__ constexpr int mma_parts(int NW) { return kWarps / (NW * kTile / 16); }

// Floats the tensor cores stage for a group of rpb rows: per input set (and,
// for the GLU, the skip beside it) every row of 8 * ceil(rpb / 8), each
// kblk + 4 floats apart (4 modulo 8, so that a warp's fragment loads meet 32
// banks).
__host__ __device__ constexpr int mma_staged(int NW, int NI, int kblk, int rpb) {
  return (NI + (NW == 2 && NI == 1)) * ((rpb + 7) / 8 * 8) * (kblk + 4);
}

// esize 1: int8 weights, with their NW x kTile fp32 scales staged beside them.
// mma: the tensor cores' layout: every row of the group staged at once, and
// instead of the warps' sums those of the second contraction range alone.
constexpr size_t smem_bytes(int NW, int NI, int R, int kblk, int rpb, size_t esize, bool mma) {
  return kHeader + (size_t)kblk * NW * kTile * esize +
         ((esize == 1 ? (size_t)NW * kTile : 0) +
          (mma ? (size_t)mma_staged(NW, NI, kblk, rpb) + (mma_parts(NW) - 1) * rpb * NW * kTile
               : (size_t)NI * kblk * R + (size_t)kWarps * R * NW * kTile) +
          (size_t)rpb * NW * kTile) * sizeof(float);
}

// Whether a product over fp32 inputs TX, of compute type TW, over weights
// stored as TS runs on the tensor cores (mma_group): bf16 weights in an fp32
// pack, fed fp32.  Every other combination keeps the SIMT loop of
// split_product.
template <typename TX, typename TW, typename TS>
constexpr bool kMma = std::is_same_v<TX, float> && std::is_same_v<TW, float> &&
                      std::is_same_v<TS, __nv_bfloat16>;

// A row's inputs, as the tensor cores stage them: a, plus b where two inputs
// are added (x + skip); a null a: a row of zeros.
struct RowSrc {
  const float* a;
  const float* b;
};

// 4 bytes from device memory into shared memory, asynchronously (cp.async):
// a thread issues all of its staging before it waits once.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile(
      "{\n.reg .u64 ga;\ncvta.to.global.u64 ga, %1;\ncp.async.ca.shared.global [%0], [ga], 4;\n}"
      ::"r"(smem_addr(dst)), "l"(src)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// x = hi + lo, hi the TF32 nearest x (ties away from zero, by its bits: a
// finite x), lo the rest, which the tensor cores read to TF32 by dropping its
// low bits (2^-22 of x at most).  Three instructions, where cvt.rna.tf32.f32
// takes about sixteen and was most of a step.
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The steps [s0, s1) of a warp's tile for RT row tiles: d[t] += W^T x_t, the
// weights' columns wl (bf16, kRow apart a contraction row), the rows xl (Pk
// floats apart).  The lo parts' products and the hi parts' go to sums of
// their own, added at the end: two chains a tile to keep the tensor cores
// busy, and the small terms summed among themselves (half the error of one
// chain, at the same time on an H100).
template <int RT, int kRow>
__device__ __forceinline__ void mma_steps(float (&d)[4][4], const __nv_bfloat16* wl,
                                          const float* xl, int Pk, int kn, int q, int s0,
                                          int s1) {
  float dh[RT][4] = {};
#pragma unroll 2
  for (int s = s0; s < s1; ++s) {
    const int ka = 8 * s + q, kb = ka + 4;
    // past kn the slab holds no weights: a zero (not what lies there) meets the staged zeros
    const uint32_t wa = ka < kn ? *reinterpret_cast<const uint32_t*>(wl + (size_t)ka * kRow) : 0u;
    const uint32_t wb = kb < kn ? *reinterpret_cast<const uint32_t*>(wl + (size_t)kb * kRow) : 0u;
    const uint32_t a[4] = {wa << 16, wa & 0xffff0000u, wb << 16, wb & 0xffff0000u};
    uint32_t hi[RT][2], lo[RT][2];
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      split_tf32_fast(xl[(size_t)8 * t * Pk + ka], hi[t][0], lo[t][0]);
      split_tf32_fast(xl[(size_t)8 * t * Pk + kb], hi[t][1], lo[t][1]);
    }
#pragma unroll
    for (int t = 0; t < RT; ++t) mma_tf32(d[t], a, lo[t]);
#pragma unroll
    for (int t = 0; t < RT; ++t) mma_tf32(dh[t], a, hi[t]);
  }
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[t][i] += dh[t][i];
}

// The tensor-core body of split_product, for bf16 weights in an fp32 pack fed
// fp32: a bf16 weight is exact in TF32 and each input is split hi + lo, so
// two TF32 products a step keep fp32 accuracy.  Every row of the group is
// staged at once by cp.async (xs: [set][row][kblk + 4], zeros past the rows
// and past kn up to a whole step of 8; rows(set, row) names a row's inputs,
// and with paired the b inputs are staged beside and added); a warp owns a
// 16-column tile of one weight, every row tile of 8 and one of kParts ranges
// of the steps.  The transposed mma: A = the weights (16 columns x 8
// contraction rows, column m0 + 2g at A's row g and m0 + 2g + 1 at row g + 8,
// so one 32-bit load holds both), B = the inputs (8 contraction rows x 8
// rows).  The first range's sums go to part[row][weight][column], the
// second's to red (rows alike), then added to part: the ranges in order.
template <int NW, int NI, typename Rows>
__device__ __forceinline__ void mma_group(const __nv_bfloat16* slab, float* xs, float* red,
                                          float* part, uint32_t full, int kn, int kblk, int k0,
                                          int r_begin, int r_end, Rows& rows, bool paired) {
  constexpr int kRow = NW * kTile;
  constexpr int kUnits = kRow / 16;      // column tiles of the block
  constexpr int kParts = mma_parts(NW);  // ranges of the contraction steps
  static_assert(kParts * kUnits == kWarps && kParts <= 2, "every warp owns a tile and a range");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int n = r_end - r_begin, rt = (n + 7) / 8, rows8 = 8 * rt, Pk = kblk + 4;
  const int steps = (kn + 7) / 8;
  float* xs2 = xs + (size_t)NI * rows8 * Pk;  // the b inputs (the GLU's skip)
  for (int p = warp; p < NI * rows8; p += kWarps) {
    const int set = p / rows8, i = p % rows8;
    const RowSrc r = i < n ? rows(set, r_begin + i) : RowSrc{nullptr, nullptr};
    for (int k = lane; k < 8 * steps; k += 32) {
      float* d = xs + (size_t)p * Pk + k;
      if (r.a != nullptr && k < kn) cp_async4(d, r.a + k0 + k); else *d = 0.f;
      if (paired) {
        float* d2 = xs2 + (size_t)p * Pk + k;
        if (r.b != nullptr && k < kn) cp_async4(d2, r.b + k0 + k); else *d2 = 0.f;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the inputs are staged (and the mbarrier initialised)
  if (paired) {
    for (int e = tid; e < NI * rows8 * Pk; e += kThreads) xs[e] += xs2[e];
    __syncthreads();
  }
  if (kn > 0) mbar_wait(full, 0);

  const int unit = warp % kUnits, range = warp / kUnits;
  const int w = unit / (kTile / 16), m0 = unit % (kTile / 16) * 16;
  const __nv_bfloat16* wl = slab + w * kTile + m0 + 2 * g;
  const float* xl = xs + ((size_t)(NI == 1 ? 0 : w) * rows8 + g) * Pk;
  float d[4][4] = {};  // row tile t: fragment of rows 8t + 2q (+1), columns m0 + 2g (+1)
  const int s0 = range * steps / kParts, s1 = (range + 1) * steps / kParts;
  switch (rt) {  // the row tiles as a constant: no predicated products
    case 1: mma_steps<1, kRow>(d, wl, xl, Pk, kn, q, s0, s1); break;
    case 2: mma_steps<2, kRow>(d, wl, xl, Pk, kn, q, s0, s1); break;
    case 3: mma_steps<3, kRow>(d, wl, xl, Pk, kn, q, s0, s1); break;
    default: mma_steps<4, kRow>(d, wl, xl, Pk, kn, q, s0, s1); break;
  }
  float* mine = (range == 0 ? part : red) + w * kTile + m0 + 2 * g;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 8 * t + 2 * q + h;
      if (row < n)
        *reinterpret_cast<float2*>(mine + (size_t)row * kRow) = make_float2(d[t][h], d[t][2 + h]);
    }
  }
  if constexpr (kParts == 2) {
    __syncthreads();
    for (int e = tid; e < n * kRow; e += kThreads) part[e] += red[e];
  }
}

// v[w] = sum_k src(set(w), row, k) * W[w][k, n] over the whole contraction, for
// the rows of this block's group and the kTile columns of its tile, then
// epi(row, n, v, b) on this block's share of them.  NW weights per staged row
// (wt tiled [tile][K][NW][kTile], of type TS; an int8 wt has its scales tiled
// [tile][NW][kTile] in wscale, null otherwise); NI == 1: every weight reads
// input set 0, NI == NW: weight w reads set w.  src returns the input already
// rounded.
// bias: NB vectors over the N columns; a thread's epilogue column is fixed,
// so it loads its biases at the start and epi gets them as b.
// The grid is (tiles, splits, groups) in clusters of (1, splits, 1).
template <int R, int NW, int NI, bool Mma, typename TS, int NB, typename Src, typename Rows,
          typename Epi>
__device__ __forceinline__ void split_product(const TS* __restrict__ wt,
                                              const float* __restrict__ wscale, int K, int N,
                                              int rows, const Split& sp,
                                              const float* const (&bias)[NB], Src&& src,
                                              Rows&& rowp, bool paired, Epi&& epi) {
  static_assert(R == 2 || R == 4 || R == 8, "row tile");
  static_assert(NI == 1 || NI == NW, "input sets");
  static_assert(kThreads % kTile == 0, "a thread's epilogue column is fixed");
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRow = NW * kTile;  // staged elements per contraction row
  constexpr bool kScaled = std::is_same_v<TS, int8_t>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x, split = blockIdx.y, group = blockIdx.z;  // split: cluster rank
  const int k0 = split * sp.kblk, kn = max(0, min(sp.kblk, K - k0));

  const uint32_t full = smem_addr(smem);  // the mbarrier the slab's copy completes on
  TS* slab = reinterpret_cast<TS*>(smem + kHeader);
  float* scales = reinterpret_cast<float*>(smem + kHeader + (size_t)sp.kblk * kRow * sizeof(TS));
  float* xs = scales + (kScaled ? kRow : 0);
  // the warps' sums [warp][row][weight][column] (tensor cores: [row][weight][column])
  float* red = xs + (Mma ? (size_t)mma_staged(NW, NI, sp.kblk, sp.rpb)
                         : (size_t)NI * R * sp.kblk);
  // this block's sums: [group row][weight][column]
  float* part = red + (Mma ? (mma_parts(NW) - 1) * sp.rpb : kWarps * R) * kRow;

  // every byte of this block's weights is requested before anything else
  if (tid == 0 && kn > 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t bytes = (uint32_t)(kn * kRow * sizeof(TS));
    mbar_expect_tx(full, bytes + (kScaled ? (uint32_t)(kRow * sizeof(float)) : 0u));
    bulk_copy(smem_addr(slab), wt + ((size_t)tile * K + k0) * kRow, bytes, full);
    if constexpr (kScaled)
      bulk_copy(smem_addr(scales), wscale + (size_t)tile * kRow, kRow * sizeof(float), full);
  }
  // this block's share of the group's rpb * kTile outputs, and its biases
  const int share = (sp.rpb * kTile + sp.splits - 1) / sp.splits;
  float b[NB];
  {
    const int n = tile * kTile + (split * share + tid) % kTile;
#pragma unroll
    for (int j = 0; j < NB; ++j) b[j] = n < N ? __ldg(bias[j] + n) : 0.f;
  }
  // let the level's next launch start and request its weights; then wait for
  // the previous launch's result (both are no-ops without a dependent launch)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");

  const int r_begin = group * sp.rpb, r_end = min(rows, r_begin + sp.rpb);
  if constexpr (Mma)
    mma_group<NW, NI>(slab, xs, red, part, full, kn, sp.kblk, k0, r_begin, r_end, rowp, paired);
  for (int r0 = r_begin; !Mma && r0 < r_end; r0 += R) {
    __syncthreads();  // the mbarrier is initialised; the previous pass is done with xs and red
    for (int e = tid; e < NI * R * kn; e += kThreads) {
      const int k = e % kn, i = (e / kn) % R, set = e / (kn * R);
      const int row = r0 + i;
      xs[((size_t)set * sp.kblk + k) * R + i] = row < r_end ? src(set, row, k0 + k) : 0.f;
    }
    __syncthreads();

    float acc[NW][R][2] = {};
    float2 sc[NW] = {};  // this lane's two columns' scales, per weight (int8)
    if (kn > 0) {
      mbar_wait(full, 0);  // the slab has landed (at once after the first pass)
      if constexpr (kScaled) {
#pragma unroll
        for (int w = 0; w < NW; ++w)
          sc[w] = *reinterpret_cast<const float2*>(scales + w * kTile + 2 * lane);
      }
    }
#pragma unroll 2
    for (int k = warp; k < kn; k += kWarps) {
      float x[NI][R];
#pragma unroll
      for (int s = 0; s < NI; ++s) load_rows<R>(xs + ((size_t)s * sp.kblk + k) * R, x[s]);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float2 wv = load_w2(slab + (size_t)k * kRow + w * kTile + 2 * lane, sc[w]);
        const int s = NI == 1 ? 0 : w;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[w][i][0] = fmaf(x[s][i], wv.x, acc[w][i][0]);
          acc[w][i][1] = fmaf(x[s][i], wv.y, acc[w][i][1]);
        }
      }
    }

    // the warps' partial sums, in warp order, into this block's sums
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < R; ++i)
        *reinterpret_cast<float2*>(red + ((size_t)(warp * R + i) * NW + w) * kTile + 2 * lane) =
            make_float2(acc[w][i][0], acc[w][i][1]);
    __syncthreads();
    for (int e = tid; e < R * kRow; e += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) s += red[wp * R * kRow + e];
      part[(r0 - r_begin) * kRow + e] = s;
    }
  }

  // The blocks' sums, in rank order, for this block's share of the outputs.
  // One block alone (no cluster) reads its own sums.
  if (sp.splits == 1) {
    __syncthreads();
  } else {
    cluster_sync();  // every block's sums are written
  }
  for (int e = tid; e < share; e += kThreads) {
    const int o = split * share + e, i = o / kTile, col = o % kTile, row = r_begin + i;
    if (row >= r_end) continue;
    const float* p = part + i * kRow + col;
    float v[NW] = {};
    if (sp.splits == 1) {
#pragma unroll
      for (int w = 0; w < NW; ++w) v[w] = p[w * kTile];
    } else {
      float t[NW][kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
#pragma unroll
        for (int w = 0; w < NW; ++w)
          t[w][s] = s < sp.splits ? load_cluster(p + w * kTile, s) : 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
#pragma unroll
        for (int w = 0; w < NW; ++w) v[w] += t[w][s];
    }
    epi(row, tile * kTile + col, v, b);
  }
  if (sp.splits > 1) cluster_sync();  // nobody reads this block's sums any more
}

// Where row r = b * T + t of an input starts, for the tensor cores' staging:
// its K elements are contiguous, the rows ldt elements apart and the batch
// rows ldb (a strided view: the encoder's windows over the level input, a
// skip's first T tokens).  The SIMT loop reads its inputs contiguous.
struct RowStride {
  int T;
  long long ldb, ldt;
  __device__ __forceinline__ size_t at(int r) const {
    return (size_t)(r / T) * ldb + (size_t)(r % T) * ldt;
  }
};

// out (M, N) = relu(x (M, K) @ w (K, N) + bias), x rounded to TW first (its
// rows as xr gives them on the tensor cores, else contiguous); w stored as TS
// (TW, bf16 in an fp32 pack, or int8 with scales in a bf16 pack).
template <typename TX, typename TW, typename TS, int R>
__global__ void __launch_bounds__(kThreads)
conv_relu_kernel(const TX* __restrict__ x, RowStride xr, const TS* __restrict__ wt,
                 const float* __restrict__ wscale, const float* __restrict__ bias,
                 TW* __restrict__ out, int M, int K, int N, Split sp) {
  const float* const biases[1] = {bias};
  split_product<R, 1, 1, kMma<TX, TW, TS>, TS>(
      wt, wscale, K, N, M, sp, biases,
      [&](int, int row, int k) { return round_to<TW>(to_f32(x[(size_t)row * K + k])); },
      [&](int, int row) {
        return RowSrc{reinterpret_cast<const float*>(x) + xr.at(row), nullptr};
      },
      false, [&](int row, int n, const float(&v)[1], const float(&b)[1]) {
        if (n < N) out[(size_t)row * N + n] = from_f32<TW>(fmaxf(v[0] + b[0], 0.f));
      });
}

// out (M, N) = (xin @ wa + ba) * act(xin @ wb + bb), xin = TW(x + skip) (skip
// may be null; its rows as sr gives them on the tensor cores, else
// contiguous), the GLU with its 1x1 mix split into value and gate halves.
template <typename TX, typename TW, typename TS, int R>
__global__ void __launch_bounds__(kThreads)
glu_kernel(const TX* __restrict__ x, const TX* __restrict__ skip, RowStride sr,
           const TS* __restrict__ wt, const float* __restrict__ wscale,
           const float* __restrict__ ba, const float* __restrict__ bb, int act,
           TW* __restrict__ out, int M, int K, int N, Split sp) {
  const float* const biases[2] = {ba, bb};
  split_product<R, 2, 1, kMma<TX, TW, TS>, TS>(
      wt, wscale, K, N, M, sp, biases,
      [&](int, int row, int k) {
        const size_t off = (size_t)row * K + k;
        float v = to_f32(x[off]);
        if (skip != nullptr) v += to_f32(skip[off]);
        return round_to<TW>(v);
      },
      [&](int, int row) {
        return RowSrc{reinterpret_cast<const float*>(x) + (size_t)row * K,
                      skip != nullptr ? reinterpret_cast<const float*>(skip) + sr.at(row)
                                      : nullptr};
      },
      skip != nullptr, [&](int row, int n, const float(&v)[2], const float(&b)[2]) {
        if (n < N)
          out[(size_t)row * N + n] = from_f32<TW>((v[0] + b[0]) * activate(v[1] + b[1], act));
      });
}

// The transposed conv (K = 2S) with its overlap-add, over virtual rows
// r = b * (T + 1) + t, t = 0..T.  g (Bsz*T, K) holds the GLU output; wt the lo
// and hi taps with N = S*Cout.  For t < T:
//   out[b, t] = g[b, t] @ wlo + g[b, t-1] @ whi + cb (+ prev[b] at t = 0),
// then ReLU if asked; for t = T: tail[b] = g[b, T-1] @ whi (no bias).
template <typename TX, typename TW, typename TS, int R>
__global__ void __launch_bounds__(kThreads)
convt_kernel(const TW* __restrict__ g, const TS* __restrict__ wt,
             const float* __restrict__ wscale, const float* __restrict__ cb,
             const TX* __restrict__ prev, int relu, TW* __restrict__ out,
             TW* __restrict__ tail, int Bsz, int T, int K, int N, Split sp) {
  const float* const biases[1] = {cb};
  split_product<R, 2, 2, kMma<TW, TW, TS>, TS>(
      wt, wscale, K, N, Bsz * (T + 1), sp, biases,
      [&](int set, int r, int k) {
        const int b = r / (T + 1), t = r % (T + 1);
        const size_t row = (size_t)b * T + t;  // g row of (b, t)
        if (set == 0) return t < T ? to_f32(g[row * K + k]) : 0.f;
        return t >= 1 ? to_f32(g[(row - 1) * K + k]) : 0.f;
      },
      [&](int set, int r) {
        const int b = r / (T + 1), t = r % (T + 1);
        const float* row = reinterpret_cast<const float*>(g) + ((size_t)b * T + t) * K;
        if (set == 0) return RowSrc{t < T ? row : nullptr, nullptr};
        return RowSrc{t >= 1 ? row - K : nullptr, nullptr};
      },
      false, [&](int r, int n, const float(&v)[2], const float(&bv)[1]) {
        if (n >= N) return;
        const int b = r / (T + 1), t = r % (T + 1);
        if (t == T) {
          tail[(size_t)b * N + n] = from_f32<TW>(v[1]);
          return;
        }
        float o = v[0] + v[1] + bv[0];
        if (t == 0 && prev != nullptr) o += to_f32(prev[(size_t)b * N + n]);
        if (relu) o = fmaxf(o, 0.f);
        out[((size_t)b * T + t) * N + n] = from_f32<TW>(o);
      });
}

__global__ void empty_kernel() {}

// One product's plan as the wrapper passes it: 5 ints.
struct Plan {
  Split sp;
  int R;
};

Plan read_plan(const int* p) { return {{p[0], p[1], p[2], p[3]}, p[4]}; }

bool plan_ok(const Plan& p, int K) {
  const Split& s = p.sp;
  return (s.splits == 1 || s.splits == 2 || s.splits == 4 || s.splits == kMaxSplits) &&
         s.groups >= 1 && s.kblk >= 1 && s.rpb >= 1 && s.kblk % 8 == 0 &&
         (long long)s.splits * s.kblk >= K && (p.R == 2 || p.R == 4 || p.R == 8);
}

// Launch Kern on (tiles, splits, groups) blocks in clusters of (1, splits, 1)
// (no cluster where the contraction is not split);
// `overlap` makes it a programmatic dependent launch of the kernel before it
// on the stream.
template <auto Kern, typename... Args>
cudaError_t launch(int tiles, const Split& sp, size_t smem, cudaStream_t st, bool overlap,
                   Args... args) {
  static size_t allowed = 48 * 1024;  // per kernel instantiation
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (e != cudaSuccess) return e;
    allowed = kSmemLimit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, sp.splits, sp.groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (sp.splits > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = 1;
    attr[n].val.clusterDim.y = sp.splits;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (overlap) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, Kern, args...);
}

// Runs the statements that follow with `R` bound to a plan's row tile.
#define DISPATCH_ROWS(rows, R, ...)                         \
  if ((rows) == 2) {                                        \
    constexpr int R = 2;                                    \
    __VA_ARGS__                                             \
  } else if ((rows) == 4) {                                 \
    constexpr int R = 4;                                    \
    __VA_ARGS__                                             \
  } else {                                                  \
    constexpr int R = 8;                                    \
    __VA_ARGS__                                             \
  }

// Calls f with a null `const TS*`, TS the stored weight type of `code` in a
// pack of compute type TW fed activations TX: TW itself, bf16 in an fp32 pack
// fed fp32 (the tensor cores' product), or int8 in a bf16 pack.
template <typename TX, typename TW, typename F>
cudaError_t with_weight(int code, F&& f) {
  if (code == (std::is_same_v<TW, float> ? kF32 : kBF16)) return f(static_cast<const TW*>(nullptr));
  if constexpr (kMma<TX, TW, __nv_bfloat16>) {
    if (code == kBF16) return f(static_cast<const __nv_bfloat16*>(nullptr));
  } else if constexpr (std::is_same_v<TW, __nv_bfloat16>) {
    if (code == kI8) return f(static_cast<const int8_t*>(nullptr));
  }
  return cudaErrorInvalidValue;
}

// The stored weight type named by a with_weight tag.
template <typename Tag> using Stored = std::remove_const_t<std::remove_pointer_t<Tag>>;

template <typename TX, typename TW, typename TS>
cudaError_t launch_conv_relu(const Plan& p, cudaStream_t st, bool overlap, const void* x,
                             RowStride xr, const void* wt, const void* ws, const void* bias,
                             void* out, int M, int K, int N) {
  DISPATCH_ROWS(p.R, R, {
    return launch<conv_relu_kernel<TX, TW, TS, R>>(
        cdiv(N, kTile), p.sp,
        smem_bytes(1, 1, R, p.sp.kblk, p.sp.rpb, sizeof(TS), kMma<TX, TW, TS>), st, overlap,
        static_cast<const TX*>(x), xr, static_cast<const TS*>(wt),
        static_cast<const float*>(ws), static_cast<const float*>(bias), static_cast<TW*>(out), M,
        K, N, p.sp);
  })
}

template <typename TX, typename TW, typename TS>
cudaError_t launch_glu(const Plan& p, cudaStream_t st, bool overlap, const void* x,
                       const void* skip, RowStride sr, const void* wt, const void* ws,
                       const void* ba, const void* bb, int act, void* out, int M, int K, int N) {
  DISPATCH_ROWS(p.R, R, {
    return launch<glu_kernel<TX, TW, TS, R>>(
        cdiv(N, kTile), p.sp,
        smem_bytes(2, 1, R, p.sp.kblk, p.sp.rpb, sizeof(TS), kMma<TX, TW, TS>), st, overlap,
        static_cast<const TX*>(x), static_cast<const TX*>(skip), sr,
        static_cast<const TS*>(wt), static_cast<const float*>(ws), static_cast<const float*>(ba),
        static_cast<const float*>(bb), act, static_cast<TW*>(out), M, K, N, p.sp);
  })
}

template <typename TX, typename TW, typename TS>
cudaError_t launch_convt(const Plan& p, cudaStream_t st, bool overlap, const void* g,
                         const void* wt, const void* ws, const void* cb, const void* prev,
                         int relu, void* out, void* tail, int Bsz, int T, int K, int N) {
  DISPATCH_ROWS(p.R, R, {
    return launch<convt_kernel<TX, TW, TS, R>>(
        cdiv(N, kTile), p.sp,
        smem_bytes(2, 2, R, p.sp.kblk, p.sp.rpb, sizeof(TS), kMma<TW, TW, TS>), st, overlap,
        static_cast<const TW*>(g), static_cast<const TS*>(wt), static_cast<const float*>(ws),
        static_cast<const float*>(cb), static_cast<const TX*>(prev), relu,
        static_cast<TW*>(out), static_cast<TW*>(tail), Bsz, T, K, N, p.sp);
  })
}

}  // namespace

// K3.  tx: dtype code of win; tw: of the pack's compute type (h and out);
// w1, w2: of the two products' stored weights (tw, kBF16 in an fp32 pack fed
// fp32, or kI8 in a bf16 pack).  win's row b * T + t starts at b * ldb + t * ldt (a
// strided view of the level input, its KC elements contiguous) where the
// first product runs on the tensor cores; win is contiguous otherwise.
// win (M, KC); cw tiled (KC, C); cb (C); mw tiled pair (C, N2); mba, mbb (N2);
// cws, mws: an int8 weight's tiled scales, else null; h (M, C) scratch; out
// (M, N2).  plan: 5 ints per product (splits, groups, kblk, rows per group,
// row tile).  Returns the first CUDA error (0: none).
extern "C" int fused_encoder_level(int tx, int tw, int w1, int w2, const void* win, int T,
                                   long long ldb, long long ldt, const void* cw,
                                   const void* cws, const void* cb, const void* mw,
                                   const void* mws, const void* mba, const void* mbb, int act,
                                   void* h, void* out, int M, int KC, int C, int N2,
                                   const int* plan, void* stream) {
  if (M == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p1 = read_plan(plan), p2 = read_plan(plan + 5);
  if (!plan_ok(p1, KC) || !plan_ok(p2, C)) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH_DTYPE(tx, TX, DISPATCH_DTYPE(tw, TW, {
    cudaError_t e = with_weight<TX, TW>(w1, [&](auto tag) {
      return launch_conv_relu<TX, TW, Stored<decltype(tag)>>(p1, st, false, win, {T, ldb, ldt},
                                                             cw, cws, cb, h, M, KC, C);
    });
    if (e != cudaSuccess) return static_cast<int>(e);
    e = with_weight<TX, TW>(w2, [&](auto tag) {
      return launch_glu<TW, TW, Stored<decltype(tag)>>(p2, st, true, h, nullptr, {1, 0, 0}, mw,
                                                       mws, mba, mbb, act, out, M, C, N2);
    });
    if (e != cudaSuccess) return static_cast<int>(e);
  }))
  return static_cast<int>(cudaGetLastError());
}

// K4.  tx: dtype code of x, skip and prev; tw: of the pack's compute type (g,
// out and tail); w1, w2 as for K3.  x (Bsz*T, Cx); skip's row b * T + t at
// b * skip_ldb + t * Cx (the first T tokens of a longer skip) on the tensor
// cores, skip contiguous (Bsz*T, Cx) otherwise; mw tiled pair (Cx,
// C); mba, mbb (C); g (Bsz*T, C) scratch; ctw tiled pair lo, hi (C, SC); mws,
// ctws: int8 scales or null; cb (SC); prev (Bsz, SC) or null; out (Bsz, T,
// SC); tail (Bsz, SC).  plan as for K3.
extern "C" int fused_decoder_level(int tx, int tw, int w1, int w2, const void* x,
                                   const void* skip, long long skip_ldb, const void* mw,
                                   const void* mws, const void* mba, const void* mbb, int act,
                                   void* g,
                                   const void* ctw, const void* ctws, const void* cb,
                                   const void* prev, int relu, void* out, void* tail, int Bsz,
                                   int T, int Cx, int C, int SC, const int* plan, void* stream) {
  if (Bsz == 0 || T == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p1 = read_plan(plan), p2 = read_plan(plan + 5);
  if (!plan_ok(p1, Cx) || !plan_ok(p2, C)) return static_cast<int>(cudaErrorInvalidValue);
  DISPATCH_DTYPE(tx, TX, DISPATCH_DTYPE(tw, TW, {
    cudaError_t e = with_weight<TX, TW>(w1, [&](auto tag) {
      return launch_glu<TX, TW, Stored<decltype(tag)>>(p1, st, false, x, skip,
                                                       {T, skip_ldb, Cx}, mw, mws, mba, mbb, act,
                                                       g, Bsz * T, Cx, C);
    });
    if (e != cudaSuccess) return static_cast<int>(e);
    e = with_weight<TX, TW>(w2, [&](auto tag) {
      return launch_convt<TX, TW, Stored<decltype(tag)>>(p2, st, true, g, ctw, ctws, cb, prev,
                                                         relu, out, tail, Bsz, T, C, SC);
    });
    if (e != cudaSuccess) return static_cast<int>(e);
  }))
  return static_cast<int>(cudaGetLastError());
}

// n empty kernels on the stream: the floor that a chain of launches sets.
extern "C" int empty_launches(int n, void* stream) {
  for (int i = 0; i < n; ++i) empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
