// CTC prefix beam search with n-gram and GRU char-LM fusion, for Hopper
// (sm_90a).
//
// Replaces tpu_ctc/ops/beam_pallas.py::_beam_kernel (B5, beam width K <=
// 128) and ::_beam_kernel_wide (B6, K in (128, 256]), both launched by
// beam_search_pallas, with an n-gram LM of order <= 3 and/or the GRU char
// LM.  Both are the template beam_kernel<kMaxK, kNlm>: B5 = <128, .>,
// B6 = <256, .>.  One block of 512 threads runs the whole search of one
// utterance: every frame builds the [A, K] candidate grid in enumeration
// order (the stay candidates on the blank row, then (char, beam)), folds
// duplicate prefixes with the rolling-hash mate match, selects the exact
// top-K, and writes one packed backpointer per beam slot:
//     parent | (char + 1) << 8     (char + 1 = 0 for a stay; parent <= 255)
// Frames past the utterance's length get the identity backpointer.  The
// final (pb, pnb, plen) of every slot go to `fin`; the wrapper
// (ops/beam_cuda.py) takes the argmax, and reconstruct_kernel (at the end of
// this file) follows the best slot's backpointers on the device.
//
// The TPU kernels' lane packing, sublane groups, lane banks (B6) and
// one-hot matmuls exist because Mosaic has no gather and no sort.  Here the
// per-beam state lives in shared memory and is gathered directly, and the
// top-K is a radix select on order-preserving 32-bit keys (the float bit
// pattern, sign folded, -0.0 taken as +0.0, as _ordered_key does), four
// 8-bit passes.  The survivors are every candidate above the K-th key plus
// the first ties at it in enumeration order, compacted by a block-wide
// prefix count (warp ballots), so slot s holds the s-th survivor in
// enumeration order and dead slots come last: the same beam layout as the
// XLA search and the TPU kernels.  Live beams are therefore slots
// 0 .. n_live - 1, n_live being the last frame's survivor count.
//
// The frame all paths share is a chain of dependent steps and block
// barriers: latency, not bytes or operations, bounds it.  So each step is
// spread over all 512 threads and kept short:
//   - the mate fold gives each beam a group of S threads (S = 512 / K,
//     a power of two <= 32, lanes of one warp), each scanning every S-th
//     block of four hashes with 16-byte reads; the mate is the group's
//     lowest match (a shuffle min), so it and s_excl's bits are what one
//     thread's scan gave;
//   - the grid stores each candidate's score and its key, counts the live
//     ones with one atomic a warp, and builds the radix select's first
//     histogram as it goes;
//   - a histogram add takes one atomic for a warp whose candidates share
//     the digit (close scores share their top bytes), and two histograms
//     alternate, so a pass has two block barriers instead of three.
// The float steps of the n-gram search are unchanged: the plain version's
// (decode/beam.py) in the same order, with explicit round-to-nearest
// intrinsics where a compiler could fuse a multiply and an add, so a score
// is bit-equal to the plain version's when exp and log are (expf, logf as
// PyTorch's CUDA ops).  The n-gram instances have no tensor-core path.
//
// The GRU char LM (kNlm; beam_pallas.py:278-281, :354-371, :639-669): each
// beam carries its state h [H] (H padded to a multiple of 8 with zero
// weights by the wrapper, which changes no value).  Every beam starts from
// h_bos, the BOS-stepped state.  Its three products run on the tensor
// cores, mma.sync.m16n8k8 TF32 with f32 accumulators:
//   - LM rows, at the start of each frame: [n_live padded to 16, H] x
//     [H, A padded to 8] against Wo read from L2; then one warp takes the
//     alpha * log_softmax(. - 1e30 [c == blank]) + beta of four rows at
//     once with shuffle max and sum.  Dead slots get zero rows.
//   - the GRU step of the survivors that extend: [n_ext padded to 16, H] x
//     [H, 2H] (z | r), then [n_ext, H] (r h) x [H, H] (candidate); xw [A, 3H]
//     is each char's input projection (embed @ Wx, made by the wrapper),
//     gathered by row.  A stay copies its parent's state.
// A warp's item is up to four 16-row tiles of A against one 8-column tile
// of B (z and r together in the first product): the row tiles' chains of
// mma.sync are independent and issue back to back, and each B value,
// loaded from L2 one k-step ahead, is split once for all of them.  The
// warps own disjoint columns, so each element of Wh (3 H^2 f32: 196 KB at
// H = 128) and Wo crosses from L2 once a frame (once a chunk, below).
// Precision: the reference runs every GRU product at Precision.HIGHEST, f32
// accuracy.  One TF32 pass keeps 10 mantissa bits of each operand (about
// 3e-4 relative error a product); over ~100 LM steps of alpha log p that
// crosses the 1e-2 the GRU checks allow.  So each product is three passes:
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi) (cvt.rna), and
// a b = a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in f32; the dropped
// a_lo b_lo and lo's rounding are <= 2^-24 relative, the f32 level.  Each
// k-step's three passes are summed from zero and added to the running sum
// with round-to-nearest: the tensor cores truncate as they align addends,
// and over one chain of 3 H / 8 mma.sync that bias let the trained GRU's
// scores drift several times further from the plain search's
// (chip_smoke.py phase 10: with the sum kept in the tensor cores, 10 and
// 17 utterances were off by more than 1e-2 at K = 128 and 200; with this,
// 1 and 4).  The A rows are split once when they are staged: hi in place
// (as a float) and rest = x - hi, exact, beside it, so x = hi + rest and a
// fragment needs only lo = tf32(rest).  (ops/beam_cuda.py::
// split_tf32_matmul is this arithmetic in PyTorch.)
//
// Registers: 512 threads leave 128 a thread, and the GRU instances use them
// all.  What lives across the products is kept small: the frame's loop
// bounds are read from shared memory each frame (bounds set once would hold
// the unrolled loops' trip counts in registers for the whole search), the
// ping-pong half is the frame's parity, the extending beams are counted
// over all 16 warps, and a stay's copy recomputes its slot instead of
// keeping it.  ptxas still spills 16 bytes: one float4 of a stay's copy
// (four loads in flight a thread).  Items of one gate (half the
// accumulators), at most two row tiles in the z | r product, or fewer loads
// in flight spilled too, and were slower.
//
// Where the states live: one [K, H] f32 buffer is 64 KB at K = 128,
// H = 128, 100 KB at K = 200 and 256 KB at K = 256, H = 256; the grid and
// its keys take 2 A K 4 bytes (30 KB at K = 128, A = 29; 128 KB at
// K = 256, A = 64) and the LM rows A K 4 more.  Two halves do not fit the
// 227 KB of a block, so the states stay in an L2-resident ping-pong buffer
// [B, 2, K, H] f32 allocated by the wrapper (13 MB for 64 utterances at
// K = 200), and the rows a product needs are staged into shared memory by
// 16-byte cp.async, split as above: the live beams' states for the LM rows
// (2 arrays of [rows, H + 4]), the extending beams' parents for the GRU
// step (5 arrays: parents, r h, each as (hi, rest), and z).  The staging
// area reuses the grid's region (free at both points) and takes whatever
// the block has left, in chunks of 16 rows: at H = 128 one chunk holds all
// 128 LM rows at K = 128 (160 of 200 at K = 200) and 64 extending beams.
//
// What bounds it now (torch_tools/beam_frame_breakdown.py, which stamps the
// phases of a frame): the products run well below the card's mma.sync TF32
// issue rate, which the same tool measures.  A warp's k-loop is serial:
// shared-memory fragment loads, the splits and dependent mma chains, on
// one SM per utterance; fewer passes or deeper B prefetch shorten it
// little.  The shared frame is latency.  Utterances run in parallel, one
// per SM.  The GRU's sums run in another order than the plain version's
// matmuls, so its scores agree within float tolerance only; two launches
// are bit-equal.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxA = 64;
constexpr int kMaxH = 256;
constexpr int kRowGroup = 4;    // 16-row tiles a warp accumulates at once
constexpr size_t kSmemBlock = 232448;  // shared memory a block may use
constexpr float kNegInf = -1e30f;
constexpr float kNegInfHalf = -5e29f;
constexpr unsigned kFull = 0xffffffffu;

// Rolling-hash constants of tpu_ctc_torch/decode/beam.py.
constexpr unsigned kH1Mult = 2654435761u;
constexpr unsigned kH2Mult = 40503u;
constexpr unsigned kH1Inv = 244002641u;
constexpr unsigned kH2Inv = 1650947975u;
constexpr unsigned kH1Empty = 0x9E3779B9u;
constexpr unsigned kH2Empty = 0x85EBCA6Bu;

// The GRU char LM's weights (ops/beam_cuda.py::gru_layout), all f32, H a
// multiple of 8; xw is null when the search has no GRU.
struct Gru {
  const float* xw;     // [A, 3H] input projection of each char (z | r | h)
  const float* wh;     // [H, 3H] recurrent rows (z | r | h)
  const float* b;      // [3H] (bz | br | bh)
  const float* wo;     // [H, A]
  const float* bo;     // [A]
  const float* h_bos;  // [H] initial state of every beam
  float* state;        // [B, 2, K, H] ping-pong per-beam states
  int h;
};

// The GRU instances' dynamic shared memory (floats): the LM rows [K, A],
// then the region that is the candidate grid [A K] during selection and
// the staging area of the products (g_floats) around it.
struct Smem {
  int g_floats;   // the grid / staging region
  int lm_chunk;   // rows staged at once for the LM rows (multiple of 16)
  int gru_chunk;  // extending beams stepped at once (multiple of 16)
};

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, kNegInfHalf);
  const float s = __fadd_rn(__fadd_rn(expf(__fsub_rn(a, ms)),
                                      expf(__fsub_rn(b, ms))), 1e-37f);
  const float out = __fadd_rn(ms, logf(s));
  return m > kNegInfHalf ? out : kNegInf;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// f32 -> u32 with the float order; 0 for a dead candidate (no finite float
// maps to it).
__device__ __forceinline__ unsigned cand_key(float x) {
  const unsigned b = __float_as_uint(x == 0.0f ? 0.0f : x);
  const unsigned u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return x > kNegInfHalf ? u : 0u;
}

// hist[d] += 1 for every lane that takes: one atomic for the warp when its
// takers share one digit (close scores share their top bytes), else one a
// taker.
__device__ __forceinline__ void hist_add(int* hist, bool take, unsigned d,
                                         int lane) {
  const unsigned tk = __ballot_sync(kFull, take);
  if (tk == 0u) return;
  const int lead = __ffs(tk) - 1;
  const unsigned d0 = __shfl_sync(kFull, d, lead);
  if (__all_sync(kFull, !take || d == d0)) {
    if (lane == lead) atomicAdd(&hist[d0], __popc(tk));
  } else if (take) {
    atomicAdd(&hist[d], 1);
  }
}

// ---- the three-pass TF32 split on mma.sync.m16n8k8 ----------------------
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b.  Not volatile: the compiler may interleave independent chains.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b.
__device__ __forceinline__ void mma_tf32_new(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// Work of a product over n_rt row tiles and n_ct column tiles, split into
// items of (column tile, group of rg row tiles) so that the 16 warps have
// about one item each (rg <= kRowGroup bounds the accumulators).
__device__ __forceinline__ int row_group(int n_rt, int n_ct) {
  return max(1, min(kRowGroup, (n_rt * n_ct + kWarps - 1) / kWarps));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Stage n rows of H floats into (hi, rest) [n_pad, ld] by 16-byte cp.async,
// rows n..n_pad-1 zeroed: row q is src row idx[q] (or base + q without
// idx).  Each thread then splits what it copied: hi = tf32(x), kept as a
// float, in place and rest = x - hi (exact) beside it, so x = hi + rest and
// an A fragment needs only lo = tf32(rest).  Ends with a block barrier.
__device__ __forceinline__ void stage_split(float* hi, float* rest, int ld,
                                            const float* src, int n_h,
                                            int base, int n, int n_pad,
                                            const int* idx, int tid) {
  const int per = n_h >> 2;
  for (int e = tid; e < n_pad * per; e += kThreads) {
    const int q = e / per;
    const int c = (e - q * per) * 4;
    if (q < n) {
      const int row = idx ? idx[q] : base + q;
      cp_async16(hi + q * ld + c, src + (size_t)row * n_h + c);
    } else {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(hi + q * ld + c) = zero;
      *reinterpret_cast<float4*>(rest + q * ld + c) = zero;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int e = tid; e < n * per; e += kThreads) {  // the same elements
    const int q = e / per;
    const int o = q * ld + (e - q * per) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + o);
    const float4 h = make_float4(
        __uint_as_float(tf32(x.x)), __uint_as_float(tf32(x.y)),
        __uint_as_float(tf32(x.z)), __uint_as_float(tf32(x.w)));
    *reinterpret_cast<float4*>(hi + o) = h;
    *reinterpret_cast<float4*>(rest + o) = make_float4(
        __fsub_rn(x.x, h.x), __fsub_rn(x.y, h.y), __fsub_rn(x.z, h.z),
        __fsub_rn(x.w, h.w));
  }
  __syncthreads();
}

// One warp's item of a product D = A B of depth n_h: NRT 16-row tiles of A,
// staged as (hi, rest) in shared memory (row stride ld = 4 mod 8, which
// makes the fragment reads conflict-free; first row r0), against NG
// 8-column tiles of B in device memory (row stride b_ld, tile gt at
// b + gt * gate_off; columns at or past n_cols, counted from b, read as
// 0).  Each B value is split once for all NRT tiles, and the next k-step's
// B is loaded as soon as this one's is split.  The NRT x NG accumulator
// chains are independent, so their mma.sync can issue back to back.
// epi(acc) gets the accumulators: acc[gt][i][v] is row
// r0 + 16 i + g + 8 (v >> 1), column 8 gt + 2 q + (v & 1) of the tile
// (g = lane / 4, q = lane % 4).
template <int NRT, int NG, class Epi>
__device__ __forceinline__ void run_item(const float* a_hi,
                                         const float* a_rest, int ld, int r0,
                                         const float* b, int b_ld,
                                         int gate_off, int n_cols, int n_h,
                                         int lane, Epi& epi) {
  const int g = lane >> 2, q = lane & 3;
  float acc[NG][NRT][4];
#pragma unroll
  for (int gt = 0; gt < NG; ++gt)
#pragma unroll
    for (int i = 0; i < NRT; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[gt][i][v] = 0.0f;
  const float* bq = b + (size_t)q * b_ld + g;
  bool col_ok[NG];
  float nb[NG][2];  // B of the next k-step
#pragma unroll
  for (int gt = 0; gt < NG; ++gt) {
    col_ok[gt] = g + gt * gate_off < n_cols;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nb[gt][j] = col_ok[gt]
          ? __ldg(bq + (size_t)(4 * j) * b_ld + gt * gate_off) : 0.0f;
  }
  const float* ah_p = a_hi + (r0 + g) * ld + q;
  const float* ar_p = a_rest + (r0 + g) * ld + q;
  for (int k0 = 0; k0 < n_h; k0 += 8) {
    uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
    for (int gt = 0; gt < NG; ++gt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        bh[gt][j] = tf32(nb[gt][j]);
        bl[gt][j] = tf32(__fsub_rn(nb[gt][j], __uint_as_float(bh[gt][j])));
        if (col_ok[gt] && k0 + 8 < n_h)
          nb[gt][j] =
              __ldg(bq + (size_t)(k0 + 8 + 4 * j) * b_ld + gt * gate_off);
      }
#pragma unroll
    for (int i = 0; i < NRT; ++i) {
      const int o = i * 16 * ld + k0;
      const uint32_t ah[4] = {
          __float_as_uint(ah_p[o]), __float_as_uint(ah_p[o + 8 * ld]),
          __float_as_uint(ah_p[o + 4]), __float_as_uint(ah_p[o + 8 * ld + 4])};
      const uint32_t al[4] = {tf32(ar_p[o]), tf32(ar_p[o + 8 * ld]),
                              tf32(ar_p[o + 4]), tf32(ar_p[o + 8 * ld + 4])};
      // the k-step's a_lo b_hi + a_hi b_lo + a_hi b_hi, added to the sum
      // with round-to-nearest: the tensor cores truncate as they align
      // addends, and a chain of 3 H / 8 of them would bias the sum
#pragma unroll
      for (int gt = 0; gt < NG; ++gt) {
        float t[4];
        mma_tf32_new(t, al, bh[gt][0], bh[gt][1]);
        mma_tf32(t, ah, bl[gt][0], bl[gt][1]);
        mma_tf32(t, ah, bh[gt][0], bh[gt][1]);
#pragma unroll
        for (int v = 0; v < 4; ++v)
          acc[gt][i][v] = __fadd_rn(acc[gt][i][v], t[v]);
      }
    }
  }
  epi(acc);
}

// Hands every accumulator of an item to epi(gate, row, column, value).
template <class Epi>
struct EachElem {
  Epi& epi;
  int r0, c0, g, q;
  template <int NG, int NRT>
  __device__ __forceinline__ void operator()(
      const float (&acc)[NG][NRT][4]) const {
#pragma unroll
    for (int i = 0; i < NRT; ++i)
#pragma unroll
      for (int gt = 0; gt < NG; ++gt)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          epi(gt, r0 + i * 16 + g + (v >> 1) * 8, c0 + 2 * q + (v & 1),
              acc[gt][i][v]);
  }
};

// D = A B over the n_rt row tiles of A and n_ct column tiles of B (NG gates
// each), in items of (column tile, up to rg row tiles) spread over the
// warps; epi(gate, row, column, value) gets every element.
template <int NG, class Epi>
__device__ __forceinline__ void product(const float* a_hi,
                                        const float* a_rest, int ld,
                                        int n_rt, int n_ct, const float* b,
                                        int b_ld, int gate_off, int n_cols,
                                        int n_h, int tid, Epi epi) {
  const int lane = tid & 31, warp = tid >> 5;
  const int rg = row_group(n_rt, n_ct);
  const int n_items = (n_rt + rg - 1) / rg * n_ct;
  for (int item = warp; item < n_items; item += kWarps) {
    const int c0 = item % n_ct * 8;
    const int r0 = item / n_ct * rg * 16;
    EachElem<Epi> e{epi, r0, c0, lane >> 2, lane & 3};
    const float* bc = b + c0;
    const int nc = n_cols - c0;
    switch (min(rg, n_rt - r0 / 16)) {
      case 1:
        run_item<1, NG>(a_hi, a_rest, ld, r0, bc, b_ld, gate_off, nc, n_h,
                        lane, e);
        break;
      case 2:
        run_item<2, NG>(a_hi, a_rest, ld, r0, bc, b_ld, gate_off, nc, n_h,
                        lane, e);
        break;
      case 3:
        run_item<3, NG>(a_hi, a_rest, ld, r0, bc, b_ld, gate_off, nc, n_h,
                        lane, e);
        break;
      default:
        run_item<4, NG>(a_hi, a_rest, ld, r0, bc, b_ld, gate_off, nc, n_h,
                        lane, e);
        break;
    }
  }
}

// The LM row entry of beam m for char c: alpha * log P_ngram(c | last2,
// last) + beta (rounded as two steps), plus the GRU's row where there is
// one, summed as the plain version sums the two rows.
template <bool kNlm>
__device__ __forceinline__ float lm_score(const float* __restrict__ lm,
                                          int order, int a, int last2,
                                          int last, int c, float alpha,
                                          float beta, const float* nrow,
                                          int m) {
  float v = 0.0f;
  if (order > 0) {
    int row = 0;
    if (order == 2) row = last;
    if (order == 3) row = last2 * a + last;
    v = __fadd_rn(__fmul_rn(alpha, __ldg(lm + (size_t)row * a + c)), beta);
  }
  if constexpr (kNlm) {
    const float n = nrow[m * a + c];
    v = order > 0 ? __fadd_rn(v, n) : n;
  }
  return v;
}

// GRU LM rows of the live beams (slots 0 .. n_live - 1): nrow[m, c] =
// alpha * log_softmax(h_m Wo + bo - 1e30 [c == blank])[c] + beta; dead
// slots get zeros (their candidates are dead whatever the row).  The
// states are staged lm_chunk rows at a time into `stage`; one warp takes
// the log-softmax of four rows at once.  Ends with a block barrier.
__device__ __forceinline__ void gru_rows(const float* h_cur, const Gru& gw,
                                         int n_live, int k, int a,
                                         const Smem& sm, int blank,
                                         float alpha, float beta, float* nrow,
                                         float* stage, int tid) {
  constexpr int kRows = 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_h = gw.h, ld = n_h + 4;
  const float neg_inf = __int_as_float(0xff800000);
  float* s_hi = stage;
  float* s_rest = stage + sm.lm_chunk * ld;
  for (int e = n_live * a + tid; e < k * a; e += kThreads) nrow[e] = 0.0f;
  if (n_live == 0) __syncthreads();
  for (int r0 = 0; r0 < n_live; r0 += sm.lm_chunk) {
    const int nr = min(sm.lm_chunk, n_live - r0);
    const int n_rt = (nr + 15) >> 4;
    stage_split(s_hi, s_rest, ld, h_cur, n_h, r0, nr, n_rt * 16, nullptr,
                tid);
    product<1>(s_hi, s_rest, ld, n_rt, (a + 7) >> 3, gw.wo, a, 0, a, n_h, tid,
               [&](int, int rr, int c, float v) {
                 float x = __fadd_rn(v, __ldg(gw.bo + min(c, a - 1)));
                 if (c == blank) x = __fadd_rn(x, kNegInf);
                 if (rr < nr && c < a) nrow[(r0 + rr) * a + c] = x;
               });
    __syncthreads();
    for (int m0 = r0 + warp; m0 < r0 + nr; m0 += kRows * kWarps) {
      float x0[kRows], x1[kRows], mx[kRows], s[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int m = m0 + u * kWarps;
        const bool ok = m < r0 + nr;
        x0[u] = ok && lane < a ? nrow[m * a + lane] : neg_inf;
        x1[u] = ok && lane + 32 < a ? nrow[m * a + lane + 32] : neg_inf;
        mx[u] = fmaxf(x0[u], x1[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(kFull, mx[u], off));
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const bool ok = m0 + u * kWarps < r0 + nr;
        s[u] = 0.0f;
        if (ok && lane < a) s[u] = expf(__fsub_rn(x0[u], mx[u]));
        if (ok && lane + 32 < a)
          s[u] = __fadd_rn(s[u], expf(__fsub_rn(x1[u], mx[u])));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          s[u] = __fadd_rn(s[u], __shfl_xor_sync(kFull, s[u], off));
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int m = m0 + u * kWarps;
        if (m >= r0 + nr) continue;
        const float ls = logf(s[u]);
        if (lane < a)
          nrow[m * a + lane] = __fadd_rn(
              __fmul_rn(alpha, __fsub_rn(__fsub_rn(x0[u], mx[u]), ls)), beta);
        if (lane + 32 < a)
          nrow[m * a + lane + 32] = __fadd_rn(
              __fmul_rn(alpha, __fsub_rn(__fsub_rn(x1[u], mx[u]), ls)), beta);
      }
    }
    __syncthreads();
  }
}

// A stay's state is its parent's: copied through L2, kBatch float4 loads
// in flight a thread (a store's slot is recomputed, not kept: registers).
__device__ __forceinline__ void copy_stays(const float* h_cur, float* h_nxt,
                                           int k, int n_h, const int* s_par,
                                           const int* s_chr, int tid) {
  constexpr int kBatch = 4;
  const int per = n_h >> 2;
  for (int e0 = tid; e0 < k * per; e0 += kBatch * kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int s = e / per;
      if (e < k * per && s_par[s] >= 0 && s_chr[s] < 0)
        v[u] = __ldcg(reinterpret_cast<const float4*>(
            h_cur + (size_t)s_par[s] * n_h + (e - s * per) * 4));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int s = e / per;
      if (e < k * per && s_par[s] >= 0 && s_chr[s] < 0)
        *reinterpret_cast<float4*>(h_nxt + s * n_h + (e - s * per) * 4) =
            v[u];
    }
  }
}

// The survivors' GRU states: a stay copies its parent's, an extension
// steps it on its char.  s_par[s] is slot s's parent (-1: dead), s_chr[s]
// its char (-1: stay); s_ext lists the n_ext extending slots in slot order
// and s_src their parents.  Extensions go gru_chunk at a time: parents
// staged and split, z | r on the tensor cores with z and r h (split) to
// shared memory, then the candidate and h' = (1 - z) h + z cand.  The
// stays' copies are read only after the next frame's first barrier.
__device__ __forceinline__ void gru_step(const Gru& gw, const float* h_cur,
                                         float* h_nxt, int k, const int* s_par,
                                         const int* s_chr, const int* s_ext,
                                         const int* s_src, int n_ext,
                                         const Smem& sm, float* stage,
                                         int tid) {
  const int n_h = gw.h, h3 = 3 * n_h, ld = n_h + 4;
  const int chunk = sm.gru_chunk;
  float* s_hi = stage;                  // [chunk, ld] parents' states
  float* s_rest = s_hi + chunk * ld;
  float* r_hi = s_rest + chunk * ld;    // [chunk, ld] r h
  float* r_rest = r_hi + chunk * ld;
  float* s_z = r_rest + chunk * ld;     // [chunk, ld] z
  copy_stays(h_cur, h_nxt, k, n_h, s_par, s_chr, tid);
  for (int c0 = 0; c0 < n_ext; c0 += chunk) {
    const int nc = min(chunk, n_ext - c0);
    const int n_rt = (nc + 15) >> 4;
    stage_split(s_hi, s_rest, ld, h_cur, n_h, 0, nc, n_rt * 16, s_src + c0,
                tid);
    product<2>(s_hi, s_rest, ld, n_rt, n_h >> 3, gw.wh, h3, n_h, h3, n_h,
               tid, [&](int gt, int rr, int j, float v) {
                 // pad rows read row 0's char: no branch before the loads
                 const int o = rr * ld + j;
                 const int c = s_chr[s_ext[c0 + (rr < nc ? rr : 0)]];
                 const float y = sigmoid(__fadd_rn(
                     __fadd_rn(__ldg(gw.xw + (size_t)c * h3 + gt * n_h + j),
                               v),
                     __ldg(gw.b + gt * n_h + j)));
                 if (rr >= nc) return;
                 if (gt == 0) {
                   s_z[o] = y;
                 } else {
                   const float rh =
                       __fmul_rn(y, __fadd_rn(s_hi[o], s_rest[o]));
                   const float hi = __uint_as_float(tf32(rh));
                   r_hi[o] = hi;
                   r_rest[o] = __fsub_rn(rh, hi);
                 }
               });
    __syncthreads();
    product<1>(r_hi, r_rest, ld, n_rt, n_h >> 3, gw.wh + 2 * n_h, h3, 0, n_h,
               n_h, tid, [&](int, int rr, int j, float v) {
                 const int o = rr * ld + j;
                 const int s = s_ext[c0 + (rr < nc ? rr : 0)];
                 const float cand = tanhf(__fadd_rn(
                     __fadd_rn(__ldg(gw.xw + (size_t)s_chr[s] * h3 +
                                     2 * n_h + j),
                               v),
                     __ldg(gw.b + 2 * n_h + j)));
                 if (rr >= nc) return;
                 const float z = s_z[o];
                 h_nxt[(size_t)s * n_h + j] = __fadd_rn(
                     __fmul_rn(__fsub_rn(1.0f, z),
                               __fadd_rn(s_hi[o], s_rest[o])),
                     __fmul_rn(z, cand));
               });
    __syncthreads();
  }
}

// At least one resident block an SM, all that a launch uses (one block an
// utterance): without that minimum ptxas held the n-gram instances to 40
// registers and spilled.
template <int kMaxK, bool kNlm>
__global__ void __launch_bounds__(kThreads, 1)
beam_kernel(const float* __restrict__ lp, const int* __restrict__ lens,
            const float* __restrict__ thr, const float* __restrict__ lm,
            int* __restrict__ bp, float* __restrict__ fin, int n_t, int a,
            int k, int blank, int max_len, int lm_order, float lm_alpha,
            float lm_beta, int use_prune, float prune_logp, Gru gru,
            Smem sm) {
  constexpr int kMaxCounts =
      ((kMaxK * kMaxA + kThreads - 1) / kThreads) * kWarps;
  extern __shared__ __align__(16) float smem[];
  const int n_cand = a * k;

  __shared__ float s_pb[kMaxK], s_pnb[kMaxK], s_total[kMaxK];
  __shared__ float s_stay_pb[kMaxK], s_stay_pnb[kMaxK], s_stay[kMaxK];
  __shared__ int s_plen[kMaxK], s_last[kMaxK], s_last2[kMaxK], s_sel[kMaxK];
  __shared__ __align__(16) unsigned s_h1[kMaxK];
  __shared__ unsigned s_h2[kMaxK];
  __shared__ unsigned long long s_excl[kMaxK];  // bit c: (beam, c) merged away
  __shared__ float s_lp[kMaxA];
  __shared__ int s_hist[2 * 256];               // two alternating histograms
  __shared__ int s_cnt_above[kMaxCounts], s_cnt_tie[kMaxCounts];
  __shared__ int s_nfin, s_digit, s_need, s_tot_above, s_tot_tie, s_nlive;
  __shared__ float s_bar;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = min(lens[b], n_t);
  const bool use_thr = thr != nullptr;
  int* bp_b = bp + (size_t)b * n_t * k;
  // The grid's rounds and the mate fold's threads a beam (a power of two
  // <= 32) are read from shared memory each frame: bounds computed once
  // would keep the loops' unrolled trip counts in registers across the
  // GRU's products, and the GRU instances would spill them.
  __shared__ int s_rounds, s_grp;
  if (tid == 0) {
    int grp = 1;
    while (grp < 32 && 2 * grp * k <= kThreads) grp *= 2;
    s_grp = grp;
    s_rounds = (n_cand + kThreads - 1) / kThreads;
  }

  // GRU only: the [K, A] LM rows before the grid region (which the
  // products reuse as staging), the ping-pong states, each slot's parent
  // and char, and the extending slots with their parents.
  float* cand = smem;                            // [A * K]
  float* nrow = nullptr;
  float* h_buf = nullptr;
  __shared__ int s_par[kNlm ? kMaxK : 1], s_chr[kNlm ? kMaxK : 1];
  __shared__ int s_ext[kNlm ? kMaxK : 1], s_src[kNlm ? kMaxK : 1];
  __shared__ int s_wext[kWarps];
  if constexpr (kNlm) {
    const int n_h = gru.h;
    nrow = smem;
    cand = nrow + ((k * a + 3) & ~3);
    h_buf = gru.state + (size_t)b * 2 * k * n_h;
    for (int e = tid; e < k * n_h; e += kThreads)
      h_buf[e] = __ldg(gru.h_bos + e % n_h);
  }

  unsigned* key = reinterpret_cast<unsigned*>(cand + ((n_cand + 3) & ~3));
  if (tid < k) {
    s_pb[tid] = tid == 0 ? 0.0f : kNegInf;
    s_pnb[tid] = kNegInf;
    s_plen[tid] = 0;
    s_last[tid] = 0;
    s_last2[tid] = 0;
    s_h1[tid] = tid == 0 ? kH1Empty : (unsigned)tid + 1u;
    s_h2[tid] = tid == 0 ? kH2Empty : (unsigned)tid + 1u;
  }
  if (tid == 0) s_nlive = 1;
  for (int i = tid; i < (n_t - len) * k; i += kThreads)
    bp_b[(size_t)len * k + i] = i % k;  // identity past the length
  __syncthreads();

  for (int t = 0; t < len; ++t) {
    // ---- frame row, totals --------------------------------------------
    if (tid < a) s_lp[tid] = lp[((size_t)b * n_t + t) * a + tid];
    if (tid == 0) {
      s_nfin = 0;
      if (use_thr) s_bar = thr[(size_t)b * n_t + t];
    }
    if (tid < k) {
      s_total[tid] = lse2(s_pb[tid], s_pnb[tid]);
      s_excl[tid] = 0ull;
    }
    if (tid < 256) s_hist[tid] = 0;  // the first pass's, built with the grid
    __syncthreads();
    const int rounds = s_rounds, grp_s = s_grp;
    const float bar = use_thr ? s_bar : 0.0f;
    if constexpr (kNlm)
      gru_rows(h_buf + (size_t)(t & 1) * k * gru.h, gru, s_nlive, k, a, sm,
               blank, lm_alpha, lm_beta, nrow, cand, tid);

    // ---- mate fold and stay candidates (grp_s threads a beam) ---------
    {
      const int j = tid / grp_s;
      const int sub = tid & (grp_s - 1);
      int mate = 0x7fffffff;
      if (j < k && s_plen[j] > 0 && s_total[j] > kNegInfHalf) {
        const int last_j = s_last[j];
        const unsigned ph1 = (s_h1[j] - (unsigned)last_j) * kH1Inv;
        const unsigned ph2 = (s_h2[j] - (unsigned)last_j) * kH2Inv;
        for (int q4 = sub; 4 * q4 < k; q4 += grp_s) {
          const uint4 v = reinterpret_cast<const uint4*>(s_h1)[q4];
          const unsigned hv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = 4 * q4 + i;
            if (hv[i] == ph1 && m < k && s_h2[m] == ph2) {
              mate = min(mate, m);
              atomicOr(&s_excl[m], 1ull << last_j);
            }
          }
        }
      }
      for (int off = 1; off < grp_s; off <<= 1)
        mate = min(mate, __shfl_xor_sync(kFull, mate, off));
      if (j < k && sub == 0) {
        const int last_j = s_last[j];
        const int plen_j = s_plen[j];
        const float lp_last = s_lp[last_j];
        const float stay_pb = __fadd_rn(s_total[j], s_lp[blank]);
        float stay_pnb = plen_j > 0 ? __fadd_rn(s_pnb[j], lp_last) : kNegInf;
        float from_mate = kNegInf;
        bool gate = mate < k;
        if (use_thr) gate = gate && lp_last >= bar;
        if (use_prune) gate = gate && lp_last >= prune_logp;
        if (gate) {
          const float base =
              s_last[mate] == last_j ? s_pb[mate] : s_total[mate];
          from_mate = __fadd_rn(base, lp_last);
          if (kNlm || lm_order > 0)
            from_mate = __fadd_rn(
                from_mate, lm_score<kNlm>(lm, lm_order, a, s_last2[mate],
                                          s_last[mate], last_j, lm_alpha,
                                          lm_beta, nrow, mate));
        }
        stay_pnb = lse2(stay_pnb, from_mate);
        s_stay_pb[j] = stay_pb;
        s_stay_pnb[j] = stay_pnb;
        s_stay[j] = lse2(stay_pb, stay_pnb);
      }
    }
    __syncthreads();

    // ---- candidate grid in enumeration order: e = char * K + beam ------
    // with the radix select's first histogram (the keys' top bytes)
    {
      int n_live = 0;
#pragma unroll 4
      for (int r = 0; r < rounds; ++r) {
        const int e = tid + r * kThreads;
        float v = kNegInf;
        if (e < n_cand) {
          const int c = e / k;
          const int m = e - c * k;
          if (c == blank) {
            v = s_stay[m];
          } else {
            const float lpc = s_lp[c];
            const int plen_m = s_plen[m];
            const int last_m = s_last[m];
            const bool cut = (use_thr && lpc < bar) ||
                             (use_prune && lpc < prune_logp) ||
                             plen_m >= max_len || ((s_excl[m] >> c) & 1ull);
            if (!cut) {
              const float base =
                  (plen_m > 0 && c == last_m) ? s_pb[m] : s_total[m];
              v = __fadd_rn(base, lpc);
              if (kNlm || lm_order > 0)
                v = __fadd_rn(v, lm_score<kNlm>(lm, lm_order, a, s_last2[m],
                                                last_m, c, lm_alpha, lm_beta,
                                                nrow, m));
            }
          }
          cand[e] = v;
          key[e] = cand_key(v);
          n_live += v > kNegInfHalf;
        }
        hist_add(s_hist, v > kNegInfHalf, cand_key(v) >> 24, lane);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        n_live += __shfl_xor_sync(kFull, n_live, off);
      if (lane == 0 && n_live) atomicAdd(&s_nfin, n_live);
    }
    __syncthreads();

    // ---- the K-th largest key: radix select, 8 bits a pass --------------
    // All live candidates survive when there are at most K of them
    // (threshold 0, below every live key).  The first pass's histogram
    // came with the grid; a warp whose candidates share a digit adds them
    // with one atomic; the two histograms alternate, the idle one zeroed
    // while warp 0 scans the other.
    unsigned thresh = 0u;
    int need = 0;
    if (s_nfin > k) {
      unsigned prefix = 0u, pmask = 0u;
      need = k;
      for (int shift = 24, buf = 0; shift >= 0; shift -= 8, buf ^= 1) {
        int* hist = s_hist + buf * 256;
        if (shift < 24) {
          for (int r = 0; r < rounds; ++r) {
            const int e = tid + r * kThreads;
            const unsigned u = e < n_cand ? key[e] : 0u;
            hist_add(hist, u != 0u && (u & pmask) == prefix,
                     (u >> shift) & 255u, lane);
          }
          __syncthreads();
        }
        if (warp == 0) {
          // lane l holds digits 255 - 8l down to 248 - 8l
          int cnt[8];
          int sum = 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            cnt[i] = hist[255 - 8 * lane - i];
            sum += cnt[i];
          }
          int incl = sum;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, off);
            if (lane >= off) incl += y;
          }
          int run = incl - sum;
          if (run < need && need <= incl) {
            for (int i = 0; i < 8; ++i) {
              if (run + cnt[i] >= need) {
                s_digit = 255 - 8 * lane - i;
                s_need = need - run;
                break;
              }
              run += cnt[i];
            }
          }
        } else if (tid < 32 + 256) {
          s_hist[(buf ^ 1) * 256 + tid - 32] = 0;
        }
        __syncthreads();
        prefix |= (unsigned)s_digit << shift;
        pmask |= 255u << shift;
        need = s_need;
      }
      thresh = prefix;
    }

    // ---- survivors in enumeration order ---------------------------------
    // Above the threshold: all survive.  At it: the first `need` in
    // enumeration order.  Slot = survivors before it in enumeration order.
    for (int r = 0; r < rounds; ++r) {
      const int e = tid + r * kThreads;
      const unsigned u = e < n_cand ? key[e] : 0u;
      const unsigned ba = __ballot_sync(kFull, u != 0u && u > thresh);
      const unsigned bt = __ballot_sync(kFull, u != 0u && u == thresh);
      if (lane == 0) {
        s_cnt_above[r * kWarps + warp] = __popc(ba);
        s_cnt_tie[r * kWarps + warp] = __popc(bt);
      }
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the (round, warp) counts
      const int n_ent = rounds * kWarps;
      const int per = (n_ent + 31) / 32;
      const int lo = lane * per;
      int sa = 0, st = 0;
      for (int i = lo; i < min(lo + per, n_ent); ++i) {
        sa += s_cnt_above[i];
        st += s_cnt_tie[i];
      }
      int ia = sa, it = st;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int ya = __shfl_up_sync(kFull, ia, off);
        const int yt = __shfl_up_sync(kFull, it, off);
        if (lane >= off) {
          ia += ya;
          it += yt;
        }
      }
      int ea = ia - sa, et = it - st;
      for (int i = lo; i < min(lo + per, n_ent); ++i) {
        const int xa = s_cnt_above[i], xt = s_cnt_tie[i];
        s_cnt_above[i] = ea;
        s_cnt_tie[i] = et;
        ea += xa;
        et += xt;
      }
      if (lane == 31) {
        s_tot_above = ia;
        s_tot_tie = it;
      }
    }
    __syncthreads();
    const unsigned lt_mask = (1u << lane) - 1u;
    for (int r = 0; r < rounds; ++r) {
      const int e = tid + r * kThreads;
      const unsigned u = e < n_cand ? key[e] : 0u;
      const bool above = u != 0u && u > thresh;
      const bool tie = u != 0u && u == thresh;
      const unsigned ba = __ballot_sync(kFull, above);
      const unsigned bt = __ballot_sync(kFull, tie);
      const int a_before = s_cnt_above[r * kWarps + warp] + __popc(ba & lt_mask);
      const int t_before = s_cnt_tie[r * kWarps + warp] + __popc(bt & lt_mask);
      if (above || (tie && t_before < need))
        s_sel[a_before + min(t_before, need)] = e;
    }
    __syncthreads();
    const int n_sel = s_tot_above + min(s_tot_tie, need);

    // ---- rebuild the beams, write backpointers -------------------------
    float n_pb = kNegInf, n_pnb = kNegInf;
    int n_plen = 0, n_last = 0, n_last2 = 0, packed = 0;
    unsigned n_h1 = (unsigned)tid + 1u, n_h2 = (unsigned)tid + 1u;
    int par = -1, chr = -1;
    if (tid < n_sel) {
      const int e = s_sel[tid];
      const int c = e / k;
      const int p = e - c * k;
      par = p;
      if (c == blank) {
        n_pb = s_stay_pb[p];
        n_pnb = s_stay_pnb[p];
        n_plen = s_plen[p];
        n_last = s_last[p];
        n_last2 = s_last2[p];
        n_h1 = s_h1[p];
        n_h2 = s_h2[p];
        packed = p;
      } else {
        chr = c;
        n_pnb = cand[e];
        n_plen = s_plen[p] + 1;
        n_last = c;
        n_last2 = s_last[p];
        n_h1 = s_h1[p] * kH1Mult + (unsigned)c;
        n_h2 = s_h2[p] * kH2Mult + (unsigned)c;
        packed = p | ((c + 1) << 8);
      }
    }
    if (tid < k) bp_b[(size_t)t * k + tid] = packed;
    unsigned ext_bal = 0u;
    if constexpr (kNlm) {
      if (tid < k) {
        s_par[tid] = par;
        s_chr[tid] = chr;
      }
      ext_bal = __ballot_sync(kFull, chr >= 0);
      if (lane == 0) s_wext[warp] = __popc(ext_bal);
    }
    __syncthreads();
    if (tid < k) {
      s_pb[tid] = n_pb;
      s_pnb[tid] = n_pnb;
      s_plen[tid] = n_plen;
      s_last[tid] = n_last;
      s_last2[tid] = n_last2;
      s_h1[tid] = n_h1;
      s_h2[tid] = n_h2;
    }
    if (tid == 0) s_nlive = n_sel;
    // ---- the survivors' GRU states ------------------------------------
    if constexpr (kNlm) {
      int before = 0, n_ext = 0;  // every warp's count, 0 past slot k
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? s_wext[w] : 0;
        n_ext += s_wext[w];
      }
      if (chr >= 0) {
        const int i = before + __popc(ext_bal & lt_mask);
        s_ext[i] = tid;
        s_src[i] = par;
      }
      __syncthreads();
      gru_step(gru, h_buf + (size_t)(t & 1) * k * gru.h,
               h_buf + (size_t)((t & 1) ^ 1) * k * gru.h, k, s_par, s_chr,
               s_ext, s_src, n_ext, sm, cand, tid);
    }
  }
  __syncthreads();
  if (tid < k) {
    float* f = fin + (size_t)b * 3 * k;
    f[tid] = s_pb[tid];
    f[k + tid] = s_pnb[tid];
    f[2 * k + tid] = (float)s_plen[tid];
  }
}

// The GRU instances' shared-memory plan for (K, A, H), or g_floats = 0
// when the block cannot hold it: the grid region takes what the LM rows and
// the kernel's static arrays leave, at least the grid and one 16-row chunk
// of the GRU step's five arrays.
Smem plan(int k, int a, int n_h, size_t static_bytes) {
  Smem sm{};
  const long ld = n_h + 4;
  const long avail =
      ((long)kSmemBlock - (long)static_bytes) / 4 - ((k * a + 3) & ~3);
  const long need = std::max(2L * (((long)a * k + 3) & ~3L), 5 * 16 * ld);
  if (avail < need) return sm;
  const long k16 = (k + 15) & ~15;
  sm.g_floats = (int)std::min(avail, std::max(need, 5 * k16 * ld));
  sm.lm_chunk = (int)std::min(k16, sm.g_floats / (2 * ld) / 16 * 16);
  sm.gru_chunk = (int)std::min(k16, sm.g_floats / (5 * ld) / 16 * 16);
  return sm;
}

template <int kMaxK, bool kNlm>
int launch_one(cudaStream_t stream, const float* lp, const int* lens,
               const float* thr, const float* lm, int* bp, float* fin,
               int n_b, int n_t, int a, int k, int blank, int max_len,
               int lm_order, float lm_alpha, float lm_beta, int use_prune,
               float prune_logp, const Gru& gru) {
  const void* fn = reinterpret_cast<const void*>(&beam_kernel<kMaxK, kNlm>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  Smem sm{};
  size_t floats = 2 * (((size_t)a * k + 3) & ~3);
  if constexpr (kNlm) {
    sm = plan(k, a, gru.h, attr.sharedSizeBytes);
    if (sm.g_floats == 0) return (int)cudaErrorInvalidValue;
    floats = ((k * a + 3) & ~3) + (size_t)sm.g_floats;
  }
  const size_t smem = floats * sizeof(float);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<kMaxK, kNlm><<<n_b, kThreads, smem, stream>>>(
      lp, lens, thr, lm, bp, fin, n_t, a, k, blank, max_len, lm_order,
      lm_alpha, lm_beta, use_prune, prune_logp, gru, sm);
  return (int)cudaGetLastError();
}

template <int kMaxK>
int launch(const float* lp, const int* lens, const float* thr,
           const float* lm, int* bp, float* fin, int n_b, int n_t, int a,
           int k, int blank, int max_len, int lm_order, float lm_alpha,
           float lm_beta, int use_prune, float prune_logp, const Gru& gru,
           void* stream) {
  const bool nlm = gru.xw != nullptr;
  if (n_b < 1 || n_t < 1 || a < 2 || a > kMaxA || k < 1 || k > kMaxK ||
      blank < 0 || blank >= a || lm_order < 0 || lm_order > 3 ||
      (lm_order > 0 && lm == nullptr))
    return (int)cudaErrorInvalidValue;
  if (nlm && (gru.h < 8 || gru.h > kMaxH || gru.h % 8 != 0 ||
              gru.wh == nullptr || gru.b == nullptr || gru.wo == nullptr ||
              gru.bo == nullptr || gru.h_bos == nullptr ||
              gru.state == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return nlm ? launch_one<kMaxK, true>(st, lp, lens, thr, lm, bp, fin, n_b,
                                       n_t, a, k, blank, max_len, lm_order,
                                       lm_alpha, lm_beta, use_prune,
                                       prune_logp, gru)
             : launch_one<kMaxK, false>(st, lp, lens, thr, lm, bp, fin, n_b,
                                        n_t, a, k, blank, max_len, lm_order,
                                        lm_alpha, lm_beta, use_prune,
                                        prune_logp, gru);
}

// The best slot's hypothesis from the packed backpointers, as
// beam_pallas._reconstruct builds it (tpu_ctc/ops/beam_pallas.py:1191, a
// jax.lax.scan inside the jitted search): one thread per utterance walks bp
// [B, T, K] from slot best[b] at the last frame back to the first, keeping
// each frame's char (-1 for a stay) in chars [B, T], then writes the emitted
// chars in frame order to hyps [B, max_len], zeros after the last.  The walk
// is T dependent loads of one word each from bp, which the search has just
// written (it is in L2): latency bounds it, and one launch replaces the T
// small gathers that a walk from the host takes.
__global__ void reconstruct_kernel(const int* __restrict__ bp,
                                   const long long* __restrict__ best,
                                   int* __restrict__ chars,
                                   int* __restrict__ hyps, int n_b, int n_t,
                                   int k, int max_len) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_b) return;
  const int* p = bp + (size_t)b * n_t * k;
  int* ch = chars + (size_t)b * n_t;
  int slot = (int)best[b];
  for (int t = n_t - 1; t >= 0; --t) {
    const int entry = p[(size_t)t * k + slot];
    ch[t] = (entry >> 8) - 1;
    slot = entry & 255;
  }
  int* h = hyps + (size_t)b * max_len;
  int n = 0;
  for (int t = 0; t < n_t; ++t) {
    const int c = ch[t];
    if (c >= 0 && n < max_len) h[n++] = c;
  }
  for (; n < max_len; ++n) h[n] = 0;
}

}  // namespace

extern "C" {

// lp [B, T, A] f32 normalized log posteriors; lens [B] int32; thr [B, T]
// f32 char_topk admission bar or null; lm the [A]^order f32 table or null
// (order 0); bp out [B, T, K] int32; fin out [B, 3, K] f32 (pb, pnb, plen).
// The GRU char LM (all null, h = 0, for none), H a multiple of 8: xw
// [A, 3H], wh [H, 3H], gb [3H], wo [H, A], bo [A], h_bos [H], state
// scratch [B, 2, K, H] f32.  Returns 0 or a CUDA error code.  B5: K <= 128.
int beam_search_launch(const float* lp, const int* lens, const float* thr,
                       const float* lm, int* bp, float* fin, int n_b, int n_t,
                       int a, int k, int blank, int max_len, int lm_order,
                       float lm_alpha, float lm_beta, int use_prune,
                       float prune_logp, const float* xw, const float* wh,
                       const float* gb, const float* wo, const float* bo,
                       const float* h_bos, float* state, int h,
                       void* stream) {
  const Gru gru{xw, wh, gb, wo, bo, h_bos, state, h};
  return launch<128>(lp, lens, thr, lm, bp, fin, n_b, n_t, a, k, blank,
                     max_len, lm_order, lm_alpha, lm_beta, use_prune,
                     prune_logp, gru, stream);
}

// B6: the same arguments, K in (128, 256].
int beam_search_wide_launch(const float* lp, const int* lens,
                            const float* thr, const float* lm, int* bp,
                            float* fin, int n_b, int n_t, int a, int k,
                            int blank, int max_len, int lm_order,
                            float lm_alpha, float lm_beta, int use_prune,
                            float prune_logp, const float* xw,
                            const float* wh, const float* gb, const float* wo,
                            const float* bo, const float* h_bos, float* state,
                            int h, void* stream) {
  if (k <= 128) return (int)cudaErrorInvalidValue;
  const Gru gru{xw, wh, gb, wo, bo, h_bos, state, h};
  return launch<256>(lp, lens, thr, lm, bp, fin, n_b, n_t, a, k, blank,
                     max_len, lm_order, lm_alpha, lm_beta, use_prune,
                     prune_logp, gru, stream);
}

// bp [B, T, K] int32 packed backpointers, best [B] int64 slots; chars
// [B, T] int32 scratch; hyps out [B, max_len] int32.
int beam_reconstruct_launch(const int* bp, const long long* best, int* chars,
                            int* hyps, int n_b, int n_t, int k, int max_len,
                            void* stream) {
  if (n_b < 1 || n_t < 1 || k < 1 || k > 256 || max_len < 0)
    return (int)cudaErrorInvalidValue;
  reconstruct_kernel<<<(n_b + 31) / 32, 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      bp, best, chars, hyps, n_b, n_t, k, max_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
