// CTC prefix beam search with n-gram and GRU char-LM fusion, for Hopper
// (sm_90a).
//
// Replaces tpu_ctc/ops/beam_pallas.py::_beam_kernel (B5, beam width K <=
// 128) and ::_beam_kernel_wide (B6, K in (128, 256]), both launched by
// beam_search_pallas, with an n-gram LM of order <= 3 and/or the GRU char
// LM.  Both are the template beam_kernel<kMaxK, kNlm>: B5 = <128, .>,
// B6 = <256, .>.  One block runs the whole search of one utterance: every
// frame builds the [A, K] candidate grid in enumeration order (the stay
// candidates on the blank row, then (char, beam)), folds duplicate prefixes
// with the rolling-hash mate match, selects the exact top-K, and writes one
// packed backpointer per beam slot:
//     parent | (char + 1) << 8     (char + 1 = 0 for a stay; parent <= 255)
// Frames past the utterance's length get the identity backpointer.  The
// final (pb, pnb, plen) of every slot go to `fin`; the wrapper
// (ops/beam_cuda.py) takes the argmax and follows the backpointers.
//
// The TPU kernels' lane packing, sublane groups, lane banks (B6) and
// one-hot matmuls exist because Mosaic has no gather and no sort.  Here the
// per-beam state lives in shared memory and is gathered directly, and the
// top-K is a radix select on order-preserving 32-bit keys (the float bit
// pattern, sign folded, -0.0 taken as +0.0, as _ordered_key does), four
// 8-bit passes with a shared-memory histogram.  The survivors are every
// candidate above the K-th key plus the first ties at it in enumeration
// order, compacted by a block-wide prefix count (warp ballots), so slot s
// holds the s-th survivor in enumeration order and dead slots come last:
// the same beam layout as the XLA search and the TPU kernels.  One block
// holds K = 256 (B6 needs no bank split): its per-beam arrays are 12 KB and
// the candidate grid and keys 2 A K 4 bytes.
//
// The GRU char LM (kNlm; beam_pallas.py:278-281, :354-371, :639-669): each
// beam carries its state h [H] in a per-utterance ping-pong buffer in
// global memory, [B, 2, K, H] f32 allocated by the wrapper (it does not fit
// shared memory at K = 256; it stays in L2).  Every beam starts from h_bos,
// the BOS-stepped state.  At the start of each frame the LM rows
// alpha * log_softmax(h Wo + bo) + beta (blank masked) of every live beam go
// to shared memory, [K, A], before the mate fold reads the mate's row.
// After the selection, each survivor's state is its parent's, stepped on
// its char where it extends: z, r = sigmoid(xw[c] + h W_zr + b), cand =
// tanh(xw[c] + (r h) W_h + b), h' = (1 - z) h + z cand, read from one half
// of the buffer and written to the other, swapped after a block barrier.
// xw [A, 3H] is each char's input projection (embed @ Wx, made by the
// wrapper).  The GRU step runs in chunks of extending beams whose parent
// states are staged in shared memory (aliasing the candidate grid, which
// is free by then); each thread computes one hidden unit for up to
// kGruBeams beams, so each weight read from L2/L1 feeds kGruBeams FMAs.
// All of it is plain f32 FMAs (no TF32, no tensor cores); exp, tanh and the
// sigmoid 1 / (1 + exp(-x)) are expf and tanhf.
//
// What bounds it: not bytes.  The n-gram search is a few microseconds of
// dependent steps per frame (about A K candidates and a K x K hash match,
// a dozen block barriers); utterances run in parallel, one per SM.  With
// the GRU, each frame adds K A H FMAs for the LM rows and 3 H H FMAs for
// every extending survivor, issued by one SM per utterance.
//
// The n-gram float steps are the plain version's (decode/beam.py) in the
// same order, with explicit round-to-nearest intrinsics where a compiler
// could fuse a multiply and an add, so a score is bit-equal to the plain
// version's when exp and log are (expf, logf as PyTorch's CUDA ops).  The
// GRU's sums run in another order than the plain version's matmuls, so
// its scores agree within float tolerance only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxA = 64;
constexpr int kMaxH = 256;
constexpr int kGruBeams = 8;  // beams per thread in a GRU step
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

// The GRU char LM's weights (ops/beam_cuda.py::gru_layout), all f32; xw is
// null when the search has no GRU.
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

// f32 -> u32 with the float order; 0 is kept for dead candidates (no
// finite float maps to it).
__device__ __forceinline__ unsigned ordered_key(float x) {
  const unsigned b = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
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

// GRU LM rows of every live beam: nrow[m, c] = alpha * log_softmax(h_m Wo +
// bo - 1e30 [c == blank])[c] + beta; dead beams get zeros (their candidates
// are dead whatever the row).  Ends with a block barrier.
__device__ void gru_rows(const Gru& g, const float* h_cur, int k, int a,
                         int blank, float alpha, float beta,
                         const float* s_total, float* nrow, int tid) {
  const int n_h = g.h;
  for (int e = tid; e < k * a; e += kThreads) {
    const int m = e / a;
    const int c = e - m * a;
    float v = 0.0f;
    if (s_total[m] > kNegInfHalf) {
      const float* hm = h_cur + (size_t)m * n_h;
      float acc = 0.0f;
      for (int i = 0; i < n_h; ++i)
        acc = fmaf(hm[i], __ldg(g.wo + (size_t)i * a + c), acc);
      v = __fadd_rn(acc, __ldg(g.bo + c));
      if (c == blank) v = __fadd_rn(v, kNegInf);
    }
    nrow[e] = v;
  }
  __syncthreads();
  if (tid < k && s_total[tid] > kNegInfHalf) {
    float* row = nrow + tid * a;
    float mx = row[0];
    for (int c = 1; c < a; ++c) mx = fmaxf(mx, row[c]);
    float s = 0.0f;
    for (int c = 0; c < a; ++c) s += expf(__fsub_rn(row[c], mx));
    const float ls = logf(s);
    for (int c = 0; c < a; ++c)
      row[c] = __fadd_rn(
          __fmul_rn(alpha, __fsub_rn(__fsub_rn(row[c], mx), ls)), beta);
  }
  __syncthreads();
}

// The survivors' GRU states: a stay copies its parent's, an extension
// steps it on its char.  s_par[s] is slot s's parent (-1: dead), s_chr[s]
// its char (-1: stay); s_ext lists the n_ext extending slots.  Stages
// parents in `stage` (2 * kGruBeams * (kThreads / H) * H floats).  Ends
// with a block barrier.
__device__ void gru_rebuild(const Gru& g, const float* h_cur, float* h_nxt,
                            int k, const int* s_par, const int* s_chr,
                            const int* s_ext, int n_ext, float* stage,
                            int tid) {
  const int n_h = g.h;
  const int h3 = 3 * n_h;
  for (int e = tid; e < k * n_h; e += kThreads) {
    const int s = e / n_h;
    const int p = s_par[s];
    if (p >= 0 && s_chr[s] < 0) h_nxt[e] = h_cur[(size_t)p * n_h + e - s * n_h];
  }
  const int n_grp = kThreads / n_h;
  const int chunk = kGruBeams * n_grp;
  float* s_hp = stage;                 // [chunk, H] parent states
  float* s_rh = stage + chunk * n_h;   // [chunk, H] r * h
  const int j = tid % n_h;
  const int grp = tid / n_h;
  const int q0 = grp * kGruBeams;      // this thread's first beam in a chunk
  for (int c0 = 0; c0 < n_ext; c0 += chunk) {
    const int nc = min(chunk, n_ext - c0);
    for (int e = tid; e < nc * n_h; e += kThreads) {
      const int q = e / n_h;
      s_hp[e] = h_cur[(size_t)s_par[s_ext[c0 + q]] * n_h + e - q * n_h];
    }
    __syncthreads();
    float z[kGruBeams], hp[kGruBeams];
    const bool mine = grp < n_grp && q0 < nc;
    if (mine) {
      float az[kGruBeams], ar[kGruBeams];
#pragma unroll
      for (int r = 0; r < kGruBeams; ++r) az[r] = ar[r] = 0.0f;
      for (int i = 0; i < n_h; ++i) {
        const float wz = __ldg(g.wh + (size_t)i * h3 + j);
        const float wr = __ldg(g.wh + (size_t)i * h3 + n_h + j);
#pragma unroll
        for (int r = 0; r < kGruBeams; ++r) {
          if (q0 + r < nc) {
            const float x = s_hp[(q0 + r) * n_h + i];
            az[r] = fmaf(x, wz, az[r]);
            ar[r] = fmaf(x, wr, ar[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kGruBeams; ++r) {
        if (q0 + r < nc) {
          const float* xw = g.xw + (size_t)s_chr[s_ext[c0 + q0 + r]] * h3;
          z[r] = sigmoid(__fadd_rn(__fadd_rn(__ldg(xw + j), az[r]),
                                   __ldg(g.b + j)));
          const float rg = sigmoid(__fadd_rn(
              __fadd_rn(__ldg(xw + n_h + j), ar[r]), __ldg(g.b + n_h + j)));
          hp[r] = s_hp[(q0 + r) * n_h + j];
          s_rh[(q0 + r) * n_h + j] = __fmul_rn(rg, hp[r]);
        }
      }
    }
    __syncthreads();
    if (mine) {
      float ah[kGruBeams];
#pragma unroll
      for (int r = 0; r < kGruBeams; ++r) ah[r] = 0.0f;
      for (int i = 0; i < n_h; ++i) {
        const float w = __ldg(g.wh + (size_t)i * h3 + 2 * n_h + j);
#pragma unroll
        for (int r = 0; r < kGruBeams; ++r)
          if (q0 + r < nc) ah[r] = fmaf(s_rh[(q0 + r) * n_h + i], w, ah[r]);
      }
#pragma unroll
      for (int r = 0; r < kGruBeams; ++r) {
        if (q0 + r < nc) {
          const int s = s_ext[c0 + q0 + r];
          const float* xw = g.xw + (size_t)s_chr[s] * h3;
          const float cand = tanhf(__fadd_rn(
              __fadd_rn(__ldg(xw + 2 * n_h + j), ah[r]),
              __ldg(g.b + 2 * n_h + j)));
          h_nxt[(size_t)s * n_h + j] = __fadd_rn(
              __fmul_rn(__fsub_rn(1.0f, z[r]), hp[r]), __fmul_rn(z[r], cand));
        }
      }
    }
    __syncthreads();
  }
  __syncthreads();
}

template <int kMaxK, bool kNlm>
__global__ void __launch_bounds__(kThreads)
beam_kernel(const float* __restrict__ lp, const int* __restrict__ lens,
            const float* __restrict__ thr, const float* __restrict__ lm,
            int* __restrict__ bp, float* __restrict__ fin, int n_t, int a,
            int k, int blank, int max_len, int lm_order, float lm_alpha,
            float lm_beta, int use_prune, float prune_logp, Gru gru) {
  constexpr int kMaxCounts =
      ((kMaxK * kMaxA + kThreads - 1) / kThreads) * kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_cand = a * k;
  float* cand = reinterpret_cast<float*>(smem_raw);           // [A * K]
  unsigned* key = reinterpret_cast<unsigned*>(cand + n_cand);  // [A * K]

  __shared__ float s_pb[kMaxK], s_pnb[kMaxK], s_total[kMaxK];
  __shared__ float s_stay_pb[kMaxK], s_stay_pnb[kMaxK], s_stay[kMaxK];
  __shared__ int s_plen[kMaxK], s_last[kMaxK], s_last2[kMaxK], s_sel[kMaxK];
  __shared__ unsigned s_h1[kMaxK], s_h2[kMaxK];
  __shared__ unsigned long long s_excl[kMaxK];  // bit c: (beam, c) merged away
  __shared__ float s_lp[kMaxA];
  __shared__ int s_hist[256];
  __shared__ int s_cnt_above[kMaxCounts], s_cnt_tie[kMaxCounts];
  __shared__ int s_nfin, s_digit, s_need, s_tot_above, s_tot_tie;
  __shared__ float s_bar;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = min(lens[b], n_t);
  const bool use_thr = thr != nullptr;
  const int rounds = (n_cand + kThreads - 1) / kThreads;
  int* bp_b = bp + (size_t)b * n_t * k;

  // GRU only: [K, A] LM rows after the grid region (which the GRU step
  // reuses as staging), the ping-pong states, each slot's parent and char.
  float* nrow = nullptr;
  float* h_buf = nullptr;
  int cur = 0;
  __shared__ int s_par[kNlm ? kMaxK : 1], s_chr[kNlm ? kMaxK : 1];
  __shared__ int s_ext[kNlm ? kMaxK : 1];
  __shared__ int s_next;
  if constexpr (kNlm) {
    const int chunk = kGruBeams * (kThreads / gru.h);
    nrow = cand + max(2 * n_cand, 2 * chunk * gru.h);
    h_buf = gru.state + (size_t)b * 2 * k * gru.h;
    for (int e = tid; e < k * gru.h; e += kThreads)
      h_buf[e] = __ldg(gru.h_bos + e % gru.h);
  }

  if (tid < k) {
    s_pb[tid] = tid == 0 ? 0.0f : kNegInf;
    s_pnb[tid] = kNegInf;
    s_plen[tid] = 0;
    s_last[tid] = 0;
    s_last2[tid] = 0;
    s_h1[tid] = tid == 0 ? kH1Empty : (unsigned)tid + 1u;
    s_h2[tid] = tid == 0 ? kH2Empty : (unsigned)tid + 1u;
  }
  for (int i = tid; i < (n_t - len) * k; i += kThreads)
    bp_b[(size_t)len * k + i] = i % k;  // identity past the length
  __syncthreads();

  for (int t = 0; t < len; ++t) {
    // ---- frame row, totals --------------------------------------------
    if (tid < a) s_lp[tid] = lp[((size_t)b * n_t + t) * a + tid];
    if (tid == 0) {
      s_nfin = 0;
      if constexpr (kNlm) s_next = 0;
      if (use_thr) s_bar = thr[(size_t)b * n_t + t];
    }
    if (tid < k) {
      s_total[tid] = lse2(s_pb[tid], s_pnb[tid]);
      s_excl[tid] = 0ull;
    }
    __syncthreads();
    const float bar = use_thr ? s_bar : 0.0f;
    if constexpr (kNlm)
      gru_rows(gru, h_buf + (size_t)cur * k * gru.h, k, a, blank, lm_alpha,
               lm_beta, s_total, nrow, tid);

    // ---- mate fold and stay candidates (one thread per beam) ----------
    if (tid < k) {
      const int j = tid;
      const int last_j = s_last[j];
      const int plen_j = s_plen[j];
      const float lp_last = s_lp[last_j];
      const unsigned ph1 = (s_h1[j] - (unsigned)last_j) * kH1Inv;
      const unsigned ph2 = (s_h2[j] - (unsigned)last_j) * kH2Inv;
      int mate = -1;
      if (plen_j > 0 && s_total[j] > kNegInfHalf) {
        for (int m = 0; m < k; ++m) {
          if (s_h1[m] == ph1 && s_h2[m] == ph2) {
            if (mate < 0) mate = m;
            atomicOr(&s_excl[m], 1ull << last_j);
          }
        }
      }
      const float stay_pb = __fadd_rn(s_total[j], s_lp[blank]);
      float stay_pnb = plen_j > 0 ? __fadd_rn(s_pnb[j], lp_last) : kNegInf;
      float from_mate = kNegInf;
      bool gate = mate >= 0;
      if (use_thr) gate = gate && lp_last >= bar;
      if (use_prune) gate = gate && lp_last >= prune_logp;
      if (gate) {
        const float base = s_last[mate] == last_j ? s_pb[mate] : s_total[mate];
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
    __syncthreads();

    // ---- candidate grid in enumeration order: e = char * K + beam ------
    for (int r = 0; r < rounds; ++r) {
      const int e = tid + r * kThreads;
      bool live = false;
      if (e < n_cand) {
        const int c = e / k;
        const int m = e - c * k;
        float v = kNegInf;
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
            const float base = (plen_m > 0 && c == last_m) ? s_pb[m] : s_total[m];
            v = __fadd_rn(base, lpc);
            if (kNlm || lm_order > 0)
              v = __fadd_rn(v, lm_score<kNlm>(lm, lm_order, a, s_last2[m],
                                              last_m, c, lm_alpha, lm_beta,
                                              nrow, m));
          }
        }
        cand[e] = v;
        live = v > kNegInfHalf;
        key[e] = live ? ordered_key(v) : 0u;
      }
      const unsigned bal = __ballot_sync(kFull, live);
      if (lane == 0 && bal) atomicAdd(&s_nfin, __popc(bal));
    }
    __syncthreads();

    // ---- the K-th largest key: radix select, 8 bits a pass --------------
    // All live candidates survive when there are at most K of them
    // (threshold 0, below every live key).
    unsigned thresh = 0u;
    int need = 0;
    if (s_nfin > k) {
      unsigned prefix = 0u, pmask = 0u;
      need = k;
      for (int shift = 24; shift >= 0; shift -= 8) {
        if (tid < 256) s_hist[tid] = 0;
        __syncthreads();
        for (int e = tid; e < n_cand; e += kThreads) {
          const unsigned u = key[e];
          if (u != 0u && (u & pmask) == prefix)
            atomicAdd(&s_hist[(u >> shift) & 255u], 1);
        }
        __syncthreads();
        if (warp == 0) {
          // lane l holds digits 255 - 8l down to 248 - 8l
          int cnt[8];
          int sum = 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            cnt[i] = s_hist[255 - 8 * lane - i];
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
    if (tid < k) {
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
      bp_b[(size_t)t * k + tid] = packed;
      if constexpr (kNlm) {
        s_par[tid] = par;
        s_chr[tid] = chr;
        if (chr >= 0) s_ext[atomicAdd(&s_next, 1)] = tid;
      }
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
    if constexpr (kNlm) {
      gru_rebuild(gru, h_buf + (size_t)cur * k * gru.h,
                  h_buf + (size_t)(cur ^ 1) * k * gru.h, k, s_par, s_chr,
                  s_ext, s_next, cand, tid);
      cur ^= 1;
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

template <int kMaxK, bool kNlm>
int launch_one(size_t smem, cudaStream_t stream, const float* lp,
               const int* lens, const float* thr, const float* lm, int* bp,
               float* fin, int n_b, int n_t, int a, int k, int blank,
               int max_len, int lm_order, float lm_alpha, float lm_beta,
               int use_prune, float prune_logp, const Gru& gru) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&beam_kernel<kMaxK, kNlm>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<kMaxK, kNlm><<<n_b, kThreads, smem, stream>>>(
      lp, lens, thr, lm, bp, fin, n_t, a, k, blank, max_len, lm_order,
      lm_alpha, lm_beta, use_prune, prune_logp, gru);
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
  if (nlm && (gru.h < 1 || gru.h > kMaxH || gru.wh == nullptr ||
              gru.b == nullptr || gru.wo == nullptr || gru.bo == nullptr ||
              gru.h_bos == nullptr || gru.state == nullptr))
    return (int)cudaErrorInvalidValue;
  size_t floats = (size_t)2 * a * k;
  if (nlm) {
    const size_t chunk = (size_t)kGruBeams * (kThreads / gru.h);
    floats = (floats > 2 * chunk * gru.h ? floats : 2 * chunk * gru.h) +
             (size_t)k * a;
  }
  const size_t smem = floats * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return nlm ? launch_one<kMaxK, true>(smem, st, lp, lens, thr, lm, bp, fin,
                                       n_b, n_t, a, k, blank, max_len,
                                       lm_order, lm_alpha, lm_beta,
                                       use_prune, prune_logp, gru)
             : launch_one<kMaxK, false>(smem, st, lp, lens, thr, lm, bp, fin,
                                        n_b, n_t, a, k, blank, max_len,
                                        lm_order, lm_alpha, lm_beta,
                                        use_prune, prune_logp, gru);
}

}  // namespace

extern "C" {

// lp [B, T, A] f32 normalized log posteriors; lens [B] int32; thr [B, T]
// f32 char_topk admission bar or null; lm the [A]^order f32 table or null
// (order 0); bp out [B, T, K] int32; fin out [B, 3, K] f32 (pb, pnb, plen).
// The GRU char LM (all null, h = 0, for none): xw [A, 3H], wh [H, 3H],
// gb [3H], wo [H, A], bo [A], h_bos [H], state scratch [B, 2, K, H] f32.
// Returns 0 or a CUDA error code.  B5: K <= 128.
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

}  // extern "C"
