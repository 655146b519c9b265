// CTC forward-backward sweeps over the emission lattice, for Hopper (sm_90a).
//
// Replaces tpu_ctc/ops/ctc_pallas.py::_alpha_kernel (launched by _run_alpha,
// kernel B3) and ::_beta_kernel (launched by _run_beta, kernel B4):
//   alpha[t, s] = lse3(alpha[t-1, s], alpha[t-1, s-1], skip[s] ? alpha[t-1, s-2])
//                 + emit[t, s],   init[s] + emit[0, s] at t = 0,
//                 frozen (alpha[t] = alpha[t-1]) for t >= len;
//   beta[t, s]  = final[s] at t = len-1, NEG_INF for t >= len, otherwise
//                 lse3(be[t+1, s], be[t+1, s+1], skip2[s] ? be[t+1, s+2])
//                 with be = beta + emit.
// emit, alpha and beta are [B, T, S] f32; the masks [B, S] f32; lengths [B].
// The sentinels are the JAX package's: NEG_INF = -1e30, a state is dead when
// its max is <= NEG_INF / 2, and 1e-37 is added inside each log.  expf and
// logf (not the __expf intrinsics) give the plain sweeps' bits: the kernels
// are bit-equal to ops/ctc_cuda.py's alpha_plain and beta_plain.
//
// What bounds it here: each sweep reads emit once and writes its output
// once, 2 B T S 4 bytes, with ~13 scalar operations per state and frame, so
// HBM bytes bound it (11 us at B = 32, T = 800, S = 197).  But a sweep is T
// dependent steps of S states each, so the latency of a step sets the time:
// one block per utterance, one thread per state, one block barrier a frame
// (the previous frame's row of states lives in a double-buffered shared row
// with NEG_INF sentinels at both ends, so a state reads its neighbours with
// no bounds check).  What the design keeps off a frame's chain:
//   - emit is staged in shared memory in chunks of Tc frames (a chunk of one
//     utterance is one contiguous range of Tc S floats) by a ring of three
//     stages: one thread starts each chunk's 16-byte aligned inner part as a
//     1-D TMA copy (cp.async.bulk) that completes on the stage's mbarrier,
//     six threads copy the up to 3 + 3 floats at its ends with cp.async.
//     The chunk after next is in flight while a chunk is swept, so a frame
//     reads emit from shared memory, never from HBM;
//   - the outputs go into a shared chunk that one thread stores with one TMA
//     copy when the chunk ends (six threads store the ends): no per-state
//     4-byte stores, and no burst of copy instructions on the chain (thread-
//     issued 16-byte copies of whole chunks, tried first, stalled the frame
//     at each chunk's end for several frames' time);
//   - lse3 takes the exp of the two arguments that are not the maximum: the
//     maximum's term is expf(0) = 1.0f exactly, and the sum keeps the plain
//     order (e_a + e_b) + e_c, so the result is the same to the bit; it has
//     no branch (a dead state's sums are finite and a select drops them).
// What is left is the frame's chain: the neighbours' shared loads after the
// barrier, lse3's dependent expf and logf (~250 cycles), the row's store and
// the barrier.  Frames past a row's length are filled with plain stores.
// Blocks of up to 256 threads (S <= 256) run an instance compiled with
// 256-thread launch bounds: at S = 197 on an H100 it is ~0.03-0.05 ms
// faster a sweep than the 1024-thread instance (torch_tools/ctc_dp_turns.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;     // NEG_INF / 2
constexpr float kLogFloor = 1e-37f;
constexpr int kMaxStates = 1024;          // one thread per lattice state
constexpr int kStages = 3;                // emit chunks: swept, next, after next
constexpr int kMaxChunk = 32;             // frames a chunk
constexpr int kSmemBudget = 200 * 1024;   // bytes of shared memory a block takes at most
constexpr int kBarBytes = 32;             // the emit ring's mbarriers, padded to 16

// log(e^a + e^b + e^c) with the sentinels, as ctc_ref._logaddexp3 computes it:
// m + log(exp(a - m) + exp(b - m) + exp(c - m) + 1e-37), summed left to right.
// The maximum's own term is exp(0) = 1.0f, so only the other two need expf
// (addition commutes, so (1 + e_b) equals (e_b + 1) bit for bit).  No branch:
// a dead state's sums are finite and the select drops them.
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const bool c_max = c == m;
  const float x = c_max ? a : (a == m ? b : a);
  const float y = c_max ? b : c;
  const float ex = expf(x - m);
  const float ey = expf(y - m);
  const float sum = c_max ? (ex + ey) + 1.0f : (1.0f + ex) + ey;
  const float out = m + logf(sum + kLogFloor);
  return m > kHalfNegInf ? out : kNegInf;
}

// Position of a float's address within its 16-byte group (0..3).
__device__ __forceinline__ int phase_of(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `kStages - 1` of this thread's cp.async groups are
// pending: at chunk c those are chunks c + 1 and c + 2.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* mb, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(mb)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* mb, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(mb)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* mb, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(mb)), "r"(parity)
        : "memory");
  }
}

// One TMA copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, completing on mbarrier mb; and from shared to
// global memory, in a bulk group of the issuing thread.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* mb) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(mb))
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// A range of n floats at g splits into a head up to the first 16-byte
// boundary, a 16-byte aligned inner part (TMA) and a tail of < 4 floats.
// In a stage, element i of the range sits at phase_of(g) + i, so that the
// inner part is 16-byte aligned on both sides.
struct Split {
  int ph, head, inner, tail;
  __device__ Split(const float* g, int n) {
    ph = phase_of(g);
    head = min((4 - ph) & 3, n);
    inner = (n - head) & ~3;
    tail = n - head - inner;
  }
};

// Start chunk [g, g + n) into `stage`: thread 0 the inner part by TMA on
// mb, threads 1-6 one end float each by cp.async (in the thread's group).
__device__ void fetch_chunk(float* stage, const float* g, int n, unsigned long long* mb) {
  const Split sp(g, n);
  if (threadIdx.x == 0) {
    mbar_expect(mb, sp.inner * 4);
    if (sp.inner > 0) bulk_load(stage + sp.ph + sp.head, g + sp.head, sp.inner * 4, mb);
  }
  const int k = (int)threadIdx.x - 1;
  if (k >= 0 && k < sp.head) cp_async4(stage + sp.ph + k, g + k);
  if (k >= sp.head && k < sp.head + sp.tail)
    cp_async4(stage + sp.ph + sp.inner + k, g + sp.inner + k);
  cp_async_commit();                       // a group even when empty
}

// Store `stage` (laid out as fetch_chunk lays a chunk out) to [g, g + n):
// thread 0 the inner part by TMA (one bulk group, always committed), threads
// 1-6 the ends.  Every thread has fenced its writes to the stage for the
// async proxy before the barrier that precedes this.
__device__ void store_chunk(float* g, const float* stage, int n) {
  const Split sp(g, n);
  if (threadIdx.x == 0) {
    if (sp.inner > 0) bulk_store(g + sp.head, stage + sp.ph + sp.head, sp.inner * 4);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  const int k = (int)threadIdx.x - 1;
  if (k >= 0 && k < sp.head) g[k] = stage[sp.ph + k];
  if (k >= sp.head && k < sp.head + sp.tail) g[sp.inner + k] = stage[sp.ph + sp.inner + k];
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared memory of a block: the emit ring's mbarriers [kStages] (32 bytes),
// then in floats the emit ring [kStages][stage], the output chunks
// [2][stage] and the row ring [2][r_len] (state s at index s + 2 of its row;
// two NEG_INF sentinels lead a row and two follow the threads' slots, so a
// state's neighbours need no bounds check).
struct Layout {
  int chunk;    // Tc, frames a chunk
  int r_len;    // floats of a row: threads + 4, rounded up to 4
  int stage;    // floats of one stage: Tc S and its phase, rounded up to 4
  size_t bytes;
};

Layout layout_for(int n_s, int threads) {
  Layout l;
  l.r_len = (threads + 4 + 3) / 4 * 4;
  const size_t fixed = kBarBytes + 2 * (size_t)l.r_len * 4 + (kStages + 2) * 16;
  l.chunk = (int)((kSmemBudget - fixed) / ((size_t)(kStages + 2) * n_s * 4));
  if (l.chunk > kMaxChunk) l.chunk = kMaxChunk;
  l.stage = (l.chunk * n_s + 3 + 3) / 4 * 4;
  l.bytes = kBarBytes + (2 * (size_t)l.r_len + (size_t)(kStages + 2) * l.stage) * sizeof(float);
  return l;
}

// The sentinels of both rows.
__device__ __forceinline__ void row_sentinels(float* row, int r_len) {
  const int i = threadIdx.x;
  if (i < 2) {
    row[i] = kNegInf;
    row[r_len + i] = kNegInf;
    row[blockDim.x + 2 + i] = kNegInf;
    row[r_len + blockDim.x + 2 + i] = kNegInf;
  }
}

// Both sweeps' skeleton: the chunks' emit staged by TMA three chunks deep,
// their outputs stored by TMA as each chunk ends.
struct Chunks {
  unsigned long long* bar;   // [kStages]
  float* ring;               // [kStages][stage]
  float* outs;               // [2][stage]
  float* row;                // [2][r_len]
  int stage;

  __device__ Chunks(float* smem, int stage_, int r_len) : stage(stage_) {
    bar = reinterpret_cast<unsigned long long*>(smem);
    ring = smem + kBarBytes / 4;
    outs = ring + kStages * stage;
    row = outs + 2 * stage;
    if (threadIdx.x == 0) {
      for (int k = 0; k < kStages; ++k) mbar_init(bar + k, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    row_sentinels(row, r_len);
    __syncthreads();
  }

  __device__ void fetch(int c, const float* g, int n) {
    fetch_chunk(ring + (c % kStages) * stage, g, n, bar + c % kStages);
  }

  // Chunk c's emit landed, every thread's copies visible; chunk c - 2's
  // outputs read out of its output chunk, which chunk c overwrites.  By
  // then chunks 0 .. c + 2 have each committed one cp.async group.
  __device__ void wait(int c) {
    cp_async_wait_ring();
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    mbar_wait(bar + c % kStages, (c / kStages) & 1);
    __syncthreads();
  }

  __device__ void finish() {
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
};

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
ctc_alpha_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                 const float* __restrict__ init, const int* __restrict__ lengths,
                 float* __restrict__ alpha, int n_t, int n_s, int chunk, int r_len,
                 int stage) {
  extern __shared__ __align__(16) float smem[];
  Chunks ch(smem, stage, r_len);
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < n_s;
  const int sr = on ? s : n_s - 1;        // the state whose emit this thread reads
  const int len = min(max(lengths[b], 0), n_t);
  const float* e = emit + (size_t)b * n_t * n_s;
  float* out = alpha + (size_t)b * n_t * n_s;
  const bool sk = on && s >= 2 && skip[(size_t)b * n_s + s] > 0.f;
  const float in0 = on ? init[(size_t)b * n_s + s] : kNegInf;
  const int n_chunks = (len + chunk - 1) / chunk;
  float* const mine = ch.row + 2 + s;     // this state's slot in row 0

  auto fetch = [&](int c) {                // chunk c into stage c % kStages
    if (c < n_chunks) {
      const int t0 = c * chunk;
      ch.fetch(c, e + (size_t)t0 * n_s, min(chunk, len - t0) * n_s);
    } else {
      cp_async_commit();                   // an empty group keeps the count
    }
  };
  for (int c = 0; c < kStages - 1; ++c) fetch(c);

  float a = kNegInf;                       // this state's alpha so far
  for (int c = 0; c < n_chunks; ++c) {
    // Stage (c - 1) % kStages was last read before the previous frame's
    // barrier: it takes the chunk after next.
    fetch(c + kStages - 1);
    ch.wait(c);
    const int t0 = c * chunk;
    const int nf = min(chunk, len - t0);
    const float* ein = ch.ring + (c % kStages) * stage + phase_of(e + (size_t)t0 * n_s) + sr;
    float* o = out + (size_t)t0 * n_s;
    float* oc = ch.outs + (c & 1) * stage;
    float* oin = oc + phase_of(o) + s;
    for (int j = 0; j < nf; ++j) {
      const int t = t0 + j;
      const float et = ein[j * n_s];
      const float* cur = mine + (t & 1) * r_len;
      if (t == 0) {
        a = in0 + et;
      } else {
        const float s1 = cur[-1];
        const float s2 = sk ? cur[-2] : kNegInf;
        a = lse3(a, s1, s2) + et;
      }
      mine[((t + 1) & 1) * r_len] = a;
      if (on) oin[j * n_s] = a;
      if (j == nf - 1) fence_async_shared();
      __syncthreads();
    }
    store_chunk(o, oc, nf * n_s);
  }
  ch.finish();
  // Frames past the length leave alpha untouched.
  if (on)
    for (int t = len; t < n_t; ++t) out[(size_t)t * n_s + s] = a;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
ctc_beta_kernel(const float* __restrict__ emit, const float* __restrict__ skip2,
                const float* __restrict__ final_mask, const int* __restrict__ lengths,
                float* __restrict__ beta, int n_t, int n_s, int chunk, int r_len,
                int stage) {
  extern __shared__ __align__(16) float smem[];
  Chunks ch(smem, stage, r_len);          // the row holds be = beta + emit
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < n_s;
  const int sr = on ? s : n_s - 1;
  const int len = max(lengths[b], 0);
  const int top = min(len, n_t) - 1;      // first frame of the sweep
  const float* e = emit + (size_t)b * n_t * n_s;
  float* out = beta + (size_t)b * n_t * n_s;
  const bool sk = on && s + 2 < n_s && skip2[(size_t)b * n_s + s] > 0.f;
  // final applies at t = len - 1; a length past T never reaches it.
  const float fin = (on && len <= n_t) ? final_mask[(size_t)b * n_s + s] : kNegInf;
  // Chunk c holds frames [lo, hi], hi = top - c Tc, swept from hi down.
  const int n_chunks = (top + 1 + chunk - 1) / chunk;
  float* const mine = ch.row + 2 + s;

  auto fetch = [&](int c) {
    if (c < n_chunks) {
      const int hi = top - c * chunk;
      const int lo = max(hi - chunk + 1, 0);
      ch.fetch(c, e + (size_t)lo * n_s, (hi - lo + 1) * n_s);
    } else {
      cp_async_commit();
    }
  };
  for (int c = 0; c < kStages - 1; ++c) fetch(c);

  if (on)
    for (int t = top + 1; t < n_t; ++t) out[(size_t)t * n_s + s] = kNegInf;
  for (int c = 0; c < n_chunks; ++c) {
    fetch(c + kStages - 1);
    ch.wait(c);
    const int hi = top - c * chunk;
    const int lo = max(hi - chunk + 1, 0);
    const int nf = hi - lo + 1;
    const float* ein = ch.ring + (c % kStages) * stage + phase_of(e + (size_t)lo * n_s) + sr;
    float* o = out + (size_t)lo * n_s;
    float* oc = ch.outs + (c & 1) * stage;
    float* oin = oc + phase_of(o) + s;
    for (int j = nf - 1; j >= 0; --j) {
      const int i = top - lo - j;          // frame t = lo + j is step top - t
      const float* cur = mine + (i & 1) * r_len;
      float bv;
      if (i == 0) {
        bv = fin;
      } else {
        const float s1 = cur[1];
        const float s2 = sk ? cur[2] : kNegInf;
        bv = lse3(cur[0], s1, s2);
      }
      if (on) oin[j * n_s] = bv;
      // a thread past S keeps NEG_INF in its slot: the last states'
      // neighbours
      mine[((i + 1) & 1) * r_len] = on ? bv + ein[j * n_s] : kNegInf;
      if (j == 0) fence_async_shared();
      __syncthreads();
    }
    store_chunk(o, oc, nf * n_s);
  }
  ch.finish();
}

template <int kThreads>
int launch_with(bool is_alpha, const float* emit, const float* mask_a,
                const float* mask_b, const int* lengths, float* out, int n_b,
                int n_t, int n_s, cudaStream_t stream) {
  const int threads = (n_s + 31) / 32 * 32;
  const Layout l = layout_for(n_s, threads);
  auto kernel = is_alpha ? ctc_alpha_kernel<kThreads> : ctc_beta_kernel<kThreads>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_b, threads, l.bytes, stream>>>(emit, mask_a, mask_b, lengths, out, n_t,
                                            n_s, l.chunk, l.r_len, l.stage);
  return (int)cudaGetLastError();
}

int launch(bool is_alpha, const float* emit, const float* mask_a,
           const float* mask_b, const int* lengths, float* out, int n_b,
           int n_t, int n_s, cudaStream_t stream) {
  if (n_b < 1 || n_t < 1 || n_s < 1 || n_s > kMaxStates) return (int)cudaErrorInvalidValue;
  // The 256-thread instance is the faster one where it fits (see the top).
  return n_s <= 256
             ? launch_with<256>(is_alpha, emit, mask_a, mask_b, lengths, out, n_b, n_t, n_s, stream)
             : launch_with<kMaxStates>(is_alpha, emit, mask_a, mask_b, lengths, out, n_b, n_t,
                                       n_s, stream);
}

}  // namespace

extern "C" {

// emit, alpha [B, T, S] f32; skip, init [B, S] f32; lengths [B] int32.
// Returns 0 or a CUDA error code.
int ctc_alpha_launch(const float* emit, const float* skip, const float* init,
                     const int* lengths, float* alpha, int n_b, int n_t, int n_s,
                     void* stream) {
  return launch(true, emit, skip, init, lengths, alpha, n_b, n_t, n_s,
                static_cast<cudaStream_t>(stream));
}

// emit, beta [B, T, S] f32; skip2, final [B, S] f32; lengths [B] int32.
int ctc_beta_launch(const float* emit, const float* skip2, const float* final_mask,
                    const int* lengths, float* beta, int n_b, int n_t, int n_s,
                    void* stream) {
  return launch(false, emit, skip2, final_mask, lengths, beta, n_b, n_t, n_s,
                static_cast<cudaStream_t>(stream));
}

// Frames a chunk for S lattice states (for the tests and tools).
int ctc_chunk_frames(int n_s) {
  return n_s < 1 || n_s > kMaxStates ? 0 : layout_for(n_s, (n_s + 31) / 32 * 32).chunk;
}

}  // extern "C"
