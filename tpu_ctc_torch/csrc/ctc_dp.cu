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
// logf (not the __expf intrinsics) keep the sums within an ulp or two of
// PyTorch's exp and log.
//
// What bounds it here: each sweep reads emit once and writes its output
// once, 2 B T S 4 bytes, with ~13 scalar operations per state and frame, so
// HBM bytes bound it (12 us at B = 32, T = 800, S = 201).  But a sweep is T
// dependent steps, and a step of one utterance is only S states.  One
// block per utterance and one thread per state: the previous row lives in a
// double-buffered shared-memory row, so a step costs one __syncthreads and
// the neighbour reads are shared-memory reads; the next frame's emission is
// loaded into a register before the barrier so its global latency overlaps
// the step.  The latency of T such steps, not bytes, sets the time of this
// first version; frames past a row's length are filled without barriers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;     // NEG_INF / 2
constexpr float kLogFloor = 1e-37f;
constexpr int kMaxStates = 1024;          // one thread per lattice state

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kHalfNegInf);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms) + kLogFloor);
  return m > kHalfNegInf ? out : kNegInf;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ emit,
                                 const float* __restrict__ skip,
                                 const float* __restrict__ init,
                                 const int* __restrict__ lengths,
                                 float* __restrict__ alpha, int n_t, int n_s) {
  extern __shared__ float row[];          // [2][n_s]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < n_s;
  const int len = min(max(lengths[b], 0), n_t);
  const float* e = emit + (size_t)b * n_t * n_s;
  float* out = alpha + (size_t)b * n_t * n_s;
  const bool sk = on && s >= 2 && skip[(size_t)b * n_s + s] > 0.f;
  const float in0 = on ? init[(size_t)b * n_s + s] : kNegInf;

  float a = kNegInf;                      // this state's alpha so far
  float e_next = (on && len > 0) ? e[s] : 0.f;
  for (int t = 0; t < len; ++t) {
    const float et = e_next;
    if (on && t + 1 < len) e_next = e[(size_t)(t + 1) * n_s + s];
    const float* cur = row + (t & 1) * n_s;
    float* nxt = row + ((t + 1) & 1) * n_s;
    if (on) {
      if (t == 0) {
        a = in0 + et;
      } else {
        const float s1 = s >= 1 ? cur[s - 1] : kNegInf;
        const float s2 = sk ? cur[s - 2] : kNegInf;
        a = lse3(a, s1, s2) + et;
      }
      nxt[s] = a;
      out[(size_t)t * n_s + s] = a;
    }
    __syncthreads();
  }
  // Frames past the length leave alpha untouched.
  if (on)
    for (int t = len; t < n_t; ++t) out[(size_t)t * n_s + s] = a;
}

__global__ void ctc_beta_kernel(const float* __restrict__ emit,
                                const float* __restrict__ skip2,
                                const float* __restrict__ final_mask,
                                const int* __restrict__ lengths,
                                float* __restrict__ beta, int n_t, int n_s) {
  extern __shared__ float row[];          // [2][n_s]: be = beta + emit
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < n_s;
  const int len = max(lengths[b], 0);
  const int top = min(len, n_t) - 1;      // first frame of the sweep
  const float* e = emit + (size_t)b * n_t * n_s;
  float* out = beta + (size_t)b * n_t * n_s;
  const bool sk = on && s + 2 < n_s && skip2[(size_t)b * n_s + s] > 0.f;
  // final applies at t = len - 1; a length past T never reaches it.
  const float fin = (on && len <= n_t) ? final_mask[(size_t)b * n_s + s] : kNegInf;

  if (on)
    for (int t = top + 1; t < n_t; ++t) out[(size_t)t * n_s + s] = kNegInf;
  float e_next = (on && top >= 0) ? e[(size_t)top * n_s + s] : 0.f;
  for (int t = top; t >= 0; --t) {
    const int i = top - t;
    const float et = e_next;
    if (on && t > 0) e_next = e[(size_t)(t - 1) * n_s + s];
    const float* cur = row + (i & 1) * n_s;
    float* nxt = row + ((i + 1) & 1) * n_s;
    if (on) {
      float bv;
      if (i == 0) {
        bv = fin;
      } else {
        const float s1 = s + 1 < n_s ? cur[s + 1] : kNegInf;
        const float s2 = sk ? cur[s + 2] : kNegInf;
        bv = lse3(cur[s], s1, s2);
      }
      out[(size_t)t * n_s + s] = bv;
      nxt[s] = bv + et;
    }
    __syncthreads();
  }
}

int launch(bool is_alpha, const float* emit, const float* mask_a,
           const float* mask_b, const int* lengths, float* out, int n_b,
           int n_t, int n_s, cudaStream_t stream) {
  if (n_b < 1 || n_t < 1 || n_s < 1 || n_s > kMaxStates) return (int)cudaErrorInvalidValue;
  const int threads = (n_s + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)n_s * sizeof(float);
  if (is_alpha)
    ctc_alpha_kernel<<<n_b, threads, smem, stream>>>(emit, mask_a, mask_b, lengths,
                                                     out, n_t, n_s);
  else
    ctc_beta_kernel<<<n_b, threads, smem, stream>>>(emit, mask_a, mask_b, lengths,
                                                    out, n_t, n_s);
  return (int)cudaGetLastError();
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

}  // extern "C"
