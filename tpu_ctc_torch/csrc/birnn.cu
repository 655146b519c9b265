// The clipped-ReLU recurrence of one BiRNN direction and its backward delta
// sweep, for Hopper (sm_90a): kernels B1 and B2, one source.
//
// B1 replaces tpu_ctc/ops/birnn_pallas.py::_fwd_kernel (launched by _run_fwd):
//     h_t = clip(z_t + bf16(h_{t-1}) @ W, 0, clip) * 1{t < len_b}
// swept forward or reversed in time from a zero carry.
// B2 replaces birnn_pallas.py::_bwd_kernel (launched by _run_bwd):
//     d_t = (g_t + bf16(d_next) @ W^T) * 1{0 < h_t < clip}
// swept against the forward sweep's time order from a zero carry: right to
// left for the forward direction, left to right for the reversed one.  Its
// activity mask reads the stored io-type h widened to f32; padded frames
// need no length mask, since their stored h is 0.
// Both are one template, sweep_kernel<T, kBwd>: the swept input (z or g),
// the output (h or d) and the exchanged carry are in the io type (bf16 or
// f32), the dot product takes the io-type carry and accumulates in f32, and
// each new value is rounded to the io type once, where it is stored.  Only
// the epilogue (the mask, and the clip of B1) differs.
//
// What bounds it here: a sweep is T dependent [B, H] x [H, H] products.  The
// TPU kernels keep all of W in one core's VMEM; at H = 1824 W is 6.65 MB in
// bf16, far over one SM's 227 KB.  So W (W^T for B2) is split by columns
// over the grid: block j owns columns [16 j, 16 j + 16) in shared memory
// (H x 16 x 2 B = 58 KB at H = 1824, for the whole sweep) and produces
// those columns of the new value.  Each step every block needs the whole
// previous value, so it goes through a double-buffered [2, B, H] exchange
// buffer in global memory (it stays in L2: 233 KB at B = 64) and a
// grid-wide barrier separates the steps.  Per step the whole card does
// 2 B H^2 FLOP in f32 FMA and every block reads B H io values from L2: the
// L2 reads, the FMA rate and the barrier latency bound a step, not HBM.
//
// The barrier spins on a global counter, which deadlocks unless every
// block is resident at once.  The launch is cooperative
// (cudaLaunchCooperativeKernel refuses a grid that cannot be co-resident)
// and the occupancy is checked first, so an oversized grid fails with an
// error instead of hanging.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;      // columns of W per block
constexpr int kThreads = 256;  // 64 rows x 4 column quads per pass
constexpr int kMaxB = 128;     // batch rows a launch takes
constexpr int kKc = 64;        // k-chunk of the carry staged in shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// L2-only load and store of the exchange buffer: other SMs wrote it, so
// it must not come from this SM's L1.
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_cg(const __nv_bfloat16* p) {
  unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __ushort_as_bfloat16(u);
}
__device__ __forceinline__ void st_cg(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void st_cg(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

// Grid-wide barrier: all blocks' writes before it are visible to all
// blocks after it (bar.sync + gpu-scope fence, as cooperative_groups does).
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(count) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// x: z (B1) or g (B2); w: W (B1) or W^T (B2); lengths: B1 only; hs: the
// stored forward states, B2 only; out: h (B1) or d (B2).
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const int* __restrict__ lengths, const T* __restrict__ hs,
             T* __restrict__ out, T* xbuf, unsigned int* count, int n_t,
             int n_b, int n_h, int reverse, float clip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);             // [H][kCols]
  const int c_stride = kKc + 4 / (int)sizeof(T);       // pad one 32-bit word
  T* c_s = w_s + (size_t)n_h * kCols;                  // [kMaxB][c_stride]

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kCols;
  const int quad = tid & 3;             // columns j0 + 4 quad .. + 3
  const int row0 = tid >> 2;            // rows row0, row0 + 64
  const unsigned int nblk = gridDim.x;

  for (int i = tid; i < n_h * kCols; i += kThreads) {
    int k = i / kCols, c = i % kCols;
    w_s[i] = (j0 + c < n_h) ? w[(size_t)k * n_h + j0 + c] : from_f<T>(0.f);
  }
  __syncthreads();

  for (int s = 0; s < n_t; ++s) {
    const int t = reverse ? n_t - 1 - s : s;
    const T* src = xbuf + (size_t)(s & 1) * n_b * n_h;
    T* dst = xbuf + (size_t)((s + 1) & 1) * n_b * n_h;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

    for (int k0 = 0; k0 < n_h; k0 += kKc) {
      const int kc = min(kKc, n_h - k0);
      for (int i = tid; i < n_b * kc; i += kThreads) {
        int b = i / kc, k = i % kc;
        c_s[b * c_stride + k] = ld_cg(src + (size_t)b * n_h + k0 + k);
      }
      __syncthreads();
      {
        const T* c0row = c_s + row0 * c_stride;
        const T* c1row = c0row + 64 * c_stride;
        const T* wk = w_s + (size_t)k0 * kCols + 4 * quad;
        const bool row0_live = row0 < n_b, row1_live = row0 + 64 < n_b;
        for (int k = 0; k < kc; ++k) {
          float wv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) wv[c] = to_f(wk[k * kCols + c]);
          if (row0_live) {
            const float cv = to_f(c0row[k]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[0][c] += cv * wv[c];
          }
          if (row1_live) {
            const float cv = to_f(c1row[k]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[1][c] += cv * wv[c];
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int b = row0 + 64 * r;
      if (b >= n_b) continue;
      const bool live = kBwd || t < lengths[b];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + 4 * quad + c;
        if (j >= n_h) continue;
        const size_t o = ((size_t)t * n_b + b) * n_h + j;
        float v;
        if (kBwd) {
          const float h = to_f(hs[o]);
          v = (h > 0.f && h < clip) ? to_f(x[o]) + acc[r][c] : 0.f;
        } else {
          v = live ? fminf(fmaxf(to_f(x[o]) + acc[r][c], 0.f), clip) : 0.f;
        }
        const T ov = from_f<T>(v);
        out[o] = ov;
        st_cg(dst + (size_t)b * n_h + j, ov);
      }
    }
    grid_barrier(count, nblk * (unsigned int)(s + 1));
  }
}

template <typename T, bool kBwd>
int launch(const void* x, const void* w, const int* lengths, const void* hs,
           void* out, void* xbuf, unsigned int* count, int n_t, int n_b,
           int n_h, int reverse, float clip, cudaStream_t stream) {
  if (n_b < 1 || n_b > kMaxB || n_h < 1 || n_t < 1) return (int)cudaErrorInvalidValue;
  const int grid = (n_h + kCols - 1) / kCols;
  const size_t smem = ((size_t)n_h * kCols + (size_t)kMaxB * (kKc + 4 / sizeof(T))) * sizeof(T);
  auto kern = sweep_kernel<T, kBwd>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * n_sm < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* hp = static_cast<const T*>(hs);
  T* op = static_cast<T*>(out);
  T* bp = static_cast<T*>(xbuf);
  void* args[] = {(void*)&xp, (void*)&wp, (void*)&lengths, (void*)&hp, (void*)&op,
                  (void*)&bp, (void*)&count, (void*)&n_t, (void*)&n_b, (void*)&n_h,
                  (void*)&reverse, (void*)&clip};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kBwd>
int dispatch(const void* x, const void* w, const int* lengths, const void* hs,
             void* out, void* xbuf, unsigned int* count, int n_t, int n_b,
             int n_h, int reverse, float clip, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, kBwd>(x, w, lengths, hs, out, xbuf, count, n_t,
                                       n_b, n_h, reverse, clip, st);
  return launch<float, kBwd>(x, w, lengths, hs, out, xbuf, count, n_t, n_b, n_h,
                             reverse, clip, st);
}

}  // namespace

extern "C" {

// B1.  z, hs [T, B, H] and w [H, H] in the io type; lengths [B] int32;
// xbuf [2, B, H] io type, zeroed (the zero carry h_{-1}); count one zeroed
// uint32.  Returns 0 or a CUDA error code.
int birnn_fwd_launch(const void* z, const void* w, const int* lengths, void* hs,
                     void* xbuf, unsigned int* count, int n_t, int n_b, int n_h,
                     int reverse, float clip, int bf16, void* stream) {
  return dispatch<false>(z, w, lengths, nullptr, hs, xbuf, count, n_t, n_b, n_h,
                         reverse, clip, bf16, stream);
}

// B2.  g, hs, d_out [T, B, H] and wt = W^T [H, H] in the io type; the rest
// as for B1.  The argument order follows birnn_fwd_launch: the swept input,
// the weights, the third input (hs here, lengths there), the output.
int birnn_bwd_launch(const void* g, const void* wt, const void* hs, void* d_out,
                     void* xbuf, unsigned int* count, int n_t, int n_b, int n_h,
                     int reverse, float clip, int bf16, void* stream) {
  return dispatch<true>(g, wt, nullptr, hs, d_out, xbuf, count, n_t, n_b, n_h,
                        reverse, clip, bf16, stream);
}

}  // extern "C"
