// The clipped-ReLU recurrence of one BiRNN direction and its backward delta
// sweep, for Hopper (sm_90a): kernels B1 and B2, one source.
//
// B1 replaces tpu_ctc/ops/birnn_pallas.py:103 (_fwd_kernel, launched by
// _run_fwd):
//     h_t = clip(z_t + bf16(h_{t-1}) @ W, 0, clip) * 1{t < len_b}
// swept forward or reversed in time from the carry h0 (h_{-1} forward, h_T
// reversed): zero, or the [B, H] io-type state that the launcher copies
// into the exchange buffer's first half, which the first step reads.  The
// f32 instance stages that half in shared memory like any step's carry, the
// bf16 instance streams it through its copy rings.  A dead first frame
// writes zero and zeroes the carry, so h0 reaches only the rows whose first
// processed frame is live, as in the Pallas kernel.
// B2 replaces birnn_pallas.py:167 (_bwd_kernel, launched by _run_bwd):
//     d_t = (g_t + bf16(d_next) @ W^T) * 1{0 < h_t < clip}
// swept against the forward sweep's time order from a zero carry: right to
// left for the forward direction, left to right for the reversed one.  Its
// activity mask reads the stored io-type h widened to f32; padded frames
// need no length mask, since their stored h is 0.
// In both, the swept input (z or g), the output (h or d) and the exchanged
// carry are in the io type (bf16 or f32), the dot product takes the io-type
// carry and accumulates in f32, and each new value is rounded to the io
// type once, where it is stored.  Only the epilogue (the mask, and the clip
// of B1) differs between B1 and B2.
//
// What bounds a step.  A sweep is T dependent [B, H] x [H, H] products;
// at H = 1824, B = 64 a step is 2 B H^2 = 426 MFLOP, 0.43 us on the tensor
// cores.  The TPU kernels keep all of W in one core's VMEM, but in bf16 it
// is 6.65 MB at H = 1824, far over one SM's 227 KB.  So W (W^T for B2) is
// split by columns over the grid: block j owns columns [16 j, 16 j + 16)
// for the whole sweep and produces those columns of the new value.  Every
// block needs the whole previous value, which goes through a
// double-buffered [2, B_pad, H_pad] exchange buffer in global memory (it
// stays in L2: 233 KB at B = 64) and a grid barrier separates the steps.
// A step is therefore bound by each SM's read of the previous value from
// L2 (B_pad H_pad 2 bytes a block; 26.6 MB over 114 blocks at H = 1824,
// B = 64) and by the latency of the grid barrier, not by HBM and not by
// the tensor cores.  On an H100 SXM (700 W) a step at H = 1824, B = 64
// takes ~12 us, ~72% of it the fetch of the previous value at ~3 TB/s
// from L2; at H = 1024, B = 32 ~4.7 us, the fetch latency-bound
// (torch_tools/birnn_step_breakdown.py times a step's phases).
//
// The bf16 design (mma_sweep_kernel), aimed at those two:
// - The product runs on the tensor cores.  Each of the 8 warps owns a
//   contiguous range of the H_pad / 16 k-tiles and computes the block's
//   [B_pad, 16] product over it with mma.sync m16n8k16 (bf16 operands, f32
//   accumulators), fragments loaded with ldmatrix.  A product of two bf16
//   values is exact in f32 and the sums are f32, as in the Pallas kernels'
//   jnp.dot(h.astype(bf16), W, preferred_element_type=f32).
// - W stays on chip: the block's 16 columns, transposed and zero-padded to
//   H_pad rows, are loaded into shared memory once per sweep; a row is
//   padded by 16 bytes, so ldmatrix's eight rows fall in distinct banks.
// - The state moves in 16-byte asynchronous copies.  The wrapper pads B and
//   H to multiples of 16 with zeros, so every row of the exchange buffer is
//   16-byte aligned (H = 100 too).  Each warp streams its own k-range of
//   the previous value from L2 with cp.async.cg (L2 only: other SMs wrote
//   it) through a private ring of kStages 4 KB stages, waiting with
//   cp.async.wait_group and __syncwarp: no block barrier in the k loop.
//   The ring's chunks are XOR-swizzled so ldmatrix reads them without bank
//   conflicts.
// - One block barrier a step.  Each warp writes its split-K partial into
//   its own ring (which it has finished reading), and after one
//   __syncthreads the thread that owns 8 outputs sums the 8 partials in
//   warp order: the order is fixed, so two launches are bit-equal.
// - A split grid barrier on one counter.  Each warp that stores new values
//   arrives as soon as they are in the exchange buffer (__syncwarp, then
//   one lane's red.release.gpu: the release is cumulative, so it publishes
//   the whole warp's stores, as CUTLASS's grid barrier publishes a block's
//   after __syncthreads), then stores them to out and prefetches the next
//   frame's z (B1) or g and h (B2) while the other blocks finish; every
//   warp waits (ld.acquire.gpu) only before its first copy of the next
//   step.  A warp that passes the wait knows that every block finished the
//   step, so every read of the buffer half that the next step overwrites,
//   and every read of its own ring's partial, is done.
//
// The f32 instances (f32_sweep_kernel: preset 1 and the f32 card tests)
// keep exact f32 products on the FP32 pipe, with no TF32: they keep the
// scalar loop of the first design (the carry staged in k-chunks of 64
// between two block barriers, 16 columns per block), on the same padded
// exchange buffer and with the same grid barrier, arrived at and waited
// for once a step by thread 0.
//
// The barrier spins, which deadlocks unless every block is resident at
// once.  The launch is cooperative (cudaLaunchCooperativeKernel refuses a
// grid that cannot be co-resident) and the occupancy is checked first, so
// an oversized grid fails with an error instead of hanging.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kCols = 16;           // columns of W per block: one k-tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 128;          // batch rows a launch takes
constexpr int kPad = 16;            // B and H are padded to multiples of it
constexpr int kStages = 4;          // stages of a warp's cp.async ring
constexpr int kStageBytes = 4096;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kKc = 64;             // f32: k-chunk of the staged carry

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ---- the grid barrier: one counter, arrivals with release semantics ------

__device__ __forceinline__ void arrive(unsigned int* count) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(count),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spin until the counter reaches `target`.  A step takes microseconds, so
// a wait of kHangNs is a fault (a lost arrival): it traps, and the launch
// fails with an error instead of hanging the card.
constexpr unsigned long long kHangNs = 10000000000ull;

__device__ __forceinline__ void wait_count(const unsigned int* count,
                                           unsigned int target) {
  const unsigned long long t0 = global_ns();
  unsigned int v;
  while (true) {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(count)
                 : "memory");
    if (v >= target) return;
    if (global_ns() - t0 > kHangNs) __trap();
  }
}

// ---- the bf16 kernel's PTX -------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b: a 16x16 row-major bf16 tile, b 16x8 column-major, d f32 16x8
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

union Pack8 {  // 8 bf16 values, one 16-byte access
  uint4 u;
  bf16 h[8];
};

// The n (<= 8) values at p, zeros after them; one 16-byte load if `vec`.
__device__ __forceinline__ uint4 load8(const bf16* p, int n, bool vec) {
  Pack8 v;
  if (vec && n == 8) return __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
  for (int i = 0; i < 8; ++i) v.h[i] = i < n ? p[i] : __float2bfloat16(0.f);
  return v.u;
}

__device__ __forceinline__ void store8(bf16* p, const Pack8& v, int n,
                                       bool vec) {
  if (vec && n == 8) {
    *reinterpret_cast<uint4*>(p) = v.u;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < n) p[i] = v.h[i];
}

// x: z (B1) or g (B2); w: W (B1) or W^T (B2), [H, H]; lengths: B1 only;
// hs: the stored forward states, B2 only; out: h (B1) or d (B2); xbuf:
// [2, B_pad, H_pad], zeroed; count: one zeroed counter.  `vec`: H % 8 == 0
// and x, hs, out 16-byte aligned, so their rows of 8 are single accesses.
template <bool kBwd>
__global__ void __launch_bounds__(kThreads, 1)
mma_sweep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const int* __restrict__ lengths, const bf16* __restrict__ hs,
                 bf16* __restrict__ out, bf16* xbuf, unsigned int* count,
                 int n_t, int n_b, int n_h, int reverse, float clip,
                 bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h_pad = round_up(n_h, kPad), b_pad = round_up(n_b, kPad);
  const int n_mt = b_pad / 16;          // m-tiles of the batch
  const int w_ld = h_pad + 8;           // a row of w_s, padded by 16 bytes
  bf16* w_s = reinterpret_cast<bf16*>(smem + kWarps * kRingBytes);  // [16][w_ld]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kCols;

  // W's 16 columns, once: w_s[n][k] = w[k][j0 + n], zero past H
  for (int i = tid; i < h_pad * kCols; i += kThreads) {
    const int k = i / kCols, n = i % kCols;
    w_s[n * w_ld + k] = (k < n_h && j0 + n < n_h)
                            ? w[(size_t)k * n_h + j0 + n]
                            : __float2bfloat16(0.f);
  }
  __syncthreads();

  // This warp's k-tiles [kt0, kt1), tps of them to a stage.  A tile is
  // [b_pad rows][16 k] in the ring, 32 bytes a row; the 16-byte chunk c of
  // row r sits at c ^ bit 2 of r, so ldmatrix's 8 rows hit 8 bank groups.
  const int n_kt = h_pad / 16;
  const int kt0 = warp * n_kt / kWarps, kt1 = (warp + 1) * n_kt / kWarps;
  const int tile_bytes = b_pad * 32;
  const int tps = max(1, kStageBytes / tile_bytes);
  const int n_st = (kt1 - kt0 + tps - 1) / tps;
  unsigned char* ring = smem + warp * kRingBytes;
  const uint32_t ring_sa = smem_u32(ring);
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_off =
      a_row * 32 + (((lane >> 4) ^ ((a_row >> 2) & 1)) * 16);
  const uint32_t w_sa =
      smem_u32(w_s) +
      ((((lane >> 4) & 1) * 8 + (lane & 7)) * w_ld + ((lane >> 3) & 1) * 8) * 2;

  // The epilogue: thread tid < 2 b_pad owns row eb, columns j0 + c0 .. + 7.
  // Those threads fill warps 0 .. n_mt - 1, which arrive at the barrier.
  const bool epi = tid < 2 * b_pad;
  const int eb = tid >> 1, c0 = (tid & 1) * 8;
  const bool row_live = epi && eb < n_b;
  const int n_val = min(max(n_h - (j0 + c0), 0), 8);
  const int len_b = (!kBwd && row_live) ? lengths[eb] : 0;
  const unsigned int per_step = gridDim.x * (unsigned int)n_mt;
  Pack8 xv, hv;  // the frame's x (and h, B2) values, loaded a step ahead
  xv.u = hv.u = make_uint4(0, 0, 0, 0);
  if (row_live) {
    const int t = reverse ? n_t - 1 : 0;
    const size_t o = ((size_t)t * n_b + eb) * n_h + j0 + c0;
    xv.u = load8(x + o, n_val, vec);
    if (kBwd) hv.u = load8(hs + o, n_val, vec);
  }

  for (int s = 0; s < n_t; ++s) {
    const int t = reverse ? n_t - 1 - s : s;
    const bf16* src = xbuf + (size_t)(s & 1) * b_pad * h_pad;
    bf16* dst = xbuf + (size_t)((s + 1) & 1) * b_pad * h_pad;
    if (s > 0) {  // every block's values of step s - 1 are in src
      if (lane == 0) wait_count(count, per_step * s);
      __syncwarp();
    }

    auto fetch = [&](int st) {  // stage st of src into its ring slot
      const int k_first = kt0 + st * tps;
      const int n_in = min(tps, kt1 - k_first);
      const uint32_t slot = ring_sa + (st % kStages) * kStageBytes;
      for (int i = lane; i < n_in * b_pad * 2; i += 32) {
        const int c = i & 1, rk = i >> 1;
        const int r = rk / n_in, kk = rk - r * n_in;
        cp_async16(slot + kk * tile_bytes + r * 32 + ((c ^ ((r >> 2) & 1)) * 16),
                   src + (size_t)r * h_pad + (k_first + kk) * 16 + c * 8);
      }
    };

    float acc[kMaxB / 16][2][4];
#pragma unroll
    for (int mt = 0; mt < kMaxB / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_st) fetch(st);
      cp_async_commit();
    }
    for (int st = 0; st < n_st; ++st) {
      cp_async_wait<kStages - 2>();  // stage st has landed
      __syncwarp();                  // ... for every lane; slot st - 1 is free
      if (st + kStages - 1 < n_st) fetch(st + kStages - 1);
      cp_async_commit();
      const int k_first = kt0 + st * tps;
      const int n_in = min(tps, kt1 - k_first);
      const uint32_t slot = ring_sa + (st % kStages) * kStageBytes + a_off;
      for (int kk = 0; kk < n_in; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, w_sa + (k_first + kk) * 32);
#pragma unroll
        for (int mt = 0; mt < kMaxB / 16; ++mt) {
          if (mt < n_mt) {
            uint32_t a[4];
            ldmatrix_x4(a, slot + kk * tile_bytes + mt * 512);
            mma_bf16(acc[mt][0], a, b[0], b[1]);
            mma_bf16(acc[mt][1], a, b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();  // every lane is done with the ring

    // this warp's partial, [b_pad][16] f32, into its own ring
    float* part = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int mt = 0; mt < kMaxB / 16; ++mt) {
      if (mt < n_mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = mt * 16 + (lane >> 2), c = nt * 8 + (lane & 3) * 2;
          *reinterpret_cast<float2*>(part + r * 16 + c) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<float2*>(part + (r + 8) * 16 + c) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
    }
    __syncthreads();

    if (epi) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) {  // fixed order: bit-equal launches
        const float4* p = reinterpret_cast<const float4*>(
            smem + wi * kRingBytes + (eb * 16 + c0) * 4);
        const float4 lo = p[0], hi = p[1];
        v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
        v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
      }
      const bool live = kBwd || t < len_b;
      Pack8 o;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float r = 0.f;
        if (row_live && i < n_val) {
          const float xi = __bfloat162float(xv.h[i]);
          if (kBwd) {
            const float h = __bfloat162float(hv.h[i]);
            r = (h > 0.f && h < clip) ? xi + v[i] : 0.f;
          } else {
            r = live ? fminf(fmaxf(xi + v[i], 0.f), clip) : 0.f;
          }
        }
        o.h[i] = __float2bfloat16(r);  // round to nearest even, as XLA
      }
      if (eb < n_b)  // rows past B stay zero
        __stcg(reinterpret_cast<uint4*>(dst + (size_t)eb * h_pad + j0 + c0), o.u);
      __syncwarp();  // the lanes' stores come before lane 0's release
      if (lane == 0) arrive(count);
      // off the critical path: the HBM store and the next frame's inputs
      if (row_live) {
        store8(out + ((size_t)t * n_b + eb) * n_h + j0 + c0, o, n_val, vec);
        if (s + 1 < n_t) {
          const int tn = reverse ? t - 1 : t + 1;
          const size_t on = ((size_t)tn * n_b + eb) * n_h + j0 + c0;
          xv.u = load8(x + on, n_val, vec);
          if (kBwd) hv.u = load8(hs + on, n_val, vec);
        }
      }
    }
  }
}

// The f32 sweep: exact f32 products by scalar FMAs.
// 256 threads = 64 rows x 4 column quads a pass, two passes for B <= 128.
template <bool kBwd>
__global__ void __launch_bounds__(kThreads)
f32_sweep_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const int* __restrict__ lengths, const float* __restrict__ hs,
                 float* __restrict__ out, float* xbuf, unsigned int* count,
                 int n_t, int n_b, int n_h, int reverse, float clip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);     // [H][kCols]
  const int c_stride = kKc + 1;
  float* c_s = w_s + (size_t)n_h * kCols;              // [kMaxB][c_stride]
  const int h_pad = round_up(n_h, kPad), b_pad = round_up(n_b, kPad);

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kCols;
  const int quad = tid & 3;             // columns j0 + 4 quad .. + 3
  const int row0 = tid >> 2;            // rows row0, row0 + 64
  const unsigned int nblk = gridDim.x;

  for (int i = tid; i < n_h * kCols; i += kThreads) {
    int k = i / kCols, c = i % kCols;
    w_s[i] = (j0 + c < n_h) ? w[(size_t)k * n_h + j0 + c] : 0.f;
  }
  __syncthreads();

  for (int s = 0; s < n_t; ++s) {
    const int t = reverse ? n_t - 1 - s : s;
    const float* src = xbuf + (size_t)(s & 1) * b_pad * h_pad;
    float* dst = xbuf + (size_t)((s + 1) & 1) * b_pad * h_pad;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

    for (int k0 = 0; k0 < n_h; k0 += kKc) {
      const int kc = min(kKc, n_h - k0);
      for (int i = tid; i < n_b * kc; i += kThreads) {
        int b = i / kc, k = i % kc;
        c_s[b * c_stride + k] = __ldcg(src + (size_t)b * h_pad + k0 + k);
      }
      __syncthreads();
      {
        const float* c0row = c_s + row0 * c_stride;
        const float* c1row = c0row + 64 * c_stride;
        const float* wk = w_s + (size_t)k0 * kCols + 4 * quad;
        const bool row0_live = row0 < n_b, row1_live = row0 + 64 < n_b;
        for (int k = 0; k < kc; ++k) {
          float wv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) wv[c] = wk[k * kCols + c];
          if (row0_live) {
            const float cv = c0row[k];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[0][c] += cv * wv[c];
          }
          if (row1_live) {
            const float cv = c1row[k];
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
          const float h = hs[o];
          v = (h > 0.f && h < clip) ? x[o] + acc[r][c] : 0.f;
        } else {
          v = live ? fminf(fmaxf(x[o] + acc[r][c], 0.f), clip) : 0.f;
        }
        out[o] = v;
        __stcg(dst + (size_t)b * h_pad + j, v);
      }
    }
    __syncthreads();
    if (tid == 0) {
      arrive(count);
      wait_count(count, nblk * (unsigned int)(s + 1));
    }
    __syncthreads();
  }
}

// Shared memory a block of each kernel takes.
size_t smem_bf16(int n_h) {
  return (size_t)kWarps * kRingBytes +
         (size_t)kCols * (round_up(n_h, kPad) + 8) * sizeof(bf16);
}
size_t smem_f32(int n_h) {
  return ((size_t)n_h * kCols + (size_t)kMaxB * (kKc + 1)) * sizeof(float);
}

// A cooperative launch of `grid` blocks, checked first against what the
// card holds at once.
int launch_coop(const void* kern, int grid, size_t smem, void** args,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * n_sm < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kBwd>
int dispatch(const void* x, const void* w, const int* lengths, const void* hs,
             const void* h0, void* out, void* xbuf, unsigned int* count,
             int n_t, int n_b, int n_h, int reverse, float clip, int bf16_io,
             void* stream) {
  if (n_b < 1 || n_b > kMaxB || n_h < 1 || n_t < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (n_h + kCols - 1) / kCols;
  if (h0 != nullptr) {  // h0's rows into the zeroed first half, in order
    const size_t elem = bf16_io ? sizeof(bf16) : sizeof(float);
    const cudaError_t err = cudaMemcpy2DAsync(
        xbuf, round_up(n_h, kPad) * elem, h0, n_h * elem, n_h * elem, n_b,
        cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (bf16_io) {
    const bf16* xp = static_cast<const bf16*>(x);
    const bf16* wp = static_cast<const bf16*>(w);
    const bf16* hp = static_cast<const bf16*>(hs);
    bf16* op = static_cast<bf16*>(out);
    bf16* bp = static_cast<bf16*>(xbuf);
    const uintptr_t addr = (uintptr_t)xp | (uintptr_t)hp | (uintptr_t)op;
    bool vec = n_h % 8 == 0 && addr % 16 == 0;
    void* args[] = {(void*)&xp, (void*)&wp, (void*)&lengths, (void*)&hp,
                    (void*)&op, (void*)&bp, (void*)&count, (void*)&n_t,
                    (void*)&n_b, (void*)&n_h, (void*)&reverse, (void*)&clip,
                    (void*)&vec};
    return launch_coop((const void*)mma_sweep_kernel<kBwd>, grid,
                       smem_bf16(n_h), args, st);
  }
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* hp = static_cast<const float*>(hs);
  float* op = static_cast<float*>(out);
  float* bp = static_cast<float*>(xbuf);
  void* args[] = {(void*)&xp, (void*)&wp, (void*)&lengths, (void*)&hp,
                  (void*)&op, (void*)&bp, (void*)&count, (void*)&n_t,
                  (void*)&n_b, (void*)&n_h, (void*)&reverse, (void*)&clip};
  return launch_coop((const void*)f32_sweep_kernel<kBwd>, grid, smem_f32(n_h),
                     args, st);
}

}  // namespace

extern "C" {

// B1.  z, hs [T, B, H] and w [H, H] in the io type; lengths [B] int32;
// h0 [B, H] io type, the initial carry, or null for a zero carry; xbuf
// [2, B_pad, H_pad] io type (B and H rounded up to multiples of 16), zeroed
// (the zero carry and the padding; h0, when given, is copied into its first
// half on the stream before the launch); count one zeroed uint32.
// Returns 0 or a CUDA error code.
int birnn_fwd_launch(const void* z, const void* w, const int* lengths,
                     const void* h0, void* hs, void* xbuf, unsigned int* count,
                     int n_t, int n_b, int n_h, int reverse, float clip,
                     int bf16, void* stream) {
  return dispatch<false>(z, w, lengths, nullptr, h0, hs, xbuf, count, n_t, n_b,
                         n_h, reverse, clip, bf16, stream);
}

// B2.  g, hs, d_out [T, B, H] and wt = W^T [H, H] in the io type; the rest
// as for B1.  The argument order follows birnn_fwd_launch: the swept input,
// the weights, the third input (hs here, lengths there), the output.
int birnn_bwd_launch(const void* g, const void* wt, const void* hs, void* d_out,
                     void* xbuf, unsigned int* count, int n_t, int n_b, int n_h,
                     int reverse, float clip, int bf16, void* stream) {
  return dispatch<true>(g, wt, nullptr, hs, nullptr, d_out, xbuf, count, n_t,
                        n_b, n_h, reverse, clip, bf16, stream);
}

}  // extern "C"
