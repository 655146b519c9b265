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
//   it) through a private ring of 4 KB stages (4; 3 at 32 columns a
//   block, below), waiting with cp.async.wait_group and __syncwarp: no
//   block barrier in the k loop.
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
// Both directions of a layer in one launch (bf16, narrow, dirs = 2).  One
// direction at 16 columns a block is G = H_pad / 16 blocks, one a SM: at
// preset 2's H = 1024, 64 of an H100's 132 SMs idle for the whole of both
// sweeps, and at presets 3 and 4's H = 1824 two such grids do not fit at
// once.  So where B <= 64 one cooperative launch of 2 ceil(H_pad / 32)
// blocks of 32 columns sweeps both (H <= 2080 on 132 SMs): blocks [0, G)
// direction 0, [G, 2 G) direction 1, each with its own W, third input,
// output, time order, exchange buffer and counter (kCountStride apart), and
// a step's barrier counts that direction's arrivals alone, so neither
// direction waits for the other.  Two cooperative grids on two streams are
// not guaranteed to be co-resident, so one launch holds both.  A block keeps
// 32 columns of W and streams the whole previous state through the same
// rings: each block reads the bytes it reads at 16 columns, the card reads
// the state once for both directions, and a block's mma work a step
// doubles.  Each warp keeps the same k-range (kt0, kt1) and mma order per
// column, and the partials are summed in warp order, so each direction is
// bit-equal to its one-direction launch.  A warp's accumulators stay at 64
// floats, [4 m-tiles][4 n-tiles], so B <= 64; W's 32 columns (117 KB at H =
// 1824) leave room for rings of 3 stages, and a warp's [64, 32] f32 partial
// (8 KB) fits its 12 KB ring.  Where H_pad is an odd number of 16-column
// tiles, the last block of a direction holds 16 live columns and stores
// none past H_pad.  The direction count and the columns are template
// arguments (mma_sweep_kernel<kBwd, kDirs, kN>): with a runtime count the
// one-direction kernel kept its operands in registers and ran 7-13% slower
// a step.  On an H100 SXM (700 W) a fused step at H = 1824 takes 0.95-0.97x
// one direction's 16-column step at B = 64 and 0.92-0.93x at B = 16: every
// block still reads the whole state, but the first stage lands and the k
// loop ends sooner (torch_tools/birnn_step_breakdown.py); at H = 1024, B =
// 32 the fused B1 + B2 take 0.94x what two grids of 16 columns in one
// launch took.  Why is not measured: the readers split over two state
// buffers, and all 8 warps share the epilogue.
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
constexpr int kStageBytes = 4096;   // a stage of a warp's cp.async ring
constexpr int kKc = 64;             // f32: k-chunk of the staged carry
constexpr int kCountStride = 32;    // a fused launch's counters, 128 B apart

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The bf16 narrow instance by its columns of W a block (kN, 16 or 32):
// stages of a warp's ring, its bytes, and the batch rows a launch takes
// (a warp's accumulators are 64 floats: [8][2][4] at 16, [4][4][4] at 32).
__host__ __device__ constexpr int ring_stages(int cols) {
  return cols == 16 ? 4 : 3;
}
__host__ __device__ constexpr int ring_bytes(int cols) {
  return ring_stages(cols) * kStageBytes;
}
__host__ __device__ constexpr int max_rows(int cols) {
  return cols == 16 ? kMaxB : 64;
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

// kDirs directions (1 or 2), gridDim.x / kDirs blocks each, kN (16 or
// 32) columns of W a block.  x: z (B1) or g (B2), shared by the
// directions; w0, w1: W (B1) or W^T (B2), [H, H], of direction 0 and 1;
// lengths: B1 only; hs0, hs1: the stored forward states, B2 only; out0,
// out1: h (B1) or d (B2); xbuf: a zeroed [2, B_pad, H_pad] exchange buffer
// a direction, one after the other; count: a zeroed counter a direction,
// kCountStride apart; reverse: direction 0's time order (direction 1
// sweeps the other way).  `vec`: H % 8 == 0 and x, hs0, hs1, out0, out1
// 16-byte aligned, so their rows of 8 are single accesses.
template <bool kBwd, int kDirs, int kN>
__global__ void __launch_bounds__(kThreads, 1)
mma_sweep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                 const bf16* __restrict__ w1, const int* __restrict__ lengths,
                 const bf16* __restrict__ hs0, const bf16* __restrict__ hs1,
                 bf16* __restrict__ out0, bf16* __restrict__ out1,
                 bf16* xbuf0, unsigned int* count0, int n_t, int n_b,
                 int n_h, int reverse0, float clip, bool vec) {
  constexpr int kStages = ring_stages(kN), kRing = ring_bytes(kN);
  constexpr int kMt = max_rows(kN) / 16;  // m-tiles a warp accumulates
  constexpr int kNt = kN / 8;             // n-tiles of mma, 8 columns each
  extern __shared__ __align__(128) unsigned char smem[];
  const int h_pad = round_up(n_h, kPad), b_pad = round_up(n_b, kPad);
  const int n_mt = b_pad / 16;          // m-tiles of the batch
  const int w_ld = h_pad + 8;           // a row of w_s, padded by 16 bytes
  bf16* w_s = reinterpret_cast<bf16*>(smem + kWarps * kRing);  // [kN][w_ld]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_blk = gridDim.x / kDirs;  // blocks of a direction
  const int blk = blockIdx.x;
  const bool second = kDirs == 2 && blk >= n_blk;
  const bf16* w = second ? w1 : w0;
  const bf16* hs = second ? hs1 : hs0;
  bf16* out = second ? out1 : out0;
  bf16* xbuf = second ? xbuf0 + (size_t)2 * b_pad * h_pad : xbuf0;
  unsigned int* count = second ? count0 + kCountStride : count0;
  const int reverse = second ? !reverse0 : reverse0;
  const int j0 = (second ? blk - n_blk : blk) * kN;

  // W's kN columns, once: w_s[n][k] = w[k][j0 + n], zero past H
  for (int i = tid; i < h_pad * kN; i += kThreads) {
    const int k = i / kN, n = i % kN;
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
  unsigned char* ring = smem + warp * kRing;
  const uint32_t ring_sa = smem_u32(ring);
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_off =
      a_row * 32 + (((lane >> 4) ^ ((a_row >> 2) & 1)) * 16);
  const uint32_t w_sa =
      smem_u32(w_s) +
      ((((lane >> 4) & 1) * 8 + (lane & 7)) * w_ld + ((lane >> 3) & 1) * 8) * 2;

  // The epilogue: thread tid < (kN / 8) b_pad owns row eb, columns
  // j0 + c0 .. + 7.  Those threads fill warps 0 .. n_mt kN / 16 - 1, which
  // arrive at the barrier.
  const bool epi = tid < kNt * b_pad;
  const int eb = tid >> (kNt / 2), c0 = (tid & (kNt - 1)) * 8;
  const bool row_live = epi && eb < n_b;
  const int n_val = min(max(n_h - (j0 + c0), 0), 8);
  // a block's columns past H_pad (the last block at 32) hold no state
  const bool col_in = kN == 16 || j0 + c0 < h_pad;
  const int len_b = (!kBwd && row_live) ? lengths[eb] : 0;
  const unsigned int per_step =  // a direction's arrivals a step
      n_blk * (unsigned int)n_mt * (kN / 16);
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

    float acc[kMt][kNt][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
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
        uint32_t b[kN / 16][4];  // 16 columns of W a load: two n-tiles
#pragma unroll
        for (int q = 0; q < kN / 16; ++q)
          ldmatrix_x4(b[q], w_sa + q * 16 * w_ld * 2 + (k_first + kk) * 32);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          if (mt < n_mt) {
            uint32_t a[4];
            ldmatrix_x4(a, slot + kk * tile_bytes + mt * 512);
#pragma unroll
            for (int q = 0; q < kN / 16; ++q) {
              mma_bf16(acc[mt][2 * q], a, b[q][0], b[q][1]);
              mma_bf16(acc[mt][2 * q + 1], a, b[q][2], b[q][3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();  // every lane is done with the ring

    // this warp's partial, [b_pad][kN] f32, into its own ring
    float* part = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      if (mt < n_mt) {
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int r = mt * 16 + (lane >> 2), c = nt * 8 + (lane & 3) * 2;
          *reinterpret_cast<float2*>(part + r * kN + c) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<float2*>(part + (r + 8) * kN + c) =
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
            smem + wi * kRing + (eb * kN + c0) * 4);
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
      if (eb < n_b && col_in)  // rows past B stay zero
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

// ---- the wide instances: H above 16 columns a resident block -------------
//
// At H > 16 n_SM (2112 on an H100 SXM) the narrow instances need more
// blocks than the card holds at once, and from H ~ 6700 (bf16) a block's
// 16 columns of W alone outgrow its shared memory.  All of W cannot stay on
// chip either: at H = 4096 it is 32 MiB in bf16, over the 30.7 MB of all
// SMs' shared memory together, and 64 MiB in f32, over the 50 MB L2.  The
// wide instances compute exactly what the narrow ones compute, in the same
// order, on a grid of at most n_SM co-resident blocks: the H_pad / 16
// column tiles are dealt round-robin (block j owns tiles j, j + grid, ...,
// at most kMaxOwn), W arrives from a copy laid out by column tiles, [H_pad
// / 16][H_pad][16] zero-padded (a tile's rows are contiguous, so a block's
// streamed k-range of a tile is one run of memory, not rows of 32 or 64
// bytes 2 H_pad or 4 H_pad bytes apart), and a block arrives at the grid
// barrier once a step, after it has stored all of its tiles (the exchange
// buffer and the barrier are the narrow instances').
//
// What bounds a step at preset 5's rank shape (H = 4096, B = 16: 2 tiles a
// block): every block reads the whole previous state (128 KiB bf16, 256
// KiB f32) from L2, and W's block share (256 KiB bf16, 512 KiB f32) is
// more than its shared memory, so part of it is read again every step (from
// L2 in bf16; in f32, W is larger than L2).  The design spends shared memory
// on W and reads the state once a step for all of a block's tiles:
// - bf16 (mma_wide_kernel): each warp owns the narrow instance's k-range
//   and sweeps it once a step with the k-tile as the outer loop and the
//   block's tiles inside it, an mma accumulator for each (tile, m-tile) of
//   a pass (kSlots of them; at large B the m-tiles go in passes).  A ring
//   stage is one k-tile: the state's [16 rows x 16 k] pieces and, for the
//   first k-tiles of the range, W's pieces of every owned tile; the last
//   k-tiles' pieces stay in shared memory for the whole sweep.  W's streamed
//   pieces of the first stages do not depend on the state, so they are
//   issued before the grid barrier's wait.  The epilogue sums the 8 warps'
//   partials in warp order over all 256 threads, two outputs each.
// - f32 (f32_wide_kernel): a thread owns 4 columns of a 32-column group
//   and kR rows (2 at B = 16: 2 of the 8 warps compute), each output one
//   sequential k-sum in straight-line code unrolled over 16 k; W's chunks
//   are staged [64 k][own x 16 columns] so that a warp reads 8 columns'
//   float4 and 4 rows' state float4 a k-quad without bank conflicts.  The
//   block's ring has kF32Depth stages of a 64-k chunk of the state and, for
//   the first chunks, of W; the last chunks stay in shared memory; W's
//   first streamed chunks are issued before the barrier's wait.
// - each output is summed as in the narrow instance (bf16: every warp's
//   k-range in mma order, the partials in warp order; f32: one sequential
//   k-sum), so a wide launch is bit-equal to a narrow one on the same
//   inputs, and two wide launches are too.
// Not done: TMA.  The state's multicast over a cluster of 2 blocks (one
// cp.async.bulk a k-tile stage for both, an empty mbarrier per slot that
// both blocks' warps arrive at) halved the state's L2 reads but measured
// more than twice as slow at H = 4096, B = 16: a cross-block handshake for
// every 512-byte stage costs more than it saves.

constexpr int kMaxOwn = 4;              // column tiles a wide block owns
constexpr int kPieceBytes = 16 * 16 * 2;    // a bf16 piece: 16 x 16
constexpr int kWideStages = 4;          // bf16: stages of a warp's ring
constexpr int kSlots = 8;               // bf16: accumulator tiles a warp
constexpr int kSlotPart = 16 * 16 * 4;  // bf16: a slot's f32 partial
constexpr int kUnits = kSlots * 128 / kThreads;  // bf16: epilogue pairs a thread
constexpr int kF32Depth = 4;            // f32: stages of the block's ring
constexpr int kCs = kKc + 4;            // f32: a staged state row, floats

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ int tiles_owned(int n_tiles) {
  return (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
}

// The bf16 wide block's layout, the same on the host (wide_plan) and the
// card: m-tiles a pass (mg), a ring stage's bytes (mg state pieces and
// own pieces of W), a warp's region (its ring, and its partials after the
// k loop).
struct WideLayout {
  int mg, stage, region;
};

__host__ __device__ __forceinline__ WideLayout wide_layout(int n_mt, int own) {
  WideLayout l;
  l.mg = n_mt < kSlots / own ? n_mt : kSlots / own;
  l.stage = (l.mg + own) * kPieceBytes;
  const int part = l.mg * own * kSlotPart;
  l.region = kWideStages * l.stage > part ? kWideStages * l.stage : part;
  return l;
}

// One 512-byte piece of W (rows 16 kt .. + 15 of column tile jt of the
// tiled [h_pad / 16][h_pad][16] copy) into shared memory at dst, a row of
// 32 bytes, its two 16-byte chunks swizzled by bit 2 of the row: one
// chunk a lane.
__device__ __forceinline__ void copy_piece(uint32_t dst, const bf16* w,
                                           int h_pad, int kt, int jt,
                                           int lane) {
  const int r = lane >> 1, c = lane & 1;
  cp_async16(dst + r * 32 + ((c ^ ((r >> 2) & 1)) * 16),
             w + ((size_t)jt * h_pad + kt * 16 + r) * kCols + c * 8);
}

// Two bf16 values packed in 32 bits (the first in the low half), as f32.
__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bits(bf16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}

// Two bf16 values at p (n of them, zeros after), one 4-byte access if vec.
__device__ __forceinline__ uint32_t load2(const bf16* p, int n, bool vec) {
  if (vec && n == 2) return __ldg(reinterpret_cast<const unsigned int*>(p));
  return (n > 0 ? bits(p[0]) : 0u) | (n > 1 ? bits(p[1]) << 16 : 0u);
}

// ck: k-tiles at the end of each warp's range whose W pieces (of every
// owned tile) stay in shared memory for the whole sweep.
template <bool kBwd>
__global__ void __launch_bounds__(kThreads, 1)
mma_wide_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const int* __restrict__ lengths, const bf16* __restrict__ hs,
                bf16* __restrict__ out, bf16* xbuf, unsigned int* count,
                int n_t, int n_b, int n_h, int reverse, float clip, bool vec,
                int ck) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h_pad = round_up(n_h, kPad), b_pad = round_up(n_b, kPad);
  const int n_mt = b_pad / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = h_pad / kCols, n_own = tiles_owned(n_tiles);
  const int own_max = ceil_div(n_tiles, (int)gridDim.x);
  const WideLayout L = wide_layout(n_mt, own_max);
  const int n_pass = ceil_div(n_mt, L.mg);
  const int n_kt = h_pad / 16;
  const int kt0 = warp * n_kt / kWarps, kt1 = (warp + 1) * n_kt / kWarps;
  const int nk = kt1 - kt0;
  const int ns = nk > ck ? nk - ck : 0;   // streamed: the first ns k-tiles
  const uint32_t ring_sa = smem_u32(smem + warp * L.region);
  const uint32_t cache_sa = smem_u32(smem + kWarps * L.region) +
                            warp * ck * own_max * kPieceBytes;

  // the resident pieces, once: k-tile kt0 + ns + c of tile i at c own_max + i
  for (int c = 0; c < nk - ns; ++c)
    for (int i = 0; i < n_own; ++i)
      copy_piece(cache_sa + (c * own_max + i) * kPieceBytes, w, h_pad,
                 kt0 + ns + c, blockIdx.x + i * gridDim.x, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_off =
      a_row * 32 + (((lane >> 4) ^ ((a_row >> 2) & 1)) * 16);
  const int b_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const uint32_t b_off =
      b_row * 32 + ((((lane >> 4) & 1) ^ ((b_row >> 2) & 1)) * 16);

  // Epilogue unit u (thread tid owns u = tid + 256 e): slot u >> 7 (m-tile
  // slot / n_own of the pass, tile slot % n_own), row (u >> 3) & 15,
  // columns 2 (u & 7) and 2 (u & 7) + 1 of the tile.
  uint32_t xv[kUnits], hv[kUnits];   // the units' inputs of the next pass
  auto unit_at = [&](int u, int m0, int& row, int& j) {
    const int q = u >> 7, m = q / n_own, i = q - m * n_own;
    row = (m0 + m) * 16 + ((u >> 3) & 15);
    j = (blockIdx.x + i * gridDim.x) * kCols + 2 * (u & 7);
  };
  auto load_units = [&](int t, int pass) {
    const int m0 = pass * L.mg, n_u = min(L.mg, n_mt - m0) * n_own * 128;
#pragma unroll
    for (int e = 0; e < kUnits; ++e) {
      xv[e] = hv[e] = 0u;
      const int u = tid + kThreads * e;
      if (u < n_u) {
        int row, j;
        unit_at(u, m0, row, j);
        if (row < n_b) {
          const int n_val = min(max(n_h - j, 0), 2);
          const size_t o = ((size_t)t * n_b + row) * n_h + j;
          xv[e] = load2(x + o, n_val, vec);
          if (kBwd) hv[e] = load2(hs + o, n_val, vec);
        }
      }
    }
  };
  load_units(reverse ? n_t - 1 : 0, 0);

  for (int s = 0; s < n_t; ++s) {
    const int t = reverse ? n_t - 1 - s : s;
    const bf16* src = xbuf + (size_t)(s & 1) * b_pad * h_pad;
    bf16* dst = xbuf + (size_t)((s + 1) & 1) * b_pad * h_pad;
    for (int pass = 0; pass < n_pass; ++pass) {
      const int m0 = pass * L.mg, mgp = min(L.mg, n_mt - m0);
      const int slots = mgp * n_own;
      int a_of[kSlots], w_of[kSlots];   // each slot's m-tile and tile offsets
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int m = q / n_own;
        a_of[q] = m * kPieceBytes;
        w_of[q] = q - m * n_own;
      }
      // stage st: k-tile kt0 + st, its state pieces, and W's unless resident
      auto stage_w = [&](int st) {
        const uint32_t slot = ring_sa + (st % kWideStages) * L.stage;
        if (st < ns)
          for (int i = 0; i < n_own; ++i)
            copy_piece(slot + (L.mg + i) * kPieceBytes, w, h_pad, kt0 + st,
                       blockIdx.x + i * gridDim.x, lane);
      };
      auto stage_x = [&](int st) {
        const uint32_t slot = ring_sa + (st % kWideStages) * L.stage;
        for (int e = lane; e < mgp * 32; e += 32) {
          const int r = e >> 1, c = e & 1;
          cp_async16(slot + r * 32 + ((c ^ ((r >> 2) & 1)) * 16),
                     src + (size_t)(m0 * 16 + r) * h_pad + (kt0 + st) * 16 +
                         c * 8);
        }
      };
      // W's first stages do not depend on the state: before the wait
      for (int st = 0; st < kWideStages - 1 && st < nk; ++st) stage_w(st);
      if (pass == 0 && s > 0) {  // the grid's values of step s - 1 are in src
        if (lane == 0) wait_count(count, gridDim.x * (unsigned int)s);
        __syncwarp();
      }
#pragma unroll
      for (int st = 0; st < kWideStages - 1; ++st) {
        if (st < nk) stage_x(st);
        cp_async_commit();
      }

      float acc[kSlots][2][4];
#pragma unroll
      for (int q = 0; q < kSlots; ++q)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][nt][e] = 0.f;

      for (int st = 0; st < nk; ++st) {
        cp_async_wait<kWideStages - 2>();
        __syncwarp();  // stage st is in for every lane; slot st - 1 is free
        if (st + kWideStages - 1 < nk) {
          stage_w(st + kWideStages - 1);
          stage_x(st + kWideStages - 1);
        }
        cp_async_commit();
        const uint32_t slot = ring_sa + (st % kWideStages) * L.stage;
        const uint32_t wbase =
            st < ns ? slot + L.mg * kPieceBytes
                    : cache_sa + (st - ns) * own_max * kPieceBytes;
        uint32_t a[4];
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          if (q < slots) {
            if (w_of[q] == 0) ldmatrix_x4(a, slot + a_off + a_of[q]);
            uint32_t b[4];
            ldmatrix_x4_trans(b, wbase + w_of[q] * kPieceBytes + b_off);
            mma_bf16(acc[q][0], a, b[0], b[1]);
            mma_bf16(acc[q][1], a, b[2], b[3]);
          }
        }
      }
      cp_async_wait<0>();
      __syncwarp();  // the ring is free for this warp's partials

      float* part = reinterpret_cast<float*>(smem + warp * L.region);
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (q < slots) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int r = lane >> 2, c = nt * 8 + (lane & 3) * 2;
            *reinterpret_cast<float2*>(part + q * 256 + r * 16 + c) =
                make_float2(acc[q][nt][0], acc[q][nt][1]);
            *reinterpret_cast<float2*>(part + q * 256 + (r + 8) * 16 + c) =
                make_float2(acc[q][nt][2], acc[q][nt][3]);
          }
        }
      }
      __syncthreads();  // every warp's partials of the pass are in

      uint32_t ov[kUnits];
#pragma unroll
      for (int e = 0; e < kUnits; ++e) {
        ov[e] = 0u;
        const int u = tid + kThreads * e;
        if (u >= slots * 128) continue;
        int row, j;
        unit_at(u, m0, row, j);
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) {  // warp order, as narrow
          const float2 p = *reinterpret_cast<const float2*>(
              smem + wi * L.region + (u >> 7) * kSlotPart +
              (((u >> 3) & 15) * 16 + 2 * (u & 7)) * 4);
          v0 += p.x;
          v1 += p.y;
        }
        if (row >= n_b) continue;             // rows past B stay zero
        const int n_val = min(max(n_h - j, 0), 2);
        const bool live = kBwd || t < __ldg(lengths + row);
        float r0 = 0.f, r1 = 0.f;
        if (kBwd) {
          const float h0v = lo_f(hv[e]), h1v = hi_f(hv[e]);
          if (n_val > 0 && h0v > 0.f && h0v < clip) r0 = lo_f(xv[e]) + v0;
          if (n_val > 1 && h1v > 0.f && h1v < clip) r1 = hi_f(xv[e]) + v1;
        } else if (live) {
          if (n_val > 0) r0 = fminf(fmaxf(lo_f(xv[e]) + v0, 0.f), clip);
          if (n_val > 1) r1 = fminf(fmaxf(hi_f(xv[e]) + v1, 0.f), clip);
        }
        // round to nearest even, as XLA
        ov[e] = bits(__float2bfloat16(r0)) | bits(__float2bfloat16(r1)) << 16;
        __stcg(reinterpret_cast<unsigned int*>(dst + (size_t)row * h_pad + j),
               ov[e]);
      }
      __syncthreads();  // the stores are in; the partials are read
      if (pass == n_pass - 1 && tid == 0) arrive(count);
      // off the critical path: the HBM stores and the next pass's inputs
#pragma unroll
      for (int e = 0; e < kUnits; ++e) {
        const int u = tid + kThreads * e;
        if (u >= slots * 128) continue;
        int row, j;
        unit_at(u, m0, row, j);
        if (row >= n_b) continue;
        const int n_val = min(max(n_h - j, 0), 2);
        bf16* po = out + ((size_t)t * n_b + row) * n_h + j;
        if (vec && n_val == 2) {
          *reinterpret_cast<unsigned int*>(po) = ov[e];
        } else {
          if (n_val > 0) po[0] = __ushort_as_bfloat16((unsigned short)ov[e]);
          if (n_val > 1)
            po[1] = __ushort_as_bfloat16((unsigned short)(ov[e] >> 16));
        }
      }
      if (pass + 1 < n_pass)
        load_units(t, pass + 1);
      else if (s + 1 < n_t)
        load_units(reverse ? t - 1 : t + 1, 0);
    }
  }
}

// The f32 wide sweep; cap: 64-k chunks of W (all owned tiles' columns) at
// the end of the k range that stay in shared memory for the whole sweep.
// vec: H % 4 == 0 and x, hs, out 16-byte aligned.  A thread owns kR
// (group, row) pairs of one 32-column group: rows rl kR .. rl kR + kR - 1
// (rl = tid / 8), columns 4 (tid % 8) .. + 3; kR is a template argument so
// that the k loop is straight-line code, unrolled so that the shared loads
// of the next k-quads are in flight while the FMAs of this one run.
template <bool kBwd, int kR>
__global__ void __launch_bounds__(kThreads, 1)
f32_wide_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const int* __restrict__ lengths, const float* __restrict__ hs,
                float* __restrict__ out, float* xbuf, unsigned int* count,
                int n_t, int n_b, int n_h, int reverse, float clip, bool vec,
                int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h_pad = round_up(n_h, kPad), b_pad = round_up(n_b, kPad);
  const int n_tiles = h_pad / kCols, n_own = tiles_owned(n_tiles);
  const int own_max = ceil_div(n_tiles, (int)gridDim.x);
  const int n_cols = own_max * kCols;      // a staged W chunk's row, floats
  const int stage_floats = b_pad * kCs + kKc * n_cols;
  float* stages = reinterpret_cast<float*>(smem_raw);
  float* cache = stages + (size_t)kF32Depth * stage_floats;  // [cap][64][n_cols]
  const int n_kc = ceil_div(h_pad, kKc);
  const int n_sc = n_kc > cap ? n_kc - cap : 0;   // streamed: the first n_sc

  const int tid = threadIdx.x;
  const unsigned int nblk = gridDim.x;
  const int quad = tid & 7, rl = tid >> 3;
  const int n_groups = ceil_div(n_own * kCols, 32);
  // this thread's pairs rl kR .. + kR - 1 share their group (kR | b_pad)
  const int p0 = rl * kR, g = p0 / b_pad, b0 = p0 - g * b_pad;
  const int col = g * 32 + quad * 4;       // in a staged W chunk's row
  const bool busy = g < n_groups && b0 < n_b && col < n_own * kCols;
  const int j = (blockIdx.x + (col >> 4) * nblk) * kCols + (col & 15);

  // W's rows k0 .. k0 + 63 (those below h_pad) of every owned tile, from
  // the tiled copy: 4 KB of each tile in one run
  auto w_chunk_in = [&](float* dst_s, int k0) {
    const int rows = min(kKc, h_pad - k0), per = rows * 4;
    for (int e = tid; e < n_own * per; e += kThreads) {
      const int i = e / per, r = e - i * per, k = r >> 2, q = r & 3;
      cp_async16(smem_u32(dst_s + k * n_cols + i * kCols + q * 4),
                 w + ((size_t)(blockIdx.x + i * nblk) * h_pad + k0 + k) *
                         kCols + q * 4);
    }
  };
  for (int c = n_sc; c < n_kc; ++c)
    w_chunk_in(cache + (size_t)(c - n_sc) * kKc * n_cols, c * kKc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float4 xv[kR], hv[kR];    // each row's inputs of the next step
  auto load4 = [&](const float* base, int row, int t) {
    const size_t o = ((size_t)t * n_b + row) * n_h + j;
    if (vec && j + 4 <= n_h)
      return __ldg(reinterpret_cast<const float4*>(base + o));
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = j + c < n_h ? base[o + c] : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  };
  auto load_rows = [&](int t) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (!busy || b0 + r >= n_b) continue;
      xv[r] = load4(x, b0 + r, t);
      if (kBwd) hv[r] = load4(hs, b0 + r, t);
    }
  };
  load_rows(reverse ? n_t - 1 : 0);

  for (int s = 0; s < n_t; ++s) {
    const int t = reverse ? n_t - 1 - s : s;
    const float* src = xbuf + (size_t)(s & 1) * b_pad * h_pad;
    float* dst = xbuf + (size_t)((s + 1) & 1) * b_pad * h_pad;
    // chunk kc: the state's [b_pad][64] and, unless resident, W's [64][cols]
    auto stage_w = [&](int kc) {
      if (kc < n_sc)
        w_chunk_in(stages + (size_t)(kc % kF32Depth) * stage_floats +
                       b_pad * kCs, kc * kKc);
    };
    auto stage_x = [&](int kc) {
      float* st = stages + (size_t)(kc % kF32Depth) * stage_floats;
      const int k0 = kc * kKc, q_n = min(kKc, h_pad - k0) / 4;
      for (int e = tid; e < n_b * q_n; e += kThreads) {
        const int b = e / q_n, q = e - b * q_n;
        cp_async16(smem_u32(st + b * kCs + q * 4),
                   src + (size_t)b * h_pad + k0 + q * 4);
      }
    };
    // W's first chunks do not depend on the state: before the wait
    for (int kc = 0; kc < kF32Depth - 1 && kc < n_kc; ++kc) stage_w(kc);
    if (s > 0) {  // the grid's values of step s - 1 are in src
      if (tid == 0) wait_count(count, nblk * (unsigned int)s);
      __syncthreads();
    }
    for (int kc = 0; kc < kF32Depth - 1; ++kc) {
      if (kc < n_kc) stage_x(kc);
      cp_async_commit();
    }
    float acc[kR][4];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int kc = 0; kc < n_kc; ++kc) {
      cp_async_wait<kF32Depth - 2>();
      __syncthreads();  // chunk kc is in; stage (kc - 1) % depth is free
      if (kc + kF32Depth - 1 < n_kc) {
        stage_w(kc + kF32Depth - 1);
        stage_x(kc + kF32Depth - 1);
      }
      cp_async_commit();
      if (!busy) continue;
      const float* st = stages + (size_t)(kc % kF32Depth) * stage_floats;
      const float* wc = (kc < n_sc ? st + b_pad * kCs
                                   : cache + (size_t)(kc - n_sc) * kKc * n_cols)
                        + col;
      const float* cs = st + b0 * kCs;
      const int kc_n = min(kKc, h_pad - kc * kKc);   // a multiple of 16
#pragma unroll 4
      for (int k = 0; k < kc_n; k += 4) {
        float4 w4[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          w4[kk] = *reinterpret_cast<const float4*>(wc + (k + kk) * n_cols);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float4 cv = *reinterpret_cast<const float4*>(cs + r * kCs + k);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {  // k ascending, as narrow
            acc[r][0] += c4[kk] * w4[kk].x;
            acc[r][1] += c4[kk] * w4[kk].y;
            acc[r][2] += c4[kk] * w4[kk].z;
            acc[r][3] += c4[kk] * w4[kk].w;
          }
        }
      }
    }
    cp_async_wait<0>();

    float4 ov[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int b = b0 + r;
      if (!busy || b >= n_b) continue;
      const bool live = kBwd || t < __ldg(lengths + b);
      const float xs[4] = {xv[r].x, xv[r].y, xv[r].z, xv[r].w};
      const float hh[4] = {hv[r].x, hv[r].y, hv[r].z, hv[r].w};
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j + c >= n_h) {
          v[c] = 0.f;
        } else if (kBwd) {
          v[c] = (hh[c] > 0.f && hh[c] < clip) ? xs[c] + acc[r][c] : 0.f;
        } else {
          v[c] = live ? fminf(fmaxf(xs[c] + acc[r][c], 0.f), clip) : 0.f;
        }
      }
      ov[r] = make_float4(v[0], v[1], v[2], v[3]);
      __stcg(reinterpret_cast<float4*>(dst + (size_t)b * h_pad + j), ov[r]);
    }
    __syncthreads();  // the block's stores are in; the stages are free
    if (tid == 0) arrive(count);
    // off the critical path: the HBM stores and the next frame's inputs
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int b = b0 + r;
      if (!busy || b >= n_b) continue;
      float* po = out + ((size_t)t * n_b + b) * n_h + j;
      if (vec && j + 4 <= n_h) {
        *reinterpret_cast<float4*>(po) = ov[r];
      } else {
        const float o4[4] = {ov[r].x, ov[r].y, ov[r].z, ov[r].w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j + c < n_h) po[c] = o4[c];
      }
    }
    if (s + 1 < n_t) load_rows(reverse ? t - 1 : t + 1);
  }
}

// Rows a thread of the f32 wide kernel owns: the fewest that cover the
// (group, row) pairs with 32 row lanes, times kF32Reuse (2: fewer shared
// loads of W per FMA; faster than 1 and 4 at H = 4096, B = 16).
constexpr int kF32Reuse = 2;
int f32_wide_rows(int n_b, int own) {
  const int pairs = ceil_div(own * kCols, 32) * round_up(n_b, kPad);
  const int r = ceil_div(pairs, 32) * kF32Reuse;
  return r <= 1 ? 1 : r <= 2 ? 2 : r <= 4 ? 4 : 8;
}

// Shared memory a block of each kernel takes (bf16: kN columns of W).
size_t smem_bf16(int n_h, int cols) {
  return (size_t)kWarps * ring_bytes(cols) +
         (size_t)cols * (round_up(n_h, kPad) + 8) * sizeof(bf16);
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

// The wide instances' plan at `own` column tiles a block (at most): plan[0]
// the grid, plan[1] own, plan[2] the pieces of W kept in shared memory
// (bf16: 16 x 16 pieces a warp, ck k-tiles of every owned tile; f32: 64-k
// chunks of all owned tiles' columns a block), plan[3] the block's shared
// memory in bytes.  Returns 0, or cudaErrorInvalidValue when the width does
// not fit.
int wide_plan(int n_b, int n_h, int bf16_io, int own, int* plan) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int h_pad = round_up(n_h, kPad), b_pad = round_up(n_b, kPad);
  const int n_tiles = h_pad / kCols;
  long fixed, unit, want;   // unit: shared memory of one cached k-range step
  int pieces;               // pieces of W a unit holds
  if (bf16_io) {
    fixed = (long)kWarps * wide_layout(b_pad / 16, own).region;
    unit = (long)kWarps * own * kPieceBytes;   // one k-tile of every warp
    pieces = own;
    want = ceil_div(h_pad / 16, kWarps);
  } else {
    const int n_cols = own * kCols;
    fixed = (long)kF32Depth * (b_pad * kCs + kKc * n_cols) * sizeof(float);
    unit = (long)kKc * n_cols * sizeof(float);
    pieces = 1;
    want = ceil_div(h_pad, kKc);
  }
  if (fixed > optin) return (int)cudaErrorInvalidValue;
  const long fit = (optin - fixed) / unit, cap = want < fit ? want : fit;
  plan[0] = ceil_div(n_tiles, own);
  plan[1] = own;
  plan[2] = (int)cap * pieces;
  plan[3] = (int)(fixed + cap * unit);
  return 0;
}

// The bf16 narrow sweep of kDirs directions (w1, hs1, out1 are read only
// where kDirs is 2): one cooperative launch of kDirs ceil(H_pad / kN)
// blocks.
template <bool kBwd, int kDirs, int kN>
int launch_sweeps(const void* x, const void* w0, const void* w1,
                  const int* lengths, const void* hs0, const void* hs1,
                  void* out0, void* out1, void* xbuf, unsigned int* count,
                  int n_t, int n_b, int n_h, int reverse, float clip,
                  cudaStream_t st) {
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)hs0 | (uintptr_t)hs1 |
                         (uintptr_t)out0 | (uintptr_t)out1;
  bool vec = n_h % 8 == 0 && addr % 16 == 0;
  void* args[] = {(void*)&x,     (void*)&w0,      (void*)&w1,
                  (void*)&lengths, (void*)&hs0,   (void*)&hs1,
                  (void*)&out0,  (void*)&out1,    (void*)&xbuf,
                  (void*)&count, (void*)&n_t,     (void*)&n_b,
                  (void*)&n_h,   (void*)&reverse, (void*)&clip,
                  (void*)&vec};
  return launch_coop((const void*)mma_sweep_kernel<kBwd, kDirs, kN>,
                     kDirs * ceil_div(n_h, kN), smem_bf16(n_h, kN), args,
                     st);
}

// One launch of a plan (ops/birnn_cuda.py: plan): `wide` the instance (0
// narrow, 1 wide), `dirs` the directions it sweeps, `cols` the columns of W
// a block keeps.  Instantiated: narrow, one direction, 16 columns (bf16 or
// f32); narrow, both directions of a layer, 32 columns (bf16, B <= 64, a
// zero carry); wide, one direction, 16 columns a column tile a block owns
// (at most kMaxOwn, and the fewest blocks of that many).  Anything else is
// cudaErrorInvalidValue, and nothing runs.
template <bool kBwd>
int dispatch(const void* x, const void* w0, const void* w1,
             const int* lengths, const void* hs0, const void* hs1,
             const void* h0, void* out0, void* out1, void* xbuf,
             unsigned int* count, int n_t, int n_b, int n_h, int reverse,
             float clip, int bf16_io, int wide, int dirs, int cols,
             void* stream) {
  if (n_b < 1 || n_b > kMaxB || n_h < 1 || n_t < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dirs == 2) {
    if (!bf16_io || wide || cols != 32 || h0 != nullptr || n_b > max_rows(32))
      return (int)cudaErrorInvalidValue;
    return launch_sweeps<kBwd, 2, 32>(x, w0, w1, lengths, hs0, hs1, out0,
                                      out1, xbuf, count, n_t, n_b, n_h,
                                      reverse, clip, st);
  }
  const int n_tiles = ceil_div(n_h, kCols), own = cols / kCols;
  if (dirs != 1 || cols % kCols != 0 || own < 1 || (!wide && own != 1) ||
      own > kMaxOwn || ceil_div(n_tiles, ceil_div(n_tiles, own)) != own)
    return (int)cudaErrorInvalidValue;
  int plan[4] = {n_tiles, 1, 0, 0};
  if (wide) {
    const int err = wide_plan(n_b, n_h, bf16_io, own, plan);
    if (err != 0) return err;
  }
  if (h0 != nullptr) {  // h0's rows into the zeroed first half, in order
    const size_t elem = bf16_io ? sizeof(bf16) : sizeof(float);
    const cudaError_t err = cudaMemcpy2DAsync(
        xbuf, round_up(n_h, kPad) * elem, h0, n_h * elem, n_h * elem, n_b,
        cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  // the wide kernels take their cached k-tiles (bf16) or chunks (f32)
  int cap = bf16_io && wide ? plan[2] / plan[1] : plan[2];
  if (bf16_io && !wide)
    return launch_sweeps<kBwd, 1, kCols>(x, w0, w0, lengths, hs0, hs0, out0,
                                         out0, xbuf, count, n_t, n_b, n_h,
                                         reverse, clip, st);
  if (bf16_io) {
    const bf16* xp = static_cast<const bf16*>(x);
    const bf16* wp = static_cast<const bf16*>(w0);
    const bf16* hp = static_cast<const bf16*>(hs0);
    bf16* op = static_cast<bf16*>(out0);
    bf16* bp = static_cast<bf16*>(xbuf);
    const uintptr_t addr = (uintptr_t)xp | (uintptr_t)hp | (uintptr_t)op;
    bool vec = n_h % 8 == 0 && addr % 16 == 0;
    void* args[] = {(void*)&xp, (void*)&wp, (void*)&lengths, (void*)&hp,
                    (void*)&op, (void*)&bp, (void*)&count, (void*)&n_t,
                    (void*)&n_b, (void*)&n_h, (void*)&reverse, (void*)&clip,
                    (void*)&vec, (void*)&cap};
    return launch_coop((const void*)mma_wide_kernel<kBwd>, plan[0], plan[3],
                       args, st);
  }
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w0);
  const float* hp = static_cast<const float*>(hs0);
  float* op = static_cast<float*>(out0);
  float* bp = static_cast<float*>(xbuf);
  if (wide) {
    const uintptr_t addr = (uintptr_t)xp | (uintptr_t)hp | (uintptr_t)op;
    bool vec = n_h % 4 == 0 && addr % 16 == 0;
    void* args[] = {(void*)&xp, (void*)&wp, (void*)&lengths, (void*)&hp,
                    (void*)&op, (void*)&bp, (void*)&count, (void*)&n_t,
                    (void*)&n_b, (void*)&n_h, (void*)&reverse, (void*)&clip,
                    (void*)&vec, (void*)&cap};
    const int rows = f32_wide_rows(n_b, own);
    const void* kern =
        rows == 1   ? (const void*)f32_wide_kernel<kBwd, 1>
        : rows == 2 ? (const void*)f32_wide_kernel<kBwd, 2>
        : rows == 4 ? (const void*)f32_wide_kernel<kBwd, 4>
                    : (const void*)f32_wide_kernel<kBwd, 8>;
    return launch_coop(kern, plan[0], plan[3], args, st);
  }
  void* args[] = {(void*)&xp, (void*)&wp, (void*)&lengths, (void*)&hp,
                  (void*)&op, (void*)&bp, (void*)&count, (void*)&n_t,
                  (void*)&n_b, (void*)&n_h, (void*)&reverse, (void*)&clip};
  return launch_coop((const void*)f32_sweep_kernel<kBwd>, plan[0],
                     smem_f32(n_h), args, st);
}

}  // namespace

extern "C" {

// B1 of one plan.  z [T, B, H] in the io type, shared by the directions;
// w0, w1 [H, H] in the io type, direction 0's and 1's W (a wide launch: W
// zero-padded to [H_pad, H_pad] and laid out by column tiles, [H_pad / 16]
// [H_pad][16], element (k, j) at ((j / 16) H_pad + k) 16 + j % 16); lengths
// [B] int32; h0 [B, H] io type, one direction's initial carry, or null for
// a zero carry; hs0, hs1 [T, B, H] the states; xbuf [dirs, 2, B_pad, H_pad]
// io type (B and H rounded up to multiples of 16), zeroed (the zero carry
// and the padding; h0, when given, is copied into its first half on the
// stream before the launch); count dirs x kCountStride zeroed uint32,
// direction i's counter at kCountStride i.  Direction 0 sweeps in `reverse`
// time order, direction 1 the other way; w1, hs1 are read only where dirs
// is 2.  The grid (dirs ceil(H / cols) narrow blocks, or the wide plan's)
// must be co-resident, else cudaErrorCooperativeLaunchTooLarge and nothing
// runs.  Returns 0 or a CUDA error code.
int birnn_fwd_launch(const void* z, const void* w0, const void* w1,
                     const int* lengths, const void* h0, void* hs0, void* hs1,
                     void* xbuf, unsigned int* count, int n_t, int n_b,
                     int n_h, int reverse, float clip, int bf16, int wide,
                     int dirs, int cols, void* stream) {
  return dispatch<false>(z, w0, w1, lengths, nullptr, nullptr, h0, hs0, hs1,
                         xbuf, count, n_t, n_b, n_h, reverse, clip, bf16,
                         wide, dirs, cols, stream);
}

// B2 of one plan: g [T, B, H] shared; wt0, wt1 the transposed W's; d0, d1
// direction 0's and 1's deltas over their stored states hs0, hs1 (from
// zero: there is no carry); the rest as for birnn_fwd_launch.  The argument
// order follows it: the swept input, the weights, the third inputs (the
// states here, the lengths and h0 there), the outputs.
int birnn_bwd_launch(const void* g, const void* wt0, const void* wt1,
                     const void* hs0, const void* hs1, void* d0, void* d1,
                     void* xbuf, unsigned int* count, int n_t, int n_b,
                     int n_h, int reverse, float clip, int bf16, int wide,
                     int dirs, int cols, void* stream) {
  return dispatch<true>(g, wt0, wt1, nullptr, hs0, hs1, nullptr, d0, d1,
                        xbuf, count, n_t, n_b, n_h, reverse, clip, bf16,
                        wide, dirs, cols, stream);
}

// The wide instances' plan (grid, tiles a block, cached pieces, shared
// memory bytes) on the current card: the fewest tiles a block over at most
// one block a SM.  0, or cudaErrorCooperativeLaunchTooLarge where that is
// over kMaxOwn, or cudaErrorInvalidValue where the width does not fit.
int birnn_wide_plan(int n_b, int n_h, int bf16, int* plan) {
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int own = ceil_div(ceil_div(n_h, kCols), n_sm);
  if (own > kMaxOwn) return (int)cudaErrorCooperativeLaunchTooLarge;
  return wide_plan(n_b, n_h, bf16, own, plan);
}

}  // extern "C"
