"""Fused BiRNN recurrence: CUDA kernels B1 (forward) and B2 (backward),
their plain versions, and the autograd Function over them.

Counterpart of ``tpu_ctc.ops.birnn_pallas``.  One direction computes

    h_t = clip(z_t + bf16(h_{t-1}) @ W, 0, clip) * 1{t < length}

from a carry h0 (zero unless given), forward or reversed in time; its
backward is the delta sweep in the opposite time order, from zero,

    d_t = (g_t + bf16(d_next) @ W^T) * 1{0 < h_t < clip}.

:func:`bi_recurrence` sums the two directions in f32 and differentiates
through :class:`BiRecurrence`, which mirrors ``_make_bi_recurrence``
(``birnn_pallas.py:228-326``).  :func:`carry_recurrence` sweeps one
direction from a nonzero h0 (a chunk of sequence parallelism) and
differentiates through :class:`CarryRecurrence`, which mirrors
``_make_carry_recurrence`` (``birnn_pallas.py:354-416``): its backward also
returns dh0.  Rounding points are the Pallas kernels':
z, g and h0 are rounded to the io dtype before a sweep, the dot input is the
state (or delta) in the compute dtype with f32 accumulation, and each
``h_t`` and ``d_t`` is stored in the io dtype.  The weight gradients
dW = sum_t h_neighbour^T d_t are one large product each, outside the
kernels, as the JAX package leaves them to XLA.

Layout is time-major [T, B, H].  :func:`fwd_recurrence` and
:func:`bwd_recurrence` launch the kernels (one source, ``csrc/birnn.cu``)
for CUDA tensors and run the plain loops for CPU tensors; for a CUDA tensor
they never fall back: what a kernel cannot take raises.  The kernels take
every width the JAX kernel takes (:func:`check_supported`): up to 16
columns a block on every SM at once (H <= 2112 on an H100 SXM) the narrow
instances, above it the wide ones (:func:`instance`), which deal the
16-column tiles over at most one block a SM, read the previous state once a
step for all of a block's tiles and stream the part of W that does not fit
their shared memory; both compute the same values in the same order, and a
wide launch is counted on its own kernel (``WIDE_KERNEL``,
``WIDE_BWD_KERNEL``).  Where both directions of a bf16 layer fit the card
at once in the narrow instance (:func:`bi_grid`), :class:`BiRecurrence`
sweeps them in one launch of B1 and one of B2, each direction on half the
grid, bit-equal to the two launches: with 16 columns of W a block where
that fits twice (H <= 1056 on an H100 SXM; counted on ``FWD_BI_KERNEL`` and
``BWD_BI_KERNEL``), else with 32 at B <= 64 (H <= 2080; counted on
``FWD_BI32_KERNEL`` and ``BWD_BI32_KERNEL``).

The dense products outside the kernels have an f32 result.  On a card, a
product of two bf16 operands (the dense forward at a bf16 compute dtype, dW
at a bf16 io dtype) is one bf16 GEMM with f32 accumulation and output on
the tensor cores (:func:`matmul_bf16`), as the reference multiplies bf16
operands on its matrix unit with ``preferred_element_type=f32``; every
other product (an f32 operand: the cotangent's, or an f32 compute dtype)
goes through :func:`matmul_f32`, which switches TF32 off around the call.
On the CPU every product is the f32 product of the same values.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from tpu_ctc_torch.ops._build import CudaKernel, check, ptr, stream_of

KERNEL = CudaKernel("birnn_fwd", source="birnn")
BWD_KERNEL = CudaKernel("birnn_bwd", source="birnn")
# The wide instances (H above 16 columns a resident block): kernels of their
# own in the same library, counted apart from the narrow ones.
WIDE_KERNEL = CudaKernel("birnn_fwd_wide", source="birnn")
WIDE_BWD_KERNEL = CudaKernel("birnn_bwd_wide", source="birnn")
_WIDE = {KERNEL.name: WIDE_KERNEL, BWD_KERNEL.name: WIDE_BWD_KERNEL}
# Both directions of a layer in one narrow launch (:func:`bi_grid`): kernels
# of their own in the same library, one count a launch of two sweeps.
FWD_BI_KERNEL = CudaKernel("birnn_fwd_bi", source="birnn")
BWD_BI_KERNEL = CudaKernel("birnn_bwd_bi", source="birnn")
# ... with 32 columns of W a block, where two 16-column grids do not fit
FWD_BI32_KERNEL = CudaKernel("birnn_fwd_bi32", source="birnn")
BWD_BI32_KERNEL = CudaKernel("birnn_bwd_bi32", source="birnn")
_BI = {(False, 16): FWD_BI_KERNEL, (True, 16): BWD_BI_KERNEL,
       (False, 32): FWD_BI32_KERNEL, (True, 32): BWD_BI32_KERNEL}
# The kernels' limits.  A block is 256 threads; the bf16 kernel keeps 8
# m-tiles x 2 n-tiles of f32 accumulators a warp (B <= 128) and takes 172
# registers a thread (ptxas, 0 spill bytes), within an SM's 64 K; its shared
# memory (rings and W's columns, over half an SM's) allows one block a SM.
# Its instance of 32 columns a block keeps 4 x 4 (B <= 64), 152-158
# registers.
MAX_BATCH = 128                    # kMaxB of the kernels
_COLS, _PAD, _KC = 16, 16, 64      # kCols, kPad, kKc of the kernels
_BI_COLS, _BI_ROWS = 32, 64        # the 32-column instance: max_rows(32)
# bf16, by columns of W a block: kWarps rings of ring_stages x 4 KB
_RING_BYTES = {_COLS: 8 * 4 * 4096, _BI_COLS: 8 * 3 * 4096}
_SMEM_LIMIT = 232448               # bytes of shared memory a block may use
_MAX_OWN = 4                       # kMaxOwn: column tiles a wide block owns
H100_SMS = 132                     # SMs of an H100 SXM: one block each
_COOP_TOO_LARGE = 720              # cudaErrorCooperativeLaunchTooLarge
_COUNT_STRIDE = 32                 # kCountStride: a fused launch's counters
# The JAX kernel's VMEM budget (tpu_ctc/ops/birnn_pallas.py:_VMEM_BUDGET):
# the widths it admits are the widths the port takes.
_JAX_VMEM_BUDGET = 80 * 1024 * 1024
_JAX_LANE = 128


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def jax_admits(n_h: int, dtype: torch.dtype) -> bool:
    """Whether the JAX package's fused kernel takes width ``n_h`` at this
    compute (and io) dtype: ``birnn_pallas.supported``'s formula, W plus
    one minimal stream chunk within its VMEM budget (bf16: H <= 6016,
    f32: H <= 4096).  Above it the JAX package runs the XLA scan."""
    h_pad = _round_up(n_h, _JAX_LANE)
    item = torch.tensor([], dtype=dtype).element_size()
    min_stream = 3 * 2 * 8 * 16 * h_pad * item
    return h_pad * h_pad * item + min_stream + 4 * h_pad * 16 \
        <= _JAX_VMEM_BUDGET


def exchange_shape(n_b: int, n_h: int) -> tuple:
    """Shape of the kernels' zeroed exchange buffer: two halves of
    [B_pad, H_pad], B and H rounded up to multiples of 16 (one mma tile,
    and 16-byte aligned rows for the bf16 kernel's copies)."""
    return (2, _round_up(n_b, _PAD), _round_up(n_h, _PAD))


def grid_size(n_h: int) -> int:
    """Blocks of a narrow launch: one per 16 columns of W, all
    co-resident."""
    return -(-n_h // _COLS)


def wide_grid(n_h: int, n_sm: int = H100_SMS) -> tuple:
    """(blocks, column tiles a block owns) of a wide launch: the H_pad / 16
    tiles dealt round-robin over at most one block a SM."""
    tiles = grid_size(n_h)
    own = -(-tiles // n_sm)
    return -(-tiles // own), own


def smem_bytes(n_h: int, dtype: torch.dtype, cols: int = _COLS) -> int:
    """Shared memory one narrow block takes: for bf16 the warps' copy rings
    and W's ``cols`` columns (16, or 32 in a fused launch; a row padded by
    16 bytes); for f32 W's 16 columns and the staged carry of up to 128
    rows in k-chunks of 64.  A wide block takes what the card allows
    (``birnn_wide_plan``): its rings (bf16: a ring of 4 k-tiles a warp;
    f32: 4 chunks of 64 k a block), and W's pieces cached as far as they
    fit."""
    if dtype == torch.bfloat16:
        return _RING_BYTES[cols] + cols * (_round_up(n_h, _PAD) + 8) * 2
    return (n_h * _COLS + MAX_BATCH * (_KC + 1)) * 4


def instance(n_h: int, dtype: torch.dtype, n_sm: int = H100_SMS) -> str:
    """Which instance a launch of width ``n_h`` takes on a card of ``n_sm``
    SMs: "narrow" while its 16-column blocks are co-resident (one a SM) and
    a block's shared memory fits, else "wide"."""
    if grid_size(n_h) <= n_sm and smem_bytes(n_h, dtype) <= _SMEM_LIMIT:
        return "narrow"
    return "wide"


def bi_grid(n_b: int, n_h: int, dtype: torch.dtype, n_sm: int = H100_SMS,
            *, bidirectional: bool = True) -> Tuple[int, int]:
    """(blocks, columns of W a block) of one launch that sweeps both
    directions of a layer of ``n_b`` rows, half the grid each, where the
    layer is bidirectional and the io dtype bf16: 16 columns where both
    halves fit one block a SM in the narrow instance (H <= 1056 on 132
    SMs); else 32 where B <= 64, both halves of ceil(H / 32) blocks fit and
    a block's shared memory does (H <= 2080 on 132 SMs); else (0, 0), and
    the directions launch one after the other."""
    if not (bidirectional and dtype == torch.bfloat16):
        return 0, 0
    grid = 2 * grid_size(n_h)
    if grid <= n_sm and instance(n_h, dtype, n_sm) == "narrow":
        return grid, _COLS
    grid = 2 * -(-n_h // _BI_COLS)
    if (n_b <= _BI_ROWS and grid <= n_sm
            and smem_bytes(n_h, dtype, _BI_COLS) <= _SMEM_LIMIT):
        return grid, _BI_COLS
    return 0, 0


def direction_sweeps(launches: Dict[str, int]) -> Dict[str, int]:
    """Narrow B1 and B2 sweeps of one direction each in a dict of launch
    counts (kernel name -> launches): ``birnn_fwd`` + 2 ``birnn_fwd_bi`` +
    2 ``birnn_fwd_bi32``, and the same of B2."""
    return {k.name: launches.get(k.name, 0)
            + 2 * launches.get(_BI[bwd, 16].name, 0)
            + 2 * launches.get(_BI[bwd, 32].name, 0)
            for k, bwd in ((KERNEL, False), (BWD_KERNEL, True))}


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full f32: TF32 is switched off for the call on a card
    (a product of two bf16 values is exact in f32, so with TF32 off a
    product of bf16-rounded operands has f32 accumulation)."""
    if not a.is_cuda:
        return a @ b
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 matrices on a card: one bf16 GEMM that
    accumulates and returns f32 (``torch.mm`` with ``out_dtype``).  The
    products of bf16 values are exact, so it equals the f32 product of the
    same values up to the order of the f32 sums."""
    return torch.mm(a, b, out_dtype=torch.float32)


class DotF32(torch.autograd.Function):
    """``x @ w`` with inputs rounded to the compute dtype and an f32 result,
    as JAX's ``jnp.dot(x.astype(cdt), w.astype(cdt),
    preferred_element_type=f32)``, and JAX's gradient of it: the f32
    cotangent g enters both products unrounded, and dx = g w_c^T and
    dw = x_c^T g are each rounded to the compute dtype (the transpose of
    ``astype(cdt)``) before they return to the inputs' f32.  x is [..., K],
    w [K, N].  On a card at a bf16 compute dtype the forward product is
    :func:`matmul_bf16`; the backward's products take the f32 cotangent and
    stay f32 (:func:`matmul_f32`)."""

    @staticmethod
    def forward(ctx, x, w, compute_dtype):
        ctx.cdt = compute_dtype
        ctx.dtypes = (x.dtype, w.dtype)
        if x.is_cuda and compute_dtype == torch.bfloat16:
            xb, wb = x.to(compute_dtype), w.to(compute_dtype)
            ctx.save_for_backward(xb, wb)
            out = matmul_bf16(xb.reshape(-1, xb.shape[-1]), wb)
            return out.reshape(*x.shape[:-1], w.shape[-1])
        xc = x.to(compute_dtype).to(torch.float32)
        wc = w.to(compute_dtype).to(torch.float32)
        ctx.save_for_backward(xc, wc)
        return matmul_f32(xc, wc)

    @staticmethod
    def backward(ctx, g):
        xc, wc = (t.to(torch.float32) for t in ctx.saved_tensors)
        g = g.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = matmul_f32(g, wc.t()).to(ctx.cdt).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = matmul_f32(xc.reshape(-1, xc.shape[-1]).t(),
                            g.reshape(-1, g.shape[-1]))
            dw = dw.to(ctx.cdt).to(ctx.dtypes[1])
        return dx, dw, None


def dot_f32(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x @ w`` with inputs rounded to ``compute_dtype`` and an f32 result
    that is not rounded again, as JAX's ``preferred_element_type=f32``;
    differentiable as :class:`DotF32`."""
    return DotF32.apply(x, w, compute_dtype)


def fwd_recurrence_plain(z: torch.Tensor, w: torch.Tensor,
                         lengths: torch.Tensor, *, reverse: bool,
                         clip: float, h0: torch.Tensor = None) -> torch.Tensor:
    """Plain per-frame loop: z [T, B, H] io dtype, w [H, H] compute dtype,
    lengths [B] int, h0 [B, H] the initial carry (rounded to z's dtype;
    zero when None) -> hs [T, B, H] in z's dtype."""
    n_t, n_b, n_h = z.shape
    h = (torch.zeros((n_b, n_h), dtype=torch.float32, device=z.device)
         if h0 is None else h0.to(z.dtype).to(torch.float32))
    live = (torch.arange(n_t, device=z.device)[:, None]
            < lengths.to(z.device)[None, :])                  # [T, B]
    out = torch.empty_like(z)
    for s in range(n_t):
        t = n_t - 1 - s if reverse else s
        a = z[t].to(torch.float32) + dot_f32(h, w, w.dtype)
        h = torch.where(live[t][:, None], torch.clamp(a, 0.0, clip),
                        torch.zeros_like(a))
        out[t] = h.to(z.dtype)          # the carry h itself stays f32
    return out


def check_supported(n_b: int, n_h: int, dtype: torch.dtype,
                    what: str = "birnn_fwd", n_sm: int = H100_SMS) -> None:
    """Raise if the kernels (B1 and B2 share their limits) cannot take
    this shape or dtype on a card of ``n_sm`` SMs: B <= 128 and every
    width that the JAX package's fused kernel takes at this dtype
    (:func:`jax_admits`: bf16 H <= 6016, f32 H <= 4096), the narrow
    instance up to 16 n_sm columns (2112 on an H100 SXM), the wide one
    above, whose blocks own at most 4 column tiles each."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{what} kernel: io dtype {dtype} "
                                  "(bfloat16 or float32 only)")
    if not 1 <= n_b <= MAX_BATCH:
        raise NotImplementedError(
            f"{what} kernel: batch {n_b} (1..{MAX_BATCH} per launch)")
    if not jax_admits(n_h, dtype):
        raise NotImplementedError(
            f"{what} kernel: H={n_h} at {dtype} is above the widths the "
            f"JAX package's fused kernel takes (its W must fit "
            f"{_JAX_VMEM_BUDGET >> 20} MiB of VMEM; the JAX package runs "
            "the XLA scan there)")
    if instance(n_h, dtype, n_sm) == "wide":
        grid, own = wide_grid(n_h, n_sm)
        if own > _MAX_OWN:
            raise NotImplementedError(
                f"{what} kernel: H={n_h} needs {own} column tiles of 16 a "
                f"block over the {n_sm} SMs the card holds (at most "
                f"{_MAX_OWN})")


def wide_plan(n_b: int, n_h: int, dtype: torch.dtype) -> Dict[str, int]:
    """The wide instance's launch on the current card: grid, tiles a
    block, pieces of W kept in shared memory (bf16: 16 x 16 pieces a warp,
    the last k-tiles of its range for every owned tile; f32: 64-k chunks
    of every owned tile's columns a block, the last chunks of the k range)
    and a block's shared memory in bytes."""
    plan = (ctypes.c_int * 4)()
    fn = WIDE_KERNEL.lib().birnn_wide_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    check(fn(n_b, n_h, int(dtype == torch.bfloat16), plan), "birnn_wide_plan")
    return dict(zip(("grid", "own", "cached", "smem"), plan))


def wide_weights(w: torch.Tensor) -> torch.Tensor:
    """W [H, H] as the wide instances take it: zero-padded to [H_pad,
    H_pad] and laid out by 16-column tiles, [H_pad / 16, H_pad, 16], so
    that a tile's rows are one run of memory."""
    h_pad = _round_up(w.shape[0], _PAD)
    pad = h_pad - w.shape[0]
    w = torch.nn.functional.pad(w, (0, pad, 0, pad)) if pad else w
    return w.reshape(h_pad, h_pad // _COLS, _COLS).transpose(0, 1) \
        .contiguous()


def _checked(what: str, x: torch.Tensor, w: torch.Tensor,
             third: torch.Tensor, h0: torch.Tensor = None) -> int:
    """Raise on what a launch of B1 or B2 cannot take (x [T, B, H] swept
    input, w [H, H], ``third`` and ``h0`` as :func:`_sweep_cuda` takes
    them); the card's SMs."""
    if not (x.is_cuda and w.is_cuda and third.is_cuda
            and (h0 is None or h0.is_cuda)):
        raise ValueError(f"{what} kernel: tensors must be on a CUDA device")
    if x.dim() != 3 or w.shape != (x.shape[2], x.shape[2]):
        raise ValueError(f"{what} kernel: {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not fit [T,B,H] x [H,H]")
    if h0 is not None and (h0.shape != x.shape[1:] or h0.dtype != x.dtype):
        raise ValueError(f"{what} kernel: h0 {tuple(h0.shape)} {h0.dtype} "
                         f"does not fit [B, H] {x.dtype}")
    if w.dtype != x.dtype:
        raise NotImplementedError(
            f"{what} kernel: io dtype {x.dtype} with compute dtype "
            f"{w.dtype} (the kernel takes one dtype for both)")
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    check_supported(x.shape[1], x.shape[2], x.dtype, what, n_sm)
    return n_sm


def _sweep_cuda(kernel: CudaKernel, x: torch.Tensor, w: torch.Tensor,
                third: torch.Tensor, *, reverse: bool, clip: float,
                h0: torch.Tensor = None, wide: bool = None) -> torch.Tensor:
    """Launch B1 or B2: x [T, B, H] swept input, w [H, H] in x's dtype,
    ``third`` the lengths (B1) or the stored states (B2), ``h0`` B1's
    initial carry [B, H] in x's dtype or None -> [T, B, H].  The instance
    is :func:`instance`'s unless ``wide`` names it (the card tests hold
    the wide one against the narrow one at narrow widths); a wide launch
    is counted on the wide kernel (``WIDE_KERNEL``, ``WIDE_BWD_KERNEL``)."""
    what = kernel.name
    n_sm = _checked(what, x, w, third, h0)
    n_t, n_b, n_h = x.shape
    if wide is None:
        wide = instance(n_h, x.dtype, n_sm) == "wide"
    x = x.contiguous()
    w = w.contiguous()
    if wide:
        kernel = _WIDE[kernel.name]
        w = wide_weights(w)
    out = torch.empty_like(x)
    xbuf = torch.zeros(exchange_shape(n_b, n_h), dtype=x.dtype,
                       device=x.device)
    count = torch.zeros((1,), dtype=torch.int32, device=x.device)
    fn = getattr(kernel.lib(), kernel.name + "_launch")
    fn.restype = ctypes.c_int
    carry = []                  # B1 takes h0 (null: a zero carry)
    if kernel.name in (KERNEL.name, WIDE_KERNEL.name):
        h0 = None if h0 is None else h0.contiguous()
        carry = [ctypes.c_void_p(None) if h0 is None else ptr(h0)]
    fn.argtypes = [ctypes.c_void_p] * (6 + len(carry)) + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    err = fn(ptr(x), ptr(w), ptr(third), *carry, ptr(out), ptr(xbuf),
             ptr(count), n_t, n_b, n_h, int(reverse), float(clip),
             int(x.dtype == torch.bfloat16),
             stream_of(what, x, w, third, h0, out, xbuf, count))
    if err == _COOP_TOO_LARGE:
        raise NotImplementedError(
            f"{what} kernel: H={n_h} needs more co-resident blocks than "
            "the card holds at once")
    check(err, what)
    kernel.launches += 1
    return out


def _bi_sweep_cuda(backward: bool, x: torch.Tensor, ws, thirds, *,
                   clip: float):
    """Both directions of a layer in one launch of :func:`bi_grid` blocks,
    x [T, B, H] shared: B1 (ws = (wf, wb), thirds the lengths twice)
    sweeps direction 0 forward and 1 reversed, B2 (``backward``; ws =
    (wf^T, wb^T), thirds = (hs_f, hs_b)) direction 0 right to left and 1
    left to right; each direction has its own zeroed exchange buffer and
    counter -> the two outputs.  Counted on ``FWD_BI_KERNEL`` or
    ``BWD_BI_KERNEL`` at 16 columns a block, ``FWD_BI32_KERNEL`` or
    ``BWD_BI32_KERNEL`` at 32.  None where the launch does not engage
    (:func:`bi_grid` is (0, 0), or the card cannot hold the grid at once):
    nothing ran, and the caller sweeps one direction at a time."""
    n_t, n_b, n_h = x.shape
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid, cols = bi_grid(n_b, n_h, x.dtype, n_sm)
    if not grid:
        return None
    kernel = _BI[backward, cols]
    for w, third in zip(ws, thirds):
        _checked(kernel.name, x, w, third)
    x = x.contiguous()
    ws = [w.contiguous() for w in ws]
    outs = [torch.empty_like(x) for _ in ws]
    xbuf = torch.zeros((2,) + exchange_shape(n_b, n_h), dtype=x.dtype,
                       device=x.device)
    count = torch.zeros((2 * _COUNT_STRIDE,), dtype=torch.int32,
                        device=x.device)
    fn = getattr(kernel.lib(), kernel.name + "_launch")
    fn.restype = ctypes.c_int
    # B1 takes the shared lengths once, B2 each direction's states
    third = thirds if backward else thirds[:1]
    args = [ptr(t) for t in (x, *ws, *third, *outs, xbuf, count)]
    fn.argtypes = [ctypes.c_void_p] * len(args) + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    err = fn(*args, n_t, n_b, n_h, float(clip),
             stream_of(kernel.name, x, *ws, *thirds, *outs, xbuf, count))
    if err == _COOP_TOO_LARGE:
        return None
    check(err, kernel.name)
    kernel.launches += 1
    return tuple(outs)


def fwd_recurrence_cuda(z: torch.Tensor, w: torch.Tensor,
                        lengths: torch.Tensor, *, reverse: bool,
                        clip: float, h0: torch.Tensor = None) -> torch.Tensor:
    """Launch kernel B1 for one direction.  Same contract as
    :func:`fwd_recurrence_plain`; z and w must share the io dtype, and h0
    is rounded to it."""
    return _sweep_cuda(KERNEL, z, w, lengths.to(torch.int32).contiguous(),
                       reverse=reverse, clip=clip,
                       h0=None if h0 is None else h0.to(z.dtype))


def fwd_recurrence(z, w, lengths, *, reverse: bool, clip: float, h0=None):
    """One direction: kernel B1 for CUDA tensors, the plain loop for CPU
    tensors."""
    if z.is_cuda:
        return fwd_recurrence_cuda(z, w, lengths, reverse=reverse, clip=clip,
                                   h0=h0)
    return fwd_recurrence_plain(z, w, lengths, reverse=reverse, clip=clip,
                                h0=h0)


def fwd_bi_recurrence(z, wf, wb, lengths, *, clip: float,
                      plain: bool = False):
    """Both directions' states (hs_f swept forward with wf, hs_b reversed
    with wb): one launch of B1 for the two on a card where :func:`bi_grid`
    engages, else one a direction; the plain loops for CPU tensors and
    with ``plain``."""
    if z.is_cuda and not plain:
        lengths = lengths.to(torch.int32).contiguous()
        pair = _bi_sweep_cuda(False, z, (wf, wb), (lengths, lengths),
                              clip=clip)
        if pair is not None:
            return pair
    fwd = fwd_recurrence_plain if plain else fwd_recurrence
    return (fwd(z, wf, lengths, reverse=False, clip=clip),
            fwd(z, wb, lengths, reverse=True, clip=clip))


def bwd_recurrence_plain(g: torch.Tensor, hs: torch.Tensor, wt: torch.Tensor,
                         *, reverse: bool, clip: float) -> torch.Tensor:
    """Plain delta loop: g, hs [T, B, H] io dtype (hs the stored forward
    states), wt = W^T [H, H] compute dtype -> d [T, B, H] in g's dtype.
    ``reverse`` sweeps right to left (the forward direction's backward)."""
    n_t, n_b, n_h = g.shape
    d = torch.zeros((n_b, n_h), dtype=torch.float32, device=g.device)
    out = torch.empty_like(g)
    for s in range(n_t):
        t = n_t - 1 - s if reverse else s
        h = hs[t].to(torch.float32)
        active = (h > 0.0) & (h < clip)
        d = torch.where(active, g[t].to(torch.float32)
                        + dot_f32(d, wt, wt.dtype), torch.zeros_like(h))
        out[t] = d.to(g.dtype)          # the carry d itself stays f32
    return out


def bwd_recurrence_cuda(g: torch.Tensor, hs: torch.Tensor, wt: torch.Tensor,
                        *, reverse: bool, clip: float) -> torch.Tensor:
    """Launch kernel B2 for one direction.  Same contract as
    :func:`bwd_recurrence_plain`; g, hs and wt must share the io dtype."""
    _check_states(g, hs)
    return _sweep_cuda(BWD_KERNEL, g, wt, hs.contiguous(), reverse=reverse,
                       clip=clip)


def _check_states(g: torch.Tensor, hs: torch.Tensor) -> None:
    if hs.shape != g.shape or hs.dtype != g.dtype:
        raise ValueError(f"birnn_bwd kernel: hs {tuple(hs.shape)} {hs.dtype} "
                         f"does not match g {tuple(g.shape)} {g.dtype}")


def bwd_recurrence(g, hs, wt, *, reverse: bool, clip: float):
    """One direction's delta sweep: kernel B2 for CUDA tensors, the plain
    loop for CPU tensors."""
    if g.is_cuda:
        return bwd_recurrence_cuda(g, hs, wt, reverse=reverse, clip=clip)
    return bwd_recurrence_plain(g, hs, wt, reverse=reverse, clip=clip)


def bwd_bi_recurrence(g, hs_f, hs_b, wft, wbt, *, clip: float,
                      plain: bool = False):
    """Both directions' deltas (d_f right to left over hs_f with wft =
    W_f^T, d_b left to right over hs_b with wbt): one launch of B2 for the
    two on a card where :func:`bi_grid` engages, else one a direction; the
    plain loops for CPU tensors and with ``plain``."""
    if g.is_cuda and not plain:
        for hs in (hs_f, hs_b):
            _check_states(g, hs)
        pair = _bi_sweep_cuda(True, g, (wft, wbt),
                              (hs_f.contiguous(), hs_b.contiguous()),
                              clip=clip)
        if pair is not None:
            return pair
    bwd = bwd_recurrence_plain if plain else bwd_recurrence
    return (bwd(g, hs_f, wft, reverse=True, clip=clip),
            bwd(g, hs_b, wbt, reverse=False, clip=clip))


def _weight_grad(h_nb: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """dW = sum_t h_nb[t]^T d[t] over [T, B, H] io-dtype streams: one
    [H, T B] x [T B, H] product of the stored values with an f32 result
    (:func:`matmul_bf16` for bf16 streams on a card)."""
    n_h = d.shape[2]
    if d.is_cuda and d.dtype == torch.bfloat16 == h_nb.dtype:
        return matmul_bf16(h_nb.reshape(-1, n_h).t(), d.reshape(-1, n_h))
    return matmul_f32(h_nb.reshape(-1, n_h).to(torch.float32).t(),
                      d.reshape(-1, n_h).to(torch.float32))


class BiRecurrence(torch.autograd.Function):
    """Fused bidirectional recurrence with the custom gradient of
    ``_make_bi_recurrence``: the forward saves the io-dtype states of both
    sweeps; the backward rounds g to the io dtype, runs the delta sweeps
    (right to left for the forward direction, left to right for the
    reversed one), forms dz = d_f + d_b in f32 and dwf = h_prev^T d_f,
    dwb = h_next^T d_b with a zero state at the edge.  On a card the two
    directions' sweeps are one launch where :func:`bi_grid` engages."""

    @staticmethod
    def forward(ctx, z, wf, wb, lengths, clip, cdt, io, bidirectional,
                plain):
        z_io = z.to(io)
        if bidirectional:
            hs_f, hs_b = fwd_bi_recurrence(z_io, wf.to(cdt), wb.to(cdt),
                                           lengths, clip=clip, plain=plain)
            out = hs_f.to(torch.float32) + hs_b.to(torch.float32)
        else:
            fwd = fwd_recurrence_plain if plain else fwd_recurrence
            hs_f = fwd(z_io, wf.to(cdt), lengths, reverse=False, clip=clip)
            hs_b, out = None, hs_f.to(torch.float32)
        ctx.save_for_backward(hs_f, hs_b, wf, wb)
        ctx.opts = (clip, cdt, io, bidirectional, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        hs_f, hs_b, wf, wb = ctx.saved_tensors
        clip, cdt, io, bidirectional, plain = ctx.opts
        g_io = g.to(io)
        zeros = torch.zeros_like(hs_f[:1])
        if bidirectional:
            d_f, d_b = bwd_bi_recurrence(g_io, hs_f, hs_b, wf.to(cdt).t(),
                                         wb.to(cdt).t(), clip=clip,
                                         plain=plain)
        else:
            bwd = bwd_recurrence_plain if plain else bwd_recurrence
            d_f = bwd(g_io, hs_f, wf.to(cdt).t(), reverse=True, clip=clip)
        dz = d_f.to(torch.float32)
        dwf = _weight_grad(torch.cat([zeros, hs_f[:-1]]), d_f)
        if bidirectional:
            dz = dz + d_b.to(torch.float32)
            dwb = _weight_grad(torch.cat([hs_b[1:], zeros]), d_b).to(wb.dtype)
        else:
            dwb = torch.zeros_like(wb)
        return (dz, dwf.to(wf.dtype), dwb, None, None, None, None, None,
                None)


def bi_recurrence(z: torch.Tensor, wf: torch.Tensor, wb: torch.Tensor,
                  lengths: torch.Tensor, *, clip: float, compute_dtype,
                  io_dtype=None, bidirectional: bool = True,
                  plain: bool = False) -> torch.Tensor:
    """Fused bidirectional recurrence (``birnn_pallas.bi_recurrence`` with
    ``time_major=True``): z [T, B, H] f32 projection, wf/wb [H, H],
    lengths [B] -> f + b summed in f32, [T, B, H], differentiable in z, wf
    and wb.  ``plain`` forces the plain loops on any device.  With
    ``bidirectional=False`` only the forward sweep runs and wb gets a zero
    gradient."""
    return BiRecurrence.apply(z.to(torch.float32), wf, wb, lengths,
                              float(clip), compute_dtype,
                              io_dtype or compute_dtype, bool(bidirectional),
                              bool(plain))


def carry_sweep_grad(g: torch.Tensor, hs: torch.Tensor, h0: torch.Tensor,
                     w: torch.Tensor, *, reverse: bool, clip: float, cdt,
                     plain: bool = False):
    """The backward of one direction swept from h0, as
    ``_make_carry_recurrence``'s ``_bwd``: g [T, B, H] the f32 cotangent of
    the states, hs [T, B, H] and h0 [B, H] the io-dtype states and carry of
    the forward sweep, w [H, H] -> (dz [T, B, H], dW [H, H], dh0 [B, H]),
    all f32.  The delta sweep (B2 on a card) runs in the opposite time
    order from zero; h0 is the neighbour of the first processed frame in
    dW; dh0 = d_first W^T from the compute-dtype operands."""
    wc = w.to(cdt)
    bwd = bwd_recurrence_plain if plain else bwd_recurrence
    d = bwd(g.to(hs.dtype), hs, wc.t(), reverse=not reverse, clip=clip)
    h0_row = h0[None].to(hs.dtype)
    if reverse:
        h_nb, d_first = torch.cat([hs[1:], h0_row]), d[-1]
    else:
        h_nb, d_first = torch.cat([h0_row, hs[:-1]]), d[0]
    dh0 = matmul_f32(d_first.to(cdt).to(torch.float32),
                     wc.to(torch.float32).t())
    return d.to(torch.float32), _weight_grad(h_nb, d), dh0


class CarryRecurrence(torch.autograd.Function):
    """One direction swept from a nonzero carry, with the custom gradient
    of ``_make_carry_recurrence`` (:func:`carry_sweep_grad`): time-major z
    [T, B, H] f32, w [H, H], h0 [B, H] f32, lengths [B] -> hs [T, B, H]
    f32; differentiable in z, w and h0 (lengths get none)."""

    @staticmethod
    def forward(ctx, z, w, h0, lengths, clip, cdt, io, reverse, plain):
        fwd = fwd_recurrence_plain if plain else fwd_recurrence
        h0_io = h0.to(io)
        hs = fwd(z.to(io), w.to(cdt), lengths, reverse=reverse, clip=clip,
                 h0=h0_io)
        ctx.save_for_backward(hs, h0_io, w)
        ctx.opts = (clip, cdt, reverse, plain)
        return hs.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        hs, h0_io, w = ctx.saved_tensors
        clip, cdt, reverse, plain = ctx.opts
        dz, dw, dh0 = carry_sweep_grad(g, hs, h0_io, w, reverse=reverse,
                                       clip=clip, cdt=cdt, plain=plain)
        return dz, dw.to(w.dtype), dh0, None, None, None, None, None, None


def carry_recurrence(z: torch.Tensor, w: torch.Tensor, h0: torch.Tensor,
                     mask: torch.Tensor, *, reverse: bool, clip: float,
                     compute_dtype, io_dtype=None,
                     plain: bool = False) -> torch.Tensor:
    """Single-direction clipped-ReLU recurrence from carry h0
    (``birnn_pallas.carry_recurrence``): z [B, T, H] f32, w [H, H], h0
    [B, H], mask [B, T] trailing-padded -> hs [B, T, H] f32,
    differentiable in z, w and h0.  ``plain`` forces the plain loops on any
    device."""
    lengths = mask.to(torch.float32).sum(dim=1).to(torch.int32)
    hs = CarryRecurrence.apply(z.transpose(0, 1).to(torch.float32), w,
                               h0.to(torch.float32), lengths, float(clip),
                               compute_dtype, io_dtype or compute_dtype,
                               bool(reverse), bool(plain))
    return hs.transpose(0, 1)
