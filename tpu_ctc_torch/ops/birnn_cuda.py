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

Layout is time-major [T, B, H].  :func:`plan` is the one place that
chooses which row of ``INSTANCES`` (one source, ``csrc/birnn.cu``) runs a
layer's sweeps on a card; CPU tensors, and callers that pass
:data:`PLAIN`, run the plain loops.  Where both directions of a
bf16 layer fit the card at once with 32 columns of W a block (B <= 64, H <=
2080 on an H100 SXM), one launch sweeps both, each on half the grid.  Else
one direction a launch: the narrow instance while its 16-column blocks are
all resident, one a SM (H <= 2112 on an H100 SXM), above it the wide one,
whose blocks own up to 4 of the 16-column tiles, read the previous state
once a step for all of them and stream the part of W that does not fit
their shared memory.  Every instance computes the same values in the same
order, so each is bit-equal to the others.  :func:`fwd_recurrence` and
:func:`bwd_recurrence` run one or both directions under a plan, the plain
loops for CPU tensors; :func:`launch` launches one plan on a card, where
nothing falls back to the plain loops: what a kernel cannot take raises.

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
import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from tpu_ctc_torch.ops._build import CudaKernel, check, ptr, stream_of

# The kernels' instances: (code, directions a launch) -> (columns of W a
# block, B1's launch counter, B2's).  A wide block keeps 16 columns for
# each column tile it owns (``Plan.cols``).
INSTANCES = {("narrow", 1): (16, "birnn_fwd", "birnn_bwd"),
             ("wide", 1): (16, "birnn_fwd_wide", "birnn_bwd_wide"),
             ("narrow", 2): (32, "birnn_fwd_bi32", "birnn_bwd_bi32")}
# One launch counter a row and sweep, all over the one library.
COUNTERS = {name: CudaKernel(name, source="birnn")
            for _, *names in INSTANCES.values() for name in names}
# The kernels' limits, copies of birnn.cu's constants.  A block is 8 warps;
# a narrow bf16 warp keeps 64 f32 accumulators, 8 m-tiles x 2 n-tiles at 16
# columns a block (B <= 128), 4 x 4 at 32 (B <= 64), and copies the state
# through a ring of 4 KB stages; W's columns and the rings take over half an
# SM's shared memory, so one block a SM.
MAX_BATCH = 128                    # kMaxB
_COLS, _PAD, _KC = 16, 16, 64      # kCols, kPad, kKc
_WARPS, _STAGE_BYTES = 8, 4096     # kWarps, kStageBytes
_RING_STAGES = {16: 4, 32: 3}      # ring_stages(cols)
_MAX_ROWS = {16: MAX_BATCH, 32: 64}  # max_rows(cols)
_MAX_OWN = 4                       # kMaxOwn: column tiles a wide block owns
_COUNT_STRIDE = 32                 # kCountStride: a direction's counter
_SMEM_LIMIT = 232448               # bytes of shared memory a block may use
H100_SMS = 132                     # SMs of an H100 SXM: one block each
_COOP_TOO_LARGE = 720              # cudaErrorCooperativeLaunchTooLarge
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
    """Shape of a direction's zeroed exchange buffer: two halves of
    [B_pad, H_pad], B and H rounded up to multiples of 16 (one mma tile,
    and 16-byte aligned rows for the bf16 kernel's copies)."""
    return (2, _round_up(n_b, _PAD), _round_up(n_h, _PAD))


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the sweeps of a layer run (:func:`plan`).  ``code``: "plain"
    (the loops, on any device), "narrow" or "wide"; ``directions``: the
    directions one launch sweeps (a layer of two directions under a plan
    of one launches once a direction); ``cols``: the columns of W a block
    keeps (a wide block: 16 a column tile it owns); ``grid``: a launch's
    blocks, all resident at once; ``smem``: a narrow block's shared memory
    in bytes (a wide block takes what ``birnn_wide_plan`` finds on the
    card: 0 here); ``counters``: the names in ``COUNTERS`` that count B1's
    and B2's launches."""
    code: str
    directions: int = 1
    cols: int = 0
    grid: int = 0
    smem: int = 0
    counters: Tuple[str, str] = ("", "")

    def counter(self, backward: bool) -> CudaKernel:
        return COUNTERS[self.counters[backward]]


PLAIN = Plan("plain")


def _instance(code: str, directions: int, grid: int, smem: int,
              cols: int = 0) -> Plan:
    row_cols, *counters = INSTANCES[code, directions]
    return Plan(code, directions, cols or row_cols, grid, smem,
                tuple(counters))


def _narrow_smem(n_h: int, dtype: torch.dtype, cols: int) -> int:
    """Shared memory of a narrow block of ``cols`` columns of W: for bf16
    the warps' copy rings and W's columns (a row padded by 16 bytes); for
    f32 W's 16 columns and the staged carry of up to 128 rows in k-chunks
    of 64."""
    if dtype == torch.bfloat16:
        return (_WARPS * _RING_STAGES[cols] * _STAGE_BYTES
                + cols * (_round_up(n_h, _PAD) + 8) * 2)
    return (n_h * _COLS + MAX_BATCH * (_KC + 1)) * 4


def plan(n_b: int, n_h: int, dtype: torch.dtype, *, directions: int = 1,
         n_sm: int = H100_SMS, what: str = "birnn_fwd") -> Plan:
    """How ``directions`` (1 or 2) sweeps of a layer of ``n_b`` rows at
    width ``n_h`` and io dtype ``dtype`` run on a card of ``n_sm`` SMs
    (:data:`PLAIN`, the loops, is no choice of this function).  Two directions in one launch of 2
    ceil(H / 32) blocks of 32 columns where the dtype is bf16, B <= 64, the
    grid fits one block a SM and a block's shared memory fits (H <= 2080 on
    132 SMs); else one direction a launch: the narrow instance while its
    ceil(H / 16) blocks of 16 columns and their shared memory fit one a SM,
    else the wide one, its tiles dealt over at most one block a SM.
    Raises what the kernels cannot take, naming ``what``: a dtype other
    than bf16 and f32, B outside 1..128, a width the JAX package's fused
    kernel does not take (:func:`jax_admits`), a wide block of over 4
    tiles."""
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
    if directions == 2 and dtype == torch.bfloat16:
        cols = INSTANCES["narrow", 2][0]
        grid, smem = 2 * -(-n_h // cols), _narrow_smem(n_h, dtype, cols)
        if n_b <= _MAX_ROWS[cols] and grid <= n_sm and smem <= _SMEM_LIMIT:
            return _instance("narrow", 2, grid, smem)
    tiles = -(-n_h // _COLS)
    smem = _narrow_smem(n_h, dtype, _COLS)
    if tiles <= n_sm and smem <= _SMEM_LIMIT:
        return _instance("narrow", 1, tiles, smem)
    own = -(-tiles // n_sm)
    if own > _MAX_OWN:
        raise NotImplementedError(
            f"{what} kernel: H={n_h} needs {own} column tiles of 16 a "
            f"block over the {n_sm} SMs the card holds (at most "
            f"{_MAX_OWN})")
    return _instance("wide", 1, -(-tiles // own), 0, cols=_COLS * own)


def check_supported(n_b: int, n_h: int, dtype: torch.dtype,
                    what: str = "birnn_fwd", n_sm: int = H100_SMS) -> None:
    """Raise if the kernels (B1 and B2 share their limits) cannot take
    this shape or dtype on a card of ``n_sm`` SMs (:func:`plan`'s
    refusals): B <= 128 and every width that the JAX package's fused
    kernel takes at this dtype (bf16 H <= 6016, f32 H <= 4096)."""
    plan(n_b, n_h, dtype, n_sm=n_sm, what=what)


def plan_for(x: torch.Tensor, directions: int = 1) -> Plan:
    """:func:`plan` for ``directions`` sweeps of x [T, B, H] in x's dtype
    on x's card; the plain loops for CPU tensors."""
    if not x.is_cuda:
        return PLAIN
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    return plan(x.shape[1], x.shape[2], x.dtype, directions=directions,
                n_sm=n_sm)


def direction_sweeps(launches: Dict[str, int]) -> Dict[str, int]:
    """B1's and B2's sweeps of one direction by the narrow instances in a
    dict of launch counts (counter name -> launches): each narrow row's
    launches times its directions, under ``birnn_fwd`` and ``birnn_bwd``."""
    keys = INSTANCES["narrow", 1][1:]
    sweeps = dict.fromkeys(keys, 0)
    for (code, directions), (_, *names) in INSTANCES.items():
        if code == "narrow":
            for key, name in zip(keys, names):
                sweeps[key] += directions * launches.get(name, 0)
    return sweeps


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


def wide_plan(n_b: int, n_h: int, dtype: torch.dtype) -> Dict[str, int]:
    """The wide instance's launch on the current card: grid, tiles a
    block, pieces of W kept in shared memory (bf16: 16 x 16 pieces a warp,
    the last k-tiles of its range for every owned tile; f32: 64-k chunks
    of every owned tile's columns a block, the last chunks of the k range)
    and a block's shared memory in bytes."""
    out = (ctypes.c_int * 4)()
    fn = COUNTERS["birnn_fwd_wide"].lib().birnn_wide_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    check(fn(n_b, n_h, int(dtype == torch.bfloat16), out), "birnn_wide_plan")
    return dict(zip(("grid", "own", "cached", "smem"), out))


def wide_weights(w: torch.Tensor) -> torch.Tensor:
    """W [H, H] as the wide instances take it: zero-padded to [H_pad,
    H_pad] and laid out by 16-column tiles, [H_pad / 16, H_pad, 16], so
    that a tile's rows are one run of memory."""
    h_pad = _round_up(w.shape[0], _PAD)
    pad = h_pad - w.shape[0]
    w = torch.nn.functional.pad(w, (0, pad, 0, pad)) if pad else w
    return w.reshape(h_pad, h_pad // _COLS, _COLS).transpose(0, 1) \
        .contiguous()


def _checked(what: str, x: torch.Tensor, ws, thirds, h0) -> int:
    """Raise on tensors that do not fit a launch of B1 or B2 (the
    arguments of :func:`launch`); the card's SMs."""
    if not all(t is None or t.is_cuda for t in (x, *ws, *thirds, h0)):
        raise ValueError(f"{what} kernel: tensors must be on a CUDA device")
    for w in ws:
        if x.dim() != 3 or w.shape != (x.shape[2], x.shape[2]):
            raise ValueError(f"{what} kernel: {tuple(x.shape)} and w "
                             f"{tuple(w.shape)} do not fit [T,B,H] x [H,H]")
        if w.dtype != x.dtype:
            raise NotImplementedError(
                f"{what} kernel: io dtype {x.dtype} with compute dtype "
                f"{w.dtype} (the kernel takes one dtype for both)")
    if h0 is not None and (len(ws) != 1 or h0.shape != x.shape[1:]
                           or h0.dtype != x.dtype):
        raise ValueError(f"{what} kernel: h0 {tuple(h0.shape)} {h0.dtype} "
                         f"does not fit one direction's [B, H] {x.dtype}")
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def launch(p: Plan, backward: bool, x: torch.Tensor, ws: Sequence,
           thirds: Sequence, *, reverse: bool, clip: float,
           h0: torch.Tensor = None, lib: ctypes.CDLL = None) -> tuple:
    """Launch B1 (B2 with ``backward``) on a card under plan ``p`` (None:
    :func:`plan`'s for these tensors), ``p.directions`` directions a
    launch -> each direction's output [T, B, H] in x's dtype.  x [T, B,
    H]: the swept input (z or g), shared; ``ws``: each direction's W (B2:
    W^T) [H, H] in x's dtype; ``thirds``: the lengths [B] int32, shared
    (B1), or each direction's stored states (B2); ``h0``: B1's initial
    carry [B, H] in x's dtype for one direction, or None (zero).  The
    first direction sweeps in ``reverse`` time order, the second the other
    way; each has its own zeroed exchange buffer and counter, and each
    launch counts once on the plan's counter.  What :func:`plan` refuses
    for these tensors raises, under a given plan too.  Where the card
    cannot hold a two-direction grid at once, the directions launch in
    turn.  ``lib`` is another build of ``birnn.cu`` with this C interface
    (a tool's), else the package's."""
    if p and p.code == "plain":
        raise ValueError("the plain plan launches no kernel")
    what = p.counters[backward] if p else ("birnn_bwd" if backward
                                           else "birnn_fwd")
    if p and p.directions > len(ws):
        raise ValueError(f"{what} kernel: a plan of {p.directions} "
                         f"directions a launch for {len(ws)} W")
    n_sm = _checked(what, x, ws, thirds, h0)
    n_b, n_h = x.shape[1:]
    # the one plan a launch makes: its refusal is the check, also where
    # a plan was given
    own = plan(n_b, n_h, x.dtype, directions=len(ws), n_sm=n_sm, what=what)
    p = p or own
    if p.directions == len(ws):
        outs = _launch(p, backward, x, ws, thirds, reverse, clip, h0, lib)
        if outs is not None:
            return outs
        # the card holds fewer blocks at once than ``n_sm`` promised
        p = plan(n_b, n_h, x.dtype, n_sm=n_sm, what=what)
    return tuple(_launch(p, backward, x, ws[i:i + 1],
                         thirds[i:i + 1] if backward else thirds,
                         reverse != (i == 1), clip, h0, lib)[0]
                 for i in range(len(ws)))


def _launch(p: Plan, backward: bool, x: torch.Tensor, ws: Sequence,
            thirds: Sequence, reverse: bool, clip: float, h0, lib):
    """One launch of :func:`launch` for ``p.directions`` W in ``ws`` ->
    their outputs, or None where the card cannot hold a two-direction
    grid at once."""
    n_t, n_b, n_h = x.shape
    x = x.contiguous()
    ws = [wide_weights(w) if p.code == "wide" else w.contiguous()
          for w in ws]
    thirds = [t.contiguous() for t in thirds]
    h0 = None if h0 is None else h0.contiguous()
    outs = [torch.empty_like(x) for _ in ws]
    xbuf = torch.zeros((len(ws),) + exchange_shape(n_b, n_h), dtype=x.dtype,
                       device=x.device)
    count = torch.zeros((len(ws) * _COUNT_STRIDE,), dtype=torch.int32,
                        device=x.device)
    # B1 takes the shared lengths and h0 (null: a zero carry), B2 each
    # direction's states
    mid = ([ptr(thirds[0]), ptr(thirds[-1])] if backward else
           [ptr(thirds[0]), ctypes.c_void_p(None) if h0 is None else ptr(h0)])
    kernel = p.counter(backward)
    fn = getattr(lib or kernel.lib(),
                 "birnn_bwd_launch" if backward else "birnn_fwd_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    err = fn(ptr(x), ptr(ws[0]), ptr(ws[-1]), *mid, ptr(outs[0]),
             ptr(outs[-1]), ptr(xbuf), ptr(count), n_t, n_b, n_h,
             int(reverse), float(clip), int(x.dtype == torch.bfloat16),
             int(p.code == "wide"), p.directions, p.cols,
             stream_of(kernel.name, x, *ws, *thirds, h0, *outs, xbuf, count))
    if err == _COOP_TOO_LARGE and p.directions == 2:
        return None
    if err == _COOP_TOO_LARGE:
        raise NotImplementedError(
            f"{kernel.name} kernel: H={n_h} needs more co-resident blocks "
            "than the card holds at once")
    check(err, kernel.name)
    kernel.launches += 1
    return tuple(outs)


def _is_plain(p: Plan, x: torch.Tensor) -> bool:
    return p.code == "plain" if p else not x.is_cuda


def fwd_recurrence(z: torch.Tensor, ws: Sequence, lengths: torch.Tensor, *,
                   reverse: bool, clip: float, h0: torch.Tensor = None,
                   plan: Plan = None) -> tuple:
    """B1: the states of each direction in ``ws`` (W [H, H] each), z [T,
    B, H] in the io dtype shared, lengths [B] int, the first direction
    swept in ``reverse`` time order from h0 [B, H] (rounded to z's dtype;
    zero when None; one direction only), the second the other way -> a
    tuple of [T, B, H] in z's dtype.  Under ``plan`` (None: the plain
    loops for CPU tensors, else :func:`plan`'s on the card); a launch's ws
    must share z's dtype."""
    if _is_plain(plan, z):
        return tuple(fwd_recurrence_plain(z, w, lengths, reverse=rev,
                                          clip=clip, h0=h0)
                     for w, rev in zip(ws, (reverse, not reverse)))
    return launch(plan, False, z, ws, (lengths.to(torch.int32),),
                  reverse=reverse, clip=clip,
                  h0=None if h0 is None else h0.to(z.dtype))


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


def bwd_recurrence(g: torch.Tensor, hs: Sequence, wts: Sequence, *,
                   reverse: bool, clip: float, plan: Plan = None) -> tuple:
    """B2: the deltas of each direction over its stored forward states in
    ``hs`` with its W^T in ``wts`` [H, H], g [T, B, H] in the io dtype
    shared, the first direction swept in ``reverse`` time order, the
    second the other way -> a tuple of [T, B, H] in g's dtype.  Under
    ``plan`` as :func:`fwd_recurrence`."""
    for h in hs:
        if h.shape != g.shape or h.dtype != g.dtype:
            raise ValueError(f"birnn_bwd kernel: hs {tuple(h.shape)} "
                             f"{h.dtype} does not match g {tuple(g.shape)} "
                             f"{g.dtype}")
    if _is_plain(plan, g):
        return tuple(bwd_recurrence_plain(g, h, wt, reverse=rev, clip=clip)
                     for h, wt, rev in zip(hs, wts, (reverse, not reverse)))
    return launch(plan, True, g, wts, hs, reverse=reverse, clip=clip)


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
    dwb = h_next^T d_b with a zero state at the edge.  Both passes run
    under one plan: ``plan``, or None for :func:`plan_for`'s."""

    @staticmethod
    def forward(ctx, z, wf, wb, lengths, clip, cdt, io, bidirectional,
                plan):
        z_io = z.to(io)
        ws = (wf.to(cdt), wb.to(cdt)) if bidirectional else (wf.to(cdt),)
        plan = plan or plan_for(z_io, len(ws))
        hs_f, hs_b = (*fwd_recurrence(z_io, ws, lengths, reverse=False,
                                      clip=clip, plan=plan), None)[:2]
        out = hs_f.to(torch.float32)
        if bidirectional:
            out = out + hs_b.to(torch.float32)
        ctx.save_for_backward(hs_f, hs_b, wf, wb)
        ctx.opts = (clip, cdt, io, bidirectional, plan)
        return out

    @staticmethod
    def backward(ctx, g):
        hs_f, hs_b, wf, wb = ctx.saved_tensors
        clip, cdt, io, bidirectional, plan = ctx.opts
        g_io = g.to(io)
        zeros = torch.zeros_like(hs_f[:1])
        if bidirectional:
            hs, wts = (hs_f, hs_b), (wf.to(cdt).t(), wb.to(cdt).t())
        else:
            hs, wts = (hs_f,), (wf.to(cdt).t(),)
        d_f, d_b = (*bwd_recurrence(g_io, hs, wts, reverse=True, clip=clip,
                                    plan=plan), None)[:2]
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
                              PLAIN if plain else None)


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
    d, = bwd_recurrence(g.to(hs.dtype), (hs,), (wc.t(),),
                        reverse=not reverse, clip=clip,
                        plan=PLAIN if plain else None)
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
        h0_io = h0.to(io)
        hs, = fwd_recurrence(z.to(io), (w.to(cdt),), lengths,
                             reverse=reverse, clip=clip, h0=h0_io,
                             plan=PLAIN if plain else None)
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
