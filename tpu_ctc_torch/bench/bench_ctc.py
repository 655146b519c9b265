"""CTC micro-benchmark: the kernel path (B3/B4) against the plain loop and
the library's ``F.ctc_loss``, forward and forward + backward.

Counterpart of ``tpu_ctc.bench.bench_ctc``.  The loss runs through
``losses/ctc.py`` (``impl="auto"``: kernels B3 and B4 on a card, in
``ops/ctc_cuda.CtcDp``), against the plain ``losses/ctc_ref.py`` (autograd
through a loop over T) and ``torch.nn.functional.ctc_loss``, which
computes the same function and is B3/B4's yardstick in ``PERF.md``.  The
defaults B = 32, T = 1600, L = 120 give S = 241 lattice states, which
``ctc_alpha_kernel<256>`` takes.  The DP is mostly log-sum-exp, so the
result is lattice cells/s (and, on stderr, a TFLOP/s equivalent).

Times on a card are device times (:mod:`tpu_ctc_torch.utils.devtime`):
each function's device events, and B3's and B4's own kernels inside the
kernel path's forward + backward.  ``--device cpu`` times with the host
clock instead, as a functional check; its unit says so.  The kernel
path's NLL is held to the plain loop's within rtol 1e-3 before anything
is timed.  The TPU's lane packing (``--force-q`` of the JAX bench) has no
counterpart here.

Prints ONE JSON line {"metric": "ctc_grad_cells_per_s", ...}.

Run: python -m tpu_ctc_torch.bench.bench_ctc [--batch 32 --frames 1600 --labels 120]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

FLOPS_PER_CELL = 10.0  # lse3: 3 exp + log + adds (counting transcendentals as 1)
B3_KERNEL = r"ctc_alpha_kernel"
B4_KERNEL = r"ctc_beta_kernel"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def wall_ms(fn, *args, iters: int = 10) -> float:
    """Mean host time of ``fn(*args)`` in ms after one warm-up call (the
    CPU's stand-in for :func:`..utils.devtime.device_time_ms`)."""
    fn(*args)
    t0 = time.time()
    for _ in range(iters):
        fn(*args)
    return (time.time() - t0) / iters * 1e3


def inputs(batch=32, frames=1600, labels=120, vocab=29, device="cuda"):
    """The bench's seeded (logits [B, T, A], labels [B, L], frame lengths,
    label lengths) on ``device``: every utterance T frames, L labels."""
    rng = np.random.RandomState(0)
    logits = torch.as_tensor(rng.randn(batch, frames, vocab).astype(
        np.float32), device=device)
    labs = torch.as_tensor(rng.randint(1, vocab, (batch, labels)).astype(
        np.int32), device=device)
    tl = torch.full((batch,), frames, dtype=torch.int32, device=device)
    ll = torch.full((batch,), labels, dtype=torch.int32, device=device)
    return logits, labs, tl, ll


def run(batch=32, frames=1600, labels=120, vocab=29, iters=10,
        device="cuda"):
    """Time the forward and forward + backward of the kernel path, the
    plain loop and ``F.ctc_loss`` on :func:`inputs`; returns ({name: ms},
    lattice cells).  On a card the names also include ``b3`` and ``b4``:
    their kernels' device ms a call of the kernel path's forward +
    backward."""
    from tpu_ctc_torch import resolve_device
    from tpu_ctc_torch.losses import ctc, ctc_ref
    from tpu_ctc_torch.utils.devtime import device_time_ms

    dev = resolve_device(device)
    logits, labs, tl, ll = inputs(batch, frames, labels, vocab, dev)
    cells = batch * frames * (2 * labels + 1)

    def kernel_loss(x):
        return ctc.ctc_loss(x, labs, tl, ll, impl="auto")

    def plain_loss(x):
        return ctc_ref.ctc_loss(x, labs, tl, ll)

    def library_loss(x):
        lp = torch.log_softmax(x.to(torch.float32), dim=-1)
        return F.ctc_loss(lp.transpose(0, 1), labs, tl, ll, blank=0,
                          reduction="none")

    def fwd(loss):
        def f(x):
            with torch.no_grad():
                return loss(x)
        return f

    def grad(loss):
        def g(x):
            x = x.detach().requires_grad_(True)
            return torch.autograd.grad(loss(x).sum(), x)[0]
        return g

    # correctness spot-check before timing
    np.testing.assert_allclose(fwd(kernel_loss)(logits).cpu().numpy(),
                               fwd(plain_loss)(logits).cpu().numpy(),
                               rtol=1e-3)

    timer = device_time_ms if dev.type == "cuda" else wall_ms
    results = {}
    for name, fn in [("fwd_plain", fwd(plain_loss)),
                     ("fwd_kernel", fwd(kernel_loss)),
                     ("fwd_library", fwd(library_loss)),
                     ("grad_plain", grad(plain_loss)),
                     ("grad_kernel", grad(kernel_loss)),
                     ("grad_library", grad(library_loss))]:
        # the plain loop takes fewer iterations to bound the trace's size
        n = max(2, iters // 3) if name.endswith("plain") else iters
        ms = timer(fn, logits, iters=n)
        results[name] = ms
        log(f"[ctc-bench] {name:12s} {ms:8.3f} ms  "
            f"{cells / ms / 1e6:7.2f} Gcells/s  "
            f"{cells * FLOPS_PER_CELL / ms / 1e9:6.3f} TFLOP/s-equiv")
    if dev.type == "cuda":
        for name, pattern in (("b3", B3_KERNEL), ("b4", B4_KERNEL)):
            results[name] = device_time_ms(grad(kernel_loss), logits,
                                           iters=iters, kernel=pattern)
        log(f"[ctc-bench] in the kernel path's forward + backward: B3 "
            f"{results['b3']:.4f} ms, B4 {results['b4']:.4f} ms a call")
    log(f"[ctc-bench] fwd speedup over plain "
        f"{results['fwd_plain'] / results['fwd_kernel']:.2f}x, over the "
        f"library {results['fwd_library'] / results['fwd_kernel']:.2f}x; "
        f"grad speedup over plain "
        f"{results['grad_plain'] / results['grad_kernel']:.2f}x, over the "
        f"library {results['grad_library'] / results['grad_kernel']:.2f}x")
    return results, cells


def report(results, cells, device) -> dict:
    """The JSON line of a :func:`run`."""
    on_card = torch.device(device).type == "cuda"
    return {
        "metric": "ctc_grad_cells_per_s",
        "value": round(cells / results["grad_kernel"] / 1e6, 3),
        "unit": "Gcells/s" if on_card else "Gcells/s (cpu wall clock)",
        "vs_baseline": round(results["grad_plain"] / results["grad_kernel"],
                             3),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--frames", type=int, default=1600)
    p.add_argument("--labels", type=int, default=120)
    p.add_argument("--vocab", type=int, default=29)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    results, cells = run(args.batch, args.frames, args.labels, args.vocab,
                         args.iters, device=args.device)
    print(json.dumps(report(results, cells, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
