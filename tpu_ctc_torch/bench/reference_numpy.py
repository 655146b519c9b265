"""Faithful numpy re-implementation of the reference's CPU training path.

A copy of ``tpu_ctc.bench.reference_numpy`` (numpy only), kept in the port
so that the port's benches need nothing of the JAX package.

This module re-creates, in plain numpy, the computational structure the
reference used (SURVEY.md §3.1): per-utterance processing, a Python loop
over time steps for the bidirectional recurrences, hand-written backprop,
and the probability-space CTC forward-backward with per-frame rescaling of
``ctc/ctc.py`` (SURVEY.md C1, §3.2).  It serves two purposes:

  1. **Benchmark baseline** — BASELINE.md's throughput target is "≥10x
     audio-seconds/s per chip vs CPU reference"; this is that CPU
     reference, measured in-repo on the same synthetic workload.
  2. **Independent oracle** — a second implementation of the same math
     (model forward, CTC loss/grad) for cross-checking the PyTorch stack.

It intentionally keeps the reference's *algorithmic shape* (per-utterance,
sequential time loop, CPU) while using numpy BLAS for the matmuls — i.e. it
is a *generous* baseline: the 2014 gnumpy/cudamat original had the same
loop structure with slower kernels and host↔device copies.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def clipped_relu(x, clip=20.0):
    return np.minimum(np.maximum(x, 0.0), clip)


def d_clipped_relu(pre, clip=20.0):
    return ((pre > 0.0) & (pre < clip)).astype(pre.dtype)


def softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def ctc_loss_numpy(probs: np.ndarray, labels: np.ndarray, blank: int = 0
                   ) -> Tuple[float, np.ndarray]:
    """Probability-space CTC with per-frame rescaling (SURVEY.md C1/§3.2).

    probs: [A, T] column-stochastic posteriors.  labels: [L] (no blanks).
    Returns (negative log-likelihood, gradient w.r.t. the softmax *inputs*
    [A, T]) — the same interface as the reference's ``ctc_loss``.
    """
    a, t = probs.shape
    l = len(labels)
    s = 2 * l + 1
    ext = np.full(s, blank, dtype=np.int64)
    ext[1::2] = labels

    alpha = np.zeros((s, t))
    beta = np.zeros((s, t))
    scale = np.zeros(t)

    alpha[0, 0] = probs[blank, 0]
    if s > 1:
        alpha[1, 0] = probs[ext[1], 0]
    scale[0] = alpha[:, 0].sum() or 1e-30
    alpha[:, 0] /= scale[0]
    for ti in range(1, t):
        for si in range(s):
            v = alpha[si, ti - 1]
            if si >= 1:
                v += alpha[si - 1, ti - 1]
            if si >= 2 and ext[si] != blank and ext[si] != ext[si - 2]:
                v += alpha[si - 2, ti - 1]
            alpha[si, ti] = v * probs[ext[si], ti]
        scale[ti] = alpha[:, ti].sum() or 1e-30
        alpha[:, ti] /= scale[ti]

    final = alpha[s - 1, t - 1] + (alpha[s - 2, t - 1] if s > 1 else 0.0)
    nll = -float(np.log(scale).sum() + np.log(final or 1e-300))

    beta[s - 1, t - 1] = 1.0
    if s > 1:
        beta[s - 2, t - 1] = 1.0
    beta[:, t - 1] /= scale[t - 1]
    for ti in range(t - 2, -1, -1):
        for si in range(s - 1, -1, -1):
            v = beta[si, ti + 1] * probs[ext[si], ti + 1]
            if si + 1 < s:
                v += beta[si + 1, ti + 1] * probs[ext[si + 1], ti + 1]
            if (si + 2 < s and ext[si + 2] != blank
                    and ext[si + 2] != ext[si]):
                v += beta[si + 2, ti + 1] * probs[ext[si + 2], ti + 1]
            beta[si, ti] = v
        beta[:, ti] /= scale[ti]

    # gamma (occupancy per class), then grad wrt softmax inputs = p - gamma'.
    ab = alpha * beta
    occupancy = np.zeros((a, t))
    for si in range(s):
        occupancy[ext[si]] += ab[si]
    # alpha_t*beta_t sums (over s) to P(l|x)/scale-normalized const per t;
    # normalize per frame so grad = p - occupancy/sum_t.
    denom = ab.sum(axis=0)
    denom = np.where(denom <= 0, 1e-30, denom)
    grad = probs - occupancy / denom
    return nll, grad


class ReferenceBRNN:
    """Per-utterance deep BRNN with hand-written backprop (SURVEY.md C4).

    Same architecture family as :mod:`tpu_ctc_torch.models.birnn`: pre FF layers →
    bidirectional layers (shared input projection, summed directions) →
    output affine, all clipped-ReLU.
    """

    def __init__(self, input_dim, hidden_dim, vocab_size, num_pre=1,
                 num_bi=1, clip=20.0, init_scale=0.01, seed=0):
        rng = np.random.RandomState(seed)
        self.clip = clip
        self.pre: List[Dict] = []
        d = input_dim
        for _ in range(num_pre):
            self.pre.append({"w": init_scale * rng.randn(d, hidden_dim),
                             "b": np.zeros(hidden_dim)})
            d = hidden_dim
        self.bi: List[Dict] = []
        for _ in range(num_bi):
            self.bi.append({
                "w": init_scale * rng.randn(d, hidden_dim),
                "b": np.zeros(hidden_dim),
                "wf": init_scale * rng.randn(hidden_dim, hidden_dim),
                "wb": init_scale * rng.randn(hidden_dim, hidden_dim)})
            d = hidden_dim
        self.out = {"w": init_scale * rng.randn(d, vocab_size),
                    "b": np.zeros(vocab_size)}

    def cost_and_grad(self, feats: np.ndarray, labels: np.ndarray):
        """feats [T, D], labels [L] → (nll, grads dict-tree).

        Mirrors the reference's ``costAndGrad`` (SURVEY.md §3.1): forward
        with Python loop over t, CTC on the posteriors, hand-written
        backward pass through the stack.
        """
        clip = self.clip
        t = feats.shape[0]
        # ---- forward ----
        acts = [feats]
        pre_caches = []
        x = feats
        for layer in self.pre:
            pre = x @ layer["w"] + layer["b"]
            x = clipped_relu(pre, clip)
            pre_caches.append(pre)
            acts.append(x)
        bi_caches = []
        for layer in self.bi:
            z = x @ layer["w"] + layer["b"]
            h = x.shape[1] if x.ndim > 1 else len(layer["b"])
            hdim = layer["wf"].shape[0]
            f = np.zeros((t, hdim))
            pf = np.zeros((t, hdim))
            for ti in range(t):          # the reference's inner HOT LOOP
                prev = f[ti - 1] if ti > 0 else np.zeros(hdim)
                pf[ti] = z[ti] + prev @ layer["wf"]
                f[ti] = clipped_relu(pf[ti], clip)
            bwd = np.zeros((t, hdim))
            pb = np.zeros((t, hdim))
            for ti in range(t - 1, -1, -1):
                nxt = bwd[ti + 1] if ti < t - 1 else np.zeros(hdim)
                pb[ti] = z[ti] + nxt @ layer["wb"]
                bwd[ti] = clipped_relu(pb[ti], clip)
            bi_caches.append({"x": x, "z": z, "f": f, "pf": pf,
                              "bwd": bwd, "pb": pb})
            x = f + bwd
            acts.append(x)
        logits = x @ self.out["w"] + self.out["b"]
        probs = softmax(logits, axis=1)          # [T, A]

        nll, dlogits_at = ctc_loss_numpy(probs.T, labels)
        dlogits = dlogits_at.T                   # [T, A]

        # ---- backward ----
        grads = {"pre": [], "bi": [], "out": {}}
        x_in = acts[-1]
        grads["out"]["w"] = x_in.T @ dlogits
        grads["out"]["b"] = dlogits.sum(axis=0)
        dx = dlogits @ self.out["w"].T

        for li in range(len(self.bi) - 1, -1, -1):
            layer, cache = self.bi[li], bi_caches[li]
            dz = np.zeros_like(cache["z"])
            dwf = np.zeros_like(layer["wf"])
            dwb = np.zeros_like(layer["wb"])
            # forward-direction recurrence backprop (reverse time)
            carry = np.zeros(layer["wf"].shape[0])
            for ti in range(t - 1, -1, -1):
                g = (dx[ti] + carry) * d_clipped_relu(cache["pf"][ti], clip)
                prev = cache["f"][ti - 1] if ti > 0 else None
                if prev is not None:
                    dwf += np.outer(prev, g)
                dz[ti] += g
                carry = g @ layer["wf"].T
            # backward-direction recurrence backprop (forward time)
            carry = np.zeros(layer["wb"].shape[0])
            for ti in range(t):
                g = (dx[ti] + carry) * d_clipped_relu(cache["pb"][ti], clip)
                nxt = cache["bwd"][ti + 1] if ti < t - 1 else None
                if nxt is not None:
                    dwb += np.outer(nxt, g)
                dz[ti] += g
                carry = g @ layer["wb"].T
            grads["bi"].insert(0, {
                "w": cache["x"].T @ dz, "b": dz.sum(axis=0),
                "wf": dwf, "wb": dwb})
            dx = dz @ layer["w"].T

        for li in range(len(self.pre) - 1, -1, -1):
            layer = self.pre[li]
            pre = pre_caches[li]
            g = dx * d_clipped_relu(pre, clip)
            x_in = acts[li]
            grads["pre"].insert(0, {"w": x_in.T @ g, "b": g.sum(axis=0)})
            dx = g @ layer["w"].T

        return nll, grads

    def sgd_step(self, grads, lr=1e-2, momentum=0.95, velocity=None):
        """Reference-style momentum update (SURVEY.md C5)."""
        if velocity is None:
            velocity = self._zeros_like_params()
        for p, g, v in self._iter(grads, velocity):
            v *= momentum
            v += g
            p -= lr * v
        return velocity

    def _zeros_like_params(self):
        z = {"pre": [{k: np.zeros_like(v) for k, v in l.items()}
                     for l in self.pre],
             "bi": [{k: np.zeros_like(v) for k, v in l.items()}
                    for l in self.bi],
             "out": {k: np.zeros_like(v) for k, v in self.out.items()}}
        return z

    def _iter(self, grads, velocity):
        for i, l in enumerate(self.pre):
            for k in l:
                yield l[k], grads["pre"][i][k], velocity["pre"][i][k]
        for i, l in enumerate(self.bi):
            for k in ("w", "b", "wf", "wb"):
                yield l[k], grads["bi"][i][k], velocity["bi"][i][k]
        for k in self.out:
            yield self.out[k], grads["out"][k], velocity["out"][k]

    def forward(self, feats: np.ndarray) -> np.ndarray:
        """Posterior-only forward for decoding parity tests."""
        x = feats
        t = feats.shape[0]
        for layer in self.pre:
            x = clipped_relu(x @ layer["w"] + layer["b"], self.clip)
        for layer in self.bi:
            z = x @ layer["w"] + layer["b"]
            hdim = layer["wf"].shape[0]
            f = np.zeros((t, hdim))
            for ti in range(t):
                prev = f[ti - 1] if ti > 0 else np.zeros(hdim)
                f[ti] = clipped_relu(z[ti] + prev @ layer["wf"], self.clip)
            bwd = np.zeros((t, hdim))
            for ti in range(t - 1, -1, -1):
                nxt = bwd[ti + 1] if ti < t - 1 else np.zeros(hdim)
                bwd[ti] = clipped_relu(z[ti] + nxt @ layer["wb"], self.clip)
            x = f + bwd
        return softmax(x @ self.out["w"] + self.out["b"], axis=1)
