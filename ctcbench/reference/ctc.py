"""CTC from its definition (Graves et al. 2006): the forward recursion over
the blank-extended label in log space, batched in torch and
differentiable by autograd."""
from __future__ import annotations

import torch

NEG = -1e30


def _lse(*xs):
    m = xs[0]
    for x in xs[1:]:
        m = torch.maximum(m, x)
    m = m.detach()
    return m + torch.log(sum(torch.exp(x - m) for x in xs))


def nll(log_probs: torch.Tensor, labels: torch.Tensor,
        frame_lengths: torch.Tensor, label_lengths: torch.Tensor,
        blank: int = 0) -> torch.Tensor:
    """-log p(labels | x) per utterance, [B]: log_probs [B, T, A], labels
    [B, L] (valid up to label_lengths), lengths [B]."""
    n_b, n_t, _ = log_probs.shape
    dev = log_probs.device
    n_l = labels.shape[1]
    s_max = 2 * n_l + 1
    ext = torch.full((n_b, s_max), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels.to(torch.int64)
    s_len = 2 * label_lengths.to(torch.int64) + 1
    pos = torch.arange(s_max, device=dev)
    valid = pos[None, :] < s_len[:, None]
    prev2 = torch.cat([torch.full((n_b, 2), -1, dtype=torch.int64,
                                  device=dev), ext[:, :-2]], dim=1)
    skip = (ext != blank) & (ext != prev2) & (pos[None, :] >= 2)
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(n_b, n_t, s_max))
    neg = torch.full((n_b, s_max), NEG, device=dev, dtype=log_probs.dtype)
    alpha = torch.where(pos[None, :] < 2, emit[:, 0], neg)
    alpha = torch.where(valid, alpha, neg)
    f_len = frame_lengths.to(torch.int64).to(dev)
    for t in range(1, int(f_len.max())):
        a1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        a2 = torch.where(skip, torch.cat([neg[:, :2], alpha[:, :-2]], dim=1),
                         neg)
        new = _lse(alpha, a1, a2) + emit[:, t]
        new = torch.where(valid, new, neg)
        alpha = torch.where((t < f_len)[:, None], new, alpha)
    last = torch.gather(alpha, 1, (s_len - 1)[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, (s_len - 2).clamp_min(0)[:, None])[:, 0]
    return -_lse(last, last2)
