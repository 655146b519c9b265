"""Neural character language model (Maas et al. NAACL'15 variant): a GRU
over character embeddings, trained on the transcripts and scored inside the
beam search beside the n-gram LM.

Counterpart of ``tpu_ctc.decode.neural_lm``.  The parameters keep the JAX
package's names and layouts (``embed`` [V, E]; ``wz``, ``wr``, ``wh``
[E + H, H], input rows first, with ``bz``, ``br``, ``bh`` [H]; ``wo`` [H, V],
``bo`` [V]), so :func:`params_from_jax` carries a JAX model over as it is.
During decoding every beam carries its GRU state [H], stepped only when its
prefix is extended (``decode/beam.py`` and kernels B5/B6).

Every forward matrix product runs in full f32 (``matmul_f32`` switches
TF32 off on a card), as the JAX package's do; training's backward products
follow PyTorch's setting, off by default.  :class:`CharRNNLMHost` scores
one prefix at a time from scratch, the oracle of
``decode.beam.prefix_beam_search_host``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu_ctc_torch import resolve_device
from tpu_ctc_torch.ops.birnn_cuda import matmul_f32

BOS = 0  # context id before the first character (shares the blank id slot)
_NAMES = ("embed", "wz", "bz", "wr", "br", "wh", "bh", "wo", "bo")


@dataclasses.dataclass
class CharRNNLMConfig:
    vocab_size: int = 29
    embed_dim: int = 64
    hidden_dim: int = 128


class CharRNNLM(nn.Module):
    """The GRU char LM's parameters, under the JAX package's names (zeros
    until :func:`init_params` or :func:`params_from_jax` fills them)."""

    def __init__(self, cfg: CharRNNLMConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        v, e, h = cfg.vocab_size, cfg.embed_dim, cfg.hidden_dim
        shapes = {"embed": (v, e), "wz": (e + h, h), "bz": (h,),
                  "wr": (e + h, h), "br": (h,), "wh": (e + h, h), "bh": (h,),
                  "wo": (h, v), "bo": (v,)}
        for name in _NAMES:
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shapes[name], dtype=torch.float32, device=dev)))


def init_params(cfg: CharRNNLMConfig, seed: int = 0,
                device=None) -> CharRNNLM:
    """Weights 0.08 N(0, 1) from ``torch.Generator().manual_seed(seed)`` (in
    the order embed, wz, wr, wh, wo), biases 0, as ``neural_lm.init_params``
    draws them from its JAX key."""
    model = CharRNNLM(cfg, device=device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in ("embed", "wz", "wr", "wh", "wo"):
            p = getattr(model, name)
            p.copy_(0.08 * torch.randn(p.shape, generator=gen))
    return model


def params_from_jax(params: Dict, device=None) -> CharRNNLM:
    """A JAX ``neural_lm`` parameter dict (numpy or array values) as a
    :class:`CharRNNLM`, bit for bit."""
    arrays = {k: np.array(params[k], np.float32) for k in _NAMES}
    v, e = arrays["embed"].shape
    cfg = CharRNNLMConfig(vocab_size=v, embed_dim=e,
                          hidden_dim=arrays["bz"].shape[0])
    model = CharRNNLM(cfg, device=device)
    with torch.no_grad():
        for name, arr in arrays.items():
            p = getattr(model, name)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return model


def gru_step(lm: CharRNNLM, h: torch.Tensor,
             x_ids: torch.Tensor) -> torch.Tensor:
    """One GRU step.  h: [..., H]; x_ids: [...] int char ids."""
    x = lm.embed[x_ids]                                  # [..., E]
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(matmul_f32(xh, lm.wz) + lm.bz)
    r = torch.sigmoid(matmul_f32(xh, lm.wr) + lm.br)
    xh_r = torch.cat([x, r * h], dim=-1)
    cand = torch.tanh(matmul_f32(xh_r, lm.wh) + lm.bh)
    return (1.0 - z) * h + z * cand


def logits(lm: CharRNNLM, h: torch.Tensor) -> torch.Tensor:
    return matmul_f32(h, lm.wo) + lm.bo


def log_probs(lm: CharRNNLM, h: torch.Tensor,
              blank_id: int = 0) -> torch.Tensor:
    """log P(next char | state), with the blank/BOS slot masked out."""
    lg = logits(lm, h)
    chars = torch.arange(lg.shape[-1], device=lg.device)
    mask = torch.where(chars == blank_id, -1e30, 0.0).to(lg.dtype)
    return torch.log_softmax(lg + mask, dim=-1)


def init_state(lm: CharRNNLM, batch_shape=()) -> torch.Tensor:
    """Decode-time initial state: ONE BOS step from zeros, the state from
    which :func:`sequence_nll` predicts the first character in training."""
    n_h = lm.bz.shape[0]
    h_bos = gru_step(lm, torch.zeros(n_h, device=lm.bz.device),
                     torch.tensor(BOS, device=lm.bz.device))
    return h_bos.expand(*tuple(batch_shape), n_h)


def sequence_nll(lm: CharRNNLM, seqs: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Mean per-char NLL of [B, L] zero-padded char sequences."""
    n_b, n_l = seqs.shape
    seqs = seqs.to(torch.int64)
    # inputs: BOS, c1, ..., c_{L-1}; targets: c1..cL; the zero start's first
    # input is the BOS token, so the first prediction comes from the state
    # that init_state gives the decoders
    inputs = torch.nn.functional.pad(seqs, (1, 0))[:, :n_l]
    h = torch.zeros((n_b, lm.bz.shape[0]), device=seqs.device)
    nlls = []
    for t in range(n_l):
        h = gru_step(lm, h, inputs[:, t])
        lp = log_probs(lm, h)
        nlls.append(-lp.gather(1, seqs[:, t:t + 1])[:, 0])
    nll = torch.stack(nlls, dim=1)                       # [B, L]
    mask = (torch.arange(n_l, device=seqs.device)[None, :]
            < lengths.to(seqs.device)[:, None]).to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def adam_update(lm: CharRNNLM, opt: torch.optim.Optimizer,
                seqs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One training step: the NLL's gradient and one ``opt`` update (Adam
    equals ``optax.adam``'s in exact arithmetic); returns the NLL before
    the update."""
    opt.zero_grad(set_to_none=True)
    nll = sequence_nll(lm, seqs, lengths)
    nll.backward()
    opt.step()
    return nll.detach()


def pad_label_seqs(label_seqs: List[np.ndarray], max_len: int = 64
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """[N, max_len] int32 zero-padded (cut) sequences and their lengths."""
    padded = np.zeros((len(label_seqs), max_len), np.int32)
    lens = np.zeros(len(label_seqs), np.int32)
    for i, s in enumerate(label_seqs):
        s = np.asarray(s, np.int32)[:max_len]
        padded[i, :len(s)] = s
        lens[i] = len(s)
    return padded, lens


def train_char_rnn_lm(label_seqs: List[np.ndarray], cfg: CharRNNLMConfig,
                      steps: int = 500, batch_size: int = 32,
                      lr: float = 3e-3, seed: int = 0, max_len: int = 64,
                      device=None) -> Tuple[CharRNNLM, float]:
    """Train the GRU char LM on label id sequences with Adam; returns
    (model, the NLL of the last step's batch).  The batches are drawn from
    ``np.random.RandomState(seed)`` as the JAX package draws them."""
    rng = np.random.RandomState(seed)
    padded, lens = pad_label_seqs(label_seqs, max_len)
    model = init_params(cfg, seed, device=device)
    dev = model.bz.device
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    nll = torch.zeros(())
    for _ in range(steps):
        idx = rng.randint(0, len(label_seqs), batch_size)
        nll = adam_update(model, opt, torch.from_numpy(padded[idx]).to(dev),
                          torch.from_numpy(lens[idx]).to(dev))
    return model, float(nll)


def train_nlm_from_data(dataset, cfg, device=None) -> Optional[CharRNNLM]:
    """The decode config's GRU char LM trained on a dataset's transcripts
    (the neural analogue of ``lm.train_char_lm_from_data``), or None when
    ``cfg.decode.neural_lm`` is off."""
    if not getattr(cfg.decode, "neural_lm", False):
        return None
    from tpu_ctc_torch.decode.lm import label_seqs_of
    nl_cfg = CharRNNLMConfig(vocab_size=cfg.model.vocab_size,
                             embed_dim=cfg.decode.neural_lm_embed,
                             hidden_dim=cfg.decode.neural_lm_hidden)
    model, _ = train_char_rnn_lm(label_seqs_of(dataset), nl_cfg,
                                 steps=cfg.decode.neural_lm_steps,
                                 device=device)
    return model


class CharRNNLMHost:
    """Host-side adapter exposing ``score_host`` like ``NGramCharLM``: the
    GRU rerun over the whole prefix for every score, on a CPU copy."""

    def __init__(self, lm: CharRNNLM):
        self.lm = CharRNNLM(lm.cfg, device="cpu")
        self.lm.load_state_dict({k: v.detach().cpu()
                                 for k, v in lm.state_dict().items()})

    @torch.no_grad()
    def score_host(self, history, c: int) -> float:
        h = init_state(self.lm)
        for ch in history:
            h = gru_step(self.lm, h, torch.tensor(int(ch)))
        return float(log_probs(self.lm, h)[int(c)])
