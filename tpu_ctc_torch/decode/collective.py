"""Collective batched decoding over the ranks of a mesh.

Counterpart of ``tpu_ctc.decode.collective``.  The utterances of a batch
are split over the 'data' axis, each rank decodes its rows, and every rank
returns every hypothesis.  Two exchanges of decode state:

  * length-balanced redistribution (``redistribute=True``, beam mode,
    'data' > 1): before the search the log posteriors are dealt again so
    that each rank gets an equal sum of frame lengths, not just an equal
    count (the fused search, kernel B5/B6 on a card, skips padding frames,
    so a rank's time follows its real frames).  :func:`snake_assignment`
    deals the length-sorted utterances boustrophedon over the ranks, and
    :func:`_ring_redistribute` moves them in n - 1 hops of the original
    local block around the 'data' ring (``mesh.shift``), each rank keeping
    the rows dealt to it: a selection by index, exact, as the JAX one-hot
    product at HIGHEST precision is;
  * the final gather of the hypotheses and their lengths over 'data', then
    the inverse permutation of the deal.

There is no exchange during the search: an utterance's beams are
independent of the others'.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu_ctc_torch import resolve_device
from tpu_ctc_torch.decode.beam import make_beam_search
from tpu_ctc_torch.decode.greedy import collapse_ids
from tpu_ctc_torch.decode.lm import NGramCharLM
from tpu_ctc_torch.models import birnn
from tpu_ctc_torch.parallel.mesh import (AXIS_DATA, Mesh, gather_blocks,
                                        shard_batch, shift)


def snake_assignment(lengths, n_shards: int) -> torch.Tensor:
    """Length-balancing permutation: perm[j] = the utterance that decodes
    at dealt position j (positions [s b, (s + 1) b) on rank s).  Sorted by
    length, longest first (ties in index order), then dealt boustrophedon
    (rank 0 .. n-1, n-1 .. 0, ...): equal counts a rank and near-equal
    total lengths."""
    lengths = torch.as_tensor(np.asarray(lengths) if not torch.is_tensor(
        lengths) else lengths)
    b_total = lengths.shape[0]
    if b_total % n_shards:
        raise ValueError(f"snake_assignment: batch {b_total} not divisible "
                         f"by {n_shards} shards")
    per = b_total // n_shards
    order = torch.argsort(-lengths.to(torch.int64), stable=True)
    pos = torch.arange(b_total, device=lengths.device)
    rnd, col = pos // n_shards, pos % n_shards
    shard = torch.where(rnd % 2 == 0, col, n_shards - 1 - col)
    perm = torch.zeros(b_total, dtype=torch.int32, device=lengths.device)
    perm[shard * per + rnd] = order.to(torch.int32)
    return perm


def _ring_redistribute(log_probs: torch.Tensor, frame_lengths: torch.Tensor,
                       perm: torch.Tensor, mesh: Mesh):
    """This rank's rows of the ``perm`` deal: n - 1 hops of the original
    local block (and its lengths and row ids) around the 'data' ring, the
    rows dealt here copied out of each block that passes."""
    n, me = mesh.axis_size(AXIS_DATA), mesh.axis_index(AXIS_DATA)
    b_loc = log_probs.shape[0]
    my_ids = perm[me * b_loc:(me + 1) * b_loc].to(torch.int64)
    cur = log_probs
    cur_ids = me * b_loc + torch.arange(b_loc, device=log_probs.device)
    cur_lens = frame_lengths.to(torch.int64)
    out = torch.zeros_like(log_probs)
    out_lens = torch.zeros(b_loc, dtype=torch.int64, device=log_probs.device)
    for k in range(n):
        j = torch.nonzero(my_ids[:, None] == cur_ids[None, :])
        out[j[:, 0]] = cur[j[:, 1]]
        out_lens[j[:, 0]] = cur_lens[j[:, 1]]
        if k < n - 1:
            cur = shift(cur, mesh, AXIS_DATA, ring=True)
            cur_ids = shift(cur_ids, mesh, AXIS_DATA, ring=True)
            cur_lens = shift(cur_lens, mesh, AXIS_DATA, ring=True)
    return out, out_lens.to(torch.int32)


def make_collective_decoder(cfg, mesh: Mesh, lm: Optional[NGramCharLM] = None,
                            nlm_params=None, use_beam: bool = True,
                            max_len: int = 128, redistribute: bool = True,
                            device=None):
    """Build a (model, batch) -> (hyps, lens) decoder on ``mesh``.

    ``batch`` is the global batch (numpy arrays or tensors: ``feats``,
    ``frame_mask``, ``frame_lengths``); each rank decodes its block of
    rows over 'data' on ``device`` (default ``cuda``) and every rank
    returns the whole batch's hypotheses [B, max_len] (greedy: [B, T])
    and lengths [B], int32.  The search is ``decode.beam``'s
    (``make_beam_search``: kernel B5/B6 on a card, which raises for what
    they do not take, the plain search on the CPU); without ``use_beam``
    the greedy best path.  With ``redistribute`` (beam mode, 'data' > 1)
    the utterances are length-balanced over the ranks before the search.
    ``decode.from_posteriors(log_probs, frame_lengths, frame_mask)`` runs
    the same decode from this rank's rows' log posteriors.
    """
    dev = resolve_device(device)
    n_data = mesh.shape.get(AXIS_DATA, 1)
    search = make_beam_search(cfg, lm, nlm_params, dev) if use_beam else None
    do_redist = redistribute and use_beam and n_data > 1
    specs = {k: (AXIS_DATA,) for k in ("feats", "frame_mask",
                                       "frame_lengths")}

    @torch.no_grad()
    def from_posteriors(log_probs, frame_lengths, frame_mask):
        """The decode of this rank's rows from their log posteriors."""
        frame_lengths = frame_lengths.to(torch.int32)
        perm = None
        if use_beam:
            if do_redist:
                lens_g = gather_blocks(mesh, frame_lengths, AXIS_DATA, 0)
                perm = snake_assignment(lens_g, n_data)
                log_probs, frame_lengths = _ring_redistribute(
                    log_probs, frame_lengths, perm, mesh)
            hyps, lens, _ = search(log_probs, frame_lengths, max_len)
        else:
            ids = torch.argmax(log_probs, dim=-1).to(torch.int32)
            hyps, lens = collapse_ids(ids, frame_mask)
        hyps = gather_blocks(mesh, hyps.to(torch.int32), AXIS_DATA, 0)
        lens = gather_blocks(mesh, lens.to(torch.int32), AXIS_DATA, 0)
        if perm is not None:
            # dealt position j holds utterance perm[j]
            inv = torch.argsort(perm.to(torch.int64))
            hyps, lens = hyps[inv], lens[inv]
        return hyps, lens

    @torch.no_grad()
    def decode(model, batch):
        whole = {k: torch.as_tensor(np.asarray(batch[k]) if not
                                    torch.is_tensor(batch[k]) else batch[k],
                                    device=dev) for k in specs}
        local = shard_batch(mesh, whole, specs)
        log_probs = birnn.log_posteriors(model, cfg.model, local["feats"],
                                         local["frame_mask"])
        return from_posteriors(log_probs, local["frame_lengths"],
                               local["frame_mask"])

    decode.from_posteriors = from_posteriors
    return decode
