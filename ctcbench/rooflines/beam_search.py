"""B5/B6, the prefix beam search with a char n-gram LM: each live frame
of an utterance scores K A candidates (a beam extended by every char, or
kept): a log-sum-exp of two terms, the LM row and beta added, the prune
test, and one comparison towards the top K: 10 float operations each.
Bytes: the frame's A log posteriors, the LM table once, each hypothesis
written once (``max_len`` int32 a row).  The operations bind."""

OPS_PER_CANDIDATE = 10


def cost(frames: int, rows: int, beam: int, vocab: int, order: int,
         max_len: int):
    flops = OPS_PER_CANDIDATE * float(frames) * beam * vocab
    nbytes = 4.0 * (frames * vocab + vocab ** order + rows * max_len)
    return flops, nbytes
