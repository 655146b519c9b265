"""B3, the CTC forward recursion: alpha over ``cells`` = sum of T (2L + 1)
lattice cells, each a log-sum-exp of up to three predecessors plus the
emission (12 float operations).  Bytes: the emissions the lattice needs,
sum of T (L + 1) float32 (a label's chars and the blank a frame), read
once, and alpha written once.  The bytes bind."""

OPS_PER_CELL = 12


def cost(cells: int, emit: int):
    return OPS_PER_CELL * float(cells), 4.0 * (emit + cells)
