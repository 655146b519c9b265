"""B4, the CTC backward recursion: beta over the same ``cells`` as B3,
the same 12 operations a cell; the emissions read once and beta written
once.  The bytes bind."""

OPS_PER_CELL = 12


def cost(cells: int, emit: int):
    return OPS_PER_CELL * float(cells), 4.0 * (emit + cells)
