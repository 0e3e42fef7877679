"""The affine segmented scan's work, frozen from the port's
``kernels/segscan/ops.py`` ``cost(x, "affine")``.

One scan over ``rows`` rows of ``lanes`` float32 lanes reads the flags (one
byte a row) and two coefficient operands and writes two scans, each byte
once, and spends 3 operations a row and lane composing affine pairs.
``rows`` comes from the cell's inputs: every access of every event is one
row of the stream's scan.
"""


def cost(rows: int, lanes: int):
    """(bytes, operations) of one affine scan of ``rows`` x ``lanes``."""
    return rows + 16.0 * rows * lanes, 3.0 * rows * lanes
