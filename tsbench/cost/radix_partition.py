"""The radix partition's work, frozen from the port's
``kernels/radix_partition/ops.py`` ``cost``.

One call over ``batches`` rows of ``n`` int32 keys in ``n_buckets``
buckets reads each key once and writes each rank and each batch's counts
once (4 bytes each), one operation a key.
"""


def cost(batches: int, n: int, n_buckets: int):
    """(bytes, operations) of one call on keys [batches, n]."""
    return 4.0 * (2 * batches * n + batches * n_buckets), float(batches * n)
