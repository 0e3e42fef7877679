"""Bounds of the restructure ladder (reference: ``repro/kernels/autotune.py``).

Only what the slice reads: the counting-partition bounds of the "auto" rung
(``LADDER_BOUNDS``) and the megakernel's auto band (``MEGA_BOUNDS``), both
the reference's "cpu" row.  Every device reads them, the H100 included, so
the rung choice is the reference's on the CPU; on the card the megakernel
rung also needs each interval to fit its block's shared memory
(``core/restructure.megakernel_fits``), which the band's intervals never
do.  At the main path's shapes
(GS 5,000 rows over 10,001 buckets, TP 2,000 over 201) "auto" therefore
takes the packed-sort rung on the card and launches neither the radix
kernel nor the megakernel; only ``restructure_method="partition"`` or
``"megakernel"`` reaches them.  Hopper rows, and a search over block
parameters, wait until they are measured on the card.
"""
from __future__ import annotations

# (max_buckets, min_rows): "auto" takes the partition rung when the key space
# is at most max_buckets and the batch at least min_rows.
LADDER_BOUNDS = (16, 1 << 18)

# The megakernel's auto band: at least min_rows rows per interval and at most
# max_buckets slots (pad included).
MEGA_BOUNDS = dict(min_rows=1 << 15, max_buckets=1 << 14)
