"""Segmented affine and max scans over operation chains."""
