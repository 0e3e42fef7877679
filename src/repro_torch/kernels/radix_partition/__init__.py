"""Radix partition: stable within-bucket rank and key histogram."""
