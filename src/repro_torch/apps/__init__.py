"""Benchmark applications (paper §VI-A): GS, SL, OB, TP."""
from .gs import GS
from .ob import OB
from .sl import SL
from .tp import TP

ALL_APPS = {a.name: a for a in (GS, SL, OB, TP)}
