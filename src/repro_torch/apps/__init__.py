"""Benchmark applications of this slice: GS and TP.  SL and OB take the
lockstep path and come with it (ROADMAP A7)."""
from .gs import GS
from .tp import TP

ALL_APPS = {a.name: a for a in (GS, TP)}
