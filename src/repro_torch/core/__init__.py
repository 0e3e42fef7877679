"""TStream core on PyTorch: dual-mode scheduling (D1) and dynamic
restructuring execution (D2) on one device."""
from .blotter import AppSpec, Blotter, build_opbatch
from .engines import SCHEMES, EngineStats, evaluate
from .restructure import Chains, restructure
from .scheduler import DualModeEngine, EngineConfig
from .types import (ASSOC_FUNS, CORE_FUNS, F_ADD, F_MAX, F_NOP, F_PUT, F_READ,
                    F_TAKE, FunSpec, OpBatch, OpKind, OpResults, StateStore,
                    make_store)
