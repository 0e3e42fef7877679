"""The runtime on the port's engine (the reference's ``repro/runtime``): the
streaming service with its fault plane, and the fault-tolerant training
loop ``ft.py``."""
from .faults import (Fault, FaultPlane, HangAborted, InjectedCrashError,
                     InjectedFault, TransientSourceError, corrupt_snapshot,
                     random_schedule, schedule_from_json, schedule_to_json)
from .ft import TrainLoop, TrainLoopConfig
from .service import (ExecutorHungError, ServiceConfig, ServiceRun,
                      StragglerPolicy, StreamService, ts_base_for)
