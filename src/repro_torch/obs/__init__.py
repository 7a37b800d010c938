"""repro_torch.obs — own copy of ``repro.obs``: the bounded trace
recorder the serve engine's instrumentation sites write to."""
from .trace import (TID_BUS, TID_ENGINE, TID_REQ, TID_SCHED, TID_STORE,
                    Span, TraceRecorder, jsonable)

__all__ = ["TraceRecorder", "Span", "jsonable", "TID_ENGINE", "TID_SCHED",
           "TID_STORE", "TID_REQ", "TID_BUS"]
