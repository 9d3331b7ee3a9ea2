from repro_torch.serve.engine import (DecodeCache, init_decode_cache,
                                      prefill, decode_step)
from repro_torch.serve.batcher import Request, RequestBatcher, SlotTable
from repro_torch.serve.logic_engine import (CompiledEntry, LogicEngine,
                                            LogicRequest, ProgramCache)
from repro_torch.serve.frontdoor import (FaultPolicy, FrontDoor, Priority,
                                         RequestRejected, ShedReason,
                                         SHED_CODES, Tenant)
from repro_torch.serve.traffic import (TrafficPattern, TrafficReport,
                                       TrafficRequest, build_trace,
                                       run_trace, run_trace_sync)
from repro_torch.core.artifact_store import ArtifactStore

__all__ = ["DecodeCache", "init_decode_cache", "prefill", "decode_step",
           "RequestBatcher", "Request", "SlotTable", "ArtifactStore",
           "LogicEngine", "LogicRequest", "ProgramCache", "CompiledEntry",
           "FrontDoor", "FaultPolicy", "Priority", "RequestRejected",
           "ShedReason", "SHED_CODES", "Tenant",
           "TrafficPattern", "TrafficReport", "TrafficRequest",
           "build_trace", "run_trace", "run_trace_sync"]
