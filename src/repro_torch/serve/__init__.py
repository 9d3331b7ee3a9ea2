from repro_torch.serve.batcher import SlotTable
from repro_torch.serve.logic_engine import (CompiledEntry, LogicEngine,
                                            LogicRequest, ProgramCache)
from repro_torch.core.artifact_store import ArtifactStore

__all__ = ["SlotTable", "ArtifactStore", "LogicEngine", "LogicRequest",
           "ProgramCache", "CompiledEntry"]
