# Copied from src/repro/core/__init__.py; only the repro imports differ.
# The paper's primary contribution — implement the SYSTEM here
# (scheduler, optimizer, data path, serving loop, etc.) in the
# host framework. Add sibling subpackages for substrates.
#
# The declarative compile API (DESIGN.md §8) is re-exported at the
# package root: one CompileSpec value describes the full compilation
# target, and LogicCompiler is the one facade that turns (graph, spec)
# into a CompiledArtifact.
from repro_torch.core.artifact_store import (ArtifactStore, FORMAT_VERSION,
                                       alias_key, store_key)
from repro_torch.core.compiler import CompiledArtifact, LogicCompiler
from repro_torch.core.errors import (ArtifactIntegrityError, CompileError,
                               PermanentCompileError, TransientCompileError,
                               is_transient)
from repro_torch.core.spec import CompileSpec

__all__ = ["CompileSpec", "CompiledArtifact", "LogicCompiler",
           "ArtifactStore", "ArtifactIntegrityError", "FORMAT_VERSION",
           "store_key", "alias_key",
           "CompileError", "TransientCompileError",
           "PermanentCompileError", "is_transient"]
