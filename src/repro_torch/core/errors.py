# Copied from src/repro/core/errors.py; only the repro imports differ.
"""Compile-failure taxonomy (consumed by the serving front door).

The compile path can fail three distinct ways, and a serving layer must
react differently to each — retry, reject, or crash loudly:

``CompileError``
    Base of every *classified* compilation failure.  Anything else
    escaping the compile path (``ValueError`` from spec/graph
    validation, a genuine bug) is deliberately NOT wrapped: validation
    errors are the caller's fault and bugs must stay loud.

``TransientCompileError``
    A failure expected to succeed on retry — resource pressure, a
    fault-injection hook (``serve.frontdoor.FaultPolicy``), an evicted
    artifact store entry mid-read.  ``retryable = True``: the front
    door retries these with bounded exponential backoff.

``PermanentCompileError``
    A failure retrying cannot fix (graph exceeds a hard fabric limit,
    unsupported opcode on a backend).  The front door sheds the request
    with a machine-readable ``compile_failed`` reason instead of
    burning its deadline on retries.

``ArtifactIntegrityError``
    A ``PermanentCompileError`` specific to the persistence layer
    (core/artifact_store.py): a store entry failed verification —
    checksum, format-version, fingerprint, or spec mismatch.  Loud by
    design (a silently-wrong compiled program is the worst possible
    failure); the store quarantines the entry and ``ProgramCache``
    falls back to a clean compile.

:func:`is_transient` is the one classification point: retry loops ask
it instead of isinstance-matching, so new retryable subclasses (or a
third-party exception taught to carry ``retryable = True``) slot in
without touching the retry code.
"""
from __future__ import annotations


class CompileError(RuntimeError):
    """A classified failure of the logic-compile path."""

    retryable: bool = False


class TransientCompileError(CompileError):
    """Compilation failed but is expected to succeed on retry."""

    retryable = True


class PermanentCompileError(CompileError):
    """Compilation failed and retrying cannot help."""

    retryable = False


class ArtifactIntegrityError(PermanentCompileError):
    """A persisted compiled artifact failed verification.

    Raised by :mod:`repro.core.artifact_store` on any checksum /
    format-version / fingerprint / spec mismatch.  Carries
    ``quarantine_path`` (set by the store) pointing at where the
    offending entry was moved for post-mortem, or ``None`` when another
    process quarantined it first."""

    quarantine_path = None


def is_transient(exc: BaseException) -> bool:
    """True when ``exc`` is a retryable compile failure."""
    return bool(getattr(exc, "retryable", False))
