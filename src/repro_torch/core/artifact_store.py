# Copied from src/repro/core/artifact_store.py; only the repro imports differ.
"""Durable persistence of compiled logic programs (``ArtifactStore``).

The paper's deliverable is a *compiled artifact* — eq. 23-scheduled
address/opcode streams mapped onto the DSP fabric — yet until this module
every process recompiled from the gate IR on startup, paying the ~0.5 s
cold compile the 232x in-memory cache-hit speedup exists to hide.  The
store makes a :class:`~repro.core.compiler.CompiledArtifact` a durable,
shareable file-system object so a *fleet* of serving processes warms one
shared directory instead of each compiling its own copy (ROADMAP:
"Compiled-artifact persistence + fleet warm start"; the logic-served-NN
follow-up, arXiv 2304.06299, assumes exactly this artifact contract).

Layout (content-addressed; DESIGN.md §10)::

    <root>/objects/<kk>/<key>/manifest.json   # provenance + checksums
                             /arrays.npz      # schedule tables + graph
    <root>/aliases/<kk>/<akey>.json           # raw-identity -> key records
    <root>/tmp/...                            # staging (atomic writes)
    <root>/quarantine/...                     # failed-integrity entries

``key = store_key(fingerprint, spec)`` digests the *post-optimization*
graph fingerprint plus the canonical ``CompileSpec.to_dict()`` — the same
identity ``serve.ProgramCache`` keys on — so a store hit names exactly
one concrete program pipeline, and structurally-equal graphs from
different producers share one entry.

Integrity contract (the whole point — a persistence layer that can
silently serve a *wrong* program is worse than none):

  * every write is **atomic**: both files are staged in ``tmp/`` and
    published with one ``os.replace`` of the directory, so readers see
    either nothing or a complete entry — never a torn write.  Racing
    writers of the same key are benign: the loser's rename fails and is
    discarded (the contents are equivalent by content-addressing).
  * every read **verifies before trusting**: manifest-body checksum
    (any bit flip in the manifest fails), ``arrays.npz`` checksum (any
    truncation/flip of the tables fails), format-version equality (a
    future writer's entry is refused, never half-parsed), spec equality,
    and — the end-to-end check — the rebuilt graph's recomputed
    ``fingerprint()`` must equal the requested one.
  * failure is **loud and quarantining**: any mismatch raises
    :class:`~repro.core.errors.ArtifactIntegrityError` (a
    ``PermanentCompileError`` — retrying cannot fix a corrupt file) and
    the entry is moved to ``quarantine/`` so it can never be served
    again; callers (``ProgramCache``) fall back to a clean compile.

Alias records make warm starts skip the pass pipeline: the canonical
address uses the POST-optimization fingerprint, which a fresh process
can only compute by re-running the optimizer — the dominant cold-start
cost for ``optimize="default"`` specs.  ``save_alias`` records
``(raw fingerprint, spec as requested) -> canonical key`` so
``load_alias`` resolves a first-contact request straight to the
verified canonical entry.  The alias record itself is checksummed and
version-gated (any accidental flip fails loudly, same as the
manifest), but its *claim* — that the optimizer maps this raw graph to
that canonical entry — is trusted, not re-derived: re-deriving would
re-run the pipeline, which is exactly the cost being skipped.  The
canonical entry behind it is still verified end-to-end on every load.
"""
from __future__ import annotations

import io
import itertools
import json
import os
import shutil
import hashlib
from pathlib import Path

import numpy as np

from repro_torch.core.calibrate import Calibration, CalibrationError
from repro_torch.core.compiler import CompiledArtifact
from repro_torch.core.errors import ArtifactIntegrityError
from repro_torch.core.gate_ir import LogicGraph
from repro_torch.core.scheduler import LogicProgram
from repro_torch.core.spec import CompileSpec
from repro_torch.core.verify import verify_artifact

#: On-disk format version.  Bump on ANY schema change (manifest keys,
#: array set, dtype contract): readers refuse entries whose version
#: differs — an old reader must never half-parse a future entry, and a
#: future reader must never guess at a past one.
FORMAT_VERSION = 1

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"

#: Process-wide staging sequence: staging paths must be unique across
#: every ``ArtifactStore`` instance in the process (pid alone is not
#: enough — racing instances over one root would collide at ``.0``).
_STAGE_SEQ = itertools.count()


def _digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def _canonical_json(obj: dict) -> bytes:
    """Canonical (sorted, minimal) JSON encoding — the checksummed form."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def store_key(fingerprint: str, spec: CompileSpec) -> str:
    """Content address of ``(post-opt graph, spec)`` — a stable hex
    digest of the fingerprint plus the canonical serialized spec.

    Mirrors ``ProgramCache.key_of``: the spec must be resolved (concrete
    ``n_unit``) and is keyed through ``to_dict()``, so only the named
    pipelines (``"none"``/``"default"``) are storable — a custom
    :class:`PassManager` has no declarative serial form and raises (from
    ``to_dict``) rather than colliding under a lossy key.
    """
    if not spec.resolved:
        raise ValueError(
            "store_key() requires a concrete n_unit; resolve "
            "n_unit='auto' first (LogicCompiler.resolve / ProgramCache)")
    return _digest(_canonical_json(
        {"fingerprint": fingerprint, "spec": spec.to_dict()}))


def alias_key(fingerprint: str, spec: CompileSpec) -> str:
    """Address of a raw-identity alias record: the PRE-optimization
    fingerprint plus the spec *as requested* (``n_unit="auto"`` and
    ``optimize="default"`` serialize as themselves here — resolution
    and pipeline effects live in the canonical entry it points at)."""
    return _digest(_canonical_json(
        {"alias_fp": fingerprint, "spec": spec.to_dict()}))


def _graph_payload(graph: LogicGraph) -> tuple[dict, dict]:
    """(arrays, meta) serialization of a :class:`LogicGraph`."""
    gates = (np.asarray(graph.gates, dtype=np.int64).reshape(-1, 3)
             if graph.gates else np.zeros((0, 3), dtype=np.int64))
    outputs = np.asarray(graph.outputs, dtype=np.int64)
    return ({"graph_gates": gates, "graph_outputs": outputs},
            {"n_inputs": graph.n_inputs, "name": graph.name})


def _graph_from_payload(arrays: dict, meta: dict) -> LogicGraph:
    # tolist() + map(tuple, ...) run the per-gate conversion in C — the
    # naive per-row python loop dominated verified-load wall-clock
    gates = list(map(tuple, arrays["graph_gates"].tolist()))
    return LogicGraph(n_inputs=int(meta["n_inputs"]), gates=gates,
                      outputs=arrays["graph_outputs"].tolist(),
                      name=str(meta["name"]))


class ArtifactStore:
    """Content-addressed, atomically-written store of compiled artifacts.

    One instance fronts one root directory; many processes may share the
    root concurrently (the atomic-rename publish protocol is the only
    coordination).  All counters are per-instance telemetry, not shared
    state.

    Args:
      root: store directory (created, with substructure, if missing).
      verify_on_load: when True, every loaded artifact additionally runs
        the static schedule verifier (core/verify.py, DESIGN.md §13)
        before being returned: checksums prove the *bytes* round-tripped,
        the verifier proves the *schedule* still computes the manifest's
        graph.  A verifier-rejected entry is treated exactly like a
        checksum failure — quarantined + ``ArtifactIntegrityError``.
    """

    def __init__(self, root: str | os.PathLike, *,
                 verify_on_load: bool = False):
        self.root = Path(root)
        self.verify_on_load = bool(verify_on_load)
        self._objects = self.root / "objects"
        self._aliases = self.root / "aliases"
        self._calibration = self.root / "calibration"
        self._tmp = self.root / "tmp"
        self._quarantine_dir = self.root / "quarantine"
        for d in (self._objects, self._aliases, self._calibration,
                  self._tmp, self._quarantine_dir):
            d.mkdir(parents=True, exist_ok=True)
        # telemetry (per-instance)
        self.saves = 0
        self.save_races = 0
        self.alias_saves = 0
        self.loads = 0
        self.misses = 0
        self.integrity_failures = 0
        self.quarantined = 0

    # -- paths ---------------------------------------------------------------

    def path_of(self, key: str) -> Path:
        """Directory an entry with ``key`` lives at (existing or not)."""
        return self._objects / key[:2] / key

    def _stage_path(self, key: str) -> Path:
        return self._tmp / f"{key}.{os.getpid()}.{next(_STAGE_SEQ)}"

    def alias_path_of(self, akey: str) -> Path:
        """File an alias record with ``akey`` lives at (existing or not)."""
        return self._aliases / akey[:2] / f"{akey}.json"

    def __contains__(self, key: str) -> bool:
        return (self.path_of(key) / _MANIFEST).is_file()

    def contains(self, fingerprint: str, spec: CompileSpec) -> bool:
        """True when an entry for ``(fingerprint, spec)`` is published
        (presence only — integrity is verified at :meth:`load` time)."""
        return store_key(fingerprint, spec) in self

    def keys(self) -> list[str]:
        """Keys of every published entry (sorted, for determinism)."""
        return sorted(p.name for shard in self._objects.iterdir()
                      for p in shard.iterdir()
                      if (p / _MANIFEST).is_file())

    # -- save ----------------------------------------------------------------

    def save(self, artifact: CompiledArtifact) -> str:
        """Persist ``artifact``; returns its store key.

        Idempotent and race-safe: an already-published key is left
        untouched (content addressing makes rewrites pointless), and a
        concurrent writer losing the publish rename discards its staging
        copy.  The artifact's spec must be serializable
        (``CompileSpec.to_dict()`` — named pipelines only).
        """
        fingerprint = artifact.graph.fingerprint()
        key = store_key(fingerprint, artifact.spec)
        final = self.path_of(key)
        if (final / _MANIFEST).is_file():
            return key

        arrays: dict[str, np.ndarray] = {
            "output_perm": np.asarray(artifact.output_perm, dtype=np.int64)}
        g_arrays, g_meta = _graph_payload(artifact.graph)
        arrays.update(g_arrays)
        prog_meta = []
        for i, prog in enumerate(artifact.programs):
            p_arrays, p_scalars = prog.to_payload()
            arrays.update({f"p{i}_{k}": v for k, v in p_arrays.items()})
            prog_meta.append(p_scalars)

        buf = io.BytesIO()
        np.savez(buf, **arrays)
        blob = buf.getvalue()

        payload = {
            "format_version": FORMAT_VERSION,
            "fingerprint": fingerprint,
            "spec": artifact.spec.to_dict(),
            "graph": g_meta,
            "programs": prog_meta,
            "compile_s": artifact.compile_s,
            "arrays": _ARRAYS,
            "arrays_checksum": _digest(blob),
        }
        manifest = {"payload": payload,
                    "checksum": _digest(_canonical_json(payload))}

        stage = self._stage_path(key)
        stage.mkdir(parents=True)
        try:
            self._write_file(stage / _ARRAYS, blob)
            self._write_file(stage / _MANIFEST,
                             json.dumps(manifest, indent=1).encode())
            final.parent.mkdir(parents=True, exist_ok=True)
            try:
                os.replace(stage, final)
            except OSError:
                # lost the publish race: an equivalent entry exists
                self.save_races += 1
                shutil.rmtree(stage, ignore_errors=True)
                return key
        except BaseException:
            shutil.rmtree(stage, ignore_errors=True)
            raise
        self.saves += 1
        return key

    @staticmethod
    def _write_file(path: Path, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    # -- aliases -------------------------------------------------------------

    def save_alias(self, fingerprint: str, spec: CompileSpec,
                   target_key: str) -> str:
        """Record ``(raw fingerprint, requested spec) -> target_key`` so
        warm starts resolve first-contact requests without re-running
        the pass pipeline.  Atomic (staged file + ``os.replace``) and
        idempotent; returns the alias key."""
        akey = alias_key(fingerprint, spec)
        final = self.alias_path_of(akey)
        if final.is_file():
            return akey
        payload = {"format_version": FORMAT_VERSION,
                   "alias_fp": fingerprint, "spec": spec.to_dict(),
                   "target": target_key}
        record = {"payload": payload,
                  "checksum": _digest(_canonical_json(payload))}
        stage = self._stage_path(akey)
        try:
            self._write_file(stage, json.dumps(record, indent=1).encode())
            final.parent.mkdir(parents=True, exist_ok=True)
            os.replace(stage, final)    # files replace cleanly: last wins,
        except BaseException:           # and racing writers write equal bytes
            stage.unlink(missing_ok=True)
            raise
        self.alias_saves += 1
        return akey

    def load_alias(self, fingerprint: str, spec: CompileSpec
                   ) -> CompiledArtifact | None:
        """Verified load through the raw-identity alias for
        ``(fingerprint, spec)``.

        ``None`` on a clean miss — no alias record, or the record points
        at a canonical entry that is gone (quarantined by another
        process; the caller recompiles and republishes).  A corrupt
        alias record quarantines the record and raises; a corrupt
        canonical entry behind a valid alias fails exactly as
        :meth:`load` would."""
        akey = alias_key(fingerprint, spec)
        path = self.alias_path_of(akey)
        if not path.is_file():
            self.misses += 1
            return None
        try:
            payload = self._verified_manifest_bytes(
                path, f"alias record {akey}")
            if (payload.get("alias_fp") != fingerprint
                    or payload.get("spec") != spec.to_dict()):
                raise ArtifactIntegrityError(
                    f"alias record {akey}: names a different "
                    "(fingerprint, spec) than its address — moved or "
                    "tampered")
            target = payload["target"]
        except ArtifactIntegrityError as exc:
            self.integrity_failures += 1
            exc.quarantine_path = self._quarantine_path(path, akey)
            raise
        if not (self.path_of(target) / _MANIFEST).is_file():
            self.misses += 1
            return None
        artifact = self.load_key(target)
        self.loads += 1
        return artifact

    # -- calibrations --------------------------------------------------------

    def calibration_path_of(self, name: str = "default") -> Path:
        """File the calibration record ``name`` lives at (existing or
        not)."""
        if not name or "/" in name or name != name.strip() or name in (
                ".", ".."):
            raise ValueError(f"invalid calibration name {name!r}")
        return self._calibration / f"{name}.json"

    def save_calibration(self, calibration: Calibration,
                         name: str = "default") -> Path:
        """Persist a fitted wall-clock calibration (core/calibrate.py)
        under ``calibration/<name>.json`` — same checksummed-record +
        atomic-publish protocol as alias records, so a warm process
        loads the fleet's fit instead of re-measuring (the CLI smoke
        pins ``calibrate.fit_count() == 0`` on the load path).  Unlike
        content-addressed entries, calibrations are *named* and a
        re-save replaces the record (a re-fit on the same host should
        win)."""
        final = self.calibration_path_of(name)
        payload = {"format_version": FORMAT_VERSION, "name": name,
                   "calibration": calibration.to_dict()}
        record = {"payload": payload,
                  "checksum": _digest(_canonical_json(payload))}
        stage = self._stage_path(f"calib.{name}")
        try:
            self._write_file(stage, json.dumps(record, indent=1).encode())
            final.parent.mkdir(parents=True, exist_ok=True)
            os.replace(stage, final)
        except BaseException:
            stage.unlink(missing_ok=True)
            raise
        self.saves += 1
        return final

    def load_calibration(self, name: str = "default"
                         ) -> Calibration | None:
        """Verified load of the calibration record ``name``.

        ``None`` on a clean miss.  A present-but-invalid record —
        flipped bytes, version mismatch, malformed calibration payload —
        is quarantined and raises :class:`ArtifactIntegrityError`: a
        corrupt calibration silently steering the design-space search
        is exactly the failure mode the typed error exists to prevent.
        """
        path = self.calibration_path_of(name)
        if not path.is_file():
            self.misses += 1
            return None
        try:
            payload = self._verified_manifest_bytes(
                path, f"calibration record {name!r}")
            if payload.get("name") != name:
                raise ArtifactIntegrityError(
                    f"calibration record {name!r}: payload names "
                    f"{payload.get('name')!r} — moved or tampered")
            try:
                cal = Calibration.from_dict(payload["calibration"])
            except (CalibrationError, KeyError) as exc:
                raise ArtifactIntegrityError(
                    f"calibration record {name!r}: undecodable payload "
                    f"({exc})") from exc
        except ArtifactIntegrityError as exc:
            self.integrity_failures += 1
            exc.quarantine_path = self._quarantine_path(
                path, f"calib.{name}")
            raise
        self.loads += 1
        return cal

    # -- load ----------------------------------------------------------------

    def load(self, fingerprint: str, spec: CompileSpec
             ) -> CompiledArtifact | None:
        """Verified load of the entry for ``(fingerprint, spec)``.

        Returns ``None`` on a clean miss (no entry published).  Any
        *present-but-invalid* entry — truncated/flipped arrays, tampered
        manifest, version or fingerprint or spec mismatch — quarantines
        the entry and raises :class:`ArtifactIntegrityError`
        (``PermanentCompileError``): a corrupt store must never be
        mistaken for a miss silently, and must never serve a wrong
        program.
        """
        key = store_key(fingerprint, spec)
        path = self.path_of(key)
        if not (path / _MANIFEST).is_file():
            self.misses += 1
            return None
        try:
            artifact = self._verified_load(path, fingerprint, spec)
        except ArtifactIntegrityError as exc:
            self.integrity_failures += 1
            qpath = self.quarantine(key)
            exc.quarantine_path = qpath
            raise
        self.loads += 1
        return artifact

    def load_key(self, key: str) -> CompiledArtifact:
        """Verified load by bare key (fleet tooling / inspection): the
        fingerprint and spec are taken from the manifest, and the key is
        re-derived from them — a mismatch is corruption."""
        path = self.path_of(key)
        if not (path / _MANIFEST).is_file():
            raise KeyError(f"no store entry for key {key!r}")
        try:
            payload = self._verified_manifest(path)
            fingerprint = payload["fingerprint"]
            spec = CompileSpec.from_dict(payload["spec"])
            if store_key(fingerprint, spec) != key:
                raise ArtifactIntegrityError(
                    f"store entry {key}: manifest names key "
                    f"{store_key(fingerprint, spec)} (moved or tampered)")
            return self._verified_load(path, fingerprint, spec)
        except ArtifactIntegrityError as exc:
            self.integrity_failures += 1
            exc.quarantine_path = self.quarantine(key)
            raise

    def _verified_manifest(self, path: Path) -> dict:
        """Parse + self-check an entry's manifest; any anomaly is
        integrity."""
        return self._verified_manifest_bytes(path / _MANIFEST,
                                             f"store entry {path.name}")

    @staticmethod
    def _verified_manifest_bytes(file_path: Path, label: str) -> dict:
        """Shared record verification (entry manifests + alias records):
        json parse, payload checksum, format-version equality."""
        try:
            with open(file_path, "rb") as f:
                manifest = json.load(f)
            payload = manifest["payload"]
            claimed = manifest["checksum"]
        except (OSError, ValueError, KeyError, TypeError) as exc:
            raise ArtifactIntegrityError(
                f"{label}: unreadable manifest ({exc})") from exc
        actual = _digest(_canonical_json(payload))
        if actual != claimed:
            raise ArtifactIntegrityError(
                f"{label}: manifest checksum mismatch "
                f"(claimed {claimed}, actual {actual}) — manifest corrupt")
        version = payload.get("format_version")
        if version != FORMAT_VERSION:
            raise ArtifactIntegrityError(
                f"{label}: format-version {version!r} != "
                f"reader's {FORMAT_VERSION} — refusing to guess at the "
                "schema (re-precompile with this build)")
        return payload

    def _verified_load(self, path: Path, fingerprint: str,
                       spec: CompileSpec) -> CompiledArtifact:
        payload = self._verified_manifest(path)
        if payload["fingerprint"] != fingerprint:
            raise ArtifactIntegrityError(
                f"store entry {path.name}: manifest fingerprint "
                f"{payload['fingerprint']} != requested {fingerprint}")
        if payload["spec"] != spec.to_dict():
            raise ArtifactIntegrityError(
                f"store entry {path.name}: manifest spec {payload['spec']} "
                f"!= requested {spec.to_dict()}")
        try:
            with open(path / _ARRAYS, "rb") as f:
                blob = f.read()
        except OSError as exc:
            raise ArtifactIntegrityError(
                f"store entry {path.name}: unreadable arrays ({exc})"
            ) from exc
        actual = _digest(blob)
        if actual != payload["arrays_checksum"]:
            raise ArtifactIntegrityError(
                f"store entry {path.name}: arrays checksum mismatch "
                f"(claimed {payload['arrays_checksum']}, actual {actual}) "
                "— schedule tables truncated or corrupt")
        try:
            with np.load(io.BytesIO(blob), allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
            graph = _graph_from_payload(arrays, payload["graph"])
            programs = tuple(
                LogicProgram.from_payload(
                    {k: arrays[f"p{i}_{k}"]
                     for k in LogicProgram.ARRAY_FIELDS}, scalars)
                for i, scalars in enumerate(payload["programs"]))
            output_perm = arrays["output_perm"]
        except ArtifactIntegrityError:
            raise
        except Exception as exc:
            raise ArtifactIntegrityError(
                f"store entry {path.name}: undecodable payload ({exc})"
            ) from exc
        # the end-to-end check: the REBUILT graph must hash to the
        # requested identity — a consistent-but-wrong entry (e.g. a
        # collision or a tampered-and-rechecksummed file) still fails here
        rebuilt_fp = graph.fingerprint()
        if rebuilt_fp != fingerprint:
            raise ArtifactIntegrityError(
                f"store entry {path.name}: rebuilt graph fingerprint "
                f"{rebuilt_fp} != requested {fingerprint} — wrong program")
        artifact = CompiledArtifact(
            spec=CompileSpec.from_dict(payload["spec"]), graph=graph,
            programs=programs, output_perm=output_perm,
            compile_s=float(payload["compile_s"]))
        if self.verify_on_load:
            report = verify_artifact(artifact)
            if not report.ok:
                raise ArtifactIntegrityError(
                    f"store entry {path.name}: schedule verification "
                    f"failed — {report.summary()}")
        return artifact

    # -- quarantine ----------------------------------------------------------

    def quarantine(self, key: str) -> Path | None:
        """Move a (presumed corrupt) entry out of the serving namespace.

        The entry is renamed into ``quarantine/`` (kept for post-mortem,
        never loadable again); returns the new path, or ``None`` when the
        entry vanished first (another process already quarantined it).
        """
        return self._quarantine_path(self.path_of(key), key)

    def _quarantine_path(self, src: Path, label: str) -> Path | None:
        dst = (self._quarantine_dir
               / f"{label}.{os.getpid()}.{next(_STAGE_SEQ)}")
        try:
            os.replace(src, dst)
        except OSError:
            return None
        self.quarantined += 1
        return dst

    # -- telemetry -----------------------------------------------------------

    def stats(self) -> dict:
        return {"root": str(self.root), "entries": len(self.keys()),
                "saves": self.saves, "save_races": self.save_races,
                "alias_saves": self.alias_saves,
                "loads": self.loads, "misses": self.misses,
                "integrity_failures": self.integrity_failures,
                "quarantined": self.quarantined}
