"""Build and bind the port's hand-written CUDA kernels, and count launches.

Every ``repro_torch/csrc/*.cu`` goes into ONE shared library with a plain
C interface.  At first use one ``nvcc`` call compiles and links them all
for ``sm_90a``, and ``ctypes`` binds the result.  The library is keyed on
a hash of every source and the flags, under ``build/repro_torch/`` of the
checkout
(``REPRO_TORCH_BUILD_DIR`` overrides it), so a checkout builds once and a
changed source builds anew.  Nothing is built or loaded when this module
is imported.

The kernel wrappers (``logic_dsp/kernel.py``, ``xnor_gemm/kernel.py``)
bump a plain per-kernel launch counter here where, and only where, they
launch their kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ---------------------------------------------------------------------------
# launch accounting (plain integers, bumped only where a kernel launches)
# ---------------------------------------------------------------------------

#: ``"logic"`` = K1, ``"mega"`` = K2 (both ``mega_kernel``), ``"xnor"`` = K3,
#: ``"pack"`` / ``"unpack"`` the bit layout kernels (``csrc/bitpack.cu``).
KERNELS = ("logic", "mega", "xnor", "pack", "unpack")
#: Launches per (kernel, variant); K1 and K2 name their scratch variant
#: (``"shared"`` or ``"device"``), K3 has none.
_launches: dict[tuple[str, str | None], int] = {}
#: Launches per kernel, all variants: one dict read for the runner's spans,
#: which note whether a wave's pack and unpack launched.
_totals: dict[str, int] = {}


def launch_count(kernel: str | None = None,
                 variant: str | None = None) -> int:
    """Kernel launches issued so far: one kernel's (``"logic"`` = K1,
    ``"mega"`` = K2, ``"xnor"`` = K3, ``"pack"``, ``"unpack"``), one
    variant's (K1 and K2: ``"shared"`` or ``"device"`` scratch), both, or
    with no argument all together."""
    if kernel is not None and variant is None:
        return _totals.get(kernel, 0)
    return sum(n for (k, v), n in _launches.items()
               if kernel in (None, k) and variant in (None, v))


def reset_launch_counts() -> None:
    _launches.clear()
    _totals.clear()


def count_launch(kernel: str, variant: str | None = None) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    _launches[kernel, variant] = _launches.get((kernel, variant), 0) + 1
    _totals[kernel] = _totals.get(kernel, 0) + 1


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

#: The C entry points and their ctypes signatures (pointers and the stream
#: as ``c_void_p``, so they are not cut to 32 bits).
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "logic_dsp_mega": ([_P, _I, _P, _I, _I, _I] + [_P] * 6 + [_I] * 8 + [_P],
                       _I),
    "xnor_gemm_launch": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "bitpack_pack": ([_P, _I, _I, _P, _I, _P], _I),
    "bitpack_unpack": ([_P, _I, _I, _P, _I, _P], _I),
    "repro_torch_error_string": ([_I], ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None
#: What the last build did: library path, seconds, and nvcc's ptxas report,
#: which names each kernel (empty when the library was already built).
build_info: dict = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def library_name() -> str:
    """``librepro_torch_<hash>.so``, the hash over every source's name and
    bytes and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return f"librepro_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "port's kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile and link every ``csrc/*.cu`` unless a library for these exact
    sources and flags exists already; returns the library's path."""
    out_dir = build_dir()
    lib = out_dir / library_name()
    if lib.exists():
        build_info.update(path=str(lib), seconds=0.0, ptxas="")
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{lib.name}.{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, sources())],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    build_info.update(path=str(lib), seconds=time.perf_counter() - t0,
                      ptxas=proc.stderr)
    return lib


def library() -> ctypes.CDLL:
    """The built and bound kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (args, res) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
    return _lib


def raise_on(err: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error (0 is success)."""
    if err != 0:
        msg = library().repro_torch_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
