"""Build and load the port's CUDA kernels.

The kernels live in ``ndsm_tpu_torch/csrc`` and are compiled at first use,
from those sources only, with ``nvcc`` into a shared library with a plain
C interface that is loaded through ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Each ``.cu`` file is compiled by its own ``nvcc``,
all started together, then one more links them.  The library goes to
``ndsm_tpu_torch/_build/<key>/`` where the key hashes the sources and the
compiler flags; a file lock serialises concurrent builds (test workers,
several processes).

Nothing here runs at import.  ``kernels()`` raises when ``nvcc`` is
missing or the build fails; there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["kernels", "build_dir", "find_nvcc", "check", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libndsm_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)

#: argtypes of every C entry point (restype is c_int for all).
_SIGNATURES = {
    "ndsm_sum_partials_f32": (_P, _L, _P, _I, _P),
    "ndsm_sum_final_f32": (_P, _I, _F, _P, _P),
    "ndsm_sub_scalar_f32": (_P, _P, _L, _P),
    "ndsm_mean_smooth_f32": (_P,) * 5 + (_I,) * 7 + (_F,) * 5 + (_P,),
    "ndsm_mean_resident_blocks": (_I, _I, _I),
    "ndsm_v2d_smooth_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _F, _F, _F, _F, _P),
    "ndsm_v2d_lane_f32": (_P, _P, _P, _P, _P) + (_I,) * 8 + (_F, _F, _F, _F, _P),
    "ndsm_defect_f64": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _D, _P),
    "ndsm_defect_point_f64": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _D, _P),
    "ndsm_defect_blocks": (_I, _I, _I),
    "ndsm_defect_tile_blocks": (_I, _I, _I),
    "ndsm_lane_half_inplace_f32": (_P, _P, _I, _I, _I, _I, _IP, _IP, _IP, _I,
                                   _F, _F, _F, _F, _P),
    "ndsm_lane_half_oop_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _IP, _IP, _IP,
                               _F, _F, _F, _F, _P),
    "ndsm_lane_residual_f32": (_P, _P, _P, _I, _I, _I, _I, _IP, _IP, _F, _F, _F, _P),
    "ndsm_lane_pass_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _IP, _IP, _IP, _I, _I, _I, _I,
                           _F, _F, _F, _F, _P),
    "ndsm_compact_half_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _IP, _IP, _IP,
                              _I, _F, _F, _F, _F, _P),
    "ndsm_compact_pass_f32": (_P,) * 6 + (_I,) * 4 + (_IP,) * 3 + (_I,) * 4 + (_F,) * 4 + (_P,),
    "ndsm_compact_split_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _IP, _P),
    "ndsm_compact_merge_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    "ndsm_shard_half_oop_f32": (_P, _P, _P) + (_I,) * 9 + (_F, _F, _F, _F, _P),
    "ndsm_shard_half_inplace_f32": (_P, _P) + (_I,) * 9 + (_F, _F, _F, _F, _P),
    "ndsm_shard_residual_f32": (_P, _P, _P) + (_I,) * 10 + (_F, _F, _F, _P),
    "ndsm_shard_pass_f32": (_P,) * 4 + (_I,) * 18 + (_F,) * 4 + (_P,),
    "ndsm_defect_sharded_f64": (_P,) * 6 + (_I,) * 9 + (_D, _D, _D, _P),
    "ndsm_defect_sharded_tile_f64": (_P,) * 6 + (_I,) * 9 + (_D, _D, _D, _P),
    "ndsm_defect_sharded_tile_blocks": (_I, _I, _I),
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``.  Raises ``RuntimeError`` when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "a CUDA tensor needs the port's CUDA kernels, but nvcc was not found "
        "(looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _key() -> str:
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    lib = out_dir / LIB_NAME
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if lib.exists():
                return lib
            nvcc = find_nvcc()
            tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
            objs, procs = [], []
            for src in sorted(CSRC.glob("*.cu")):
                obj = out_dir / f"{src.stem}.{os.getpid()}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
                objs.append(str(obj))
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            log = []
            for cmd, proc in procs:
                out, err = proc.communicate()
                log.append(" ".join(cmd) + "\n" + out + err)
                if proc.returncode != 0:
                    for _, other in procs:
                        other.wait()
                    raise RuntimeError(
                        f"nvcc failed (exit {proc.returncode}) building the port's "
                        f"kernels:\n{err[-4000:]}"
                    )
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            (out_dir / "build.log").write_text("\n".join(log))
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}) linking the port's "
                    f"kernels:\n{proc.stderr[-4000:]}"
                )
            for obj in objs:
                os.remove(obj)
            os.replace(tmp, lib)
            return lib
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def build_dir() -> Path:
    """Where the library of the current sources goes (with ``build.log``,
    nvcc's and ptxas's output, after a build)."""
    return BUILD_ROOT / _key()


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = _build(build_dir())
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.ndsm_error_string.argtypes = [ctypes.c_int]
            lib.ndsm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = _lib.ndsm_error_string(rc).decode() if _lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {rc} at launch ({msg})")
