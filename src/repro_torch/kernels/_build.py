"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/*.cu` source compiles, with its own `nvcc` process and all of
them started together, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

The build happens at first CUDA use (`library(name)`), never at import, so
the CPU tests import every module without `nvcc`.  Libraries land in
`build/repro_torch/` at the repository root, named by a hash of their
sources, so an edited kernel is rebuilt and an unchanged one is loaded as
it is.  `-Xptxas -v` (registers, shared memory, spills) goes to
`<name>-<hash>.log` beside each library; `build_report()` returns it.
No `--use_fast_math`: the saturation heuristic's float ops must round as
the reference's do, and the float kernels' `expf`, division and
denormals must be IEEE's, as their plain versions' are.  No `-lcuda`
either: `quant_matmul.cu` takes the driver's `cuTensorMapEncodeTiled`
through the runtime's `cudaGetDriverEntryPoint`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from repro_torch.core import fixed_point as fxp

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fixed_conv", "fixed_dense", "fixed_net", "frame_trunk", "float_kernels",
           "float_net", "float_sweep", "kda", "quant_matmul")     # csrc/<name>.cu
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class FixedCfg(ctypes.Structure):
    """`struct FixedCfg` of csrc/fixed_word.cuh, passed by value."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "total_bits", "frac_bits", "saturate", "round_nearest", "max_int",
        "min_int")] + [("scale", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in (
            "c5", "c2375", "c1", "c084375", "c0625", "c05", "one")]


@functools.lru_cache(maxsize=32)
def fixed_cfg(cfg: fxp.FixedPointConfig) -> FixedCfg:
    c = fxp.plan_constants(cfg)
    return FixedCfg(cfg.total_bits, cfg.frac_bits, int(cfg.saturate),
                    int(cfg.round_nearest), cfg.max_int, cfg.min_int,
                    cfg.scale, c.c5, c.c2375, c.c1, c.c084375, c.c0625,
                    c.c05, c.one)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of every launcher (all return cudaGetLastError() as int, or
# SHAPE_UNSUPPORTED) and of the shape queries beside them (an int)
SIGNATURES = {
    "fixed_conv": {
        "fixed_conv2d_launch": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, FixedCfg, _P],
        "fixed_maxpool2x2_launch": [_I, _P, _P, _I, _I, _I, _I, _I, _P],
        "fixed_sigmoid_launch": [_I, _P, _P, _LL, FixedCfg, _P],
    },
    "fixed_dense": {
        "fixed_dense_launch": [_I, _P, _P, _P, _P, _I, _I, _I, FixedCfg, _P],
        "fixed_dense_rows_route": [_I, _I],
        "fixed_window_head_launch": [_I] + [_P] * 9 + [_I] * 5 + [FixedCfg, _P],
    },
    "fixed_net": {
        "fixed_smallnet_launch": [_I] + [_P] * 8 + [_I, _I, _I, _I, FixedCfg, _P],
        "fixed_smallnet_fits": [_I, _I, _I],
    },
    "frame_trunk": {
        "frame_trunk_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               FixedCfg, _P],
    },
    "float_kernels": {
        "conv2d_launch": [_I, _P, _P, _P, _P] + [_I] * 11 + [_P],
        "maxpool2d_launch": [_I, _P, _P, _I, _I, _I, _I, _I, _P],
        "sigmoid_pla_launch": [_I, _P, _P, _LL, _P],
        "conv2d_tile": [_I] * 9 + [_P],
    },
    "float_net": {
        "float_smallnet_launch": [_I] + [_P] * 8 + [_I] * 5 + [_P],
        "float_smallnet_fits": [_I, _I, _I],
    },
    "float_sweep": {
        "float_sweep_stage_launch": [_I] + [_P] * 7 + [_I] * 4 + [_P],
        "float_window_head_launch": [_I] + [_P] * 9 + [_I] * 6 + [_P],
    },
    "kda": {
        "kda_chunk_prefill_launch": [_I] + [_P] * 7 + [_I] * 5 + [_P],
    },
    "quant_matmul": {
        "quant_matmul_dp4a_launch": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "quant_matmul_transpose_launch": [_I, _P, _P, _I, _I, _P],
        "quant_matmul_wgmma_launch": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}
build_seconds: float | None = None     # wall time of the last build_all()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def build_all() -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load every source; one nvcc per source, all
    started together.  Raises RuntimeError with nvcc's output on failure."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(_libs)
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            so = library_path(name)
            if not so.exists():
                tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
                procs[name] = (so, tmp, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (so, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            so.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for name in SOURCES:
            so = library_path(name)
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
            log = so.with_suffix(".log")
            _logs[name] = log.read_text() if log.exists() else ""
        build_seconds = time.perf_counter() - t0
        return dict(_libs)


def library_path(name: str) -> pathlib.Path:
    """Where the library of csrc/<name>.cu is (or would be) built."""
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)          # loaded: no lock on the launch path
    return lib if lib is not None else build_all()[name]


def build_report() -> dict[str, str]:
    """nvcc's -Xptxas -v output per source, from the build that made the
    loaded libraries (empty before the first build)."""
    with _lock:
        return dict(_logs)


SHAPE_UNSUPPORTED = -1       # csrc/launch_error.cuh kShapeUnsupported


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (the launch never ran):
    ValueError for a shape its kernel cannot take, RuntimeError else."""
    if rc == SHAPE_UNSUPPORTED:
        raise ValueError(f"{what}: the kernel cannot take this shape")
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} ({msg})")
