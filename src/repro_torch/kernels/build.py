"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

The sources under ``repro_torch/csrc`` have a plain ``extern "C"``
interface, so one ``nvcc`` call per source builds them in seconds (PyTorch's
extension builder would compile its headers for minutes). Each library is
built at first use into ``build/repro_torch/<hash>/`` at the repository
root, keyed by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so a changed source rebuilds and an unchanged one loads at
once. There is no fallback: without
``nvcc`` the build raises.

``cpu_library`` builds a source with g++ against the CUDA emulation headers
of the repository's tests instead (``tests/cuda_emulation``), for what
only reads a kernel's own plan or layout off the card: the core's plan
(``fused_core_plan``) in the launch lint on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# csrc/<name>.cu, one library each
SOURCES = ("fused_block", "fused_wgrad", "dft_rows", "fused_core", "cgemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Per library name and -D flags: build seconds (0.0 when loaded from the
# cache) and the ptxas report lines (registers, shared memory, spills).
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is absent."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the repro_torch CUDA kernels are built at first "
            "use and need the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _ptxas_lines(log: str) -> List[str]:
    return [ln.strip() for ln in log.splitlines()
            if "spill" in ln or "smem" in ln
            or ("ptxas info" in ln and ("registers" in ln
                                        or "Compiling" in ln))]


def source_digest(name: str, defines: Sequence[str] = ()) -> str:
    """The hash a build of ``csrc/<name>.cu`` is keyed by: the source, the
    shared headers (``csrc/*.cuh``) and the flags. Its build directory is
    named by it, and the tuned plan cache (``repro_torch.tuning``) stamps
    it, so a change to any of them rebuilds the kernel and makes its tuned
    plans stale."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    return hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]


def build(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu``, with ``-D`` for each of `defines`, into
    ``lib<name>.so`` under a directory keyed by ``source_digest``; return
    its path and record ``BUILD_INFO``."""
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    key = " ".join([name, *flags[len(NVCC_FLAGS):]])
    out_dir = BUILD_ROOT / source_digest(name, defines)
    lib = out_dir / f"lib{name}.so"
    log_path = out_dir / f"{name}.ptxas.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        BUILD_INFO[key] = {"seconds": 0.0, "cached": True,
                           "ptxas": _ptxas_lines(log)}
        return lib
    compiler = nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # Build under a temporary name and rename: concurrent builders (test
    # workers, parallel builds) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} (exit "
                               f"{proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO[key] = {"seconds": seconds, "cached": False,
                       "ptxas": _ptxas_lines(log)}
    return lib


def load_block_library(path: Path) -> ctypes.CDLL:
    """Load a fused-block library and declare its C signatures."""
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_block_forward.argtypes = [i, i, i, i, vp, vp, vp, vp, vp, vp,
                                        vp, vp, vp, vp, vp, vp, vp, vp]
    lib.fused_block_forward.restype = i
    lib.fused_block_max_clusters.argtypes = [i, i, i, i,
                                             ctypes.POINTER(i)]
    lib.fused_block_max_clusters.restype = i
    lib.fused_block_smem.argtypes = [i, i, vp, vp, vp, vp]
    lib.fused_block_smem.restype = ctypes.c_longlong
    lib.fused_block_error_string.argtypes = [i]
    lib.fused_block_error_string.restype = ctypes.c_char_p
    return lib


def load_wgrad_library(path: Path) -> ctypes.CDLL:
    """Load a fused weight-gradient library and declare its C signatures."""
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_wgrad.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.fused_wgrad.restype = i
    lib.fused_wgrad_max_clusters.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.fused_wgrad_max_clusters.restype = i
    lib.fused_wgrad_smem.argtypes = [i, i, vp, vp]
    lib.fused_wgrad_smem.restype = ctypes.c_longlong
    lib.fused_wgrad_error_string.argtypes = [i]
    lib.fused_wgrad_error_string.restype = ctypes.c_char_p
    return lib


EMULATION = BUILD_ROOT.parents[1] / "tests" / "cuda_emulation"


def cpu_library(name: str) -> Path:
    """``csrc/<name>.cu`` compiled with g++ for the CPU against
    ``EMULATION`` (one POSIX thread per CUDA thread) into
    ``build/repro_torch/cpu-<digest>/``; raises where g++ or the headers
    are absent or the compile fails. Its launches are slow emulations: use
    it for plans and layouts."""
    gxx = shutil.which("g++")
    if gxx is None or not EMULATION.is_dir():
        raise RuntimeError(f"building {name} for the CPU needs g++ and "
                           f"{EMULATION}")
    out_dir = BUILD_ROOT / f"cpu-{source_digest(name)}"
    lib = out_dir / f"lib{name}_cpu.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (CSRC / f"{name}.cu").read_text().replace(
        "extern __shared__ float smem[];",
        "float* smem = g_smem[blockIdx.x].data();")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cpp = out_dir / f"{name}.cpp"
    cpp.write_text(src)
    try:
        proc = subprocess.run(
            [gxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-pthread",
             "-fno-strict-aliasing", "-Wno-unknown-pragmas", "-include",
             "cuda_runtime.h", f"-I{EMULATION}", f"-I{CSRC}", str(cpp),
             "-o", tmp], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load_fused_block() -> ctypes.CDLL:
    """The fused FNO block library, built from ``csrc/fused_block.cu``."""
    return load_block_library(build("fused_block"))


@functools.lru_cache(maxsize=None)
def load_fused_wgrad() -> ctypes.CDLL:
    """The fused weight-gradient library, built from
    ``csrc/fused_wgrad.cu``."""
    return load_wgrad_library(build("fused_wgrad"))


def load_dft_rows_library(path: Path) -> ctypes.CDLL:
    """Load a row-DFT library and declare its C signatures."""
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dft_rows_cdft.argtypes = [i, vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.dft_rows_cdft.restype = i
    lib.dft_rows_rdft.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, i, i, i, i,
                                  i, i, vp]
    lib.dft_rows_rdft.restype = i
    lib.dft_rows_irdft.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, i, i, i,
                                   i, i, i, vp]
    lib.dft_rows_irdft.restype = i
    lib.dft_rows_group.argtypes = [i, i, i, i, i, i, i, i, i]
    lib.dft_rows_group.restype = i
    lib.dft_rows_smem.argtypes = [i, i, i, i, i, i, i, i]
    lib.dft_rows_smem.restype = ctypes.c_longlong
    lib.dft_rows_error_string.argtypes = [i]
    lib.dft_rows_error_string.restype = ctypes.c_char_p
    return lib


def load_core_library(path: Path) -> ctypes.CDLL:
    """Load a partial-fusion core library and declare its C signatures."""
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_core.argtypes = [i, vp, vp, vp, vp, vp, vp]
    lib.fused_core.restype = i
    lib.fused_core_plan.argtypes = [i, vp, vp, vp]
    lib.fused_core_plan.restype = i
    lib.fused_core_max_clusters.argtypes = [i, vp, vp, ctypes.POINTER(i)]
    lib.fused_core_max_clusters.restype = i
    lib.fused_core_error_string.argtypes = [i]
    lib.fused_core_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_dft_rows() -> ctypes.CDLL:
    """The row-DFT library, built from ``csrc/dft_rows.cu``."""
    return load_dft_rows_library(build("dft_rows"))


@functools.lru_cache(maxsize=None)
def load_fused_core() -> ctypes.CDLL:
    """The partial-fusion core library, built from ``csrc/fused_core.cu``."""
    return load_core_library(build("fused_core"))


def load_cgemm_library(path: Path) -> ctypes.CDLL:
    """Load a complex-product library and declare its C signatures."""
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.cgemm.argtypes = [i, vp, i, i, i, vp]
    lib.cgemm.restype = i
    lib.cgemm_plan.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.cgemm_plan.restype = None
    lib.cgemm_error_string.argtypes = [i]
    lib.cgemm_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_cgemm() -> ctypes.CDLL:
    """The complex-product library, built from ``csrc/cgemm.cu``."""
    return load_cgemm_library(build("cgemm"))
