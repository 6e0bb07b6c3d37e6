"""Build the port's CUDA C++ kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
compiled for `sm_90a` at first use into `build/repro_torch_kernels/` under
the checkout (git-ignored). The file name carries a digest of the sources
and flags, so an edited source never loads a stale library. Nothing here
runs at import time: the CPU test suite imports every module on machines
with no `nvcc` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry point per library, with its ctypes argument kinds:
# "p" = pointer or stream (c_void_p), "i" = int (c_int), "f" = float
# (c_float). Every entry point
# ends with (int device, void* stream) and returns a cudaError_t as int.
ENTRY_POINTS = {
    "block_matmul": ("block_matmul_f32", "ppp" "iiiiii" "ip"),
    "fused_gcn_dense": ("fused_gcn_dense_f32", "pppppp" "iiiii" "ip"),
    "int8_matmul": ("int8_matmul_s8", "pppp" "iiiiii" "ip"),
    "fused_gcn_int8": ("fused_gcn_int8_f32", "pppppppppp" "iiiiii" "ip"),
    "bitmap_spmm": ("bitmap_spmm_f32", "ppppp" "iiiii" "ip"),
    "fused_gcn_grasp": ("fused_gcn_grasp_f32", "pppppppp" "iiiiii" "ip"),
    "gat_attention": ("gat_attention_f32", "ppppp" "iiii" "ip"),
    "fused_gat_full": ("fused_gat_full_f32", "pppppppppp" "iiiiii" "ip"),
    "fused_gat_precombined": ("fused_gat_precombined_f32",
                              "pppppp" "iiiii" "ip"),
    "sage_max": ("sage_max_f32", "ppp" "iiii" "ip"),
    "fused_sage": ("fused_sage_f32", "pppppppp" "iiiiiii" "ip"),
    "flash_attention": ("flash_attention_fwd",
                        "pppp" "iiiiiiiiii" "ff" "ip"),
    "flash_attention_tc": ("flash_attention_tc_fwd",
                           "pppp" "iiiiiiiii" "ff" "ip"),
    "flash_attention_bwd": ("flash_attention_bwd",
                            "pppppppp" "iiiiiiiiii" "ff" "ip"),
    "flash_attention_bwd_tc": ("flash_attention_bwd_tc",
                               "pppppppp" "iiiiiiiii" "ff" "ip"),
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_ENTRIES: Dict[str, ctypes._CFuncPtr] = {}     # loaded once per process


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME);"
                       " the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named libraries (all by default) that are not built yet,
    one nvcc process each, all started together. Returns each library's
    nvcc/ptxas log (registers, shared memory, spills); raises when a
    compile fails."""
    names = list(ENTRY_POINTS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running: List = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in names}


def cuobjdump_path() -> str:
    """The toolkit's cuobjdump, else the copy Triton ships."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidates = [Path(nvcc_path()).with_name("cuobjdump")]
    try:
        import triton
        candidates.append(Path(triton.__file__).parent / "backends" /
                          "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("cuobjdump not found (toolkit or triton)")


def sass_counts(name: str, patterns: Dict[str, Iterable[str]]
                ) -> Dict[str, int]:
    """Count the SASS instructions of one built library (`cuobjdump
    -sass`): for each key, the lines that hold every word of its pattern,
    e.g. {"HMMA TF32": ("HMMA", "TF32")}."""
    path = library_path(name)
    if not path.exists():
        build([name])
    text = subprocess.run([cuobjdump_path(), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    lines = text.splitlines()
    return {key: sum(all(w in line for w in words) for line in lines)
            for key, words in patterns.items()}


def load(name: str):
    """The bound C entry point of one kernel library, building it first if
    this checkout has not yet."""
    if name not in _ENTRIES:
        path = library_path(name)
        if not path.exists():
            build([name])
        symbol, kinds = ENTRY_POINTS[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = [_CTYPES[k] for k in kinds]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return _ENTRIES[name]
