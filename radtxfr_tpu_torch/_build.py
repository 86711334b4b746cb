"""Build and load the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface under ``_build/`` (listed in
``.gitignore``), named by the hash of the sources and flags so an edited
source is rebuilt; the library is loaded with ``ctypes``. Nothing here runs
at import. A missing ``nvcc`` or a failed build raises: no kernel falls back
to anything else. :func:`check_tensor` is the argument check both kernel
wrappers run before they pass raw pointers.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int

#: argument types of every C entry point (see the ``extern "C"`` blocks)
_SIGNATURES = {
    # mode, starts, counts, k_line, frac0, line, wcap, lay_idx, n_lay_call,
    # shift0, strength, gamma_d, gamma_0, wing, ymix, n_lines, wei, n_wei,
    # tile, block, n_tiles, n_out, dx, out, stream
    "radtxfr_fused_xsect": [I, P, P, P, P, P, P, P, I, P, P, P, P, P, P, I,
                            P, I, I, I, I, I, ctypes.c_double, P, P],
    # od, x, inv_t, n_lay, n_x, mus, n_mu, snap, n_zs, sec, w, n_angles,
    # return_od, tau, lu, ld, stream
    "radtxfr_fused_tud": [P, P, P, I, I, P, I, P, I, P, P, I, I, P, P, P, P],
}


def _find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of radtxfr_tpu_torch are "
        "built from source at first use and need the CUDA toolkit")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources():
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libradtxfr_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if their library does not exist yet."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def check_tensor(name, t, dtype, device, shape=None):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (and of ``shape``, when given): what a kernel's raw pointer assumes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library, with argument types declared."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
