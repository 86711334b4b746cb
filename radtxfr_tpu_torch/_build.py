"""Build and load the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into a
shared library of its own with a plain C interface under ``_build/``
(``*_fast.cu`` include another source with ``RADTXFR_FAST`` set: its
kernels' FAST instantiations, entries named with ``_fast``, :func:`entry`)
(listed in ``.gitignore``), all sources at once in parallel processes; each
library is named by the hash of the flags, its source and the headers it
includes (``#include "..."``, followed into the headers' own), so an edited
source or header is rebuilt, and is loaded with ``ctypes``. ``-Xptxas -v``
writes each kernel's registers, shared memory and spills into a log beside
the library (:func:`build_log`). Nothing here runs at import. A missing
``nvcc`` or a failed build raises: no kernel falls back to anything else.
:func:`check_tensor` is the argument check the kernel wrappers run before
they pass raw pointers, and :func:`launch_stream` the stream they launch
on, the current one of the tensors' device, which must be current.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import types

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
DEFAULT_BUILD_DIR = os.path.join(_HERE, "_build")
#: where the libraries are built and loaded from
#: (:func:`~radtxfr_tpu_torch.utils.enable_persistent_cache` moves it)
BUILD_DIR = DEFAULT_BUILD_DIR
# -lineinfo maps each SASS instruction to its source line (nvdisasm -g) and
# leaves the generated code as it is
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

#: argument types of every C entry point (see the ``extern "C"`` blocks)
_SIGNATURES = {
    # mode, R, starts, counts, k_line, frac0, line, wcap, tile_off (the
    # tiles' int32 grid offsets, or None), lay_idx, n_lay_call, shift0,
    # strength, gamma_d, gamma_0, wing, ymix, gamma_2, n_lines, wei, n_wei,
    # tile, block, n_tiles, max_blocks, n_out, dx, out, stream
    "radtxfr_fused_xsect": [I, I, P, P, P, P, P, P, P, P, I, P, P, P, P, P,
                            P, P, I, P, I, I, I, I, I, I, ctypes.c_double,
                            P, P],
    # mode, starts, counts, k_line, frac0, line, wcap, lay_idx, n_lay,
    # shift0, strength, gamma_d, gamma_0, wing, n_lines, wei, n_wei, tile,
    # block, n_tiles, n_out, dx, out, stream
    "radtxfr_unfused_xsect": [I, P, P, P, P, P, P, P, I, P, P, P, P, P, I,
                              P, I, I, I, I, I, ctypes.c_double, P, P],
    # op, n_chains, depth, y0, a, b, iters, n, out, stream
    "radtxfr_fp32_probe": [I, I, I, P, F, F, I, I, P, P],
    # out (2^23 float32), stream
    "radtxfr_rcp_approx_table": [P, P],
    # starts, counts, k_line, frac0, line, wcap, tile_off, lay_idx,
    # n_lay_call, live ((n_dir, n_lay) int32), shift0, strength, gamma_d,
    # gamma_0, wing, shift0_t, strength_t, gamma_d_t, gamma_0_t, n_dir,
    # n_lay, n_lines, wei, n_wei, tile, block, n_tiles, n_out, dx, out,
    # stream
    "radtxfr_fused_xsect_jvp": [P, P, P, P, P, P, P, P, I, P, P, P, P, P, P,
                                P, P, P, P, I, I, I, P, I, I, I, I, I,
                                ctypes.c_double, P, P],
    # starts, counts, k_line, frac0, line, wcap, tile_off, lay_idx,
    # n_lay_call, live ((n_dir, n_lay) int32), shift0, strength, gamma_d,
    # gamma_0, gamma_2, wing, shift0_t, strength_t, gamma_d_t, gamma_0_t,
    # gamma_2_t, n_dir, n_lay, n_lines, wei, n_wei, tile, block, n_tiles,
    # n_out, dx, out, stream
    "radtxfr_fused_sdvoigt_jvp": [P, P, P, P, P, P, P, P, I, P, P, P, P, P,
                                  P, P, P, P, P, P, P, I, I, I, P, I, I, I,
                                  I, I, ctypes.c_double, P, P],
    # starts, counts, k_line, frac0, line, wcap, tile_off, lay_idx,
    # n_lay_call, strength, wing, the 11 HT constants, n_lay, n_lines, wei,
    # n_wei, tile, block, n_tiles, n_out, dx, out, stream
    "radtxfr_fused_ht": [P] * 8 + [I] + [P] * 13 + [I, I, P, I, I, I, I, I,
                                                    ctypes.c_double, P, P],
    # starts, counts, k_line, frac0, line, wcap, tile_off, lay_idx,
    # n_lay_call, live ((n_dir, n_lay) int32), strength, wing, the 11 HT
    # constants, strength_t, the 11 constants' tangents, n_dir, n_lay,
    # n_lines, wei, n_wei, tile, block, n_tiles, n_out, dx, out, stream
    "radtxfr_fused_ht_jvp": [P] * 8 + [I] + [P] * 26 + [I, I, I, P, I, I, I,
                                                        I, I, ctypes.c_double,
                                                        P, P],
    # od, src (x or B), inv_t, planck, n_lay, n_x, mus, n_mu, snap, n_zs,
    # sec, w, n_angles, return_od, tau, lu, ld, stream
    "radtxfr_fused_tud": [P, P, P, I, I, I, P, I, P, I, P, P, I, I, P, P, P,
                          P],
    # od, x, inv_t, n_lay, n_x, mus, n_mu, snap, n_zs, sec, w, n_angles,
    # dod, dT, n_dirs, dtau, dlu, dld, stream
    "radtxfr_fused_tud_jvp": [P, P, P, I, I, P, I, P, I, P, P, I, P, P, I, P,
                              P, P, P],
}
#: the entries whose kernels also have a FAST build (``csrc/*_fast.cu``:
#: the TPU kernels' fast reciprocal, JAX's ``fast_rcp=True``), each with
#: ``_fast`` at the end of its name and the same arguments
FAST_ENTRIES = ("radtxfr_fused_xsect", "radtxfr_unfused_xsect",
                "radtxfr_fused_xsect_jvp", "radtxfr_fused_sdvoigt_jvp",
                "radtxfr_fused_ht")
_SIGNATURES.update({f"{n}_fast": _SIGNATURES[n] for n in FAST_ENTRIES})


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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _with_includes(src: str) -> list[str]:
    """``src`` and the files its ``#include "..."`` lines name (relative to
    the including file), followed into those, each once, in order."""
    out, todo = [], [os.path.abspath(src)]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        with open(path, "rb") as f:
            todo += [os.path.join(os.path.dirname(path), m.decode())
                     for m in _INCLUDE.findall(f.read())]
    return out


def library_path(src: str) -> str:
    """Path of the shared library for source ``src``, the headers it
    includes and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _with_includes(src):
        with open(path, "rb") as f:
            h.update(f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build() -> list[str]:
    """Compile every source whose library does not exist yet, one ``nvcc``
    per source, all started together; the libraries' paths."""
    outs = [library_path(s) for s in _sources()]
    todo = [(s, o) for s, o in zip(_sources(), outs) if not os.path.exists(o)]
    if not todo:
        return outs
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _find_nvcc()
    procs = []
    try:
        for src, out in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs.append((src, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} ({proc.returncode})"
                              f":\n{log}")
                continue
            with open(out + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return outs


def build_log() -> str:
    """The ``nvcc`` output of each library (``-Xptxas -v``: registers,
    shared memory and spills per kernel)."""
    parts = []
    for path in build():
        with open(path + ".log") as f:
            parts.append(f"== {os.path.basename(path)}\n{f.read()}")
    return "\n".join(parts)


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


def launch_stream(device) -> int:
    """The handle of the current stream of ``device``, the CUDA device the
    kernel's tensors lie on, for a launch; raises unless ``device`` is the
    current device (a launch goes to the current device, so its pointers
    would belong to another one: run a mesh shard's work under
    ``torch.cuda.device(device)``)."""
    cur = torch.cuda.current_device()
    if device.index != cur:
        raise ValueError(f"the kernel's tensors are on {device} but the "
                         f"current device is cuda:{cur}; launch under "
                         f"torch.cuda.device({device})")
    return torch.cuda.current_stream(device).cuda_stream


def tool(name: str) -> str:
    """A CUDA toolkit program beside ``nvcc`` (``cuobjdump``,
    ``nvdisasm``)."""
    return os.path.join(os.path.dirname(_find_nvcc()), name)


def entry(name: str, fast: bool = False):
    """The built C entry ``name``, or with ``fast`` its FAST build's
    (``name`` + ``_fast``: the kernels' fast reciprocal); raises for an
    entry that has no FAST build."""
    if fast and name not in FAST_ENTRIES:
        raise ValueError(f"{name} has no FAST build")
    return getattr(library(), f"{name}_fast" if fast else name)


@functools.lru_cache(maxsize=1)
def library() -> types.SimpleNamespace:
    """The built kernel entry points, argument types declared, as
    attributes named after the C functions."""
    libs = [ctypes.CDLL(p) for p in build()]
    fns = {}
    for name, argtypes in _SIGNATURES.items():
        fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(**fns)
