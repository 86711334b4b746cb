"""ctypes binding of the native C++ ``.par`` parser (counterpart of
``radtxfr_tpu/lines/native_parser.py``), the port's own.

The source is the repository's ``native/par_parser.cpp``, read by path. At
first use ``g++`` builds it into ``radtxfr_tpu_torch/_build/`` (listed in
``.gitignore``), under a name made from the hash of the source and the
flags, written to a temporary name and moved into place with
``os.replace``: two processes that build at once each leave a whole
library, and ``native/`` is never written. Without ``g++`` (or the source)
:func:`parse_par_native` returns None and callers use the Python parser.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.normpath(os.path.join(_HERE, "..", "..", "native",
                                    "par_parser.cpp"))
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))
FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpar_parser_{h.hexdigest()[:16]}.so")


def _build() -> str | None:
    if not os.path.exists(SRC):
        return None
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, SRC], check=True,
                       capture_output=True)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.CalledProcessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.lru_cache(maxsize=1)
def load_library():
    """The ctypes library, or None where it cannot be built."""
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.par_count_records.restype = ctypes.c_long
    lib.par_count_records.argtypes = [ctypes.c_char_p]
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.par_parse.restype = ctypes.c_long
    lib.par_parse.argtypes = [ctypes.c_char_p, ctypes.c_long, iptr, iptr,
                              dptr, dptr, dptr, dptr, dptr, dptr, dptr]
    return lib


def parse_par_native(path: str):
    """The columns of a ``.par`` file as NumPy arrays (``mol``, ``iso``,
    ``nu``, ``sw``, ``elower``, ``gamma_air``, ``gamma_self``, ``n_air``,
    ``delta_air``), or None without the library."""
    lib = load_library()
    if lib is None:
        return None
    n = lib.par_count_records(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    cols = dict(
        mol=np.empty(n, np.int32), iso=np.empty(n, np.int32),
        nu=np.empty(n), sw=np.empty(n), elower=np.empty(n),
        gamma_air=np.empty(n), gamma_self=np.empty(n),
        n_air=np.empty(n), delta_air=np.empty(n),
    )
    got = lib.par_parse(path.encode(), n, cols["mol"], cols["iso"],
                        cols["nu"], cols["sw"], cols["elower"],
                        cols["gamma_air"], cols["gamma_self"],
                        cols["n_air"], cols["delta_air"])
    if got < 0:
        raise FileNotFoundError(path)
    return {k: v[:got] for k, v in cols.items()}
