"""radtxfr_tpu_torch — the PyTorch/CUDA port of ``radtxfr_tpu``.

Same subpackage layout as the JAX package (``core``, ``lines``, ``kernels``,
``atmos``, ``products``, ``sensor``, ``dist``, ``io``, ``scene``, ``utils``,
``cli``); each module here is the counterpart of the module at the same
relative path there. Plain tensor code is PyTorch; the line-by-line kernels are hand-written CUDA C++
for Hopper (``csrc/``), built with ``nvcc`` at first use
(:mod:`radtxfr_tpu_torch._build`), never at import.

Every public constructor and builder takes ``device`` and runs on the card
(CUDA) unless the caller passes another device, e.g. ``device="cpu"`` for
the kernels' plain versions; float data defaults to float32, the kernels'
type. Without a card, a call that leaves ``device`` at its default raises
(:func:`resolve_device`): nothing falls back to the CPU.

The port imports neither JAX nor ``radtxfr_tpu`` (whose ``__init__`` pulls
in JAX); it reads the packaged tables of ``radtxfr_tpu/data`` by file path.
"""

import os

import numpy as np
import torch

__version__ = "0.1.0"

# A float32 matmul or convolution in TF32 keeps ~3 decimal digits; every
# number of this package is held to float32 bounds, so TF32 stays off
# (the GPU form of the TPU bf16-MXU hazard the JAX package guards against).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _settle_cpu_exp():
    """torch's CPU ``exp`` (MKL build) intermittently returns low-precision
    values on its first multi-threaded call in a process (3.3e-9 relative
    in float64, 3e-5 of peak in a float32 TUD, in about one process in
    five) and is exact on every later call; one large call per dtype spends
    that first call, so the plain versions on the CPU are exact."""
    for dt in (torch.float64, torch.float32):
        torch.exp(torch.zeros(1 << 20, dtype=dt))


_settle_cpu_exp()


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card
    (``cuda``). A CUDA device, the default or named, raises where torch
    sees none: nothing falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {device}: radtxfr_tpu_torch runs on the "
            "card unless asked otherwise; pass device='cpu' to run the "
            "kernels' plain versions on the CPU")
    return device


def as_tensor_on(a, device=None, dtype=None) -> torch.Tensor:
    """``a`` (array, scalar or tensor) as a tensor on ``device`` in
    ``dtype``. ``device`` None keeps a tensor's own device and puts
    anything else on the card (:func:`resolve_device`); ``dtype`` None
    keeps the input's own dtype."""
    if isinstance(a, torch.Tensor):
        dev = a.device if device is None else torch.device(device)
    else:
        dev = resolve_device(device)
        # a read-only array (a broadcast view) is copied: torch warns on it
        a = torch.as_tensor(np.array(a) if isinstance(a, np.ndarray)
                            and not a.flags.writeable else a)
    return a.to(device=dev, dtype=dtype)


def arrays_on(*arrays, device=None, dtype=None, lead=False) -> tuple:
    """A call's array arguments as its tensors, on the call's device: its
    first tensor argument's, else ``device`` (None: the card). Each NumPy
    array or NumPy scalar goes there through :func:`as_tensor_on`, in
    ``dtype`` (None: its own); with ``lead`` the first argument does too,
    whatever it is (a Python scalar or list in torch's default float32).
    Anything else (tensors, scalars, lists, None) is returned as given, so
    a call without NumPy arguments keeps its bits."""
    dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
               device)
    return tuple(
        as_tensor_on(a, dev, dtype)
        if isinstance(a, (np.ndarray, np.generic))
        or (lead and i == 0 and a is not None
            and not isinstance(a, torch.Tensor)) else a
        for i, a in enumerate(arrays))


def as_numpy(a, dtype=None) -> np.ndarray:
    """``a`` as a host NumPy array (in ``dtype`` where given, as
    ``np.asarray(a, dtype)``): a tensor is copied off its device (a card's
    refuses ``np.asarray``), anything else goes through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


#: packaged data tables shared with the JAX package (read by path only)
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "radtxfr_tpu", "data")

# the top-level names of radtxfr_tpu/__init__.py that are ported
from .core.planck import (planckian, brightness_temperature,  # noqa: E402,F401
                          bt2l)
from .core.grid import make_spectral_axis, arange_drift_free  # noqa: E402,F401
