"""TUD Jacobians by forward-mode autodiff (counterpart of
``radtxfr_tpu/products/jacobian.py``).

The reference approximates Jacobians by brute force: 3*66+1 = 199 perturbed
profiles with relative step 1e-3, each a full TUD run
(``Generate_LWIR_TUD.py:55-71``). Here ``torch.func.jvp`` differentiates
the physics instead, over the per-layer (T, vmr-column) state: the plain
modules (line parameters, continuum) under PyTorch's forward mode, the
composition of :func:`~.tud.make_tud_diff_fn` (K2 and its tangent mode for
a CUDA float32 OD, else Planck and the scan composition
:func:`~.tud.tud_from_od`), and the line OD by one of two engines, as in
the JAX package:

* ``engine='jnp'`` (the default there and here): the reference engine,
  :func:`~.od.compute_od_layer` layer by layer plus the pointwise
  continuum, differentiated as plain PyTorch (any dtype);
* ``engine='pallas'``: the differentiable ``full`` pass of
  :func:`~.od.make_od_fn`, whose tangent is the kernel K3.

Directions go through ``torch.func.vmap`` in batches of ``tangent_batch``
(K3 carries a batch as one direction axis). Wing cutoffs are held fixed at
the linearization point (the hapi window mask is piecewise constant in
(T, p)), as in the reference's finite differences. Neither engine takes
line mixing here; mixing Jacobians are forward-mode AD through
``compute_od_layers(engine='jnp', line_mixing=...)``, as in the JAX
package.

Spans (:func:`~..utils.profiling.span`): ``jacobian.primal`` around the
products at the state, ``jacobian.tangent`` around each batch's
``vmap(jvp)``, and inside the forward ``od`` and ``tud`` (``planck`` too
off K2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.profiling import span
from .od import _line_species_cols, compute_od_layer, make_od_fn
from .tud import make_tud_diff_fn

__all__ = ["tud_with_jacobian"]


def tud_with_jacobian(lines, iso, grid, atmos, altitudes, wrt=("T", 1, 3),
                      mu=1.0, n_angles: int = 30, chunk: int = 512,
                      tangent_batch: int | None = None, engine: str = "jnp",
                      continuum: str = "none", continuum_factors=None,
                      reduce=None):
    """TUD products and their Jacobian w.r.t. per-layer state variables.

    ``lines``/``iso``/``atmos`` live on one device in one dtype (on the
    ``'pallas'`` engine float32 launches the kernels on a card, CPU tensors
    run their plain versions); ``grid`` is the uniform (nX,) axis the OD is
    computed on (its values size the plans, as in the JAX builder).

    Parameters
    ----------
    wrt : "T" and/or HITRAN molecule ids of ``atmos.mol_ids``, e.g.
        ``("T", 1, 3)`` for temperature, H2O and O3 (the reference's set).
    chunk : lines per block of the ``'jnp'`` engine.
    tangent_batch : directions per ``vmap`` batch (default: all nLayers);
        changes no value, only how many tangents are held at once.
    engine : ``'jnp'`` (the reference engine) or ``'pallas'`` (the
        differentiable kernels K1 ``full`` and K3).
    reduce : optional function applied to each batch's tangents, spectral
        axis first and directions last (e.g. a
        :class:`~..sensor.resolution.ReduceOperator`), before the batches
        are joined: the full-resolution Jacobian is then never held.

    Returns
    -------
    (tud, jac): ``tud`` maps tau/Lu/Ld to the products at the state
    (tau/Lu (nX, nZs, nMu), Ld (nX,)); ``jac`` maps each entry of ``wrt``,
    stringified (``"T"``, ``"1"``, ...), to tau/Lu/Ld with a trailing
    (nLayers,) axis: d(product)/d(state_layer), reduced by ``reduce`` when
    given.
    """
    dev, dt = lines.sw.device, lines.sw.dtype
    grid = torch.as_tensor(grid, device=dev)
    alts = torch.atleast_1d(torch.as_tensor(altitudes, device=dev))
    if engine == "pallas":
        od_fn = make_od_fn(lines, iso, grid.cpu().numpy(), atmos,
                           differentiable=True, continuum=continuum,
                           continuum_factors=continuum_factors)
    else:
        from ..atmos.continuum import continuum_od

        cols = _line_species_cols(lines.host_view(), atmos.mol_ids)

        def od_fn(T, p, pl, vmr):
            with span("od"):
                od = torch.stack([
                    compute_od_layer(lines, iso, grid, T_l, p_l, pl_l, vmr_l,
                                     cols, chunk=chunk)
                    for T_l, p_l, pl_l, vmr_l in zip(T, p, pl, vmr)])
                if continuum == "none":
                    return od
                st = dataclasses.replace(atmos, T=T, vmr=vmr)
                with span("od.continuum"):
                    return od + continuum_od(
                        grid, st, model=continuum,
                        continuum_factors=continuum_factors).to(od.dtype)

    compose = make_tud_diff_fn(atmos.z0, alts, mu=mu, n_angles=n_angles,
                               devices=[dev])

    def forward(T, vmr):
        od = od_fn(T, atmos.p, atmos.pl, vmr)
        return dict(zip(("tau", "Lu", "Ld"), compose(grid, od, T)))

    with span("jacobian.primal"):
        tud = forward(atmos.T, atmos.vmr)
    n_lay = int(atmos.T.shape[0])
    batch = n_lay if tangent_batch is None else max(1, int(tangent_batch))
    eye = torch.eye(n_lay, dtype=dt, device=dev)

    def jac_batched(f, x):
        parts = []
        for k in range(0, n_lay, batch):
            with span("jacobian.tangent"):
                tan = torch.func.vmap(
                    lambda v: torch.func.jvp(f, (x,), (v,))[1])(
                    eye[k:k + batch])
            tan = {name: a.movedim(0, -1) for name, a in tan.items()}
            if reduce is not None:
                tan = {name: reduce(a) for name, a in tan.items()}
            parts.append(tan)
        return {name: torch.cat([p[name] for p in parts], dim=-1)
                for name in parts[0]}

    mol_col = {m: i for i, m in enumerate(atmos.mol_ids)}
    jac = {}
    for key in wrt:
        if key == "T":
            jac["T"] = jac_batched(lambda T: forward(T, atmos.vmr), atmos.T)
            continue
        c = mol_col[int(key)]
        is_col = torch.as_tensor(np.arange(len(atmos.mol_ids)) == c,
                                 device=dev)

        def f(v_col):
            return forward(atmos.T, torch.where(is_col, v_col[:, None],
                                                atmos.vmr))

        jac[str(int(key))] = jac_batched(f, atmos.vmr[:, c])
    return tud, jac
