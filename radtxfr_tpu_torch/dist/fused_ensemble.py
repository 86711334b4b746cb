"""The sharded production path: ensemble TUD and TUD Jacobians on an
(ensemble x spectrum) mesh through the kernels (counterpart of
``radtxfr_tpu/dist/pallas_ensemble.py``).

Every mesh entry (e, s) runs the same static plans on its data: its
members (or tangent directions) of ensemble slice e, and spectral shard s
of the padded grid, whose tiles carry their global grid offsets
(:func:`~..products.od.make_od_local_fn`). Each process walks the entries
it owns on the host and runs each under its device (kernels launch on that
device's current stream, asynchronously, so distinct cards overlap; on a
repeated device the entries run one after another); nothing synchronises
inside the walk. On a mesh over several processes (JAX's multi-controller
``shard_map``) every process builds the same plans from the same inputs,
checks through the group that they are the same, binds only its own
shards, and calls ``run`` with the same inputs as the others; the other
processes' parts reach it through the group
(:func:`~.ensemble.share_parts`), and every process joins the whole on its
caller's device in the layout of JAX's ``out_specs``. Line-wing spill
across shard boundaries is the bucketing's: line data are replicated and
each shard's tiles hold every line whose wing reaches them.

Composition is pointwise in nu, so a weighted partition's permuted points
go through it as they are and are put back in grid order at the gather.
Float32 members compose with K2 (:func:`~..products.tud.make_tud_fn`),
built per layer grid: a member is composed on its own ``z0``, not on the
build batch's (the JAX builder bakes in the build batch's first member's,
``pallas_ensemble.py:102-114``). Float64 members compose with
:func:`~..products.tud.tud_from_od`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import arrays_on, as_numpy
from ..atmos.profile import AtmosphericState
from ..core.planck import planckian
from ..products.od import make_od_local_fn, shard_slice
from ..products.tud import make_tud_diff_fn, make_tud_fn, tud_from_od
from ..utils.profiling import span
from .ensemble import gather_shards, member, shard_context, share_parts
from .mesh import ENSEMBLE, SPECTRUM

__all__ = ["make_tud_ensemble_fn", "tud_ensemble_fused",
           "make_tud_jacobian_fn", "jacobian_directions"]

_FIELDS = ("z0", "z1", "pl", "p", "T", "vmr")


def _envelope(batch: AtmosphericState) -> list:
    """The four corners that bound every member's wing and core plans:
    all minima, all maxima, and the mixed (T min, p/pl/vmr max) and (T
    max, p/pl/vmr min) states (a core width grows with p and vmr and
    shrinks with T, so its extreme lies in neither pure corner)."""
    lo = {f: getattr(batch, f).detach().cpu().amin(dim=0) for f in _FIELDS}
    hi = {f: getattr(batch, f).detach().cpu().amax(dim=0) for f in _FIELDS}
    mk = lambda d: AtmosphericState(**d, mol_ids=batch.mol_ids)  # noqa
    dense = ("p", "pl", "vmr")
    return [mk(lo), mk(hi),
            mk({f: (hi if f in dense else lo)[f] for f in _FIELDS}),
            mk({f: (lo if f in dense else hi)[f] for f in _FIELDS})]


def _check_same_plans(local_fn, mesh):
    """Raise unless every process of a mesh's group built the same host
    plans (a mismatch would gather wrong columns without a word); every
    process raises alike, so none is left waiting on the others."""
    if not mesh.spans_group:
        return
    import torch.distributed as dist

    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, local_fn.plan_digest)
    if len(set(digests)) > 1:
        raise ValueError("the processes of the mesh built different plans "
                         f"(SHA-256 by rank: {digests}); every process must "
                         "build from the same inputs")


class _Shards:
    """A local OD function's copies on this process's devices of a mesh,
    and the spec and (possibly permuted) wavenumbers of each spectral shard
    that this process's entries run."""

    def __init__(self, local_fn, spec_data, gpad, mesh, dtype):
        _check_same_plans(local_fn, mesh)
        self.mesh = mesh
        self.n_spec = mesh.shape[SPECTRUM]
        self.n_local = gpad.n // self.n_spec
        self.point_index = local_fn.point_index
        x = gpad.values(np.float64)
        if self.point_index is not None:
            x = x[np.asarray(self.point_index).reshape(-1)]
        fns, self.shard, self.x = {}, {}, {}
        for e, s in mesh.owned():
            dev = mesh.devices[e, s]
            if dev not in fns:
                fns[dev] = local_fn.to(dev)
            if (s, dev) not in self.shard:
                # bound here, outside any torch.func transform
                self.shard[(s, dev)] = fns[dev].bind(
                    shard_slice(spec_data, s, dev), s * self.n_local)
                self.x[(s, dev)] = torch.as_tensor(
                    x[s * self.n_local:(s + 1) * self.n_local],
                    dtype=dtype, device=dev)

    def od(self, s, dev, T, p, pl, vmr):
        """Shard s's layer OD of one state, on ``dev``."""
        return self.shard[(s, dev)](T, p, pl, vmr)


def make_tud_ensemble_fn(lines, iso, grid, batch: AtmosphericState,
                         altitudes, mesh, atmos_class=None, mu=1.0,
                         n_angles: int = 30, quadrature: str = "uniform",
                         return_od: bool = False,
                         compose_engine: str = "auto", **od_opts):
    """Sharded ensemble TUD through the kernels.

    ``batch`` carries a leading ensemble axis on every tensor (its size a
    multiple of the mesh's ensemble axis); ``atmos_class`` (default: the
    four corners of ``batch``'s envelope) sizes the static plans and must
    envelope every batch ``run`` is given. ``od_opts`` go to
    :func:`~..products.od.make_od_local_fn` (``partition``,
    ``continuum``, ``line_mixing``, ...). ``compose_engine``: ``'auto'``
    composes float32 members with K2 and float64 ones with
    :func:`~..products.tud.tud_from_od`; ``'pallas'`` always K2, ``'jnp'``
    always ``tud_from_od``.

    Returns ``(padded_grid, run)``: ``run(batch) -> (tau, Lu, Ld)``, tau/Lu
    (B, nXp, nZs, nMu) and Ld (B, nXp) on the device of ``batch``'s
    tensors, on the padded grid (slice to the original ``len(grid)``). On a
    mesh over several processes every process of the group builds and
    calls ``run`` with the same inputs, computes its own entries and
    receives the whole.
    """
    n_spec, n_ens = mesh.shape[SPECTRUM], mesh.shape[ENSEMBLE]
    if batch.T.shape[0] % n_ens:
        raise ValueError(f"batch {batch.T.shape[0]} not divisible by "
                         f"ensemble axis {n_ens}")
    if compose_engine not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown compose_engine {compose_engine!r}")
    if atmos_class is None:
        atmos_class = _envelope(batch)
    local_fn, spec_data, gpad = make_od_local_fn(
        lines, iso, grid, atmos_class, n_spec, **od_opts)
    dt = lines.sw.dtype
    sh = _Shards(local_fn, spec_data, gpad, mesh, dt)
    alts_np = np.atleast_1d(as_numpy(altitudes, np.float64))
    mu_np = np.atleast_1d(as_numpy(mu, np.float64))
    fused = compose_engine == "pallas" or (compose_engine == "auto"
                                           and dt == torch.float32)
    k2 = {}

    def compose(x, od, st, z0_key, dev):
        if fused:
            key = (z0_key, dev)
            if key not in k2:
                k2[key] = make_tud_fn(np.frombuffer(z0_key), alts_np,
                                      mu=mu_np, n_angles=n_angles,
                                      quadrature=quadrature,
                                      return_od=return_od, device=dev)
            tud = k2[key](x, od, st.T)
        else:
            B = planckian(x, st.T).transpose(0, 1).to(od.dtype)
            tud = tud_from_od(x, od, B, st.z0,
                              torch.as_tensor(alts_np, device=dev),
                              mu=torch.as_tensor(mu_np, dtype=od.dtype,
                                                 device=dev),
                              n_angles=n_angles, return_od=return_od,
                              quadrature=quadrature)
        return tud.tau, tud.Lu, tud.Ld

    def run(b: AtmosphericState):
        n_b = b.T.shape[0]
        if n_b % n_ens:
            raise ValueError(f"batch {n_b} not divisible by ensemble axis "
                             f"{n_ens}")
        m = n_b // n_ens
        # each member's layer grid, read once before any launch
        z0 = np.ascontiguousarray(b.z0.detach().cpu().numpy(),
                                  dtype=np.float64)
        parts = {}
        for e, s in mesh.owned():
            dev = mesh.devices[e, s]
            with shard_context(dev):
                outs = []
                for i in range(e * m, (e + 1) * m):
                    st = member(b, i, dev)
                    od = sh.od(s, dev, st.T, st.p, st.pl, st.vmr)
                    outs.append(compose(sh.x[(s, dev)], od, st,
                                        z0[i].tobytes(), dev))
                parts[(e, s)] = tuple(torch.stack(a) for a in zip(*outs))
        return gather_shards(share_parts(parts, mesh), b.T.device, n_b,
                             gpad.n, sh.point_index)

    return gpad, run


def tud_ensemble_fused(lines, iso, grid, batch, altitudes, mesh, **kw):
    """One-shot convenience around :func:`make_tud_ensemble_fn` (the
    counterpart of ``tud_ensemble_pallas``): ``(padded_grid, tau, Lu,
    Ld)``. Production loops build once and call ``run`` per batch."""
    gpad, run = make_tud_ensemble_fn(lines, iso, grid, batch, altitudes,
                                     mesh, **kw)
    tau, Lu, Ld = run(batch)
    return gpad, tau, Lu, Ld


def jacobian_directions(atmos: AtmosphericState, wrt=("T", 1, 3)):
    """One-hot tangent bases for the reference's Jacobian ensemble (its
    3*66+1 = 199 finite-difference profiles, ``Generate_LWIR_TUD.py:55-71``:
    the primal plus one direction per (variable, layer)). Returns NumPy
    float32 ``(V_T (n_dirs, nLay), V_vmr (n_dirs, nLay, nSpecies),
    labels)``, labels ``(str(key), layer)``."""
    n_lay = int(atmos.T.numel())
    n_sp = int(atmos.vmr.shape[1])
    mol_col = {m: i for i, m in enumerate(atmos.mol_ids)}
    V_T, V_vmr, labels = [], [], []
    eye = np.eye(n_lay, dtype=np.float32)
    zT = np.zeros((n_lay,), dtype=np.float32)
    zV = np.zeros((n_lay, n_sp), dtype=np.float32)
    for key in wrt:
        for layer in range(n_lay):
            if key == "T":
                V_T.append(eye[layer])
                V_vmr.append(zV)
            else:
                v = zV.copy()
                v[layer, mol_col[int(key)]] = 1.0
                V_T.append(zT)
                V_vmr.append(v)
            labels.append((str(key), layer))
    return np.stack(V_T), np.stack(V_vmr), labels


def make_tud_jacobian_fn(lines, iso, grid, atmos: AtmosphericState,
                         altitudes, mesh, mu=1.0, n_angles: int = 30,
                         quadrature: str = "uniform", **od_opts):
    """Spectrum- and direction-sharded TUD Jacobian.

    The fine grid shards over the mesh's spectrum axis through the
    differentiable local builder (``make_od_local_fn(differentiable=True)``:
    K1 ``full`` or ``sdvoigt`` for the value, K3 or K4 for the tangents,
    each on the shard's tiles with their offsets; ``partition`` defaults to
    'weighted'), and tangent directions over the ensemble axis. Returns
    ``(padded_grid, run)``, ``run(T, vmr, V_T, V_vmr) -> (primal,
    tangent)``: dicts of tau (nXp, nZs, nMu), Lu and Ld (nXp,), the
    tangent's with a leading (n_dirs,) axis; ``V_T`` is (n_dirs, nLay) and
    ``V_vmr`` (n_dirs, nLay, nSpecies), n_dirs a multiple of the ensemble
    axis. Outputs lie on the device of ``T``. On a mesh over several
    processes every process of the group builds and calls ``run`` with the
    same inputs; the owner of entry (0, s) computes shard s's primal.
    Spans (:func:`~..utils.profiling.span`): ``jacobian.primal``,
    ``jacobian.tangent`` (the ``vmap(jvp)``) and ``jacobian.gather``, with
    ``od`` and ``tud`` inside the first two.

    The composition is :func:`~..products.tud.make_tud_diff_fn`'s, which
    follows the OD it is given: a CUDA float32 OD composes with K2 and its
    tangent mode (one launch for a mesh entry's batch of directions), any
    other (the CPU, float64) with ``planckian`` (span ``planck``) and
    :func:`~..products.tud.tud_from_od` under ``jvp`` and ``vmap``.
    """
    n_spec, n_ens = mesh.shape[SPECTRUM], mesh.shape[ENSEMBLE]
    od_opts.setdefault("partition", "weighted")
    local_fn, spec_data, gpad = make_od_local_fn(
        lines, iso, grid, atmos, n_spec, differentiable=True, **od_opts)
    sh = _Shards(local_fn, spec_data, gpad, mesh, lines.sw.dtype)
    fixed = {dev: {f: getattr(atmos, f).to(dev) for f in ("p", "pl")}
             for dev in mesh.distinct()}
    compose = make_tud_diff_fn(
        atmos.z0, np.atleast_1d(as_numpy(altitudes, np.float64)), mu=mu,
        n_angles=n_angles, quadrature=quadrature, devices=mesh.distinct())

    def run(T, vmr, V_T, V_vmr):
        # NumPy inputs join a tensor input's device, else the store's
        T, vmr, V_T, V_vmr = arrays_on(T, vmr, V_T, V_vmr,
                                       device=lines.sw.device)
        T, vmr = torch.as_tensor(T), torch.as_tensor(vmr)
        V_T = torch.as_tensor(V_T).to(T.dtype)
        V_vmr = torch.as_tensor(V_vmr).to(vmr.dtype)
        n_dirs = V_T.shape[0]
        if n_dirs % n_ens:
            raise ValueError(f"direction batch {n_dirs} not divisible by "
                             f"the ensemble mesh axis {n_ens}")
        m = n_dirs // n_ens
        prim, tan = {}, {}
        for e, s in mesh.owned():
            dev = mesh.devices[e, s]
            fx, x = fixed[dev], sh.x[(s, dev)]

            def forward(T_, vmr_, s=s, dev=dev, fx=fx, x=x):
                od = sh.od(s, dev, T_, fx["p"], fx["pl"], vmr_)
                return compose(x, od, T_)

            with shard_context(dev):
                T_d, vmr_d = T.to(dev), vmr.to(dev)
                if e == 0:
                    with span("jacobian.primal"):
                        prim[(0, s)] = tuple(a[None] for a in
                                             forward(T_d, vmr_d))
                with span("jacobian.tangent"):
                    tan[(e, s)] = torch.func.vmap(
                        lambda vT, vv: torch.func.jvp(
                            forward, (T_d, vmr_d), (vT, vv))[1])(
                        V_T[e * m:(e + 1) * m].to(dev),
                        V_vmr[e * m:(e + 1) * m].to(dev))
        names = ("tau", "Lu", "Ld")
        with span("jacobian.gather"):
            p = gather_shards(share_parts(prim, mesh, rows=[0]), T.device, 1,
                              gpad.n, sh.point_index)
            t = gather_shards(share_parts(tan, mesh), T.device, n_dirs,
                              gpad.n, sh.point_index)
        return ({k: a[0] for k, a in zip(names, p)}, dict(zip(names, t)))

    return gpad, run
