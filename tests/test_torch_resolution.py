"""The port's spectral smoothing and resolution reduction
(``radtxfr_tpu_torch/sensor/resolution.py``) against radtxfr_tpu's, in
float64 from seeded inputs: ``smooth`` with every window (a length under 3
or over the signal's returns the input), ``apply_resample``,
``reduce_resolution`` on (nX,) and (nX, nS), each within 1e-12 of the
peak; the banded ``reduce_operator`` equals ``reduce_resolution`` where
both apply; and the CLI's fallback where ``reduce_operator`` refuses
(``--dv-out`` of one fine step) gives the JAX CLI's products and
unreduced Jacobian shapes, while at two fine steps (hanning(2) is all
zeros) both CLIs raise ValueError.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.cli.main import build_parser as j_build_parser
from radtxfr_tpu.sensor import resolution as j_res
from radtxfr_tpu_torch.cli.main import main
from radtxfr_tpu_torch.sensor import resolution as res
from port_fixtures import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(7)
X = 718.0 + 0.005 * np.arange(1001)
#: a smooth spectrum with sharp features, and three columns of it
Y1 = (np.exp(-((X - 720.3) / 0.05) ** 2) + 0.3 * np.sin(3.0 * X)
      + 0.05 * RNG.standard_normal(X.size))
YS = np.stack([Y1, 2.0 * Y1[::-1], RNG.standard_normal(X.size)], axis=1)


def _close(got, want, bound=1e-12, gain=1.0):
    """|got - want| within ``bound`` x ``gain`` of the peak of ``want``;
    ``gain`` is what a resample stencil can multiply a rounding difference
    of its inputs by (the largest sum of |weights| of an output)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = np.abs(want).max()
    assert peak > 0.0
    assert np.abs(got - want).max() <= bound * gain * peak, \
        np.abs(got - want).max() / peak


@pytest.mark.parametrize("window", sorted(res._WINDOWS))
@pytest.mark.parametrize("window_len", [3, 4, 11, 50])
def test_smooth_matches_jax(window, window_len):
    want = j_res.smooth(jnp.asarray(Y1), window_len, window)
    got = res.smooth(torch.as_tensor(Y1), window_len, window)
    assert got.shape == (X.size,)
    _close(got.numpy(), want)


def test_smooth_returns_input_outside_its_range():
    """A window under 3 points or longer than the signal returns the
    input itself, as in JAX; an unknown window raises ValueError."""
    y = torch.as_tensor(Y1[:20])
    for n in (0, 1, 2, 21):
        assert res.smooth(y, n) is y
        np.testing.assert_array_equal(
            np.asarray(j_res.smooth(jnp.asarray(Y1[:20]), n)), Y1[:20])
    with pytest.raises(ValueError, match="window must be one of"):
        res.smooth(y, 5, "kaiser")


@pytest.mark.parametrize("cols", [False, True])
def test_apply_resample_matches_jax(cols):
    x_out = np.sort(RNG.uniform(X[0] - 0.01, X[-1] + 0.01, 300))
    idx, w = res.cubic_resample_weights(X, x_out)
    j_idx, j_w = j_res.cubic_resample_weights(X, x_out)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(w, j_w)
    y = YS if cols else Y1
    _close(res.apply_resample(idx, w, torch.as_tensor(y)).numpy(),
           j_res.apply_resample(j_idx, j_w, jnp.asarray(y)))


@pytest.mark.parametrize("dX", [0.05, 0.25])
@pytest.mark.parametrize("cols", [False, True])
def test_reduce_resolution_matches_jax(dX, cols):
    y = YS if cols else Y1
    x_lo, got = res.reduce_resolution(X, torch.as_tensor(y), dX)
    j_x, want = j_res.reduce_resolution(X, jnp.asarray(y), dX)
    np.testing.assert_array_equal(x_lo, j_x)
    _close(got.numpy(), want)
    # a given axis, edges included: the reflected smoothing zone and, out
    # to X's ends, extrapolation from the smoothed axis, whose stencils
    # carry weights up to ~1e5 at 0.25 cm^-1 (both packages round the
    # smoothed values alike only to the last bits, so the bound is scaled
    # by the stencil's gain)
    x_out = np.linspace(X[0], X[-1], 57)
    sm = int(round(dX / 0.005))
    _, w = res.cubic_resample_weights(res._np_sym_smooth(X, sm, "hanning"),
                                      x_out)
    _close(res.reduce_resolution(X, torch.as_tensor(y), dX,
                                 X_out=x_out).numpy(),
           j_res.reduce_resolution(X, jnp.asarray(y), dX, X_out=x_out),
           gain=np.abs(w).sum(axis=1).max())


@pytest.mark.parametrize("dX", [0.05, 0.25])
def test_reduce_operator_equals_reduce_resolution(dX):
    """The banded operator against reduce_resolution on the default axis
    (interior stencils), both the port's, within 1e-12 of the peak."""
    op = res.reduce_operator(X, dX, device="cpu")
    x_lo, want = res.reduce_resolution(X, torch.as_tensor(YS), dX)
    np.testing.assert_array_equal(op.x_out, x_lo)
    _close(op(torch.as_tensor(YS)).numpy(), want.numpy())


# the CLI's fallback: one fine step of --dv-out (the operator refuses under
# 3), the JAX CLI on its Pallas engine (interpret mode, float32) for the
# products and the Jacobian kept at full resolution with the mu axis
FALLBACK = ["tud", "--derived", "--continuum", "mt_ckd", "--numin", "718",
            "--numax", "718.25", "--dv", "0.005", "--n-atmos", "2",
            "--batch", "2", "--jacobian", "--jacobian-wrt", "T"]


def _run_jax(argv):
    args = j_build_parser().parse_args(argv)
    jax.config.update("jax_enable_x64", False)
    try:
        args.fn(args)
    finally:
        jax.config.update("jax_enable_x64", True)


def test_cli_fallback_matches_jax_cli(tmp_path):
    """tau/La/Ld within the CLI's 1e-5 of each one's peak (tests/
    test_torch_cli.py), the Jacobians (nX, nZs, 1, nLay) and (nX, nLay)
    within its 5e-4 (the JAX package's bound between its Jacobian
    engines), the same X."""
    argv = FALLBACK + ["--dv-out", "0.005"]
    with pytest.raises(ValueError):
        res.reduce_operator(np.arange(101) * 0.005, 0.005, device="cpu")
    main(argv + ["--device", "cpu", "--output", str(tmp_path / "p.h5")])
    _run_jax(argv + ["--engine", "pallas", "--output",
                     str(tmp_path / "j.h5")])
    with h5py.File(tmp_path / "p.h5", "r") as f, \
            h5py.File(tmp_path / "j.h5", "r") as g:
        assert sorted(f) == sorted(g)
        np.testing.assert_array_equal(f["X"][...], g["X"][...])
        assert f["X"].shape == (194,)
        assert f["dtau_dT"].shape == (51, 9, 1, 66)
        assert f["dLd_dT"].shape == (51, 66)
        for k, bound in (("tau", 1e-5), ("La", 1e-5), ("Ld", 1e-5),
                         ("dtau_dT", 5e-4), ("dLu_dT", 5e-4),
                         ("dLd_dT", 5e-4)):
            assert f[k].shape == g[k].shape, k
            assert np.isfinite(f[k][...]).all(), k
            _close(f[k][...], g[k][...], bound)


def test_cli_two_fine_steps_raise_as_jax(tmp_path):
    """--dv-out of two fine steps: hanning(2) is zeros, so the smoothed
    axis is NaN and both CLIs raise ValueError before any member."""
    argv = FALLBACK[:-3] + ["--dv-out", "0.01"]
    with pytest.raises(ValueError):
        main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError):
        _run_jax(argv + ["--engine", "pallas"])
