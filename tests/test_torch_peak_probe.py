"""The FP32 peak probe's plain chains (P1/P2's counterpart,
``radtxfr_tpu_torch/tools/fp32_peak.py``) against a NumPy float32
recurrence of the JAX package's probe bodies (``bench.py:190-191``,
``tools/vpu_peak_probe.py:156-165``): a*y + b, y*a, y + b and (y + b)*a.
The kernel itself runs on the card only (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from radtxfr_tpu_torch.tools import fp32_peak
from port_fixtures import one_torch_thread  # noqa: F401

A, B = fp32_peak.A, fp32_peak.B


def _numpy_chains(op, steps, y0):
    """The probe bodies step by step in NumPy float32; the FMA, which rounds
    once, as the float64 a*y + b of float32 operands rounded to float32."""
    y = y0.astype(np.float32).copy()
    for _ in range(steps):
        if op == "fma":
            y = (np.float64(A) * y.astype(np.float64)
                 + np.float64(B)).astype(np.float32)
        elif op == "mul":
            y = y * A
        elif op == "add":
            y = y + B
        else:
            y = (y + B) * A
    acc = y[:, 0].copy()
    for k in range(1, y.shape[1]):
        acc = acc + y[:, k]
    return acc


@pytest.mark.parametrize("name,op,n_chains", fp32_peak.SUITE)
def test_plain_chains_match_numpy(name, op, n_chains):
    """Each mix of the suite, 2 x 8 steps on 257 elements: the plain chains
    equal the NumPy recurrence bit for bit, and ``probe`` runs them for CPU
    tensors."""
    y0 = np.random.default_rng(5).uniform(0.25, 1.0, (257, n_chains))
    y0 = y0.astype(np.float32)
    want = _numpy_chains(op, 16, y0)
    got = fp32_peak.probe_plain(op, 8, 2, torch.from_numpy(y0)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        fp32_peak.probe(op, 8, 2, torch.from_numpy(y0)).numpy(), want)


@pytest.mark.parametrize("depth", [8, fp32_peak.DEPTH])
@pytest.mark.parametrize("name,op,n_chains", fp32_peak.SUITE)
def test_check_operands_expose_each_operation(name, op, n_chains, depth):
    """With the card checks' operands (``CHECK_A``, ``CHECK_B``), the plain
    chains of each mix, 2 iterations at either unrolled depth, lie more than
    4 float32 ulps (the checks' bound) from what a kernel that ran another
    operation, half the steps or none would return, at every element: so
    the check can tell each of those from the right chain."""
    y0 = torch.from_numpy(np.random.default_rng(7).uniform(
        0.25, 1.0, (257, n_chains)).astype(np.float32))
    ab = dict(a=fp32_peak.CHECK_A, b=fp32_peak.CHECK_B)
    want = fp32_peak.probe_plain(op, depth, 2, y0, **ab)
    wrong = [fp32_peak.probe_plain(o, depth, 2, y0, **ab)
             for o in fp32_peak.OPS if o != op]
    wrong += [fp32_peak.probe_plain(op, depth, 1, y0, **ab),
              fp32_peak.probe_plain(op, depth, 0, y0, **ab)]
    ulp = torch.finfo(torch.float32).eps * want.abs()
    assert bool(torch.isfinite(want).all()) and bool((want > 0).all())
    for w in wrong:
        assert bool(((w - want).abs() > 4 * ulp).all())


def test_plain_fma_rounds_once():
    """An FMA step rounds once: one plain step is within a float32 ulp of
    the twice-rounded float32 a*y + b (P1's jnp body) and differs from it
    somewhere (over many steps the two drift apart by up to an ulp a step,
    so the card's FFMA is held to the singly rounded chain)."""
    y0 = np.random.default_rng(6).uniform(0.25, 1.0, (4096, 1))
    y0 = y0.astype(np.float32)
    got = fp32_peak.probe_plain("fma", 1, 1, torch.from_numpy(y0)).numpy()
    y = A * y0[:, 0] + B
    assert np.abs(got - y).max() <= np.spacing(np.abs(y)).max()
    assert (got != y).any()


def test_peak_is_a_card_measurement():
    """The measured peak is a device metric: asking for it on the CPU
    raises instead of timing the plain chains."""
    with pytest.raises(ValueError, match="measurement of the card"):
        fp32_peak.measured_fp32_peak(device="cpu")
    with pytest.raises(ValueError, match="measurement of the card"):
        fp32_peak.probe_suite(device="cpu")
