"""The port's resumable checkpoints (``radtxfr_tpu_torch/dist``) against
radtxfr_tpu's, and ``tud --checkpoint`` killed and resumed.

* ``EnsembleCheckpoint``/``run_batched`` (the writes in line and on the
  writer thread) and ``TiledCheckpoint``/``run_tiled`` of both packages run
  the same compute function (NumPy, from a seed) in directories of their
  own: the same file names, the same manifest JSON, equal ``gather``
  results; each package reads a directory the other wrote, and refuses one
  made for another plan with the same error.
* ``tud --checkpoint`` on the port's CLI (``--device cpu``: the kernels'
  plain versions) at the JAX package's kill test's size
  (``tests/test_dist_infra.py::test_kill_resume_bit_identical``: 120
  synthetic lines, 800-812 cm^-1 at 0.005, 8 members in batches of 2, 8
  angles, 2 altitudes): a child that kills itself with SIGKILL right after
  its first batch file is in place (a wrapper around
  ``EnsembleCheckpoint.write_batch`` in the child's own code), then a fresh
  process that resumes, gives an HDF5 byte-identical to an uninterrupted
  run's, whose products equal the run without ``--checkpoint``.
"""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from radtxfr_tpu.dist import checkpoint as j_ck
from radtxfr_tpu_torch.dist import checkpoint as ck
from port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS, BATCH = 7, 3


def _compute(indices, shard=None):
    """A batch's (or tile's) arrays, a function of its members (and
    shard) only, from a seed."""
    rng = np.random.default_rng(1000 + 10 * int(indices[0])
                                + (0 if shard is None else shard))
    n = len(indices)
    return {"tau": rng.random((n, 5, 2)).astype(np.float32),
            "Ld": rng.random((n, 5)), "idx": np.asarray(indices)}


def _listing(directory):
    return sorted(f for f in os.listdir(directory) if ".tmp." not in f)


def _manifest(directory):
    with open(os.path.join(directory, "manifest.json")) as f:
        return f.read()


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("async_io", [False, True])
def test_run_batched_matches_jax(tmp_path, async_io):
    """The same batches, files, manifest and gathered arrays as JAX's,
    in line and with the writer thread; a restart computes nothing."""
    logs = []
    got = ck.run_batched(ck.EnsembleCheckpoint(str(tmp_path / "port"),
                                               N_ITEMS, BATCH,
                                               meta={"seed": 3}),
                         _compute, log=logs.append, async_io=async_io)
    jlogs = []
    want = j_ck.run_batched(j_ck.EnsembleCheckpoint(str(tmp_path / "jax"),
                                                    N_ITEMS, BATCH,
                                                    meta={"seed": 3}),
                            _compute, log=jlogs.append, async_io=async_io)
    _equal(got, want)
    assert logs == jlogs and len(logs) == 3
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax") == [
        "batch_000000.npz", "batch_000001.npz", "batch_000002.npz",
        "manifest.json"]
    assert _manifest(tmp_path / "port") == _manifest(tmp_path / "jax")
    calls = []
    again = ck.run_batched(
        ck.EnsembleCheckpoint(str(tmp_path / "port"), N_ITEMS, BATCH),
        lambda idx: calls.append(idx) or _compute(idx), log=None)
    assert calls == []
    _equal(again, want)


def test_run_batched_resumes_pending_only(tmp_path):
    """Batches already in place are not computed again: after one batch of
    three, a restart computes the other two, and the result equals an
    uninterrupted run's."""
    d = str(tmp_path / "ck")
    c = ck.EnsembleCheckpoint(d, N_ITEMS, BATCH)
    c.write_batch(1, _compute(c.batch_indices(1)))
    assert c.completed == {1} and c.pending == [0, 2]
    calls = []
    got = ck.run_batched(ck.EnsembleCheckpoint(d, N_ITEMS, BATCH),
                         lambda idx: calls.append(list(idx)) or _compute(idx),
                         log=None)
    assert calls == [[0, 1, 2], [6]]
    _equal(got, j_ck.run_batched(
        j_ck.EnsembleCheckpoint(str(tmp_path / "j"), N_ITEMS, BATCH),
        _compute, log=None))


def test_checkpoints_read_across_packages(tmp_path):
    """JAX's EnsembleCheckpoint gathers a directory the port wrote, and the
    port's one JAX wrote; likewise the tiled checkpoints."""
    ck.run_batched(ck.EnsembleCheckpoint(str(tmp_path / "p"), N_ITEMS,
                                         BATCH), _compute, log=None)
    j_ck.run_batched(j_ck.EnsembleCheckpoint(str(tmp_path / "j"), N_ITEMS,
                                             BATCH), _compute, log=None)
    _equal(j_ck.EnsembleCheckpoint(str(tmp_path / "p"), N_ITEMS,
                                   BATCH).gather(),
           ck.EnsembleCheckpoint(str(tmp_path / "j"), N_ITEMS,
                                 BATCH).gather())
    ck.run_tiled(ck.TiledCheckpoint(str(tmp_path / "tp"), N_ITEMS, BATCH, 2),
                 _compute, log=None)
    j_ck.run_tiled(j_ck.TiledCheckpoint(str(tmp_path / "tj"), N_ITEMS,
                                        BATCH, 2), _compute, log=None)
    _equal(j_ck.TiledCheckpoint(str(tmp_path / "tp"), N_ITEMS, BATCH,
                                2).gather(),
           ck.TiledCheckpoint(str(tmp_path / "tj"), N_ITEMS, BATCH,
                              2).gather())


@pytest.mark.parametrize("shard_axes", [-1, {"tau": 1, "Ld": -1,
                                             "idx": None}])
def test_run_tiled_matches_jax(tmp_path, shard_axes):
    """run_tiled over owned shards, then the rest: None while tiles are
    missing, then the same tiles, manifest and stitched arrays as JAX's."""
    kw = dict(log=None, shard_axes=shard_axes)
    port = ck.TiledCheckpoint(str(tmp_path / "port"), N_ITEMS, BATCH, 3,
                              meta={"band": [800, 812]})
    assert ck.run_tiled(port, _compute, owned_shards=[0, 2], **kw) is None
    assert sorted(port.completed) == [(b, s) for b in range(3)
                                      for s in (0, 2)]
    got = ck.run_tiled(port, _compute, owned_shards=[1], **kw)
    jax_ck = j_ck.TiledCheckpoint(str(tmp_path / "jax"), N_ITEMS, BATCH, 3,
                                  meta={"band": [800, 812]})
    want = j_ck.run_tiled(jax_ck, _compute, **kw)
    _equal(got, want)
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    assert len(_listing(tmp_path / "port")) == 10
    assert _manifest(tmp_path / "port") == _manifest(tmp_path / "jax")


@pytest.mark.parametrize("kind", ["ensemble", "tiled"])
def test_plan_mismatch_raises_as_jax(tmp_path, kind):
    """Reopening a directory with another plan raises ValueError with
    JAX's message."""
    d = str(tmp_path / kind)
    if kind == "ensemble":
        ck.EnsembleCheckpoint(d, 8, 2)
        reopen = [(m.EnsembleCheckpoint, (d, 8, 4)) for m in (ck, j_ck)]
    else:
        ck.TiledCheckpoint(d, 8, 2, 2)
        reopen = [(m.TiledCheckpoint, (d, 8, 2, 3)) for m in (ck, j_ck)]
    msgs = []
    for cls, args in reopen:
        with pytest.raises(ValueError) as e:
            cls(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "was created for" in msgs[0]
    assert json.loads(_manifest(d))["n_items"] == 8


def test_gather_incomplete_raises(tmp_path):
    c = ck.EnsembleCheckpoint(str(tmp_path), 4, 2)
    c.write_batch(0, _compute(c.batch_indices(0)))
    with pytest.raises(RuntimeError, match=r"incomplete: \[1\]"):
        c.gather()


# --------------------------------------------------------------------------
# tud --checkpoint: kill and resume
# --------------------------------------------------------------------------

KILL_ARGS = ["tud", "--synthetic", "120", "--numin", "800", "--numax",
             "812", "--dv", "0.005", "--dv-out", "0.25", "--n-atmos", "8",
             "--batch", "2", "--n-angles", "8", "--altitudes", "2.0",
             "500.0", "--device", "cpu"]

#: the child: the port's CLI, one torch thread; with ``kill`` a wrapper
#: around EnsembleCheckpoint.write_batch kills the process with SIGKILL
#: right after the first batch file is renamed into place
CHILD = """
import os, signal, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from radtxfr_tpu_torch.dist.checkpoint import EnsembleCheckpoint
if {kill!r}:
    write = EnsembleCheckpoint.write_batch
    def write_then_die(self, b, arrays):
        write(self, b, arrays)
        os.kill(os.getpid(), signal.SIGKILL)
    EnsembleCheckpoint.write_batch = write_then_die
from radtxfr_tpu_torch.cli.main import main
main({argv!r})
"""


def _child(argv, kill=False):
    code = CHILD.format(root=ROOT, kill=kill, argv=argv)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_port_cli_kill_resume_bit_identical(tmp_path):
    ref_h5, ref_ck = str(tmp_path / "ref.h5"), str(tmp_path / "ck_ref")
    run = _child(KILL_ARGS + ["--checkpoint", ref_ck, "--output", ref_h5])
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]

    h5, ckd = str(tmp_path / "int.h5"), str(tmp_path / "ck_int")
    argv = KILL_ARGS + ["--checkpoint", ckd, "--output", h5]
    run = _child(argv, kill=True)
    assert run.returncode == -9, run.stdout[-2000:] + run.stderr[-2000:]
    assert _listing(ckd) == ["batch_000000.npz", "manifest.json"]
    assert not os.path.exists(h5)
    run = _child(argv)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert "batch 1/4" not in run.stdout and "batch 4/4" in run.stdout
    with open(ref_h5, "rb") as a, open(h5, "rb") as b:
        assert a.read() == b.read(), "resumed HDF5 differs"

    plain = str(tmp_path / "plain.h5")
    run = _child(KILL_ARGS + ["--output", plain])
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    with h5py.File(h5, "r") as f, h5py.File(plain, "r") as g:
        for k in ("X", "tau", "La", "Ld"):
            assert np.array_equal(f[k][...], g[k][...]), k
        assert f["tau"].shape == (8, 185, 2)
        assert np.isfinite(f["La"][...]).all()
