"""The port's ``utils`` (``radtxfr_tpu_torch/utils``) against
``radtxfr_tpu.utils`` on the CPU: the ``PhaseTimer`` report and rates, a
``MetricsLog`` round trip, ``retry``'s attempts and error, ``f32_matmuls``
restoring the TF32 flags, ``enable_persistent_cache`` moving the kernels'
build directory (and restoring it), ``get_help`` on a bare name, and the
``tud`` command's phase report."""

import importlib
import os

import pytest
import torch

from radtxfr_tpu import utils as jax_utils

from radtxfr_tpu_torch import _build, utils
from radtxfr_tpu_torch.lines import native_parser
from port_fixtures import one_torch_thread  # noqa: F401


class _Clock:
    """A fake ``time.perf_counter``: each phase lasts the next duration."""

    def __init__(self, durations):
        self.t, self.steps, self.start = 0.0, list(durations), True

    def __call__(self):
        if not self.start:
            self.t += self.steps.pop(0)
        self.start = not self.start
        return self.t


@pytest.mark.parametrize("pkg", [jax_utils, utils], ids=["jax", "port"])
def test_phase_timer_report_and_rates(monkeypatch, pkg):
    clock = _Clock([0.5, 2.0, 0.25, 1.0])
    monkeypatch.setattr(pkg.profiling.time, "perf_counter", clock)
    timer = pkg.PhaseTimer()
    with timer.phase("build"):
        pass
    with timer.phase("od+tud+reduce", work_items=1000.0):
        pass
    with timer.phase("reduce"):
        pass
    with timer.phase("od+tud+reduce", work_items=500.0,
                     block_on=[torch.zeros(2)]):
        pass
    assert timer.phases == {"build": 0.5, "od+tud+reduce": 3.0,
                            "reduce": 0.25}
    assert timer.rates() == {"od+tud+reduce": 500.0}
    assert timer.report() == (
        "           od+tud+reduce:     3.000 s  (5.000e+02 items/s)\n"
        "                   build:     0.500 s\n"
        "                  reduce:     0.250 s")


def test_device_sync_returns_its_argument_on_the_cpu():
    x = {"a": [torch.ones(3)], "b": (torch.zeros(1), 2)}
    assert utils.device_sync(x) is x


@pytest.mark.parametrize("pkg", [jax_utils, utils], ids=["jax", "port"])
def test_metrics_log_round_trip(tmp_path, pkg):
    log = pkg.MetricsLog(str(tmp_path / "m.jsonl"))
    assert log.read() == []
    log.log(step=1, loss=0.5, t=10.0)
    log.log(step=2, name="x")
    rows = log.read()
    assert rows[0] == {"step": 1, "loss": 0.5, "t": 10.0}
    assert rows[1]["step"] == 2 and rows[1]["name"] == "x" and "t" in rows[1]


@pytest.mark.parametrize("pkg", [jax_utils, utils], ids=["jax", "port"])
def test_retry_attempts_and_error(monkeypatch, pkg):
    sleeps, logs, calls = [], [], []
    monkeypatch.setattr(importlib.import_module(pkg.retry.__module__).time,
                        "sleep", sleeps.append)

    @pkg.retry(n_attempts=3, backoff_s=0.5, exceptions=(OSError,),
               log=logs.append)
    def flaky(fail_times):
        calls.append(1)
        if len(calls) <= fail_times:
            raise OSError(f"try {len(calls)}")
        return "ok"

    assert flaky(2) == "ok" and len(calls) == 3
    assert sleeps == [0.5, 1.0] and len(logs) == 2
    calls.clear()
    with pytest.raises(RuntimeError, match="failed after 3 attempts") as e:
        flaky(5)
    assert isinstance(e.value.__cause__, OSError)
    calls.clear()

    @pkg.retry(n_attempts=3, exceptions=(OSError,))
    def wrong():
        calls.append(1)
        raise KeyError("not retried")

    with pytest.raises(KeyError):
        wrong()
    assert len(calls) == 1


@pytest.mark.parametrize("before", [False, True])
def test_f32_matmuls_restores_the_tf32_flags(before):
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    seen = []

    @utils.f32_matmuls
    def fn(x):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        if x:
            raise ValueError("inside")
        return x @ x if isinstance(x, torch.Tensor) else x

    try:
        torch.backends.cuda.matmul.allow_tf32 = before
        torch.backends.cudnn.allow_tf32 = before
        assert fn(0) == 0
        with pytest.raises(ValueError):
            fn(1)
        assert seen == [(False, False)] * 2
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (before, before)
        assert fn.__name__ == "fn"
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def test_enable_persistent_cache(tmp_path, monkeypatch):
    before = (_build.BUILD_DIR, native_parser.BUILD_DIR)
    try:
        monkeypatch.delenv("RADTXFR_CACHE_DIR", raising=False)
        assert utils.enable_persistent_cache() == _build.DEFAULT_BUILD_DIR
        d = str(tmp_path / "given")
        assert utils.enable_persistent_cache(d, min_compile_secs=5.0) == d
        assert os.path.isdir(d)
        assert _build.BUILD_DIR == native_parser.BUILD_DIR == d
        assert os.path.dirname(_build.library_path(_build._sources()[0])) == d
        env = str(tmp_path / "from_env")
        monkeypatch.setenv("RADTXFR_CACHE_DIR", env)
        assert utils.enable_persistent_cache() == env
        assert _build.BUILD_DIR == env and os.path.isdir(env)
        assert utils.enable_persistent_cache(d) == d   # the argument wins
    finally:
        _build.BUILD_DIR, native_parser.BUILD_DIR = before


def test_get_help_and_api_index():
    out = []
    utils.get_help("build_xs_table", _print=out.append)
    assert out[0].startswith(
        "radtxfr_tpu_torch.products.od_from_xs.build_xs_table(")
    assert "Fill an :class:`XsTable`" in out[0]
    out.clear()
    utils.get_help("products.make_tud_fn", _print=out.append)
    assert out[0].startswith("radtxfr_tpu_torch.products.tud.make_tud_fn(")
    with pytest.raises(ValueError, match="no such name"):
        utils.get_help("no_such_function")
    out.clear()
    utils.get_help(_print=out.append)
    assert "  radtxfr_tpu_torch.utils:" in out
    index = utils.api_index()
    assert "od_from_xs" in index["products"]
    assert "PhaseTimer" in index["utils"]


def test_tud_prints_the_phase_report(capsys):
    from radtxfr_tpu_torch.cli.main import main

    main("tud --derived --numin 718 --numax 719 --dv 0.01 --n-atmos 1 "
         "--batch 1 --device cpu".split())
    out = capsys.readouterr().out
    assert "tud [cpu]: 1 members" in out
    for name in ("build", "od+tud+reduce"):
        assert f"{name:>24s}: " in out
