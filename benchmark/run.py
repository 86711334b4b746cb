"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Measures the PyTorch and CUDA port (``radtxfr_tpu_torch``) on one NVIDIA
card. The cell's configuration, traffic mix, driver and metric readers are
found by name from ``BENCHMARK.json`` (``benchkit/registry.py``). Set-up
(imports, inputs from the seed, the program's builders, the kernels
loaded or built, every shape warmed up) is ``setup_s``; then requests run
back to back for ``--seconds`` (``--trace 1``: a short traced window whose
per-layer metrics are read from the device trace); then the plain
reference checks a sample of the window's products, drawn from the seed.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last: each compared number beside its
limit); the compared numbers are also the last lines of standard error.
Exit status 0 with a result, else non-zero and no result: no card, fewer
cards than the cell asks for, an unknown cell, a failure, or a JAX module
loaded by the time the window closed.
"""

import time

T_ORIGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _caches():
    """Every kernel and build cache inside the checkout, at fixed paths
    (the port builds its kernels under ``radtxfr_tpu_torch/_build``)."""
    cache = os.path.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    from benchkit import registry

    try:
        cell = registry.Cell(registry.benchmark_spec(ROOT), args.workload,
                             ROOT)
    except (KeyError, OSError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {need} CUDA device(s), "
              f"{count} available", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    from benchkit.harness import run_cell

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_ORIGIN)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
