"""Failure handling: bounded retry with backoff (counterpart of
``radtxfr_tpu/utils/retry.py``).

The reference's failure mode is print-and-return-empty (LBLRTM stderr check,
``radiative_transfer.py:495-499``), which crashes callers downstream.
Transient failures (a lost device, flaky IO) instead get bounded, logged
retries; persistent failures raise with context.
"""

from __future__ import annotations

import functools
import time

__all__ = ["retry"]


def retry(n_attempts: int = 3, backoff_s: float = 1.0,
          exceptions=(Exception,), log=None):
    """Decorator: retry up to ``n_attempts`` with linear backoff; then
    ``RuntimeError`` from the last failure."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            last = None
            for attempt in range(n_attempts):
                try:
                    return fn(*args, **kwargs)
                except exceptions as e:  # noqa: PERF203
                    last = e
                    if log:
                        log(f"{fn.__name__}: attempt {attempt + 1}/"
                            f"{n_attempts} failed: {e!r}")
                    if attempt + 1 < n_attempts:
                        time.sleep(backoff_s * (attempt + 1))
            raise RuntimeError(
                f"{fn.__name__} failed after {n_attempts} attempts"
            ) from last

        return wrapped

    return deco
