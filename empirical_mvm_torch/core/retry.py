"""Bounded retries for host IO (counterpart of
``empirical_mvm_tpu/core/retry.py``).

TSV shards are read from network filesystems, where a read can fail for a
moment and succeed when tried again. :func:`retry_io` retries such errors a
few times with exponential backoff; an error that will not go away (a
missing file, a permission, a bad argument) raises at once. Used by
``data/tsv.py`` ``TSVFile.seek``.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

# transient network-FS errors are retried; these errnos re-raise at once
_RETRYABLE = (TimeoutError, InterruptedError, BlockingIOError, OSError)
_FATAL_ERRNO = {2, 13, 21, 22}   # ENOENT, EACCES, EISDIR, EINVAL


def retry_io(fn: Callable[[], T], *, attempts: int = 3,
             base_delay: float = 0.1, what: str = "io") -> T:
    """Run ``fn`` with up to ``attempts`` tries and exponential backoff.

    Retries transient OS-level errors only; deterministic failures
    (missing file, permissions, bad args) raise on the first attempt.
    """
    delay = base_delay
    for attempt in range(attempts):
        try:
            return fn()
        except _RETRYABLE as e:  # noqa: PERF203
            if isinstance(e, OSError) and e.errno in _FATAL_ERRNO:
                raise
            if attempt + 1 >= attempts:
                raise
            logger.warning("%s failed (%s: %s); retry %d/%d in %.1fs",
                           what, type(e).__name__, e, attempt + 1,
                           attempts - 1, delay)
            time.sleep(delay)
            delay *= 2
    raise AssertionError("unreachable")
