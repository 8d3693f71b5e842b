"""Retry with exponential backoff + jitter (the port's copy of
``paddle_tpu/utils/retry.py``, which imports no JAX either: the port keeps
its own so that it never imports ``paddle_tpu``).

Reference analog: the retry loops scattered through the reference's
filesystem/HDFS clients (fluid/incubate/fleet/utils/fs.py wraps every remote
call in a bounded retry); here the policy is one reusable object so the
checkpoint writer, the launch controller's restart loop and any RPC caller
share the same backoff math.

Jitter matters on fleets: a preempted pod's ranks all hit the shared
filesystem again at the same instant after a transient error; the multiplier
spreads them out so the retry storm does not reproduce the overload that
caused the error.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["RetryPolicy", "backoff_delay"]


def backoff_delay(attempt: int, base: float, cap: float = 30.0,
                  multiplier: float = 2.0, jitter: float = 0.5,
                  rng: Optional[random.Random] = None) -> float:
    """Delay before retry number `attempt` (1-based): exponential growth
    capped at `cap`, then inflated by up to `jitter` fraction uniformly."""
    if base <= 0:
        return 0.0
    delay = min(base * (multiplier ** max(attempt - 1, 0)), cap)
    if jitter > 0:
        delay *= 1.0 + (rng or random).uniform(0.0, jitter)
    return delay


class RetryPolicy:
    """Bounded retry of a callable on transient errors.

    ``policy(fn, *args)`` runs fn; on an exception in `retry_on` it sleeps
    ``backoff_delay(attempt)`` and retries, up to `max_attempts` total calls,
    then re-raises the last error. `on_retry(attempt, exc)` observes every
    retry (telemetry hook); `sleep` is injectable for tests.
    """

    def __init__(self, max_attempts: int = 4, base_delay: float = 0.1,
                 max_delay: float = 30.0, multiplier: float = 2.0,
                 jitter: float = 0.5,
                 retry_on: Tuple[Type[BaseException], ...] = (OSError,),
                 on_retry: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self.retry_on = retry_on
        self.on_retry = on_retry
        self._sleep = sleep
        self._rng = rng or random.Random()

    def delay(self, attempt: int) -> float:
        return backoff_delay(attempt, self.base_delay, self.max_delay,
                             self.multiplier, self.jitter, self._rng)

    def __call__(self, fn: Callable, *args, **kwargs):
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                if attempt >= self.max_attempts:
                    raise
                if self.on_retry is not None:
                    try:
                        self.on_retry(attempt, e)
                    except Exception:
                        pass  # a broken telemetry hook must not end the retry
                self._sleep(self.delay(attempt))

    call = __call__
