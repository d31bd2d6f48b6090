"""Failure detection and recovery for serving and training (PyTorch port).

The counterpart of ``custereomatching_tpu/utils/failsafe.py``, with its
names and signatures:

* :func:`is_transient_device_error`: is a fault worth retrying?  The JAX
  package's message markers (device preemption, relay hiccups) still
  classify, so the same messages give the same answer; CUDA faults are
  classified by their error code (the kernels' launch check raises
  ``"...: CUDA error {code} ({msg})"``, ``ops/_build.py``) or by the
  runtime's message where PyTorch raised them;
* :func:`with_retries`: bounded retry with backoff; persistent faults
  re-raise after the budget, and an allocation failure empties PyTorch's
  cache before the next try;
* :func:`device_healthcheck`: a tiny computation on the card, read back
  and checked, for readiness probes.

A sticky CUDA error (an illegal address, a launch failure, a device-side
assert, an uncorrectable ECC error) leaves the process's context unusable:
every later call fails too, so it is never retried in-process.  The op is
stateless, so a transient fault (an allocation failure, a device busy or
unavailable) can be retried with the same inputs.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Iterable, Optional, TypeVar

import torch

T = TypeVar("T")

# Substrings that mark an error as plausibly transient on the JAX
# package's TPU/PJRT stack; kept so its messages classify the same.
TRANSIENT_MARKERS: tuple = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "Socket closed",
    "connection reset",
    "Connection reset",
    "temporarily unavailable",
    "remote_compile",
    "HTTP 5",
)

# CUDA runtime error codes (cudaError_t) that a retry may clear: the
# context stays usable.
CUDA_TRANSIENT_CODES = {
    2: "cudaErrorMemoryAllocation",
    46: "cudaErrorDevicesUnavailable",
}
# Sticky CUDA errors: the context is corrupted and every later call in the
# process fails; never retried.
CUDA_STICKY_CODES = {
    214: "cudaErrorECCUncorrectable",
    700: "cudaErrorIllegalAddress",
    710: "cudaErrorAssert",
    714: "cudaErrorHardwareStackError",
    715: "cudaErrorIllegalInstruction",
    716: "cudaErrorMisalignedAddress",
    717: "cudaErrorInvalidAddressSpace",
    718: "cudaErrorInvalidPc",
    719: "cudaErrorLaunchFailure",
}
# The runtime's messages for the same cases, where PyTorch raised them
# without a code.
CUDA_TRANSIENT_MESSAGES = ("out of memory", "busy or unavailable")
CUDA_STICKY_MESSAGES = ("illegal memory access", "device-side assert",
                        "unspecified launch failure", "misaligned address",
                        "illegal instruction", "uncorrectable ECC",
                        "hardware stack error", "invalid program counter")

_CODE = re.compile(r"CUDA error (\d+)")


def cuda_error_code(exc: BaseException) -> Optional[int]:
    """The CUDA error code in a kernel launch's error message, or None."""
    m = _CODE.search(str(exc))
    return int(m.group(1)) if m else None


def _out_of_memory(exc: BaseException) -> bool:
    return (isinstance(exc, torch.cuda.OutOfMemoryError)
            or cuda_error_code(exc) == 2)


def is_transient_device_error(exc: BaseException,
                              markers: Iterable[str] = TRANSIENT_MARKERS
                              ) -> bool:
    """Heuristic: is ``exc`` a fault worth retrying?

    Programming errors (shape, type and value errors) are never transient.
    A CUDA error code is transient only if it is in
    ``CUDA_TRANSIENT_CODES``; a sticky one (``CUDA_STICKY_CODES``) never
    is.  Without a code, PyTorch's out-of-memory error and the runtime's
    transient messages are, its sticky messages are not, and anything else
    is classified by ``markers``.
    """
    if isinstance(exc, (ValueError, TypeError, KeyError, AssertionError)):
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    code = cuda_error_code(exc)
    if code is not None:
        return code in CUDA_TRANSIENT_CODES
    msg = str(exc)
    if any(m in msg for m in CUDA_STICKY_MESSAGES):
        return False
    if any(m in msg for m in CUDA_TRANSIENT_MESSAGES):
        return True
    return any(m in msg for m in markers)


def with_retries(
    fn: Callable[..., T],
    *,
    retries: int = 2,
    backoff_s: float = 0.5,
    backoff_factor: float = 2.0,
    classify: Callable[[BaseException], bool] = is_transient_device_error,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> Callable[..., T]:
    """Wrap ``fn`` with bounded retry on transient device faults.

    Non-transient errors raise at once; transient ones retry up to
    ``retries`` times with exponential backoff, then re-raise.  Before
    retrying an allocation failure the wrapper releases PyTorch's cached
    device memory (``torch.cuda.empty_cache()``).  ``on_retry(attempt,
    exc)`` is called before each retry (a logging or metrics hook).
    """

    def wrapped(*args, **kwargs) -> T:
        delay = backoff_s
        for attempt in range(retries + 1):
            try:
                return fn(*args, **kwargs)
            except BaseException as exc:  # noqa: B036 -- classified below
                if attempt >= retries or not classify(exc):
                    raise
                if _out_of_memory(exc):
                    torch.cuda.empty_cache()
                if on_retry is not None:
                    on_retry(attempt + 1, exc)
                time.sleep(delay)
                delay *= backoff_factor
        raise AssertionError("unreachable")

    return wrapped


def device_healthcheck(device=None, tolerance: float = 1e-6) -> bool:
    """Run a tiny computation on ``device`` (the current CUDA card unless
    the caller names another, e.g. ``"cpu"``), read the answer back and
    check it: sum of squares of 0..7 = 140.

    Returns True iff the device computed it; False without a card or on
    any error (a readiness probe that catches a wedged context that still
    accepts launches)."""
    try:
        if device is None:
            if not torch.cuda.is_available():
                return False
            device = torch.device("cuda", torch.cuda.current_device())
        x = torch.arange(8, dtype=torch.float32, device=device)
        y = float((x * x).sum().cpu())
        return bool(abs(y - 140.0) <= tolerance)
    except Exception:
        return False
