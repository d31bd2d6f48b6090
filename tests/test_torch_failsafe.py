"""PyTorch port: failure classification, retries and the health probe
(``utils/failsafe.py``) and the engine's ``retries`` and ``healthy()``.
The six cases of tests/test_failsafe.py run against the port, then the
classification of CUDA errors by code."""

import numpy as np
import pytest
import torch

from custereomatching_tpu.utils import failsafe as jax_failsafe
from custereomatching_tpu_torch import StereoConfig, StereoEngine
from custereomatching_tpu_torch.utils import failsafe
from custereomatching_tpu_torch.utils.failsafe import (
    CUDA_STICKY_CODES,
    CUDA_TRANSIENT_CODES,
    device_healthcheck,
    is_transient_device_error,
    with_retries,
)


class _FakeDeviceError(RuntimeError):
    pass


def test_classification():
    cases = [_FakeDeviceError("UNAVAILABLE: device preempted"),
             _FakeDeviceError("HTTP 500: remote_compile relay"),
             ValueError("bad shape"), RuntimeError("INVALID_ARGUMENT")]
    for exc, want in zip(cases, (True, True, False, False)):
        assert is_transient_device_error(exc) is want
        assert jax_failsafe.is_transient_device_error(exc) is want
    assert failsafe.TRANSIENT_MARKERS == jax_failsafe.TRANSIENT_MARKERS


def test_retry_recovers_from_transient_faults():
    calls = {"n": 0}
    seen = []

    def flaky(x):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise _FakeDeviceError("UNAVAILABLE: transient")
        return x * 2

    fn = with_retries(flaky, retries=3, backoff_s=0.001,
                      on_retry=lambda a, e: seen.append(a))
    assert fn(21) == 42
    assert calls["n"] == 3
    assert seen == [1, 2]


def test_retry_budget_exhausted_reraises():
    def always_down(_):
        raise _FakeDeviceError("UNAVAILABLE: still down")

    fn = with_retries(always_down, retries=2, backoff_s=0.001)
    with pytest.raises(_FakeDeviceError):
        fn(0)


def test_nontransient_raises_immediately():
    calls = {"n": 0}

    def broken(_):
        calls["n"] += 1
        raise ValueError("shape mismatch")

    fn = with_retries(broken, retries=5, backoff_s=0.001)
    with pytest.raises(ValueError):
        fn(0)
    assert calls["n"] == 1


def test_device_healthcheck():
    """The probe computes on the card unless asked for the CPU: true on the
    CPU when asked, and by default exactly when a card is there; a device
    that cannot run it gives False, not an exception."""
    assert device_healthcheck("cpu") is True
    assert device_healthcheck() is torch.cuda.is_available()
    assert device_healthcheck("cpu", tolerance=-1.0) is False
    assert device_healthcheck("no-such-device") is False


def test_engine_retry_and_health():
    """The engine with retries survives an injected transient fault."""
    eng = StereoEngine(StereoConfig(kernel_size=5, num_disparities=6),
                       buckets=[(32, 64)], retries=2, device="cpu")
    assert eng.healthy()
    inner = eng._fn
    state = {"fail": 1}

    def flaky(c, p):
        if state["fail"]:
            state["fail"] -= 1
            raise _FakeDeviceError("UNAVAILABLE: injected")
        return inner(c, p)

    eng._fn = with_retries(flaky, retries=2, backoff_s=0.001)
    rng = np.random.default_rng(0)
    cam = rng.random((24, 48), dtype=np.float32)
    out = eng.infer(cam, cam)
    assert out.disparity.shape == (24, 48)
    assert state["fail"] == 0


def _launch_error(code, msg="msg"):
    """The message a kernel wrapper raises (``ops/_build.py::check``)."""
    return RuntimeError(f"K3 fused pipeline launch: CUDA error {code} "
                        f"({msg})")


@pytest.mark.parametrize("code", sorted(CUDA_TRANSIENT_CODES)
                         + sorted(CUDA_STICKY_CODES) + [1, 98, 209])
def test_cuda_codes_classify(code):
    """An allocation failure (2) and a busy or unavailable device (46) are
    transient; a sticky error that poisons the context (214, 700, 710,
    714-719) never is, nor is a configuration error (1: invalid value; 98:
    invalid device function; 209: no kernel image)."""
    want = code in CUDA_TRANSIENT_CODES
    assert is_transient_device_error(_launch_error(code)) is want
    assert failsafe.cuda_error_code(_launch_error(code)) == code


def test_sticky_table():
    assert set(CUDA_STICKY_CODES) == {214, 700, 710, 714, 715, 716, 717, 718,
                                      719}
    assert not set(CUDA_STICKY_CODES) & set(CUDA_TRANSIENT_CODES)


def test_torch_cuda_messages_classify():
    """PyTorch's own CUDA errors carry no code: its out-of-memory error is
    transient, the runtime's sticky messages are not, even beside a
    marker that would otherwise retry."""
    assert is_transient_device_error(
        torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"))
    assert is_transient_device_error(RuntimeError(
        "CUDA error: all CUDA-capable devices are busy or unavailable"))
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: device-side assert triggered",
                "CUDA error: unspecified launch failure UNAVAILABLE"):
        assert not is_transient_device_error(RuntimeError(msg))


def test_sticky_error_raises_at_once_and_oom_empties_the_cache(monkeypatch):
    """A sticky code is raised on the first try; an allocation failure is
    retried after PyTorch's cache is emptied, and the call served."""
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: emptied.append(1))
    calls = {"n": 0}

    def sticky():
        calls["n"] += 1
        raise _launch_error(700, "an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="CUDA error 700"):
        with_retries(sticky, retries=3, backoff_s=0.001)()
    assert calls["n"] == 1 and not emptied

    state = {"fail": 2}

    def oom():
        if state["fail"]:
            state["fail"] -= 1
            raise (_launch_error(2, "out of memory") if state["fail"]
                   else torch.cuda.OutOfMemoryError("CUDA out of memory"))
        return "served"

    assert with_retries(oom, retries=2, backoff_s=0.001)() == "served"
    assert len(emptied) == 2


def test_engine_retries_an_injected_allocation_failure():
    """The engine's own wrapper (``retries=2``) serves a frame whose first
    try hits an allocation failure, and raises a sticky one at once."""
    eng = StereoEngine(StereoConfig(kernel_size=3, num_disparities=4),
                       buckets=[(16, 32)], retries=2, device="cpu")
    model_maps = eng.model.disparity_maps
    state = {"fail": 1, "calls": 0}

    def flaky(c, p):
        state["calls"] += 1
        if state["fail"]:
            state["fail"] -= 1
            raise _launch_error(state.get("code", 2))
        return model_maps(c, p)

    eng.model.disparity_maps = flaky
    eng._fn = eng._wrap(eng.model.disparity_maps)
    rng = np.random.default_rng(1)
    cam = rng.random((12, 30), dtype=np.float32)
    out = eng.infer(cam, cam)
    assert out.mask.shape == (12, 30) and state["calls"] == 2
    state.update(fail=1, calls=0, code=719)
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        eng.infer(cam, cam)
    assert state["calls"] == 1
