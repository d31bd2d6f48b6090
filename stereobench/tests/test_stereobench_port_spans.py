"""The readers of the port's spans (``forward_ms.step``, ``host_ms.*``,
``port_gap_ms.*``) on small synthetic traces: two host threads, the
main one and the autograd engine's, and the card's stream."""

import pytest

from stereobench import harness, tracing

MAIN, AUTOGRAD, STREAM = 1, 2, 7
READERS = ("forward_ms.step", "host_ms.step", "host_ms.pipeline",
           "port_gap_ms.step", "port_gap_ms.pipeline")


def host(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 2, "pid": 1, "tid": tid,
            "args": {"correlation": corr}}


def kernel(corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"kernel_{corr}", "ts": ts,
            "dur": dur, "pid": 0, "tid": STREAM,
            "args": {"correlation": corr}}


def summary(events, units):
    return tracing.Summary([host(tracing.STRETCH, 0, 1000)] + events,
                           units, units, None, None)


def read(name, t):
    return harness.reader(name)(t)


def train_steps():
    """Two steps' worth: the forward (K3w, then a loss op) inside
    ``custereo.train.loss`` on the main thread, K4 on the autograd thread
    inside an ``evaluate_function`` span, then Adam."""
    return summary([
        host("stereobench.train_step", 5, 990),
        host("custereo.train.step", 10, 980),
        host("custereo.train.loss", 20, 280),
        host("custereo.kernel.K3w", 30, 30), launch(1, 40),
        kernel(1, 100, 150),                        # gap 0-100: K3w's
        host("aten::mul", 270, 20), launch(2, 280),
        kernel(2, 300, 20),                         # gap 250-300: loss
        host("autograd::engine::evaluate_function: MulBackward0", 330, 20,
             AUTOGRAD), launch(3, 340, AUTOGRAD),
        kernel(3, 360, 20),                         # gap 320-360: none
        host("autograd::engine::evaluate_function: _TrainablePipeline"
             "Backward", 370, 60, AUTOGRAD),
        host("custereo.kernel.K4", 380, 20, AUTOGRAD),
        launch(4, 390, AUTOGRAD),
        kernel(4, 400, 400),                        # gap 380-400: K4's
        host(tracing.OPTIMIZER, 800, 100), launch(5, 850),
        kernel(5, 900, 50),                         # gap 800-900: step
    ], units=2)


def test_the_forward_is_what_the_loss_launched():
    t = train_steps()
    assert read("forward_ms.step", t) == pytest.approx(1e-3 * 170 / 2)
    assert read("backward_ms.step", t) == pytest.approx(1e-3 * 420 / 2)
    assert read("optimizer_ms.step", t) == pytest.approx(1e-3 * 50 / 2)


def test_the_host_time_is_the_step_span():
    assert read("host_ms.step", train_steps()) == pytest.approx(
        1e-3 * 980 / 2)


def test_a_gap_counts_by_the_next_launch_whole_chain():
    # 100 (K3w) + 50 (the loss's op) + 20 (K4 on the autograd thread) +
    # 100 (Adam, inside the step); not 40 before MulBackward0's kernel.
    assert read("port_gap_ms.step", train_steps()) == pytest.approx(
        1e-3 * 270 / 2)


def stream_calls():
    """Two calls: the first under a bare benchmark span (a program
    without the port's spans), the second through the port's; another
    thread's launch in the port's span's time does not belong to it."""
    return summary([
        host("stereobench.disparity_maps", 10, 90), launch(1, 50),
        kernel(1, 200, 100),                        # gap 0-200: bare
        host("stereobench.disparity_maps", 310, 90),
        host("custereo.model.disparity_maps", 320, 70),
        host("custereo.kernel.K3", 330, 20), launch(2, 340),
        kernel(2, 500, 100),                        # gap 300-500: K3's
        launch(3, 335, AUTOGRAD),
        kernel(3, 700, 50),                         # gap 600-700: none
    ], units=2)


def test_a_gap_before_the_port_kernel_counts_and_a_bare_one_not():
    t = stream_calls()
    assert read("port_gap_ms.pipeline", t) == pytest.approx(1e-3 * 200 / 2)
    assert read("host_ms.pipeline", t) == pytest.approx(1e-3 * 70 / 2)
    labels = dict(t.breakdown()["idle_gaps"])
    assert labels["stereobench.disparity_maps > custereo.kernel.K3"] == \
        pytest.approx(200e-6)


@pytest.mark.parametrize("name", READERS)
def test_a_trace_without_the_port_spans_reads_nothing(name):
    t = summary([
        host("stereobench.train_step", 10, 300), launch(1, 20),
        kernel(1, 100, 100),
        host("stereobench.disparity_maps", 400, 100), launch(2, 410),
        kernel(2, 600, 100),
    ], units=2)
    assert read(name, t) is None
