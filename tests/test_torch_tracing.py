"""The port's spans on the profiler's clock (``utils.profiling.span``) and
the one way a kernel is launched and counted (``ops._build.launch``,
``utils.profiling.COUNTS``).

No JAX here: the file also runs on the card, alone, with ``python -m
pytest --noconftest tests/test_torch_tracing.py``."""

import ast
import json
from collections import Counter
from pathlib import Path

import pytest
import torch

from custereomatching_tpu_torch import StereoConfig, StereoMatcher, utils
from custereomatching_tpu_torch.models import PyramidStereoMatcher, optimize
from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "custereomatching_tpu_torch"

# The kernels a launch may name; the large-k route's steps are its C
# entries' names after ``custereo_lk_``.
KERNELS = {"K1", "K2", "K3", "K3w", "K3m", "K4", "K5", "K6", "K7", "K8",
           "K8b", "K8h", "K8hb", "K9a", "K9b", "K10a", "K10b", "K10c"} | {
    "large_k." + e[len("custereo_lk_"):] for e in _build.SIGNATURES
    if e.startswith("custereo_lk_")}
# Entry points that launch nothing: the launchers' rounds, queried.
QUERIES = {"custereo_fused_rounds", "custereo_head_rounds"}
LAUNCHING = set(_build.SIGNATURES) - QUERIES


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda", 0)


def _pair(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(*shape, generator=g), torch.rand(*shape, generator=g))


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _named(events, name):
    found = [e for e in events if e.name == name]
    assert found, f"no span {name!r} in the profile"
    return found


def _encloses(outer, inner) -> bool:
    return (outer.thread == inner.thread
            and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


# ---------------------------------------------------------------------------
# The span helper
# ---------------------------------------------------------------------------

def test_span_off_is_one_shared_no_op(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) made off the trace")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not torch._C._autograd._profiler_enabled()
    first = profiling.span("custereo.kernel.K3")
    assert profiling.span("custereo.train.step") is first
    with first, profiling.span("custereo.train.loss"):
        pass
    assert utils.span is profiling.span


def test_span_on_records_its_range():
    def traced():
        with profiling.span("custereo.test"):
            torch.ones(3).sum()

    (outer,) = _named(_profiled(traced), "custereo.test")
    assert outer.cpu_children


# ---------------------------------------------------------------------------
# The spans of the model and the train step, on the CPU
# ---------------------------------------------------------------------------

def test_a_train_step_encloses_its_loss():
    model = StereoMatcher(StereoConfig(num_disparities=4, kernel_size=5))
    camera, projector = _pair(1, 12, 24)
    state = optimize.init_state(camera, optimize.adam(1e-2))
    step = optimize.make_train_step(model)
    target = torch.full((1, 12, 24), 2.0)
    events = _profiled(lambda: step(state, projector, target))
    (outer,) = _named(events, "custereo.train.step")
    (loss,) = _named(events, "custereo.train.loss")
    assert _encloses(outer, loss)
    assert not _encloses(loss, outer)


def test_the_allpairs_vjp_is_a_span_of_the_backward():
    model = StereoMatcher(StereoConfig(kernel_size=5))
    camera, projector = _pair(1, 10, 16, seed=1)
    state = optimize.init_state(camera, optimize.adam(1e-2))
    step = optimize.make_train_step(model)
    target = torch.full((1, 10, 16), 3.0)
    events = _profiled(lambda: step(state, projector, target))
    (vjp,) = _named(events, "custereo.vjp.allpairs")
    (loss,) = _named(events, "custereo.train.loss")
    assert not _encloses(loss, vjp)
    assert any(_encloses(e, vjp) for e in events
               if e.name.startswith("autograd::engine::evaluate_function"))


def test_disparity_maps_is_a_span():
    model = StereoMatcher(StereoConfig(num_disparities=4, kernel_size=5))
    camera, projector = _pair(2, 12, 24, seed=2)
    with torch.no_grad():
        events = _profiled(lambda: model.disparity_maps(camera, projector))
    assert len(_named(events, "custereo.model.disparity_maps")) == 1


PYRAMID_GLUE = ("custereo.pyramid.pool", "custereo.pyramid.warp",
                "custereo.pyramid.compose")


def _pyramid():
    return PyramidStereoMatcher(StereoConfig(num_disparities=12,
                                             kernel_size=5),
                                downsample=2, residual=3)


def test_a_pyramid_call_is_a_span():
    camera, projector = _pair(2, 16, 30, seed=3)
    with torch.no_grad():
        events = _profiled(lambda: _pyramid()(camera, projector))
    assert len(_named(events, "custereo.model.pyramid")) == 1


def test_the_pyramid_span_encloses_its_glue_and_both_levels():
    camera, projector = _pair(1, 16, 30, seed=4)
    with torch.no_grad():
        events = _profiled(lambda: _pyramid()(camera, projector))
    (outer,) = _named(events, "custereo.model.pyramid")
    for name in PYRAMID_GLUE:
        (glue,) = _named(events, name)
        assert _encloses(outer, glue)
    levels = _named(events, "custereo.model.disparity_maps")
    assert len(levels) == 2
    assert all(_encloses(outer, level) for level in levels)
    (pool,), (warp,), (compose,) = (_named(events, n) for n in PYRAMID_GLUE)
    coarse, fine = sorted(levels, key=lambda e: e.time_range.start)
    assert (pool.time_range.end <= coarse.time_range.start
            and coarse.time_range.end <= warp.time_range.start
            and warp.time_range.end <= fine.time_range.start
            and fine.time_range.end <= compose.time_range.start)


def test_the_pyramid_spans_are_the_shared_no_op_off_the_trace(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) made off the trace")

    camera, projector = _pair(1, 16, 30, seed=5)
    model = _pyramid()
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not torch._C._autograd._profiler_enabled()
    with torch.no_grad():
        maps = model(camera, projector)
    assert maps.mask.shape == camera.shape


# ---------------------------------------------------------------------------
# Every launch goes through _build.launch, naming its kernel
# ---------------------------------------------------------------------------

def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


class _Module:
    """A source's functions, the function around each node, and the
    strings an argument of a launch can take."""

    def __init__(self, path: Path):
        self.path = path
        self.tree = ast.parse(path.read_text())
        self.owner = {}
        for fn in ast.walk(self.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    self.owner[node] = fn      # innermost wins: walk order

    def calls_of(self, name):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Name) and node.func.id == name:
                yield node

    def strings(self, expr, fn):
        """Every value ``expr`` can take inside ``fn``: constants, their
        conditionals and f-strings, local names and parameters followed
        back to their values and to the module's calls of ``fn``."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return {expr.value}
        if isinstance(expr, ast.IfExp):
            return self.strings(expr.body, fn) | self.strings(expr.orelse,
                                                              fn)
        if isinstance(expr, ast.JoinedStr):
            out = {""}
            for part in expr.values:
                vals = (self.strings(part.value, fn)
                        if isinstance(part, ast.FormattedValue)
                        else {part.value})
                out = {a + b for a in out for b in vals}
            return out
        if isinstance(expr, ast.Name) and fn is not None:
            params = [a.arg for a in fn.args.args]
            if expr.id in params:
                i = params.index(expr.id)
                out = set()
                for call in self.calls_of(fn.name):
                    arg = next((k.value for k in call.keywords
                                if k.arg == expr.id), None)
                    if arg is None:
                        arg = call.args[i]
                    out |= self.strings(arg, self.owner.get(call))
                assert out, f"{self.path}: no call of {fn.name}"
                return out
            values = [n.value for n in ast.walk(fn)
                      if isinstance(n, ast.Assign) and any(
                          isinstance(t, ast.Name) and t.id == expr.id
                          for t in n.targets)]
            if values:
                return set().union(*(self.strings(v, fn) for v in values))
        raise AssertionError(f"{self.path}:{expr.lineno}: cannot follow "
                             f"{ast.unparse(expr)} back to its strings")


def _library_calls(tree):
    """Names bound to ``kernels()`` and the calls of it."""
    def is_kernels(node):
        f = node.func if isinstance(node, ast.Call) else None
        return (isinstance(f, ast.Name) and f.id == "kernels") or (
            isinstance(f, ast.Attribute) and f.attr == "kernels")
    bound = {t.id for n in ast.walk(tree) if isinstance(n, ast.Assign)
             and is_kernels(n.value) for t in n.targets
             if isinstance(t, ast.Name)}
    return is_kernels, bound


def test_every_launch_goes_through_build_launch():
    kernels, entries = set(), set()
    for path in _sources():
        mod = _Module(path)
        is_kernels, bound = _library_calls(mod.tree)
        for node in ast.walk(mod.tree):
            where = f"{path.relative_to(ROOT)}:{getattr(node, 'lineno', 0)}"
            # No entry point is called by attribute, ...
            if isinstance(node, ast.Attribute):
                assert node.attr not in LAUNCHING, where
            # ... nor looked up on the library but by launch.
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Name) and node.func.id == "getattr":
                target = node.args[0]
                on_library = is_kernels(target) or (
                    isinstance(target, ast.Name) and target.id in bound)
                assert not on_library or (
                    path.name == "_build.py"
                    and mod.owner[node].name == "launch"), where
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr == "launch" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "_build":
                fn = mod.owner.get(node)
                named = mod.strings(node.args[0], fn)
                called = mod.strings(node.args[1], fn)
                assert named <= KERNELS, (where, named - KERNELS)
                assert called <= LAUNCHING, (where, called - LAUNCHING)
                kernels |= named
                entries |= called
    assert kernels == KERNELS
    assert entries == LAUNCHING


def test_launch_names_the_kernel_and_raises_as_check(monkeypatch):
    seen = []

    class Library:
        def custereo_banded_volume(self, *args):
            seen.append((args, torch._C._autograd._profiler_enabled()))
            return 9

        def custereo_error_string(self, code):
            return b"invalid configuration argument"

    monkeypatch.setattr(_build, "kernels", lambda: Library())
    with pytest.raises(RuntimeError, match="K1 launch: CUDA error 9"):
        _build.launch("K1", "custereo_banded_volume", 1, 2)

    def profiled():
        with pytest.raises(RuntimeError, match="^K1 banded volume launch"):
            _build.launch("K1", "custereo_banded_volume", 3,
                          what="K1 banded volume launch")

    events = _profiled(profiled)
    assert len(_named(events, "custereo.kernel.K1")) == 1
    assert seen == [((1, 2), False), ((3,), True)]


def test_launch_counts_a_launch_once_under_its_span_name(monkeypatch):
    codes = [0, 700]

    class Library:
        def custereo_volume_head_grad(self, *args):
            return codes.pop(0)

        def custereo_error_string(self, code):
            return b"an illegal memory access was encountered"

    monkeypatch.setattr(_build, "kernels", lambda: Library())
    before = profiling.COUNTS.copy()
    events = _profiled(lambda: _build.launch(
        "K8hb", "custereo_volume_head_grad", 1))
    assert profiling.COUNTS - before == Counter({"K8hb": 1})
    assert [e.name for e in events if e.name.startswith("custereo.")] == [
        "custereo.kernel.K8hb"]
    # A launch that fails raises and counts nothing.
    before = profiling.COUNTS.copy()
    with pytest.raises(RuntimeError, match="K8hb launch: CUDA error 700"):
        _build.launch("K8hb", "custereo_volume_head_grad", 2)
    assert profiling.COUNTS == before
    assert codes == []


def test_no_function_carries_a_counter():
    """What ran is counted in ``profiling.COUNTS`` alone: no source sets
    or bumps a ``launches`` or ``calls`` attribute."""
    for path in _sources() + [PACKAGE / "bench.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            targets = (node.targets if isinstance(node, ast.Assign) else
                       [node.target] if isinstance(node, ast.AugAssign)
                       else [])
            for t in targets:
                assert not (isinstance(t, ast.Attribute) and (
                    t.attr.endswith("launches") or t.attr == "calls")), \
                    f"{path.relative_to(ROOT)}:{node.lineno}"


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.card
def test_the_k3_span_encloses_its_kernel_launch(card, tmp_path):
    from custereomatching_tpu_torch.ops.cuda_pipeline import (
        stereo_pipeline_cuda,
    )

    camera, projector = (x.to(card) for x in _pair(2, 64, 128, seed=3))
    stereo_pipeline_cuda(camera, projector, 16, 5, 1e-5, 50.0, 0.6)
    torch.cuda.synchronize(card)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        stereo_pipeline_cuda(camera, projector, 16, 5, 1e-5, 50.0, 0.6)
        torch.cuda.synchronize(card)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    kernel = [e for e in events if e.get("cat") == "kernel"
              and "fused_pipeline_kernel" in e["name"]]
    assert len(kernel) == 1
    corr = kernel[0]["args"]["correlation"]
    (rt,) = [e for e in events if e.get("cat") == "cuda_runtime"
             and e.get("args", {}).get("correlation") == corr]
    spans = [e for e in events if e["name"] == "custereo.kernel.K3"
             and e.get("cat") == "user_annotation"]
    assert len(spans) == 1
    s = spans[0]
    assert (s["pid"], s["tid"]) == (rt["pid"], rt["tid"])
    assert s["ts"] <= rt["ts"] <= s["ts"] + s["dur"]
