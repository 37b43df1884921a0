"""The span readers (``metrics/spans.py``) on hand-made event lists: the
attribution rule (a launch from a second thread included), idle time
inside a span, the step's waits for the card, the readers' silence on a
program without spans, and the traced slice of ``trace.py`` unchanged by
the spans on the same events."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import trace, trace_spans
from benchmark.metrics import readers, spans
from benchmark.metrics.spans import Dev, Host, SpanSlice

MAIN, AUTOGRAD, OTHER = 1, 2, 3


def _step_slice(calls=1):
    """One step: spans on the main thread, a backward launched from the
    autograd engine's thread, an ATen op whose id equals a launch's."""
    host = [
        Host("step", 0, 100, MAIN, 900),
        Host("step.forward", 10, 40, MAIN, 901),
        Host("step.backward", 40, 80, MAIN, 902),
        Host("step.optimizer", 80, 95, MAIN, 903),
        Host("aten::mm", 12, 18, MAIN, 2),          # op ids are no launch ids
        Host("cudaLaunchKernel", 5, 6, MAIN, 1),     # in step only
        Host("cudaLaunchKernel", 15, 16, MAIN, 2),   # step.forward
        Host("cuLaunchKernel", 50, 51, AUTOGRAD, 3),  # backward's thread
        Host("cudaLaunchKernel", 85, 86, MAIN, 4),   # step.optimizer
        Host("cudaLaunchKernel", 120, 121, MAIN, 5),  # after the step
        Host("cudaMemcpy", 30, 32, MAIN, 7),         # a blocking copy
        Host("cudaMemcpyAsync", 35, 36, MAIN, 8),
        Host("aten::copy_", 89, 93, MAIN, 904),
        Host("cudaStreamSynchronize", 90, 92, MAIN, 9),
        Host("cudaDeviceSynchronize", 150, 151, MAIN, 10),
    ]
    dev = [Dev("k_a", 7, 9, 1), Dev("k_fwd", 17, 27, 2),
           Dev("k_bwd", 52, 70, 3), Dev("k_opt", 87, 89, 4),
           Dev("k_after", 122, 124, 5), Dev("k_unlaunched", 130, 131, 6)]
    return SpanSlice(calls=calls, host=host, dev=dev)


def test_each_device_op_falls_to_the_innermost_span_of_its_launch():
    sl = _step_slice()
    assert spans.owners(sl) == ["step", "step.forward", "step.backward",
                                "step.optimizer", None, None]
    by = spans.device_us(sl)
    assert by == {"step": 2, "step.forward": 10, "step.backward": 18,
                  "step.optimizer": 2, None: 3}
    assert spans.attributed_share(sl) == pytest.approx(100 * 32 / 35)


def test_a_launch_falls_to_its_own_thread_s_span_first():
    sl = _step_slice()
    sl.host += [Host("serve.call", 45, 60, OTHER, 950),
                Host("cudaLaunchKernel", 55, 56, OTHER, 11)]
    sl.dev.append(Dev("k_serve", 57, 58, 11))
    assert spans.owners(sl)[-1] == "serve.call"
    # the autograd thread holds no span: the moment's innermost span on
    # any thread, the one that began last
    assert spans.owners(sl)[2] == "serve.call"


def test_idle_time_is_the_complement_of_busy_within_the_span():
    dev = [Dev("a", 20, 30, 1), Dev("b", 25, 35, 2), Dev("c", 60, 70, 3),
           Dev("d", 95, 120, 4)]
    host = [Host("serve.call", 10, 50, MAIN, 90),
            Host("serve.call", 55, 100, MAIN, 91),
            Host("serve.to_host", 40, 50, MAIN, 92)]
    sl = SpanSlice(calls=2, host=host, dev=dev)
    assert spans.busy(dev) == [(20, 35), (60, 70), (95, 120)]
    # 40 - 15 in the first call, 45 - 10 - 5 in the second
    assert spans.idle_us(sl, "serve.call") == pytest.approx(25 + 30)
    assert spans.METRICS["serve.idle_ms"](sl) == pytest.approx(55 / 1e3 / 2)
    assert spans.METRICS["serve.to_host.idle_ms"](sl) == pytest.approx(
        10 / 1e3 / 2)


def test_the_step_s_waits_for_the_card():
    sl = _step_slice(calls=2)
    assert spans.is_sync("cudaStreamSynchronize")
    assert spans.is_sync("cudaMemcpy")
    assert not spans.is_sync("cudaMemcpyAsync")
    assert not spans.is_sync("aten::copy_")
    assert spans.syncs(sl, "step") == 2
    assert spans.METRICS["step.syncs"](sl) == 1.0
    assert spans.METRICS["step.forward.device_ms"](sl) == pytest.approx(
        10 / 1e3 / 2)
    assert spans.METRICS["step.sparse_update.device_ms"](sl) is None


def test_a_program_without_spans_reads_nothing():
    sl = _step_slice()
    sl.host = [h for h in sl.host if h.name not in spans.SPANS]
    assert all(f(sl) is None for f in spans.METRICS.values())
    assert spans.attributed_share(sl) == 0.0


def _profile_of(sl: SpanSlice):
    """A stand-in for ``torch.profiler.profile`` that yields ``sl``'s
    events as ``FunctionEvent``s and as raw Kineto events."""
    t0 = 10 ** 9
    events = [(h.name, DeviceType.CPU, h) for h in sl.host] + [
        (d.name, DeviceType.CUDA, d) for d in sl.dev]

    def raw(name, kind, e):
        return SimpleNamespace(
            name=lambda: name, device_type=lambda: kind,
            start_ns=lambda: t0 + int(e.start * 1e3),
            end_ns=lambda: t0 + int(e.end * 1e3),
            start_thread_id=lambda: getattr(e, "thread", 0),
            correlation_id=lambda: e.corr, is_user_annotation=lambda: False)

    class Fake:
        def __init__(self, activities=None):
            self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(
                trace_start_ns=lambda: t0,
                events=lambda: [raw(*x) for x in events]))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [SimpleNamespace(name=n, device_type=k, time_range=(
                SimpleNamespace(start=e.start, end=e.end)))
                for n, k, e in events]

    return Fake


def test_the_traced_slice_is_as_before_on_the_same_events(monkeypatch):
    sl = _step_slice()
    fake = _profile_of(sl)
    monkeypatch.setattr(torch.profiler, "profile", fake)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    got = trace.profile_slice(lambda: None, 1)
    # without the spans, the same slice
    bare = SpanSlice(1, [h for h in sl.host if h.name not in spans.SPANS],
                     sl.dev)
    monkeypatch.setattr(torch.profiler, "profile", _profile_of(bare))
    want = trace.profile_slice(lambda: None, 1)
    assert got.ops == want.ops and len(got.ops) == len(sl.dev)
    assert got.busy_s == want.busy_s
    assert got.busy_s == pytest.approx(
        sum(b - a for a, b in spans.busy(sl.dev)) / 1e6)
    assert [g for _, g in got.gaps] == [g for _, g in want.gaps]
    assert got.breakdown()["device_ops"] == want.breakdown()["device_ops"]
    # the raw events give the span reader the same slice
    read = spans.from_profile(fake(), 1)
    assert [(d.name, d.corr) for d in read.dev] == [
        (d.name, d.corr) for d in sl.dev]
    assert spans.owners(read) == spans.owners(sl)


def test_the_report_of_a_slice():
    out = trace_spans.report(_step_slice(), wall=200e-6, rows={
        "sparse_rows_touched": 30.0, "sparse_rows_processed": 40.0,
        "onehot_scatter_add": 7.0})
    assert out["metrics"]["sparse.useful_row_share"] == 75.0
    assert out["rows"] == {"sparse_rows_touched": 30.0,
                           "sparse_rows_processed": 40.0}
    assert out["device_ms"]["None"] == pytest.approx(3e-3)
    assert out["syncs"]["step"] == 2
    assert out["wait_sites"] == {"- / cudaMemcpy": 1.0,
                                 "aten::copy_ / cudaStreamSynchronize": 1.0,
                                 "- / cudaDeviceSynchronize": 1.0}
    assert out["ops_per_call"] == 6


@pytest.mark.parametrize("launches,want", [
    ({"sparse_rows_touched": 3.0, "sparse_rows_processed": 4.0}, 75.0),
    ({"sparse_rows_touched": 0.0, "sparse_rows_processed": 0.0}, None),
    ({"onehot_scatter_add": 7.0}, None),            # a program without them
])
def test_the_useful_row_share_reads_the_counters(launches, want):
    read = readers.own_module("sparse.useful_row_share").read
    assert read(None, {"launches": launches}) == want
