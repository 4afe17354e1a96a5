"""The metric readers and the trace reduction, on synthetic inputs."""

import importlib.util
import os
from types import SimpleNamespace

import pytest

from portbench import harness, traces

METRICS = os.path.join(harness.BASE, "metrics")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ctx(**kw):
    base = dict(units=[], window=(0.0, 0.0), facts={}, summary=None,
                config={}, card="NVIDIA H100 80GB HBM3", setup_s=1.5,
                peak_bytes=0, chips=1)
    base.update(kw)
    return SimpleNamespace(**base)


def test_p95_is_the_nearest_rank_over_every_request():
    # 200 requests: 1..200 ms; the 95th percentile is the 190th value, not
    # a median of chunks (which would read 10.5 ms for chunks of 20)
    units = [(0.0, i / 1e3, True) for i in range(1, 201)]
    assert reader("query_p95_ms")(ctx(units=units)) == pytest.approx(190.0)
    # eleven slow requests make the tail: the 190th value is one of them
    units[-11:] = [(0.0, 5.0, True)] * 11
    assert reader("query_p95_ms")(ctx(units=units)) == pytest.approx(5000.0)
    assert reader("query_p95_ms")(ctx(units=units[:20])) == \
        pytest.approx(19.0)
    # a failed request has no latency
    units[5] = (0.0, 99.0, False)
    assert reader("query_p95_ms")(ctx(units=units)) == pytest.approx(5000.0)
    assert reader("query_p95_ms")(ctx()) is None


def test_rates_are_over_whole_passes_and_the_whole_window():
    units = [(10.0 + i, 11.0 + i, True) for i in range(4)]
    c = ctx(units=units, window=(10.0, 16.0),
            facts={"audio_s_per_unit": 2520.0})
    # 4 passes of 2,520 s of audio in the 6 s from the window's start to
    # its last pass's end (the slow last pass included)
    assert reader("extract_xrt")(c) == pytest.approx(4 * 2520.0 / 6.0)
    assert reader("analysis_ms")(c) == pytest.approx(1500.0)
    assert reader("extract_xrt")(ctx(window=(0.0, 1.0))) is None


def test_setup_and_peak():
    assert reader("setup_s")(ctx()) == 1.5
    assert reader("peak_device_gb")(ctx(peak_bytes=19_858_423_808)) == \
        pytest.approx(19.858423808)
    assert reader("peak_device_gb")(ctx()) is None


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def events():
    """Two requests of 100 µs each; kernels on two streams overlap."""
    return [
        _ev("portbench.request", "user_annotation", 0, 100),
        _ev("portbench.request", "user_annotation", 100, 100),
        _ev("aten::sort", "cpu_op", 60, 50),
        _ev("k1", "kernel", 0, 40),
        _ev("k2", "kernel", 10, 40),          # overlaps k1: union 0-50
        _ev("Memcpy DtoH", "gpu_memcpy", 120, 30),
        _ev("prep_long", "kernel", 160, 10),
        _ev("k1", "kernel", 300, 50),         # outside the stretch
    ]


def test_busy_is_the_union_not_the_sum():
    s = traces.summarize(events(), "request")
    assert s.units == 2 and s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(90e-6)          # 50 + 30 + 10
    assert s.card_busy_s == [s.busy_s]
    # the card named in args, or by pid, is the same one card
    tagged = [dict(e, args={"device": 0}) if e["cat"] == "kernel" else e
              for e in events()]
    assert traces.summarize(tagged, "request") == s
    # negative control: the sum of the durations counts the overlap twice
    summed = sum(e["dur"] for e in events()[3:7]) * 1e-6
    assert summed == pytest.approx(120e-6) and summed != s.busy_s
    assert s.device_events == 4
    assert s.kernel_seconds("prep_long") == pytest.approx(10e-6)
    assert dict(s.ops)["k1"] == pytest.approx(40e-6)


def test_idle_gaps_are_labelled_by_the_open_span():
    s = traces.summarize(events(), "request")
    gaps = dict((round(sec * 1e6), label) for label, sec in s.gaps)
    assert gaps[70] == "request/aten::sort"            # 50-120
    assert gaps[10] == "request/-"                     # 150-160
    assert gaps[30] == "request/-"                     # 170-200
    assert sum(sec for _, sec in s.gaps) == pytest.approx(110e-6)
    assert traces.summarize(events(), "f_pass") is None


def test_device_readers():
    s = traces.summarize(events(), "request")
    c = ctx(summary=s, config={"files": 10_000, "channels": 14,
                               "frames": 10_336},
            facts={"channels": 14, "searched_frames": 20 * 10_335})
    assert reader("device_ms.serve")(c) == pytest.approx(0.045)
    assert reader("frontend_launches")(c) == pytest.approx(2.0)
    for cell in ("serve", "extract", "analysis"):
        assert reader(f"device_idle_pct.{cell}")(c) == pytest.approx(55.0)


def test_roofline_bytes_come_from_the_configuration():
    s = traces.Summary(units=1, window_s=0.2, busy_s=0.1289,
                       device_events=100, kernels={"prep_long_k": 26.3e-6})
    cfg = {"files": 10_000, "channels": 14, "frames": 10_336}
    c = ctx(summary=s, config=cfg,
            facts={"channels": 14, "searched_frames": 20 * 10_335})
    moved = 10_000 * 14 * 10_336 * 4                  # 5.79 GB read once
    want = 100 * moved / 3.35e12 / 0.1289
    assert reader("serve_roofline_pct")(c) == pytest.approx(want)
    assert 1.0 < want < 1.5
    prep = 2 * 4 * 14 * 20 * 10_335                  # read + write once
    assert reader("prep_roofline_pct")(c) == \
        pytest.approx(100 * prep / 3.35e12 / 26.3e-6)
    # an unknown card, or no prep kernel in the trace, reads nothing
    assert reader("serve_roofline_pct")(ctx(summary=s, config=cfg,
                                            card="cpu")) is None
    s.kernels = {}
    assert reader("prep_roofline_pct")(c) is None


def two_cards():
    """The two requests of ``events``, with work on a second card: a kernel
    named by ``args.device`` and a copy named by its ``pid`` alone."""
    return events() + [
        dict(_ev("k3", "kernel", 20, 60), args={"device": 1}, pid=1),
        dict(_ev("Memcpy HtoD", "gpu_memcpy", 120, 30), pid=1),
        dict(_ev("k3", "kernel", 70, 40), args={"device": 1}, pid=1),
    ]


@pytest.mark.parametrize("chips", [2, 3])
def test_busy_is_each_cards_union_averaged_over_the_cells_cards(chips):
    s = traces.summarize(two_cards(), "request", chips)
    # card 0 as in ``events``: 90 µs; card 1: 20-110 and 120-150, 120 µs;
    # a third card of the cell ran nothing and counts as idle
    want = [90e-6, 120e-6] + [0.0] * (chips - 2)
    assert s.card_busy_s == pytest.approx(want)
    assert s.busy_s == pytest.approx(sum(want) / chips)
    assert s.device_events == 7
    assert s.kernel_seconds("k3") == pytest.approx(100e-6 / chips)
    assert s.kernel_seconds("prep_long") == pytest.approx(10e-6 / chips)
    # idle gaps are where no card of the cell is busy
    gaps = sorted(round(sec * 1e6) for _, sec in s.gaps)
    assert gaps == [10, 10, 30]          # 110-120, 150-160, 170-200
    c = ctx(summary=s, chips=chips,
            config={"files": 10_000, "channels": 14, "frames": 10_336})
    assert reader("device_ms.serve")(c) == pytest.approx(
        1e3 * sum(want) / chips / 2)
    assert reader("device_idle_pct.serve")(c) == pytest.approx(
        100 * (1 - sum(want) / chips / 200e-6))
    # the bytes against the card-seconds summed over the cell's cards
    moved = 10_000 * 14 * 10_336 * 4
    assert reader("serve_roofline_pct")(c) == pytest.approx(
        100 * moved / 3.35e12 / (sum(want) / 2))


def test_one_card_reads_as_it_did():
    """On one card the per-card accounting gives the single union and the
    card's rate, as before it."""
    s = traces.summarize(events(), "request", 1)
    assert s == traces.summarize(events(), "request")
    c = ctx(summary=s, config={"files": 10_000, "channels": 14,
                               "frames": 10_336})
    moved = 10_000 * 14 * 10_336 * 4
    assert reader("serve_roofline_pct")(c) == \
        100.0 * moved / 3.35e12 / (s.busy_s / s.units)
    assert s.kernel_seconds("prep_long") == sum(
        sec for n, sec in s.kernels.items() if "prep_long" in n)
