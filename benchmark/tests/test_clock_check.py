"""The clock check's arithmetic (``benchmark/clock_check.py``) on synthetic
copies and spans."""

import pytest

from benchmark import clock_check

SPANS = [(100.0, 200.0), (300.0, 310.0)]
PIECES = [("backend.h2d", 100.0, 200.0), ("backend.pack", 200.0, 300.0),
          ("backend.d2h", 300.0, 310.0)]


def test_offsets_inside_near_and_far():
    ops = [("Memcpy HtoD", 120.0, 180.0),   # inside
           ("Memcpy HtoD", 195.0, 215.0),   # 15 us past the first
           ("Memcpy DtoH", 250.0, 260.0),   # 50 us before the second
           ("Memcpy DtoH", 299.0, 330.0)]   # 20 us past the second
    assert clock_check.offsets(ops, SPANS, 20.0) == [0.0, 15.0, 50.0, 20.0]


def test_summary_shares_and_where_the_rest_falls():
    ops = [("Memcpy HtoD", 120.0, 180.0), ("Memcpy HtoD", 250.0, 270.0)]
    out = clock_check.summary(ops, SPANS, PIECES, 20.0)
    assert out["ops"] == 2
    assert out["device_s"] == pytest.approx(80e-6)
    assert out["in_span_pct"] == pytest.approx(75.0)
    assert out["largest_offset_us"] == 50.0
    assert out["outside_s_by_span"] == pytest.approx({"backend.pack": 20e-6})


def test_misalignment_pairs_in_order_and_fits_the_drift():
    spans = [(1e6 * k, 1e6 * k + 50.0) for k in range(5)]
    # Each op starts 10 us into its span, 2 us later every second.
    ops = [("Memcpy DtoH", s + 10.0 + 2.0 * k, s + 20.0 + 2.0 * k)
           for k, (s, _) in enumerate(spans)]
    out = clock_check.misalignment(ops, spans)
    assert out["paired"]
    assert out["start_less_span_start_us"]["min"] == 10.0
    assert out["start_less_span_start_us"]["max"] == 18.0
    assert out["drift_us_per_s"] == pytest.approx(2.0)
    assert out["span_p50_us"] == 50.0
    assert not clock_check.misalignment(ops[:4], spans)["paired"]
