"""The idle time no serving stage explains, on a hand-built timeline and
hand-built spans: device busy time and stage spans both explain idle time,
spans outside the window and of other names do not, and with no spans the
metric is the idle fraction."""
from collections import namedtuple

import pytest

from perfbench import readers, stage_spans, tracing

Span = namedtuple("Span", "name start_ns end_ns")
S = 10 ** 9


def _timeline():
    """A 1-s window, the device busy over its first half."""
    return tracing.Timeline(window=(0, S), device=[("k", 0, S // 2)])


def test_device_and_prepare_leave_a_fifth():
    spans = [Span("prepare", S // 2, 8 * S // 10)]
    assert stage_spans.unexplained_idle(_timeline(), spans) == \
        pytest.approx(0.2)


def test_spans_outside_the_window_and_other_names_are_ignored():
    spans = [Span("prepare", S // 2, 8 * S // 10),
             Span("dispatch", -S, -1), Span("harvest", S + 1, 2 * S),
             Span("await_work", 8 * S // 10, S),
             Span("sample", 8 * S // 10, S)]
    assert stage_spans.unexplained_idle(_timeline(), spans) == \
        pytest.approx(0.2)


def test_a_span_across_the_window_edge_counts_its_part_inside():
    spans = [Span("publish", 9 * S // 10, 2 * S),
             Span("prepare", S // 4, 6 * S // 10)]
    assert stage_spans.unexplained_idle(_timeline(), spans) == \
        pytest.approx(0.3)


def test_no_spans_read_the_idle_fraction():
    tl = _timeline()
    assert stage_spans.unexplained_idle(tl, []) == \
        pytest.approx(readers.idle_fraction({"timeline": tl}))


def test_an_empty_window_reads_nothing():
    tl = tracing.Timeline(window=(S, S), device=[])
    assert stage_spans.unexplained_idle(tl, []) is None
    assert stage_spans.read({"timeline": tl}) is None
