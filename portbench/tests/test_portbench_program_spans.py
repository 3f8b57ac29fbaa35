"""The readers of the program's spans in a traced stretch
(``harness/program_spans.py``, bound by ``metrics/serve.assemble_ms.py``,
``serve.unpack_ms.py`` and ``serve.idle_in_tick.py``) on a hand-made
trace, each against its value worked out by hand."""
import pytest

from harness import program_spans, readers, runner, trace

CHILDREN = ("serve.admit", "serve.assemble", "serve.step", "serve.fetch",
            "serve.unpack")


def _x(cat, name, ts, end):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts),
            "dur": float(end - ts)}


def _tick(start, bounds):
    """A ``serve.tick`` from ``start`` and its five children, each ending
    at the next of ``bounds``; the tick ends at the last."""
    ev = [_x("user_annotation", "serve.tick", start, bounds[-1])]
    for name, a, b in zip(CHILDREN, [start, *bounds], bounds):
        ev.append(_x("user_annotation", name, a, b))
    return ev


def _summary():
    """A 1000 µs stretch: ticks at 100-400 µs and 600-800 µs, a stray
    ``serve.assemble`` at 900-950 µs outside them; the device busy at
    0-50, 190-360 (a kernel, then a copy), 700-900 (across the second
    tick's end) and 990-1000 µs. The gap 50-190 µs lies partly inside
    the first tick."""
    ev = [_x("cpu_op", "loop", 0, 1000)]
    ev += _tick(100, [120, 180, 200, 350, 390, 400])
    ev += _tick(600, [610, 650, 660, 760, 790, 800])
    ev.append(_x("user_annotation", "serve.assemble", 900, 950))
    ev += [_x("kernel", "k0", 0, 50), _x("kernel", "k1", 190, 330),
           _x("gpu_memcpy", "Memcpy DtoH", 330, 360),
           _x("kernel", "k2", 700, 900), _x("gpu_memset", "Memset", 990,
                                              1000)]
    return trace.Summary(ev)


def test_assemble_is_admit_plus_assemble_a_tick():
    # (20 + 60) + (10 + 40) µs over 2 ticks; the stray span is left out
    got = runner.reader("serve.assemble_ms")({"trace": _summary()})
    assert got == pytest.approx(0.065)


def test_unpack_a_tick():
    got = runner.reader("serve.unpack_ms")({"trace": _summary()})
    assert got == pytest.approx((40 + 30) / 2 * 1e-3)


def test_idle_in_tick_counts_only_the_gaps_inside_ticks():
    s = _summary()
    # tick 1: 300 µs, busy 190-360 inside it (170), idle 130 (of it 90 in
    # the gap 50-190 that began before the tick); tick 2: 200 µs, busy
    # 700-800 (100), idle 100
    got = runner.reader("serve.idle_in_tick")({"trace": s})
    assert got == pytest.approx(100.0 * (130 + 100) / 1000)
    # the whole stretch: busy 50 + 170 + 200 + 10 = 430 µs of 1000
    assert readers.idle({"trace": s}) == pytest.approx(57.0)


def test_a_trace_without_the_programs_spans_reads_nothing():
    s = trace.Summary([_x("cpu_op", "loop", 0, 100),
                       _x("kernel", "k", 10, 20)])
    for name in ("serve.assemble_ms", "serve.unpack_ms",
                 "serve.idle_in_tick"):
        assert runner.reader(name)({"trace": s}) is None
        assert runner.reader(name)({"trace": None}) is None
        assert runner.reader(name)({}) is None


def test_overlap_of_sorted_intervals():
    iv = [(0.0, 10.0), (20.0, 30.0), (40.0, 50.0)]
    assert program_spans._overlap(iv, 5.0, 45.0) == 5 + 10 + 5
    assert program_spans._overlap(iv, 10.0, 20.0) == 0.0
    assert program_spans._overlap(iv, 55.0, 60.0) == 0.0
