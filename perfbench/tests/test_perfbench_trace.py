"""The reduction of device intervals: busy time, idle gaps and their
names."""
from perfbench import devtrace

OPS = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 45, 50)]


def test_busy_is_the_union_inside_the_window():
    assert devtrace.busy_ns(OPS, 0, 50) == 20 + 10 + 5
    assert devtrace.busy_ns(OPS, 8, 35) == 12 + 5


def test_idle_gaps_name_their_neighbours():
    gaps = devtrace.idle_gaps(OPS, 0, 60)
    assert gaps == [(20, 30, "b", "c"), (40, 45, "c", "d"),
                    (50, 60, "d", "window end")]


def test_breakdown_by_span():
    spans = [("engine.step", 0, 42), ("engine.step", 44, 60)]
    bd = devtrace.breakdown(OPS, spans, 0, 60)
    assert bd["idle_gaps"][0] == ["engine.step: b -> c", 10e-9]
    assert bd["device_ops"][0] == ["b", 15e-9]


def test_short_names():
    assert devtrace.short("void ns::kern<int, 4>(Args)") == "ns::kern<int, 4>"
