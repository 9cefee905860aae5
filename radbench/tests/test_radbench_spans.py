"""The host-stage readers (radbench/spans.py and its six metrics) on a
hand-made window: two calls, nested ``rte.*`` spans, device intervals with
known gaps."""
import pytest

from radbench import harness, spans as S
from radbench.trace import TraceWindow

METRICS = ("host_prep_ms_per_call", "host_enqueue_ms_per_call", "host_stage_ms_per_call",
           "host_wait_ms_per_call", "rebuilds_per_call", "idle_unattributed_share")


def ev(name, ts, end, cat="user_annotation", tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts, "pid": 1, "tid": tid}


CALLS = [ev("radbench.call", 0, 100), ev("radbench.call", 100, 200)]
SPANS = [
    # call 1: an RFMIP LW driver call
    ev("rte.rfmip.lw", 0, 60), ev("rte.check", 2, 6), ev("rte.planck", 10, 20),
    ev("rte.canon", 20, 30), ev("rte.h2d", 30, 36), ev("rte.prep", 40, 48),
    ev("rte.first_layer.miss", 42, 45), ev("rte.kernel.lw", 50, 58),
    # call 2: a sweep, under a range of the benchmark's own and with a span
    # of a name the table does not know (it counts in its parent's self time)
    ev("radbench.sweep", 100, 195), ev("rte.gcm.sweep", 100, 190), ev("rte.pack", 105, 135),
    ev("rte.later", 110, 120), ev("rte.stream", 140, 188), ev("rte.stage", 141, 150),
    ev("rte.wait", 142, 146), ev("rte.step", 150, 160), ev("rte.d2h", 160, 162),
    ev("rte.wait", 162, 180), ev("rte.gather", 180, 186),
    # the host's synchronizing runtime calls: under rte.prep a wait taken
    # from its self time; under rte.wait, and under no span, nothing more
    ev("cudaStreamSynchronize", 46, 47, cat="cuda_runtime"),
    ev("cudaDeviceSynchronize", 163, 179, cat="cuda_runtime"),
    ev("cudaStreamSynchronize", 61, 62, cat="cuda_runtime"),
]
BUSY = [(8, 12), (50, 58), (70, 100), (150, 170), (195, 198)]
DEVICE = [ev("lw_mega_kernel", s, e, cat="kernel") for s, e in BUSY]
# self times, microseconds, by category: prep = rfmip.lw 14 + check 4 + planck 10 +
# canon 10 + gcm.sweep 12 + pack 30 + stream 3 + gather 6; enqueue = prep 5 - 1 +
# miss 3 + kernel.lw 8 + step 10; stage = h2d 6 + stage 5 + d2h 2; wait = 4 + 18 +
# the sync under rte.prep 1
SELF_US = {"prep": 89.0, "enqueue": 25.0, "stage": 13.0, "wait": 23.0}
# idle gaps [0,8) [12,50) [58,70) [100,150) [170,195) [198,200); the middles
# of [58,70) and [198,200) lie under no span
IDLE_US, LOST_US = 135.0, 14.0


def window(events):
    return TraceWindow(events, {}, skip=0)


@pytest.fixture()
def tw():
    return window(CALLS + SPANS + DEVICE)


def test_self_times_by_category(tw):
    for cat, us in SELF_US.items():
        assert S.ms_per_call(tw, cat) == pytest.approx(us * 1e-3 / 2)
    for cat, name in (("prep", "host_prep_ms_per_call"), ("enqueue", "host_enqueue_ms_per_call"),
                      ("stage", "host_stage_ms_per_call"), ("wait", "host_wait_ms_per_call")):
        assert harness.metric_reader(name)(tw) == pytest.approx(SELF_US[cat] * 1e-3 / 2)


def test_the_four_categories_split_the_outermost_spans(tw):
    total = sum(harness.metric_reader(m)(tw) for m in METRICS[:4])
    assert total == pytest.approx((60 + 90) * 1e-3 / 2)
    assert sum(us for _, us in S.self_us(tw)) == pytest.approx(150.0)
    assert [n for n, _ in S.self_us(tw) if n in S.SYNCS] == ["cudaStreamSynchronize"]


def test_a_child_past_its_parent_is_cut_at_its_end():
    events = CALLS[:1] + [ev("rte.rfmip.sw", 0, 50), ev("rte.solar", 40, 55),
                          ev("rte.h2d", 60, 70)]
    times = S.self_us(window(events))
    assert times == [["rte.rfmip.sw", 40.0], ["rte.solar", 10.0], ["rte.h2d", 10.0]]


def test_spans_of_another_thread_do_not_nest():
    events = CALLS[:1] + [ev("rte.rfmip.lw", 0, 50), ev("rte.wait", 10, 20, tid=2)]
    assert S.self_us(window(events)) == [["rte.rfmip.lw", 50.0], ["rte.wait", 10.0]]


def test_rebuilds_count_the_rebuild_spans(tw):
    assert harness.metric_reader("rebuilds_per_call")(tw) == pytest.approx(2 / 2)


def test_idle_unattributed_share(tw):
    assert harness.metric_reader("idle_unattributed_share")(tw) == pytest.approx(
        100.0 * LOST_US / IDLE_US)


def test_every_reader_returns_none_without_spans():
    bare = window(CALLS + DEVICE + [ev("radbench.sweep", 100, 195)])
    for m in METRICS:
        assert harness.metric_reader(m)(bare) is None, m
