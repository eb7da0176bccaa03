"""``harness/span_profiling.py`` on synthetic raw events (ns): the user
annotations are no activities and no busy time; each activity goes to
the innermost span of ``SPAN_GROUPS`` open when the runtime call that
launched it started (its correlation id), wherever it ran; idle gaps get
the host op running in them."""

import pytest

from harness import span_profiling as sp


def ev(name, start, end, corr=0, device=False, annotation=False):
    return sp.Event(name, start, end, corr, device, annotation)


def span(name, start, end):
    """A profiler range: its host event and its CUDA-typed twin."""
    return [ev(name, start, end, annotation=True),
            ev(name, start + 1, end + 5, device=True, annotation=True)]


def launch(corr, t, start, end, name="k"):
    """A runtime call at host time t and the kernel it launched."""
    return [ev("cudaLaunchKernel", t, t + 1, corr),
            ev(name, start, end, corr, device=True)]


def trace():
    return (span("physics.control_step", 0, 200)
            + span("ar.controller", 10, 40) + span("physics.objects", 60, 90)
            + span("physics.objects", 62, 70)      # nested in its own group
            + span("Optimizer.step#Adam.step", 100, 150)
            + launch(1, 15, 20, 30)                # controller
            + launch(2, 35, 50, 55)                # controller, runs after
            + launch(3, 65, 70, 80, "pgs_kernel")  # objects
            + launch(4, 110, 120, 130)             # no group (Adam, step)
            + launch(5, 300, 310, 320))            # no span at all


def test_annotations_are_no_activities():
    dev, groups = sp.attribute(trace())
    assert sorted(e.corr for e in dev) == [1, 2, 3, 4, 5]
    assert groups == {"controller": 15, "objects": 10}


def test_record_sums_busy_and_groups():
    s = sp.SpanSummary()
    busy = sp.record(s, "rollout", 3, 2.0, trace())
    assert busy == pytest.approx(45e-9)
    assert s.busy_tag["rollout"] == busy and s.busy_s == busy
    assert s.activities["rollout"] == 5 and s.steps["rollout"] == 3
    assert s.group_s[("rollout", "controller")] == pytest.approx(15e-9)
    assert s.group_s[("rollout", "objects")] == pytest.approx(10e-9)
    assert s.kernel_s[("rollout", "pgs_kernel")] == pytest.approx(10e-9)
    assert s.window_s == 2.0
    sp.record(s, "update", 0, 1.0, launch(9, 0, 5, 25))
    assert s.busy_tag["update"] == pytest.approx(20e-9)
    assert s.busy_s == pytest.approx(65e-9)


def test_gaps_name_the_host_op():
    events = (span("ar.controller", 0, 100) + [ev("aten::mm", 10, 60),
                                                ev("aten::add", 20, 40)]
              + launch(1, 1, 2, 5) + launch(2, 50, 90, 95))
    dev, _ = sp.attribute(events)
    (label, s), *rest = sp.gap_labels(events, dev)
    # the longest gap [5, 90], its middle 47.5: aten::mm alone covers it
    assert (label, s) == ("aten::mm", pytest.approx(85e-9))
    assert sp.gap_labels(events, []) == []


def test_innermost_of_nested_spans():
    inner = sp.Innermost([ev("a", 0, 100), ev("b", 10, 20), ev("c", 30, 40)])
    assert [inner.at(t) for t in (-1, 5, 15, 25, 35, 100, 101)] == [
        None, "a", "b", "a", "c", None, None]
