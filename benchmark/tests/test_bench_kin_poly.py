"""The kinematic-policy cell from its files alone: found by name with its
loop, limits and readers; its configuration held to the program's named
one; its readers' arithmetic on a synthetic run, and nothing read where
the run holds nothing (a program without the spans or counters)."""

import pytest

from harness import loops, record, spec
from harness.span_profiling import SpanSummary

ROOT = spec.BENCH_DIR.parent
CELL = "kin_poly.train.e320x32"
PER_LAYER = {
    "kin_poly_train.rollout_device_ms_per_step",
    "kin_poly_train.context_device_ms", "kin_poly_train.update_device_ms",
    "kin_poly_train.kin_policy.device_ms_per_step",
    "kin_poly_train.controller.device_ms_per_step",
    "kin_poly_train.objects.device_ms_per_step",
    "kin_poly_train.fk_calls_per_step", "kin_poly_train.roofline.pgs_solve",
    "kin_poly_train.roofline.ltdl_solve", "kin_poly_train.device_idle"}


@pytest.fixture(scope="module")
def cell():
    return spec.find_cell(spec.load_json(ROOT / "BENCHMARK.json"), CELL)


def test_cell_found_with_its_readers(cell):
    assert cell.traffic["loop"] == "kin_poly_train"
    assert cell.traffic["limits"] and cell.workload["chips"] == 1
    assert {m["name"] for m in cell.end_to_end} == {
        "uhc_train_device_s_per_iter", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == PER_LAYER
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_configuration_is_the_programs(cell):
    """The file's values are ``KinPolyConfig.named("kin_poly")`` field for
    field; the cut keeps kin_poly.yml's 10,000-sample epoch."""
    from kinpoly_tpu_torch.config.defaults import KinPolyConfig
    c = cell.config
    loops.check_config(KinPolyConfig.named(c["name"]), c["values"])
    for k in ("n_envs", "rollout_steps"):
        assert c[k] == cell.traffic[k] == c["reduced"][k][1]
        assert c["reduced"][k][0] == c["values"][k]
    samples = c["n_envs"] * c["rollout_steps"]
    assert 10000 <= samples < 10000 + c["n_envs"]
    assert samples >= c["values"]["policy_specs"]["min_batch_size"]


def _run(cell, profile=None, **counters):
    run = record.Run(cell.config, cell.traffic, 51, True, units=[
        record.Unit(0, 10, 10240, 32)])
    run.counters.update(n_envs=320, steps=32, contact_blocks=24,
                        contact_iters=20, **counters)
    run.profile = profile
    return run


def test_nothing_to_read_reads_none(cell):
    for name in PER_LAYER | {"uhc_train_device_s_per_iter"}:
        assert spec.reader(name)(_run(cell)) is None, name
    # a parent without the new spans and counters: a profile, no groups
    prof = SpanSummary(window_s=2.0, busy_s=0.5)
    prof.busy_tag.update(rollout=0.3, update=0.2)
    prof.steps.update(rollout=3)
    run = _run(cell, prof, context_busy_s=0.05)
    for g in ("kin_policy", "controller", "objects"):
        assert spec.reader(f"kin_poly_train.{g}.device_ms_per_step")(run) is None
    assert spec.reader("kin_poly_train.fk_calls_per_step")(run) is None


def test_readers_arithmetic(cell):
    prof = SpanSummary(window_s=2.0, busy_s=0.5)
    prof.busy_tag.update(rollout=0.3, update=0.2)
    prof.steps.update(rollout=3)
    prof.group_s.update({("rollout", "kin_policy"): 0.03,
                         ("rollout", "controller"): 0.06,
                         ("rollout", "objects"): 0.09,
                         ("update", "objects"): 1.0})
    prof.counts.update({("rollout", "fk"): 12, ("update", "fk"): 100})
    run = _run(cell, prof, context_busy_s=0.05)
    read = lambda n: spec.reader(n)(run)
    assert read("uhc_train_device_s_per_iter") == pytest.approx(0.1 * 32 + 0.2)
    assert read("kin_poly_train.rollout_device_ms_per_step") == pytest.approx(100)
    assert read("kin_poly_train.context_device_ms") == pytest.approx(50)
    assert read("kin_poly_train.update_device_ms") == pytest.approx(150)
    assert read("kin_poly_train.kin_policy.device_ms_per_step") == pytest.approx(10)
    assert read("kin_poly_train.controller.device_ms_per_step") == pytest.approx(20)
    assert read("kin_poly_train.objects.device_ms_per_step") == pytest.approx(30)
    assert read("kin_poly_train.fk_calls_per_step") == 4
    assert read("kin_poly_train.device_idle") == pytest.approx(75)


def test_rooflines_at_the_cells_shapes(cell):
    """K3 at 24 blocks and K2 at R = 49 and 1, from the frozen counts."""
    from harness import counts
    prof = SpanSummary()
    prof.launches.update({("rollout", "pgs_solve"): 45,
                          ("rollout", "ltdl_solve[R=49]"): 45,
                          ("rollout", "ltdl_solve[R=1]"): 45})
    prof.kernel_s.update({("rollout", "void pgs_kernel<24>(...)"): 1e-3,
                          ("rollout", "ltdl_solve_kernel"): 2e-3})
    run = _run(cell, prof)
    k3 = 45 * counts.bound_s(*counts.pgs_solve(320, 24, 20))
    k2 = 45 * (counts.bound_s(*counts.ltdl_solve(320, counts.DEPTH, 49))
               + counts.bound_s(*counts.ltdl_solve(320, counts.DEPTH, 1)))
    assert spec.reader("kin_poly_train.roofline.pgs_solve")(run) == \
        pytest.approx(100 * k3 / 1e-3)
    assert spec.reader("kin_poly_train.roofline.ltdl_solve")(run) == \
        pytest.approx(100 * k2 / 2e-3)
