"""The port's tracing (``kinpoly_tpu_torch/utils/profiling.py``) on the CPU
at a few envs: spans off share one null context and leave nothing in a
profiler trace; spans on land in it; the spans nest as the layers do (a
control step holds its contact plan and 15 substeps, each with its FK,
dynamics, factor, solves, contacts and PSOR; the update holds PPO and
each optimizer step); the FK counter's calls per rollout step; a training
iteration identical bit for bit with spans on and off; the AR agent's
phases as spans; ``profile_eval``'s span and layer tables on synthetic
traces (attribution at launch, idle split by overlap, foreign
annotations, sums) and its map holding every span the port opens.

The CPU profiler records ~780k events for one control step (every op's
nested calls), and reading them takes about a minute, so traces are taken
of a one-substep model; the nesting is read from a recorder that stands
in for ``torch.profiler.record_function`` and opens the real range too."""

import contextlib
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kinpoly_tpu_torch.config.defaults import UHCConfig
from kinpoly_tpu_torch.rl import rollout as ro
from kinpoly_tpu_torch.rl.agent_ar import AgentAR
from kinpoly_tpu_torch.scripts.eval_uhc import get_takes
from kinpoly_tpu_torch.scripts.train_uhc import build_trainer
from kinpoly_tpu_torch.utils import profiling

torch.set_num_threads(1)

N_ENVS, STEPS = 2, 2
LAYERS = ("physics.", "env.", "uhc.", "ppo.", "optim.", "ar.")


def _trainer(seed: int = 3, **model_kw):
    cfg = UHCConfig.named("uhc")
    takes = get_takes(None, 2, 8, seed=1)
    agent = build_trainer(takes, cfg, N_ENVS, STEPS, device="cpu", **model_kw)
    agent.generator.manual_seed(seed)
    return agent, cfg


def _carry(agent):
    probs = torch.full((agent.n_clips,), 1.0 / agent.n_clips)
    return probs, ro.init_rollout_state(agent.env, agent.generator, N_ENVS,
                                        probs)


@contextlib.contextmanager
def _recorded():
    """Spans on, each recorded as {name, args, kids} in the tree it opens
    (the list of top-level spans is yielded), inside the real range."""
    real = torch.profiler.record_function
    top, stack = [], []

    @contextlib.contextmanager
    def record(name, args=None):
        node = dict(name=name, args=args, kids=[])
        (stack[-1]["kids"] if stack else top).append(node)
        stack.append(node)
        try:
            with real(name, args):
                yield
        finally:
            stack.pop()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", record)
        profiling.enable(True)
        try:
            yield top
        finally:
            profiling.enable(False)


def _kids(node, name):
    return [k for k in node["kids"] if k["name"] == name]


def _one(node, name):
    (k,) = _kids(node, name)
    return k


@pytest.fixture(scope="module")
def agent():
    return _trainer()[0]


@pytest.mark.parametrize("on", [False, True])
def test_profiler_trace_holds_the_spans_only_while_on(on):
    """A control step of a one-substep model under torch.profiler."""
    agent, _ = _trainer(n_substeps=1)
    probs, carry = _carry(agent)
    action = torch.zeros(N_ENVS, agent.env.action_dim)
    profiling.enable(on)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            agent.env.step(carry.env_state, action)
    finally:
        profiling.enable(False)
    names = [e.name for e in prof.events()]
    spans = [n for n in names if n.startswith(LAYERS)]
    if on:
        assert spans.count("physics.substep") == 1
        assert spans.count("physics.fk") == 3     # plan, substep, env step
        assert {"env.step", "physics.control_step", "physics.pgs",
                "env.reward", "env.observe"} <= set(spans)
    else:
        assert names and not spans
        assert profiling.span("physics.fk") is profiling.span("env.step")


def test_spans_nest_as_the_layers(agent):
    probs, carry = _carry(agent)
    with _recorded() as top:
        agent._rollout(carry, agent.norm, probs, agent.generator)
    (roll,) = top
    assert roll["name"] == "uhc.rollout"
    assert len(_kids(roll, "uhc.policy")) == STEPS
    # the all-env reset after every env step
    assert len(_kids(roll, "env.reset")) == STEPS
    for reset in _kids(roll, "env.reset"):
        assert len(_kids(_one(reset, "env.observe"), "physics.fk")) == 1
    steps = _kids(roll, "env.step")
    assert len(steps) == STEPS
    for s in steps:
        assert [k["name"] for k in s["kids"]] == [
            "physics.control_step", "physics.fk", "env.reward", "env.observe"]
        assert not _one(s, "env.observe")["kids"]   # it reuses the step's FK
        cs = _one(s, "physics.control_step")
        assert len(_kids(_one(cs, "physics.contact_plan"), "physics.fk")) == 1
        subs = _kids(cs, "physics.substep")
        assert len(subs) == 15 and len(cs["kids"]) == 16
        for sub in subs:
            assert [k["name"] for k in sub["kids"]] == [
                "physics.fk", "physics.dof_frames", "physics.bias_force",
                "physics.crba", "physics.factor", "physics.solve",
                "physics.contacts"]
            con = _one(sub, "physics.contacts")
            assert [k["name"] for k in con["kids"]] == ["physics.solve",
                                                        "physics.pgs"]


@pytest.mark.parametrize("plan_contacts,per_step", [(True, 18), (False, 17)])
def test_fk_calls_per_rollout_step(plan_contacts, per_step):
    """15 substeps, the contact plan (if on), the env step's pose and the
    all-env reset's observation; counted with spans off."""
    agent, _ = _trainer(plan_contacts=plan_contacts)
    probs, carry = _carry(agent)
    before = profiling.COUNTS["fk"]
    agent._rollout(carry, agent.norm, probs, agent.generator)
    assert profiling.COUNTS["fk"] - before == per_step * STEPS


@pytest.fixture(scope="module")
def epochs():
    """One training iteration of two agents of one seed, spans off and
    spans on (recorded)."""
    off, cfg = _trainer(seed=11)
    m_off = off.train_epoch(adaptive=cfg.adaptive_params(0))
    on, _ = _trainer(seed=11)
    with _recorded() as top:
        m_on = on.train_epoch(adaptive=cfg.adaptive_params(0))
    return dict(off=off, on=on, m_off=m_off, m_on=m_on, top=top)


def test_train_epoch_identical_with_spans_on_and_off(epochs):
    m_off, m_on = dict(epochs["m_off"]), dict(epochs["m_on"])
    m_off.pop("T_iter"), m_on.pop("T_iter")
    assert m_on == m_off
    for net in ("policy", "value"):
        a = getattr(epochs["off"], net).state_dict()
        b = getattr(epochs["on"], net).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (net, k)
    for a, b in zip(epochs["off"].norm, epochs["on"].norm):
        assert torch.equal(a, b)


def test_update_spans_nest_under_the_iteration(epochs):
    (it,) = epochs["top"]
    assert (it["name"], it["args"]) == ("uhc.train_epoch", "0")
    # the first iteration's reset, the rollout, the update, the fetch
    assert [k["name"] for k in it["kids"]] == [
        "env.reset", "uhc.rollout", "uhc.update", "uhc.host_fetch"]
    ppo_span = _one(_one(it, "uhc.update"), "ppo.update")
    # one minibatch per epoch at this batch: a value and a policy step each
    n = 2 * epochs["on"].cfg.num_optim_epoch
    assert [k["name"] for k in ppo_span["kids"]] == ["optim.step"] * n


@pytest.mark.parametrize("time_phases", [False, True])
def test_ar_phase_opens_its_span(time_phases):
    agent = types.SimpleNamespace(time_phases=time_phases, phase_s={},
                                  device=torch.device("cpu"))
    with _recorded() as top:
        with AgentAR._phase(agent, "rollout"):
            with profiling.span("physics.fk"):
                pass
    assert top == [dict(name="ar.rollout", args=None, kids=[
        dict(name="physics.fk", args=None, kids=[])])]
    assert list(agent.phase_s) == (["rollout"] if time_phases else [])


CUDA = torch.autograd.DeviceType.CUDA


def _ev(name, start, end, id=0, device=torch.autograd.DeviceType.CPU,
        annotation=False):
    return types.SimpleNamespace(
        name=name, id=id, device_type=device, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def _span(name, start, end, id=0):
    """A profiler range: its host event and its CUDA-typed annotation."""
    return [_ev(name, start, end, id, annotation=True),
            _ev(name, start + 1, end + 5, id, CUDA, annotation=True)]


def _launch(id, t, start, end):
    """A runtime call at host time t and the kernel it launched."""
    return [_ev("cudaLaunchKernel", t, t + 1, id), _ev("k", start, end, id, CUDA)]


def _rows(events, steps=1):
    from kinpoly_tpu_torch.scripts import profile_eval as pe
    return {r[0]: r[1:] for r in pe.span_table(events, steps)}


def test_profile_eval_device_time_goes_to_the_innermost_span_at_launch():
    """``profile_eval``'s span table on a synthetic trace (us): a kernel
    goes to the span innermost when its launch started, wherever it runs
    (here after the span closed); a sync to the span it ran in; columns
    calls, device ms, idle ms, activities, syncs per control step."""
    events = (_span("physics.substep", 0, 100, 1) + _span("physics.fk", 10, 30, 2)
              + _launch(7, 15, 40, 45) + _launch(8, 50, 60, 70)
              + [_ev("cudaStreamSynchronize", 72, 75)]
              + _launch(9, 200, 210, 212))
    rows = _rows(events, steps=2)
    assert {k: v[:2] + v[3:] for k, v in rows.items()} == {
        "physics.substep": (0.5, 0.005, 0.5, 0.5),
        "physics.fk": (0.5, 0.0025, 0.5, 0.0),
        "(no span)": (0.0, 0.001, 0.5, 0.0)}


def test_profile_eval_idle_splits_by_overlap_among_innermost_spans():
    events = (_span("env.step", 0, 100, 1) + _span("physics.fk", 20, 40, 2)
              + _span("env.reward", 60, 80, 3)
              + _launch(7, 1, 5, 10) + _launch(8, 95, 130, 140))
    idle = {k: v[2] * 1e3 for k, v in _rows(events).items()}
    # the trace is [0, 140]; its gaps [0, 5] and [10, 130]
    assert idle == {"env.step": 5 + 10 + 20 + 20, "physics.fk": 20,
                    "env.reward": 20, "(no span)": 30}
    assert sum(idle.values()) == 140 - 15


def test_profile_eval_unmapped_annotation_is_no_span():
    """Adam's range inside ``optim.step``: its kernels go to the span, it
    has no row, and no annotation counts as a device activity."""
    from kinpoly_tpu_torch.scripts import profile_eval as pe
    events = (_span("ppo.update", 0, 100, 1) + _span("optim.step", 10, 70, 2)
              + _span("Optimizer.step#Adam.step", 20, 60, 5)
              + _launch(7, 25, 30, 40) + _launch(8, 50, 55, 58)
              + _launch(9, 80, 85, 90))
    assert [e.id for e in pe.device_activities(events)] == [7, 8, 9]
    rows = _rows(events)
    assert set(rows) == {"ppo.update", "optim.step"}
    assert rows["optim.step"][3] == 2 and rows["ppo.update"][3] == 1
    assert rows["optim.step"][0] == 1 and rows["ppo.update"][0] == 1


def test_profile_eval_groups_sum_to_the_trace():
    """The layers' device and idle ms add up to the trace's busy and idle
    time, and spans outside ``GROUPS`` are no spans."""
    from kinpoly_tpu_torch.scripts import profile_eval as pe
    events = (_span("physics.substep", 0, 100, 1) + _span("physics.fk", 10, 30, 2)
              + _span("physics.crba", 40, 50, 3) + _span("physics.pgs", 70, 90, 4)
              + _launch(7, 15, 20, 25) + _launch(8, 45, 50, 60)
              + _launch(9, 75, 80, 95) + _launch(10, 120, 130, 131))
    groups = {g: cols for g, *cols in
              pe.group_table(pe.span_table(events, steps=1))}
    assert set(groups) == {"fk", "dynamics", "solve", "none"}
    busy = 5 + 10 + 15 + 1
    assert sum(c[0] for c in groups.values()) * 1e3 == pytest.approx(busy)
    assert sum(c[1] for c in groups.values()) * 1e3 == pytest.approx(131 - busy)
    assert groups["fk"][:3] == pytest.approx([0.005, 0.015, 1])


def test_profile_eval_maps_every_span_the_port_opens():
    """Every literal name the port gives ``span``/``spanned`` (and the AR
    agent's ``_phase``, as ``ar.<phase>``) has a layer in ``GROUPS``, so no
    span of the port passes for a foreign annotation."""
    import pathlib
    import re
    from kinpoly_tpu_torch.scripts import profile_eval as pe
    root = pathlib.Path(pe.__file__).resolve().parents[1]
    names = set()
    for p in root.rglob("*.py"):
        text = p.read_text()
        names |= set(re.findall(r'span(?:ned)?\(\s*"([\w.]+)"', text))
        names |= {f"ar.{n}" for n in re.findall(r'_phase\("(\w+)"\)', text)}
    assert "physics.fk" in names and "ar.rollout" in names
    assert names == set(pe.GROUPS)
