"""Observability in the port (``repro_torch.obs``, the engine's spans and
counters, the pipeline's phase probes), on the CPU:

* the registry: the port's ``Histogram`` snapshot equals the reference's
  on the same seeded samples; create-on-use and reset;
* the export schema: JSONL round trip, bad events rejected, the Chrome
  trace; the disabled tracer is a no-op (the shared null span, no
  ``record_function``);
* a trace the port records validates with ``repro.obs.export`` and
  renders to the same text with ``repro.obs.report.render`` as with the
  port's;
* the engine: instrumented == uninstrumented bit for bit (scan mode, with
  calibrated stage spans; step mode, with stage spans and step records);
  timings and step counters reset between runs; guards and obs on add no
  host read to a scan-mode step (the flags and counters come back with
  the window's verdict); a ``torch.profiler`` capture (``xla_trace_dir``)
  holds the engine's spans;
* 8 virtual ranks: the DD counters recorded through scan windows equal
  the provider's own diagnostics; the last phase probe IS the fused force
  function (bit for bit) and ``timed_prefix_phases`` splits it into the
  Fig.-12 phases.
"""
import json

import numpy as np
import pytest
import torch

from repro.obs import Histogram as JHistogram
from repro.obs import export as jexport
from repro.obs import report as jreport
from repro_torch.core import DeepmdForceProvider, suggest_config
from repro_torch.dp import DPConfig, DPModel, DescriptorConfig
from repro_torch.health import GuardConfig
from repro_torch.md import (EngineConfig, MDEngine, build_solvated_protein,
                            mark_nn_group)
from repro_torch.obs import (Counter, Gauge, Histogram, ObsConfig, Registry,
                             Tracer, export, report, timed_prefix_phases)
from repro_torch.obs.trace import _NULL_SPAN, read_host

torch.set_num_threads(1)

_CFG = dict(cutoff=0.9, neighbor_capacity=96, dt=0.0005, thermostat_t=200.0)


# -- registry ------------------------------------------------------------------

def test_histogram_snapshot_equals_reference():
    samples = np.random.default_rng(11).lognormal(-6.0, 1.5, 3000)
    ours, theirs = Histogram(lo=1e-6), JHistogram(lo=1e-6)
    for s in samples:
        ours.observe(s)
        theirs.observe(s)
    assert ours.snapshot() == theirs.snapshot()
    assert ours._counts == theirs._counts
    for q in (0.0, 0.37, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    one = Histogram()
    one.observe(3.0)
    assert one.quantile(0.0) == one.quantile(0.99) == 3.0
    assert Histogram().snapshot()["count"] == 0


def test_registry_create_on_use_and_reset():
    r = Registry()
    r.counter("steps").inc()
    r.counter("steps").inc(4)
    r.gauge("depth").set(3)
    r.gauge("depth").set(1)
    r.histogram("lat").observe(0.5)
    snap = r.snapshot()
    assert snap["counters"]["steps"] == 5
    assert snap["gauges"]["depth"] == {"value": 1, "peak": 3}
    assert snap["histograms"]["lat"]["count"] == 1
    assert isinstance(r.counter("steps"), Counter)
    assert isinstance(r.gauge("depth"), Gauge)
    r.reset()
    assert r.snapshot()["counters"] == {}


# -- export schema -------------------------------------------------------------

_EVENTS = [
    {"type": "meta", "kind": "run", "n_steps": 4},
    {"type": "span", "name": "scan_window", "ts": 0.1, "dur": 0.05,
     "phase": "scan", "steps": 4, "tid": 0},
    {"type": "instant", "name": "profile_capture_start", "ts": 0.2},
    {"type": "step", "step": 0, "rank_cost": [3, 4], "cost_ratio": 1.1,
     "rebuild": False},
]


def test_jsonl_round_trip_and_chrome_trace(tmp_path):
    path = str(tmp_path / "events.jsonl")
    export.write_jsonl(_EVENTS, path)
    back = export.read_jsonl(path)
    assert back == _EVENTS
    jexport.validate_events(back)
    doc = json.load(open(export.write_chrome_trace(
        _EVENTS, str(tmp_path / "trace.json"))))
    evs = doc["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert len(xs) == 1 and xs[0]["name"] == "scan_window"
    assert xs[0]["dur"] == pytest.approx(0.05 * 1e6)  # microseconds
    assert any(e["ph"] == "i" for e in evs)
    assert all({"ph", "pid", "ts"} <= set(e) for e in evs if e["ph"] != "M")
    ref = jexport.chrome_trace(_EVENTS)
    assert [e for e in evs if e["ph"] != "M"] == \
        [e for e in ref["traceEvents"] if e["ph"] != "M"]


@pytest.mark.parametrize("bad", [{"name": "no type"},
                                 {"type": "span", "name": "x"},
                                 {"type": "step"},
                                 {"type": "step", "step": 1, "x": "s"},
                                 {"type": "wat", "name": "x"}])
def test_jsonl_rejects_bad_events(tmp_path, bad):
    with pytest.raises(ValueError):
        export.write_jsonl([bad], str(tmp_path / "bad.jsonl"))


def test_disabled_tracer_is_noop(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: calls.append(a))
    tr = Tracer(None)
    assert not tr.enabled and not tr.wants_counters
    assert tr.span("anything", phase="x") is _NULL_SPAN  # shared object
    with tr.span("anything"):
        pass
    tr.meta(kind="run")
    tr.instant("mark")
    tr.add_span("derived", 0.1)
    tr.record_window(0, 4, {"c": torch.zeros(4)})
    tr.record_step(0, {"c": 1})
    assert tr.events == [] and calls == []
    assert tr.flush() is None
    assert not tr.start_capture()
    cfg = ObsConfig(enabled=True)
    assert Tracer.ensure(Tracer(cfg)).enabled
    assert not Tracer.ensure(None).enabled


def test_read_host_is_one_exact_read():
    vals = [torch.tensor(True), torch.arange(3, dtype=torch.int32),
            torch.tensor([[1.5, -2.25e-7]]), 7, np.zeros(2)]
    got = read_host(vals)
    assert got[0].dtype == bool and bool(got[0])
    assert got[1].dtype == np.int32 and got[1].tolist() == [0, 1, 2]
    assert got[2].dtype == np.float32
    np.testing.assert_array_equal(got[2], vals[2].numpy())
    assert int(got[3]) == 7 and got[4].shape == (2,)


# -- the engine ----------------------------------------------------------------

@pytest.fixture(scope="module")
def md():
    system, pos, nn = build_solvated_protein(5, water_per_protein_atom=1.5,
                                             device="cpu")
    system = mark_nn_group(system, nn)
    desc = DescriptorConfig(kind="dpa1", rcut=0.6, rcut_smth=0.3, sel=32,
                            ntypes=4, neuron=(8, 16), axis_neuron=4,
                            attn_layers=1, attn_hidden=32)
    model = DPModel(DPConfig(descriptor=desc, fitting_neuron=(24, 24)),
                    device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    box = system.box.numpy()

    def provider(ranks=0):
        dd = None
        if ranks:
            dd = suggest_config(len(nn), box, ranks, 0.6, nbr_capacity=48,
                                slack=2.5, skin=0.04,
                                force_mode="ghost_reduce",
                                coords=pos.numpy()[nn])
        return DeepmdForceProvider(model, params, nn, system.types, box,
                                   system.n_atoms, nbr_capacity=48,
                                   skin=0.08, dd_config=dd, device="cpu")

    return system, pos, provider


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("positions", "velocities", "forces", "step"))


@pytest.mark.parametrize("mode", ["scan", "step"])
def test_instrumented_run_bitwise_equals_uninstrumented(md, mode, tmp_path):
    system, pos, provider = md
    runs = {}
    for tag, obs in [("off", None),
                     ("on", ObsConfig(enabled=True,
                                      trace_dir=str(tmp_path / "trace")))]:
        eng = MDEngine(system, EngineConfig(**_CFG, loop_mode=mode),
                       special_force=provider(), obs=obs)
        runs[tag] = (eng.run(eng.init_state(pos, 200.0), 10), eng)
    (st_off, _), (st_on, eng_on) = runs["off"], runs["on"]
    assert _same(st_off, st_on)
    events = eng_on.tracer.events
    steps = [e for e in events if e["type"] == "step"]
    assert [e["step"] for e in steps] == list(range(10))
    phases = {e.get("phase") for e in events if e["type"] == "span"
              and not e.get("calibrated")}
    if mode == "scan":
        cal = {e["phase"] for e in events if e.get("calibrated")}
        assert {"scan.neighbor", "scan.classical", "scan.inference",
                "scan.integrate"} <= cal
        assert "scan" in phases
    else:
        assert {"neighbor", "classical", "inference", "integrate"} <= phases
    # run() flushed into trace_dir: the log loads with either package
    # and renders to the same text
    logged = report.load(str(tmp_path / "trace" / "events.jsonl"))
    jexport.validate_events(logged)
    assert jreport.render(logged) == report.render(logged)
    assert report.counter_summary(logged)["n_steps"] == 10
    assert report.summarize(logged) == jreport.summarize(logged)


def test_timings_and_step_counters_reset_per_run(md):
    system, pos, provider = md
    eng = MDEngine(system, EngineConfig(**_CFG), special_force=provider(),
                   obs=ObsConfig(enabled=True))
    st = eng.run(eng.init_state(pos, 200.0), 6)
    assert eng.timings["scan"] > 0
    assert len([e for e in eng.tracer.events if e["type"] == "step"]) == 6
    # a restart from step 0: without clearing, steps 0..5 appear twice
    eng.run(eng.init_state(pos, 200.0), 4)
    assert [e["step"] for e in eng.tracer.events
            if e["type"] == "step"] == list(range(4))
    metas = [e for e in eng.tracer.events
             if e["type"] == "meta" and e.get("kind") == "run"]
    assert len(metas) == 2
    t_second = dict(eng.timings)
    eng.run(st, 2)
    assert eng.timings["scan"] != t_second["scan"]   # rewritten, not added
    eng.reset()
    assert all(v == 0.0 for v in eng.timings.values())
    assert eng.diagnostics["displacement_rebuilds"] == 0
    assert eng.tracer.events == []


def _count_host_reads(monkeypatch):
    """Count every tensor -> host conversion a run makes."""
    n = [0]
    for name in ("tolist", "item", "__bool__", "__int__", "__float__",
                 "numpy", "cpu"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, **k):
            n[0] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return n


def test_guards_and_obs_add_no_host_read_per_step(md, monkeypatch):
    """Scan mode: with guards and counters on, the guard flag and the
    counters come back in the window's verdict read, so a run makes as
    many host reads as with both off."""
    system, pos, provider = md
    reads = {}
    for tag, kw in (("off", {}),
                    ("on", dict(guard=GuardConfig(enabled=True),
                                obs=ObsConfig(enabled=True, spans=False,
                                              calibrate=False)))):
        eng = MDEngine(system, EngineConfig(**_CFG), special_force=provider(),
                       **kw)
        st = eng.init_state(pos, 200.0)
        with monkeypatch.context() as m:
            n = _count_host_reads(m)
            eng.run(st, 10)
        reads[tag] = n[0]
    assert reads["on"] == reads["off"] > 0


def test_dd_counters_through_scan_windows_equal_the_provider_diag(md):
    system, pos, provider = md
    prov = provider(ranks=8)
    tracer = Tracer(ObsConfig(enabled=True, calibrate=False))
    eng = MDEngine(system, EngineConfig(**_CFG), special_force=prov,
                   obs=tracer)
    state = eng.run(eng.init_state(pos, 200.0), 6)
    steps = [e for e in tracer.events if e["type"] == "step"]
    assert [e["step"] for e in steps] == list(range(6))
    for key in ("rank_cost", "cost_max", "cost_ratio", "nbr_occupancy",
                "rank_occupancy", "local_count", "ghost_count", "max_disp2",
                "rank_nonfinite", "rebuild", "sp_rebuild", "e_special"):
        assert key in steps[-1], key
    # the decomposition at the last step's positions: the provider's own
    # evaluation diagnostics equal the recorded last-step counters
    _, _, fl = prov.evaluate(state.positions, prov.assemble(state.positions))
    truth = {k: np.asarray(v).tolist() for k, v in fl["counters"].items()}
    for key in ("local_count", "ghost_count", "rank_cost", "cost_max",
                "rank_nonfinite"):
        assert steps[-1][key] == truth[key], key
    rc = np.asarray(steps[-1]["rank_cost"])
    assert rc.shape == (8,) and rc.max() == steps[-1]["cost_max"]
    assert rc.sum() == steps[-1]["local_count"] + steps[-1]["ghost_count"]
    assert all(0 < e["nbr_occupancy"] <= 1 for e in steps)
    imb = report.imbalance_table(steps)
    assert imb["n_samples"] == 6 and len(imb["ranks"]) == 8


def test_phase_probes_split_the_fused_force_function(md):
    system, pos, provider = md
    prov = provider(ranks=8)
    pipe = prov.pipeline
    probes = pipe.build_phase_probes()
    assert list(probes) == ["gather", "assembly", "inference",
                            "force_reduce"]
    x = prov._to_model(pos)
    e0, f0, d0 = pipe.build_force_fn()(prov.params, x, prov.nn_types)
    e1, f1, d1 = probes["force_reduce"](prov.params, x, prov.nn_types)
    assert torch.equal(e0, e1) and torch.equal(f0, f1)
    assert all(torch.equal(d0[k], d1[k]) for k in d0)
    for name in ("gather", "assembly", "inference"):
        v = probes[name](prov.params, x, prov.nn_types)
        assert v.shape == (8,) and bool(torch.isfinite(v).all())
    tracer = Tracer(ObsConfig(enabled=True))
    split = timed_prefix_phases(
        tracer, {k: (lambda fn=fn: fn(prov.params, x, prov.nn_types))
                 for k, fn in probes.items()}, iters=1)
    assert list(split) == list(probes) and all(v >= 0 for v in split.values())
    frac = report.stage_fractions(tracer.events)
    assert set(frac) == set(probes)
    assert sum(a["fraction"] for a in frac.values()) == pytest.approx(1.0)


def test_profiler_capture_holds_the_engine_spans(md, tmp_path):
    """``xla_trace_dir``: a ``torch.profiler`` capture around the run,
    written as ``torch_trace.json``, whose events carry the engine's span
    names (``record_function``)."""
    system, pos, provider = md
    d = str(tmp_path / "prof")
    eng = MDEngine(system, EngineConfig(**_CFG), special_force=provider(),
                   obs=ObsConfig(enabled=True, calibrate=False,
                                 xla_trace_dir=d))
    eng.run(eng.init_state(pos, 200.0), 3)
    names = {e.get("name") for e in json.load(
        open(f"{d}/torch_trace.json"))["traceEvents"]}
    assert {"build", "scan_window"} <= names
    assert [e["name"] for e in eng.tracer.events if e["type"] == "instant"] \
        == ["profile_capture_start", "profile_capture_stop"]
