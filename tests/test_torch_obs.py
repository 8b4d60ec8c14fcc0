"""PyTorch port, the observability plane: ``lightgbm_tpu_torch/obs/``,
``utils/timer.py`` and ``utils/supervise.py`` against the JAX package's
copies.

Each check feeds the same inputs to both packages' modules (no booster of
either package trains here, but the one-tree byte count of the port):
the event schema, the Prometheus text, the Chrome trace, the roofline
math, the regression sentinel over the repo's ``BENCH_r*.json``, the
report, the timer, ``run_stage``, the health server and a flight dump from
a killed child.  The repo's own journal and history files are read only;
everything written goes under ``tmp_path``.  CPU, well under a minute in
one process.
"""
import json
import os
import re
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from lightgbm_tpu.obs import costs as jcosts
from lightgbm_tpu.obs import events as jevents
from lightgbm_tpu.obs import health as jhealth
from lightgbm_tpu.obs import metrics as jmetrics
from lightgbm_tpu.obs import regress as jregress
from lightgbm_tpu.obs import report as jreport
from lightgbm_tpu.obs import tracer as jtracer
from lightgbm_tpu.utils import supervise as jsupervise
from lightgbm_tpu.utils import timer as jtimer

from lightgbm_tpu_torch.obs import costs as tcosts
from lightgbm_tpu_torch.obs import events as tevents
from lightgbm_tpu_torch.obs import flight as tflight
from lightgbm_tpu_torch.obs import health as thealth
from lightgbm_tpu_torch.obs import metrics as tmetrics
from lightgbm_tpu_torch.obs import regress as tregress
from lightgbm_tpu_torch.obs import report as treport
from lightgbm_tpu_torch.obs import tracer as ttracer
from lightgbm_tpu_torch.utils import supervise as tsupervise
from lightgbm_tpu_torch.utils import timer as ttimer
from lightgbm_tpu_torch.utils.log import LightGBMError

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOURNAL = os.path.join(REPO, "perf_results.jsonl")


@pytest.fixture(autouse=True)
def _clean_port_state():
    """The port's health plane and registries are process-global: every
    test ends with them clean."""
    yield
    thealth.stop_health_server()
    thealth._reset_status()
    tmetrics.reset()
    ttracer.get_tracer().reset()
    tflight.uninstall()


# ---------------------------------------------------------------------------
# one peak table
def test_no_peak_rate_figures_in_the_port_outside_its_costs():
    """Every peak rate of the port prices against
    ``lightgbm_tpu_torch/obs/costs.py:PEAK_RATES``: the JAX rule
    (tests/test_obs.py) applied to the port's package, ``chip_smoke.py``
    and ``scripts/torch_*.py``, and matched in units as well: rate names
    (``TB_PER_S``, ``TFLOP_PER_S``, ...), a figure times a power of ten
    of 1e9 or more, and figures of 100 or more beside TFLOP/TOP/TB units."""
    patterns = [
        # the JAX rule's pattern (its three names spelt in two parts, so
        # that rule's own walk over the tree does not flag this line)
        re.compile(r"\b\d+\.\d+e(?:9|1[0-9])\b|\b\d{2,}e(?:9|1[0-9])\b"
                   + "|PEAK_" + "BF16|_PEAK_" + "FLOPS|PEAK_" + "HBM"),
        re.compile(r"(?:TB|GB|TFLOP|TOP|TOPS|FLOP)_PER_S", re.I),
        re.compile(r"\b\d+(?:\.\d+)?\s*\*\s*1e(?:9|1[0-9])\b"
                   r"|\b1e(?:9|1[0-9])\s*\*\s*\d"),
        re.compile(r"\b\d{3,}(?:\.\d+)?\s*(?:TFLOP|TOP|TB/s)", re.I),
    ]
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "scripts", n)
              for n in sorted(os.listdir(os.path.join(REPO, "scripts")))
              if n.startswith("torch_") and n.endswith(".py")]
    for root, dirs, names in os.walk(os.path.join(REPO,
                                                  "lightgbm_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    allowed = os.path.join(REPO, "lightgbm_tpu_torch", "obs", "costs.py")
    offenders = []
    for path in files:
        if path == allowed:
            continue
        for i, line in enumerate(open(path, errors="replace"), 1):
            code = line.split("#", 1)[0]
            if any(p.search(code) for p in patterns):
                offenders.append(f"{os.path.relpath(path, REPO)}:{i}: "
                                 f"{line.strip()}")
    assert not offenders, "\n".join(offenders)
    # and the table itself holds the H100's rates the kernels' bounds read
    h100 = tcosts.PEAK_RATES["h100"]
    assert h100["bytes_per_sec"] < h100["f32_flops"] < h100["flops"] \
        < h100["int8_ops"]


# ---------------------------------------------------------------------------
# events
def test_events_validate_across_packages_and_classify_the_journal(tmp_path):
    jrec = jevents.make_event("train_iter", "j" * 12, iteration=3)
    trec = tevents.make_event("train_iter", "t" * 12, iteration=3)
    assert tevents.validate_event(jrec) == [] == jevents.validate_event(trec)
    for bad in ({}, [], {"schema_version": 0, "run_id": "", "event": "",
                         "ts": "x", "mono": True}):
        assert tevents.validate_event(bad) == jevents.validate_event(bad)
    with open(JOURNAL) as f:
        lines = f.readlines()
    assert lines
    for line in lines + ["", "not json", "[1]", '{"schema_version": 1}']:
        assert tevents.classify_record(line) == jevents.classify_record(line)
    # the default journal resolves the same way (WATCHER_PERF_LOG first)
    env = {"WATCHER_PERF_LOG": str(tmp_path / "w.jsonl")}
    assert tevents.perf_log_path(env) == jevents.perf_log_path(env)
    assert tevents.perf_log_path({}) == jevents.perf_log_path({}) == JOURNAL
    # a port log's lines read back as schema events in both packages
    log = tevents.EventLog(str(tmp_path / "j.jsonl"))
    log.emit("train_tree", iteration=0, num_leaves=7)
    line = open(log.path).read()
    assert jevents.classify_record(line)[0] == "event"
    assert tevents.classify_record(line) == jevents.classify_record(line)


# ---------------------------------------------------------------------------
# metrics
def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("train.iterations").inc()
    reg.counter("train.iterations").inc(4)
    reg.gauge("train.device_bytes_in_use").set(1024)
    reg.gauge("train.device_peak_bytes_in_use").set_max(4096)
    reg.gauge("train.device_peak_bytes_in_use").set_max(2048)
    hist = reg.histogram("train.grow_tree_seconds", 64)
    for v in np.linspace(0.01, 0.5, 40):
        hist.observe(float(v))
    return reg.snapshot()


def test_metrics_render_the_same_prometheus_text():
    jsnap, tsnap = _drive_registry(jmetrics), _drive_registry(tmetrics)
    assert tsnap == jsnap

    def text(mod, snap):
        # the uptime series is the one clock in the text
        return [l for l in mod.render_prometheus(snap).splitlines()
                if not l.startswith("lgbtpu_health_uptime_seconds ")]
    assert text(thealth, tsnap) == text(jhealth, jsnap)
    assert any(l.startswith('lgbtpu_train_grow_tree_seconds{quantile="0.99"}')
               for l in text(thealth, tsnap))


# ---------------------------------------------------------------------------
# tracer
def _nested_trace(mod, path):
    tr = mod.Tracer()
    with tr.step("train/iteration", step=0):
        with tr.span("GBDT::gradients"):
            pass
        tr.begin("GBDT::grow_tree")
        with tr.span("inner", leaf=3):
            pass
        tr.end("GBDT::grow_tree")
    tr.end("never_opened")                  # unbalanced ends are ignored
    n = tr.export_chrome_trace(str(path))
    doc = json.load(open(path))
    shape = [(e["name"], e["ph"], e.get("args")) for e in doc["traceEvents"]]
    depths = [(s.name, s.depth) for s in tr.spans()]
    agg = {k: v["count"] for k, v in tr.aggregate().items()}
    return n, doc["displayTimeUnit"], shape, depths, agg


def test_tracer_exports_the_same_chrome_trace(tmp_path):
    got = _nested_trace(ttracer, tmp_path / "t.json")
    assert got == _nested_trace(jtracer, tmp_path / "j.json")
    assert got[3] == [("GBDT::gradients", 1), ("inner", 2),
                      ("GBDT::grow_tree", 1), ("train/iteration", 0)]


def test_device_ranges_label_a_profile_on_the_cpu():
    """``obs_trace_device``'s ranges reach torch.profiler (on the CPU
    here; on the card they also push NVTX ranges)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    tr = ttracer.Tracer(annotate_device=True)
    fn = ttracer.device_ranged("lgbm/hist", lambda x: x * 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.step("train/iteration", step=5):
            fn(torch.ones(4))
        rnd = ttracer.DeviceRange("lgbm/frontier_round").open()
        rnd.close()
    keys = {e.key for e in prof.key_averages()}
    assert {"train/iteration", "lgbm/hist", "lgbm/frontier_round"} <= keys
    assert [s.args for s in tr.spans()] == [{"step": 5}]


@pytest.mark.parametrize("grower,ranges", [
    ("auto", ("lgbm/hist", "lgbm/split_search", "lgbm/frontier_round")),
    ("serial", ("lgbm/hist", "lgbm/split_search", "lgbm/partition",
                "lgbm/apply_split"))])
def test_growers_label_their_phases_under_obs_trace_device(grower, ranges):
    """``obs_trace_device`` labels each grower's phases (the JAX package's
    ``lgbm/*`` named scopes) and changes no tree."""
    import lightgbm_tpu_torch as lgt
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    X = rng.normal(size=(2000, 5)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float64)
    params = dict(objective="binary", num_leaves=7, verbose=-1,
                  tree_grower=grower)
    plain = lgt.train(params, lgt.Dataset(X, label=y), 2,
                      verbose_eval=False, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = lgt.train(dict(params, obs_trace_device=True),
                           lgt.Dataset(X, label=y), 2, verbose_eval=False,
                           device="cpu")
    keys = {e.key for e in prof.key_averages()}
    assert set(ranges) <= keys, sorted(k for k in keys if "lgbm" in k)
    split = "\nparameters:\n"
    assert (traced.model_to_string().split(split)[0]
            == plain.model_to_string().split(split)[0])


# ---------------------------------------------------------------------------
# costs
def test_costs_roofline_on_the_cpu_row_and_the_card_names():
    for flops, nbytes, secs in ((1e9, 1e9, 0.01), (5e12, 1e9, 2.0),
                                (0.0, 8e6, 0.5), (1e6, 0.0, 1.0)):
        assert (tcosts.roofline(flops, nbytes, secs, "cpu")
                == jcosts.roofline(flops, nbytes, secs, "cpu"))
        assert (tcosts.mfu(flops, secs, "cpu")
                == jcosts.mfu(flops, secs, "cpu"))
        ai = tcosts.arithmetic_intensity(flops, nbytes)
        assert ai == jcosts.arithmetic_intensity(flops, nbytes)
        assert (tcosts.classify_bound(ai, "cpu")
                == jcosts.classify_bound(ai, "cpu"))
    assert tcosts.PEAK_RATES["cpu"] == jcosts.PEAK_RATES["cpu"]
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB", "h100"):
        assert tcosts.normalize_chip(name) == "h100"
    assert tcosts.normalize_chip(None) == "cpu"
    assert tcosts.current_chip("cpu") == "cpu"
    for other in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe",
                  "NVIDIA H100 NVL", "TPU v5 lite"):
        with pytest.raises(LightGBMError, match=re.escape(other)):
            tcosts.normalize_chip(other)
    bw = tcosts.PEAK_RATES["h100"]["bytes_per_sec"]
    rec = tcosts.roofline(0.0, bw / 1e6, 1e-3, "NVIDIA H100 80GB HBM3")
    assert rec["chip"] == "h100" and rec["bound"] == "bandwidth"
    assert rec["hbm_util"] == pytest.approx(1e-3)


def test_cost_ledger_takes_the_port_count_and_emits(tmp_path):
    led = tcosts.CostLedger()
    with pytest.raises(LightGBMError, match="chip"):
        led.record("p")
    led.record("train.grow_tree", cost={"bytes_accessed": 3e8},
               memory={"peak_bytes": 123}, chip="cpu", rows=10)
    led.observe("train.grow_tree", 0.5)
    led.observe("train.grow_tree", 0.5)
    led.observe("unknown", 1.0)                   # no-op, as in JAX
    (row,) = led.rooflines()
    assert row["flops_source"] == "model" and row["calls"] == 2
    assert row["bytes_accessed"] == 6e8 and row["memory"] == {
        "peak_bytes": 123}
    assert row["hbm_util"] == pytest.approx(
        6e8 / tcosts.PEAK_RATES["cpu"]["bytes_per_sec"])
    log = tevents.EventLog(str(tmp_path / "c.jsonl"))
    assert led.emit(log) == 1
    (line,) = open(log.path).read().splitlines()
    rec = json.loads(line)
    assert rec["event"] == "program_cost" and rec["program"] == (
        "train.grow_tree")
    rows = jreport.roofline_rows(jreport.load_perf_log(log.path))
    assert treport.render_roofline(rows) == jreport.render_roofline(rows)
    assert "train.grow_tree" in treport.render_roofline(rows)


def test_watermarks_are_empty_on_the_cpu_and_mirror_a_provider():
    reg = tmetrics.MetricsRegistry()
    assert tcosts.record_watermarks("train", reg, "cpu") == {}
    assert tcosts.record_watermarks("train", reg, None) == {}
    stats = {"bytes_in_use": 10, "peak_bytes_in_use": 30}
    for mod in (tcosts, jcosts):
        mod.set_stats_provider(lambda: stats)
    try:
        regs = [tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()]
        got = tcosts.record_watermarks("train", regs[0], "cpu")
        assert got == jcosts.record_watermarks("train", regs[1]) == stats
        assert regs[0].snapshot() == regs[1].snapshot()
    finally:
        for mod in (tcosts, jcosts):
            mod.set_stats_provider(None)


def test_grow_tree_cost_counts_the_histogram_calls_bytes(tmp_path,
                                                         monkeypatch):
    """The port's ``train.grow_tree`` record of one small tree: the bytes
    its histogram calls read and wrote, by hand from each call's shape
    (each bin column of every row, 12 bytes of grad/hess/mask a row, 4
    bytes a block of the leaves' map, 12 bytes an output bin)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import frontier
    calls = []
    full, leaves = frontier.build_histogram, frontier.build_histogram_leaves

    def spy_full(bins, g, h, m, B, **kw):
        f = min(kw.get("f_limit") or bins.shape[1], bins.shape[1])
        calls.append(bins.element_size() * bins.shape[0] * f
                     + 12 * bins.shape[0] + f * B * 12)
        return full(bins, g, h, m, B, **kw)

    def spy_leaves(comb, g, h, m, block_leaf, k, B, **kw):
        f = min(kw.get("f_limit") or comb.shape[1], comb.shape[1])
        calls.append(comb.element_size() * comb.shape[0] * f
                     + 12 * comb.shape[0] + 4 * block_leaf.shape[0]
                     + k * f * B * 12)
        return leaves(comb, g, h, m, block_leaf, k, B, **kw)
    monkeypatch.setattr(frontier, "build_histogram", spy_full)
    monkeypatch.setattr(frontier, "build_histogram_leaves", spy_leaves)
    tcosts.reset_ledger()
    rng = np.random.default_rng(3)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.normal(size=3000) > 0).astype(np.float64)
    params = dict(objective="binary", num_leaves=15, max_bin=63,
                  verbose=-1, obs_telemetry=True,
                  obs_events_path=str(tmp_path / "j.jsonl"))
    lgt.train(params, lgt.Dataset(X, label=y), 1, verbose_eval=False,
              device="cpu")
    ent = tcosts.get_ledger().entry("train.grow_tree")
    assert len(calls) >= 2
    assert ent["cost"] == {"bytes_accessed": float(sum(calls))}
    assert ent["chip"] == "cpu" and "memory" not in ent
    assert ent["meta"] == {"rows": 3000, "features": 6}
    tcosts.reset_ledger()


# ---------------------------------------------------------------------------
# regress + report
def test_regress_scans_the_repo_history_alike():
    glob = os.path.join(REPO, "BENCH_r*.json")
    t = tregress.scan(journal_path=JOURNAL, bench_glob=glob)
    j = jregress.scan(journal_path=JOURNAL, bench_glob=glob)
    assert t == j
    assert t["verdicts"]
    for base, latest, d in (([1.0, 1.0, 1.02, 0.99], 2.0, "lower"),
                            ([5.0, 5.1], 9.0, "higher")):
        assert (tregress.classify(base, latest, d)
                == jregress.classify(base, latest, d))


def _journal(path):
    log = tevents.EventLog(str(path), run_id="abc123abc123")
    log.emit("train_iter", iteration=0, trees=1,
             phase_seconds={"grow_tree": 0.2})
    log.emit("train_tree", iteration=0, num_leaves=7,
             split_gain={"splits": 6, "max": 3.0, "mean": 1.0, "total": 6.0})
    log.emit("program_cost", program="train.grow_tree", chip="h100",
             calls=2, seconds=0.4, seconds_per_call=0.2, flops=0.0,
             bytes_accessed=1e8, mfu=0.0, hbm_util=0.1, bound="bandwidth",
             intensity=0.0, flops_source="model")
    log.emit("bench_summary", metric="higgs_train_throughput", value=4.5,
             unit="Mrow_iters/s", backend="gpu", rows=1000)
    with open(path, "a") as f:
        f.write('{"metric": "legacy_metric", "value": 1.0}\nnot json\n')


def test_report_renders_the_same_markdown_and_json(tmp_path):
    path = tmp_path / "journal.jsonl"
    _journal(path)
    tl, jl = treport.load_perf_log(str(path)), jreport.load_perf_log(
        str(path))
    assert tl == jl
    snap = _drive_registry(tmetrics)
    ts, js = treport.summarize(tl, snap), jreport.summarize(jl, snap)
    assert treport.render_markdown(ts) == jreport.render_markdown(js)
    assert treport.render_json(ts) == jreport.render_json(js)
    rows = treport.roofline_rows(tl)
    assert treport.render_roofline(rows) == jreport.render_roofline(rows)
    res = tregress.scan(journal_path=str(path), bench_glob=str(
        tmp_path / "none_*.json"))
    assert (treport.render_regressions(res, gate=True)
            == jreport.render_regressions(res, gate=True))
    data = {"ok": True, "run_id": "r", "stage": "train", "iteration": 4,
            "status": {"numeric_ok": True}, "tracer": {}, "slo": [],
            "flight": {}, "device_memory": {}}
    assert treport.render_health(data) == jreport.render_health(data)


def test_obs_report_command_line(tmp_path, capsys):
    from lightgbm_tpu_torch.application import main
    path = tmp_path / "journal.jsonl"
    _journal(path)
    out = tmp_path / "report.md"
    assert main(["obs-report", "--path", str(path), "--no-metrics",
                 "--out", str(out)]) == 0
    text = out.read_text()
    assert "train_iter" in text and "higgs_train_throughput" in text
    assert main(["obs-report", "--path", str(path), "--roofline"]) == 0
    assert "train.grow_tree" in capsys.readouterr().out
    assert main(["obs-report", "--path", str(path), "--regressions",
                 "--gate", "--bench-glob", str(tmp_path / "x_*.json")]) == 0


# ---------------------------------------------------------------------------
# timer + supervise
class _Clock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.25
        return self.t


def _timed(mod, monkeypatch):
    monkeypatch.setattr(mod, "time", _Clock())
    t = mod.Timer()
    tr = []

    class Rec:
        def begin(self, name):
            tr.append(("begin", name))

        def end(self, name):
            tr.append(("end", name))
    t.attach_tracer(Rec())
    with t.scope("GBDT::grow_tree"):
        with t.scope("GBDT::grow_tree"):         # the same name nests
            pass
        t.start("GBDT::gradients")
        t.stop("GBDT::gradients")
    t.stop("never_started")                      # ignored
    t.detach_tracer()
    with t.scope("GBDT::update_score"):
        pass
    return ([(n, s, t.calls(n)) for n, s in t.items()], tr,
            t.seconds("absent"))


def test_timer_accounts_scopes_alike(monkeypatch):
    got = _timed(ttimer, monkeypatch)
    assert got == _timed(jtimer, monkeypatch)
    assert got[0][0] == ("GBDT::grow_tree", 1.5, 2)


def test_run_stage_gives_the_same_result(tmp_path):
    child = [sys.executable, "-c",
             "import json; print('noise'); print(json.dumps({'x': 1}))"]
    fail = [sys.executable, "-c", "import sys; sys.exit(3)"]
    for argv, status in ((child, "ok"), (fail, "crash")):
        t = tsupervise.run_stage("s", argv, timeout=60, retries=1,
                                 backoff=0.0, flight_dir=str(tmp_path),
                                 sleep=lambda s: None)
        j = jsupervise.run_stage("s", argv, timeout=60, retries=1,
                                 backoff=0.0, flight_dir=str(tmp_path),
                                 sleep=lambda s: None)
        for field in ("name", "status", "returncode", "attempts",
                      "output_tail", "flight_dumps"):
            assert getattr(t, field) == getattr(j, field), field
        assert t.status == status
    assert tsupervise.extract_json_line(t.output_tail) is None
    assert tsupervise.extract_json_line("a\n{\"x\": 1}\n") == {"x": 1}
    assert (tsupervise.backoff_schedule(3, 1.0, jitter=0.0)
            == jsupervise.backoff_schedule(3, 1.0, jitter=0.0))


# ---------------------------------------------------------------------------
# health server + flight recorder
def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read().decode()


def test_health_server_answers_on_an_ephemeral_port():
    server = thealth.start_health_server(0)
    assert server is not None and server.port > 0
    assert thealth.maybe_start(0) is server          # idempotent
    tmetrics.counter("train.iterations").inc(3)
    thealth.set_status(run_id="r1", stage="train", iteration=7)
    code, body = _get(server.url + "/metrics")
    assert code == 200 and "lgbtpu_train_iterations 3" in body
    code, body = _get(server.url + "/healthz")
    doc = json.loads(body)
    assert code == 200 and doc["ok"] and doc["iteration"] == 7
    assert doc["run_id"] == "r1" and doc["stage"] == "train"
    with pytest.raises(urllib.error.HTTPError):
        _get(server.url + "/nope")


def test_check_numeric_dumps_and_raises(tmp_path):
    tflight.install(dir=str(tmp_path), run_id="num")
    log = tevents.EventLog(str(tmp_path / "j.jsonl"))
    assert thealth.check_numeric(
        {"grad": {"finite_frac": 1.0, "max_abs": 2.0}}, iteration=0, log=log)
    with pytest.raises(thealth.DivergenceError) as ei:
        thealth.check_numeric({"grad": {"finite_frac": 0.5, "max_abs": 2.0},
                               "hess": {"finite_frac": 1.0,
                                        "max_abs": float("inf")}},
                              iteration=4, log=log)
    assert ei.value.iteration == 4
    assert str(ei.value).startswith(
        "numeric divergence at iteration 4: non-finite values in grad, hess")
    assert ei.value.flight_path == str(tmp_path / "flight_num.jsonl")
    evs = [json.loads(l) for l in open(ei.value.flight_path)]
    assert evs[0]["event"] == "flight_dump"
    assert [e["ok"] for e in evs if e["event"] == "numeric_health"] == [
        True, False]


_CRASH_CHILD = """
import os, signal, sys
sys.path.insert(0, {repo!r})
from lightgbm_tpu_torch.obs import flight
rec = flight.install(dir={dir!r}, run_id="victim", flush_every=1)
rec.note("about_to_die", mode="sigkill")
import lightgbm_tpu_torch.parallel
assert "jax" not in sys.modules
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_flight_dump_survives_sigkill(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(_CRASH_CHILD.format(repo=REPO, dir=str(tmp_path)))
    env = {k: v for k, v in os.environ.items() if k != "LGBM_FLIGHT_DIR"}
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=120, env=env)
    assert p.returncode == -signal.SIGKILL, p.stderr
    evs = [json.loads(l) for l in open(tmp_path / "flight_victim.jsonl")]
    assert all(jevents.validate_event(e) == [] for e in evs)
    assert evs[0]["event"] == "flight_dump" and evs[0]["reason"] == (
        "periodic")
    assert any(e["event"] == "about_to_die" for e in evs)
