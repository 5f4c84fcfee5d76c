"""The port's run ledger and regression sentinel
(``horovod_tpu_torch/goodput/ledger.py``) against the JAX package's
``horovod_tpu/goodput/ledger.py``: the record's keys, append and read
with a torn tail, the once-per-run shutdown record, and the sentinel's
verdicts on the same synthetic directories (never on the repo's
committed files)."""

import json

import pytest

from horovod_tpu.config import knobs as jknobs
from horovod_tpu.goodput import ledger as jledger
import horovod_tpu_torch as htt
from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.goodput import ledger
from horovod_tpu_torch.goodput import numerics


@pytest.fixture(autouse=True)
def _clean():
    yield
    for kn in (knobs, jknobs):
        kn.clear_override("HOROVOD_GOODPUT_LEDGER")
        kn.clear_override("HOROVOD_NUMERICS")
    numerics.reset_for_tests()


def test_record_keys_equal_jax():
    got, want = ledger.build_record(), jledger.build_record()
    assert set(got) == set(want)
    assert got["schema"] == want["schema"] == ledger.SCHEMA_VERSION
    assert got["chip"] == "cpu" and got["world_size"] == 1
    assert len(got["knob_fingerprint"]) == 16
    assert got["artifact_store"] is None and got["numerics"] is None
    assert got["collective_fingerprints"] == {}
    json.dumps(got)                               # one JSON line


def test_knob_fingerprint_follows_the_knobs():
    a = ledger.knob_fingerprint()
    knobs.set_override("HOROVOD_NUMERICS", True)
    try:
        b = ledger.knob_fingerprint()
    finally:
        knobs.clear_override("HOROVOD_NUMERICS")
    assert a != b and ledger.knob_fingerprint() == a


def test_append_and_read(tmp_path):
    p = str(tmp_path / "sub" / "ledger.jsonl")
    rec = ledger.append_record(path=p, bench={"value": 1.0})
    assert rec["bench"] == {"value": 1.0}
    rows = ledger.read_ledger(p)
    assert len(rows) == 1 and rows[0]["bench"] == {"value": 1.0}
    assert jledger.read_ledger(p) == rows


def test_torn_tail_line_is_skipped_by_both(tmp_path):
    p = tmp_path / "ledger.jsonl"
    p.write_text('{"schema": 1, "goodput": {}}\n\n[1, 2]\n{"torn')
    assert ledger.read_ledger(str(p)) == jledger.read_ledger(str(p))
    assert len(ledger.read_ledger(str(p))) == 1
    ledger.append_record(path=str(p))       # appends after the torn line
    assert len(ledger.read_ledger(str(p))) == 1


def test_no_path_is_a_noop(tmp_path):
    assert ledger.append_record() is None
    assert ledger.read_ledger() == []


def test_shutdown_writes_once_per_run(tmp_path):
    p = str(tmp_path / "ledger.jsonl")
    knobs.set_override("HOROVOD_GOODPUT_LEDGER", p)
    knobs.set_override("HOROVOD_NUMERICS", True)
    htt.init(device="cpu")
    numerics.get_monitor().observe_step(1, loss=float("nan"))
    numerics.get_monitor().drain()
    htt.shutdown()
    rows = ledger.read_ledger(p)
    assert len(rows) == 1
    assert rows[0]["numerics"]["anomalies"] == 1
    assert rows[0]["goodput"]["total_seconds"] > 0
    # an explicit append marks the run recorded: the next init/shutdown
    # cycle writes exactly one more record
    htt.init(device="cpu")
    ledger.append_record(bench={"value": 2.0})
    htt.shutdown()
    rows = ledger.read_ledger(p)
    assert len(rows) == 2 and rows[-1]["bench"] == {"value": 2.0}


# ---------------------------------------------------------------------------
# the regression sentinel, each verdict held against JAX's
# ---------------------------------------------------------------------------

def _bench_dir(tmp_path, values):
    for i, v in enumerate(values, start=1):
        (tmp_path / f"BENCH_r{i:02d}.json").write_text(json.dumps(
            {"parsed": {"metric": "m", "value": v}}))
    return str(tmp_path)


def _same(d, path=None, tolerance=None):
    got = ledger.regression_report(d, path=path, tolerance=tolerance)
    want = jledger.regression_report(d, path=path, tolerance=tolerance)
    assert got == want
    return got


def _check(report, name):
    return [c for c in report["checks"] if c["check"] == name][0]


def test_regression_report_pass(tmp_path):
    d = _bench_dir(tmp_path, [100.0, 110.0, 108.0])
    r = _same(d, path=str(tmp_path / "none.jsonl"))
    assert r["verdict"] == "pass"
    assert _check(r, "bench_throughput")["best_prior"] == 110.0


def test_malformed_bench_round_is_skipped(tmp_path):
    d = _bench_dir(tmp_path, [100.0, 101.0])
    (tmp_path / "BENCH_r03.json").write_text(json.dumps(
        {"parsed": {"metric": "m", "value": "n/a"}}))
    r = _same(d, path=str(tmp_path / "none.jsonl"))
    assert r["bench_rounds"] == [1, 2] and r["verdict"] == "pass"


def test_regression_report_regress(tmp_path):
    d = _bench_dir(tmp_path, [100.0, 110.0, 80.0])
    assert _same(d, path=str(tmp_path / "none.jsonl"))["verdict"] == \
        "regress"


def test_regression_report_numerics_gate(tmp_path):
    d = _bench_dir(tmp_path, [100.0, 101.0])
    p = tmp_path / "ledger.jsonl"
    p.write_text(json.dumps(
        {"schema": 1, "goodput": {"goodput_fraction": 0.5},
         "numerics": {"anomalies": 2, "by_kind": {"nonfinite": 2}}}) + "\n")
    r = _same(d, path=str(p))
    assert r["verdict"] == "regress"
    gate = _check(r, "numerics_clean")
    assert gate["status"] == "regress" and gate["anomalies"] == 2


def test_regression_report_goodput_history(tmp_path):
    d = _bench_dir(tmp_path, [100.0, 101.0])
    p = tmp_path / "ledger.jsonl"
    rows = [{"schema": 1, "goodput": {"goodput_fraction": f},
             "numerics": {"anomalies": 0}} for f in (0.5, 0.52, 0.2)]
    p.write_text("".join(json.dumps(r) + "\n" for r in rows))
    r = _same(d, path=str(p))
    assert _check(r, "goodput_fraction")["status"] == "regress"
    rows[-1]["goodput"]["goodput_fraction"] = 0.5
    p.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert _check(_same(d, path=str(p)), "goodput_fraction")["status"] == \
        "pass"


def _serve_setup(tmp_path, cur, priors, fleet=None):
    art = {"continuous": {"tokens_per_s": cur[0],
                          "ttft_ms": {"p50": 1.0, "p99": cur[1]},
                          "tpot_ms": {"p50": 1.0, "p99": cur[2]}}}
    rows = [{"schema": 1, "goodput": {"goodput_fraction": 0.5},
             "numerics": {"anomalies": 0},
             "bench": {"metric": "serve_continuous_vs_static",
                       "continuous_tokens_per_s": t,
                       "ttft_ms": {"p99": f}, "tpot_ms": {"p99": o}}}
            for t, f, o in priors]
    if fleet is not None:
        (fcur, grow), fpriors = fleet
        art["fleet"] = {"scaling": [
            {"replicas": 1, "tokens_per_s": fcur / 2},
            {"replicas": 2, "tokens_per_s": fcur}],
            "autoscale": {"ttft_after_grow_ms": grow}}
        rows += [{"schema": 1, "goodput": {"goodput_fraction": 0.5},
                  "numerics": {"anomalies": 0},
                  "bench": {"metric": "serve_fleet",
                            "fleet_tokens_per_s": t,
                            "ttft_after_grow_ms": g}}
                 for t, g in fpriors]
    (tmp_path / "BENCH_SERVE.json").write_text(json.dumps(art))
    p = tmp_path / "ledger.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(tmp_path), str(p)


@pytest.mark.parametrize("cur,priors,verdicts", [
    ((980.0, 156.0, 20.9), [(1000.0, 150.0, 20.0), (980.0, 156.0, 20.9)],
     ("pass", "pass", "pass")),
    ((900.0, 150.0, 20.0), [(1000.0, 150.0, 20.0), (900.0, 150.0, 20.0)],
     ("regress", "pass", "pass")),
    ((1100.0, 150.0, 30.0), [(1000.0, 150.0, 20.0), (1100.0, 150.0, 30.0)],
     ("pass", "pass", "regress")),
    ((980.0, 160.0, 22.0), [(980.0, 160.0, 22.0)],
     ("skipped", "skipped", "skipped")),
])
def test_serve_axis_matches_jax(tmp_path, cur, priors, verdicts):
    d, p = _serve_setup(tmp_path, cur, priors)
    r = _same(d, path=p, tolerance=0.05)
    assert tuple(_check(r, n)["status"] for n in (
        "serve_tokens_per_s", "serve_ttft_p99", "serve_tpot_p99")) == \
        verdicts


@pytest.mark.parametrize("fleet,verdicts", [
    (((1900.0, 42.0), [(2000.0, 40.0), (1900.0, 42.0)]), ("pass", "pass")),
    (((1500.0, 40.0), [(2000.0, 40.0), (1500.0, 40.0)]),
     ("regress", "pass")),
    (((2100.0, 90.0), [(2000.0, 40.0), (2100.0, 90.0)]),
     ("pass", "regress")),
])
def test_fleet_axis_matches_jax(tmp_path, fleet, verdicts):
    d, p = _serve_setup(tmp_path, (1000.0, 150.0, 20.0),
                        [(1000.0, 150.0, 20.0)], fleet=fleet)
    r = _same(d, path=p, tolerance=0.05)
    assert (_check(r, "fleet_tokens_per_s")["status"],
            _check(r, "fleet_ttft_after_grow")["status"]) == verdicts


def test_cost_and_compat_axes_match_jax(tmp_path):
    d = _bench_dir(tmp_path, [100.0, 101.0])
    r = _same(d, path=str(tmp_path / "none.jsonl"))
    assert {_check(r, n)["status"] for n in (
        "cost_peak_memory_ceiling", "cost_roofline_drift",
        "compat_certified", "compat_expected_findings")} == {"skipped"}
    (tmp_path / "COST.json").write_text(json.dumps({"workloads": {
        "a": {"accounting": {"peak_bytes": 5, "budget_bytes": 4},
              "findings": [{"code": "HVD705"}], "expected_findings": []}}}))
    (tmp_path / "COMPAT.json").write_text(json.dumps({"workloads": {
        "train-serve-handoff": {"verdict": "compatible",
                                "rules": {"r1": "evaluated"},
                                "findings": [], "expected_findings": []}},
        "gate_failures": []}))
    r = _same(d, path=str(tmp_path / "none.jsonl"))
    assert _check(r, "cost_peak_memory_ceiling")["status"] == "regress"
    assert _check(r, "cost_roofline_drift")["status"] == "regress"
    assert _check(r, "compat_certified")["status"] == "pass"
    assert r["verdict"] == "regress"


def test_tolerance_knob_is_the_references(tmp_path):
    assert knobs.get("HOROVOD_GOODPUT_REGRESSION_TOLERANCE") == \
        jknobs.get("HOROVOD_GOODPUT_REGRESSION_TOLERANCE") == 0.05
    d = _bench_dir(tmp_path, [100.0, 94.0])
    assert _same(d, path=str(tmp_path / "n.jsonl"))["verdict"] == "regress"
    assert _same(d, path=str(tmp_path / "n.jsonl"),
                 tolerance=0.1)["verdict"] == "pass"
