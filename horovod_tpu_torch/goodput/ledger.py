"""The run ledger and the cross-run regression sentinel.

The counterpart of ``horovod_tpu/goodput/ledger.py``.

**Ledger**: an append-only JSONL file (``HOROVOD_GOODPUT_LEDGER``; one
JSON object per line, schema below) written once per run at
``shutdown()``, or by an explicit :func:`append_record`. Append-only on
purpose: the file IS the cross-run history the sentinel reads, and a
crashed run's partial line is skipped by the reader, never repaired in
place.

Record schema (``"schema": 1``, the JAX package's keys)::

    {
      "schema": 1, "time": <unix>, "run_id": <trace id or random hex>,
      "pid": ..., "world_size": <ranks>, "chip": <card name>|"cpu",
      "goodput":  <accountant.goodput_report()>,
      "numerics": {"anomalies": N, "by_kind": {...}, "last": {...}}|null,
      "knob_fingerprint": "<sha256[:16] of the resolved knob snapshot>",
      "collective_fingerprints": {},
      "wire": {"tier", "logical_bytes", "wire_bytes", "n_buckets",
               "error_feedback", "schedule", "dcn_wire_bytes"}|null,
      "artifact_store": {"hits", "misses", "publishes", "evictions",
                         "compile_seconds_saved"}|null,
      "serve": {"engine": {...}, "scheduler": {...}}|null,
      "bench": {<a benchmark's JSON line>}|null
    }

``collective_fingerprints`` stays empty (the JAX package fills it from
its IR verifier's collective-order registry, which the port does not
have); ``artifact_store`` is null when ``HOROVOD_ARTIFACT_STORE`` is
unset. The fingerprint hashes the port's own knobs.

**Regression sentinel** (:func:`regression_report`): compares the newest
run against the histories in the directory it is given: the
``BENCH_r0*.json`` trajectory (throughput), this ledger (goodput
fraction, numerics anomalies), the serving and fleet axes
(``BENCH_SERVE.json`` against prior serve-bench ledger records), and the
committed ``COST.json`` and ``COMPAT.json`` verdicts. A drop beyond
``HOROVOD_GOODPUT_REGRESSION_TOLERANCE`` against the best prior value is
a regression (throughput and goodput get floors, the serve p99 tails get
ceilings); the verdict is ``pass`` or ``regress``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from typing import Any, Dict, List, Optional

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.goodput.ledger")

SCHEMA_VERSION = 1

# One record per run: an explicit append (a benchmark after its
# measurement) marks the run recorded, and the shutdown() hook then
# skips: the explicit record is the richer one (it carries the bench
# block).
_recorded_this_run = False


def _mark_run_start() -> None:
    """init() hook: re-arm the once-per-run shutdown record."""
    global _recorded_this_run
    _recorded_this_run = False


def ledger_path() -> str:
    """The configured ledger path ('' = disabled)."""
    return str(knobs.get("HOROVOD_GOODPUT_LEDGER") or "")


def knob_fingerprint() -> str:
    """sha256[:16] over the RESOLVED knob snapshot — two runs with the
    same fingerprint ran under the same configuration, so a regression
    between them is code or environment, not knobs."""
    snap = knobs.snapshot()
    raw = json.dumps(snap, sort_keys=True, default=str)
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def _artifact_store_summary() -> Optional[Dict[str, Any]]:
    """The compiled-artifact store's tallies of this run, or None when
    HOROVOD_ARTIFACT_STORE is unset."""
    from horovod_tpu_torch.store import artifact_store as _artifact_store
    st = _artifact_store.store_stats()
    if st is None:
        return None
    return {k: st[k] for k in ("hits", "misses", "publishes", "evictions",
                               "compile_seconds_saved")}


def _collective_fingerprints() -> Dict[str, str]:
    """The JAX package's HVD503 collective-order fingerprints come from
    its IR verifier, which the port does not have: none."""
    return {}


def _chip_kind() -> str:
    """The card's name (``torch.cuda.get_device_name``) when the runtime
    (or, before init, the process) uses one, else "cpu"."""
    import torch
    from horovod_tpu_torch.runtime import context
    try:
        if context.is_initialized():
            dev = context.get_context().device
            if dev.type == "cuda":
                return torch.cuda.get_device_name(dev)
            return "cpu"
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.cuda.get_device_name()
    except Exception:
        return "unknown"
    return "cpu"


def _world_size() -> int:
    from horovod_tpu_torch.runtime import context
    return context.size() if context.is_initialized() else 1


def _serve_summary() -> Optional[Dict[str, Any]]:
    """Serving summary of this run (engine slot and page geometry, builds,
    scheduler tallies), or None when no serve engine was built in this
    process."""
    try:
        from horovod_tpu_torch import serving as _serving
        return _serving.serving_stats()
    except Exception:
        return None


def _wire_summary() -> Optional[Dict[str, Any]]:
    """Gradient wire accounting of this run (tier and per-step logical and
    wire bytes of the last bucketed sync), or None when no bucketed sync
    ran."""
    try:
        from horovod_tpu_torch.parallel.distributed import last_wire_trace
        wt = last_wire_trace()
        return wt if wt.get("logical_bytes") else None
    except Exception:
        return None


def build_record(bench: Optional[Dict[str, Any]] = None,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One ledger line for the current process state."""
    from horovod_tpu_torch.goodput import accountant
    from horovod_tpu_torch.goodput import numerics as _numerics
    from horovod_tpu_torch.tracing import spans as trace
    run_id = trace.trace_id() or os.urandom(8).hex()
    record: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "time": time.time(),
        "run_id": run_id,
        "pid": os.getpid(),
        "world_size": _world_size(),
        "chip": _chip_kind(),
        "goodput": accountant.goodput_report(),
        "numerics": _numerics.monitor_summary(),
        "knob_fingerprint": knob_fingerprint(),
        "collective_fingerprints": _collective_fingerprints(),
        "wire": _wire_summary(),
        "artifact_store": _artifact_store_summary(),
        "serve": _serve_summary(),
        "bench": bench,
    }
    if extra:
        record.update(extra)
    return record


def append_record(path: Optional[str] = None,
                  bench: Optional[Dict[str, Any]] = None,
                  extra: Optional[Dict[str, Any]] = None
                  ) -> Optional[Dict[str, Any]]:
    """Append one record (creating parent dirs); returns the record, or
    None when no path is configured. Never raises — the ledger is
    telemetry, not a commit protocol."""
    global _recorded_this_run
    p = path or ledger_path()
    if not p:
        return None
    record = build_record(bench=bench, extra=extra)
    try:
        d = os.path.dirname(os.path.abspath(p))
        os.makedirs(d, exist_ok=True)
        with open(p, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()
    except OSError:
        logger.warning("run-ledger append to %s failed", p, exc_info=True)
        return None
    _recorded_this_run = True
    return record


def write_on_shutdown() -> Optional[Dict[str, Any]]:
    """shutdown() hook: one record per run when a ledger is configured
    (skipped when an explicit append already recorded this run, which is
    the richer record)."""
    if _recorded_this_run:
        return None
    return append_record()


def read_ledger(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every parseable record, oldest first (torn tail lines from a
    crashed run are skipped)."""
    p = path or ledger_path()
    out: List[Dict[str, Any]] = []
    if not p or not os.path.exists(p):
        return out
    with open(p, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


# ---------------------------------------------------------------------------
# the regression sentinel
# ---------------------------------------------------------------------------

def _bench_trajectory(repo_dir: str) -> List[Dict[str, Any]]:
    """The BENCH_r0*.json trajectory in ``repo_dir``, round order. Each
    file is either a benchmark's raw JSON line or a wrapper holding it
    under ``parsed``."""
    rows: List[Dict[str, Any]] = []
    try:
        names = os.listdir(repo_dir)
    except OSError:
        return rows
    found = [(int(m.group(1)), name)
             for name in names
             for m in [re.match(r"BENCH_r(\d+)\.json$", name)] if m]
    for n, name in sorted(found):
        try:
            with open(os.path.join(repo_dir, name), encoding="utf-8") as f:
                b = json.load(f)
            parsed = b.get("parsed", b)
            if isinstance(parsed, dict) and "value" in parsed:
                rows.append({"round": n, "file": name,
                             "value": float(parsed["value"]),
                             "metric": parsed.get("metric", "")})
        except (OSError, ValueError, TypeError):
            # one malformed round (e.g. "value": "n/a" from a failed
            # measure) must not crash the sentinel's verdict contract
            continue
    return rows


def _check(name: str, ok: bool, detail: Dict[str, Any]) -> Dict[str, Any]:
    return dict({"check": name, "status": "pass" if ok else "regress"},
                **detail)


def _serve_current(repo_dir: str) -> Optional[Dict[str, float]]:
    """The committed BENCH_SERVE.json serving point: continuous-batching
    tokens/s plus the p99 tail latencies the serve SLO lives on."""
    try:
        with open(os.path.join(repo_dir, "BENCH_SERVE.json"),
                  encoding="utf-8") as f:
            b = json.load(f)
        cont = b["continuous"]
        return {"tokens_per_s": float(cont["tokens_per_s"]),
                "ttft_p99_ms": float(cont["ttft_ms"]["p99"]),
                "tpot_p99_ms": float(cont["tpot_ms"]["p99"])}
    except (OSError, ValueError, TypeError, KeyError):
        return None


def _serve_priors(records: List[Dict[str, Any]]) -> List[Dict[str, float]]:
    """Serve-bench points from the ledger history: the records
    a serving benchmark appends (bench.metric == serve_continuous_vs_
    static) carry the same three numbers the committed artifact does."""
    out: List[Dict[str, float]] = []
    for rec in records:
        bench = rec.get("bench") or {}
        if bench.get("metric") != "serve_continuous_vs_static":
            continue
        try:
            out.append({
                "tokens_per_s": float(bench["continuous_tokens_per_s"]),
                "ttft_p99_ms": float(bench["ttft_ms"]["p99"]),
                "tpot_p99_ms": float(bench["tpot_ms"]["p99"])})
        except (ValueError, TypeError, KeyError):
            continue
    return out


def _serve_checks(repo_dir: str, records: List[Dict[str, Any]],
                  tol: float) -> List[Dict[str, Any]]:
    """The serving axis of the sentinel: committed BENCH_SERVE.json vs
    the best prior serve-bench ledger record. Throughput gets a floor,
    the p99 tails get ceilings — a serve change that trades tokens/s
    for tail latency (or the reverse) beyond tolerance is a regression
    either way."""
    cur = _serve_current(repo_dir)
    # the newest serve-bench record is the run that produced the
    # committed artifact — it is the measurement under judgement, not
    # history, so the prior set is the serve series without it
    priors = _serve_priors(records)[:-1]
    if cur is None or not priors:
        reason = ("no committed BENCH_SERVE.json" if cur is None
                  else "fewer than 2 serve-bench ledger records")
        return [{"check": c, "status": "skipped", "reason": reason}
                for c in ("serve_tokens_per_s", "serve_ttft_p99",
                          "serve_tpot_p99")]
    checks: List[Dict[str, Any]] = []
    best_tps = max(p["tokens_per_s"] for p in priors)
    floor = (1.0 - tol) * best_tps
    checks.append(_check(
        "serve_tokens_per_s", cur["tokens_per_s"] >= floor,
        {"current": cur["tokens_per_s"], "best_prior": best_tps,
         "floor": round(floor, 3), "tolerance": tol,
         "priors": len(priors)}))
    for key, name in (("ttft_p99_ms", "serve_ttft_p99"),
                      ("tpot_p99_ms", "serve_tpot_p99")):
        best = min(p[key] for p in priors)
        ceiling = (1.0 + tol) * best
        checks.append(_check(
            name, cur[key] <= ceiling,
            {"current": cur[key], "best_prior": best,
             "ceiling": round(ceiling, 3), "tolerance": tol,
             "priors": len(priors)}))
    return checks


def _fleet_current(repo_dir: str) -> Optional[Dict[str, float]]:
    """The committed BENCH_SERVE.json fleet point: tokens/s at the
    largest measured replica count plus the TTFT observed right after an
    autoscale grow (the scale-up responsiveness number)."""
    try:
        with open(os.path.join(repo_dir, "BENCH_SERVE.json"),
                  encoding="utf-8") as f:
            b = json.load(f)
        fl = b["fleet"]
        top = max(fl["scaling"], key=lambda r: int(r["replicas"]))
        return {"tokens_per_s": float(top["tokens_per_s"]),
                "ttft_after_grow_ms":
                    float(fl["autoscale"]["ttft_after_grow_ms"])}
    except (OSError, ValueError, TypeError, KeyError):
        return None


def _fleet_priors(records: List[Dict[str, Any]]) -> List[Dict[str, float]]:
    """Fleet-bench points from the ledger history: the records
    a fleet benchmark appends (bench.metric == serve_fleet)
    carry the same two numbers the committed fleet block does."""
    out: List[Dict[str, float]] = []
    for rec in records:
        bench = rec.get("bench") or {}
        if bench.get("metric") != "serve_fleet":
            continue
        try:
            out.append({
                "tokens_per_s": float(bench["fleet_tokens_per_s"]),
                "ttft_after_grow_ms": float(bench["ttft_after_grow_ms"])})
        except (ValueError, TypeError, KeyError):
            continue
    return out


def _fleet_checks(repo_dir: str, records: List[Dict[str, Any]],
                  tol: float) -> List[Dict[str, Any]]:
    """The fleet axis of the sentinel: committed fleet block vs the best
    prior fleet-bench ledger record. Peak-replica tokens/s gets a floor
    and TTFT-after-grow gets a ceiling — a router or autoscaler change
    that costs either aggregate throughput or scale-up responsiveness
    beyond tolerance is a regression."""
    cur = _fleet_current(repo_dir)
    # as with the serve axis, the newest fleet record produced the
    # committed artifact — judge it against the series without it
    priors = _fleet_priors(records)[:-1]
    if cur is None or not priors:
        reason = ("no fleet block in BENCH_SERVE.json" if cur is None
                  else "fewer than 2 fleet-bench ledger records")
        return [{"check": c, "status": "skipped", "reason": reason}
                for c in ("fleet_tokens_per_s", "fleet_ttft_after_grow")]
    checks: List[Dict[str, Any]] = []
    best_tps = max(p["tokens_per_s"] for p in priors)
    floor = (1.0 - tol) * best_tps
    checks.append(_check(
        "fleet_tokens_per_s", cur["tokens_per_s"] >= floor,
        {"current": cur["tokens_per_s"], "best_prior": best_tps,
         "floor": round(floor, 3), "tolerance": tol,
         "priors": len(priors)}))
    best_grow = min(p["ttft_after_grow_ms"] for p in priors)
    ceiling = (1.0 + tol) * best_grow
    checks.append(_check(
        "fleet_ttft_after_grow", cur["ttft_after_grow_ms"] <= ceiling,
        {"current": cur["ttft_after_grow_ms"], "best_prior": best_grow,
         "ceiling": round(ceiling, 3), "tolerance": tol,
         "priors": len(priors)}))
    return checks


def _cost_checks(repo_dir: str) -> List[Dict[str, Any]]:
    """The static-resource axis of the sentinel: the committed COST.json
    projections (HVD7xx). Two gates:

    - ``cost_peak_memory_ceiling``: every flagship workload the chips
      actually run (everything except the deliberately-OOM 2B config)
      must keep its projected peak per-device memory under its HBM
      budget — a model/optimizer change that silently pushes a
      fits-today config over the ceiling regresses here before any
      chip OOMs;
    - ``cost_roofline_drift``: each workload's findings must equal its
      committed expected set — in particular an HVD705 appearing on the
      measured ResNet workload means the roofline projection and the
      committed step time have drifted apart (rates stale or a real
      perf change that needs a remeasure)."""
    try:
        with open(os.path.join(repo_dir, "COST.json"),
                  encoding="utf-8") as f:
            cost = json.load(f)
        workloads = cost["workloads"]
    except (OSError, ValueError, KeyError):
        return [{"check": c, "status": "skipped",
                 "reason": "no committed COST.json"}
                for c in ("cost_peak_memory_ceiling",
                          "cost_roofline_drift")]
    checks: List[Dict[str, Any]] = []
    over = {}
    for name, w in workloads.items():
        acc = w.get("accounting") or {}
        expected = set(w.get("expected_findings") or ())
        if "HVD702" in expected:        # the OOM verdict is the point
            continue
        peak, budget = acc.get("peak_bytes"), acc.get("budget_bytes")
        if peak is not None and budget and peak > budget:
            over[name] = {"peak_bytes": peak, "budget_bytes": budget}
    checks.append(_check(
        "cost_peak_memory_ceiling", not over,
        {"over_budget": over, "workloads": len(workloads)}))
    drifted = {}
    for name, w in workloads.items():
        got = sorted({f["code"] for f in (w.get("findings") or ())})
        expected = sorted(w.get("expected_findings") or ())
        if got != expected:
            drifted[name] = {"findings": got, "expected": expected}
    resnet = workloads.get("resnet50-dp") or {}
    checks.append(_check(
        "cost_roofline_drift", not drifted,
        {"drifted": drifted,
         "resnet_model_vs_measured": (resnet.get("measured")
                                      or {}).get("ratio")}))
    return checks


def _compat_checks(repo_dir: str) -> List[Dict[str, Any]]:
    """The handoff-certification axis of the sentinel: the committed
    COMPAT.json verdicts (HVD8xx). Two gates:

    - ``compat_certified``: the flagship train->serve handoff workload
      must hold its ``compatible`` verdict with ALL FIVE rules
      evaluated and no gate failures — a checkpoint-format, store, or
      model change that breaks the swap-is-one-device_put invariant
      regresses here before any serving fleet loads it;
    - ``compat_expected_findings``: every seeded-defect workload's
      findings must equal its committed expected set — a defect the
      tier stops catching (or a clean workload it starts flagging) is a
      certifier regression, same contract as ``cost_roofline_drift``."""
    try:
        with open(os.path.join(repo_dir, "COMPAT.json"),
                  encoding="utf-8") as f:
            compat = json.load(f)
        workloads = compat["workloads"]
        handoff = workloads["train-serve-handoff"]
    except (OSError, ValueError, KeyError):
        return [{"check": c, "status": "skipped",
                 "reason": "no committed COMPAT.json"}
                for c in ("compat_certified",
                          "compat_expected_findings")]
    checks: List[Dict[str, Any]] = []
    rules = handoff.get("rules") or {}
    skipped_rules = sorted(k for k, v in rules.items()
                           if v != "evaluated")
    gate_failures = list(compat.get("gate_failures") or ())
    checks.append(_check(
        "compat_certified",
        handoff.get("verdict") == "compatible" and not skipped_rules
        and not gate_failures,
        {"verdict": handoff.get("verdict"),
         "skipped_rules": skipped_rules,
         "gate_failures": gate_failures,
         "fingerprint": handoff.get("fingerprint")}))
    drifted = {}
    for name, w in workloads.items():
        got = sorted({f["code"] for f in (w.get("findings") or ())})
        expected = sorted(w.get("expected_findings") or ())
        if got != expected:
            drifted[name] = {"findings": got, "expected": expected}
    checks.append(_check(
        "compat_expected_findings", not drifted,
        {"drifted": drifted, "workloads": len(workloads)}))
    return checks


def regression_report(repo_dir: str,
                      path: Optional[str] = None,
                      tolerance: Optional[float] = None) -> Dict[str, Any]:
    """The pass/regress verdict over (a) the BENCH trajectory and (b)
    the ledger history. With fewer than two points on an axis, that axis
    reports ``skipped`` — a fresh repo or a fresh ledger cannot regress
    against itself."""
    tol = float(tolerance if tolerance is not None
                else knobs.get("HOROVOD_GOODPUT_REGRESSION_TOLERANCE"))
    checks: List[Dict[str, Any]] = []

    # (a) throughput vs the committed trajectory: newest round vs the
    # best earlier round, tolerance-scaled.
    bench = _bench_trajectory(repo_dir)
    if len(bench) >= 2:
        cur = bench[-1]
        best_prior = max(bench[:-1], key=lambda r: r["value"])
        floor = (1.0 - tol) * best_prior["value"]
        checks.append(_check(
            "bench_throughput", cur["value"] >= floor,
            {"current": cur["value"], "current_round": cur["round"],
             "best_prior": best_prior["value"],
             "best_prior_round": best_prior["round"],
             "floor": round(floor, 3), "tolerance": tol}))
    else:
        checks.append({"check": "bench_throughput", "status": "skipped",
                       "reason": f"{len(bench)} BENCH round(s) found; "
                                 f"need 2"})

    # (b) ledger history: goodput fraction + numerics cleanliness of the
    # newest record.
    records = read_ledger(path)
    if records:
        cur = records[-1]
        gp = (cur.get("goodput") or {}).get("goodput_fraction")
        prior = [
            (r.get("goodput") or {}).get("goodput_fraction")
            for r in records[:-1]]
        prior = [p for p in prior if isinstance(p, (int, float))]
        if isinstance(gp, (int, float)) and prior:
            best = max(prior)
            floor = max(best - tol, 0.0)
            checks.append(_check(
                "goodput_fraction", gp >= floor,
                {"current": gp, "best_prior": best,
                 "floor": round(floor, 6), "tolerance": tol,
                 "records": len(records)}))
        else:
            checks.append({"check": "goodput_fraction",
                           "status": "skipped",
                           "reason": "fewer than 2 ledger records with "
                                     "a goodput fraction"})
        numerics = cur.get("numerics") or {}
        anomalies = int(numerics.get("anomalies") or 0)
        checks.append(_check(
            "numerics_clean", anomalies == 0,
            {"anomalies": anomalies,
             "by_kind": numerics.get("by_kind") or {}}))
    else:
        checks.append({"check": "goodput_fraction", "status": "skipped",
                       "reason": "no ledger records"})
        checks.append({"check": "numerics_clean", "status": "skipped",
                       "reason": "no ledger records"})

    # (c) the serving axis: committed BENCH_SERVE.json vs prior
    # serve-bench ledger records (tokens/s floor, p99 tail ceilings).
    checks.extend(_serve_checks(repo_dir, records, tol))

    # (d) the fleet axis: peak-replica tokens/s floor plus the
    # TTFT-after-grow ceiling from the autoscale drill.
    checks.extend(_fleet_checks(repo_dir, records, tol))

    # (e) the static-resource axis: committed COST.json projections
    # (peak-memory ceilings, roofline-vs-measured drift).
    checks.extend(_cost_checks(repo_dir))

    # (f) the handoff-certification axis: committed COMPAT.json
    # verdicts (flagship handoff certified, seeded defects still
    # caught).
    checks.extend(_compat_checks(repo_dir))

    regressed = [c for c in checks if c["status"] == "regress"]
    return {
        "metric": "regression_verdict",
        "verdict": "regress" if regressed else "pass",
        "tolerance": tol,
        "checks": checks,
        "bench_rounds": [r["round"] for r in bench],
        "ledger_records": len(records),
        "ledger_path": path or ledger_path() or None,
    }
