"""hvdlint-torch (horovod_tpu_torch.analysis) against the JAX package's
hvdlint, on the CPU: the AST tiers HVD1xx-HVD4xx.

Mirrors ``tests/test_analysis.py``: every fixture of ``tests/data/lint/``
gives the port's rules the JAX rules' findings (code, line, column,
severity; the same golden lists), the torch fixtures of
``tests/lint_torch/`` (one good/bad pair per family) fire their
rules in torch idiom, the engine's suppressions and baseline behave
alike, the CLI keeps the JAX exit codes and refuses the tiers not ported
yet, and the port's own tree lints clean against the empty
``.hvdlint-torch-baseline.json``. The model-checking tier HVD6xx is
``tests/test_torch_modellint.py``.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

from horovod_tpu import analysis as janalysis
from horovod_tpu_torch.analysis import (
    Options, all_rules, analyze, collect_files, load_baseline, run_rules,
    split_new, write_baseline,
)

HERE = os.path.dirname(__file__)
REPO = os.path.abspath(os.path.join(HERE, ".."))
LINT = os.path.join(HERE, "data", "lint")
LINT_TORCH = os.path.join(HERE, "lint_torch")

# Fixture runs must not resolve the real docs/knobs.md: the fixtures
# register no knobs, so every real docs row would read as stale.
NO_DOCS = Options(knobs_doc=os.path.join(LINT, "no-such-knobs.md"))
LIMIT_S = 170


@pytest.fixture(scope="module", autouse=True)
def _limit():
    def expired(*_):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")
    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def lint(*names, root=LINT, options=NO_DOCS):
    files = collect_files([os.path.join(root, n) for n in names],
                          excludes=())
    return run_rules(files, all_rules(), options)


def tlint(*names):
    return lint(*names, root=LINT_TORCH)


def lint_text(tmp_path, text, name="mod.py"):
    p = tmp_path / name
    p.write_text(text)
    return run_rules(collect_files([str(p)], excludes=()), all_rules(),
                     NO_DOCS)


def codes(findings):
    return sorted(f.code for f in findings)


def by_code(findings, code):
    return [f for f in findings if f.code == code]


def _key(findings):
    return [(f.code, f.line, f.col, f.severity) for f in findings]


# ---------------------------------------------------------------------------
# the JAX fixtures: the port's rules find what the JAX rules find
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(LINT) if n.endswith(".py")))
def test_jax_fixture_findings_equal_the_jax_analyzer(name):
    path = os.path.join(LINT, name)
    want = janalysis.run_rules(
        janalysis.collect_files([path], excludes=()),
        janalysis.all_rules(),
        janalysis.Options(knobs_doc=NO_DOCS.knobs_doc))
    assert _key(lint(name)) == _key(want)
    assert _key(analyze([path])) == _key(janalysis.analyze([path]))


def test_rule_catalog_matches_the_jax_ast_tiers():
    assert [(r.code, r.severity) for r in all_rules()] == \
        [(r.code, r.severity) for r in janalysis.all_rules()]


# ---------------------------------------------------------------------------
# HVD1xx SPMD consistency
# ---------------------------------------------------------------------------

class TestSpmdRules:
    def test_jax_bad_fixture_golden(self):
        fs = lint("spmd_bad.py")
        assert codes(fs) == ["HVD101", "HVD101", "HVD102", "HVD102",
                             "HVD103", "HVD103"]
        assert {f.symbol for f in by_code(fs, "HVD101")} == {
            "rank_gated_allreduce", "leader_only_barrier"}
        assert {f.symbol for f in by_code(fs, "HVD102")} == {
            "gated_lax_psum", "early_exit_before_collective"}
        assert {f.symbol for f in by_code(fs, "HVD103")} == {
            "set_iteration_order", "set_call_iteration"}

    def test_torch_bad_fixture_golden(self):
        fs = tlint("spmd_bad.py")
        assert codes(fs) == ["HVD101", "HVD101", "HVD102", "HVD102",
                             "HVD103", "HVD105", "HVD106"]
        gated = by_code(fs, "HVD101")
        assert {f.symbol for f in gated} == {"rank_gated_all_reduce",
                                             "leader_only_barrier"}
        assert any("'dist.all_reduce'" in f.message for f in gated)
        assert any("'torch.distributed.barrier'" in f.message
                   for f in gated)
        assert {f.symbol for f in by_code(fs, "HVD102")} == {
            "store_wait_before_exit", "odd_ranks_skip_send"}
        (loop,) = by_code(fs, "HVD103")
        assert "'all_reduce'" in loop.message        # imported by name
        assert by_code(fs, "HVD105")[0].symbol == "collective_in_handler"
        assert by_code(fs, "HVD106")[0].symbol == "swallow_mismatch"
        assert all(f.severity == "error" for f in fs)

    def test_torch_good_fixture_clean(self):
        assert tlint("spmd_good.py") == []

    def test_jax_good_fixtures_clean(self):
        assert lint("spmd_good.py", "spmd_except_good.py",
                    "compat_swallow_good.py") == []

    @pytest.mark.parametrize("binding, call", [
        ("import torch.distributed as dist", "dist.all_gather(out, t)"),
        ("import torch.distributed",
         "torch.distributed.reduce_scatter(o, t)"),
        ("from torch import distributed as td",
         "td.all_to_all_single(o, t)"),
        ("from torch.distributed import recv", "recv(t, 0)"),
        ("import torch.distributed as dist", "dist.new_group([0, 1])"),
        ("import horovod_tpu_torch as htt", "htt.allreduce_async(t)"),
        ("from horovod_tpu_torch.ops import collectives as C",
         "C.allreduce_(t)"),
        ("import torch", "self._store.wait(['k'], 5)"),
    ])
    def test_torch_collectives_under_a_rank_gate(self, tmp_path, binding,
                                                 call):
        fs = lint_text(tmp_path, f"{binding}\n"
                                 f"def f(self, t, o, out):\n"
                                 f"    if torch.distributed.get_rank():\n"
                                 f"        {call}\n")
        assert codes(fs) == ["HVD101"], fs

    @pytest.mark.parametrize("call", [
        "torch.broadcast_to(t, (2, 2))", "torch.cuda.comm.broadcast(t, d)",
        "np.broadcast(t, t)", "socket.send(b'x')", "t.all_reduce()",
        "queue.wait()", "recv(t, 0)", "dist.wait(t)",
    ])
    def test_tensor_functions_are_not_collectives(self, tmp_path, call):
        """torch's own tensor functions, a ``send`` or ``recv`` not bound
        to torch.distributed, and ``wait`` on something that is not a
        store stay quiet under a rank gate."""
        fs = lint_text(tmp_path, "import numpy as np\n"
                                 "import torch\n"
                                 "import torch.distributed as dist\n"
                                 "def f(t, d, socket, queue, recv):\n"
                                 "    if dist.get_rank() == 0:\n"
                                 f"        {call}\n")
        assert fs == []

    def test_hvd105_no_double_report_for_handler_after_swallow(
            self, tmp_path):
        fs = lint_text(tmp_path,
                       "import torch.distributed as dist\n"
                       "def f(x):\n"
                       "    r = dist.get_rank()\n"
                       "    try:\n"
                       "        open(f'/s/{r}')\n"
                       "    except OSError:\n"
                       "        pass\n"
                       "    try:\n"
                       "        open('/cfg')\n"
                       "    except OSError:\n"
                       "        return dist.all_reduce(x)\n"
                       "    return x\n")
        assert codes(fs) == ["HVD105"]
        assert "'except' handler" in fs[0].message

    def test_compat_swallow_fixture_golden(self):
        fs = lint("compat_swallow_bad.py")
        assert codes(fs) == ["HVD106"] * 4
        assert all("compat_report" in f.message for f in fs)


# ---------------------------------------------------------------------------
# HVD2xx trace safety
# ---------------------------------------------------------------------------

class TestTraceRules:
    def test_jax_bad_fixture_golden(self):
        fs = lint("trace_bad.py")
        assert codes(fs) == ["HVD201", "HVD202", "HVD202", "HVD203",
                             "HVD203", "HVD204", "HVD205"]
        assert {f.symbol for f in by_code(fs, "HVD202")} == {
            "step_with_host_rng", "make_step.traced"}

    def test_torch_bad_fixture_golden(self):
        fs = tlint("trace_bad.py")
        assert codes(fs) == ["HVD201", "HVD202", "HVD202", "HVD203",
                             "HVD204", "HVD205", "HVD206", "HVD207"]
        assert by_code(fs, "HVD201")[0].symbol == "step_with_wallclock"
        assert {f.symbol for f in by_code(fs, "HVD202")} == {
            "step_with_host_rng", "make_step.traced"}
        assert by_code(fs, "HVD203")[0].symbol == "step_with_env"
        # the body of ``with torch.cuda.graph(g):`` runs once, at capture
        assert [f.symbol for f in by_code(fs, "HVD204") +
                by_code(fs, "HVD205")] == ["capture", "capture"]
        assert "<cuda graph capture>" in by_code(fs, "HVD204")[0].message
        assert by_code(fs, "HVD206")[0].symbol == "make_step.traced"
        assert "'requests_total'" in by_code(fs, "HVD207")[0].message

    def test_torch_good_fixture_clean(self):
        assert tlint("trace_good.py") == []

    def test_jax_span_fixtures(self):
        assert codes(lint("trace_span_bad.py")) == ["HVD206"] * 3
        assert lint("trace_good.py", "trace_span_good.py") == []

    def test_port_tree_traces_nothing(self):
        """The port compiles, scripts and captures no function, so no
        traced body exists in its tree for HVD201-206 to check."""
        from horovod_tpu_torch.analysis.rules_trace import \
            find_traced_functions
        files = collect_files([os.path.join(REPO, "horovod_tpu_torch")])
        assert len(files) > 100
        assert [f.rel for f in files if find_traced_functions(f.tree)] == []


class TestMetricsRegistryRule:
    def test_bad_fixture_golden(self):
        fs = lint("metrics_bad.py")
        assert codes(fs) == ["HVD207"] * 3
        assert any("prometheus_client" in f.message for f in fs)

    def test_good_fixture_clean(self):
        assert lint("metrics_good.py") == []

    def test_registry_module_exempt(self, tmp_path):
        pkg = tmp_path / "horovod_tpu_torch"
        pkg.mkdir()
        (pkg / "metrics.py").write_text(
            "def counter(name, help=''):\n"
            "    return counter('not_hvd_prefixed', help)\n")
        files = collect_files([str(pkg)], excludes=())
        assert run_rules(files, all_rules(), NO_DOCS) == []


# ---------------------------------------------------------------------------
# HVD3xx concurrency
# ---------------------------------------------------------------------------

class TestConcurrencyRules:
    def test_jax_bad_fixture_golden(self):
        fs = lint("concurrency_bad.py")
        assert codes(fs) == ["HVD301", "HVD302", "HVD302", "HVD303",
                             "HVD304", "HVD304"]
        assert codes(lint("kv_timeout_bad.py")) == ["HVD305"] * 5

    def test_torch_bad_fixture_golden(self):
        fs = tlint("concurrency_bad.py")
        assert codes(fs) == ["HVD302", "HVD304", "HVD305", "HVD305",
                             "HVD305"]
        store = by_code(fs, "HVD305")
        assert {f.symbol for f in store} == {
            "StoreBarrier.wait_all", "StoreBarrier.wait_long",
            "StoreBarrier.read"}
        assert sum("without a timeout" in f.message for f in store) == 1
        assert sum("600s literal timeout" in f.message for f in store) == 1
        assert sum("blocks until the key exists" in f.message
                   for f in store) == 1
        assert ".join" in by_code(fs, "HVD302")[0].message
        assert "destroy_process_group" in by_code(fs, "HVD304")[0].message

    def test_torch_good_fixture_clean(self):
        assert tlint("concurrency_good.py") == []

    def test_jax_good_fixtures_clean(self):
        assert lint("concurrency_good.py", "kv_timeout_good.py") == []

    def test_real_signal_handler_and_kv_consumers_are_clean(self):
        """The port's flag-only preemption handler passes HVD304, and its
        retry seam and every store consumer pass HVD305."""
        root = os.path.join(REPO, "horovod_tpu_torch")
        targets = [os.path.join(root, *p.split("/")) for p in (
            "resilience/preemption.py", "resilience/faults.py",
            "utils/kvstore.py", "resilience/async_checkpoint.py",
            "ops/divergence.py", "autotune.py", "metrics.py",
            "tracing/merge.py", "tracing/straggler.py",
            "elastic/resize.py", "elastic/driver.py")]
        fs = run_rules(collect_files(targets, excludes=()), all_rules(),
                       NO_DOCS)
        assert by_code(fs, "HVD304") == [] and by_code(fs, "HVD305") == []


# ---------------------------------------------------------------------------
# HVD4xx knob registry
# ---------------------------------------------------------------------------

class TestKnobRules:
    def test_bad_fixture_golden(self):
        fs = lint("knobs_bad.py")
        assert codes(fs) == ["HVD401"] * 3
        unreg = [f for f in fs if "TOTALLY_NEW_KNOB" in f.message]
        assert unreg and "not even registered" in unreg[0].message

    def test_torch_fixtures(self):
        fs = tlint("knobs_bad.py")
        assert codes(fs) == ["HVD401"] * 3
        assert any("HOROVOD_TORCH_ONLY_KNOB" in f.message and
                   "not even registered" in f.message for f in fs)
        assert tlint("knobs_good.py") == [] and lint("knobs_good.py") == []

    def test_docs_drift_dead_knobs_and_the_skip_list(self, tmp_path):
        """Synthetic registry + docs: missing row -> HVD402, stale row ->
        HVD403 unless UNREGISTERED_DOC_KNOBS lists it, unreferenced knob
        -> HVD404."""
        pkg = tmp_path / "horovod_tpu_torch"
        pkg.mkdir()
        (pkg / "config.py").write_text(textwrap.dedent("""\
            class KnobRegistry:
                def register(self, *a, **k):
                    pass
            knobs = KnobRegistry()
            knobs.register("HOROVOD_DOCUMENTED", 1, int)
            knobs.register("HOROVOD_UNDOCUMENTED", 2, int)
            knobs.register("HOROVOD_DEAD", 3, int)
            UNREGISTERED_DOC_KNOBS = {"HOROVOD_TPU_ONLY": "a TPU knob"}
        """))
        (pkg / "user.py").write_text(textwrap.dedent("""\
            from config import knobs
            A = knobs.get("HOROVOD_DOCUMENTED")
            B = knobs.get("HOROVOD_UNDOCUMENTED")
        """))
        docs = tmp_path / "knobs.md"
        docs.write_text(textwrap.dedent("""\
            | Knob | Default |
            |---|---|
            | `HOROVOD_DOCUMENTED` | `1` |
            | `HOROVOD_DEAD` | `3` |
            | `HOROVOD_GONE` | `0` |
            | `HOROVOD_TPU_ONLY` | `1` |
        """))
        fs = run_rules(collect_files([str(pkg)], excludes=()), all_rules(),
                       Options(knobs_doc=str(docs)))
        got = {(f.code, f.message.split("'")[1]) for f in fs
               if f.code.startswith("HVD4")}
        assert got == {("HVD402", "HOROVOD_UNDOCUMENTED"),
                       ("HVD403", "HOROVOD_GONE"),
                       ("HVD404", "HOROVOD_DEAD")}

    def test_port_registry_has_no_drift(self):
        """The port's registry against docs/knobs.md: every knob
        documented, no dead knob, no raw read, and the doc's rows the
        port does not register are exactly the skip list, each with its
        reason."""
        from horovod_tpu_torch import config
        from horovod_tpu_torch.analysis.rules_knobs import (
            KnobConsistency, _doc_rows)
        doc = os.path.join(REPO, "docs", "knobs.md")
        files = collect_files([os.path.join(REPO, "horovod_tpu_torch")])
        assert run_rules(files, [KnobConsistency()],
                         Options(knobs_doc=doc)) == []
        rows = set(_doc_rows(doc))
        registered = set(config.knobs._knobs)
        assert registered <= rows
        assert rows - registered == set(config.UNREGISTERED_DOC_KNOBS)
        assert all(config.UNREGISTERED_DOC_KNOBS.values())


# ---------------------------------------------------------------------------
# engine mechanics: suppressions, baseline, fingerprints
# ---------------------------------------------------------------------------

class TestEngine:
    def test_suppressions(self):
        assert lint("suppressed.py") == []

    def test_suppression_with_a_reason(self, tmp_path):
        fs = lint_text(tmp_path,
                       "import torch.distributed as dist\n"
                       "def f(t):\n"
                       "    if dist.get_rank() == 0:\n"
                       "        dist.send(t, 1)  # hvdlint: disable=HVD101"
                       " (rank 1 posts the matching recv)\n"
                       "    if dist.get_rank() == 1:\n"
                       "        dist.recv(t, 0)\n")
        assert [(f.code, f.line) for f in fs] == [("HVD101", 6)]

    def test_multiline_suppression_covers_statement_span(self, tmp_path):
        fs = lint_text(tmp_path,
                       "import os\n"
                       "def f():\n"
                       "    a = os.environ.get(\n"
                       "        'HOROVOD_CYCLE_TIME',\n"
                       "    )  # hvdlint: disable=HVD401\n"
                       "    b = os.environ.get('HOROVOD_TIMELINE')\n"
                       "    return a, b\n")
        assert codes(fs) == ["HVD401"] and fs[0].line == 6

    def test_zero_entry_baseline(self):
        bl = load_baseline(os.path.join(REPO, ".hvdlint-torch-baseline.json"))
        assert bl == {}

    def test_file_level_suppression_and_parse_error(self, tmp_path):
        assert lint_text(tmp_path,
                         "# hvdlint: disable-file=HVD401\n"
                         "import os\n"
                         "x = os.environ.get('HOROVOD_CYCLE_TIME')\n") == []
        assert codes(lint_text(tmp_path, "def oops(:\n", "broken.py")) == \
            ["HVD001"]

    def test_unused_suppressions_reported(self, tmp_path):
        from horovod_tpu_torch.analysis.engine import unused_suppressions
        p = tmp_path / "mod.py"
        p.write_text(
            "import os\n"
            "x = os.environ.get('HOROVOD_CYCLE_TIME')"
            "  # hvdlint: disable=HVD401\n"
            "y = 1  # hvdlint: disable=HVD401\n"
            "z = 2  # hvdlint: disable=HVD502\n"
            "w = 3  # hvdlint: disable=ALL\n")
        files = collect_files([str(p)], excludes=())
        assert run_rules(files, all_rules(), NO_DOCS) == []
        stale = unused_suppressions(files, [r.code for r in all_rules()])
        assert [(f.code, f.line) for f in stale] == [("HVD002", 3)]

    def test_baseline_roundtrip_and_new_findings(self, tmp_path):
        fs = tlint("knobs_bad.py")
        bl_path = str(tmp_path / "baseline.json")
        write_baseline(bl_path, fs)
        new, old = split_new(fs, load_baseline(bl_path))
        assert new == [] and len(old) == 3
        write_baseline(bl_path, fs[:1])
        new, old = split_new(fs, load_baseline(bl_path))
        assert len(old) == 1 and len(new) == 2
        f = fs[0]
        moved = type(f)(f.code, f.severity, f.path, f.line + 40, f.col,
                        f.message, f.symbol)
        assert moved.fingerprint() == f.fingerprint()

    def test_default_excludes_skip_both_fixture_sets(self):
        rels = {f.rel for f in collect_files([HERE])}
        assert not any("data/lint/" in r or "lint_torch/" in r
                       for r in rels)
        assert any(r.endswith("resilient_train.py") for r in rels)


# ---------------------------------------------------------------------------
# CLI + self-application
# ---------------------------------------------------------------------------

def run_cli(*argv, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis", *argv],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


class TestCli:
    def test_list_rules_and_formats(self):
        from horovod_tpu_torch.analysis import rules_model
        out = run_cli("--list-rules")
        assert out.returncode == 0
        assert [line.split()[0] for line in out.stdout.splitlines()] == \
            [r.code for r in all_rules()] + [r.code for r in rules_model.RULES]
        target = os.path.join("tests", "lint_torch", "knobs_bad.py")
        out = run_cli(target, "--no-baseline", "--format", "json")
        assert out.returncode == 1
        assert json.loads(out.stdout)["summary"]["new"] == 3
        out = run_cli(target, "--no-baseline", "--format", "github")
        assert out.returncode == 1
        assert len([line for line in out.stdout.splitlines()
                    if line.startswith("::error file=")]) == 3

    @pytest.mark.parametrize("flag, item", [
        ("--ir", "A.15.3"), ("--cost", "A.15.4"), ("--compat", "A.15.4")])
    def test_unported_tiers_are_usage_errors(self, flag, item):
        out = run_cli("horovod_tpu_torch", flag, "x")
        assert out.returncode == 2
        assert out.stderr.startswith("usage: hvdlint-torch")
        assert f"ROADMAP {item}" in out.stderr

    def test_select_and_baseline_cycle(self, tmp_path):
        out = run_cli(os.path.join("tests", "lint_torch"),
                      "--no-baseline", "--select", "HVD3")
        assert out.returncode == 1
        assert "HVD305" in out.stdout and "HVD101" not in out.stdout
        target = os.path.join("tests", "lint_torch", "spmd_bad.py")
        bl = str(tmp_path / "bl.json")
        assert run_cli(target, "--baseline", bl,
                       "--write-baseline").returncode == 0
        again = run_cli(target, "--baseline", bl)
        assert again.returncode == 0 and "baselined" in again.stdout
        assert run_cli("--no-such-flag").returncode == 2
        assert run_cli().returncode == 2

    def test_self_application_is_clean(self):
        """The port's tree lints clean against the empty checked-in
        baseline, with no stale suppression."""
        out = run_cli("horovod_tpu_torch", "--report-unused-suppressions")
        assert out.returncode == 0, out.stdout + out.stderr
        assert "0 new" in out.stdout
