"""The port's elastic launcher end to end on the CPU: REAL worker processes,
a scripted discovery and scripted failures, as ``tests/
test_elastic_integration.py`` runs the JAX package's.

A temp discovery script cats a hosts file the test mutates mid-run; the
workers run ``tests/test_torch_launch_workers.py elastic_train`` (the
port's copy of ``tests/data/elastic_train.py``) under ``python -m
horovod_tpu_torch.runner.launch --virtual --min-np ...
--host-discovery-script ... --elastic-local`` (gloo, one process per
slot) and append JSON records to a log the assertions read. The
scenarios and their assertions are the JAX file's: a host added, a host
removed with no lost sample, a worker crash blacklisting its host, the
min-np timeout and the weight continuity. One more runs both launchers on
the same exit schedule and compares the sizes by generation and the
per-rank index lists.

The whole module runs under a time limit of its own (``LIMIT_S``).
"""

import json
import os
import signal
import stat
import subprocess
import sys
import time

import pytest

LIMIT_S = 420
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TRAIN = [os.path.join(REPO, "tests", "test_torch_launch_workers.py"),
              "elastic_train"]
JAX_TRAIN = [os.path.join(REPO, "tests", "data", "elastic_train.py")]


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


class ElasticRun:
    def __init__(self, tmp_path, hosts, min_np, max_np=None, schedule=None,
                 epochs=3, start_timeout=20.0, package="port",
                 batch_sleep=None):
        self.tmp = tmp_path
        self.hosts_file = tmp_path / "hosts.txt"
        self.hosts_file.write_text("\n".join(hosts) + "\n")
        self.script = tmp_path / "discover.sh"
        self.script.write_text(f"#!/bin/sh\ncat {self.hosts_file}\n")
        self.script.chmod(self.script.stat().st_mode | stat.S_IEXEC)
        self.log_path = tmp_path / "run.json"
        self.log_path.write_text("")
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env.pop("XLA_FLAGS", None)
        env.pop("HVD_TPU_FORCE_CPU", None)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
        env["ELASTIC_TEST_LOG"] = str(self.log_path)
        env["ELASTIC_TEST_EPOCHS"] = str(epochs)
        if batch_sleep is not None:
            env["ELASTIC_TEST_BATCH_SLEEP"] = str(batch_sleep)
        if schedule:
            env["ELASTIC_EXIT_SCHEDULE"] = json.dumps(schedule)
        self.env = env
        launcher = ("horovod_tpu_torch.runner.launch" if package == "port"
                    else "horovod_tpu.runner.launch")
        self.cmd = [
            sys.executable, "-m", launcher,
            *(["--virtual"] if package == "port" else []),
            "--min-np", str(min_np),
            *(["--max-np", str(max_np)] if max_np else []),
            "--host-discovery-script", str(self.script),
            "--start-timeout", str(start_timeout),
            "--elastic-local",
            "--elastic-state-dir", str(tmp_path / "state"),
            "--", sys.executable,
            *(PORT_TRAIN if package == "port" else JAX_TRAIN)]
        self.proc = None

    def start(self):
        self.proc = subprocess.Popen(
            self.cmd, env=self.env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return self

    def set_hosts(self, hosts):
        self.hosts_file.write_text("\n".join(hosts) + "\n")

    def wait(self, timeout=240):
        out, _ = self.proc.communicate(timeout=timeout)
        return self.proc.returncode, out

    def records(self):
        return [json.loads(x) for x in self.log_path.read_text().splitlines()
                if x.strip()]

    def wait_for_record(self, pred, timeout=120):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for r in self.records():
                if pred(r):
                    return r
            if self.proc.poll() is not None:
                break
            time.sleep(0.3)
        raise AssertionError(
            f"no record matching predicate; have {self.records()[-5:]}")


def sizes_by_generation(records):
    gens = {}
    for r in records:
        if "gen" in r and "size" in r:
            gens[r["gen"]] = r["size"]
    return [gens[g] for g in sorted(gens)]


def test_elastic_host_added(tmp_path):
    run = ElasticRun(tmp_path, hosts=["nodeA:2"], min_np=2, max_np=4,
                     epochs=4).start()
    run.wait_for_record(lambda r: r["type"] == "batch" and r["size"] == 2)
    run.set_hosts(["nodeA:2", "nodeB:2"])
    rc, out = run.wait()
    assert rc == 0, out
    recs = run.records()
    sizes = sizes_by_generation(recs)
    assert sizes[0] == 2 and sizes[-1] == 4, sizes
    assert any(r["type"] == "done" for r in recs)


def test_elastic_host_removed_no_sample_loss(tmp_path):
    run = ElasticRun(tmp_path, hosts=["nodeA:1", "nodeB:1"], min_np=1,
                     epochs=3).start()
    run.wait_for_record(lambda r: r["type"] == "batch" and r["size"] == 2)
    run.set_hosts(["nodeA:1"])
    rc, out = run.wait()
    assert rc == 0, out
    recs = run.records()
    sizes = sizes_by_generation(recs)
    assert sizes[0] == 2 and sizes[-1] == 1, sizes
    dataset = set(range(48))
    for epoch in range(3):
        seen = [i for r in recs
                if r["type"] == "batch" and r["epoch"] == epoch
                for i in r["idx"]]
        missing = dataset - set(seen)
        assert not missing, f"epoch {epoch} lost samples {missing}"


def test_elastic_worker_crash_blacklists_and_continues(tmp_path):
    run = ElasticRun(tmp_path, hosts=["nodeA:1", "nodeB:1"], min_np=1,
                     epochs=3, schedule={"1:1:0": 17}).start()
    rc, out = run.wait()
    assert rc == 0, out
    recs = run.records()
    assert any(r["type"] == "crash" and r["rank"] == 1 for r in recs)
    sizes = sizes_by_generation(recs)
    # nodeB blacklisted: some post-crash generation runs at size 1 (a
    # cooldown that expires first may bring it back at the end)
    assert sizes[0] == 2 and 1 in sizes[1:], sizes
    done = [r for r in recs if r["type"] == "done"]
    assert done and done[0]["size"] in (1, 2)
    assert any(r["type"] == "epoch_done" and r["epoch"] == 2 for r in recs)


def test_elastic_min_np_timeout(tmp_path):
    run = ElasticRun(tmp_path, hosts=[], min_np=2, start_timeout=4.0,
                     epochs=1).start()
    rc, out = run.wait(timeout=60)
    assert rc == 124, out
    assert "timed out waiting" in out


def test_elastic_weight_continuity_across_resize(tmp_path):
    run = ElasticRun(tmp_path, hosts=["nodeA:2"], min_np=1, epochs=3).start()
    run.wait_for_record(lambda r: r["type"] == "epoch_done")
    run.set_hosts(["nodeA:1"])
    rc, out = run.wait()
    assert rc == 0, out
    recs = run.records()
    done = [r for r in recs if r["type"] == "done"]
    assert len(done) == 1, done          # exactly one completion, ever
    epochs_done = [r["epoch"] for r in recs if r["type"] == "epoch_done"
                   and r["rank"] == 0]
    assert sorted(epochs_done) == [0, 1, 2], epochs_done
    w = [r["weights0"] for r in recs if r["type"] == "epoch_done"]
    assert all(b >= a for a, b in zip(w, w[1:])), w


def test_both_launchers_on_one_exit_schedule(tmp_path):
    """The same crash schedule through the JAX launcher (JAX workers) and
    the port's (torch workers): rank 1 exits 17 at epoch 1, batch 0. The
    first two generations' sizes are 2 then 1 in both, epoch 0's
    per-rank index lists (before any interruption) are equal, and every
    epoch's samples are all processed in both."""
    outs = {}
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        run = ElasticRun(d, hosts=["nodeA:1", "nodeB:1"], min_np=1,
                         epochs=3, schedule={"1:1:0": 17}, package=pkg,
                         batch_sleep=0.05).start()
        rc, out = run.wait()
        assert rc == 0, (pkg, out)
        outs[pkg] = run.records()
    views = {}
    for pkg, recs in outs.items():
        sizes = sizes_by_generation(recs)
        first = {r["rank"]: [] for r in recs if r.get("gen") == 1
                 and r["type"] == "batch"}
        for r in recs:
            if r["type"] == "batch" and r["gen"] == 1 and r["epoch"] == 0:
                first[r["rank"]].extend(r["idx"])
        crashes = [(r["rank"], r["epoch"], r["batch"]) for r in recs
                   if r["type"] == "crash"]
        for epoch in range(3):
            seen = {i for r in recs if r["type"] == "batch"
                    and r["epoch"] == epoch for i in r["idx"]}
            assert seen == set(range(48)), (pkg, epoch)
        views[pkg] = (sizes[:2], first, crashes)
    assert views["port"] == views["jax"]
    assert views["port"][0] == [2, 1]
    assert views["port"][1][0] == list(range(0, 48, 2))
