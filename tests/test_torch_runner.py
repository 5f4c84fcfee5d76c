"""The port's launcher (``horovod_tpu_torch/runner``) against the JAX
package's (``horovod_tpu/runner``) on the CPU.

``tests/test_runner.py`` replayed without its ``tpu_pod`` cases (the TPU-pod
launch has no GPU counterpart): ``parse_hosts``; ``env_from_args`` (the
same environment as the JAX launcher's for the same argv, less the per-run
secret and trace id); the config-file cases (the same parsed arguments as
the JAX package's); the SSH command of every slot (equal to the JAX
launcher's per-host command but for the world variables of the process
model: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` in place of ``HVD_TPU_COORDINATOR``,
``HVD_TPU_NUM_PROCESSES`` and ``HVD_TPU_PROCESS_ID``); the connectivity
probe; ``_supervise`` (relaunch on 75 and on death by a signal, never on
an ordinary failure, ``HVD_RESUME_ATTEMPT`` stamped), with stubbed runs
and with real ``--virtual`` worlds; and ``interactive.run``
(``tests/test_interactive_run.py``'s five cases; the ranks of one
machine are one host here, as in the reference Horovod, where the JAX
package makes each process a host of one device).

The whole module runs under a time limit of its own (``LIMIT_S``).
"""

import json
import os
import shlex
import signal
import subprocess
import sys
import time
from unittest import mock

import pytest

from horovod_tpu.runner import launch as jlaunch
from horovod_tpu.runner import config_file as jconfig
from horovod_tpu_torch.runner import config_file as config
from horovod_tpu_torch.runner import interactive
from horovod_tpu_torch.runner import launch
import test_torch_launch_workers as lw

LIMIT_S = 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "test_torch_launch_workers.py")
PER_RUN = ("HVD_TPU_SECRET", "HVD_TRACE_ID")


@pytest.fixture(scope="module", autouse=True)
def _module_time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def _env(mod, argv):
    env = mod.env_from_args(mod.build_parser().parse_args(argv))
    return {k: v for k, v in env.items() if k not in PER_RUN}


def _cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    env.pop("HVD_TPU_FORCE_CPU", None)
    return env


# ---------------------------------------------------------------------------
# hosts and the environment
# ---------------------------------------------------------------------------

def test_parse_hosts_inline_and_file(tmp_path):
    f = tmp_path / "hostfile"
    f.write_text("# comment\nh1 slots=4\nh2:8\n")
    for mod in (launch, jlaunch):
        assert mod.parse_hosts("h1:4,h2:2", None) == [("h1", 4), ("h2", 2)]
        assert mod.parse_hosts("solo", None) == [("solo", 1)]
        assert mod.parse_hosts(None, str(f)) == [("h1", 4), ("h2", 8)]


ENV_ARGVS = [
    ["--torus-allreduce", "--mesh-shape", "4,2"],
    ["--hierarchical-allreduce", "--log-level", "INFO"],
    ["--trace", "--trace-dir", "/tmp/tr", "--trace-profile", "steps:3@2",
     "--stall-check-disable", "--log-level", "DEBUG"],
    ["--elastic-grace-seconds", "10", "--auto-resume", "2", "--ckpt-dir",
     "/tmp/ck", "--ckpt-interval", "auto", "--preemption-file", "/tmp/p"],
    [],
]


@pytest.mark.parametrize("argv", ENV_ARGVS, ids=range(len(ENV_ARGVS)))
def test_env_from_args_matches_jax(argv):
    argv = argv + ["--", "python", "x.py"]
    got = _env(launch, argv)
    assert got == _env(jlaunch, argv)
    full = launch.env_from_args(launch.build_parser().parse_args(argv))
    assert len(full["HVD_TPU_SECRET"]) == 64
    assert os.environ["HVD_TPU_SECRET"] == full["HVD_TPU_SECRET"]
    if "--trace" in argv:
        assert len(full["HVD_TRACE_ID"]) == 16


@pytest.mark.parametrize("argv,err", [
    (["--trace-profile", "steps:x"], "steps:N"),
    (["--ckpt-interval", "often"], "convert")])
def test_env_from_args_rejects_what_jax_rejects(argv, err):
    for mod in (launch, jlaunch):
        args = mod.build_parser().parse_args(argv + ["--", "python"])
        with pytest.raises(ValueError, match=err):
            mod.env_from_args(args)


# The online tuner's flags (once refused), with a value and the knob each
# sets.
UNPORTED_FLAGS = {"--autotune": (None, "HOROVOD_AUTOTUNE"),
                  "--autotune-log-file": ("at.csv", "HOROVOD_AUTOTUNE_LOG")}
# The metrics exports' flags, with a value and the knob each sets.
METRICS_FLAGS = {"--metrics-port": ("9090", "HOROVOD_METRICS_PORT"),
                 "--metrics-dump": ("m.json", "HOROVOD_METRICS_DUMP")}
# The control plane's flags (the coordinator and the timeline), with a
# value for each.
CONTROL_PLANE_FLAGS = {
    "--fusion-threshold-mb": "64", "--fusion-threshold": "local:1MB,cross:16KB",
    "--cycle-time-ms": "5", "--cache-capacity": "7",
    "--timeline-filename": "t.json", "--timeline-mark-cycles": None}


def _flags(mod):
    return {o for a in mod.build_parser()._actions for o in a.option_strings}


def test_parser_has_jax_flags_but_tpu():
    """The JAX launcher's flags less ``--tpu``: the control plane's, the
    online tuner's and the metrics exports' are there."""
    assert set(UNPORTED_FLAGS) <= _flags(launch)
    assert _flags(jlaunch) - _flags(launch) == {"--tpu"}
    assert _flags(launch) - _flags(jlaunch) == set()


@pytest.mark.parametrize("flag", sorted(METRICS_FLAGS))
def test_metrics_flags_set_jax_env(flag):
    """``--metrics-port`` and ``--metrics-dump`` set the environment the
    JAX launcher sets for them."""
    value, knob = METRICS_FLAGS[flag]
    argv = [flag, value, "--", "python", "x.py"]
    got = _env(launch, argv)
    assert got == _env(jlaunch, argv)
    assert got[knob] == value


@pytest.mark.parametrize("flag", sorted(UNPORTED_FLAGS))
def test_unported_knob_flags_are_refused(flag):
    """The online tuner's flags, once refused, set the environment the JAX
    launcher sets for them: HOROVOD_AUTOTUNE=1 and HOROVOD_AUTOTUNE_LOG."""
    value, knob = UNPORTED_FLAGS[flag]
    argv = [flag] + ([value] if value else []) + ["--", "python", "x.py"]
    got = _env(launch, argv)
    assert got == _env(jlaunch, argv)
    assert got[knob] == (value or "1")


@pytest.mark.parametrize("flag", sorted(CONTROL_PLANE_FLAGS))
def test_control_plane_flags_set_jax_env(flag):
    """Each flag of the coordinator and the timeline sets the environment
    the JAX launcher sets for it."""
    value = CONTROL_PLANE_FLAGS[flag]
    argv = [flag] + ([value] if value else []) + ["--", "python", "x.py"]
    got = _env(launch, argv)
    assert got == _env(jlaunch, argv)
    knob = {"--fusion-threshold-mb": "HOROVOD_FUSION_THRESHOLD",
            "--fusion-threshold": "HOROVOD_FUSION_THRESHOLD",
            "--cycle-time-ms": "HOROVOD_CYCLE_TIME",
            "--cache-capacity": "HOROVOD_CACHE_CAPACITY",
            "--timeline-filename": "HOROVOD_TIMELINE",
            "--timeline-mark-cycles": "HOROVOD_TIMELINE_MARK_CYCLES"}[flag]
    assert knob in got


# ---------------------------------------------------------------------------
# the config file (the JAX package's cases, both packages)
# ---------------------------------------------------------------------------

def _apply(mod, cfg_mod, cfg_text, argv, tmp_path):
    cfg = tmp_path / "hvd.yaml"
    cfg.write_text(cfg_text)
    argv = ["--config-file", str(cfg)] + argv
    parser = mod.build_parser()
    args = parser.parse_args(argv)
    cfg_mod.set_args_from_config(parser, args,
                                 cfg_mod.load_config_file(str(cfg)),
                                 cfg_mod.cli_overrides(parser, argv,
                                                       args.command))
    return args


CONFIG_CASES = [
    ("params:\n  hierarchical_allreduce: true\n  torus_allreduce: true\n"
     "stall_check:\n  enabled: false\nlogging:\n  level: DEBUG\n"
     "mesh_shape: '4,2'\n",
     ["--log-level", "INFO", "--", "python", "x.py"]),
    ("elastic:\n  min_np: 2\n  max_np: 8\n  slots: 4\n  reset_limit: 3\n"
     "  host_discovery_script: ./discover.sh\n", ["--", "python", "x.py"]),
    ("logging:\n  level: DEBUG\n",
     ["python", "x.py", "--log-level", "INFO"]),
    ("elastic:\n  min_np: '2'\n  grace_seconds: '10'\n",
     ["--", "python", "x.py"]),
    ("hosts: other:8\nnum_proc: 16\n",
     ["-Hlocalhost:4", "-np=4", "--", "python", "x.py"]),
    ("logging:\n  level: 10\nmesh_shape: 4\n", ["--", "python", "x.py"]),
    ("stall_check:\n  enabled: null\ntrace:\n"
     "  enabled: true\n  dir: /tmp/t\n", ["--", "python", "x.py"]),
    ("params:\n  fusion_threshold_mb: 32\n  cache_capacity: 9\n"
     "timeline:\n  filename: t.json\n  mark_cycles: true\n",
     ["--cycle-time-ms", "2.5", "--", "python", "x.py"]),
]


@pytest.mark.parametrize("text,argv", CONFIG_CASES,
                         ids=range(len(CONFIG_CASES)))
def test_config_file_matches_jax(text, argv, tmp_path):
    got = vars(_apply(launch, config, text, argv, tmp_path))
    want = vars(_apply(jlaunch, jconfig, text, argv, tmp_path))
    want.pop("tpu")
    assert got == want
    env = {k: v for k, v in _env_of(got).items() if k not in PER_RUN}
    assert all(isinstance(v, str) for v in env.values())


def _env_of(d):
    import argparse
    return launch.env_from_args(argparse.Namespace(**d))


def test_config_file_cli_wins_and_sections(tmp_path):
    args = _apply(launch, config, *CONFIG_CASES[0], tmp_path)
    env = launch.env_from_args(args)
    assert env["HOROVOD_LOG_LEVEL"] == "INFO"          # CLI wins
    assert env["HOROVOD_TORUS_ALLREDUCE"] == "1"
    assert env["HOROVOD_STALL_CHECK_DISABLE"] == "1"
    args = _apply(launch, config, *CONFIG_CASES[4], tmp_path)
    assert args.hosts == "localhost:4" and args.num_proc == 4


@pytest.mark.parametrize("cfg,err", [
    ({"params": "oops"}, "must be a mapping"),
    ({"stall_check": True}, "must be a mapping"),
    ({"params": {"torus_allreduce": "yes"}}, "expected a boolean"),
    ({"elastic": {"min_np": True}}, "got a boolean"),
    ({"stall_check": {"enabled": 1}}, "stall_check.enabled"),
    ({"params": {"fusion_threshold": 64}}, "unknown key"),
    ({"elastics": {}}, "unknown key")])
def test_config_file_rejections_match_jax(cfg, err):
    for mod, cmod in ((launch, config), (jlaunch, jconfig)):
        parser = mod.build_parser()
        args = parser.parse_args(["--", "python", "x.py"])
        with pytest.raises(ValueError, match=err):
            cmod.set_args_from_config(parser, args, cfg, set())


@pytest.mark.parametrize("cfg", [
    {"metrics": {"port": 9090}}, {"metrics": {"dump": "m.json"}}])
def test_config_file_metrics_keys_match_jax(cfg):
    """The ``metrics`` section gives the JAX package's arguments and
    environment."""
    got = []
    for mod, cmod in ((launch, config), (jlaunch, jconfig)):
        parser = mod.build_parser()
        args = parser.parse_args(["--", "python", "x.py"])
        cmod.set_args_from_config(parser, args, cfg, set())
        got.append((args.metrics_port, args.metrics_dump,
                    {k: v for k, v in mod.env_from_args(args).items()
                     if k.startswith("HOROVOD_METRICS")}))
    assert got[0] == got[1]
    assert got[0][2]


@pytest.mark.parametrize("cfg", [
    {"autotune": {"enabled": True}}, {"autotune": {"log_file": "at.csv"}}])
def test_config_file_refuses_unported_knobs(cfg):
    """The ``autotune`` section, once refused, gives the JAX package's
    arguments and environment (HOROVOD_AUTOTUNE, HOROVOD_AUTOTUNE_LOG)."""
    got = []
    for mod, cmod in ((launch, config), (jlaunch, jconfig)):
        parser = mod.build_parser()
        args = parser.parse_args(["--", "python"])
        cmod.set_args_from_config(parser, args, cfg, set())
        got.append((args.autotune, args.autotune_log_file,
                    {k: v for k, v in mod.env_from_args(args).items()
                     if k.startswith("HOROVOD_AUTOTUNE")}))
    assert got[0] == got[1]
    want = ({"HOROVOD_AUTOTUNE": "1"} if cfg["autotune"].get("enabled")
            else {"HOROVOD_AUTOTUNE_LOG": "at.csv"})
    assert got[0][2] == want


@pytest.mark.parametrize("cfg", [
    {"params": {"fusion_threshold_mb": 64}}, {"params": {"cycle_time_ms": 5}},
    {"params": {"cache_capacity": 7}}, {"timeline": {"filename": "t.json"}},
    {"timeline": {"mark_cycles": True}}])
def test_config_file_control_plane_keys_match_jax(cfg):
    """The control plane's keys give the JAX package's arguments and
    environment."""
    got = []
    for mod, cmod in ((launch, config), (jlaunch, jconfig)):
        parser = mod.build_parser()
        args = parser.parse_args(["--", "python"])
        cmod.set_args_from_config(parser, args, cfg, set())
        env = {k: v for k, v in mod.env_from_args(args).items()
               if k not in PER_RUN}
        got.append((vars(args), env))
    (args, env), (jargs, jenv) = got
    for dest in ("fusion_threshold_mb", "cycle_time_ms", "cache_capacity",
                 "timeline_filename", "timeline_mark_cycles"):
        assert args[dest] == jargs[dest]
    assert env == jenv


def test_config_file_rejects_non_mapping(tmp_path):
    cfg = tmp_path / "bad.yaml"
    cfg.write_text("- just\n- a list\n")
    with pytest.raises(ValueError):
        config.load_config_file(str(cfg))


# ---------------------------------------------------------------------------
# the SSH command of every slot
# ---------------------------------------------------------------------------

WORLD_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HVD_TPU_COORDINATOR",
              "HVD_TPU_NUM_PROCESSES", "HVD_TPU_PROCESS_ID")


def _ssh_calls(mod, argv):
    with mock.patch.object(subprocess, "Popen") as popen:
        popen.return_value.wait.return_value = 0
        popen.return_value.poll.return_value = 0
        popen.return_value.returncode = 0
        assert mod.main(argv) == 0
    calls = []
    for c in popen.call_args_list:
        full = c.args[0]
        remote = full[-1]
        stdin = b"".join(a.args[0] for a in
                         popen.return_value.stdin.write.call_args_list)
        calls.append((full[:-1], remote))
    return calls, stdin.decode(), os.environ["HVD_TPU_SECRET"]


def _split(remote):
    """(env pairs of the world, the rest of the command with them cut)."""
    toks = shlex.split(remote)
    world = {}
    rest = []
    for t in toks:
        k, eq, v = t.partition("=")
        if eq and k in WORLD_VARS:
            world[k] = v
        else:
            rest.append(t)
    return world, rest


def test_multihost_ssh_command_per_slot():
    argv = ["-H", "h1:2,h2:2", "--coordinator-port", "1234",
            "--disable-connectivity-probe", "--torus-allreduce", "--",
            "python", "train.py"]
    calls, stdin, secret = _ssh_calls(launch, argv)
    jcalls, _, _ = _ssh_calls(jlaunch, argv)
    assert len(calls) == 4 and len(jcalls) == 2
    for slot, (head, remote) in enumerate(calls):
        host = "h1" if slot < 2 else "h2"
        assert head == ["ssh", host]
        world, rest = _split(remote)
        assert world == {"RANK": str(slot), "WORLD_SIZE": "4",
                         "LOCAL_RANK": str(slot % 2),
                         "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "h1",
                         "MASTER_PORT": "1234"}
        jhead, jremote = jcalls[slot // 2]
        jworld, jrest = _split(jremote)
        assert jworld["HVD_TPU_PROCESS_ID"] == str(slot // 2)
        assert head == jhead and rest == jrest
        # the secret rides stdin, never the command line
        assert "read -r HVD_TPU_SECRET" in remote
        assert secret not in remote
    assert stdin.count(secret) == 4


def test_multihost_launch_sets_advertise_host():
    from horovod_tpu_torch.runner import probe as probe_mod
    with mock.patch.object(probe_mod, "probe_hosts",
                           return_value={0: "10.0.0.5", 1: "10.0.0.6"}):
        calls, _, _ = _ssh_calls(launch, ["-H", "h1:1,h2:1", "--",
                                       "python", "train.py"])
    assert "HVD_TPU_ADVERTISE_HOST=10.0.0.5" in calls[0][1]
    assert "HVD_TPU_ADVERTISE_HOST=10.0.0.6" in calls[1][1]


def test_exit_code_rule_matches_jax():
    """Any other nonzero code beats 75 and 75 beats 0 (JAX
    launch.py:390-405)."""
    cases = [([0, 0], 0), ([75, 0], 75), ([0, 75, 75], 75), ([75, 1], 1),
             ([2, 75, 3], 2), ([-9, 75], -9)]
    for rcs, want in cases:
        assert launch.exit_code_of(rcs) == want
        with mock.patch.object(subprocess, "Popen") as popen:
            popen.return_value.wait.side_effect = list(rcs)
            hosts = ",".join(f"h{i}" for i in range(len(rcs)))
            assert jlaunch.main(["-H", hosts, "--disable-connectivity-probe",
                                 "--", "python", "x.py"]) == want


@pytest.mark.parametrize("rc,want", [(0, 0), (1, 1), (75, 75), (128, 128),
                                     (137, -9), (143, -15), (255, -1)])
def test_ssh_exit_code_maps_remote_signals(rc, want):
    """ssh reports a remote death by signal N as 128+N and a lost
    connection as 255: both reach _supervise as a death by a signal."""
    assert launch.ssh_exit_code(rc) == want


FAKE_SSH = """#!{python}
import os, signal, subprocess, sys
argv = sys.argv[1:]
while argv[0] == "-p":
    argv = argv[2:]
# Run the remote command here, in a session of its own; terminating this
# client kills it, and a death by signal N is reported as 128+N, as ssh does.
p = subprocess.Popen(["sh", "-c", argv[1]], start_new_session=True)
signal.signal(signal.SIGTERM, lambda *a: os.killpg(p.pid, signal.SIGKILL))
rc = p.wait()
sys.exit(128 - rc if rc < 0 else rc)
"""


def test_multihost_dead_slot_releases_its_blocked_peers(tmp_path,
                                                         monkeypatch):
    """One slot dies to a signal while the other blocks: the launcher
    stops the blocked slot after the grace window and auto-resume
    relaunches both (attempt 1), instead of waiting on the blocked one."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    ssh = bindir / "ssh"
    ssh.write_text(FAKE_SSH.format(python=sys.executable))
    ssh.chmod(0o755)
    log = tmp_path / "launch.jsonl"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("LAUNCH_TEST_LOG", str(log))
    monkeypatch.setattr(launch, "EXIT_GRACE_S", 1.0)
    t0 = time.monotonic()
    rc = launch.main(["-H", "localhost:1,127.0.0.1:1",
                      "--disable-connectivity-probe", "--auto-resume", "1",
                      "--", sys.executable, WORKERS, "die_or_block"])
    assert rc == 0
    assert time.monotonic() - t0 < 60        # the sleeper blocks for 120 s
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert sorted((r["attempt"], r["rank"]) for r in recs) == \
        [("0", "0"), ("0", "1"), ("1", "0"), ("1", "1")]


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

@pytest.fixture()
def loopback_driver(monkeypatch):
    """The probes connect back to the driver on the loopback address."""
    from horovod_tpu_torch.runner import probe as probe_mod
    monkeypatch.setattr(probe_mod, "driver_candidate_addresses",
                        lambda: ["127.0.0.1"])


def test_probe_learns_worker_addresses(loopback_driver):
    from horovod_tpu_torch.runner.probe import probe_hosts
    got = probe_hosts(["hostA", "hostB"], local=True, timeout=30)
    assert got == {0: "127.0.0.1", 1: "127.0.0.1"}


def test_probe_fails_fast_on_unreachable_host(loopback_driver):
    from horovod_tpu_torch.runner.probe import (ProbeError, _default_argv_fn,
                                                probe_hosts)

    def argv_fn(host, client_argv):
        if host == "bad":
            return [sys.executable, "-c", "import sys; sys.exit('no route')"]
        return _default_argv_fn(None, True)(host, client_argv)

    with pytest.raises(ProbeError, match="bad") as e:
        probe_hosts(["good", "bad"], local=True, timeout=20,
                    argv_fn=argv_fn)
    assert e.value.failed_hosts == ["bad"]


def test_probe_rejects_spoofed_reports():
    import socket
    from horovod_tpu_torch.runner.probe import ProbeServer
    server = ProbeServer(expected=1, secret=b"real-secret")
    try:
        body = json.dumps({"index": 0, "local_ip": "6.6.6.6",
                           "hostname": "evil"}, sort_keys=True)
        s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
        s.sendall((json.dumps({"body": body, "mac": "00" * 32})
                   + "\n").encode())
        s.close()
        assert not server.wait(0.5)
        assert server.results == {}
    finally:
        server.close()


# ---------------------------------------------------------------------------
# supervision: stubbed runs, then real --virtual worlds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rcs,auto,want_rc,want_attempts", [
    ([75, 0], 1, 0, [0, 1]),           # preempted, resumed
    ([-9, 0], 1, 0, [0, 1]),           # died to a signal, resumed
    ([1], 3, 1, [0]),                  # an ordinary failure: never retried
    ([75, 75, 75], 2, 75, [0, 1, 2]),  # the limit
    ([75], 0, 75, [0]),                # auto-resume off
    ([0], 2, 0, [0])])
def test_supervise_matches_jax(rcs, auto, want_rc, want_attempts):
    for mod in (launch, jlaunch):
        seen = []

        def run_once(attempt, it=iter(list(rcs))):
            seen.append(attempt)
            return next(it)

        args = mod.build_parser().parse_args(
            ["--auto-resume", str(auto), "--", "x"])
        assert mod._supervise(run_once, args) == want_rc
        assert seen == want_attempts


def test_supervise_reads_the_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTO_RESUME", "1")
    seen = []

    def run_once(attempt):
        seen.append(attempt)
        return 75 if attempt == 0 else 0

    args = launch.build_parser().parse_args(["--", "x"])
    assert launch._supervise(run_once, args) == 0 and seen == [0, 1]


def test_local_launch_env_of_every_rank(monkeypatch):
    monkeypatch.delenv("HVD_TPU_FORCE_CPU", raising=False)
    procs = []

    def fake_popen(cmd, env):
        p = mock.MagicMock()
        p.poll.return_value = 0
        p.returncode = 0
        procs.append((cmd, env))
        return p

    with mock.patch.object(subprocess, "Popen", side_effect=fake_popen):
        assert launch.main(["-np", "3", "--virtual", "--", "python", "-c",
                            "pass"]) == 0
    assert [c for c, _ in procs] == [["python", "-c", "pass"]] * 3
    ports = {e["MASTER_PORT"] for _, e in procs}
    assert len(ports) == 1 and int(ports.pop()) > 0
    for r, (_, env) in enumerate(procs):
        assert (env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"],
                env["LOCAL_WORLD_SIZE"]) == (str(r), "3", str(r), "3")
        assert env["MASTER_ADDR"] == "127.0.0.1"
        assert env["HVD_TPU_FORCE_CPU"] == "1"
        assert env["TORCHELASTIC_USE_AGENT_STORE"] == "True"
        assert env["HVD_RESUME_ATTEMPT"] == "0"
    assert launch.main(["-np", "2"]) == 2          # no command


def _run_cli(tmp_path, argv, timeout=120):
    log = tmp_path / "launch.jsonl"
    env = _cli_env()
    env["LAUNCH_TEST_LOG"] = str(log)
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *argv],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    recs = [json.loads(x) for x in log.read_text().splitlines()] \
        if log.exists() else []
    return out, recs


@pytest.mark.parametrize("code,rc,attempts", [("75", 0, ["0", "1"]),
                                              ("kill", 0, ["0", "1"]),
                                              ("1", 1, ["0"])])
def test_virtual_world_auto_resume(tmp_path, code, rc, attempts):
    out, recs = _run_cli(tmp_path, ["-np", "2", "--virtual",
                                    "--auto-resume", "1", "--",
                                    sys.executable, WORKERS, "exit_with",
                                    code])
    assert out.returncode == rc, out.stderr
    assert sorted({r["attempt"] for r in recs}) == attempts
    assert sorted((r["attempt"], r["rank"]) for r in recs) == \
        [(a, str(k)) for a in attempts for k in range(2)]


def test_virtual_world_joins_over_the_launchers_store(tmp_path):
    out, recs = _run_cli(tmp_path, ["-np", "3", "--virtual", "--",
                                    sys.executable, WORKERS, "world_check"])
    assert out.returncode == 0, out.stderr
    assert sorted(r["rank"] for r in recs) == ["0", "1", "2"]
    for r in recs:
        assert r["size"] == 3 and r["sum"] == 6.0 and r["device"] == "cpu"
        assert r["agent_store"] == "True"


def test_no_cpu_fallback_without_virtual(tmp_path):
    """Without --virtual the workers ask for the card; with none here,
    init raises and the run fails (never continues on the CPU)."""
    out, recs = _run_cli(tmp_path, ["-np", "1", "--", sys.executable,
                                    WORKERS, "world_check"])
    assert out.returncode != 0 and recs == []
    assert "torch.cuda.is_available() is False" in out.stderr


def test_cli_entry_point_version():
    out = subprocess.run([sys.executable, "-m",
                          "horovod_tpu_torch.runner.launch", "--version"],
                         capture_output=True, text=True, env=_cli_env(),
                         timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == \
        __import__("horovod_tpu_torch").__version__


# ---------------------------------------------------------------------------
# interactive.run (tests/test_interactive_run.py's five cases), on a CPU
# world: run() takes the cards unless the caller asks for the CPU.
# ---------------------------------------------------------------------------

_CPU = {"HVD_TPU_FORCE_CPU": "1"}

def test_run_returns_per_rank_results():
    out = interactive.run(lw.rank_info, np=2, env=_CPU)
    assert [o["rank"] for o in out] == [0, 1]
    for o in out:
        assert o["size"] == 2 and o["homogeneous"]
        assert o["local_size"] == 2 and o["cross_size"] == 1
        assert o["cross_rank"] == 0


def test_run_object_collectives_across_processes():
    for o in interactive.run(lw.object_collectives, np=2, env=_CPU):
        assert o["gathered"] == [0, 10] and o["bcast"] == "root-data"


def test_run_broadcast_parameters_across_processes():
    for o in interactive.run(lw.broadcast_params, np=2, env=_CPU):
        assert o["w"] == [0.0] * 4 and o["b"] == [100.0, 100.0]


def test_run_propagates_worker_failure():
    with pytest.raises(RuntimeError, match="rank exploded"):
        interactive.run(lw.failing_fn, np=2, env=_CPU)


def test_run_defaults_to_one_rank_per_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interactive.run(lw.rank_info)


def test_run_never_falls_back_to_the_cpu(monkeypatch):
    """Without HVD_TPU_FORCE_CPU=1 the ranks ask for a card; with none
    here, init raises in every rank."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    monkeypatch.delenv("HVD_TPU_FORCE_CPU", raising=False)
    with pytest.raises(RuntimeError, match="is_available"):
        interactive.run(lw.rank_info, np=1)


def test_run_forwards_args_kwargs():
    assert interactive.run(lw.with_args, args=(2, 3), kwargs={"scale": 10},
                           np=2, env=_CPU) == [50, 51]
