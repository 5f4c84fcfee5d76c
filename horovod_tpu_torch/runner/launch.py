"""``hvdrun-torch`` — the port's launcher CLI.

The counterpart of ``horovod_tpu/runner/launch.py`` (reference: ``horovodrun``,
runner/launch.py:286-594 argparse, :806 _run). The process model is the
reference Horovod's: ONE process per card, each joining the world through
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` (``runtime/context.init``):

- single host: ``hvdrun-torch -np N cmd`` starts N processes here (default:
  every visible card). The launcher binds the world's c10d ``TCPStore``
  itself and exports ``TORCHELASTIC_USE_AGENT_STORE=True``, so every rank
  is a store client and the store outlives any rank. ``--virtual`` is a
  CPU world of N for development: N processes on gloo, with
  ``HVD_TPU_FORCE_CPU=1`` (``init(device="cuda")`` then takes the CPU;
  without it and without a card, ``init`` raises);
- multi host: ``-H h1:4,h2:4`` starts one SSH command per slot, as the
  reference's gloo_run does (runner/gloo_run.py:116-200), with
  ``MASTER_ADDR`` the first host (its rank 0 hosts the store);
- elastic: ``--host-discovery-script`` switches to the generation launcher
  (``runner/elastic_run.py``).

Every launch is supervised (``_supervise``): a run that exits with the
resumable status (75, a preemption snapshot committed) or dies to a signal
is relaunched up to ``--auto-resume N`` / ``HOROVOD_AUTO_RESUME`` times,
with ``HVD_RESUME_ATTEMPT`` stamped on each attempt; an ordinary failure is
never retried. Of several processes, any other nonzero exit code beats
75, and 75 beats 0.

Runtime knobs are forwarded 1:1 as HOROVOD_* env vars, mirroring the
reference's flag->env convention (launch.py:356-544), for the knobs the
port reads. The JAX launcher's flags of subsystems not ported yet
(``--fusion-threshold[-mb]``, ``--cycle-time-ms``, ``--cache-capacity``,
``--autotune[-log-file]``, ``--timeline-filename``,
``--timeline-mark-cycles``: ROADMAP A.9b; ``--metrics-port``,
``--metrics-dump``: A.13b) are absent, so argparse refuses them. There is
no ``--tpu``: the TPU-pod launch has no GPU counterpart.
"""

from __future__ import annotations

import argparse
import os
import re
import shlex
import subprocess
import sys
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.version import __version__

# The ranks of a world get this long to follow the first one out before
# the launcher terminates them (a rank that failed leaves its peers
# blocked in a collective).
EXIT_GRACE_S = 30.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvdrun-torch",
        description="Launch a horovod_tpu_torch training program, one "
                    "process per card.",
        # Exact flag names only: abbreviation would defeat the config-file
        # override detection.
        allow_abbrev=False)
    p.add_argument("-v", "--version", action="version", version=__version__)
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="Number of processes (one per card). Default: "
                        "every visible card.")
    p.add_argument("--virtual", action="store_true",
                   help="A CPU world of -np processes on gloo for "
                        "development (HVD_TPU_FORCE_CPU=1; analogue of the "
                        "reference's gloo-on-localhost).")
    p.add_argument("-H", "--hosts", default=None,
                   help="Comma-separated host:slots list for a multi-host "
                        "launch over SSH (one process per slot).")
    p.add_argument("--hostfile", default=None,
                   help="File with one host:slots per line.")
    p.add_argument("--ssh-port", type=int, default=None)
    p.add_argument("--coordinator-port", type=int, default=9733,
                   help="MASTER_PORT of a multi-host launch (the first "
                        "host's rank 0 binds the store there).")
    p.add_argument("--disable-connectivity-probe", action="store_true",
                   help="Skip the pre-launch SSH probe that verifies every "
                        "host can reach the driver and auto-discovers each "
                        "host's routable address (reference "
                        "driver_service.py NIC discovery).")
    p.add_argument("--probe-timeout", type=float, default=30.0,
                   help="Seconds to wait for all connectivity probes.")
    # Elastic mode (reference launch.py:356-594 elastic group + :689
    # _run_elastic).
    p.add_argument("--min-np", type=int, default=None,
                   help="Minimum world size; elastic runs stall/abort below "
                        "this (reference --min-np).")
    p.add_argument("--max-np", type=int, default=None,
                   help="Maximum world size (reference --max-np).")
    p.add_argument("--host-discovery-script", default=None,
                   help="Executable printing one 'hostname[:slots]' per "
                        "line; polled every second (reference "
                        "--host-discovery-script).")
    p.add_argument("--slots", type=int, default=None,
                   help="Default slots per discovered host (reference "
                        "--slots).")
    p.add_argument("--start-timeout", type=float, default=60.0,
                   help="Seconds to wait for --min-np slots (reference "
                        "--start-timeout).")
    p.add_argument("--reset-limit", type=int, default=None,
                   help="Max failure-driven world resets before aborting "
                        "(reference --reset-limit).")
    p.add_argument("--elastic-local", action="store_true",
                   help="Spawn all elastic workers on this machine whatever "
                        "their hostname (each on a card of its own: "
                        "CUDA_VISIBLE_DEVICES is its index among the "
                        "machine's live workers).")
    p.add_argument("--elastic-state-dir", default=None,
                   help="Directory for committed elastic state snapshots.")
    p.add_argument("--elastic-grace-seconds", type=float, default=None,
                   help="Seconds survivors get to reach their next commit "
                        "and exit after a topology change before they are "
                        "terminated (HOROVOD_ELASTIC_GRACE_SECONDS).")
    p.add_argument("--output-filename", default=None,
                   help="Redirect each remote slot's output to "
                        "<file>.<host>.<local_rank> (reference "
                        "--output-filename).")
    # Resilience (resilience/: async checkpointing + preemption).
    p.add_argument("--auto-resume", type=int, default=None, metavar="N",
                   help="Restart the run up to N times when it exits with "
                        "the resumable status (75: preemption snapshot "
                        "committed) or dies to a signal; each restart "
                        "restores from the latest committed checkpoint in "
                        "--ckpt-dir (HOROVOD_AUTO_RESUME).")
    p.add_argument("--ckpt-dir", default=None,
                   help="Checkpoint directory for the resilience "
                        "subsystem's crash-safe snapshots "
                        "(HOROVOD_CKPT_DIR).")
    p.add_argument("--ckpt-interval", default=None,
                   help="Steps between async snapshots, or 'auto' for "
                        "CheckFreq-style cadence tuning "
                        "(HOROVOD_CKPT_INTERVAL).")
    p.add_argument("--preemption-file", default=None,
                   help="Sentinel file that triggers quiesce + final "
                        "snapshot + resumable exit when touched "
                        "(HOROVOD_PREEMPTION_FILE).")
    p.add_argument("--verbose", action="store_true")
    # Knob mirrors (reference launch.py:356-544).
    p.add_argument("--hierarchical-allreduce", action="store_true")
    p.add_argument("--torus-allreduce", action="store_true",
                   help="2D torus (local x cross) allreduce decomposition.")
    p.add_argument("--trace", action="store_true",
                   help="Enable the span tracer on every worker "
                        "(HOROVOD_TRACE=1) with a launcher-minted shared "
                        "trace id.")
    p.add_argument("--trace-dir", default=None,
                   help="Trace-artifact directory on every worker "
                        "(HOROVOD_TRACE_DIR).")
    p.add_argument("--trace-profile", default=None, metavar="SPEC",
                   help="Profile capture window, 'steps:N[@S]' "
                        "(HOROVOD_TRACE_PROFILE).")
    p.add_argument("--stall-check-disable", action="store_true")
    p.add_argument("--log-level", default=None)
    p.add_argument("--mesh-shape", default=None,
                   help="Comma-separated mesh shape, e.g. 4,2.")
    p.add_argument("--config-file", default=None,
                   help="YAML config file; explicit CLI flags win over file "
                        "values (reference --config-file).")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="Program and args to launch.")
    return p


def _check_profile_spec(spec: str) -> None:
    """'steps:N' or 'steps:N@S' (the JAX package's tracing.profile
    grammar); raises ValueError in the launcher, not in every worker."""
    s = (spec or "").strip()
    if s and s != "0" and not re.fullmatch(r"steps:(\d+)(?:@(\d+))?", s):
        raise ValueError(
            f"HOROVOD_TRACE_PROFILE={spec!r}: expected 'steps:N' or "
            f"'steps:N@S' (capture N steps starting at step S)")


def env_from_args(args) -> dict:
    """The HOROVOD_* environment of every worker: the JAX launcher's for
    the same argv (its per-run secret and trace id are minted anew)."""
    env = {}
    # Per-run random secret for worker-notification HMAC auth (the
    # reference's launcher-generated secret key). Also exported into THIS
    # process's environment so driver-side notification clients sign with
    # the same key.
    from horovod_tpu_torch.elastic.notification import SECRET_ENV, make_secret
    secret = make_secret().hex()
    env[SECRET_ENV] = secret
    os.environ[SECRET_ENV] = secret
    if args.hierarchical_allreduce:
        env["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    if args.torus_allreduce:
        env["HOROVOD_TORUS_ALLREDUCE"] = "1"
    if getattr(args, "trace", False):
        env["HOROVOD_TRACE"] = "1"
        env["HVD_TRACE_ID"] = os.urandom(8).hex()
    if getattr(args, "trace_dir", None):
        env["HOROVOD_TRACE_DIR"] = args.trace_dir
    if getattr(args, "trace_profile", None):
        _check_profile_spec(args.trace_profile)
        env["HOROVOD_TRACE_PROFILE"] = args.trace_profile
    if args.stall_check_disable:
        env["HOROVOD_STALL_CHECK_DISABLE"] = "1"
    if args.elastic_grace_seconds is not None:
        env["HOROVOD_ELASTIC_GRACE_SECONDS"] = str(args.elastic_grace_seconds)
    if args.auto_resume is not None:
        env["HOROVOD_AUTO_RESUME"] = str(args.auto_resume)
    if args.ckpt_dir:
        env["HOROVOD_CKPT_DIR"] = args.ckpt_dir
    if args.ckpt_interval is not None:
        from horovod_tpu_torch.config import _parse_ckpt_interval
        _parse_ckpt_interval(args.ckpt_interval)   # fail in the launcher
        env["HOROVOD_CKPT_INTERVAL"] = str(args.ckpt_interval)
    if args.preemption_file:
        env["HOROVOD_PREEMPTION_FILE"] = args.preemption_file
    if args.log_level:
        env["HOROVOD_LOG_LEVEL"] = args.log_level
    if args.mesh_shape:
        env["HOROVOD_TPU_MESH_SHAPE"] = args.mesh_shape
    return env


def parse_hosts(hosts: Optional[str], hostfile: Optional[str]) -> List[tuple]:
    """Parse 'h1:4,h2:4' or a hostfile into [(host, slots)]
    (reference runner/common/util/hosts.py parse_hosts)."""
    entries: List[str] = []
    if hosts:
        entries = [h.strip() for h in hosts.split(",") if h.strip()]
    elif hostfile:
        with open(hostfile) as f:
            entries = [ln.strip().replace(" slots=", ":")
                       for ln in f if ln.strip()
                       and not ln.strip().startswith("#")]
    out = []
    for e in entries:
        if ":" in e:
            host, slots = e.rsplit(":", 1)
            out.append((host, int(slots)))
        else:
            out.append((e, 1))
    return out


def rank_env(rank: int, size: int, local_rank: int, local_size: int,
             master_addr: str, master_port: int) -> Dict[str, str]:
    """The world-joining variables of one rank (as ``torchrun`` sets
    them)."""
    return {"RANK": str(rank), "WORLD_SIZE": str(size),
            "LOCAL_RANK": str(local_rank),
            "LOCAL_WORLD_SIZE": str(local_size),
            "MASTER_ADDR": master_addr, "MASTER_PORT": str(master_port)}


def bind_store(host: str = "127.0.0.1"):
    """A c10d ``TCPStore`` server bound by the launcher on a port of the
    OS's choosing (its ``.port``), for a world whose ranks are all
    clients (``TORCHELASTIC_USE_AGENT_STORE=True``)."""
    import datetime

    import torch.distributed as dist
    return dist.TCPStore(host, 0, is_master=True, wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=300))


def exit_code_of(rcs: List[int]) -> int:
    """One code for a world's exit codes: any nonzero code other than the
    resumable 75 wins, then 75, then 0 (a crashed rank is not a clean
    preemption)."""
    from horovod_tpu_torch.resilience.preemption import RESUMABLE_EXIT_CODE
    rc = 0
    saw_resumable = False
    for r in rcs:
        if r == RESUMABLE_EXIT_CODE:
            saw_resumable = True
        elif r:
            rc = rc or r
    if rc == 0 and saw_resumable:
        rc = RESUMABLE_EXIT_CODE
    return rc


def wait_world(procs: List[subprocess.Popen],
               grace_s: Optional[float] = None) -> List[int]:
    """Wait for every process; once one exits nonzero the others get
    ``grace_s`` (default ``EXIT_GRACE_S``) to exit on their own and are
    then terminated. Returns the exit codes of the processes that exited
    on their own, a terminated one's only when no process failed by
    itself."""
    grace_s = EXIT_GRACE_S if grace_s is None else grace_s
    deadline = None
    own: Dict[int, int] = {}
    while len(own) < len(procs):
        for i, p in enumerate(procs):
            if i not in own and p.poll() is not None:
                own[i] = p.returncode
                if p.returncode and deadline is None:
                    deadline = time.monotonic() + grace_s
        if deadline is not None and time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    killed = []
    for i, p in enumerate(procs):
        if i in own:
            continue
        p.terminate()
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        killed.append(p.returncode)
    rcs = [own[i] for i in sorted(own)]
    return rcs if any(rcs) else rcs + killed


def ssh_exit_code(rc: int) -> int:
    """A slot's exit code as ``_supervise`` reads it. ``ssh`` reports a
    remote command killed by signal N as 128+N, and a lost connection
    (the host died or went away) as 255; both become a death by a signal
    (-N, and -SIGHUP for 255), so a preempted host is relaunched as a
    local one is."""
    import signal
    if rc == 255:
        return -signal.SIGHUP
    if 128 < rc <= 128 + 64:
        return 128 - rc
    return rc


def _command(args) -> Optional[List[str]]:
    cmd = list(args.command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("hvdrun-torch: no command given", file=sys.stderr)
        return None
    return cmd


def _launch_local(args, extra_env: dict) -> int:
    """``-np N`` processes on this host, ranks 0..N-1 (card = LOCAL_RANK),
    over a store the launcher binds anew for every attempt."""
    cmd = _command(args)
    if cmd is None:
        return 2
    base = dict(os.environ)
    base.update(extra_env)
    if args.virtual:
        np_ = args.num_proc or 8
        base["HVD_TPU_FORCE_CPU"] = "1"
    else:
        import torch
        np_ = args.num_proc or max(torch.cuda.device_count(), 1)
    base["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    base["TORCHELASTIC_RESTART_COUNT"] = "0"
    if args.verbose:
        print(f"hvdrun-torch: {np_} x {shlex.join(cmd)}", file=sys.stderr)

    def run_once(attempt: int) -> int:
        store = bind_store()
        procs = []
        try:
            for r in range(np_):
                env = dict(base)
                env.update(rank_env(r, np_, r, np_, "127.0.0.1",
                                    store.port))
                env["HVD_RESUME_ATTEMPT"] = str(attempt)
                procs.append(subprocess.Popen(cmd, env=env))
            return exit_code_of(wait_world(procs))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            del store

    return _supervise(run_once, args)


def _supervise(run_once, args) -> int:
    """Auto-resume supervision (resilience/preemption.py contract): a run
    exiting with the resumable status (75) committed a final snapshot on
    purpose; a signal death (negative rc) may have one from the async
    cadence. Either way the command is relaunched — workers restore from
    the latest committed checkpoint in HOROVOD_CKPT_DIR — up to
    --auto-resume/HOROVOD_AUTO_RESUME times, with HVD_RESUME_ATTEMPT
    stamped per attempt. Ordinary failures (tracebacks, bad flags) are
    NOT retried: they are deterministic bugs, not preemptions."""
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.resilience.preemption import RESUMABLE_EXIT_CODE
    auto_resume = args.auto_resume if args.auto_resume is not None else \
        int(knobs.get("HOROVOD_AUTO_RESUME"))
    attempt = 0
    while True:
        rc = run_once(attempt)
        resumable = rc == RESUMABLE_EXIT_CODE or rc < 0
        if rc == 0 or not resumable or attempt >= auto_resume:
            return rc
        attempt += 1
        how = "resumable" if rc > 0 else "to a signal"
        print(f"hvdrun-torch: run exited {how} (rc={rc}); auto-resume "
              f"attempt {attempt}/{auto_resume}", file=sys.stderr)


def _launch_multihost(args, hosts: List[tuple], extra_env: dict) -> int:
    """One process per slot over SSH (reference gloo_run.py
    _exec_command_fn:116-200); the first host's rank 0 hosts the store
    at ``--coordinator-port``."""
    cmd = _command(args)
    if cmd is None:
        return 2
    from horovod_tpu_torch.elastic.notification import SECRET_ENV
    master = hosts[0][0]
    size = sum(s for _, s in hosts)
    # Verify every host is reachable and learn each host's routable
    # address BEFORE spawning anything (ref HorovodRunDriverService NIC
    # discovery, runner/driver/driver_service.py:30,162,218).
    advertise: dict = {}
    if not args.disable_connectivity_probe:
        from horovod_tpu_torch.runner.probe import probe_hosts
        advertise = probe_hosts([h for h, _ in hosts],
                                ssh_port=args.ssh_port,
                                timeout=args.probe_timeout)
        if args.verbose:
            print(f"hvdrun-torch: probe learned addresses {advertise}",
                  file=sys.stderr)
    cwd = os.getcwd()

    def _spawn_slots(attempt, procs, logs) -> None:
        rank = 0
        for i, (host, slots) in enumerate(hosts):
            for local in range(slots):
                env_pairs = dict(extra_env)
                env_pairs.update(rank_env(rank, size, local, slots, master,
                                          args.coordinator_port))
                env_pairs["HVD_RESUME_ATTEMPT"] = str(attempt)
                if i in advertise and \
                        "HVD_TPU_ADVERTISE_HOST" not in env_pairs:
                    env_pairs["HVD_TPU_ADVERTISE_HOST"] = advertise[i]
                # The HMAC secret must NOT appear on the remote command
                # line (any local user could read it from the process
                # list); ship it on the ssh stdin instead.
                secret = env_pairs.pop(SECRET_ENV, None)
                env_str = " ".join(f"{k}={shlex.quote(v)}"
                                   for k, v in env_pairs.items())
                remote = (f"cd {shlex.quote(cwd)} && env {env_str} "
                          f"{shlex.join(cmd)}")
                if secret is not None:
                    remote = (f"read -r {SECRET_ENV} && export "
                              f"{SECRET_ENV} && " + remote)
                ssh = ["ssh"]
                if args.ssh_port:
                    ssh += ["-p", str(args.ssh_port)]
                full = ssh + [host, remote]
                if args.verbose:
                    print(f"hvdrun-torch: {shlex.join(full)}",
                          file=sys.stderr)
                stdout = None
                if args.output_filename:
                    stdout = open(f"{args.output_filename}.{host}.{local}",
                                  "wb")
                    logs.append(stdout)
                p = subprocess.Popen(
                    full, stdout=stdout,
                    stderr=subprocess.STDOUT if stdout else None,
                    stdin=subprocess.PIPE if secret is not None else None)
                if secret is not None:
                    p.stdin.write((secret + "\n").encode())
                    p.stdin.flush()
                procs.append(p)
                rank += 1


    def run_once(attempt: int) -> int:
        procs: List[subprocess.Popen] = []
        logs = []
        try:
            _spawn_slots(attempt, procs, logs)
            # A dead rank leaves its peers blocked in NCCL: the same
            # waiting rule as the local launch, on the slots' codes as
            # ssh reports them.
            return exit_code_of([ssh_exit_code(rc)
                                 for rc in wait_world(procs)])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()

    return _supervise(run_once, args)


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config_file:
        from horovod_tpu_torch.runner.config_file import (
            cli_overrides, load_config_file, set_args_from_config)
        raw_argv = sys.argv[1:] if argv is None else argv
        set_args_from_config(
            parser, args, load_config_file(args.config_file),
            cli_overrides(parser, raw_argv, args.command))
    extra_env = env_from_args(args)
    if args.host_discovery_script:
        if args.min_np is None:
            print("hvdrun-torch: elastic mode requires --min-np",
                  file=sys.stderr)
            return 2
        from horovod_tpu_torch.runner.elastic_run import launch_elastic
        return launch_elastic(args, extra_env)
    hosts = parse_hosts(args.hosts, args.hostfile)
    if hosts:
        return _launch_multihost(args, hosts, extra_env)
    return _launch_local(args, extra_env)


if __name__ == "__main__":
    sys.exit(main())
