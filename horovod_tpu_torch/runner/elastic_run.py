"""Elastic launcher: ``hvdrun-torch --min-np N --max-np M
--host-discovery-script d.sh -- python train.py``.

The counterpart of ``horovod_tpu/runner/elastic_run.py`` (reference:
``_run_elastic``, runner/launch.py:689 -> ``launch_gloo_elastic``,
runner/gloo_run.py:303): a discovery thread polls the script, computes
rank-preserving assignments, launches one worker per slot, pushes
HostsUpdated notifications, blacklists failing hosts, and re-forms the
world on membership changes.

The reset protocol — **generations**, as in the JAX package: the world is
re-formed by CONTROLLED RESTART. torch could re-form a world in process,
but an NCCL communicator whose peer died can hang in
``destroy_process_group``; the respawn is the safe path and the
reference's contract.

1. workers run with generation-stamped env (``RANK``, ``WORLD_SIZE``,
   ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``
   of a ``TCPStore`` the launcher binds anew for the generation, with
   ``TORCHELASTIC_USE_AGENT_STORE=True`` so every rank is a client) and
   commit state to an on-disk store (``elastic/state.py``) at every
   ``state.commit()``;
2. on a membership change the launcher pushes HostsUpdated to every worker
   (WorkerNotificationClient; a push that fails is mirrored into the
   generation's store, where ``State.check_host_updates`` finds it); at
   its next commit each worker exits with RESTART_EXIT_CODE (73);
3. the launcher reaps the generation, recomputes assignments (ranks
   preserved for surviving hosts, ``assign_slots``), and spawns
   generation+1 — workers restore committed state and continue the epoch
   (ElasticSampler repartitions only unprocessed samples);
4. a worker crash (any other nonzero exit) blacklists its host
   (exponential-backoff cooldown) first, then follows the same path, so
   the job survives as long as >= min_np slots remain; a worker that
   exits 75 (preemption) re-forms the world without a blacklist.

Workers spawned on this machine each get ``CUDA_VISIBLE_DEVICES`` = their
index among the machine's live workers of the generation (under
``--elastic-local`` every fake host's worker has ``LOCAL_RANK`` 0, and
NCCL refuses two ranks on one card); ``init`` takes ``cuda:0`` of what it
sees.
"""

from __future__ import annotations

import json
import os
import shlex
import socket
import socketserver
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.elastic.discovery import (HostDiscoveryScript,
                                                 HostManager,
                                                 HostUpdateResult)
from horovod_tpu_torch.elastic.driver import SlotInfo, assign_slots
from horovod_tpu_torch.elastic.notification import (SECRET_ENV,
                                                    WorkerNotificationClient,
                                                    make_secret, _sign)
from horovod_tpu_torch.elastic.worker import (ENV_DRIVER_ADDR, ENV_HOSTNAME,
                                              ENV_LOCAL_RANK, ENV_RUN,
                                              ENV_STATE_DIR,
                                              RESTART_EXIT_CODE)
from horovod_tpu_torch.resilience.preemption import RESUMABLE_EXIT_CODE
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.elastic_run")

LOCAL_HOSTS = {"localhost", "127.0.0.1"}


class DriverService:
    """Launcher-side registration endpoint (ref runner/elastic/registration
    + worker notification bookkeeping): workers register their notification
    address and readiness over signed JSON/TCP."""

    def __init__(self, secret: bytes):
        self._secret = secret
        self._lock = threading.Lock()
        # (hostname, local_rank) -> (notif_host, notif_port)
        self.notification_addrs: Dict[Tuple[str, int], Tuple[str, int]] = {}
        self.ready: Dict[Tuple[str, int], bool] = {}
        self._server: Optional[socketserver.ThreadingTCPServer] = None

    def start(self) -> Tuple[str, int]:
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                line = self.rfile.readline()
                if not line:
                    return
                try:
                    msg = json.loads(line)
                    payload = json.dumps(msg["payload"]).encode()
                    import hmac as _hmac
                    if not _hmac.compare_digest(
                            _sign(outer._secret, payload),
                            msg.get("sig", "")):
                        return
                    p = msg["payload"]
                    key = (p["hostname"], int(p["local_rank"]))
                    with outer._lock:
                        if p.get("type") == "register":
                            outer.notification_addrs[key] = (
                                p["notif_host"], int(p["notif_port"]))
                        elif p.get("type") == "ready":
                            outer.ready[key] = True
                    self.wfile.write(b'{"ok": true}\n')
                except Exception:
                    self.wfile.write(b'{"ok": false}\n')

        self._server = socketserver.ThreadingTCPServer(("0.0.0.0", 0),
                                                       Handler)
        self._server.daemon_threads = True
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self._server.server_address

    def clear_generation(self) -> None:
        with self._lock:
            self.notification_addrs.clear()
            self.ready.clear()

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()


class _WorkerProc:
    def __init__(self, slot: SlotInfo, proc: subprocess.Popen):
        self.slot = slot
        self.proc = proc


class ElasticLauncher:
    """Generation loop (see module docstring)."""

    def __init__(self, command: List[str], discovery, min_np: int,
                 max_np: Optional[int] = None, start_timeout: float = 60.0,
                 reset_limit: Optional[int] = None,
                 force_local_spawn: bool = False,
                 state_dir: Optional[str] = None,
                 worker_env: Optional[Dict[str, str]] = None,
                 ssh_port: Optional[int] = None,
                 verbose: bool = False,
                 probe: bool = True,
                 probe_timeout: float = 30.0):
        self.command = command
        self.min_np = min_np
        self.max_np = max_np
        self.start_timeout = start_timeout
        self.reset_limit = reset_limit
        self.force_local_spawn = force_local_spawn
        self.state_dir = state_dir or os.path.join(
            os.getcwd(), ".hvd_elastic_state")
        self.worker_env = dict(worker_env or {})
        self.ssh_port = ssh_port
        self.verbose = verbose
        self.probe = probe
        self.probe_timeout = probe_timeout
        self.host_manager = HostManager(discovery)
        secret_hex = os.environ.get(SECRET_ENV)
        self._secret = bytes.fromhex(secret_hex) if secret_hex \
            else make_secret()
        os.environ[SECRET_ENV] = self._secret.hex()
        self.driver_service = DriverService(self._secret)
        self.generation = 0
        self.world_size_history: List[int] = []
        self._topology_changed = threading.Event()
        self._stop_discovery = threading.Event()
        # the generation's c10d store (bound by run())
        self._store = None
        self.virtual = False

    # -- discovery thread ---------------------------------------------------
    def _discovery_loop(self) -> None:
        while not self._stop_discovery.is_set():
            try:
                res = self.host_manager.update_available_hosts()
            except Exception:
                logger.exception("host discovery failed")
                res = HostUpdateResult.NO_UPDATE
            if res != HostUpdateResult.NO_UPDATE:
                logger.info("topology change detected (%d)", res)
                self._topology_changed.set()
                self._notify_workers(res)
            self._stop_discovery.wait(1.0)

    def _notify_workers(self, res: int) -> None:
        ts = time.time()
        dropped = 0
        for addr in list(self.driver_service.notification_addrs.values()):
            if not WorkerNotificationClient(addr, secret=self._secret) \
                    .notify_hosts_updated(ts, res):
                dropped += 1
        if dropped:
            self._mirror_hosts_updated(ts, res)

    def _mirror_hosts_updated(self, ts: float, res: int) -> None:
        """A push failed: mirror the event into the generation's store
        (the key ``ElasticDriver._mirror_hosts_updated_kv`` writes), where
        a worker's ``State.check_host_updates`` finds it at its next
        commit (``distributed_kv(root=True)``: the server's own keys).
        Best effort."""
        store = self._store
        if store is None:
            return
        try:
            store.set(
                "hvd/elastic/hosts_updated",
                json.dumps({"timestamp": ts, "res": int(res),
                            "wall_time": time.time()}))
        except Exception:
            logger.warning("hosts-updated store mirror failed",
                           exc_info=True)

    # -- spawn --------------------------------------------------------------
    def _is_local(self, hostname: str) -> bool:
        return (self.force_local_spawn or hostname in LOCAL_HOSTS
                or hostname == socket.gethostname())

    def _probe_generation(self, slots) -> Optional[Dict[str, str]]:
        """Verify every remote host of this generation is reachable BEFORE
        spawning (ref HorovodRunDriverService probing ahead of each launch,
        driver_service.py:30,162) and learn per-host advertise addresses.
        Unreachable hosts are blacklisted (exponential-backoff cooldown,
        like a crashed worker's host) and the generation is re-planned —
        returns None in that case."""
        remote = sorted({s.hostname for s in slots
                         if not self._is_local(s.hostname)})
        if not remote or not self.probe:
            return {}
        from horovod_tpu_torch.runner.probe import (
            ProbeError, driver_candidate_addresses, probe_hosts)
        try:
            got = probe_hosts(remote, ssh_port=self.ssh_port,
                              timeout=self.probe_timeout,
                              secret=self._secret)
        except ProbeError as e:
            for host in e.failed_hosts:
                self.host_manager.blacklist(host)
            print(f"hvdrun-torch[elastic]: blacklisting unreachable "
                  f"{e.failed_hosts}: {e}", file=sys.stderr)
            return None
        except Exception as e:
            # Launcher-side failures spawning the probe itself (OSError
            # from ssh exec, resource exhaustion, ...) must count as a
            # failed generation against --reset-limit, not abort the whole
            # elastic loop — they are often transient. Nothing is
            # blacklisted: no specific host was proven bad.
            print(f"hvdrun-torch[elastic]: probe failed "
                  f"({type(e).__name__}: {e}); retrying generation",
                  file=sys.stderr)
            return None
        advertise = {remote[i]: addr for i, addr in got.items()}
        # In a mixed local+remote world the driver-host workers need an
        # advertise address too (the static path probes every host): use
        # the driver's default-route interface.
        local_hosts = {s.hostname for s in slots
                       if self._is_local(s.hostname)}
        if local_hosts:
            def _is_ipv4(a):
                import socket as _s
                try:
                    _s.inet_aton(a)
                    return a.count(".") == 3
                except OSError:
                    return False
            own = next((a for a in driver_candidate_addresses()
                        if _is_ipv4(a) and not a.startswith("127.")),
                       None)
            if own:
                for host in local_hosts:
                    advertise[host] = own
        return advertise

    def _spawn_worker(self, slot: SlotInfo, master: str,
                      driver_addr: str,
                      advertise: Optional[str] = None,
                      card: Optional[str] = None) -> _WorkerProc:
        from horovod_tpu_torch.runner.launch import rank_env
        addr, port = master.rsplit(":", 1)
        env = {
            **self.worker_env,
            ENV_RUN: "1",
            ENV_DRIVER_ADDR: driver_addr,
            ENV_HOSTNAME: slot.hostname,
            ENV_LOCAL_RANK: str(slot.local_rank),
            ENV_STATE_DIR: self.state_dir,
            SECRET_ENV: self._secret.hex(),
            **rank_env(slot.rank, slot.size, slot.local_rank,
                       slot.local_size, addr, int(port)),
            "TORCHELASTIC_USE_AGENT_STORE": "True",
            "TORCHELASTIC_RESTART_COUNT": "0",
            "HVD_ELASTIC_GENERATION": str(self.generation),
            "HVD_RESUME_ATTEMPT": str(self.generation - 1),
            "HOROVOD_ELASTIC": "1",
        }
        if advertise and "HVD_TPU_ADVERTISE_HOST" not in env:
            env["HVD_TPU_ADVERTISE_HOST"] = advertise
        if self._is_local(slot.hostname):
            full_env = dict(os.environ)
            full_env.update(env)
            if card is not None:
                full_env["CUDA_VISIBLE_DEVICES"] = card
            proc = subprocess.Popen(self.command, env=full_env)
        else:
            env_no_secret = {k: v for k, v in env.items()
                             if k != SECRET_ENV}
            env_str = " ".join(f"{k}={shlex.quote(v)}"
                               for k, v in env_no_secret.items())
            remote = (f"read -r {SECRET_ENV} && export {SECRET_ENV} && "
                      f"cd {shlex.quote(os.getcwd())} && env {env_str} "
                      f"{shlex.join(self.command)}")
            ssh = ["ssh"] + (["-p", str(self.ssh_port)]
                             if self.ssh_port else [])
            proc = subprocess.Popen(ssh + [slot.hostname, remote],
                                    stdin=subprocess.PIPE)
            proc.stdin.write((self._secret.hex() + "\n").encode())
            proc.stdin.flush()
        if self.verbose:
            print(f"hvdrun-torch[elastic]: gen {self.generation} rank "
                  f"{slot.rank}/{slot.size} on {slot.hostname} "
                  f"(pid {proc.pid})", file=sys.stderr)
        return _WorkerProc(slot, proc)

    # -- generation loop ----------------------------------------------------
    def run(self) -> int:
        os.makedirs(self.state_dir, exist_ok=True)
        driver_host, driver_port = self.driver_service.start()
        host = (socket.gethostname() if driver_host == "0.0.0.0"
                else driver_host)
        driver_addr = f"{host}:{driver_port}"
        if self.force_local_spawn:
            driver_addr = f"127.0.0.1:{driver_port}"
        # initial discovery + min_np gate (ref wait_for_available_slots)
        deadline = time.monotonic() + self.start_timeout
        while True:
            self.host_manager.update_available_hosts()
            if self.host_manager.available_slots >= self.min_np:
                break
            if time.monotonic() >= deadline:
                print(f"hvdrun-torch[elastic]: timed out waiting for "
                      f"{self.min_np} slots "
                      f"(have {self.host_manager.available_slots})",
                      file=sys.stderr)
                return 124
        threading.Thread(target=self._discovery_loop, daemon=True).start()
        resets = 0
        try:
            while True:
                self._topology_changed.clear()
                self.driver_service.clear_generation()
                self.generation += 1
                hosts = self.host_manager.current_hosts
                order = self.host_manager.host_assignment_order
                slots = assign_slots(order, hosts, self.max_np)
                if len(slots) < self.min_np:
                    # below min capacity: wait for cooldown expiry / new
                    # hosts, up to start_timeout
                    ok = self._wait_for_capacity()
                    if not ok:
                        print("hvdrun-torch[elastic]: capacity below "
                              "--min-np and no recovery; aborting",
                              file=sys.stderr)
                        return 1
                    continue
                advertise = self._probe_generation(slots)
                if advertise is None:
                    # A host was blacklisted: re-plan the generation with
                    # the reduced host set (min-np gate re-applies above).
                    # A probe failure counts against --reset-limit like a
                    # failed generation — a permanently unreachable host
                    # resurrecting from cooldown must not churn forever.
                    resets += 1
                    if self.reset_limit is not None and \
                            resets > self.reset_limit:
                        print(f"hvdrun-torch[elastic]: reset limit "
                              f"{self.reset_limit} exceeded",
                              file=sys.stderr)
                        return 1
                    continue
                self.world_size_history.append(len(slots))
                # the generation's store, bound here so it outlives any
                # rank; its port is the generation's MASTER_PORT
                from horovod_tpu_torch.runner.launch import bind_store
                self._store = None
                self._store = bind_store("0.0.0.0")
                store_host = ("127.0.0.1" if all(
                    self._is_local(s.hostname) for s in slots)
                    else driver_addr.rsplit(":", 1)[0])
                master = f"{store_host}:{self._store.port}"
                cards = self._local_cards(slots)
                workers = [self._spawn_worker(
                    s, master, driver_addr, advertise.get(s.hostname),
                    cards.get(s.rank)) for s in slots]
                outcome = self._reap_generation(workers)
                if outcome == "done":
                    return 0
                if outcome == "failed":
                    resets += 1
                if self.reset_limit is not None and \
                        resets > self.reset_limit:
                    print(f"hvdrun-torch[elastic]: reset limit "
                          f"{self.reset_limit} exceeded", file=sys.stderr)
                    return 1
        finally:
            self._stop_discovery.set()
            self.driver_service.stop()
            self._store = None

    def _local_cards(self, slots) -> Dict[int, str]:
        """rank -> CUDA_VISIBLE_DEVICES of every slot spawned on this
        machine: its index among the generation's local workers, mapped
        through the launcher's own CUDA_VISIBLE_DEVICES when set. None
        under --virtual (a CPU world)."""
        if self.virtual:
            return {}
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        names = [v.strip() for v in visible.split(",")] if visible \
            else None
        local = [s for s in slots if self._is_local(s.hostname)]
        out = {}
        for i, s in enumerate(local):
            if names is not None and i >= len(names):
                raise RuntimeError(
                    f"{len(local)} workers on this machine but "
                    f"CUDA_VISIBLE_DEVICES={visible!r} lists "
                    f"{len(names)} cards")
            out[s.rank] = names[i] if names is not None else str(i)
        return out

    def _wait_for_capacity(self) -> bool:
        deadline = time.monotonic() + self.start_timeout
        while time.monotonic() < deadline:
            self.host_manager.update_available_hosts()
            if self.host_manager.available_slots >= self.min_np:
                return True
            time.sleep(0.2)
        return False

    def _reap_generation(self, workers: List[_WorkerProc]) -> str:
        """Wait for the generation to end. Returns 'done' (all ranks exit
        0), 'restart' (voluntary re-rendezvous or terminated stragglers),
        or 'failed' (crash -> blacklist). A topology change racing with a
        fully-successful generation does NOT force a spurious restart."""
        crashed = False
        restarting = False
        terminated = False
        live = list(workers)
        grace_deadline: Optional[float] = None
        while live:
            for w in list(live):
                rc = w.proc.poll()
                if rc is None:
                    continue
                live.remove(w)
                if rc == 0:
                    continue
                if rc == RESTART_EXIT_CODE:
                    restarting = True
                    continue
                if rc == RESUMABLE_EXIT_CODE:
                    # Preemption quiesce (resilience/preemption.py): the
                    # worker committed a final snapshot and exited on
                    # purpose. Re-form the world WITHOUT blacklisting —
                    # the host is being maintenance-evicted, it did not
                    # fail; discovery drops it when it actually goes.
                    logger.info("worker rank %d on %s exited resumable "
                                "(preemption snapshot committed)",
                                w.slot.rank, w.slot.hostname)
                    restarting = True
                    continue
                crashed = True
                logger.warning("worker rank %d on %s crashed (rc=%d); "
                               "blacklisting host", w.slot.rank,
                               w.slot.hostname, rc)
                self.host_manager.blacklist(w.slot.hostname)
                self._topology_changed.set()
                self._notify_workers(HostUpdateResult.REMOVED)
            if live and (crashed or restarting
                         or self._topology_changed.is_set()):
                # Survivors get a grace window to reach their next commit
                # and exit voluntarily; stragglers are then terminated.
                if grace_deadline is None:
                    from horovod_tpu_torch.config import knobs
                    grace_deadline = time.monotonic() + float(
                        knobs.get("HOROVOD_ELASTIC_GRACE_SECONDS"))
                elif time.monotonic() >= grace_deadline:
                    for w in live:
                        terminated = True
                        w.proc.terminate()
                        try:
                            w.proc.wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            w.proc.kill()
                    live = []
                    break
            time.sleep(0.05)
        if crashed:
            return "failed"
        if restarting or terminated:
            return "restart"
        return "done"


def launch_elastic(args, extra_env: Dict[str, str]) -> int:
    """CLI entry (ref launch.py:689 _run_elastic)."""
    cmd = list(args.command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("hvdrun-torch: no command given", file=sys.stderr)
        return 2
    discovery = HostDiscoveryScript(args.host_discovery_script,
                                    default_slots=args.slots or 1)
    if args.elastic_grace_seconds is not None:
        # the grace window is the launcher's own (the JAX launcher only
        # forwards the flag to the workers, where nothing reads it)
        from horovod_tpu_torch.config import knobs
        knobs.set_override("HOROVOD_ELASTIC_GRACE_SECONDS",
                           float(args.elastic_grace_seconds))
    if args.virtual:
        # a CPU worker per slot on gloo (the static launcher's --virtual):
        # the dev/CI path where discovery hosts are localhost aliases
        extra_env = {**extra_env, "HVD_TPU_FORCE_CPU": "1"}
    launcher = ElasticLauncher(
        cmd, discovery,
        min_np=args.min_np,
        max_np=args.max_np,
        start_timeout=args.start_timeout,
        reset_limit=args.reset_limit,
        force_local_spawn=args.elastic_local,
        state_dir=args.elastic_state_dir,
        worker_env=extra_env,
        ssh_port=args.ssh_port,
        verbose=args.verbose,
        probe=not getattr(args, "disable_connectivity_probe", False),
        probe_timeout=getattr(args, "probe_timeout", 30.0))
    launcher.virtual = bool(args.virtual)
    return launcher.run()
