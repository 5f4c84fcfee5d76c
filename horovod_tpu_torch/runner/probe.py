"""Pre-launch connectivity probe for multi-host runs (the port's copy of
``horovod_tpu/runner/probe.py``).

Reference parity: before spawning workers, ``horovodrun`` SSHes a tiny task
service onto every host, verifies it can be reached, and discovers the set
of routable interfaces (HorovodRunDriverService,
runner/driver/driver_service.py:30; ``_driver_fn`` :162,
``get_common_interfaces`` :218); its task services authenticate with the
launcher-generated secret (runner/common/util/secret.py).

The form: the driver opens ONE TCP probe server; each host runs a
stdlib-only probe over SSH that connects BACK to the driver (trying every
candidate driver address in order), reports its hostname, and learns which
of ITS OWN interfaces routes to the driver — ``getsockname()`` on the
connected socket. That address becomes the host's
``HVD_TPU_ADVERTISE_HOST`` (the data-service registry and workers of
``data/compute_service.py`` read it), with no manual env
preparation. Reports are HMAC-signed with the per-run secret
(shipped on the probe's ssh stdin, never the command line) so a network
peer cannot spoof a host's advertise address or fake a dead host's
liveness during the launch window. A host that cannot connect fails the
launch BEFORE any worker is spawned, with the ssh error attached.
"""

from __future__ import annotations

import hmac
import hashlib
import json
import shlex
import socket
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

# Runs on the remote host: argv = idx, port, candidate driver addresses;
# the signing secret arrives as one hex line on stdin.
_CLIENT_CODE = r"""
import hashlib, hmac, json, socket, sys
idx, port = int(sys.argv[1]), int(sys.argv[2])
secret = bytes.fromhex(sys.stdin.readline().strip())
last = None
for addr in sys.argv[3:]:
    try:
        s = socket.create_connection((addr, port), timeout=5)
    except OSError as e:
        last = e
        continue
    msg = {"index": idx, "local_ip": s.getsockname()[0],
           "hostname": socket.gethostname()}
    body = json.dumps(msg, sort_keys=True)
    mac = hmac.new(secret, body.encode(), hashlib.sha256).hexdigest()
    s.sendall((json.dumps({"body": body, "mac": mac}) + "\n").encode())
    s.recv(16)
    s.close()
    sys.exit(0)
sys.exit(f"probe: no driver address reachable of {sys.argv[3:]}: {last}")
""".strip()


def driver_candidate_addresses() -> List[str]:
    """Addresses a worker might reach this driver at, best-first: the
    default-route interface, the hostname and its A records, loopback last
    (single-machine / localhost-alias setups)."""
    addrs: List[str] = []
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("8.8.8.8", 53))     # routing lookup only; nothing sent
        addrs.append(s.getsockname()[0])
        s.close()
    except OSError:
        pass
    try:
        host = socket.gethostname()
        addrs.append(host)
        for info in socket.getaddrinfo(host, None, socket.AF_INET):
            addrs.append(info[4][0])
    except OSError:
        pass
    addrs.append("127.0.0.1")
    seen: set = set()
    return [a for a in addrs if not (a in seen or seen.add(a))]


class ProbeError(RuntimeError):
    """Connectivity probe failure; ``failed_hosts`` names the hosts that
    never produced a verified report (so callers — e.g. the elastic
    launcher — can blacklist them instead of string-parsing)."""

    def __init__(self, message: str, failed_hosts: List[str]):
        super().__init__(message)
        self.failed_hosts = list(failed_hosts)


class ProbeServer:
    """Collects one HMAC-verified report per host index on an ephemeral
    port; unauthenticated or tampered reports are dropped (the prober just
    keeps waiting — a spoofer cannot place an address or fake liveness)."""

    def __init__(self, expected: int, secret: bytes):
        self.expected = expected
        self._secret = secret
        self._sock = socket.create_server(("0.0.0.0", 0))
        self._sock.settimeout(0.25)
        self.port = self._sock.getsockname()[1]
        self.results: Dict[int, dict] = {}
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop.is_set() and not self._done.is_set():
            try:
                conn, peer = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn.settimeout(5)
                data = b""
                while not data.endswith(b"\n") and len(data) < 65536:
                    chunk = conn.recv(4096)
                    if not chunk:
                        break
                    data += chunk
                envelope = json.loads(data.decode())
                body, mac = envelope["body"], envelope["mac"]
                want = hmac.new(self._secret, body.encode(),
                                hashlib.sha256).hexdigest()
                if not hmac.compare_digest(mac, want):
                    continue                      # spoofed: drop silently
                msg = json.loads(body)
                msg["peer_ip"] = peer[0]
                with self._lock:
                    self.results[int(msg["index"])] = msg
                    if len(self.results) >= self.expected:
                        self._done.set()
                conn.sendall(b"ok\n")
            except Exception:
                pass
            finally:
                conn.close()

    def wait(self, timeout: float) -> bool:
        return self._done.wait(timeout)

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


def _default_argv_fn(ssh_port: Optional[int], local: bool
                     ) -> Callable[[str, List[str]], List[str]]:
    def argv_fn(host: str, client_argv: List[str]) -> List[str]:
        if local:
            return ["python3", "-c", _CLIENT_CODE] + client_argv
        ssh = ["ssh"]
        if ssh_port:
            ssh += ["-p", str(ssh_port)]
        remote = "python3 -c " + shlex.quote(_CLIENT_CODE) + " " \
            + shlex.join(client_argv)
        return ssh + [host, remote]
    return argv_fn


def probe_hosts(hosts: List[str], ssh_port: Optional[int] = None,
                timeout: float = 30.0, local: bool = False,
                secret: Optional[bytes] = None,
                argv_fn: Optional[Callable] = None) -> Dict[int, str]:
    """Probe every host; returns {host_index: advertise_address}.

    ``local`` runs the probes in local subprocesses instead of ssh (the
    ``--elastic-local`` analogue for tests / single-machine runs).
    ``secret`` signs the reports (defaults to the per-run notification
    secret). Raises RuntimeError naming every host that failed, each with
    its own evidence (probe exit output vs no-response-within-timeout) —
    the launch must fail fast BEFORE workers spawn (ref driver_service
    connectivity check)."""
    if secret is None:
        from horovod_tpu_torch.elastic.notification import resolve_secret
        secret = resolve_secret()
    server = ProbeServer(expected=len(hosts), secret=secret)
    argv_fn = argv_fn or _default_argv_fn(ssh_port, local)
    addrs = driver_candidate_addresses()
    procs = []
    try:
        for i, host in enumerate(hosts):
            client_argv = [str(i), str(server.port)] + addrs
            p = subprocess.Popen(
                argv_fn(host, client_argv), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            try:
                p.stdin.write((secret.hex() + "\n").encode())
                p.stdin.flush()
                p.stdin.close()
            except OSError:
                pass                     # already dead; reported below
            procs.append(p)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if server.wait(0.25):
                break
            # Every probe has exited: nothing more can arrive. Give the
            # server a beat to drain reports already in flight, then stop —
            # but never cut off probes still running (a slow ssh handshake
            # on one host must not get blamed for another's failure).
            if all(p.poll() is not None for p in procs):
                time.sleep(0.5)
                break
        with server._lock:
            results = dict(server.results)
        missing = [i for i in range(len(hosts)) if i not in results]
        if missing:
            details = []
            for i in missing:
                rc = procs[i].poll()
                out = b""
                try:
                    out, _ = procs[i].communicate(timeout=2)
                except Exception:
                    procs[i].kill()
                text = out.decode(errors="replace").strip()
                if rc not in (None, 0):
                    details.append(f"  {hosts[i]}: probe exited {rc}: "
                                   f"{text or 'no output'}")
                else:
                    details.append(f"  {hosts[i]}: no report within "
                                   f"{timeout:.0f}s"
                                   + (f": {text}" if text else ""))
            raise ProbeError(
                "connectivity probe failed for "
                f"{[hosts[i] for i in missing]} — not launching:\n"
                + "\n".join(details),
                failed_hosts=[hosts[i] for i in missing])
        return {i: results[i]["local_ip"] for i in results}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.close()
