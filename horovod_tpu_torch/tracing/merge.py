"""Cross-rank trace merge over the c10d store.

The counterpart of ``horovod_tpu/tracing/merge.py``: every rank publishes
its span summary (ring-buffer contents plus the wall-clock anchor of its
perf epoch) under ``hvd/trace/p<i>``; rank 0 pulls whatever is present,
estimates each rank's clock offset, shifts the spans onto its own
timeline, and writes ONE Perfetto-loadable file with a track (pid and
``process_name`` metadata naming the host) per rank.

Clock offsets: span timestamps are perf-counter microseconds relative to
each process's epoch; the epoch's ``time.time()`` value is the anchor.
``offset(follower) = follower.epoch_unix - leader.epoch_unix`` aligns
the timelines to wall-clock accuracy (NTP-disciplined hosts: single-digit
ms; the ranks of one host share a clock). Per-rank durations are exact,
they never cross clocks. The estimate is recorded in the merged file's
metadata. The store is ``utils/kvstore.distributed_kv(site="trace_merge")``:
the ``trace_merge`` site's retry policy, its chaos faults, and, when the
fault domain has shed it, a local-only trace instead.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Dict, List, Optional

from horovod_tpu_torch.tracing import spans as _spans
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.tracing")

_KV_PREFIX = "hvd/trace"

# Shutdown-time budget for followers that have not published yet: the
# leader commonly reaches shutdown() first, so a purely non-blocking
# collect would routinely produce a leader-only "merged" file.
_SHUTDOWN_WAIT_S = 5.0


def _key(idx: int) -> str:
    return f"{_KV_PREFIX}/p{idx}"


def publish(kv, process_index: int) -> None:
    """Publish this process's span summary (overwriting an earlier one).
    A chaos ``clock_skew`` clause shifts this rank's wall-clock epoch
    anchor (the NTP-drift drill): the merged file's offset estimation
    must absorb it."""
    summary = _spans.summary(process_index)
    from horovod_tpu_torch.resilience import chaos
    skew = chaos.clock_skew_s()
    if skew:
        summary = dict(summary)
        summary["epoch_unix"] = float(summary["epoch_unix"]) + skew
    kv.set(_key(process_index), json.dumps(summary), overwrite=True)


def collect(kv, process_count: int,
            local_index: int = 0,
            wait_s: float = 0.0) -> List[Dict[str, Any]]:
    """Leader side: every published summary, the local one taken
    directly. ``wait_s`` is a TOTAL budget for peers that have not
    published yet; a peer still absent at the deadline contributes
    nothing."""
    deadline = time.monotonic() + max(float(wait_s), 0.0)
    out: List[Dict[str, Any]] = []
    for i in range(process_count):
        if i == local_index:
            out.append(_spans.summary(local_index))
            continue
        try:
            raw = kv.try_get(_key(i))
            if not raw:
                remaining = deadline - time.monotonic()
                if remaining > 0:
                    raw = kv.get(_key(i), timeout_s=remaining)
        except Exception:
            continue                      # dead peer: merge what exists
        if not raw:
            continue
        try:
            out.append(json.loads(raw))
        except Exception:
            logger.warning("unparseable trace summary from process %d", i)
    return out


def clock_offset_us(leader: Dict[str, Any],
                    follower: Dict[str, Any]) -> float:
    """Microseconds to ADD to the follower's relative timestamps to land
    them on the leader's timeline."""
    return (float(follower["epoch_unix"])
            - float(leader["epoch_unix"])) * 1e6


def merge_summaries(summaries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One Chrome-trace payload from per-rank summaries: the lowest
    process index anchors the timeline; every other rank is shifted by
    its estimated clock offset and drawn on its own pid track."""
    if not summaries:
        return {"displayTimeUnit": "ms", "metadata": {}, "traceEvents": []}
    summaries = sorted(summaries, key=lambda s: int(s["process_index"]))
    leader = summaries[0]
    events: List[Dict[str, Any]] = []
    offsets: Dict[str, float] = {}
    for s in summaries:
        idx = int(s["process_index"])
        off = clock_offset_us(leader, s)
        offsets[str(idx)] = off
        events.append({
            "ph": "M", "name": "process_name", "pid": idx,
            "args": {"name": f"host{idx} ({s.get('hostname', '?')})"}})
        events += _spans.chrome_events(
            s.get("spans", []), pid=idx, shift_us=off,
            trace_id_=s.get("trace_id", ""))
    return {
        "displayTimeUnit": "ms",
        "metadata": {
            "merged_hosts": len(summaries),
            "anchor_process": int(leader["process_index"]),
            "anchor_epoch_unix": leader["epoch_unix"],
            "clock_offsets_us": offsets,
            "clock_note": "offsets from per-host wall-clock epoch "
                          "anchors (NTP accuracy); per-host durations "
                          "are exact",
        },
        "traceEvents": events,
    }


def merged_chrome_trace(path: str, kv=None, process_index: int = 0,
                        process_count: int = 1,
                        wait_s: float = 0.0) -> str:
    """Publish the local summary, then (on rank 0) collect every rank's
    and write the merged Perfetto file. Followers write nothing and
    return "": the merged file is the leader's, like the aggregated
    /metrics."""
    from horovod_tpu_torch.resilience import faults
    if kv is not None and process_count > 1 \
            and faults.should_shed("trace_merge"):
        # degraded mode: the cross-rank merge is optional traffic; write
        # a local-only trace instead of touching the shed transport
        logger.warning("trace merge shed (fault domain degraded); "
                       "writing a local-only trace")
        kv = None
    if kv is not None and process_count > 1:
        try:
            publish(kv, process_index)
        except Exception:
            logger.warning("trace summary publication failed",
                           exc_info=True)
        if process_index != 0:
            return ""
        summaries = collect(kv, process_count, local_index=process_index,
                            wait_s=wait_s)
    else:
        summaries = [_spans.summary(process_index)]
    payload = merge_summaries(summaries)
    return _spans.write_chrome_trace(
        path, payload["traceEvents"], metadata=payload["metadata"])


def export_on_shutdown(kv=None, process_index: int = 0,
                       process_count: int = 1,
                       directory: Optional[str] = None) -> Optional[str]:
    """Best-effort merged export into the trace dir (the ``shutdown()``
    path while tracing is on); never raises."""
    if not _spans.enabled() and not _spans.snapshot():
        return None
    d = directory or _spans.trace_dir()
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"merged-{socket.gethostname()}-p{process_index}.trace.json")
        out = merged_chrome_trace(path, kv=kv, process_index=process_index,
                                  process_count=process_count,
                                  wait_s=_SHUTDOWN_WAIT_S)
        return out or None
    except Exception:
        logger.warning("merged trace export failed", exc_info=True)
        return None
