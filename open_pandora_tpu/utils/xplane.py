"""Minimal XSpace (.xplane.pb) reader — dependency-free profiling analysis.

`jax.profiler.trace` writes XSpace protobufs; the TensorBoard profile
plugin that normally reads them isn't usable headless in this image, so
this module parses the wire format directly (the same ~60 lines of varint
walking as the TFRecord writer in utils/loggers.py) and aggregates
per-op device time.

Schema subset (tsl/profiler/protobuf/xplane.proto):
  XSpace.planes = 1 (XPlane)
  XPlane.name = 2, .lines = 3, .event_metadata map = 4
  XEventMetadata entry: key=1, value=2 {id=1, name=2, display_name=4}
  XLine.events = 4 (repeated XEvent)
  XEvent.metadata_id = 1, .duration_ps = 3 (or num_occurrences packing)

GPU device planes are named "/device:GPU:<n>" (DEVICE_PLANE); host
threads live in "/host:CPU".

Usage:
    from open_pandora_tpu.utils.xplane import profile_op_totals
    totals = profile_op_totals(fn, *args)   # {op_name: ms}, one device step
"""

from __future__ import annotations

import struct
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

DEVICE_PLANE = "/device:GPU"


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) from a protobuf message."""
    i, n = 0, len(buf)
    while i < n:
        key = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        num, wire = key >> 3, key & 7
        if wire == 0:
            v = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wire == 1:
            v = struct.unpack("<q", buf[i:i + 8])[0]
            i += 8
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<i", buf[i:i + 4])[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield num, wire, v


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def parse_xspace(data: bytes) -> List[Dict]:
    """-> [{name, lines: [[(metadata_id, duration_ps), ...]], meta: {id: name}}]"""
    planes = []
    for num, _, v in _fields(data):
        if num != 1:
            continue
        plane = {"name": "", "meta": {}, "lines": []}
        for pn, _, pv in _fields(v):
            if pn == 2:
                plane["name"] = pv.decode("utf-8", "replace")
            elif pn == 4:  # event_metadata map entry
                key = mid = None
                name = ""
                for en, _, ev in _fields(pv):
                    if en == 1:
                        key = ev
                    elif en == 2:
                        for mn, _, mv in _fields(ev):
                            if mn == 1:
                                mid = mv
                            elif mn == 2:
                                name = mv.decode("utf-8", "replace")
                plane["meta"][key if mid is None else mid] = name
            elif pn == 3:  # XLine
                events = []
                line_name = ""
                for ln, _, lv in _fields(pv):
                    if ln == 2:
                        line_name = lv.decode("utf-8", "replace")
                    elif ln == 11:
                        line_name = lv.decode("utf-8", "replace") or line_name
                    elif ln == 4:  # XEvent
                        mid = dur = off = 0
                        for en, ew, ev in _fields(lv):
                            if en == 1:
                                mid = ev
                            elif en == 2 and ew == 0:
                                off = ev
                            elif en == 3 and ew == 0:
                                dur = ev
                        events.append((mid, dur, off))
                plane["lines"].append({"name": line_name, "events": events})
        planes.append(plane)
    return planes


def op_totals_from_file(path: str, plane_filter: str = DEVICE_PLANE,
                        line_filter: str = "",
                        ) -> Dict[str, float]:
    """Aggregate event duration (ms) by op name over device-plane lines
    whose name contains line_filter (e.g. 'XLA Ops' for exclusive per-op
    compute; async DMA queues report start->done windows, not exclusive
    time)."""
    with open(path, "rb") as f:
        planes = parse_xspace(f.read())
    totals: Dict[str, float] = defaultdict(float)
    for plane in planes:
        if plane_filter.lower() not in plane["name"].lower():
            continue
        for line in plane["lines"]:
            if line_filter.lower() not in line["name"].lower():
                continue
            for mid, dur_ps, _off in line["events"]:
                name = plane["meta"].get(mid, f"#{mid}")
                totals[name] += dur_ps / 1e9  # ps -> ms
    return dict(totals)


def op_events_from_file(path: str, plane_filter: str = DEVICE_PLANE,
                        line_filter: str = "",
                        ) -> List[Tuple[str, float, float]]:
    """Flat [(op_name, offset_ms, duration_ms)] over matching lines —
    ordered timeline data for exclusive-coverage analysis (op_totals alone
    cannot distinguish overlapping async windows from serialized compute).
    NOTE: line_filter is a substring match, so 'XLA Ops' also matches the
    'Async XLA Ops' line — pass 'async' explicitly or post-filter."""
    with open(path, "rb") as f:
        planes = parse_xspace(f.read())
    out: List[Tuple[str, float, float]] = []
    for plane in planes:
        if plane_filter.lower() not in plane["name"].lower():
            continue
        for line in plane["lines"]:
            if line_filter.lower() not in line["name"].lower():
                continue
            for mid, dur_ps, off_ps in line["events"]:
                out.append((plane["meta"].get(mid, f"#{mid}"),
                            off_ps / 1e9, dur_ps / 1e9))
    out.sort(key=lambda e: e[1])
    return out


def line_names_from_file(path: str) -> List[Tuple[str, str, int]]:
    with open(path, "rb") as f:
        planes = parse_xspace(f.read())
    return [(p["name"], ln["name"], len(ln["events"]))
            for p in planes for ln in p["lines"]]


def find_xplane_files(logdir: str) -> List[str]:
    import glob
    import os

    return sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                            recursive=True))


def profile_op_totals(fn, *args, warmup: int = 1, iters: int = 1,
                      plane_filter: str = DEVICE_PLANE, line_filter: str = "",
                      logdir: str = None) -> Dict[str, float]:
    """Trace `fn(*args)` with jax.profiler and return {op_name: total_ms}
    across `iters` calls on the device plane."""
    import tempfile

    import jax
    import numpy as np

    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]

    logdir = logdir or tempfile.mkdtemp(prefix="xprof_")
    with jax.profiler.trace(logdir):
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]
    files = find_xplane_files(logdir)
    if not files:
        raise RuntimeError(f"no .xplane.pb produced under {logdir}")
    totals: Dict[str, float] = defaultdict(float)
    for f in files:
        for k, v in op_totals_from_file(f, plane_filter, line_filter).items():
            totals[k] += v
    return {k: v / iters for k, v in totals.items()}


def top_ops(totals: Dict[str, float], k: int = 30) -> List[Tuple[str, float]]:
    return sorted(totals.items(), key=lambda kv: -kv[1])[:k]
