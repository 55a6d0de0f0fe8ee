"""XSpace profile parser: round-trip against a hand-encoded protobuf."""

import struct

from open_pandora_tpu.utils.xplane import (op_totals_from_file, parse_xspace,
                                           top_ops)


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num, payload):
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _vint_field(num, val):
    return _varint(num << 3) + _varint(val)


def _make_xspace():
    # XEventMetadata {id=1, name=2}
    meta7 = _vint_field(1, 7) + _field(2, b"%fusion.1 = add")
    meta9 = _vint_field(1, 9) + _field(2, b"%copy-start = weights")
    # map entries {key=1, value=2}
    entry7 = _vint_field(1, 7) + _field(2, meta7)
    entry9 = _vint_field(1, 9) + _field(2, meta9)
    # XEvent {metadata_id=1, duration_ps=3}
    ev1 = _vint_field(1, 7) + _vint_field(3, 2_000_000_000)  # 2 ms
    ev2 = _vint_field(1, 7) + _vint_field(3, 1_000_000_000)
    ev3 = _vint_field(1, 9) + _vint_field(3, 5_000_000_000)
    # XLine {name=2, events=4}
    line_ops = _field(2, b"XLA Ops") + _field(4, ev1) + _field(4, ev2)
    line_async = _field(2, b"Async XLA Ops") + _field(4, ev3)
    # XPlane {name=2, lines=3, event_metadata=4}
    plane = (_field(2, b"/device:GPU:0") + _field(3, line_ops)
             + _field(3, line_async) + _field(4, entry7) + _field(4, entry9))
    host = _field(2, b"/host:CPU") + _field(3, _field(2, b"python"))
    return _field(1, plane) + _field(1, host)


def test_parse_and_aggregate(tmp_path):
    p = tmp_path / "x.xplane.pb"
    p.write_bytes(_make_xspace())

    planes = parse_xspace(p.read_bytes())
    assert [pl["name"] for pl in planes] == ["/device:GPU:0", "/host:CPU"]
    assert planes[0]["meta"][7] == "%fusion.1 = add"

    tot = op_totals_from_file(str(p))
    assert tot["%fusion.1 = add"] == 3.0       # 2 + 1 ms
    assert tot["%copy-start = weights"] == 5.0

    ops_only = op_totals_from_file(str(p), line_filter="XLA Ops")
    # 'XLA Ops' substring also matches 'Async XLA Ops'; exact line pick:
    sync_only = op_totals_from_file(str(p), line_filter="xla ops")
    assert ops_only == sync_only
    asy = op_totals_from_file(str(p), line_filter="Async")
    assert asy == {"%copy-start = weights": 5.0}

    ranked = top_ops(tot, 1)
    assert ranked[0][0] == "%copy-start = weights"
