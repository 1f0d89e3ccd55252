"""A ``/requestz`` timeline read back for validation (fault C8).

``/requestz`` rounds each event's ``t_s`` and ``dur_s`` to 1 µs on its
own (the wire equals JAX's, ``ddp_tpu/obs/reqtrace.py:288-289``), so a
decode span that ends exactly at retire can come back ending 1 µs past
it. ``obs.reqtrace.requestz_events`` rebuilds whole µs, where that
overrun is exactly 1 µs and inside ``validate_request_timeline``'s
epsilon; the float rebuild chip_smoke used (``t_s * 1e6``) failed these
real pairs (found by search over random timelines). A 2 µs overrun must
still fail. The validator's epsilon is unchanged.
"""

import pytest

from ddp_tpu_torch.obs.reqtrace import (
    requestz_events,
    validate_request_timeline,
)

# (decode t_s, decode dur_s, retire t_s) as /requestz serves them: the
# true decode end equals retire, each field rounded to 1 µs on its own.
ROUNDED_PAIRS = [(0.026312, 0.03764, 0.063951),
                 (0.031597, 0.032827, 0.064423),
                 (0.021732, 0.040793, 0.062524)]


def _doc(t_decode, dur_decode, t_retire):
    return {"rid": 0, "trace_id": "0x0", "summary": {"total_s": t_retire},
            "events": [
                {"name": "req.admit", "t_s": 0.0, "dur_s": 0.0},
                {"name": "req.queue", "t_s": 0.0, "dur_s": 0.001},
                {"name": "req.prefill_chunk", "t_s": 0.002, "dur_s": 0.003,
                 "args": {"i": 0, "tokens": 5}},
                {"name": "req.decode", "t_s": t_decode, "dur_s": dur_decode,
                 "args": {"tokens": 9}},
                {"name": "req.retire", "t_s": t_retire, "dur_s": 0.0,
                 "args": {"reason": "complete"}},
            ]}


def _float_rebuild(doc):
    """chip_smoke's former rebuild (floats): the check at fault."""
    out = [{"name": "request", "ph": "X", "ts": 0.0,
            "dur": doc["summary"]["total_s"] * 1e6}]
    for e in doc["events"]:
        ev = {"name": e["name"], "ts": e["t_s"] * 1e6,
              **({"args": e["args"]} if e.get("args") else {})}
        if e["dur_s"] > 0:
            ev.update(ph="X", dur=e["dur_s"] * 1e6)
        else:
            ev["ph"] = "n"
        out.append(ev)
    return sorted(out, key=lambda e: e["ts"])


@pytest.mark.parametrize("pair", ROUNDED_PAIRS)
def test_one_microsecond_rounding_overrun_passes(pair):
    doc = _doc(*pair)
    with pytest.raises(ValueError, match="decode span runs past retire"):
        validate_request_timeline(_float_rebuild(doc))  # the old fault
    summary = validate_request_timeline(requestz_events(doc))
    assert summary["reason"] == "complete" and summary["chunks"] == 1
    events = requestz_events(doc)
    assert all(isinstance(e["ts"], int) for e in events)
    decode = next(e for e in events if e["name"] == "req.decode")
    retire = next(e for e in events if e["name"] == "req.retire")
    assert decode["ts"] + decode["dur"] - retire["ts"] == 1


@pytest.mark.parametrize("pair", ROUNDED_PAIRS)
def test_two_microsecond_overrun_fails(pair):
    t, dur, retire = pair
    doc = _doc(t, round(dur + 1e-6, 6), retire)  # ends 2 µs past retire
    with pytest.raises(ValueError, match="decode span runs past retire"):
        validate_request_timeline(requestz_events(doc))
