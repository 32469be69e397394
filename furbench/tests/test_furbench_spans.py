"""The readers of the port's span log (`pass_enqueue_ms`, `hit_device_ms`,
`camera_device_ms`, `live_share`) on a synthetic log: each reads only the
traced stretch's passes, and each returns None, without raising, where the
port keeps no span log, the log is empty or short, or (the device
intervals) the spans carry no events."""

import pytest

from ba_pathtracing_fur_torch.utils import profiling
from furbench import harness

READERS = ("pass_enqueue_ms", "hit_device_ms", "camera_device_ms", "live_share")


class Events:
    """A (start, end) pair of events `ms` apart on the device."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _span(log, name, parent, pass_index, host_ms, device_ms=None, bounce=None, **counts):
    s = profiling.Span(name, parent, pass_index, bounce, t0=0, t1=int(host_ms * 1e6),
                       events=None if device_ms is None else (Events(0.0), Events(device_ms)))
    s.index = len(log)
    s.counts = {k: [v] for k, v in counts.items()}
    log.append(s)
    return s


def _log(passes, events=True, first=0):
    """`passes` passes from index `first`: pass p's enqueue 10 + p ms, its
    camera 2 + p ms on the device, two bounces of 100 rays with 100 and 40
    live, each with a hit of 1 and 3 ms."""
    log = []
    for p in range(first, first + passes):
        head = _span(log, "pass", None, p, 10.0 + p)
        _span(log, "camera", head.index, p, 0.5, (2.0 + p) if events else None)
        for b, (live, hit_ms) in enumerate(((100, 1.0), (40, 3.0))):
            bounce = _span(log, "bounce", head.index, p, 5.0, bounce=b, rays=100, live=live)
            _span(log, "hit", bounce.index, p, 0.2, hit_ms if events else None, bounce=b)
        _span(log, "mean", head.index, p, 0.1)
    return log


def _read(name, log, monkeypatch, units=3, unit="pass"):
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    return harness.reader_of(name).read({"trace": {"units": units}, "unit": unit})


def test_each_reader_reads_the_traced_passes(monkeypatch):
    # two untraced passes before (another render's), three traced
    log = _log(2, first=0) + _log(3, first=10)
    for i, s in enumerate(log):
        s.index = i
    assert _read("pass_enqueue_ms", log, monkeypatch) == 21.0  # median of 20, 21, 22
    assert _read("camera_device_ms", log, monkeypatch) == 13.0
    assert _read("hit_device_ms", log, monkeypatch) == 4.0
    assert _read("live_share", log, monkeypatch) == 70.0


def test_device_readers_need_events(monkeypatch):
    log = _log(3, events=False)
    assert _read("pass_enqueue_ms", log, monkeypatch) == 11.0
    assert _read("live_share", log, monkeypatch) == 70.0
    assert _read("hit_device_ms", log, monkeypatch) is None
    assert _read("camera_device_ms", log, monkeypatch) is None


@pytest.mark.parametrize("name", READERS)
def test_none_where_there_is_nothing_to_read(name, monkeypatch):
    assert _read(name, [], monkeypatch) is None  # an empty log
    assert _read(name, _log(2), monkeypatch) is None  # fewer passes than traced
    assert _read(name, _log(3), monkeypatch, unit="step") is None  # not by passes
    assert harness.reader_of(name).read({}) is None  # not traced
    monkeypatch.delattr(profiling, "spans")  # a port without the span log
    assert harness.reader_of(name).read({"trace": {"units": 3}, "unit": "pass"}) is None
