"""Tracking's copy of the map for the two-device split (``MonoSlam(devices=
(track_device, map_device))``; the JAX package's ``_map_replica`` /
``_replica_copy``, the shape of the reference's Tracking / LocalMapping
thread split, System.cc:178).

Mapping writes the canonical map on the map device; per-frame tracking
reads a replica on the track device. The replica is two preallocated
``MapState`` buffers: tracking reads one while a refresh writes the other,
so the buffer tracking reads is never the one being written. On the card a
refresh is one ``copy_(non_blocking=True)`` a field on a side stream of each
device, with an event recorded after it:

* ``start`` (after a keyframe) first adopts a refresh still in flight,
  waiting for it, so the replica is never more than one keyframe behind;
  then it copies the map into the free buffer. The copy waits for the work
  queued so far on both devices' streams (the map it reads, the tracking
  that still reads the free buffer); the map device's stream waits for the
  copy's event before any later write to the map.
* ``poll`` (at the top of every frame) adopts a refresh whose event has
  completed: tracking reads it from that frame on. Forced, it adopts it
  whatever its state (the tracking stream waits for its event).
* ``sync`` (a map change outside the keyframe cadence: initialization, a
  loop closure, a global-BA fold-in, compaction, an Atlas switch or weld, a
  reset) starts a refresh and adopts it at once.

Off the card the copy is a plain ``copy_`` and a refresh lands at once; the
code paths are the same. ``counts`` holds the refreshes started
("copies"), the immediate ones ("syncs"), the adoptions made by ``poll``
("adopted"; "forced" of them forced by a new refresh or a sync), the
frames tracked while a refresh was still in flight ("stale_frames") and
the most refreshes any tracked frame's replica was behind the canonical map
("max_stale": at most one, a keyframe).
"""

from __future__ import annotations

import contextlib
from collections import deque

import torch

from .map_state import MapState


class MapReplica:
    def __init__(self, m: MapState, device):
        self.device = torch.device(device)
        self._bufs = [MapState(*(torch.empty_like(x, device=self.device) for x in m))
                      for _ in range(2)]
        self._cur = 0
        self._pending = None  # (buffer index, event or None, refresh serial)
        self._serial = self._cur_serial = 0  # refreshes started; the one tracking reads
        self._streams = None  # {device: side stream} on the card, made at the first refresh
        self.nbytes = sum(x.numel() * x.element_size() for x in m)
        self.counts = dict(copies=0, syncs=0, adopted=0, forced=0, stale_frames=0, max_stale=0)
        self.timing = deque(maxlen=256)  # (start, end) CUDA events of each refresh on the card
        self._copy(m)
        self._adopt()

    @property
    def current(self) -> MapState:
        """The buffer tracking reads."""
        return self._bufs[self._cur]

    def start(self, m: MapState) -> None:
        """Refresh asynchronously from the canonical map ``m``."""
        self.poll(force=True)
        self._copy(m)
        self.counts["copies"] += 1

    def sync(self, m: MapState) -> None:
        """Refresh from ``m`` now: tracking reads it from the next call on."""
        self.poll(force=True)
        self._copy(m)
        self._adopt()
        self.counts["syncs"] += 1

    def poll(self, force: bool = False) -> bool:
        """Adopt a refresh in flight once it has landed (or when forced);
        returns whether one was adopted."""
        if self._pending is None:
            return False
        event = self._pending[1]
        if not force and event is not None and not event.query():
            return False
        self._adopt()
        self.counts["adopted"] += 1
        self.counts["forced"] += int(force)
        return True

    def note_frame(self) -> None:
        """Count a tracked frame by how far its replica is behind."""
        stale = self._serial - self._cur_serial
        self.counts["stale_frames"] += int(stale > 0)
        self.counts["max_stale"] = max(self.counts["max_stale"], stale)

    def refresh_us(self) -> list:
        """Device microseconds of the recorded refreshes (synchronizes)."""
        out = []
        for a, b in self.timing:
            b.synchronize()
            out.append(a.elapsed_time(b) * 1e3)
        return out

    def _copy(self, m: MapState) -> None:
        self._serial += 1
        target = 1 - self._cur
        dst = self._bufs[target]
        src_dev = m.kf_valid.device
        if self.device.type != "cuda":
            for d, s in zip(dst, m):
                d.copy_(s)
            self._pending = (target, None, self._serial)
            return
        if self._streams is None:
            self._streams = {d: torch.cuda.Stream(device=d) for d in (src_dev, self.device)}
            for buf in self._bufs:
                for x in buf:
                    x.record_stream(self._streams[self.device])
        with contextlib.ExitStack() as stack:
            # The map device's side stream first, the track device's last (the
            # current device in the block); each waits for the work queued so
            # far on its device: the map's writers, the free buffer's readers.
            for d in dict.fromkeys((src_dev, self.device)):
                s = self._streams[d]
                s.wait_stream(torch.cuda.current_stream(d))
                stack.enter_context(torch.cuda.stream(s))
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            # across devices torch runs the copy on the source's stream and
            # makes the destination's wait for it
            for d, s in zip(dst, m):
                d.copy_(s, non_blocking=True)
            t1.record()
            event = torch.cuda.Event()
            event.record()
        self.timing.append((t0, t1))
        # later writes to the canonical map wait until the copy has read it
        torch.cuda.current_stream(src_dev).wait_event(event)
        self._pending = (target, event, self._serial)

    def _adopt(self) -> None:
        target, event, serial = self._pending
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        self._cur, self._cur_serial, self._pending = target, serial, None
