"""Out-of-process control surface: JSONL over a Unix-domain socket — port of
``orb_slam3_ros_tpu.utils.control``.

Role of the reference ROS wrapper's services and topics (``save_map`` /
``save_traj`` and the pose / point publishers, src/common.cc:24-118,
srv/SaveMap.srv:1-3) without ROS: a client connects to the socket, sends
one JSON command a line and reads one JSON reply a line; ``subscribe``
turns the connection into a live event stream (the publisher role, fed by
the system's ``on_frame`` events, the ones ``utils.obslog`` writes).

Threads: a thread accepts connections, and each connection has a reader
thread and a writer thread. Commands EXECUTE on the SLAM thread: the
driving loop calls ``server.poll()`` between frames (as a ROS spin
interleaves service callbacks with the node's work); the system is never
touched from a server thread.

Every line to a client goes through that connection's bounded queue,
drained by its own writer thread, so the SLAM thread never blocks on a
socket and two threads never write into one connection. A subscriber that
stops reading fills its socket's send buffer (``SEND_BUFFER_BYTES``, set
on each connection), then its queue; once the queue is full
(``QUEUE_LINES`` lines unread) it is dropped and its connection closed, as
the JAX package drops a subscriber whose send fails; the frames go on.
(The JAX server sends on the SLAM thread with a blocking
``sendall``, so a subscriber that stops reading stalls ``process_frame``.)

A frame's events go out together: the server collects the lines of the
events a frame emits and hands them to each subscriber's queue as one item
at the next "frame" event (with that event's own line) or at ``poll()``,
whichever comes first; a writer thread is woken only when it is idle, and
sends everything queued in one ``sendall``. So a frame costs each
subscriber one or two wake-ups of its writer thread, not one a line.

Commands:
  {"cmd": "status"}                                -> counters / state
  {"cmd": "save_map",  "path": p}                  -> whole-session checkpoint
  {"cmd": "save_traj", "path": p, "format": f}     -> tum | euroc | kitti
  {"cmd": "localization_mode", "on": true|false}   -> toggle the frozen map
  {"cmd": "subscribe"}                             -> live event stream
"""

from __future__ import annotations

import json
import os
import queue
import socket
import threading

# lines a client may leave unread, past what its socket's kernel buffer
# holds, before it is dropped: ~16 frames of events at points_every 1
QUEUE_LINES = 64
# the kernel's send buffer a connection asks for (the kernel doubles it):
# small, so that an unread client backs up into its queue within seconds
# whatever the host's default (net.core.wmem_default); a reader that keeps
# up with tens of lines a second never comes near it
SEND_BUFFER_BYTES = 8 * 1024
REPLY_TIMEOUT_S = 60.0  # how long a command waits for the SLAM thread's poll()


class _Conn:
    """One client connection: its socket, its outgoing queue (byte chunks
    of whole lines, at most ``QUEUE_LINES`` lines not yet taken by the
    writer) and the thread that writes them."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.dead = threading.Event()
        self._close_lock = threading.Lock()
        self._cv = threading.Condition(threading.Lock())
        self._chunks: list[bytes] = []
        self._lines = 0  # lines in ``_chunks``
        self._idle = False  # the writer waits on ``_cv``
        threading.Thread(target=self._write_loop, daemon=True).start()

    def put(self, obj, n_lines: int = 1) -> bool:
        """Queue a JSON line (a dict), or ``n_lines`` encoded lines (bytes);
        False (and the connection closed) when the queue would pass
        ``QUEUE_LINES`` lines or the connection is gone."""
        data = obj if isinstance(obj, bytes) else (json.dumps(obj) + "\n").encode()
        if self.dead.is_set():
            return False
        with self._cv:
            full = self._lines + n_lines > QUEUE_LINES
            if not full:
                self._chunks.append(data)
                self._lines += n_lines
                if self._idle:
                    self._cv.notify()
        if full:
            self.close()
            return False
        return True

    def _write_loop(self):
        while True:
            with self._cv:
                while not self._chunks and not self.dead.is_set():
                    self._idle = True
                    self._cv.wait()
                    self._idle = False
                if self.dead.is_set():
                    return
                data = b"".join(self._chunks)
                self._chunks, self._lines = [], 0
            try:
                self.sock.sendall(data)
            except OSError:
                self.close()

    def close(self):
        with self._close_lock:  # the writer thread and the SLAM thread may both close
            if self.dead.is_set():
                return
            self.dead.set()
        with self._cv:
            self._cv.notify()  # an idle writer thread ends
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:  # the peer already went
            pass
        self.sock.close()


class ControlServer:
    """JSONL command server bound to the Unix socket ``sock_path``; chains
    onto ``slam.on_frame``."""

    def __init__(self, slam, sock_path: str):
        self.slam = slam
        self.sock_path = sock_path
        self.dropped = 0  # subscribers dropped for a full queue or a dead socket
        self._cmds: queue.Queue = queue.Queue()
        self._subscribers: list[_Conn] = []
        self._conns: list[_Conn] = []
        # lines of the current frame's events not yet handed to the
        # subscribers (SLAM thread only)
        self._pending: list[bytes] = []
        self._lock = threading.Lock()
        self._closing = False
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(sock_path)
        self._srv.listen(4)
        self._srv.settimeout(0.2)  # the accept loop checks for close() this often
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        prev = slam.on_frame

        def hook(ev):
            if prev is not None:
                prev(ev)
            self._publish(ev)

        slam.on_frame = hook

    # -- server threads --------------------------------------------------
    def _accept_loop(self):
        while not self._closing:
            try:
                sock, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.settimeout(None)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, SEND_BUFFER_BYTES)
            conn = _Conn(sock)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._client_loop, args=(conn,), daemon=True).start()

    def _client_loop(self, conn: _Conn):
        try:
            for line in conn.sock.makefile("r"):
                line = line.strip()
                if not line:
                    continue
                try:
                    cmd = json.loads(line)
                except json.JSONDecodeError as e:
                    conn.put({"ok": False, "error": f"bad json: {e}"})
                    continue
                if cmd.get("cmd") == "subscribe":
                    with self._lock:
                        self._subscribers.append(conn)
                    conn.put({"ok": True, "subscribed": True})
                    continue
                done = threading.Event()
                box: dict = {}
                self._cmds.put((cmd, box, done))
                done.wait(timeout=REPLY_TIMEOUT_S)
                conn.put(box or {"ok": False, "error": "timeout"})
        except (OSError, ValueError):
            pass
        finally:
            conn.close()
            self._forget(conn)

    def _forget(self, conn: _Conn):
        with self._lock:
            if conn in self._subscribers:
                self._subscribers.remove(conn)
            if conn in self._conns:
                self._conns.remove(conn)

    def _publish(self, ev: dict):
        """Collect an ``on_frame`` event for every subscriber, never
        blocking: arrays of at most 16 values as lists, bulkier ones left
        out (the reference publishes counts at frame rate, clouds at a
        slower cadence). A "frame" event hands the collected lines over
        (``_flush``), its own included."""
        with self._lock:
            if not self._subscribers:
                self._pending = []
                return
        out = {}
        for k, v in ev.items():
            if hasattr(v, "tolist"):
                v = v.tolist() if getattr(v, "size", 0) <= 16 else None
            if v is not None:
                out[k] = v
        self._pending.append((json.dumps(out) + "\n").encode())
        if ev.get("event") == "frame":
            self._flush()

    def _flush(self):
        """Hand the collected lines to every subscriber's queue as one item."""
        if not self._pending:
            return
        data, n = b"".join(self._pending), len(self._pending)
        self._pending = []
        with self._lock:
            subs = list(self._subscribers)
        for s in subs:
            if not s.put(data, n):
                self.dropped += 1
                self._forget(s)

    # -- SLAM thread -----------------------------------------------------
    def poll(self):
        """Send the events collected since the last frame event, then
        execute the queued commands on the caller's (SLAM) thread. Call
        between frames."""
        self._flush()
        while True:
            try:
                cmd, box, done = self._cmds.get_nowait()
            except queue.Empty:
                return
            try:
                box.update(self._execute(cmd))
            except Exception as e:  # reply rather than end the session
                box.update({"ok": False, "error": repr(e)})
            done.set()

    def _execute(self, cmd: dict) -> dict:
        from . import checkpoint, trajectory

        slam = self.slam
        name = cmd.get("cmd")
        if name == "status":
            return {
                "ok": True, "state": int(slam.state),
                "n_kf": int(slam.n_kf), "n_pts": int(slam.n_pts),
                "frame_id": int(slam.frame_id),
                "localization_only": bool(slam.localization_only),
                "n_closures": len(slam.loop_closer.closures) if slam.loop_closer is not None else 0,
            }
        if name == "save_map":
            digest = checkpoint.save_atlas(cmd["path"], slam)
            return {"ok": True, "path": cmd["path"], "md5": digest}
        if name == "save_traj":
            fmt = cmd.get("format", "tum")
            writer = {"tum": trajectory.save_tum, "euroc": trajectory.save_euroc,
                      "kitti": trajectory.save_kitti}.get(fmt)
            if writer is None:
                return {"ok": False, "error": f"unknown format {fmt!r}"}
            traj = slam.get_trajectory()
            writer(cmd["path"], traj)
            return {"ok": True, "path": cmd["path"], "n_poses": len(traj)}
        if name == "localization_mode":
            if cmd.get("on"):
                slam.activate_localization_mode()
            else:
                slam.deactivate_localization_mode()
            return {"ok": True, "localization_only": bool(slam.localization_only)}
        return {"ok": False, "error": f"unknown cmd {name!r}"}

    def close(self):
        """Hand over the events still collected, stop accepting, close every
        connection and remove the socket file."""
        self._flush()
        self._closing = True
        self._srv.close()
        self._thread.join(timeout=2.0)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)


class ControlClient:
    """Line-oriented client of ``ControlServer`` (the rosservice-call
    counterpart; any language can speak the JSONL). ``timeout``: seconds
    each socket read or write may wait."""

    def __init__(self, sock_path: str, timeout: float = 60.0):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(sock_path)
        self._f = self._sock.makefile("r")

    def call(self, cmd: str, **kw) -> dict:
        self._sock.sendall((json.dumps({"cmd": cmd, **kw}) + "\n").encode())
        return json.loads(self._f.readline())

    def subscribe(self):
        """Subscribe, then yield the live events."""
        self._sock.sendall((json.dumps({"cmd": "subscribe"}) + "\n").encode())
        ack = json.loads(self._f.readline())
        if not ack.get("ok"):
            raise RuntimeError(f"subscribe refused: {ack}")
        for line in self._f:
            yield json.loads(line)

    def close(self):
        self._sock.close()
