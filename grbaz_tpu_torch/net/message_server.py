"""Message distribution plane: TCP broadcast + relays + callbacks.

Host-side equivalents of the reference's msgq plumbing:

* :class:`MessageServer` — python/message_server.py:31-174: a TCP
  server broadcasting line-oriented messages to every connected client
  (the way radar/ACARS reports were distributed).
* :class:`MessageRelay` — python/message_relay.py:29-50: forwards
  messages from one queue to another (thread).
* :class:`MessageCallback` — python/message_callback.py: invokes a
  Python callable for each message (thread).

Messages here are anything ``str()``-able; event arrays from blocks are
typically formatted by the caller (e.g. radar reports, ACARS packets).

The port's copy of ``grbaz_tpu/net/message_server.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import queue
import socket
import socketserver
import threading
from typing import Callable, Optional


class _BroadcastHandler(socketserver.BaseRequestHandler):
    def setup(self):
        self.server.clients_lock.acquire()
        try:
            self.server.clients.add(self.request)
        finally:
            self.server.clients_lock.release()

    def handle(self):
        # clients are write-only; block until they disconnect
        try:
            while True:
                data = self.request.recv(4096)
                if not data:
                    break
        except OSError:
            pass

    def finish(self):
        with self.server.clients_lock:
            self.server.clients.discard(self.request)


class MessageServer(socketserver.ThreadingTCPServer):
    """Broadcasts posted messages (one per line) to all TCP clients."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address=("0.0.0.0", 0)):
        self.clients = set()
        self.clients_lock = threading.Lock()
        super().__init__(address, _BroadcastHandler)
        self._thr = threading.Thread(target=self.serve_forever, daemon=True)
        self._thr.start()

    @property
    def port(self):
        return self.server_address[1]

    def post(self, message) -> int:
        """Send one message line to every client; returns #receivers."""
        line = (str(message).rstrip("\n") + "\n").encode()
        sent = 0
        with self.clients_lock:
            dead = []
            for c in self.clients:
                try:
                    c.sendall(line)
                    sent += 1
                except OSError:
                    dead.append(c)
            for c in dead:
                self.clients.discard(c)
        return sent

    def close(self):
        self.shutdown()
        self.server_close()


class MessageRelay:
    """Forward messages queue->queue on a daemon thread
    (message_relay.py equivalent)."""

    def __init__(self, src: "queue.Queue", dst: "queue.Queue"):
        self.src, self.dst = src, dst
        self._run = True
        self._thr = threading.Thread(target=self._loop, daemon=True)
        self._thr.start()

    def _loop(self):
        while self._run:
            try:
                msg = self.src.get(timeout=0.2)
            except queue.Empty:
                continue
            self.dst.put(msg)

    def stop(self):
        self._run = False


class MessageCallback:
    """Invoke ``fn(msg)`` for each message in a queue
    (message_callback.py equivalent)."""

    def __init__(self, src: "queue.Queue", fn: Callable):
        self.src, self.fn = src, fn
        self._run = True
        self._thr = threading.Thread(target=self._loop, daemon=True)
        self._thr.start()

    def _loop(self):
        while self._run:
            try:
                msg = self.src.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self.fn(msg)
            except Exception:
                import traceback
                traceback.print_exc()

    def stop(self):
        self._run = False


class EventToMessage:
    """Event arrays -> queue messages with an appended string
    (baz_tag_to_msg equivalent, the reference's lib/baz_tag_to_msg.cc:
    46-91: converts stream tags to msgq messages + fixed appendix).

    Call ``post(events, count)`` with a block's event output; each valid
    row becomes one message ``(formatted_row + appendix)`` on ``dst``.
    """

    def __init__(self, dst: "queue.Queue", appendix: str = "",
                 formatter: Optional[Callable] = None):
        self.dst = dst
        self.appendix = appendix
        self.formatter = formatter or (lambda row: str(list(row)))

    def post(self, events, count=None) -> int:
        import numpy as _np
        if hasattr(events, "detach"):  # a tensor of the port, any device
            events = events.detach().cpu().numpy()
        ev = _np.asarray(events)
        n = int(count) if count is not None else len(ev)
        for row in ev[:n]:
            self.dst.put(self.formatter(row) + self.appendix)
        return n
