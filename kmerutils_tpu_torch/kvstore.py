"""A minimal RESP (redis serialization protocol) key-value client and server.

Port of kmerutils_tpu/kvstore.py.  Anchors persist to a redis-protocol
store: ``RespClient`` speaks RESP2 as a stock redis server accepts it, and
``RespServer`` is a small threaded in-process server with the command
subset the anchor store needs (HSET, HGET, HGETALL, HLEN, PING, SELECT,
BGREWRITEAOF, FLUSHDB), with redis's replies.

RESP2 framing: a request is an array of bulk strings
``*N\\r\\n$len\\r\\narg\\r\\n...``; replies are ``+simple``, ``-error``,
``:integer``, ``$len bulk`` (-1 = nil) or ``*N array``.

Unlike the JAX server, a malformed request frame gets ``-ERR protocol
error`` and the connection closes; the JAX server's handler thread raises
on it and closes the connection without a reply.  For the same reason an
unknown command that is not UTF-8 is echoed as its raw bytes in the
``-ERR unknown command`` reply (the JAX handler raises on it too).
"""

from __future__ import annotations

import socket
import threading


class RespError(RuntimeError):
    """A server-reported (-ERR ...) reply, or a frame that is not RESP."""


def _encode_command(*args) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        elif isinstance(a, int):
            a = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


class _Reader:
    """Buffered RESP reader over a socket."""

    def __init__(self, sock: socket.socket):
        self._s = sock
        self._buf = b""

    def _line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._s.recv(65536)
            if not chunk:
                raise ConnectionError("RESP peer closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._s.recv(65536)
            if not chunk:
                raise ConnectionError("RESP peer closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]  # strip \r\n
        return data

    def reply(self):
        line = self._line()
        t, body = line[:1], line[1:]
        if t == b"+":
            return body.decode()
        if t == b"-":
            raise RespError(body.decode())
        if t == b":":
            return int(body)
        if t == b"$":
            n = int(body)
            return None if n < 0 else self._exact(n)
        if t == b"*":
            n = int(body)
            return None if n < 0 else [self.reply() for _ in range(n)]
        raise RespError(f"bad RESP type byte {t!r}")


class RespClient:
    """Blocking RESP2 client: the anchor store's network path.  Only the
    anchor flow's commands have a method; ``execute`` sends anything."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = _Reader(self._sock)
        self._lock = threading.Lock()
        if db:
            self.execute("SELECT", db)

    def execute(self, *args):
        with self._lock:
            self._sock.sendall(_encode_command(*args))
            return self._reader.reply()

    def pipeline(self, commands):
        """Send many commands in one write and read all their replies."""
        payload = b"".join(_encode_command(*c) for c in commands)
        with self._lock:
            self._sock.sendall(payload)
            return [self._reader.reply() for _ in commands]

    def ping(self) -> bool:
        return self.execute("PING") == "PONG"

    def hset(self, key: str, field: str, value: str) -> int:
        return self.execute("HSET", key, field, value)

    def hget(self, key: str, field: str) -> str | None:
        v = self.execute("HGET", key, field)
        return v.decode() if isinstance(v, bytes) else v

    def hgetall(self, key: str) -> dict[str, str]:
        flat = self.execute("HGETALL", key) or []
        return {flat[i].decode(): flat[i + 1].decode()
                for i in range(0, len(flat), 2)}

    def hlen(self, key: str) -> int:
        return self.execute("HLEN", key)

    def bgrewriteaof(self) -> str:
        return self.execute("BGREWRITEAOF")

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class RespServer:
    """Threaded in-process RESP server over a dict of dicts (``store``:
    key -> {field: value}, bytes), one daemon thread per connection.  HSET
    returns the number of NEW fields, HGET nil on a miss."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.store: dict[bytes, dict[bytes, bytes]] = {}
        self._lock = threading.Lock()
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                self._srv.settimeout(0.2)
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        reader = _Reader(conn)
        try:
            while True:
                try:
                    req = reader.reply()    # requests are RESP arrays too
                except (RespError, ValueError):
                    req = None              # not RESP: bad type or length
                if not isinstance(req, list) or not req \
                        or not all(isinstance(a, bytes) for a in req):
                    conn.sendall(b"-ERR protocol error\r\n")
                    return
                conn.sendall(self._dispatch(req))
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _dispatch(self, req: list[bytes]) -> bytes:
        cmd = req[0].upper()
        with self._lock:
            if cmd == b"PING":
                return b"+PONG\r\n"
            if cmd == b"SELECT":
                return b"+OK\r\n"           # single-db server
            if cmd == b"BGREWRITEAOF":
                return b"+Background append only file rewriting started\r\n"
            if cmd == b"FLUSHDB":
                self.store.clear()
                return b"+OK\r\n"
            if cmd == b"HSET" and len(req) >= 4 and len(req) % 2 == 0:
                h = self.store.setdefault(req[1], {})
                added = 0
                for i in range(2, len(req), 2):
                    added += req[i] not in h
                    h[req[i]] = req[i + 1]
                return b":%d\r\n" % added
            if cmd == b"HGET" and len(req) == 3:
                v = self.store.get(req[1], {}).get(req[2])
                if v is None:
                    return b"$-1\r\n"
                return b"$%d\r\n%s\r\n" % (len(v), v)
            if cmd == b"HLEN" and len(req) == 2:
                return b":%d\r\n" % len(self.store.get(req[1], {}))
            if cmd == b"HGETALL" and len(req) == 2:
                h = self.store.get(req[1], {})
                parts = [b"*%d\r\n" % (2 * len(h))]
                for f, v in h.items():
                    parts.append(b"$%d\r\n%s\r\n$%d\r\n%s\r\n"
                                 % (len(f), f, len(v), v))
                return b"".join(parts)
        return b"-ERR unknown command '%s'\r\n" % cmd

    def close(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)
