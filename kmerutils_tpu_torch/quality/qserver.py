"""Quality service: a request/reply server and client over TCP.

Port of kmerutils_tpu/quality/qserver.py, with the same wire protocol: a
loader process holds the wavelet-compressed qualities and serves reads,
blocks and single bases by read number.  Big-endian framing:

  request : u64 handle | u32 code | u64 numseq | u64 begin | u64 end
  reply   : u64 handle | u32 status | u32 len | len bytes of qualities

Codes: GetQRead 1, GetQBlock 2, GetQBase 3, Exit 9.  Status: 0 ok, 1 error
(read number out of range, block or base out of the read, unknown code).
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

GET_Q_READ = 1
GET_Q_BLOCK = 2
GET_Q_BASE = 3
EXIT = 9

DEFAULT_PORT = 4766

_REQ = struct.Struct(">QIQQQ")
_REP_HDR = struct.Struct(">QII")


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


class QualityServer:
    """Serves a list of QSequenceWM, or a QualityStore, one connection at
    a time until a client sends Exit."""

    def __init__(self, qseqs, port: int = DEFAULT_PORT,
                 host: str = "127.0.0.1"):
        self.qseqs = qseqs
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self._stop = False

    def _treat(self, handle, code, numseq, begin, end):
        """(handle, status, payload) of one request."""
        if code == EXIT:
            self._stop = True
            return handle, 0, b""
        if numseq >= len(self.qseqs):
            return handle, 1, b""
        wm = self.qseqs[numseq]
        if code == GET_Q_READ:
            data = wm.decompress().qseq.tobytes()
        elif code == GET_Q_BLOCK:
            if not begin <= end <= len(wm):
                return handle, 1, b""
            data = wm.qseq.lookup(np.arange(begin, end)) \
                .astype(np.uint8).tobytes()
        elif code == GET_Q_BASE:
            if begin >= len(wm):
                return handle, 1, b""
            data = wm.qseq.lookup(begin).astype(np.uint8).tobytes()
        else:
            return handle, 1, b""
        return handle, 0, data

    def serve_forever(self):
        while not self._stop:
            try:
                self.sock.settimeout(0.5)
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            with conn:
                try:
                    while not self._stop:
                        req = _recv_exact(conn, _REQ.size)
                        handle, code, numseq, begin, end = _REQ.unpack(req)
                        h, status, data = self._treat(handle, code, numseq,
                                                      begin, end)
                        conn.sendall(_REP_HDR.pack(h, status, len(data))
                                     + data)
                        if code == EXIT:
                            break
                except ConnectionError:
                    continue
        self.sock.close()

    def serve_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


class QualityClient:
    """Client of :class:`QualityServer`; every reply's handle must match
    its request's, and a non-zero status raises."""

    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT):
        self.sock = socket.create_connection((host, port))
        self._rng = np.random.default_rng()

    def _request(self, code, numseq=0, begin=0, end=0) -> np.ndarray:
        handle = int(self._rng.integers(0, 1 << 63))
        self.sock.sendall(_REQ.pack(handle, code, numseq, begin, end))
        h, status, n = _REP_HDR.unpack(_recv_exact(self.sock, _REP_HDR.size))
        data = _recv_exact(self.sock, n) if n else b""
        if h != handle:
            raise RuntimeError("handle mismatch in quality reply")
        if status != 0:
            raise RuntimeError(f"quality server error status {status}")
        return np.frombuffer(data, dtype=np.uint8)

    def get_quality_sequence(self, numseq: int) -> np.ndarray:
        """The remapped quality symbols of read ``numseq``."""
        return self._request(GET_Q_READ, numseq)

    def get_quality_block(self, numseq: int, begin: int, end: int
                          ) -> np.ndarray:
        return self._request(GET_Q_BLOCK, numseq, begin, end)

    def get_quality_base(self, numseq: int, pos: int) -> int:
        return int(self._request(GET_Q_BASE, numseq, pos)[0])

    def exit_server(self):
        self._request(EXIT)

    def close(self):
        self.sock.close()
