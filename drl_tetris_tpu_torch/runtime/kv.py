"""Client for tetrikv (native/kvstore), the host-side control plane of the
process runtime.

Counterpart of ``drl_tetris_tpu/runtime/kv.py`` (reference: the Redis
types of drl_tetris/training_state/redis_types.py:25-181): entry, clock,
flag (TTL and atomic claim), byte block and queue, keyed
``run_id/role/name`` (scope.py keyjoin).  Values are raw bytes; the same
wire protocol, so this client and the JAX package's read each other's
keys on one server.

The server stays ``native/kvstore/kvstore.cpp``.  ``server_binary`` builds
it with g++ and ``build.sh``'s flags into ``build/tetrikv-<digest of the
source>``: through a temporary name and ``os.replace``, so two processes
(or test files run side by side) that build at once never run a
half-written binary, and never the one ``build.sh`` writes in place.
"""
from __future__ import annotations

import hashlib
import os
import socket
import struct
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Tuple

REPO = Path(__file__).resolve().parents[2]
SERVER_SOURCE = REPO / "native" / "kvstore" / "kvstore.cpp"
BUILD_DIR = REPO / "build"
GXX_FLAGS = ("-O2", "-std=c++17")       # native/kvstore/build.sh's


def keyjoin(*parts: str) -> str:
    """scope.py:4-9."""
    return "/".join(p for p in parts if p)


class KVClient:
    """One connection to a tetrikv server (opened on first use, reopened
    once after a dropped connection)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6399,
                 timeout: float = 30.0):
        self.addr = (host, port)
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None

    def _conn(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self.addr, timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def close(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def _call(self, line: str, value: bytes = b"") -> Tuple[str, bytes]:
        payload = line.encode() + b"\n" + value
        msg = struct.pack("<I", len(payload)) + payload
        for attempt in range(2):
            try:
                s = self._conn()
                s.sendall(msg)
                (rlen,) = struct.unpack("<I", self._read_n(s, 4))
                resp = self._read_n(s, rlen)
                return chr(resp[0]), resp[1:]
            except OSError:
                self.close()
                if attempt == 1:
                    raise
        raise ConnectionError("unreachable")

    @staticmethod
    def _read_n(s: socket.socket, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = s.recv(n - len(out))
            if not chunk:
                raise ConnectionError("kv server closed connection")
            out += chunk
        return out

    # -- primitives ---------------------------------------------------------
    def ping(self) -> bool:
        try:
            st, body = self._call("PING")
        except OSError:
            return False
        return st == "$" and body == b"PONG"

    def set(self, key: str, value: bytes):
        self._call(f"SET {key}", value)

    def get(self, key: str) -> Optional[bytes]:
        st, body = self._call(f"GET {key}")
        return body if st == "$" else None

    def delete(self, key: str):
        self._call(f"DEL {key}")

    def incr(self, key: str, delta: int = 1) -> int:
        _, body = self._call(f"INCR {key} {delta}")
        return int(body)

    def fincr(self, key: str, delta: float) -> float:
        _, body = self._call(f"FINCR {key} {delta}")
        return float(body)

    def expire(self, key: str, ttl_s: float) -> bool:
        st, _ = self._call(f"EXPIRE {key} {int(ttl_s * 1000)}")
        return st == "+"

    def claim(self, key: str, ttl_s: float) -> bool:
        """flag.claim (redis_types.py:118-131): true for the one caller
        that set the flag; it lapses after ``ttl_s``."""
        _, body = self._call(f"CLAIM {key} {int(ttl_s * 1000)}")
        return body == b"1"

    def push(self, queue: str, value: bytes):
        self._call(f"PUSH {queue}", value)

    def pop(self, queue: str) -> Optional[bytes]:
        st, body = self._call(f"POP {queue}")
        return body if st == "$" else None

    def pop_iter(self, queue: str, max_items: int = 1 << 30):
        """queue.pop_iter (trainer.py:83-87 drain)."""
        for _ in range(max_items):
            v = self.pop(queue)
            if v is None:
                return
            yield v

    def qlen(self, queue: str) -> int:
        _, body = self._call(f"QLEN {queue}")
        return int(body)

    def keys(self, prefix: str = "") -> List[str]:
        _, body = self._call(f"KEYS {prefix}")
        return [k for k in body.decode().split("\n") if k]

    def save(self, path: str) -> bool:
        st, _ = self._call(f"SAVE {path}")
        return st == "+"


def server_binary() -> str:
    """The tetrikv server built from this checkout's source (g++ with
    ``build.sh``'s flags), built on first use."""
    digest = hashlib.sha1(SERVER_SOURCE.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"tetrikv-{digest}"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                              str(SERVER_SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, out)
    return str(out)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_server(port: int = 6399, wait: float = 5.0) -> subprocess.Popen:
    """Start tetrikv on ``port`` (the docker-compose 'redis' service) and
    wait until it answers; the caller stops the process."""
    proc = subprocess.Popen([server_binary(), str(port)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    cli = KVClient(port=port)
    deadline = time.time() + wait
    try:
        while time.time() < deadline:
            if cli.ping():
                return proc
            if proc.poll() is not None:
                break
            time.sleep(0.05)
    finally:
        cli.close()
    proc.kill()
    proc.wait()
    raise RuntimeError(f"tetrikv did not come up on port {port}")
