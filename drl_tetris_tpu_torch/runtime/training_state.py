"""Typed distributed-run state over the control-plane store.

Counterpart of ``drl_tetris_tpu/runtime/training_state.py`` (reference:
drl_tetris/training_state/training_state.py:12-52), with the same key
layout and TTLs: per-role key namespaces, versioned weight publication,
the experience queue, the workers' clock, shared stats, heartbeat flags,
and the elastic worker-slot claim (a worker claims the first worker-<i>
slot whose TTL'd flag is free, so a crashed worker's slot becomes
claimable again, :43-52).

The wire carries pickles of numpy arrays and plain Python values only:
callers move tensors to the host (``.cpu().numpy()``) before a push or a
publish and back to their device after a fetch, so no CUDA tensor is ever
pickled.  Only bytes that the run's own processes wrote are unpickled.
"""
from __future__ import annotations

import pickle
import time
from typing import Any, Iterator, Optional, Tuple

from drl_tetris_tpu_torch.runtime.kv import KVClient, keyjoin

WORKER_HEARTBEAT_TTL = 10.0   # worker.py:126
TRAINER_HEARTBEAT_TTL = 120.0  # trainer.py:146
CLAIM_TTL = 10.0               # redis_types.py:23 CLAIM_TIME


def _dumps(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def _loads(b: bytes) -> Any:
    return pickle.loads(b)


class TrainingState:
    """One process's view of the shared run state; ``role=None`` claims a
    worker slot."""

    def __init__(self, run_id: str, role: Optional[str] = None,
                 kv: Optional[KVClient] = None, port: int = 6399):
        self.kv = kv or KVClient(port=port)
        self.run_id = run_id
        self.me = role or self.claim_worker_slot()

    def k(self, *parts: str) -> str:
        return keyjoin(self.run_id, *parts)

    # -- elastic worker registry (training_state.py:43-52) ------------------
    def claim_worker_slot(self, max_workers: int = 4096) -> str:
        while True:
            for i in range(max_workers):
                name = f"worker-{i}"
                if self.kv.claim(self.k(name, "alive"), CLAIM_TTL):
                    return name
            time.sleep(1.0)

    def heartbeat(self, ttl: Optional[float] = None):
        """alive_flag.set(expire=...) each loop (worker.py:126)."""
        ttl = ttl or (TRAINER_HEARTBEAT_TTL if self.me == "trainer"
                      else WORKER_HEARTBEAT_TTL)
        key = self.k(self.me, "alive")
        self.kv.incr(key, 0)
        self.kv.expire(key, ttl)

    def unset_alive(self):
        self.kv.delete(self.k(self.me, "alive"))

    def alive_roles(self) -> list:
        out = []
        for key in self.kv.keys(self.run_id + "/"):
            parts = key.split("/")
            if len(parts) >= 3 and parts[-1] == "alive":
                out.append(parts[1])
        return out

    # -- weight publication (trainer.py:107-111 / worker.py:131-140) --------
    def publish_weights(self, weights: Any) -> int:
        self.kv.set(self.k("trainer", "weights"), _dumps(weights))
        return self.kv.incr(self.k("trainer", "weights_index"))

    def weights_index(self) -> int:
        v = self.kv.get(self.k("trainer", "weights_index"))
        return int(v) if v else 0

    def fetch_weights(self) -> Tuple[int, Optional[Any]]:
        idx = self.weights_index()
        blob = self.kv.get(self.k("trainer", "weights"))
        return idx, (None if blob is None else _loads(blob))

    # -- experience transport (worker.py:143-148 / trainer.py:83-87) --------
    def push_data(self, packet: Any):
        self.kv.push(self.k("data_queue"), _dumps(packet))

    def pop_data_iter(self, max_items: int = 64) -> Iterator[Any]:
        for blob in self.kv.pop_iter(self.k("data_queue"), max_items):
            yield _loads(blob)

    def queue_len(self) -> int:
        return self.kv.qlen(self.k("data_queue"))

    # -- clocks & stats -----------------------------------------------------
    def tick_clock(self, n: int = 1) -> int:
        """workers_clock.tick (worker.py:127)."""
        return self.kv.incr(self.k("workers_clock"), n)

    def clock(self) -> int:
        v = self.kv.get(self.k("workers_clock"))
        return int(v) if v else 0

    def stats_incr(self, name: str, delta: float) -> float:
        return self.kv.fincr(self.k("stats", name), delta)

    def stats_set(self, name: str, value: Any):
        self.kv.set(self.k("stats", name), _dumps(value))

    # -- runner state blobs (runner.py:69-88) -------------------------------
    def store_runner_state(self, blob: bytes):
        self.kv.set(self.k(self.me, "runner_state"), blob)

    def load_runner_state(self) -> Optional[bytes]:
        return self.kv.get(self.k(self.me, "runner_state"))

    def store_validation(self, artifact: Any, checksum: str):
        self.kv.set(self.k(self.me, "validation"), _dumps((artifact, checksum)))

    def load_validation(self) -> Optional[Tuple[Any, str]]:
        blob = self.kv.get(self.k(self.me, "validation"))
        return None if blob is None else _loads(blob)
