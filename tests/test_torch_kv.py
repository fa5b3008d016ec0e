"""The port's control plane: the tetrikv client (runtime/kv.py), the run
state over it (runtime/training_state.py) and the HTTP sidecar
(cli/sidecar.py).

* the client's primitives, TTLs, the atomic claim and SAVE, on a
  server the port builds from native/kvstore (g++, build.sh's flags);
* interop: the port's client and the JAX package's on one server read
  what the other wrote, through both TrainingStates too;
* the TrainingState round trip (slots, weights, queue, clock, heartbeats,
  runner state and validation), with numpy arrays on the wire;
* the sidecar's four pages.
Every server listens on a free port found at run time.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import json  # noqa: E402
import os  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import urllib.request  # noqa: E402
from http.server import HTTPServer  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.runtime import kv as jkv  # noqa: E402
from drl_tetris_tpu.runtime import training_state as jts  # noqa: E402
from drl_tetris_tpu_torch.cli.sidecar import make_handler  # noqa: E402
from drl_tetris_tpu_torch.runtime.kv import (KVClient, free_port,  # noqa: E402
                                             launch_server, server_binary)
from drl_tetris_tpu_torch.runtime.training_state import TrainingState  # noqa: E402


@pytest.fixture(scope="module")
def port():
    p = free_port()
    proc = launch_server(p)
    yield p
    proc.kill()
    proc.wait()


def test_server_binary_is_built_from_the_source():
    path = server_binary()
    assert os.access(path, os.X_OK)
    assert os.path.basename(path).startswith("tetrikv-")
    assert server_binary() == path                  # built once


def test_kv_primitives(port):
    kv = KVClient(port=port)
    assert kv.ping()
    kv.set("a/b", b"hello\nworld\x00binary")
    assert kv.get("a/b") == b"hello\nworld\x00binary"
    assert kv.get("missing") is None
    assert kv.incr("ctr", 5) == 5
    assert kv.incr("ctr", 2) == 7
    kv.push("q", b"one")
    kv.push("q", b"two")
    assert kv.qlen("q") == 2
    assert list(kv.pop_iter("q")) == [b"one", b"two"]
    assert kv.pop("q") is None
    assert abs(kv.fincr("f", 0.5) - 0.5) < 1e-9
    assert abs(kv.fincr("f", 0.25) - 0.75) < 1e-9
    kv.set("pre/x", b"1")
    kv.set("pre/y", b"2")
    assert set(kv.keys("pre/")) == {"pre/x", "pre/y"}
    kv.delete("pre/x")
    assert kv.keys("pre/") == ["pre/y"]
    kv.close()
    assert not KVClient(port=free_port(), timeout=1.0).ping()


def test_kv_ttl_and_claim(port):
    kv = KVClient(port=port)
    # the first caller wins a claim, the second does not
    # (redis_types.py:118-131), until the TTL lapses
    assert kv.claim("slot", 0.3)
    assert not kv.claim("slot", 0.3)
    time.sleep(0.5)
    assert kv.claim("slot", 0.3)
    kv.set("tmp", b"v")
    assert kv.expire("tmp", 0.2)
    assert kv.get("tmp") == b"v"
    time.sleep(0.4)
    assert kv.get("tmp") is None
    kv.close()


def test_kv_persistence(port, tmp_path):
    """SAVE writes the store's entries to a file."""
    kv = KVClient(port=port)
    kv.set("persist/me", b"payload")
    path = str(tmp_path / "dump.kv")
    assert kv.save(path) and os.path.getsize(path) > 0
    kv.close()
    with open(path, "rb") as f:
        assert b"persist/me" in f.read()


def test_interop_with_the_jax_client(port):
    """One server, both clients: each reads what the other wrote."""
    mine, theirs = KVClient(port=port), jkv.KVClient(port=port)
    mine.set("x/port", b"from the port")
    theirs.set("x/jax", b"from jax")
    assert theirs.get("x/port") == b"from the port"
    assert mine.get("x/jax") == b"from jax"
    mine.push("x/q", b"1")
    theirs.push("x/q", b"2")
    assert theirs.pop("x/q") == b"1" and mine.pop("x/q") == b"2"
    assert theirs.incr("x/c", 3) == 3 and mine.incr("x/c", 4) == 7
    assert mine.claim("x/slot", 5.0) and not theirs.claim("x/slot", 5.0)
    assert sorted(theirs.keys("x/")) == sorted(mine.keys("x/"))
    # the typed state: the JAX side's weights and queue, read by the port
    jside = jts.TrainingState("interop", role="trainer", port=port)
    side = TrainingState("interop", port=port)
    assert side.me == "worker-0"
    assert jside.publish_weights({"w": np.arange(4.0)}) == 1
    idx, w = side.fetch_weights()
    assert idx == 1 and (w["w"] == np.arange(4.0)).all()
    side.push_data({"batch": np.ones(3, np.float32)})
    (packet,) = list(jside.pop_data_iter())
    assert (packet["batch"] == 1.0).all()
    side.tick_clock(5)
    assert jside.clock() == 5
    mine.close()
    theirs.close()


def test_training_state_roundtrip(port):
    ts_t = TrainingState("testrun", role="trainer", port=port)
    ts_w = TrainingState("testrun", port=port)
    assert ts_w.me == "worker-0"
    ts_w2 = TrainingState("testrun", port=port)
    assert ts_w2.me == "worker-1"

    weights = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    assert ts_t.publish_weights(weights) == 1
    assert ts_w.weights_index() == 1
    got_idx, got = ts_w.fetch_weights()
    assert got_idx == 1
    np.testing.assert_array_equal(got["w"], weights["w"])

    ts_w.push_data({"batch": [1, 2, 3]})
    assert ts_t.queue_len() == 1
    assert list(ts_t.pop_data_iter()) == [{"batch": [1, 2, 3]}]

    assert ts_w.tick_clock(30) == 30 and ts_t.clock() == 30
    ts_t.heartbeat()
    ts_w.heartbeat()
    assert {"trainer", "worker-0"} <= set(ts_t.alive_roles())
    ts_w.unset_alive()
    assert "worker-0" not in ts_t.alive_roles()
    # a freed slot is claimed again (training_state.py:43-52)
    assert TrainingState("testrun", port=port).me == "worker-0"

    ts_w.store_runner_state(b"state-bytes")
    ts_w.store_validation(None, "abc")
    assert ts_w.load_runner_state() == b"state-bytes"
    assert ts_w.load_validation() == (None, "abc")
    ts_t.stats_set("losses/x", 1.5)
    assert abs(ts_t.stats_incr("count", 2.0) - 2.0) < 1e-9


def test_sidecar_pages(port):
    kv = KVClient(port=port)
    kv.set("side/stats/loss", b"0.5")
    kv.set("side/trainer/alive", b"1")
    server = HTTPServer(("127.0.0.1", 0), make_handler(kv, "side"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.read().decode()
        assert "side/stats/loss" in get("/")
        assert json.loads(get("/key/side/stats/loss")) == {
            "key": "side/stats/loss", "value": "0.5", "bytes": 3}
        assert json.loads(get("/stats")) == {"side/stats/loss": "0.5"}
        assert json.loads(get("/alive")) == ["side/trainer/alive"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        kv.close()
    assert not thread.is_alive()
