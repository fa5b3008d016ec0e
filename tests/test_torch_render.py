"""The port's renderer (utils/render.py, utils/render_pygame.py) and the
rendered match (runtime/evaluate.py ``play_match(render=True)``) against
the JAX package's:

* ``field_arrays`` and ``render_ansi`` of the same engine states (a batch
  after 40 random ticks on a 12 x 8 board, garbage included, and one
  game's state without the game axis): equal arrays and equal text;
  ``progress_bar`` equal;
* a rendered match of two ``argmax`` agents from the same seeded weights
  (a small float32 net): JAX's frames line for line, the fields exactly,
  the probe lines' entropy and value within a unit of their last printed
  digit (their unrounded values within PROBE_TOL on the same state);
* the pygame window on SDL's dummy video output: a drawn frame, and a
  match played with ``pygame=True``.

JAX's rendered match is committed (tests/jax_fixtures/render_match.npz,
tests/torch_jax_fixtures.py); a ``slow`` test plays it again with JAX and
holds it to the file.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache, to_torch_state
from tests import torch_jax_fixtures as fixtures

rekey_jax_cache()

import re  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402
from drl_tetris_tpu.env.env import (EnvConfig as JEnvConfig,  # noqa: E402
                                    TetrisVectorEnv as JEnv)
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu.runtime import evaluate as jevaluate  # noqa: E402
from drl_tetris_tpu.utils import render as jrender  # noqa: E402
from drl_tetris_tpu_torch.engine.core import EngineConfig, tree_map  # noqa: E402
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv  # noqa: E402
from drl_tetris_tpu_torch.runtime import evaluate  # noqa: E402
from drl_tetris_tpu_torch.utils import render  # noqa: E402
from tests.test_torch_env_spaces import to_jax_state  # noqa: E402
from tests.test_torch_eval import board_params, port_net  # noqa: E402
from tests.test_torch_nets import SMALL  # noqa: E402

H, W, N = 12, 8, 6
PROBE_TOL = 1e-4
PROBE = re.compile(r"(\[[|-]*\]) H=(-?[\d.]+) v=([+-][\d.]+) (\S+)$")


@pytest.fixture(scope="module")
def states():
    """A JAX env state after 40 ticks of random actions, and the port's
    copy of it."""
    jenv = JEnv(JEnvConfig(engine=JEngineConfig(height=H, width=W)), N)
    step = jax.jit(jenv.step)
    js = jenv.reset(jax.random.PRNGKey(3))
    rs = np.random.RandomState(4)
    for _ in range(40):
        js, _, _ = step(js, rs.randint(0, 4, N), rs.randint(0, W, N))
    env = TetrisVectorEnv(EnvConfig(engine=EngineConfig(height=H, width=W)),
                          N, device="cpu")
    ts = to_torch_state(js, env.reset(0))
    # garbage rows under two games' stacks (the bottom rows, a hole each)
    ps = ts.engine.players
    rows = torch.tensor([0b11101111, 0b10111111], dtype=torch.int32)
    ps.garb[:2, 1, H - 2:] = rows
    ps.occ[:2, 1, H - 2:] |= rows
    return to_jax_state(ts, js), ts


def test_field_arrays_and_ansi_match_jax(states):
    js, ts = states
    jcfg, cfg = JEngineConfig(height=H, width=W), EngineConfig(height=H,
                                                               width=W)
    ref = jrender.field_arrays(jcfg, js.engine)
    got = render.field_arrays(cfg, ts.engine)
    assert ref.dtype == got.dtype and ref.shape == got.shape == (N, 2, H, W)
    assert (ref == got).all()
    assert (got == 8).any() and (got > 1).any()    # garbage and pieces
    titles = ["left", "right"]
    assert render.render_ansi(cfg, ts.engine, max_games=N, titles=titles) \
        == jrender.render_ansi(jcfg, js.engine, max_games=N, titles=titles)
    one = jax.tree.map(lambda a: a[1], js.engine)
    assert (jrender.field_arrays(jcfg, one)
            == render.field_arrays(cfg, tree_map(lambda a: a[1],
                                                 ts.engine))).all()
    assert render.ansi_field(got[0, 1]) == jrender.ansi_field(ref[0, 1])
    for cur, tot in ((0.0, 3.5), (1.2, 3.5), (9.0, 3.5), (1.0, 0.0)):
        assert render.progress_bar(cur, tot) == jrender.progress_bar(cur,
                                                                     tot)


def frames(text):
    return text.split("\x1b[2J\x1b[H")[1:]


def jax_rendered_match(capsys) -> dict:
    """JAX's rendered match of two argmax agents from seeded weights: the
    result and the frames
    (tests/jax_fixtures/render_match.npz)."""
    params = [board_params(s) for s in (1, 2)]
    jnet = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL))
    jagents = [jevaluate.EvalAgent(name=n, params={"params": p}, net=jnet)
               for n, p in zip("AB", params)]
    jenv = JEnvConfig(engine=JEngineConfig(height=H, width=W))
    capsys.readouterr()
    result = jevaluate.play_match(jenv, tuple(jagents), n_games=1, seed=2,
                                  render=True)
    return dict(result=np.asarray(result),
                frames=frames(capsys.readouterr().out))


# slow: a JAX match program, about 125 s cold
@pytest.mark.slow
def test_rendered_match_fixture_regenerates(capsys):
    fixtures.regenerates("render_match", lambda: jax_rendered_match(capsys))


def test_rendered_match_frames_match_jax(capsys):
    want = fixtures.load("render_match")
    agents = [evaluate.EvalAgent(name=n, net=port_net(p))
              for n, p in zip("AB", [board_params(s) for s in (1, 2)])]
    env = EnvConfig(engine=EngineConfig(height=H, width=W))
    ref_result = tuple(int(x) for x in want["result"])
    ref = [str(f) for f in want["frames"]]
    capsys.readouterr()
    result = evaluate.play_match(env, tuple(agents), n_games=1, seed=2,
                                 render=True)
    got = frames(capsys.readouterr().out)
    assert result == ref_result and result[2] == 0   # the game finished
    assert len(got) == len(ref) > 1
    probes = 0
    for t, (a, b) in enumerate(zip(ref, got)):
        la, lb = a.splitlines(), b.splitlines()
        assert len(la) == len(lb), t
        for x, y in zip(la, lb):
            mx, my = PROBE.search(x), PROBE.search(y)
            if mx is None:
                assert x == y, t                  # a field row, a title
                continue
            probes += 1
            assert my is not None and x[:mx.start()] == y[:my.start()], t
            assert mx.group(1) == my.group(1) and mx.group(4) == my.group(4)
            # printed to 2 and 3 decimals: one unit of the last digit
            for g, unit in ((2, 0.01), (3, 0.001)):
                assert abs(float(mx.group(g)) - float(my.group(g))) \
                    <= unit + 1e-9, (t, x, y)
    assert probes == 2 * len(ref)


def test_probe_values_match_jax(states):
    """The probe's unrounded entropy, its maximum and the value against
    JAX's on the same state."""
    js, ts = states
    params = board_params(1)
    jnet = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL))
    jagent = jevaluate.EvalAgent(name="a", params={"params": params},
                                 net=jnet)
    jenv = JEnvConfig(engine=JEngineConfig(height=H, width=W))
    sig = (jnet, "argmax", "macro", 0.05) * 2
    _, _, _, (jprobe, _) = jevaluate._match_fns(jenv, N, *sig)
    ref = [float(x) for x in jprobe(jagent.params, js)]
    env = TetrisVectorEnv(EnvConfig(engine=EngineConfig(height=H, width=W)),
                          N, device="cpu")
    probe = evaluate.make_probe(env, evaluate.EvalAgent("a",
                                                        port_net(params)))
    got = [x.item() for x in probe(ts)]
    assert got[1] == ref[1]
    for a, b in zip(ref, got):
        assert abs(a - b) <= PROBE_TOL * max(1.0, abs(a)), (ref, got)
    assert evaluate.make_probe(env, evaluate.EvalAgent(
        "w", port_net(params), kind="world_model")) is None


def test_pygame_window_on_sdl_dummy_video(monkeypatch, capsys, states):
    pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    monkeypatch.setenv("SDL_AUDIODRIVER", "dummy")
    _, ts = states
    r = render.get_pygame_renderer(resolution=(320, 240))
    try:
        r.draw_all_fields(render.field_arrays(EngineConfig(height=H, width=W),
                                              ts.engine)[:2])
        assert r.screen.get_size() == (320, 240)
        assert r.screen.get_at((5, 5))[:3] == (10, 10, 10)
    finally:
        r.close()
    a = evaluate.EvalAgent("a", port_net(board_params(1)))
    env = EnvConfig(engine=EngineConfig(height=H, width=W))
    wins = evaluate.play_match(env, (a, a), n_games=1, seed=1, pygame=True)
    assert sum(wins) == 1 and frames(capsys.readouterr().out)
