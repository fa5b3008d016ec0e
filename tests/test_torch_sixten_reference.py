"""The port's SIXten against the benchmark's plain reference
(benchmark/reference: sixten.py, placement.py, replay.py,
value_estimator.py) on seeded random weights, small sizes, the CPU: the
VNet's forward, the top-drop placement masks and successor boards, the
placement step, the replay's add and rank sample from given noise, the
k-step targets, and one update's gradient and priorities.  The benchmark's
``sixten_train`` judge rests on these agreeing at float32."""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

from benchmark.reference import placement as RP  # noqa: E402
from benchmark.reference import replay as RR  # noqa: E402
from benchmark.reference import sixten as RS  # noqa: E402
from benchmark.reference import value_estimator as RV  # noqa: E402
from benchmark.reference.compare import (as_reference_state,  # noqa: E402
                                         mismatches)
from benchmark.reference.observations import field_grid  # noqa: E402
from benchmark.programs import _plain  # noqa: E402
from benchmark.work.engine import env_config  # noqa: E402
from drl_tetris_tpu_torch.algos import replay, sixten  # noqa: E402
from drl_tetris_tpu_torch.algos.rollout import Segment  # noqa: E402
from drl_tetris_tpu_torch.algos.value_estimator import (  # noqa: E402
    EstimatorConfig, kstep_targets)
from drl_tetris_tpu_torch.engine import masks, rng  # noqa: E402
from drl_tetris_tpu_torch.engine.checks import crowded  # noqa: E402
from drl_tetris_tpu_torch.engine.core import EngineConfig  # noqa: E402
from drl_tetris_tpu_torch.env.env import (EnvConfig,  # noqa: E402
                                          TetrisVectorEnv, take_player)
from drl_tetris_tpu_torch.models.nets import ModelConfig  # noqa: E402

MODEL = dict(compute_dtype="float32", architecture="silver", n_rotations=4,
             n_pieces=7, tower_layers=1, tower_filters=4,
             tower_filter_size=3, val_layers=2, val_filters=4,
             val_filter_size=5, dropout=0.0, separate_piece_values=True,
             visual_stack=(), used_pieces=(0, 6))
ENGINE = EngineConfig(piece_map=(0, 6, 0, 6, 0, 6, 0))
N = 6
TOL = 1e-5        # float32 against float32: the same operations in the
                  # same order up to the convolution's summation order


def ref_env_config():
    """The reference's EnvConfig of the port's, through the configuration
    file's form."""
    return env_config({"env": _plain(EnvConfig(engine=ENGINE))})


def nets(seed):
    """The port's float32 VNet and the reference's, the same weights: the
    convs at N(0, 1/fan_in), biases N(0, 0.1), the value channel's bias
    -3 (the spawn x rides the peepholes into it)."""
    port = sixten.VNet(ModelConfig(**MODEL), device="cpu")
    ref = RS.VNet(dict(MODEL, visual_stack=[]), (22, 10))
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in port.state_dict().items():
        x = torch.randn(v.shape, generator=g)
        sd[k] = x / (v[0].numel() ** 0.5) if v.ndim == 4 else 0.1 * x
    sd["value_tower.convs.1.bias"][0] -= 3.0
    port.load_state_dict(sd)
    ref.load_state_dict(sd)
    return port, ref


def states(seed):
    env = TetrisVectorEnv(EnvConfig(engine=ENGINE), N, device="cpu")
    return env, crowded(env.cfg, env.reset(seed), seed)


def stored(seed, n):
    """n stored states (occ (n, 2, H), vec (n, 2, 12), piece (n,)) of
    crowded games."""
    _, st = states(seed)
    ps = st.engine.players
    g = torch.Generator().manual_seed(seed)
    pick = torch.randint(0, N, (n,), generator=g)
    occ = ps.occ[pick]
    vec = torch.rand((n, 2, 12), generator=g)
    piece = torch.tensor([0, 6])[torch.randint(0, 2, (n,), generator=g)]
    return occ, vec, piece.to(torch.int32)


def test_vnet_forward_matches():
    port, ref = nets(1)
    occ, vec, _ = stored(2, 16)
    grids = field_grid(ENGINE, occ)
    args = ([vec[:, 0], vec[:, 1]],
            [grids[:, 0, :, :, None], grids[:, 1, :, :, None]])
    with torch.no_grad():
        a, b = port(*args), ref(*args)
    assert a.shape == b.shape == (16, 7)
    assert (a - b).abs().max() <= TOL * b.abs().max()
    assert b[:, [0, 6]].std() > 1e-2


def test_placement_masks_and_boards_match():
    _, st = states(3)
    ps, p = st.engine.players, st.current_player
    occ, garb, piece, rot = (take_player(x, p) for x in (
        ps.occ, ps.garb, ps.piece, ps.rot))
    mask, after, _ = masks.placement_boards(ENGINE, occ, garb, piece, rot)
    rmask, rafter = RP.top_drop_boards(ENGINE, occ, garb, piece, rot)
    assert torch.equal(mask, rmask) and torch.equal(after, rafter)
    assert 0 < int(mask.sum()) < mask.numel()


def test_placement_step_matches():
    env, st = states(4)
    ref = as_reference_state(st)
    cfg = ref_env_config()
    g = torch.Generator().manual_seed(4)
    for _ in range(3):
        r = torch.randint(0, 4, (N,), generator=g, dtype=torch.int32)
        x = torch.randint(-1, 9, (N,), generator=g, dtype=torch.int32)
        st, rew, done = env.step_place(st, r, x)
        ref, rrew, rdone = RP.step_place(cfg, ref, r, x)
        assert mismatches(as_reference_state(st), ref) == 0
        assert torch.equal(rew, rrew) and torch.equal(done, rdone)


def test_successor_choice_matches_the_policy():
    port, ref = nets(5)
    env, st = states(5)
    policy = sixten.make_sixten_policy(env, port, "epsilon", 0.3)
    key = rng.prng_key(5, "cpu")
    _, _, r_rel, x, prob, v_sel, _ = policy(st, key)
    rst = as_reference_state(st)
    mask, v_next, _ = RS.successor_values(ENGINE, ref, rst)
    explores, pick = RS.explore(key, mask, 0.3)
    choice = RS.choose(mask, v_next, explores, pick)
    rot = RP.acting_player(rst)["rot"]
    assert torch.equal(torch.remainder(choice // 10 - rot, 4).int(), r_rel)
    assert torch.equal((choice % 10 - 1).int(), x)
    assert torch.equal(RS.legal_prob(mask), prob)
    got = v_next.gather(1, choice[:, None])[:, 0]
    assert (got - v_sel).abs().max() <= TOL


def filled_replay(seed, capacity=256):
    cfg = replay.ReplayConfig(capacity=capacity, k_step=5, sample_mode="rank")
    st = replay.replay_init(cfg, "cpu")
    g = torch.Generator().manual_seed(seed)
    T, n = 8, 24
    occ, vec, piece = stored(seed, T * n)
    seg = {"occ": occ.reshape(T, n, 2, 22), "vec": vec.reshape(T, n, 2, 12),
           "piece": piece.reshape(T, n),
           "rot": torch.randint(0, 4, (T, n), generator=g, dtype=torch.int32),
           "trans": torch.randint(0, 9, (T, n), generator=g,
                                  dtype=torch.int32),
           "reward": torch.randint(-1, 2, (T, n), generator=g).float(),
           "done": torch.rand((T, n), generator=g) < 0.1}
    z = torch.zeros(T, n)
    replay.replay_add_segment(cfg, st, Segment(
        prob=z, v_piece=z, v_mean=z, player=z.int(), **seg), T)
    ref = {f: torch.zeros_like(getattr(st, f)) for f in RR.FIELDS}
    ref.update(prio=torch.full((capacity,), -1.0), cursor=0, size=0)
    RR.add_segment(ref, seg, capacity, 5)
    # three quarters sampled before, some ties left at 2 and 0
    rows = torch.randperm(st.size, generator=g)[:st.size * 3 // 4]
    st.prio[rows] = (0.3 * torch.randn(rows.shape[0], generator=g)).abs()
    ref["prio"][rows] = st.prio[rows]
    return cfg, st, ref


def test_replay_add_and_rank_sample_match():
    cfg, st, ref = filled_replay(6)
    for f in RR.FIELDS + ("prio",):
        assert torch.equal(getattr(st, f), ref[f].to(getattr(st, f).dtype))
    assert (st.cursor, st.size) == (ref["cursor"], ref["size"])
    key = rng.prng_key(6, "cpu")
    noise = RR.noise(key, cfg.capacity)
    assert torch.equal(noise, rng.gumbel(key, (cfg.capacity,)))
    idx, iw = replay.replay_sample(cfg, st, 64, 0.7, 0.5, key)
    ridx, riw = RR.sample(ref["prio"], ref["size"], 64, 0.7, 0.5, noise)
    assert torch.equal(idx, ridx) and torch.equal(iw, riw)


def test_kstep_targets_and_update_match():
    port, ref = nets(7)
    cfg, st, rref = filled_replay(7)
    idx = torch.arange(0, 160, 5)
    win = replay.replay_gather_windows(cfg, st, idx)
    rwin = RR.gather_windows(rref, idx, cfg.capacity, 5)
    for k in rwin:
        assert torch.equal(win[k], rwin[k].to(win[k].dtype))
    est = EstimatorConfig(k_step=5)
    t = kstep_targets(ENGINE, port, est, win)
    rt = RV.kstep_targets(ENGINE, ref, rwin, est.steps, est.effective_gamma,
                          est.lam)
    assert (t - rt).abs().max() <= TOL
    iw = torch.rand(idx.shape[0], generator=torch.Generator().manual_seed(7))
    mb = {"occ0": win["occ"][:, 0], "vec0": win["vec"][:, 0],
          "piece": win["piece"], "target": t}
    scfg = sixten.SixtenConfig(nn_regularizer=1e-4)
    loss, prios, _ = sixten.sixten_loss(ENGINE, scfg, port, mb, iw)
    port.zero_grad()
    loss.backward()
    grads, rprios = RS.gradient(ENGINE, 1e-4, ref, rwin["occ"][:, 0],
                                rwin["vec"][:, 0], rwin["piece"], rt, iw)
    assert (prios - rprios).abs().max() <= TOL
    for name, p in port.named_parameters():
        scale = grads[name].abs().max()
        assert (p.grad - grads[name]).abs().max() <= 1e-4 * scale, name
    # one Adam step from fresh moments: torch.optim.Adam's
    opt = torch.optim.Adam(port.parameters(), lr=1e-3)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt.step()
    for name, p in port.named_parameters():
        z = torch.zeros_like(p)
        want = RS.adam_step(before[name], p.grad, z, z.clone(), 1, 1e-3)
        assert torch.allclose(p.detach(), want, rtol=0, atol=1e-7), name
