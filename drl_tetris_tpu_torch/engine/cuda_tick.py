"""Wrapper of the engine tick kernel (csrc/engine_tick.cu), the port of the
TPU kernel ``drl_tetris_tpu/engine/pallas_tick.py::_rollout``.

Two entries, each with its plain PyTorch version beside it:

* ``step(cfg, state, r, t, kind=None, y=None) -> (state', reward,
  done)``: one env tick; the NN-in-the-loop rollouts and evaluation call
  it between policy forwards.  ``kind`` (N,) picks each game's make phase
  (0 macro, 1 placement, 2 pose lock at row ``y``) and launches the
  kernel's per-kind instantiation; without it the macro-only one runs.
  Plain version: ``env.env.step_plain``.
* ``rollout(cfg, state, n_ticks, actions=(r, t) | base_key=..,
  block_games=..)``: T ticks in one launch, the contract of
  ``rollout_pallas``.  Plain version: ``rollout_plain``.

A wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  The kernel is built with nvcc from the
repository's source on first use into ``build/torch_kernels/`` (keyed by
the source's hash) and loaded with ctypes.  Each state leaf is passed as a
device pointer, in the order of ``LEAF_NAMES`` (== ``enum Leaf`` in the
source), through two host arrays that the C entry copies into the kernel's
by-value parameter structs.  Outputs are fresh tensors: the entries are
functional like the JAX ones.

The one-tick entry runs once per env step of the self-play rollout, so its
host side is kept short: the leaves are read by name and each leaf's
pointer once, the per-config words and the per-shape leaf specs are
cached, and the outputs are 45 ``empty_like`` calls (cutting one flat
buffer into 45 typed views costs more host time per call).

``LAUNCHES`` counts kernel launches per entry, ``step_kinds`` for the
per-kind instantiation of the one-tick entry (the plain path never
counts).
A combo count past the payout table sets a flag word on the device:
``rollout`` checks it after its launch, and callers of ``step`` check it
once per rollout with ``raise_if_overflowed`` (a per-tick check would wait
for the device every tick).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from drl_tetris_tpu_torch.engine.core import (ROW_MASKS, SPAWN_ROT,
                                              EngineState, PlayerState)
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.engine.step import COMBO_POW_BITS, DUR_SLOPE
from drl_tetris_tpu_torch.env.env import EnvConfig, EnvState, step_plain

LAUNCHES = {"step": 0, "step_kinds": 0, "rollout": 0}

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "engine_tick.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]
MAX_H, MAX_CAP = 32, 64

# EnvState leaves in kernel order, with dtype and per-game trailing shape.
LEAF_NAMES = (
    "occ", "garb", "piece", "rot", "px", "py", "cur_rows", "nextpiece",
    "time_ms", "drop_delay", "drop_delay_time", "incr_dd_time", "lockdown",
    "lockdown_time", "combo_start", "combo_time", "combo_count",
    "combo_line_count", "combo_remaining", "g_count", "g_delay", "g_size",
    "g_min_remaining", "incoming_lines", "incoming_count", "lines_sent",
    "lines_recv", "garbage_cleared", "lines_cleared", "lines_blocked",
    "max_combo", "lines_cleared_snap", "reward", "dead", "cogp", "lasthole",
    "piece_key", "hole_key", "piece_draws", "hole_draws",
    "round_over", "last_winner", "current_player", "key", "rounds_played",
)
_BOOL = {"lockdown", "dead", "round_over"}
_FLOAT = {"incoming_lines", "cogp"}
_N_PLAYER = LEAF_NAMES.index("round_over")      # PlayerState leaves first
_PTRS = ctypes.c_int64 * len(LEAF_NAMES)
_PLAYER_LEAVES = LEAF_NAMES[:_N_PLAYER]


@functools.lru_cache(maxsize=64)
def _leaf_spec(cfg: EnvConfig, n: int):
    """(name, dtype, shape, pair) per leaf for n games; ``pair``: the
    kernel reads both players' words of an (N, 2) 32-bit leaf as one
    8-byte word, so its pointer must be 8-byte aligned."""
    e = cfg.engine
    trail = {"occ": (2, e.height), "garb": (2, e.height), "cur_rows": (2, 4),
             "g_count": (2, e.garbage_cap), "g_delay": (2, e.garbage_cap),
             "cogp": (2, 7), "piece_key": (2, 2), "hole_key": (2, 2),
             "round_over": (), "last_winner": (), "current_player": (),
             "key": (2,), "rounds_played": ()}
    spec = []
    for name in LEAF_NAMES:
        dt = (torch.bool if name in _BOOL else
              torch.float32 if name in _FLOAT else torch.int32)
        shape = (n,) + trail.get(name, (2,))
        spec.append((name, dt, torch.Size(shape),
                     shape[1:] == (2,) and dt != torch.bool))
    return tuple(spec)


@functools.lru_cache(maxsize=64)
def _config_words(cfg: EnvConfig) -> np.ndarray:
    """icfg of the C entries (``enum CfgWord``); cached, read-only."""
    e = cfg.engine
    if e.n_players != 2:
        raise ValueError("the engine kernel runs two-player games")
    if e.height > MAX_H or e.garbage_cap > MAX_CAP:
        raise ValueError(f"kernel limits: height <= {MAX_H}, "
                         f"garbage_cap <= {MAX_CAP}")
    words = np.array([e.height, e.width, e.garbage_cap, e.max_seed_rerolls,
                      e.garbage_initial_delay, e.garbage_add_delay,
                      e.garbage_freeze_delay, e.combo_line_mult,
                      e.combo_static_mult, e.lockdown_ms,
                      cfg.time_elapsed_each_action, int(cfg.extra_rewards),
                      int(e.only_zs), *e.piece_map], dtype=np.int32)
    words.flags.writeable = False
    return words


def state_leaves(cfg: EnvConfig, state: EnvState):
    """(leaves, pointers): the state's leaves in kernel order, checked for
    device, dtype, shape, contiguity and alignment, and their device
    pointers as the C entries take them."""
    eng = state.engine
    fields = vars(eng.players)
    leaves = [fields[k] for k in _PLAYER_LEAVES] + [
        eng.round_over, eng.last_winner, state.current_player, state.key,
        state.rounds_played]
    dev = state.current_player.get_device()
    spec = _leaf_spec(cfg, state.current_player.shape[0])
    ptrs = [t.data_ptr() for t in leaves]
    for (name, dt, shape, pair), t, ptr in zip(spec, leaves, ptrs):
        if t.dtype is not dt or t.shape != shape or not t.is_contiguous() \
                or t.get_device() != dev or (pair and ptr & 7):
            raise ValueError(
                f"leaf {name}: got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()}, address {t.data_ptr()}); "
                f"the kernel takes contiguous {dt} {tuple(shape)} on "
                f"{state.current_player.device}, 8-byte aligned")
    return leaves, _PTRS(*ptrs)


def unflatten(leaves) -> EnvState:
    """The EnvState of leaves in kernel order."""
    ps = PlayerState(**dict(zip(_PLAYER_LEAVES, leaves)))
    rest = leaves[_N_PLAYER:]
    return EnvState(engine=EngineState(players=ps, round_over=rest[0],
                                       last_winner=rest[1]),
                    current_player=rest[2], key=rest[3],
                    rounds_played=rest[4])


_DEVICE_TABLES = {}


def device_tables(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table, flags) on ``device``: the uint32 table [ROW_MASKS (112),
    SPAWN_ROT (7), COMBO_POW_BITS (256)] as int32 words, and the int32
    overflow flag word the kernel ORs into."""
    t = _DEVICE_TABLES.get(device)
    if t is None:
        words = np.concatenate([ROW_MASKS.reshape(-1).astype(np.uint32),
                                SPAWN_ROT.astype(np.uint32),
                                COMBO_POW_BITS]).view(np.int32)
        t = (torch.as_tensor(words.copy(), device=device),
             torch.zeros(1, dtype=torch.int32, device=device))
        _DEVICE_TABLES[device] = t
    return t


def raise_if_overflowed(device) -> None:
    """Raise if a launch on ``device`` met a combo count past the payout
    table (waits for the device)."""
    _, flags = device_tables(torch.device(device))
    if int(flags.item()) & 1:
        raise OverflowError(
            f"combo count beyond the payout table ({len(COMBO_POW_BITS)})")


def _ptr_array(tensors):
    return _PTRS(*[t.data_ptr() for t in tensors])


def step_args(cfg: EnvConfig, state: EnvState, r, t, kind=None, y=None):
    """Validate, allocate the outputs and marshal the C arguments of the
    one-tick entry (without the stream); ``kind`` and ``y`` (N,) select
    the per-kind instantiation.  Returns (args, keep, outputs): ``keep``
    must stay alive until the call returns."""
    leaves, pin = state_leaves(cfg, state)
    n = leaves[0].shape[0]
    dev = leaves[0].device
    if (kind is None) != (y is None):
        raise ValueError("pass both kind and y, or neither")
    for a in (r, t) if kind is None else (r, t, kind, y):
        if a.device != dev or a.dtype != torch.int32 or \
                tuple(a.shape) != (n,) or not a.is_contiguous():
            raise ValueError("actions must be contiguous int32 (N,) tensors "
                             "on the state's device")
    outs = [torch.empty_like(x) for x in leaves]
    reward = torch.empty(n, dtype=torch.float32, device=dev)
    done = torch.empty(n, dtype=torch.bool, device=dev)
    tab, flags = device_tables(dev)
    icfg = _config_words(cfg)
    pout = _ptr_array(outs)
    args = (icfg.ctypes.data, cfg.reward_base_weight, cfg.reward_combo_weight,
            DUR_SLOPE, ctypes.addressof(pin), ctypes.addressof(pout),
            r.data_ptr(), t.data_ptr(),
            None if kind is None else kind.data_ptr(),
            None if y is None else y.data_ptr(), reward.data_ptr(),
            done.data_ptr(), tab.data_ptr(), flags.data_ptr(), n)
    keep = (icfg, pin, pout, leaves)
    return args, keep, (outs, reward, done)


def rollout_args(cfg: EnvConfig, state: EnvState, n_ticks: int,
                 actions, base_key, block_games: int):
    """As step_args, for the T-tick entry."""
    leaves, pin = state_leaves(cfg, state)
    n = leaves[0].shape[0]
    dev = leaves[0].device
    if actions is not None:
        ar, at = actions
        for a in (ar, at):
            if a.device != dev or a.dtype != torch.int32 or \
                    tuple(a.shape) != (n_ticks, n) or not a.is_contiguous():
                raise ValueError("actions must be contiguous int32 (T, N) "
                                 "tensors on the state's device")
        pa, pt, k0, k1 = ar.data_ptr(), at.data_ptr(), 0, 0
    else:
        k = [int(v) & rng.M32 for v in base_key]
        pa, pt, k0, k1 = None, None, k[0], k[1]
    outs = [torch.empty_like(x) for x in leaves]
    tab, flags = device_tables(dev)
    icfg = _config_words(cfg)
    pout = _ptr_array(outs)
    args = (icfg.ctypes.data, cfg.reward_base_weight, cfg.reward_combo_weight,
            DUR_SLOPE, ctypes.addressof(pin), ctypes.addressof(pout),
            n_ticks, pa, pt, k0, k1, block_games, tab.data_ptr(),
            flags.data_ptr(), n)
    keep = (icfg, pin, pout, leaves, actions)
    return args, keep, outs


def declare(fn_step, fn_rollout, with_stream: bool) -> None:
    """ctypes signatures of the two entries (CUDA library or host build)."""
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_uint32
    tail = [P] if with_stream else []
    fn_step.argtypes = [P, F, F, F, P, P, P, P, P, P, P, P, P, P, I] + tail
    fn_step.restype = I
    fn_rollout.argtypes = [P, F, F, F, P, P, I, P, P, U, U, I, P, P, I] + tail
    fn_rollout.restype = I


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_LIB = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the engine kernel is built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def build(source: Path = SOURCE) -> Tuple[Path, str]:
    """Compile ``source`` (csrc/engine_tick.cu) into build/torch_kernels/
    unless the library for this exact source exists.  Returns (library
    path, the compiler's report: ptxas registers, spills and stack per
    kernel)."""
    digest = hashlib.sha1(Path(source).read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libengine_tick-{digest}.so"
    log = out.with_suffix(".ptxas.txt")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    log.write_text(res.stderr)
    os.replace(tmp, out)
    return out, res.stderr


def open_library(path):
    """A built library of the kernel, with its entries' ctypes
    signatures."""
    lib = ctypes.CDLL(str(path))
    declare(lib.engine_tick_step, lib.engine_tick_rollout, True)
    lib.engine_tick_n_leaves.restype = ctypes.c_int
    if lib.engine_tick_n_leaves() != len(LEAF_NAMES):
        raise RuntimeError("kernel leaf count does not match LEAF_NAMES")
    return lib


def load():
    """The library built from csrc/engine_tick.cu."""
    global _LIB
    if _LIB is None:
        _LIB = open_library(build()[0])
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a C entry."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------

def step(cfg: EnvConfig, state: EnvState, rotations, translations,
         kind=None, y=None) -> Tuple[EnvState, torch.Tensor, torch.Tensor]:
    """One env tick: (state', reward, done).  CPU tensors run step_plain;
    CUDA tensors launch the kernel's one-tick entry (its per-kind
    instantiation when ``kind`` is given)."""
    dev = state.current_player.device
    if dev.type == "cpu":
        return step_plain(cfg, state, rotations, translations, kind, y)
    if dev.type != "cuda":
        raise ValueError(f"no engine path for device {dev}")
    r = rotations.to(torch.int32).contiguous()
    t = translations.to(torch.int32).contiguous()
    if kind is not None:
        kind = kind.to(torch.int32).contiguous()
        y = y.to(torch.int32).contiguous()
    args, keep, (outs, reward, done) = step_args(cfg, state, r, t, kind, y)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib.engine_tick_step(*args, stream), "engine_tick_step")
    LAUNCHES["step" if kind is None else "step_kinds"] += 1
    del keep
    return unflatten(outs), reward, done


def random_actions(cfg: EnvConfig, base_key, tick: int, n: int,
                    block_games: int):
    """The in-kernel action stream of a tick: bits of game i are
    random_bits(fold_in(fold_in(base_key, tick), i // block_games)) at
    index i % block_games."""
    dev = base_key.device
    base = rng.u32(base_key)
    kt = rng.fold_in(base, tick)
    kb = rng.fold_in(kt[None, :].expand(n // block_games, 2),
                     torch.arange(n // block_games, device=dev))
    idx = torch.arange(block_games, dtype=torch.int64, device=dev)[None, :]
    b1, b2 = rng.threefry2x32(kb[:, 0, None], kb[:, 1, None], 0, idx)
    bits = (b1 ^ b2).reshape(n)
    return (bits % 4).to(torch.int32), \
        ((bits >> 16) % cfg.engine.width).to(torch.int32)


def _block_games(n: int, block_games: int, actions, base_key) -> int:
    """The random action stream's block size for n games (capped at n;
    replayed actions do not read it)."""
    if (actions is None) == (base_key is None):
        raise ValueError("pass exactly one of actions and base_key")
    block_games = min(block_games, n)
    if base_key is not None and n % block_games:
        raise ValueError(f"n_games {n} is not a multiple of block_games "
                         f"{block_games}")
    return block_games


def rollout_plain(cfg: EnvConfig, state: EnvState, n_ticks: int, *,
                  actions=None, base_key=None, block_games: int = 128
                  ) -> EnvState:
    """T env ticks in plain PyTorch, with the kernel's action sources."""
    n = state.current_player.shape[0]
    block_games = _block_games(n, block_games, actions, base_key)
    if base_key is not None:
        base_key = torch.as_tensor(base_key).to(state.current_player.device)
    for tick in range(n_ticks):
        if actions is not None:
            r, t = actions[0][tick], actions[1][tick]
        else:
            r, t = random_actions(cfg, base_key, tick, n, block_games)
        state, _, _ = step_plain(cfg, state, r, t)
    return state


def rollout(cfg: EnvConfig, state: EnvState, n_ticks: int, *,
            actions: Optional[tuple] = None, base_key=None,
            block_games: int = 128) -> EnvState:
    """Advance every game ``n_ticks`` ticks: ``actions=(r, t)`` two (T, N)
    int arrays, or ``base_key`` (2,) key words for the in-kernel random
    actions, whose stream depends on ``block_games``."""
    n = state.current_player.shape[0]
    block_games = _block_games(n, block_games, actions, base_key)
    dev = state.current_player.device
    if dev.type == "cpu":
        return rollout_plain(cfg, state, n_ticks, actions=actions,
                             base_key=base_key, block_games=block_games)
    if dev.type != "cuda":
        raise ValueError(f"no engine path for device {dev}")
    if actions is not None:
        actions = tuple(a.to(torch.int32).contiguous() for a in actions)
    else:
        base_key = rng.u32(base_key).tolist()
    args, keep, outs = rollout_args(cfg, state, n_ticks, actions, base_key,
                                    block_games)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib.engine_tick_rollout(*args, stream), "engine_tick_rollout")
    LAUNCHES["rollout"] += 1
    del keep
    raise_if_overflowed(dev)
    return unflatten(outs)
