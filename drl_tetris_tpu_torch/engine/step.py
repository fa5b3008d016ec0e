"""Game-step state machine, macro path, batched over games: the plain
PyTorch version of the engine tick.

Counterpart of ``drl_tetris_tpu/engine/step.py`` (semantics references
there: PythonHandle.cpp, gamePlay.cpp, Garbage.cpp, Combo.cpp,
randomizer.cpp).  Every function works on all N games at once: a "player
view" is a PlayerState whose fields are ``(N, ...)`` (one player), and
branches become per-game selects, as in the JAX package.  This is the
reference the CUDA kernel (csrc/engine_tick.cu, one thread per game with
real branches) is held against bit for bit; it runs on the CPU in the
tests and on the card only for that comparison.

Float32 arithmetic follows what XLA compiles the JAX engine into on the
CPU, not the literal expression, because the JAX package is the reference
bit for bit:

* the bag update ``adjust = (cval/4)*3; cogp - adjust; cogp + adjust/6``
  compiles to ``cval*0.75`` for the chosen piece, fused into
  ``fma(-cval, 0.75, cval)`` (exactly ``cval*0.25``), and ``cogp +
  cval*0.125`` for the others (XLA folds the constants);
* the combo payout's ``1 + t/60000*0.1`` compiles to
  ``fma(t, 0.1f/60000f, 1)`` and its exponent ``1.4 + cc*0.01`` to
  ``fma(cc, 0.01, 1.4)``; ``power`` itself is taken from a table of the
  float32 results of JAX's own ``power`` (``COMBO_POW_BITS``, cc 0..255),
  so neither this version nor the kernel depends on a libm ``pow``;
* the bag draw's ``u*1000 - cogp[0]`` is not fused (its product has two
  uses).

Only the macro path (``step_macro``) is ported; ``step_place``,
``step_pose`` and ``step_keys`` wait for the masks slice.
"""
from __future__ import annotations

import numpy as np
import torch

from drl_tetris_tpu_torch.engine.core import (
    COGP_INIT, EngineConfig, EngineState, PlayerState, tree_map,
    zeros_player_state,
)
from drl_tetris_tpu_torch.engine import kernels as K
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.engine.pieces import SPAWN_ROT

I32 = torch.int32
F32 = torch.float32

# float32 bit patterns of jnp.power(cc, 1.4 + cc*0.01) as XLA compiles it
# (exponent fused), cc = 0..255; shared with the CUDA kernel through the
# device table of engine/cuda_tick.py.
COMBO_POW_BITS = np.array([
    0x00000000, 0x3F800000, 0x402B4135, 0x4099F812, 0x40EB916A, 0x41250DDD,
    0x415AE32C, 0x418BC2A9, 0x41ADA536, 0x41D34E46, 0x41FCFB72, 0x4215791B,
    0x422EBFD3, 0x424A7C36, 0x4268DC77, 0x42850964, 0x42972AC3, 0x42AAEFBC,
    0x42C07807, 0x42D7E5D3, 0x42F15DF8, 0x43068407, 0x4315875D, 0x4325CFE9,
    0x4337764E, 0x434A9502, 0x435F4874, 0x4375AF2F, 0x4386F4FE, 0x43940E08,
    0x43A2359C, 0x43B18001, 0x43C20301, 0x43D3D5F0, 0x43E711E4, 0x43FBD1C0,
    0x44091931, 0x4415295F, 0x44222A04, 0x44302CF0, 0x443F453D, 0x444F876A,
    0x4461096E, 0x4473E2DB, 0x4484167C, 0x448F0172, 0x449AC0D1, 0x44A76430,
    0x44B4FC43, 0x44C39AF4, 0x44D35376, 0x44E43A61, 0x44F665C5, 0x4504F6A6,
    0x450F752B, 0x451ABC08, 0x4526D9D1, 0x4533DE25, 0x4541D9CB, 0x4550DEA8,
    0x45610000, 0x45725273, 0x4582760E, 0x458C7256, 0x45972AC3, 0x45A2ACF2,
    0x45AF0777, 0x45BC49F6, 0x45CA852E, 0x45D9CB14, 0x45EA2EE6, 0x45FBC543,
    0x46075223, 0x461171CF, 0x461C4E56, 0x4627F553, 0x4634755A, 0x4641DE15,
    0x4650402B, 0x465FAD98, 0x46703995, 0x4680FC5F, 0x468A8094, 0x4694B53D,
    0x469FA708, 0x46AB638D, 0x46B7F95A, 0x46C5780A, 0x46D3F055, 0x46E37428,
    0x46F416B6, 0x4702F64A, 0x470C85E9, 0x4716C607, 0x4721C350, 0x472D8B56,
    0x473A2CA5, 0x4747B6D2, 0x47563A92, 0x4765C9CD, 0x477677B1, 0x47842C68,
    0x478DC198, 0x47980743, 0x47A309FC, 0x47AED75D, 0x47BB7DEE, 0x47C90D45,
    0x47D79612, 0x47E72A3C, 0x47F7DCEF, 0x4804E15D, 0x480E78D3, 0x4818C0A7,
    0x4823C580, 0x482F94EF, 0x483C3D7E, 0x4849CEC0, 0x4858596B, 0x4867EF63,
    0x4878A3DA, 0x488545B0, 0x488EDE02, 0x489926B1, 0x48A42C6A, 0x48AFFCBE,
    0x48BCA63E, 0x48CA3881, 0x48D8C441, 0x48E85B7E, 0x48F9114D, 0x49057D2C,
    0x490F165C, 0x4919600B, 0x492466ED, 0x4930389A, 0x493CE3AB, 0x494A77C2,
    0x495905A5, 0x49689F4C, 0x497957FF, 0x4985A233, 0x498F3D55, 0x49998946,
    0x49A492C3, 0x49B06773, 0x49BD15F9, 0x49CAAE0A, 0x49D9407B, 0x49E8DF58,
    0x49F99DFD, 0x4A05C895, 0x4A0F6792, 0x4A19B7E3, 0x4A24C661, 0x4A30A0AD,
    0x4A3D558B, 0x4A4AF4C2, 0x4A598F41, 0x4A69372E, 0x4A7A0000, 0x4A85FF4D,
    0x4A8FA4AF, 0x4A99FC2A, 0x4AA5129D, 0x4AB0F5DA, 0x4ABDB4B2, 0x4ACB5F08,
    0x4ADA05E9, 0x4AE9BB9D, 0x4AFA93C2, 0x4B0651B0, 0x4B100084, 0x4B1A6278,
    0x4B258487, 0x4B31749F, 0x4B3E41B1, 0x4B4BFBC4, 0x4B5AB40A, 0x4B6A7CF5,
    0x4B7B6A64, 0x4B86C8B5, 0x4B908471, 0x4B9AF49F, 0x4BA6265A, 0x4BB227B3,
    0x4BBF07C2, 0x4BCCD6B7, 0x4BDBA5F4, 0x4BEB881C, 0x4BFC9130, 0x4C076B54,
    0x4C1137C5, 0x4C1BBA48, 0x4C27001E, 0x4C331783, 0x4C400FBC, 0x4C4DF92C,
    0x4C5CE56A, 0x4C6CE754, 0x4C7E132C, 0x4C883F57, 0x4C922097, 0x4C9CB9DC,
    0x4CA81895, 0x4CB44B3C, 0x4CC16130, 0x4CCF6B1B, 0x4CDE7AD2, 0x4CEEA37A,
    0x4CFFF99C, 0x4D0949A4, 0x4D134414, 0x4D1DF8D3, 0x4D297584, 0x4D35C8CC,
    0x4D430261, 0x4D513323, 0x4D606D30, 0x4D70C3F8, 0x4D81262E, 0x4D8A8E63,
    0x4D94A6A2, 0x4D9F7BD7, 0x4DAB1BE0, 0x4DB795A0, 0x4DC4F914, 0x4DD35767,
    0x4DE2C306, 0x4DF34FBD, 0x4E028965, 0x4E0C118C, 0x4E164C7D, 0x4E21476A,
    0x4E2D1074, 0x4E39B6C7, 0x4E474AAD, 0x4E55DDA4, 0x4E658278, 0x4E764D54,
    0x4E8429F3, 0x4E8DD6B8, 0x4E98397B, 0x4EA35FA6, 0x4EAF57A4, 0x4EBC30F2,
    0x4EC9FC30, 0x4ED8CB3C, 0x4EE8B146, 0x4EF9C2E8, 0x4F060B24, 0x4F0FE195,
    0x4F1A718E, 0x4F25C8C6, 0x4F31F5FB, 0x4F3F0902,
], dtype=np.uint32)

# float32 slope of the combo duration multiplier: XLA folds t/60000*0.1
# into t * (0.1f / 60000f).
DUR_SLOPE = float(np.float32(0.1) / np.float32(60000))

_U32_VIEW_FIELDS = ("occ", "garb", "cur_rows", "piece_key", "hole_key")


# ---------------------------------------------------------------------------
# Selects over player views
# ---------------------------------------------------------------------------

def _sel(pred, a, b):
    """where(pred, a, b) with the (N,) game predicate broadcast over the
    trailing axes of the operands."""
    nd = max(getattr(a, "ndim", 0), getattr(b, "ndim", 0))
    if nd > 1:
        pred = pred.reshape(pred.shape + (1,) * (nd - 1))
    return torch.where(pred, a, b)


def _merge(pred, a_view, b_view):
    """a where pred, else b, field by field; fields that are the same
    tensor in both views cost nothing."""
    return tree_map(lambda a, b: a if a is b else _sel(pred, a, b),
                    a_view, b_view)


def _get(ps: PlayerState, i: int) -> PlayerState:
    return tree_map(lambda a: a[:, i], ps)


def _put(ps: PlayerState, i: int, view: PlayerState, pred,
         base: PlayerState) -> PlayerState:
    """Write ``view`` into player slot i where pred holds; fields the
    subroutine never replaced (same tensor as in ``base``) are skipped."""
    def f(full, one, orig):
        if one is orig:
            return full
        out = full.clone()
        out[:, i] = _sel(pred, one, orig)
        return out
    return tree_map(f, ps, view, base)


def _fma(a, b, c):
    """float32 fma(a, b, c), exact here: the product of two float32 values
    and the sum with c fit in float64 for every operand range the engine
    feeds it, so the one rounding to float32 is the fma's."""
    return (a.to(torch.float64) * b + c).to(F32)


_TABLES = {}


def _tables(device):
    """(SPAWN_ROT int64, combo payout float32) on ``device``, cached."""
    t = _TABLES.get(device)
    if t is None:
        t = (torch.as_tensor(SPAWN_ROT.astype(np.int64), device=device),
             torch.as_tensor(COMBO_POW_BITS.view(np.int32),
                             device=device).view(F32))
        _TABLES[device] = t
    return t


def _full(like, value):
    return torch.full_like(like, value)


# ---------------------------------------------------------------------------
# Randomizer (randomizer.cpp)
# ---------------------------------------------------------------------------

def _uniform(key, counter):
    """uniform01(fold_in(key, counter)) per game."""
    return rng.key_uniform(rng.fold_in(key, counter))


def _choose_from_bag(cogp, u):
    """getPiece's selection: sequential weight subtraction, first negative
    wins, default 0."""
    rem = u * 1000.0
    chosen = torch.zeros_like(u, dtype=I32)
    found = torch.zeros_like(u, dtype=torch.bool)
    for i in range(7):
        rem2 = rem - cogp[:, i]
        hit = ~found & (rem2 < 0)
        chosen = torch.where(hit, i, chosen)
        found = found | hit
        rem = torch.where(found, rem, rem2)
    return chosen


def _bag_update(cogp, chosen):
    """getPiece's weight shift in XLA's compiled form (module docstring)."""
    onehot = torch.arange(7, device=cogp.device)[None, :] == chosen[:, None]
    cval = cogp.gather(1, chosen.long()[:, None])
    return torch.where(onehot, cval * 0.25, cogp + cval * 0.125)


def _draw_piece(v: PlayerState):
    u = _uniform(v.piece_key, v.piece_draws)
    chosen = _choose_from_bag(v.cogp, u)
    return v.replace(cogp=_bag_update(v.cogp, chosen),
                     piece_draws=v.piece_draws + 1), chosen


def _draw_hole(cfg: EngineConfig, v: PlayerState):
    u = _uniform(v.hole_key, v.hole_draws)
    hole = (u * float(cfg.width)).to(I32)
    return v.replace(lasthole=hole, hole_draws=v.hole_draws + 1), hole


# ---------------------------------------------------------------------------
# Garbage FIFO (Garbage.cpp): front entry at slot 0, pops shift left
# ---------------------------------------------------------------------------

def garbage_count(cfg: EngineConfig, v: PlayerState):
    live = torch.arange(cfg.garbage_cap, device=v.g_count.device) \
        < v.g_size[:, None]
    return torch.where(live, v.g_count, 0).sum(-1).to(I32)


def _shift_left(arr, n):
    """out[:, j] = arr[:, j + n], zero fill; n (N,) in [0, CAP]."""
    CAP = arr.shape[-1]
    j = torch.arange(CAP, device=arr.device)[None, :]
    src = j + n[:, None].long()
    return torch.where(src < CAP, arr.gather(1, src.clamp(max=CAP - 1)), 0)


def _garbage_add(cfg: EngineConfig, v: PlayerState, amount) -> PlayerState:
    """GarbageHandler::add; at capacity the lines merge into the newest
    entry."""
    CAP = cfg.garbage_cap
    j = torch.arange(CAP, device=amount.device)[None, :]
    full = v.g_size >= CAP
    tail = torch.clamp(v.g_size, max=CAP - 1)
    at_tail = j == tail[:, None]
    delay = v.time_ms + cfg.garbage_initial_delay
    g_count = torch.where(at_tail, _sel(full, v.g_count + amount[:, None],
                                        amount[:, None]), v.g_count)
    g_delay = torch.where(at_tail & ~full[:, None], delay[:, None],
                          v.g_delay)
    return v.replace(g_count=g_count, g_delay=g_delay,
                     g_size=torch.clamp(v.g_size + 1, max=CAP))


def _garbage_block(cfg: EngineConfig, v: PlayerState, amount, freeze: bool):
    """GarbageHandler::block: returns (v', remainder)."""
    CAP = cfg.garbage_cap
    j = torch.arange(CAP, device=amount.device)[None, :]
    empty0 = v.g_size == 0
    live = j < v.g_size[:, None]
    counts = torch.where(live, v.g_count, 0)
    csum = torch.cumsum(counts, -1).to(I32)
    total = counts.sum(-1).to(I32)
    blocked = torch.minimum(amount, total)
    delay0 = v.g_delay[:, 0]
    new_counts = torch.minimum(
        torch.clamp(csum - blocked[:, None], min=0), counts)
    n_popped = (live & (csum <= blocked[:, None])).sum(-1).to(I32)
    g_count = _shift_left(torch.where(live, new_counts, v.g_count), n_popped)
    g_delay = _shift_left(v.g_delay, n_popped)
    size = v.g_size - n_popped
    nonempty = size > 0
    fd = torch.maximum(delay0, g_delay[:, 0])
    if freeze:
        fd = torch.minimum(fd + cfg.garbage_freeze_delay,
                           v.time_ms + v.g_min_remaining
                           + cfg.garbage_freeze_delay)
    g_delay = torch.where((j == 0) & nonempty[:, None], fd[:, None], g_delay)
    g_min = torch.where(nonempty, v.g_min_remaining,
                        cfg.garbage_initial_delay)
    v2 = v.replace(g_count=g_count, g_delay=g_delay, g_size=size,
                   g_min_remaining=g_min,
                   lines_blocked=v.lines_blocked + blocked)
    return _merge(empty0, v, v2), torch.where(empty0, amount,
                                              amount - blocked)


def _garbage_check(cfg: EngineConfig, v: PlayerState):
    """GarbageHandler::check: pop one pending line when the front entry's
    delay lapses.  Returns (v', popped?)."""
    j = torch.arange(cfg.garbage_cap, device=v.g_count.device)[None, :]
    t = v.time_ms
    empty = v.g_size == 0
    fire = ~empty & (t > v.g_delay[:, 0])
    chain_delay = v.g_delay[:, 0] + cfg.garbage_add_delay
    new_front = v.g_count[:, 0] - 1
    pop = fire & (new_front == 0)
    one = torch.ones_like(v.g_size)
    g_count = torch.where(fire[:, None] & (j == 0), new_front[:, None],
                          v.g_count)
    g_count = _sel(pop, _shift_left(g_count, one), g_count)
    g_delay = _sel(pop, _shift_left(v.g_delay, one), v.g_delay)
    size = torch.where(pop, v.g_size - 1, v.g_size)
    nonempty_after = size > 0
    fd = torch.maximum(chain_delay, g_delay[:, 0])
    g_delay = torch.where((fire & nonempty_after)[:, None] & (j == 0),
                          fd[:, None], g_delay)
    g_min = torch.where(
        fire,
        torch.where(nonempty_after, fd - t,
                    _full(t, cfg.garbage_initial_delay)),
        torch.where(empty, v.g_min_remaining,
                    torch.minimum(v.g_min_remaining, v.g_delay[:, 0] - t)))
    return v.replace(g_count=g_count, g_delay=g_delay, g_size=size,
                     g_min_remaining=g_min), fire


def _garbage_clear(cfg: EngineConfig, v: PlayerState) -> PlayerState:
    return v.replace(g_count=torch.zeros_like(v.g_count),
                     g_delay=torch.zeros_like(v.g_delay),
                     g_size=torch.zeros_like(v.g_size),
                     g_min_remaining=_full(v.g_min_remaining,
                                           cfg.garbage_initial_delay))


# ---------------------------------------------------------------------------
# Combo counter (Combo.cpp)
# ---------------------------------------------------------------------------

def _combo_increase(cfg: EngineConfig, v: PlayerState, amount):
    """ComboCounter::increase (amount <= 4), the reference's float order."""
    first = v.combo_count == 0
    start = torch.where(first, v.time_ms, v.combo_start)
    ctime = torch.where(first, 0, v.combo_time)
    cc = v.combo_count + 1
    lc = v.combo_line_count
    lt = torch.zeros_like(v.incoming_lines)
    for i in range(4):
        take = amount > i
        lc2 = lc + 1
        lt2 = lt + float(cfg.combo_line_mult) / lc2.to(F32)
        lc = torch.where(take, lc2, lc)
        lt = torch.where(take, lt2, lt)
    div = torch.div(_full(cc, cfg.combo_static_mult), cc,
                    rounding_mode="floor")
    ctime = (ctime.to(F32) + div.to(F32) + lt).to(I32)
    return v.replace(combo_start=start, combo_time=ctime, combo_count=cc,
                     combo_line_count=lc,
                     max_combo=torch.maximum(v.max_combo, cc))


def _combo_check(cfg: EngineConfig, v: PlayerState):
    """ComboCounter::check: returns (v', lines_sent)."""
    t = v.time_ms
    deadline = v.combo_start + v.combo_time
    remaining = torch.clamp(deadline - t, min=0)
    fire = (t > deadline) & (v.combo_count != 0)
    if bool((fire & (v.combo_count >= len(COMBO_POW_BITS))).any()):
        raise OverflowError(
            f"combo count beyond the payout table ({len(COMBO_POW_BITS)})")
    _, pow_table = _tables(t.device)
    dur_mult = _fma(t.to(F32), DUR_SLOPE, 1.0)
    payout = pow_table[v.combo_count.long().clamp(0, len(COMBO_POW_BITS) - 1)]
    sent = torch.where(fire, (payout * dur_mult).to(I32), 0)
    return v.replace(
        combo_remaining=remaining,
        combo_count=torch.where(fire, 0, v.combo_count),
        combo_line_count=torch.where(fire, 0, v.combo_line_count),
    ), sent


# ---------------------------------------------------------------------------
# Piece lifecycle
# ---------------------------------------------------------------------------

def _copy_piece(cfg: EngineConfig, v: PlayerState, np_) -> PlayerState:
    """GamePlay::copyPiece."""
    spawn_rot, _ = _tables(np_.device)
    rot = spawn_rot[np_.long()].to(I32)
    return v.replace(piece=np_, rot=rot, cur_rows=K.lookup_rows(np_, rot),
                     px=_full(v.px, (cfg.width - 4) // 2),
                     py=torch.zeros_like(v.py))


def _piece_map(cfg: EngineConfig, raw):
    table = torch.as_tensor(cfg.piece_map, dtype=I32, device=raw.device)
    return table[raw.long()]


def _make_new_piece(cfg: EngineConfig, v: PlayerState):
    """GamePlay::makeNewPiece: spawn nextpiece, roll a new one, die if the
    spawn is blocked (the blocking piece is still drawn)."""
    v = _copy_piece(cfg, v, v.nextpiece)
    v, raw = _draw_piece(v)
    v = v.replace(nextpiece=_piece_map(cfg, raw))
    ext = K.ext_board(cfg, v.occ)
    ok = K.possible(cfg, ext, v.cur_rows, v.px, v.py)
    occ_dead = K.add_piece(cfg, v.occ, v.cur_rows, v.px, v.py)
    return v.replace(occ=_sel(ok, v.occ, occ_dead)), ~ok


def _send_lines(cfg: EngineConfig, v: PlayerState, n_cleared, n_garb):
    """GamePlay::sendLines: returns (v', sent)."""
    v = v.replace(garbage_cleared=v.garbage_cleared + n_garb,
                  lines_cleared=v.lines_cleared + n_cleared)
    no_clear = n_cleared == 0
    v_nc = v.replace(combo_time=v.combo_time - 200)
    v_cl, sent = _garbage_block(cfg, v, n_cleared - 1, freeze=True)
    v_cl = v_cl.replace(lines_sent=v_cl.lines_sent + sent)
    v_cl = _combo_increase(cfg, v_cl, n_cleared)
    return _merge(no_clear, v_nc, v_cl), torch.where(no_clear, 0, sent)


def _hd_make(cfg: EngineConfig, v: PlayerState) -> PlayerState:
    """GamePlay::hd_make: drop, lock, reset the gravity timer."""
    ext = K.ext_board(cfg, v.occ)
    py = v.py + K.drop_distance(cfg, ext, v.cur_rows, v.px, v.py)
    occ = K.add_piece(cfg, v.occ, v.cur_rows, v.px, py)
    return v.replace(py=py, occ=occ, drop_delay_time=v.time_ms,
                     lockdown=torch.zeros_like(v.lockdown))


def _hd_finish(cfg: EngineConfig, v: PlayerState):
    """GamePlay::hd_finish: returns (v', sent, or -1 on death)."""
    occ, garb, n_cl, n_gb = K.clear_lines(cfg, v.occ, v.garb, v.py)
    v = v.replace(occ=occ, garb=garb)
    v, sent = _send_lines(cfg, v, n_cl, n_gb)
    v, died = _make_new_piece(cfg, v)
    return v, torch.where(died, -1, sent)


def _game_mdown(cfg: EngineConfig, v: PlayerState):
    """GamePlay::mDown: on success reset the gravity timer, on failure arm
    the lockdown countdown (unless already armed)."""
    ext = K.ext_board(cfg, v.occ)
    ok, px, py = K.try_move(cfg, ext, v.cur_rows, v.px, v.py, 0, 1)
    ddt = torch.where(ok, v.time_ms, v.drop_delay_time)
    lt = torch.where(ok | v.lockdown, v.lockdown_time,
                     v.time_ms + cfg.lockdown_ms)
    return v.replace(px=px, py=py, drop_delay_time=ddt, lockdown=~ok,
                     lockdown_time=lt), ok


def _push_garbage(cfg: EngineConfig, v: PlayerState):
    """GamePlay::pushGarbage: returns (v', died)."""
    v, hole = _draw_hole(cfg, v)
    occ, garb = K.add_garbage_line(cfg, v.occ, v.garb, hole)
    v = v.replace(occ=occ, garb=garb)
    py1 = torch.where(v.py > 0, v.py - 1, v.py)
    ok = K.possible(cfg, K.ext_board(cfg, occ), v.cur_rows, v.px, py1)
    died = ~ok & (py1 <= 0)
    py2 = torch.where(~ok & (py1 > 0), py1 - 1, py1)
    return v.replace(py=py2), died


def _delay_check(cfg: EngineConfig, v: PlayerState, dt: int):
    """Per-tick timers (gamePlay.cpp:90-114): gravity, lockdown auto-drop,
    garbage intake, combo payout, garbage landing.  Returns (v', sent) with
    sent == -1 on death; a lockdown hard drop returns early."""
    v = v.replace(time_ms=v.time_ms + dt)
    t = v.time_ms
    speedup = (t - v.incr_dd_time) > 3000
    dd = v.drop_delay
    dec = torch.where(dd > 200, 10, torch.where(dd > 100, 5, torch.where(
        dd > 50, 2, torch.where(dd > 10, 1, 0)))).to(I32)
    dd = torch.where(speedup, dd - dec, dd)
    v = v.replace(drop_delay=dd,
                  incr_dd_time=torch.where(speedup, t, v.incr_dd_time))
    gravity = (t - v.drop_delay_time) > dd
    v = v.replace(drop_delay_time=torch.where(gravity, t, v.drop_delay_time))
    vg, _ = _game_mdown(cfg, v)
    v = _merge(gravity, vg, v)

    lock_fire = v.lockdown & (t > v.lockdown_time)
    vl, moved = _game_mdown(cfg, v)
    vh, hd_sent = _hd_finish(cfg, _hd_make(cfg, vl))
    do_hd = lock_fire & ~moved
    v = _merge(lock_fire, _merge(do_hd, vh, vl), v)

    x = v
    add_g = torch.floor(x.incoming_lines).to(I32)
    x = x.replace(incoming_lines=x.incoming_lines - add_g.to(F32))
    x = _merge(add_g > 0, _garbage_add(cfg, x, add_g), x)
    x, combo_sent = _combo_check(cfg, x)
    xp, rem = _garbage_block(cfg, x, combo_sent, freeze=False)
    xp = xp.replace(lines_sent=xp.lines_sent + rem)
    pay = combo_sent > 0
    x = _merge(pay, xp, x)
    sent = torch.where(pay, rem, 0)
    x, popped = _garbage_check(cfg, x)
    xg, died_g = _push_garbage(cfg, x)
    x = _merge(popped, xg, x)
    rest_ret = torch.where(popped & died_g, -1, sent)
    return _merge(do_hd, v, x), torch.where(do_hd, hd_sent, rest_ret)


# ---------------------------------------------------------------------------
# Actions, phases, the tick
# ---------------------------------------------------------------------------

def apply_macro(cfg: EngineConfig, v: PlayerState, r, tr) -> PlayerState:
    """The (rotation, translation) macro: r clockwise rotations (at most
    3), slide to the far left, tr steps right, hard drop (lock only)."""
    ext = K.ext_board(cfg, v.occ)
    rot, px, py, rows = v.rot, v.px, v.py, v.cur_rows
    for k in range(3):
        do = r > k
        _, rot2, px2, py2, rows2 = K.try_rotate(cfg, ext, v.piece, rot, px,
                                                py, 1, rows)
        rot = torch.where(do, rot2, rot)
        px = torch.where(do, px2, px)
        py = torch.where(do, py2, py)
        rows = _sel(do, rows2, rows)
    px = px - K.slide_distance(cfg, ext, rows, px, py, -1)
    px = px + torch.minimum(tr, K.slide_distance(cfg, ext, rows, px, py, +1))
    return _hd_make(cfg, v.replace(rot=rot, px=px, py=py, cur_rows=rows))


def make_phase_macro(cfg: EngineConfig, state: EngineState, use, r, tr
                     ) -> EngineState:
    """make_actions with (r, t) macros; use (N, P) False == null action."""
    ps = state.players
    for i in range(cfg.n_players):
        v = _get(ps, i)
        v2 = apply_macro(cfg, v, r[:, i], tr[:, i])
        ps = _put(ps, i, v2, ~v.dead & use[:, i], base=v)
    return state.replace(players=ps)


def _distribute(cfg: EngineConfig, incoming, sender: int, amount):
    """PythonHandle::distributeLines: amount/(P-1) to every other player."""
    if cfg.n_players < 2:
        return incoming
    per = amount.to(F32) / float(cfg.n_players - 1)
    others = (torch.arange(cfg.n_players, device=incoming.device)
              != sender).to(F32)
    return incoming + per[:, None] * others[None, :]


def finish_phase(cfg: EngineConfig, state: EngineState, dt: int
                 ) -> EngineState:
    """PythonHandle::finish_actions: resolve every player's hard drop
    (stopping on the first death), then every survivor's delayCheck,
    distributing sent lines as they happen."""
    ps = state.players
    broke = torch.zeros_like(state.round_over)
    for i in range(cfg.n_players):
        v = _get(ps, i)
        active = ~v.dead & ~broke
        v2, sent = _hd_finish(cfg, v)
        died = sent == -1
        v2 = v2.replace(dead=v2.dead | died)
        ps = _put(ps, i, v2, active, base=v)
        inc = _distribute(cfg, ps.incoming_lines, i, torch.clamp(sent, min=0))
        do_inc = active & ~died & (sent > 0)
        ps = ps.replace(incoming_lines=_sel(do_inc, inc, ps.incoming_lines))
        broke = broke | (active & died)

    alive = torch.zeros_like(state.last_winner)
    for i in range(cfg.n_players):
        v = _get(ps, i)
        active = ~v.dead
        v2, sent = _delay_check(cfg, v, dt)
        died = sent == -1
        v2 = v2.replace(dead=v2.dead | died)
        v3 = v2.replace(reward=v2.lines_cleared - v2.lines_cleared_snap,
                        lines_cleared_snap=v2.lines_cleared,
                        incoming_count=garbage_count(cfg, v2))
        ps = _put(ps, i, _merge(died, v2, v3), active, base=v)
        inc = _distribute(cfg, ps.incoming_lines, i, torch.clamp(sent, min=0))
        do_inc = active & ~died & (sent > 0)
        ps = ps.replace(incoming_lines=_sel(do_inc, inc, ps.incoming_lines))
        alive = alive + (active & ~died).to(I32)

    over = (alive == 0) | ((cfg.n_players > 1) & (alive < 2))
    return state.replace(players=ps, round_over=over)


def _widen(ps: PlayerState) -> PlayerState:
    return ps.replace(**{f: rng.u32(getattr(ps, f))
                         for f in _U32_VIEW_FIELDS})


def _narrow(ps: PlayerState) -> PlayerState:
    return ps.replace(**{f: rng.to_i32(getattr(ps, f))
                         for f in _U32_VIEW_FIELDS})


def step_macro(cfg: EngineConfig, state: EngineState, use, r, tr, dt: int
               ) -> EngineState:
    """One engine tick with macro actions (make + finish) for every game;
    games whose round is already over are left as they are.  use/r/tr are
    (N, P)."""
    wide = state.replace(players=_widen(state.players))
    new = finish_phase(cfg, make_phase_macro(cfg, wide, use, r, tr), dt)
    new = new.replace(players=_narrow(new.players))
    return tree_map(lambda a, b: _sel(state.round_over, a, b), state, new)


# ---------------------------------------------------------------------------
# Round lifecycle
# ---------------------------------------------------------------------------

def _restart_round(cfg: EngineConfig, v: PlayerState) -> PlayerState:
    """GamePlay::restartRound + data.clear()."""
    v = _garbage_clear(cfg, v)
    z = torch.zeros_like(v.time_ms)
    f = torch.zeros_like(v.dead)
    return v.replace(
        occ=torch.zeros_like(v.occ), garb=torch.zeros_like(v.garb),
        combo_start=z, combo_time=z, combo_count=z, combo_line_count=z,
        time_ms=z, incoming_lines=torch.zeros_like(v.incoming_lines),
        lines_cleared_snap=z, dead=f, drop_delay=_full(z, 1000),
        drop_delay_time=z, incr_dd_time=z, lockdown=f, lockdown_time=z,
        lines_sent=z, lines_recv=z, garbage_cleared=z, lines_cleared=z,
        lines_blocked=z, max_combo=z)


def _seed_round(cfg: EngineConfig, v: PlayerState, piece_key, hole_key
                ) -> PlayerState:
    """GamePlay::seed in closed form: the first non-S/Z candidate of a
    fresh-bag draw window (or the last one), then its successor draw."""
    z = torch.zeros_like(v.time_ms)
    fresh = torch.full_like(v.cogp, COGP_INIT)
    v = v.replace(piece_key=piece_key, hole_key=hole_key, piece_draws=z,
                  hole_draws=z, cogp=fresh, lasthole=_full(z, 20))
    R = cfg.max_seed_rerolls
    us = [_uniform(piece_key, _full(z, i)) for i in range(R + 2)]
    cands = [_choose_from_bag(fresh, us[i]) for i in range(R + 1)]
    mapped = [_piece_map(cfg, c) for c in cands]
    k = _full(z, R)
    if cfg.only_zs:
        k = z
    else:
        for i in range(R, -1, -1):
            ok_i = ~((mapped[i] == 2) | (mapped[i] == 3))
            k = torch.where(ok_i, i, k)
    cand_k, piece_k, u_next = z, z, torch.zeros_like(us[0])
    for i in range(R + 1):
        hit = k == i
        cand_k = torch.where(hit, cands[i], cand_k)
        piece_k = torch.where(hit, mapped[i], piece_k)
        u_next = torch.where(hit, us[i + 1], u_next)
    cogp1 = _bag_update(fresh, cand_k)
    cand_next = _choose_from_bag(cogp1, u_next)
    cogp2 = _bag_update(cogp1, cand_next)
    v = v.replace(cogp=cogp2, piece_draws=k + 2)
    v = _copy_piece(cfg, v, piece_k)
    return v.replace(nextpiece=_piece_map(cfg, cand_next))


def reset(cfg: EngineConfig, state: EngineState, key) -> EngineState:
    """PythonHandle::reset for every game: record the finished round's
    winner, restart and reseed every player; key is (N, 2) (int32 bits or
    int64 u32).  Both players get the same stream keys."""
    ps = _widen(state.players)
    alive = ~ps.dead
    idx = torch.arange(cfg.n_players, dtype=I32, device=alive.device)
    winner = torch.where(alive, idx[None, :], -1).amax(-1).to(I32)
    winner = torch.where(alive.sum(-1) > 1, -1, winner).to(I32)
    key = rng.u32(key)
    piece_key = rng.fold_in(key, 0)
    hole_key = rng.fold_in(key, 1)
    views = [_seed_round(cfg, _restart_round(cfg, _get(ps, i)), piece_key,
                         hole_key) for i in range(cfg.n_players)]
    new_ps = tree_map(lambda *xs: torch.stack(xs, dim=1), *views)
    return EngineState(players=_narrow(new_ps),
                       round_over=torch.zeros_like(state.round_over),
                       last_winner=winner)


def init(cfg: EngineConfig, keys) -> EngineState:
    """PythonHandle::init for N games from (N, 2) keys."""
    n = keys.shape[0]
    state = EngineState(
        players=zeros_player_state(cfg, n, keys.device),
        round_over=torch.zeros(n, dtype=torch.bool, device=keys.device),
        last_winner=torch.full((n,), -1, dtype=I32, device=keys.device))
    return reset(cfg, state, keys)
