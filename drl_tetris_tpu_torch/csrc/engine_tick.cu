// Engine tick kernel for Hopper (sm_90a): the port of the TPU kernel
// drl_tetris_tpu/engine/pallas_tick.py::_rollout (its inner kernel/body,
// its wrapper rollout_pallas and batch tick env_step_batch), together with the
// helpers it ran inside that kernel: the raw-threefry RNG
// (engine/rng.py::fold_in, split2, random_bits, uniform01) and the static
// shifts and scans of engine/shifts.py (as register loops here).
//
// Design: one thread per game.  A thread loads its game's whole EnvState
// (about 1.25 KB: two bitboards of H rows, two garbage FIFOs of CAP slots,
// the bag weights and ~35 scalars per player) into a local struct, runs
// the tick as plain scalar C++ with real branches, and writes the state
// back.  The control flow follows the JAX engine (engine/step.py): the
// nested lockdown merge (_merge3) is an if/else, the lockdown hard drop
// returns early from the delay check, and the hard-drop loop of the finish
// phase stops at the first death.  The JAX select-form is not transcribed,
// and the Mosaic workarounds of the TPU kernel are dropped, not ported: the
// bit-blend branch of step._sel, pallas_tick._bsel, the bool->int32 carries
// and the rank-1 -> (1, N) leaf promotion.
//
// Two entries share the tick:
//   engine_tick_step     one env tick; also writes the acting player's
//                        reward and done, taken before the reset merge
//                        (env/env.py step).  Carries the NN-in-the-loop
//                        rollout.
//   engine_tick_rollout  T ticks with the state held in the thread; actions
//                        replayed from (T, N) arrays or drawn in-kernel as
//                        random_bits(fold_in(fold_in(base_key, tick),
//                        game / block_games)) at index game % block_games,
//                        r = bits % 4, t = (bits >> 16) % W, the stream of
//                        rollout_pallas for the same block_games.
//
// Leaf pointers: EnvState has N_LEAVES tensors, each contiguous with the
// game batch first ((N, P, ...), (N, ...)).  The wrapper passes two host
// arrays of device pointers (inputs, outputs) in the order of enum Leaf,
// which is the field order of engine/core.py PlayerState followed by the
// engine and env scalars; the C entry copies them into structs passed to
// the kernel by value.  uint32 leaves arrive as int32 words, bools as one
// byte.
//
// Bound: each launch reads every state leaf once and writes it once
// (2 x ~1.25 KB per game, plus actions and outputs), so at 3.35 TB/s the
// memory floor is under a microsecond per 1k games; the tick itself is
// thousands of dependent integer operations per game with divergent
// branches, so the kernel is bound by its instruction issue and latency,
// not by bytes.  This first form keeps the state in local memory; keeping
// it in registers and shared memory is later work.
//
// Float32 arithmetic is written with explicit round-to-nearest intrinsics
// (and built with --fmad=false besides), in the forms XLA compiles the JAX
// engine into: see engine/step.py.  The combo payout's pow comes from the
// shared table COMBO_POW_BITS; a combo count past the table sets bit 0 of
// *flags, which the wrapper checks.

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ inline
#define F_ADD(a, b) __fadd_rn((a), (b))
#define F_SUB(a, b) __fsub_rn((a), (b))
#define F_MUL(a, b) __fmul_rn((a), (b))
#define F_DIV(a, b) __fdiv_rn((a), (b))
#define F_FMA(a, b, c) __fmaf_rn((a), (b), (c))
DEV float bits_to_float(uint32_t b) { return __uint_as_float(b); }
#else
#include <math.h>
#define DEV static inline
#define F_ADD(a, b) ((a) + (b))
#define F_SUB(a, b) ((a) - (b))
#define F_MUL(a, b) ((a) * (b))
#define F_DIV(a, b) ((a) / (b))
#define F_FMA(a, b, c) fmaf((a), (b), (c))
DEV float bits_to_float(uint32_t b) { float f; memcpy(&f, &b, 4); return f; }
#endif

#define MAX_H 32
#define MAX_CAP 64
#define BIG (1 << 20)

enum Leaf {
  L_OCC, L_GARB, L_PIECE, L_ROT, L_PX, L_PY, L_CUR_ROWS, L_NEXTPIECE,
  L_TIME_MS, L_DROP_DELAY, L_DROP_DELAY_TIME, L_INCR_DD_TIME, L_LOCKDOWN,
  L_LOCKDOWN_TIME, L_COMBO_START, L_COMBO_TIME, L_COMBO_COUNT,
  L_COMBO_LINE_COUNT, L_COMBO_REMAINING, L_G_COUNT, L_G_DELAY, L_G_SIZE,
  L_G_MIN_REMAINING, L_INCOMING_LINES, L_INCOMING_COUNT, L_LINES_SENT,
  L_LINES_RECV, L_GARBAGE_CLEARED, L_LINES_CLEARED, L_LINES_BLOCKED,
  L_MAX_COMBO, L_LINES_CLEARED_SNAP, L_REWARD, L_DEAD, L_COGP, L_LASTHOLE,
  L_PIECE_KEY, L_HOLE_KEY, L_PIECE_DRAWS, L_HOLE_DRAWS,
  L_ROUND_OVER, L_LAST_WINNER, L_CURRENT_PLAYER, L_KEY, L_ROUNDS_PLAYED,
  N_LEAVES
};

// Offsets into the device table: ROW_MASKS (7x4x4), SPAWN_ROT (7),
// COMBO_POW_BITS (256).
#define TAB_ROWS 0
#define TAB_SPAWN 112
#define TAB_POW 119
#define N_POW 256

// icfg layout (engine/cuda_tick.py _config_words)
enum CfgWord {
  C_H, C_W, C_CAP, C_R, C_INIT_DELAY, C_ADD_DELAY, C_FREEZE_DELAY,
  C_LINE_MULT, C_STATIC_MULT, C_LOCKDOWN_MS, C_DT, C_EXTRA_REWARDS,
  C_ONLY_ZS, C_PIECE_MAP, N_CFG = C_PIECE_MAP + 7
};

struct Cfg {
  int H, W, CAP, R, init_delay, add_delay, freeze_delay, line_mult,
      static_mult, lockdown_ms, dt, extra_rewards, only_zs;
  int piece_map[7];
  uint32_t wall_mask, full_row;
  float wbase, wcombo, dur_slope;
};

struct Ptrs { void* p[N_LEAVES]; };

struct Player {
  uint32_t occ[MAX_H], garb[MAX_H];
  int piece, rot, px, py;
  uint32_t cur_rows[4];
  int nextpiece, time_ms, drop_delay, drop_delay_time, incr_dd_time;
  bool lockdown;
  int lockdown_time;
  int combo_start, combo_time, combo_count, combo_line_count, combo_remaining;
  int g_count[MAX_CAP], g_delay[MAX_CAP];
  int g_size, g_min_remaining;
  float incoming_lines;
  int incoming_count, lines_sent, lines_recv, garbage_cleared, lines_cleared,
      lines_blocked, max_combo, lines_cleared_snap, reward;
  bool dead;
  float cogp[7];
  int lasthole;
  uint32_t piece_key[2], hole_key[2];
  int piece_draws, hole_draws;
};

struct Game {
  Player pl[2];
  bool round_over;
  int last_winner, current_player, rounds_played;
  uint32_t key[2];
};

struct Ctx {               // what every tick function reads besides state
  const Cfg* cfg;
  const uint32_t* tab;
  int* flags;
};

// ---------------------------------------------------------------------------
// RNG: threefry-2x32, bit-exact with partitionable jax.random
// ---------------------------------------------------------------------------

DEV uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

DEV void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                      uint32_t* o0, uint32_t* o1) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += k0;
  x1 += k1;
  for (int i = 0; i < 5; i++) {
    for (int j = 0; j < 4; j++) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

DEV void fold_in(const uint32_t* key, uint32_t data, uint32_t* out) {
  threefry2x32(key[0], key[1], 0u, data, &out[0], &out[1]);
}

DEV uint32_t random_bits_at(const uint32_t* key, uint32_t index) {
  uint32_t b0, b1;
  threefry2x32(key[0], key[1], 0u, index, &b0, &b1);
  return b0 ^ b1;
}

DEV float bits_to_uniform(uint32_t bits) {
  return F_SUB(bits_to_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// uniform01(fold_in(key, counter))
DEV float draw_uniform(const uint32_t* key, int counter) {
  uint32_t k[2];
  fold_in(key, (uint32_t)counter, k);
  return bits_to_uniform(random_bits_at(k, 0u));
}

// ---------------------------------------------------------------------------
// Bitboard primitives (engine/kernels.py); uint32 shifts outside [0, 31]
// give 0, as XLA's do
// ---------------------------------------------------------------------------

DEV uint32_t shl32(uint32_t x, int s) {
  return (s >= 0 && s < 32) ? (x << s) : 0u;
}
DEV uint32_t shr32(uint32_t x, int s) {
  return (s >= 0 && s < 32) ? (x >> s) : 0u;
}

DEV void ext_board(const Cfg& c, const uint32_t* occ, uint32_t* ext) {
  for (int y = 0; y < c.H; y++) ext[y] = (occ[y] << 4) | c.wall_mask;
}

DEV void lookup_rows(const Ctx& x, int piece, int rot, uint32_t* rows) {
  bool ok = piece >= 0 && piece < 7 && rot >= 0 && rot < 4;
  for (int i = 0; i < 4; i++)
    rows[i] = ok ? x.tab[TAB_ROWS + (piece * 4 + rot) * 4 + i] : 0u;
}

DEV bool possible(const Cfg& c, const uint32_t* ext, const uint32_t* rows,
                  int px, int py) {
  for (int i = 0; i < 4; i++) {
    if (rows[i] == 0) continue;
    int y = py + i;
    if (y < 0 || y > c.H - 1) return false;
    if (ext[y] & shl32(rows[i], px + 4)) return false;
  }
  return true;
}

DEV int drop_distance(const Cfg& c, const uint32_t* ext, const uint32_t* rows,
                      int px, int py) {
  int first = BIG;
  for (int i = 0; i < 4; i++) {
    if (rows[i] == 0) continue;
    uint32_t sh = shl32(rows[i], px + 4);
    int base = py + i;
    int d_hit = BIG;
    for (int y = (base + 1 > 0 ? base + 1 : 0); y < c.H; y++) {
      if (ext[y] & sh) { d_hit = y - base; break; }
    }
    int d_i = d_hit < c.H - base ? d_hit : c.H - base;
    if (d_i < first) first = d_i;
  }
  return first - 1 > 0 ? first - 1 : 0;
}

DEV int slide_distance(const Cfg& c, const uint32_t* ext, const uint32_t* rows,
                       int px, int py, int dir) {
  for (int s = 1; s < c.W + 4; s++) {
    int shift = px + 4 + dir * s;
    if (shift < 0 || shift > 27) return s - 1;
    for (int i = 0; i < 4; i++) {
      int y = py + i;
      if (rows[i] == 0 || y < 0 || y > c.H - 1) continue;
      if (ext[y] & (rows[i] << shift)) return s - 1;
    }
  }
  return BIG - 1;
}

DEV void add_piece(const Cfg& c, uint32_t* occ, const uint32_t* rows, int px,
                   int py) {
  for (int i = 0; i < 4; i++) {
    int y = py + i;
    if (y < 0 || y > c.H - 1) continue;
    occ[y] |= px >= 0 ? shl32(rows[i], px) : shr32(rows[i], -px);
  }
}

// Rotate by `turns` with the kick probes (gameField.cpp:55-103); updates
// rot/px/py/rows in place when a probe fits.
DEV void try_rotate(const Ctx& x, const uint32_t* ext, int piece, int* rot,
                    int* px, int* py, uint32_t* rows, int turns) {
  const Cfg& c = *x.cfg;
  const int kdx[8] = {0, 0, -1, 1, -1, 1, -2, 2};
  const int kdy[8] = {0, 1, 0, 0, 1, 1, 0, 0};
  int new_rot = ((*rot + turns) % 4 + 4) % 4;
  uint32_t nr[4];
  lookup_rows(x, piece, new_rot, nr);
  bool oob[2] = {false, false};
  for (int dy = 0; dy < 2; dy++)
    for (int i = 0; i < 4; i++) {
      int y = *py + dy + i;
      if (nr[i] != 0 && (y < 0 || y > c.H - 1)) oob[dy] = true;
    }
  for (int k = 0; k < 8; k++) {
    if (oob[kdy[k]]) continue;
    int s = *px + kdx[k] + 4;
    bool ok = true;
    for (int i = 0; i < 4 && ok; i++) {
      int y = *py + kdy[k] + i;
      if (nr[i] == 0 || y < 0 || y > c.H - 1) continue;
      if (ext[y] & shl32(nr[i], s)) ok = false;
    }
    if (ok) {
      *rot = new_rot;
      *px += kdx[k];
      *py += kdy[k];
      for (int i = 0; i < 4; i++) rows[i] = nr[i];
      return;
    }
  }
}

// BasicField::clearlines over the scan window [py, py+H-1]; kept rows fall
// by the number of full rows below them (rows falling more than 4 are
// dropped, as the JAX compaction does).
DEV void clear_lines(const Cfg& c, uint32_t* occ, uint32_t* garb, int py,
                     int* n_cleared, int* n_garb) {
  uint32_t o2[MAX_H], g2[MAX_H];
  for (int y = 0; y < c.H; y++) { o2[y] = 0u; g2[y] = 0u; }
  int below = 0, nc = 0, ng = 0;
  for (int y = c.H - 1; y >= 0; y--) {
    bool full = occ[y] == c.full_row && y >= py && y <= py + c.H - 1;
    if (full) {
      below++;
      nc++;
      if (garb[y] != 0) ng++;
    } else if (below <= 4 && y + below < c.H) {
      o2[y + below] |= occ[y];
      g2[y + below] |= garb[y];
    }
  }
  for (int y = 0; y < c.H; y++) { occ[y] = o2[y]; garb[y] = g2[y]; }
  *n_cleared = nc;
  *n_garb = ng;
}

DEV void add_garbage_line(const Cfg& c, uint32_t* occ, uint32_t* garb,
                          int hole) {
  uint32_t row = c.full_row & ~shl32(1u, hole);
  for (int y = 0; y < c.H - 1; y++) { occ[y] = occ[y + 1]; garb[y] = garb[y + 1]; }
  occ[c.H - 1] = row;
  garb[c.H - 1] = row;
}

// ---------------------------------------------------------------------------
// Randomizer (randomizer.cpp)
// ---------------------------------------------------------------------------

DEV int choose_from_bag(const float* cogp, float u) {
  float rem = F_MUL(u, 1000.0f);
  for (int i = 0; i < 7; i++) {
    float rem2 = F_SUB(rem, cogp[i]);
    if (rem2 < 0.0f) return i;
    rem = rem2;
  }
  return 0;
}

DEV void bag_update(float* cogp, int chosen) {
  float cval = cogp[chosen];
  for (int i = 0; i < 7; i++)
    cogp[i] = i == chosen ? F_MUL(cval, 0.25f)
                          : F_ADD(cogp[i], F_MUL(cval, 0.125f));
}

DEV int draw_piece(Player& v) {
  float u = draw_uniform(v.piece_key, v.piece_draws);
  int chosen = choose_from_bag(v.cogp, u);
  bag_update(v.cogp, chosen);
  v.piece_draws += 1;
  return chosen;
}

DEV int draw_hole(const Cfg& c, Player& v) {
  float u = draw_uniform(v.hole_key, v.hole_draws);
  int hole = (int)F_MUL(u, (float)c.W);
  v.lasthole = hole;
  v.hole_draws += 1;
  return hole;
}

// ---------------------------------------------------------------------------
// Garbage FIFO (Garbage.cpp): front at slot 0, pops shift left
// ---------------------------------------------------------------------------

DEV void shift_left(int* a, int n, int cap) {
  for (int j = 0; j < cap; j++) a[j] = j + n < cap ? a[j + n] : 0;
}

DEV int garbage_count(const Cfg& c, const Player& v) {
  int s = 0;
  for (int j = 0; j < c.CAP && j < v.g_size; j++) s += v.g_count[j];
  return s;
}

DEV void garbage_add(const Cfg& c, Player& v, int amount) {
  bool full = v.g_size >= c.CAP;
  int tail = v.g_size < c.CAP - 1 ? v.g_size : c.CAP - 1;
  if (full) {
    v.g_count[tail] += amount;
  } else {
    v.g_count[tail] = amount;
    v.g_delay[tail] = v.time_ms + c.init_delay;
  }
  v.g_size = v.g_size + 1 < c.CAP ? v.g_size + 1 : c.CAP;
}

// GarbageHandler::block: returns the lines left after blocking.
DEV int garbage_block(const Cfg& c, Player& v, int amount, bool freeze) {
  if (v.g_size == 0) return amount;
  int live = v.g_size < c.CAP ? v.g_size : c.CAP;
  int total = 0;
  for (int j = 0; j < live; j++) total += v.g_count[j];
  int blocked = amount < total ? amount : total;
  int delay0 = v.g_delay[0];
  int csum = 0, n_popped = 0;
  for (int j = 0; j < live; j++) {
    csum += v.g_count[j];
    int nc = csum - blocked > 0 ? csum - blocked : 0;
    if (nc > v.g_count[j]) nc = v.g_count[j];
    if (csum <= blocked) n_popped++;
    v.g_count[j] = nc;
  }
  shift_left(v.g_count, n_popped, c.CAP);
  shift_left(v.g_delay, n_popped, c.CAP);
  int size = v.g_size - n_popped;
  int fd = delay0 > v.g_delay[0] ? delay0 : v.g_delay[0];
  if (freeze) {
    int a = fd + c.freeze_delay;
    int b = v.time_ms + v.g_min_remaining + c.freeze_delay;
    fd = a < b ? a : b;
  }
  if (size > 0) v.g_delay[0] = fd;
  else v.g_min_remaining = c.init_delay;
  v.g_size = size;
  v.lines_blocked += blocked;
  return amount - blocked;
}

// GarbageHandler::check: pop one pending line when the front delay lapses.
DEV bool garbage_check(const Cfg& c, Player& v) {
  if (v.g_size == 0) return false;
  int t = v.time_ms;
  int d0 = v.g_delay[0];
  if (!(t > d0)) {
    if (d0 - t < v.g_min_remaining) v.g_min_remaining = d0 - t;
    return false;
  }
  int chain = d0 + c.add_delay;
  int nf = v.g_count[0] - 1;
  v.g_count[0] = nf;
  if (nf == 0) {
    shift_left(v.g_count, 1, c.CAP);
    shift_left(v.g_delay, 1, c.CAP);
    v.g_size -= 1;
  }
  if (v.g_size > 0) {
    int fd = chain > v.g_delay[0] ? chain : v.g_delay[0];
    v.g_delay[0] = fd;
    v.g_min_remaining = fd - t;
  } else {
    v.g_min_remaining = c.init_delay;
  }
  return true;
}

DEV void garbage_clear(const Cfg& c, Player& v) {
  for (int j = 0; j < c.CAP; j++) { v.g_count[j] = 0; v.g_delay[j] = 0; }
  v.g_size = 0;
  v.g_min_remaining = c.init_delay;
}

// ---------------------------------------------------------------------------
// Combo counter (Combo.cpp)
// ---------------------------------------------------------------------------

DEV void combo_increase(const Cfg& c, Player& v, int amount) {
  int ctime = v.combo_time;
  if (v.combo_count == 0) { v.combo_start = v.time_ms; ctime = 0; }
  int cc = v.combo_count + 1;
  int lc = v.combo_line_count;
  float lt = 0.0f;
  for (int i = 0; i < 4; i++) {
    if (i < amount) {
      lc += 1;
      lt = F_ADD(lt, F_DIV((float)c.line_mult, (float)lc));
    }
  }
  v.combo_time = (int)F_ADD(F_ADD((float)ctime, (float)(c.static_mult / cc)), lt);
  v.combo_count = cc;
  v.combo_line_count = lc;
  if (cc > v.max_combo) v.max_combo = cc;
}

DEV int combo_check(const Ctx& x, Player& v) {
  int t = v.time_ms;
  int deadline = v.combo_start + v.combo_time;
  v.combo_remaining = deadline - t > 0 ? deadline - t : 0;
  if (!(t > deadline && v.combo_count != 0)) return 0;
  int cc = v.combo_count;
  if (cc >= N_POW) {
#ifdef __CUDACC__
    atomicOr(x.flags, 1);
#else
    *x.flags |= 1;
#endif
    cc = N_POW - 1;
  }
  float dur = F_FMA((float)t, x.cfg->dur_slope, 1.0f);
  int sent = (int)F_MUL(bits_to_float(x.tab[TAB_POW + cc]), dur);
  v.combo_count = 0;
  v.combo_line_count = 0;
  return sent;
}

// ---------------------------------------------------------------------------
// Piece lifecycle (gamePlay.cpp)
// ---------------------------------------------------------------------------

DEV void copy_piece(const Ctx& x, Player& v, int np) {
  v.piece = np;
  v.rot = (np >= 0 && np < 7) ? (int)x.tab[TAB_SPAWN + np] : (int)x.tab[TAB_SPAWN];
  lookup_rows(x, np, v.rot, v.cur_rows);
  v.px = (x.cfg->W - 4) / 2;
  v.py = 0;
}

DEV bool make_new_piece(const Ctx& x, Player& v) {
  const Cfg& c = *x.cfg;
  copy_piece(x, v, v.nextpiece);
  v.nextpiece = c.piece_map[draw_piece(v)];
  uint32_t ext[MAX_H];
  ext_board(c, v.occ, ext);
  if (possible(c, ext, v.cur_rows, v.px, v.py)) return false;
  add_piece(c, v.occ, v.cur_rows, v.px, v.py);
  return true;
}

DEV int send_lines(const Cfg& c, Player& v, int n_cleared, int n_garb) {
  v.garbage_cleared += n_garb;
  v.lines_cleared += n_cleared;
  if (n_cleared == 0) {
    v.combo_time -= 200;
    return 0;
  }
  int sent = garbage_block(c, v, n_cleared - 1, true);
  v.lines_sent += sent;
  combo_increase(c, v, n_cleared);
  return sent;
}

DEV void hd_make(const Cfg& c, Player& v) {
  uint32_t ext[MAX_H];
  ext_board(c, v.occ, ext);
  v.py += drop_distance(c, ext, v.cur_rows, v.px, v.py);
  add_piece(c, v.occ, v.cur_rows, v.px, v.py);
  v.drop_delay_time = v.time_ms;
  v.lockdown = false;
}

// returns the lines sent, or -1 on death
DEV int hd_finish(const Ctx& x, Player& v) {
  int n_cl, n_gb;
  clear_lines(*x.cfg, v.occ, v.garb, v.py, &n_cl, &n_gb);
  int sent = send_lines(*x.cfg, v, n_cl, n_gb);
  return make_new_piece(x, v) ? -1 : sent;
}

DEV bool game_mdown(const Cfg& c, Player& v) {
  uint32_t ext[MAX_H];
  ext_board(c, v.occ, ext);
  if (possible(c, ext, v.cur_rows, v.px, v.py + 1)) {
    v.py += 1;
    v.drop_delay_time = v.time_ms;
    v.lockdown = false;
    return true;
  }
  if (!v.lockdown) v.lockdown_time = v.time_ms + c.lockdown_ms;
  v.lockdown = true;
  return false;
}

DEV bool push_garbage(const Cfg& c, Player& v) {
  int hole = draw_hole(c, v);
  add_garbage_line(c, v.occ, v.garb, hole);
  int py1 = v.py > 0 ? v.py - 1 : v.py;
  uint32_t ext[MAX_H];
  ext_board(c, v.occ, ext);
  bool ok = possible(c, ext, v.cur_rows, v.px, py1);
  v.py = (!ok && py1 > 0) ? py1 - 1 : py1;
  return !ok && py1 <= 0;
}

// delayCheck (gamePlay.cpp:90-114); returns lines sent, or -1 on death.
DEV int delay_check(const Ctx& x, Player& v, int dt) {
  const Cfg& c = *x.cfg;
  v.time_ms += dt;
  int t = v.time_ms;
  if (t - v.incr_dd_time > 3000) {
    int dd = v.drop_delay;
    int dec = dd > 200 ? 10 : dd > 100 ? 5 : dd > 50 ? 2 : dd > 10 ? 1 : 0;
    v.drop_delay = dd - dec;
    v.incr_dd_time = t;
  }
  if (t - v.drop_delay_time > v.drop_delay) {
    v.drop_delay_time = t;
    game_mdown(c, v);
  }
  if (v.lockdown && t > v.lockdown_time) {
    if (!game_mdown(c, v)) {          // lockdown hard drop: early return
      hd_make(c, v);
      return hd_finish(x, v);
    }
  }
  int add_g = (int)floorf(v.incoming_lines);
  v.incoming_lines = F_SUB(v.incoming_lines, (float)add_g);
  if (add_g > 0) garbage_add(c, v, add_g);
  int sent = 0;
  int combo_sent = combo_check(x, v);
  if (combo_sent > 0) {
    int rem = garbage_block(c, v, combo_sent, false);
    v.lines_sent += rem;
    sent = rem;
  }
  if (garbage_check(c, v) && push_garbage(c, v)) return -1;
  return sent;
}

// ---------------------------------------------------------------------------
// The tick
// ---------------------------------------------------------------------------

DEV void apply_macro(const Ctx& x, Player& v, int r, int tr) {
  const Cfg& c = *x.cfg;
  uint32_t ext[MAX_H];
  ext_board(c, v.occ, ext);
  for (int k = 0; k < 3; k++)
    if (k < r) try_rotate(x, ext, v.piece, &v.rot, &v.px, &v.py, v.cur_rows, 1);
  v.px -= slide_distance(c, ext, v.cur_rows, v.px, v.py, -1);
  int right = slide_distance(c, ext, v.cur_rows, v.px, v.py, +1);
  v.px += tr < right ? tr : right;
  hd_make(c, v);
}

DEV void distribute(Game& g, int sender, int amount) {
  float per = (float)amount;      // amount / (P - 1) with P == 2
  for (int j = 0; j < 2; j++)
    if (j != sender) g.pl[j].incoming_lines = F_ADD(g.pl[j].incoming_lines, per);
}

// PythonHandle::finish_actions
DEV void finish_phase(const Ctx& x, Game& g) {
  bool broke = false;
  for (int i = 0; i < 2; i++) {
    Player& v = g.pl[i];
    if (v.dead || broke) continue;
    int sent = hd_finish(x, v);
    if (sent == -1) {
      v.dead = true;
      broke = true;
    } else if (sent > 0) {
      distribute(g, i, sent);
    }
  }
  int alive = 0;
  for (int i = 0; i < 2; i++) {
    Player& v = g.pl[i];
    if (v.dead) continue;
    int sent = delay_check(x, v, x.cfg->dt);
    if (sent == -1) {
      v.dead = true;
      continue;
    }
    v.reward = v.lines_cleared - v.lines_cleared_snap;
    v.lines_cleared_snap = v.lines_cleared;
    v.incoming_count = garbage_count(*x.cfg, v);
    if (sent > 0) distribute(g, i, sent);
    alive++;
  }
  g.round_over = alive < 2;
}

DEV void restart_round(const Cfg& c, Player& v) {
  garbage_clear(c, v);
  for (int y = 0; y < c.H; y++) { v.occ[y] = 0u; v.garb[y] = 0u; }
  v.combo_start = v.combo_time = v.combo_count = v.combo_line_count = 0;
  v.time_ms = 0;
  v.incoming_lines = 0.0f;
  v.lines_cleared_snap = 0;
  v.dead = false;
  v.drop_delay = 1000;
  v.drop_delay_time = v.incr_dd_time = 0;
  v.lockdown = false;
  v.lockdown_time = 0;
  v.lines_sent = v.lines_recv = v.garbage_cleared = v.lines_cleared = 0;
  v.lines_blocked = v.max_combo = 0;
}

// GamePlay::seed in closed form (engine/step.py _seed_round)
DEV void seed_round(const Ctx& x, Player& v, const uint32_t* pk,
                    const uint32_t* hk) {
  const Cfg& c = *x.cfg;
  const float fresh = (float)(1000 / 7);
  v.piece_key[0] = pk[0]; v.piece_key[1] = pk[1];
  v.hole_key[0] = hk[0]; v.hole_key[1] = hk[1];
  v.hole_draws = 0;
  v.lasthole = 20;
  float bag[7];
  for (int i = 0; i < 7; i++) bag[i] = fresh;
  int k = c.R, cand = 0, piece = 0;
  for (int i = 0; i <= c.R; i++) {
    cand = choose_from_bag(bag, draw_uniform(pk, i));
    piece = c.piece_map[cand];
    if (c.only_zs || (piece != 2 && piece != 3)) { k = i; break; }
  }
  bag_update(bag, cand);
  int cand_next = choose_from_bag(bag, draw_uniform(pk, k + 1));
  bag_update(bag, cand_next);
  for (int i = 0; i < 7; i++) v.cogp[i] = bag[i];
  v.piece_draws = k + 2;
  copy_piece(x, v, piece);
  v.nextpiece = c.piece_map[cand_next];
}

// PythonHandle::reset: record the winner, restart and reseed both players
DEV void reset_game(const Ctx& x, Game& g, const uint32_t* key) {
  int alive = 0, winner = -1;
  for (int i = 0; i < 2; i++)
    if (!g.pl[i].dead) { alive++; winner = i; }
  if (alive > 1) winner = -1;
  uint32_t pk[2], hk[2];
  fold_in(key, 0u, pk);
  fold_in(key, 1u, hk);
  for (int i = 0; i < 2; i++) {
    restart_round(*x.cfg, g.pl[i]);
    seed_round(x, g.pl[i], pk, hk);
  }
  g.round_over = false;
  g.last_winner = winner;
}

// One env tick (env/env.py step): the acting player's macro, the finish
// phase, reward/done before the reset, key split, auto-reset, flip.
DEV void env_tick(const Ctx& x, Game& g, int r, int t, float* reward,
                  bool* done) {
  const Cfg& c = *x.cfg;
  int me = g.current_player;
  if (!g.round_over) {
    for (int i = 0; i < 2; i++)
      if (!g.pl[i].dead && i == me) apply_macro(x, g.pl[i], r, t);
    finish_phase(x, g);
  }
  bool d = g.round_over;
  bool me_dead = g.pl[me & 1].dead, you_dead = g.pl[(1 - me) & 1].dead;
  int base = (me_dead && you_dead) ? -1 : (int)you_dead - (int)me_dead;
  if (!d) base = 0;
  float rew = (float)base;
  if (c.extra_rewards)
    rew = F_ADD(F_MUL(c.wbase, rew),
                F_MUL(c.wcombo, (float)g.pl[me & 1].combo_count));
  uint32_t next[2], rk[2];
  threefry2x32(g.key[0], g.key[1], 0u, 0u, &next[0], &next[1]);
  threefry2x32(g.key[0], g.key[1], 0u, 1u, &rk[0], &rk[1]);
  if (d) reset_game(x, g, rk);
  g.current_player = 1 - me;
  g.key[0] = next[0];
  g.key[1] = next[1];
  g.rounds_played += d ? 1 : 0;
  *reward = rew;
  *done = d;
}

// ---------------------------------------------------------------------------
// State I/O: leaf layout (N, P, ...) / (N, ...), game batch first
// ---------------------------------------------------------------------------

template <typename T>
DEV T* leaf(const Ptrs& p, int l) { return (T*)p.p[l]; }

#define LD_I(L, field)                                                  \
  for (int i = 0; i < 2; i++) g.pl[i].field = leaf<int32_t>(p, L)[n * 2 + i];
#define ST_I(L, field)                                                  \
  for (int i = 0; i < 2; i++) leaf<int32_t>(p, L)[n * 2 + i] = g.pl[i].field;

DEV void load_game(const Cfg& c, const Ptrs& p, int n, Game& g) {
  for (int i = 0; i < 2; i++) {
    Player& v = g.pl[i];
    const uint32_t* occ = leaf<uint32_t>(p, L_OCC) + (n * 2 + i) * c.H;
    const uint32_t* garb = leaf<uint32_t>(p, L_GARB) + (n * 2 + i) * c.H;
    for (int y = 0; y < c.H; y++) { v.occ[y] = occ[y]; v.garb[y] = garb[y]; }
    const uint32_t* cr = leaf<uint32_t>(p, L_CUR_ROWS) + (n * 2 + i) * 4;
    for (int k = 0; k < 4; k++) v.cur_rows[k] = cr[k];
    const int32_t* gc = leaf<int32_t>(p, L_G_COUNT) + (n * 2 + i) * c.CAP;
    const int32_t* gd = leaf<int32_t>(p, L_G_DELAY) + (n * 2 + i) * c.CAP;
    for (int j = 0; j < c.CAP; j++) { v.g_count[j] = gc[j]; v.g_delay[j] = gd[j]; }
    const float* cg = leaf<float>(p, L_COGP) + (n * 2 + i) * 7;
    for (int k = 0; k < 7; k++) v.cogp[k] = cg[k];
    const uint32_t* pk = leaf<uint32_t>(p, L_PIECE_KEY) + (n * 2 + i) * 2;
    const uint32_t* hk = leaf<uint32_t>(p, L_HOLE_KEY) + (n * 2 + i) * 2;
    v.piece_key[0] = pk[0]; v.piece_key[1] = pk[1];
    v.hole_key[0] = hk[0]; v.hole_key[1] = hk[1];
    v.lockdown = leaf<uint8_t>(p, L_LOCKDOWN)[n * 2 + i] != 0;
    v.dead = leaf<uint8_t>(p, L_DEAD)[n * 2 + i] != 0;
    v.incoming_lines = leaf<float>(p, L_INCOMING_LINES)[n * 2 + i];
  }
  LD_I(L_PIECE, piece) LD_I(L_ROT, rot) LD_I(L_PX, px) LD_I(L_PY, py)
  LD_I(L_NEXTPIECE, nextpiece) LD_I(L_TIME_MS, time_ms)
  LD_I(L_DROP_DELAY, drop_delay) LD_I(L_DROP_DELAY_TIME, drop_delay_time)
  LD_I(L_INCR_DD_TIME, incr_dd_time) LD_I(L_LOCKDOWN_TIME, lockdown_time)
  LD_I(L_COMBO_START, combo_start) LD_I(L_COMBO_TIME, combo_time)
  LD_I(L_COMBO_COUNT, combo_count) LD_I(L_COMBO_LINE_COUNT, combo_line_count)
  LD_I(L_COMBO_REMAINING, combo_remaining) LD_I(L_G_SIZE, g_size)
  LD_I(L_G_MIN_REMAINING, g_min_remaining)
  LD_I(L_INCOMING_COUNT, incoming_count) LD_I(L_LINES_SENT, lines_sent)
  LD_I(L_LINES_RECV, lines_recv) LD_I(L_GARBAGE_CLEARED, garbage_cleared)
  LD_I(L_LINES_CLEARED, lines_cleared) LD_I(L_LINES_BLOCKED, lines_blocked)
  LD_I(L_MAX_COMBO, max_combo) LD_I(L_LINES_CLEARED_SNAP, lines_cleared_snap)
  LD_I(L_REWARD, reward) LD_I(L_LASTHOLE, lasthole)
  LD_I(L_PIECE_DRAWS, piece_draws) LD_I(L_HOLE_DRAWS, hole_draws)
  g.round_over = leaf<uint8_t>(p, L_ROUND_OVER)[n] != 0;
  g.last_winner = leaf<int32_t>(p, L_LAST_WINNER)[n];
  g.current_player = leaf<int32_t>(p, L_CURRENT_PLAYER)[n];
  g.key[0] = leaf<uint32_t>(p, L_KEY)[n * 2];
  g.key[1] = leaf<uint32_t>(p, L_KEY)[n * 2 + 1];
  g.rounds_played = leaf<int32_t>(p, L_ROUNDS_PLAYED)[n];
}

DEV void store_game(const Cfg& c, const Ptrs& p, int n, const Game& g) {
  for (int i = 0; i < 2; i++) {
    const Player& v = g.pl[i];
    uint32_t* occ = leaf<uint32_t>(p, L_OCC) + (n * 2 + i) * c.H;
    uint32_t* garb = leaf<uint32_t>(p, L_GARB) + (n * 2 + i) * c.H;
    for (int y = 0; y < c.H; y++) { occ[y] = v.occ[y]; garb[y] = v.garb[y]; }
    uint32_t* cr = leaf<uint32_t>(p, L_CUR_ROWS) + (n * 2 + i) * 4;
    for (int k = 0; k < 4; k++) cr[k] = v.cur_rows[k];
    int32_t* gc = leaf<int32_t>(p, L_G_COUNT) + (n * 2 + i) * c.CAP;
    int32_t* gd = leaf<int32_t>(p, L_G_DELAY) + (n * 2 + i) * c.CAP;
    for (int j = 0; j < c.CAP; j++) { gc[j] = v.g_count[j]; gd[j] = v.g_delay[j]; }
    float* cg = leaf<float>(p, L_COGP) + (n * 2 + i) * 7;
    for (int k = 0; k < 7; k++) cg[k] = v.cogp[k];
    uint32_t* pk = leaf<uint32_t>(p, L_PIECE_KEY) + (n * 2 + i) * 2;
    uint32_t* hk = leaf<uint32_t>(p, L_HOLE_KEY) + (n * 2 + i) * 2;
    pk[0] = v.piece_key[0]; pk[1] = v.piece_key[1];
    hk[0] = v.hole_key[0]; hk[1] = v.hole_key[1];
    leaf<uint8_t>(p, L_LOCKDOWN)[n * 2 + i] = v.lockdown ? 1 : 0;
    leaf<uint8_t>(p, L_DEAD)[n * 2 + i] = v.dead ? 1 : 0;
    leaf<float>(p, L_INCOMING_LINES)[n * 2 + i] = v.incoming_lines;
  }
  ST_I(L_PIECE, piece) ST_I(L_ROT, rot) ST_I(L_PX, px) ST_I(L_PY, py)
  ST_I(L_NEXTPIECE, nextpiece) ST_I(L_TIME_MS, time_ms)
  ST_I(L_DROP_DELAY, drop_delay) ST_I(L_DROP_DELAY_TIME, drop_delay_time)
  ST_I(L_INCR_DD_TIME, incr_dd_time) ST_I(L_LOCKDOWN_TIME, lockdown_time)
  ST_I(L_COMBO_START, combo_start) ST_I(L_COMBO_TIME, combo_time)
  ST_I(L_COMBO_COUNT, combo_count) ST_I(L_COMBO_LINE_COUNT, combo_line_count)
  ST_I(L_COMBO_REMAINING, combo_remaining) ST_I(L_G_SIZE, g_size)
  ST_I(L_G_MIN_REMAINING, g_min_remaining)
  ST_I(L_INCOMING_COUNT, incoming_count) ST_I(L_LINES_SENT, lines_sent)
  ST_I(L_LINES_RECV, lines_recv) ST_I(L_GARBAGE_CLEARED, garbage_cleared)
  ST_I(L_LINES_CLEARED, lines_cleared) ST_I(L_LINES_BLOCKED, lines_blocked)
  ST_I(L_MAX_COMBO, max_combo) ST_I(L_LINES_CLEARED_SNAP, lines_cleared_snap)
  ST_I(L_REWARD, reward) ST_I(L_LASTHOLE, lasthole)
  ST_I(L_PIECE_DRAWS, piece_draws) ST_I(L_HOLE_DRAWS, hole_draws)
  leaf<uint8_t>(p, L_ROUND_OVER)[n] = g.round_over ? 1 : 0;
  leaf<int32_t>(p, L_LAST_WINNER)[n] = g.last_winner;
  leaf<int32_t>(p, L_CURRENT_PLAYER)[n] = g.current_player;
  leaf<uint32_t>(p, L_KEY)[n * 2] = g.key[0];
  leaf<uint32_t>(p, L_KEY)[n * 2 + 1] = g.key[1];
  leaf<int32_t>(p, L_ROUNDS_PLAYED)[n] = g.rounds_played;
}

// The per-game bodies of the two entries (shared with the host build of
// csrc/engine_tick_host.cpp)
DEV void step_game(const Ctx& x, const Ptrs& in, const Ptrs& out, int n,
                   const int32_t* r, const int32_t* t, float* reward,
                   uint8_t* done) {
  Game g;
  load_game(*x.cfg, in, n, g);
  bool d;
  env_tick(x, g, r[n], t[n], &reward[n], &d);
  done[n] = d ? 1 : 0;
  store_game(*x.cfg, out, n, g);
}

DEV void rollout_game(const Ctx& x, const Ptrs& in, const Ptrs& out, int n,
                      int n_ticks, const int32_t* ar, const int32_t* at,
                      int n_games, uint32_t k0, uint32_t k1,
                      int block_games) {
  Game g;
  load_game(*x.cfg, in, n, g);
  const uint32_t base[2] = {k0, k1};
  for (int tick = 0; tick < n_ticks; tick++) {
    int r, t;
    if (ar != 0) {
      r = ar[tick * n_games + n];
      t = at[tick * n_games + n];
    } else {
      uint32_t k1_[2], tk[2];
      fold_in(base, (uint32_t)tick, k1_);
      fold_in(k1_, (uint32_t)(n / block_games), tk);
      uint32_t bits = random_bits_at(tk, (uint32_t)(n % block_games));
      r = (int)(bits % 4u);
      t = (int)((bits >> 16) % (uint32_t)x.cfg->W);
    }
    float rew;
    bool d;
    env_tick(x, g, r, t, &rew, &d);
  }
  store_game(*x.cfg, out, n, g);
}

static inline void make_cfg(const int32_t* w, float wbase, float wcombo, float slope,
                  Cfg* c) {
  c->H = w[C_H]; c->W = w[C_W]; c->CAP = w[C_CAP]; c->R = w[C_R];
  c->init_delay = w[C_INIT_DELAY]; c->add_delay = w[C_ADD_DELAY];
  c->freeze_delay = w[C_FREEZE_DELAY]; c->line_mult = w[C_LINE_MULT];
  c->static_mult = w[C_STATIC_MULT]; c->lockdown_ms = w[C_LOCKDOWN_MS];
  c->dt = w[C_DT]; c->extra_rewards = w[C_EXTRA_REWARDS];
  c->only_zs = w[C_ONLY_ZS];
  for (int i = 0; i < 7; i++) c->piece_map[i] = w[C_PIECE_MAP + i];
  c->full_row = (uint32_t)((1ull << c->W) - 1ull);
  c->wall_mask = 0xFu | (uint32_t)((0xFFFFFFFFull << (c->W + 4)) & 0xFFFFFFFFull);
  c->wbase = wbase;
  c->wcombo = wcombo;
  c->dur_slope = slope;
}

#ifdef __CUDACC__

__global__ void step_kernel(Cfg cfg, Ptrs in, Ptrs out, const int32_t* r,
                            const int32_t* t, float* reward, uint8_t* done,
                            const uint32_t* tab, int* flags, int n_games) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_games) return;
  Ctx x = {&cfg, tab, flags};
  step_game(x, in, out, n, r, t, reward, done);
}

__global__ void rollout_kernel(Cfg cfg, Ptrs in, Ptrs out, int n_ticks,
                               const int32_t* ar, const int32_t* at,
                               uint32_t k0, uint32_t k1, int block_games,
                               const uint32_t* tab, int* flags, int n_games) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_games) return;
  Ctx x = {&cfg, tab, flags};
  rollout_game(x, in, out, n, n_ticks, ar, at, n_games, k0, k1, block_games);
}

static const int kThreads = 128;

static void to_ptrs(const int64_t* a, Ptrs* p) {
  for (int i = 0; i < N_LEAVES; i++) p->p[i] = (void*)(intptr_t)a[i];
}

extern "C" int engine_tick_n_leaves() { return N_LEAVES; }

extern "C" int engine_tick_step(const int32_t* icfg, float wbase, float wcombo,
                                float slope, const int64_t* in_ptrs,
                                const int64_t* out_ptrs, const int32_t* r,
                                const int32_t* t, float* reward, uint8_t* done,
                                const uint32_t* tab, int* flags, int n_games,
                                void* stream) {
  Cfg cfg;
  make_cfg(icfg, wbase, wcombo, slope, &cfg);
  Ptrs in, out;
  to_ptrs(in_ptrs, &in);
  to_ptrs(out_ptrs, &out);
  int blocks = (n_games + kThreads - 1) / kThreads;
  step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      cfg, in, out, r, t, reward, done, tab, flags, n_games);
  return (int)cudaGetLastError();
}

extern "C" int engine_tick_rollout(const int32_t* icfg, float wbase,
                                   float wcombo, float slope,
                                   const int64_t* in_ptrs,
                                   const int64_t* out_ptrs, int n_ticks,
                                   const int32_t* ar, const int32_t* at,
                                   uint32_t k0, uint32_t k1, int block_games,
                                   const uint32_t* tab, int* flags,
                                   int n_games, void* stream) {
  Cfg cfg;
  make_cfg(icfg, wbase, wcombo, slope, &cfg);
  Ptrs in, out;
  to_ptrs(in_ptrs, &in);
  to_ptrs(out_ptrs, &out);
  int blocks = (n_games + kThreads - 1) / kThreads;
  rollout_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      cfg, in, out, n_ticks, ar, at, k0, k1, block_games, tab, flags, n_games);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
