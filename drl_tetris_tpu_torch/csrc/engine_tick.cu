// Engine tick kernel for Hopper (sm_90a): the port of the TPU kernel
// drl_tetris_tpu/engine/pallas_tick.py::_rollout (its inner kernel/body,
// its wrapper rollout_pallas and batch tick env_step_batch), together with the
// helpers it ran inside that kernel: the raw-threefry RNG
// (engine/rng.py::fold_in, split2, random_bits, uniform01) and the static
// shifts and scans of engine/shifts.py (as lane shuffles and votes here).
//
// Design: one warp per game.  Lane y holds row y of both players' bitboards
// (occ, garb) and lane j holds garbage slots j and j + 32 of both FIFOs
// (g_count, g_delay), each in a register; lanes past H or CAP hold zeros.
// Fourteen per-player fields that the tick mostly writes or adds to (the
// counters, the hole key) sit one per lane in a register of their own
// (Player::cold).  The other scalars per player, the game scalars and the
// key words are kept and computed alike in every lane, so every branch of
// the tick is uniform across the warp: the control flow follows the JAX
// engine (engine/step.py) with real branches (the lockdown hard drop
// returns early, the finish phase's hard-drop loop stops at the first
// death) and never diverges.  On the common path (kick choice, hard drop,
// bag draw, spawn test, gravity) the tick uses selects where the scalar
// form branched: a uniform branch still costs this kernel its latency.
// Each loop of the scalar tick over rows or slots is a warp primitive: a
// vote (possible, kick probes, line clears), a ballot and find-first-set
// (drop distance), a min-reduction of each row's free shift (slides),
// shuffles (garbage line push, line-clear compaction, FIFO pops) and an
// add-reduction or scan (FIFO sums).  Independent threefry draws run in
// different lanes at once: the key split, the reseed's candidate pieces
// and 32 ticks of the in-kernel action keys.  The Mosaic workarounds of the
// TPU kernel are dropped, not ported: the bit-blend branch of step._sel,
// pallas_tick._bsel, the bool->int32 carries, the rank-1 -> (1, N) leaf
// promotion.
//
// The tick is written once, against a small lane-vector type V<T> and its
// primitives (per_lane, ballot, any, bcast, gather, shfl_down0, shfl_up0,
// reduce_add/min/or, scan_add).  Under nvcc a V is one register per lane
// and the primitives are warp intrinsics; without __CUDACC__ a V is an
// array of 32 values and the primitives are loops, so that
// csrc/engine_tick_host.cpp compiles this same tick with g++ for the CPU
// tests.
//
// Two entries share the tick:
//   engine_tick_step     one env tick; also writes the acting player's
//                        reward and done, taken before the reset merge
//                        (env/env.py step).  Carries the NN-in-the-loop
//                        rollout.
//   engine_tick_rollout  T ticks with the state held in registers; actions
//                        replayed from (T, N) arrays or drawn in-kernel as
//                        random_bits(fold_in(fold_in(base_key, tick),
//                        game / block_games)) at index game % block_games,
//                        r = bits % 4, t = (bits >> 16) % W, the stream of
//                        rollout_pallas for the same block_games.  The CUDA
//                        block (kWarps games) is independent of block_games.
//
// Leaf pointers: EnvState has N_LEAVES tensors, each contiguous with the
// game batch first ((N, P, ...), (N, ...)).  The wrapper passes two host
// arrays of device pointers (inputs, outputs) in the order of enum Leaf,
// which is the field order of engine/core.py PlayerState followed by the
// engine and env scalars; the C entry copies them into structs passed to
// the kernel by value (__grid_constant__).  uint32 leaves arrive as int32
// words, bools as one byte.  Lane y reads and writes row y of its game, so
// a warp's row and slot accesses are contiguous; scalar leaves are read by
// every lane from one address (one broadcast transaction, both players in
// one 8-byte word) and written by lane 0.
//
// Bound: a launch reads every state leaf once and writes it once (2 x 1,249
// bytes per game at the default config), which at 3.35 TB/s is under a
// microsecond per thousand games.  The tick needs about 1.6-1.8k 32-bit
// integer operations per game (chip_smoke.py tick_int_ops counts them term
// by term); over a derived int32 rate of 132 SMs x 64 lanes x the SM clock
// that is the larger side for the T-tick entry, and the bytes are for the
// one-tick entry.  Neither side is what holds the kernel back: a game's
// tick is one long chain of dependent operations, votes and shuffles, so
// the kernel is bound by that chain's latency.  The warp mapping shortens
// the chain (each row or slot loop is one warp operation; independent
// draws run in parallel lanes), keeps the state in registers (no per-game
// arrays in local memory), and gives 1024 games 1024 warps over all 132
// SMs.  The piece and payout tables are copied to shared memory once per
// block and read at uniform indices.
//
// Float32 arithmetic is written with explicit round-to-nearest intrinsics
// (and built with --fmad=false besides), in the forms XLA compiles the JAX
// engine into: see engine/step.py.  It stays scalar and in its order (no
// float reductions across lanes).  The combo payout's pow comes from the
// shared table COMBO_POW_BITS; a combo count past the table sets bit 0 of
// *flags, which the wrapper checks.

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#define UNROLL _Pragma("unroll")
#define F_ADD(a, b) __fadd_rn((a), (b))
#define F_SUB(a, b) __fsub_rn((a), (b))
#define F_MUL(a, b) __fmul_rn((a), (b))
#define F_DIV(a, b) __fdiv_rn((a), (b))
#define F_FMA(a, b, c) __fmaf_rn((a), (b), (c))
DEV float bits_to_float(uint32_t b) { return __uint_as_float(b); }
DEV uint32_t float_to_bits(float f) { return __float_as_uint(f); }
DEV int popc(uint32_t m) { return __popc(m); }
DEV int low_bit(uint32_t m) { return __ffs(m) - 1; }      // m != 0
DEV int high_bit(uint32_t m) { return 31 - __clz(m); }    // m != 0
#else
#include <math.h>
#define DEV static inline
#define UNROLL
#define F_ADD(a, b) ((a) + (b))
#define F_SUB(a, b) ((a) - (b))
#define F_MUL(a, b) ((a) * (b))
#define F_DIV(a, b) ((a) / (b))
#define F_FMA(a, b, c) fmaf((a), (b), (c))
DEV float bits_to_float(uint32_t b) { float f; memcpy(&f, &b, 4); return f; }
DEV uint32_t float_to_bits(float f) { uint32_t b; memcpy(&b, &f, 4); return b; }
DEV int popc(uint32_t m) { return __builtin_popcount(m); }
DEV int low_bit(uint32_t m) { return __builtin_ctz(m); }
DEV int high_bit(uint32_t m) { return 31 - __builtin_clz(m); }
#endif

// Limits: H <= WARP (a row per lane), CAP <= 2 * WARP (two slots per lane);
// engine/cuda_tick.py refuses larger configs.
#define WARP 32
#define BIG (1 << 20)
typedef unsigned long long u64;

// ---------------------------------------------------------------------------
// Lane vectors: one value per lane of the game's warp
// ---------------------------------------------------------------------------

#ifdef __CUDACC__
#define FULL_MASK 0xFFFFFFFFu

template <typename T>
struct V {
  T x;
  DEV T operator[](int) const { return x; }
};

DEV int lane_id() { return (int)(threadIdx.x & (WARP - 1)); }
DEV bool lead() { return lane_id() == 0; }

// f(lane) in every lane
template <typename F>
DEV auto per_lane(F f) -> V<decltype(f(0))> { return {f(lane_id())}; }
template <typename F>
DEV void for_lanes(F f) { f(lane_id()); }

DEV uint32_t ballot(const V<bool>& p) { return __ballot_sync(FULL_MASK, p.x); }
DEV bool any(const V<bool>& p) { return __any_sync(FULL_MASK, p.x); }
// lane src's value, in every lane
template <typename T>
DEV T bcast(const V<T>& v, int src) { return __shfl_sync(FULL_MASK, v.x, src); }
// lane l gets v[src[l]], src in [0, 31]
template <typename T>
DEV V<T> gather(const V<T>& v, const V<int>& src) {
  return {__shfl_sync(FULL_MASK, v.x, src.x)};
}
// lane l gets v[l + n], 0 past the last lane (n >= 0)
template <typename T>
DEV V<T> shfl_down0(const V<T>& v, int n) {
  T r = __shfl_down_sync(FULL_MASK, v.x, (unsigned)n & (WARP - 1));
  return {n < WARP && lane_id() + n < WARP ? r : T(0)};
}
// lane l gets v[l - n], 0 before the first lane (n >= 0)
template <typename T>
DEV V<T> shfl_up0(const V<T>& v, int n) {
  T r = __shfl_up_sync(FULL_MASK, v.x, (unsigned)n & (WARP - 1));
  return {n < WARP && lane_id() >= n ? r : T(0)};
}
DEV int reduce_add(const V<int>& v) {
  return (int)__reduce_add_sync(FULL_MASK, (unsigned)v.x);
}
DEV int reduce_min(const V<int>& v) { return __reduce_min_sync(FULL_MASK, v.x); }
DEV uint32_t reduce_or(const V<uint32_t>& v) {
  return __reduce_or_sync(FULL_MASK, v.x);
}
// inclusive prefix sum over the lanes
DEV V<int> scan_add(const V<int>& v) {
  int s = v.x;
  UNROLL
  for (int d = 1; d < WARP; d <<= 1) {
    int y = __shfl_up_sync(FULL_MASK, s, d);
    if (lane_id() >= d) s += y;
  }
  return {s};
}
DEV void set_flag(int* flags) {
  if (lead()) atomicOr(flags, 1);
}

#else  // host form: a warp is an array of 32 lanes

template <typename T>
struct V {
  T x[WARP];
  T operator[](int l) const { return x[l]; }
};

DEV bool lead() { return true; }

template <typename F>
static auto per_lane(F f) -> V<decltype(f(0))> {
  V<decltype(f(0))> v;
  for (int l = 0; l < WARP; l++) v.x[l] = f(l);
  return v;
}
template <typename F>
static void for_lanes(F f) {
  for (int l = 0; l < WARP; l++) f(l);
}

DEV uint32_t ballot(const V<bool>& p) {
  uint32_t m = 0;
  for (int l = 0; l < WARP; l++) m |= (uint32_t)p.x[l] << l;
  return m;
}
DEV bool any(const V<bool>& p) { return ballot(p) != 0u; }
template <typename T>
static T bcast(const V<T>& v, int src) { return v.x[src]; }
template <typename T>
static V<T> gather(const V<T>& v, const V<int>& src) {
  V<T> r;
  for (int l = 0; l < WARP; l++) r.x[l] = v.x[src.x[l] & (WARP - 1)];
  return r;
}
template <typename T>
static V<T> shfl_down0(const V<T>& v, int n) {
  V<T> r;
  for (int l = 0; l < WARP; l++) r.x[l] = l + n < WARP ? v.x[l + n] : T(0);
  return r;
}
template <typename T>
static V<T> shfl_up0(const V<T>& v, int n) {
  V<T> r;
  for (int l = 0; l < WARP; l++) r.x[l] = l >= n ? v.x[l - n] : T(0);
  return r;
}
DEV int reduce_add(const V<int>& v) {
  uint32_t s = 0;
  for (int l = 0; l < WARP; l++) s += (uint32_t)v.x[l];
  return (int)s;
}
DEV int reduce_min(const V<int>& v) {
  int m = v.x[0];
  for (int l = 1; l < WARP; l++) m = v.x[l] < m ? v.x[l] : m;
  return m;
}
DEV uint32_t reduce_or(const V<uint32_t>& v) {
  uint32_t m = 0;
  for (int l = 0; l < WARP; l++) m |= v.x[l];
  return m;
}
DEV V<int> scan_add(const V<int>& v) {
  V<int> r;
  uint32_t s = 0;
  for (int l = 0; l < WARP; l++) { s += (uint32_t)v.x[l]; r.x[l] = (int)s; }
  return r;
}
DEV void set_flag(int* flags) { *flags |= 1; }

#endif  // __CUDACC__

template <typename T>
DEV V<T> zeros() { return per_lane([](int) { return T(0); }); }

// ---------------------------------------------------------------------------
// State
// ---------------------------------------------------------------------------

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

// Offsets into the table: ROW_MASKS (7x4x4), SPAWN_ROT (7),
// COMBO_POW_BITS (256).
#define TAB_ROWS 0
#define TAB_SPAWN 112
#define TAB_POW 119
#define N_POW 256
#define N_TAB (TAB_POW + N_POW)

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

// A garbage FIFO's slot array: slot j in lane j of lo, slot j + 32 in lane j
// of hi; slots past CAP hold 0.
struct Slots { V<int> lo, hi; };

// Per-player fields that the tick mostly writes or adds to: lane k of the
// player's `cold` register holds field k, so that they take one register
// and not fourteen.  A write is a select in its lane, a read a broadcast.
enum Cold {
  K_COMBO_REMAINING, K_INCOMING_COUNT, K_LINES_SENT, K_LINES_RECV,
  K_GARBAGE_CLEARED, K_LINES_CLEARED, K_LINES_BLOCKED, K_MAX_COMBO,
  K_LINES_CLEARED_SNAP, K_REWARD, K_LASTHOLE, K_HOLE_DRAWS, K_HOLE_KEY0,
  K_HOLE_KEY1, N_COLD
};

struct Player {
  V<uint32_t> occ, garb;                 // lane y: row y
  int piece, rot, px, py;
  uint32_t cur_rows[4];
  int nextpiece, time_ms, drop_delay, drop_delay_time, incr_dd_time;
  bool lockdown;
  int lockdown_time;
  int combo_start, combo_time, combo_count, combo_line_count;
  Slots g_count, g_delay;
  int g_size, g_min_remaining;
  float incoming_lines;
  bool dead;
  float cogp[7];
  uint32_t piece_key[2];
  int piece_draws;
  V<int> cold;                           // lane k: field k of enum Cold
};

DEV int cold_get(const Player& v, int k) { return bcast(v.cold, k); }
DEV void cold_set(Player& v, int k, int x) {
  v.cold = per_lane([&](int l) { return l == k ? x : v.cold[l]; });
}
DEV void cold_add(Player& v, int k, int x) {
  v.cold = per_lane([&](int l) { return l == k ? v.cold[l] + x : v.cold[l]; });
}

struct Game {
  Player pl[2];
  bool round_over;
  int last_winner, current_player, rounds_played;
  uint32_t key[2];
};

struct Ctx {               // what every tick function reads besides state
  const Cfg* cfg;
  const uint32_t* tab;     // shared memory on the card
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
  UNROLL
  for (int i = 0; i < 5; i++) {
    UNROLL
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

// fold_in(key, 0) and fold_in(key, 1) (== split2), in two lanes at once
DEV void fold_in_01(const uint32_t* key, uint32_t* a, uint32_t* b) {
  V<u64> w = per_lane([&](int l) -> u64 {
    uint32_t o[2];
    fold_in(key, (uint32_t)(l & 1), o);
    return (u64)o[0] | ((u64)o[1] << 32);
  });
  u64 w0 = bcast(w, 0), w1 = bcast(w, 1);
  a[0] = (uint32_t)w0; a[1] = (uint32_t)(w0 >> 32);
  b[0] = (uint32_t)w1; b[1] = (uint32_t)(w1 >> 32);
}

// ---------------------------------------------------------------------------
// Bitboard primitives (engine/kernels.py); uint32 shifts outside [0, 31]
// give 0, as XLA's do.  Piece rows are 4-bit masks (ROW_MASKS).
// ---------------------------------------------------------------------------

#ifdef __CUDACC__
// one clamped funnel shift each: a shift past 31 (or negative, which is
// past 31 as unsigned) moves every bit out
DEV uint32_t shl32(uint32_t x, int s) { return __funnelshift_lc(0u, x, (unsigned)s); }
DEV uint32_t shr32(uint32_t x, int s) { return __funnelshift_rc(x, 0u, (unsigned)s); }
#else
DEV uint32_t shl32(uint32_t x, int s) {
  return (s >= 0 && s < 32) ? (x << s) : 0u;
}
DEV uint32_t shr32(uint32_t x, int s) {
  return (s >= 0 && s < 32) ? (x >> s) : 0u;
}
#endif

// rows[i] for i in [0, 3], else 0
DEV uint32_t row_at(const uint32_t* rows, int i) {
  return i == 0 ? rows[0] : i == 1 ? rows[1] : i == 2 ? rows[2]
       : i == 3 ? rows[3] : 0u;
}

DEV int pmap(const Cfg& c, int i) {          // c.piece_map[i], i in [0, 6]
  int p = c.piece_map[0];
  UNROLL
  for (int k = 1; k < 7; k++) p = i == k ? c.piece_map[k] : p;
  return p;
}

// the walled board: lane y holds (occ[y] << 4) | wall_mask
DEV V<uint32_t> ext_board(const Cfg& c, const V<uint32_t>& occ) {
  return per_lane([&](int l) -> uint32_t { return (occ[l] << 4) | c.wall_mask; });
}

DEV void lookup_rows(const Ctx& x, int piece, int rot, uint32_t* rows) {
  bool ok = piece >= 0 && piece < 7 && rot >= 0 && rot < 4;
  UNROLL
  for (int i = 0; i < 4; i++)
    rows[i] = ok ? x.tab[TAB_ROWS + (piece * 4 + rot) * 4 + i] : 0u;
}

DEV bool possible(const Cfg& c, const V<uint32_t>& ext, const uint32_t* rows,
                  int px, int py) {
  bool in_range = true;
  UNROLL
  for (int i = 0; i < 4; i++) {
    int y = py + i;
    if (rows[i] != 0 && (y < 0 || y > c.H - 1)) in_range = false;
  }
  bool hit = any(per_lane([&](int l) {
    return l < c.H && (ext[l] & shl32(row_at(rows, l - py), px + 4)) != 0u;
  }));
  return in_range && !hit;
}

DEV int drop_distance(const Cfg& c, const V<uint32_t>& ext,
                      const uint32_t* rows, int px, int py) {
  int first = BIG;
  UNROLL
  for (int i = 0; i < 4; i++) {          // no branches: the 4 ballots overlap
    uint32_t sh = shl32(rows[i], px + 4);
    int base = py + i;
    uint32_t hit = ballot(per_lane([&](int l) {
      return l < c.H && l > base && (ext[l] & sh) != 0u;
    }));
    int d_hit = hit ? low_bit(hit) - base : BIG;
    int d_i = d_hit < c.H - base ? d_hit : c.H - base;
    first = rows[i] != 0 && d_i < first ? d_i : first;
  }
  return first - 1 > 0 ? first - 1 : 0;
}

// Steps the piece can slide in direction dir (+1 right, -1 left): the
// scalar loop probes s = 1 .. W+3 at shift px+4+dir*s and stops at a shift
// outside [0, 27] or at a collision.  Each lane finds the first colliding
// s of its own row with a bit scan; the warp takes the minimum.
DEV int slide_distance(const Cfg& c, const V<uint32_t>& ext,
                       const uint32_t* rows, int px, int py, int dir) {
  int s_oor;                             // first s with the shift out of range
  if (dir > 0) s_oor = 24 - px > 1 ? 24 - px : 1;
  else s_oor = px + 3 > 27 ? 1 : (px + 5 > 1 ? px + 5 : 1);
  if (dir > 0 && px + 5 < 0) s_oor = 1;
  int s_hit = reduce_min(per_lane([&](int l) {
    uint32_t row = l < c.H ? row_at(rows, l - py) : 0u;
    uint32_t e = ext[l], m = 0u;         // bit k: row << k meets the board
    UNROLL
    for (int b = 0; b < 4; b++)
      if ((row >> b) & 1u) m |= e >> b;
    m &= 0x0FFFFFFFu;
    if (dir > 0) {                       // shifts k >= px + 5
      int k0 = px + 5;
      uint32_t mm = k0 <= 0 ? m : k0 > 27 ? 0u : m & ~((1u << k0) - 1u);
      return mm ? low_bit(mm) - px - 4 : BIG;
    }
    int k1 = px + 3;                     // shifts k <= px + 3
    uint32_t mm = k1 < 0 ? 0u : k1 >= 27 ? m : m & ((2u << k1) - 1u);
    return mm ? px + 4 - high_bit(mm) : BIG;
  }));
  int s = s_hit < s_oor ? s_hit : s_oor;
  return s < c.W + 4 ? s - 1 : BIG - 1;
}

DEV void add_piece(const Cfg& c, V<uint32_t>& occ, const uint32_t* rows,
                   int px, int py, bool add_it = true) {
  occ = per_lane([&](int l) -> uint32_t {
    uint32_t r = row_at(rows, l - py);
    uint32_t add = px >= 0 ? shl32(r, px) : shr32(r, -px);
    return l < c.H && add_it ? occ[l] | add : occ[l];
  });
}

// Rotate by `turns` with the kick probes (gameField.cpp:55-103); updates
// rot/px/py/rows in place at the first probe that fits.  Each lane tests
// its row against all 8 kicks; one OR-reduction gives the colliding kicks,
// and the first free kick is a find-first-set.  Kick k moves the piece by
// (kdx, kdy) = ({0, 0, -1, 1, -1, 1, -2, 2}, {0, 1, 0, 0, 1, 1, 0, 0})[k]:
// kdx + 2 is nibble k of KICK_DX2, kdy bit k of KICK_DY.
#define KICK_DX2 0x40313122u
#define KICK_DY 0x32u
DEV void try_rotate(const Ctx& x, const V<uint32_t>& ext, int piece, int* rot,
                    int* px, int* py, uint32_t* rows, int turns) {
  const Cfg& c = *x.cfg;
  int new_rot = (*rot + turns) & 3;       // == ((rot + turns) % 4 + 4) % 4
  uint32_t nr[4];
  lookup_rows(x, piece, new_rot, nr);
  const int x0 = *px, y0 = *py;
  bool oob[2] = {false, false};
  UNROLL
  for (int dy = 0; dy < 2; dy++)
    UNROLL
    for (int i = 0; i < 4; i++) {
      int y = y0 + dy + i;
      if (nr[i] != 0 && (y < 0 || y > c.H - 1)) oob[dy] = true;
    }
  uint32_t hit = reduce_or(per_lane([&](int l) -> uint32_t {
    const uint32_t r0 = row_at(nr, l - y0), r1 = row_at(nr, l - y0 - 1);
    uint32_t m = 0u;
    UNROLL
    for (int k = 0; k < 8; k++) {
      uint32_t r = (KICK_DY >> k) & 1u ? r1 : r0;
      int dx = (int)((KICK_DX2 >> (4 * k)) & 0xFu) - 2;
      if (l < c.H && (ext[l] & shl32(r, x0 + dx + 4))) m |= 1u << k;
    }
    return m;
  }));
  uint32_t ok = ~(hit | (oob[0] ? ~KICK_DY : 0u) | (oob[1] ? KICK_DY : 0u)) &
                0xFFu;
  int k = ok ? low_bit(ok) : 0;           // no free kick: nothing moves
  *rot = ok ? new_rot : *rot;
  *px = ok ? x0 + (int)((KICK_DX2 >> (4 * k)) & 0xFu) - 2 : x0;
  *py = ok ? y0 + (int)((KICK_DY >> k) & 1u) : y0;
  UNROLL
  for (int i = 0; i < 4; i++) rows[i] = ok ? nr[i] : rows[i];
}

// BasicField::clearlines over the scan window [py, py+H-1]; kept rows fall
// by the number of full rows below them (rows falling more than 4 are
// dropped, as the JAX compaction does).  A ballot finds the full rows; each
// kept row's fall is the popcount of full rows below it, and five shuffles
// (falls 0..4) move the rows down.
DEV void clear_lines(const Cfg& c, V<uint32_t>& occ, V<uint32_t>& garb,
                     int py, int* n_cleared, int* n_garb) {
  uint32_t full = ballot(per_lane([&](int l) {
    return l < c.H && occ[l] == c.full_row && l >= py && l <= py + c.H - 1;
  }));
  uint32_t has_garb = ballot(per_lane([&](int l) { return garb[l] != 0u; }));
  *n_cleared = popc(full);
  *n_garb = popc(full & has_garb);
  if (full == 0u) return;
  V<int> fall = per_lane([&](int l) {
    int below = popc(shr32(full, l + 1));
    bool keep = l < c.H && !((full >> l) & 1u) && below <= 4 &&
                l + below < c.H;
    return keep ? below : -1;
  });
  V<uint32_t> o2 = zeros<uint32_t>(), g2 = zeros<uint32_t>();
  UNROLL
  for (int d = 0; d <= 4; d++) {
    V<int> f = shfl_up0(fall, d);
    V<uint32_t> so = shfl_up0(occ, d), sg = shfl_up0(garb, d);
    o2 = per_lane([&](int l) -> uint32_t { return f[l] == d ? o2[l] | so[l] : o2[l]; });
    g2 = per_lane([&](int l) -> uint32_t { return f[l] == d ? g2[l] | sg[l] : g2[l]; });
  }
  occ = o2;
  garb = g2;
}

DEV void add_garbage_line(const Cfg& c, V<uint32_t>& occ, V<uint32_t>& garb,
                          int hole) {
  uint32_t row = c.full_row & ~shl32(1u, hole);
  V<uint32_t> so = shfl_down0(occ, 1), sg = shfl_down0(garb, 1);
  occ = per_lane([&](int l) -> uint32_t {
    return l < c.H - 1 ? so[l] : l == c.H - 1 ? row : occ[l];
  });
  garb = per_lane([&](int l) -> uint32_t {
    return l < c.H - 1 ? sg[l] : l == c.H - 1 ? row : garb[l];
  });
}

// ---------------------------------------------------------------------------
// Randomizer (randomizer.cpp)
// ---------------------------------------------------------------------------

// the first i at which u * 1000 - cogp[0] - ... - cogp[i] < 0, else 0
// (the same float operations in the same order; selects, not branches)
DEV int choose_from_bag(const float* cogp, float u) {
  float rem = F_MUL(u, 1000.0f);
  int chosen = -1;
  UNROLL
  for (int i = 0; i < 7; i++) {
    rem = F_SUB(rem, cogp[i]);
    chosen = chosen < 0 && rem < 0.0f ? i : chosen;
  }
  return chosen < 0 ? 0 : chosen;
}

DEV void bag_update(float* cogp, int chosen) {
  float cval = cogp[0];
  UNROLL
  for (int i = 1; i < 7; i++) cval = i == chosen ? cogp[i] : cval;
  UNROLL
  for (int i = 0; i < 7; i++)
    cogp[i] = i == chosen ? F_MUL(cval, 0.25f)
                          : F_ADD(cogp[i], F_MUL(cval, 0.125f));
}

// the next piece from u = uniform01(fold_in(piece_key, piece_draws))
DEV int draw_piece(Player& v, float u) {
  int chosen = choose_from_bag(v.cogp, u);
  bag_update(v.cogp, chosen);
  v.piece_draws += 1;
  return chosen;
}

DEV int draw_hole(const Cfg& c, Player& v) {
  const uint32_t key[2] = {(uint32_t)cold_get(v, K_HOLE_KEY0),
                           (uint32_t)cold_get(v, K_HOLE_KEY1)};
  int draws = cold_get(v, K_HOLE_DRAWS);
  float u = draw_uniform(key, draws);
  int hole = (int)F_MUL(u, (float)c.W);
  v.cold = per_lane([&](int l) {
    return l == K_LASTHOLE ? hole : l == K_HOLE_DRAWS ? draws + 1 : v.cold[l];
  });
  return hole;
}

// ---------------------------------------------------------------------------
// Garbage FIFO (Garbage.cpp): front at slot 0, pops shift left
// ---------------------------------------------------------------------------

DEV int slot_get(const Slots& s, int j) {
  return j < WARP ? bcast(s.lo, j) : bcast(s.hi, j - WARP);
}

DEV void slot_set(Slots& s, int j, int val) {
  if (j < WARP) s.lo = per_lane([&](int l) { return l == j ? val : s.lo[l]; });
  else s.hi = per_lane([&](int l) { return l == j - WARP ? val : s.hi[l]; });
}

// slot src[l] of a, 0 where src >= cap (src >= 0)
DEV V<int> slot_gather(const Slots& a, const V<int>& src, int cap) {
  V<int> idx = per_lane([&](int l) { return src[l] & (WARP - 1); });
  V<int> lo = gather(a.lo, idx);
  V<int> hi = cap > WARP ? gather(a.hi, idx) : zeros<int>();
  return per_lane([&](int l) {
    return src[l] < cap ? (src[l] < WARP ? lo[l] : hi[l]) : 0;
  });
}

DEV void shift_left(Slots& a, int n, int cap) {
  if (n == 0) return;
  V<int> lo = slot_gather(a, per_lane([&](int l) { return l + n; }), cap);
  if (cap > WARP)
    a.hi = slot_gather(a, per_lane([&](int l) { return l + WARP + n; }), cap);
  a.lo = lo;
}

// sum of the first `lim` slots
DEV int slots_sum(const Slots& s, int lim) {
  return reduce_add(per_lane([&](int l) {
    return (l < lim ? s.lo[l] : 0) + (l + WARP < lim ? s.hi[l] : 0);
  }));
}

DEV int garbage_count(const Cfg& c, const Player& v) {
  return slots_sum(v.g_count, v.g_size < c.CAP ? v.g_size : c.CAP);
}

DEV void garbage_add(const Cfg& c, Player& v, int amount) {
  bool full = v.g_size >= c.CAP;
  int tail = v.g_size < c.CAP - 1 ? v.g_size : c.CAP - 1;
  if (full) {
    slot_set(v.g_count, tail, slot_get(v.g_count, tail) + amount);
  } else {
    slot_set(v.g_count, tail, amount);
    slot_set(v.g_delay, tail, v.time_ms + c.init_delay);
  }
  v.g_size = v.g_size + 1 < c.CAP ? v.g_size + 1 : c.CAP;
}

// GarbageHandler::block: returns the lines left after blocking.  The
// running sum over the live slots is a warp scan.
DEV int garbage_block(const Cfg& c, Player& v, int amount, bool freeze) {
  if (v.g_size == 0) return amount;
  int live = v.g_size < c.CAP ? v.g_size : c.CAP;
  Slots& gc = v.g_count;
  V<int> cs_lo = scan_add(per_lane([&](int l) { return l < live ? gc.lo[l] : 0; }));
  int total = bcast(cs_lo, WARP - 1);
  V<int> cs_hi = zeros<int>();
  if (c.CAP > WARP) {
    V<int> s = scan_add(per_lane([&](int l) {
      return l + WARP < live ? gc.hi[l] : 0;
    }));
    cs_hi = per_lane([&](int l) { return s[l] + total; });
    total = bcast(cs_hi, WARP - 1);
  }
  int blocked = amount < total ? amount : total;
  int delay0 = slot_get(v.g_delay, 0);
  auto left = [&](int csum, int cnt) {
    int nc = csum - blocked > 0 ? csum - blocked : 0;
    return nc > cnt ? cnt : nc;
  };
  int n_popped =
      popc(ballot(per_lane([&](int l) { return l < live && cs_lo[l] <= blocked; }))) +
      popc(ballot(per_lane([&](int l) {
        return l + WARP < live && cs_hi[l] <= blocked;
      })));
  gc.lo = per_lane([&](int l) { return l < live ? left(cs_lo[l], gc.lo[l]) : gc.lo[l]; });
  if (c.CAP > WARP)
    gc.hi = per_lane([&](int l) {
      return l + WARP < live ? left(cs_hi[l], gc.hi[l]) : gc.hi[l];
    });
  shift_left(v.g_count, n_popped, c.CAP);
  shift_left(v.g_delay, n_popped, c.CAP);
  int size = v.g_size - n_popped;
  int d0 = slot_get(v.g_delay, 0);
  int fd = delay0 > d0 ? delay0 : d0;
  if (freeze) {
    int a = fd + c.freeze_delay;
    int b = v.time_ms + v.g_min_remaining + c.freeze_delay;
    fd = a < b ? a : b;
  }
  if (size > 0) slot_set(v.g_delay, 0, fd);
  else v.g_min_remaining = c.init_delay;
  v.g_size = size;
  cold_add(v, K_LINES_BLOCKED, blocked);
  return amount - blocked;
}

// GarbageHandler::check: pop one pending line when the front delay lapses.
DEV bool garbage_check(const Cfg& c, Player& v) {
  if (v.g_size == 0) return false;
  int t = v.time_ms;
  int d0 = slot_get(v.g_delay, 0);
  if (!(t > d0)) {
    if (d0 - t < v.g_min_remaining) v.g_min_remaining = d0 - t;
    return false;
  }
  int chain = d0 + c.add_delay;
  int nf = slot_get(v.g_count, 0) - 1;
  slot_set(v.g_count, 0, nf);
  if (nf == 0) {
    shift_left(v.g_count, 1, c.CAP);
    shift_left(v.g_delay, 1, c.CAP);
    v.g_size -= 1;
  }
  if (v.g_size > 0) {
    int front = slot_get(v.g_delay, 0);
    int fd = chain > front ? chain : front;
    slot_set(v.g_delay, 0, fd);
    v.g_min_remaining = fd - t;
  } else {
    v.g_min_remaining = c.init_delay;
  }
  return true;
}

DEV void garbage_clear(const Cfg& c, Player& v) {
  v.g_count.lo = v.g_count.hi = zeros<int>();
  v.g_delay.lo = v.g_delay.hi = zeros<int>();
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
  UNROLL
  for (int i = 0; i < 4; i++) {
    if (i < amount) {
      lc += 1;
      lt = F_ADD(lt, F_DIV((float)c.line_mult, (float)lc));
    }
  }
  v.combo_time = (int)F_ADD(F_ADD((float)ctime, (float)(c.static_mult / cc)), lt);
  v.combo_count = cc;
  v.combo_line_count = lc;
  v.cold = per_lane([&](int l) {
    return l == K_MAX_COMBO && cc > v.cold[l] ? cc : v.cold[l];
  });
}

DEV int combo_check(const Ctx& x, Player& v) {
  int t = v.time_ms;
  int deadline = v.combo_start + v.combo_time;
  cold_set(v, K_COMBO_REMAINING, deadline - t > 0 ? deadline - t : 0);
  if (!(t > deadline && v.combo_count != 0)) return 0;
  int cc = v.combo_count;
  if (cc >= N_POW) {
    set_flag(x.flags);
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

DEV bool make_new_piece(const Ctx& x, Player& v, float u) {
  const Cfg& c = *x.cfg;
  copy_piece(x, v, v.nextpiece);
  v.nextpiece = pmap(c, draw_piece(v, u));
  bool blocked = !possible(c, ext_board(c, v.occ), v.cur_rows, v.px, v.py);
  add_piece(c, v.occ, v.cur_rows, v.px, v.py, blocked);   // the death mark
  return blocked;
}

DEV int send_lines(const Cfg& c, Player& v, int n_cleared, int n_garb) {
  v.cold = per_lane([&](int l) {
    return v.cold[l] + (l == K_GARBAGE_CLEARED ? n_garb
                        : l == K_LINES_CLEARED ? n_cleared : 0);
  });
  if (n_cleared == 0) {
    v.combo_time -= 200;
    return 0;
  }
  int sent = garbage_block(c, v, n_cleared - 1, true);
  cold_add(v, K_LINES_SENT, sent);
  combo_increase(c, v, n_cleared);
  return sent;
}

DEV void hd_make(const Cfg& c, Player& v) {
  v.py += drop_distance(c, ext_board(c, v.occ), v.cur_rows, v.px, v.py);
  add_piece(c, v.occ, v.cur_rows, v.px, v.py);
  v.drop_delay_time = v.time_ms;
  v.lockdown = false;
}

// returns the lines sent, or -1 on death; u: the new piece's draw
DEV int hd_finish(const Ctx& x, Player& v, float u) {
  int n_cl, n_gb;
  clear_lines(*x.cfg, v.occ, v.garb, v.py, &n_cl, &n_gb);
  int sent = send_lines(*x.cfg, v, n_cl, n_gb);
  return make_new_piece(x, v, u) ? -1 : sent;
}

DEV bool game_mdown(const Cfg& c, Player& v) {
  if (possible(c, ext_board(c, v.occ), v.cur_rows, v.px, v.py + 1)) {
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
  bool ok = possible(c, ext_board(c, v.occ), v.cur_rows, v.px, py1);
  v.py = (!ok && py1 > 0) ? py1 - 1 : py1;
  return !ok && py1 <= 0;
}

// delayCheck (gamePlay.cpp:90-114); returns lines sent, or -1 on death.
DEV int delay_check(const Ctx& x, Player& v, int dt) {
  const Cfg& c = *x.cfg;
  v.time_ms += dt;
  int t = v.time_ms;
  // the drop delay speeds up every 3 s; gravity moves the piece down (or
  // starts the lockdown) once the drop delay has passed.  Selects, not
  // branches: the move-down probe is made every tick.
  bool speed_up = t - v.incr_dd_time > 3000;
  int dd = v.drop_delay;
  int dec = dd > 200 ? 10 : dd > 100 ? 5 : dd > 50 ? 2 : dd > 10 ? 1 : 0;
  v.drop_delay = speed_up ? dd - dec : dd;
  v.incr_dd_time = speed_up ? t : v.incr_dd_time;
  bool fall = t - v.drop_delay_time > v.drop_delay;
  bool down = possible(c, ext_board(c, v.occ), v.cur_rows, v.px, v.py + 1);
  v.drop_delay_time = fall ? t : v.drop_delay_time;
  v.py = fall && down ? v.py + 1 : v.py;
  v.lockdown_time = fall && !down && !v.lockdown ? t + c.lockdown_ms
                                                 : v.lockdown_time;
  v.lockdown = fall ? !down : v.lockdown;
  if (v.lockdown && t > v.lockdown_time) {
    if (!game_mdown(c, v)) {          // lockdown hard drop: early return
      hd_make(c, v);
      return hd_finish(x, v, draw_uniform(v.piece_key, v.piece_draws));
    }
  }
  int add_g = (int)floorf(v.incoming_lines);
  v.incoming_lines = F_SUB(v.incoming_lines, (float)add_g);
  if (add_g > 0) garbage_add(c, v, add_g);
  int sent = 0;
  int combo_sent = combo_check(x, v);
  if (combo_sent > 0) {
    int rem = garbage_block(c, v, combo_sent, false);
    cold_add(v, K_LINES_SENT, rem);
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
  V<uint32_t> ext = ext_board(c, v.occ);
  for (int k = 0; k < 3; k++)
    if (k < r) try_rotate(x, ext, v.piece, &v.rot, &v.px, &v.py, v.cur_rows, 1);
  v.px -= slide_distance(c, ext, v.cur_rows, v.px, v.py, -1);
  int right = slide_distance(c, ext, v.cur_rows, v.px, v.py, +1);
  v.px += tr < right ? tr : right;
  hd_make(c, v);
}

DEV void distribute(Game& g, int sender, int amount) {
  float per = (float)amount;      // amount / (P - 1) with P == 2
  UNROLL
  for (int j = 0; j < 2; j++)
    if (j != sender) g.pl[j].incoming_lines = F_ADD(g.pl[j].incoming_lines, per);
}

// PythonHandle::finish_actions; u[i]: player i's first piece draw
DEV void finish_phase(const Ctx& x, Game& g, const float* u) {
  bool broke = false;
  UNROLL
  for (int i = 0; i < 2; i++) {
    Player& v = g.pl[i];
    if (v.dead || broke) continue;
    int sent = hd_finish(x, v, u[i]);
    if (sent == -1) {
      v.dead = true;
      broke = true;
    } else if (sent > 0) {
      distribute(g, i, sent);
    }
  }
  int alive = 0;
  UNROLL
  for (int i = 0; i < 2; i++) {
    Player& v = g.pl[i];
    if (v.dead) continue;
    int sent = delay_check(x, v, x.cfg->dt);
    if (sent == -1) {
      v.dead = true;
      continue;
    }
    int cleared = cold_get(v, K_LINES_CLEARED);
    int reward = cleared - cold_get(v, K_LINES_CLEARED_SNAP);
    int incoming = garbage_count(*x.cfg, v);
    v.cold = per_lane([&](int l) {
      return l == K_REWARD ? reward : l == K_LINES_CLEARED_SNAP ? cleared
           : l == K_INCOMING_COUNT ? incoming : v.cold[l];
    });
    if (sent > 0) distribute(g, i, sent);
    alive++;
  }
  g.round_over = alive < 2;
}

DEV void restart_round(const Cfg& c, Player& v) {
  garbage_clear(c, v);
  v.occ = v.garb = zeros<uint32_t>();
  v.combo_start = v.combo_time = v.combo_count = v.combo_line_count = 0;
  v.time_ms = 0;
  v.incoming_lines = 0.0f;
  v.dead = false;
  v.drop_delay = 1000;
  v.drop_delay_time = v.incr_dd_time = 0;
  v.lockdown = false;
  v.lockdown_time = 0;
  v.cold = per_lane([&](int l) {
    bool zero = l == K_LINES_CLEARED_SNAP || l == K_LINES_SENT ||
                l == K_LINES_RECV || l == K_GARBAGE_CLEARED ||
                l == K_LINES_CLEARED || l == K_LINES_BLOCKED ||
                l == K_MAX_COMBO;
    return zero ? 0 : v.cold[l];
  });
}

// GamePlay::seed in closed form (engine/step.py _seed_round): both players
// get the same keys, so it is computed once.  The candidate draws
// i = 0 .. R all come from the fresh bag, so lane l draws candidate
// base + l and a ballot finds the first acceptable one.
struct Seed {
  float cogp[7];
  int piece, nextpiece, piece_draws;
};

DEV void seed_round(const Ctx& x, const uint32_t* pk, Seed* s) {
  const Cfg& c = *x.cfg;
  const float fresh = (float)(1000 / 7);
  float bag[7];
  UNROLL
  for (int i = 0; i < 7; i++) bag[i] = fresh;
  int k = c.R, cand = 0;
  for (int base = 0; base <= c.R; base += WARP) {
    V<int> cands = per_lane([&](int l) {
      return choose_from_bag(bag, draw_uniform(pk, base + l));
    });
    uint32_t ok = ballot(per_lane([&](int l) {
      int p = pmap(c, cands[l]);
      return base + l <= c.R && (c.only_zs || (p != 2 && p != 3));
    }));
    if (ok) {
      k = base + low_bit(ok);
      cand = bcast(cands, k - base);
      break;
    }
    if (c.R - base < WARP) cand = bcast(cands, c.R - base);
  }
  s->piece = pmap(c, cand);
  bag_update(bag, cand);
  int cand_next = choose_from_bag(bag, draw_uniform(pk, k + 1));
  bag_update(bag, cand_next);
  UNROLL
  for (int i = 0; i < 7; i++) s->cogp[i] = bag[i];
  s->piece_draws = k + 2;
  s->nextpiece = pmap(c, cand_next);
}

// PythonHandle::reset: record the winner, restart and reseed both players
DEV void reset_game(const Ctx& x, Game& g, const uint32_t* key) {
  int alive = 0, winner = -1;
  UNROLL
  for (int i = 0; i < 2; i++)
    if (!g.pl[i].dead) { alive++; winner = i; }
  if (alive > 1) winner = -1;
  uint32_t pk[2], hk[2];
  fold_in_01(key, pk, hk);
  Seed s;
  seed_round(x, pk, &s);
  UNROLL
  for (int i = 0; i < 2; i++) {
    Player& v = g.pl[i];
    restart_round(*x.cfg, v);
    v.piece_key[0] = pk[0]; v.piece_key[1] = pk[1];
    v.cold = per_lane([&](int l) {
      return l == K_HOLE_KEY0 ? (int)hk[0] : l == K_HOLE_KEY1 ? (int)hk[1]
           : l == K_HOLE_DRAWS ? 0 : l == K_LASTHOLE ? 20 : v.cold[l];
    });
    UNROLL
    for (int j = 0; j < 7; j++) v.cogp[j] = s.cogp[j];
    v.piece_draws = s.piece_draws;
    copy_piece(x, v, s.piece);
    v.nextpiece = s.nextpiece;
  }
  g.round_over = false;
  g.last_winner = winner;
}

// The threefry work of a tick that its start state fixes, one chain per
// lane: lanes 0 and 1 split the env key (split2), lanes 2 and 3 draw the
// first new piece of players 0 and 1 (uniform01(fold_in(piece_key,
// piece_draws)), two chained calls), lane 4 the bits of an in-kernel
// action (random_bits(akey) at aidx).
struct Draws {
  uint32_t next[2], rk[2];
  float u[2];
  uint32_t bits;
};

DEV void tick_draws(const Game& g, const uint32_t* akey, uint32_t aidx,
                    Draws* d) {
  const Player &p0 = g.pl[0], &p1 = g.pl[1];
  V<u64> w = per_lane([&](int l) -> u64 {
    bool piece = l == 2 || l == 3;
    uint32_t k0 = l == 2 ? p0.piece_key[0] : l == 3 ? p1.piece_key[0]
                : l == 4 ? akey[0] : g.key[0];
    uint32_t k1 = l == 2 ? p0.piece_key[1] : l == 3 ? p1.piece_key[1]
                : l == 4 ? akey[1] : g.key[1];
    uint32_t ctr = l == 2 ? (uint32_t)p0.piece_draws
                 : l == 3 ? (uint32_t)p1.piece_draws
                 : l == 4 ? aidx : (uint32_t)(l & 1);
    uint32_t o0, o1, b0, b1;
    threefry2x32(k0, k1, 0u, ctr, &o0, &o1);
    threefry2x32(o0, o1, 0u, 0u, &b0, &b1);      // random_bits at index 0
    if (piece) return (u64)(b0 ^ b1);
    if (l == 4) return (u64)(o0 ^ o1);
    return (u64)o0 | ((u64)o1 << 32);
  });
  u64 w0 = bcast(w, 0), w1 = bcast(w, 1);
  d->next[0] = (uint32_t)w0; d->next[1] = (uint32_t)(w0 >> 32);
  d->rk[0] = (uint32_t)w1; d->rk[1] = (uint32_t)(w1 >> 32);
  d->u[0] = bits_to_uniform((uint32_t)bcast(w, 2));
  d->u[1] = bits_to_uniform((uint32_t)bcast(w, 3));
  d->bits = (uint32_t)bcast(w, 4);
}

// One env tick (env/env.py step): the acting player's macro, the finish
// phase, reward/done before the reset, key split, auto-reset, flip; dr:
// the tick's draws (tick_draws).
DEV void env_tick(const Ctx& x, Game& g, const Draws& dr, int r, int t,
                  float* reward, bool* done) {
  const Cfg& c = *x.cfg;
  int me = g.current_player;
  if (!g.round_over) {
    UNROLL
    for (int i = 0; i < 2; i++)
      if (!g.pl[i].dead && i == me) apply_macro(x, g.pl[i], r, t);
    finish_phase(x, g, dr.u);
  }
  bool d = g.round_over;
  bool me_dead = (me & 1) ? g.pl[1].dead : g.pl[0].dead;
  bool you_dead = (me & 1) ? g.pl[0].dead : g.pl[1].dead;
  int my_combo = (me & 1) ? g.pl[1].combo_count : g.pl[0].combo_count;
  int base = (me_dead && you_dead) ? -1 : (int)you_dead - (int)me_dead;
  if (!d) base = 0;
  float rew = (float)base;
  if (c.extra_rewards)
    rew = F_ADD(F_MUL(c.wbase, rew), F_MUL(c.wcombo, (float)my_combo));
  if (d) reset_game(x, g, dr.rk);
  g.current_player = 1 - me;
  g.key[0] = dr.next[0];
  g.key[1] = dr.next[1];
  g.rounds_played += d ? 1 : 0;
  *reward = rew;
  *done = d;
}

// ---------------------------------------------------------------------------
// State I/O: leaf layout (N, P, ...) / (N, ...), game batch first.  Lane y
// moves row y and slots y, y + 32; scalars are read by every lane from one
// address and written by lane 0.
// ---------------------------------------------------------------------------

template <typename T>
DEV T* leaf(const Ptrs& p, int l) { return (T*)p.p[l]; }

// both players' words of an (N, 2) 32-bit leaf, in one 8-byte load
DEV void load_pair(const Ptrs& p, int l, int n, int32_t* a, int32_t* b) {
#ifdef __CUDACC__
  u64 w = leaf<const u64>(p, l)[n];
#else
  u64 w;
  memcpy(&w, leaf<const int32_t>(p, l) + 2 * n, 8);
#endif
  *a = (int32_t)(uint32_t)w;
  *b = (int32_t)(uint32_t)(w >> 32);
}
DEV void store_pair(const Ptrs& p, int l, int n, int32_t a, int32_t b) {
  u64 w = (u64)(uint32_t)a | ((u64)(uint32_t)b << 32);
#ifdef __CUDACC__
  leaf<u64>(p, l)[n] = w;
#else
  memcpy(leaf<int32_t>(p, l) + 2 * n, &w, 8);
#endif
}

#define LD_I(L, field) load_pair(p, L, n, &g.pl[0].field, &g.pl[1].field);
#define ST_I(L, field) store_pair(p, L, n, g.pl[0].field, g.pl[1].field);

// the word of cold field k of player slot pn (= n * 2 + player)
DEV int32_t* cold_word(const Ptrs& p, int k, int pn) {
  int32_t* w = leaf<int32_t>(p, L_COMBO_REMAINING) + pn;
  UNROLL
  for (int j = K_INCOMING_COUNT; j <= K_REWARD; j++)       // leaves 24..32
    w = k == j ? leaf<int32_t>(p, L_INCOMING_COUNT + j - K_INCOMING_COUNT) + pn : w;
  w = k == K_LASTHOLE ? leaf<int32_t>(p, L_LASTHOLE) + pn : w;
  w = k == K_HOLE_DRAWS ? leaf<int32_t>(p, L_HOLE_DRAWS) + pn : w;
  w = k == K_HOLE_KEY0 ? leaf<int32_t>(p, L_HOLE_KEY) + pn * 2 : w;
  w = k == K_HOLE_KEY1 ? leaf<int32_t>(p, L_HOLE_KEY) + pn * 2 + 1 : w;
  return w;
}

DEV V<uint32_t> load_rows(const uint32_t* src, int h) {
  return per_lane([&](int l) { return l < h ? src[l] : 0u; });
}
DEV Slots load_slots(const int32_t* src, int cap) {
  return {per_lane([&](int l) { return l < cap ? src[l] : 0; }),
          per_lane([&](int l) { return l + WARP < cap ? src[l + WARP] : 0; })};
}

DEV void load_game(const Cfg& c, const Ptrs& p, int n, Game& g) {
  UNROLL
  for (int i = 0; i < 2; i++) {
    Player& v = g.pl[i];
    int pn = n * 2 + i;
    v.occ = load_rows(leaf<const uint32_t>(p, L_OCC) + pn * c.H, c.H);
    v.garb = load_rows(leaf<const uint32_t>(p, L_GARB) + pn * c.H, c.H);
    v.g_count = load_slots(leaf<const int32_t>(p, L_G_COUNT) + pn * c.CAP, c.CAP);
    v.g_delay = load_slots(leaf<const int32_t>(p, L_G_DELAY) + pn * c.CAP, c.CAP);
    const uint32_t* cr = leaf<const uint32_t>(p, L_CUR_ROWS) + pn * 4;
    UNROLL
    for (int k = 0; k < 4; k++) v.cur_rows[k] = cr[k];
    const float* cg = leaf<const float>(p, L_COGP) + pn * 7;
    UNROLL
    for (int k = 0; k < 7; k++) v.cogp[k] = cg[k];
    const uint32_t* pk = leaf<const uint32_t>(p, L_PIECE_KEY) + pn * 2;
    v.piece_key[0] = pk[0]; v.piece_key[1] = pk[1];
    v.cold = per_lane([&](int l) { return l < N_COLD ? *cold_word(p, l, pn) : 0; });
    v.lockdown = leaf<const uint8_t>(p, L_LOCKDOWN)[pn] != 0;
    v.dead = leaf<const uint8_t>(p, L_DEAD)[pn] != 0;
  }
  int32_t il[2];
  load_pair(p, L_INCOMING_LINES, n, &il[0], &il[1]);
  g.pl[0].incoming_lines = bits_to_float((uint32_t)il[0]);
  g.pl[1].incoming_lines = bits_to_float((uint32_t)il[1]);
  LD_I(L_PIECE, piece) LD_I(L_ROT, rot) LD_I(L_PX, px) LD_I(L_PY, py)
  LD_I(L_NEXTPIECE, nextpiece) LD_I(L_TIME_MS, time_ms)
  LD_I(L_DROP_DELAY, drop_delay) LD_I(L_DROP_DELAY_TIME, drop_delay_time)
  LD_I(L_INCR_DD_TIME, incr_dd_time) LD_I(L_LOCKDOWN_TIME, lockdown_time)
  LD_I(L_COMBO_START, combo_start) LD_I(L_COMBO_TIME, combo_time)
  LD_I(L_COMBO_COUNT, combo_count) LD_I(L_COMBO_LINE_COUNT, combo_line_count)
  LD_I(L_G_SIZE, g_size) LD_I(L_G_MIN_REMAINING, g_min_remaining)
  LD_I(L_PIECE_DRAWS, piece_draws)
  g.round_over = leaf<const uint8_t>(p, L_ROUND_OVER)[n] != 0;
  g.last_winner = leaf<const int32_t>(p, L_LAST_WINNER)[n];
  g.current_player = leaf<const int32_t>(p, L_CURRENT_PLAYER)[n];
  g.key[0] = leaf<const uint32_t>(p, L_KEY)[n * 2];
  g.key[1] = leaf<const uint32_t>(p, L_KEY)[n * 2 + 1];
  g.rounds_played = leaf<const int32_t>(p, L_ROUNDS_PLAYED)[n];
}

DEV void store_game(const Cfg& c, const Ptrs& p, int n, const Game& g) {
  UNROLL
  for (int i = 0; i < 2; i++) {
    const Player& v = g.pl[i];
    int pn = n * 2 + i;
    uint32_t* occ = leaf<uint32_t>(p, L_OCC) + pn * c.H;
    uint32_t* garb = leaf<uint32_t>(p, L_GARB) + pn * c.H;
    int32_t* gc = leaf<int32_t>(p, L_G_COUNT) + pn * c.CAP;
    int32_t* gd = leaf<int32_t>(p, L_G_DELAY) + pn * c.CAP;
    for_lanes([&](int l) {
      if (l < c.H) { occ[l] = v.occ[l]; garb[l] = v.garb[l]; }
      if (l < c.CAP) { gc[l] = v.g_count.lo[l]; gd[l] = v.g_delay.lo[l]; }
      if (l + WARP < c.CAP) {
        gc[l + WARP] = v.g_count.hi[l];
        gd[l + WARP] = v.g_delay.hi[l];
      }
      if (l < N_COLD) *cold_word(p, l, pn) = v.cold[l];
    });
    if (!lead()) continue;
    uint32_t* cr = leaf<uint32_t>(p, L_CUR_ROWS) + pn * 4;
    UNROLL
    for (int k = 0; k < 4; k++) cr[k] = v.cur_rows[k];
    float* cg = leaf<float>(p, L_COGP) + pn * 7;
    UNROLL
    for (int k = 0; k < 7; k++) cg[k] = v.cogp[k];
    uint32_t* pk = leaf<uint32_t>(p, L_PIECE_KEY) + pn * 2;
    pk[0] = v.piece_key[0]; pk[1] = v.piece_key[1];
    leaf<uint8_t>(p, L_LOCKDOWN)[pn] = v.lockdown ? 1 : 0;
    leaf<uint8_t>(p, L_DEAD)[pn] = v.dead ? 1 : 0;
  }
  if (!lead()) return;
  store_pair(p, L_INCOMING_LINES, n, (int32_t)float_to_bits(g.pl[0].incoming_lines),
             (int32_t)float_to_bits(g.pl[1].incoming_lines));
  ST_I(L_PIECE, piece) ST_I(L_ROT, rot) ST_I(L_PX, px) ST_I(L_PY, py)
  ST_I(L_NEXTPIECE, nextpiece) ST_I(L_TIME_MS, time_ms)
  ST_I(L_DROP_DELAY, drop_delay) ST_I(L_DROP_DELAY_TIME, drop_delay_time)
  ST_I(L_INCR_DD_TIME, incr_dd_time) ST_I(L_LOCKDOWN_TIME, lockdown_time)
  ST_I(L_COMBO_START, combo_start) ST_I(L_COMBO_TIME, combo_time)
  ST_I(L_COMBO_COUNT, combo_count) ST_I(L_COMBO_LINE_COUNT, combo_line_count)
  ST_I(L_G_SIZE, g_size) ST_I(L_G_MIN_REMAINING, g_min_remaining)
  ST_I(L_PIECE_DRAWS, piece_draws)
  leaf<uint8_t>(p, L_ROUND_OVER)[n] = g.round_over ? 1 : 0;
  leaf<int32_t>(p, L_LAST_WINNER)[n] = g.last_winner;
  leaf<int32_t>(p, L_CURRENT_PLAYER)[n] = g.current_player;
  leaf<uint32_t>(p, L_KEY)[n * 2] = g.key[0];
  leaf<uint32_t>(p, L_KEY)[n * 2 + 1] = g.key[1];
  leaf<int32_t>(p, L_ROUNDS_PLAYED)[n] = g.rounds_played;
}

// The per-game bodies of the two entries: one warp's work on the card, one
// call per game in the host build (csrc/engine_tick_host.cpp)
DEV void step_game(const Ctx& x, const Ptrs& in, const Ptrs& out, int n,
                   const int32_t* r, const int32_t* t, float* reward,
                   uint8_t* done) {
  Game g;
  load_game(*x.cfg, in, n, g);
  Draws dr;
  tick_draws(g, g.key, 0u, &dr);
  float rew;
  bool d;
  env_tick(x, g, dr, r[n], t[n], &rew, &d);
  store_game(*x.cfg, out, n, g);
  if (lead()) {
    reward[n] = rew;
    done[n] = d ? 1 : 0;
  }
}

// Actions come 32 ticks at a time: lane l loads (or draws the block key
// of) tick t0 + l, and each tick broadcasts its own; a drawn action's bits
// come with the tick's other draws.
DEV void rollout_game(const Ctx& x, const Ptrs& in, const Ptrs& out, int n,
                      int n_ticks, const int32_t* ar, const int32_t* at,
                      int n_games, uint32_t k0, uint32_t k1,
                      int block_games) {
  Game g;
  load_game(*x.cfg, in, n, g);
  const uint32_t base[2] = {k0, k1};
  const uint32_t blk = (uint32_t)(n / block_games);
  const uint32_t idx = (uint32_t)(n % block_games);
  V<int> ra = zeros<int>(), ta = zeros<int>();
  V<u64> keys = zeros<u64>();
  for (int tick = 0; tick < n_ticks; tick++) {
    int j = tick % WARP;
    if (ar == 0 && j == 0)
      keys = per_lane([&](int l) -> u64 {
        uint32_t kt[2], kb[2];
        fold_in(base, (uint32_t)(tick + l), kt);
        fold_in(kt, blk, kb);
        return (u64)kb[0] | ((u64)kb[1] << 32);
      });
    if (ar != 0 && j == 0) {
      ra = per_lane([&](int l) {
        return tick + l < n_ticks ? ar[(tick + l) * n_games + n] : 0;
      });
      ta = per_lane([&](int l) {
        return tick + l < n_ticks ? at[(tick + l) * n_games + n] : 0;
      });
    }
    u64 kw = bcast(keys, j);
    const uint32_t tk[2] = {(uint32_t)kw, (uint32_t)(kw >> 32)};
    Draws dr;
    tick_draws(g, tk, idx, &dr);
    int r, t;
    if (ar != 0) {
      r = bcast(ra, j);
      t = bcast(ta, j);
    } else {
      r = (int)(dr.bits % 4u);
      t = (int)((dr.bits >> 16) % (uint32_t)x.cfg->W);
    }
    float rew;
    bool d;
    env_tick(x, g, dr, r, t, &rew, &d);
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

// Games (warps) per block.  A block copies the table into shared memory
// before any warp past n_games returns.
static const int kWarps = 4;

DEV const uint32_t* block_table(const uint32_t* tab, uint32_t* s_tab) {
  for (int i = threadIdx.x; i < N_TAB; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
  return s_tab;
}

__global__ void __launch_bounds__(kWarps * WARP)
step_kernel(const __grid_constant__ Cfg cfg, const __grid_constant__ Ptrs in,
            const __grid_constant__ Ptrs out, const int32_t* r,
            const int32_t* t, float* reward, uint8_t* done,
            const uint32_t* tab, int* flags, int n_games) {
  __shared__ uint32_t s_tab[N_TAB];
  Ctx x = {&cfg, block_table(tab, s_tab), flags};
  int n = blockIdx.x * kWarps + (int)(threadIdx.x / WARP);
  if (n >= n_games) return;               // the whole warp
  step_game(x, in, out, n, r, t, reward, done);
}

__global__ void __launch_bounds__(kWarps * WARP)
rollout_kernel(const __grid_constant__ Cfg cfg,
               const __grid_constant__ Ptrs in,
               const __grid_constant__ Ptrs out, int n_ticks,
               const int32_t* ar, const int32_t* at, uint32_t k0,
               uint32_t k1, int block_games, const uint32_t* tab,
               int* flags, int n_games) {
  __shared__ uint32_t s_tab[N_TAB];
  Ctx x = {&cfg, block_table(tab, s_tab), flags};
  int n = blockIdx.x * kWarps + (int)(threadIdx.x / WARP);
  if (n >= n_games) return;
  rollout_game(x, in, out, n, n_ticks, ar, at, n_games, k0, k1, block_games);
}

static void to_ptrs(const int64_t* a, Ptrs* p) {
  for (int i = 0; i < N_LEAVES; i++) p->p[i] = (void*)(intptr_t)a[i];
}

static int n_blocks(int n_games) { return (n_games + kWarps - 1) / kWarps; }

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
  step_kernel<<<n_blocks(n_games), kWarps * WARP, 0, (cudaStream_t)stream>>>(
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
  rollout_kernel<<<n_blocks(n_games), kWarps * WARP, 0, (cudaStream_t)stream>>>(
      cfg, in, out, n_ticks, ar, at, k0, k1, block_games, tab, flags, n_games);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
