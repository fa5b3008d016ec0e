// Host build of the engine tick kernel's per-game code, for checking the
// kernel's logic on a machine without a CUDA compiler.  It includes
// engine_tick.cu without __CUDACC__ (so the __global__ kernels and launch
// code drop out, the float intrinsics become plain IEEE operations and a
// warp's lane vector becomes an array of 32 values) and loops the same
// step_game / rollout_game bodies over the games, one warp's work each.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libengine_tick_host.so engine_tick_host.cpp
//
// tests/test_torch_engine.py builds it with g++ when one is installed and
// holds it bit-exact against the plain PyTorch tick.

#include "engine_tick.cu"

static void host_ptrs(const int64_t* a, Ptrs* p) {
  for (int i = 0; i < N_LEAVES; i++) p->p[i] = (void*)(intptr_t)a[i];
}

extern "C" int engine_tick_host_n_leaves() { return N_LEAVES; }

extern "C" int engine_tick_host_step(const int32_t* icfg, float wbase,
                                     float wcombo, float slope,
                                     const int64_t* in_ptrs,
                                     const int64_t* out_ptrs,
                                     const int32_t* r, const int32_t* t,
                                     float* reward, uint8_t* done,
                                     const uint32_t* tab, int* flags,
                                     int n_games) {
  Cfg cfg;
  make_cfg(icfg, wbase, wcombo, slope, &cfg);
  Ptrs in, out;
  host_ptrs(in_ptrs, &in);
  host_ptrs(out_ptrs, &out);
  Ctx x = {&cfg, tab, flags};
  for (int n = 0; n < n_games; n++)
    step_game(x, in, out, n, r, t, reward, done);
  return 0;
}

extern "C" int engine_tick_host_rollout(const int32_t* icfg, float wbase,
                                        float wcombo, float slope,
                                        const int64_t* in_ptrs,
                                        const int64_t* out_ptrs, int n_ticks,
                                        const int32_t* ar, const int32_t* at,
                                        uint32_t k0, uint32_t k1,
                                        int block_games, const uint32_t* tab,
                                        int* flags, int n_games) {
  Cfg cfg;
  make_cfg(icfg, wbase, wcombo, slope, &cfg);
  Ptrs in, out;
  host_ptrs(in_ptrs, &in);
  host_ptrs(out_ptrs, &out);
  Ctx x = {&cfg, tab, flags};
  for (int n = 0; n < n_games; n++)
    rollout_game(x, in, out, n, n_ticks, ar, at, n_games, k0, k1,
                 block_games);
  return 0;
}

// The lane primitives' host definitions, for a test against numpy.  From a
// vector v, a predicate p and a source lane per lane src (32 each), a
// shift n >= 0 and a lane k, writes out[0..133]: ballot(p), any(p),
// bcast(v, k), reduce_add(v), reduce_min(v as int32), reduce_or(v), then
// 32 words each of gather(v, src), shfl_down0(v, n), shfl_up0(v, n) and
// scan_add(v).
extern "C" void engine_tick_host_lanes(const uint32_t* v, const uint8_t* p,
                                       const int32_t* src, int n, int k,
                                       uint32_t* out) {
  V<uint32_t> vu = per_lane([&](int l) { return v[l]; });
  V<int> vi = per_lane([&](int l) { return (int)v[l]; });
  V<bool> vp = per_lane([&](int l) { return p[l] != 0; });
  V<int> vs = per_lane([&](int l) { return src[l]; });
  out[0] = ballot(vp);
  out[1] = any(vp);
  out[2] = bcast(vu, k);
  out[3] = (uint32_t)reduce_add(vi);
  out[4] = (uint32_t)reduce_min(vi);
  out[5] = reduce_or(vu);
  V<uint32_t> g = gather(vu, vs), d = shfl_down0(vu, n), u = shfl_up0(vu, n);
  V<int> sc = scan_add(vi);
  for (int l = 0; l < WARP; l++) {
    out[6 + l] = g[l];
    out[38 + l] = d[l];
    out[70 + l] = u[l];
    out[102 + l] = (uint32_t)sc[l];
  }
}
