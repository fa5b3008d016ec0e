// Host build of the engine tick kernel's per-game code, for checking the
// kernel's logic on a machine without a CUDA compiler.  It includes
// engine_tick.cu without __CUDACC__ (so the __global__ kernels and launch
// code drop out and the float intrinsics become plain IEEE operations) and
// loops the same step_game / rollout_game bodies over the games.
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
