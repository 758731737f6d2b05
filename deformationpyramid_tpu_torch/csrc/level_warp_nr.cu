// C2 level_warp_fwd and C3 level_warp_bwd with the nonrigidity head
// (level_warp.cuh, NR = true): the nonrigid solves of config/NDP.yaml with
// w_reg > 0 (JAX ops/fused_iteration.py kernels 1 and 2 with
// nonrigid=True). Its own source so that nvcc builds it beside
// level_warp.cu.
#include "level_warp.cuh"

cudaError_t launch_level_warp_fwd_nr(const void* prm, const void* x, int n,
                                     int width, int depth, int motion,
                                     int fmt, bool gate, float freq,
                                     float scale, void* out, void* nr_out,
                                     int tile, void* stream) {
  return launch_level_warp_fwd<true>(prm, x, n, width, depth, motion, fmt,
                                     gate, freq, scale, out, nr_out, tile,
                                     stream);
}

cudaError_t launch_level_warp_bwd_nr(const void* prm, const void* x,
                                     const void* g, const void* g_nr, int n,
                                     int width, int depth, int motion,
                                     int fmt, bool gate, float freq,
                                     float scale, void* partial, int tile,
                                     void* stream) {
  return launch_level_warp_bwd<true>(prm, x, g, g_nr, n, width, depth, motion,
                                     fmt, gate, freq, scale, partial, tile,
                                     stream);
}
