// C2 level_warp_fwd and C3 level_warp_bwd: the C entry points, and the
// kernels' instantiations without the nonrigidity head (level_warp.cuh).
#include "level_warp.cuh"

extern "C" int dp_level_warp_fwd(const void* prm, const void* x, int n,
                                 int width, int depth, int motion, int fmt,
                                 int nonrigid, int gate, float freq,
                                 float scale, void* out, void* nr_out,
                                 int tile, void* stream) {
  if (!layout_supported(width, depth, motion, fmt)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  // The caller picks the tile: whole m-tiles whose shared memory fits a
  // block (ops/fused_iteration.py fwd_tile).
  const LevelLayout L = level_layout(width, depth, motion, fmt, nonrigid != 0);
  if (tile < C3_MT || tile % C3_MT != 0 ||
      sizeof(float) * c2_smem_floats(tile, width, L.hs) > C3_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (nonrigid)
    return (int)launch_level_warp_fwd_nr(prm, x, n, width, depth, motion, fmt,
                                         gate != 0, freq, scale, out, nr_out,
                                         tile, stream);
  return (int)launch_level_warp_fwd<false>(prm, x, n, width, depth, motion,
                                           fmt, false, freq, scale, out,
                                           nullptr, tile, stream);
}

extern "C" int dp_level_warp_bwd(const void* prm, const void* x, const void* g,
                                 const void* g_nr, int n, int width, int depth,
                                 int motion, int fmt, int nonrigid, int gate,
                                 float freq, float scale, void* partial,
                                 int n_rows, int tile, void* stream) {
  if (!layout_supported(width, depth, motion, fmt)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  // The caller picks the tile (whole m-tiles whose shared memory fits a
  // block: ops/fused_iteration.py bwd_tile) and sizes `partial` as
  // [n_rows, P]; each block writes one row.
  const LevelLayout L = level_layout(width, depth, motion, fmt, nonrigid != 0);
  if (tile < C3_MT || tile % C3_MT != 0 ||
      sizeof(float) * c3_smem_floats(tile, width, depth, L.hs, nonrigid != 0) >
          C3_SMEM_LIMIT ||
      n_rows != (n + tile - 1) / tile)
    return (int)cudaErrorInvalidValue;
  if (nonrigid)
    return (int)launch_level_warp_bwd_nr(prm, x, g, g_nr, n, width, depth,
                                         motion, fmt, gate != 0, freq, scale,
                                         partial, tile, stream);
  return (int)launch_level_warp_bwd<false>(prm, x, g, nullptr, n, width,
                                           depth, motion, fmt, false, freq,
                                           scale, partial, tile, stream);
}
