// C2 level_warp_fwd and C3 level_warp_bwd: the C entry points, and the
// kernels' instantiations without the nonrigidity head (level_warp.cuh).
#include "level_warp.cuh"

extern "C" int dp_level_warp_fwd(const void* prm, const void* x, int n,
                                 int width, int depth, int motion, int fmt,
                                 int nonrigid, int gate, float freq,
                                 float scale, void* out, void* nr_out,
                                 void* stream) {
  if (!layout_supported(width, depth, motion, fmt)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  if (nonrigid)
    return (int)launch_level_warp_fwd_nr(prm, x, n, width, depth, motion, fmt,
                                         gate != 0, freq, scale, out, nr_out,
                                         stream);
  return (int)launch_level_warp_fwd<false>(prm, x, n, width, depth, motion,
                                           fmt, false, freq, scale, out,
                                           nullptr, stream);
}

extern "C" int dp_level_warp_bwd(const void* prm, const void* x, const void* g,
                                 const void* g_nr, int n, int width, int depth,
                                 int motion, int fmt, int nonrigid, int gate,
                                 float freq, float scale, void* partial,
                                 int n_rows, void* stream) {
  if (!layout_supported(width, depth, motion, fmt)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  // The caller sizes `partial` as [n_rows, P]; each block writes one row.
  if (n_rows != (n + BWD_TP - 1) / BWD_TP) return (int)cudaErrorInvalidValue;
  if (nonrigid)
    return (int)launch_level_warp_bwd_nr(prm, x, g, g_nr, n, width, depth,
                                         motion, fmt, gate != 0, freq, scale,
                                         partial, stream);
  return (int)launch_level_warp_bwd<false>(prm, x, g, nullptr, n, width,
                                           depth, motion, fmt, false, freq,
                                           scale, partial, stream);
}
