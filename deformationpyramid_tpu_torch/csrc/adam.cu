// C4 adam_step: sum of the per-block partial gradients from C3 and one
// optax-exact Adam step on the flat parameter vector, held while the
// solver's early-stop flag is set.
//
// Replaces the Adam half of the JAX package's kernel 2
// (ops/fused_iteration.py _bwd_adam_kernel, the last-grid-step update).
//
// optax.adam(lr) with b1=0.9, b2=0.999, eps=1e-8, eps_root=0:
//   m2 = b1 m + (1-b1) g,  v2 = b2 v + (1-b2) g^2,
//   upd = -lr (m2 / bc1) / (sqrt(v2 / bc2) + eps),  bc = 1 - b^t,
// where t = applied steps + 1; c1 = 1-b1 and c2 = 1-b2 come from the host,
// rounded from double as optax rounds them. `applied` and `hold` are device scalars
// (f32) read through pointers, so the host never waits for them; while
// hold > 0.5 p, m and v are left bit-identical. The port updates p, m and
// v in place (the JAX kernel wrote new arrays).
//
// What bounds it: bytes. One thread per parameter reads its n_blocks
// partials (n_blocks x P x 4 bytes: 8.7 MB for the 63 blocks of 2000
// points at P = 34,694)
// plus p, m, v, and writes p, m, v; neighbouring threads read neighbouring
// addresses, so every read is coalesced. The partials are summed in block
// order, so the result does not depend on scheduling.
#include "common.cuh"

#define ADAM_THREADS 256

__global__ void adam_step_kernel(float* __restrict__ p, float* __restrict__ m,
                                 float* __restrict__ v,
                                 const float* __restrict__ partial, int n_blocks,
                                 int count, const float* __restrict__ applied,
                                 const float* __restrict__ hold, float lr,
                                 float b1, float b2, float c1, float c2,
                                 float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count || *hold > 0.5f) return;
  float g = 0.f;
  for (int b = 0; b < n_blocks; ++b) g += partial[(size_t)b * count + i];
  const float t = *applied + 1.f;
  const float bc1 = 1.f - powf(b1, t);
  const float bc2 = 1.f - powf(b2, t);
  const float m2 = b1 * m[i] + c1 * g;
  const float v2 = b2 * v[i] + c2 * (g * g);
  const float upd = (m2 / bc1) / (sqrtf(v2 / bc2) + eps) * (-lr);
  p[i] = p[i] + upd;
  m[i] = m2;
  v[i] = v2;
}

extern "C" int dp_adam_step(void* p, void* m, void* v, const void* partial,
                            int n_blocks, int count, const void* applied,
                            const void* hold, float lr, float b1, float b2,
                            float c1, float c2, float eps, void* stream) {
  if (count > 0) {
    const int blocks = (count + ADAM_THREADS - 1) / ADAM_THREADS;
    adam_step_kernel<<<blocks, ADAM_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)p, (float*)m, (float*)v, (const float*)partial, n_blocks, count,
        (const float*)applied, (const float*)hold, lr, b1, b2, c1, c2, eps);
  }
  return (int)cudaGetLastError();
}
