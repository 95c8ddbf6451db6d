// Expert activations of the MoE kernels (K11, K12) and their derivatives,
// as the reference computes them: silu(x) = x * sigmoid(x), and gelu in
// its tanh form (jax.nn.gelu's default).  act is 0 for silu, 1 for gelu.
#pragma once

#include <math.h>

namespace rt {

__device__ __forceinline__ float moe_act(float x, int act) {
  if (act == 0) return x * (1.f / (1.f + expf(-x)));
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float moe_act_grad(float x, int act) {
  if (act == 0) {
    const float s = 1.f / (1.f + expf(-x));
    return s * (1.f + x * (1.f - s));
  }
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (x + 0.044715f * x * x * x));
  return 0.5f * (1.f + t) +
         0.5f * x * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * x * x);
}

}  // namespace rt
