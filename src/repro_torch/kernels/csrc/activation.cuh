// Epilogue activations shared by the port's GCN kernels (sm_90a).
//
// The codes match `kernels/fused_layers.py:ACTIVATIONS`. ELU is expm1f for
// z <= 0, as the plain versions' `torch.where(z > 0, z, torch.expm1(z))`.
#pragma once

namespace gcn_port {

enum Activation { kActNone = 0, kActRelu = 1, kActElu = 2 };

__device__ __forceinline__ float apply_activation(float z, int act) {
  if (act == kActRelu) return z > 0.f ? z : 0.f;
  if (act == kActElu) return z > 0.f ? z : expm1f(z);
  return z;
}

}  // namespace gcn_port
