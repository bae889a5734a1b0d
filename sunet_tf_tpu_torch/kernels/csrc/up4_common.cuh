// Pieces of the conv-fused x4 head's forward (up4_conv.cu, #5): the
// half-pixel x4 stencil's phase weights and the PReLU.
//
// Everything here is static or inline, so several sources can include the
// header.
#pragma once

#include "common.cuh"

namespace sunet {

// Half-pixel x4 phase weights: output row 4h+p samples input at h +
// (2p-3)/8 -> taps (h-1, h) for p = 0, 1 and (h, h+1) for p = 2, 3.
static __constant__ float kP4[4][2] = {{0.375f, 0.625f}, {0.125f, 0.875f},
                                       {0.875f, 0.125f}, {0.625f, 0.375f}};

__device__ inline float prelu(float v, float a) { return fmaxf(v, 0.f) + a * fminf(v, 0.f); }

}  // namespace sunet
