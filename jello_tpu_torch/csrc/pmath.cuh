// Device counterparts of jello_tpu_torch/pmath.py, op by op.
//
// Built with -fmad=false and without fast math, every operation below
// rounds once, as the corresponding torch op does on the card: float
// constants are the Python doubles the torch code multiplies by, cast to
// float once (F(x)); division is IEEE `/` and sqrtf is IEEE, as torch's
// CUDA `/` between tensors and torch.sqrt are; torch.clamp, maximum and
// minimum propagate NaN, and so do the helpers here. cbrt's seed uses
// expf/logf, as torch.exp/torch.log do on the card.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define F(x) ((float)(x))

namespace pm {

constexpr double kPi = 3.141592653589793;
constexpr double kPi2 = 1.5707963267948966;  // _PI / 2.0

__device__ __forceinline__ float maxf(float a, float b) {  // torch.maximum
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minf(float a, float b) {  // torch.minimum
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float v, float lo) {  // clamp(min=)
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {  // clamp(max=)
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float sign(float a) {  // torch.sign: 0 for NaN
  return (float)((0.0f < a) - (a < 0.0f));
}

struct SinCos {
  float sinp, cosp;
  int q;
};

__device__ __forceinline__ SinCos sincos_polys(float x) {
  const float k = rintf(x * F(0.6366197723675814));
  const float r = (x - k * F(1.5707855224609375)) - k * F(1.0804334124e-05);
  SinCos o;
  o.q = ((int)k) & 3;
  const float s = r * r;
  float sp = F(-1.9515295891e-4) * s + F(8.3321608736e-3);
  sp = sp * s + F(-1.6666654611e-1);
  o.sinp = r + r * s * sp;
  float cp = F(2.443315711809948e-5) * s + F(-1.388731625493765e-3);
  cp = cp * s + F(4.166664568298827e-2);
  o.cosp = (1.0f - 0.5f * s) + s * s * cp;
  return o;
}

__device__ __forceinline__ float sin(float x) {
  const SinCos p = sincos_polys(x);
  const float v = (p.q & 1) == 0 ? p.sinp : p.cosp;
  return p.q >= 2 ? -v : v;
}

__device__ __forceinline__ float cos(float x) {
  const SinCos p = sincos_polys(x);
  const float v = (p.q & 1) == 0 ? p.cosp : -p.sinp;
  return p.q >= 2 ? -v : v;
}

__device__ __forceinline__ float atan_poly(float z) {
  const float s = z * z;
  float p = F(-0.0117212) * s + F(0.05265332);
  p = p * s + F(-0.11643287);
  p = p * s + F(0.19354346);
  p = p * s + F(-0.33262348);
  p = p * s + F(0.99997723);
  return z * p;
}

__device__ __forceinline__ float arctan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = maxf(ax, ay), mn = minf(ax, ay);
  float a = atan_poly(mn / (mx == 0.0f ? 1.0f : mx));
  a = ay > ax ? F(kPi2) - a : a;
  a = x < 0.0f ? F(kPi) - a : a;
  a = y < 0.0f ? -a : a;
  a = (y == 0.0f && x < 0.0f) ? F(kPi) : a;
  a = (y == 0.0f && x >= 0.0f) ? 0.0f : a;
  return a;
}

__device__ __forceinline__ float arcsin(float x) {
  const float xc = clamp(x, -1.0f, 1.0f);
  return arctan2(xc, sqrtf(clamp_min(1.0f - xc * xc, 0.0f)));
}

__device__ __forceinline__ float arccos(float x) { return F(kPi2) - arcsin(x); }

__device__ __forceinline__ float cbrt(float x) {
  const float ax = fabsf(x);
  const float safe = clamp_min(ax, F(1e-30));
  float c = expf(logf(safe) * F(1.0 / 3.0));
  c = c - (c - safe / (c * c)) * F(1.0 / 3.0);
  return ax == 0.0f ? 0.0f : sign(x) * c;
}

}  // namespace pm
