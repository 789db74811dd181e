// Update rules shared by the collision kernels (collisions.cu: K3, K4;
// offset_walk.cu: K5, K6, K8, K9): the positivity-preserving QP relaxation
// and the frozen-coefficient phonon solve of the plain version
// (qpsim_tpu_torch/ops/collisions.py, _relaxation_update and
// _affine_growth_update), with CUDA's own expm1.
#pragma once

#include <cuda_runtime.h>

namespace qpsim {

// max(x, 0) that propagates NaN like jnp.maximum / torch.clamp
template <typename T>
__device__ __forceinline__ T relu(T x) { return x < T(0) ? T(0) : x; }

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dexpm1(float x) { return expm1f(x); }
__device__ __forceinline__ double dexpm1(double x) { return expm1(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float drsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double drsqrt(double x) { return rsqrt(x); }

// positivity-preserving exponential relaxation of dn/dt = gain − loss·n
template <typename T>
__device__ __forceinline__ T relax(T n, T gain, T loss, T dt) {
  const T floor = T(1e-14);
  const T mu = relu(loss);
  const T p_term = relu(gain + (mu - loss) * n);
  const T decay = dexp(-mu * dt);
  const T coeff = mu < floor ? dt : -dexpm1(-mu * dt) / (mu < floor ? floor : mu);
  return relu(decay * n + coeff * p_term);
}

// exact frozen-coefficient solve of y' = a + b·y, clamped non-negative
template <typename T>
__device__ __forceinline__ T affine(T y, T a, T b, T dt) {
  T x = b * dt;
  x = x < T(-80) ? T(-80) : (x > T(80) ? T(80) : x);
  const bool tiny = dabs(b) < T(1e-14);
  const T coeff = tiny ? dt : dexpm1(x) / b;
  return relu(dexp(x) * y + coeff * a);
}

// The Dynes (ρ, 1/ρ) of bin i from the pixel's Δ², in the plain version's
// order (ops/collisions.py, analytic_rho): e2 = E² − γ², zim = −2Eγ.
//   γ = 0:  r2 = E² − Δ², ρ = E·rsqrt(r2), 1/ρ = r2·rsqrt(r2)/E (0 where r2 ≤ 0)
//   γ > 0:  z = (E² − γ² − Δ²) − 2iEγ, principal root s + it,
//           ρ = max((E·s − γ·t)/|z|, 0), 1/ρ = 1/ρ where ρ > 1e-30
template <typename T>
__device__ __forceinline__ void analytic_rho(T d2, T e, T inv_e, T e2, T zim, T gamma,
                                             T& rho, T& inv) {
  const T floor = T(1e-30);
  if (gamma == T(0)) {
    const T r2 = e2 - d2;
    const T t = drsqrt(r2 > floor ? r2 : floor);
    const bool pos = r2 > T(0);
    rho = pos ? e * t : T(0);
    inv = pos ? (r2 * t) * inv_e : T(0);
  } else {
    const T zr = e2 - d2;
    const T r = dsqrt(zr * zr + zim * zim);
    const T s = dsqrt(relu(T(0.5) * (r + zr)));
    const T tq = -dsqrt(relu(T(0.5) * (r - zr)));
    rho = relu((e * s - gamma * tq) / (r > floor ? r : floor));
    inv = rho > floor ? T(1) / (rho > floor ? rho : floor) : T(0);
  }
}

}  // namespace qpsim
