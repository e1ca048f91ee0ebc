// Forward-mode dual numbers for the K5 kernel (generic_ilqr.cu): a model's
// step, written once as a template over its scalar type, gives a Jacobian
// column when it runs on Dual<T> with a one-hot tangent. The step takes
// the sin and cos of its angle's value from its caller.
//
// Each operation applies the tangent rule that torch's forward-mode AD
// (torch.func.jvp in ops/generic_ilqr_soa.py) applies, with the same
// roundings: a*b -> b.t*a.v + a.t*b.v, a*s -> a.t*s for a constant s,
// sin(a) -> a.t*cos(a.v), cos(a) -> a.t*(-sin(a.v)). The plain version
// passes real zero tangents, not symbolic ones, so the kernel computes the
// zero products too: adding an exact zero changes no value.
#pragma once

#include <math.h>

namespace ilqr {

#ifndef ILQR_HD
#define ILQR_HD __host__ __device__ __forceinline__
#endif

ILQR_HD float msin(float x) { return sinf(x); }
ILQR_HD double msin(double x) { return sin(x); }
ILQR_HD float mcos(float x) { return cosf(x); }
ILQR_HD double mcos(double x) { return cos(x); }

template <typename T>
struct Dual {
  T v;  // value
  T t;  // tangent
};

template <typename T>
ILQR_HD Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.t + b.t};
}
template <typename T>
ILQR_HD Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.t - b.t};
}
template <typename T>
ILQR_HD Dual<T> operator-(Dual<T> a) {
  return {-a.v, -a.t};
}
template <typename T>
ILQR_HD Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, b.t * a.v + a.t * b.v};
}
template <typename T>
ILQR_HD Dual<T> operator*(Dual<T> a, T s) {
  return {a.v * s, a.t * s};
}
template <typename T>
ILQR_HD Dual<T> operator*(T s, Dual<T> a) {
  return {s * a.v, a.t * s};
}
// sin(a) and cos(a) given sn = sin(a's value) and cs = cos(a's value), so
// that the step's passes for the columns of one stage share one evaluation
// of the two (the same values: the functions are pure)
template <typename T>
ILQR_HD T msin(T, T sn, T) {
  return sn;
}
template <typename T>
ILQR_HD T mcos(T, T, T cs) {
  return cs;
}
template <typename T>
ILQR_HD Dual<T> msin(Dual<T> a, T sn, T cs) {
  return {sn, a.t * cs};
}
template <typename T>
ILQR_HD Dual<T> mcos(Dual<T> a, T sn, T cs) {
  return {cs, a.t * -sn};
}

}  // namespace ilqr
