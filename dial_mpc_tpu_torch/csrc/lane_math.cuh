// Per-sample vector, quaternion and spatial algebra for the step kernel.
//
// vec3 = T[3]; quat = T[4] as (w, x, y, z); spatial vectors = T[6] ordered
// [angular(3); linear(3)]; rotation matrices are world_from_body, row-major
// T[9]. Every function is evaluated by one thread for its own sample.
#pragma once

#include <math.h>

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T tclip(T x, T lo, T hi) { return tmin(tmax(x, lo), hi); }

template <typename T>
__device__ __forceinline__ void v3_set(T* o, T x, T y, T z) { o[0] = x; o[1] = y; o[2] = z; }
template <typename T>
__device__ __forceinline__ void v3_copy(T* o, const T* a) { o[0] = a[0]; o[1] = a[1]; o[2] = a[2]; }
template <typename T>
__device__ __forceinline__ void v3_add(T* o, const T* a, const T* b) {
  o[0] = a[0] + b[0]; o[1] = a[1] + b[1]; o[2] = a[2] + b[2];
}
template <typename T>
__device__ __forceinline__ void v3_sub(T* o, const T* a, const T* b) {
  o[0] = a[0] - b[0]; o[1] = a[1] - b[1]; o[2] = a[2] - b[2];
}
template <typename T>
__device__ __forceinline__ void v3_scale(T* o, const T* a, T s) {
  o[0] = a[0] * s; o[1] = a[1] * s; o[2] = a[2] * s;
}
template <typename T>
__device__ __forceinline__ T v3_dot(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
template <typename T>
__device__ __forceinline__ T v6_dot(const T* a, const T* b) {
  T s = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) s = s + a[i] * b[i];
  return s;
}
// o may not alias a or b
template <typename T>
__device__ __forceinline__ void v3_cross(T* o, const T* a, const T* b) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}
// sqrt(max(a.a, 1e-15)): the norm with its floor inside the root
template <typename T>
__device__ __forceinline__ T v3_norm(const T* a) {
  return sqrt(tmax(v3_dot(a, a), T(1e-15)));
}
template <typename T>
__device__ __forceinline__ T v3_normalize(T* o, const T* a) {
  T n = v3_norm(a);
  o[0] = a[0] / n; o[1] = a[1] / n; o[2] = a[2] / n;
  return n;
}

// o may not alias u or v
template <typename T>
__device__ __forceinline__ void quat_mul(T* o, const T* u, const T* v) {
  o[0] = u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3];
  o[1] = u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2];
  o[2] = u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1];
  o[3] = u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0];
}
// rotate vec3 v by quat q (world = q * body); o may not alias v
template <typename T>
__device__ __forceinline__ void quat_rot(T* o, const T* v, const T* q) {
  T uv[3], uuv[3];
  v3_cross(uv, q + 1, v);
  v3_cross(uuv, q + 1, uv);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = v[i] + T(2) * (q[0] * uv[i] + uuv[i]);
}
template <typename T>
__device__ __forceinline__ void quat_normalize(T* o, const T* q) {
  T n = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  T d = tmax(n, T(1e-15));
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = q[i] / d;
}
// row-major 3x3 rotation
template <typename T>
__device__ __forceinline__ void quat_to_mat(T* R, const T* q) {
  T w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z); R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = 1 - 2 * (x * x + y * y);
}
template <typename T>
__device__ __forceinline__ void mat_col(T* o, const T* R, int j) {
  o[0] = R[j]; o[1] = R[3 + j]; o[2] = R[6 + j];
}

// spatial cross product of motion vectors: v x m; o may not alias v or m
template <typename T>
__device__ __forceinline__ void motion_cross(T* o, const T* v, const T* m) {
  T a[3], b[3];
  v3_cross(o, v, m);
  v3_cross(a, v, m + 3);
  v3_cross(b, v + 3, m);
  v3_add(o + 3, a, b);
}
// spatial cross product motion x* force; o may not alias v or f
template <typename T>
__device__ __forceinline__ void force_cross(T* o, const T* v, const T* f) {
  T a[3], b[3];
  v3_cross(a, v, f);
  v3_cross(b, v + 3, f + 3);
  v3_add(o, a, b);
  v3_cross(o + 3, v, f + 3);
}
// 6x6 (row-major T[36]) times 6-vector
template <typename T>
__device__ __forceinline__ void m6_vec(T* o, const T* M6, const T* v) {
#pragma unroll
  for (int i = 0; i < 6; ++i) o[i] = v6_dot(M6 + 6 * i, v);
}
