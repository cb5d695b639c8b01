// The float32 -> int8/int16 link quantize of the port's host->device
// window transfer (parallel/multichannel.py _DeviceWindows, through
// native.py quantize_into).
//
// Definition, bit for bit that of native/hostdsp.cpp f32_quantize_i8/i16
// (the scalar reference the tests hold this file against): v = x * scale
// in float32; NaN -> 0; round to nearest, ties to even; clamp to +-127
// (int8, scale 254) or +-32767 (int16, scale 65534).
//
// What bounds it: the scalar loop makes three libm calls an element
// (nearbyintf, fmaxf, fminf) and does not vectorize, ~7 ns an element on
// one core, which capped a farm's feeding thread. Here the body takes 16
// elements a step with SSE2 intrinsics, x86-64's baseline, so it needs no
// compiler flag and no runtime dispatch: per 4 lanes a multiply, an
// ordered compare that zeroes the NaN lanes, a clamp by maxps/minps and
// cvtps2dq, then saturating packs to 16 or 8 bits. Clamping before
// rounding gives the same integers as rounding first, because the limits
// are integers; cvtps2dq rounds in the MXCSR mode, the one nearbyintf
// obeys. The tail, and a host without SSE2, take a scalar loop of the
// same semantics written with comparisons and no libm call.
//
// Plain C ABI for ctypes; each function returns the count of elements
// that went through the vector body (n less its tail of n mod 16, or 0
// without SSE2).

#include <cstdint>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

constexpr uint64_t kStep = 16;

// One element. Adding and taking away 1.5 * 2^23 rounds any |v| <= 2^22
// to an integer in the current rounding mode, as nearbyintf does; the
// sum is stored to a float first so that it is rounded to one.
template <typename T>
inline T quantize_one(float x, float scale, float lim) {
  float v = x * scale;
  if (!(v == v)) v = 0.0f;
  if (v < -lim) v = -lim;
  if (v > lim) v = lim;
  const float magic = 12582912.0f;
  float r = v + magic;
  r -= magic;
  return static_cast<T>(r);
}

#if defined(__SSE2__)
// Four lanes to int32, each in [-lim, lim].
inline __m128i quantize4(const float* x, __m128 scale, __m128 lo,
                         __m128 hi) {
  __m128 v = _mm_mul_ps(_mm_loadu_ps(x), scale);
  v = _mm_and_ps(v, _mm_cmpord_ps(v, v));  // NaN lanes -> +0
  v = _mm_min_ps(_mm_max_ps(v, lo), hi);
  return _mm_cvtps_epi32(v);
}
#endif

}  // namespace

extern "C" {

uint64_t wspr_quantize_i8(const float* x, uint64_t n, float scale,
                          int8_t* out) {
  uint64_t k = 0;
#if defined(__SSE2__)
  const __m128 s = _mm_set1_ps(scale);
  const __m128 lo = _mm_set1_ps(-127.0f), hi = _mm_set1_ps(127.0f);
  for (; k + kStep <= n; k += kStep) {
    const float* p = x + k;
    __m128i a = _mm_packs_epi32(quantize4(p, s, lo, hi),
                                quantize4(p + 4, s, lo, hi));
    __m128i b = _mm_packs_epi32(quantize4(p + 8, s, lo, hi),
                                quantize4(p + 12, s, lo, hi));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + k),
                     _mm_packs_epi16(a, b));
  }
#endif
  const uint64_t vector = k;
  for (; k < n; ++k) out[k] = quantize_one<int8_t>(x[k], scale, 127.0f);
  return vector;
}

uint64_t wspr_quantize_i16(const float* x, uint64_t n, float scale,
                           int16_t* out) {
  uint64_t k = 0;
#if defined(__SSE2__)
  const __m128 s = _mm_set1_ps(scale);
  const __m128 lo = _mm_set1_ps(-32767.0f), hi = _mm_set1_ps(32767.0f);
  for (; k + kStep <= n; k += kStep) {
    const float* p = x + k;
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + k),
                     _mm_packs_epi32(quantize4(p, s, lo, hi),
                                     quantize4(p + 4, s, lo, hi)));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + k + 8),
                     _mm_packs_epi32(quantize4(p + 8, s, lo, hi),
                                     quantize4(p + 12, s, lo, hi)));
  }
#endif
  const uint64_t vector = k;
  for (; k < n; ++k) out[k] = quantize_one<int16_t>(x[k], scale, 32767.0f);
  return vector;
}

}  // extern "C"
