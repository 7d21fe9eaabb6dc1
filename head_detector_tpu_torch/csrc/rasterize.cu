// Z-buffered triangle rasterizer for Hopper (sm_90a), batched over heads.
//
// Replaces the TPU kernel head_detector_tpu/ops/rasterize_pallas.py
// (_raster_kernel, launched by rasterize_zbuffer_pallas).  Same contract as
// that kernel and as the plain torch version in ops/rasterize.py:
//   * barycentric weights by the get_point_weight formula, with the relative
//     degenerate guard deno <= 1e-6 * dot00 * dot11 (weights then never pass);
//   * pixel bbox ceil(min)..floor(max) clamped to the canvas, strict w > 0;
//   * a pixel is hit when some depth exceeds -1e8; the winner is the
//     lexicographic max of (depth, -triangle index), so on a depth tie the
//     lowest index wins, as in the sequential C++ loop;
//   * color = w0*c0 + w1*c1 + w2*c2 of the winner; reverse flips rows.
//
// Design.  The TPU kernel walks a (tile x triangle-chunk) grid in order and
// keeps the z-buffer in VMEM.  Here blocks run in no order, so the z-buffer
// becomes a per-pixel 64-bit key
//     (order_preserving_bits(depth) << 32) | (0xFFFFFFFF - triangle)
// reduced with atomicMax, which is order independent and deterministic:
//   pass 1: one thread per (head, triangle) walks its clamped pixel bbox and
//           atomicMax-es the key of every covered pixel;
//   pass 2: one thread per (head, pixel) decodes the winner, recomputes its
//           weights with the same device function and writes color and hit.
// Every multiply and add is an explicit round-to-nearest intrinsic (and the
// file is built with --fmad=false), so no FMA contraction moves an edge
// pixel away from the plain version's unfused float32 arithmetic.
//
// Bound.  Bytes: the function reads the meshes (N*V*12 B + F*12 B + V*12 B)
// and writes 13 B per output pixel (12 B color + 1 B hit); the key buffer
// adds 8 B zeroing + 8 B read per pixel of scratch traffic, ~29 B/pixel in
// all, ~12 MB per 640x640 head.  Arithmetic is ~40 float ops per candidate
// pixel of a triangle bbox, far below the card's float32 rate, so the kernel
// is bound by bytes.  No single PyTorch call computes this function.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegDepth = -1e8f;
constexpr int kThreads = 256;

struct TriSetup {
  float p0x, p0y;
  float v0x, v0y, v1x, v1y;
  float dot00, dot01, dot11, inver;
  bool degenerate;
};

__device__ __forceinline__ TriSetup setup_triangle(const float* a, const float* b,
                                                   const float* c) {
  TriSetup s;
  s.p0x = a[0];
  s.p0y = a[1];
  s.v0x = __fsub_rn(c[0], a[0]);
  s.v0y = __fsub_rn(c[1], a[1]);
  s.v1x = __fsub_rn(b[0], a[0]);
  s.v1y = __fsub_rn(b[1], a[1]);
  s.dot00 = __fadd_rn(__fmul_rn(s.v0x, s.v0x), __fmul_rn(s.v0y, s.v0y));
  s.dot01 = __fadd_rn(__fmul_rn(s.v0x, s.v1x), __fmul_rn(s.v0y, s.v1y));
  s.dot11 = __fadd_rn(__fmul_rn(s.v1x, s.v1x), __fmul_rn(s.v1y, s.v1y));
  const float deno = __fsub_rn(__fmul_rn(s.dot00, s.dot11), __fmul_rn(s.dot01, s.dot01));
  s.degenerate = deno <= __fmul_rn(__fmul_rn(1e-6f, s.dot00), s.dot11);
  s.inver = s.degenerate ? 0.0f : __fdiv_rn(1.0f, deno);
  return s;
}

__device__ __forceinline__ void point_weights(const TriSetup& s, float px, float py,
                                              float& w0, float& w1, float& w2) {
  const float v2x = __fsub_rn(px, s.p0x);
  const float v2y = __fsub_rn(py, s.p0y);
  const float dot02 = __fadd_rn(__fmul_rn(s.v0x, v2x), __fmul_rn(s.v0y, v2y));
  const float dot12 = __fadd_rn(__fmul_rn(s.v1x, v2x), __fmul_rn(s.v1y, v2y));
  const float u = __fmul_rn(
      __fsub_rn(__fmul_rn(s.dot11, dot02), __fmul_rn(s.dot01, dot12)), s.inver);
  const float v = __fmul_rn(
      __fsub_rn(__fmul_rn(s.dot00, dot12), __fmul_rn(s.dot01, dot02)), s.inver);
  w0 = __fsub_rn(__fsub_rn(1.0f, u), v);
  w1 = v;
  w2 = u;
}

__global__ void raster_pass1(const float* __restrict__ verts, const int* __restrict__ tris,
                             int n, int nv, int nf, int h, int w,
                             unsigned long long* __restrict__ keys) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * nf) return;
  const int head = (int)(t / nf);
  const int f = (int)(t - (long long)head * nf);

  const float* vb = verts + (size_t)head * nv * 3;
  const float* a = vb + 3 * (size_t)tris[3 * f];
  const float* b = vb + 3 * (size_t)tris[3 * f + 1];
  const float* c = vb + 3 * (size_t)tris[3 * f + 2];
  const TriSetup s = setup_triangle(a, b, c);
  if (s.degenerate) return;

  // clamp in float first: NaN or huge coordinates then fail the test below
  const float fx0 = fmaxf(ceilf(fminf(fminf(a[0], b[0]), c[0])), 0.0f);
  const float fx1 = fminf(floorf(fmaxf(fmaxf(a[0], b[0]), c[0])), (float)(w - 1));
  const float fy0 = fmaxf(ceilf(fminf(fminf(a[1], b[1]), c[1])), 0.0f);
  const float fy1 = fminf(floorf(fmaxf(fmaxf(a[1], b[1]), c[1])), (float)(h - 1));
  if (!(fx0 <= fx1) || !(fy0 <= fy1)) return;
  const int x0 = (int)fx0, x1 = (int)fx1, y0 = (int)fy0, y1 = (int)fy1;

  const unsigned long long low = 0xFFFFFFFFull - (unsigned long long)f;
  unsigned long long* kb = keys + (size_t)head * h * w;
  for (int y = y0; y <= y1; ++y) {
    for (int x = x0; x <= x1; ++x) {
      float w0, w1, w2;
      point_weights(s, (float)x, (float)y, w0, w1, w2);
      if (!(w0 > 0.0f && w1 > 0.0f && w2 > 0.0f)) continue;
      float d = __fadd_rn(__fadd_rn(__fmul_rn(w0, a[2]), __fmul_rn(w1, b[2])),
                          __fmul_rn(w2, c[2]));
      if (!(d > kNegDepth)) continue;
      d = __fadd_rn(d, 0.0f);  // -0 -> +0: equal depths get equal keys
      unsigned int bits = __float_as_uint(d);
      bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
      atomicMax(kb + (size_t)y * w + x, ((unsigned long long)bits << 32) | low);
    }
  }
}

__global__ void raster_pass2(const float* __restrict__ verts, const int* __restrict__ tris,
                             const float* __restrict__ colors,
                             const unsigned long long* __restrict__ keys,
                             int n, int nv, int h, int w, int reverse,
                             float* __restrict__ color_out,
                             unsigned char* __restrict__ hit_out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)h * w;
  if (p >= (long long)n * plane) return;
  const int head = (int)(p / plane);
  const long long rem = p - (long long)head * plane;
  const int y = (int)(rem / w);
  const int x = (int)(rem - (long long)y * w);
  const int ys = reverse ? h - 1 - y : y;  // source row of this output row

  const unsigned long long key = keys[(size_t)head * plane + (size_t)ys * w + x];
  float* out = color_out + 3 * (size_t)p;
  if (key == 0ull) {
    out[0] = 0.0f;
    out[1] = 0.0f;
    out[2] = 0.0f;
    hit_out[p] = 0;
    return;
  }
  const int f = (int)(0xFFFFFFFFull - (key & 0xFFFFFFFFull));
  const float* vb = verts + (size_t)head * nv * 3;
  const int i0 = tris[3 * f], i1 = tris[3 * f + 1], i2 = tris[3 * f + 2];
  const TriSetup s = setup_triangle(vb + 3 * (size_t)i0, vb + 3 * (size_t)i1,
                                    vb + 3 * (size_t)i2);
  float w0, w1, w2;
  point_weights(s, (float)x, (float)ys, w0, w1, w2);
  const float* c0 = colors + 3 * (size_t)i0;
  const float* c1 = colors + 3 * (size_t)i1;
  const float* c2 = colors + 3 * (size_t)i2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[k] = __fadd_rn(__fadd_rn(__fmul_rn(w0, c0[k]), __fmul_rn(w1, c1[k])),
                       __fmul_rn(w2, c2[k]));
  }
  hit_out[p] = 1;
}

}  // namespace

// verts [n, nv, 3] f32, tris [nf, 3] i32 (all in [0, nv)), colors [nv, 3] f32,
// keys [n, h, w] u64 zeroed by the caller, color_out [n, h, w, 3] f32,
// hit_out [n, h, w] bool.  Launches on `stream`, does not synchronise, and
// returns the first cudaGetLastError() that is not cudaSuccess, else 0.
extern "C" int hdt_rasterize_zbuffer(const float* verts, const int* tris,
                                     const float* colors, unsigned long long* keys,
                                     float* color_out, unsigned char* hit_out, int n,
                                     int nv, int nf, int h, int w, int reverse,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long pairs = (long long)n * nf;
  if (pairs > 0) {
    const unsigned int blocks = (unsigned int)((pairs + kThreads - 1) / kThreads);
    raster_pass1<<<blocks, kThreads, 0, st>>>(verts, tris, n, nv, nf, h, w, keys);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long pixels = (long long)n * h * w;
  if (pixels > 0) {
    const unsigned int blocks = (unsigned int)((pixels + kThreads - 1) / kThreads);
    raster_pass2<<<blocks, kThreads, 0, st>>>(verts, tris, colors, keys, n, nv, h, w,
                                              reverse, color_out, hit_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
