// hdt_native — host-side native runtime for head_detector_tpu.
//
// The reference ships exactly one native component: the Sim3DR z-buffer
// rasterizer, a Cython/C++ extension built at pip-install time
// (reference setup.py:45-60, Sim3DR/lib/rasterize_kernel.cpp).  This file is
// its TPU-framework counterpart plus the host runtime pieces that surround
// the JAX compute path: a band-parallel z-buffer rasterizer (CPU fallback /
// host rendering without a device round trip), a parallel OBJ mesh writer
// (MeshSaver hot path, reference detection_result.py:22-35), and a threaded
// uint8 letterbox (StreamingDetector host feed, reference detector.py:43-50
// preprocessing semantics).
//
// Functional specs (re-derived, not translated):
//  * rasterize: reference Sim3DR/lib/rasterize_kernel.cpp:219-292 —
//    barycentric weights via the dot-product formula (get_point_weight,
//    :57-80), strict inside test w0,w1,w2 > 0 (:264), depth test "strictly
//    greater wins" vs a buffer initialised to -1e8 (:268), pixel bbox
//    ceil(min)..floor(max) clamped (:245-249), sequential triangle order so
//    the EARLIEST triangle wins depth ties.  The formula and the degenerate
//    guard mirror head_detector_tpu/ops/rasterize.py so the native and XLA
//    backends agree pixel-for-pixel (tests/test_native.py).
//  * write_objs: same byte format as MeshSaver ("v %.8f %.8f %.8f\n" per
//    vertex + a constant 1-based face block), OpenMP-parallel over meshes.
//  * letterbox: aspect-preserving bilinear resize (pixel-center aligned,
//    cv2.INTER_LINEAR semantics) pasted centered into a 127-filled square.
//
// Built on first use by head_detector_tpu/native/__init__.py with
//   g++ -O3 -march=native -std=c++17 -shared -fPIC -fopenmp
// and loaded via ctypes (no pybind11 in this environment).

#include <omp.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

inline float min3(float a, float b, float c) {
  return std::min(a, std::min(b, c));
}
inline float max3(float a, float b, float c) {
  return std::max(a, std::max(b, c));
}
inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// Z-buffer triangle rasterizer.
//   verts   [nv, 3] float32 (x, y, depth) in pixel coordinates
//   tris    [nf, 3] int32
//   colors  [nv, 3] float32 in [0, 1]
//   out_color [h, w, 3] float32   — caller-zeroed
//   out_hit   [h, w]    uint8     — caller-zeroed
//   zbuf      [h, w]    float32   — caller-initialised to -1e8
// Parallelism: each OpenMP thread owns a horizontal band of rows and loops
// the full triangle list in order — no cross-thread writes, and the
// sequential-order tie-break (strict '>' keeps the earliest triangle on an
// exact depth tie) is preserved inside every band.
void hdt_rasterize(const float* verts, int nv, const int* tris, int nf,
                   const float* colors, int height, int width,
                   float* out_color, uint8_t* out_hit, float* zbuf) {
  (void)nv;
#pragma omp parallel
  {
    const int nt = omp_get_num_threads();
    const int tid = omp_get_thread_num();
    const int band = (height + nt - 1) / nt;
    const int y_lo = tid * band;
    const int y_hi = std::min(height, y_lo + band);

    for (int t = 0; t < nf; ++t) {
      const int i0 = tris[t * 3 + 0];
      const int i1 = tris[t * 3 + 1];
      const int i2 = tris[t * 3 + 2];
      const float x0 = verts[i0 * 3 + 0], y0 = verts[i0 * 3 + 1],
                  z0 = verts[i0 * 3 + 2];
      const float x1 = verts[i1 * 3 + 0], y1 = verts[i1 * 3 + 1],
                  z1 = verts[i1 * 3 + 2];
      const float x2 = verts[i2 * 3 + 0], y2 = verts[i2 * 3 + 1],
                  z2 = verts[i2 * 3 + 2];

      // pixel bbox: ceil(min)..floor(max), clamped (spec :245-249)
      const int xs = std::max(0, (int)std::ceil(min3(x0, x1, x2)));
      const int xe = std::min(width - 1, (int)std::floor(max3(x0, x1, x2)));
      int ys = std::max(y_lo, (int)std::ceil(min3(y0, y1, y2)));
      int ye = std::min(y_hi - 1, (int)std::floor(max3(y0, y1, y2)));
      if (xs > xe || ys > ye) continue;

      // barycentric setup — identical formula/order to ops/rasterize.py
      // _point_weights (v0 = p2 - p0, v1 = p1 - p0; w0 = 1-u-v, w1 = v,
      // w2 = u) so both backends make the same inside/outside calls.
      const float ax = x2 - x0, ay = y2 - y0;  // v0
      const float bx = x1 - x0, by = y1 - y0;  // v1
      const float dot00 = ax * ax + ay * ay;
      const float dot01 = ax * bx + ay * by;
      const float dot11 = bx * bx + by * by;
      const float deno = dot00 * dot11 - dot01 * dot01;
      // relative degenerate guard (ops/rasterize.py:54-63): deno is the
      // squared edge cross product; threshold masks the triangles the C++
      // exact '== 0' guard masks, robustly under FMA contraction.
      if (deno <= 1e-6f * dot00 * dot11) continue;
      const float inver = 1.0f / deno;

      const float c00 = colors[i0 * 3 + 0], c01 = colors[i0 * 3 + 1],
                  c02 = colors[i0 * 3 + 2];
      const float c10 = colors[i1 * 3 + 0], c11 = colors[i1 * 3 + 1],
                  c12 = colors[i1 * 3 + 2];
      const float c20 = colors[i2 * 3 + 0], c21 = colors[i2 * 3 + 1],
                  c22 = colors[i2 * 3 + 2];

      for (int py = ys; py <= ye; ++py) {
        const float cy = (float)py - y0;
        float* zrow = zbuf + (size_t)py * width;
        uint8_t* hrow = out_hit + (size_t)py * width;
        float* crow = out_color + (size_t)py * width * 3;
        for (int px = xs; px <= xe; ++px) {
          const float cx = (float)px - x0;
          const float dot02 = ax * cx + ay * cy;
          const float dot12 = bx * cx + by * cy;
          const float u = (dot11 * dot02 - dot01 * dot12) * inver;
          const float v = (dot00 * dot12 - dot01 * dot02) * inver;
          const float w0 = 1.0f - u - v, w1 = v, w2 = u;
          if (!(w0 > 0.0f && w1 > 0.0f && w2 > 0.0f)) continue;
          const float depth = w0 * z0 + w1 * z1 + w2 * z2;
          if (depth > zrow[px]) {
            zrow[px] = depth;
            hrow[px] = 1;
            crow[px * 3 + 0] = w0 * c00 + w1 * c10 + w2 * c20;
            crow[px * 3 + 1] = w0 * c01 + w1 * c11 + w2 * c21;
            crow[px * 3 + 2] = w0 * c02 + w1 * c12 + w2 * c22;
          }
        }
      }
    }
  }
}

// Batch OBJ writer.  verts: [n_mesh, n_vert, 3] float64 (float64 so the
// "%.8f" rendering is byte-identical to Python's MeshSaver, which also
// formats float64).  paths: array of n_mesh C strings.  faces_block: the
// constant "f a b c\n" block (1-based), written verbatim after the vertices.
// status[m] = 0 on success, 1 on open/write failure.
void hdt_write_objs(const double* verts, int n_mesh, int n_vert,
                    const char* faces_block, long faces_len,
                    const char* const* paths, int* status) {
#pragma omp parallel for schedule(dynamic)
  for (int m = 0; m < n_mesh; ++m) {
    status[m] = 1;
    FILE* f = std::fopen(paths[m], "wb");
    if (!f) continue;
    // worst case per line: "v " + 3 floats (sign + ~17 int digits + "." + 8
    // decimals) + 2 spaces + "\n"  << 96
    const size_t cap = (size_t)n_vert * 96 + 1;
    char* buf = (char*)std::malloc(cap);
    if (!buf) {
      std::fclose(f);
      continue;
    }
    size_t off = 0;
    bool truncated = false;
    const double* v = verts + (size_t)m * n_vert * 3;
    for (int i = 0; i < n_vert; ++i) {
      // bound by REMAINING capacity and clamp the advance to bytes actually
      // written: a pathological vertex line (non-finite / >=1e24 coords)
      // must not let `off` run past the buffer on later iterations
      const size_t avail = cap - off;
      const int want = std::snprintf(buf + off, avail, "v %.8f %.8f %.8f\n",
                                     v[i * 3 + 0], v[i * 3 + 1], v[i * 3 + 2]);
      if (want < 0) { truncated = true; break; }
      if ((size_t)want >= avail) { truncated = true; off = cap - 1; break; }
      off += (size_t)want;
    }
    const bool ok = !truncated && std::fwrite(buf, 1, off, f) == off &&
                    std::fwrite(faces_block, 1, (size_t)faces_len, f) ==
                        (size_t)faces_len;
    std::free(buf);
    status[m] = (std::fclose(f) == 0 && ok) ? 0 : 1;
  }
}

// Letterbox: aspect-preserving bilinear resize of a uint8 HWC image into a
// centered region of a `size` x `size` canvas prefilled with 127
// (StreamingDetector._letterbox_host semantics; reference preprocessing
// detector.py:43-50 uses the same pad value).  Pixel-center-aligned source
// mapping sx = (dx + 0.5) * (sw / nw) - 0.5 with edge clamping — the float
// form of cv2.INTER_LINEAR (cv2 uses 11-bit fixed-point weights, so outputs
// may differ by at most 1 count; tests bound this).
// dst: [size, size, 3] uint8, fully overwritten.  Returns the resize scale.
double hdt_letterbox(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int size) {
  std::memset(dst, 127, (size_t)size * size * 3);
  const double scale =
      std::min((double)size / (double)sh, (double)size / (double)sw);
  const int nh = (int)((double)sh * scale + 0.5);
  const int nw = (int)((double)sw * scale + 0.5);
  const int top = (size - nh) / 2, left = (size - nw) / 2;
  const double ry = (double)sh / (double)nh;
  const double rx = (double)sw / (double)nw;

#pragma omp parallel for schedule(static)
  for (int dy = 0; dy < nh; ++dy) {
    const float fy = (float)((dy + 0.5) * ry - 0.5);
    const int y0 = (int)std::floor(fy);
    const float wy = fy - (float)y0;
    const int y0c = clampi(y0, 0, sh - 1);
    const int y1c = clampi(y0 + 1, 0, sh - 1);
    const uint8_t* r0 = src + (size_t)y0c * sw * 3;
    const uint8_t* r1 = src + (size_t)y1c * sw * 3;
    uint8_t* drow = dst + ((size_t)(top + dy) * size + left) * 3;
    for (int dx = 0; dx < nw; ++dx) {
      const float fx = (float)((dx + 0.5) * rx - 0.5);
      const int x0 = (int)std::floor(fx);
      const float wx = fx - (float)x0;
      const int x0c = clampi(x0, 0, sw - 1);
      const int x1c = clampi(x0 + 1, 0, sw - 1);
      for (int c = 0; c < 3; ++c) {
        const float v00 = (float)r0[x0c * 3 + c];
        const float v01 = (float)r0[x1c * 3 + c];
        const float v10 = (float)r1[x0c * 3 + c];
        const float v11 = (float)r1[x1c * 3 + c];
        const float val = (1.0f - wy) * ((1.0f - wx) * v00 + wx * v01) +
                          wy * ((1.0f - wx) * v10 + wx * v11);
        drow[dx * 3 + c] = (uint8_t)(val + 0.5f);
      }
    }
  }
  return scale;
}

// Batch letterbox over n same-shape images (the StreamingDetector feed
// shape): parallelism inside hdt_letterbox is per-row; here it is per-image.
void hdt_letterbox_batch(const uint8_t* src, int n, int sh, int sw,
                         uint8_t* dst, int size) {
  const size_t in_stride = (size_t)sh * sw * 3;
  const size_t out_stride = (size_t)size * size * 3;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    // nested parallel regions are disabled by default -> inner loop serial
    hdt_letterbox(src + (size_t)i * in_stride, sh, sw,
                  dst + (size_t)i * out_stride, size);
  }
}

int hdt_version() { return 1; }

}  // extern "C"
