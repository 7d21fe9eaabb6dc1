// Z-buffered triangle rasterizer for Hopper (sm_90a), batched over heads: a
// z-buffer owned by the tile's block, in registers and shared memory, with two
// entry points over one tile core.
//
// Replaces the TPU kernel head_detector_tpu/ops/rasterize_pallas.py
// (_raster_kernel, launched by rasterize_zbuffer_pallas).  Same contract as
// that kernel and as the plain torch versions in ops/rasterize.py:
//   * barycentric weights by the get_point_weight formula, with the relative
//     degenerate guard deno <= 1e-6 * dot00 * dot11 (such a triangle covers
//     nothing);
//   * pixel bbox ceil(min)..floor(max) clamped to the canvas, strict w > 0;
//   * a pixel is hit when some depth exceeds -1e8; the winner is the
//     lexicographic max of (depth, -triangle index), so on a depth tie the
//     lowest index wins, as in the sequential C++ loop;
//   * color = w0*c0 + w1*c1 + w2*c2 of the winner; reverse flips rows.
//
// Bound.  The function reads the meshes (N*V*12 B + F*12 B + V*12 B) and
// writes 13 B per pixel per head (hdt_rasterize_zbuffer) or 3 B per pixel of
// one canvas (hdt_pncc_render).  Arithmetic is ~40 float operations per
// (triangle, pixel) test, far below the card's float32 rate, so the least
// time is set by bytes, and for the PNCC entry by launch latency.  What the
// card really waits for is latency: a head is a few dozen pixels wide and its
// triangles one or two, so a few dozen tiles of thousands hold all the work,
// each alone on its SM with nothing to hide a load behind, and the kernel
// lasts as long as the densest tile's chain of dependent loads.  The design
// keeps that chain short.  No single PyTorch call computes this function.
//
// Design.  The TPU kernel gives each pixel tile to one grid step and keeps
// the tile's depth and color in VMEM across triangle chunks.  Here:
//   setup_kernel   one thread per (head, triangle): gathers the corners, runs
//                  setup_triangle once and writes a 64-byte record (the ten
//                  setup terms, the three depths, the triangle index and the
//                  clamped pixel box as four int16; an empty box for a
//                  degenerate or off-canvas triangle), the box again in an
//                  array of its own for scanning, and one box per block of
//                  256 triangles, whose union is the head's box (every tile
//                  block reduces those few boxes itself: no atomics, nothing
//                  to clear).
//   tile core      one block owns a tile of kTileW x kTileH pixels, one thread
//                  per pixel, the pixel's best (depth, triangle, weights) in
//                  registers.  A tile outside the head's box does nothing.
//                  Otherwise the block streams the head's boxes (8 B each,
//                  coalesced, kScanBatch loads a thread in flight at once) and
//                  every warp compacts the indices of those that reach the
//                  tile into a list of its own in shared memory with warp
//                  ballots (no atomics, one barrier a step).  The lists are
//                  rastered in rounds of kChunk, one thread per triangle: on
//                  at most kSmallPixels pixels of the tile (nearly all
//                  triangles at PNCC sizes) it is tested by that one thread,
//                  which leaves a 64-bit (depth, -index) key at the pixels it
//                  covers with a maximum in shared memory; a larger one has
//                  its record staged in shared memory, and every warp tests
//                  its own pixels against the staged triangles that reach
//                  its rows (all lanes read one record: a broadcast).  At the
//                  end each pixel takes the better of its register and its
//                  key.  The winner rule d > best || (d == best && f <
//                  best_f), which is the key's order, does not depend on the
//                  order triangles arrive in, so the lists are not sorted.
//                  No pixel belongs to two blocks: there are no atomics on
//                  pixels in device memory, no key buffer, no memset and no
//                  second pass over the canvas.
//   raster_zbuffer_kernel  grid (tile, head): the core, then the winner's
//                  color, staged in shared memory and stored row by row with
//                  16-byte stores where the canvas allows.
//   pncc_render_kernel     grid (tile): the core for head 0, 1, ... in turn
//                  and a running uint8 RGB per pixel in registers: at a hit
//                  pixel c8 = (uint8) (255.0f * color) (the float32 product
//                  and truncating cast of the host composite with alpha = 1),
//                  which replaces the running value unless c8 sums to 0.
//                  One [H, W, 3] uint8 canvas leaves the card.
// The list scan reads every box of a head once per tile inside the head's
// box (tiles x F x 8 B from L2); binning triangles to tiles beforehand would
// take more launches than it saves at these sizes.  Every multiply and add is an explicit
// round-to-nearest intrinsic (and the file is built with --fmad=false), so no
// FMA contraction moves an edge pixel away from the plain version's unfused
// float32 arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegDepth = -1e8f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kRowsPerWarp = 32 / kTileW;
constexpr int kScanBatch = 4;     // boxes a thread lists between two barriers
constexpr int kScanStep = kThreads * kScanBatch;
constexpr int kWarpCap = 2 * 32 * kScanBatch;  // triangles a warp lists before the tile
                                               // rasters them: a scan step's worth twice
constexpr int kChunk = 512;        // listed triangles rastered in one round
constexpr int kSmallPixels = 16;   // a triangle on so few of the tile's pixels is one
                                   // thread's work
constexpr int kRecVec = 4;           // float4 per triangle record
constexpr int kNoTriangle = 0x7fffffff;
constexpr int kBoxEmptyLo = 32767;   // an empty box is (lo, hi) = (32767, -1)
constexpr int kBoxEmptyHi = -1;
constexpr unsigned kFullMask = 0xffffffffu;

static_assert(kTileW * kTileH == kThreads, "one thread per pixel of the tile");
static_assert(kTileW <= 32 && 32 % kTileW == 0 && kTileW % 4 == 0,
              "a warp owns whole rows, and a row is a whole number of 16-byte stores");

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

// A pixel box as two words: x = lo | hi << 16 for columns, y for rows.
struct Box {
  int x0, x1, y0, y1;
};

__device__ __forceinline__ int2 pack_box(const Box& b) {
  return make_int2((int)((unsigned)(b.x0 & 0xffff) | ((unsigned)b.x1 << 16)),
                   (int)((unsigned)(b.y0 & 0xffff) | ((unsigned)b.y1 << 16)));
}

__device__ __forceinline__ Box unpack_box(int2 p) {
  Box b;
  b.x0 = (int)(short)(p.x & 0xffff);
  b.x1 = p.x >> 16;
  b.y0 = (int)(short)(p.y & 0xffff);
  b.y1 = p.y >> 16;
  return b;
}

__device__ __forceinline__ Box empty_box() {
  return Box{kBoxEmptyLo, kBoxEmptyHi, kBoxEmptyLo, kBoxEmptyHi};
}

// An empty box reaches nothing: its x0 lies right of any canvas column.
__device__ __forceinline__ bool reaches(const Box& b, int x0, int y0, int x1, int y1) {
  return b.x0 <= x1 && b.x1 >= x0 && b.y0 <= y1 && b.y1 >= y0;
}

__device__ __forceinline__ Box warp_union(Box b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    b.x0 = min(b.x0, __shfl_xor_sync(kFullMask, b.x0, off));
    b.x1 = max(b.x1, __shfl_xor_sync(kFullMask, b.x1, off));
    b.y0 = min(b.y0, __shfl_xor_sync(kFullMask, b.y0, off));
    b.y1 = max(b.y1, __shfl_xor_sync(kFullMask, b.y1, off));
  }
  return b;
}

// grid (ceil(nf / kThreads), n).  records [n, nf, 4] float4:
//   [0] p0x p0y v0x v0y   [1] v1x v1y dot00 dot01   [2] dot11 inver z0 z1
//   [3] z2, triangle index, box x word, box y word (the last three as bits)
// boxes [n, nf] int2, group_boxes [n, gridDim.x] int2.
__global__ void __launch_bounds__(kThreads)
setup_kernel(const float* __restrict__ verts, const int* __restrict__ tris, int nv, int nf,
             int h, int w, float4* __restrict__ records, int2* __restrict__ boxes,
             int2* __restrict__ group_boxes) {
  __shared__ int2 s_warp_box[kWarps];
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const int head = blockIdx.y;
  Box box = empty_box();
  if (f < nf) {
    const float* vb = verts + (size_t)head * nv * 3;
    const float* a = vb + 3 * (size_t)tris[3 * f];
    const float* b = vb + 3 * (size_t)tris[3 * f + 1];
    const float* c = vb + 3 * (size_t)tris[3 * f + 2];
    const TriSetup s = setup_triangle(a, b, c);
    if (!s.degenerate) {
      // clamp in float first: NaN or huge coordinates then fail the test below
      const float fx0 = fmaxf(ceilf(fminf(fminf(a[0], b[0]), c[0])), 0.0f);
      const float fx1 = fminf(floorf(fmaxf(fmaxf(a[0], b[0]), c[0])), (float)(w - 1));
      const float fy0 = fmaxf(ceilf(fminf(fminf(a[1], b[1]), c[1])), 0.0f);
      const float fy1 = fminf(floorf(fmaxf(fmaxf(a[1], b[1]), c[1])), (float)(h - 1));
      if (fx0 <= fx1 && fy0 <= fy1) box = Box{(int)fx0, (int)fx1, (int)fy0, (int)fy1};
    }
    const int2 packed = pack_box(box);
    const size_t t = (size_t)head * nf + f;
    float4* rec = records + t * kRecVec;
    rec[0] = make_float4(s.p0x, s.p0y, s.v0x, s.v0y);
    rec[1] = make_float4(s.v1x, s.v1y, s.dot00, s.dot01);
    rec[2] = make_float4(s.dot11, s.inver, a[2], b[2]);
    rec[3] = make_float4(c[2], __int_as_float(f), __int_as_float(packed.x),
                         __int_as_float(packed.y));
    boxes[t] = packed;
  }
  box = warp_union(box);
  if ((threadIdx.x & 31) == 0) s_warp_box[threadIdx.x >> 5] = pack_box(box);
  __syncthreads();
  if (threadIdx.x < 32) {
    box = threadIdx.x < kWarps ? unpack_box(s_warp_box[threadIdx.x]) : empty_box();
    box = warp_union(box);
    if (threadIdx.x == 0) group_boxes[(size_t)head * gridDim.x + blockIdx.x] = pack_box(box);
  }
}

// The head's box: the union of its groups' boxes, reduced by every warp alike.
__device__ __forceinline__ Box head_box(const int2* __restrict__ group_boxes, int n_groups) {
  Box box = empty_box();
  for (int i = threadIdx.x & 31; i < n_groups; i += 32) {
    const Box g = unpack_box(__ldg(group_boxes + i));
    box.x0 = min(box.x0, g.x0);
    box.x1 = max(box.x1, g.x1);
    box.y0 = min(box.y0, g.y0);
    box.y1 = max(box.y1, g.y1);
  }
  return warp_union(box);
}

struct Best {
  float d;
  int f;
  float w0, w1, w2;
};

__device__ __forceinline__ Best no_winner() {
  return Best{kNegDepth, kNoTriangle, 0.0f, 0.0f, 0.0f};
}

struct TileShared {
  int n_large;                        // large triangles staged since the kernel began
  int warp_count[kWarps];             // the length of each warp's list ...
  int ids[kWarps][kWarpCap];          // ... of indices of triangles that reach the tile
  float4 rec[kRecVec][kChunk];        // the records of a round's large triangles
  unsigned long long keys[kThreads];  // small triangles' (depth, -index) per pixel
};

__device__ __forceinline__ TriSetup setup_of(const float4& r0, const float4& r1,
                                             const float4& r2) {
  TriSetup s;
  s.p0x = r0.x;
  s.p0y = r0.y;
  s.v0x = r0.z;
  s.v0y = r0.w;
  s.v1x = r1.x;
  s.v1y = r1.y;
  s.dot00 = r1.z;
  s.dot01 = r1.w;
  s.dot11 = r2.x;
  s.inver = r2.y;
  s.degenerate = false;
  return s;
}

// The pixel against one triangle: true where it lies strictly inside and its
// depth counts, with the depth (-0 made +0) and the weights.
__device__ __forceinline__ bool covers(const TriSetup& s, float z0, float z1, float z2, int px,
                                       int py, float& d, float& w0, float& w1, float& w2) {
  point_weights(s, (float)px, (float)py, w0, w1, w2);
  if (!(w0 > 0.0f && w1 > 0.0f && w2 > 0.0f)) return false;
  d = __fadd_rn(__fadd_rn(__fmul_rn(w0, z0), __fmul_rn(w1, z1)), __fmul_rn(w2, z2));
  if (!(d > kNegDepth)) return false;
  d = __fadd_rn(d, 0.0f);
  return true;
}

__device__ __forceinline__ bool beats(float d, int f, const Best& best) {
  return d > best.d || (d == best.d && f < best.f);
}

// (depth, -index) as one integer that orders like the pair, and back.
__device__ __forceinline__ unsigned long long encode_key(float d, int f) {
  unsigned int bits = __float_as_uint(d);
  bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((unsigned long long)bits << 32) | (0xFFFFFFFFull - (unsigned long long)(unsigned)f);
}

__device__ __forceinline__ void decode_key(unsigned long long key, float& d, int& f) {
  unsigned int bits = (unsigned int)(key >> 32);
  bits = (bits & 0x80000000u) ? (bits ^ 0x80000000u) : ~bits;
  d = __uint_as_float(bits);
  f = (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}

// The j-th listed triangle, the warps' lists taken one after the other:
// start[k] is where warp k's begins.
__device__ __forceinline__ int listed(const TileShared& sh, const int (&start)[kWarps + 1],
                                      int j) {
  int warp = 0, begin = 0;
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
    if (j >= start[k]) {
      warp = k;
      begin = start[k];
    }
  }
  return sh.ids[warp][j - begin];
}

// One round: `count` listed triangles from the `first`-th, at most kChunk.
// 1. One thread per triangle reads its record and clips its box to the tile.
//    A small triangle (at most kSmallPixels pixels of the tile) is tested by
//    that thread, pixel after pixel, and leaves its key at the pixels it
//    covers: a 64-bit maximum in shared memory, inside the tile's own block.
//    A large one has its record staged in shared memory.
// 2. Every warp takes the staged triangles 32 at a time, keeps those that
//    reach its rows, and all its lanes test each against their own pixel, the
//    record read as a broadcast, the best kept in registers.
// sh.n_large is never reset: `large_done` is what earlier rounds staged.
__device__ __forceinline__ void raster_round(const float4* __restrict__ records,
                                             const int (&start)[kWarps + 1], int first,
                                             int count, int x0, int y0, int x1, int y1, int wy0,
                                             int wy1, int px, int py, TileShared& sh,
                                             int& large_done, Best& best) {
  for (int j = threadIdx.x; j < count; j += kThreads) {
    const float4* src = records + (size_t)listed(sh, start, first + j) * kRecVec;
    const float4 r0 = __ldg(src), r1 = __ldg(src + 1), r2 = __ldg(src + 2), r3 = __ldg(src + 3);
    const Box b = unpack_box(make_int2(__float_as_int(r3.z), __float_as_int(r3.w)));
    const int xs = max(b.x0, x0), xe = min(b.x1, x1), ys = max(b.y0, y0), ye = min(b.y1, y1);
    if ((xe - xs + 1) * (ye - ys + 1) <= kSmallPixels) {
      const TriSetup s = setup_of(r0, r1, r2);
      const int f = __float_as_int(r3.y);
      for (int y = ys; y <= ye; ++y) {
        for (int x = xs; x <= xe; ++x) {
          float d, w0, w1, w2;
          if (covers(s, r2.z, r2.w, r3.x, x, y, d, w0, w1, w2))
            atomicMax(&sh.keys[(y - y0) * kTileW + (x - x0)], encode_key(d, f));
        }
      }
    } else {
      const int slot = atomicAdd(&sh.n_large, 1) - large_done;
      sh.rec[0][slot] = r0;
      sh.rec[1][slot] = r1;
      sh.rec[2][slot] = r2;
      sh.rec[3][slot] = r3;
    }
  }
  __syncthreads();
  const int n_large = sh.n_large - large_done;
  large_done += n_large;
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < n_large; j0 += 32) {
    bool mine = false;
    if (j0 + lane < n_large) {
      const float4 r3 = sh.rec[3][j0 + lane];
      mine = reaches(unpack_box(make_int2(__float_as_int(r3.z), __float_as_int(r3.w))), x0, wy0,
                     x1, wy1);
    }
    unsigned m = __ballot_sync(kFullMask, mine);
    while (m != 0u) {
      const int k = j0 + __ffs(m) - 1;
      m &= m - 1u;
      const float4 r3 = sh.rec[3][k];
      const Box b = unpack_box(make_int2(__float_as_int(r3.z), __float_as_int(r3.w)));
      if (px < b.x0 || px > b.x1 || py < b.y0 || py > b.y1) continue;
      const float4 r0 = sh.rec[0][k], r1 = sh.rec[1][k], r2 = sh.rec[2][k];
      float d, w0, w1, w2;
      if (!covers(setup_of(r0, r1, r2), r2.z, r2.w, r3.x, px, py, d, w0, w1, w2)) continue;
      const int f = __float_as_int(r3.y);
      if (beats(d, f, best)) best = Best{d, f, w0, w1, w2};
    }
  }
  __syncthreads();  // the list and the staged records are free again
}

// The tile core: one head's triangles against this block's tile.  All threads
// of the block call it together; sh.keys is zero before and after, and
// `large_done` runs on through the kernel (see raster_round).
__device__ __forceinline__ void raster_head_tile(
    const float4* __restrict__ records, const int2* __restrict__ boxes, int nf, int x0, int y0,
    int x1, int y1, int px, int py, TileShared& sh, int& large_done, Best& best) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wy0 = y0 + warp * kRowsPerWarp;
  const int wy1 = min(wy0 + kRowsPerWarp - 1, y1);
  int listed_here = 0;  // the length of this warp's list, the same in all its lanes
  for (int base = 0; base < nf; base += kScanStep) {
    // kScanBatch boxes a thread, all in flight at once.  Each warp lists what
    // it finds in a list of its own (no atomics; the order is free), so a
    // step costs the block one barrier.
    int2 packed[kScanBatch];
#pragma unroll
    for (int q = 0; q < kScanBatch; ++q) {
      const int i = base + q * kThreads + threadIdx.x;
      packed[q] = i < nf ? __ldg(boxes + i) : pack_box(empty_box());
    }
#pragma unroll
    for (int q = 0; q < kScanBatch; ++q) {
      const bool mine = reaches(unpack_box(packed[q]), x0, y0, x1, y1);
      const unsigned m = __ballot_sync(kFullMask, mine);
      if (mine)
        sh.ids[warp][listed_here + __popc(m & ((1u << lane) - 1u))] =
            base + q * kThreads + threadIdx.x;
      listed_here += __popc(m);
    }
    if (lane == 0) sh.warp_count[warp] = listed_here;
    const bool last = base + kScanStep >= nf;
    if (!__syncthreads_or(last || listed_here + 32 * kScanBatch > kWarpCap)) continue;
    // some warp's list is full or the head is done: raster what is listed
    int start[kWarps + 1];
    start[0] = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) start[k + 1] = start[k] + sh.warp_count[k];
    const int count = start[kWarps];
    for (int first = 0; first < count; first += kChunk) {
      raster_round(records, start, first, min(kChunk, count - first), x0, y0, x1, y1, wy0, wy1,
                   px, py, sh, large_done, best);
    }
    if (count == 0) __syncthreads();  // the counts are free again, as after a round
    listed_here = 0;
  }
  // what the small triangles left at this pixel, against the register's best
  const unsigned long long key = sh.keys[threadIdx.x];
  if (key != 0ull) {
    sh.keys[threadIdx.x] = 0ull;
    float d;
    int f;
    decode_key(key, d, f);
    if (beats(d, f, best)) {
      const float4* rec = records + (size_t)f * kRecVec;
      const float4 r0 = __ldg(rec), r1 = __ldg(rec + 1), r2 = __ldg(rec + 2);
      best.d = d;
      best.f = f;
      point_weights(setup_of(r0, r1, r2), (float)px, (float)py, best.w0, best.w1, best.w2);
    }
  }
}

__device__ __forceinline__ void winner_color(const Best& best, const int* __restrict__ tris,
                                             const float* __restrict__ colors, float out[3]) {
  const int i0 = tris[3 * best.f], i1 = tris[3 * best.f + 1], i2 = tris[3 * best.f + 2];
  const float* c0 = colors + 3 * (size_t)i0;
  const float* c1 = colors + 3 * (size_t)i1;
  const float* c2 = colors + 3 * (size_t)i2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[k] = __fadd_rn(__fadd_rn(__fmul_rn(best.w0, c0[k]), __fmul_rn(best.w1, c1[k])),
                       __fmul_rn(best.w2, c2[k]));
  }
}

// grid (tiles x, tiles y, n).  color_out [n, h, w, 3] f32, hit_out [n, h, w].
__global__ void __launch_bounds__(kThreads)
raster_zbuffer_kernel(const float4* __restrict__ records, const int2* __restrict__ boxes,
                      const int2* __restrict__ group_boxes, const int* __restrict__ tris,
                      const float* __restrict__ colors, int nf, int n_groups, int h, int w,
                      int reverse, float* __restrict__ color_out,
                      unsigned char* __restrict__ hit_out) {
  __shared__ TileShared sh;
  __shared__ __align__(16) float s_color[kThreads * 3];
  const int head = blockIdx.z;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x1 = min(x0 + kTileW, w) - 1, y1 = min(y0 + kTileH, h) - 1;
  const int px = x0 + threadIdx.x % kTileW, py = y0 + threadIdx.x / kTileW;

  Best best = no_winner();
  const Box hb = head_box(group_boxes + (size_t)head * n_groups, n_groups);
  if (reaches(hb, x0, y0, x1, y1)) {
    if (threadIdx.x == 0) sh.n_large = 0;
    sh.keys[threadIdx.x] = 0ull;
    __syncthreads();
    int large_done = 0;
    raster_head_tile(records + (size_t)head * nf * kRecVec, boxes + (size_t)head * nf, nf, x0,
                     y0, x1, y1, px, py, sh, large_done, best);
  }

  const bool hit = best.f != kNoTriangle;
  float c[3] = {0.0f, 0.0f, 0.0f};
  if (hit) winner_color(best, tris, colors, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) s_color[threadIdx.x * 3 + k] = c[k];
  __syncthreads();

  // rows of the tile are contiguous in the output; reverse maps source row
  // y to output row h - 1 - y
  const size_t plane = (size_t)head * h;
  if (px < w && py < h) {
    const int orow = reverse ? h - 1 - py : py;
    hit_out[(plane + orow) * w + px] = hit ? 1 : 0;
  }
  if (w % 4 == 0 && x0 + kTileW <= w) {
    constexpr int kVecPerRow = kTileW * 3 / 4;
    for (int i = threadIdx.x; i < kTileH * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow, v = i % kVecPerRow;
      if (y0 + r >= h) continue;
      const int orow = reverse ? h - 1 - (y0 + r) : y0 + r;
      float* dst = color_out + ((plane + orow) * w + x0) * 3 + 4 * v;
      *reinterpret_cast<float4*>(dst) =
          *reinterpret_cast<const float4*>(s_color + r * kTileW * 3 + 4 * v);
    }
  } else {
    for (int i = threadIdx.x; i < kThreads * 3; i += kThreads) {
      const int r = i / (kTileW * 3), v = i % (kTileW * 3);
      if (y0 + r >= h || x0 + v / 3 >= w) continue;
      const int orow = reverse ? h - 1 - (y0 + r) : y0 + r;
      color_out[((plane + orow) * w + x0) * 3 + v] = s_color[i];
    }
  }
}

// grid (tiles x, tiles y).  rgb_out [h, w, 3] uint8: heads composited in order.
__global__ void __launch_bounds__(kThreads)
pncc_render_kernel(const float4* __restrict__ records, const int2* __restrict__ boxes,
                   const int2* __restrict__ group_boxes, const int* __restrict__ tris,
                   const float* __restrict__ colors, int n, int nf, int n_groups, int h, int w,
                   unsigned char* __restrict__ rgb_out) {
  __shared__ TileShared sh;
  __shared__ __align__(16) unsigned char s_rgb[kThreads * 3];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x1 = min(x0 + kTileW, w) - 1, y1 = min(y0 + kTileH, h) - 1;
  const int px = x0 + threadIdx.x % kTileW, py = y0 + threadIdx.x / kTileW;

  if (threadIdx.x == 0) sh.n_large = 0;
  sh.keys[threadIdx.x] = 0ull;
  __syncthreads();
  int large_done = 0;
  unsigned char rgb[3] = {0, 0, 0};
  for (int head = 0; head < n; ++head) {
    const Box hb = head_box(group_boxes + (size_t)head * n_groups, n_groups);
    if (!reaches(hb, x0, y0, x1, y1)) continue;
    Best best = no_winner();
    raster_head_tile(records + (size_t)head * nf * kRecVec, boxes + (size_t)head * nf, nf, x0,
                     y0, x1, y1, px, py, sh, large_done, best);
    if (best.f == kNoTriangle) continue;
    float c[3];
    winner_color(best, tris, colors, c);
    unsigned char c8[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) c8[k] = (unsigned char)(int)__fmul_rn(255.0f, c[k]);
    if ((int)c8[0] + (int)c8[1] + (int)c8[2] != 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) rgb[k] = c8[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) s_rgb[threadIdx.x * 3 + k] = rgb[k];
  __syncthreads();

  if (w % 4 == 0 && x0 + kTileW <= w) {
    constexpr int kWordsPerRow = kTileW * 3 / 4;
    for (int i = threadIdx.x; i < kTileH * kWordsPerRow; i += kThreads) {
      const int r = i / kWordsPerRow, v = i % kWordsPerRow;
      if (y0 + r >= h) continue;
      unsigned char* dst = rgb_out + ((size_t)(y0 + r) * w + x0) * 3 + 4 * v;
      *reinterpret_cast<unsigned int*>(dst) =
          *reinterpret_cast<const unsigned int*>(s_rgb + r * kTileW * 3 + 4 * v);
    }
  } else {
    for (int i = threadIdx.x; i < kThreads * 3; i += kThreads) {
      const int r = i / (kTileW * 3), v = i % (kTileW * 3);
      if (y0 + r >= h || x0 + v / 3 >= w) continue;
      rgb_out[((size_t)(y0 + r) * w + x0) * 3 + v] = s_rgb[i];
    }
  }
}

struct Scratch {
  float4* records;
  int2* boxes;
  int2* group_boxes;
  int n_groups;
};

__host__ int groups_of(int nf) { return (nf + kThreads - 1) / kThreads; }

__host__ Scratch carve(void* scratch, int n, int nf) {
  Scratch s;
  const size_t pairs = (size_t)n * nf;
  s.n_groups = groups_of(nf);
  s.records = static_cast<float4*>(scratch);
  s.boxes = reinterpret_cast<int2*>(s.records + pairs * kRecVec);
  s.group_boxes = s.boxes + pairs;
  return s;
}

__host__ cudaError_t launch_setup(const float* verts, const int* tris, const Scratch& s, int n,
                                  int nv, int nf, int h, int w, cudaStream_t st) {
  if (n == 0 || nf == 0) return cudaSuccess;
  setup_kernel<<<dim3(s.n_groups, n), kThreads, 0, st>>>(verts, tris, nv, nf, h, w, s.records,
                                                        s.boxes, s.group_boxes);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch both entry points need for n heads of nf triangles.
extern "C" long long hdt_raster_scratch_bytes(int n, int nf) {
  const long long pairs = (long long)n * nf;
  return pairs * (kRecVec * (long long)sizeof(float4) + (long long)sizeof(int2)) +
         (long long)n * groups_of(nf) * (long long)sizeof(int2);
}

// verts [n, nv, 3] f32, tris [nf, 3] i32 (all in [0, nv)), colors [nv, 3] f32,
// scratch of hdt_raster_scratch_bytes(n, nf) bytes (16-byte aligned, contents
// free), color_out [n, h, w, 3] f32, hit_out [n, h, w] bool; h, w <= 32767.
// Launches on `stream`, allocates nothing, does not synchronise, and returns
// the first cudaGetLastError() that is not cudaSuccess, else 0.
extern "C" int hdt_rasterize_zbuffer(const float* verts, const int* tris, const float* colors,
                                     void* scratch, float* color_out, unsigned char* hit_out,
                                     int n, int nv, int nf, int h, int w, int reverse,
                                     void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = carve(scratch, n, nf);
  cudaError_t err = launch_setup(verts, tris, s, n, nv, nf, h, w, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  raster_zbuffer_kernel<<<grid, kThreads, 0, st>>>(s.records, s.boxes, s.group_boxes, tris,
                                                   colors, nf, s.n_groups, h, w, reverse,
                                                   color_out, hit_out);
  return (int)cudaGetLastError();
}

// The same meshes composited in head order into rgb_out [h, w, 3] uint8 (see
// pncc_render_kernel); the other arguments as above.
extern "C" int hdt_pncc_render(const float* verts, const int* tris, const float* colors,
                               void* scratch, unsigned char* rgb_out, int n, int nv, int nf,
                               int h, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = carve(scratch, n, nf);
  cudaError_t err = launch_setup(verts, tris, s, n, nv, nf, h, w, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  pncc_render_kernel<<<grid, kThreads, 0, st>>>(s.records, s.boxes, s.group_boxes, tris,
                                                colors, n, nf, s.n_groups, h, w, rgb_out);
  return (int)cudaGetLastError();
}
