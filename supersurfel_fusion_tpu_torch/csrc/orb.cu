// ORB keypoint detection over all pyramid levels in one launch, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's detector
// (supersurfel_fusion_tpu/ops/features.py: fast_scores, harris_response and
// the per-pixel half of _select_level_keypoints) is plain jnp. It was added
// because that per-pixel work, written as tensor ops, is some 5 400 tiny
// elementwise kernels a frame on the card (shifted copies, compares, bit
// packing, the Harris shift-chain box sums, NMS, padding and the per-cell
// argmax over 8 levels), each a few microseconds of launch-bound device time.
//
// What bounds it on this card: operations. About 250 float operations a
// pixel (the FAST-9/16 arc test at two thresholds and the FAST score, the
// Harris gradients and 7x7 box sums, NMS and the key) over the ~0.95 M
// pixels of the 8-level 640x480 pyramid: ~3.5 us at 67 TFLOP/s. The bytes
// are each level image read once (~4 MB, ~1.1 us at 3.35 TB/s) and 16 bytes
// written per detection cell. Its design keeps every intermediate in shared
// memory and registers: one thread block per detection cell of every level
// (cfg.vo.detect_cell <= 32), which
//   1. loads its cell of the level image with a 4-pixel halo (zeros outside
//      the image, the plain version's shift fill);
//   2. computes the FAST score on the cell plus a 1-pixel ring (for the 3x3
//      NMS) and the arc test at both thresholds on the cell;
//   3. with Harris ranking on, the gradients and their products on the cell
//      plus 3 pixels, the vertical box sums, then the horizontal ones and
//      the response on the cell;
//   4. forms the two keys of each cell pixel (NMS, border mask, Harris key)
//      and reduces each to its cell's largest, ties to the lower in-cell
//      index (torch.argmax over the zero-padded cell);
//   5. writes the cell's pick: in-cell index, value and rank.
//
// Bit-exact with the plain version (ops/features.py): the same float
// operations in the same order. The Harris box sums add in the order
// ((t + (s1 + s-1)) + (s2 + s-2)) + (s3 + s-3) per axis, rows first; the
// response is det - (k * tr) * tr with separate roundings; the key divides
// with IEEE division; scalar constants are the float roundings aten uses on
// the card. The library is built with --fmad=false, so nothing is
// contracted into an fma.
//
// Image borders: only pixels at least `border` (21) from the edge can reach
// a key, and everything such a pixel reads (score 1 px away, image 4 px
// away) lies inside the image, so the plain version's shift fills never
// reach a key. The kernel still matches those fills where it is cheap: the
// tile holds zeros outside the image (the FAST taps' and gradients' fill)
// and the Harris products are zero outside it (the box sums' fill), so the
// per-pixel maps that tests read equal the plain version's on every pixel
// of the image. The NMS fill (-1) is not reproduced: it only touches pixels
// next to the edge, whose keys the border mask zeroes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCell = 32;
constexpr int kMaxLevels = 16;
constexpr int kHalo = 4;  // FAST radius 3 + the NMS ring; Harris 3 + 1
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = kMaxCell + 2 * kHalo;  // image tile
constexpr int kMaxRing = kMaxCell + 2;          // FAST score region
constexpr int kMaxGrad = kMaxCell + 6;          // Harris product region
constexpr int kMaps = 6;  // corner_hi, corner_lo, score, harris, key_hi, key_lo

struct Level {
  const float* img;
  int H, W;
  int ncw;         // cells across
  int cell0;       // first cell (block) of the level
  long long map0;  // first float of the level's maps (kMaps planes of H*W)
};

struct Params {
  Level lv[kMaxLevels];
  int n_levels;
  int cell;
  int border;
  int harris;
  float th_hi, th_lo;
  long long* best_idx;
  float* best_val;
  float* rank;
  float* maps;  // null unless the caller asked for the per-pixel maps
};

// FAST-9/16: a contiguous arc of at least 9 of the 16 bits (the plain
// version's packed run-length test, on 32 unsigned bits).
__device__ __forceinline__ bool run9(uint32_t m) {
  const uint32_t ext = m | (m << 16);
  const uint32_t r2 = ext & (ext >> 1);
  const uint32_t r4 = r2 & (r2 >> 2);
  const uint32_t r8 = r4 & (r4 >> 4);
  const uint32_t r9 = r8 & (ext >> 8);
  return (r9 & 0xFFFFu) != 0;
}

// Largest key, ties to the lower index (torch.argmax's first maximum).
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    better(v, i, ov, oi);
  }
}

// One of the 3 Harris box sums along a row or column of 7 values c[0..6]
// centred on c[3]: ((t + (s1 + s-1)) + (s2 + s-2)) + (s3 + s-3).
__device__ __forceinline__ float box7(float c0, float c1, float c2, float c3,
                                      float c4, float c5, float c6) {
  float acc = __fadd_rn(c3, __fadd_rn(c4, c2));
  acc = __fadd_rn(acc, __fadd_rn(c5, c1));
  return __fadd_rn(acc, __fadd_rn(c6, c0));
}

__global__ void __launch_bounds__(kThreads)
    orb_detect_kernel(const Params p) {
  __shared__ float tile[kMaxTile * kMaxTile];
  __shared__ float score[kMaxRing * kMaxRing];
  __shared__ uint8_t corner[kMaxCell * kMaxCell];  // bit 0 hi, bit 1 lo
  __shared__ float prod[3][kMaxGrad * kMaxGrad];   // ix*ix, iy*iy, ix*iy
  __shared__ float vsum[3][kMaxCell * kMaxGrad];   // vertical box sums
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];

  const int b = blockIdx.x;
  int l = 0;
  while (l + 1 < p.n_levels && b >= p.lv[l + 1].cell0) ++l;
  const Level lv = p.lv[l];
  const int C = p.cell;
  const int c_id = b - lv.cell0;
  const int y0 = (c_id / lv.ncw) * C;  // the cell's origin in the level
  const int x0 = (c_id % lv.ncw) * C;
  const int H = lv.H, W = lv.W;
  const int tw = C + 2 * kHalo, rw = C + 2, gw = C + 6;
  const int tid = threadIdx.x;

  // 1. the cell and its halo; zeros outside the image
  for (int i = tid; i < tw * tw; i += kThreads) {
    const int r = i / tw, c = i - r * tw;
    const int y = y0 - kHalo + r, x = x0 - kHalo + c;
    tile[i] = (y >= 0 && y < H && x >= 0 && x < W)
                  ? __ldg(lv.img + (size_t)y * W + x)
                  : 0.0f;
  }
  __syncthreads();

  // 2. FAST score on the cell and its ring; the arc test on the cell
  {
    constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3,
                             -2, -1};
    constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1,
                             -2, -3};
    const float th_hi = p.th_hi, th_lo = p.th_lo;
    for (int i = tid; i < rw * rw; i += kThreads) {
      const int r = i / rw, c = i - r * rw;  // cell-relative (r-1, c-1)
      const int ty = r + kHalo - 1, tx = c + kHalo - 1;
      const float v = tile[ty * tw + tx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        d[k] = __fsub_rn(tile[(ty + kDy[k]) * tw + tx + kDx[k]], v);
      // sum(clamp(d - th_lo, min=0)) from Python's 0, in circle order
      float pos = 0.0f, neg = 0.0f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        pos = __fadd_rn(pos, fmaxf(__fsub_rn(d[k], th_lo), 0.0f));
        neg = __fadd_rn(neg, fmaxf(__fsub_rn(-d[k], th_lo), 0.0f));
      }
      score[i] = fmaxf(pos, neg);
      if (r >= 1 && r <= C && c >= 1 && c <= C) {
        uint32_t bh = 0, dh = 0, bl = 0, dl = 0;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          bh |= (uint32_t)(d[k] > th_hi) << k;
          dh |= (uint32_t)(d[k] < -th_hi) << k;
          bl |= (uint32_t)(d[k] > th_lo) << k;
          dl |= (uint32_t)(d[k] < -th_lo) << k;
        }
        const int y = y0 + r - 1, x = x0 + c - 1;
        const bool interior = x >= 3 && x < W - 3 && y >= 3 && y < H - 3;
        const bool hi = interior && (run9(bh) || run9(dh));
        const bool lo = interior && (run9(bl) || run9(dl));
        corner[(r - 1) * C + (c - 1)] = (uint8_t)(hi | (lo << 1));
      }
    }
  }

  // 3. Harris: gradient products on the cell +-3 (zero outside the image),
  // then the vertical box sums on the cell's rows
  if (p.harris) {
    for (int i = tid; i < gw * gw; i += kThreads) {
      const int r = i / gw, c = i - r * gw;  // cell-relative (r-3, c-3)
      const int y = y0 + r - 3, x = x0 + c - 3;
      const int ty = r + kHalo - 3, tx = c + kHalo - 3;
      float xx = 0.0f, yy = 0.0f, xy = 0.0f;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const float ix = __fmul_rn(
            0.5f, __fsub_rn(tile[ty * tw + tx + 1], tile[ty * tw + tx - 1]));
        const float iy = __fmul_rn(0.5f, __fsub_rn(tile[(ty + 1) * tw + tx],
                                                   tile[(ty - 1) * tw + tx]));
        xx = __fmul_rn(ix, ix);
        yy = __fmul_rn(iy, iy);
        xy = __fmul_rn(ix, iy);
      }
      prod[0][i] = xx;
      prod[1][i] = yy;
      prod[2][i] = xy;
    }
    __syncthreads();
    for (int i = tid; i < C * gw; i += kThreads) {
      const int r = i / gw, c = i - r * gw;  // product row r + 3 is the centre
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float* t = prod[q] + c;
        vsum[q][i] = box7(t[r * gw], t[(r + 1) * gw], t[(r + 2) * gw],
                          t[(r + 3) * gw], t[(r + 4) * gw], t[(r + 5) * gw],
                          t[(r + 6) * gw]);
      }
    }
  }
  __syncthreads();

  // 4. keys and each thread's best pixel of each key, in index order
  const float k_harris = static_cast<float>(0.04);
  float bv_hi = 0.0f, bv_lo = 0.0f;
  int bi_hi = 0x7fffffff, bi_lo = 0x7fffffff;
  for (int i = tid; i < C * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const int y = y0 + r, x = x0 + c;
    const float s = score[(r + 1) * rw + c + 1];
    float resp = s;
    if (p.harris) {
      const float* v0 = vsum[0] + r * gw + c;
      const float* v1 = vsum[1] + r * gw + c;
      const float* v2 = vsum[2] + r * gw + c;
      const float ixx = box7(v0[0], v0[1], v0[2], v0[3], v0[4], v0[5], v0[6]);
      const float iyy = box7(v1[0], v1[1], v1[2], v1[3], v1[4], v1[5], v1[6]);
      const float ixy = box7(v2[0], v2[1], v2[2], v2[3], v2[4], v2[5], v2[6]);
      const float det = __fsub_rn(__fmul_rn(ixx, iyy), __fmul_rn(ixy, ixy));
      const float tr = __fadd_rn(ixx, iyy);
      resp = __fsub_rn(det, __fmul_rn(__fmul_rn(k_harris, tr), tr));
    }
    bool nms = true;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx)
        if (dy != 0 || dx != 0)
          nms = nms && s >= score[(r + 1 + dy) * rw + c + 1 + dx];
    const bool in_border = x >= p.border && x < W - p.border &&
                           y >= p.border && y < H - p.border;
    const float h = fmaxf(resp, 0.0f);
    const float hkey = __fdiv_rn(__fadd_rn(h, 1.0f), __fadd_rn(h, 1e9f));
    const int fl = corner[i];
    const bool take = in_border && nms;
    const float key_hi = (take && (fl & 1)) ? hkey : 0.0f;
    const float key_lo = (take && (fl & 2)) ? hkey : 0.0f;
    if (p.maps != nullptr && y < H && x < W) {
      const size_t plane = (size_t)H * W;
      float* m = p.maps + lv.map0 + (size_t)y * W + x;
      m[0 * plane] = (fl & 1) ? 1.0f : 0.0f;
      m[1 * plane] = (fl & 2) ? 1.0f : 0.0f;
      m[2 * plane] = s;
      m[3 * plane] = resp;
      m[4 * plane] = key_hi;
      m[5 * plane] = key_lo;
    }
    better(bv_hi, bi_hi, key_hi, i);
    better(bv_lo, bi_lo, key_lo, i);
  }

  // 5. the cell's pick of each key, then the pick of the two
  warp_best(bv_hi, bi_hi);
  warp_best(bv_lo, bi_lo);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    red_v[0][warp] = bv_hi;
    red_i[0][warp] = bi_hi;
    red_v[1][warp] = bv_lo;
    red_i[1][warp] = bi_lo;
  }
  __syncthreads();
  if (tid == 0) {
    float vh = red_v[0][0], vl = red_v[1][0];
    int ih = red_i[0][0], il = red_i[1][0];
    for (int w = 1; w < kWarps; ++w) {
      better(vh, ih, red_v[0][w], red_i[0][w]);
      better(vl, il, red_v[1][w], red_i[1][w]);
    }
    const bool use_hi = vh > 0.0f;
    const float val = use_hi ? vh : vl;
    p.best_idx[b] = use_hi ? ih : il;
    p.best_val[b] = val;
    p.rank[b] = __fadd_rn(val, use_hi ? 1000.0f : 0.0f);
  }
}

}  // namespace

// Launch the detector over n_levels level images (img[l] of H[l] x W[l],
// contiguous f32) on `stream`. Outputs, one per detection cell, the levels'
// cells in order and row-major within a level: best_idx (int64, in-cell
// index of the pick), best_val (f32), rank (f32). maps (null, or kMaps
// planes of H x W f32 per level, level after level) receives the per-pixel
// corner_hi, corner_lo, score, harris, key_hi, key_lo. n_cells is the
// caller's count of cells; a mismatch is refused. Returns a cudaError_t.
extern "C" int orb_detect_launch(int n_levels, const void* const* img,
                                 const int* H, const int* W, int cell,
                                 int border, int harris, float th_hi,
                                 float th_lo, int n_cells, void* best_idx,
                                 void* best_val, void* rank, void* maps,
                                 void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || cell < 1 || cell > kMaxCell)
    return (int)cudaErrorInvalidValue;
  Params p;
  int cells = 0;
  long long map0 = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (H[l] < 1 || W[l] < 1) return (int)cudaErrorInvalidValue;
    const int nch = (H[l] + cell - 1) / cell, ncw = (W[l] + cell - 1) / cell;
    p.lv[l] = Level{static_cast<const float*>(img[l]), H[l], W[l], ncw, cells,
                    map0};
    cells += nch * ncw;
    map0 += (long long)kMaps * H[l] * W[l];
  }
  if (cells != n_cells) return (int)cudaErrorInvalidValue;
  p.n_levels = n_levels;
  p.cell = cell;
  p.border = border;
  p.harris = harris;
  p.th_hi = th_hi;
  p.th_lo = th_lo;
  p.best_idx = static_cast<long long*>(best_idx);
  p.best_val = static_cast<float*>(best_val);
  p.rank = static_cast<float*>(rank);
  p.maps = static_cast<float*>(maps);
  orb_detect_kernel<<<cells, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
