// TPS superpixel iteration kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `run_iterations` of
// supersurfel_fusion_tpu/ops/tps_pallas.py (pl.pallas_call at :381, body
// `_make_kernel` :109-358, wrapper `segment` :423-464). That kernel keeps the
// whole segmentation state resident in 119 MiB of VMEM and works around
// Mosaic (bf16 stat encodings, matmul pooling/upsampling, no i1 vectors).
// None of that carries over. On Hopper the state (labels, inliers, the
// (9, GH, GW) stats table, rgb and disparity: about 8 MB at 640x480) sits
// in the 50 MB L2 between launches, and an iteration is two launches from
// a host loop (ops/tps_cuda.py):
//
//   tps_iteration  K1 phase/cand_energy (:231-336) with K3 rebuild_S
//                  (:148-168) folded in as a table lookup by label, all four
//                  checkerboard phases of one iteration in one launch.
//   tps_merge      K2 merge (:170-229): per-superpixel sums and, in the RGBD
//                  pass, the disparity-plane refit.
//
// What bounds them: by bytes, both are a few microseconds from HBM at
// 640x480 (24-28 B/px read and written once). In practice they are bound by
// latency and instruction throughput: how many dependent trips through
// memory and barriers a block makes, and how many instructions a pixel
// costs. Both designs make
// one trip to memory for their inputs, vector loads of 4 pixels, and keep
// everything else in shared memory.
//
// tps_iteration (temporal blocking). A phase's decision at a pixel reads
// only the pre-phase labels of its 8-ring and the table, which is constant
// over the four phases of an iteration (the merge runs once per iteration).
// So four phases depend on labels at most 4 px away (3 in fact, as each
// pixel is decided in one phase only). A block owns a 32x32 output tile,
// loads the tile plus a 4-px halo (40x40; 4 also keeps the region's origin
// on the checkerboard's period) into shared memory once, and runs the
// phases there; phase k computes only pixels at least k px inside the
// region, where every label it reads is still valid. Labels live in shared
// memory as int16 slots into the block's table slice (the labels of the
// region's cells +-1 cell; every label lies in the 3x3 cell window of its
// pixel), so a candidate's stats and cell are a shared-memory read with no
// division. In a phase each warp lists its active pixels (boundary, not
// frozen) and evaluates their energies densely (a candidate label already
// met is skipped: it cannot win a strict <); decisions go to registers, a
// barrier, then the writes, so one label buffer does the work of the
// reference's two. Each pixel is active in one phase of the four and reads
// its own rgb/disparity (staged as one float4). After the fourth phase a
// pixel's inlier bit is the plane test of its final label (the bits of
// phases 1-3 are overwritten by phase 4 and feed no decision), so the RGBD
// pass tests every tile pixel once at write-back and the RGB pass does not
// touch the inliers.
//
// tps_merge (cell partials over a ring). A block owns a 3x4 tile of
// superpixels and reads the pixels of those cells plus a ring of one cell
// (5x6 cells), one warp per cell, 4 consecutive pixels of a row per lane: a
// superpixel's pixels all lie in its cell's 3x3 neighbourhood. A warp finds
// its pixels' relative codes (label cell minus pixel cell), keeps the codes
// of labels the block owns, and per round each lane sums its pixels of one
// code; per code present in the warp (__reduce_or_sync) a fixed
// reduce-scatter shuffle tree adds the lanes' sums into a (cell, code)
// partial of 15 sums in shared memory. Then each owned superpixel adds its
// 9 partials in code order and solves its plane. Labels are read 30/12 =
// 2.5 times (by the blocks whose ring holds them); a pixel's other inputs
// only by the lanes that sum it, about once. No global scratch, no
// atomics: deterministic. The
// integer division of a label by the grid width is a float estimate plus
// one exact correction.

// The arithmetic follows ops/tps.py (the plain version) term by term and
// the library is built with --fmad=false, so an iteration gives the plain
// version's labels and inliers bit for bit; merges differ only in
// summation order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

// --- tps_iteration tiling ---------------------------------------------------
constexpr int kTileH = 32, kTileW = 32;  // output tile
constexpr int kHalo = 4;                 // 4 phases x 1 px of 8-ring reach
constexpr int kRegH = kTileH + 2 * kHalo, kRegW = kTileW + 2 * kHalo;
constexpr int kRegPx = kRegH * kRegW;
constexpr int kIterThreads = 256;
// pixels of one phase in the region: every other row, half of the columns
constexpr int kPhasePx = (kRegH / 2) * (kRegW / 2);
constexpr int kPerThread = (kPhasePx + kIterThreads - 1) / kIterThreads;
// The region's origin is (tile origin - halo); with these multiples the
// phase parity of a pixel is the same in region and image coordinates.
static_assert(kTileW % 4 == 0 && kHalo % 4 == 0 && kTileH % 2 == 0,
              "tile and halo must keep the checkerboard parity");

constexpr short kOffImage = -1;   // slot of a pixel outside the image
constexpr short kForeign = 0x7fff;  // label outside the block's table slice
constexpr short kKeep = -2;       // decision: label unchanged

// --- tps_merge tiling -------------------------------------------------------
constexpr int kMergeTY = 3, kMergeTX = 4;  // superpixels a block owns
constexpr int kRingX = kMergeTX + 2;        // ... plus a ring of one cell
constexpr int kRingCells = (kMergeTY + 2) * kRingX;
constexpr int kMergeWarps = kRingCells;    // one warp per cell
constexpr int kMergeThreads = 32 * kMergeWarps;
static_assert(kMergeThreads <= 1024, "one warp per cell of tile and ring");
constexpr int kChunkPerLane = 4;  // consecutive pixels a lane sums per pass
                                  // (cs % 4 == 0: one row segment)
constexpr int kSlice = 32 * kChunkPerLane;  // pixels a warp sums per pass
static_assert(kChunkPerLane == 4, "one vector load per input and lane");
constexpr int kRgbSums = 6;    // n, x, y, r, g, b
// w, w*xl, w*yl, w*xl^2, w*yl^2, w*xl*yl, w*d, w*xl*d, w*yl*d
constexpr int kDispSums = 9;

struct PhaseParams {
  float lam_pos, lam_bound, lam_size, lam_disp, thresh_disp, min_size;
};

// Energy of assigning pixel (x, y) to the superpixel in `slot` (ops/tps.py
// _candidate_energy). tab is (10, stride): cx cy r g b n ta tb tc and the
// leave-one-out factor n / max(n - 1, 1e-6) of the own label.
__device__ __forceinline__ float cand_energy(const float* tab, int stride,
                                             int slot, bool own, float x,
                                             float y, float4 v, bool use_disp,
                                             const PhaseParams& p) {
  const float cx = tab[0 * stride + slot];
  const float cy = tab[1 * stride + slot];
  const float mr = tab[2 * stride + slot];
  const float mg = tab[3 * stride + slot];
  const float mb = tab[4 * stride + slot];
  const float n = tab[5 * stride + slot];
  float dx, dy, dr, dg, db, dsize;
  if (own) {
    const float s = tab[9 * stride + slot];
    dsize = n - p.min_size;
    dx = s * (x - cx);
    dy = s * (y - cy);
    dr = (v.x - mr) * s;
    dg = (v.y - mg) * s;
    db = (v.z - mb) * s;
  } else {
    dsize = (n + 1.0f) - p.min_size;
    dx = x - cx;
    dy = y - cy;
    dr = v.x - mr;
    dg = v.y - mg;
    db = v.z - mb;
  }
  float E = ((dr * dr + dg * dg) + db * db) + p.lam_pos * (dx * dx + dy * dy);
  E = E - p.lam_size * fminf(dsize, 0.0f);
  if (use_disp) {
    const float dp =
        (tab[6 * stride + slot] * x + tab[7 * stride + slot] * y) +
        tab[8 * stride + slot];
    const float e = (dp - v.w) * (dp - v.w);
    const bool good = isfinite(e) && e <= p.thresh_disp && dp > 0.0f;
    E = E + p.lam_disp * (good ? e : p.thresh_disp);
  }
  return E;
}

// a / b for 0 <= a < 2^22 and b > 0, given rb = 1.0f / b: a float
// estimate and one exact correction (no integer division).
__device__ __forceinline__ int div_pos(int a, int b, float rb) {
  int q = __float2int_rz((float)a * rb);
  const int r = a - q * b;
  if (r < 0) --q;
  else if (r >= b) ++q;
  return q;
}

// The inlier test of cand_energy: the pixel against one plane.
__device__ __forceinline__ float plane_inlier(float ta, float tb, float tc,
                                              float x, float y, float d,
                                              float thresh) {
  const float dp = (ta * x + tb * y) + tc;
  const float e = (dp - d) * (dp - d);
  return (isfinite(e) && e <= thresh && dp > 0.0f) ? 1.0f : 0.0f;
}

__device__ __forceinline__ float lane4(const float4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}
__device__ __forceinline__ int lane4(const int4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

// W % 4 == 0 and 16-byte aligned inputs (the wrapper checks): the region
// and the tile are read and written 4 pixels at a time.
template <bool USE_DISP>
__global__ void __launch_bounds__(kIterThreads)
    tps_iteration_kernel(const float* __restrict__ rgb,
                         const float* __restrict__ disp,
                         const int* __restrict__ lab_in,
                         const float* __restrict__ table,
                         int* __restrict__ lab_out,
                         float* __restrict__ inl_out, int H, int W, int cs,
                         int nslot, PhaseParams p) {
  extern __shared__ float4 smem[];
  float4* px = smem;                                  // (kRegPx) r g b d
  float* tab = reinterpret_cast<float*>(px + kRegPx);  // (10, nslot)
  int* slot_id = reinterpret_cast<int*>(tab + 10 * nslot);
  short* slot_cy = reinterpret_cast<short*>(slot_id + nslot);
  short* slot_cx = slot_cy + nslot;
  short* row_cell = slot_cx + nslot;  // (kRegH) pixel row's cell in the slice
  short* col_cell = row_cell + kRegH;
  short* lab = col_cell + kRegW;      // (kRegPx) label slot
  // a phase's active pixels, listed per warp
  __shared__ short act[kIterThreads * kPerThread];

  const int tid = threadIdx.x, lane = tid & 31, wbase = tid & ~31;
  const int GW = W / cs, GH = H / cs, G = GH * GW;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int oy = ty0 - kHalo, ox = tx0 - kHalo;
  // the table slice: the cells of the region's in-image pixels, +-1 cell
  const int cy_lo = max(0, max(oy, 0) / cs - 1);
  const int cy_hi = min(GH - 1, (min(oy + kRegH, H) - 1) / cs + 1);
  const int cx_lo = max(0, max(ox, 0) / cs - 1);
  const int cx_hi = min(GW - 1, (min(ox + kRegW, W) - 1) / cs + 1);
  const int sw = cx_hi - cx_lo + 1;
  const int ns = (cy_hi - cy_lo + 1) * sw;
  const float rgw = 1.0f / (float)GW;

  // the region's pixels, 4 at a time, every load in flight before any use
  constexpr int kGroups = kRegPx / 4, kRowGroups = kRegW / 4;
  constexpr int kLoads = (kGroups + kIterThreads - 1) / kIterThreads;
  int4 idv[kLoads];
  float4 rv[kLoads], gv[kLoads], bv[kLoads], dv[kLoads];
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int g = tid + it * kIterThreads;
    const int y = oy + g / kRowGroups, x = ox + 4 * (g % kRowGroups);
    if (g < kGroups && y >= 0 && y < H && x >= 0 && x < W) {
      const int i = y * W + x;
      idv[it] = __ldg(reinterpret_cast<const int4*>(lab_in + i));
      rv[it] = __ldg(reinterpret_cast<const float4*>(rgb + i));
      gv[it] = __ldg(reinterpret_cast<const float4*>(rgb + H * W + i));
      bv[it] = __ldg(reinterpret_cast<const float4*>(rgb + 2 * H * W + i));
      if (USE_DISP) dv[it] = __ldg(reinterpret_cast<const float4*>(disp + i));
    }
  }
  for (int s = tid; s < ns; s += kIterThreads) {
    const int sy = s / sw, sx = s - (s / sw) * sw;
    const int id = (cy_lo + sy) * GW + cx_lo + sx;
    slot_id[s] = id;
    slot_cy[s] = (short)sy;
    slot_cx[s] = (short)sx;
#pragma unroll
    for (int c = 0; c < 9; ++c) tab[c * nslot + s] = table[c * G + id];
    const float n = tab[5 * nslot + s];
    tab[9 * nslot + s] = n / fmaxf(n - 1.0f, 1e-6f);
  }
  for (int r = tid; r < kRegH; r += kIterThreads)
    row_cell[r] = (short)((oy + r >= 0 ? (oy + r) / cs : 0) - cy_lo);
  for (int r = tid; r < kRegW; r += kIterThreads)
    col_cell[r] = (short)((ox + r >= 0 ? (ox + r) / cs : 0) - cx_lo);
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int g = tid + it * kIterThreads;
    if (g >= kGroups) continue;
    const int y = oy + g / kRowGroups, x = ox + 4 * (g % kRowGroups);
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const int q0 = 4 * g;  // kRegW % 4 == 0: a group is 4 pixels of a row
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      short slot = kOffImage;
      if (in) {
        const int id = lane4(idv[it], m);
        slot = kForeign;
        if (id >= 0 && id < G) {
          const int gy = div_pos(id, GW, rgw);
          const int sy = gy - cy_lo, sx = id - gy * GW - cx_lo;
          if (sy >= 0 && sy <= cy_hi - cy_lo && sx >= 0 && sx < sw)
            slot = (short)(sy * sw + sx);
        }
        px[q0 + m] = make_float4(lane4(rv[it], m), lane4(gv[it], m),
                                 lane4(bv[it], m),
                                 USE_DISP ? lane4(dv[it], m) : 0.0f);
      }
      lab[q0 + m] = slot;
    }
  }
  __syncthreads();

  // the four phases (OFFSET_X, OFFSET_Y) = (0,0) (1,1) (0,1) (1,0). In a
  // phase each warp lists its active pixels (boundary, not frozen), then
  // evaluates their energies densely; after a barrier the changed labels
  // are written.
  for (int k = 0; k < 4; ++k) {
    const int off_x = k & 1, off_y = (k ^ (k >> 1)) & 1;
    const int margin = k + 1;
    bool active[kPerThread];
    int qs[kPerThread];
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      const int j = tid + m * kIterThreads;
      active[m] = false;
      qs[m] = 0;
      if (j >= kPhasePx) continue;
      const int row = j / (kRegW / 2), c = j % (kRegW / 2);
      const int ly = 2 * row + off_y;
      const int lx = 4 * (c >> 1) + (off_x ? 1 + (c & 1) : 3 * (c & 1));
      const int q = ly * kRegW + lx;
      qs[m] = q;
      const short own = lab[q];
      if (ly < margin || ly >= kRegH - margin || lx < margin ||
          lx >= kRegW - margin || own == kOffImage || own == kForeign)
        continue;
      // boundary: a 4-neighbour (up, left, right, down) differs
      if (lab[q - kRegW] == own && lab[q - 1] == own && lab[q + 1] == own &&
          lab[q + kRegW] == own)
        continue;
      // open 8-ring connectivity guard (ops/tps.py unchangeable)
      const short ring[8] = {lab[q - kRegW - 1], lab[q - kRegW],
                             lab[q - kRegW + 1], lab[q + 1],
                             lab[q + kRegW + 1], lab[q + kRegW],
                             lab[q + kRegW - 1], lab[q - 1]};
      int jumps = 0;
#pragma unroll
      for (int t = 1; t < 8; ++t)
        jumps += ((ring[t] == own) != (ring[t - 1] == own));
      active[m] = jumps <= 2;
    }
    int n = 0;  // this warp's active pixels
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      const uint32_t mask = __ballot_sync(0xffffffffu, active[m]);
      if (active[m])
        act[wbase * kPerThread + n + __popc(mask & ((1u << lane) - 1))] =
            (short)qs[m];
      n += __popc(mask);
    }
    __syncwarp();

    short res[kPerThread];
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      res[m] = kKeep;
      const int e = lane + 32 * m;
      if (e >= n) continue;
      const int q = act[wbase * kPerThread + e];
      const int ly = q / kRegW, lx = q % kRegW;
      const short own = lab[q];
      const short nb[4] = {lab[q - kRegW], lab[q - 1], lab[q + 1],
                           lab[q + kRegW]};
      int bounds = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) bounds += (nb[t] != own);
      const float xf = (float)(ox + lx), yf = (float)(oy + ly);
      const float4 v = px[q];
      float E_best = cand_energy(tab, nslot, own, true, xf, yf, v, USE_DISP,
                                 p);
      E_best = E_best + p.lam_bound * (float)bounds;
      short best = own;
      const int pcy = row_cell[ly], pcx = col_cell[lx];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const short nl = nb[t];
        if (nl == kOffImage || nl == kForeign || nl == own) continue;
        // a label met before has the same energy and cannot win (strict <)
        bool seen = false;
#pragma unroll
        for (int u = 0; u < t; ++u) seen |= (nb[u] == nl);
        if (seen) continue;
        const int dcy = slot_cy[nl] - pcy, dcx = slot_cx[nl] - pcx;
        if (dcy < -1 || dcy > 1 || dcx < -1 || dcx > 1) continue;
        float E = cand_energy(tab, nslot, nl, false, xf, yf, v, USE_DISP, p);
        int bb = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) bb += (nb[u] != nl);
        E = E + p.lam_bound * (float)bb;
        if (E < E_best) {
          E_best = E;
          best = nl;
        }
      }
      if (best != own) res[m] = best;
    }
    __syncthreads();  // every decision read the pre-phase labels
#pragma unroll
    for (int m = 0; m < kPerThread; ++m)
      if (res[m] != kKeep)
        lab[act[wbase * kPerThread + lane + 32 * m]] = res[m];
    __syncthreads();
  }

  // write-back of the tile's interior, 4 pixels at a time; in the RGBD
  // pass with each pixel's inlier bit: the plane test of its final label
  for (int g = tid; g < kTileH * kTileW / 4; g += kIterThreads) {
    const int ty = g / (kTileW / 4), tx = 4 * (g % (kTileW / 4));
    const int y = ty0 + ty, x = tx0 + tx;
    if (y >= H || x >= W) continue;
    const int i = y * W + x;
    const int lq = (ty + kHalo) * kRegW + tx + kHalo;
    int ids[4];
    float inl[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const short s = lab[lq + m];
      // a label outside its pixel's cell window (which the callers' labels
      // never hold) is frozen and kept, with no plane
      ids[m] = s == kForeign ? lab_in[i + m] : slot_id[s];
      if (USE_DISP)
        inl[m] = s == kForeign
                     ? 0.0f
                     : plane_inlier(tab[6 * nslot + s], tab[7 * nslot + s],
                                    tab[8 * nslot + s], (float)(x + m),
                                    (float)y, px[lq + m].w, p.thresh_disp);
    }
    *reinterpret_cast<int4*>(lab_out + i) =
        make_int4(ids[0], ids[1], ids[2], ids[3]);
    if (USE_DISP)
      *reinterpret_cast<float4*>(inl_out + i) =
          make_float4(inl[0], inl[1], inl[2], inl[3]);
  }
}

// A superpixel's table column from its 6 (15) sums: means and count and,
// with USE_DISP, the plane by Cramer's rule in label-cell-centred
// coordinates (ops/tps.py fit_planes); the RGB pass keeps the plane.
template <bool USE_DISP>
__device__ __forceinline__ void write_stats(const float* s,
                                            const float* __restrict__ table_in,
                                            float* __restrict__ table, int gy,
                                            int gx, int GW, int G, int cs,
                                            float half) {
  const int id = gy * GW + gx;
  const float n = s[0];
  const float safe_n = fmaxf(n, 1e-6f);
  table[0 * G + id] = s[1] / safe_n;
  table[1 * G + id] = s[2] / safe_n;
  table[2 * G + id] = s[3] / safe_n;
  table[3 * G + id] = s[4] / safe_n;
  table[4 * G + id] = s[5] / safe_n;
  table[5 * G + id] = n;
  if constexpr (USE_DISP) {
    const float cx0 = gx * cs + half, cy0 = gy * cs + half;
    // A = [[sxx sxy sx] [sxy syy sy] [sx sy n]], b = [sxd syd sd]
    const float a00 = s[9], a01 = s[11], a02 = s[7];
    const float a11 = s[10], a12 = s[8], a22 = s[6];
    const float b0 = s[13], b1 = s[14], b2 = s[12];
    const float c00 = a11 * a22 - a12 * a12;
    const float c01 = a12 * a02 - a01 * a22;
    const float c02 = a01 * a12 - a11 * a02;
    const float det = (a00 * c00 + a01 * c01) + a02 * c02;
    const float c11 = a00 * a22 - a02 * a02;
    const float c12 = a01 * a02 - a00 * a12;
    const float c22 = a00 * a11 - a01 * a01;
    const bool ok = fabsf(det) > 1e-12f;
    const float sdet = ok ? det : 1.0f;
    const float ta = ((c00 * b0 + c01 * b1) + c02 * b2) / sdet;
    const float tb = ((c01 * b0 + c11 * b1) + c12 * b2) / sdet;
    const float tcl = ((c02 * b0 + c12 * b1) + c22 * b2) / sdet;
    const float tc = (tcl - ta * cx0) - tb * cy0;
    // a singular fit is marked tc = -1e30 ("no plane", read back as nan)
    table[6 * G + id] = ok ? ta : 0.0f;
    table[7 * G + id] = ok ? tb : 0.0f;
    table[8 * G + id] = ok ? tc : -1e30f;
  } else {
    table[6 * G + id] = table_in[6 * G + id];
    table[7 * G + id] = table_in[7 * G + id];
    table[8 * G + id] = table_in[8 * G + id];
  }
}

// Sum over the 32 lanes of a warp of N values per lane (reduce-scatter:
// N - 1 shuffles halve the values, log2(32 / N) more finish the sums).
// Afterwards v[0] is the warp sum of value lane / (32 / N); the lanes that
// share that index hold the same bits. Fixed order: deterministic.
template <int N, int OFF>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float* v, int lane) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? v[i] : v[i + N / 2];
      const float keep = upper ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    ReduceScatter<N / 2, OFF / 2>::run(v, lane);
  }
};
template <int OFF>
struct ReduceScatter<1, OFF> {
  static __device__ __forceinline__ void run(float* v, int lane) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
    ReduceScatter<1, OFF / 2>::run(v, lane);
  }
};
template <>
struct ReduceScatter<1, 0> {
  static __device__ __forceinline__ void run(float*, int) {}
};

// N (a multiple of 4) consecutive values from a 16-byte aligned address.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         T (&out)[N]) {
  static_assert(sizeof(T) == 4 && N % 4 == 0, "4-byte elements, N % 4 == 0");
  using V = typename std::conditional<std::is_same<T, int>::value, int4,
                                      float4>::type;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const V a = __ldg(reinterpret_cast<const V*>(p) + j);
    out[4 * j] = a.x;
    out[4 * j + 1] = a.y;
    out[4 * j + 2] = a.z;
    out[4 * j + 3] = a.w;
  }
}

// cs % 4 == 0, W % 4 == 0 and 16-byte aligned inputs (the wrapper checks).
template <bool USE_DISP>
__global__ void __launch_bounds__(kMergeThreads)
    tps_merge_kernel(const float* __restrict__ rgb,
                     const float* __restrict__ disp,
                     const int* __restrict__ labels,
                     const float* __restrict__ inl,
                     const float* __restrict__ table_in,
                     float* __restrict__ table, int H, int W, int cs) {
  constexpr int NS = kRgbSums + (USE_DISP ? kDispSums : 0);
  constexpr int NP = USE_DISP ? 16 : 8;  // NS padded for the reduction
  __shared__ float part[kRingCells][9][NS];  // (ring cell, code) partials
  __shared__ float sums[kMergeTY * kMergeTX][NS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GW = W / cs, GH = H / cs, G = GH * GW;
  const float rgw = 1.0f / (float)GW;
  const float half = (cs - 1) * 0.5f;
  const int gy0 = blockIdx.y * kMergeTY, gx0 = blockIdx.x * kMergeTX;
  const int pcy = gy0 - 1 + warp / kRingX, pcx = gx0 - 1 + warp % kRingX;

  for (int t = lane; t < 9 * NS; t += 32) (&part[warp][0][0])[t] = 0.0f;
  __syncwarp();

  // 1. one warp per cell of the tile and its ring: the cell's partial sums
  // per relative code, for the pixels whose superpixel the block owns
  if (pcy >= 0 && pcy < GH && pcx >= 0 && pcx < GW) {
    const int npx = cs * cs;
    for (int base = 0; base < npx; base += kSlice) {
      // a lane's pixels are consecutive in one row of the cell (cs % 4 == 0
      // and W % 4 == 0): fewer codes per lane, one vector load per input
      const int q0 = base + lane * kChunkPerLane;
      // the lane's first pixel, in image coordinates
      const int y0 = pcy * cs + q0 / cs, x0 = pcx * cs + q0 % cs;
      int lab[kChunkPerLane];
      float cr[kChunkPerLane], cg[kChunkPerLane], cb[kChunkPerLane];
      float cd[kChunkPerLane], cw[kChunkPerLane];
#pragma unroll
      for (int m = 0; m < kChunkPerLane; ++m) lab[m] = -1;
      const int i0 = y0 * W + x0;
      if (q0 < npx) load_vec(labels + i0, lab);
      // relative codes (4 bits each); a label outside the cell window is
      // dropped, as cell_reduce drops it, and so is another block's label
      uint32_t codes = 0u, todo = 0u;
#pragma unroll
      for (int m = 0; m < kChunkPerLane; ++m) {
        const int id = lab[m];
        if (id < 0 || id >= G) continue;
        const int ly = div_pos(id, GW, rgw), lx = id - ly * GW;
        const int dy = ly - pcy, dx = lx - pcx;
        if (dy < -1 || dy > 1 || dx < -1 || dx > 1) continue;
        if (ly < gy0 || ly >= gy0 + kMergeTY || lx < gx0 ||
            lx >= gx0 + kMergeTX)
          continue;
        codes |= (uint32_t)((dy + 1) * 3 + dx + 1) << (4 * m);
        todo |= 1u << m;
      }
      // the other inputs only where the lane has a pixel to sum
      if (todo) {
        load_vec(rgb + i0, cr);
        load_vec(rgb + H * W + i0, cg);
        load_vec(rgb + 2 * H * W + i0, cb);
        if constexpr (USE_DISP) {
          load_vec(disp + i0, cd);
          load_vec(inl + i0, cw);
        }
      }
      // rounds: each lane sums its pixels of one code per round (its first
      // pending one); then, per code present in the warp, the lanes holding
      // it reduce their sums into the cell's partial
      while (__any_sync(0xffffffffu, todo != 0u)) {
        const int c = todo ? (codes >> (4 * (__ffs(todo) - 1))) & 0xf : -1;
        const float cxl = (float)((pcx + c % 3 - 1) * cs) + half;
        const float cyl = (float)((pcy + c / 3 - 1) * cs) + half;
        float acc[NP];
#pragma unroll
        for (int t = 0; t < NP; ++t) acc[t] = 0.0f;
#pragma unroll
        for (int m = 0; m < kChunkPerLane; ++m) {
          if (!((todo >> m) & 1u) || ((codes >> (4 * m)) & 0xf) != c)
            continue;
          const float xf = (float)(x0 + m);
          const float yf = (float)y0;
          acc[0] += 1.0f;
          acc[1] += xf;
          acc[2] += yf;
          acc[3] += cr[m];
          acc[4] += cg[m];
          acc[5] += cb[m];
          if constexpr (USE_DISP) {
            // the plane moments in label-cell-centred coordinates
            // (ops/tps.py fit_planes)
            const float w = cw[m] > 0.5f ? 1.0f : 0.0f;
            const float dd = isfinite(cd[m]) ? cd[m] : 0.0f;
            const float xl = xf - cxl, yl = yf - cyl;
            acc[6] += w;
            acc[7] += w * xl;
            acc[8] += w * yl;
            acc[9] += w * xl * xl;
            acc[10] += w * yl * yl;
            acc[11] += w * xl * yl;
            acc[12] += w * dd;
            acc[13] += w * xl * dd;
            acc[14] += w * yl * dd;
          }
          todo &= ~(1u << m);
        }
        uint32_t present =
            __reduce_or_sync(0xffffffffu, c >= 0 ? 1u << c : 0u);
        while (present) {
          const int k = __ffs(present) - 1;
          present &= present - 1;
          float v[NP];
#pragma unroll
          for (int t = 0; t < NP; ++t) v[t] = c == k ? acc[t] : 0.0f;
          ReduceScatter<NP, 16>::run(v, lane);
          const int f = lane / (32 / NP);
          if (lane % (32 / NP) == 0 && f < NS) part[warp][k][f] += v[0];
        }
      }
    }
  }
  __syncthreads();

  // 2. each owned superpixel: its 9 partials in code order. Code k of pixel
  // cell P means label cell P + offs(k), so the partial sits at the label
  // cell minus offs(k).
  for (int t = tid; t < kMergeTY * kMergeTX * NS; t += kMergeThreads) {
    const int u = t / NS, f = t % NS;
    const int uy = u / kMergeTX, ux = u % kMergeTX;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      s += part[(uy + 1 - (k / 3 - 1)) * kRingX + ux + 1 - (k % 3 - 1)][k][f];
    sums[u][f] = s;
  }
  __syncthreads();
  if (tid < kMergeTY * kMergeTX) {
    const int gy = gy0 + tid / kMergeTX, gx = gx0 + tid % kMergeTX;
    if (gy < GH && gx < GW)
      write_stats<USE_DISP>(sums[tid], table_in, table, gy, gx, GW, G, cs,
                            half);
  }
}

}  // namespace

// Shared-memory bytes of one tps_iteration block, and the table-slice size
// (slots) it holds, for a frame of (H, W) and cell size cs.
static void iteration_smem(int H, int W, int cs, int* nslot, size_t* bytes) {
  const int sh = std::min(H / cs, (kRegH - 1) / cs + 4);
  const int sw = std::min(W / cs, (kRegW - 1) / cs + 4);
  *nslot = sh * sw;
  *bytes = kRegPx * sizeof(float4) +
           (size_t)*nslot * (10 * sizeof(float) + sizeof(int) +
                             2 * sizeof(short)) +
           (kRegH + kRegW + kRegPx) * sizeof(short);
}

extern "C" int tps_iteration_launch(const float* rgb, const float* disp,
                                    const int* lab_in, const float* table,
                                    int* lab_out, float* inl_out, int H,
                                    int W, int cs, int use_disp,
                                    float lam_pos, float lam_bound,
                                    float lam_size, float lam_disp,
                                    float thresh_disp, float min_size,
                                    void* stream) {
  const PhaseParams p{lam_pos, lam_bound, lam_size, lam_disp, thresh_disp,
                      min_size};
  int nslot;
  size_t smem;
  iteration_smem(H, W, cs, &nslot, &smem);
  if (nslot >= kForeign || (H / cs) * (W / cs) >= (1 << 22) || W % 4)
    return (int)cudaErrorInvalidValue;
  // the attribute is set on every call: it is cheap, and a refusal (more
  // shared memory than the card gives a block) must surface as an error
  auto kern = use_disp ? tps_iteration_kernel<true>
                       : tps_iteration_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  kern<<<grid, kIterThreads, smem, (cudaStream_t)stream>>>(
      rgb, disp, lab_in, table, lab_out, inl_out, H, W, cs, nslot, p);
  return (int)cudaGetLastError();
}

extern "C" int tps_merge_launch(const float* rgb, const float* disp,
                                const int* labels, const float* inl,
                                const float* table_in, float* table, int H,
                                int W, int cs, int use_disp, void* stream) {
  const int GH = H / cs, GW = W / cs;
  if (GH * GW >= (1 << 22) || cs % 4 || W % 4)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((GW + kMergeTX - 1) / kMergeTX,
                  (GH + kMergeTY - 1) / kMergeTY);
  auto kern = use_disp ? tps_merge_kernel<true> : tps_merge_kernel<false>;
  kern<<<grid, kMergeThreads, 0, (cudaStream_t)stream>>>(
      rgb, disp, labels, inl, table_in, table, H, W, cs);
  return (int)cudaGetLastError();
}
