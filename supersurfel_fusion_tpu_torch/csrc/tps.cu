// TPS superpixel iteration kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `run_iterations` of
// supersurfel_fusion_tpu/ops/tps_pallas.py (pl.pallas_call at :381, body
// `_make_kernel` :109-358, wrapper `segment` :423-464). That kernel keeps the
// whole segmentation state resident in 119 MiB of VMEM and works around
// Mosaic (bf16 stat encodings, matmul pooling/upsampling, no i1 vectors).
// None of that carries over. On Hopper the state (labels, inliers, the
// (9, GH, GW) stats table, rgb and disparity: about 8 MB at 640x480) sits
// in the 50 MB L2 between launches, so the iteration is two plain f32
// kernels launched from a host loop (ops/tps_cuda.py):
//
//   tps_phase  K1 phase/cand_energy (:231-336) with K3 rebuild_S (:148-168)
//              folded in as a direct gather table[:, label] (the stat image
//              is by construction the table gathered by label). One thread
//              per pixel; labels are double-buffered so every read sees the
//              pre-phase labels, as the reference's whole-image update does.
//   tps_merge  K2 merge (:170-229). One block per superpixel reduces over
//              its own 3x3-cell window (labels never leave it), in a fixed
//              order: deterministic, no atomics. In the RGBD pass it also
//              sums the 9 plane moments in label-cell-centred coordinates
//              and solves the 3x3 normal equations by Cramer's rule.
//
// What bounds it: both kernels are memory bound (a phase reads ~36 B/px,
// a merge ~9 MB per call at 640x480), i.e. a few microseconds each from
// HBM and less from L2; 52 launches per frame make launch overhead the
// first limit. The design keeps every launch a single pass over the state
// and allocates nothing; a CUDA graph over the host loop is the next step.
//
// The arithmetic follows ops/tps.py (the plain version) term by term and
// the library is built with --fmad=false, so a phase gives the plain
// version's labels bit for bit; merges differ only in summation order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMergeThreads = 256;
constexpr int kRgbSums = 6;    // n, x, y, r, g, b
constexpr int kDispSums = 9;   // w, w*xl, w*yl, w*xl^2, w*yl^2, w*xl*yl, w*d, w*xl*d, w*yl*d

struct PhaseParams {
  float lam_pos, lam_bound, lam_size, lam_disp, thresh_disp, min_size;
};

__device__ __forceinline__ int label_at(const int* __restrict__ labels, int y,
                                        int x, int H, int W) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? labels[y * W + x] : -1;
}

// Energy of assigning pixel (x, y) to superpixel `lab` (ops/tps.py
// _candidate_energy). table is (9, G): cx cy r g b n ta tb tc.
__device__ __forceinline__ float cand_energy(
    const float* __restrict__ table, int G, int lab, bool own, float x,
    float y, float r, float g, float b, float d, bool use_disp,
    const PhaseParams& p, bool* inl) {
  const float cx = table[0 * G + lab];
  const float cy = table[1 * G + lab];
  const float mr = table[2 * G + lab];
  const float mg = table[3 * G + lab];
  const float mb = table[4 * G + lab];
  const float n = table[5 * G + lab];
  float dx, dy, dr, dg, db, dsize;
  if (own) {
    const float s = n / fmaxf(n - 1.0f, 1e-6f);
    dsize = n - p.min_size;
    dx = s * (x - cx);
    dy = s * (y - cy);
    dr = (r - mr) * s;
    dg = (g - mg) * s;
    db = (b - mb) * s;
  } else {
    dsize = (n + 1.0f) - p.min_size;
    dx = x - cx;
    dy = y - cy;
    dr = r - mr;
    dg = g - mg;
    db = b - mb;
  }
  float E = ((dr * dr + dg * dg) + db * db) + p.lam_pos * (dx * dx + dy * dy);
  E = E - p.lam_size * fminf(dsize, 0.0f);
  *inl = true;
  if (use_disp) {
    const float dp = (table[6 * G + lab] * x + table[7 * G + lab] * y) +
                     table[8 * G + lab];
    const float e = (dp - d) * (dp - d);
    const bool good = isfinite(e) && e <= p.thresh_disp && dp > 0.0f;
    E = E + p.lam_disp * (good ? e : p.thresh_disp);
    *inl = good;
  }
  return E;
}

__global__ void tps_phase_kernel(const float* __restrict__ rgb,
                                 const float* __restrict__ disp,
                                 const int* __restrict__ lab_in,
                                 const float* __restrict__ inl_in,
                                 const float* __restrict__ table,
                                 int* __restrict__ lab_out,
                                 float* __restrict__ inl_out, int H, int W,
                                 int cs, int off_x, int off_y, int use_disp,
                                 PhaseParams p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * W) return;
  const int y = idx / W;
  const int x = idx - y * W;
  const int GW = W / cs;
  const int G = (H / cs) * GW;
  const int own = lab_in[idx];

  // 4-neighbours in candidate order up, left, right, down; -1 off-image
  const int nb[4] = {label_at(lab_in, y - 1, x, H, W),
                     label_at(lab_in, y, x - 1, H, W),
                     label_at(lab_in, y, x + 1, H, W),
                     label_at(lab_in, y + 1, x, H, W)};
  int bounds = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) bounds += (nb[k] != own);

  // open 8-ring connectivity guard (ops/tps.py unchangeable)
  const int ry[8] = {-1, -1, -1, 0, 1, 1, 1, 0};
  const int rx[8] = {-1, 0, 1, 1, 1, 0, -1, -1};
  int jumps = 0;
  bool prev = label_at(lab_in, y + ry[0], x + rx[0], H, W) == own;
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const bool cur = label_at(lab_in, y + ry[k], x + rx[k], H, W) == own;
    jumps += (cur != prev);
    prev = cur;
  }
  const bool col = (((x & 3) + 1 + 2 * off_x) & 3) <= 1;
  const bool active = ((y & 1) == off_y) && col && bounds > 0 && jumps <= 2;

  if (!active && !use_disp) {
    lab_out[idx] = own;
    inl_out[idx] = inl_in[idx];
    return;
  }

  const float xf = (float)x, yf = (float)y;
  const float r = rgb[idx], g = rgb[H * W + idx], b = rgb[2 * H * W + idx];
  const float d = disp[idx];
  const bool ud = use_disp != 0;

  // every pixel of an RGBD pass refreshes its inlier bit against its own
  // label's plane, as the reference does
  bool inl_best;
  float E_best = cand_energy(table, G, own, true, xf, yf, r, g, b, d, ud, p,
                             &inl_best);
  int best = own;
  if (active) {
    E_best = E_best + p.lam_bound * (float)bounds;
    const int gyp = y / cs, gxp = x / cs;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int nl = nb[c];
      if (nl < 0 || nl == own) continue;
      const int gyn = nl / GW, gxn = nl - (nl / GW) * GW;
      if (gyn < gyp - 1 || gyn > gyp + 1 || gxn < gxp - 1 || gxn > gxp + 1)
        continue;
      bool inl;
      float E = cand_energy(table, G, nl, false, xf, yf, r, g, b, d, ud, p,
                            &inl);
      int bb = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) bb += (nb[k] != nl);
      E = E + p.lam_bound * (float)bb;
      if (E < E_best) {
        E_best = E;
        best = nl;
        inl_best = inl;
      }
    }
  }
  lab_out[idx] = best;
  inl_out[idx] = ud ? (inl_best ? 1.0f : 0.0f) : inl_in[idx];
}

template <bool USE_DISP>
__global__ void __launch_bounds__(kMergeThreads)
    tps_merge_kernel(const float* __restrict__ rgb,
                     const float* __restrict__ disp,
                     const int* __restrict__ labels,
                     const float* __restrict__ inl, float* __restrict__ table,
                     int H, int W, int cs) {
  constexpr int NS = kRgbSums + (USE_DISP ? kDispSums : 0);
  const int GW = W / cs;
  const int GH = H / cs;
  const int G = GH * GW;
  const int id = blockIdx.x;
  const int gy = id / GW, gx = id - (id / GW) * GW;
  const int y0 = max(0, (gy - 1) * cs), y1 = min(H, (gy + 2) * cs);
  const int x0 = max(0, (gx - 1) * cs), x1 = min(W, (gx + 2) * cs);
  const int ww = x1 - x0;
  const int npx = (y1 - y0) * ww;
  const float half = (cs - 1) * 0.5f;
  const float cx0 = gx * cs + half, cy0 = gy * cs + half;

  float acc[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = 0.0f;

  for (int q = threadIdx.x; q < npx; q += kMergeThreads) {
    const int yy = y0 + q / ww;
    const int xx = x0 + q % ww;
    const int i = yy * W + xx;
    if (labels[i] != id) continue;
    const float xf = (float)xx, yf = (float)yy;
    acc[0] += 1.0f;
    acc[1] += xf;
    acc[2] += yf;
    acc[3] += rgb[i];
    acc[4] += rgb[H * W + i];
    acc[5] += rgb[2 * H * W + i];
    if constexpr (USE_DISP) {
      const float w = inl[i];
      const float dv = disp[i];
      const float dd = isfinite(dv) ? dv : 0.0f;
      const float xl = xf - cx0, yl = yf - cy0;
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
  }

  // fixed-order reduction: warp shuffles, then the warp partials in order
  __shared__ float part[kMergeThreads / 32][NS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float s[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    float v = 0.0f;
    for (int w = 0; w < kMergeThreads / 32; ++w) v += part[w][k];
    s[k] = v;
  }
  const float n = s[0];
  const float safe_n = fmaxf(n, 1e-6f);
  table[0 * G + id] = s[1] / safe_n;
  table[1 * G + id] = s[2] / safe_n;
  table[2 * G + id] = s[3] / safe_n;
  table[3 * G + id] = s[4] / safe_n;
  table[4 * G + id] = s[5] / safe_n;
  table[5 * G + id] = n;
  if constexpr (USE_DISP) {
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
  }
}

}  // namespace

extern "C" int tps_phase_launch(const float* rgb, const float* disp,
                                const int* lab_in, const float* inl_in,
                                const float* table, int* lab_out,
                                float* inl_out, int H, int W, int cs,
                                int off_x, int off_y, int use_disp,
                                float lam_pos, float lam_bound, float lam_size,
                                float lam_disp, float thresh_disp,
                                float min_size, void* stream) {
  const PhaseParams p{lam_pos, lam_bound, lam_size, lam_disp, thresh_disp,
                      min_size};
  const int n = H * W;
  const int threads = 256;
  tps_phase_kernel<<<(n + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(rgb, disp, lab_in, inl_in, table,
                                             lab_out, inl_out, H, W, cs,
                                             off_x, off_y, use_disp, p);
  return (int)cudaGetLastError();
}

extern "C" int tps_merge_launch(const float* rgb, const float* disp,
                                const int* labels, const float* inl,
                                float* table, int H, int W, int cs,
                                int use_disp, void* stream) {
  const int blocks = (H / cs) * (W / cs);
  if (use_disp)
    tps_merge_kernel<true><<<blocks, kMergeThreads, 0, (cudaStream_t)stream>>>(
        rgb, disp, labels, inl, table, H, W, cs);
  else
    tps_merge_kernel<false><<<blocks, kMergeThreads, 0,
                              (cudaStream_t)stream>>>(rgb, disp, labels, inl,
                                                      table, H, W, cs);
  return (int)cudaGetLastError();
}
