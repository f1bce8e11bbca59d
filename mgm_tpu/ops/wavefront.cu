// MGM directional recursion as one CUDA kernel (Hopper, sm_90a).
//
// Computes, for every plane p = (pass, problem), the aggregated volume
// Lr of ops/aggregate._run_group with the SGM potential:
//
//   Lr[r, c] = cc[r, c] + e(Lr at the causal neighbours)   (interior)
//   Lr[r, c] = cc[r, c]                                     (border)
//
// in the pass's canonical scan space (r, c), whose causal neighbours are
// W = (r, c-1), N = (r-1, c), NW = (r-1, c-1) and NE = (r-1, c+1)
// (aggregate.py, "stack order of the canonical causal offsets").  Cell
// (r, c) lies on front t = c + slope*r; all cells of one front are
// independent, fronts are sequential.
//
// One thread-block cluster of CLUSTER blocks owns one plane and loops
// over its fronts; canonical row r belongs to block r % CLUSTER, so
// the rows a front touches spread over every block.  Each warp computes
// one (row, front) cell at a time, lanes striding the label axis.  The
// volume is read and written in its image layout (N, H, W, L) by index
// arithmetic (flips and the row/column swap of the pass): no skewed or
// transposed copy exists.  Row r reads row r-1 of earlier fronts, which
// another block of the cluster wrote; one cluster barrier per front
// (release/acquire) orders those accesses, and the reads bypass L1.
//
// The arithmetic is the XLA scan's as XLA compiles it, operation for
// operation (the library is built with -fmad=false): NaN-propagating
// min, and the mean over neighbours as a product with 1/mgm, which is
// what XLA's simplifier makes of a division by a constant.

#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace cg = cooperative_groups;
namespace ffi = xla::ffi;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDesc = 16;  // int32 fields per plane descriptor

// plane descriptor fields (ops/wavefront_cuda.plane_table)
enum {
  D_PROBLEM = 0,  // n: which (H, W, L) volume of cc / w8
  D_FLIP_X,
  D_FLIP_Y,
  D_ROW_MAJOR,
  D_SLOPE,        // 2 when NE is an active neighbour, else 1
  D_NDIR,         // active neighbours (mgm)
  D_OFF0,         // D_OFF0 + k: offset index of dir k (0 W, 1 N, 2 NW, 3 NE)
  D_WCH0 = D_OFF0 + 4,  // D_WCH0 + k: weight channel of dir k
};

// jnp.minimum: NaN if either operand is NaN
__device__ __forceinline__ float xmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

struct Geometry {
  int H, W, L, R, C, flip_x, flip_y, row_major;

  // canonical (r, c) -> linear image pixel index y * W + x
  __device__ __forceinline__ int64_t pixel(int r, int c) const {
    int y, x;
    if (row_major) {
      y = r;
      x = c;
    } else {
      y = c;
      x = r;
    }
    if (flip_y) y = H - 1 - y;
    if (flip_x) x = W - 1 - x;
    return (int64_t)y * W + x;
  }
};

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
wavefront_kernel(const float* __restrict__ cc, const float* __restrict__ w8,
                 const int32_t* __restrict__ desc, float* out, float* mins,
                 int H, int W, int L, float p1, float p2, int use_weights,
                 int div_each) {
  cg::cluster_group cluster = cg::this_cluster();
  const int plane = blockIdx.x / kCluster;
  const int rank = blockIdx.x % kCluster;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int32_t* d = desc + plane * kDesc;
  Geometry g;
  g.H = H;
  g.W = W;
  g.L = L;
  g.flip_x = d[D_FLIP_X];
  g.flip_y = d[D_FLIP_Y];
  g.row_major = d[D_ROW_MAJOR];
  g.R = g.row_major ? H : W;
  g.C = g.row_major ? W : H;
  const int slope = d[D_SLOPE];
  const int nd = d[D_NDIR];
  int off[4], wch[4];
  for (int k = 0; k < 4; ++k) {
    off[k] = d[D_OFF0 + k];
    wch[k] = d[D_WCH0 + k];
  }
  const int64_t HW = (int64_t)H * W;
  const float* cc_p = cc + (int64_t)d[D_PROBLEM] * HW * L;
  const float* w8_p = w8 + (int64_t)d[D_PROBLEM] * HW * 8;
  float* out_p = out + (int64_t)plane * HW * L;
  float* mins_p = mins + (int64_t)plane * HW;  // canonical (R, C)

  const int R = g.R, C = g.C;
  const int T = C + slope * (R - 1);
  const int stride = kCluster * kWarps;          // rows per sweep
  const int mine = rank + kCluster * warp;       // this warp's residue
  const float inf = INFINITY;
  const float p1f = p1, p2f = p2;
  const float inv_nd = 1.0f / (float)nd;  // XLA's rewrite of x / nd

  for (int t = 0; t < T; ++t) {
    // rows with a cell on front t: 0 <= t - slope*r < C
    int r_lo = t - C + 1 > 0 ? (t - C + slope) / slope : 0;
    int r_hi = min(t / slope, R - 1);
    int r = r_lo + ((mine - r_lo) % stride + stride) % stride;
    for (; r <= r_hi; r += stride) {
      const int c = t - slope * r;
      const int64_t px = g.pixel(r, c);
      const float* cc_row = cc_p + px * L;
      float* out_row = out_p + px * L;
      const bool interior = r >= 1 && c >= 1 && c <= C - 2;

      const float* nb[4];
      float mk[4], p1w[4], p2w[4];
      if (interior) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k >= nd) break;
          int rn = r - 1, cn = c;
          switch (off[k]) {
            case 0: rn = r; cn = c - 1; break;   // W
            case 1: break;                       // N
            case 2: cn = c - 1; break;           // NW
            default: cn = c + 1; break;          // NE
          }
          nb[k] = out_p + g.pixel(rn, cn) * L;
          mk[k] = __ldcg(mins_p + (int64_t)rn * C + cn);
          if (use_weights) {
            const float delta = __ldg(w8_p + px * 8 + wch[k]);
            p1w[k] = p1f * delta;
            p2w[k] = p2f * delta;
          } else {
            p1w[k] = p1f;
            p2w[k] = p2f;
          }
        }
      }

      float row_min = inf;
      for (int l = lane; l < L; l += 32) {
        const float c0 = __ldg(cc_row + l);
        float v = c0;
        if (interior) {
          float msg[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k >= nd) break;
            const float lk = __ldcg(nb[k] + l);
            const float lm = l > 0 ? __ldcg(nb[k] + l - 1) : inf;
            const float lp = l + 1 < L ? __ldcg(nb[k] + l + 1) : inf;
            const float vlp1 = xmin(lm, lp) + p1w[k];
            msg[k] = xmin(xmin(lk, vlp1), mk[k] + p2w[k]) - mk[k];
          }
          float e;
          if (div_each) {
            e = msg[0] * 0.5f + msg[1] * 0.5f;
          } else {
            e = msg[0];
#pragma unroll
            for (int k = 1; k < 4; ++k) {
              if (k >= nd) break;
              e = e + msg[k];
            }
            if (nd > 1) e = e * inv_nd;
          }
          v = c0 + e;
        }
        out_row[l] = v;
        row_min = xmin(row_min, v);
      }
      for (int s = 16; s > 0; s >>= 1)
        row_min = xmin(row_min, __shfl_xor_sync(0xffffffffu, row_min, s));
      if (lane == 0) mins_p[(int64_t)r * C + c] = row_min;
    }
    cluster.sync();
  }
}

ffi::Error WavefrontImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> cc,
                         ffi::Buffer<ffi::F32> w8, ffi::Buffer<ffi::S32> desc,
                         ffi::ResultBuffer<ffi::F32> out,
                         ffi::ResultBuffer<ffi::F32> mins, float p1, float p2,
                         int32_t use_weights, int32_t div_each) {
  auto dims = cc.dimensions();  // (N, H, W, L)
  if (dims.size() != 4) {
    return ffi::Error::InvalidArgument("cc must be (N, H, W, L)");
  }
  const int H = (int)dims[1], W = (int)dims[2], L = (int)dims[3];
  const int planes = (int)desc.dimensions()[0];
  if (desc.dimensions()[1] != kDesc) {
    return ffi::Error::InvalidArgument("plane descriptors must be (P, 16)");
  }
  wavefront_kernel<<<planes * kCluster, kThreads, 0, stream>>>(
      cc.typed_data(), w8.typed_data(), desc.typed_data(),
      out->typed_data(), mins->typed_data(), H, W, L, p1, p2, use_weights,
      div_each);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MgmWavefront, WavefrontImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<float>("p1")
                                  .Attr<float>("p2")
                                  .Attr<int32_t>("use_weights")
                                  .Attr<int32_t>("div_each"));
