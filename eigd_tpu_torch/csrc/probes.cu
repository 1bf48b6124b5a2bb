// The stencil floor probes: kernels that move K1's bytes with less of its
// work, so that K1's time at the 1M-DOF shapes splits into data movement,
// arithmetic and column shifts.
//
// Replaces the two Pallas TPU probe kernels of scripts/:
//   K3 = kern of make_variant (diag_pallas_floor.py:51, pallas_call :87),
//        three bodies on the same operands (x slabs (C, R, Y+2) with
//        C = ndof*k channels, W planes (9*ndof*ndof, R, Y), out (C, R, Y)):
//          copy     out[c] = x0[c, :, 1:1+Y]
//          onetap   out[a*k+c] = sum_b W[4*nd*nd + a*nd + b] * x0[b*k+c]
//                   (the centre tap, no shifts)
//          noshift9 all nine taps over the row-shifted slabs x_-1, x_0,
//                   x_+1, every tap on the UNSHIFTED column window (wrong
//                   maths on purpose: K1's bytes and flops without its
//                   column shifts), summed in the order (di, b, dj).
//   K4 = kern of probe (diag_pallas_dma.py:44, pallas_call :62):
//          out = sum_{s<n_slabs} slab_s[:, :, :Yo] (+ W[0, :, :Yo]).
//
// The TPU kernels cut the rows into TX-row BlockSpec tiles over an XR-row
// padded array and DMA every block of all 36 W planes into VMEM, whether
// the body reads them or not. Here the grid covers any row count R, and
// each kernel reads only the planes its body reads.
//
// Cost model. All of them are bound by memory (at most 2*9*ndof*ndof
// flops per output node and column against 4-byte loads). One thread per
// output element (copy, K4) or per (column, row, j) node (onetap,
// noshift9, where each thread computes all ndof outputs, so each x value
// is loaded once per tap and not once per output dof); neighbouring
// threads go along the contiguous Y axis, so every load and store of a
// warp is coalesced. The three K3 x pointers are row offsets into one
// padded buffer: their rows overlap, and the overlapping reads hit L2.
// Fixed-order sums, no atomics: results are deterministic.

#include <cuda_runtime.h>

namespace {

enum FloorKind { kCopy = 0, kOneTap = 1, kNoShift9 = 2 };

template <int KIND, int NDOF>
__global__ void floor_kernel(const float* __restrict__ W,
                             const float* __restrict__ xm,
                             const float* __restrict__ x0,
                             const float* __restrict__ xp,
                             float* __restrict__ out, int k, int R, int Y,
                             long long xsc, long long xsr) {
  // threads over (channel group, row, j); copy runs over all C channels
  const int groups = (KIND == kCopy) ? NDOF * k : k;
  const long long total = static_cast<long long>(groups) * R * Y;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = static_cast<int>(idx % Y);
  const long long rr = idx / Y;
  const int r = static_cast<int>(rr % R);
  const int c = static_cast<int>(rr / R);
  const long long plane = static_cast<long long>(R) * Y;
  const long long node = static_cast<long long>(r) * Y + j;
  // column window 1:1+Y of the (Y+2)-wide slabs
  const long long xo = static_cast<long long>(r) * xsr + 1 + j;

  if (KIND == kCopy) {
    out[c * plane + node] = x0[c * xsc + xo];
    return;
  }
  float acc[NDOF];
#pragma unroll
  for (int a = 0; a < NDOF; ++a) acc[a] = 0.0f;

  if (KIND == kOneTap) {
#pragma unroll
    for (int b = 0; b < NDOF; ++b) {
      const float xv = x0[static_cast<long long>(b * k + c) * xsc + xo];
#pragma unroll
      for (int a = 0; a < NDOF; ++a) {
        const int t = 4 * NDOF * NDOF + a * NDOF + b;
        acc[a] += W[t * plane + node] * xv;
      }
    }
  } else {
    const float* slabs[3] = {xm, x0, xp};
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int b = 0; b < NDOF; ++b) {
        const float xv =
            slabs[di][static_cast<long long>(b * k + c) * xsc + xo];
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
          for (int a = 0; a < NDOF; ++a) {
            const int t = (3 * di + dj) * NDOF * NDOF + a * NDOF + b;
            acc[a] += W[t * plane + node] * xv;
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NDOF; ++a)
    out[static_cast<long long>(a * k + c) * plane + node] = acc[a];
}

template <int KIND>
int launch_floor(const float* W, const float* xm, const float* x0,
                 const float* xp, float* out, int ndof, int k, int R, int Y,
                 long long xsc, long long xsr, cudaStream_t s) {
  const int groups = (KIND == kCopy) ? ndof * k : k;
  const long long total = static_cast<long long>(groups) * R * Y;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned int blocks =
      static_cast<unsigned int>((total + threads - 1) / threads);
  switch (ndof) {
    case 1:
      floor_kernel<KIND, 1><<<blocks, threads, 0, s>>>(W, xm, x0, xp, out, k,
                                                       R, Y, xsc, xsr);
      break;
    case 2:
      floor_kernel<KIND, 2><<<blocks, threads, 0, s>>>(W, xm, x0, xp, out, k,
                                                       R, Y, xsc, xsr);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NSLABS, bool WITH_W>
__global__ void dma_kernel(const float* __restrict__ s0,
                           const float* __restrict__ s1,
                           const float* __restrict__ s2,
                           const float* __restrict__ W,
                           float* __restrict__ out, int C, int R, int Yo,
                           long long ssc, long long ssr, long long wsr) {
  const long long total = static_cast<long long>(C) * R * Yo;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = static_cast<int>(idx % Yo);
  const long long rr = idx / Yo;
  const int r = static_cast<int>(rr % R);
  const int c = static_cast<int>(rr / R);
  const long long so = c * ssc + r * ssr + j;
  float acc = s0[so];
  if (NSLABS == 3) {
    acc = acc + s1[so];
    acc = acc + s2[so];
  }
  if (WITH_W) acc = acc + W[r * wsr + j];
  out[idx] = acc;
}

template <int NSLABS, bool WITH_W>
int launch_dma(const float* s0, const float* s1, const float* s2,
               const float* W, float* out, int C, int R, int Yo,
               long long ssc, long long ssr, long long wsr, cudaStream_t s) {
  const long long total = static_cast<long long>(C) * R * Yo;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned int blocks =
      static_cast<unsigned int>((total + threads - 1) / threads);
  dma_kernel<NSLABS, WITH_W><<<blocks, threads, 0, s>>>(
      s0, s1, s2, W, out, C, R, Yo, ssc, ssr, wsr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success).
//
// K3: kind 0 copy, 1 onetap, 2 noshift9. W contiguous (9*ndof*ndof, R, Y);
// xm, x0, xp share the element strides (xsc channel, xsr row, 1 column) of
// (ndof*k, R, Y+2) slabs; out contiguous (ndof*k, R, Y).
extern "C" int eigd_probe_floor(int kind, const void* W, const void* xm,
                                const void* x0, const void* xp, void* out,
                                int ndof, int k, int R, int Y, long long xsc,
                                long long xsr, void* stream) {
  const float* w = static_cast<const float*>(W);
  const float* a = static_cast<const float*>(xm);
  const float* b = static_cast<const float*>(x0);
  const float* c = static_cast<const float*>(xp);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kCopy:
      return launch_floor<kCopy>(w, a, b, c, o, ndof, k, R, Y, xsc, xsr, s);
    case kOneTap:
      return launch_floor<kOneTap>(w, a, b, c, o, ndof, k, R, Y, xsc, xsr,
                                   s);
    case kNoShift9:
      return launch_floor<kNoShift9>(w, a, b, c, o, ndof, k, R, Y, xsc, xsr,
                                     s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4: n_slabs 1 or 3 slabs sharing the element strides (ssc channel, ssr
// row, 1 column); W (may be null when with_w is 0) is read on plane 0 with
// row stride wsr; out contiguous (C, R, Yo).
extern "C" int eigd_probe_dma(const void* s0, const void* s1, const void* s2,
                              int n_slabs, const void* W, int with_w,
                              void* out, int C, int R, int Yo, long long ssc,
                              long long ssr, long long wsr, void* stream) {
  const float* a = static_cast<const float*>(s0);
  const float* b = static_cast<const float*>(s1);
  const float* c = static_cast<const float*>(s2);
  const float* w = static_cast<const float*>(W);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_slabs == 1 && !with_w)
    return launch_dma<1, false>(a, b, c, w, o, C, R, Yo, ssc, ssr, wsr, s);
  if (n_slabs == 1 && with_w)
    return launch_dma<1, true>(a, b, c, w, o, C, R, Yo, ssc, ssr, wsr, s);
  if (n_slabs == 3 && !with_w)
    return launch_dma<3, false>(a, b, c, w, o, C, R, Yo, ssc, ssr, wsr, s);
  if (n_slabs == 3 && with_w)
    return launch_dma<3, true>(a, b, c, w, o, C, R, Yo, ssc, ssr, wsr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
