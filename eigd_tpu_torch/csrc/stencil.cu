// 9-point block-stencil matvec y = A x on a structured (X, Y) node grid,
// with ndof x ndof coupling blocks and a zero halo at the grid edges.
//
// Replaces the two Pallas TPU kernels of eigd_tpu/ops/pallas_stencil.py:
//   K1 = _kernel (reached through _matvec_planes_impl): the f32 matvec of
//        every multigrid V-cycle level, Chebyshev step and f32 PCG;
//   K2 = _dd_kernel (reached through _dd_stencil_matvec_impl): the
//        f64-accurate matvec of the outer PCG residual and of every
//        solver-side f64 A.mv / B.mv. On the TPU it is a compensated
//        double-float sum of Dekker-split f32 products, because XLA:TPU
//        emulates f64. Hopper has native FP64, so K2 is the same template
//        as K1 instantiated for double: no split, no (s, c) pair, no
//        column chunking.
//
// Layouts. W is the plane stencil (9*ndof*ndof, X, Y), contiguous, plane
// t = (3*(di+1) + (dj+1))*ndof*ndof + a*ndof + b. x and y are addressed
// through element strides (b, column, i, j), so one kernel reads both the
// (ndof, k, X, Y) plane layout of the V-cycle and the (X, Y, ndof, k)
// vector layout of the solvers without a transpose.
//
// Cost model. The kernel is bound by memory: per output node and column it
// reads 9*ndof*ndof W values and 9*ndof x values for 2*9*ndof*ndof flops.
// The design keeps every read coalesced where the layout allows it: one
// thread per (column, i, j) output node. For plane-layout x neighbouring
// threads go along j, the contiguous axis of W and of x, so a warp reads
// 32 consecutive W values per plane; for vector-layout x with k > 1 they
// go along the contiguous column axis instead. Each thread computes all
// ndof outputs of its node, so x is read once per tap and not once per
// output dof. The nine neighbour reads of x hit L1/L2 (neighbouring
// threads share them).
// Each output is a fixed-order sum with no atomics, so results are
// deterministic. Shared-memory tiling of x is left for a later change.

#include <cuda_runtime.h>

namespace {

template <typename T, int NDOF>
__global__ void stencil_kernel(const T* __restrict__ W,
                               const T* __restrict__ x, T* __restrict__ y,
                               int X, int Y, int k,
                               int xsb, int xsk, int xsi, int xsj,
                               int ysb, int ysk, int ysi, int ysj,
                               int col_fastest) {
  const long long total = static_cast<long long>(k) * X * Y;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int i, j, c;
  if (col_fastest) {  // x's columns contiguous: neighbouring threads on c
    c = static_cast<int>(idx % k);
    const long long r = idx / k;
    j = static_cast<int>(r % Y);
    i = static_cast<int>(r / Y);
  } else {  // neighbouring threads along j
    j = static_cast<int>(idx % Y);
    const long long r = idx / Y;
    i = static_cast<int>(r % X);
    c = static_cast<int>(r / X);
  }
  const long long plane = static_cast<long long>(X) * Y;
  const long long node = static_cast<long long>(i) * Y + j;
  const long long xc = static_cast<long long>(c) * xsk;

  T acc[NDOF];
#pragma unroll
  for (int a = 0; a < NDOF; ++a) acc[a] = T(0);

#pragma unroll
  for (int di = -1; di <= 1; ++di) {
    const int ii = i + di;
    if (ii < 0 || ii >= X) continue;
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj) {
      const int jj = j + dj;
      if (jj < 0 || jj >= Y) continue;
      const int tap = 3 * (di + 1) + (dj + 1);
      const long long xo = xc + static_cast<long long>(ii) * xsi +
                           static_cast<long long>(jj) * xsj;
#pragma unroll
      for (int b = 0; b < NDOF; ++b) {
        const T xv = x[xo + static_cast<long long>(b) * xsb];
#pragma unroll
        for (int a = 0; a < NDOF; ++a) {
          const int t = (tap * NDOF + a) * NDOF + b;
          acc[a] += W[t * plane + node] * xv;
        }
      }
    }
  }
  const long long yo = static_cast<long long>(c) * ysk +
                       static_cast<long long>(i) * ysi +
                       static_cast<long long>(j) * ysj;
#pragma unroll
  for (int a = 0; a < NDOF; ++a)
    y[yo + static_cast<long long>(a) * ysb] = acc[a];
}

template <typename T>
int launch(const void* W, const void* x, void* y, int X, int Y, int ndof,
           int k, int xsb, int xsk, int xsi, int xsj, int ysb, int ysk,
           int ysi, int ysj, void* stream) {
  const long long total = static_cast<long long>(k) * X * Y;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned int blocks =
      static_cast<unsigned int>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The vector layout (X, Y, ndof, k) has its k columns contiguous: map
  // neighbouring threads to neighbouring columns there, so x and y
  // accesses coalesce (threads of one node share their W reads).
  const int col_fastest = (k > 1 && xsk == 1) ? 1 : 0;
  const T* Wt = static_cast<const T*>(W);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (ndof) {
    case 1:
      stencil_kernel<T, 1><<<blocks, threads, 0, s>>>(
          Wt, xt, yt, X, Y, k, xsb, xsk, xsi, xsj, ysb, ysk, ysi, ysj,
          col_fastest);
      break;
    case 2:
      stencil_kernel<T, 2><<<blocks, threads, 0, s>>>(
          Wt, xt, yt, X, Y, k, xsb, xsk, xsi, xsj, ysb, ysk, ysi, ysj,
          col_fastest);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int eigd_stencil_f32(const void* W, const void* x, void* y, int X,
                                int Y, int ndof, int k, int xsb, int xsk,
                                int xsi, int xsj, int ysb, int ysk, int ysi,
                                int ysj, void* stream) {
  return launch<float>(W, x, y, X, Y, ndof, k, xsb, xsk, xsi, xsj, ysb, ysk,
                       ysi, ysj, stream);
}

extern "C" int eigd_stencil_f64(const void* W, const void* x, void* y, int X,
                                int Y, int ndof, int k, int xsb, int xsk,
                                int xsi, int xsj, int ysb, int ysk, int ysi,
                                int ysj, void* stream) {
  return launch<double>(W, x, y, X, Y, ndof, k, xsb, xsk, xsi, xsj, ysb, ysk,
                        ysi, ysj, stream);
}
