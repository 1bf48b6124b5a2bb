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
//        as K1 instantiated for double: no split, no (s, c) pair.
//
// Layouts. W is the plane stencil (9*ndof*ndof, X, Y), contiguous, plane
// t = (3*(di+1) + (dj+1))*ndof*ndof + a*ndof + b. x and y are addressed
// through element strides (b, column, i, j), so one kernel reads both the
// (ndof, k, X, Y) plane layout of the V-cycle and the (X, Y, ndof, k)
// vector layout of the solvers in place, without a transpose.
//
// What bounds it: memory. A call must read the 9*ndof^2 W planes once and
// x once and write y once, (9*ndof^2 + 2*ndof*k) values a node, for
// 2*9*ndof^2*k flops a node: under one flop a byte in f32 and f64 alike.
//
// The previous mapping, one thread per (column, i, j), read a node's W
// values once per column: all 9*ndof^2 W planes k times a call (about
// 606 MB at 1025x513, k 8 in f32, where the bound counts 143 MB), and the
// nine neighbour reads of x per tap went through L1/L2 with no reuse plan.
//
// This design. A block owns a tile of TX x TY output nodes (8 rows of 32
// j, one warp a row), one thread a node. Each thread loads its node's
// 9*ndof^2 W values once, coalesced along j from the planes, keeps them in
// registers and loops over the block's columns, so W is read once a call.
// x goes through shared memory: for each chunk of columns the block
// copies the (TX+2) x (TY+2) x ndof halo tile of each column with
// cp.async, zero-filled outside the grid (the taps need no edge
// branches), double-buffered when a block has more than one chunk, so
// that the next chunk is in flight while this one computes. The copy is
// coalesced in both layouts: lanes along j where x's j stride is 1 (the
// plane layout, read in chunks of 4 columns), lanes along the columns
// otherwise (the vector layout, whose tile rows are contiguous runs of
// (j, b, column)). In the vector layout a block takes all its columns in
// one chunk where shared memory allows: chunks of a few columns would
// read and write each node's run of columns in 32-byte pieces far apart
// in time: a first version of this kernel that did ran K2 at k 16 1.8x
// slower than the previous kernel (H100 SXM, 700 W). y: in the plane
// layout, and in the vector layout at k 1, each thread writes its node's
// outputs, coalesced along j; in the vector layout at k > 1 the block
// stages 32 bytes of columns per (node, output) in shared memory and
// writes them with lanes along the columns (2x faster than each thread
// writing its own strided run, K2 at k 16 on an H100). When a grid has
// too few tiles to fill the card, the wrapper splits the columns over
// blockIdx.y (cols_per_group); each group then reads W again, from L2 at
// those grid sizes.
//
// Each output is a fixed-order FMA sum over (di, dj, b), the previous
// kernel's order, with no atomics: results are deterministic, and the zero
// halo adds exact zeros.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 8;   // tile rows (i)
constexpr int TY = 32;  // tile columns (j): one warp a row
constexpr int THREADS = TX * TY;
constexpr int HX = TX + 2;  // halo tile
constexpr int HY = TY + 2;
constexpr int SP = THREADS + 2;  // pitch of a staged y row (no bank conflict)
constexpr int MAX_SHARED = 232448;  // 227 KB, the most a block can have

// One column's halo tile: ndof planes of HX x HY values, padded to an odd
// count so that the columns of a chunk start in different banks.
template <int NDOF>
__host__ __device__ constexpr int slab() {
  return NDOF * HX * HY + 1;
}

// Columns of one staged y pass: 32 bytes, a sector, of each (node, a) run.
template <typename T>
__host__ __device__ constexpr int stage_cols() {
  return 32 / static_cast<int>(sizeof(T));
}

// cp.async of one element; src_bytes 0 fills the element with zeros.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool ok) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  const int n = ok ? static_cast<int>(sizeof(T)) : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)), "r"(n));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// log2 of the lanes given to a run of n columns: a power of two, <= 32
__device__ __forceinline__ int lanes_log2(int n) {
  return n <= 1 ? 0 : min(5, 32 - __clz(n - 1));
}

struct Strides {
  int b, k, i, j;
};

// Copy the halo tiles of columns [c0, c1) of the tile at (i0, j0) into s
// (column c0 + c at s + c * slab), zero outside the grid.
template <typename T, int NDOF>
__device__ __forceinline__ void load_chunk(T* s, const T* __restrict__ x,
                                           int c0, int c1, int i0, int j0,
                                           int X, int Y, Strides xs) {
  constexpr int SLAB = slab<NDOF>();
  constexpr int PLANE = HX * HY;
  if (xs.j == 1) {
    // lanes along j: one tile row (c, b, ii) per warp pass
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int rows = (c1 - c0) * NDOF * HX;
    for (int r = warp; r < rows; r += THREADS / 32) {
      const int ii = r % HX;
      const int b = (r / HX) % NDOF;
      const int c = r / (HX * NDOF);
      const int gi = i0 - 1 + ii;
      const bool row_ok = gi >= 0 && gi < X;
      const long long base = static_cast<long long>(c0 + c) * xs.k +
                             static_cast<long long>(b) * xs.b +
                             static_cast<long long>(gi) * xs.i;
      T* dst = s + c * SLAB + b * PLANE + ii * HY;
      for (int jj = lane; jj < HY; jj += 32) {
        const int gj = j0 - 1 + jj;
        const bool ok = row_ok && gj >= 0 && gj < Y;
        copy_async(dst + jj, ok ? x + (base + gj) : x, ok);
      }
    }
  } else {
    // lanes along the columns, 2^lg lanes a (node, b) run
    const int n = c1 - c0;
    const int lg = lanes_log2(n);
    const int total = (NDOF * PLANE) << lg;
    for (int cc = 0; cc < n; cc += 1 << lg) {
      for (int e = threadIdx.x; e < total; e += THREADS) {
        const int c = cc + (e & ((1 << lg) - 1));
        if (c >= n) continue;
        const int seg = e >> lg;
        const int b = seg % NDOF;
        const int node = seg / NDOF;
        const int ii = node / HY, jj = node % HY;
        const int gi = i0 - 1 + ii, gj = j0 - 1 + jj;
        const bool ok = gi >= 0 && gi < X && gj >= 0 && gj < Y;
        const long long off = static_cast<long long>(c0 + c) * xs.k +
                              static_cast<long long>(b) * xs.b +
                              static_cast<long long>(gi) * xs.i +
                              static_cast<long long>(gj) * xs.j;
        copy_async(s + c * SLAB + b * PLANE + ii * HY + jj,
                   ok ? x + off : x, ok);
      }
    }
  }
}

// One output column of the thread's node from its halo tile s (centred on
// the node): the sum over (di, dj, b) in that order.
template <typename T, int NDOF>
__device__ __forceinline__ void column(const T* s,
                                       const T (&w)[9 * NDOF * NDOF],
                                       T (&acc)[NDOF]) {
  constexpr int PLANE = HX * HY;
#pragma unroll
  for (int a = 0; a < NDOF; ++a) acc[a] = T(0);
#pragma unroll
  for (int di = 0; di < 3; ++di) {
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
      for (int b = 0; b < NDOF; ++b) {
        const T xv = s[b * PLANE + di * HY + dj];
#pragma unroll
        for (int a = 0; a < NDOF; ++a)
          acc[a] = fmadd(w[((3 * di + dj) * NDOF + a) * NDOF + b], xv, acc[a]);
      }
    }
  }
}

// Write n staged columns (column c of output a of node nl at
// st[(c * NDOF + a) * SP + nl]) to y from column c0 on, lanes along the
// columns: a run of n contiguous values per (node, a) in the vector layout.
template <typename T, int NDOF>
__device__ __forceinline__ void store_staged(T* __restrict__ y, const T* st,
                                             int c0, int n, int i0, int j0,
                                             int X, int Y, Strides ys) {
  const int lg = lanes_log2(n);
  const int total = (NDOF * THREADS) << lg;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int c = e & ((1 << lg) - 1);
    if (c >= n) continue;
    const int seg = e >> lg;
    const int a = seg % NDOF, nl = seg / NDOF;
    const int gi = i0 + nl / TY, gj = j0 + nl % TY;
    if (gi < X && gj < Y)
      y[static_cast<long long>(c0 + c) * ys.k +
        static_cast<long long>(a) * ys.b + static_cast<long long>(gi) * ys.i +
        static_cast<long long>(gj) * ys.j] = st[(c * NDOF + a) * SP + nl];
  }
}

// Block (t, g): node tile t for columns [g * cols_per_group, ...), in
// chunks of cols_per_chunk columns (double-buffered when a group has more
// than one chunk). y goes out directly where its j stride is at most
// ndof (each thread's outputs are then contiguous with its neighbours'),
// else through the staging rows after the chunk buffers.
template <typename T, int NDOF>
__global__ void __launch_bounds__(THREADS)
    stencil_kernel(const T* __restrict__ W, const T* __restrict__ x,
                   T* __restrict__ y, int X, int Y, int k, Strides xs,
                   Strides ys, int cols_per_group, int cols_per_chunk,
                   int tiles_j) {
  constexpr int NW = 9 * NDOF * NDOF;
  constexpr int SLAB = slab<NDOF>();
  constexpr int KS = stage_cols<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc = cols_per_chunk;
  T* const buf0 = reinterpret_cast<T*>(smem);
  T* const buf1 = buf0 + kc * SLAB;
  T* const st = buf0 + (cols_per_group > kc ? 2 : 1) * kc * SLAB;
  const bool staged = ys.j > NDOF;

  const int i0 = (blockIdx.x / tiles_j) * TX;
  const int j0 = (blockIdx.x % tiles_j) * TY;
  const int ty = threadIdx.x / TY, tx = threadIdx.x % TY;
  const int i = i0 + ty, j = j0 + tx;
  const bool mine = i < X && j < Y;
  const int cbeg = blockIdx.y * cols_per_group;
  const int cend = min(k, cbeg + cols_per_group);

  load_chunk<T, NDOF>(buf0, x, cbeg, min(cend, cbeg + kc), i0, j0, X, Y, xs);
  copy_commit();

  // the node's W values, once for all columns
  T w[NW];
  const long long plane = static_cast<long long>(X) * Y;
  const long long node = static_cast<long long>(i) * Y + j;
#pragma unroll
  for (int t = 0; t < NW; ++t) w[t] = mine ? W[t * plane + node] : T(0);

  for (int c0 = cbeg, q = 0; c0 < cend; c0 += kc, ++q) {
    T* const cur = (q & 1) ? buf1 : buf0;
    if (c0 + kc < cend) {
      load_chunk<T, NDOF>((q & 1) ? buf0 : buf1, x, c0 + kc,
                          min(cend, c0 + 2 * kc), i0, j0, X, Y, xs);
      copy_commit();
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const T* s = cur + ty * HY + tx;
    const int nc = min(kc, cend - c0);
    if (staged) {
      for (int cs = 0; cs < nc; cs += KS) {
        const int ns = min(KS, nc - cs);
        if (mine) {
#pragma unroll
          for (int c = 0; c < KS; ++c) {
            if (c < ns) {
              T acc[NDOF];
              column<T, NDOF>(s + (cs + c) * SLAB, w, acc);
#pragma unroll
              for (int a = 0; a < NDOF; ++a)
                st[(c * NDOF + a) * SP + threadIdx.x] = acc[a];
            }
          }
        }
        __syncthreads();
        store_staged<T, NDOF>(y, st, c0 + cs, ns, i0, j0, X, Y, ys);
        __syncthreads();
      }
    } else if (mine) {
      for (int c = 0; c < nc; ++c) {
        T acc[NDOF];
        column<T, NDOF>(s + c * SLAB, w, acc);
        const long long yo = static_cast<long long>(c0 + c) * ys.k +
                             static_cast<long long>(i) * ys.i +
                             static_cast<long long>(j) * ys.j;
#pragma unroll
        for (int a = 0; a < NDOF; ++a)
          y[yo + static_cast<long long>(a) * ys.b] = acc[a];
      }
    }
    __syncthreads();  // before the next pass overwrites this buffer
  }
}

template <typename T, int NDOF>
int launch_nd(const T* W, const T* x, T* y, int X, int Y, int k, Strides xs,
              Strides ys, int cols_per_group, int cols_per_chunk,
              cudaStream_t s) {
  static bool opted_in = false;  // dynamic shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        stencil_kernel<T, NDOF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SHARED);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int nbuf = cols_per_group > cols_per_chunk ? 2 : 1;
  const long long shared =
      (static_cast<long long>(nbuf) * cols_per_chunk * slab<NDOF>() +
       (ys.j > NDOF ? stage_cols<T>() * NDOF * SP : 0)) *
      static_cast<long long>(sizeof(T));
  if (shared > MAX_SHARED) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_j = (Y + TY - 1) / TY;
  const dim3 grid(((X + TX - 1) / TX) * tiles_j,
                  (k + cols_per_group - 1) / cols_per_group);
  stencil_kernel<T, NDOF><<<grid, THREADS, static_cast<size_t>(shared), s>>>(
      W, x, y, X, Y, k, xs, ys, cols_per_group, cols_per_chunk, tiles_j);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* W, const void* x, void* y, int X, int Y, int ndof,
           int k, int xsb, int xsk, int xsi, int xsj, int ysb, int ysk,
           int ysi, int ysj, int cols_per_group, int cols_per_chunk,
           void* stream) {
  if (X <= 0 || Y <= 0 || k <= 0) return 0;
  if (cols_per_group < 1 || cols_per_chunk < 1 ||
      (k + cols_per_group - 1) / cols_per_group > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* Wt = static_cast<const T*>(W);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const Strides xs{xsb, xsk, xsi, xsj}, ys{ysb, ysk, ysi, ysj};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ndof) {
    case 1:
      return launch_nd<T, 1>(Wt, xt, yt, X, Y, k, xs, ys, cols_per_group,
                             cols_per_chunk, s);
    case 2:
      return launch_nd<T, 2>(Wt, xt, yt, X, Y, k, xs, ys, cols_per_group,
                             cols_per_chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success). cols_per_group: columns of one
// blockIdx.y group; cols_per_chunk: columns of one shared-memory chunk
// (the wrapper's launch_plan).
extern "C" int eigd_stencil_f32(const void* W, const void* x, void* y, int X,
                                int Y, int ndof, int k, int xsb, int xsk,
                                int xsi, int xsj, int ysb, int ysk, int ysi,
                                int ysj, int cols_per_group,
                                int cols_per_chunk, void* stream) {
  return launch<float>(W, x, y, X, Y, ndof, k, xsb, xsk, xsi, xsj, ysb, ysk,
                       ysi, ysj, cols_per_group, cols_per_chunk, stream);
}

extern "C" int eigd_stencil_f64(const void* W, const void* x, void* y, int X,
                                int Y, int ndof, int k, int xsb, int xsk,
                                int xsi, int xsj, int ysb, int ysk, int ysi,
                                int ysj, int cols_per_group,
                                int cols_per_chunk, void* stream) {
  return launch<double>(W, x, y, X, Y, ndof, k, xsb, xsk, xsi, xsj, ysb, ysk,
                        ysi, ysj, cols_per_group, cols_per_chunk, stream);
}
