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
//                   column shifts), summed in the order (di, b, dj, a).
//   K4 = kern of probe (diag_pallas_dma.py:44, pallas_call :62):
//          out = ((s0 + s1) + s2)[:, :, :Yo] (+ W[0, :, :Yo]).
//
// The TPU kernels cut the rows into TX-row BlockSpec tiles over an XR-row
// padded array and DMA every block of all 36 W planes into VMEM, whether
// the body reads them or not. Here the grid covers any row count R, and
// each kernel reads only the planes its body reads.
//
// What bounds them: memory (at most 2*9*ndof*ndof flops per output node
// and column against 4-byte loads). Two kernels:
//
// rows_kernel: K4 and K3 copy, which is K4's one-slab function on the
// window that starts at column 1. A warp owns one output row (channel c,
// row r), a block 4 rows, and the grid is (row blocks, channels), so no
// thread divides to find its indices. Each lane issues all its loads of a
// pass, up to 20 elements (or 8 16-byte quads) of each stream, before its
// first store: one pass covers a 513- or 640-wide row, with 68-80 bytes of
// loads in flight a lane and stream. The first version gave each thread
// one 4-byte element through per-element 64-bit divisions and reached
// half the bound at most. Rows whose every stream and the output are
// 16-byte aligned (the 640-wide layout) move quads both ways (VEC). Other
// rows start at their own offset mod 16 in each stream, so they load
// elements (coalesced along the row), and store 16-byte quads of the
// output's aligned interior, realigned through a shared-memory row per
// warp, with a scalar head and tail: 4-19% faster than each lane storing
// its elements (PERF.md). Each output is ((s0 + s1) + s2) + W in that
// order, as the twin: results are exact.
//
// taps_kernel: K3 onetap and noshift9. One thread owns a node (r, j) for
// all k columns: it loads the node's W values (nd^2 or 9*nd^2 of them,
// coalesced along j from their planes) into registers once, then loops
// over the columns, CU at a time with all their x loads issued first, and
// writes nd outputs a column. So W is read once a call, as by the TPU
// kernel, whose W block is indexed by the row block alone
// (diag_pallas_floor.py:84, :97) and applied to all k channels. The
// mapping of the first version, one thread per (column, r, j), read all W
// planes k times (about 615 MB a noshift9 call at 1040x513, k 8, against
// 145 MB in the bound). A block owns 128 consecutive nodes of the (R, Y)
// plane, row after row (one 32-bit division a thread finds (r, j)), so
// each W plane and each output channel is read or written in runs of
// 512 bytes; tiles of 8 x 32 and 4 x 64 nodes ran onetap 10-22% slower,
// and 256-node blocks noshift9 3-6% slower (PERF.md). noshift9 loads 4
// columns (24 values at nd 2) before it computes them, onetap 8; 2 and 3
// columns ran noshift9 8-11% slower. noshift9's three slabs are row
// offsets into one buffer: a row of x read by one block is read again by
// the blocks one row before and after, running at the same time, from L2.
// Sums are FMA in the twin's order (di, b, dj, a), with no atomics:
// deterministic.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

enum FloorKind { kCopy = 0, kOneTap = 1, kNoShift9 = 2 };

constexpr int ROW_WARPS = 4;  // rows of one rows_kernel block, a warp each
constexpr int ROW_THREADS = 32 * ROW_WARPS;

// Units (elements, or quads where VEC) one lane holds in one pass.
__host__ __device__ constexpr int per_max(bool vec) { return vec ? 8 : 20; }

// A staging row per warp: a pass's elements plus the shift that aligns
// them with the output (a multiple of 4 floats: every row is 16-byte
// aligned).
constexpr int STAGE = 32 * per_max(false) + 4;

struct Rows {
  const float* s[3];  // slab windows, element strides (ssc, ssr, 1)
  const float* w;     // W's plane-0 window, row stride wsr
  float* out;         // contiguous (C, R, Yo)
  long long ssc, ssr, wsr;
  int R, Yo;
  int per, passes;  // units a lane holds in a pass; passes a row
};

__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <int NSLABS, bool WITH_W, bool VEC>
__global__ void __launch_bounds__(ROW_THREADS) rows_kernel(Rows p) {
  constexpr int PER = per_max(VEC);
  using V = typename std::conditional<VEC, float4, float>::type;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * ROW_WARPS + warp;
  if (r >= p.R) return;
  const int c = blockIdx.y;
  const long long so = c * p.ssc + r * p.ssr;
  const long long orow = (static_cast<long long>(c) * p.R + r) * p.Yo;
  const V* s0 = reinterpret_cast<const V*>(p.s[0] + so);
  const V* s1 = reinterpret_cast<const V*>(p.s[1] + so);
  const V* s2 = reinterpret_cast<const V*>(p.s[2] + so);
  const V* w = reinterpret_cast<const V*>(p.w + r * p.wsr);
  const int n = VEC ? p.Yo / 4 : p.Yo;  // units in the row
  const int span = 32 * p.per;

  for (int base = 0, q = 0; q < p.passes; base += span, ++q) {
    const int lim = min(span, n - base);  // units of this pass
    if (lim <= 0) break;
    V v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = i * 32 + lane;
      if (u < lim) v[i] = __ldg(s0 + base + u);
    }
    if (NSLABS == 3) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int u = i * 32 + lane;
        if (u < lim) v[i] = add(v[i], __ldg(s1 + base + u));
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int u = i * 32 + lane;
        if (u < lim) v[i] = add(v[i], __ldg(s2 + base + u));
      }
    }
    if (WITH_W) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int u = i * 32 + lane;
        if (u < lim) v[i] = add(v[i], __ldg(w + base + u));
      }
    }
    if constexpr (VEC) {
      V* o = reinterpret_cast<V*>(p.out + orow);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int u = i * 32 + lane;
        if (u < lim) o[base + u] = v[i];
      }
    } else {
      // unit u of the pass goes to out element o0 + u; stage it at
      // st[sh + u] with sh = o0 mod 4, so that aligned outputs are
      // aligned staging quads
      __shared__ __align__(16) float stage[ROW_WARPS][STAGE];
      float* st = stage[warp];
      const long long o0 = orow + base;
      const int sh = static_cast<int>(o0 & 3);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int u = i * 32 + lane;
        if (u < lim) st[sh + u] = v[i];
      }
      __syncwarp();
      const int head = min(lim, (4 - sh) & 3);  // units before an aligned out
      const int nq = (lim - head) / 4;
      const int tail = head + 4 * nq;
      float* ob = p.out + o0;
      if (lane < head) ob[lane] = st[sh + lane];
      const float4* sq = reinterpret_cast<const float4*>(st + sh + head);
      float4* oq = reinterpret_cast<float4*>(ob + head);
      for (int i = lane; i < nq; i += 32) oq[i] = sq[i];
      if (lane < lim - tail) ob[tail + lane] = st[sh + tail + lane];
      __syncwarp();  // before the next pass overwrites the row
    }
  }
}

template <int NSLABS, bool WITH_W>
int launch_rows(const Rows& p, int C, bool vec, cudaStream_t s) {
  const dim3 grid((p.R + ROW_WARPS - 1) / ROW_WARPS, C);
  if (vec)
    rows_kernel<NSLABS, WITH_W, true><<<grid, ROW_THREADS, 0, s>>>(p);
  else
    rows_kernel<NSLABS, WITH_W, false><<<grid, ROW_THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Columns a taps_kernel thread loads before it computes them.
template <int KIND>
__host__ __device__ constexpr int taps_cols() {
  return KIND == kOneTap ? 8 : 4;
}

constexpr int TAP_THREADS = 128;  // nodes of a taps_kernel block

template <int KIND, int NDOF>
__global__ void __launch_bounds__(TAP_THREADS)
    taps_kernel(const float* __restrict__ W, const float* __restrict__ xm,
                const float* __restrict__ x0, const float* __restrict__ xp,
                float* __restrict__ out, int k, int R, int Y, long long xsc,
                long long xsr) {
  constexpr int NS = KIND == kOneTap ? 1 : 3;  // slabs (row shifts) read
  constexpr int NT = NS * NS * NDOF * NDOF;    // W planes read
  constexpr int T0 = KIND == kOneTap ? 4 * NDOF * NDOF : 0;  // first plane
  constexpr int CU = taps_cols<KIND>();
  const int nn = blockIdx.x * TAP_THREADS + threadIdx.x;  // node r*Y + j
  if (nn >= R * Y) return;
  const int r = nn / Y, j = nn - r * Y;
  const long long plane = static_cast<long long>(R) * Y;
  const long long node = static_cast<long long>(r) * Y + j;

  // the node's W values, once for all columns
  float w[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) w[t] = W[(T0 + t) * plane + node];

  // column window 1:1+Y of the (Y+2)-wide slabs
  const long long xo = static_cast<long long>(r) * xsr + 1 + j;
  const float* xs[NS];
  if constexpr (NS == 1) {
    xs[0] = x0 + xo;
  } else {
    xs[0] = xm + xo;
    xs[NS / 2] = x0 + xo;
    xs[NS - 1] = xp + xo;
  }
  float* o = out + node;

  for (int c0 = 0; c0 < k; c0 += CU) {
    float xv[CU][NS][NDOF];
#pragma unroll
    for (int cc = 0; cc < CU; ++cc) {
      if (c0 + cc < k) {
#pragma unroll
        for (int di = 0; di < NS; ++di) {
#pragma unroll
          for (int b = 0; b < NDOF; ++b)
            xv[cc][di][b] = xs[di][(b * k + c0 + cc) * xsc];
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < CU; ++cc) {
      if (c0 + cc < k) {
        float acc[NDOF];
#pragma unroll
        for (int a = 0; a < NDOF; ++a) acc[a] = 0.0f;
#pragma unroll
        for (int di = 0; di < NS; ++di) {
#pragma unroll
          for (int b = 0; b < NDOF; ++b) {
#pragma unroll
            for (int dj = 0; dj < NS; ++dj) {
#pragma unroll
              for (int a = 0; a < NDOF; ++a)
                acc[a] = __fmaf_rn(
                    w[((NS * di + dj) * NDOF + a) * NDOF + b], xv[cc][di][b],
                    acc[a]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < NDOF; ++a)
          o[static_cast<long long>(a * k + c0 + cc) * plane] = acc[a];
      }
    }
  }
}

template <int KIND>
int launch_taps(const float* W, const float* xm, const float* x0,
                const float* xp, float* out, int ndof, int k, int R, int Y,
                long long xsc, long long xsr, cudaStream_t s) {
  const unsigned int grid = (R * Y + TAP_THREADS - 1) / TAP_THREADS;
  switch (ndof) {
    case 1:
      taps_kernel<KIND, 1><<<grid, TAP_THREADS, 0, s>>>(W, xm, x0, xp, out, k,
                                                        R, Y, xsc, xsr);
      break;
    case 2:
      taps_kernel<KIND, 2><<<grid, TAP_THREADS, 0, s>>>(W, xm, x0, xp, out, k,
                                                        R, Y, xsc, xsr);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success).
//
// K4 and K3 copy: out (C, R, Yo) contiguous = ((s0 + s1) + s2) over the
// first Yo columns of n_slabs (1 or 3) windows sharing the element strides
// (ssc channel, ssr row, 1 column), + W's plane-0 window (row stride wsr)
// unless W is null. vec: every stream, the output and their strides are
// 16-byte aligned and Yo is a multiple of 4; per: units a lane holds in a
// pass (at most per_max(vec)), passes: passes a row (32 * per * passes
// units cover the row), as the wrapper's plan sets.
extern "C" int eigd_probe_rows(const void* s0, const void* s1, const void* s2,
                               int n_slabs, const void* W, void* out, int C,
                               int R, int Yo, long long ssc, long long ssr,
                               long long wsr, int vec, int per, int passes,
                               void* stream) {
  if (C <= 0 || R <= 0 || Yo <= 0) return 0;
  if (per < 1 || per > per_max(vec) || passes < 1 || C > 65535 ||
      static_cast<long long>(32) * per * passes < (vec ? Yo / 4 : Yo) ||
      (vec && Yo % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Rows p{{static_cast<const float*>(s0), static_cast<const float*>(s1),
          static_cast<const float*>(s2)},
         static_cast<const float*>(W),
         static_cast<float*>(out),
         ssc,
         ssr,
         wsr,
         R,
         Yo,
         per,
         passes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool with_w = W != nullptr;
  if (n_slabs == 1 && !with_w) return launch_rows<1, false>(p, C, vec, s);
  if (n_slabs == 1 && with_w) return launch_rows<1, true>(p, C, vec, s);
  if (n_slabs == 3 && !with_w) return launch_rows<3, false>(p, C, vec, s);
  if (n_slabs == 3 && with_w) return launch_rows<3, true>(p, C, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3 onetap (kind 1) and noshift9 (kind 2): W contiguous (9*ndof*ndof, R,
// Y); xm, x0, xp share the element strides (xsc channel, xsr row, 1
// column) of (ndof*k, R, Y+2) slabs; out contiguous (ndof*k, R, Y).
extern "C" int eigd_probe_taps(int kind, const void* W, const void* xm,
                               const void* x0, const void* xp, void* out,
                               int ndof, int k, int R, int Y, long long xsc,
                               long long xsr, void* stream) {
  if (k <= 0 || R <= 0 || Y <= 0) return 0;
  if (static_cast<long long>(R) * Y + TAP_THREADS > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* w = static_cast<const float*>(W);
  const float* a = static_cast<const float*>(xm);
  const float* b = static_cast<const float*>(x0);
  const float* c = static_cast<const float*>(xp);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kOneTap:
      return launch_taps<kOneTap>(w, a, b, c, o, ndof, k, R, Y, xsc, xsr, s);
    case kNoShift9:
      return launch_taps<kNoShift9>(w, a, b, c, o, ndof, k, R, Y, xsc, xsr,
                                    s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
