// evp_rounds.cu — one k-halo round of the EVP subcycles on a padded block of
// a decomposed grid, on Hopper: tiles with their aprons in shared memory, no
// grid barrier.
//
// Replaces, on the rounds of a decomposed grid (cice4_tpu_torch/ops/
// evp_sharded.py), the TPU kernels cice4_tpu/ops/evp_pallas.py::_kernel
// (:83, the whole-grid kernel, whose doubly cyclic mode a padded block takes)
// and ::_kernel_blocked (:210); the JAX package runs these rounds in plain
// jnp (cice4_tpu/ops/evp_sharded.py:246-338).  It computes what the plain
// version cice4_tpu_torch/ops/evp.py::_evp_rounds_plain computes on the
// whole padded block, doubly cyclic: k gated subcycles, each a stress pass
// (strain rates, the 12 corner stresses, the 8 str8 pieces) and a momentum
// pass (the 2x2 solve from str8 at E, N and NE), no final subcycle and no
// diagnostics; it returns the velocities and the stresses.
//
// Design: temporal blocking.  One ordinary launch a round (or a part of one,
// the wrapper's choice), not cooperative, with no grid barrier and no active
// lists.  A block owns a core tile of rows x cols cells; the tiles cover the
// whole padded block, ghost rings included.  It stages its core plus an
// apron k cells wide on every side, read with the cyclic wrap, in shared
// memory by cp.async: u, v, the 12 stresses and the 20 constants of the
// stress and momentum passes (34 planes, read once a round), the two masks,
// and 8 str8 planes.  It then runs the k subcycles on that region, with
// __syncthreads() in place of the grid barrier between passes.  The stress
// pass reads u, v at W, S and SW and the momentum pass str8 at E, N and NE,
// so each subcycle's region shrinks by one ring: subcycle s computes the
// stresses of rows and columns [s, A - s + 1) and the velocities of
// [s, A - s) of the A-wide apron tile, and after k subcycles the core's
// values are exact.  Since the apron reads wrap, every core cell, ghost
// rings included, gets exactly the plain value: the round stays the same
// function of the whole padded array (tests/test_torch_evp_rounds.py holds
// that tiling on the CPU, and that an apron of k - 1 is not enough).  The
// stress pass writes only its cell's stresses and str8, the momentum pass
// only its point's velocity, so no buffer is doubled.  Threads walk each
// pass's region in row-major order, so a warp reads neighbouring words.
// The results go to tensors apart from the inputs (in place, a block's core
// would overwrite another block's apron).
//
// Gating: a T cell off icetmask keeps zero stresses and str8, a U point off
// iceumask a zero velocity, as per-cell masks; the staging zeroes them there
// (the masked-zero invariant, which the whole-grid kernel's wrapper enforces
// too).  So a core with no active cell comes out all zeros, whatever its
// apron holds: such a tile writes its core's zeros and stops (the TPU
// kernel's skipped blocks).
//
// What bounds it: per SM, the instruction rate of each icy tile (about
// 450 instructions a T cell and subcycle, with IEEE divisions and square
// roots and no FMA, and 120 a U point) over the shrinking regions; the
// recompute share, cells computed over core cells, is the mean of
// (rows + 2m + 1)(cols + 2m + 1) / (rows cols) over m < k for the stress
// pass.  The tile is the fastest one-launch tile measured at gx1's rounds
// on 2x2 blocks on an H100 (PERF.md section 6): 8 x 16 cells, k = 10, 512 threads, 83
// registers and no spill in f32, 1008 cells staged (7.9 a core cell) and
// 3.9 (stress) and 3.6 (momentum) computed a core cell and subcycle.
// Other cores from 8 x 8 to 16 x 32 ran 2-49% slower there
// (tools/time_round_tiles.py): the recompute, and the SMs left idle by
// ice-free tiles, set the time (two launches of 5 subcycles take 13% less
// device time, and a launch's host time more a round).
// Shared memory: (rows + 2k)(cols + 2k) cells x (42 words + 2 bytes),
// 171,360 bytes at 8 x 16 and k = 10 in f32, so one block an SM; the
// wrapper splits a round whose apron does not fit (f64 at k > 7) into
// launches of fewer subcycles (the arithmetic is unchanged).
//
// Arithmetic follows the plain version expression by expression, in the same
// order (evp_cell.cuh, shared with evp_subcycle.cu); the source is built with
// -fmad=false, so no a*b+c is contracted.
//
// C interface: evp_rounds_f32 / evp_rounds_f64 take a table of 32 pointers
// (the 10 geometry planes cyp, cxp, cym, cxm, dxt, dyt, dxhy, dyhx,
// tinyarea, uarear; strength, icetmask, iceumask, aiu, uocn, vocn, waterx,
// watery, forcex, forcey, umassdtei, fm; the inputs uvel, vvel, stressp,
// stressm, stress12; the outputs in the same order), the block size ny, nx,
// the core tile rows x cols, the subcycles k, a table of 9 double
// parameters, flags (bit 0 evp_damping, bit 1 hemi_turning) and the CUDA
// stream; they return the launch's error code (cudaErrorInvalidValue for a
// tile whose apron does not fit a block's shared memory).
// evp_rounds_occupancy gives what the runtime reports of the kernel at a
// tile (rows, cols, k, element bytes), and its shared-memory bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "evp_cell.cuh"

namespace {

// shared-memory planes of the apron tile: the round's state (u, v, the 12
// stresses; also the output planes), the constants, then str8
enum Plane { U = 0, V = 1, SP = 2, SM = 6, S12 = 10, GEO = 14, CON = 24,
             STR8 = 34 };
constexpr int kStates = 14;   // u, v and the 12 stresses
constexpr int kStaged = 34;   // the state and the 20 constants
constexpr int kPlanes = 42;   // and the 8 str8 pieces
constexpr int64_t kMaxSmem = 232448;  // bytes a block may use on Hopper

// pointer-table layout (cice4_tpu_torch/ops/evp_cuda.py)
enum Ptr { GEOM = 0, STRENGTH = 10, ICET = 11, ICEU = 12, AIU = 13,
           IN = 22, OUT = 27, kNumPtr = 32 };

template <typename T>
struct Block {
  static constexpr int threads = sizeof(T) == 4 ? 512 : 256;
};

template <typename T>
struct RoundArgs {
  const T* src[kStaged];       // each staged plane's source
  const unsigned char* icet;
  const unsigned char* iceu;
  T* dst[kStates];             // each state plane's output
  int ny, nx, rows, cols, k;
  evp::Params<T> p;
};

int64_t tile_bytes(int rows, int cols, int k, int64_t elem) {
  const int64_t n = static_cast<int64_t>(rows + 2 * k) * (cols + 2 * k);
  return n * (kPlanes * elem + 2);
}

// an asynchronous copy of one element from device to shared memory
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  }
}

__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ int wrap(int x, int n) {
  x %= n;
  return x < 0 ? x + n : x;
}

template <typename T>
__global__ void __launch_bounds__(Block<T>::threads, 1)
    evp_round_tiles(const RoundArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = a.k, AW = a.cols + 2 * K, AH = a.rows + 2 * K;
  const int n = AW * AH;
  T* const sm = reinterpret_cast<T*>(smem_raw);
  auto plane = [&](int p) { return sm + static_cast<int64_t>(p) * n; };
  unsigned char* const icet =
      reinterpret_cast<unsigned char*>(sm + static_cast<int64_t>(kPlanes) * n);
  unsigned char* const iceu = icet + n;
  const int y0 = blockIdx.y * a.rows, x0 = blockIdx.x * a.cols;
  const int tid = threadIdx.x, nt = blockDim.x;
  // the block's cell of apron-tile cell c, the wrap applied
  auto source = [&](int c) {
    const int r = c / AW, q = c - r * AW;
    return static_cast<int64_t>(wrap(y0 - K + r, a.ny)) * a.nx +
           wrap(x0 - K + q, a.nx);
  };

  // --- the masks; a tile whose core has no active cell writes zeros ------
  int any = 0;
  for (int c = tid; c < n; c += nt) {
    const int64_t g = source(c);
    const unsigned char t = a.icet[g], u = a.iceu[g];
    icet[c] = t;
    iceu[c] = u;
    const int r = c / AW - K, q = c - (r + K) * AW - K;
    if (r >= 0 && r < a.rows && q >= 0 && q < a.cols && y0 + r < a.ny &&
        x0 + q < a.nx)
      any |= t | u;
  }
  if (!__syncthreads_or(any)) {
    for (int c = tid; c < a.rows * a.cols; c += nt) {
      const int r = c / a.cols, q = c - r * a.cols;
      if (y0 + r >= a.ny || x0 + q >= a.nx) continue;
      const int64_t g = static_cast<int64_t>(y0 + r) * a.nx + x0 + q;
#pragma unroll
      for (int p = 0; p < kStates; ++p) a.dst[p][g] = T(0);
    }
    return;
  }

  // --- stage the state and the constants; mask the state, zero str8 ------
  for (int c = tid; c < n; c += nt) {
    const int64_t g = source(c);
#pragma unroll
    for (int p = 0; p < kStaged; ++p) copy_async(plane(p) + c, a.src[p] + g);
  }
  copies_landed();
  for (int c = tid; c < n; c += nt) {  // the cells this thread staged
    if (!iceu[c]) {
      plane(U)[c] = T(0);
      plane(V)[c] = T(0);
    }
    if (!icet[c]) {
#pragma unroll
      for (int p = SP; p < kStates; ++p) plane(p)[c] = T(0);
    }
#pragma unroll
    for (int p = STR8; p < kPlanes; ++p) plane(p)[c] = T(0);
  }
  __syncthreads();

  // --- k subcycles on shrinking regions ------------------------------------
  T* const u = plane(U);
  T* const v = plane(V);
  for (int s = 1; s <= K; ++s) {
    // stress pass: rows and columns [s, A - s + 1)
    const int ws = AW - 2 * s + 1, hs = AH - 2 * s + 1;
    for (int i = tid; i < ws * hs; i += nt) {
      const int dr = i / ws;
      const int c = (s + dr) * AW + s + (i - dr * ws);
      if (!icet[c]) continue;
      const evp::CellGeom<T> g{plane(GEO)[c],     plane(GEO + 1)[c],
                               plane(GEO + 2)[c], plane(GEO + 3)[c],
                               plane(GEO + 4)[c], plane(GEO + 5)[c],
                               plane(GEO + 6)[c], plane(GEO + 7)[c],
                               plane(GEO + 8)[c], plane(GEO + 9)[c]};
      T sp[4], smm[4], s12[4], str[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sp[k] = plane(SP + k)[c];
        smm[k] = plane(SM + k)[c];
        s12[k] = plane(S12 + k)[c];
      }
      evp::stress_cell<T, false>(a.p, g, u[c], u[c - 1], u[c - AW],
                                 u[c - AW - 1], v[c], v[c - 1], v[c - AW],
                                 v[c - AW - 1], true, sp, smm, s12, str,
                                 nullptr);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        plane(SP + k)[c] = sp[k];
        plane(SM + k)[c] = smm[k];
        plane(S12 + k)[c] = s12[k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) plane(STR8 + k)[c] = str[k];
    }
    __syncthreads();
    // momentum pass: rows and columns [s, A - s)
    const int wm = AW - 2 * s, hm = AH - 2 * s;
    for (int i = tid; i < wm * hm; i += nt) {
      const int dr = i / wm;
      const int c = (s + dr) * AW + s + (i - dr * wm);
      if (!iceu[c]) continue;
      const evp::PointConst<T> q{plane(CON)[c],     plane(CON + 1)[c],
                                 plane(CON + 2)[c], plane(CON + 3)[c],
                                 plane(CON + 4)[c], plane(CON + 5)[c],
                                 plane(CON + 6)[c], plane(CON + 7)[c],
                                 plane(CON + 8)[c], plane(CON + 9)[c]};
      T uu = u[c], vv = v[c];
      evp::momentum_point<T, false>(
          a.p, q, uu, vv, plane(STR8)[c], plane(STR8 + 1)[c + 1],
          plane(STR8 + 2)[c + AW], plane(STR8 + 3)[c + AW + 1],
          plane(STR8 + 4)[c], plane(STR8 + 5)[c + AW],
          plane(STR8 + 6)[c + 1], plane(STR8 + 7)[c + AW + 1], nullptr);
      u[c] = uu;
      v[c] = vv;
    }
    __syncthreads();
  }

  // --- the core's state out -----------------------------------------------
  for (int c = tid; c < a.rows * a.cols; c += nt) {
    const int r = c / a.cols, q = c - r * a.cols;
    if (y0 + r >= a.ny || x0 + q >= a.nx) continue;
    const int64_t g = static_cast<int64_t>(y0 + r) * a.nx + x0 + q;
    const int t = (r + K) * AW + q + K;
#pragma unroll
    for (int p = 0; p < kStates; ++p) a.dst[p][g] = plane(p)[t];
  }
}

template <typename T>
int run(const int64_t* ptrs, int ny, int nx, int rows, int cols, int k,
        const double* par, int flags, cudaStream_t stream) {
  if (ny < 1 || nx < 1 || rows < 1 || cols < 1 || k < 1 ||
      static_cast<int64_t>(ny) * nx >= static_cast<int64_t>(1) << 30 ||
      (flags & ~3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = tile_bytes(rows, cols, k, sizeof(T));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t np = static_cast<int64_t>(ny) * nx;
  auto in = [&](int i) { return reinterpret_cast<const T*>(ptrs[i]); };
  auto out = [&](int i) { return reinterpret_cast<T*>(ptrs[i]); };
  RoundArgs<T> a;
  // the state planes: u, v, then each stress tensor's 4 corners
  a.src[U] = in(IN);
  a.src[V] = in(IN + 1);
  a.dst[U] = out(OUT);
  a.dst[V] = out(OUT + 1);
  for (int s = 0; s < 3; ++s)
    for (int c = 0; c < 4; ++c) {
      a.src[SP + 4 * s + c] = in(IN + 2 + s) + c * np;
      a.dst[SP + 4 * s + c] = out(OUT + 2 + s) + c * np;
    }
  // cyp .. tinyarea and strength; aiu .. fm and uarear
  for (int g = 0; g < 9; ++g) a.src[GEO + g] = in(GEOM + g);
  a.src[GEO + 9] = in(STRENGTH);
  for (int c = 0; c < 9; ++c) a.src[CON + c] = in(AIU + c);
  a.src[CON + 9] = in(GEOM + 9);
  a.icet = reinterpret_cast<const unsigned char*>(ptrs[ICET]);
  a.iceu = reinterpret_cast<const unsigned char*>(ptrs[ICEU]);
  a.ny = ny;
  a.nx = nx;
  a.rows = rows;
  a.cols = cols;
  a.k = k;
  a.p = evp::make_params<T>(par, flags);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        evp_round_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((nx + cols - 1) / cols, (ny + rows - 1) / rows);
  const int threads = Block<T>::threads;
  const size_t bytes = static_cast<size_t>(smem);
  evp_round_tiles<T><<<grid, threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int rows, int cols, int k, int* out) {
  const int64_t smem = tile_bytes(rows, cols, k, sizeof(T));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  out[1] = Block<T>::threads;
  out[4] = static_cast<int>(smem);
  cudaError_t e =
      smem > 48 * 1024
          ? cudaFuncSetAttribute(evp_round_tiles<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem))
          : cudaSuccess;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], evp_round_tiles<T>, out[1], smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, evp_round_tiles<T>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

extern "C" {

int evp_rounds_f32(const int64_t* ptrs, int ny, int nx, int rows, int cols,
                   int k, const double* par, int flags, void* stream) {
  return run<float>(ptrs, ny, nx, rows, cols, k, par, flags,
                    static_cast<cudaStream_t>(stream));
}

int evp_rounds_f64(const int64_t* ptrs, int ny, int nx, int rows, int cols,
                   int k, const double* par, int flags, void* stream) {
  return run<double>(ptrs, ny, nx, rows, cols, k, par, flags,
                     static_cast<cudaStream_t>(stream));
}

// what the runtime reports of the kernel of `elem` bytes with a rows x
// cols tile and k subcycles on the current device: in out[0..4] its blocks
// resident an SM, threads per block, registers a thread, local (stack and
// spill) bytes a thread and shared-memory bytes a block; returns the
// runtime's error code (cudaErrorInvalidValue for a tile that does not fit)
int evp_rounds_occupancy(int rows, int cols, int k, int elem, int* out) {
  return elem == 4 ? occupancy<float>(rows, cols, k, out)
                   : occupancy<double>(rows, cols, k, out);
}

}  // extern "C"
