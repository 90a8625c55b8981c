// evp_subcycle.cu — the EVP subcycle loop (stress relaxation + momentum
// solve, ndte times) on Hopper.
//
// Replaces the TPU kernels cice4_tpu/ops/evp_pallas.py::_kernel_blocked
// (:210-334; host code _evp_pallas_blocked :374-440), taken on grids that are
// closed or open north-south, and ::_kernel (:83-144; host code
// _evp_pallas_wholegrid :443-486), the whole-grid kernel taken on grids that
// are cyclic north-south.  On the GPU one kernel serves both: the per-cell
// gating below is exact on any boundary, so the whole-grid kernel is this
// one with the NS wrap of its neighbour reads (NS code 0).  It computes
// what the plain version cice4_tpu_torch/ops/evp.py::_evp_subcycle_plain
// computes:
// per subcycle, the corner strain rates from the old velocities, the
// relaxation of the 12 corner stresses and the 8 str8 flux pieces
// (_stress_relax, _str8_from_stress), then the 2x2 implicit momentum solve
// from the fresh str8 of the point and its E, N and NE neighbours (_stepu).
// That is the Jacobi update which the TPU kernel's north-to-south block order
// also realises.
//
// Design.  One persistent cooperative launch per call, one block per SM
// (512 threads in f32, 256 in f64: as many as the registers allow), so
// that cooperative_groups' grid.sync() is a grid-wide barrier and spans as
// few blocks as possible:
//  * phase 0 zeroes str8 and builds the active lists, the reference's
//    icellt/icellu: the flat indices of the icetmask T cells and of the
//    iceumask U points, in grid order (per-block counts, a barrier, each
//    block's offset from the counts before it, a block-wide rank);
//  * the resident thread of rank g owns T cell tlist[g] and U point
//    ulist[g], ranks running over the warps of all blocks in turn, so the
//    icy cells, which at gx1 lie in two polar caps, spread evenly over
//    every SM, 32 neighbouring cells to a warp.  It keeps its cell's 12
//    stresses, geometry and strength and its point's 9 momentum constants,
//    uarear and velocity in registers for all ndte subcycles; entries beyond
//    the resident threads (g + k * R, k >= 1) keep their state in device
//    memory (the overflow path);
//  * each of the ndte - 1 gated subcycles is a stress pass, a grid barrier,
//    a momentum pass and a grid barrier.  Only u, v (read at W, S, SW) and
//    str8 (read at E, N, NE and at the point itself) cross between threads,
//    through device memory that stays in L2;
//  * the final subcycle covers every cell: the owners finish their icy
//    cells and a grid-stride loop the others (stresses and str8 zero, the
//    strain sums and prs_sig of every T cell; zero u, v, strint and strocn
//    off iceumask), with one more barrier between its two passes.
// Barriers per call: 2 (phase 0) + 2 (ndte - 1) + 1 = 2 ndte + 1.
// The stress pass reads velocities and writes only same-cell stresses and
// str8, the momentum pass reads str8 and writes only same-point velocities,
// so no double buffer is needed.  A launch that cannot be co-resident is
// refused by the runtime and its error returned.  (The k-halo rounds of a
// decomposed grid have a kernel of their own, evp_rounds.cu.)
//
// Activity gating: a T cell outside icetmask keeps zero stresses and str8,
// and a U point outside iceumask zero velocities (the reference's
// icellt/icellu lists, the TPU kernel's skipped blocks).  This is exact
// given the masked-zero invariant (stresses zero off icetmask, velocities
// zero off iceumask, str8 zeroed in phase 0), which the wrapper enforces.
//
// Boundaries: EW and NS cyclic wrap (the corner read (j-1, i-1) wraps on both
// axes), EW and NS open/closed read 0 beyond the edge (evp_pallas.py
// KernelNbr).  The tripole and tripoleT folds (NS only; the JAX package
// runs them in plain jnp, cice4_tpu/ops/evp.py:127-159) cross the fold in one
// place: velocities are read at W, S and SW and the south edge is closed, so
// only the momentum pass's str8 reads at N and NE of the top row reach beyond
// the north edge.  There they read the mirror cell's paired piece, negated
// (_STR8_PAIR: N takes piece 1 for 2 and 6 for 5 at (src, nx-1-i), NE piece 0
// for 3 and 4 for 7 at (src, (nx-2-i) mod nx), src = ny-1 on the U-fold grid,
// ny-2 on the T-fold one), and the NE read of the other rows wraps east-west
// whatever the EW boundary, as cice4_tpu_torch/parallel/halo.py::Nbr.ne_str
// does.  The U-fold symmetrization of the top row of U points happens in
// ops/evp.py before the call.
//
// What bounds it on an H100: latency.  A gated subcycle does ~400
// operations and ~20 device-memory accesses (L2 hits) per active cell,
// about 14 M operations at gx1, well under a microsecond of the card's
// arithmetic; but each pass over fewer than one cell per thread is a chain
// of L2 round trips and dependent arithmetic (two divisions and a square
// root per corner), and each grid barrier a round of atomics and fences
// through L2.  So the time is ~ndte x (two barriers + two short passes),
// not bytes or operations.  A call on a grid without ice runs the barriers,
// the lists and the final subcycle alone (chip_smoke.py times it).
//
// Arithmetic follows the plain version expression by expression, in the same
// order (evp_cell.cuh, shared with evp_rounds.cu); the source is built with
// -fmad=false so that no a*b+c is contracted.
//
// C interface: evp_subcycle_f32 / evp_subcycle_f64 take a table of 38
// pointers (the last an int32 scratch of 2 x blocks + 5 + 2 x ny x nx
// entries, blocks as evp_subcycle_resident gives them), the grid size, the
// EW boundary (1 = cyclic), the NS boundary (0 = cyclic, 1 = open or closed,
// 2 = tripole, 3 = tripoleT), a table of 9 double parameters, ndte,
// flags (bit 0 evp_damping, bit 1 hemi_turning) and the CUDA stream; they
// return the launch's error code.  The kernel leaves in scratch[2 x blocks
// ...] what it ran: its active T cells and U points, the grid barriers it
// passed, its blocks and threads per block.
// evp_subcycle_resident_f32 / _f64 (blocks, threads per block) give the
// cooperative grid the call launches on the current device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "evp_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 16;
// what a call reports after its block counts in the scratch: active T
// cells, active U points, grid barriers passed, blocks, threads per block
constexpr int kStats = 5;

// pointer-table layout (cice4_tpu_torch/ops/evp_cuda.py)
enum Ptr {
  CYP, CXP, CYM, CXM, DXT, DYT, DXHY, DYHX, TINYAREA, UAREAR,
  STRENGTH, ICET, ICEU, AIU, UOCN, VOCN, WATERX, WATERY, FORCEX, FORCEY,
  UMASSDTEI, FM,
  UVEL, VVEL, STRESSP, STRESSM, STRESS12, STR8,
  STRINTX, STRINTY, STROCNX, STROCNY, DIVSUM, DELTASUM, TENSUM, SHRSUM,
  PRSSIG, SCRATCH, kNumPtr
};

template <typename T>
struct Args {
  const T* geom[10];
  const T* strength;
  const bool* icet;
  const bool* iceu;
  const T* c[9];  // aiu, uocn, vocn, waterx, watery, forcex, forcey,
                  // umassdtei, fm
  T* u;
  T* v;
  T* sp;
  T* sm;
  T* s12;
  T* str8;
  T* out[9];
  int* scratch;  // block counts (2 x blocks), kStats, tlist, ulist (np)
  int ny, nx, ew_cyclic, ns_cyclic, ndte;
  evp::Params<T> p;
  int fold;  // 0, or the NS code of a fold: 2 tripole, 3 tripoleT
};

// one block per SM: 512 threads of up to 128 registers in f32, 256 threads
// of up to 255 in f64; fewer, larger blocks make each grid barrier cheaper
template <typename T>
struct Launch {
  static constexpr int threads = sizeof(T) == 4 ? 512 : 256;
};

// value of f at (j, i) with the boundary rules: a cyclic axis wraps, an open
// or closed one reads 0 beyond its edge
template <typename T>
__device__ __forceinline__ T at(const T* f, int j, int i, const Args<T>& a) {
  if (j < 0 || j >= a.ny) {
    if (!a.ns_cyclic) return T(0);
    j = (j + a.ny) % a.ny;
  }
  if (i < 0 || i >= a.nx) {
    if (!a.ew_cyclic) return T(0);
    i = (i + a.nx) % a.nx;
  }
  return f[(int64_t)j * a.nx + i];
}

// a T cell's per-call constants and its 12 corner stresses
template <typename T>
struct Cell {
  int c, j, i;
  evp::CellGeom<T> g;
  T sp[4], sm[4], s12[4];
};

// a U point's per-call constants and its velocity
template <typename T>
struct Point {
  int c, j, i;
  evp::PointConst<T> k;
  T u, v;
};

template <typename T>
__device__ __forceinline__ void load_geom(const Args<T>& a, int c,
                                          Cell<T>& s) {
  s.c = c;
  s.j = c / a.nx;
  s.i = c - s.j * a.nx;
  s.g.cyp = a.geom[0][c];
  s.g.cxp = a.geom[1][c];
  s.g.cym = a.geom[2][c];
  s.g.cxm = a.geom[3][c];
  s.g.dxt = a.geom[4][c];
  s.g.dyt = a.geom[5][c];
  s.g.dxhy = a.geom[6][c];
  s.g.dyhx = a.geom[7][c];
  s.g.tiny = a.geom[8][c];
  s.g.strength = a.strength[c];
}

template <typename T>
__device__ __forceinline__ void load_cell(const Args<T>& a, int c,
                                          Cell<T>& s) {
  load_geom(a, c, s);
  const int64_t np = (int64_t)a.ny * a.nx;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s.sp[k] = a.sp[k * np + c];
    s.sm[k] = a.sm[k * np + c];
    s.s12[k] = a.s12[k * np + c];
  }
}

template <typename T>
__device__ __forceinline__ void store_stress(const Args<T>& a,
                                             const Cell<T>& s) {
  const int64_t np = (int64_t)a.ny * a.nx;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a.sp[k * np + s.c] = s.sp[k];
    a.sm[k * np + s.c] = s.sm[k];
    a.s12[k * np + s.c] = s.s12[k];
  }
}

template <typename T>
__device__ __forceinline__ void load_point(const Args<T>& a, int c,
                                           Point<T>& q) {
  q.c = c;
  q.j = c / a.nx;
  q.i = c - q.j * a.nx;
  q.k.aiu = a.c[0][c];
  q.k.uocn = a.c[1][c];
  q.k.vocn = a.c[2][c];
  q.k.waterx = a.c[3][c];
  q.k.watery = a.c[4][c];
  q.k.forcex = a.c[5][c];
  q.k.forcey = a.c[6][c];
  q.k.umassdtei = a.c[7][c];
  q.k.fm = a.c[8][c];
  q.k.uarear = a.geom[9][c];
  q.u = a.u[c];
  q.v = a.v[c];
}

// The stress pass of one T cell: strain rates from the velocities at its
// four U corners, relaxation of s's stresses (zero when !icet), its 8 str8
// pieces to device memory, and with FINAL the strain sums and prs_sig.
template <typename T, bool FINAL>
__device__ __forceinline__ void stress(const Args<T>& a, Cell<T>& s,
                                       bool icet) {
  const int j = s.j, i = s.i, c = s.c;
  const int64_t np = (int64_t)a.ny * a.nx;
  const T u = a.u[c], u_w = at(a.u, j, i - 1, a), u_s = at(a.u, j - 1, i, a),
          u_sw = at(a.u, j - 1, i - 1, a);
  const T v = a.v[c], v_w = at(a.v, j, i - 1, a), v_s = at(a.v, j - 1, i, a),
          v_sw = at(a.v, j - 1, i - 1, a);
  T str[8], sums[5];
  evp::stress_cell<T, FINAL>(a.p, s.g, u, u_w, u_s, u_sw, v, v_w, v_s, v_sw,
                             icet, s.sp, s.sm, s.s12, str, sums);
  if (FINAL) {
#pragma unroll
    for (int k = 0; k < 5; ++k) a.out[4 + k][c] = sums[k];
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) a.str8[k * np + c] = str[k];
}

// The momentum pass of one icy U point: the 2x2 solve from str8 at the point
// and its E, N and NE neighbours; with FINAL also strint and strocn.
template <typename T, bool FINAL, bool FOLD>
__device__ __forceinline__ void momentum(const Args<T>& a, Point<T>& q) {
  const int j = q.j, i = q.i, c = q.c;
  const int64_t np = (int64_t)a.ny * a.nx;
  const T* s = a.str8;
  const T s0 = s[c], s4 = s[4 * np + c];
  const T s1e = at(s + 1 * np, j, i + 1, a), s6e = at(s + 6 * np, j, i + 1, a);
  T s2n, s5n, s3ne, s7ne;
  if constexpr (!FOLD) {
    s2n = at(s + 2 * np, j + 1, i, a);
    s5n = at(s + 5 * np, j + 1, i, a);
    s3ne = at(s + 3 * np, j + 1, i + 1, a);
    s7ne = at(s + 7 * np, j + 1, i + 1, a);
  } else if (j == a.ny - 1) {  // across the fold: the mirror's pair
    const int64_t src = (int64_t)(a.fold == 2 ? a.ny - 1 : a.ny - 2) * a.nx;
    const int64_t rn = src + (a.nx - 1 - i);
    const int64_t rne = src + (i == a.nx - 1 ? a.nx - 1 : a.nx - 2 - i);
    s2n = -s[1 * np + rn];
    s5n = -s[6 * np + rn];
    s3ne = -s[rne];
    s7ne = -s[4 * np + rne];
  } else {  // the fold's NE shift wraps east-west
    const int64_t n = c + a.nx;
    const int64_t ne = n + (i == a.nx - 1 ? 1 - a.nx : 1);
    s2n = s[2 * np + n];
    s5n = s[5 * np + n];
    s3ne = s[3 * np + ne];
    s7ne = s[7 * np + ne];
  }
  T out[4];
  evp::momentum_point<T, FINAL>(a.p, q.k, q.u, q.v, s0, s1e, s2n, s3ne, s4,
                                s5n, s6e, s7ne, out);
  a.u[c] = q.u;
  a.v[c] = q.v;
  if (FINAL) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a.out[k][c] = out[k];
  }
}

// rank of this thread's flag among the block's set flags (in thread order)
// and, in `total`, their number; every thread of the block must call it
__device__ __forceinline__ int block_rank(bool flag, int* warp_counts,
                                          int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_counts[w] = __popc(m);
  __syncthreads();
  int before = 0;
  total = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
    if (k < w) before += warp_counts[k];
    total += warp_counts[k];
  }
  __syncthreads();
  return before + __popc(m & ((1u << lane) - 1u));
}

// block-wide sum; every thread of the block must call it
__device__ __forceinline__ int block_sum(int x, int* warp_sums) {
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  int total = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) total += warp_sums[k];
  __syncthreads();
  return total;
}

// FOLD: the instance for a tripole grid; the other grids run the one without
template <typename T, bool FOLD>
__global__ void __launch_bounds__(Launch<T>::threads, 1)
    evp_persistent(Args<T> a) {
  constexpr int kThreads = Launch<T>::threads;
  cg::grid_group grid = cg::this_grid();
  __shared__ int red[2][kMaxWarps];
  const int np = a.ny * a.nx;
  const int nb = gridDim.x, b = blockIdx.x;
  const int R = nb * kThreads;
  // this thread's rank: warps interleaved over the blocks, so the first
  // entries of the active lists spread over every SM, 32 neighbours a warp
  const int g = ((threadIdx.x >> 5) * nb + b) * 32 + (threadIdx.x & 31);
  int* counts = a.scratch;
  int* stats = a.scratch + 2 * nb;
  int* tlist = stats + kStats;
  int* ulist = tlist + np;
  int barriers = 0;  // grid barriers this thread has passed
  auto sync = [&] {
    grid.sync();
    ++barriers;
  };

  // --- phase 0: str8 to zero, the active lists in grid order -------------
  for (int64_t k = g; k < 8 * (int64_t)np; k += R) a.str8[k] = T(0);
  const int chunk = (np + nb - 1) / nb;
  const int lo = min(b * chunk, np), hi = min(lo + chunk, np);
  int nt_b = 0, nu_b = 0;
  for (int base = lo; base < hi; base += kThreads) {
    const int c = base + threadIdx.x;
    int tot;
    block_rank(c < hi && a.icet[c], red[0], tot);
    nt_b += tot;
    block_rank(c < hi && a.iceu[c], red[1], tot);
    nu_b += tot;
  }
  if (threadIdx.x == 0) {
    counts[b] = nt_b;
    counts[nb + b] = nu_b;
  }
  sync();
  int ot = 0, ou = 0, all_t = 0, all_u = 0;
  for (int k = threadIdx.x; k < nb; k += kThreads) {
    const int ct = counts[k], cu = counts[nb + k];
    all_t += ct;
    all_u += cu;
    if (k < b) {
      ot += ct;
      ou += cu;
    }
  }
  ot = block_sum(ot, red[0]);
  ou = block_sum(ou, red[0]);
  const int nt = block_sum(all_t, red[0]);
  const int nu = block_sum(all_u, red[0]);
  for (int base = lo; base < hi; base += kThreads) {
    const int c = base + threadIdx.x;
    const bool ft = c < hi && a.icet[c], fu = c < hi && a.iceu[c];
    int tot;
    const int rt = block_rank(ft, red[0], tot);
    if (ft) tlist[ot + rt] = c;
    ot += tot;
    const int ru = block_rank(fu, red[1], tot);
    if (fu) ulist[ou + ru] = c;
    ou += tot;
  }
  sync();

  // --- the gated subcycles: owned state in registers ---------------------
  const bool own_t = g < nt, own_u = g < nu;
  Cell<T> cs;
  Point<T> ps;
  if (own_t) load_cell(a, tlist[g], cs);
  if (own_u) load_point(a, ulist[g], ps);
  for (int n = 0; n < a.ndte - 1; ++n) {
    if (own_t) stress<T, false>(a, cs, true);
    for (int k = g + R; k < nt; k += R) {  // overflow: state in memory
      Cell<T> s;
      load_cell(a, tlist[k], s);
      stress<T, false>(a, s, true);
      store_stress(a, s);
    }
    sync();
    if (own_u) momentum<T, false, FOLD>(a, ps);
    for (int k = g + R; k < nu; k += R) {
      Point<T> q;
      load_point(a, ulist[k], q);
      momentum<T, false, FOLD>(a, q);
    }
    sync();
  }

  // --- the final subcycle over every cell --------------------------------
  if (own_t) {
    stress<T, true>(a, cs, true);
    store_stress(a, cs);
  }
  for (int k = g + R; k < nt; k += R) {
    Cell<T> s;
    load_cell(a, tlist[k], s);
    stress<T, true>(a, s, true);
    store_stress(a, s);
  }
  for (int c = g; c < np; c += R) {
    if (a.icet[c]) continue;
    Cell<T> s;
    load_geom(a, c, s);
    stress<T, true>(a, s, false);
    store_stress(a, s);
  }
  sync();
  if (own_u) momentum<T, true, FOLD>(a, ps);
  for (int k = g + R; k < nu; k += R) {
    Point<T> q;
    load_point(a, ulist[k], q);
    momentum<T, true, FOLD>(a, q);
  }
  for (int c = g; c < np; c += R) {
    if (a.iceu[c]) continue;
    a.u[c] = T(0);
    a.v[c] = T(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) a.out[k][c] = T(0);
  }
  if (b == 0 && threadIdx.x == 0) {
    stats[0] = nt;
    stats[1] = nu;
    stats[2] = barriers;
    stats[3] = nb;
    stats[4] = kThreads;
  }
}

template <typename T, bool FOLD = false>
int resident(int* blocks, int* threads) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, evp_persistent<T, FOLD>, Launch<T>::threads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop || per_sm < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks = per_sm * sms;
  *threads = Launch<T>::threads;
  return 0;
}

template <typename T>
int run(const int64_t* ptrs, int ny, int nx, int ew_cyclic, int ns,
        const double* par, int ndte, int flags, cudaStream_t stream) {
  if ((int64_t)ny * nx >= (int64_t)1 << 30 || ndte < 1 || ns < 0 || ns > 3 ||
      (ns >= 2 && ny < 2) || (flags & ~3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a;
  for (int k = 0; k < 10; ++k) a.geom[k] = reinterpret_cast<const T*>(ptrs[k]);
  a.strength = reinterpret_cast<const T*>(ptrs[STRENGTH]);
  a.icet = reinterpret_cast<const bool*>(ptrs[ICET]);
  a.iceu = reinterpret_cast<const bool*>(ptrs[ICEU]);
  for (int k = 0; k < 9; ++k) a.c[k] = reinterpret_cast<const T*>(ptrs[AIU + k]);
  a.u = reinterpret_cast<T*>(ptrs[UVEL]);
  a.v = reinterpret_cast<T*>(ptrs[VVEL]);
  a.sp = reinterpret_cast<T*>(ptrs[STRESSP]);
  a.sm = reinterpret_cast<T*>(ptrs[STRESSM]);
  a.s12 = reinterpret_cast<T*>(ptrs[STRESS12]);
  a.str8 = reinterpret_cast<T*>(ptrs[STR8]);
  for (int k = 0; k < 9; ++k) a.out[k] = reinterpret_cast<T*>(ptrs[STRINTX + k]);
  a.scratch = reinterpret_cast<int*>(ptrs[SCRATCH]);
  a.ny = ny;
  a.nx = nx;
  a.ew_cyclic = ew_cyclic;
  a.ns_cyclic = ns == 0;
  a.fold = ns >= 2 ? ns : 0;
  a.ndte = ndte;
  a.p = evp::make_params<T>(par, flags);

  // the scratch holds the counts of the grid evp_subcycle_resident gives:
  // the fold's instance must launch the same
  int blocks = 0, threads = 0, fold_blocks = 0;
  int rc = resident<T>(&blocks, &threads);
  if (rc == 0 && ns >= 2) rc = resident<T, true>(&fold_blocks, &threads);
  if (rc != 0) return rc;
  if (ns >= 2 && fold_blocks != blocks)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&a};
  const void* kernel = ns >= 2
      ? reinterpret_cast<const void*>(evp_persistent<T, true>)
      : reinterpret_cast<const void*>(evp_persistent<T, false>);
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(threads), args, 0, stream));
}

}  // namespace

extern "C" {

int evp_subcycle_f32(const int64_t* ptrs, int ny, int nx, int ew_cyclic,
                     int ns, const double* par, int ndte, int flags,
                     void* stream) {
  return run<float>(ptrs, ny, nx, ew_cyclic, ns, par, ndte, flags,
                    static_cast<cudaStream_t>(stream));
}

int evp_subcycle_f64(const int64_t* ptrs, int ny, int nx, int ew_cyclic,
                     int ns, const double* par, int ndte, int flags,
                     void* stream) {
  return run<double>(ptrs, ny, nx, ew_cyclic, ns, par, ndte, flags,
                     static_cast<cudaStream_t>(stream));
}

int evp_subcycle_resident_f32(int* blocks, int* threads) {
  return resident<float>(blocks, threads);
}

int evp_subcycle_resident_f64(int* blocks, int* threads) {
  return resident<double>(blocks, threads);
}

}  // extern "C"
