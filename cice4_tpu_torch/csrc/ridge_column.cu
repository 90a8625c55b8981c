// ridge_column.cu — mechanical redistribution and the ITD cleanup, one thread
// a column, on Hopper.
//
// Replaces no TPU kernel: the JAX package keeps the ridging loop in a
// lax.while_loop of plain jnp (cice4_tpu/ops/mechred.py:235-252) and the
// cleanup in plain jnp (cice4_tpu/ops/itd.py).  It was added because eager
// PyTorch spends about 12,600 launches and 4 host synchronisations a gx1 step
// on these two functions (ridge_ice's ~4 passes of ~1,700 operations each,
// two cleanup_itd calls of ~2,900), so the step waits on the host's dispatch.
// It computes what the plain versions compute:
//
// - ridge_column: cice4_tpu_torch/ops/mechred.py::_ridge_ice_plain, the whole
//   ridge_ice loop (ridge_prep, then up to nitermax passes of ridge_shift:
//   ridge_itd's participation and redistribution for both krdg_partic and both
//   krdg_redist, the rate reductions, each donor's deposits into every
//   receiving category, the tracers rebuilt, then ridge_check);
// - cleanup_column: cice4_tpu_torch/ops/itd.py::_cleanup_itd_plain, rebin
//   (the category-1 minimum fix, the upward and downward sweeps, each a
//   whole-donor shift_ice with its tracer rebuild) then zap_small_areas (the
//   zap at a_negligible and the normalisation of aice > 1 with its fluxes).
//
// Per-column exit.  A column leaves its ridging loop when its area sums to
// 1 +- puny, or is masked, or after nitermax passes.  The plain loop runs
// until every column of the grid (of every block) is done, giving a converged
// column further passes with zero closing and opening; such a pass changes
// nothing but the tracers' divide-and-multiply round trip (a few ulps;
// tests/test_torch_mechred.py holds it) and the volume tracers (age,
// level-ice volume) of a category holding less than puny of ice, which the
// plain rebuild divides by max(vicen, puny) each pass: a difference of
// result, not rounding, in tracers no other field reads (in f32 the cleanup
// after ridging zaps such categories).  So no grid-wide exit and no host
// synchronisation remain.  CICE's Fortran takes the decision per block.
// The kernel writes each column's pass count and converged flag; the wrapper
// reduces the counts with a max on the device.
//
// Arithmetic follows the plain versions as PyTorch runs them on the card,
// expression by expression and in their order: a division by a Python number
// is a multiplication by its reciprocal (PyTorch's div_true_kernel_cuda with
// a CPU scalar), 1 / x is reciprocal(x), x ** 2 is x * x, clamps and minima
// propagate NaN, Python constants round to T, and a sum over a leading axis of
// up to a few dozen elements associates as PyTorch's CUDA reduction does
// (four accumulators taking element i into i % 4, combined in order:
// ATen/native/cuda/Reduce.cuh thread_reduce_impl with vt0 = 4).  Built with
// -fmad=false, so no multiply and add contract into an FMA that eager
// PyTorch does not do; expf and sqrtf are the full-precision ones.  So on the
// card the kernels differ from the plain path only where the per-column exit
// skips a pass.
//
// Design: one thread owns one (j, i) column of every category, layer and
// tracer plane, so thread t reads and writes word t of each plane and a warp
// touches neighbouring addresses (coalesced).  Every count (ncat, nilyr,
// nslyr, the tracers and their dependencies) and every option is a run-time
// argument: one instance a type serves every configuration.  A thread's
// per-category work slots (the pass-start area and volumes, the
// participation, the donors' amounts, the ncat x ncat redistribution
// coefficients, one finished row) live in dynamic shared memory laid out
// [slot][thread], so a warp's 32 threads touch neighbouring words: 11 ncat +
// 2 ncat^2 words for ridging (53,760 bytes a block of 128 threads at ncat 5
// in f32, four blocks an SM), 7 ncat + 4 (ncat - 1) + 2 ntrcr ncat for the
// cleanup.  Where a block's slots do not fit in 227 KB (ridging above 12
// categories in f32, above 8 in f64), they live in a global scratch tensor
// laid out [slot][column] that the wrapper allocates; one accessor serves
// both, so no count is refused.  The state is processed a row at a time
// (one quantity of every category: the area, a volume, one enthalpy layer,
// the surface temperature, one tracer), in place in the outputs from the
// second pass on.  Each category's value of a row is built in a register:
// the plain loop takes donor n, then its receivers nr, so category nr takes,
// for n = 0, 1, ..., its own removal when n == nr and then donor n's
// deposit, the same operations in the same order.  No atomics.
//
// What bounds it on an H100: bytes.  Each column's inputs are read once and
// its outputs written once (gx1 in f32: 55 MB for ridging, 51 MB for the
// cleanup, 0.016 and 0.015 ms at 3.35 TB/s).  A column that ridges runs
// several passes while its warp's other threads wait; most columns take one.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTracers = 8;
constexpr int kErrTracers = -2;
constexpr int64_t kMaxSmem = 232448;  // a Hopper block's most, 227 KB

// the work slots a thread of each kernel keeps (the layouts in ridge_pass
// and cleanup_column)
int64_t ridge_slots(int64_t n) { return 11 * n + 2 * n * n; }
int64_t cleanup_slots(int64_t n, int64_t r) {
  return 7 * n + 4 * (n > 1 ? n - 1 : 0) + 2 * r * n;
}

// clamp(x, min=lo) and torch.maximum / torch.minimum as PyTorch computes
// them: NaN propagates
template <typename T>
__device__ __forceinline__ T clamp_lo(T x, T lo) {
  return x != x ? x : (x > lo ? x : lo);
}
template <typename T>
__device__ __forceinline__ T clamp_hi(T x, T hi) {
  return x != x ? x : (x < hi ? x : hi);
}
template <typename T>
__device__ __forceinline__ T maxnan(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T minnan(T a, T b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}
__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double xsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float xabs(float x) { return fabsf(x); }
__device__ __forceinline__ double xabs(double x) { return fabs(x); }

// a sum over a leading axis as PyTorch's CUDA reduction takes it
template <typename T>
struct Sum4 {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int i = 0;
  __device__ void add(T x) {
    switch (i++ & 3) {
      case 0: a0 = a0 + x; break;
      case 1: a1 = a1 + x; break;
      case 2: a2 = a2 + x; break;
      default: a3 = a3 + x;
    }
  }
  __device__ T total() const { return ((a0 + a1) + a2) + a3; }
};

// this thread's work slots: in dynamic shared memory laid out
// [slot][thread], or, where a block's do not fit there, in the global
// scratch tensor laid out [slot][column]
template <typename T>
struct Slots {
  T* base;
  int64_t stride;
  __device__ T& operator()(int s) const { return base[s * stride]; }
};

template <typename T>
__device__ Slots<T> slots_of(T* scratch, int64_t col, int64_t P) {
  if (scratch != nullptr) return {scratch + col, P};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return {reinterpret_cast<T*>(smem_raw) + threadIdx.x, int64_t(kThreads)};
}

// plane p of a (..., ny, nx) array at this column
template <typename T>
struct Planes {
  T* base;
  int64_t stride;
  __device__ T& operator()(int p) const { return base[p * stride]; }
};

template <typename T>
__device__ Planes<T> at(const T* a, int64_t col, int64_t P) {
  return {const_cast<T*>(a) + col, P};
}

// the tracers, one (ncat, ny, nx) array each: category n of tracer t at
// this column
template <typename T>
struct TracerPlanes {
  T* const* base;
  int64_t col, stride;
  __device__ T& operator()(int t, int n) const {
    return base[t][n * stride + col];
  }
};

// ---------------------------------------------------------------------------
// ridge_column
// ---------------------------------------------------------------------------

struct RidgeParams {
  double dt, dti, puny, Cs, Gstar, Gstari, astari, xtmp, maxraft, Hstar,
      mu_rdg, fsnowrdg, one_m_fsnowrdg, rhos, Tocnfrz;
};

template <typename T>
struct RidgeArgs {
  // inputs: (ncat, ...) planes, each tracer an (ncat, ny, nx) array;
  // aice0 may be null (then 1 - sum of aicen, clamped at 0)
  const T *aicen, *vicen, *vsnon, *tsfcn, *eicen, *esnon, *aice0, *rdg_conv,
      *rdg_shear;
  T* trcrn[kMaxTracers];  // read only
  const bool* tmask;
  const double* hin_max;  // ncat + 1 bounds, the top one 1e8
  // outputs
  T *o_aicen, *o_vicen, *o_vsnon, *o_tsfcn, *o_eicen, *o_esnon;
  T* o_trcrn[kMaxTracers];
  T *dardg1dt, *dardg2dt, *dvirdgdt, *opening, *fresh, *fhocn, *asum;
  int32_t* niter;
  bool* converged;
  T* scratch;  // null: the work slots live in shared memory
  int64_t P;
  int ncat, nilyr, nslyr, ntrcr, krdg_partic, krdg_redist, nitermax;
  int tcode[kMaxTracers];  // dependency (0 area, 1 ice, 2 snow) | 4 level
  RidgeParams p;
};

// one pass of ridge_shift (mechred.py::_ridge_shift) on this column: reads
// the pass-start state from the src planes, writes the new state to the
// output planes (which may be the src planes); the scalars of the carry are
// updated in place
template <typename T>
__device__ void ridge_pass(const RidgeArgs<T>& a, const Slots<T>& s,
                           int64_t col, bool first,
                           T closing_net, T opning, T& aice0, T& ardg1,
                           T& ardg2, T& virdg, T& aopen, T& msnow, T& esnow) {
  const int N = a.ncat, L = a.nilyr, S = a.nslyr, R = a.ntrcr;
  const int64_t P = a.P;
  const T puny = T(a.p.puny), dt = T(a.p.dt);
  const Planes<T> sa = at(first ? a.aicen : a.o_aicen, col, P),
                  sv = at(first ? a.vicen : a.o_vicen, col, P),
                  ss = at(first ? a.vsnon : a.o_vsnon, col, P),
                  st = at(first ? a.tsfcn : a.o_tsfcn, col, P),
                  se = at(first ? a.eicen : a.o_eicen, col, P),
                  ses = at(first ? a.esnon : a.o_esnon, col, P);
  const TracerPlanes<T> str{first ? a.trcrn : a.o_trcrn, col, P},
      otr{a.o_trcrn, col, P};
  const Planes<T> oa = at(a.o_aicen, col, P), ov = at(a.o_vicen, col, P),
                  os = at(a.o_vsnon, col, P), ot = at(a.o_tsfcn, col, P),
                  oe = at(a.o_eicen, col, P), oes = at(a.o_esnon, col, P);
  const int AI = 0, VI = N, SI = 2 * N, APART = 3 * N, KRDG = 4 * N,
            ARDG1 = 5 * N, ARDG2 = 6 * N, AFRAC = 7 * N, VIRDG = 8 * N,
            VSRDG = 9 * N, W = 10 * N, FAREA = 11 * N, FVOL = 11 * N + N * N;

  // the pass-start area and volumes (the carry's)
  for (int n = 0; n < N; ++n) {
    s(AI + n) = sa(n);
    s(VI + n) = sv(n);
    s(SI + n) = ss(n);
  }

  // ridge_itd (mechred_strength.py::ridge_itd_full)
  const T contrib0 = aice0 > puny ? aice0 : T(0);
  T cs = T(0);
  for (int n = 0; n < N; ++n) {
    const T an = s(AI + n);
    cs = cs + (an > puny ? an : T(0));
  }
  const T norm = T(1) / clamp_lo(contrib0 + cs, puny);
  const T G0 = contrib0 * norm;
  const T Gstar = T(a.p.Gstar), Gstari = T(a.p.Gstari);
  const T astari = T(a.p.astari), xtmp = T(a.p.xtmp);
  auto partic = [&](T glo, T ghi) -> T {
    if (a.krdg_partic == 0) {
      const T full = ((ghi - glo) * Gstari) * (T(2) - (glo + ghi) * Gstari);
      const T part =
          ((Gstar - glo) * Gstari) * (T(2) - (glo + Gstar) * Gstari);
      return ghi < Gstar ? full : (glo < Gstar ? part : T(0));
    }
    return xexp(-glo * astari) * xtmp - xexp(-ghi * astari) * xtmp;
  };
  const T apartic0 = partic(T(0), G0);
  Sum4<T> ak;
  T Gprev = G0;
  cs = T(0);
  for (int n = 0; n < N; ++n) {
    const T an = s(AI + n), vn = s(VI + n);
    cs = cs + (an > puny ? an : T(0));
    const T Gn = (contrib0 + cs) * norm;
    const T ap = partic(Gprev, Gn);
    Gprev = Gn;
    const bool has = an > puny;
    T hi = has ? vn / clamp_lo(an, puny) : T(0);
    hi = clamp_lo(hi, puny);
    const T hrmin = has ? minnan(T(2) * hi, hi + T(a.p.maxraft)) : T(0);
    T hrmax = T(0), hrexp = T(0), krdg;
    if (a.krdg_redist == 0) {
      hrmax = has ? maxnan(xsqrt(hi * T(a.p.Hstar)) * T(2), hrmin + puny)
                  : T(0);
      const T hrmean = (hrmin + hrmax) * T(0.5);
      krdg = has ? hrmean / hi : T(1);
    } else {
      hrexp = has ? xsqrt(hi) * T(a.p.mu_rdg) : T(0);
      krdg = has ? (hrmin + hrexp) / hi : T(1);
    }
    s(APART + n) = ap;
    s(KRDG + n) = krdg;
    ak.add(ap * (T(1) - T(1) / krdg));
    // where donor n's ridged ice goes: area and volume shares of each
    // receiving category
    const T dhr = clamp_lo(hrmax - hrmin, puny);
    const T dhr2 = clamp_lo(hrmax * hrmax - hrmin * hrmin, puny);
    for (int nr = 0; nr < N; ++nr) {
      const T hlo = T(a.hin_max[nr]), hhi = T(a.hin_max[nr + 1]);
      T farea, fvol;
      if (a.krdg_redist == 0) {
        const bool empty = (hrmin >= hhi) | (hrmax <= hlo);
        const T hLr = clamp_lo(hrmin, hlo), hRr = clamp_hi(hrmax, hhi);
        farea = empty ? T(0) : (hRr - hLr) / dhr;
        fvol = empty ? T(0) : (hRr * hRr - hLr * hLr) / dhr2;
      } else {
        const T hi1 = hrmin, hexp = clamp_lo(hrexp, puny);
        const T hLr = clamp_lo(hi1, hlo);
        const T expL = xexp(-(hLr - hi1) / hexp);
        if (nr < N - 1) {
          const bool empty = hi1 >= hhi;
          const T expR = xexp(-(hhi - hi1) / hexp);
          farea = empty ? T(0) : expL - expR;
          fvol = empty ? T(0)
                       : ((hLr + hexp) * expL - (hexp + hhi) * expR) /
                             clamp_lo(hi1 + hexp, puny);
        } else {
          farea = expL;
          fvol = (hLr + hexp) * expL / clamp_lo(hi1 + hexp, puny);
        }
      }
      s(FAREA + n * N + nr) = farea;
      s(FVOL + n * N + nr) = fvol;
    }
  }
  const T aksum = apartic0 + ak.total();

  // reduce the rates if they would remove more area than exists
  T cg = closing_net / clamp_lo(aksum, puny);
  T opn = opning;
  {
    const T wk1 = (apartic0 * cg) * dt;
    const T fac = (apartic0 > T(0) && wk1 > aice0)
                      ? aice0 / clamp_lo(wk1, puny) : T(1);
    cg = cg * fac;
    opn = opn * fac;
  }
  for (int n = 0; n < N; ++n) {
    const T an = s(AI + n), ap = s(APART + n);
    const T wk1 = (ap * cg) * dt;
    const T fac = (an > puny && ap > T(0) && wk1 > an)
                      ? an / clamp_lo(wk1, puny) : T(1);
    cg = cg * fac;
    opn = opn * fac;
  }
  aice0 = clamp_lo((aice0 - (apartic0 * cg) * dt) + opn * dt, T(0));
  aopen = aopen + opn * dt;

  // each donor's ridged amounts
  const T rhos = T(a.p.rhos), keep = T(a.p.fsnowrdg);
  const T lost = T(a.p.one_m_fsnowrdg);
  for (int n = 0; n < N; ++n) {
    const T an = s(AI + n), ap = s(APART + n);
    const bool active = an > puny && ap > T(0) && cg > T(0);
    const T ardg1n = active ? minnan((ap * cg) * dt, an) : T(0);
    const T ardg2n = ardg1n / clamp_lo(s(KRDG + n), puny);
    const T afrac = ardg1n / clamp_lo(an, puny);
    const T virdgn = s(VI + n) * afrac, vsrdgn = s(SI + n) * afrac;
    s(ARDG1 + n) = ardg1n;
    s(ARDG2 + n) = ardg2n;
    s(AFRAC + n) = afrac;
    s(VIRDG + n) = virdgn;
    s(VSRDG + n) = vsrdgn;
    ardg1 = ardg1 + ardg1n;
    ardg2 = ardg2 + ardg2n;
    virdg = virdg + virdgn;
    msnow = msnow + (vsrdgn * rhos) * lost;
    Sum4<T> es;
    for (int k = 0; k < S; ++k) es.add(ses(n * S + k) * afrac);
    esnow = esnow + es.total() * lost;
  }

  // the rows: remove each donor's ridged share, deposit it into every
  // category.  The plain loop runs donor n, then its receivers nr; so
  // category nr's value takes, for n = 0, 1, ..., its own removal when
  // n == nr and then donor n's deposit, the order kept here one category
  // at a time, the value in a register
  auto ridge_row = [&](auto init, auto removed, auto deposit) {
    for (int nr = 0; nr < N; ++nr) {
      T w = init(nr);
      for (int n = 0; n < N; ++n) {
        if (n == nr) w = removed(n, w);
        w = w + deposit(n, nr);
      }
      s(W + nr) = w;
    }
  };
  auto fa = [&](int n, int nr) { return s(FAREA + n * N + nr); };
  auto fv = [&](int n, int nr) { return s(FVOL + n * N + nr); };

  ridge_row([&](int n) { return s(AI + n); },
            [&](int n, T w) { return w - s(ARDG1 + n); },
            [&](int n, int nr) { return fa(n, nr) * s(ARDG2 + n); });
  for (int n = 0; n < N; ++n) oa(n) = s(W + n);
  ridge_row([&](int n) { return s(VI + n); },
            [&](int n, T w) { return w - s(VIRDG + n); },
            [&](int n, int nr) { return fv(n, nr) * s(VIRDG + n); });
  for (int n = 0; n < N; ++n) ov(n) = s(W + n);
  ridge_row([&](int n) { return s(SI + n); },
            [&](int n, T w) { return w - s(VSRDG + n); },
            [&](int n, int nr) { return (fv(n, nr) * s(VSRDG + n)) * keep; });
  for (int n = 0; n < N; ++n) os(n) = s(W + n);
  for (int k = 0; k < L; ++k) {
    ridge_row([&](int n) { return se(n * L + k); },
              [&](int n, T w) { return w - se(n * L + k) * s(AFRAC + n); },
              [&](int n, int nr) {
                return fv(n, nr) * (se(n * L + k) * s(AFRAC + n));
              });
    for (int n = 0; n < N; ++n) oe(n * L + k) = s(W + n);
  }
  for (int k = 0; k < S; ++k) {
    ridge_row([&](int n) { return ses(n * S + k); },
              [&](int n, T w) { return w - ses(n * S + k) * s(AFRAC + n); },
              [&](int n, int nr) {
                return (fv(n, nr) * (ses(n * S + k) * s(AFRAC + n))) * keep;
              });
    for (int n = 0; n < N; ++n) oes(n * S + k) = s(W + n);
  }

  // the area-weighted surface temperature, rebuilt on the new area
  // (itd.py::_compute_tracers); the carry's tsfc_a is tsfcn * aicen
  ridge_row([&](int n) { return st(n) * s(AI + n); },
            [&](int n, T w) { return w - s(ARDG1 + n) * st(n); },
            [&](int n, int nr) {
              return (fa(n, nr) * s(ARDG2 + n)) * st(n);
            });
  for (int n = 0; n < N; ++n) {
    const T an = oa(n);
    ot(n) = an > puny ? s(W + n) / clamp_lo(an, puny) : T(a.p.Tocnfrz);
  }
  for (int t = 0; t < R; ++t) {
    const int dep = a.tcode[t] & 3;
    const bool level = (a.tcode[t] & 4) != 0;
    const int WI = dep == 0 ? AI : (dep == 1 ? VI : SI);
    ridge_row([&](int n) { return str(t, n) * s(WI + n); },
              [&](int n, T w) {
                if (level) w = w * (T(1) - s(AFRAC + n));
                const T amt = dep == 0 ? s(ARDG1 + n)
                              : dep == 1 ? s(VIRDG + n) : s(VSRDG + n);
                return w - amt * str(t, n);
              },
              [&](int n, int nr) {
                const T amt = dep == 0   ? fa(n, nr) * s(ARDG2 + n)
                              : dep == 1 ? fv(n, nr) * s(VIRDG + n)
                                         : (fv(n, nr) * s(VSRDG + n)) * keep;
                return amt * str(t, n);
              });
    const Planes<T> od = dep == 0 ? oa : (dep == 1 ? ov : os);
    const T thresh = dep == 0 ? puny : T(0);
    for (int n = 0; n < N; ++n) {
      const T d = od(n);
      otr(t, n) = d > thresh ? s(W + n) / clamp_lo(d, puny) : T(0);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ridge_column(const RidgeArgs<T> a) {
  const int64_t col = blockIdx.x * int64_t(kThreads) + threadIdx.x;
  if (col >= a.P) return;
  const int N = a.ncat;
  const int64_t P = a.P;
  const T puny = T(a.p.puny);
  const T inv_dt = T(1) / T(a.p.dt);
  const bool tm = a.tmask[col];
  const Planes<T> ain = at(a.aicen, col, P), oa = at(a.o_aicen, col, P);
  const Slots<T> slots = slots_of(a.scratch, col, P);

  T aice0;
  if (a.aice0 != nullptr) {
    aice0 = a.aice0[col];
  } else {
    Sum4<T> sm;
    for (int n = 0; n < N; ++n) sm.add(ain(n));
    aice0 = clamp_lo(T(1) - sm.total(), T(0));
  }
  // ridge_prep
  T asum;
  {
    Sum4<T> sm;
    for (int n = 0; n < N; ++n) sm.add(ain(n));
    asum = aice0 + sm.total();
  }
  T closing_net = a.rdg_shear[col] * T(a.p.Cs) + a.rdg_conv[col];
  T divu_adv = (T(1) - asum) * inv_dt;
  if (divu_adv < T(0)) closing_net = maxnan(closing_net, -divu_adv);
  T opning = closing_net + divu_adv;
  if (!tm) {
    closing_net = T(0);
    opning = T(0);
  }

  T ardg1 = T(0), ardg2 = T(0), virdg = T(0), aopen = T(0), msnow = T(0),
    esnow = T(0);
  int it = 0;
  bool ok = false;
  while (true) {
    ridge_pass(a, slots, col, it == 0, closing_net, opning, aice0, ardg1,
               ardg2, virdg, aopen, msnow, esnow);
    ++it;
    // ridge_check
    Sum4<T> sm;
    for (int n = 0; n < N; ++n) sm.add(oa(n));
    asum = aice0 + sm.total();
    ok = xabs(asum - T(1)) < puny || !tm;
    if (ok || it >= a.nitermax) break;
    divu_adv = (T(1) - asum) * inv_dt;
    closing_net = clamp_lo(-divu_adv, T(0));
    opning = clamp_lo(divu_adv, T(0));
  }
  const T dti = T(a.p.dti);
  a.dardg1dt[col] = ardg1 * dti;
  a.dardg2dt[col] = ardg2 * dti;
  a.dvirdgdt[col] = virdg * dti;
  a.opening[col] = aopen * dti;
  a.fresh[col] = msnow * dti;
  a.fhocn[col] = esnow * dti;
  a.asum[col] = asum;
  a.niter[col] = it;
  a.converged[col] = ok;
}

// ---------------------------------------------------------------------------
// cleanup_column
// ---------------------------------------------------------------------------

struct CleanupParams {
  double dt, puny, one_m_puny, Tocnfrz, a_zap, rhoi, rhos, ice_ref_salinity;
};

template <typename T>
struct CleanupArgs {
  const T *aicen, *vicen, *vsnon, *tsfcn, *eicen, *esnon;
  T* trcrn[kMaxTracers];  // read only
  const bool* tmask;
  const double* hin_max;
  T *o_aicen, *o_vicen, *o_vsnon, *o_tsfcn, *o_eicen, *o_esnon;
  T* o_trcrn[kMaxTracers];
  T *dfresh, *dfsalt, *dfhocn;
  T* scratch;  // null: the work slots live in shared memory
  int64_t P;
  int ncat, nilyr, nslyr, ntrcr, limit_aice;
  int tcode[kMaxTracers];
  CleanupParams p;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cleanup_column(const CleanupArgs<T> a) {
  const int64_t col = blockIdx.x * int64_t(kThreads) + threadIdx.x;
  if (col >= a.P) return;
  const int N = a.ncat, L = a.nilyr, S = a.nslyr, R = a.ntrcr;
  const int64_t P = a.P;
  const T puny = T(a.p.puny), one_m_puny = T(a.p.one_m_puny);
  const T inv_dt = T(1) / T(a.p.dt);
  const Slots<T> s = slots_of(a.scratch, col, P);
  const int NB = N - 1;  // category boundaries; 2 NB shift_ice calls
  const int A = 0, V = N, VS = 2 * N, TS = 3 * N, TA = 4 * N, W = 5 * N,
            ZAP = 6 * N, UP = 7 * N, FV = 7 * N + 2 * NB,
            TR = 7 * N + 4 * NB, TRA = TR + R * N;
  const Planes<T> ia = at(a.aicen, col, P), iv = at(a.vicen, col, P),
                  is = at(a.vsnon, col, P), it = at(a.tsfcn, col, P),
                  ie = at(a.eicen, col, P), ies = at(a.esnon, col, P);
  const TracerPlanes<T> itr{a.trcrn, col, P}, otr{a.o_trcrn, col, P};
  const Planes<T> oa = at(a.o_aicen, col, P), ov = at(a.o_vicen, col, P),
                  os = at(a.o_vsnon, col, P), ot = at(a.o_tsfcn, col, P),
                  oe = at(a.o_eicen, col, P), oes = at(a.o_esnon, col, P);
  for (int n = 0; n < N; ++n) {
    s(A + n) = ia(n);
    s(V + n) = iv(n);
    s(VS + n) = is(n);
    s(TS + n) = it(n);
  }
  for (int t = 0; t < R; ++t)
    for (int n = 0; n < N; ++n) s(TR + t * N + n) = itr(t, n);
  auto weight = [&](int t) {
    const int dep = a.tcode[t] & 3;
    return dep == 0 ? A : (dep == 1 ? V : VS);
  };

  // rebin (itd.py::rebin): the category-1 minimum thickness
  const T hin0 = T(a.hin_max[0]);
  if (a.hin_max[0] > 0.0) {
    const T a0 = s(A), v0 = s(V);
    const T h0 = a0 > puny ? v0 / clamp_lo(a0, puny) : T(0);
    if (a0 > puny && h0 <= hin0) s(A) = v0 * (T(1) / hin0);
  }

  // the sweeps: call c moves the whole donor across boundary bc (upward,
  // the thick category bc into bc + 1; downward, the thin category bc + 1
  // into bc) if rebin asks, and rebuilds the tracers either way
  // (itd.py::shift_ice); the boundary's direction and volume fraction are
  // kept for the enthalpy rows
  for (int c = 0; c < 2 * NB; ++c) {
    const bool upward = c < NB;
    const int bc = upward ? c : 2 * NB - 1 - c;
    const int donor = upward ? bc : bc + 1;
    const T ad = s(A + donor), vd = s(V + donor);
    const T h = ad > puny ? vd / clamp_lo(ad, puny) : T(0);
    const T bound = T(a.hin_max[bc + 1]);
    const bool move = ad > puny && (upward ? h > bound : h <= bound);
    const T amt_a = move ? ad : T(0), amt_v = move ? vd : T(0);

    for (int n = 0; n < N; ++n) s(TA + n) = s(TS + n) * s(A + n);
    for (int t = 0; t < R; ++t) {
      const int wi = weight(t);
      for (int n = 0; n < N; ++n)
        s(TRA + t * N + n) = s(TR + t * N + n) * s(wi + n);
    }
    for (int b = 0; b < NB; ++b) {
      const bool here = b == bc;
      const bool up = here && move && upward;
      const bool dn = here && move && !upward;
      const T a_d = up ? s(A + b) : s(A + b + 1);
      const T v_d = up ? s(V + b) : s(V + b + 1);
      T da = clamp_lo(here ? amt_a : T(0), T(0));
      T dv = clamp_lo(here ? amt_v : T(0), T(0));
      const bool full = (da > a_d * one_m_puny) | (dv > v_d * one_m_puny);
      if (full) {
        da = a_d;
        dv = v_d;
      }
      const bool active = (up || dn) && da > T(0);
      if (!active) {
        da = T(0);
        dv = T(0);
      }
      const T frac_v = v_d > T(0) ? dv / clamp_lo(v_d, puny) : T(0);
      const T sgn = up ? T(1) : T(-1);
      auto move_row = [&](int base, T d) {
        s(base + b) = s(base + b) - d;
        s(base + b + 1) = s(base + b + 1) + d;
      };
      move_row(A, sgn * da);
      move_row(V, sgn * dv);
      const T vs_d = up ? s(VS + b) : s(VS + b + 1);
      move_row(VS, sgn * (vs_d * frac_v));
      if (here) {
        s(UP + c) = up ? T(1) : T(0);
        s(FV + c) = frac_v;
      }
      const T frac_a = a_d > T(0) ? da / clamp_lo(a_d, puny) : T(0);
      const T t_d = up ? s(TA + b) : s(TA + b + 1);
      move_row(TA, sgn * (t_d * frac_a));
      for (int t = 0; t < R; ++t) {
        const int base = TRA + t * N;
        const T frac = (a.tcode[t] & 3) == 0 ? frac_a : frac_v;
        const T t_dn = up ? s(base + b) : s(base + b + 1);
        move_row(base, sgn * (t_dn * frac));
      }
    }
    for (int n = 0; n < N; ++n) {
      const T an = s(A + n);
      s(TS + n) = an > puny ? s(TA + n) / clamp_lo(an, puny)
                            : T(a.p.Tocnfrz);
    }
    for (int t = 0; t < R; ++t) {
      const int wi = weight(t);
      const T thresh = (a.tcode[t] & 3) == 0 ? puny : T(0);
      for (int n = 0; n < N; ++n) {
        const T d = s(wi + n);
        s(TR + t * N + n) =
            d > thresh ? s(TRA + t * N + n) / clamp_lo(d, puny) : T(0);
      }
    }
  }
  // the enthalpy rows replay the calls' moves
  auto replay = [&](Planes<T> in, Planes<T> out, int layers) {
    for (int k = 0; k < layers; ++k) {
      for (int n = 0; n < N; ++n) s(W + n) = in(n * layers + k);
      for (int c = 0; c < 2 * NB; ++c) {
        const int bc = c < NB ? c : 2 * NB - 1 - c;
        for (int b = 0; b < NB; ++b) {
          const bool up = b == bc && s(UP + c) != T(0);
          const T frac_v = b == bc ? s(FV + c) : T(0);
          const T sgn = up ? T(1) : T(-1);
          const T e_d = up ? s(W + b) : s(W + b + 1);
          const T d = sgn * (e_d * frac_v);
          s(W + b) = s(W + b) - d;
          s(W + b + 1) = s(W + b + 1) + d;
        }
      }
      for (int n = 0; n < N; ++n) out(n * layers + k) = s(W + n);
    }
  };
  replay(ie, oe, L);
  replay(ies, oes, S);

  T dfresh = T(0), dfsalt = T(0), dfhocn = T(0), scale = T(1);
  if (a.limit_aice) {
    // zap_small_areas
    const T a_zap = T(a.p.a_zap), rhoi = T(a.p.rhoi), rhos = T(a.p.rhos);
    const T sal = T(a.p.ice_ref_salinity);
    const bool tm = a.tmask[col];
    for (int n = 0; n < N; ++n) {
      const T an = xabs(s(A + n));
      s(ZAP + n) = (an > T(0) && an <= a_zap && tm) ? T(1) : T(0);
    }
    Sum4<T> fz, sz;
    for (int n = 0; n < N; ++n) {
      const bool zap = s(ZAP + n) != T(0);
      fz.add(zap ? s(V + n) * rhoi + s(VS + n) * rhos : T(0));
      sz.add(zap ? s(V + n) * rhoi : T(0));
    }
    Sum4<T> ez, esz;
    for (int n = 0; n < N; ++n) {
      const bool zap = s(ZAP + n) != T(0);
      for (int k = 0; k < L; ++k) ez.add(zap ? oe(n * L + k) : T(0));
      for (int k = 0; k < S; ++k) esz.add(zap ? oes(n * S + k) : T(0));
    }
    dfhocn = ez.total() * inv_dt;
    dfhocn = dfhocn + esz.total() * inv_dt;
    dfresh = fz.total() * inv_dt;
    dfsalt = ((sz.total() * sal) * T(0.001)) * inv_dt;
    for (int n = 0; n < N; ++n) {
      if (s(ZAP + n) != T(0)) {
        s(A + n) = T(0);
        s(V + n) = T(0);
        s(VS + n) = T(0);
        s(TS + n) = T(a.p.Tocnfrz);
        for (int t = 0; t < R; ++t) s(TR + t * N + n) = T(0);
      }
    }
    // the excess of the total area over 1
    Sum4<T> sa;
    for (int n = 0; n < N; ++n) sa.add(s(A + n));
    const T aice = sa.total();
    const bool excess = aice > T(1);
    scale = excess ? T(1) / clamp_lo(aice, puny) : T(1);
    const T zapfrac = excess ? (aice - T(1)) / clamp_lo(aice, puny) : T(0);
    Sum4<T> ee, ees, fe, se;
    for (int n = 0; n < N; ++n) {
      const bool zap = s(ZAP + n) != T(0);
      for (int k = 0; k < L; ++k) {
        const T e = zap ? T(0) : oe(n * L + k);
        ee.add(e);
        oe(n * L + k) = e * scale;
      }
      for (int k = 0; k < S; ++k) {
        const T e = zap ? T(0) : oes(n * S + k);
        ees.add(e);
        oes(n * S + k) = e * scale;
      }
      fe.add(s(V + n) * rhoi + s(VS + n) * rhos);
      se.add(s(V + n) * rhoi);
    }
    dfhocn = dfhocn + ((ee.total() + ees.total()) * zapfrac) * inv_dt;
    dfresh = dfresh + (fe.total() * zapfrac) * inv_dt;
    dfsalt = dfsalt + ((((se.total() * sal) * T(0.001)) * zapfrac)) * inv_dt;
  }
  for (int n = 0; n < N; ++n) {
    oa(n) = s(A + n) * scale;
    ov(n) = s(V + n) * scale;
    os(n) = s(VS + n) * scale;
    ot(n) = s(TS + n);
  }
  for (int t = 0; t < R; ++t)
    for (int n = 0; n < N; ++n) otr(t, n) = s(TR + t * N + n);
  a.dfresh[col] = dfresh;
  a.dfsalt[col] = dfsalt;
  a.dfhocn[col] = dfhocn;
}

template <typename T>
const T* cptr(const int64_t* ptrs, int i) {
  return reinterpret_cast<const T*>(ptrs[i]);
}
template <typename T>
T* mptr(const int64_t* ptrs, int i) {
  return reinterpret_cast<T*>(ptrs[i]);
}

// ptrs: aicen vicen vsnon tsfcn eicen esnon aice0 rdg_conv rdg_shear tmask
// hin_max | aicen vicen vsnon tsfcn eicen esnon dardg1dt dardg2dt dvirdgdt
// opening fresh fhocn asum niter converged scratch | the ntrcr tracers in,
// the ntrcr tracers out; ints: P ncat nilyr nslyr ntrcr krdg_partic
// krdg_redist nitermax tcode[ntrcr]; par: RidgeParams in order
template <typename T>
int launch_ridge(const int64_t* ptrs, const int64_t* ints, const double* par,
                 cudaStream_t stream) {
  RidgeArgs<T> a{};
  a.aicen = cptr<T>(ptrs, 0);
  a.vicen = cptr<T>(ptrs, 1);
  a.vsnon = cptr<T>(ptrs, 2);
  a.tsfcn = cptr<T>(ptrs, 3);
  a.eicen = cptr<T>(ptrs, 4);
  a.esnon = cptr<T>(ptrs, 5);
  a.aice0 = cptr<T>(ptrs, 6);
  a.rdg_conv = cptr<T>(ptrs, 7);
  a.rdg_shear = cptr<T>(ptrs, 8);
  a.tmask = reinterpret_cast<const bool*>(ptrs[9]);
  a.hin_max = reinterpret_cast<const double*>(ptrs[10]);
  a.o_aicen = mptr<T>(ptrs, 11);
  a.o_vicen = mptr<T>(ptrs, 12);
  a.o_vsnon = mptr<T>(ptrs, 13);
  a.o_tsfcn = mptr<T>(ptrs, 14);
  a.o_eicen = mptr<T>(ptrs, 15);
  a.o_esnon = mptr<T>(ptrs, 16);
  a.dardg1dt = mptr<T>(ptrs, 17);
  a.dardg2dt = mptr<T>(ptrs, 18);
  a.dvirdgdt = mptr<T>(ptrs, 19);
  a.opening = mptr<T>(ptrs, 20);
  a.fresh = mptr<T>(ptrs, 21);
  a.fhocn = mptr<T>(ptrs, 22);
  a.asum = mptr<T>(ptrs, 23);
  a.niter = reinterpret_cast<int32_t*>(ptrs[24]);
  a.converged = reinterpret_cast<bool*>(ptrs[25]);
  a.scratch = mptr<T>(ptrs, 26);
  a.P = ints[0];
  a.ncat = int(ints[1]);
  a.nilyr = int(ints[2]);
  a.nslyr = int(ints[3]);
  a.ntrcr = int(ints[4]);
  a.krdg_partic = int(ints[5]);
  a.krdg_redist = int(ints[6]);
  a.nitermax = int(ints[7]);
  if (a.ntrcr < 0 || a.ntrcr > kMaxTracers) return kErrTracers;
  for (int t = 0; t < a.ntrcr; ++t) {
    a.tcode[t] = int(ints[8 + t]);
    a.trcrn[t] = mptr<T>(ptrs, 27 + t);
    a.o_trcrn[t] = mptr<T>(ptrs, 27 + a.ntrcr + t);
  }
  a.p = RidgeParams{par[0], par[1], par[2],  par[3],  par[4],
                    par[5], par[6], par[7],  par[8],  par[9],
                    par[10], par[11], par[12], par[13], par[14]};
  if (a.P == 0) return 0;
  size_t smem = 0;
  if (a.scratch == nullptr) {
    smem = size_t(ridge_slots(a.ncat)) * kThreads * sizeof(T);
    if (int64_t(smem) > kMaxSmem) return int(cudaErrorInvalidValue);
    cudaFuncSetAttribute(ridge_column<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(smem));
  }
  const int64_t blocks = (a.P + kThreads - 1) / kThreads;
  ridge_column<T><<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: aicen vicen vsnon tsfcn eicen esnon tmask hin_max | aicen vicen
// vsnon tsfcn eicen esnon dfresh dfsalt dfhocn scratch | the ntrcr tracers
// in, the ntrcr tracers out; ints: P ncat nilyr nslyr ntrcr limit_aice
// tcode[ntrcr]; par: CleanupParams in order
template <typename T>
int launch_cleanup(const int64_t* ptrs, const int64_t* ints,
                   const double* par, cudaStream_t stream) {
  CleanupArgs<T> a{};
  a.aicen = cptr<T>(ptrs, 0);
  a.vicen = cptr<T>(ptrs, 1);
  a.vsnon = cptr<T>(ptrs, 2);
  a.tsfcn = cptr<T>(ptrs, 3);
  a.eicen = cptr<T>(ptrs, 4);
  a.esnon = cptr<T>(ptrs, 5);
  a.tmask = reinterpret_cast<const bool*>(ptrs[6]);
  a.hin_max = reinterpret_cast<const double*>(ptrs[7]);
  a.o_aicen = mptr<T>(ptrs, 8);
  a.o_vicen = mptr<T>(ptrs, 9);
  a.o_vsnon = mptr<T>(ptrs, 10);
  a.o_tsfcn = mptr<T>(ptrs, 11);
  a.o_eicen = mptr<T>(ptrs, 12);
  a.o_esnon = mptr<T>(ptrs, 13);
  a.dfresh = mptr<T>(ptrs, 14);
  a.dfsalt = mptr<T>(ptrs, 15);
  a.dfhocn = mptr<T>(ptrs, 16);
  a.scratch = mptr<T>(ptrs, 17);
  a.P = ints[0];
  a.ncat = int(ints[1]);
  a.nilyr = int(ints[2]);
  a.nslyr = int(ints[3]);
  a.ntrcr = int(ints[4]);
  a.limit_aice = int(ints[5]);
  if (a.ntrcr < 0 || a.ntrcr > kMaxTracers) return kErrTracers;
  for (int t = 0; t < a.ntrcr; ++t) {
    a.tcode[t] = int(ints[6 + t]);
    a.trcrn[t] = mptr<T>(ptrs, 18 + t);
    a.o_trcrn[t] = mptr<T>(ptrs, 18 + a.ntrcr + t);
  }
  a.p = CleanupParams{par[0], par[1], par[2], par[3],
                      par[4], par[5], par[6], par[7]};
  if (a.P == 0) return 0;
  size_t smem = 0;
  if (a.scratch == nullptr) {
    smem = size_t(cleanup_slots(a.ncat, a.ntrcr)) * kThreads * sizeof(T);
    if (int64_t(smem) > kMaxSmem) return int(cudaErrorInvalidValue);
    cudaFuncSetAttribute(cleanup_column<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(smem));
  }
  const int64_t blocks = (a.P + kThreads - 1) / kThreads;
  cleanup_column<T><<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ridge_column_f32(const int64_t* ptrs, const int64_t* ints,
                     const double* par, void* stream) {
  return launch_ridge<float>(ptrs, ints, par,
                             static_cast<cudaStream_t>(stream));
}

int ridge_column_f64(const int64_t* ptrs, const int64_t* ints,
                     const double* par, void* stream) {
  return launch_ridge<double>(ptrs, ints, par,
                              static_cast<cudaStream_t>(stream));
}

int cleanup_column_f32(const int64_t* ptrs, const int64_t* ints,
                       const double* par, void* stream) {
  return launch_cleanup<float>(ptrs, ints, par,
                               static_cast<cudaStream_t>(stream));
}

int cleanup_column_f64(const int64_t* ptrs, const int64_t* ints,
                       const double* par, void* stream) {
  return launch_cleanup<double>(ptrs, ints, par,
                                static_cast<cudaStream_t>(stream));
}

// the (slot, ny, nx) scratch tensor a launch of `kernel` (0 ridge_column,
// 1 cleanup_column) needs at these counts and `elem` bytes a word: 0 slots
// where a block's work slots fit in shared memory, else one slot plane
// for each
int64_t column_scratch_slots(int kernel, int ncat, int ntrcr, int elem) {
  const int64_t slots =
      kernel == 0 ? ridge_slots(ncat) : cleanup_slots(ncat, ntrcr);
  return slots * kThreads * elem <= kMaxSmem ? 0 : slots;
}

}  // extern "C"
