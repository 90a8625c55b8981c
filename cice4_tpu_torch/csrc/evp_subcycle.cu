// evp_subcycle.cu — the EVP subcycle loop (stress relaxation + momentum
// solve, ndte times) on Hopper.
//
// Replaces the TPU kernels cice4_tpu/ops/evp_pallas.py::_kernel_blocked
// (:210-334; host code _evp_pallas_blocked :374-440), taken on grids that are
// closed or open north-south, and ::_kernel (:83-144; host code
// _evp_pallas_wholegrid :443-486), the whole-grid kernel taken on grids that
// are cyclic north-south.  On the GPU one kernel serves both: the per-cell
// gating below is exact on any boundary, so the whole-grid kernel is this
// one with the NS wrap of its neighbour reads (ns_cyclic).  It computes
// what the plain version cice4_tpu_torch/ops/evp.py::_evp_subcycle_plain
// computes:
// per subcycle, the corner strain rates from the old velocities, the
// relaxation of the 12 corner stresses and the 8 str8 flux pieces
// (_stress_relax, _str8_from_stress), then the 2x2 implicit momentum solve
// from the fresh str8 of the point and its E, N and NE neighbours (_stepu).
// That is the Jacobi update which the TPU kernel's north-to-south block order
// also realises.
//
// Design.  Two kernels per subcycle, one thread per grid point:
//  * stress pass, one thread per T cell: reads u, v at the cell's four U
//    corners, updates the cell's 12 stresses in place and writes its 8 str8
//    pieces to a scratch buffer;
//  * momentum pass, one thread per U point: reads str8 at the point and its
//    E, N, NE neighbours and updates u, v in place.
// The kernel boundary between the two passes is the grid-wide barrier that
// the TPU got from running blocks in order: the stress pass reads velocities
// and writes only same-cell stresses, the momentum pass reads only
// same-point velocities, so no double buffer is needed.  str8 is stored, not
// recomputed in the momentum pass as on the TPU: recomputing it for four
// neighbours would read 4 x 12 stresses per point instead of 4 x 2 str8
// values, and the TPU only recomputed because it had no grid-wide barrier.
// The last subcycle runs the same two kernels with FINAL set: they also write
// strintx/y, strocnx/y, the corner sums of div, delta, ten, shr and prs_sig.
//
// Activity gating: a T cell outside icetmask keeps zero stresses and str8,
// and a U point outside iceumask zero velocities (the reference's
// icellt/icellu lists, the TPU kernel's skipped blocks), so their threads
// return at once in the non-final passes.  This is exact given the
// masked-zero invariant (stresses zero off icetmask, velocities zero off
// iceumask, str8 zero-initialised), which the wrapper enforces.
//
// Boundaries: EW and NS cyclic wrap (the corner read (j-1, i-1) wraps on both
// axes), EW and NS open/closed read 0 beyond the edge (evp_pallas.py
// KernelNbr).  Tripole folds are not handled.
//
// What bounds it on an H100: memory traffic and launch count.  A subcycle
// reads about 38 (ny, nx) planes and writes 22 (counted in PERF.md); at gx1 in
// f32 that is ~29 MB per subcycle if every cell were active, ~3.5 GB per
// call of 120 subcycles, ~1 ms at 3.35 TB/s.  The working set (~25 MB at
// gx1 f32) fits in the 50 MB L2, so most of it should come from L2, and the
// 240 short launches per call may bind first.  Gating cuts the traffic to
// the icy share of the grid.
//
// Arithmetic follows the plain version expression by expression, in the same
// order; the source is built with -fmad=false so that no a*b+c is contracted.
//
// C interface: evp_subcycle_f32 / evp_subcycle_f64 take a table of 37
// pointers, the grid size, the EW and NS boundaries (1 = cyclic), a table of
// 9 double parameters,
// ndte, flags (bit 0 evp_damping, bit 1 hemi_turning) and the CUDA stream;
// they return cudaGetLastError() after the launches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr double p055 = 1.0 / 18.0;
constexpr double p111 = 1.0 / 9.0;
constexpr double p166 = 1.0 / 6.0;
constexpr double p222 = 2.0 / 9.0;
constexpr double p25 = 0.25;
constexpr double p333 = 1.0 / 3.0;
constexpr double p5 = 0.5;

// pointer-table layout (cice4_tpu_torch/ops/evp_cuda.py)
enum Ptr {
  CYP, CXP, CYM, CXM, DXT, DYT, DXHY, DYHX, TINYAREA, UAREAR,
  STRENGTH, ICET, ICEU, AIU, UOCN, VOCN, WATERX, WATERY, FORCEX, FORCEY,
  UMASSDTEI, FM,
  UVEL, VVEL, STRESSP, STRESSM, STRESS12, STR8,
  STRINTX, STRINTY, STROCNX, STROCNY, DIVSUM, DELTASUM, TENSUM, SHRSUM,
  PRSSIG, kNumPtr
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
  int ny, nx, ew_cyclic, ns_cyclic;
  T dte2T, denom1, denom2, rcon, ecci, cosw, sinw, dragw, puny;
  bool damping, hemi;
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

template <typename T, bool FINAL>
__global__ void stress_pass(Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= a.nx || j >= a.ny) return;
  const int64_t c = (int64_t)j * a.nx + i;
  const int64_t np = (int64_t)a.ny * a.nx;
  const bool icet = a.icet[c];
  if (!FINAL && !icet) return;

  const T u = a.u[c], u_w = at(a.u, j, i - 1, a), u_s = at(a.u, j - 1, i, a),
          u_sw = at(a.u, j - 1, i - 1, a);
  const T v = a.v[c], v_w = at(a.v, j, i - 1, a), v_s = at(a.v, j - 1, i, a),
          v_sw = at(a.v, j - 1, i - 1, a);
  const T cyp = a.geom[0][c], cxp = a.geom[1][c], cym = a.geom[2][c],
          cxm = a.geom[3][c], dxt = a.geom[4][c], dyt = a.geom[5][c];

  T div[4], ten[4], shr[4];
  div[0] = cyp * u - dyt * u_w + cxp * v - dxt * v_s;
  div[1] = cym * u_w + dyt * u + cxp * v_w - dxt * v_sw;
  div[2] = cym * u_sw + dyt * u_s + cxm * v_sw + dxt * v_w;
  div[3] = cyp * u_s - dyt * u_sw + cxm * v_s + dxt * v;

  ten[0] = -cym * u - dyt * u_w + cxm * v + dxt * v_s;
  ten[1] = -cyp * u_w + dyt * u + cxm * v_w + dxt * v_sw;
  ten[2] = -cyp * u_sw + dyt * u_s + cxp * v_sw - dxt * v_w;
  ten[3] = -cym * u_s - dyt * u_sw + cxp * v_s - dxt * v;

  shr[0] = -cym * v - dyt * v_w - cxm * u - dxt * u_s;
  shr[1] = -cyp * v_w + dyt * v - cxm * u_w - dxt * u_sw;
  shr[2] = -cyp * v_sw + dyt * v_s - cxp * u_sw + dxt * u_w;
  shr[3] = -cym * v_s - dyt * v_sw - cxp * u_s + dxt * u;

  const T strength = a.strength[c];
  const T tiny = a.geom[8][c];
  T delta[4], c1[4];
  T prs = T(0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    delta[k] = sqrt(div[k] * div[k] + a.ecci * (ten[k] * ten[k] +
                                                shr[k] * shr[k]));
    T c0;
    if (a.damping) {
      const T floor = T(4.0) * tiny;
      c0 = fmin(strength / fmax(delta[k], floor), a.rcon);
      if (k == 0) prs = strength * delta[0] / fmax(delta[0], floor);
    } else {
      c0 = strength / fmax(delta[k], tiny);
      if (k == 0) prs = c0 * delta[0];
    }
    c1[k] = c0 * a.dte2T;
  }

  T sp[4], sm[4], s12[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t ck = k * np + c;
    if (icet) {
      sp[k] = (a.sp[ck] + c1[k] * (div[k] - delta[k])) * a.denom1;
      sm[k] = (a.sm[ck] + c1[k] * ten[k]) * a.denom2;
      s12[k] = (a.s12[ck] + c1[k] * shr[k] * T(p5)) * a.denom2;
    } else {
      sp[k] = sm[k] = s12[k] = T(0);
    }
    a.sp[ck] = sp[k];
    a.sm[ck] = sm[k];
    a.s12[ck] = s12[k];
  }

  if (FINAL) {
    a.out[4][c] = div[0] + div[1] + div[2] + div[3];
    a.out[5][c] = delta[0] + delta[1] + delta[2] + delta[3];
    a.out[6][c] = ten[0] + ten[1] + ten[2] + ten[3];
    a.out[7][c] = shr[0] + shr[1] + shr[2] + shr[3];
    a.out[8][c] = prs;
  }

  // str8 (_str8_from_stress)
  T str[8];
  if (icet) {
    const T dxhy = a.geom[6][c], dyhx = a.geom[7][c];
    const T P055 = T(p055), P111 = T(p111), P166 = T(p166), P222 = T(p222),
            P25 = T(p25), P333 = T(p333), P5 = T(p5), P0555 = T(p055 * p5);
    const T ssigpn = sp[0] + sp[1], ssigps = sp[2] + sp[3],
            ssigpe = sp[0] + sp[3], ssigpw = sp[1] + sp[2],
            ssigp1 = (sp[0] + sp[2]) * P055, ssigp2 = (sp[1] + sp[3]) * P055;
    const T ssigmn = sm[0] + sm[1], ssigms = sm[2] + sm[3],
            ssigme = sm[0] + sm[3], ssigmw = sm[1] + sm[2],
            ssigm1 = (sm[0] + sm[2]) * P055, ssigm2 = (sm[1] + sm[3]) * P055;
    const T ssig12n = s12[0] + s12[1], ssig12s = s12[2] + s12[3],
            ssig12e = s12[0] + s12[3], ssig12w = s12[1] + s12[2],
            ssig121 = (s12[0] + s12[2]) * P111,
            ssig122 = (s12[1] + s12[3]) * P111;

    const T csigpne = P111 * sp[0] + ssigp2 + P0555 * sp[2];
    const T csigpnw = P111 * sp[1] + ssigp1 + P0555 * sp[3];
    const T csigpsw = P111 * sp[2] + ssigp2 + P0555 * sp[0];
    const T csigpse = P111 * sp[3] + ssigp1 + P0555 * sp[1];

    const T csigmne = P111 * sm[0] + ssigm2 + P0555 * sm[2];
    const T csigmnw = P111 * sm[1] + ssigm1 + P0555 * sm[3];
    const T csigmsw = P111 * sm[2] + ssigm2 + P0555 * sm[0];
    const T csigmse = P111 * sm[3] + ssigm1 + P0555 * sm[1];

    const T csig12ne = P222 * s12[0] + ssig122 + P055 * s12[2];
    const T csig12nw = P222 * s12[1] + ssig121 + P055 * s12[3];
    const T csig12sw = P222 * s12[2] + ssig122 + P055 * s12[0];
    const T csig12se = P222 * s12[3] + ssig121 + P055 * s12[1];

    const T str12ew = P5 * dxt * (P333 * ssig12e + P166 * ssig12w);
    const T str12we = P5 * dxt * (P333 * ssig12w + P166 * ssig12e);
    const T str12ns = P5 * dyt * (P333 * ssig12n + P166 * ssig12s);
    const T str12sn = P5 * dyt * (P333 * ssig12s + P166 * ssig12n);

    T strp = P25 * dyt * (P333 * ssigpn + P166 * ssigps);
    T strm = P25 * dyt * (P333 * ssigmn + P166 * ssigms);
    str[0] = -strp - strm - str12ew + dxhy * (-csigpne + csigmne) +
             dyhx * csig12ne;
    str[1] = strp + strm - str12we + dxhy * (-csigpnw + csigmnw) +
             dyhx * csig12nw;
    strp = P25 * dyt * (P333 * ssigps + P166 * ssigpn);
    strm = P25 * dyt * (P333 * ssigms + P166 * ssigmn);
    str[2] = -strp - strm + str12ew + dxhy * (-csigpse + csigmse) +
             dyhx * csig12se;
    str[3] = strp + strm + str12we + dxhy * (-csigpsw + csigmsw) +
             dyhx * csig12sw;

    strp = P25 * dxt * (P333 * ssigpe + P166 * ssigpw);
    strm = P25 * dxt * (P333 * ssigme + P166 * ssigmw);
    str[4] = -strp + strm - str12ns - dyhx * (csigpne + csigmne) +
             dxhy * csig12ne;
    str[5] = strp - strm - str12sn - dyhx * (csigpse + csigmse) +
             dxhy * csig12se;
    strp = P25 * dxt * (P333 * ssigpw + P166 * ssigpe);
    strm = P25 * dxt * (P333 * ssigmw + P166 * ssigme);
    str[6] = -strp + strm + str12ns - dyhx * (csigpnw + csigmnw) +
             dxhy * csig12nw;
    str[7] = strp - strm + str12sn - dyhx * (csigpsw + csigmsw) +
             dxhy * csig12sw;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) str[k] = T(0);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) a.str8[k * np + c] = str[k];
}

template <typename T, bool FINAL>
__global__ void momentum_pass(Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= a.nx || j >= a.ny) return;
  const int64_t c = (int64_t)j * a.nx + i;
  const int64_t np = (int64_t)a.ny * a.nx;
  const bool iceu = a.iceu[c];
  if (!iceu) {
    if (FINAL) {
      a.u[c] = T(0);
      a.v[c] = T(0);
#pragma unroll
      for (int k = 0; k < 4; ++k) a.out[k][c] = T(0);
    }
    return;
  }
  const T aiu = a.c[0][c], uocn = a.c[1][c], vocn = a.c[2][c];
  const T waterx = a.c[3][c], watery = a.c[4][c];
  const T forcex = a.c[5][c], forcey = a.c[6][c];
  const T umassdtei = a.c[7][c], fm = a.c[8][c];
  const T u = a.u[c], v = a.v[c];

  const T du = uocn - u, dv = vocn - v;
  const T vrel = aiu * a.dragw * sqrt(du * du + dv * dv);
  const T taux = vrel * waterx;
  const T tauy = vrel * watery;
  const T cca = umassdtei + vrel * a.cosw;
  const T sgn = (a.hemi && fm < T(0)) ? T(-1) : T(1);
  const T ccb = fm + sgn * vrel * a.sinw;
  const T ab2 = cca * cca + ccb * ccb;

  const T* s = a.str8;
  const T s0 = s[c], s4 = s[4 * np + c];
  const T s1e = at(s + 1 * np, j, i + 1, a), s6e = at(s + 6 * np, j, i + 1, a);
  const T s2n = at(s + 2 * np, j + 1, i, a), s5n = at(s + 5 * np, j + 1, i, a);
  const T s3ne = at(s + 3 * np, j + 1, i + 1, a),
          s7ne = at(s + 7 * np, j + 1, i + 1, a);
  const T uarear = a.geom[9][c];
  const T strintx = uarear * (s0 + s1e + s2n + s3ne);
  const T strinty = uarear * (s4 + s5n + s6e + s7ne);

  const T cc1 = strintx + forcex + taux + umassdtei * u;
  const T cc2 = strinty + forcey + tauy + umassdtei * v;
  const T den = fmax(ab2, a.puny);
  a.u[c] = (cca * cc1 + ccb * cc2) / den;
  a.v[c] = (cca * cc2 - ccb * cc1) / den;
  if (FINAL) {
    a.out[0][c] = strintx;
    a.out[1][c] = strinty;
    a.out[2][c] = taux;
    a.out[3][c] = tauy;
  }
}

template <typename T>
int run(const int64_t* ptrs, int ny, int nx, int ew_cyclic, int ns_cyclic,
        const double* par, int ndte, int flags, cudaStream_t stream) {
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
  a.ny = ny;
  a.nx = nx;
  a.ew_cyclic = ew_cyclic;
  a.ns_cyclic = ns_cyclic;
  a.dte2T = T(par[0]);
  a.denom1 = T(par[1]);
  a.denom2 = T(par[2]);
  a.rcon = T(par[3]);
  a.ecci = T(par[4]);
  a.cosw = T(par[5]);
  a.sinw = T(par[6]);
  a.dragw = T(par[7]);
  a.puny = T(par[8]);
  a.damping = (flags & 1) != 0;
  a.hemi = (flags & 2) != 0;

  const dim3 block(32, 4);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  // str8 starts at zero: gated cells never write it
  cudaMemsetAsync(a.str8, 0, sizeof(T) * 8 * (size_t)ny * nx, stream);
  for (int n = 0; n < ndte - 1; ++n) {
    stress_pass<T, false><<<grid, block, 0, stream>>>(a);
    momentum_pass<T, false><<<grid, block, 0, stream>>>(a);
  }
  stress_pass<T, true><<<grid, block, 0, stream>>>(a);
  momentum_pass<T, true><<<grid, block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int evp_subcycle_f32(const int64_t* ptrs, int ny, int nx, int ew_cyclic,
                     int ns_cyclic, const double* par, int ndte, int flags,
                     void* stream) {
  return run<float>(ptrs, ny, nx, ew_cyclic, ns_cyclic, par, ndte, flags,
                    static_cast<cudaStream_t>(stream));
}

int evp_subcycle_f64(const int64_t* ptrs, int ny, int nx, int ew_cyclic,
                     int ns_cyclic, const double* par, int ndte, int flags,
                     void* stream) {
  return run<double>(ptrs, ny, nx, ew_cyclic, ns_cyclic, par, ndte, flags,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
