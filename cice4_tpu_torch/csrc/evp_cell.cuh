// evp_cell.cuh — the EVP arithmetic of one T cell and of one U point, shared
// by the whole-grid kernel (evp_subcycle.cu) and the tiled round kernel
// (evp_rounds.cu), so that its expressions exist once in CUDA.
//
//  * stress_cell: the corner strain rates of a T cell from the velocities at
//    its four U corners, the relaxation of its 12 corner stresses and the 8
//    str8 flux pieces of the relaxed stresses (cice4_tpu_torch/ops/evp.py
//    _strain_rates, _stress_relax, _str8_from_stress), and on request the
//    corner sums and prs_sig of the final subcycle;
//  * momentum_point: the 2x2 implicit momentum solve of a U point from the
//    str8 pieces at the point and its E, N and NE neighbours (_stepu).
//
// Both follow the plain version expression by expression, in the same order;
// the sources that include this header are built with -fmad=false, so no
// a*b+c is contracted.

#pragma once

#include <cuda_runtime.h>

namespace evp {

constexpr double p055 = 1.0 / 18.0;
constexpr double p111 = 1.0 / 9.0;
constexpr double p166 = 1.0 / 6.0;
constexpr double p222 = 2.0 / 9.0;
constexpr double p25 = 0.25;
constexpr double p333 = 1.0 / 3.0;
constexpr double p5 = 0.5;

// the derived EVP constants (ops/evp.py EvpParams) in the working type
template <typename T>
struct Params {
  T dte2T, denom1, denom2, rcon, ecci, cosw, sinw, dragw, puny;
  bool damping, hemi;
};

// from the wrappers' table of 9 doubles (dte2T, denom1, denom2, rcon, ecci,
// cosw, sinw, dragw, puny) and flags (bit 0 evp_damping, bit 1 hemi_turning)
template <typename T>
Params<T> make_params(const double* par, int flags) {
  Params<T> p;
  p.dte2T = T(par[0]);
  p.denom1 = T(par[1]);
  p.denom2 = T(par[2]);
  p.rcon = T(par[3]);
  p.ecci = T(par[4]);
  p.cosw = T(par[5]);
  p.sinw = T(par[6]);
  p.dragw = T(par[7]);
  p.puny = T(par[8]);
  p.damping = (flags & 1) != 0;
  p.hemi = (flags & 2) != 0;
  return p;
}

// a T cell's geometry and strength
template <typename T>
struct CellGeom {
  T cyp, cxp, cym, cxm, dxt, dyt, dxhy, dyhx, tiny, strength;
};

// a U point's constants of the momentum solve
template <typename T>
struct PointConst {
  T aiu, uocn, vocn, waterx, watery, forcex, forcey, umassdtei, fm, uarear;
};

// The stress pass of one T cell: strain rates from the velocities at its U
// corners (NE u, v; W u_w, v_w; S u_s, v_s; SW u_sw, v_sw), the stresses
// sp, sm, s12 relaxed in place (zero when !icet), str the 8 str8 pieces of
// the relaxed stresses (zero when !icet); with FINAL, sums holds the corner
// sums of div, delta, ten, shr and prs_sig.
template <typename T, bool FINAL>
__device__ __forceinline__ void stress_cell(
    const Params<T>& a, const CellGeom<T>& g, T u, T u_w, T u_s, T u_sw,
    T v, T v_w, T v_s, T v_sw, bool icet, T (&sp)[4], T (&sm)[4],
    T (&s12)[4], T (&str)[8], T* sums) {
  const T cyp = g.cyp, cxp = g.cxp, cym = g.cym, cxm = g.cxm, dxt = g.dxt,
          dyt = g.dyt;

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

  const T strength = g.strength;
  const T tiny = g.tiny;
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

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (icet) {
      sp[k] = (sp[k] + c1[k] * (div[k] - delta[k])) * a.denom1;
      sm[k] = (sm[k] + c1[k] * ten[k]) * a.denom2;
      s12[k] = (s12[k] + c1[k] * shr[k] * T(p5)) * a.denom2;
    } else {
      sp[k] = sm[k] = s12[k] = T(0);
    }
  }

  if (FINAL) {
    sums[0] = div[0] + div[1] + div[2] + div[3];
    sums[1] = delta[0] + delta[1] + delta[2] + delta[3];
    sums[2] = ten[0] + ten[1] + ten[2] + ten[3];
    sums[3] = shr[0] + shr[1] + shr[2] + shr[3];
    sums[4] = prs;
  }

  // str8 (_str8_from_stress)
  if (icet) {
    const T dxhy = g.dxhy, dyhx = g.dyhx;
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
}

// The momentum solve of one icy U point from the str8 pieces s0 (piece 0 at
// the point), s1e (1 at E), s2n (2 at N), s3ne (3 at NE), s4 (4 at the
// point), s5n (5 at N), s6e (6 at E), s7ne (7 at NE): u, v updated in place;
// with FINAL, out holds strintx, strinty, taux, tauy.
template <typename T, bool FINAL>
__device__ __forceinline__ void momentum_point(
    const Params<T>& a, const PointConst<T>& q, T& u, T& v, T s0, T s1e,
    T s2n, T s3ne, T s4, T s5n, T s6e, T s7ne, T* out) {
  const T du = q.uocn - u, dv = q.vocn - v;
  const T vrel = q.aiu * a.dragw * sqrt(du * du + dv * dv);
  const T taux = vrel * q.waterx;
  const T tauy = vrel * q.watery;
  const T cca = q.umassdtei + vrel * a.cosw;
  const T sgn = (a.hemi && q.fm < T(0)) ? T(-1) : T(1);
  const T ccb = q.fm + sgn * vrel * a.sinw;
  const T ab2 = cca * cca + ccb * ccb;

  const T strintx = q.uarear * (s0 + s1e + s2n + s3ne);
  const T strinty = q.uarear * (s4 + s5n + s6e + s7ne);

  const T cc1 = strintx + q.forcex + taux + q.umassdtei * u;
  const T cc2 = strinty + q.forcey + tauy + q.umassdtei * v;
  const T den = fmax(ab2, a.puny);
  u = (cca * cc1 + ccb * cc2) / den;
  v = (cca * cc2 - ccb * cc1) / den;
  if (FINAL) {
    out[0] = strintx;
    out[1] = strinty;
    out[2] = taux;
    out[3] = tauy;
  }
}

}  // namespace evp
