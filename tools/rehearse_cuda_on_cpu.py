"""Rehearse the port's dynamics kernels on the CPU, without a card or nvcc.

    python tools/rehearse_cuda_on_cpu.py [--out build/cpu_rehearsal]

Compiles ``evp_subcycle.cu``, ``evp_rounds.cu``, ``remap_gsh.cu``,
``remap_k12.cu``, ``therm_newton.cu``, ``ridge_column.cu`` and
``gfdl_column.cu`` (with the headers they include)
with ``g++ -std=c++20 -ffp-contract=off`` against a stand-in CUDA
runtime written into ``--out``: each block's
threads run as ``std::thread``s meeting at a ``std::barrier``, blocks one
after another, or, for the EVP kernel's cooperative launch, every block
at once with a grid-wide barrier; ``__ballot_sync`` and
``__shfl_down_sync`` meet at a barrier of their warp; ``cp.async`` is a
plain copy.  The kernels' C interfaces are then called through ctypes on
CPU tensors and each result is held against the plain PyTorch version
with the tolerances of ``cice4_tpu_torch.kernel_check``, on small
ragged shapes and every boundary pair the kernels take, the tripole and
tripoleT folds on the all-ocean grid included, in f32 and f64;
``therm_newton`` through its wrapper (the runtime's stream and device
calls stood in), its generic instance at several layer counts and bit for
bit against the register instance at (4, 1); ``ridge_column`` and
``cleanup_column`` through their wrappers against ``ridge_ice``'s and
``cleanup_itd``'s plain versions, for both ridging options each, three
tracer sets, ten ice layers, the delta-function ITD's category-1 bound
and twelve categories (whose work slots exceed shared memory in f64);
``gfdl_column`` through its wrapper against the plain GFDL fluxes under
each option (``--gfdl`` alone: ~1 min).  The stand-in's ``exp`` of a float is the double one's, so f32
Newton results agree within tolerance; the CPU's plain versions divide by
a Python number where the card's multiply by its reciprocal, and sum in
another order, so the column kernels agree with them within tolerance.

What it shows: that the kernels' index arithmetic, masking, staging and
synchronisation compute the plain version's function.  What it cannot
show: that nvcc accepts the source for sm_90a, the card's timing, or
faults that only the card's memory model or warp scheduling brings out.
Exits non-zero when a case disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cice4_tpu_torch import constants as cn  # noqa: E402
from cice4_tpu_torch import kernel_check as kc  # noqa: E402
from cice4_tpu_torch.config import Config, DynamicsConfig  # noqa: E402
from cice4_tpu_torch.grid import make_grid  # noqa: E402
from cice4_tpu_torch.ops import evp as evp_ops  # noqa: E402
from cice4_tpu_torch.ops import evp_cuda, remap_cuda  # noqa: E402
from cice4_tpu_torch.ops.remap import _tracer_meta  # noqa: E402

RUNTIME = r"""#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::exp;
using std::fabs;
using std::fmax;
using std::fmin;
using std::max;
using std::min;
using std::sqrt;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
inline thread_local uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local std::barrier<>* g_bar = nullptr;
inline thread_local unsigned char* g_dyn_smem = nullptr;
inline thread_local unsigned char* g_block_shared = nullptr;
struct Warp { std::barrier<> bar{32}; int slot[32]; };
inline thread_local Warp* g_warp = nullptr;
inline std::barrier<>* g_grid_bar = nullptr;
inline thread_local int* g_block_or = nullptr;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
// every thread's flag ORed; a barrier first, so that the last call's
// reset (by thread 0, after its read) precedes this call's stores
inline int __syncthreads_or(int p) {
  g_bar->arrive_and_wait();
  if (p) __atomic_store_n(g_block_or, 1, __ATOMIC_SEQ_CST);
  g_bar->arrive_and_wait();
  const int r = __atomic_load_n(g_block_or, __ATOMIC_SEQ_CST);
  g_bar->arrive_and_wait();
  if (threadIdx.x == 0) __atomic_store_n(g_block_or, 0, __ATOMIC_SEQ_CST);
  return r;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  const int lane = threadIdx.x & 31;
  g_warp->slot[lane] = p;
  g_warp->bar.arrive_and_wait();
  unsigned m = 0;
  for (int k = 0; k < 32; ++k) m |= (unsigned)(g_warp->slot[k] != 0) << k;
  g_warp->bar.arrive_and_wait();
  return m;
}
inline int __shfl_down_sync(unsigned, int x, int d) {
  const int lane = threadIdx.x & 31;
  g_warp->slot[lane] = x;
  g_warp->bar.arrive_and_wait();
  const int v = lane + d < 32 ? g_warp->slot[lane + d] : x;
  g_warp->bar.arrive_and_wait();
  return v;
}
inline int __popc(unsigned m) { return __builtin_popcount(m); }
inline int atomicMax(int* a, int v) {
  int old = __atomic_load_n(a, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(
                        a, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9,
       cudaErrorCooperativeLaunchTooLarge = 82 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16,
                      cudaDevAttrCooperativeLaunch = 95 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
// three "SMs", one resident block each
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? 3 : 1;
  return 0;
}
template <class K> int cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}
struct cudaFuncAttributes { int numRegs = 0; size_t localSizeBytes = 0; };
template <class K> int cudaFuncGetAttributes(cudaFuncAttributes*, K) {
  return 0;
}
template <class K>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}
// a launch: the blocks one after another, a block's threads at once
template <class F, class... A>
void launch(F f, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  gridDim = grid;
  blockDim = block;
  std::vector<unsigned char> buf(smem + 64);
  const unsigned n = block.x * block.y * block.z;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::memset(buf.data(), 0xcd, buf.size());  // garbage, as on a card
      std::barrier<> bar(n);
      int block_or = 0;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < n; ++t)
        ts.emplace_back([&, t] {
          blockIdx = {bx, by, 0};
          threadIdx = {t % block.x, (t / block.x) % block.y,
                       t / (block.x * block.y)};
          g_bar = &bar;
          g_block_or = &block_or;
          g_dyn_smem = buf.data();
          f(args...);
          bar.arrive_and_drop();
        });
      for (auto& t : ts) t.join();
    }
}
// a cooperative launch: every block's threads at once, a grid barrier
template <class F, class A>
int coop_launch(F f, dim3 grid, dim3 block, A arg) {
  gridDim = grid;
  blockDim = block;
  const unsigned n = block.x * block.y * block.z, nb = grid.x;
  std::barrier<> gbar(n * nb);
  g_grid_bar = &gbar;
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  std::vector<std::vector<unsigned char>> shared(
      nb, std::vector<unsigned char>(4096));
  std::vector<std::vector<Warp>> warps(nb);
  for (unsigned b = 0; b < nb; ++b) {
    bars.emplace_back(new std::barrier<>(n));
    warps[b] = std::vector<Warp>(n / 32);
  }
  std::vector<std::thread> ts;
  for (unsigned b = 0; b < nb; ++b)
    for (unsigned t = 0; t < n; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx = {b, 0, 0};
        threadIdx = {t, 0, 0};
        g_bar = bars[b].get();
        g_block_shared = shared[b].data();
        g_warp = &warps[b][t / 32];
        f(arg);
        gbar.arrive_and_drop();
        bars[b]->arrive_and_drop();
      });
  for (auto& t : ts) t.join();
  return 0;
}
"""

COOPERATIVE_GROUPS = """#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group { void sync() { g_grid_bar->arrive_and_wait(); } };
inline grid_group this_grid() { return {}; }
}
"""

LIBRARIES = ("evp_subcycle", "evp_rounds", "remap_gsh", "remap_k12",
             "therm_newton", "ridge_column", "gfdl_column")


def translate(name: str, src: str) -> str:
    """The source as the stand-in runtime takes it."""
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "unsigned char* smem_raw = g_dyn_smem;")
    if name in ("remap_tile.cuh", "evp_rounds.cu"):
        src = re.sub(r"(void copy_async\(T\* dst, const T\* src\) \{).*?\n\}\n",
                     r"\1 *dst = *src; }\n", src, flags=re.S)
        src = src.replace('asm volatile("cp.async.commit_group;\\n" ::);', "")
        src = src.replace('asm volatile("cp.async.wait_group 0;\\n" ::);', "")
    if name == "evp_subcycle.cu":
        src = src.replace(
            "__shared__ int red[2][kMaxWarps];",
            "auto& red = *reinterpret_cast<int(*)[2][kMaxWarps]>("
            "g_block_shared);")
        src = re.sub(r"return static_cast<int>\(cudaLaunchCooperativeKernel\("
                     r"\s*kernel, dim3\(blocks\), dim3\(threads\), args, 0, "
                     r"stream\)\);",
                     "return ns >= 2 ? coop_launch(evp_persistent<T, true>, "
                     "dim3(blocks), dim3(threads), a) : coop_launch("
                     "evp_persistent<T, false>, dim3(blocks), dim3(threads), "
                     "a);", src)
        if "coop_launch" not in src:
            raise SystemExit("the cooperative launch was not translated")
    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\(", r"launch(\1, \2, ",
                  src, flags=re.S)


def build(out: Path, names=LIBRARIES) -> dict:
    src = out / "src"
    src.mkdir(parents=True, exist_ok=True)
    (out / "cuda_runtime.h").write_text(RUNTIME)
    (out / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS)
    for f in (ROOT / "cice4_tpu_torch" / "csrc").glob("*.cu*"):
        (src / f.name).write_text(translate(f.name, f.read_text()))
    procs = {name: subprocess.Popen(
        ["g++", "-x", "c++", "-std=c++20", "-O1", "-ffp-contract=off",
         "-fPIC", "-shared", f"-I{out}", f"-I{src}", "-o",
         str(out / f"lib{name}.so"), str(src / f"{name}.cu"), "-lpthread"])
        for name in names}
    for name, p in procs.items():
        if p.wait() != 0:
            raise SystemExit(f"g++ failed on {name}.cu")
    return {name: ctypes.CDLL(str(out / f"lib{name}.so"))
            for name in names}


def _sym(lib, name, dtype, argtypes):
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


V, I = ctypes.c_void_p, ctypes.c_int


def gsh_kernel(lib, dx, dy, afac, bc, order):
    ny, nx = dx.shape
    out = torch.full((9, 10, ny, nx), float("nan"), dtype=dx.dtype)
    codes = torch.zeros((2, ny, nx), dtype=torch.int32)
    rc = _sym(lib, "remap_gsh", dx.dtype, [V] * 5 + [I] * 6 + [V])(
        dx.data_ptr(), dy.data_ptr(), afac.data_ptr(), out.data_ptr(),
        codes.data_ptr(), ny, nx, remap_cuda.KERNEL_BC_CODE[bc.ew],
        remap_cuda.KERNEL_BC_CODE[bc.ns], order, 1, None)
    if rc:
        raise RuntimeError(f"remap_gsh returned {rc}")
    return out, codes


def k12_kernel(lib, gsh, hm, mm, tm, meta, bc):
    C, T = tm.shape[:2]
    ny, nx = hm.shape
    n1, par = remap_cuda._tracer_table("remap_k12", meta, T)
    div = torch.full((C, ny, nx), float("nan"), dtype=hm.dtype)
    divt = torch.full((C, T, ny, nx), float("nan"), dtype=hm.dtype)
    table = remap_cuda._int_table(par)
    rc = _sym(lib, "remap_k12", hm.dtype, [V] * 6 + [I] * 7 + [V] * 2)(
        gsh.data_ptr(), hm.data_ptr(), mm.data_ptr(), tm.data_ptr(),
        div.data_ptr(), divt.data_ptr(), C, T, n1, ny, nx,
        remap_cuda.KERNEL_BC_CODE[bc.ew], remap_cuda.KERNEL_BC_CODE[bc.ns],
        ctypes.addressof(table), None)
    if rc:
        raise RuntimeError(f"remap_k12 returned {rc}")
    return div, divt


def evp_kernel(lib, p, grid, *args):
    """`evp_cuda._evp_subcycle_cuda` on CPU tensors and the stand-in."""
    dtype, bc = args[-1].dtype, grid.bc
    ny, nx = grid.ny, grid.nx
    geom = [getattr(grid, k).contiguous() for k in evp_cuda._GEOM]
    const = list(args[:12])
    icet, iceu = const[1], const[2]
    state = [torch.where(iceu, x, 0.0) for x in args[12:14]] + [
        torch.where(icet, s, 0.0).contiguous() for s in args[14:17]]
    str8 = torch.empty((8, ny, nx), dtype=dtype)
    outs = [torch.empty((ny, nx), dtype=dtype) for _ in evp_cuda._OUT]
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    _sym(lib, "evp_subcycle_resident", dtype, [V, V])(
        ctypes.addressof(blocks), ctypes.addressof(threads))
    scratch = torch.empty(2 * blocks.value + len(evp_cuda._STATS)
                          + 2 * ny * nx, dtype=torch.int32)
    ptrs = [x.data_ptr() for x in geom + const + state + [str8] + outs
            + [scratch]]
    ptr_arr = (ctypes.c_int64 * len(ptrs))(*ptrs)
    par = [p.dte2T, p.denom1, p.denom2, p.rcon, p.ecci, p.cosw, p.sinw,
           p.dragw, cn.puny]
    par_arr = (ctypes.c_double * len(par))(*par)
    rc = _sym(lib, "evp_subcycle", dtype, [V, I, I, I, I, V, I, I, V])(
        ctypes.addressof(ptr_arr), ny, nx, int(bc.ew == "cyclic"),
        evp_cuda.KERNEL_BC_CODE[bc.ns], ctypes.addressof(par_arr), p.ndte,
        int(p.evp_damping) | (int(p.hemi_turning) << 1), None)
    if rc:
        raise RuntimeError(f"evp_subcycle returned {rc}")
    o = dict(zip(evp_cuda._OUT, outs))
    return (*state, {k: o[k] for k in evp_cuda._OUT[4:]}, *(
        o[k] for k in evp_cuda._OUT[:4]))


def rounds_kernel(lib, p, grid, *args, tile):
    """`evp_cuda._evp_rounds_cuda` on CPU tensors and the stand-in, with
    `tile` (rows, columns, most subcycles a launch) in place of
    `evp_cuda.ROUND_TILE`."""
    dtype = args[-1].dtype
    ny, nx = grid.ny, grid.nx
    const = [getattr(grid, k).contiguous() for k in evp_cuda._GEOM] + [
        x.contiguous() for x in args[:12]]
    state = [x.contiguous() for x in args[12:]]
    rows, cols, most = tile
    launches = evp_cuda.round_launches(p.ndte, most)
    par_arr, flags = evp_cuda._params(p)
    fn = _sym(lib, "evp_rounds", dtype, [V] + [I] * 5 + [V, I, V])
    for k in launches:
        out = [torch.full_like(x, float("nan")) for x in state]
        ptrs = [x.data_ptr() for x in const + state + out]
        ptr_arr = (ctypes.c_int64 * len(ptrs))(*ptrs)
        rc = fn(ctypes.addressof(ptr_arr), ny, nx, rows, cols, k,
                ctypes.addressof(par_arr), flags, None)
        if rc:
            raise RuntimeError(f"evp_rounds returned {rc}")
        state = out
    return state


def _stand_in(name, lib):
    """Load `lib` as the card's library `name` and stand in the runtime's
    device and stream calls that the wrappers make."""
    import contextlib
    from types import SimpleNamespace

    from cice4_tpu_torch import cuda_build

    cuda_build._loaded[name] = cuda_build.Library(
        lib=lib, path=Path(lib._name), built=True, seconds=0.0, log="")
    torch.cuda.device = lambda _d: contextlib.nullcontext()
    torch.cuda.current_stream = lambda _d=None: SimpleNamespace(
        cuda_stream=None)


BOTH = (torch.float64, torch.float32)
COLUMN_CASES = (
    # (name, configuration settings, krdg_partic, krdg_redist, types)
    ("gx1", {}, 1, 1, BOTH),
    ("gx1 Thorndike Hibler", {}, 0, 0, BOTH),
    ("lvl+pond nilyr 10", {"tracers.tr_lvl": True, "tracers.tr_pond": True,
                           "domain.nilyr": 10}, 0, 1, BOTH),
    ("kitd 0, no tracers", {"thermo.kitd": 0, "tracers.tr_iage": False},
     1, 0, BOTH),
    # a block's ridging slots exceed shared memory: the global scratch
    ("ncat 12", {"domain.ncat": 12}, 1, 1, (torch.float64,)),
)


def check_columns(lib) -> list[str]:
    """ridge_column and cleanup_column through their wrappers on CPU
    tensors and the stand-in, against the plain versions, on a 13 x 37
    cut of gx1 (a ragged last block) with masked columns."""
    from cice4_tpu_torch.config import gx1_config
    from cice4_tpu_torch.ops import itd as itd_ops
    from cice4_tpu_torch.ops import mechred, ridge_cuda
    from cice4_tpu_torch.state import make_itd_params

    _stand_in("ridge_column", lib)
    failed = []
    for name, over, partic, redist, dtypes in COLUMN_CASES:
        cfg = gx1_config().with_values(**{
            "grid.kmt_file": "", "domain.ny_global": 13,
            "domain.nx_global": 37, "dynamics.krdg_partic": partic,
            "dynamics.krdg_redist": redist, **over})
        itd = make_itd_params(cfg)
        for dtype in dtypes:
            grid = make_grid(cfg, device="cpu", dtype=dtype)
            tmask = grid.tmask.clone()
            tmask[5, 3:9] = False
            st = kc.column_state(cfg, grid, seed=11)
            conv, shear, aice0 = kc.ridge_forcing(st, seed=12)
            new, kd, _, niter, _ = ridge_cuda.ridge_ice_cuda(
                st, itd, cfg.dynamics, 3600.0, conv, shear, tmask, aice0)
            pst, pd = mechred._ridge_ice_plain(st, itd, cfg.dynamics,
                                               3600.0, conv, shear, tmask,
                                               aice0)
            rtol = kc.COLUMN_RTOL[dtype]
            # in f32 an ulp can flip a category's test against puny, or a
            # column's |asum - 1| < puny: a few elements of 1e-3
            allowed = 0 if dtype == torch.float64 else st.aicen.numel() // 1000
            rep, left_out = kc.compare_columns(st.replace(**new), kd, pst,
                                               pd, rtol)
            tag = f"{name} {dtype}"
            print(f"ridge_column {tag}: passes {int(niter.max())} "
                  f"(plain {pd['niter']}), worst "
                  f"{max(v['max_rel'] for v in rep.values()):.2e}, "
                  f"beyond {sum(v['n_bad'] for v in rep.values())}, tracer "
                  f"elements under a parent below puny that differ "
                  f"{left_out}", flush=True)
            if not kc.fields_ok(rep, allowed) or (
                    dtype == torch.float64 and int(niter.max()) != pd["niter"]):
                failed.append(f"ridge_column {tag}: {rep}")
            for limit in (True, False):
                new, kf = ridge_cuda.cleanup_itd_cuda(st, itd, tmask, 3600.0,
                                                      limit)
                pst, pf = itd_ops._cleanup_itd_plain(st, itd, tmask, 3600.0,
                                                     limit)
                rep, _ = kc.compare_columns(st.replace(**new), kf, pst, pf,
                                            rtol)
                print(f"cleanup_column {tag} limit_aice={limit}: worst "
                      f"{max(v['max_rel'] for v in rep.values()):.2e}",
                      flush=True)
                if not kc.fields_ok(rep, allowed):
                    failed.append(f"cleanup_column {tag} {limit}: {rep}")
    return failed


GFDL_CASES = [(scheme, ncar, celsius)
              for scheme in ("beljaars", "charnock", "fixed")
              for ncar in (False, True) for celsius in (True, False)]


def check_gfdl(lib) -> list[str]:
    """gfdl_column through its wrapper on CPU tensors and the stand-in,
    against `_gfdl_ocean_fluxes_plain`, on a 13 x 37 plane with land in
    two blocks (so the grid-stride loop takes a cell a thread more than
    once), for each roughness scheme, NCAR or Monin-Obukhov and Celsius or
    Kelvin SST; the most Newton passes in [1, MO_MAX_ITER], 0 under
    NCAR."""
    from cice4_tpu_torch.ops import gfdl_cuda
    from cice4_tpu_torch.ops import gfdl_flux as gf

    _stand_in("gfdl_column", lib)
    gfdl_cuda._most_blocks = lambda _device: 2
    failed = []
    for dtype in BOTH:
        for scheme, ncar, celsius in GFDL_CASES:
            x = kc.gfdl_inputs(13, 37, seed=5, device="cpu", dtype=dtype,
                               celsius=celsius)
            kw = dict(rough_scheme=scheme, use_ncar=ncar)
            passes = gfdl_cuda.mo_passes(torch.device("cpu"))
            passes.zero_()
            got = gfdl_cuda.gfdl_ocean_fluxes_cuda(**x, **kw)
            want = gf._gfdl_ocean_fluxes_plain(**x, **kw)
            rep = kc.compare_gfdl(got, want)
            land = ~x["tmask"]
            tag = f"gfdl_column {scheme} ncar={ncar} celsius={celsius} " \
                  f"{dtype}"
            worst = max(v["norm_gap"] for v in rep.values())
            print(f"{tag}: mo_passes {int(passes)}, worst norm gap "
                  f"{worst:.2e}, worst point gap "
                  f"{max(v['point_gap'] for v in rep.values()):.2e}",
                  flush=True)
            ok = (kc.gfdl_ok(rep, dtype)
                  and all(torch.equal(got[k][land], want[k][land])
                          for k in want)
                  and (int(passes) == 0 if ncar
                       else 1 <= int(passes) <= gf.MO_MAX_ITER))
            if not ok:
                failed.append(f"{tag}: passes {int(passes)}, {rep}")
    return failed


def check_newton(lib) -> list[str]:
    """therm_newton through its wrapper on CPU tensors, the stand-in
    library loaded in place of the card's: the generic instance against the
    plain version at counts past the register instances, and against the
    register instance at (4, 1) bit for bit."""
    from cice4_tpu_torch.config import gx1_config
    from cice4_tpu_torch.ops import therm_vertical as tv
    from cice4_tpu_torch.state import make_itd_params

    _stand_in("therm_newton", lib)
    failed = []
    for layers in ((4, 1), (9, 1), (10, 1), (16, 2)):
        cfg = gx1_config().with_values(**{"domain.nilyr": layers[0],
                                          "domain.nslyr": layers[1]})
        p = tv.make_thermo_params(cfg, make_itd_params(cfg))
        for dtype in (torch.float64, torch.float32):
            args = kc.make_inputs(p, 2, 40, 24, seed=7, device="cpu",
                                  dtype=dtype)
            gen = tv._temperature_changes_cuda(p, 3600.0, *args,
                                               generic=True)
            rep = kc.compare(gen, tv._temperature_changes_core(
                p, 3600.0, *args), args[0], dtype)
            ok = rep["ok"]
            if layers == (4, 1):
                reg = tv._temperature_changes_cuda(p, 3600.0, *args)
                ok &= all(torch.equal(gen[k], reg[k]) for k in reg)
            print(f"therm_newton generic {layers} {dtype}: "
                  f"{'ok' if ok else 'FAILED'}", flush=True)
            if not ok:
                failed.append(f"therm_newton generic {layers} {dtype}: {rep}")
    return failed


def grid_of(shape, ew, ns, dtype):
    """The all-ocean 10 km grid (ice and stresses reach every edge)."""
    cfg = Config().with_values(**{
        "domain.ny_global": shape[0], "domain.nx_global": shape[1],
        "domain.ew_boundary_type": ew, "domain.ns_boundary_type": ns,
        "grid.grid_type": "column", "grid.lat_origin": 55.0,
        "grid.dx_rect": 10.0e3, "grid.dy_rect": 10.0e3})
    return make_grid(cfg, device="cpu", dtype=dtype)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "cpu_rehearsal"))
    ap.add_argument("--columns", action="store_true",
                    help="build and check only the column kernels")
    ap.add_argument("--gfdl", action="store_true",
                    help="build and check only the GFDL column kernel")
    args = ap.parse_args()
    out = Path(args.out)
    torch.set_num_threads(2)
    if args.columns or args.gfdl:
        failed = []
        if args.columns:
            failed += check_columns(
                build(out, ("ridge_column",))["ridge_column"])
        if args.gfdl:
            failed += check_gfdl(build(out, ("gfdl_column",))["gfdl_column"])
        for line in failed:
            print(line)
        print(f"{len(failed)} case(s) disagree")
        return 1 if failed else 0
    libs = build(out)
    meta = _tracer_meta(["iage"], 4, 1)
    bcs = [(ew, ns) for ew in ("cyclic", "closed")
           for ns in ("closed", "cyclic", "tripole", "tripoleT")]
    failed = []
    for shape in ((20, 40), (13, 37)):
        for ew, ns in bcs:
            for dtype in (torch.float64, torch.float32):
                grid = grid_of(shape, ew, ns, dtype)
                tag = f"{shape[0]}x{shape[1]} EW {ew} NS {ns} {dtype}"
                # velocities everywhere, the top row of U points included
                dx, dy, afac, mm, tm = kc.remap_inputs(grid, 5, 3, meta,
                                                       dtype=dtype)
                rng = np.random.RandomState(1)
                dx = dx + torch.as_tensor(rng.uniform(-0.3, 0.3, dx.shape),
                                          dtype=dtype)
                dy = dy + torch.as_tensor(rng.uniform(-0.3, 0.3, dy.shape),
                                          dtype=dtype)
                for order in (1, 2):
                    k, codes = gsh_kernel(libs["remap_gsh"], dx, dy, afac,
                                          grid.bc, order)
                    p = remap_cuda.ga_gsh_plain(dx, dy, afac, grid.bc, order)
                    flips = int((codes != remap_cuda.edge_cases_plain(
                        dx, dy, afac, grid.bc)).sum())
                    rep = kc.compare_fields({"gsh": k}, {"gsh": p},
                                            kc.GSH_RTOL[dtype])
                    if not kc.fields_ok(rep, 90 * 25 * flips) or flips > \
                            kc.GSH_MAX_FLIP_SHARE[dtype] * codes.numel():
                        failed.append(f"remap_gsh {tag} order {order}: {rep}")
                gsh = remap_cuda.ga_gsh_plain(dx, dy, afac, grid.bc, 2)
                k = k12_kernel(libs["remap_k12"], gsh, grid.hm, mm, tm, meta,
                               grid.bc)
                p = remap_cuda.k12_plain(gsh, grid.hm, mm, tm, meta, grid.bc)
                rep = kc.compare_fields(dict(zip(("div", "divt"), k)),
                                        dict(zip(("div", "divt"), p)),
                                        kc.K12_RTOL[dtype])
                if not kc.fields_ok(rep):
                    failed.append(f"remap_k12 {tag}: {rep}")
                params = evp_ops.make_evp_params(
                    DynamicsConfig(ndte=6, evp_damping=True, sinw=0.3),
                    3600.0)
                for ice in ("bands", "all"):
                    args = kc.evp_inputs(grid, seed=4, dtype=dtype, ice=ice)
                    k = kc.evp_named(evp_kernel(libs["evp_subcycle"], params,
                                                grid, *args))
                    p = kc.evp_named(evp_ops._evp_subcycle_plain(
                        params, grid, *args))
                    rep = kc.compare_fields(k, p, kc.EVP_RTOL[dtype])
                    if not kc.fields_ok(rep):
                        failed.append(f"evp_subcycle {tag} ice {ice}: {rep}")
                if ew == ns == "cyclic":
                    # the round kernel on a doubly cyclic block against its
                    # plain version (PyTorch's CPU x**2 is not x*x to the
                    # last bit, so within tolerance), and each tiling
                    # bit-equal to the first: tiles that divide the block
                    # or not, a round in one launch and split in three
                    rp = dataclasses.replace(params, ndte=7)
                    args = kc.evp_inputs(grid, seed=5, dtype=dtype)
                    want = dict(zip(kc.EVP_OUTPUTS, evp_ops._evp_rounds_plain(
                        rp, grid, *args)))
                    first = None
                    for tile in ((4, 8, 7), (16, 16, 5), (6, 5, 3)):
                        got = dict(zip(kc.EVP_OUTPUTS, rounds_kernel(
                            libs["evp_rounds"], rp, grid, *args, tile=tile)))
                        rep = kc.compare_fields(got, want,
                                                kc.ROUNDS_RTOL[dtype])
                        first = first or got
                        if not kc.fields_ok(rep) or not all(
                                torch.equal(got[k], first[k]) for k in got):
                            failed.append(f"evp_rounds {tag} tile {tile}: "
                                          f"{rep}")
                print(f"{tag}: {'ok' if not failed else 'FAILED'}",
                      flush=True)
    failed += check_newton(libs["therm_newton"])
    failed += check_columns(libs["ridge_column"])
    failed += check_gfdl(libs["gfdl_column"])
    for line in failed:
        print(line)
    print(f"{len(failed)} case(s) disagree")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
