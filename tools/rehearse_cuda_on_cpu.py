"""Rehearse the port's dynamics kernels on the CPU, without a card or nvcc.

    python tools/rehearse_cuda_on_cpu.py [--out build/cpu_rehearsal]

Compiles ``evp_subcycle.cu``, ``remap_gsh.cu`` and ``remap_k12.cu`` (with
the headers they include) with ``g++ -std=c++20 -ffp-contract=off``
against a stand-in CUDA runtime written into ``--out``: each block's
threads run as ``std::thread``s meeting at a ``std::barrier``, blocks one
after another, or, for the EVP kernel's cooperative launch, every block
at once with a grid-wide barrier; ``__ballot_sync`` and
``__shfl_down_sync`` meet at a barrier of their warp; ``cp.async`` is a
plain copy.  The kernels' C interfaces are then called through ctypes on
CPU tensors and each result is held against the plain PyTorch version
with the tolerances of ``cice4_tpu_torch.kernel_check``, on small
ragged shapes and every boundary pair the kernels take, the tripole and
tripoleT folds on the all-ocean grid included, in f32 and f64.

What it shows: that the kernels' index arithmetic, masking, staging and
synchronisation compute the plain version's function.  What it cannot
show: that nvcc accepts the source for sm_90a, the card's timing, or
faults that only the card's memory model or warp scheduling brings out.
Exits non-zero when a case disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
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
using std::max;
using std::min;
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
inline void __syncthreads() { g_bar->arrive_and_wait(); }
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
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < n; ++t)
        ts.emplace_back([&, t] {
          blockIdx = {bx, by, 0};
          threadIdx = {t % block.x, (t / block.x) % block.y,
                       t / (block.x * block.y)};
          g_bar = &bar;
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

LIBRARIES = ("evp_subcycle", "remap_gsh", "remap_k12")


def translate(name: str, src: str) -> str:
    """The source as the stand-in runtime takes it."""
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "unsigned char* smem_raw = g_dyn_smem;")
    if name == "remap_tile.cuh":
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
    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<([^>]*)>>>\(", r"launch(\1, \2, ",
                  src)


def build(out: Path) -> dict:
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
        for name in LIBRARIES}
    for name, p in procs.items():
        if p.wait() != 0:
            raise SystemExit(f"g++ failed on {name}.cu")
    return {name: ctypes.CDLL(str(out / f"lib{name}.so"))
            for name in LIBRARIES}


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
    out = Path(ap.parse_args().out)
    libs = build(out)
    torch.set_num_threads(2)
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
                print(f"{tag}: {'ok' if not failed else 'FAILED'}",
                      flush=True)
    for line in failed:
        print(line)
    print(f"{len(failed)} case(s) disagree")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
