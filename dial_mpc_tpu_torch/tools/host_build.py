"""Compile a kernel of ``csrc/`` as host C++, a thread for each lane of a team.

Where there is no ``nvcc`` and no card, this is how the kernels' arithmetic is
checked: the CUDA source is compiled by ``g++`` with the shim below as its
``cuda_runtime.h``. A team's lanes become ``LANES`` ``std::thread``\\ s:
``__syncwarp`` is a ``std::barrier`` of the team, a shuffle an exchange through
a buffer between two barrier waits, ``__ldg`` a plain load. The harness that
runs the threads (one per lane, one team per sample, its shared memory a
buffer pre-filled with a given byte) is the caller's, since it calls the
kernel's own per-sample function.

    d = pathlib.Path(...)
    write_shim(d)
    subprocess.run([*gxx_command(d, lanes=32), "-shared", "-fPIC", "-o", ..., "harness.cpp"])
"""

from __future__ import annotations

import pathlib
import shutil

from dial_mpc_tpu_torch.physics.cuda_build import CSRC

SHIM = """
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __constant__ static const
#define __global__
#define __restrict__
using std::sqrt; using std::sin; using std::cos; using std::pow; using std::fabs;
struct HostTeam { std::barrier<>* bar; double* xbuf; };
inline thread_local HostTeam* tl_team = nullptr;
inline thread_local int tl_lane = 0;
inline void __syncwarp(unsigned) { tl_team->bar->arrive_and_wait(); }
template <typename T> inline T host_exchange(T v, int src) {
  tl_team->xbuf[tl_lane] = (double)v;
  tl_team->bar->arrive_and_wait();
  T r = (T)tl_team->xbuf[src];
  tl_team->bar->arrive_and_wait();
  return r;
}
template <typename T> inline T __shfl_xor_sync(unsigned, T v, int o, int) { return host_exchange(v, tl_lane ^ o); }
template <typename T> inline T __shfl_sync(unsigned, T v, int src, int) { return host_exchange(v, src); }
template <typename T> inline T __ldg(const T* p) { return *p; }
"""

# What a harness needs to run one team: the barrier and exchange buffer of
# HostTeam, set up by run_team below.
RUN_TEAM = """
#include <thread>
#include <vector>
// runs body(lane) on LANES threads that form one team
template <typename F> static void run_team(F body) {
  std::barrier<> bar(LANES);
  double xbuf[LANES];
  HostTeam team{&bar, xbuf};
  std::vector<std::thread> lanes;
  for (int l = 0; l < LANES; ++l)
    lanes.emplace_back([&, l] {
      tl_team = &team;
      tl_lane = l;
      body(l);
    });
  for (auto& t : lanes) t.join();
}
"""


def write_shim(d: pathlib.Path) -> None:
    """Write the shim as ``d/shim/cuda_runtime.h`` and ``d/shim/run_team.h``."""
    (d / "shim").mkdir(exist_ok=True)
    (d / "shim" / "cuda_runtime.h").write_text(SHIM)
    (d / "shim" / "run_team.h").write_text('#pragma once\n#include "cuda_runtime.h"\n' + RUN_TEAM)


def source_without_launch(source: str, marker: str) -> str:
    """The text of ``csrc/<source>`` up to the line that starts its launch
    code (``marker``): what the host build compiles."""
    text = (pathlib.Path(CSRC) / source).read_text()
    return text[: text.index(marker)]


def gxx_command(d: pathlib.Path, *flags: str, lanes: int) -> list:
    """The g++ command line (without output and input) for a host build in d;
    raises FileNotFoundError if there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("no host C++ compiler (g++)")
    return [gxx, "-O1", *flags, f"-DLANES={lanes}", "-std=c++20", "-pthread", "-x", "c++",
            "-I", str(d / "shim"), "-I", str(d), "-I", CSRC]
