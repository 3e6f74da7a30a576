#!/usr/bin/env python3
"""Per-stage clock of the whole-frame streaming kernel (K5) on one NVIDIA GPU.

    python scripts/torch_k5_clock.py                     # this checkout's K5
    python scripts/torch_k5_clock.py --checkout DIR      # another checkout's (e.g. the parent)
    python scripts/torch_k5_clock.py --micro             # also barrier, store and copy costs

Builds a copy of the checkout's ``csrc/stream_mega.cu`` with a ``clock64``
stamp of block 0's thread 0 after every block or cluster barrier and every
wait for a product's weights, keyed by source line, into ``cleanumamba_tpu_torch/_build/k5_clock/`` (ignored by
git), launches it through that checkout's own wrapper on the FullMini
geometry (batch 1, random weights from seed 0), and prints each source
line's cycles and count; the stamps in order go to
``profiles/k5_clock_<tag>.json``.  ``--micro`` times a cluster barrier, a
block barrier, stores into the cluster's other blocks and one bulk copy.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cleanumamba_tpu_torch.config import CleanUMambaConfig  # noqa: E402
from cleanumamba_tpu_torch.models.cleanumamba import init_params  # noqa: E402
from cleanumamba_tpu_torch.ops.cuda import build  # noqa: E402
from cleanumamba_tpu_torch.params import prepare_weight_view, tree_map  # noqa: E402
from cleanumamba_tpu_torch.streaming import stream_prime  # noqa: E402

STAMP = '''
__device__ long long* g_clk;
__device__ int g_nclk;
#define STAMP() do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_clk) { \\
  const int i_ = g_nclk++; if (i_ < 1000) { g_clk[2 * i_] = __LINE__; \\
  g_clk[2 * i_ + 1] = clock64(); } } } while (0)
#define STAMP_RESET() do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_clk) g_nclk = 0; } while (0)
'''
SET_CLOCK = '''
extern "C" int set_clock(void* buf) {
  cudaMemcpyToSymbol(g_clk, &buf, sizeof(void*));
  return static_cast<int>(cudaGetLastError());
}
'''
MICRO = r'''
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void csync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ uint32_t crank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// mode 0: n cluster barriers; 1: n block barriers; 2: n rounds of (each
// thread stores `per` floats into every block of the cluster, cluster barrier)
__global__ void bar_kernel(long long* out, int n, int mode, int per, int C) {
  __shared__ float buf[8192];
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    if (mode == 0) {
      csync();
    } else if (mode == 1) {
      __syncthreads();
    } else {
      for (int j = 0; j < per; ++j)
        for (int r = 0; r < C; ++r) {
          uint32_t remote;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote)
                       : "r"(saddr(buf + ((threadIdx.x * per + j) & 8191))), "r"(r));
          asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(1.f * i) : "memory");
        }
      csync();
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0 && crank() == 0 && blockIdx.x == 0) out[0] = t1 - t0;
  csync();
}
__global__ void copy_kernel(const float* src, long long* out, int bytes, int reps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const uint32_t b = saddr(&bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1) : "memory");
  long long total = 0;
  for (int i = 0; i < reps; ++i) {
    const long long t0 = clock64();
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(saddr(smem)), "l"(src + (size_t)i * bytes / 4), "r"(bytes), "r"(b) : "memory");
    uint32_t done;
    do {
      asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                   "selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(b), "r"(i & 1) : "memory");
    } while (!done);
    total += clock64() - t0;
  }
  out[0] = total / reps;
}
extern "C" int bar_cycles(void* out, int n, int mode, int per, int C, int threads) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, bar_kernel, (long long*)out, n, mode, per, C);
}
extern "C" int copy_cycles(const void* src, void* out, int bytes, int reps) {
  cudaFuncSetAttribute(copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  copy_kernel<<<1, 32, bytes>>>((const float*)src, (long long*)out, bytes, reps);
  return (int)cudaGetLastError();
}
'''


def _instrument(src: str) -> str:
    lines = []
    for ln in src.split("\n"):
        code = ln.split("//")[0].rstrip()
        if (code.endswith("__syncthreads();") or code.endswith("cluster_sync();")
                or code.endswith("mbar_wait(cx.bar(p), 0);")) and "__device__" not in code:
            ln = code + " STAMP();"
        elif "extern __shared__" in ln and "smem[]" in ln and "__global__" not in ln:
            ln = ln + " STAMP_RESET(); STAMP();"
        lines.append(ln)
    out = "\n".join(lines).replace('#include "common.cuh"', '#include "common.cuh"\n' + STAMP, 1)
    return out.replace('extern "C" int mega_stream_step(', SET_CLOCK + 'extern "C" int mega_stream_step(', 1)


def _build(tag, src, csrc):
    out = build.BUILD_DIR / "k5_clock" / tag
    out.mkdir(parents=True, exist_ok=True)
    (out / "stream_mega.cu").write_text(src)
    (out / "common.cuh").write_text((pathlib.Path(csrc) / "common.cuh").read_text())
    return build.load_library("stream_mega", out)


def _wrapper(checkout, lib):
    """The checkout's K5 wrapper module, launching ``lib``."""
    path = pathlib.Path(checkout) / "cleanumamba_tpu_torch" / "ops" / "cuda" / "stream_mega.py"
    spec = importlib.util.spec_from_file_location(f"k5_{abs(hash(str(lib)))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.load_library = lambda *_: lib
    return module


def _fullmini(family, **kw):
    return CleanUMambaConfig(**{**dict(channels_H=32, max_H=64, encoder_n_layers=8,
                                       tsfm_n_layers=3, tsfm_n_head=8, tsfm_d_model=64,
                                       tsfm_d_inner=128, bottleneck=family), **kw})


def _micro(dev):
    out = build.BUILD_DIR / "k5_clock" / "micro"
    out.mkdir(parents=True, exist_ok=True)
    (out / "micro.cu").write_text(MICRO)
    lib = build.load_library("micro", out)
    lib.bar_cycles.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    lib.copy_cycles.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    buf = torch.zeros(4, dtype=torch.int64, device=dev)
    res, n = {}, 1000
    for C in (1, 2, 4, 8):
        for mode, per, what in ((0, 0, "cluster barrier"), (1, 0, "block barrier (512 threads)"),
                                (2, 1, "1 store a thread into every block + cluster barrier")):
            for _ in range(2):
                assert lib.bar_cycles(buf.data_ptr(), n, mode, per, C, 512) == 0
            torch.cuda.synchronize()
            res[f"C={C} {what}"] = buf[0].item() / n
    src = torch.randn(16 * 1024 * 1024, device=dev)
    for nbytes in (4096, 16384, 65536):
        for _ in range(2):
            assert lib.copy_cycles(src.data_ptr(), buf.data_ptr(), nbytes, 1) == 0
            torch.cuda.synchronize()
        res[f"bulk copy of {nbytes} B from L2"] = buf[0].item()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose K5 is clocked")
    ap.add_argument("--tag", default=None, help="name of this run's output (default: the dir)")
    ap.add_argument("--families", default="mamba,mha,mamba_s4")
    ap.add_argument("--micro", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k5_clock: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    tag = args.tag or pathlib.Path(args.checkout).resolve().name
    csrc = pathlib.Path(args.checkout) / "cleanumamba_tpu_torch" / "csrc"
    src = _instrument((csrc / "stream_mega.cu").read_text())
    report = {"smi": smi, "source": str(csrc / "stream_mega.cu")}
    if args.micro:
        report["micro_cycles"] = _micro(dev)
        print(json.dumps(report["micro_cycles"], indent=1))
    src_lines = src.split("\n")
    clk = torch.zeros(2 * 1000, dtype=torch.int64, device=dev)
    lib = _build(tag, src, csrc)
    lib.set_clock.argtypes = [ctypes.c_void_p]
    sm = _wrapper(args.checkout, lib)
    for family in args.families.split(","):
        for kw in ({}, dict(channels_H=64, max_H=128)) if family == "mamba" else ({},):
            cfg = _fullmini(family, **kw)
            params = init_params(cfg, torch.Generator().manual_seed(0), dev)
            for cdt in (torch.float32, torch.bfloat16):
                view = params if cdt == torch.float32 else prepare_weight_view(params, "bf16")
                mega = sm.pack_mega(view, cfg, cdt)
                st, _ = stream_prime(params, cfg, torch.zeros(1, cfg.frame_length, device=dev))
                st = tree_map(lambda t: t.contiguous(), st)
                frame = torch.from_numpy((np.random.default_rng(1).normal(
                    size=(1, cfg.frame_length)) * 0.3).astype(np.float32)).to(dev)
                lib.set_clock(clk.data_ptr())
                for _ in range(4):
                    clk.zero_()
                    sm.mega_stream_step(frame, st, *mega)
                    torch.cuda.synchronize()
                lib.set_clock(None)
                s = clk.view(-1, 2).cpu().numpy()
                s = s[s[:, 1] > 0]
                by_line = {}
                for i in range(1, len(s)):
                    e = by_line.setdefault(int(s[i, 0]), [0, 0, src_lines[int(s[i, 0]) - 1]
                                                          .strip()[:60]])
                    e[0] += int(s[i, 1] - s[i - 1, 1])
                    e[1] += 1
                total = int(s[-1, 1] - s[0, 1])
                key = (f"{family}{' width 64..128' if kw else ''} "
                       f"{str(cdt).split('.')[-1]}")
                report[key] = dict(total=total, stamps=[(int(a), int(b)) for a, b in s])
                print(f"{key}: {total} cycles from first to last stamp, {len(s)} stamps "
                      f"({smi})", flush=True)
                for line, (cyc, n, text) in sorted(by_line.items(), key=lambda kv: -kv[1][0])[:8]:
                    print(f"    line {line:4d} x{n:3d} {cyc:8d} cycles "
                          f"({100 * cyc / max(total, 1):4.1f} %)  {text}")
    os.makedirs(ROOT / "profiles", exist_ok=True)
    (ROOT / "profiles" / f"k5_clock_{tag}.json").write_text(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
