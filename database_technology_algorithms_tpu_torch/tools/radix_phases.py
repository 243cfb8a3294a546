"""Where a one-sweep radix pass spends its time, tile by tile (K1, K5).

Builds a copy of ``csrc/`` under ``build/radix_phases/`` in which every block
of ``onesweep_pass`` that scatters records the SM clock at the ends of its
phases (prologue and load issue, ranking, counts and local scan, reorder in
shared memory, look-back, write-out) and the global timer at its start and
end, then runs K1 at 2M rows (the main path's keys: below 2^19, every row
active) and 16M rows, and K5 at 2M rows of 5-letter strings, once each
after a warm-up.  Per pass it prints the span, the per-tile wall time and
the mean and 90th percentile of each phase in cycles.  The copy differs from
the kernel only by those clock reads; the timings of ``chip_smoke.py`` come
from the kernel itself.

    python -m database_technology_algorithms_tpu_torch.tools.radix_phases
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np
import torch

from ..kernels import _lib, radix_plan
from ..kernels.radix_sort import view_sort
from ..kernels.words_sort import words_sort
from . import device_name

MAX_TILES = 8192
MAX_SCATTERS = 8  # the passes that scatter, recorded in order
PHASES = ("load", "rank", "counts", "reorder", "lookback", "store")
# (anchor in csrc/radix.cuh, what replaces it); each anchor occurs once
PATCHES = [
    ("namespace dbt {\n", """namespace dbt {
static __device__ unsigned long long g_phases[8 * 8192 * 8];
__device__ __forceinline__ unsigned long long rs_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""),
    ("  const uint32_t r = *a.route;\n",
     "  const unsigned long long g0 = rs_globaltimer();\n  const long long c0 = clock64();\n"
     "  const uint32_t r = *a.route;\n"),
    ("  rs_load(a, io, base, key, val);\n\n  // stable rank",
     "  rs_load(a, io, base, key, val);\n  const long long c1 = clock64();\n\n  // stable rank"),
    ("    __syncwarp();\n  }\n  __syncthreads();\n\n  // per digit:",
     "    __syncwarp();\n  }\n  __syncthreads();\n  const long long c2 = clock64();\n\n"
     "  // per digit:"),
    ("  __syncthreads();\n\n  // the tile in digit order",
     "  __syncthreads();\n  const long long c3 = clock64();\n\n  // the tile in digit order"),
    ("      s.tile.val[slot[k]] = val[k];\n    }\n  }\n",
     "      s.tile.val[slot[k]] = val[k];\n    }\n  }\n  const long long c4 = clock64();\n"),
    ("  __syncthreads();\n  const int64_t left = a.n - tile0;",
     "  __syncthreads();\n  const long long c5 = clock64();\n  const int64_t left = a.n - tile0;"),
    ("      rs_store(io, (int64_t)(uint32_t)(s_base[d] + (uint32_t)j), kk, vv);\n    }\n  }\n}",
     """      rs_store(io, (int64_t)(uint32_t)(s_base[d] + (uint32_t)j), kk, vv);
    }
  }
  if (tid == 0 && t < 8192 && k_exec < 8) {
    unsigned long long* o = g_phases + ((uint64_t)k_exec * 8192 + t) * 8;
    o[0] = g0; o[1] = c1 - c0; o[2] = c2 - c1; o[3] = c3 - c2; o[4] = c4 - c3;
    o[5] = c5 - c4; o[6] = clock64() - c5; o[7] = rs_globaltimer();
  }
}"""),
]
FETCH = """
DBT_API int dbt_fetch_phases(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, dbt::g_phases, sizeof(dbt::g_phases));
}
"""


def instrumented_library() -> ctypes.CDLL:
    """Build the instrumented copy and point the wrappers at it."""
    root = _lib.BUILD_DIR.parent / "radix_phases"
    src = root / "csrc"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_lib.CSRC, src)
    text = (src / "radix.cuh").read_text()
    for anchor, repl in PATCHES:
        if text.count(anchor) != 1:
            raise RuntimeError(f"radix_phases: csrc/radix.cuh no longer holds {anchor!r} once")
        text = text.replace(anchor, repl)
    (src / "radix.cuh").write_text(text)
    (src / "radix_sort.cu").write_text((src / "radix_sort.cu").read_text() + FETCH)
    _lib.CSRC, _lib.BUILD_DIR = src, root / "lib"
    _lib.library.cache_clear()
    lib = _lib.library()
    lib.dbt_fetch_phases.argtypes = [ctypes.c_void_p]
    lib.dbt_fetch_phases.restype = ctypes.c_int
    return lib


def report(lib: ctypes.CDLL, what: str, n: int, fn) -> None:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with radix_plan.record_pass_kinds() as kinds:
        fn()
    torch.cuda.synchronize()
    buf = np.zeros(MAX_SCATTERS * MAX_TILES * 8, np.uint64)
    if lib.dbt_fetch_phases(buf.ctypes.data):
        raise RuntimeError("radix_phases: reading the phase record failed")
    tiles = min(-(-n // radix_plan.TILE), MAX_TILES)
    rec = buf.reshape(MAX_SCATTERS, MAX_TILES, 8)[:, :tiles].astype(np.float64)
    k_exec = 0
    for p, k in enumerate(kinds[0].tolist()):
        if k != radix_plan.KIND_SCATTERED:
            print(f"{what} pass {p}: trivial, skipped")
            continue
        r = rec[k_exec]
        k_exec += 1
        start, end = r[:, 0], r[:, 7]
        wall = (end - start) / 1e3
        mean = dict(zip(PHASES, np.round(r[:, 1:7].mean(0)).astype(int).tolist()))
        p90 = dict(zip(PHASES, np.round(np.percentile(r[:, 1:7], 90, axis=0)).astype(int).tolist()))
        print(f"{what} pass {p}: span {(end.max() - start.min()) / 1e3:.1f} us over {tiles} "
              f"tiles; tile wall mean {wall.mean():.2f} us, p90 {np.percentile(wall, 90):.2f}; "
              f"cycles by phase, mean {mean}; p90 {p90}")


def main() -> int:
    if not torch.cuda.is_available():
        print("radix_phases: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    lib = instrumented_library()
    print(f"radix_phases on {device_name(dev)}")
    g = torch.Generator(device=dev).manual_seed(3)
    n = 2_000_000
    key = torch.randint(0, 3 * n // 20, (n,), dtype=torch.int32, device=dev, generator=g)
    inact = torch.zeros(n, dtype=torch.bool, device=dev)
    report(lib, "K1 2M rows", n, lambda: view_sort(inact, key))
    big = 16 * 2**20
    bkey = torch.randint(0, 3 * big // 20, (big,), dtype=torch.int32, device=dev, generator=g)
    binact = torch.zeros(big, dtype=torch.bool, device=dev)
    report(lib, "K1 16M rows", big, lambda: view_sort(binact, bkey))
    del bkey, binact
    # 5-letter strings as two big-endian words (the pipeline command's field 2)
    letters = torch.randint(97, 123, (n, 5), dtype=torch.int64, device=dev, generator=g)
    w0 = (letters[:, 0] << 24) | (letters[:, 1] << 16) | (letters[:, 2] << 8) | letters[:, 3]
    w1 = letters[:, 4] << 24
    strw = torch.stack([w0, w1], 1).to(torch.int32)  # both below 2^31
    d_inact = torch.zeros(n, dtype=torch.bool, device=dev)
    d_inact[::97] = True
    words = [strw[:, 0], strw[:, 1]]
    report(lib, "K5 2M rows, 2 words", n, lambda: words_sort(words, d_inact))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
