"""The gather of K1's and K5's extra words (``gather_words_*`` in
``csrc/radix.cuh``) swept on the card, form by form.

The form (``kernels/radix_plan.gather_packed``) is set through
``radix_plan.GATHER_PACK_BYTES`` around ordinary ``view_sort`` calls:
packed, forced by a limit of 0, or direct, by a limit past any footprint.
The form is an argument of the C entry, so one build serves both.

The shapes: 16,777,216 rows (the 24M + 24M run's largest ``view_sort``)
with 2 extra words; 262,144 to 4M rows with 2 words (the extras in the L2
up to 2M); 16M rows with 1, 3, 4, 5 and 9 words (one word; a padded
group; one group; a group and a direct word; two groups and a direct
word).  Keys are the bench's range (uniform in
``[0, 3 n / 10)``, so the order is a random permutation of the rows), every
seventh row inactive; the extras random words.  Every form's outputs are
held against the plain version; a time is the mean device time a call of
the gather's launches over 20 calls (torch.profiler), each launch's
beside it, and of the whole ``view_sort``, beside ``index_select`` of the
same words through the same order and the byte bound (the order read, each
word read and written once).

    python -m database_technology_algorithms_tpu_torch.tools.gather_sweep
"""

from __future__ import annotations

import subprocess

import torch

from ..kernels import radix_plan
from . import device_name

REPS = 20
FORMS = {"direct": 1 << 62, "packed": 0}  # GATHER_PACK_BYTES that force each form
SHAPES = ((16_777_216, 2), (262_144, 2), (1_048_576, 2), (2_097_152, 2), (4_194_304, 2),
          (16_777_216, 1), (16_777_216, 3), (16_777_216, 4), (16_777_216, 5), (16_777_216, 9))
PEAK_BYTES_S = 3.35e12


def inputs(n: int, words: int, dev, seed: int = 22):
    g = torch.Generator(device=dev).manual_seed(seed)
    key = torch.randint(0, max(3 * n // 10, 1), (n,), generator=g, device=dev,
                        dtype=torch.int32)
    inact = torch.arange(n, device=dev) % 7 == 3
    extra = tuple(torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                                dtype=torch.int32) for _ in range(words))
    return inact, key, extra


def launch_ms(fn) -> dict:
    """Device ms a call of fn by kernel name (demangled, arguments cut), a
    mean over REPS calls in one profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name.replace("void ", "").replace("dbt::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + ev.device_time / REPS / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_sweep: no CUDA device")
        return 1
    from ..kernels.radix_sort import view_sort, view_sort_plain
    from .hash_sweep import plan

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[gather_sweep] {smi or device_name(dev)}", flush=True)
    for n, words in SHAPES:
        inact, key, extra = inputs(n, words, dev)
        want = view_sort_plain(inact, key, extra)
        perm = want[1]
        lib_ms = sum(launch_ms(lambda: [torch.index_select(w, 0, perm) for w in extra]).values())
        bound = (4 * n + 8 * n * words) / PEAK_BYTES_S * 1e3
        what = f"{n} rows, {words} words"
        print(f"[gather_sweep] {what}: index_select {lib_ms:.4f} ms, bound {bound:.4f} ms; "
              f"the plan's form {'packed' if radix_plan.gather_packed(n, words) else 'direct'}",
              flush=True)
        for form, limit in FORMS.items():
            if form == "packed" and words == 1:
                continue
            with plan(radix_plan, GATHER_PACK_BYTES=limit):
                got = view_sort(inact, key, extra)
                for a, b in zip(got[3], want[3]):
                    if not torch.equal(a, b):
                        raise AssertionError(f"gather_sweep: {form}, {what}: the extras differ "
                                             f"from the plain version")
                by = launch_ms(lambda: view_sort(inact, key, extra))
            mine = {k: v for k, v in by.items() if "gather_words" in k}
            print(f"[gather_sweep] {what}: {form}: gather {sum(mine.values()):.4f} ms ("
                  + ", ".join(f"{k} {v:.4f}" for k, v in mine.items())
                  + f"); the whole view_sort {sum(by.values()):.4f}", flush=True)
        del inact, key, extra, want, perm
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
