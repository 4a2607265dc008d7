"""Time designs of the lazy Adam pass (kernel B10) on the card.

    python tools/probe_adam_chunks.py      # from the repo root, on a GPU

Builds ``tools/probe_adam_chunks.cu`` into the git-ignored
``rec_now_tpu_torch/_build/`` and runs each design on config 2's table
(``FeatureConfig()``: 2.6M rows of D = 16, f32) with the rows a
``SyntheticCriteo`` batch of B = 8,192 touches (36,302, zipf-skewed),
t = 1.  Prints, for each design and in two rounds, its time a call by
CUDA events over 200 back-to-back calls and its device time by
``torch.profiler`` over 50, and whether its table, m and v are
bit-equal to the first design's.  The port's kernel is design 3.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from rec_now_tpu_torch.models import FeatureConfig  # noqa: E402
from rec_now_tpu_torch.ops import _build  # noqa: E402
from rec_now_tpu_torch.training.data import SyntheticCriteo  # noqa: E402

DESIGNS = {0: "a thread per float4 of the table (the first kernel)",
           1: "512-flag chunk a warp, D/4 lanes a row",
           2: "128-flag chunk a warp, D/4 lanes a row",
           3: "64-flag chunk a warp, D/4 lanes a row (the port's)",
           4: "32-flag chunk a warp, D/4 lanes a row",
           5: "128-flag chunk a warp, a thread a row",
           6: "32-flag chunk a warp, a thread a row",
           7: "a list by atomics, then a persistent grid (3 operations)",
           8: "persistent: SMs x 4 blocks over 64-flag chunks, next "
              "chunk's flags loaded first",
           9: "persistent: SMs x 8 blocks over 64-flag chunks, next "
              "chunk's flags loaded first"}


def main() -> None:
    so = _build.BUILD_DIR / "probe_adam_chunks.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(ROOT / "tools" / "probe_adam_chunks.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    lib.adam_design.argtypes = ([ctypes.c_int] + [ptr] * 6
                                + [ctypes.c_longlong, ptr, ctypes.c_int])
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    fc = FeatureConfig()
    v = fc.total_rows
    batch = next(SyntheticCriteo(seed=0).batches(8192, 1, seed=1))
    ids = fc.global_ids(torch.as_tensor(batch.sparse_ids, device=dev))
    flags = torch.zeros(v, dtype=torch.bool, device=dev)
    flags.index_fill_(0, ids.reshape(-1), True)
    gen = torch.Generator(device=dev).manual_seed(0)
    start = [torch.randn(v, 16, device=dev, generator=gen) * 1e-3
             for _ in range(3)]
    start[2] = start[2].square()
    g = torch.randn(v, 16, device=dev, generator=gen) * 1e-3
    count = torch.tensor(1, dtype=torch.int32, device=dev)
    scratch = torch.zeros(v + 1, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def call(design, state):
        rc = lib.adam_design(design, *(x.data_ptr() for x in state),
                             g.data_ptr(), flags.data_ptr(),
                             count.data_ptr(), v, scratch.data_ptr(), sms)
        if rc:
            raise RuntimeError(f"design {design} failed: {rc}")

    ref = [x.clone() for x in start]
    call(0, ref)
    print(f"V={v}, D=16: {int(flags.sum())} rows touched")
    for rnd in range(2):
        for design, what in DESIGNS.items():
            state = [x.clone() for x in start]
            call(design, state)
            same = all(torch.equal(a, b) for a, b in zip(state, ref))
            for _ in range(5):
                call(design, state)
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            for _ in range(200):
                call(design, state)
            b.record()
            b.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(100_000)
                torch.cuda.synchronize()
                for _ in range(50):
                    call(design, state)
                torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and "spin" not in e.name]
            device_us = sum(e.time_range.elapsed_us() for e in kernels) / 50
            print(f"round {rnd} design {design}, {what}: events "
                  f"{a.elapsed_time(b) / 200 * 1e3:.2f} us a call, device "
                  f"{device_us:.2f} us ({len(kernels) // 50} operations), "
                  f"bit-equal to design 0: {same}")


if __name__ == "__main__":
    main()
