"""Where the f32 flash kernel's time goes, on the card.

Builds variants of ``csrc/flash_attention.cu`` that each drop one part of
the work, and times each beside the kernel itself at gemma2-9b's prefill
shape (B = 2, S = 4,608, H = 16, KV = 8, hd = 256, softcap 50), local
(window 4,096) and global layer, by CUDA events, in turns (kernel first,
then each variant, then back in reverse order; the faster of the two
medians counts). The parts are not additive: a dropped phase also drops
the copies and barrier waits it hid. A variant's output is wrong by design;
it is a measurement, never a path. Prints the card, the SM clock and power
while the kernel runs, and one JSON line.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ablate
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import time

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops

SHAPE = dict(b=2, s=4608, h=16, kvh=8, hd=256, softcap=50.0)
WINDOWS = (4096, None)
# variant -> (what it drops, [(text in the source, its replacement)])
VARIANTS = {
    "kernel": ("nothing", []),
    "no_pv": ("the O += P V products", [
        ("for (int j = 0; j < kKeys; j += 4)",
         "for (int j = 0; j < 0; j += 4)")]),
    "no_s": ("the S = Q K^T products", [
        ("for (int d = 4 * dh; d < kHd; d += 8)",
         "for (int d = 4 * dh; d < 0; d += 8)")]),
    "no_tanh_fast_exp": ("tanhf; expf becomes __expf", [
        ("tanhf(x / softcap)", "(x / softcap)"), ("expf(", "__expf(")]),
    "no_copies": ("the K and V tile copies inside the loop", [
        ("    load_tile<kHd>(vs, kVStride, vg, t0, s);", "    ;"),
        ("if (t0 + kKeys < hi) load_tile<kHd>(ks",
         "if (false) load_tile<kHd>(ks")]),
}


def build_variants() -> dict:
    """``{variant: C entry point}``, one nvcc per variant, all at once."""
    src = _build.SOURCES["flash_attention"].read_text()
    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"ablate: {name}: {old!r} is not in "
                                   f"{_build.SOURCES['flash_attention']}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"ablate: nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).flash_attention_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    fns = build_variants()
    b, s, h, kvh, hd = (SHAPE[key] for key in ("b", "s", "h", "kvh", "hd"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b * h, s, hd), generator=gen, device=dev)
    k, v = (torch.randn((b * kvh, s, hd), generator=gen, device=dev)
            for _ in range(2))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(fn, window):
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b * h, h // kvh, s, 1,
                        0 if window is None else window, hd, 1 / hd ** 0.5,
                        SHAPE["softcap"], stream), "ablate")

    def median_ms(fn, window, reps=5):
        for _ in range(2):
            launch(fn, window)
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(fn, window)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[reps // 2]

    # the kernel's own output against the wrapper's, so the variants are
    # known to be built from the source the wrapper runs
    launch(fns["kernel"], WINDOWS[0])
    want = ops.flash_attention(q, k, v, group_size=h // kvh,
                               window=WINDOWS[0], softcap=SHAPE["softcap"])
    if not torch.equal(out, want):
        raise RuntimeError("ablate: the unchanged source differs from the "
                           "wrapper's kernel")
    ms = {name: {str(w): [] for w in WINDOWS} for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        for window in WINDOWS:
            ms[name][str(window)].append(median_ms(fns[name], window))
    rows = {}
    for name, by_window in ms.items():
        best = {w: min(t) for w, t in by_window.items()}
        rows[name] = dict(drops=VARIANTS[name][0], ms=best,
                          mean_ms=sum(best.values()) / len(best))
        print(f"[ablate] {name:18s} local {best['4096']:.3f} ms, global "
              f"{best['None']:.3f} ms (drops {VARIANTS[name][0]})",
              flush=True)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader", "-lms", "500"],
        stdout=subprocess.PIPE, text=True)
    t_end = time.perf_counter() + 3.0
    while time.perf_counter() < t_end:
        for _ in range(10):
            launch(fns["kernel"], None)
        torch.cuda.synchronize()
    smi.terminate()
    clocks = [line.strip() for line in smi.communicate()[0].splitlines()]
    print(f"[ablate] the kernel back to back: SM clock, power {clocks}",
          flush=True)
    print(json.dumps({"card": card, "shape": SHAPE, "variants": rows,
                      "clock_power": clocks}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
