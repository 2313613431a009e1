#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It

  1. device:    prints the card (nvidia-smi name and power limit) and versions;
  2. build:     builds the CUDA sources of ``src/repro_torch/kernels/csrc``
                with nvcc (one process per source, all at once) and counts
                the integer operations of one emulated multiply in the SASS
                of the probe kernels;
  3. kernels:   runs B2 (bit-exact conv), B3 (bit-exact matmul), B4
                (stacked emulator), B5 (fused surrogate GEMM with its noise
                epilogue; a projection, the LM head and a population of 8),
                B6 (folded moments) and B7 (unfolded moments) at the main
                paths' shapes, holds each against its plain PyTorch version
                on the card (bitwise), and times kernel, plain version and,
                for B5-B7, the cuBLAS spelling beside the bound;
  4. main_path: sets every launch count to 0 and drives the paper's pipeline
                through the port's entry points: parameters, calibration
                (one B4 launch), exact accuracy on 2000 test images, the
                Fig. 2(a) uniform study, NSGA-II at K=2, bit-exact
                validation of the knee (B2), its displacement study, and
                the engine's bit-exact matmul (B3); then reads the counts;
  5. lm_forward: xlstm-125m at full width (12 layers, d 768, vocab 50304,
                bf16, random parameters from a seed) on a synthetic batch of
                8 x 512 tokens: the loss under exact numerics and under the
                engine's surrogate_fused numerics (uniform:pm_csi and rr:8),
                one warm-up and three timed forwards each, the counts set to
                0 before each timed forward and read after it (B5: 61 per
                surrogate forward, one per weight projection); then one more
                rr:8 forward under torch.profiler (device time by kernel
                group, the device's busy share of the wall time);
  6. engine:    the surrogate_fused matmul's return_moments (B6) and the
                noisy unfolded matmul ops.am_surrogate_matmul (B7), counts
                set to 0 before and read after;
  7. checks:    calibration on the card equals the CPU's bitwise, bit-exact
                CNN features on the card equal the CPU plain path bitwise,
                every AM accuracy is within 0.05 of exact and every AM PDP
                below exact; the LM losses are finite, each surrogate loss
                within 1% of the exact loss, and the SMOKE LM's float32
                forward through B5 on the card (noise-free policy
                uniform:exact) within 5e-4 of its largest logit of the CPU's.

Each phase prints one JSON line. Then come the kernels line, the nvidia-smi
line and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line. Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM figures (NVIDIA data sheet): device memory rate; each SM issues
# 64 int32 ALU lanes and 64 IMAD lanes per clock, and 4 warp-instructions
# (128 thread-instructions) per clock.
HBM_BYTES_PER_S = 3.35e12
INT_LANES_PER_SM = 64
DISPATCH_LANES_PER_SM = 128
FP32_LANES_PER_SM = 128  # an FFMA a lane and clock: 2 flops

# SASS opcodes that move data, steer control or run on the uniform datapath:
# not arithmetic of the multiply.
_NOT_ARITH = {"LDG", "STG", "LD", "ST", "LDS", "STS", "LDC", "S2R", "CS2R",
              "EXIT", "BRA", "NOP", "BAR", "RET", "CALL", "BSSY", "BSYNC",
              "WARPSYNC", "MEMBAR", "DEPBAR", "YIELD"}
_FMA_PIPE = {"IMAD", "IMUL", "FFMA", "FADD", "FMUL", "DFMA", "HFMA2"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits" if "clocks" in query
                          else "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_counts(lib: pathlib.Path, nvcc: str) -> dict[str, dict[str, int]]:
    """Per probe function: arithmetic instructions on the ALU and FMA pipes,
    and all instructions, from ``cuobjdump -sass``."""
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), {"alu": 0, "fma": 0, "all": 0})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not m or cur is None:
            continue
        op = m.group(1).split(".")[0]
        cur["all"] += 1
        if op in _NOT_ARITH or op.startswith("U"):
            continue
        cur["fma" if op in _FMA_PIPE else "alu"] += 1
    return counts


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Device kernels grouped by name for the forward's profile.
_KERNEL_GROUPS = (("B5", "surrogate_matmul_kernel"), ("gemm", "gemm"), ("gemm", "nvjet"),
                  ("gemm", "cutlass"), ("reduce", "reduce"), ("elementwise", "elementwise"))


def profile_forward(fn) -> dict:
    """Wall and device time of one call of fn under torch.profiler: device
    time by kernel group, the ten longest kernels, and the device's busy
    share of the wall time (kernels of one stream do not overlap). Device
    times are None when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # Device events only: the CPU ops that launched them carry their time too.
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": None, "busy_share": None}
    groups: dict[str, float] = {}
    for name, ms, _ in kernels:
        g = next((g for g, pat in _KERNEL_GROUPS if pat in name.lower()), "other")
        groups[g] = groups.get(g, 0.0) + ms
    device_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "kernel_launches": sum(c for _, _, c in kernels), "device_ms_by_group": groups,
            "top_kernels": [{"name": n[:90], "ms": ms, "count": c} for n, ms, c in top]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA card", file=sys.stderr)
        return 1

    import numpy as np

    from repro_torch import weights
    from repro_torch.configs import xlstm_125m
    from repro_torch.core import amlinear, engine, hwmodel, schemes, surrogate
    from repro_torch.data import cifar_like, synthetic
    from repro_torch.experiments import paper_cnn
    from repro_torch.kernels import (am_surrogate_matmul, approx_conv, approx_matmul,
                                     bitexact_emulator, cuda_build, ops, ref)
    from repro_torch.models import cnn, transformer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. device -------------------------------------------------------------
    smi = nvidia_smi("name,power.limit")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm"))
    int_ops_per_s = sms * INT_LANES_PER_SM * clock_mhz * 1e6
    fp32_flops_per_s = sms * FP32_LANES_PER_SM * 2 * clock_mhz * 1e6
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi, "sms": sms,
          "max_sm_clock_mhz": clock_mhz, "int32_ops_per_s": int_ops_per_s,
          "fp32_fma_flops_per_s": fp32_flops_per_s,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build(cuda_build.KERNEL_SOURCES + ("am_probe.cu",))
    build_s = time.perf_counter() - t0
    nvcc = cuda_build.nvcc()
    registers = {}
    for res in built.values():
        for m in re.finditer(r"Compiling entry function '(\w+)'.*?Used (\d+) registers",
                             res.log, re.S):
            registers[m.group(1)] = int(m.group(2))
    counts = sass_counts(built["am_probe.cu"].path, nvcc)
    per_mul = {k.replace("am_probe_", ""): v for k, v in counts.items()
               if k.startswith("am_probe_")}
    if set(per_mul) != {"full", "head", "tail"}:
        fail(f"probe SASS not found: {sorted(counts)}")

    def cycles(c):  # SM clocks per thread-op of one multiply (or part of one)
        return max(c["alu"] / INT_LANES_PER_SM, c["fma"] / INT_LANES_PER_SM,
                   c["all"] / DISPATCH_LANES_PER_SM)

    emit({"phase": "build", "seconds": build_s,
          "nvcc_seconds": {s: r.seconds for s, r in built.items()},
          "nvcc": subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout.strip().splitlines()[-1],
          "registers": registers, "int_ops_per_multiply": per_mul,
          "op_count_method": "static SASS of branch-free one-multiply probes "
                             "(cuobjdump -sass); alu = integer-pipe arithmetic, "
                             "fma = IMAD/FP-pipe arithmetic, all = every instruction"})

    def bound(ops_cycles: float, nbytes: int):
        t_ops = ops_cycles / (sms * clock_mhz * 1e6) * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    def gemm_bound(flops: float, nbytes: int):
        """FP32 flops at the FMA peak (the card's cores, no tensor cores)
        against bytes at the memory rate."""
        return bound(flops / fp32_flops_per_s * sms * clock_mhz * 1e6, nbytes)

    def compare(got, want):
        """On the card: max |got - want| (NaNs skipped), max ulp, bitwise."""
        if not got.numel():
            return {"max_abs_err": 0.0, "max_ulp": 0, "bitwise": True}
        d = (got - want).abs()
        d = d[~torch.isnan(d)]
        gi, wi = got.view(torch.int32), want.view(torch.int32)
        return {"max_abs_err": float(d.max()) if d.numel() else 0.0,
                "max_ulp": int((gi.long() - wi.long()).abs().max()),
                "bitwise": bool(torch.equal(gi, wi))}

    # -- 3. kernels, at the main path's shapes ----------------------------------
    kernels = {}
    masks = ops.seed_masks(dev)

    # B4: calibration, 9 maps x 2^18 operands.
    a_np, b_np = surrogate.calibration_operands()
    a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)
    n = a.numel()
    v = schemes.N_VARIANTS
    got = bitexact_emulator.fp32_multiply_stacked_cuda(a, b, masks)
    torch.cuda.synchronize()
    cmp4 = compare(got, ref.fp32_multiply_stacked_ref(a, b, masks))
    ms = time_ms(lambda: bitexact_emulator.fp32_multiply_stacked_cuda(a, b, masks), 200,
                 warmup=20)
    plain_ms = time_ms(lambda: ref.fp32_multiply_stacked_ref(a, b, masks), 3)
    b4_bound = bound(n * (cycles(per_mul["head"]) + v * cycles(per_mul["tail"])),
                     (2 * n + v * n) * 4 + masks.numel() * 8)
    kernels["B4"] = {"name": "fp32_multiply_stacked", "kernel": bitexact_emulator.KERNEL,
                     "source": "src/repro_torch/kernels/csrc/bitexact_emulator.cu",
                     "replaces": "src/repro/kernels/bitexact_emulator.py:70",
                     "shape": f"({v} maps, n={n})", "multiplies": v * n,
                     "ms": ms, "plain_ms": plain_ms, "bound": b4_bound, **cmp4}

    # B3: the engine bench shape, x, w standard normal, random vids 0..8.
    rng = np.random.default_rng(0)
    mm, kk, nn = 256, 256, 256
    x3 = torch.from_numpy(rng.standard_normal((mm, kk)).astype(np.float32)).to(dev)
    w3 = torch.from_numpy(rng.standard_normal((kk, nn)).astype(np.float32)).to(dev)
    vids3_np = rng.integers(0, 9, (kk, nn)).astype(np.int32)
    vids3 = torch.from_numpy(vids3_np).to(dev)
    ck = ops.MATMUL_CHUNK_K
    got = approx_matmul.am_matmul_bitexact_cuda(x3, w3, vids3, masks, ck)
    torch.cuda.synchronize()
    cmp3 = compare(got, ref.am_matmul_bitexact_ref(x3, w3, vids3, chunk_k=ck, masks=masks))
    ms = time_ms(lambda: approx_matmul.am_matmul_bitexact_cuda(x3, w3, vids3, masks, ck), 50,
                 warmup=5)
    plain_ms = time_ms(lambda: ref.am_matmul_bitexact_ref(x3, w3, vids3, chunk_k=ck,
                                                          masks=masks), 2)
    muls3 = mm * kk * nn
    kernels["B3"] = {"name": "am_matmul_bitexact", "kernel": approx_matmul.KERNEL,
                     "source": "src/repro_torch/kernels/csrc/approx_matmul.cu",
                     "replaces": "src/repro/kernels/approx_matmul.py:56",
                     "shape": f"({mm}, {kk}) @ ({kk}, {nn}), vids 0..8",
                     "multiplies": muls3, "ms": ms, "plain_ms": plain_ms,
                     "bound": bound(muls3 * cycles(per_mul["full"]),
                                    (mm * kk + 2 * kk * nn + mm * nn) * 4),
                     **cmp3}

    # B2: one 256-image chunk of the CNN's bit-exact accuracy, both convs.
    params = paper_cnn.load_params(dev)
    x_np, _ = cifar_like.make_batch("test", 0, 256)
    x1 = torch.from_numpy(x_np).to(dev)
    slot1 = torch.from_numpy(rng.integers(0, 9, (10, 3, 3)).astype(np.int32)).to(dev)
    slot2 = torch.from_numpy(rng.integers(0, 9, (12, 3, 3)).astype(np.int32)).to(dev)
    w1, w2 = params["conv1_w"], params["conv2_w"]
    y1 = approx_conv.am_conv2d_bitexact_cuda(x1, w1, slot1, masks)
    x2 = cnn.maxpool2(torch.relu(y1 + params["conv1_b"])).contiguous()

    def b2_kernel():
        return (approx_conv.am_conv2d_bitexact_cuda(x1, w1, slot1, masks),
                approx_conv.am_conv2d_bitexact_cuda(x2, w2, slot2, masks))

    def b2_plain():
        return (ref.am_conv2d_bitexact_ref(x1, w1, slot1, masks),
                ref.am_conv2d_bitexact_ref(x2, w2, slot2, masks))

    got, want = b2_kernel(), b2_plain()
    torch.cuda.synchronize()
    c1, c2 = compare(got[0], want[0]), compare(got[1], want[1])
    cmp2 = {"max_abs_err": max(c1["max_abs_err"], c2["max_abs_err"]),
            "max_ulp": max(c1["max_ulp"], c2["max_ulp"]),
            "bitwise": c1["bitwise"] and c2["bitwise"]}
    ms = time_ms(b2_kernel, 20, warmup=3)
    plain_ms = time_ms(b2_plain, 2)
    muls2 = 256 * 30 * 30 * 10 * 27 + 256 * 13 * 13 * 12 * 90
    bytes2 = (x1.numel() + x2.numel() + w1.numel() + w2.numel() + y1.numel()
              + got[1].numel() + slot1.numel() + slot2.numel()) * 4
    kernels["B2"] = {"name": "am_conv2d_bitexact", "kernel": approx_conv.KERNEL,
                     "source": "src/repro_torch/kernels/csrc/approx_conv.cu",
                     "replaces": "src/repro/kernels/approx_conv.py:67",
                     "shape": "conv1 (256,32,32,3)x(10,3,3,3) + conv2 (256,15,15,10)"
                              "x(12,3,3,10)",
                     "multiplies": muls2, "ms": ms, "plain_ms": plain_ms,
                     "bound": bound(muls2 * cycles(per_mul["full"]), bytes2), **cmp2}

    # B5, B6, B7 at xlstm-125m's shapes: M = 8 x 512 tokens, K = d = 768, a
    # projection N = 768 and the head N = 50304; B5 also with a population
    # of 8 on the weights. Weights as the LM folds them: wm ~ N(0, 1/K),
    # wv = wm^2 * 1e-6 (sigma about 1e-3).
    M, K, N, V, POP = 4096, 768, 768, 50304, 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def b5_library(x, wm, wv, z):
        mean, var = torch.matmul(x, wm), torch.matmul(x * x, wv)
        return mean + z * torch.sqrt(torch.clamp(var, min=0.0))

    def surrogate_kernel(kid, name, kernel, fn, plain, library, shape, flops, nbytes,
                         iters, plain_iters=2, plain_warmup=1):
        def one(t):  # (mean, var) pairs compare as one tensor
            return t if isinstance(t, torch.Tensor) else torch.stack(t)

        got = fn()
        torch.cuda.synchronize()
        cmp = compare(one(got), one(plain()))
        ms = time_ms(fn, iters, warmup=2)
        plain_ms = time_ms(plain, plain_iters, warmup=plain_warmup)
        library_ms = time_ms(library, iters, warmup=2)
        kernels[kid] = {"name": name, "kernel": kernel,
                        "source": "src/repro_torch/kernels/csrc/am_surrogate_matmul.cu",
                        "replaces": {"B5": "src/repro/kernels/am_surrogate_matmul.py:188",
                                     "B6": "src/repro/kernels/am_surrogate_matmul.py:114",
                                     "B7": "src/repro/kernels/am_surrogate_matmul.py:67"}[
                                         kid[:2]],
                        "shape": shape, "flops": flops, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound": gemm_bound(flops, nbytes), **cmp}
        del got

    ck = ops.MATMUL_CHUNK_K
    xs = randn(M, K)
    for kid, n in (("B5", N), ("B5-head", V)):
        wm = randn(K, n) * K ** -0.5
        wv = wm * wm * 1e-6
        z = randn(M, n)
        surrogate_kernel(
            kid, "am_surrogate_matmul_epilogue", am_surrogate_matmul.EPILOGUE,
            lambda: am_surrogate_matmul.am_surrogate_matmul_epilogue_cuda(xs, wm, wv, z),
            lambda: ref.am_surrogate_epilogue_ref(xs, wm, wv, z, ck),
            lambda: b5_library(xs, wm, wv, z), f"({M}, {K}) @ ({K}, {n})",
            4 * M * K * n, (M * K + 2 * K * n + 2 * M * n) * 4,
            iters=50 if n == N else 10, plain_iters=2 if n == N else 1,
            plain_warmup=1 if n == N else 0)
        del wm, wv, z
    wmp = randn(POP, K, N) * K ** -0.5
    wvp = wmp * wmp * 1e-6
    zp = randn(M, N)
    surrogate_kernel(
        "B5-pop8", "am_surrogate_matmul_epilogue", am_surrogate_matmul.EPILOGUE,
        lambda: am_surrogate_matmul.am_surrogate_matmul_epilogue_cuda(xs, wmp, wvp, zp),
        lambda: ref.am_surrogate_epilogue_ref(xs, wmp, wvp, zp, ck),
        lambda: b5_library(xs, wmp, wvp, zp), f"({M}, {K}) @ ({POP}, {K}, {N})",
        4 * POP * M * K * N, (M * K + 2 * POP * K * N + M * N + POP * M * N) * 4, iters=20)
    del wmp, wvp, zp
    wm6 = randn(K, N) * K ** -0.5
    wv6 = wm6 * wm6 * 1e-6
    surrogate_kernel(
        "B6", "am_surrogate_moments_folded", am_surrogate_matmul.FOLDED,
        lambda: am_surrogate_matmul.am_surrogate_moments_folded_cuda(xs, wm6, wv6),
        lambda: ref.am_surrogate_moments_ref(xs, wm6, wv6, ck),
        lambda: (torch.matmul(xs, wm6), torch.matmul(xs * xs, wv6)),
        f"({M}, {K}) @ ({K}, {N})", 4 * M * K * N, (M * K + 2 * K * N + 2 * M * N) * 4,
        iters=50)
    mu7 = randn(K, N) * 1e-3
    sg7 = randn(K, N).abs() * 1e-3

    def b7_library():
        return (torch.matmul(xs, wm6 * (1.0 + mu7)),
                torch.matmul(xs * xs, (wm6 * wm6) * (sg7 * sg7)))

    surrogate_kernel(
        "B7", "am_surrogate_moments", am_surrogate_matmul.UNFOLDED,
        lambda: am_surrogate_matmul.am_surrogate_moments_cuda(xs, wm6, mu7, sg7),
        lambda: ref.am_surrogate_unfolded_ref(xs, wm6, mu7, sg7, ck), b7_library,
        f"({M}, {K}) @ ({K}, {N})", 4 * M * K * N, (M * K + 3 * K * N + 2 * M * N) * 4,
        iters=50)
    del xs, wm6, wv6, mu7, sg7
    torch.cuda.empty_cache()

    for kid, k in kernels.items():
        emit({"phase": "kernel", "id": kid, "name": k["name"], "shape": k["shape"],
              "multiplies": k.get("multiplies"), "flops": k.get("flops"),
              "max_abs_err": k["max_abs_err"], "max_ulp": k["max_ulp"],
              "bitwise": k["bitwise"], "ms": k["ms"], "plain_ms": k["plain_ms"],
              "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
              "library_ms": k.get("library_ms")})
        if not k["bitwise"]:
            fail(f"{kid} differs from its plain version (max ulp {k['max_ulp']})")

    def reset_counts():
        for k in kernels.values():
            k["kernel"].launches = 0

    def read_counts():
        return {kid: k["kernel"].launches for kid, k in kernels.items()
                if "-" not in kid}

    # -- 4. main path -------------------------------------------------------------
    reset_counts()
    wall = {}

    def step(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t
        return out

    params = step("load_params", lambda: paper_cnn.load_params(dev))
    mu_sg = step("calibrate", lambda: surrogate.moment_tables(dev))
    acc_exact = step("eval_exact", lambda: paper_cnn.eval_accuracy(params, None, 2000,
                                                                   device=dev))
    uni = step("uniform_study", lambda: paper_cnn.uniform_study(params, 2000, device=dev))
    study = step("nsga_study_k2", lambda: paper_cnn.nsga_study(params, 2, log=None,
                                                               device=dev))
    knee = np.asarray(study["knee_genome"], np.int32)
    acc_knee = step("eval_knee_bitexact", lambda: paper_cnn.eval_accuracy(
        params, knee, 2000, numerics="bitexact_cuda", device=dev))
    disp = step("displacement_study", lambda: paper_cnn.displacement_study(
        params, knee, device=dev))
    y3 = step("engine_am_matmul_bitexact", lambda: engine.am_matmul(
        x3, w3, vids3_np, backend="bitexact_cuda"))
    launches = read_counts()
    emit({"phase": "main_path", "n_images": 2000, "accuracy_exact": acc_exact,
          "uniform_study": {v: {"accuracy": r["accuracy"], "pdp_pj": r["pdp_pj"]}
                            for v, r in uni.items()},
          "ranking": paper_cnn.accuracy_ranking(uni),
          "nsga_k2": {"front_size": len(study["front"]), "knee_genome_counts": {
              schemes.VARIANTS[i]: int(c) for i, c in enumerate(np.bincount(
                  knee, minlength=schemes.N_VARIANTS)) if c},
              "knee_objectives": study["knee_objectives"], "evals": study["evals"],
              "eval_stats": study["eval_stats"]},
          "knee_accuracy_bitexact": acc_knee,
          "knee_surrogate_accuracy_512": 1.0 - study["knee_objectives"][2],
          "displacement": disp, "launches": launches, "wall_s": wall})
    for kid in ("B2", "B3", "B4"):
        if launches[kid] == 0:
            fail(f"the main path launched {kid} no time")

    # -- 5. lm_forward: xlstm-125m at full width --------------------------------
    lm_cfg = xlstm_125m.CONFIG
    lm_params = transformer.init_params(lm_cfg, seed=0, device=dev)
    lm_batch = synthetic.batch_for(lm_cfg, 0, global_batch=8, seq=512)
    lm_numerics = {
        "exact": amlinear.EXACT,
        "surrogate_fused:uniform:pm_csi": amlinear.NumericsConfig(
            mode="surrogate", policy="uniform:pm_csi", backend="surrogate_fused"),
        "surrogate_fused:rr:8": amlinear.NumericsConfig(
            mode="surrogate", policy="rr:8", backend="surrogate_fused"),
    }
    lm = {}
    with torch.no_grad():
        for name, numerics in lm_numerics.items():
            cfg_n = lm_cfg.with_numerics(numerics)
            transformer.loss_fn(lm_params, lm_batch, cfg_n, key=1)  # warm-up
            torch.cuda.synchronize()
            runs = []
            for _ in range(3):
                reset_counts()
                t = time.perf_counter()
                loss = float(transformer.loss_fn(lm_params, lm_batch, cfg_n, key=1))
                torch.cuda.synchronize()
                runs.append((loss, time.perf_counter() - t, read_counts()))
            lm[name] = {"loss": runs[0][0], "wall_s": [r[1] for r in runs],
                        "losses_equal": len({r[0] for r in runs}) == 1,
                        "launches": runs[0][2],
                        "launches_equal": all(r[2] == runs[0][2] for r in runs)}
        # Where the surrogate forward's time goes: one more rr:8 forward under
        # torch.profiler, outside the counted windows.
        profile = profile_forward(lambda: transformer.loss_fn(
            lm_params, lm_batch, lm_cfg.with_numerics(lm_numerics["surrogate_fused:rr:8"]),
            key=1))
    del lm_params
    torch.cuda.empty_cache()
    emit({"phase": "lm_forward", "arch": lm_cfg.name, "n_layers": lm_cfg.n_layers,
          "d_model": lm_cfg.d_model, "vocab": lm_cfg.vocab, "dtype": lm_cfg.dtype,
          "batch": [8, 512], "rows_per_projection": 8 * 512, "runs": lm,
          "profile_rr8": profile})
    for name, r in lm.items():
        want = 0 if name == "exact" else 61
        if not r["launches_equal"] or r["launches"]["B5"] != want or any(
                n for kid, n in r["launches"].items() if kid != "B5"):
            fail(f"lm_forward {name}: launches {r['launches']}, expected B5 = {want} "
                 "in each forward and no other kernel")
    launches["B5"] = sum(3 * r["launches"]["B5"] for r in lm.values())

    # -- 6. engine: the surrogate_fused matmul's moments (B6), the noisy
    # unfolded matmul (B7), at a projection's shape ------------------------------
    x6 = torch.randn((M, K), generator=gen, device=dev)
    w6 = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
    reset_counts()
    t = time.perf_counter()
    mean6, var6 = engine.am_matmul(x6, w6, "rr:8", backend="surrogate_fused", key=2,
                                   return_moments=True)
    mu6, sg6 = engine.device_moment_maps(engine.canonical_matmul_map("rr:8", K, N),
                                         device=dev)
    y7 = ops.am_surrogate_matmul(x6, w6, mu6, sg6, key=2)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t
    engine_counts = read_counts()
    emit({"phase": "engine", "wall_s": engine_s, "launches": engine_counts})
    for kid in ("B6", "B7"):
        if engine_counts[kid] != 1:
            fail(f"the engine path launched {kid} {engine_counts[kid]} times, not once")
        launches[kid] = engine_counts[kid]

    # -- 7. checks ----------------------------------------------------------------
    mu_cpu, sg_cpu = surrogate.moment_tables("cpu")
    calib_same = bool((mu_sg[0].view(np.uint32) == mu_cpu.view(np.uint32)).all()
                      and (mu_sg[1].view(np.uint32) == sg_cpu.view(np.uint32)).all())
    cfg = cnn.AMConfig.from_sequence(knee, backend="bitexact_cuda")
    x4, _ = cifar_like.make_batch("test", 0, 4)
    with torch.no_grad():
        f_card = cnn.PaperCNN(params).features(torch.from_numpy(x4).to(dev), cfg)
        f_card = f_card.cpu().numpy()
        params_cpu = {k: t.cpu() for k, t in params.items()}
        f_cpu = cnn.PaperCNN(params_cpu).features(torch.from_numpy(x4), cfg).numpy()
    ams = [v for v in uni if v != "exact"]
    # The SMOKE LM in float32 through B5 with the noise-free policy
    # uniform:exact (mu = sigma = 0), on the card and on the CPU.
    smoke = dataclasses.replace(xlstm_125m.SMOKE, dtype="float32").with_numerics(
        amlinear.NumericsConfig.for_backend("surrogate_fused", "uniform:exact"))
    smoke_params = transformer.init_params(smoke, seed=1, device="cpu")
    smoke_batch = synthetic.batch_for(smoke, 1, global_batch=2, seq=40)
    with torch.no_grad():
        l_cpu = transformer.forward(smoke_params, smoke_batch, smoke, key=3)
        l_card = transformer.forward(weights.to_device(smoke_params, dev), smoke_batch,
                                     smoke, key=3).cpu()
    smoke_err = float((l_card - l_cpu).abs().max() / l_cpu.abs().max())
    exact_loss = lm["exact"]["loss"]
    checks = {
        "calibration_card_equals_cpu_bitwise": calib_same,
        "bitexact_cnn_features_card_equal_cpu_bitwise": bool(
            (f_card.view(np.uint32) == f_cpu.view(np.uint32)).all()),
        "am_accuracies_within_0.05_of_exact": all(
            abs(uni[v]["accuracy"] - uni["exact"]["accuracy"]) <= 0.05 for v in ams),
        "am_pdp_below_exact": all(uni[v]["pdp_pj"] < uni["exact"]["pdp_pj"] for v in ams),
        "knee_bitexact_accuracy_within_0.05_of_exact": abs(acc_knee - acc_exact) <= 0.05,
        "engine_matmul_finite_256x256": bool(torch.isfinite(y3).all())
        and tuple(y3.shape) == (mm, nn),
        "knee_pdp_below_exact": hwmodel.sequence_cost(knee)["pdp_pj"]
        < uni["exact"]["pdp_pj"],
        "lm_losses_finite": all(np.isfinite(r["loss"]) for r in lm.values()),
        "lm_losses_repeat_exactly": all(r["losses_equal"] for r in lm.values()),
        "lm_surrogate_losses_within_1pct_of_exact": all(
            abs(r["loss"] - exact_loss) <= 0.01 * exact_loss for r in lm.values()),
        "smoke_lm_b5_card_vs_cpu_within_5e-4": smoke_err <= 5e-4,
        "engine_moments_and_b7_finite": bool(torch.isfinite(mean6).all()
                                             and (var6 >= 0).all()
                                             and torch.isfinite(y7).all()),
    }
    emit({"phase": "checks", "smoke_lm_rel_err": smoke_err, **checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"checks failed: {bad}")

    emit({"kernels": [{
        "name": k["name"], "route": "cuda", "source": k["source"],
        "replaces": k["replaces"], "launches": launches[kid.split("-")[0]],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
        "library_ms": k.get("library_ms"), "id": kid, "shape": k["shape"],
        "multiplies": k.get("multiplies"), "flops": k.get("flops"),
        "max_ulp": k["max_ulp"], "tolerance": "bitwise",
    } for kid, k in kernels.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
