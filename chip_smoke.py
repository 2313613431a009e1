#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It

  1. device:    prints the card (nvidia-smi name and power limit) and versions;
  2. build:     builds the CUDA sources of ``src/repro_torch/kernels/csrc``
                with nvcc (one process per source, all at once) and counts
                the integer operations of one emulated multiply in the SASS
                of the probe kernels;
  3. kernels:   runs B2 (bit-exact conv), B3 (bit-exact matmul) and B4
                (stacked emulator) at the main path's shapes, holds each
                against its plain PyTorch version on the card (bitwise), and
                times both beside the operations bound;
  4. main_path: sets every launch count to 0 and drives the paper's pipeline
                through the port's entry points: parameters, calibration
                (one B4 launch), exact accuracy on 2000 test images, the
                Fig. 2(a) uniform study, NSGA-II at K=2, bit-exact
                validation of the knee (B2), its displacement study, and
                the engine's bit-exact matmul (B3); then reads the counts;
  5. checks:    calibration on the card equals the CPU's bitwise, bit-exact
                CNN features on the card equal the CPU plain path bitwise,
                every AM accuracy is within 0.05 of exact and every AM PDP
                below exact.

Each phase prints one JSON line. Then come the kernels line, the nvidia-smi
line and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line. Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA card", file=sys.stderr)
        return 1

    import numpy as np

    from repro_torch.core import engine, hwmodel, schemes, surrogate
    from repro_torch.data import cifar_like
    from repro_torch.experiments import paper_cnn
    from repro_torch.kernels import (approx_conv, approx_matmul, bitexact_emulator,
                                     cuda_build, ops, ref)
    from repro_torch.models import cnn

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. device -------------------------------------------------------------
    smi = nvidia_smi("name,power.limit")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm"))
    int_ops_per_s = sms * INT_LANES_PER_SM * clock_mhz * 1e6
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi, "sms": sms,
          "max_sm_clock_mhz": clock_mhz, "int32_ops_per_s": int_ops_per_s,
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

    def compare(got, want):
        g, w = got.cpu().numpy(), want.cpu().numpy()
        same = g.view(np.uint32) == w.view(np.uint32)
        ulp = np.abs(g.view(np.int32).astype(np.int64) - w.view(np.int32).astype(np.int64))
        return {"max_abs_err": float(np.nanmax(np.abs(g - w))) if g.size else 0.0,
                "max_ulp": int(ulp.max()) if g.size else 0, "bitwise": bool(same.all())}

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

    for kid, k in kernels.items():
        emit({"phase": "kernel", "id": kid, "name": k["name"], "shape": k["shape"],
              "multiplies": k["multiplies"], "max_abs_err": k["max_abs_err"],
              "max_ulp": k["max_ulp"], "bitwise": k["bitwise"], "ms": k["ms"],
              "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
              "bound_by": k["bound"][1], "library_ms": None})
        if not k["bitwise"]:
            fail(f"{kid} differs from its plain version (max ulp {k['max_ulp']})")

    # -- 4. main path -------------------------------------------------------------
    for k in kernels.values():
        k["kernel"].launches = 0
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
    launches = {kid: k["kernel"].launches for kid, k in kernels.items()}
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
    for kid, nl in launches.items():
        if nl == 0:
            fail(f"the main path launched {kid} no time")

    # -- 5. checks ----------------------------------------------------------------
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
    }
    emit({"phase": "checks", **checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"checks failed: {bad}")

    emit({"kernels": [{
        "name": k["name"], "route": "cuda", "source": k["source"],
        "replaces": k["replaces"], "launches": launches[kid],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound"][0], "bound_by": k["bound"][1], "library_ms": None,
        "id": kid, "shape": k["shape"], "multiplies": k["multiplies"],
        "max_ulp": k["max_ulp"], "tolerance": "bitwise",
    } for kid, k in kernels.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
