"""Paper Sec. III experiments on the procedural CIFAR-10 stand-in.

  * Fig. 2(a): each of the 8 FP32 AMs applied uniformly across both conv
    layers: inference accuracy and cumulative multiplier PDP;
  * NSGA-II over 198-slot sequences with a K-variant alphabet, objectives
    (area, PDP, accuracy loss), and the knee-point selection;
  * Fig. 5: random displacements of a selected sequence;
  * bit-exact validation of a sequence (``eval_accuracy`` with a bit-exact
    backend; the surrogate is the search's inner-loop numerics).

Every entry point takes ``device`` (default "cuda") and raises if that
device is not there; nothing moves to the CPU on its own.
"""
from __future__ import annotations

import pathlib
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import check_device, weights
from repro_torch.core import engine, hwmodel, interleave, nsga2, schemes, surrogate
from repro_torch.data import cifar_like
from repro_torch.models import cnn

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts"
PARAMS_FILE = ARTIFACTS / "paper_cnn_params.npz"
N_SLOTS = cnn.N_SLOTS


def load_params(device="cuda") -> dict[str, torch.Tensor]:
    """The committed trained CNN parameters as float32 tensors on device."""
    dev = check_device(device)
    with np.load(PARAMS_FILE) as d:
        return weights.params_from_numpy(dict(d), dev)


def _model(params, dev) -> cnn.PaperCNN:
    return cnn.PaperCNN({k: torch.as_tensor(v).to(dev) for k, v in params.items()})


def eval_accuracy(params, seq, n_images: int = 2000, *, numerics: str = "surrogate",
                  key=None, noise_scale: float = 1.0, device="cuda") -> float:
    """CNN accuracy on the first ``n_images`` test images under a 198-slot
    sequence (None = exact). ``numerics`` is "surrogate" (surrogate_torch),
    "bitexact" (bitexact_ref) or any engine backend name."""
    dev = check_device(device)
    x, y = cifar_like.make_batch("test", 0, n_images)
    model = _model(params, dev)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    if seq is None:
        return cnn.accuracy(model, xt, yt, numerics="exact")
    backend = {"surrogate": "surrogate_torch", "bitexact": "bitexact_ref"}.get(
        numerics, numerics)
    cfg = cnn.AMConfig.from_sequence(seq, backend=backend, noise_scale=noise_scale)
    return cnn.accuracy(model, xt, yt, numerics=cfg, key=key)


def make_batched_evaluator(params, n_images: int, noise_scale: float = 1.0,
                           block: int = 2, image_chunk: int = 64, *, device="cuda",
                           noise: Sequence | None = None):
    """Population-batched surrogate CNN accuracy.

    Returns ``evaluate(genomes (P, 198) int32, key) -> (P,) accuracies``.
    The CNN pipeline of the JAX evaluator: each conv is an im2col GEMM whose
    input patches all genomes share (the layer-1 patches are built once
    here), with the per-slot moments folded into per-genome weights on the
    host (layer 1 tap-major, layer 2 channel-major), all GEMMs channel-major
    ((F, K) @ (K, pixels)), the genomes in ``block``-genome slices and the
    images in chunks. Populations pad to ``block`` x a power of two, so the
    per-block shapes are fixed and a genome's score does not depend on the
    batch it is scored in.

    Noise is shared across the population (common random numbers): chunk
    ``ci`` draws z1 (10, bc, 30, 30) and z2 (12, bc*144) from keys folded
    from ``key`` and ``ci``. ``noise``, when given, is the list of (z1, z2)
    per chunk to use instead, whatever the key (tests hand over the
    reference's draws this way).
    """
    dev = check_device(device)
    x_np, y_np = cifar_like.make_batch("test", 0, n_images)
    bc = max(d for d in range(1, min(image_chunk, n_images) + 1) if n_images % d == 0)
    nc = n_images // bc
    g_blk = block
    f1, f2 = cnn.LAYER_FILTERS  # 10, 12
    h1, h2p, hf = 30, 15, 6  # conv1 output, pooled, final spatial
    h2 = 12  # conv2 rows/cols the VALID 2x2 pool reads (the 13th is dropped)

    px = engine.conv_patch_matrix(x_np, 3, 3)  # (27, n, 900)
    px = px.reshape(27, nc, bc, h1 * h1).transpose(1, 0, 2, 3).reshape(nc, 27, -1)
    pxt = torch.from_numpy(np.ascontiguousarray(px, np.float32)).to(dev)
    pxxt = pxt * pxt
    yc = torch.from_numpy(y_np.reshape(nc, bc)).to(dev)

    host = {k: torch.as_tensor(v).detach().cpu().numpy() for k, v in params.items()}
    w1, w2 = host["conv1_w"], host["conv2_w"]
    b1 = torch.from_numpy(host["conv1_b"]).to(dev).reshape(1, f1, 1, 1, 1)
    b2 = torch.from_numpy(host["conv2_b"]).to(dev).reshape(1, f2, 1)
    wd = torch.from_numpy(host["dense_w"]).to(dev)
    bd = torch.from_numpy(host["dense_b"]).to(dev)

    if noise is not None:
        if len(noise) != nc:
            raise ValueError(f"noise has {len(noise)} chunks, the evaluator {nc}")
        noise = [tuple(torch.as_tensor(np.asarray(z), dtype=torch.float32).to(dev)
                       for z in zz) for zz in noise]

    def chunk_noise(key, ci):
        if noise is not None:
            return noise[ci]
        k = surrogate.fold_in(key, ci)
        return (surrogate.crn_normal(surrogate.fold_in(k, 0), (f1, bc, h1, h1), dev),
                surrogate.crn_normal(surrogate.fold_in(k, 1), (f2, bc * h2 * h2), dev))

    def block_correct(bm1, bv1, bm2, bv2, pxc, pxxc, z1, z2, yb):
        mean = (bm1 @ pxc).reshape(g_blk, f1, bc, h1, h1)
        var = (bv1 @ pxxc).reshape(g_blk, f1, bc, h1, h1)
        y = mean + b1 + z1[None] * torch.sqrt(var)
        y = y.reshape(g_blk, f1, bc, h2p, 2, h2p, 2).amax(6).amax(4)
        y = torch.relu(y)  # relu and max pool commute
        cols = [y[:, :, :, i:i + h2, j:j + h2] for i in range(3) for j in range(3)]
        pat = torch.stack(cols, dim=2).reshape(g_blk, f1 * 9, -1)
        m2 = torch.bmm(bm2, pat)
        v2 = torch.bmm(bv2, pat * pat)
        y2 = m2 + b2 + z2[None] * torch.sqrt(v2)
        y2 = y2.reshape(g_blk, f2, bc, hf, 2, hf, 2).amax(6).amax(4)
        y2 = torch.relu(y2)
        h = y2.permute(0, 2, 3, 4, 1).reshape(g_blk, bc, -1)
        pred = (h @ wd + bd).argmax(-1)
        return (pred == yb[None]).sum(1)

    def evaluate(genomes, key) -> np.ndarray:
        g = np.atleast_2d(np.asarray(genomes, np.int32))
        if g.shape[1] != N_SLOTS:
            raise ValueError(f"genome length {g.shape[1]} != {N_SLOTS} slots")
        p = g.shape[0]
        n_blocks = engine.population_blocks(p, g_blk)
        g = engine.pad_population(g, g_blk)
        m1 = engine.canonical_conv_map(g[:, : f1 * 9], f1, 3, 3)
        m2 = engine.canonical_conv_map(g[:, f1 * 9:], f2, 3, 3)
        wm1, wv1 = engine.fold_conv_gemm_weights(
            w1, m1, noise_scale=noise_scale, layout="tap_major", device=dev)
        wm2, wv2 = engine.fold_conv_gemm_weights(
            w2, m2, noise_scale=noise_scale, layout="channel_major", device=dev)
        wm1, wv1 = (torch.from_numpy(t.reshape(n_blocks, g_blk * f1, 27)).to(dev)
                    for t in (wm1, wv1))
        wm2, wv2 = (torch.from_numpy(t.reshape(n_blocks, g_blk, f2, 9 * f1)).to(dev)
                    for t in (wm2, wv2))
        total = torch.zeros(n_blocks * g_blk, dtype=torch.int64, device=dev)
        with torch.no_grad():
            for ci in range(nc):
                z1, z2 = chunk_noise(key, ci)
                for bi in range(n_blocks):
                    total[bi * g_blk:(bi + 1) * g_blk] += block_correct(
                        wm1[bi], wv1[bi], wm2[bi], wv2[bi], pxt[ci], pxxt[ci],
                        z1, z2, yc[ci])
        return total.cpu().numpy()[:p] / n_images

    return evaluate


def uniform_study(params, n_images: int = 2000, noise_scale: float = 1.0, *,
                  device="cuda") -> dict:
    """Fig. 2(a): accuracy + PDP of each AM deployed uniformly.

    The eight uniform deployments are scored in one batched evaluator call
    under a common noise instance (key 0).
    """
    rows = {"exact": {
        "accuracy": eval_accuracy(params, None, n_images, device=device),
        **hwmodel.sequence_cost(interleave.uniform_sequence("exact", N_SLOTS)),
    }}
    evaluate = make_batched_evaluator(params, n_images, noise_scale, device=device)
    seqs = np.stack([interleave.uniform_sequence(v, N_SLOTS)
                     for v in schemes.AM_VARIANTS])
    for v, seq, acc in zip(schemes.AM_VARIANTS, seqs, evaluate(seqs, 0)):
        rows[v] = {"accuracy": float(acc), **hwmodel.sequence_cost(seq)}
    return rows


def accuracy_ranking(uniform_rows: dict) -> list[str]:
    """AM variants ranked by uniform-deployment accuracy (paper's ranking)."""
    ams = [(v, r["accuracy"]) for v, r in uniform_rows.items() if v != "exact"]
    return [v for v, _ in sorted(ams, key=lambda t: -t[1])]


def nsga_study(params, k: int, *, ranking: list[str] | None = None,
               alphabet: list[int] | None = None, n_images: int = 512,
               pop_size: int = 24, generations: int = 15, seed: int = 0,
               noise_scale: float = 1.0, batched: bool = True,
               position_agnostic: bool | None = None, initial_genomes=None,
               log=print, device="cuda") -> dict:
    """NSGA-II over 198-slot sequences with a K-variant alphabet.

    Objectives (minimised): distinct-type area, total PDP, accuracy loss on
    the first ``n_images`` test images. ``batched`` scores a generation's
    new offspring in one evaluator call (else one call per genome; the
    fixed-block padding makes both give the same front). The memo key is
    the variant multiset when ``noise_scale <= 1`` (the default of
    ``position_agnostic``), the exact sequence otherwise.
    """
    if alphabet is not None:
        alphabet = [int(v) for v in alphabet]
        if len(alphabet) != k:
            raise ValueError(f"alphabet length {len(alphabet)} != k={k}")
    elif ranking is None:
        alphabet = interleave.alphabet_for_k(k)
    else:
        alphabet = [schemes.VARIANT_IDS[v] for v in ranking[:k]]
    if position_agnostic is None:
        position_agnostic = noise_scale <= 1.0
    eval_key = seed + 1000
    stats = nsga2.EvalStats()
    evaluate = make_batched_evaluator(params, n_images, noise_scale, device=device)

    if batched:
        def objectives_batch(genomes: np.ndarray) -> np.ndarray:
            accs = evaluate(genomes, eval_key)
            return np.column_stack([hwmodel.objectives_batch(genomes), 1.0 - accs])

        objective_kwargs = dict(objectives_batch=objectives_batch)
    else:
        def objectives(genome: np.ndarray) -> np.ndarray:
            cost = hwmodel.sequence_cost(genome)
            acc = float(evaluate(genome[None], eval_key)[0])
            return np.array([cost["area_um2"], cost["pdp_pj"], 1.0 - acc])

        objective_kwargs = dict(objective_fn=objectives)

    t0 = time.perf_counter()
    front = nsga2.optimize(
        genome_len=N_SLOTS, alphabet=alphabet, pop_size=pop_size,
        generations=generations, seed=seed, position_agnostic=position_agnostic,
        initial_genomes=initial_genomes, stats=stats,
        log=(lambda s: log(f"  [K={k}] {s}")) if log else None, **objective_kwargs)
    seconds = time.perf_counter() - t0
    knee = nsga2.knee_point(front)
    return {
        "k": k,
        "alphabet": list(map(int, alphabet)),
        "front": [{"objectives": ind.objectives.tolist(), "genome": ind.genome.tolist()}
                  for ind in front],
        "knee_genome": knee.genome.tolist(),
        "knee_objectives": knee.objectives.tolist(),
        "evals": stats.genomes_scored,
        "eval_stats": stats.as_dict(),
        "batched": batched,
        "genomes_per_sec": stats.genomes_requested / seconds if seconds > 0 else 0.0,
        "scored_genomes_per_sec": stats.genomes_scored / seconds if seconds > 0 else 0.0,
        "seconds": seconds,
    }


def displacement_study(params, seq, *, n_perms: int = 10, n_images: int = 2000,
                       seed: int = 0, noise_scale: float = 1.0, device="cuda") -> dict:
    """Fig. 5: random slot permutations of an optimised sequence, scored in
    one evaluator call under a common noise instance (key 7000 + seed)."""
    rng = np.random.default_rng(seed)
    perms = np.stack([interleave.random_displacement(np.asarray(seq, np.int32), rng)
                      for _ in range(n_perms)])
    evaluate = make_batched_evaluator(params, n_images, noise_scale, device=device)
    accs = [float(a) for a in evaluate(perms, 7000 + seed)]
    return {"accuracies": accs, "max": max(accs), "mean": float(np.mean(accs))}
