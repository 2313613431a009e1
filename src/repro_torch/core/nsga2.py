"""NSGA-II: non-dominated sorting genetic algorithm (Deb et al., 2002).

Integer-genome search used by the paper's multiplier-sequence optimisation
(Sec. III-A): minimise (area, PDP, accuracy loss) over length-198 variant-id
sequences. Evaluation is population-batched: each generation hands the
evaluator one (P, L) int32 array of the offspring not seen before, and
duplicates resolve from a memo cache. With ``position_agnostic`` (the
paper's multiset fitness) permutations of one multiset share an evaluation.

Pure numpy, drawing from ``np.random.default_rng(seed)`` in the same order
as the JAX package's ``core/nsga2.py``, so a deterministic objective gives
the same search in both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import schemes


@dataclasses.dataclass
class Individual:
    genome: np.ndarray  # int32 vector
    objectives: np.ndarray | None = None  # float64 vector, minimised
    rank: int = -1
    crowding: float = 0.0


@dataclasses.dataclass
class EvalStats:
    """Telemetry from the batched, memoised evaluation pipeline."""

    batch_calls: int = 0  # objectives_batch invocations (<= 1 + generations)
    genomes_requested: int = 0  # genomes the optimizer asked to score
    genomes_scored: int = 0  # genomes actually sent to the evaluator
    cache_hits: int = 0  # requests satisfied from the memo cache

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / self.genomes_requested if self.genomes_requested else 0.0

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "cache_hit_rate": self.cache_hit_rate}


class BatchEvaluator:
    """Memoising, batching front-end over a population objective.

    Wraps ``objectives_batch((P, L) int32) -> (P, M)`` so each call scores
    only genomes whose key was never seen. The key is the alphabet's
    signature followed by the genome's bytes (sorted first when
    ``position_agnostic``). ``memoize=False`` scores every genome every time.
    """

    def __init__(self, objectives_batch: Callable[[np.ndarray], np.ndarray], *,
                 memoize: bool = True, position_agnostic: bool = False):
        self._fn = objectives_batch
        self._memoize = memoize
        self._position_agnostic = position_agnostic
        self._salt = schemes.registry_signature()
        self._cache: dict[bytes, np.ndarray] = {}
        self.stats = EvalStats()

    def _key(self, genome: np.ndarray) -> bytes:
        g = np.ascontiguousarray(genome, np.int32)
        return self._salt + (np.sort(g).tobytes() if self._position_agnostic
                             else g.tobytes())

    def _score(self, batch: np.ndarray) -> np.ndarray:
        objs = np.asarray(self._fn(batch), float)
        if objs.shape[0] != batch.shape[0]:
            raise ValueError(f"objectives_batch returned {objs.shape[0]} rows for "
                             f"{batch.shape[0]} genomes")
        self.stats.batch_calls += 1
        self.stats.genomes_scored += batch.shape[0]
        return objs

    def __call__(self, genomes: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Score a list of genomes; returns per-genome objective vectors."""
        genomes = [np.asarray(g, np.int32) for g in genomes]
        self.stats.genomes_requested += len(genomes)
        if not self._memoize:
            return list(self._score(np.stack(genomes).astype(np.int32)))
        keys = [self._key(g) for g in genomes]
        todo_keys, todo_genomes, pending = [], [], set()
        for g, k in zip(genomes, keys):
            if k in self._cache or k in pending:
                self.stats.cache_hits += 1
                continue
            pending.add(k)
            todo_keys.append(k)
            todo_genomes.append(g)
        if todo_genomes:
            objs = self._score(np.stack(todo_genomes).astype(np.int32))
            for k, o in zip(todo_keys, objs):
                self._cache[k] = o
        return [self._cache[k] for k in keys]


def per_individual_batch(objective_fn: Callable[[np.ndarray], np.ndarray]):
    """Lift a genome -> objectives function to a batch function."""

    def objectives_batch(genomes: np.ndarray) -> np.ndarray:
        return np.stack([np.asarray(objective_fn(g), float) for g in genomes])

    return objectives_batch


def fast_non_dominated_sort(objs: np.ndarray) -> list[np.ndarray]:
    """Fronts (index arrays) by Pareto rank. objs: (P, M), minimised."""
    p = objs.shape[0]
    le = (objs[:, None, :] <= objs[None, :, :]).all(-1)
    lt = (objs[:, None, :] < objs[None, :, :]).any(-1)
    dominates = le & lt  # dominates[i, j]: i dominates j
    n_dom = dominates.sum(0)
    fronts = []
    assigned = np.zeros(p, bool)
    current = np.where(n_dom == 0)[0]
    while current.size:
        fronts.append(current)
        assigned[current] = True
        n_dom = n_dom - dominates[current].sum(0)
        current = np.where((n_dom == 0) & ~assigned)[0]
    return fronts


def crowding_distance(objs: np.ndarray) -> np.ndarray:
    """Crowding distance within one front. objs: (F, M)."""
    f, m = objs.shape
    if f <= 2:
        return np.full(f, np.inf)
    d = np.zeros(f)
    for j in range(m):
        order = np.argsort(objs[:, j], kind="stable")
        span = objs[order[-1], j] - objs[order[0], j]
        d[order[0]] = d[order[-1]] = np.inf
        if span > 0:
            d[order[1:-1]] += (objs[order[2:], j] - objs[order[:-2], j]) / span
    return d


def _rank_population(pop: list[Individual]) -> None:
    objs = np.stack([ind.objectives for ind in pop])
    for r, front in enumerate(fast_non_dominated_sort(objs)):
        cd = crowding_distance(objs[front])
        for i, idx in enumerate(front):
            pop[idx].rank = r
            pop[idx].crowding = cd[i]


def _tournament(pop: list[Individual], rng: np.random.Generator) -> Individual:
    a, b = rng.integers(0, len(pop), 2)
    pa, pb = pop[a], pop[b]
    if pa.rank != pb.rank:
        return pa if pa.rank < pb.rank else pb
    return pa if pa.crowding > pb.crowding else pb


def _crossover(g1: np.ndarray, g2: np.ndarray, rng: np.random.Generator):
    mask = rng.random(g1.size) < 0.5  # uniform crossover
    return np.where(mask, g1, g2), np.where(mask, g2, g1)


def _mutate(g: np.ndarray, alphabet: np.ndarray, rate: float, rng: np.random.Generator):
    mask = rng.random(g.size) < rate
    repl = alphabet[rng.integers(0, alphabet.size, g.size)]
    return np.where(mask, repl, g).astype(np.int32)


def optimize(
    objective_fn: Callable[[np.ndarray], np.ndarray] | None = None,
    genome_len: int = 0,
    alphabet: Sequence[int] = (),
    *,
    objectives_batch: Callable[[np.ndarray], np.ndarray] | None = None,
    pop_size: int = 24,
    generations: int = 20,
    mutation_rate: float | None = None,
    seed: int = 0,
    memoize: bool = True,
    position_agnostic: bool = False,
    initial_genomes: Sequence[np.ndarray] | None = None,
    stats: EvalStats | None = None,
    log: Callable[[str], None] | None = None,
) -> list[Individual]:
    """Run NSGA-II; returns the final population's first Pareto front.

    Exactly one of ``objective_fn`` (genome -> (M,) objectives) and
    ``objectives_batch`` ((P, L) genomes -> (P, M)) is given. The initial
    population is alphabet-uniform random genomes, the first
    ``max(1, pop_size // 8)`` replaced by single-variant genomes;
    ``initial_genomes`` fill from the tail without displacing those.
    """
    if (objective_fn is None) == (objectives_batch is None):
        raise ValueError("provide exactly one of objective_fn / objectives_batch")
    if genome_len <= 0:
        raise ValueError(f"genome_len must be positive, got {genome_len}")
    if not len(alphabet):
        raise ValueError("alphabet must be non-empty")
    if objectives_batch is None:
        objectives_batch = per_individual_batch(objective_fn)
    evaluator = BatchEvaluator(objectives_batch, memoize=memoize,
                               position_agnostic=position_agnostic)
    if stats is not None:
        evaluator.stats = stats

    rng = np.random.default_rng(seed)
    alpha = np.asarray(list(alphabet), np.int32)
    rate = mutation_rate if mutation_rate is not None else 2.0 / genome_len

    genomes = [alpha[rng.integers(0, alpha.size, genome_len)] for _ in range(pop_size)]
    for i, v in enumerate(alpha[: max(1, pop_size // 8)]):
        genomes[i] = np.full(genome_len, v, np.int32)
    n_uniform = min(max(1, pop_size // 8), len(alpha))
    if initial_genomes is not None:
        warm = [np.asarray(g, np.int32) for g in initial_genomes]
        for g in warm:
            if g.shape != (genome_len,):
                raise ValueError(f"initial genome shape {g.shape} != ({genome_len},)")
        for i, g in enumerate(warm[: pop_size - n_uniform]):
            genomes[pop_size - 1 - i] = g
    objs = evaluator(genomes)
    pop = [Individual(genome=g, objectives=o) for g, o in zip(genomes, objs)]
    _rank_population(pop)

    for gen in range(generations):
        child_genomes: list[np.ndarray] = []
        while len(child_genomes) < pop_size:
            p1, p2 = _tournament(pop, rng), _tournament(pop, rng)
            c1, c2 = _crossover(p1.genome, p2.genome, rng)
            child_genomes.append(_mutate(c1, alpha, rate, rng))
            if len(child_genomes) < pop_size:
                child_genomes.append(_mutate(c2, alpha, rate, rng))
        child_objs = evaluator(child_genomes)
        union = pop + [Individual(genome=g, objectives=o)
                       for g, o in zip(child_genomes, child_objs)]
        _rank_population(union)
        union.sort(key=lambda ind: (ind.rank, -ind.crowding))
        pop = union[:pop_size]
        _rank_population(pop)
        if log:
            f0 = [ind for ind in pop if ind.rank == 0]
            best = min(ind.objectives[-1] for ind in f0)
            log(f"gen {gen + 1}/{generations}: front0={len(f0)} best_last_obj={best:.4f}")

    return [ind for ind in pop if ind.rank == 0]


def knee_point(front: list[Individual]) -> Individual:
    """The paper's highlighted solution: least normalised L2 to the ideal."""
    objs = np.stack([ind.objectives for ind in front])
    lo, hi = objs.min(0), objs.max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    norm = (objs - lo) / span
    return front[int(np.argmin(np.linalg.norm(norm, axis=1)))]
