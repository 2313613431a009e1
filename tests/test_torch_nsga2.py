"""Port parity: NSGA-II. With one fixed numpy objective, the port's search
returns the JAX package's front, genome for genome and bit for bit."""
import numpy as np
import pytest

from repro.core import hwmodel as jhw
from repro.core import nsga2 as jnsga
from repro_torch.core import hwmodel, nsga2

L = 198


def _objectives(genomes, hw):
    """Area, PDP and a deterministic 'accuracy loss' that favours variants 1
    and 5 and depends on slot order (so position matters)."""
    g = np.asarray(genomes)
    pos = np.linspace(1.0, 2.0, g.shape[1])
    loss = ((g == 1) * pos + 0.7 * (g == 5) * pos[::-1] + 0.3 * (g == 0)).mean(1)
    return np.column_stack([hw.objectives_batch(g), 1.0 - loss / 2.0])


def _front(res):
    return [(ind.genome.tolist(), ind.objectives.tolist(), ind.rank, ind.crowding)
            for ind in res]


@pytest.mark.parametrize("position_agnostic", [False, True])
@pytest.mark.parametrize("alphabet", [[4, 6], [0, 1, 5, 8]])
def test_optimize_same_front_as_jax(alphabet, position_agnostic):
    kw = dict(genome_len=L, alphabet=alphabet, pop_size=12, generations=6, seed=3,
              position_agnostic=position_agnostic)
    want_stats, got_stats = jnsga.EvalStats(), nsga2.EvalStats()
    want = jnsga.optimize(objectives_batch=lambda g: _objectives(g, jhw),
                          stats=want_stats, **kw)
    got = nsga2.optimize(objectives_batch=lambda g: _objectives(g, hwmodel),
                         stats=got_stats, **kw)
    assert _front(got) == _front(want)
    assert got_stats.as_dict() == want_stats.as_dict()


def test_per_genome_objective_and_warm_start_match_jax():
    warm = [np.full(L, 8, np.int32), np.arange(L, dtype=np.int32) % 3]
    kw = dict(genome_len=L, alphabet=[1, 2, 3], pop_size=9, generations=3, seed=5,
              initial_genomes=warm, mutation_rate=0.05)
    want = jnsga.optimize(lambda g: _objectives(g[None], jhw)[0], **kw)
    got = nsga2.optimize(lambda g: _objectives(g[None], hwmodel)[0], **kw)
    assert _front(got) == _front(want)


def test_sort_crowding_knee_equal_jax():
    rng = np.random.default_rng(0)
    objs = rng.integers(0, 6, (40, 3)).astype(float)
    for g, w in zip(nsga2.fast_non_dominated_sort(objs), jnsga.fast_non_dominated_sort(objs)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(nsga2.crowding_distance(objs[:7]),
                                  jnsga.crowding_distance(objs[:7]))
    front = [nsga2.Individual(np.full(3, i, np.int32), o) for i, o in enumerate(objs[:9])]
    jfront = [jnsga.Individual(np.full(3, i, np.int32), o) for i, o in enumerate(objs[:9])]
    assert nsga2.knee_point(front).genome.tolist() == jnsga.knee_point(jfront).genome.tolist()


def test_batch_evaluator_memo():
    calls = []

    def fn(batch):
        calls.append(batch.shape[0])
        return batch.sum(1, keepdims=True).astype(float)

    ev = nsga2.BatchEvaluator(fn, position_agnostic=True)
    g1, g2 = np.array([1, 2, 3]), np.array([3, 2, 1])
    out = ev([g1, g2, g1])
    assert calls == [1] and [o.tolist() for o in out] == [[6.0]] * 3
    assert ev.stats.as_dict() == {"batch_calls": 1, "genomes_requested": 3,
                                  "genomes_scored": 1, "cache_hits": 2,
                                  "cache_hit_rate": 2 / 3}
    ev_nomemo = nsga2.BatchEvaluator(fn, memoize=False)
    ev_nomemo([g1, g1])
    assert calls[-1] == 2
    with pytest.raises(ValueError, match="exactly one"):
        nsga2.optimize(genome_len=3, alphabet=[1])
