"""Port parity: the paper's experiment pipeline (batched surrogate
evaluator, Fig. 2(a) uniform study, NSGA-II study, displacement) on the CPU.

The batched evaluator is handed the reference evaluator's noise, recomputed
with the same jax.random calls; accuracies then agree to within one image
in 64 (float32 GEMM orders differ, which can flip a near-tie argmax).
"""
import jax
import numpy as np
import pytest
import torch

from repro.experiments import paper_cnn as jpaper
from repro_torch.core import hwmodel, interleave
from repro_torch.experiments import paper_cnn


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return paper_cnn.load_params("cpu")


def test_load_params_equal_committed_npz(params):
    with np.load(paper_cnn.PARAMS_FILE) as d:
        for k in d.files:
            np.testing.assert_array_equal(params[k].numpy(), d[k])
            assert params[k].dtype == torch.float32


def test_batched_evaluator_with_reference_noise_vs_jax(params):
    n_images = 64
    genomes = np.random.default_rng(0).integers(0, 9, (4, paper_cnn.N_SLOTS)).astype(np.int32)
    genomes[0] = 4
    key = jax.random.PRNGKey(11)
    want = jpaper.make_batched_evaluator(jpaper.load_params(), n_images)(genomes, key)
    # paper_cnn.py: one image chunk of 64; k1, k2 = split(fold_in(key, 0)).
    k1, k2 = jax.random.split(jax.random.fold_in(key, 0))
    z1 = np.asarray(jax.random.normal(k1, (10, 64, 30, 30)))
    z2 = np.asarray(jax.random.normal(k2, (12, 64 * 144)))
    got = paper_cnn.make_batched_evaluator(params, n_images, device="cpu",
                                           noise=[(z1, z2)])(genomes, 0)
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1 / 64 + 1e-12)


def test_batched_evaluator_score_independent_of_batch(params):
    ev = paper_cnn.make_batched_evaluator(params, 32, image_chunk=16, device="cpu")
    genomes = np.random.default_rng(1).integers(0, 9, (5, paper_cnn.N_SLOTS))
    together = ev(genomes, 9)
    alone = np.array([ev(g[None], 9)[0] for g in genomes])
    np.testing.assert_array_equal(together, alone)
    with pytest.raises(ValueError, match="genome length"):
        ev(genomes[:, :10], 9)


def test_uniform_study_rows(params):
    rows = paper_cnn.uniform_study(params, 64, device="cpu")
    assert list(rows) == ["exact", "pm_ni", "pm_si", "pm_ci", "pm_csi", "nm_ni",
                          "nm_si", "nm_ci", "nm_csi"]
    for v, r in rows.items():
        assert r == {**r, **hwmodel.sequence_cost(interleave.uniform_sequence(v, 198))}
        assert abs(r["accuracy"] - rows["exact"]["accuracy"]) <= 0.05
    assert paper_cnn.accuracy_ranking(rows)[0] in rows


def test_nsga_study_batched_equals_per_genome_and_displacement(params):
    kw = dict(n_images=32, pop_size=6, generations=2, log=None, device="cpu")
    batched = paper_cnn.nsga_study(params, 2, **kw)
    single = paper_cnn.nsga_study(params, 2, batched=False, **kw)
    assert batched["front"] == single["front"]
    assert batched["knee_genome"] == single["knee_genome"]
    assert set(batched["knee_genome"]) <= set(interleave.alphabet_for_k(2))
    assert batched["eval_stats"]["genomes_requested"] == 6 * 3
    disp = paper_cnn.displacement_study(params, batched["knee_genome"], n_perms=3,
                                        n_images=32, device="cpu")
    assert len(disp["accuracies"]) == 3 and disp["max"] >= disp["mean"]


def test_eval_accuracy_numerics(params):
    seq = interleave.uniform_sequence("nm_csi", paper_cnn.N_SLOTS)
    exact = paper_cnn.eval_accuracy(params, None, 16, device="cpu")
    bit = paper_cnn.eval_accuracy(params, seq, 4, numerics="bitexact_cuda", device="cpu")
    sur = paper_cnn.eval_accuracy(params, seq, 16, key=1, device="cpu")
    assert 0.0 <= bit <= 1.0 and abs(sur - exact) <= 2 / 16
