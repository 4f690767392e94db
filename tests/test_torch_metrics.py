"""The port's paper §5 accounting (``repro_torch.core.metrics``) against
the reference's, on the inputs of the reference's ``tests/test_metrics.py``:
Table 5.1's timelines and speedup, block and LPT assignment, makespan and
evenness."""

import numpy as np
import pytest

from repro.core import metrics as ref
from repro_torch.core import metrics


def test_paper_constants_equal_the_reference():
    for name in ("PAPER_TIMESTAMPS", "PAPER_PC", "PAPER_CLUSTER"):
        assert getattr(metrics, name) == getattr(ref, name)
    assert metrics.ClusterSpec().batch_per_slice == \
        ref.ClusterSpec().batch_per_slice == 48


@pytest.mark.parametrize("n_nodes", [6, 12])
def test_timelines_and_speedup_equal_the_reference(n_nodes):
    spec, ref_spec = metrics.ClusterSpec(n_nodes=n_nodes), \
        ref.ClusterSpec(n_nodes=n_nodes)
    stamps = metrics.PAPER_TIMESTAMPS + [15.0, 720.0]
    assert metrics.cluster_timeline(spec, stamps) == \
        ref.cluster_timeline(ref_spec, stamps)
    assert metrics.personal_timeline(720 / 74, stamps) == \
        ref.personal_timeline(720 / 74, stamps)
    for t in stamps:
        assert metrics.speedup_at(spec, 720 / 74, float(t)) == \
            ref.speedup_at(ref_spec, 720 / 74, float(t))


@pytest.mark.parametrize("n,w", [(48, 6), (1, 1), (200, 16), (7, 3),
                                 (100, 8)])
def test_block_assignment_equals_the_reference(n, w):
    got, want = metrics.block_assignment(n, w), ref.block_assignment(n, w)
    np.testing.assert_array_equal(got, want)
    assert metrics.distribution_evenness(got, w) == \
        ref.distribution_evenness(want, w)


@pytest.mark.parametrize("seed", range(0, 200, 20))
def test_lpt_and_makespan_equal_the_reference(seed):
    costs = np.random.default_rng(seed).uniform(0.3, 1.0, size=48)
    for w in (2, 3, 6, 8):
        got, want = metrics.lpt_assignment(costs, w), \
            ref.lpt_assignment(costs, w)
        np.testing.assert_array_equal(got, want)
        assert metrics.makespan(costs, got, w) == ref.makespan(costs, want, w)
        block = ref.block_assignment(48, w)
        assert metrics.makespan(costs, block, w) == \
            ref.makespan(costs, block, w)


def test_lpt_on_fixed_costs_equals_the_reference():
    costs = np.asarray([5.0, 3.0, 3.0, 2.0, 2.0, 2.0, 1.0])
    got, want = metrics.lpt_assignment(costs, 3), ref.lpt_assignment(costs, 3)
    np.testing.assert_array_equal(got, want)
    assert metrics.makespan(costs, got, 3) == ref.makespan(costs, want, 3)
    assert metrics.distribution_evenness(got, 3) == \
        ref.distribution_evenness(want, 3)
