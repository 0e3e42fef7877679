"""The slice end to end for OB: the port's run_stream against JAX's.

OB's bid is a conditional fun, so both engines take the lockstep path (no
gates: one sweep).  Under every ``restructure_method`` and both drivers:
final state, per-op pre/post/success and the outputs bitwise, and the
port's fused driver equal to its host loop.  The port's sweep visits only
the rounds that hold a valid op, far fewer than the chain length the
reference sweeps (its padding chain's included), while its reported
rounds stay the reference's.
"""
import numpy as np
import pytest

from torch_slice import METHODS, check_slice_against_reference


def _rejected(outs):
    return sum(int(np.sum(o["rejected"])) for o in outs)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fused", [True, False])
def test_ob_slice_matches_reference(method, fused):
    outs, stats = check_slice_against_reference("ob", method, fused,
                                                exact_outputs=True)
    assert _rejected(outs) > 0
    for s in stats:
        assert s.path == "lockstep"
        # the reference's count is the longest chain, padding included;
        # the port ran only the rounds with an active op
        assert int(s.rounds) == int(s.max_chain)
        assert 0 < s.swept < int(s.rounds)


@pytest.mark.parametrize("method", ["partition", "auto"])
@pytest.mark.parametrize("fused", [True, False])
def test_ob_abort_repass_matches_reference(method, fused):
    outs, _ = check_slice_against_reference(
        "ob", method, fused, n_keys=500, cfg_kw=dict(abort_repass=True),
        exact_outputs=True)
    # a rejected bid aborts its transaction
    assert _rejected(outs) > 0
