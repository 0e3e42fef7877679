"""The slice end to end for SL: the port's run_stream against JAX's.

SL is gated and non-associative, so both engines take the lockstep path.
Under every ``restructure_method`` and both drivers (fused and host loop):
final state, per-op pre/post/success and the post-processed outputs
bitwise (SL's outputs are selections, no arithmetic), and the port's fused
driver equal to its host loop.  Two streams exercise what a default stream
rarely reaches: an overdrawn one under ``abort_repass`` (transactions
abort and are masked on the repass) and a skewed one over a small store
(dependency cycles leave chains to the sequential residue sweep).
"""
import numpy as np
import pytest

from torch_slice import METHODS, check_slice_against_reference


def overdraw(stream):
    """Amounts x 100: most transfers overdraw their source and abort."""
    stream["amount"] = (stream["amount"] * 100).astype(np.float32)


def _rejected(outs):
    return sum(int(np.sum(o["rejected"])) for o in outs)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fused", [True, False])
def test_sl_slice_matches_reference(method, fused):
    _, stats = check_slice_against_reference("sl", method, fused,
                                             exact_outputs=True)
    assert all(s.path == "lockstep" for s in stats)
    assert sum(s.swept for s in stats) > 0


@pytest.mark.parametrize("method", ["partition", "lexsort"])
@pytest.mark.parametrize("fused", [True, False])
def test_sl_overdrawn_abort_repass_matches_reference(method, fused):
    outs, _ = check_slice_against_reference(
        "sl", method, fused, mutate=overdraw,
        cfg_kw=dict(abort_repass=True), exact_outputs=True)
    # transfers that overdraw abort: both debits masked on the repass
    assert _rejected(outs) > 0


@pytest.mark.parametrize("method", ["partition", "packed"])
@pytest.mark.parametrize("fused", [True, False])
def test_sl_skewed_residue_matches_reference(method, fused):
    _, stats = check_slice_against_reference(
        "sl", method, fused, n_keys=64, gen_kw=dict(theta=0.99),
        exact_outputs=True)
    # chains left unresolved after max_dep_levels took the sequential sweep
    assert sum(s.residue for s in stats) > 0


@pytest.mark.parametrize("fused", [True, False])
def test_sl_overdrawn_skewed_with_repass_matches_reference(fused):
    outs, stats = check_slice_against_reference(
        "sl", "partition", fused, n_keys=64, gen_kw=dict(theta=0.99),
        mutate=overdraw, cfg_kw=dict(abort_repass=True), exact_outputs=True)
    assert _rejected(outs) > 0
    assert sum(s.residue for s in stats) > 0
