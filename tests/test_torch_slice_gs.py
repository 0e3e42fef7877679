"""The slice end to end for GS: the port's run_stream against JAX's.

Under every ``restructure_method`` and both drivers (fused and host loop):
final state and per-op pre/post/success bitwise, post-processed outputs to
rtol = atol = 1e-5 (torch and XLA CPU associate the Sum reduction
differently), and the port's fused driver equal to its host loop.
"""
import pytest

from torch_slice import METHODS, check_slice_against_reference


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fused", [True, False])
def test_gs_slice_matches_reference(method, fused):
    check_slice_against_reference("gs", method, fused)
