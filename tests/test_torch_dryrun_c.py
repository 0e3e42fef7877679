"""The port's dry run on the single-pod mesh (data 16, model 16) for the
cells of slice "c" of the archs (``torch_dryrun.ARCH_SLICES``), held
as ``tests/test_torch_dryrun.py`` holds slice "a": applicability and
reasons, param counts, per-device argument bytes exactly.
"""
import pytest

from torch_dryrun import cells, check_cell


@pytest.mark.parametrize("arch,shape", cells("c"))
def test_single_pod_cell_matches_reference(arch, shape):
    check_cell(arch, shape, multi_pod=False)
