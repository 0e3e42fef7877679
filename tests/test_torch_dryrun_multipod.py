"""The port's dry run (``repro_torch/launch/dryrun.py``) on the multi-pod
mesh (pod 2, data 16, model 16): ``run_cell`` for the cells of slice "a"
of the archs (``torch_dryrun.ARCH_SLICES``; slices "b" and "c" in
``tests/test_torch_dryrun_multipod_b.py`` / ``_c.py``: all 40 (arch x
shape) cells together) against the reference, as
``tests/test_torch_dryrun.py`` holds the single-pod mesh (applicability
and reasons, param counts, per-device argument bytes exactly;
``tests/torch_dryrun.py``).  EP spans (data, model) inside each pod here,
so the MoE cells' all-to-alls run in groups of 256 over 512 shards.
"""
import pytest

from torch_dryrun import cells, check_cell


@pytest.mark.parametrize("arch,shape", cells("a"))
def test_multi_pod_cell_matches_reference(arch, shape):
    check_cell(arch, shape, multi_pod=True)
