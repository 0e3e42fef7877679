"""The dry run's partitioned trace against the reference's compiled
partitioned program: the JAX package's ``build_step`` jitted with its
shardings on a (data 2, model 4) mesh of Auto axes over 8 forced host
devices, compiled in a subprocess (``tests/torch_dryrun.
xla_partitioned_costs``), and read with its own ``analyze_hlo``; the port's
step traced on the one-shard form of the same mesh, as ``run_cell`` traces
it (``port_partitioned_costs``).  The dense smoke archs minicpm-2b (MHA)
and granite-34b (MQA), train and prefill, batch 8 x sequence 32.

Per-device dot FLOPs are held within ``FLOPS_TOL`` (2%) of XLA's, net of the
work the port's program does beyond XLA's, counted from the config alone
(``port_extra_flops``): MQA's K/V projections, which each shard runs for
its data block's whole sequence where XLA projects the shard's sequence
block, and, in the train step, each layer's down projection, which
``torch.utils.checkpoint`` recomputes and XLA does not.  The counts agree
exactly (minicpm-2b's prefill has no such work and matches as it is).
XLA picks its own collectives (it runs these layers sequence-parallel
where the port runs them over heads), so the bytes by kind get no bar
(``scripts/dryrun_vs_xla.py`` prints them beside the port's).
"""
import pytest

from repro_torch.configs import get_arch
from repro_torch.models import moe_ep

from torch_dryrun import (port_extra_flops, port_partitioned_costs,
                          xla_partitioned_costs)

FLOPS_TOL = 0.02
B, S = 8, 32
CELLS = [(a, k) for a in ("minicpm-2b", "granite-34b")
         for k in ("train", "prefill")]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return xla_partitioned_costs(CELLS, B, S,
                                 str(tmp_path_factory.mktemp("xla")))


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    yield
    moe_ep.set_ep_mesh(None, ("data",))


@pytest.mark.parametrize("arch,kind", CELLS)
def test_dot_flops_per_device_match_xla(arch, kind, reference):
    want = reference[(arch, kind)]["dot_flops"]
    got = port_partitioned_costs(arch, kind, B, S)["dot_flops"]
    extra = port_extra_flops(get_arch(arch).smoke(), kind, B, S)
    assert want > 0 and got > 0
    assert abs(got - extra - want) <= FLOPS_TOL * want
    assert got - extra == want            # what this tree shows today
    if (arch, kind) == ("minicpm-2b", "prefill"):
        assert extra == 0 and got == want
