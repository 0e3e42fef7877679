"""The port's dry run (``repro_torch/launch/dryrun.py``) on the single-pod
mesh (data 16, model 16), the traced FLOPs against XLA's, and the sweep.

Held here and in ``tests/test_torch_dryrun_b.py`` / ``_c.py`` (each file
runs the cells of one slice of the archs, ``torch_dryrun.ARCH_SLICES``):
``run_cell`` for all 40 (arch x shape) cells: the 31 cells the reference
runs trace one shard's program of the partitioned step at full size on
meta tensors, and the 9 it skips are skipped with its reasons;
``model_params`` and ``active_params`` equal the reference's;
``mem.argument_bytes`` equals the per-device count from the reference's
specs and ``jax.eval_shape`` exactly; FLOPs are per device, every train
cell all-gathers and reduce-scatters, and only the MoE train and prefill
cells run EP all-to-alls (``tests/torch_dryrun.check_cell``).
The traced ``dot_flops`` of the train and prefill steps of two dense smoke
archs (granite-34b, minicpm-2b) on a (1, 1) mesh (no partitioned plan: the
one-device program) equal the reference's ``analyze_hlo`` of the same step
compiled on one CPU device: the stated tolerance is 2%, and the
counts agree exactly (MoE archs are not held: XLA may lower ``ragged_dot``
over every expert).  The sweep writes one JSON per cell and skips cached
cells on a rerun.  The multi-pod cells are in
``tests/test_torch_dryrun_multipod*.py``.
"""
import json
import os

import jax
import pytest

from repro.configs import get_arch as jax_arch
from repro.launch import steps as jsteps
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import ShapeCfg as JShapeCfg
from repro_torch.configs import get_arch
from repro_torch.launch import sweep
from repro_torch.launch.hlo_analysis import ProgramTrace, analyze
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.steps import build_step
from repro_torch.models import ShapeCfg, moe_ep

from torch_dryrun import ARCH_SLICES, CELLS, cells, check_cell

FLOPS_TOL = 0.02


@pytest.mark.parametrize("arch,shape", cells("a"))
def test_single_pod_cell_matches_reference(arch, shape):
    check_cell(arch, shape, multi_pod=False)


def test_slices_cover_every_cell_once():
    archs = [a for part in sorted(ARCH_SLICES) for a in ARCH_SLICES[part]]
    assert sorted(archs) == sorted({a for a, _ in CELLS})
    assert sorted(c for part in ARCH_SLICES for c in cells(part)) == \
        sorted(CELLS)


def test_cell_counts():
    from repro.models import SHAPES, cell_is_applicable
    from repro.configs import ARCHS
    ran = sum(cell_is_applicable(c, s)[0] for c in ARCHS.values()
              for s in SHAPES)
    assert len(CELLS) == 40 and ran == 31


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["granite-34b", "minicpm-2b"])
def test_dot_flops_match_xla(arch, kind):
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    with mesh:
        fn, specs = jsteps.build_step(jax_arch(arch).smoke(),
                                      JShapeCfg("t", 32, 2, kind), mesh)
        want = analyze_hlo(fn.lower(*specs).compile().as_text(), 1)
    fn, structs = build_step(get_arch(arch).smoke(),
                             ShapeCfg("t", 32, 2, kind),
                             MeshSpec({"data": 1, "model": 1}))
    try:
        with ProgramTrace() as trace:
            fn(*structs)
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    got = analyze(trace, 1)["dot_flops"]
    assert abs(got - want["dot_flops"]) <= FLOPS_TOL * want["dot_flops"]
    assert got == want["dot_flops"]       # what this tree shows today


def test_sweep_writes_one_json_per_cell_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "dry")
    argv = ["--out", out, "--only-single-pod", "--archs", "hubert-xlarge"]
    sweep.main(argv)
    files = sorted(os.listdir(out))
    assert files == sorted(f"hubert-xlarge__{s}__sp.json"
                           for s in sweep.SHAPE_ORDER)
    with open(os.path.join(out, "hubert-xlarge__decode_32k__sp.json")) as f:
        assert json.load(f)["skipped"] is True
    with open(os.path.join(out, "hubert-xlarge__train_4k__sp.json")) as f:
        cell = json.load(f)
    assert cell["skipped"] is False and cell["hlo_flops"] > 0
    capsys.readouterr()
    sweep.main(argv)
    err = capsys.readouterr().err
    assert err.count("skip cached") == 4 and "running" not in err
