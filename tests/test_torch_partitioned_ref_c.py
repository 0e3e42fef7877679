"""The port's partitioned steps against the reference's own, for
nemotron-4-15b (relu2), qwen1.5-110b (q/k/v biases) and hubert-xlarge
(encoder, frames in; no decode): the JAX package's ``build_step`` jitted
with its ``in_shardings`` on a (2, 4) ``("data", "model")`` mesh of Auto
axes over 8 forced host devices, computed once for the module in a
subprocess (``torch_partitioned.run_reference``).

Float32 params from the JAX init (converted), the same mid-run float32
AdamW state, batch, decode cache and tokens; the port's steps on the same
mesh in two device groups on the CPU, everything placed by the specs.
Held within 1e-4 of each leaf's largest magnitude: the train step's loss,
new params and AdamW moments; the prefill logits; the decode logits and
new caches (the serving layout).
"""
import pytest
import torch

from repro_torch.models import moe_ep

import torch_partitioned as tp

torch.set_num_threads(1)

ARCHS = ["nemotron-4-15b", "qwen1.5-110b", "hubert-xlarge"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference(tmp_path_factory.mktemp("partitioned_ref"),
                            ARCHS)


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    yield
    moe_ep.set_ep_mesh(None, ("data",))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, reference):
    tp.check_train_against_reference(arch, reference[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, reference):
    tp.check_serve_against_reference(arch, reference[arch])
