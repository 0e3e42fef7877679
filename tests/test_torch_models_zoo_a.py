"""The port's model zoo against the JAX package, part a of the ten
architectures (the rest are in ``test_torch_models_zoo_b.py``, so that
the two files run in parallel): at ``.smoke()``, ``forward`` logits,
``loss_fn`` and every grad leaf against ``jax.value_and_grad`` on the same
converted weights and batch, in float32 and in bfloat16 params (bars in
``tests/torch_models.py``), and the analytic parameter counts.
"""
import pytest

from repro.configs import get_arch as jax_arch
from repro_torch.configs import get_arch
from torch_models import check_bf16, check_f32

ARCHS = ["deepseek-v3-671b", "granite-34b", "hubert-xlarge", "minicpm-2b", "nemotron-4-15b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_grads_f32(arch):
    check_f32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_grads_bf16(arch):
    check_bf16(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_exact(arch):
    for port, ref in ((get_arch(arch), jax_arch(arch)),
                      (get_arch(arch).smoke(), jax_arch(arch).smoke())):
        assert port == type(port)(**ref.__dict__)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
