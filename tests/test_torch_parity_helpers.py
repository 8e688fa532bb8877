"""Helpers of the port's parity tests against the JAX package: a training
config in the JAX key names, weights drawn with numpy in the shapes of the
JAX parameter tree, and the two inference modules on those weights (the
port's through ``params_from_jax``, on the CPU); and ``one_torch_thread``,
a module's tests and their child processes on one torch thread."""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from scaling_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from scaling_tpu.models.transformer.inference import (  # noqa: E402
    TransformerInferenceModule as JaxInference,
)
from scaling_tpu.models.transformer.model import init_model as jax_init_model  # noqa: E402
from scaling_tpu_torch.models.transformer import (  # noqa: E402
    TransformerArchitectureConfig,
    TransformerInferenceModule,
)
from scaling_tpu_torch.models.transformer.convert import params_from_jax  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for the tests of a module that imports this
    fixture, and (through ``OMP_NUM_THREADS``) for the processes they start.
    The suite runs in several worker processes at once, and a toy model's
    many small ops spread over every core stall one another: on 8 cores
    shared by 6 workers the toy trainer phase took minutes, alone 3 s."""
    with pytest.MonkeyPatch.context() as mp:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            mp.setenv(var, "1")
        yield
        torch.set_num_threads(threads)


def config_dict(arch: dict, mbs: int = 2, gas: int = 1, lr: float = 3e-3, **sections) -> dict:
    return {
        "topology": {"model_parallel_size": 1, "pipe_parallel_size": 1,
                     "data_parallel_size": 1, "micro_batch_size": mbs,
                     "gradient_accumulation_steps": gas},
        "transformer_architecture": arch,
        "optimizer": {"gradient_clipping": 1.0, "loss_scaler": {"enable": False}},
        "learning_rate_scheduler": {"learning_rate": lr, "learning_rate_warmup_steps": 10,
                                    "learning_rate_decay_iters": 1000},
        "trainer": {"seed": 0},
        **sections,
    }


def random_params(template, rng):
    """Numpy weights shaped like the JAX tree: xavier-scaled matrices,
    small nonzero biases, norm gains near 1 (nonzero biases exercise the
    bias plumbing that a zero init would hide)."""
    def draw(path, leaf):
        shape = leaf.shape
        if len(shape) == 2:
            return (rng.normal(size=shape) * np.sqrt(2.0 / sum(shape))).astype(np.float32)
        if "norm" in jax.tree_util.keystr(path) and "bias" not in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.02 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


def draw(module, seed: int = 0):
    """Numpy weights for one JAX layer (``module.init``'s tree)."""
    template = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(0)))
    return random_params(template, np.random.default_rng(seed))


def module_state(tree) -> dict:
    """A JAX layer's numpy parameter tree as the port layer's state dict."""
    state = params_from_jax({"m": tree}, types.SimpleNamespace(dtype=torch.float32))
    return {k[len("layers.m."):]: v for k, v in state.items()}


def draw_weights(arch: dict, seed: int = 0):
    """(JAX config, its module, numpy weights) for ``arch``."""
    config = JaxConfig.from_dict(config_dict(arch))
    module = jax_init_model(config, None)
    template = jax.tree.map(np.asarray, module.init_params(jax.random.PRNGKey(0)))
    return config, module, random_params(template, np.random.default_rng(seed))


def inference_pair(arch: dict, seed: int = 0):
    """The JAX and the port's inference modules on the same numpy weights."""
    config, module, np_params = draw_weights(arch, seed)
    jax_inf = JaxInference(config, module, jax.tree.map(jnp.asarray, np_params))
    port_arch = TransformerArchitectureConfig.from_dict(arch)
    port_inf = TransformerInferenceModule.from_state_dict(
        port_arch, params_from_jax(np_params, port_arch), device="cpu")
    return jax_inf, port_inf


def route_flash_as_bf16(monkeypatch) -> None:
    """Let f32 layers take the flash route a bf16 layer takes: the gate with
    its dtype rule set aside, so a test can hold the flash path itself (the
    kernels' plain versions, which compute in any float dtype on the CPU)
    in f32. The dtype rule has its own tests."""
    from scaling_tpu_torch.nn import attention

    gate = attention.flash_path_active
    monkeypatch.setattr(attention, "flash_path_active",
                        lambda **kw: gate(**{**kw, "dtype": torch.bfloat16}))
