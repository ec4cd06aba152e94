"""Helpers shared by the ``test_torch_*`` files: the same numpy data goes
through the JAX reference (``repro``) and the PyTorch port (``repro_torch``).

The port runs on the CPU here; bf16 crosses numpy as float32 (numpy has no
bfloat16) and is cast back on each side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models.common import host_axis_env
from repro.models.model_zoo import build_model as ref_build_model
from repro_torch.configs import get_config as port_get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model as port_build_model

ENV = host_axis_env()


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def to_np(x) -> np.ndarray:
    """jax array or torch tensor -> numpy, bf16 upcast to float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if x.dtype == jnp.bfloat16:
        x = x.astype(jnp.float32)
    return np.asarray(x)


def np_tree(tree):
    return jax.tree_util.tree_map(to_np, tree)


def to_jax(a: np.ndarray, dtype=None):
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


def to_torch(a: np.ndarray, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def model_pair(arch: str, *, seed: int = 0, perturb: bool = True, **overrides):
    """(ref_model, ref_params, port_model, port_params) of the reduced config
    with the same weights: the reference's init, perturbed with seeded numpy
    noise so that biases and norm scales are not at their trivial values."""
    overrides = {"remat": "none", **overrides}
    rcfg = ref_get_config(arch).reduced().with_(**overrides)
    pcfg = port_get_config(arch).reduced().with_(**overrides)
    rmodel = ref_build_model(rcfg, ENV)
    rparams, _ = rmodel.init(jax.random.PRNGKey(seed))
    tree = np_tree(rparams)
    if perturb:
        rng = np.random.default_rng(seed + 1000)
        tree = jax.tree_util.tree_map(
            lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32),
            tree)
    pdtype = jnp.dtype(rcfg.param_dtype)
    rparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, pdtype), tree)
    pmodel = port_build_model(pcfg, "cpu")
    pparams = params_from_numpy(tree, device="cpu", dtype=pcfg.param_dtype)
    return rmodel, rparams, pmodel, pparams
