"""Shared inputs of the ``test_torch_*`` files: seeded numpy matrices that
go through both the JAX package and the PyTorch port, the field dicts
that carry the JAX package's packed formats across, and the LM smoke
models' parameters carried the same way (and, for training, their
gradients, moments and updated weights)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.core import formats as ref_formats
from repro.core import suite as ref_suite
from repro.models import transformer as ref_tf
from repro_torch.configs import base as port_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import formats as port_formats

FAMILIES = ("mesh2d_24", "blkdiag_1024_8", "plaw_1024_10", "kron_10_8",
            "road_32", "er_1024_8")


def integer_dense(n, m, density, seed):
    """Integer values in {1, 2, 3}: fp32 sums are exact in any order."""
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density)
            * rng.integers(1, 4, (n, m))).astype(np.float32)


def float_dense(n, m, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density)
            * rng.uniform(0.5, 2.0, (n, m))).astype(np.float32)


def empty_rows_and_blocks():
    """Rows 8..15 form an empty 8-row block; most rows are empty."""
    dense = np.zeros((40, 32), np.float32)
    dense[0, [1, 9, 30]] = [1.0, 2.0, 3.0]
    dense[20, 5] = 4.0
    dense[39, 31] = 5.0
    return dense


def host_pair(dense):
    """The same matrix as a JAX-package and a port HostCSR."""
    return (ref_formats.HostCSR.from_dense(dense),
            port_formats.HostCSR.from_dense(dense))


def family_pair(name, *, integer=True):
    """A suite family as (reference HostCSR, port HostCSR), values
    replaced by seeded integers when ``integer``."""
    spec = next(s for s in ref_suite.SUITE if s.name == name)
    ref = ref_suite.generate(spec)
    data = ref.data
    if integer:
        data = np.random.default_rng(len(name)).integers(
            1, 4, ref.nnz).astype(np.float32)
    ref = ref_formats.HostCSR(ref.indptr, ref.indices, data, ref.shape)
    port = port_formats.HostCSR(ref.indptr, ref.indices, data, ref.shape)
    return ref, port


def ref_fields(obj) -> dict:
    """A JAX-package dataclass as {field: numpy value}."""
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def as_numpy(x):
    """A port field (tensor or int) as numpy, bf16 widened to fp32."""
    if hasattr(x, "detach"):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.detach().numpy()
    return np.asarray(x)


def assert_same_fields(ref_obj, port_obj):
    """Field-by-field equality of a JAX-package format and its port."""
    for name, want in ref_fields(ref_obj).items():
        got = as_numpy(getattr(port_obj, name))
        if want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert np.array_equal(got, want), name


@functools.lru_cache(maxsize=None)
def lm_params_pair(arch):
    """Both packages' smoke configs of ``arch`` and parameters — the JAX
    package's ``init_params(PRNGKey(0))``, carried onto the CPU by
    ``lm_params_from_numpy``: made once per architecture and process,
    only read by the tests. Returns (ref config, ref params, port
    config, port params)."""
    rcfg = ref_configs.smoke_config(arch)
    cfg = port_configs.smoke_config(arch)
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, rparams)
    return rcfg, rparams, cfg, lm_params_from_numpy(cfg, tree, device="cpu")


def trainable_pair_copy(cfg, rparams):
    """A trainable copy, in the port, of the JAX package's parameters."""
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rparams),
                                  device="cpu")
    return params.requires_grad_(True)


def ref_named(cfg, tree):
    """A tree laid out as the JAX package's parameters (its gradients,
    moments or updated weights) as numpy arrays under the port's
    parameter names."""
    loaded = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, tree),
                                  device="cpu")
    return {k: v.detach().numpy() for k, v in loaded.named_parameters()}


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the test: the smoke models' training runs
    thousands of tiny ops, and with every parallel test worker spinning
    all the cores' worth of threads on each one, a 4 s run took 380 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
