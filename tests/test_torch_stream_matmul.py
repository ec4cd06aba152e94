"""Streaming matmul of the port (plain version, on the CPU) against the
reference's Pallas kernel in interpret mode and its jnp oracle, and the
model side's ``weight_matmul`` / ``gather_rows`` routes.

Tolerances are the reference's own (tests/test_kernels.py): fp32 1e-5 — the
two sides sum in different orders —, bf16 2e-2 — one bf16 rounding of the
output. The kernel itself runs only on the card: tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import rel_err, to_jax, to_np, to_torch
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import stream_matmul as port_sm
from repro_torch.models import layers as port_layers
from repro_torch.models.common import weight_matmul


def _xw(M, K, N, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


@pytest.mark.parametrize("M,K,N,bk", [(128, 512, 128, 256), (256, 1024, 384, 512)])
def test_stream_matmul_matches_reference_kernel(M, K, N, bk):
    """The shapes of tests/test_kernels.py::test_stream_matmul_matches_ref."""
    x, w = _xw(M, K, N)
    want = ref_ops.stream_matmul(to_jax(x), to_jax(w), block_k=bk)
    for got in (port_sm.stream_matmul_plain(to_torch(x), to_torch(w)),
                port_ops.stream_matmul(to_torch(x), to_torch(w), block_k=bk)):
        assert got.dtype == torch.float32 and got.shape == (M, N)
        assert rel_err(to_np(got), to_np(want)) < 1e-5


@pytest.mark.parametrize("M,K,N", [(5, 4096 // 8, 1000 // 8), (4, 300, 7),
                                   (1, 1, 1), (33, 77, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_matmul_any_shape_matches_oracle(M, K, N, dtype):
    """The reference asserts M, N, K divide its blocks (a TPU tiling
    artefact); the port takes any shape. Checked against the reference's
    ``matmul_ref`` on the same inputs."""
    x, w = _xw(M, K, N, seed=M + K + N)
    tdt = getattr(torch, dtype)
    got = port_ops.stream_matmul(to_torch(x, tdt), to_torch(w, tdt))
    want = ref_ref.matmul_ref(to_jax(x, jnp.dtype(dtype)), to_jax(w, jnp.dtype(dtype)))
    assert got.dtype == tdt
    assert rel_err(to_np(got), to_np(want)) < (1e-5 if dtype == "float32" else 2e-2)


def test_w_of_another_dtype_is_cast_like_the_reference():
    x, w = _xw(6, 40, 9)
    got = port_ops.stream_matmul(to_torch(x, torch.bfloat16), to_torch(w))
    want = ref_ref.matmul_ref(to_jax(x, jnp.bfloat16), to_jax(w))
    assert got.dtype == torch.bfloat16
    assert rel_err(to_np(got), to_np(want)) < 2e-2


def test_cpu_tensors_take_plain_version_and_count_nothing():
    x, w = (to_torch(a) for a in _xw(8, 64, 16))
    launches, streamed = port_sm.stream_matmul.launches, port_sm.stream_matmul.h2d_bytes
    assert torch.equal(port_sm.stream_matmul(x, w), port_sm.stream_matmul_plain(x, w))
    assert port_sm.stream_matmul.launches == launches
    assert port_sm.stream_matmul.h2d_bytes == streamed


@pytest.mark.parametrize("case", ["rank", "inner", "dtype", "strides"])
def test_wrapper_rejects_bad_input(case):
    x, w = torch.zeros(4, 8), torch.zeros(8, 3)
    if case == "rank":
        with pytest.raises(ValueError):
            port_sm.stream_matmul(x[None], w)
    elif case == "inner":
        with pytest.raises(ValueError):
            port_sm.stream_matmul(x, torch.zeros(9, 3))
    elif case == "dtype":
        with pytest.raises(TypeError):
            port_sm.stream_matmul(x.half(), w)
    else:
        with pytest.raises(ValueError, match="unit stride"):
            port_sm._w_layout(torch.zeros(16, 12)[::2, ::2])


def test_weight_layouts_read_from_strides():
    """(K, N) rows, a row of a stacked tensor, and the transposed view of an
    (N, K) table (the tied unembedding) — the layouts the kernel streams."""
    table = torch.zeros(50, 8)
    stacked = torch.zeros(3, 8, 20)
    assert port_sm._w_layout(torch.zeros(8, 20)) == (0, 20)
    assert port_sm._w_layout(stacked[1]) == (0, 20)
    assert port_sm._w_layout(table.T) == (1, 8)
    assert port_sm._w_layout(table[:, :5].T) == (1, 8)


def test_weight_matmul_on_one_device_is_the_plain_product():
    rng = np.random.default_rng(0)
    x = to_torch(rng.standard_normal((2, 3, 16)).astype(np.float32), torch.bfloat16)
    w = to_torch(rng.standard_normal((16, 5)).astype(np.float32))
    assert torch.equal(weight_matmul(x, w), x @ w.to(x.dtype))
    table = to_torch(rng.standard_normal((7, 16)).astype(np.float32))
    tokens = torch.tensor([[3, 0, 6]])
    before = port_layers.gather_rows.h2d_bytes
    assert torch.equal(port_layers.gather_rows(table, tokens), table[tokens])
    assert port_layers.gather_rows.h2d_bytes == before
