"""V-trace of the PyTorch port held against the JAX package.

The port's plain version (`vtrace_reference`) must agree with the JAX
`vtrace_scan` and with the Pallas kernel `vtrace_pallas` (interpret mode
on the CPU, as tests/test_pallas_vtrace.py runs it) at atol = rtol = 1e-5:
f32 throughout, the same operation order. The CUDA kernel is held
against `vtrace_reference` on the card in tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torched_impala_tpu.ops import vtrace as jax_vtrace
from torched_impala_tpu.ops import vtrace_pallas as jax_vtrace_pallas
from torched_impala_tpu_torch.ops import vtrace as port_vtrace

SHAPES = [(1, 1), (5, 7), (20, 32), (20, 130)]
THRESHOLDS = {
    "default": dict(),
    "none": dict(
        clip_rho_threshold=None,
        clip_c_threshold=None,
        clip_pg_rho_threshold=None,
    ),
    "half_two": dict(
        clip_rho_threshold=0.5,
        clip_c_threshold=2.0,
        clip_pg_rho_threshold=2.0,
    ),
}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(T, B, seed):
    rng = np.random.default_rng(seed)
    return dict(
        log_rhos=(rng.normal(size=(T, B)) * 0.5).astype(np.float32),
        discounts=(0.99 * (rng.uniform(size=(T, B)) > 0.15)).astype(np.float32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        values=rng.normal(size=(T, B)).astype(np.float32),
        bootstrap_value=rng.normal(size=(B,)).astype(np.float32),
    )


def _assert_out(port_out, jax_out):
    for field in ("vs", "pg_advantages", "errors"):
        np.testing.assert_allclose(
            getattr(port_out, field).cpu().numpy(),
            np.asarray(getattr(jax_out, field)),
            err_msg=field,
            **TOL,
        )


@pytest.mark.parametrize("lambda_", [1.0, 0.9])
@pytest.mark.parametrize("clips", sorted(THRESHOLDS))
@pytest.mark.parametrize("T,B", SHAPES)
def test_reference_matches_jax_scan_and_pallas(T, B, clips, lambda_):
    arrays = _inputs(T, B, seed=T * 1000 + B)
    kwargs = dict(THRESHOLDS[clips], lambda_=lambda_)
    port = port_vtrace.vtrace_reference(
        **{k: torch.from_numpy(v) for k, v in arrays.items()}, **kwargs
    )
    jarrays = {k: jnp.asarray(v) for k, v in arrays.items()}
    _assert_out(port, jax_vtrace.vtrace_scan(**jarrays, **kwargs))
    _assert_out(
        port,
        jax_vtrace_pallas.vtrace_pallas(**jarrays, **kwargs, interpret=True),
    )


def test_dispatch_takes_reference_on_cpu():
    arrays = {k: torch.from_numpy(v) for k, v in _inputs(4, 3, seed=0).items()}
    out = port_vtrace.vtrace(**arrays)
    ref = port_vtrace.vtrace_reference(**arrays)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    from torched_impala_tpu_torch.ops import vtrace_cuda

    arrays = {k: torch.from_numpy(v) for k, v in _inputs(4, 3, seed=1).items()}
    with pytest.raises(ValueError, match="CUDA tensor"):
        vtrace_cuda.vtrace_cuda(**arrays)
