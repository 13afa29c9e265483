"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA card: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

Tolerance: 1e-5 absolute and relative. The kernel and the plain version
run the same f32 formulas in the same order, and the kernel rounds every
multiply and add as the plain version does (no fused multiply-adds);
only `expf` may differ from the CPU's `exp` in the last place.
"""

import numpy as np
import pytest
import torch

from torched_impala_tpu_torch.ops import vtrace as port_vtrace

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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from torched_impala_tpu_torch import resolve_device

    return resolve_device()


def _inputs(T, B, seed, device):
    rng = np.random.default_rng(seed)
    arrays = dict(
        log_rhos=rng.normal(size=(T, B)) * 0.5,
        discounts=0.99 * (rng.uniform(size=(T, B)) > 0.15),
        rewards=rng.normal(size=(T, B)),
        values=rng.normal(size=(T, B)),
        bootstrap_value=rng.normal(size=(B,)),
    )
    return {
        k: torch.from_numpy(v.astype(np.float32)).to(device)
        for k, v in arrays.items()
    }


@pytest.mark.gpu
@pytest.mark.parametrize("clips", sorted(THRESHOLDS))
@pytest.mark.parametrize(
    "T,B", [(1, 1), (5, 7), (20, 32), (20, 130), (100, 32), (20, 256)]
)
def test_vtrace_kernel_matches_reference(cuda, T, B, clips):
    from torched_impala_tpu_torch.ops import vtrace_cuda

    x = _inputs(T, B, seed=T * 1000 + B, device=cuda)
    for lambda_ in (1.0, 0.9):
        kwargs = dict(THRESHOLDS[clips], lambda_=lambda_)
        before = vtrace_cuda.LAUNCHES
        out = vtrace_cuda.vtrace_cuda(**x, **kwargs)
        assert vtrace_cuda.LAUNCHES == before + 1
        ref = port_vtrace.vtrace_reference(**x, **kwargs)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("clips", sorted(THRESHOLDS))
def test_vtrace_kernel_passes_nan_through(cuda, clips):
    """A NaN log-ratio gives NaN where the plain version gives NaN: the
    clips pass NaN through as torch.clamp does."""
    from torched_impala_tpu_torch.ops import vtrace_cuda

    x = _inputs(20, 32, seed=5, device=cuda)
    x["log_rhos"][7, 3] = float("nan")
    out = vtrace_cuda.vtrace_cuda(**x, **THRESHOLDS[clips])
    ref = port_vtrace.vtrace_reference(**x, **THRESHOLDS[clips])
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert b.isnan().any()
        assert torch.equal(a.isnan(), b.isnan())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.gpu
def test_vtrace_dispatch_takes_kernel_on_cuda(cuda):
    from torched_impala_tpu_torch.ops import vtrace_cuda

    x = _inputs(20, 32, seed=0, device=cuda)
    before = vtrace_cuda.LAUNCHES
    port_vtrace.vtrace(**x)
    assert vtrace_cuda.LAUNCHES == before + 1


@pytest.mark.gpu
def test_vtrace_wrapper_refuses_bad_inputs(cuda):
    from torched_impala_tpu_torch.ops import vtrace_cuda

    x = _inputs(6, 4, seed=1, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        vtrace_cuda.vtrace_cuda(**{**x, "rewards": x["rewards"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        vtrace_cuda.vtrace_cuda(
            **{**x, "values": x["values"].t().contiguous().t()}
        )
    with pytest.raises(ValueError, match="shape"):
        vtrace_cuda.vtrace_cuda(**{**x, "bootstrap_value": x["values"][0, :3]})
