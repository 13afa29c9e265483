"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA card: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

Tolerances, each kernel against its plain version on the same card:

- V-trace: 1e-5 absolute and relative. The kernel and the plain version
  run the same f32 formulas in the same order, and the kernel rounds
  every multiply and add as the plain version does (no fused
  multiply-adds); only `expf` may differ from `exp` in the last place.
- LSTM cell: 5e-5 absolute. The gate pre-activations are f32 sums of
  F + H (up to 512) products taken in another order than the plain
  matmul's; the activations and the carry update round alike.
- Residual block: f32 1e-5 absolute and relative (9 C-term sums in
  another order); bf16 at most one bf16 rounding of the output apart
  (rtol = atol = 2^-7) with 99% of the elements bit-equal, since both
  round the intermediate and the output to bf16 from f32 sums.
- Gradients through the kernels' `autograd.Function`s: the backward is
  the same plain closed form, fed the kernel's forward; rtol 1e-4 and
  atol 1e-5 (LSTM) or 1e-5 times the gradient's largest magnitude
  (residual block, whose loss feeds the forward's rounding into sums
  over N*H*W positions).

The CPU cases at the end run everywhere: a wrapper refuses a CPU tensor
before it builds anything, and the dispatchers take the plain version
for CPU tensors.
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


LSTM_SHAPES = [(32, 256, 256), (8, 256, 256), (1, 7, 7), (33, 100, 130)]
BLOCK_SHAPES = [(672, 42, 42, 16), (672, 21, 21, 32), (672, 11, 11, 32), (8, 42, 42, 16)]
BF16_ULP = 2.0**-7


def _lstm_inputs(B, F, H, seed, device):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.normal(size=(B, F)),
        rng.normal(size=(B, H)),
        rng.normal(size=(B, H)),
        rng.normal(size=(F, 4 * H)) / np.sqrt(F),
        rng.normal(size=(H, 4 * H)) / np.sqrt(H),
        rng.normal(size=(4 * H,)) * 0.1,
    ]
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def _block_inputs(N, H, W, C, dtype, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    params = [
        rng.normal(size=(3, 3, C, C)) / np.sqrt(9 * C),
        rng.normal(size=(C,)) * 0.1,
        rng.normal(size=(3, 3, C, C)) / np.sqrt(9 * C),
        rng.normal(size=(C,)) * 0.1,
    ]
    return [x.to(device=device, dtype=dtype)] + [
        torch.from_numpy(a.astype(np.float32)).to(device) for a in params
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("B,F,H", LSTM_SHAPES)
def test_lstm_kernel_matches_reference(cuda, B, F, H):
    from torched_impala_tpu_torch.ops import lstm, lstm_cuda

    args = _lstm_inputs(B, F, H, seed=B + H, device=cuda)
    before = lstm_cuda.LAUNCHES
    out = lstm_cuda.lstm_cell_cuda(*args)
    assert lstm_cuda.LAUNCHES == before + 1
    ref = lstm.lstm_reference(*args)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-5)


@pytest.mark.gpu
def test_lstm_grads_through_kernel_forward(cuda):
    from torched_impala_tpu_torch.ops import lstm, lstm_cuda

    args = [t.requires_grad_() for t in _lstm_inputs(32, 256, 256, seed=1, device=cuda)]
    before = lstm_cuda.LAUNCHES
    c, h = lstm.lstm_cell_fused(*args)
    assert lstm_cuda.LAUNCHES == before + 1
    g_kernel = torch.autograd.grad((c * 0.5 + h).sum(), args)
    c, h, _ = lstm.lstm_reference(*args)
    g_plain = torch.autograd.grad((c * 0.5 + h).sum(), args)
    for a, b in zip(g_kernel, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=str)
def test_resblock_kernel_matches_reference_bf16(cuda, shape):
    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda

    args = _block_inputs(*shape, torch.bfloat16, seed=shape[1], device=cuda)
    before = conv_block_cuda.LAUNCHES
    out = conv_block_cuda.resblock_cuda(*args)
    assert conv_block_cuda.LAUNCHES == before + 1
    ref = conv_block.block_reference(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_ULP, atol=BF16_ULP)
    assert float((out == ref).float().mean()) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 13, 7, 24), (2, 42, 42, 16), (1, 1, 1, 1)], ids=str)
def test_resblock_kernel_matches_reference_f32(cuda, shape):
    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda

    args = _block_inputs(*shape, torch.float32, seed=3, device=cuda)
    out = conv_block_cuda.resblock_cuda(*args)
    ref = conv_block.block_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_resblock_grads_through_kernel_forward(cuda):
    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda

    args = [t.requires_grad_() for t in _block_inputs(4, 11, 11, 32, torch.float32, 5, cuda)]
    before = conv_block_cuda.LAUNCHES
    out = conv_block.fused_residual_block(*args)
    assert conv_block_cuda.LAUNCHES == before + 1
    g_kernel = torch.autograd.grad(out.square().sum(), args)
    g_plain = torch.autograd.grad(conv_block.block_reference(*args).square().sum(), args)
    # dout = 2 * out carries the forward's f32 rounding into each kernel
    # gradient, a sum over N*H*W positions: atol scales with its magnitude.
    for a, b in zip(g_kernel, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


@pytest.mark.gpu
def test_new_wrappers_refuse_bad_inputs_on_cuda(cuda):
    from torched_impala_tpu_torch.ops import conv_block_cuda, lstm_cuda

    args = _lstm_inputs(4, 6, 5, seed=0, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        lstm_cuda.lstm_cell_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        lstm_cuda.lstm_cell_cuda(*args[:5], args[5][:7])
    with pytest.raises(ValueError, match="contiguous"):
        wi = args[3].t().contiguous().t()
        lstm_cuda.lstm_cell_cuda(*args[:3], wi, *args[4:])
    x, *params = _block_inputs(2, 5, 5, 4, torch.float16, 0, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv_block_cuda.resblock_cuda(x, *params)
    with pytest.raises(ValueError, match="contiguous"):
        conv_block_cuda.resblock_cuda(x.float().permute(0, 2, 1, 3), *params)
    with pytest.raises(ValueError, match="float32"):
        conv_block_cuda.resblock_cuda(x.float(), params[0].bfloat16(), *params[1:])


def test_wrappers_refuse_cpu_tensors():
    """No fallback in a wrapper: a CPU tensor raises before any build."""
    from torched_impala_tpu_torch.ops import conv_block_cuda, lstm_cuda, vtrace_cuda

    with pytest.raises(ValueError, match="CUDA tensor"):
        lstm_cuda.lstm_cell_cuda(*_lstm_inputs(2, 3, 4, seed=0, device="cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv_block_cuda.resblock_cuda(*_block_inputs(1, 4, 4, 2, torch.float32, 0, "cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        vtrace_cuda.vtrace_cuda(**_inputs(3, 2, seed=0, device="cpu"))


def test_dispatch_takes_plain_version_on_cpu():
    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda, lstm, lstm_cuda

    before = (lstm_cuda.LAUNCHES, conv_block_cuda.LAUNCHES)
    args = _lstm_inputs(2, 3, 4, seed=0, device="cpu")
    torch.testing.assert_close(
        lstm.lstm_cell_fused(*args), lstm.lstm_reference(*args)[:2], rtol=0, atol=0
    )
    args = _block_inputs(1, 4, 4, 2, torch.float32, 0, "cpu")
    torch.testing.assert_close(
        conv_block.fused_residual_block(*args), conv_block.block_reference(*args), rtol=0, atol=0
    )
    assert (lstm_cuda.LAUNCHES, conv_block_cuda.LAUNCHES) == before
