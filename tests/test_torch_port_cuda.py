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
  F + H (512 at the presets' shapes, 768 at the widest case here)
  products taken in another order than the plain matmul's; the
  activations and the carry update round alike. Two launches on the same
  inputs are bit-identical (a fixed reduction order, no atomics).
- Residual block: f32 1e-5 absolute and relative (9 C-term sums in
  another order); bf16 at most one bf16 rounding of the output apart
  (rtol = atol = 2^-7) with 99% of the elements bit-equal, since both
  round the intermediate and the output to bf16 from f32 sums (the bf16
  kernel's are tensor-core sums, the plain version's cuDNN's).
- Gradients through the kernels' `autograd.Function`s: the backward is
  the same plain closed form, fed the kernel's forward; rtol 1e-4 and
  atol 1e-5 (LSTM) or 1e-5 times the gradient's largest magnitude
  (residual block, whose loss feeds the forward's rounding into sums
  over N*H*W positions).
- Fused loss: the forward's vs and advantages 1e-5 absolute and
  relative (its log-softmax takes torch's lane layout and order, so the
  log-ratios are the plain version's; then the V-trace kernel's
  rounding), lse and entropy 1e-5 absolute (sums of A terms in another
  order); its five sums rtol 1e-5 (f32 sums in another
  order); the backward's gradients rtol 1e-5 and atol 1e-6 times the
  largest (the same formula, exp and the forward's lse apart by an ulp);
  two launches of each bit-identical; the loss's total and gradients
  through both kernels rtol 1e-5.
- Attention: forward 2e-5 absolute in f32 (online softmax against the
  plain softmax, sums of dh and S terms in another order); dq, dk and dv
  rtol 1e-4 and atol 1e-5 times the largest of the three gradients; bf16
  within one bf16 rounding (rtol = atol = 2^-7, atol scaled likewise for
  the gradients), since both round the probabilities and dS to bf16
  from f32 values that differ in the last place.

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
    "T,B", [(1, 1), (5, 7), (20, 16), (20, 32), (20, 130), (100, 32), (20, 256)]
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
@pytest.mark.parametrize("T,B", [(32, 32), (33, 33), (65, 5), (1000, 32)])
def test_vtrace_kernel_across_chunks_matches_reference(cuda, T, B, clips):
    """The staged kernel carries acc, V and vs across chunks of 32 steps
    and tiles of 32 columns (a chunk exactly full, one step over, a ragged
    last chunk, a long unroll): the same 1e-5 gate."""
    from torched_impala_tpu_torch.ops import vtrace_cuda

    x = _inputs(T, B, seed=T + B, device=cuda)
    for lambda_ in (1.0, 0.9):
        kwargs = dict(THRESHOLDS[clips], lambda_=lambda_)
        out = vtrace_cuda.vtrace_cuda(**x, **kwargs)
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


# The learner's, the actors' and a Breakout microbatch's (B = 32 / 2), then
# ragged ones.
LSTM_SHAPES = [(32, 256, 256), (8, 256, 256), (16, 256, 256), (1, 7, 7), (33, 100, 130)]
# One unit and one row; F far below H, H ragged past one 256-row stage;
# two row tiles with K = 768 over four stages.
LSTM_EDGE_SHAPES = [(1, 1, 1), (2, 3, 300), (64, 512, 256)]
# The learner's three Breakout block shapes, a microbatch's (G = 2), an
# actor's.
BLOCK_SHAPES = [(672, 42, 42, 16), (672, 21, 21, 32), (672, 11, 11, 32),
                (336, 42, 42, 16), (336, 21, 21, 32), (336, 11, 11, 32), (8, 42, 42, 16)]
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
@pytest.mark.parametrize("B,F,H", LSTM_SHAPES + LSTM_EDGE_SHAPES)
def test_lstm_kernel_matches_reference(cuda, B, F, H):
    """Within 5e-5 of the plain version, and a second launch on the same
    inputs is bit-identical to the first."""
    from torched_impala_tpu_torch.ops import lstm, lstm_cuda

    args = _lstm_inputs(B, F, H, seed=B + H, device=cuda)
    before = lstm_cuda.LAUNCHES
    out = lstm_cuda.lstm_cell_cuda(*args)
    again = lstm_cuda.lstm_cell_cuda(*args)
    assert lstm_cuda.LAUNCHES == before + 2
    ref = lstm.lstm_reference(*args)
    torch.cuda.synchronize()
    for a, b, r in zip(out, again, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=5e-5)
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [32, 8])
def test_lstm_kernel_grid_fills_the_card(cuda, B):
    """At H = 256 the grid has 128 blocks at the learner's B = 32 and at
    the actors' B = 8 alike (read from the profiler's trace)."""
    from torched_impala_tpu_torch.ops import lstm_cuda, profiling

    args = _lstm_inputs(B, 256, 256, seed=0, device=cuda)
    lstm_cuda.lstm_cell_cuda(*args)
    torch.cuda.synchronize()
    grids = profiling.launched_grids(lambda: lstm_cuda.lstm_cell_cuda(*args), "lstm_cell_kernel")
    assert len(grids) == 1 and grids[0][0] * grids[0][1] * grids[0][2] >= 128, grids


@pytest.mark.gpu
def test_lstm_concurrent_learner_and_actor_launches(cuda):
    """The learner (B = 32) and an actor (B = 8) launch the kernel at once,
    50 times each from two threads: no launch is refused, and every output
    is its plain version's and the same each time."""
    import threading

    from torched_impala_tpu_torch.ops import lstm, lstm_cuda

    cases = [_lstm_inputs(32, 256, 256, seed=1, device=cuda),
             _lstm_inputs(8, 256, 256, seed=2, device=cuda)]
    refs = [lstm.lstm_reference(*args) for args in cases]
    torch.cuda.synchronize()
    outs, errors = [[], []], []
    start = threading.Barrier(len(cases))

    def launch(i):
        try:
            start.wait()
            for _ in range(50):
                outs[i].append(lstm_cuda.lstm_cell_cuda(*cases[i]))
            torch.cuda.synchronize()
        except Exception as e:  # raised again below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for ref, runs in zip(refs, outs):
        assert len(runs) == 50
        for a, b in zip(runs[0], ref):
            torch.testing.assert_close(a, b, rtol=0, atol=5e-5)
        for out in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(out, runs[0]))


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


# Edges of the bf16 kernel's tiling: one image, one row, one column, a
# 13-wide band, and channel counts it zero-pads (24 -> 32, 1 -> 16) or
# splits into several wgmma tiles (48: three n16, 64: two n32), and those
# whose two kernels do not fit in shared memory together (72 and 65 pad to
# 80: each conv's kernel is staged before that conv).
BLOCK_BF16_EDGES = [
    (1, 13, 13, 16), (2, 1, 13, 32), (3, 13, 1, 24), (3, 13, 7, 24),
    (2, 13, 21, 1), (1, 1, 1, 1), (2, 9, 9, 48), (2, 9, 9, 64),
    (2, 9, 9, 72), (3, 7, 42, 65),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BLOCK_BF16_EDGES, ids=str)
def test_resblock_bf16_kernel_edges_match_reference(cuda, shape):
    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda

    args = _block_inputs(*shape, torch.bfloat16, seed=sum(shape), device=cuda)
    before = conv_block_cuda.LAUNCHES
    out = conv_block_cuda.resblock_cuda(*args)
    assert conv_block_cuda.LAUNCHES == before + 1
    ref = conv_block.block_reference(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_ULP, atol=BF16_ULP)
    assert float((out == ref).float().mean()) >= 0.99


@pytest.mark.gpu
def test_resblock_bf16_non_finite_x_stays_where_the_plain_version_puts_it(cuda):
    """An inf or a NaN in x spreads as in the plain version, and no
    further: the kernel's zero-padded channels (C = 24 -> 32) must not
    turn inf x 0 into a NaN that reaches every output channel."""
    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda

    x, *params = _block_inputs(2, 9, 9, 24, torch.bfloat16, seed=0, device=cuda)
    x[0, 3, 3, 5] = float("nan")
    x[1, 2, 2, 1] = float("inf")
    out = conv_block_cuda.resblock_cuda(x, *params)
    ref = conv_block.block_reference(x, *params)
    torch.cuda.synchronize()
    assert torch.equal(out.isnan(), ref.isnan()) and torch.equal(out.isinf(), ref.isinf())
    finite = ref.isfinite()
    assert 0 < int(finite.sum()) < ref.numel()
    torch.testing.assert_close(
        out[finite].float(), ref[finite].float(), rtol=BF16_ULP, atol=BF16_ULP
    )


@pytest.mark.gpu
def test_resblock_bf16_concurrent_learner_and_actor_launches(cuda):
    """The learner and an actor launch the kernel at different shapes at
    once, each needing more than 48 KB of shared memory: no launch is
    refused, and every output is its plain version's (and the same each
    time)."""
    import threading

    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda

    cases = [
        _block_inputs(672, 21, 21, 32, torch.bfloat16, 1, cuda),
        _block_inputs(8, 21, 21, 32, torch.bfloat16, 2, cuda),
    ]
    refs = [conv_block.block_reference(*args) for args in cases]
    torch.cuda.synchronize()
    outs, errors = [[], []], []
    start = threading.Barrier(len(cases))

    def launch(i):
        try:
            start.wait()
            for _ in range(50):
                outs[i].append(conv_block_cuda.resblock_cuda(*cases[i]))
            torch.cuda.synchronize()
        except Exception as e:  # raised again below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for ref, runs in zip(refs, outs):
        assert len(runs) == 50
        torch.testing.assert_close(runs[0].float(), ref.float(), rtol=BF16_ULP, atol=BF16_ULP)
        assert float((runs[0] == ref).float().mean()) >= 0.99
        for out in runs[1:]:
            assert torch.equal(out, runs[0])


@pytest.mark.gpu
def test_resblock_bf16_refuses_what_it_does_not_take(cuda, monkeypatch):
    """No fallback for bf16: a launch the launcher refuses (a band whose
    shared memory is over the ceiling) raises without counting a launch."""
    import dataclasses

    from torched_impala_tpu_torch.ops import conv_block_cuda

    args = _block_inputs(2, 9, 9, 16, torch.bfloat16, 0, cuda)
    plan = conv_block_cuda.bf16_launch_plan(2, 9, 9, 16)
    monkeypatch.setattr(
        conv_block_cuda,
        "bf16_launch_plan",
        lambda *shape: dataclasses.replace(plan, rows=10_000),
    )
    before = conv_block_cuda.LAUNCHES
    with pytest.raises(RuntimeError, match="cudaError"):
        conv_block_cuda.resblock_cuda(*args)
    assert conv_block_cuda.LAUNCHES == before


# Shapes past the tuned kernels' shared memory, which take the general
# kernel: bf16 channels above 80, and f32 where two staged kernels and a
# one-row band pass 227 KB (C = 48 from W = 42; C = 64 at any W).
BLOCK_GENERAL_SHAPES = [
    ((2, 9, 9, 96), torch.bfloat16), ((2, 7, 11, 128), torch.bfloat16),
    ((2, 5, 42, 48), torch.float32), ((2, 21, 21, 64), torch.float32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", BLOCK_GENERAL_SHAPES, ids=str)
def test_resblock_general_kernel_matches_reference(cuda, shape, dtype):
    """The general kernel against `block_reference`, at the tolerances of
    the tuned kernels of the same dtype; one general launch a call, none
    of the tuned kernels', and two launches bit-identical."""
    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda

    assert conv_block_cuda.route(dtype, shape[2], shape[3]) == "general"
    args = _block_inputs(*shape, dtype, seed=shape[3], device=cuda)
    before = (conv_block_cuda.LAUNCHES, conv_block_cuda.GENERAL_LAUNCHES)
    out = conv_block_cuda.resblock_cuda(*args)
    assert (conv_block_cuda.LAUNCHES, conv_block_cuda.GENERAL_LAUNCHES) == (before[0], before[1] + 1)
    again = conv_block_cuda.resblock_cuda(*args)
    ref = conv_block.block_reference(*args)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == shape and torch.equal(out, again)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_ULP, atol=BF16_ULP)
        assert float((out == ref).float().mean()) >= 0.99
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_resblock_bf16_kernel_runs_on_tensor_cores(cuda):
    """Every instantiation of the bf16 kernel holds wgmma instructions
    (HGMMA in its machine code); the f32 kernel holds none."""
    from torched_impala_tpu_torch.ops import _build

    counts = _build.sass_counts("resblock", "HGMMA")
    bf16 = {f: n for f, n in counts.items() if "resblock_bf16_wgmma_kernel" in f}
    f32 = {f: n for f, n in counts.items() if "resblock_f32_kernel" in f}
    assert len(bf16) == 5 and min(bf16.values()) > 0, counts
    assert len(f32) == 1 and sum(f32.values()) == 0, counts


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


FUSED_SHAPES = [(20, 32, 6), (100, 32, 15), (1, 1, 2), (7, 130, 4)]
# The kernels' own tests add 18 and 100 actions, and a batch that the
# forward splits over 16 clusters (B = 70 and 130 take 2 and 3).
FUSED_KERNEL_SHAPES = FUSED_SHAPES + [(20, 32, 18), (3, 70, 100), (20, 1024, 18)]
ATTN_SHAPES = [(32, 21, 4, 64, 128), (2, 300, 4, 64, 128), (3, 1, 2, 16, 0), (5, 40, 3, 32, 19)]


def _loss_inputs(T, B, A, seed, device):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return dict(
        target_logits=t(rng.normal(size=(T, B, A))),
        values=t(rng.normal(size=(T, B))),
        behaviour_logits=t(rng.normal(size=(T, B, A))),
        bootstrap_value=t(rng.normal(size=(B,))),
        actions=torch.from_numpy(rng.integers(0, A, size=(T, B))).to(device),
        rewards=t(rng.normal(size=(T, B))),
        discounts=t(0.99 * (rng.uniform(size=(T, B)) > 0.05)),
        mask=t(rng.uniform(size=(T, B)) > 0.2),
    )


def _fused_args(T, B, A, seed, device):
    """The fused loss forward's operands: target and behaviour logits,
    int64 actions, values, bootstrap, discounts, rewards and a mask with
    zeros."""
    x = _loss_inputs(T, B, A, seed, device)
    return tuple(x[k] for k in ("target_logits", "behaviour_logits", "actions", "values",
                                "bootstrap_value", "discounts", "rewards", "mask"))


def _fused_bwd_args(args, seed, kw=None):
    """The backward's operands after the plain forward of `args`: logits,
    lse, entropy, adv, vs, values, mask, actions and three cotangents."""
    from torched_impala_tpu_torch.ops import fused_loss

    z, _, actions, values, _, _, _, mask = args
    out = fused_loss.fused_core_reference(*args, **(kw or {}))
    rng = np.random.default_rng(seed)
    g = [torch.tensor(float(v), dtype=torch.float32, device=z.device) for v in rng.normal(size=3)]
    return (z, out.lse, out.ent, out.adv, out.vs, values, mask, actions, *g)


def _assert_bwd_close(got, ref):
    """dL/dz and dL/dvalues at rtol 1e-5, atol 1e-6 x the largest."""
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


def _attn_inputs(B, T, H, dh, W, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 4, size=(B, 1))
    seg_q = base + np.cumsum(rng.uniform(size=(B, T)) < 4.0 / max(T, 4), axis=1)
    cache = np.where(rng.uniform(size=(B, W)) < 0.6, base, rng.choice([-1, 0], size=(B, W)))

    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    S = W + T
    return (f(B, T, H, dh), f(B, S, H, dh), f(B, S, H, dh), i32(seg_q),
            i32(np.concatenate([cache, seg_q], axis=1)), W, f(B, T, H, dh))


@pytest.mark.gpu
@pytest.mark.parametrize("clips", sorted(THRESHOLDS))
@pytest.mark.parametrize("T,B,A", FUSED_KERNEL_SHAPES)
def test_fused_loss_kernel_matches_reference(cuda, T, B, A, clips):
    """The forward kernel against `fused_core_reference`: the five sums
    rtol 1e-5; vs and adv 1e-5 absolute and relative, as the first
    kernel's were; lse and the entropy 1e-5 absolute."""
    from torched_impala_tpu_torch.ops import fused_loss, fused_loss_cuda
    from torched_impala_tpu_torch.ops.vtrace import threshold

    args = _fused_args(T, B, A, seed=T + B, device=cuda)
    for lambda_ in (1.0, 0.9):
        kw = {k: threshold(THRESHOLDS[clips].get(f"{k}_threshold", 1.0))
              for k in ("clip_rho", "clip_c", "clip_pg_rho")}
        kw["lambda_"] = lambda_
        before = dict(fused_loss_cuda.LAUNCHES)
        out = fused_loss_cuda.fused_loss_fwd(*args, **kw)
        assert fused_loss_cuda.LAUNCHES == dict(before, fwd=before["fwd"] + 1)
        ref = fused_loss.fused_core_reference(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.sums, ref.sums, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out.vs, ref.vs, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(out.adv, ref.adv, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(out.lse, ref.lse, rtol=0.0, atol=1e-5)
        torch.testing.assert_close(out.ent, ref.ent, rtol=0.0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,A", FUSED_KERNEL_SHAPES)
def test_fused_loss_backward_kernel_matches_reference(cuda, T, B, A):
    """The backward kernel against `fused_core_backward_reference` on the
    plain forward's residuals, any cotangents: rtol 1e-5, atol 1e-6 x the
    largest."""
    from torched_impala_tpu_torch.ops import fused_loss, fused_loss_cuda

    bwd = _fused_bwd_args(_fused_args(T, B, A, seed=T * B, device=cuda), seed=A)
    before = dict(fused_loss_cuda.LAUNCHES)
    got = fused_loss_cuda.fused_loss_bwd(*bwd)
    assert fused_loss_cuda.LAUNCHES == dict(before, bwd=before["bwd"] + 1)
    ref = fused_loss.fused_core_backward_reference(*bwd)
    torch.cuda.synchronize()
    _assert_bwd_close(got, ref)


@pytest.mark.gpu
def test_fused_loss_kernels_pass_non_finite_rows_through(cuda):
    """A -inf target logit, a NaN behaviour logit and a NaN value give NaN
    where the plain versions give NaN, and the finite rest agrees."""
    from torched_impala_tpu_torch.ops import fused_loss, fused_loss_cuda

    args = list(_fused_args(20, 32, 6, seed=4, device=cuda))
    args[0][3, 5, 2] = float("-inf")
    args[1][7, 1, 0] = float("nan")
    args[3][11, 9] = float("nan")
    out = fused_loss_cuda.fused_loss_fwd(*args)
    ref = fused_loss.fused_core_reference(*args)
    bwd = _fused_bwd_args(args, seed=0)
    got_b = fused_loss_cuda.fused_loss_bwd(*bwd)
    ref_b = fused_loss.fused_core_backward_reference(*bwd)
    torch.cuda.synchronize()
    assert all(x.isnan().any() for x in (ref.sums, ref.vs, ref.adv, ref.ent, *ref_b))
    for a, b in zip((*out, *got_b), (*ref, *ref_b)):
        assert torch.equal(a.isnan(), b.isnan())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.gpu
def test_fused_loss_kernels_bit_identical_over_launches(cuda):
    """Two launches of each kernel on the same inputs give the same bits,
    with one cluster of the forward, two and sixteen (the sums in a fixed
    order)."""
    from torched_impala_tpu_torch.ops import fused_loss_cuda

    for shape in ((20, 32, 6), (100, 70, 15), (20, 1024, 18)):
        args = _fused_args(*shape, seed=1, device=cuda)
        runs = [fused_loss_cuda.fused_loss_fwd(*args) for _ in range(2)]
        bwd = _fused_bwd_args(args, seed=2)
        runs_b = [fused_loss_cuda.fused_loss_bwd(*bwd) for _ in range(2)]
        torch.cuda.synchronize()
        for first, second in (runs, runs_b):
            assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_fused_loss_concurrent_launches(cuda):
    """Two threads launch the forward and the backward at once, at the
    learner's shape and at a longer, wider one, 20 times each: no launch
    is refused, and every result is the first one's, bit for bit."""
    import threading

    from torched_impala_tpu_torch.ops import fused_loss_cuda

    cases = []
    for shape in ((20, 32, 6), (100, 70, 15)):
        args = _fused_args(*shape, seed=3, device=cuda)
        cases.append((args, _fused_bwd_args(args, seed=4)))
    outs, errors = [[], []], []
    start = threading.Barrier(len(cases))

    def launch(i):
        try:
            start.wait()
            fwd, bwd = cases[i]
            for _ in range(20):
                outs[i].append((*fused_loss_cuda.fused_loss_fwd(*fwd),
                                *fused_loss_cuda.fused_loss_bwd(*bwd)))
            torch.cuda.synchronize()
        except Exception as e:  # raised again below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for runs in outs:
        assert len(runs) == 20
        for run in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_fused_loss_through_kernel_matches_plain(cuda, reduction, monkeypatch):
    """The whole loss through the two kernels (one forward and one
    backward launch a call) against the loss through the plain versions:
    logs and gradients rtol 1e-5."""
    from torched_impala_tpu_torch.ops import fused_loss, fused_loss_cuda, losses

    x = _loss_inputs(20, 32, 6, seed=3, device=cuda)
    cfg = losses.ImpalaLossConfig(fused_epilogue=True, reduction=reduction)

    def loss_and_grads():
        leaves = {k: x[k].clone().requires_grad_() for k in ("target_logits", "values")}
        out = losses.impala_loss(**{**x, **leaves}, config=cfg)
        return out, torch.autograd.grad(out.total, list(leaves.values()))

    before = dict(fused_loss_cuda.LAUNCHES)
    out_k, g_k = loss_and_grads()
    assert fused_loss_cuda.LAUNCHES == {k: v + 1 for k, v in before.items()}
    monkeypatch.setattr(fused_loss, "fused_core", fused_loss.fused_core_reference)
    monkeypatch.setattr(fused_loss, "fused_core_backward", fused_loss.fused_core_backward_reference)
    out_p, g_p = loss_and_grads()
    for key in out_p.logs:
        torch.testing.assert_close(out_k.logs[key], out_p.logs[key], rtol=1e-5, atol=1e-6)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _attention_vs_plain(args, bf16):
    from torched_impala_tpu_torch.ops import attention, attention_cuda

    q, k, v, seg_q, seg_ctx, W, g = args
    out, lse = attention_cuda.attention_forward_cuda(q, k, v, seg_q, seg_ctx, W)
    ref_out, ref_lse = attention.windowed_attention_reference(q, k, v, seg_q, seg_ctx, W)
    bwd = (q, k, v, g, ref_out, ref_lse, seg_q, seg_ctx, W)
    grads = attention_cuda.attention_backward_cuda(*bwd)
    refs = attention.windowed_attention_backward_reference(*bwd)
    torch.cuda.synchronize()
    ulp = 2.0**-7
    fwd_tol = dict(rtol=ulp, atol=ulp) if bf16 else dict(rtol=0.0, atol=2e-5)
    torch.testing.assert_close(out, ref_out, **fwd_tol)
    torch.testing.assert_close(lse, ref_lse, **fwd_tol)
    scale = max(float(r.abs().max()) for r in refs)
    for a, b in zip(grads, refs):
        tol = dict(rtol=ulp, atol=ulp * scale) if bf16 else dict(rtol=1e-4, atol=1e-5 * scale)
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_attention_kernels_match_reference(cuda, shape):
    from torched_impala_tpu_torch.ops import attention_cuda

    before = dict(attention_cuda.LAUNCHES)
    _attention_vs_plain(_attn_inputs(*shape, seed=sum(shape), device=cuda), bf16=False)
    assert {k: v - before[k] for k, v in attention_cuda.LAUNCHES.items()} == {"fwd": 1, "bwd": 1}


@pytest.mark.gpu
def test_attention_kernels_match_reference_bf16(cuda):
    _attention_vs_plain(
        _attn_inputs(*ATTN_SHAPES[0], seed=1, device=cuda, dtype=torch.bfloat16), bf16=True
    )


# Head widths the kernels run zero-padded (to 16, 32, 128) and the two
# widest instantiations (128, 256), at a shape with several row blocks,
# context tiles and query tiles.
ATTN_PADDED_DH = [8, 24, 96, 128, 256]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh", ATTN_PADDED_DH)
def test_attention_kernels_match_reference_at_any_head_width(cuda, dh, dtype):
    """The outputs match the plain versions' (assert_close also holds them
    to the plain versions' true-dh shapes)."""
    from torched_impala_tpu_torch.ops import attention_cuda

    before = dict(attention_cuda.LAUNCHES)
    args = _attn_inputs(2, 40, 2, dh, 19, seed=dh, device=cuda, dtype=dtype)
    _attention_vs_plain(args, bf16=dtype == torch.bfloat16)
    assert {k: v - before[k] for k, v in attention_cuda.LAUNCHES.items()} == {"fwd": 1, "bwd": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh", [257, 320, 512])
def test_attention_wide_kernels_match_reference(cuda, dh, dtype):
    """Head widths past MAX_HEAD_DIM run on the general kernels of
    csrc/attention_wide.cu, at the tiled kernels' tolerances, on episodic
    data with a partly foreign cache; one wide launch each way, none of
    the tiled kernels', and two launches bit-identical."""
    from torched_impala_tpu_torch.ops import attention, attention_cuda

    before = (dict(attention_cuda.LAUNCHES), dict(attention_cuda.WIDE_LAUNCHES))
    args = _attn_inputs(2, 21, 2, dh, 19, seed=dh, device=cuda, dtype=dtype)
    _attention_vs_plain(args, bf16=dtype == torch.bfloat16)
    assert attention_cuda.LAUNCHES == before[0]
    assert {k: v - before[1][k] for k, v in attention_cuda.WIDE_LAUNCHES.items()} == {"fwd": 1, "bwd": 1}
    q, k, v, seg_q, seg_ctx, W, g = args
    out, lse = attention.windowed_attention_reference(q, k, v, seg_q, seg_ctx, W)
    bwd = (q, k, v, g, out, lse, seg_q, seg_ctx, W)
    for fn, fn_args in ((attention_cuda.attention_forward_cuda, args[:6]),
                        (attention_cuda.attention_backward_cuda, bwd)):
        first, again = fn(*fn_args), fn(*fn_args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_attention_autograd_through_kernels(cuda):
    from torched_impala_tpu_torch.ops import attention, attention_cuda

    q, k, v, seg_q, seg_ctx, W, g = _attn_inputs(*ATTN_SHAPES[0], seed=2, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(attention_cuda.LAUNCHES)
    out = attention.windowed_attention(*leaves, seg_q, seg_ctx, W)
    grads = torch.autograd.grad(out, leaves, g)
    assert {k: v - before[k] for k, v in attention_cuda.LAUNCHES.items()} == {"fwd": 1, "bwd": 1}
    ref_out, lse = attention.windowed_attention_reference(q, k, v, seg_q, seg_ctx, W)
    refs = attention.windowed_attention_backward_reference(q, k, v, g, ref_out, lse, seg_q, seg_ctx, W)
    torch.testing.assert_close(out, ref_out, rtol=0.0, atol=2e-5)
    scale = max(float(r.abs().max()) for r in refs)
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale)


def _attention_bwd_args(shape, seed, device):
    from torched_impala_tpu_torch.ops import attention

    q, k, v, seg_q, seg_ctx, W, g = _attn_inputs(*shape, seed=seed, device=device)
    out, lse = attention.windowed_attention_reference(q, k, v, seg_q, seg_ctx, W)
    return q, k, v, g, out, lse, seg_q, seg_ctx, W


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kernels", [(ATTN_SHAPES[0], 1), (ATTN_SHAPES[1], 2)], ids=str)
def test_attention_backward_one_or_more_key_tiles(cuda, shape, kernels):
    """The learner's context (S = 149) is one key tile: one launch writes
    dq. A longer one (S = 428) takes several: their dQ shares are summed
    by a second launch. Both match the plain version, and two calls are
    bit-identical (no atomics)."""
    from torched_impala_tpu_torch.ops import attention, attention_cuda, profiling

    args = _attention_bwd_args(shape, seed=5, device=cuda)
    S, dh = args[1].shape[1], args[1].shape[3]
    tiles = -(-S // (attention_cuda.BWD_ROWS * attention_cuda.bwd_tiles(S, dh)[0]))
    assert (tiles == 1) == (kernels == 1)
    first = attention_cuda.attention_backward_cuda(*args)
    again = attention_cuda.attention_backward_cuda(*args)
    refs = attention.windowed_attention_backward_reference(*args)
    torch.cuda.synchronize()
    scale = max(float(r.abs().max()) for r in refs)
    for a, b, r in zip(first, again, refs):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5 * scale)
    _, launched = profiling.device_us(lambda: attention_cuda.attention_backward_cuda(*args),
                                      calls=3, name="attention_bwd")
    assert launched == kernels


@pytest.mark.gpu
@pytest.mark.parametrize("plan", [(1, 3), (2, 2), (3, 1)], ids=str)
def test_attention_backward_at_other_tile_plans(cuda, plan, monkeypatch):
    """Query groups (their dK and dV added in shared memory) and small key
    tiles give the plain version's gradients too."""
    from torched_impala_tpu_torch.ops import attention, attention_cuda

    monkeypatch.setattr(attention_cuda, "bwd_tiles", lambda S, dh: plan)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, seg_q, seg_ctx, W, g = _attn_inputs(5, 40, 3, 32, 19, seed=6, device=cuda, dtype=dtype)
        _attention_vs_plain((q, k, v, seg_q, seg_ctx, W, g), bf16=dtype == torch.bfloat16)


@pytest.mark.gpu
def test_attention_backward_concurrent_launches(cuda):
    """Two threads launch the backward at once, one at the learner's shape
    and one with several key tiles, 20 times each: no launch is refused
    (the kernel's shared-memory ceiling is set once), and every result is
    the first one's, bit for bit."""
    import threading

    from torched_impala_tpu_torch.ops import attention_cuda

    cases = [_attention_bwd_args(ATTN_SHAPES[0], seed=7, device=cuda),
             _attention_bwd_args(ATTN_SHAPES[1], seed=8, device=cuda)]
    outs, errors = [[], []], []
    start = threading.Barrier(len(cases))

    def launch(i):
        try:
            start.wait()
            for _ in range(20):
                outs[i].append(attention_cuda.attention_backward_cuda(*cases[i]))
            torch.cuda.synchronize()
        except Exception as e:  # raised again below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for runs in outs:
        assert len(runs) == 20
        for run in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


def _attention_fwd_vs_plain(args, bf16):
    """The forward's out and lse against the plain version's, at the
    gates of `_attention_vs_plain`."""
    from torched_impala_tpu_torch.ops import attention, attention_cuda

    out, lse = attention_cuda.attention_forward_cuda(*args)
    ref_out, ref_lse = attention.windowed_attention_reference(*args)
    torch.cuda.synchronize()
    ulp = 2.0**-7
    tol = dict(rtol=ulp, atol=ulp) if bf16 else dict(rtol=0.0, atol=2e-5)
    torch.testing.assert_close(out, ref_out, **tol)
    torch.testing.assert_close(lse, ref_lse, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", [(1, 1), (2, 1), (1, 3), (3, 2), (6, 2), (3, 4), (12, 1)], ids=str)
def test_attention_forward_at_each_tile_plan(cuda, plan, monkeypatch):
    """Query groups, key warps (their partials merged in shared memory)
    and one or many steps give the plain version's output and lse, in f32
    and bf16, at a ragged shape, two head widths and a run of query tiles.
    Plans past the block's 12 warps at a width are skipped there."""
    from torched_impala_tpu_torch.ops import attention_cuda

    monkeypatch.setattr(attention_cuda, "fwd_tiles", lambda T, S, dh: plan)
    key_warps, query_groups = plan
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((5, 40, 3, 32, 19), (2, 37, 2, 128, 21), (2, 150, 2, 64, 33)):
            dp = next(p for p in (16, 32, 64, 128, 256) if shape[3] <= p)
            if key_warps * query_groups * max(1, dp // 64) > attention_cuda.FWD_MAX_WARPS:
                continue
            q, k, v, seg_q, seg_ctx, W, _ = _attn_inputs(*shape, seed=sum(shape), device=cuda,
                                                         dtype=dtype)
            _attention_fwd_vs_plain((q, k, v, seg_q, seg_ctx, W), bf16=dtype == torch.bfloat16)


@pytest.mark.gpu
def test_attention_forward_refuses_a_plan_past_the_block(cuda, monkeypatch):
    """A plan over 12 warps at its width is refused by the launch (no
    fallback): cudaErrorInvalidValue (1)."""
    from torched_impala_tpu_torch.ops import attention_cuda

    q, k, v, seg_q, seg_ctx, W, _ = _attn_inputs(2, 21, 2, 128, 19, seed=0, device=cuda)
    monkeypatch.setattr(attention_cuda, "fwd_tiles", lambda T, S, dh: (4, 2))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        attention_cuda.attention_forward_cuda(q, k, v, seg_q, seg_ctx, W)


@pytest.mark.gpu
def test_attention_forward_concurrent_launches(cuda):
    """Two threads launch the forward at once, at the learner's shape and
    at a long unroll (other plans, other shared-memory sizes), 20 times
    each: no launch is refused (the ceiling is set once), and every result
    is the first one's, bit for bit."""
    import threading

    from torched_impala_tpu_torch.ops import attention_cuda

    cases = [_attn_inputs(*ATTN_SHAPES[0], seed=9, device=cuda)[:6],
             _attn_inputs(*ATTN_SHAPES[1], seed=10, device=cuda)[:6]]
    outs, errors = [[], []], []
    start = threading.Barrier(len(cases))

    def launch(i):
        try:
            start.wait()
            for _ in range(20):
                outs[i].append(attention_cuda.attention_forward_cuda(*cases[i]))
            torch.cuda.synchronize()
        except Exception as e:  # raised again below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for runs in outs:
        assert len(runs) == 20
        for run in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


@pytest.mark.gpu
def test_attention_forward_runs_on_tensor_cores(cuda):
    """Every instantiation of the forward kernel (two dtypes x five padded
    widths) holds mma.sync (HMMA) instructions."""
    from torched_impala_tpu_torch.ops import _build

    counts = _build.sass_counts("attention_fwd", "HMMA")
    kernels = {fn: n for fn, n in counts.items() if "attention_fwd_kernel" in fn}
    assert len(kernels) == 10 and min(kernels.values()) > 0, counts


@pytest.mark.gpu
def test_attention_backward_runs_on_tensor_cores(cuda):
    """Every instantiation of the backward kernel holds mma.sync (HMMA)
    instructions; the dQ sum kernel holds none."""
    from torched_impala_tpu_torch.ops import _build

    counts = _build.sass_counts("attention_bwd", "HMMA")
    kernels = {fn: n for fn, n in counts.items() if "attention_bwd_kernel" in fn}
    assert len(kernels) == 10 and min(kernels.values()) > 0, counts


@pytest.mark.gpu
def test_attention_and_fused_loss_wrappers_refuse_bad_inputs_on_cuda(cuda):
    from torched_impala_tpu_torch.ops import attention_cuda, fused_loss_cuda

    q, k, v, seg_q, seg_ctx, W, g = _attn_inputs(2, 5, 2, 16, 3, seed=0, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        attention_cuda.attention_forward_cuda(q, k, v, seg_q.long(), seg_ctx, W)
    with pytest.raises(ValueError, match="float32"):
        attention_cuda.attention_forward_cuda(q, k.bfloat16(), v, seg_q, seg_ctx, W)
    with pytest.raises(ValueError, match="contiguous"):
        attention_cuda.attention_forward_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                                              k, v, seg_q, seg_ctx, W)
    with pytest.raises(ValueError, match="outside"):
        attention_cuda.attention_forward_cuda(q, k, v, seg_q, seg_ctx, k.shape[1] + 1)
    out, lse = attention_cuda.attention_forward_cuda(q, k, v, seg_q, seg_ctx, W)
    with pytest.raises(ValueError, match="o must be float32"):
        attention_cuda.attention_backward_cuda(q, k, v, g, out.bfloat16(), lse, seg_q, seg_ctx, W)
    with pytest.raises(ValueError, match="lse has shape"):
        attention_cuda.attention_backward_cuda(q, k, v, g, out, lse[:, :1], seg_q, seg_ctx, W)
    args = _fused_args(6, 4, 3, seed=0, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_loss_cuda.fused_loss_fwd(*args[:7], args[7].double())
    with pytest.raises(ValueError, match="shape"):
        fused_loss_cuda.fused_loss_fwd(*args[:4], args[4][:2], *args[5:])
    with pytest.raises(ValueError, match="int64"):
        fused_loss_cuda.fused_loss_fwd(*args[:2], args[2].int(), *args[3:])
    bwd = _fused_bwd_args(args, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_loss_cuda.fused_loss_bwd(bwd[0].transpose(0, 1).contiguous().transpose(0, 1),
                                       *bwd[1:])
    with pytest.raises(ValueError, match="g_pg has shape"):
        fused_loss_cuda.fused_loss_bwd(*bwd[:8], bwd[8][None], *bwd[9:])


def _ring_feed_batches(device, use_ring, batches=5, T=5, E=2, B=4):
    """`batches` device batches of the learner's batcher, fed by a thread
    actor over scripted envs, moved to the host."""
    import dataclasses

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.envs.fake import ScriptedEnv
    from torched_impala_tpu_torch.runtime.learner import Learner
    from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

    cfg = dataclasses.replace(configs.CARTPOLE, use_lstm=True, lstm_size=8,
                              unroll_length=T, batch_size=B, traj_ring=use_ring)
    agent = configs.make_agent(cfg, seed=2)
    learner = Learner(agent=agent, optimizer=configs.make_optimizer(cfg),
                      config=configs.make_learner_config(cfg), device=device,
                      example_obs=np.zeros((4,), np.float32))
    actor = VectorActor(actor_id=0, envs=[ScriptedEnv(episode_len=4) for _ in range(E)],
                        agent=agent, param_store=learner.param_store, enqueue=learner.enqueue,
                        unroll_length=T, device=device, seed=3, traj_ring=learner.traj_ring)
    learner.start()
    out = []
    try:
        for _ in range(batches):
            for _ in range(B // E):
                actor.unroll_and_push()
            arrays, version, event, donated = learner._batch_q.get(timeout=60)
            assert donated is None  # donate_batch is off
            assert (event is not None) == use_ring
            if event is not None:
                event.synchronize()
            out.append([t.cpu() for t in (*arrays[:6], *arrays[6])])
    finally:
        learner.stop()
        learner.join()
    if use_ring:
        ring = learner.traj_ring
        assert all(t.is_pinned() for slot in ring._slots for t in slot.tensors[:6])
    return out


@pytest.mark.gpu
def test_ring_feed_on_the_card_equals_queue_feed(cuda):
    """The ring's side-stream copies of pinned slots give the queue feed's
    batches bit for bit, over more batches than slots (each slot
    recycles only after its copy's event)."""
    queue_batches = _ring_feed_batches(cuda, use_ring=False)
    ring_batches = _ring_feed_batches(cuda, use_ring=True)
    for bq, br in zip(queue_batches, ring_batches, strict=True):
        for a, b in zip(bq, br, strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


# About 0.2 s of an H100's SM clock: long enough that a writer thread
# which did not wait for the clones copies them before they exist.
CAPTURE_SLEEP_CYCLES = 400_000_000


@pytest.mark.gpu
def test_async_save_is_ordered_after_the_clones_on_the_learner_stream(cuda, tmp_path):
    """The writer's copy is ordered after `get_state_device`'s clones by
    their event, and nothing else: the learner's stream (a side stream
    here) sleeps before the clones, the blocks the clones land in hold
    NaN until the clones run, and the params and `nu` change in place on
    that stream right after `maybe_save`, with no host sync anywhere. The
    file must hold the state from before the change, bit for bit. A
    writer that skipped the event's wait copies the NaN blocks during the
    sleep; a capture that read the live tensors later sees the change.
    Nothing may wait for the device behind the test's back and so order
    the copy by luck: a first save fills the writer's pinned buffer (a
    pinned allocation syncs the device), and the in-place adds run once
    on copies before the sleep (a kernel's first launch loads its module,
    which waits for the sleep while holding the interpreter lock)."""
    from torched_impala_tpu_torch.models.agent import Agent
    from torched_impala_tpu_torch.models.nets import ImpalaNet
    from torched_impala_tpu_torch.models.torsos import MLPTorso
    from torched_impala_tpu_torch.optim import RMSProp
    from torched_impala_tpu_torch.resilience import AsyncCheckpointer, recovery
    from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig
    from torched_impala_tpu_torch.utils.checkpoint import flat_state

    torch.manual_seed(0)
    learner = Learner(agent=Agent(ImpalaNet(6, MLPTorso(64, (512, 512)))),
                      optimizer=RMSProp(1e-3),
                      config=LearnerConfig(batch_size=1, unroll_length=2), device=cuda)
    with torch.no_grad():
        for v in learner._optimizer.nu.values():
            v.uniform_(0.5, 1.0)
    before = learner.get_state()
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    ck = AsyncCheckpointer(str(tmp_path), interval_steps=1)
    try:
        with torch.cuda.stream(stream), torch.no_grad():
            assert ck.maybe_save(1, learner.get_state_device)
            ck.wait()
            for t in [*learner.params.values(), *learner._optimizer.nu.values()]:
                t.clone().add_(1.0)
            nan = [torch.full(t.shape, float("nan"), device=cuda)
                   for t in flat_state(before).values() if isinstance(t, torch.Tensor)]
            del nan  # freed on `stream`: the clones below reuse the blocks
            torch.cuda._sleep(CAPTURE_SLEEP_CYCLES)
            assert ck.maybe_save(2, learner.get_state_device)
            for p in learner.params.values():
                p.add_(1.0)
            for v in learner._optimizer.nu.values():
                v.add_(1.0)
        ck.wait()
    finally:
        ck.close()
    assert [r["step"] for r in ck.records] == [1, 2]
    manifest, saved = recovery.restore_latest(str(tmp_path), before)
    assert manifest.step == 2
    want, got = flat_state(before), flat_state(saved)
    assert want.keys() == got.keys()
    for key, x in want.items():
        if isinstance(x, torch.Tensor):
            assert got[key].dtype == x.dtype and torch.equal(got[key], x), key
        else:
            assert int(got[key]) == int(x), key


def _per_tensor_rmsprop(params, grads, nus, lr, decay, eps):
    """The per-tensor loop the multi-tensor step replaced: optax's formula,
    one tensor at a time."""
    for p, g, nu in zip(params, grads, nus):
        nu.mul_(decay).add_((1.0 - decay) * torch.square(g))
        p.sub_(lr * (g * torch.rsqrt(nu + eps)))


@pytest.mark.gpu
def test_foreach_update_and_norm_match_the_per_tensor_loop(cuda):
    """`RMSProp.step` and `global_norm` as multi-tensor ops on the card,
    at the Breakout preset's 39 parameter shapes, against the per-tensor
    loop over 3 steps: the same f32 operations in the same order, so
    params and nu agree at rtol 1e-6, atol 1e-7 (an ulp where a multi-
    tensor kernel's rsqrt or product rounds differently); the global norm
    (a norm of per-tensor norms against one sum of squares) at rtol 1e-5."""
    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.optim import RMSProp
    from torched_impala_tpu_torch.runtime.learner import global_norm

    shapes = {k: p.shape for k, p in configs.make_agent(configs.BREAKOUT).net.named_parameters()}
    assert len(shapes) == 39
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    params = {k: randn(s) for k, s in shapes.items()}
    loop_params = [p.clone() for p in params.values()]
    opt = RMSProp(3e-4, decay=0.99, eps=1e-7)
    opt.init(params)
    loop_nus = [torch.zeros_like(p) for p in loop_params]
    for _ in range(3):
        grads = {k: randn(s, 0.01) for k, s in shapes.items()}
        want = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
        torch.testing.assert_close(global_norm(grads.values()), want, rtol=1e-5, atol=0)
        opt.step(params, grads)
        _per_tensor_rmsprop(loop_params, list(grads.values()), loop_nus, 3e-4, 0.99, 1e-7)
    for p, q in zip(params.values(), loop_params):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)
    for nu, q in zip(opt.nu.values(), loop_nus):
        torch.testing.assert_close(nu, q, rtol=1e-6, atol=1e-7)


def _breakout_grads(cuda, remat, obs, first, state, weights):
    """Grads by name of a fixed scalar of the fused-block Breakout net's
    unroll (bf16 torso, random params from seed 0)."""
    import dataclasses

    from torched_impala_tpu_torch import configs

    cfg = dataclasses.replace(configs.BREAKOUT, fused_conv=True, remat_torso=remat)
    net = configs.make_agent(cfg, seed=0).net.to(cuda)
    out, (c, h) = net(obs, first, state, unroll=True)
    wl, wv, wc = weights
    scalar = (out.policy_logits * wl).sum() + (out.values * wv).sum() + (h * wc).sum()
    names = [k for k, _ in net.named_parameters()]
    return dict(zip(names, torch.autograd.grad(scalar, [p for _, p in net.named_parameters()])))


def _same_grads(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.gpu
def test_remat_torso_grads_equal_the_plain_net_bit_for_bit(cuda):
    """The Breakout net with the fused residual blocks (bf16 torso, full
    widths) at T + 1 = 5, B = 4: with `remat_torso` the grads are those
    without, bit for bit, as two runs without are, the block's forward
    kernel launching twice as often. The cuDNN setting is the
    breakout_accum phase's: the default, unless a pair differs, then all
    three runs again with the deterministic algorithms."""
    from torched_impala_tpu_torch.ops import conv_block_cuda

    gen = torch.Generator(device=cuda).manual_seed(1)
    obs = torch.randint(0, 256, (5, 4, 84, 84, 4), generator=gen, device=cuda, dtype=torch.uint8)
    first = torch.zeros(5, 4, dtype=torch.bool, device=cuda)
    first[2, 1] = True
    state = tuple(torch.randn(4, 256, generator=gen, device=cuda) * 0.5 for _ in range(2))
    weights = (torch.randn(5, 4, 4, generator=gen, device=cuda),
               torch.randn(5, 4, 1, generator=gen, device=cuda),
               torch.randn(4, 256, generator=gen, device=cuda))
    args = (obs, first, state, weights)

    def grads_and_launches(remat):
        before = conv_block_cuda.LAUNCHES
        grads = _breakout_grads(cuda, remat, *args)
        return grads, conv_block_cuda.LAUNCHES - before

    def pairs_agree():
        (plain, n_plain), (again, _), (remat, n_remat) = (
            grads_and_launches(False), grads_and_launches(False), grads_and_launches(True))
        assert (n_plain, n_remat) == (6, 12)
        return _same_grads(plain, again) and _same_grads(remat, plain)

    deterministic = torch.backends.cudnn.deterministic
    try:
        if not pairs_agree():
            torch.backends.cudnn.deterministic = True
            assert pairs_agree()
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _step_distance(a, b, before):
    """||a - b|| / ||b - before|| over every param (float64 sums)."""
    num = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in a)
    den = sum(float(((b[k] - before[k]).double() ** 2).sum()) for k in a)
    return (num / den) ** 0.5


@pytest.mark.gpu
def test_grad_accum_breakout_step_matches_the_full_batch(cuda):
    """One Breakout learner step (the preset at full width, fused blocks,
    T = 20, B = 32) at G = 2 with remat against G = 1 without, from the
    same fresh state, at the breakout_accum phase's tolerances: by the
    relative L2 distance of the two param steps and the unclipped grad
    norm, with an f32 torso both within 1e-3 (sums of up to 1.2e6
    products in another order), with the bf16 torso below the bf16
    torso's own distance and grad-norm change from the f32 one, plus 1e-3
    of the grad norm (an activation may round to the other bf16
    neighbour at the microbatch's N)."""
    import dataclasses

    import numpy as np

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.runtime.learner import Learner

    rng = np.random.default_rng(5)
    T, B, A = 20, 32, 4

    def dev(a):
        return torch.from_numpy(a).to(cuda)

    batch = (
        dev(rng.integers(0, 256, size=(T + 1, B, 84, 84, 4), dtype=np.uint8)),
        dev(rng.uniform(size=(T + 1, B)) < 0.05),
        dev(rng.integers(0, A, size=(T, B))),
        dev(rng.normal(size=(T, B, A)).astype(np.float32)),
        dev((rng.uniform(size=(T, B)) < 0.05).astype(np.float32)),
        dev(np.ones((T, B), np.float32)),
        tuple(dev(rng.normal(size=(B, 256)).astype(np.float32) * 0.5) for _ in range(2)),
    )
    out = {}
    for dtype in ("bfloat16", "float32"):
        for G, remat in ((1, False), (2, True)):
            cfg = dataclasses.replace(configs.BREAKOUT, fused_conv=True, remat_torso=remat,
                                      compute_dtype=dtype)
            learner = Learner(
                agent=configs.make_agent(cfg, seed=0),
                optimizer=configs.make_optimizer(cfg),
                config=dataclasses.replace(configs.make_learner_config(cfg), grad_accum=G),
                device=cuda,
            )
            before = {k: v.detach().clone() for k, v in learner.params.items()}
            logs = learner.train_step(batch)
            out[dtype, G] = ({k: v.detach().clone() for k, v in learner.params.items()},
                             float(logs["grad_norm_unclipped"]))
    (p32, n32), (p32g, n32g) = out["float32", 1], out["float32", 2]
    (p16, n16), (p16g, n16g) = out["bfloat16", 1], out["bfloat16", 2]
    assert _step_distance(p32g, p32, before) <= 1e-3
    assert abs(n32g - n32) <= 1e-3 * n32
    assert _step_distance(p16g, p16, before) < _step_distance(p16, p32, before)
    assert abs(n16g - n16) <= abs(n16 - n32) + 1e-3 * n32


def _pong_superbatch(device, K, seed=5):
    """A fixed Pong superbatch on the card, `[K, 21, 32, ...]` leaves."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T, B, A = 20, 32, 6

    def dev(a):
        return torch.from_numpy(a).to(device)

    return (
        dev(rng.integers(0, 256, size=(K, T + 1, B, 84, 84, 4), dtype=np.uint8)),
        dev(rng.uniform(size=(K, T + 1, B)) < 0.05),
        dev(rng.integers(0, A, size=(K, T, B))),
        dev(rng.normal(size=(K, T, B, A)).astype(np.float32)),
        dev((rng.uniform(size=(K, T, B)) < 0.05).astype(np.float32)),
        dev(np.ones((K, T, B), np.float32)),
        (),
    )


@pytest.mark.gpu
def test_superbatch_dispatch_equals_sequential_train_steps_on_the_card(cuda):
    """One K = 4 dispatch of the Pong preset at full width (bf16 torso)
    against four `train_step`s of a twin learner on the superbatch's
    slices, from the same state: the same params and last logs bit for
    bit, with cuDNN's deterministic algorithms (two plain steps may
    differ without them)."""
    import dataclasses

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.runtime.learner import Learner, superbatch_slice

    K = 4
    cfg = dataclasses.replace(configs.PONG, steps_per_dispatch=K)
    learners = [
        Learner(agent=configs.make_agent(cfg, seed=0), optimizer=configs.make_optimizer(cfg),
                config=configs.make_learner_config(cfg), device=cuda)
        for _ in range(2)
    ]
    batch = _pong_superbatch(cuda, K)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        dispatched = learners[0].train_dispatch(batch)
        for k in range(K):
            stepped = learners[1].train_step(superbatch_slice(batch, k))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for name, p in learners[0].params.items():
        assert torch.equal(p, learners[1].params[name]), name
    for key, v in dispatched.items():
        assert torch.equal(v, stepped[key]), key
    assert learners[0]._optimizer.count == learners[1]._optimizer.count == K


@pytest.mark.gpu
def test_donated_slot_is_released_only_after_its_step_event(cuda):
    """Donated superbatch ring slots on the card (K = 2): each dispatch
    sleeps ~0.2 s on the train step's stream after its steps, and every
    slot's release must find the event recorded after its consuming step
    completed. A release after the slot's copy alone would come during
    the sleep. Every handed-back slot is released, without the batcher
    waiting on an event."""
    import dataclasses
    import threading
    import time

    import numpy as np

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.envs.fake import ScriptedEnv
    from torched_impala_tpu_torch.runtime.learner import Learner
    from torched_impala_tpu_torch.runtime.traj_ring import TrajectoryRing
    from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

    T, B, E, K, dispatches = 5, 4, 2, 2, 3
    cfg = dataclasses.replace(configs.CARTPOLE, use_lstm=True, lstm_size=8, unroll_length=T,
                              batch_size=B, traj_ring=True, steps_per_dispatch=K,
                              donate_batch=True)
    agent = configs.make_agent(cfg, seed=2)
    learner = Learner(agent=agent, optimizer=configs.make_optimizer(cfg),
                      config=configs.make_learner_config(cfg), device=cuda,
                      example_obs=np.zeros((4,), np.float32))
    ring = learner.traj_ring
    assert ring.num_slots == learner._batch_q.maxsize + 4
    events, released, lock = {}, [], threading.Lock()
    dispatch, hand_back, release = Learner.train_dispatch, Learner._hand_back, ring.release

    def slow_dispatch(arrays):
        logs = dispatch(learner, arrays)
        torch.cuda._sleep(CAPTURE_SLEEP_CYCLES)
        return logs

    def recording_hand_back(slot, event):
        assert event is not None
        with lock:
            events[slot] = event
        hand_back(learner, slot, event)

    def recording_release(s):
        with lock:
            event = events.pop(s, None)
        released.append((s, event is not None and event.query()))
        release(s)

    learner.train_dispatch, learner._hand_back, ring.release = (
        slow_dispatch, recording_hand_back, recording_release)
    actor = VectorActor(actor_id=0, envs=[ScriptedEnv(episode_len=4) for _ in range(E)],
                        agent=agent, param_store=learner.param_store, enqueue=learner.enqueue,
                        unroll_length=T, device=cuda, seed=3, traj_ring=ring)
    learner.start()
    try:
        for _ in range(dispatches):
            for _ in range(K * B // E):
                actor.unroll_and_push()
            learner.step_once(timeout=60)
        deadline = time.monotonic() + 10
        while len(released) < dispatches and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        learner.stop()
        learner.join()
    assert len(released) == dispatches, released
    assert all(done for _, done in released), released
    assert learner.num_steps == K * dispatches
    assert all(t.is_pinned() for slot in ring._slots for t in slot.tensors[:6])
    assert ring._slots[0].tensors.obs.shape == (K, T + 1, B, 4)


def test_wrappers_refuse_cpu_tensors():
    """No fallback in a wrapper: a CPU tensor raises before any build."""
    from torched_impala_tpu_torch.ops import (
        attention, attention_cuda, conv_block_cuda, fused_loss_cuda, lstm_cuda, vtrace_cuda,
    )

    with pytest.raises(ValueError, match="CUDA tensor"):
        lstm_cuda.lstm_cell_cuda(*_lstm_inputs(2, 3, 4, seed=0, device="cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv_block_cuda.resblock_cuda(*_block_inputs(1, 4, 4, 2, torch.float32, 0, "cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        vtrace_cuda.vtrace_cuda(**_inputs(3, 2, seed=0, device="cpu"))
    args = _fused_args(3, 2, 4, seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_loss_cuda.fused_loss_fwd(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_loss_cuda.fused_loss_bwd(*_fused_bwd_args(args, seed=0))
    q, k, v, seg_q, seg_ctx, W, g = _attn_inputs(2, 5, 2, 16, 3, seed=0, device="cpu")
    out, lse = attention.windowed_attention_reference(q, k, v, seg_q, seg_ctx, W)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention_cuda.attention_forward_cuda(q, k, v, seg_q, seg_ctx, W)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention_cuda.attention_backward_cuda(q, k, v, g, out, lse, seg_q, seg_ctx, W)


def test_attention_wrappers_refuse_heads_above_the_limit():
    """Every head width up to MAX_HEAD_DIM takes the tiled kernels; a wider
    one picks the general kernels' plan on any device, without a build,
    and only a row past their shared memory is refused. A CPU tensor of
    any width still raises before a build."""
    from torched_impala_tpu_torch.ops import attention, attention_cuda

    assert attention_cuda.MAX_HEAD_DIM == 256
    assert not attention_cuda.takes_wide(256) and attention_cuda.takes_wide(257)
    smem = attention_cuda.wide_smem_bytes(257)
    assert smem == {"fwd": 32 + 8 * 257, "dq": 32 + 12 * 257, "dkv": 32 + 16 * 257}
    widest = (attention_cuda.SMEM_CEILING - 32) // 16
    assert attention_cuda.wide_smem_bytes(widest)["dkv"] <= attention_cuda.SMEM_CEILING
    with pytest.raises(ValueError, match="does not fit"):
        attention_cuda._check_wide("attention_wide_bwd", widest + 1)
    q, k, v, seg_q, seg_ctx, W, g = _attn_inputs(2, 5, 2, 257, 3, seed=0, device="cpu")
    out, lse = attention.windowed_attention_reference(q, k, v, seg_q, seg_ctx, W)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention_cuda.attention_forward_cuda(q, k, v, seg_q, seg_ctx, W)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention_cuda.attention_backward_cuda(q, k, v, g, out, lse, seg_q, seg_ctx, W)


@pytest.mark.parametrize(
    "S,dh,plan",
    [(149, 64, (10, 1)), (192, 64, (12, 1)), (193, 64, (4, 3)), (1152, 64, (4, 3)),
     (16, 8, (1, 1)), (149, 128, (4, 1)), (96, 128, (6, 1)), (48, 256, (3, 1)),
     (149, 256, (3, 1))],
)
def test_attention_backward_tile_plan(S, dh, plan):
    """One key tile over the whole context where a block's warps cover it
    (the learner's S = 149: one launch), else 4 key warps x 3 query groups,
    within the 12 warps a block has (fewer key warps at dh > 64, where
    warps split the columns)."""
    from torched_impala_tpu_torch.ops import attention_cuda

    assert attention_cuda.bwd_tiles(S, dh) == plan
    key_warps, query_groups = plan
    dp = next(p for p in (16, 32, 64, 128, 256) if dh <= p)
    assert key_warps * query_groups * max(1, dp // 64) <= attention_cuda.BWD_MAX_WARPS


@pytest.mark.parametrize(
    "T,S,dh,plan",
    [(21, 149, 64, (6, 2)), (1024, 1152, 64, (6, 2)), (1, 1, 16, (1, 1)), (9, 16, 8, (1, 1)),
     (40, 59, 32, (4, 2)), (21, 37, 64, (3, 2)), (16, 149, 64, (10, 1)), (33, 193, 64, (6, 2)),
     (21, 149, 128, (3, 2)), (1024, 1152, 128, (3, 2)), (9, 40, 128, (3, 1)),
     (21, 149, 256, (1, 2)), (1024, 1152, 256, (1, 2)), (16, 300, 16, (12, 1))],
)
def test_attention_forward_tile_plan(T, S, dh, plan):
    """Query tiles of as many 16-row groups as cover T, up to 2 (one tile,
    K and V read once, at the learner's T = 21), then the key warps the
    block's 12 warps leave, no more than S's 16-slot tiles; fewer at
    dh > 64, where warps split the output columns."""
    from torched_impala_tpu_torch.ops import attention_cuda

    assert attention_cuda.fwd_tiles(T, S, dh) == plan
    key_warps, query_groups = plan
    dp = next(p for p in (16, 32, 64, 128, 256) if dh <= p)
    assert key_warps * query_groups * max(1, dp // 64) <= attention_cuda.FWD_MAX_WARPS
    assert query_groups <= attention_cuda.FWD_MAX_QUERY_GROUPS


def test_compare_builds_refuses_without_a_base_or_a_card(monkeypatch, capsys):
    """The build comparison runs only on a card and with one base tree: it
    exits 2 and prints no result otherwise."""
    from torched_impala_tpu_torch.ops import compare_builds

    assert compare_builds.main([]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert compare_builds.main(["base/csrc"]) == 2
    assert capsys.readouterr().out == ""


def test_dispatch_takes_plain_version_on_cpu():
    from torched_impala_tpu_torch.ops import (
        attention, attention_cuda, conv_block, conv_block_cuda, fused_loss, fused_loss_cuda,
        lstm, lstm_cuda,
    )

    before = (lstm_cuda.LAUNCHES, conv_block_cuda.LAUNCHES, dict(fused_loss_cuda.LAUNCHES),
              dict(attention_cuda.LAUNCHES))
    args = _lstm_inputs(2, 3, 4, seed=0, device="cpu")
    torch.testing.assert_close(
        lstm.lstm_cell_fused(*args), lstm.lstm_reference(*args)[:2], rtol=0, atol=0
    )
    args = _block_inputs(1, 4, 4, 2, torch.float32, 0, "cpu")
    torch.testing.assert_close(
        conv_block.fused_residual_block(*args), conv_block.block_reference(*args), rtol=0, atol=0
    )
    args = _fused_args(5, 3, 4, seed=0, device="cpu")
    for a, b in zip(fused_loss.fused_core(*args), fused_loss.fused_core_reference(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    bwd = _fused_bwd_args(args, seed=0)
    for a, b in zip(fused_loss.fused_core_backward(*bwd),
                    fused_loss.fused_core_backward_reference(*bwd)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    q, k, v, seg_q, seg_ctx, W, g = _attn_inputs(2, 5, 2, 16, 3, seed=0, device="cpu")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention.windowed_attention(*leaves, seg_q, seg_ctx, W)
    grads = torch.autograd.grad(out, leaves, g)
    ref_out, lse = attention.windowed_attention_reference(q, k, v, seg_q, seg_ctx, W)
    refs = attention.windowed_attention_backward_reference(q, k, v, g, ref_out, lse, seg_q, seg_ctx, W)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    after = (lstm_cuda.LAUNCHES, conv_block_cuda.LAUNCHES, dict(fused_loss_cuda.LAUNCHES),
             dict(attention_cuda.LAUNCHES))
    assert after == before
