"""The algorithm of mlstm_scan's wgmma_bf16 route against the JAX package,
on the CPU.  ``ref.wgmma_route_model`` is that route in plain PyTorch: its
gate pass, the states entering each chunk and its output pass at the
kernel's chunk (128 steps, the last chunk masked), with the float32 factors
of the products split into bf16 hi + lo where the kernel splits them.  It
is held against ``repro.models.xlstm.mlstm_chunkwise`` and against the
Pallas kernel in interpret mode, on the same numpy inputs from a seed.  The
CUDA kernel itself is held against the plain version on the card
(tests/test_torch_kernels_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_scan import ops as pallas_ops
from repro.models import xlstm as JX
from repro_torch.kernels.mlstm_scan import ref

# Without the split the model is the float32 function evaluated at another
# chunk than the reference's: the same formulas summed in another order
# over at most 300 steps and a head dim of 48, outputs O(1-10); as the
# port's other cell tests, 1e-5.
OP_TOL = dict(rtol=1e-5, atol=1e-5)
# With the split each float32 factor keeps 16 of its bits (|x - hi - lo|
# <= 2^-16 |x|), and sums over up to Dh * S such terms drift by ~3e-6 of
# the largest output; the bar is the card's for the kernel against the
# plain version, 1e-4 of max |h| (and of max |C|, |n|, |m|).
MLSTM_RTOL = 1e-4

_jax_chunkwise = jax.jit(JX.mlstm_chunkwise, static_argnames="chunk")


def _cell_inputs(B, S, H, Dh, seed=0, stress=False):
    """q, k, v, ig, fg and an initial state (C, n, m) as numpy; with
    ``stress``, strongly negative forget gates meet large input gates."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, Dh)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((B, S, H)).astype(np.float32)
    fg = (3.0 + rng.standard_normal((B, S, H))).astype(np.float32)
    if stress:
        ig, fg = ig * 4 + 12, fg * 2 - 16
    init = (rng.standard_normal((B, H, Dh, Dh)).astype(np.float32),
            rng.standard_normal((B, H, Dh)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))
    return (q, k, v, ig, fg), init


def _jax(xs, init, chunk, qkv_dtype=jnp.float32):
    q, k, v, ig, fg = xs
    h, state = _jax_chunkwise(
        *(jnp.asarray(a, qkv_dtype) for a in (q, k, v)), jnp.asarray(ig),
        jnp.asarray(fg), chunk=chunk,
        init_state=None if init is None else tuple(map(jnp.asarray, init)))
    return (np.asarray(h, np.float32),) + tuple(
        np.asarray(t, np.float32) for t in state)


def _model(xs, init, qkv_dtype=torch.float32, split=True):
    q, k, v, ig, fg = (torch.from_numpy(a.copy()) for a in xs)
    h, state = ref.wgmma_route_model(
        *(t.to(qkv_dtype) for t in (q, k, v)), ig, fg,
        init_state=None if init is None else
        tuple(torch.from_numpy(a.copy()) for a in init), split=split)
    return tuple(t.numpy() for t in (h,) + state)


def _rel_errs(got, want):
    return {name: float(np.abs(g - w).max() / np.abs(w).max())
            for name, g, w in zip("hCnm", got, want)}


# (B, S, H, Dh, with init_state, stress): S at the kernel's chunk's edges
# (one step, less than a chunk, a chunk, one more, two chunks and one)
CASES = [
    (2, 1, 2, 32, False, False),
    (2, 37, 2, 32, True, False),
    (1, 127, 2, 16, False, False),
    (1, 128, 1, 48, True, False),
    (2, 129, 1, 16, False, False),
    (1, 257, 2, 16, True, False),
    (2, 200, 1, 32, False, True),
]


@pytest.mark.parametrize("B,S,H,Dh,with_init,stress", CASES)
def test_route_model_without_split_matches_jax(B, S, H, Dh, with_init,
                                               stress):
    """float32 inputs, no split: the route's passes compute the reference's
    function (the reference at its own chunk, 16 halved to divide S)."""
    xs, init = _cell_inputs(B, S, H, Dh, seed=10, stress=stress)
    init = init if with_init else None
    got = _model(xs, init, split=False)
    want = _jax(xs, init, chunk=16)
    assert np.isfinite(got[0]).all()
    for name, g, w in zip("hCnm", got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **OP_TOL)


@pytest.mark.parametrize("B,S,H,Dh,with_init,stress", CASES)
def test_route_model_with_split_matches_jax_in_bf16(B, S, H, Dh, with_init,
                                                    stress):
    """bf16 q, k, v (the route's inputs), the float32 factors split as the
    kernel splits them, against the reference on the same bf16 inputs."""
    xs, init = _cell_inputs(B, S, H, Dh, seed=11, stress=stress)
    init = init if with_init else None
    got = _model(xs, init, qkv_dtype=torch.bfloat16)
    want = _jax(xs, init, chunk=16, qkv_dtype=jnp.bfloat16)
    for name, r in _rel_errs(got, want).items():
        assert r <= MLSTM_RTOL, (name, r)


@pytest.mark.parametrize("B,S,H,Dh,chunk", [
    (2, 256, 2, 32, 64), (1, 128, 2, 16, 16), (2, 64, 1, 32, 64)])
@pytest.mark.parametrize("split", [False, True])
def test_route_model_matches_the_pallas_kernel_in_interpret_mode(
        B, S, H, Dh, chunk, split):
    """Shapes the Pallas kernel covers (S a multiple of its chunk, no
    initial state): float32 inputs, at 1e-5 without the split and at
    MLSTM_RTOL with it."""
    xs, _ = _cell_inputs(B, S, H, Dh, seed=12)
    h, state = pallas_ops.mlstm_chunkwise(*map(jnp.asarray, xs), chunk=chunk,
                                          interpret=True)
    want = (np.asarray(h),) + tuple(np.asarray(t) for t in state)
    got = _model(xs, None, split=split)
    if split:
        for name, r in _rel_errs(got, want).items():
            assert r <= MLSTM_RTOL, (name, r)
    else:
        for name, g, w in zip("hCnm", got, want):
            np.testing.assert_allclose(g, w, err_msg=name, **OP_TOL)


def test_split_is_exact_for_bf16_values():
    """A bf16 value splits into itself and zero, so the exact bf16 factors
    (q, k, v) and a bf16 input lose nothing."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 50)
    x = torch.cat([x, torch.tensor([0.0, -0.0, 1e-30, 3e38, -3e38])])
    xb = x.to(torch.bfloat16).float()
    hi, lo = ref.split_bf16(xb)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.float(), xb)
    assert torch.equal(lo.float(), torch.zeros_like(xb))


def test_split_keeps_sixteen_bits_of_float32():
    """hi + lo is x to within 2^-16 |x| (each half rounds to nearest even
    and keeps 8 significant bits: |x - hi| <= 2^-8 |x|, then |x - hi - lo|
    <= 2^-8 |x - hi|), so at least 16 bits survive, over the range of the
    gated values (|x| from 1e-30 to 1e30)."""
    rng = np.random.default_rng(14)
    mant = rng.uniform(1.0, 2.0, 100_000)
    exps = rng.integers(-99, 100, 100_000)
    sign = rng.choice([-1.0, 1.0], 100_000)
    x = torch.from_numpy((sign * mant * 2.0 ** exps).astype(np.float32))
    hi, lo = ref.split_bf16(x)
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -16
    # and the split is not trivially exact: bf16 alone keeps 8 bits
    assert float(((hi.double() - x.double()).abs()
                  / x.double().abs()).max()) > 2.0 ** -10


def test_route_model_takes_the_kernels_chunk_for_any_s():
    """The model's chunk is the kernel's (128, checked against the library
    on the card); its last chunk is masked, so any S gives the same
    function as at another chunk."""
    assert ref.WGMMA_CHUNK == 128
    xs, init = _cell_inputs(1, 131, 2, 16, seed=15)
    q, k, v, ig, fg = (torch.from_numpy(a.copy()) for a in xs)
    init_t = tuple(torch.from_numpy(a.copy()) for a in init)
    at_128 = ref.wgmma_route_model(q, k, v, ig, fg, init_state=init_t,
                                   split=False)
    at_16 = ref.wgmma_route_model(q, k, v, ig, fg, init_state=init_t,
                                  chunk=16, split=False)
    for a, b in zip((at_128[0],) + at_128[1], (at_16[0],) + at_16[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **OP_TOL)
