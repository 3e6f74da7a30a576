"""PyTorch port selective scan vs the JAX package.

The port's plain scans (the per-step ``selective_scan_ref``, the chunked
``selective_scan`` that the CUDA kernel is held against, and the streaming
``selective_scan_step``) take the same numpy inputs as JAX's
``selective_scan_ref`` and ``pallas_selective_scan(interpret=True)`` on the
CPU.  The CUDA kernel's own tests need a card and skip here.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cleanumamba_tpu.ops.pallas.selective_scan import pallas_selective_scan
from cleanumamba_tpu.ops.scan import selective_scan_ref as jax_scan_ref
from cleanumamba_tpu.ops.scan import selective_scan_step as jax_scan_step
from cleanumamba_tpu_torch.ops import scan as tscan
from cleanumamba_tpu_torch.ops.cuda import selective_scan as kscan

# fp32: summation order only (sequential vs associative scans, einsum order)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, Bsz, L, di, ds):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(u=f(Bsz, L, di), dt=np.abs(f(Bsz, L, di)) * 0.1,
                A=-np.abs(f(di, ds)), B=f(Bsz, L, ds), C=f(Bsz, L, ds), D=f(di),
                h0=f(Bsz, di, ds) * 0.5)


def _torch(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _jax(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def _np(outs):
    return tuple(np.asarray(o, np.float32) for o in outs)


# ragged L (37), d_inner not a multiple of 128 (200), d_state 8 and 64
SHAPES = [(2, 37, 200, 8), (1, 16, 24, 64), (2, 33, 40, 64)]
PLAIN_SCANS = ["selective_scan", "selective_scan_ref"]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "B{}-L{}-di{}-ds{}".format(*s))
def case(request):
    a = _inputs(sum(request.param), *request.param)
    # The port runs before JAX: in one process with JAX, a torch CPU result
    # computed right after the first Pallas-interpret compile was seen to go
    # wrong by ~1e-4 in one batch row, and right on recomputation.
    got = {fn: getattr(tscan, fn)(**_torch(a)) for fn in PLAIN_SCANS}
    ref = _np(jax_scan_ref(**_jax(a)))
    pal = _np(pallas_selective_scan(**_jax(a), chunk=16, tile_d=128, interpret=True))
    return got, ref, pal


@pytest.mark.parametrize("fn", PLAIN_SCANS)
def test_plain_scan_matches_jax_ref_and_pallas_interpret(case, fn):
    got, ref, pal = case
    y, h = got[fn]
    for want_y, want_h in (ref, pal):
        np.testing.assert_allclose(y.numpy(), want_y, **TOL)
        np.testing.assert_allclose(h.numpy(), want_h, **TOL)


@pytest.mark.parametrize("chunk", [1, 5, 16, 64])
def test_chunked_scan_is_chunk_invariant(chunk):
    a = _torch(_inputs(3, 2, 37, 24, 8))
    y_ref, h_ref = tscan.selective_scan_ref(**a)
    y, h = tscan.selective_scan(**a, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), **TOL)


def test_scan_without_D_and_h0():
    a = _inputs(4, 2, 11, 16, 8)
    a.pop("D"), a.pop("h0")
    y, h = tscan.selective_scan(**_torch(a))
    y_ref, h_ref = _np(jax_scan_ref(**_jax(a)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **TOL)


def test_scan_step_matches_jax():
    a = _inputs(5, 2, 1, 40, 64)
    step = {k: (v[:, 0] if k in ("u", "dt", "B", "C") else v) for k, v in a.items()}
    h0 = step.pop("h0")
    h_t, y_t = tscan.selective_scan_step(torch.from_numpy(h0), **_torch(step))
    h_j, y_j = _np(jax_scan_step(jnp.asarray(h0), **_jax(step)))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)


def test_steps_equal_scan():
    a = _torch(_inputs(6, 2, 9, 24, 8))
    y_scan, h_scan = tscan.selective_scan(**a)
    h, ys = a["h0"], []
    for t in range(9):
        h, y = tscan.selective_scan_step(h, a["u"][:, t], a["dt"][:, t], a["A"],
                                         a["B"][:, t], a["C"][:, t], a["D"])
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_scan.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h_scan.numpy(), **TOL)


def test_bf16_inputs_match_jax():
    """u, B, C in bf16 (dt, A, D, h0 fp32), state math fp32 in both.  y comes
    back in bf16: the two round fp32 values that differ only in summation
    order, so they agree to one bf16 ulp (2^-8 relative); h_last is fp32."""
    a = _inputs(7, 2, 37, 200, 8)
    for k in ("u", "B", "C"):  # the same bf16-rounded values on both sides
        a[k] = torch.from_numpy(a[k]).to(torch.bfloat16).float().numpy()
    aj, at = _jax(a), _torch(a)
    for k in ("u", "B", "C"):
        aj[k], at[k] = aj[k].astype(jnp.bfloat16), at[k].to(torch.bfloat16)
    y_t, h_t = tscan.selective_scan(**at)  # before JAX, as in `case`
    y_j, h_j = _np(pallas_selective_scan(**aj, chunk=16, tile_d=128, interpret=True))
    assert y_t.dtype == torch.bfloat16 and h_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.float().numpy(), np.asarray(y_j, np.float32),
                               rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)


def test_wrapper_takes_plain_version_on_cpu():
    a = _torch(_inputs(8, 1, 7, 16, 8))
    before = kscan.selective_scan.launches
    y, h = kscan.selective_scan(**a)
    y_p, h_p = kscan.selective_scan_plain(**a)
    assert kscan.selective_scan.launches == before  # no kernel on the CPU
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    torch.testing.assert_close(h, h_p, rtol=0, atol=0)


# --- the launch plan: pure functions of the shape, pinned here on the CPU ---

# (B, d_inner, d_state): serving, training, a batch of 8, small and ragged
# widths, the widest states K1 and K2 take
PLAN_SHAPES = [(1, 2048, 64), (2, 2048, 64), (8, 2048, 64), (1, 48, 8), (8, 256, 8),
               (2, 512, 128), (1, 2048, 16), (8, 2048, 16), (1, 33, 1), (2, 130, 100),
               (1, 20, 256), (64, 2048, 128), (1, 2048, 128), (4, 1024, 24)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "B{}-di{}-ds{}".format(*s))
@pytest.mark.parametrize("bwd", [False, True], ids=["K1", "K2"])
def test_scan_plan_covers_the_state_and_fills_the_card(shape, bwd):
    Bsz, Di, Ds = shape
    if bwd and Ds > kscan.MAX_D_STATE_BWD:
        with pytest.raises(ValueError):
            kscan.scan_plan(Bsz, Di, Ds, bwd=True)
        return
    plan = kscan.scan_plan(Bsz, Di, Ds, bwd=bwd)
    assert plan.lanes in kscan.LANE_CHOICES
    assert plan.npt in (1, 2, 4, 8, 16) and plan.npt <= (8 if bwd else 16)
    assert plan.lanes * plan.npt >= Ds > plan.lanes * (plan.npt // 2)
    channels = plan.channels
    assert channels == 256 // plan.lanes
    assert plan.blocks == Bsz * -(-Di // channels)
    # every SM that could get a block gets one: fewer lanes only while 128
    # blocks are left (at B=1 and 2048 channels the 16 lanes of the serving launch)
    most = Bsz * -(-Di // 16)
    assert plan.blocks >= min(128, most)
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.cluster * channels <= max(128, channels)
    assert plan.cluster <= max(plan.blocks // Bsz, 1)


def test_scan_plan_picks_every_lane_count_and_keeps_the_serving_launch():
    assert kscan.scan_plan(1, 2048, 64).lanes == 16  # block 16 of E8: 128 blocks
    assert kscan.scan_plan(2, 2048, 64).lanes == 8   # the training shape
    assert kscan.scan_plan(8, 2048, 64).lanes == 4
    assert kscan.scan_plan(8, 2048, 64, bwd=True).lanes == 8  # 8 elements a thread in K2


@pytest.mark.parametrize("ds_lo", [1, 33, 65, 97], ids=lambda d: f"ds{d}-{d + 31}")
def test_bwd_chunk_fits_shared_memory_for_every_d_state(ds_lo):
    for Ds in range(ds_lo, ds_lo + 32):
        for Bsz, Di in ((1, 2048), (2, 2048), (8, 2048), (64, 4096), (1, 16), (3, 200)):
            plan = kscan.scan_plan(Bsz, Di, Ds, bwd=True)
            chunk = kscan.scan_chunk(Bsz, Di, Ds)
            assert chunk >= 16 and chunk % 16 == 0  # a multiple of K1's 16-step stage
            for esize in (2, 4):
                assert kscan.bwd_smem_bytes(plan.lanes, plan.npt, chunk, esize) <= kscan.SMEM_LIMIT


def test_chunk_follows_the_elements_a_thread_holds():
    assert kscan.scan_chunk(2, 2048, 64) == 16   # 8 lanes x 8 elements
    assert kscan.scan_chunk(1, 2048, 64) == 32   # 16 lanes x 4
    assert kscan.scan_chunk(2, 512, 128) == 16
    assert kscan.scan_chunk(1, 48, 8) == 32
    assert kscan.scan_chunk(1, 20, 256) == 16    # forward only


@pytest.mark.parametrize("shape", [(2, 37, 24, 8), (1, 40, 16, 128), (2, 16, 8, 64)],
                         ids=lambda s: "B{}-L{}-di{}-ds{}".format(*s))
def test_chunk_states_shape_and_values_on_cpu(shape):
    """h_starts has one state per chunk of scan_chunk steps, and state k is
    the scan's h after k * chunk steps."""
    Bsz, L, di, ds = shape
    a = _torch(_inputs(12, *shape))
    chunk = kscan.scan_chunk(Bsz, di, ds)
    y, h, hs = kscan.selective_scan(**a, return_starts=True)
    assert tuple(hs.shape) == (Bsz, -(-L // chunk), di, ds) and hs.dtype == torch.float32
    y_p, h_p = kscan.selective_scan_plain(**a)
    np.testing.assert_allclose(y.numpy(), y_p.numpy(), **TOL)
    torch.testing.assert_close(hs[:, 0], a["h0"], rtol=0, atol=0)
    for k in range(1, hs.shape[1]):
        part = {n: (v[:, :k * chunk] if n in ("u", "dt", "B", "C") else v)
                for n, v in a.items()}
        np.testing.assert_allclose(hs[:, k].numpy(), tscan.selective_scan_ref(**part)[1].numpy(),
                                   **TOL)


# --- the CUDA kernel (needs a card; chip_smoke.py runs the same checks) ---

@pytest.mark.skipif("not torch.cuda.is_available()", reason="the CUDA kernel needs a GPU")
# the serving shapes, the pruned checkpoints' ragged widths, and the d_state
# edges of the kernel's per-lane templates (1, 100 -> 8 per lane, 256 -> 16)
# every lane count of the plan (16, 8, 4 at batch 1, 2, 8 of E8's widths), L
# around the 16-step stage, and a long clip
@pytest.mark.parametrize("shape", [(1, 16, 2048, 64), (2, 63, 2048, 64), (1, 37, 48, 8),
                                   (1, 5, 33, 1), (2, 9, 130, 100), (1, 4, 20, 256),
                                   (8, 17, 2048, 64), (8, 15, 2048, 16), (1, 1, 2048, 16),
                                   (2, 16, 512, 128), (1, 2500, 256, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_cuda(shape, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    a = {k: v.cuda() for k, v in _torch(_inputs(9, *shape)).items()}
    for k in ("u", "B", "C"):
        a[k] = a[k].to(dtype)
    before = kscan.selective_scan.launches
    y, h = kscan.selective_scan(**a)
    assert kscan.selective_scan.launches == before + 1
    y_p, h_p = kscan.selective_scan_plain(**{k: v.float() for k, v in a.items()})
    # fp32: 1e-4 of max|ref| (summation order); bf16: 2e-2 (y rounded to bf16)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in ((y.float(), y_p), (h, h_p)):
        assert (got - want).abs().max() <= tol * want.abs().max()
    # with chunk states: the same bits, and a repeated call too
    y2, h2, hs = kscan.selective_scan(**a, return_starts=True)
    y3, h3, hs3 = kscan.selective_scan(**a, return_starts=True)
    assert torch.equal(y2, y) and torch.equal(h2, h)
    assert torch.equal(y3, y) and torch.equal(h3, h) and torch.equal(hs3, hs)


@pytest.mark.skipif("not torch.cuda.is_available()", reason="the CUDA kernel needs a GPU")
def test_kernel_takes_absent_D_and_h0_on_cuda():
    a = {k: v.cuda() for k, v in _torch(_inputs(13, 2, 40, 200, 8)).items()}
    a.pop("D"), a.pop("h0")
    y, h = kscan.selective_scan(**a)
    y_p, h_p = kscan.selective_scan_plain(**a)
    for got, want in ((y, y_p), (h, h_p)):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.skipif("not torch.cuda.is_available()", reason="the CUDA kernel needs a GPU")
def test_kernel_rejects_what_it_cannot_take():
    a = {k: v.cuda() for k, v in _torch(_inputs(10, 1, 8, 32, 8)).items()}
    with pytest.raises(TypeError):
        kscan.selective_scan(**{**a, "dt": a["dt"].to(torch.bfloat16)})
    with pytest.raises(ValueError):
        kscan.selective_scan(**{**a, "u": a["u"].transpose(1, 2).contiguous().transpose(1, 2)})
    big = _torch(_inputs(11, 1, 4, 8, 300))
    with pytest.raises(ValueError):
        kscan.selective_scan(**{k: v.cuda() for k, v in big.items()})
