"""PyTorch port of the scan's gradient vs the JAX package.

The port's plain backward (``ops/scan.py::selective_scan_bwd``, the CPU path
and the oracle K2 is held against) takes the same numpy inputs as JAX's
``_ssg_fwd``/``_ssg_bwd`` and Pallas ``pallas_selective_scan_bwd`` in
interpret mode; ``SelectiveScanFn`` is held against ``jax.grad`` of
``selective_scan_grad``; and the mixer's gradients must reach every input
upstream of the scan.  The CUDA kernel cases need a card and skip here.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.models import bottleneck_mamba as jmamba
from cleanumamba_tpu.ops.pallas.selective_scan import (
    pallas_selective_scan,
    pallas_selective_scan_bwd,
)
from cleanumamba_tpu.ops.scan import _ssg_bwd, _ssg_fwd, selective_scan_grad
from cleanumamba_tpu_torch.models import bottleneck_mamba as tmamba
from cleanumamba_tpu_torch.ops import scan as tscan
from cleanumamba_tpu_torch.ops.cuda import selective_scan as kscan

# tests/test_pallas_scan.py's tolerance for the Pallas backward
TOL = dict(rtol=2e-4, atol=2e-4)
GRADS = ["gu", "gdt", "gA", "gB", "gC", "gD", "gh0"]
# ragged L (37, 33), d_inner not a multiple of 128 (200, 40), d_state 8 and 64
# (chunks of 32 steps) and 128 (8 state elements a thread: chunks of 16)
SHAPES = [(2, 37, 200, 8), (1, 16, 24, 64), (2, 33, 40, 64), (1, 37, 16, 128)]


def _chunk(t):
    """The chunk the wrappers use for these inputs (it follows the shape)."""
    return kscan.scan_chunk(t["u"].shape[0], t["u"].shape[2], t["A"].shape[1])


def _inputs(seed, Bsz, L, di, ds):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(u=f(Bsz, L, di), dt=np.abs(f(Bsz, L, di)) * 0.1,
                A=-np.abs(f(di, ds)), B=f(Bsz, L, ds), C=f(Bsz, L, ds), D=f(di),
                h0=f(Bsz, di, ds) * 0.5, gy=f(Bsz, L, di), gh_last=f(Bsz, di, ds))


def _torch(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _port_bwd(t):
    """Plain forward with chunk states, then the plain backward (port)."""
    _, _, hs = tscan.selective_scan(t["u"], t["dt"], t["A"], t["B"], t["C"], t["D"], t["h0"],
                                    chunk=_chunk(t), return_starts=True)
    return hs, tscan.selective_scan_bwd(t["u"], t["dt"], t["A"], t["B"], t["C"], t["D"], hs,
                                        t["gy"], t["gh_last"], chunk=_chunk(t))


def _np(xs):
    return [np.asarray(x, np.float32) for x in xs]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "B{}-L{}-di{}-ds{}".format(*s))
def case(request):
    a = _inputs(sum(request.param), *request.param)
    # The port runs before JAX (see tests/test_torch_scan.py::case).
    hs, got = _port_bwd(_torch(a))
    chunk = _chunk(_torch(a))
    j = {k: jnp.asarray(v) for k, v in a.items()}
    scan_args = (j["u"], j["dt"], j["A"], j["B"], j["C"], j["D"], j["h0"])
    _, res = _ssg_fwd(*scan_args, chunk)
    ref = _np(_ssg_bwd(chunk, res, (j["gy"], j["gh_last"])))
    _, _, bounds = pallas_selective_scan(*scan_args, chunk=chunk, tile_d=128, interpret=True,
                                         return_boundaries=True)
    pal = _np(pallas_selective_scan_bwd(*scan_args[:6], bounds, j["gy"], j["gh_last"],
                                        chunk=chunk, tile_d=128, interpret=True))
    # JAX keeps the chunk states as (n_chunks, B, d_state, d_inner)
    ref_hs = np.asarray(res[-1]).transpose(1, 0, 3, 2)
    return hs, got, ref, pal, ref_hs


@pytest.mark.parametrize("grad", GRADS)
def test_plain_bwd_matches_jax_and_pallas_interpret(case, grad):
    _, got, ref, pal, _ = case
    i = GRADS.index(grad)
    for want in (ref[i], pal[i]):
        np.testing.assert_allclose(got[i].numpy(), want, **TOL)


def test_chunk_states_match_jax(case):
    hs, _, _, _, ref_hs = case
    np.testing.assert_allclose(hs.numpy(), ref_hs, **TOL)


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_plain_bwd_is_chunk_invariant(chunk):
    t = _torch(_inputs(3, 2, 37, 24, 8))
    _, want = _port_bwd(t)
    _, _, hs = tscan.selective_scan(t["u"], t["dt"], t["A"], t["B"], t["C"], t["D"], t["h0"],
                                    chunk=chunk, return_starts=True)
    got = tscan.selective_scan_bwd(t["u"], t["dt"], t["A"], t["B"], t["C"], t["D"], hs,
                                   t["gy"], t["gh_last"], chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def _fn_grads(t, names=("u", "dt", "A", "B", "C", "D", "h0")):
    """Gradients of <y, gy> + <h_last, gh_last> through SelectiveScanFn."""
    leaves = {k: t[k].clone().requires_grad_() for k in names}
    y, h = kscan.selective_scan_fn(*(leaves[k] for k in ("u", "dt", "A", "B", "C", "D", "h0")))
    loss = (y.float() * t["gy"]).sum() + (h * t["gh_last"]).sum()
    return torch.autograd.grad(loss, [leaves[k] for k in names])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}-L{}-di{}-ds{}".format(*s))
def test_selective_scan_fn_grads_match_jax_grad(shape):
    a = _inputs(sum(shape) + 1, *shape)
    got = _fn_grads(_torch(a))
    j = {k: jnp.asarray(v) for k, v in a.items()}

    def loss(u, dt, A, B, C, D, h0):
        y, h = selective_scan_grad(u, dt, A, B, C, D, h0, 32)
        return jnp.sum(y * j["gy"]) + jnp.sum(h * j["gh_last"])

    want = _np(jax.grad(loss, argnums=tuple(range(7)))(
        *(j[k] for k in ("u", "dt", "A", "B", "C", "D", "h0"))))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_bf16_inputs_match_jax():
    """u, B, C (and gy) in bf16, state math fp32: gu, gB, gC come back bf16
    (one bf16 ulp, 2^-8 relative, from values that differ in summation
    order only), gdt, gA, gD, gh0 fp32."""
    a = _inputs(7, 2, 37, 200, 8)
    for k in ("u", "B", "C", "gy"):  # the same bf16-rounded values on both sides
        a[k] = torch.from_numpy(a[k]).to(torch.bfloat16).float().numpy()
    t = _torch(a)
    for k in ("u", "B", "C", "gy"):
        t[k] = t[k].to(torch.bfloat16)
    _, got = _port_bwd(t)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16, torch.float32,
                                      torch.float32]
    j = {k: jnp.asarray(v) for k, v in a.items()}
    _, res = _ssg_fwd(j["u"], j["dt"], j["A"], j["B"], j["C"], j["D"], j["h0"], _chunk(t))
    want = _np(_ssg_bwd(_chunk(t), res, (j["gy"], j["gh_last"])))
    for g, w in zip(got, want):
        tol = dict(rtol=8e-3, atol=8e-3) if g.dtype == torch.bfloat16 else TOL
        np.testing.assert_allclose(g.float().numpy(), w, **tol)


def _mixer_params(seed, d_model=16, d_inner=40, d_state=8, dt_rank=2):
    p = tmamba.mixer_init(torch.Generator().manual_seed(seed), d_model, d_inner, d_state,
                          dt_rank)
    rng = np.random.default_rng(seed)
    # a non-zero out_proj and D, so that every upstream gradient is non-zero
    p["out_proj"] = torch.from_numpy(rng.normal(size=(d_inner, d_model)).astype(np.float32))
    p["D"] = torch.from_numpy(rng.normal(size=(d_inner,)).astype(np.float32))
    return p


def test_mixer_gradients_reach_upstream_of_the_scan_and_match_jax():
    """The scan is differentiable: every mixer weight upstream of it gets a
    non-zero gradient, equal to jax.grad of the JAX mixer."""
    p = _mixer_params(0)
    x = np.random.default_rng(1).normal(size=(2, 37, 16)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(2, 37, 16)).astype(np.float32)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    out = tmamba.mixer_forward(leaves, torch.from_numpy(x))
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), list(leaves.values()))
    pj = {k: jnp.asarray(v.numpy()) for k, v in p.items()}

    def loss(pp):
        return jnp.sum(jmamba.mixer_forward(pp, jnp.asarray(x), scan_impl="xla") * w)

    want = jax.grad(loss)(pj)
    for (name, g) in zip(leaves, got):
        assert float(g.abs().max()) > 0, f"no gradient reached {name}"
        ref = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_raw_wrappers_refuse_autograd():
    t = _torch(_inputs(8, 1, 7, 16, 8))
    u = t["u"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="SelectiveScanFn"):
        kscan.selective_scan(u, t["dt"], t["A"], t["B"], t["C"], t["D"], t["h0"])
    with torch.no_grad():  # serving: allowed, and no chunk states are saved
        y, h = kscan.selective_scan_fn(u, t["dt"], t["A"], t["B"], t["C"], t["D"], t["h0"])
    y_p, h_p = kscan.selective_scan_plain(t["u"], t["dt"], t["A"], t["B"], t["C"], t["D"],
                                          t["h0"])
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    torch.testing.assert_close(h, h_p, rtol=0, atol=0)
    assert y.grad_fn is None


def test_wrapper_takes_plain_bwd_on_cpu():
    t = _torch(_inputs(9, 1, 20, 16, 8))
    before = kscan.selective_scan_bwd.launches
    _, _, hs = kscan.selective_scan(t["u"], t["dt"], t["A"], t["B"], t["C"], t["D"], t["h0"],
                                    return_starts=True)
    got = kscan.selective_scan_bwd(t["u"], t["dt"], t["A"], t["B"], t["C"], t["D"], hs,
                                   t["gy"], t["gh_last"])
    _, want = _port_bwd(t)
    assert kscan.selective_scan_bwd.launches == before  # no kernel on the CPU
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 625, 2048, 64), (1, 16, 2048, 64), (2, 40, 48, 8),
                                   (8, 33, 2048, 16), (2, 625, 512, 128)],
                         ids=lambda s: "B{}-L{}-di{}-ds{}".format(*s))
def test_bwd_scratch_is_the_clusters_partials(shape):
    """K2's scratch: gB/gC partials of one row per cluster (of up to 128
    channels, not per block of 16), and the per-batch gA and gD."""
    Bsz, L, Di, Ds = shape
    shapes = kscan.bwd_scratch_shapes(Bsz, L, Di, Ds)
    plan = kscan.scan_plan(Bsz, Di, Ds, bwd=True)
    groups = -(-Di // plan.channels)
    assert shapes["part"] == (2, Bsz, -(-groups // plan.cluster), L, Ds)
    assert shapes["part"][2] <= max(-(-Di // 128), 1) + 1
    assert shapes["gA_part"] == (Bsz, Di, Ds) and shapes["gD_part"] == (Bsz, Di)
    if shape == (2, 625, 2048, 64):
        # the training shape at the plan's cluster of 4: 10.5 MB where the
        # per-block partials were 82 MB; a card that takes clusters of 2 needs 21 MB
        assert 4 * np.prod(shapes["part"]) <= 11e6
        half = kscan.bwd_scratch_shapes(Bsz, L, Di, Ds, plan._replace(cluster=2))
        assert 4 * np.prod(half["part"]) <= 22e6


def test_cluster_is_fitted_to_what_the_card_holds_at_once(monkeypatch):
    """The wrapper halves the plan's cluster while it would cost a wave more
    than single blocks do (the counts are an H100's for K2 at d_state 64)."""
    room = {1: 132, 2: 66, 4: 30, 8: 15}
    monkeypatch.setattr(kscan, "clusters_at_once", lambda code, Ds, chunk, lanes, c: room[c])
    plan = kscan.scan_plan(2, 2048, 64, bwd=True)  # 128 blocks, clusters of 4 at most
    assert (plan.blocks, plan.cluster) == (128, 4)
    assert kscan.fit_cluster(plan, 2, 1, 64, 16).cluster == 2  # 32 clusters of 4 > 30
    small = kscan.scan_plan(2, 256, 64, bwd=True)  # 32 blocks in 4 clusters of 8
    assert kscan.fit_cluster(small, 2, 1, 64, 16).cluster == small.cluster  # all fit
    big = kscan.scan_plan(8, 2048, 64, bwd=True)  # 512 blocks: 4 waves alone, 5 in fours
    assert kscan.fit_cluster(big, 8, 1, 64, 16).cluster == 2


# --- the CUDA kernels (need a card; chip_smoke.py runs the same checks) ---

def _cuda(a, dtype):
    t = {k: v.cuda() for k, v in _torch(a).items()}
    for k in ("u", "B", "C", "gy"):
        t[k] = t[k].to(dtype)
    return t


@pytest.mark.skipif("not torch.cuda.is_available()", reason="the CUDA kernel needs a GPU")
# E8 widths, ragged widths, d_state at each of K2's per-lane templates
# (1, 16 -> 1 per lane, 24 -> 2, 64 -> 4, 100 and 128 -> 8), single chunk
# every lane count of K2's plan (16, 8, 4), L around the 16-step block
@pytest.mark.parametrize("shape", [(2, 63, 2048, 64), (1, 37, 48, 8), (1, 16, 32, 16),
                                   (1, 5, 33, 1), (2, 40, 130, 100), (1, 17, 20, 128),
                                   (2, 33, 40, 24), (8, 17, 2048, 64), (8, 15, 2048, 16),
                                   (1, 1, 2048, 16), (1, 700, 256, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_bwd_match_plain_on_cuda(shape, dtype):
    t = _cuda(_inputs(10, *shape), dtype)
    scan_args = [t[k] for k in ("u", "dt", "A", "B", "C", "D", "h0")]
    y, h, hs = kscan.selective_scan(*scan_args, return_starts=True)
    f32 = [x.float() for x in scan_args]
    _, _, hs_p = tscan.selective_scan(*f32, chunk=_chunk(t), return_starts=True)
    before = kscan.selective_scan_bwd.launches
    got = kscan.selective_scan_bwd(*scan_args[:6], hs, t["gy"], t["gh_last"])
    assert kscan.selective_scan_bwd.launches == before + 1
    want = tscan.selective_scan_bwd(*f32[:6], hs_p, t["gy"].float(), t["gh_last"],
                                    chunk=_chunk(t))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (hs - hs_p).abs().max() <= tol * hs_p.abs().max()
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == (dtype if name in ("gu", "gB", "gC") else torch.float32), name
        assert (g.float() - w).abs().max() <= tol * w.abs().max(), name
    again = kscan.selective_scan_bwd(*scan_args[:6], hs, t["gy"], t["gh_last"])
    for name, g, g2 in zip(GRADS, got, again):  # one fixed order of every sum
        assert torch.equal(g, g2), name


@pytest.mark.skipif("not torch.cuda.is_available()", reason="the CUDA kernel needs a GPU")
def test_mixer_gradients_on_cuda_match_cpu():
    torch.backends.cuda.matmul.allow_tf32 = False
    p = _mixer_params(3, d_model=32, d_inner=64, d_state=16)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 50, 32)).astype(np.float32))
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        out = tmamba.mixer_forward(leaves, x.to(dev))
        grads[dev] = torch.autograd.grad(out.square().sum(), list(leaves.values()))
    for name, gc, gg in zip(p, grads["cpu"], grads["cuda"]):
        assert float(gg.abs().max()) > 0, name
        assert (gg.cpu() - gc).abs().max() <= 1e-4 * gc.abs().max(), name


@pytest.mark.skipif("not torch.cuda.is_available()", reason="the CUDA kernel needs a GPU")
def test_kernel_bwd_rejects_what_it_cannot_take():
    t = _cuda(_inputs(11, 1, 8, 32, 8), torch.float32)
    args = [t[k] for k in ("u", "dt", "A", "B", "C", "D", "h0")]
    _, _, hs = kscan.selective_scan(*args, return_starts=True)
    with pytest.raises(TypeError):
        kscan.selective_scan_bwd(*args[:6], hs, t["gy"].to(torch.bfloat16), t["gh_last"])
    with pytest.raises(ValueError):
        kscan.selective_scan_bwd(*args[:6], hs[:, :0], t["gy"], t["gh_last"])
    big = _cuda(_inputs(12, 1, 4, 8, 200), torch.float32)
    bargs = [big[k] for k in ("u", "dt", "A", "B", "C", "D", "h0")]
    _, _, bhs = kscan.selective_scan(*bargs, return_starts=True)
    with pytest.raises(ValueError):
        kscan.selective_scan_bwd(*bargs[:6], bhs, big["gy"], big["gh_last"])
