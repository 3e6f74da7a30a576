"""The multiplexer's packed tick on the card (``serve.py``), against the
unpacked step.

At block 1 a ``SessionMultiplexer`` runs every encoder and decoder level
through K3/K4 inside the tick's CUDA graph, at every width.  Here, at E8's
geometry, bf16 weights at slots = 16 (the tensor cores) and fp32 weights at
slots = 8, and CleanUNet's (E8's U-Net, five mha layers whose rings K6
writes in place) with bf16 weights at 16 slots, each tick of the graphed
multiplexer (the first eager, the second captured, the rest replayed) is
held against eager, unpacked ``stream_step`` on the same card over the
live rows gathered from the same pool: the live rows' output and state at
1e-5 of max|ref| (fp32, TF32 off; another sum order), the paused rows'
state bit for bit.  The same holds for ticks at widths 1, 16, 1 and 2 on
both bottlenecks (and with fp32 weights), each width's graph eager,
captured and replayed, with width 1 captured before the first wider tick:
no K3/K4 pack's scratch moves after that capture.  The reference reads the
stored weights (bf16 where the multiplexer stores bf16), not the
multiplexer's tree, whose bf16 leaves outside the packs are widened to fp32
at construction.  Ticks at widths 1, 2, 4, 8 and 16 over those widened
weights equal, bit for bit, the same ticks of a multiplexer that reads the
stored bf16 weights and casts them per product, on both geometries.  Needs a
CUDA device and imports no JAX:
``python -m pytest --noconftest -q -m cuda tests/test_torch_serve_card.py``.
"""

import numpy as np
import pytest
import torch

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.graphs import own
from cleanumamba_tpu_torch.models.cleanumamba import init_params
from cleanumamba_tpu_torch.params import prepare_weight_view, tensor_leaves, tree_leaves, tree_map
from cleanumamba_tpu_torch.serve import SessionMultiplexer
from cleanumamba_tpu_torch.streaming import stream_step, without_packed_levels

REL = 1e-5


def _close(got, want, what):
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= REL * max(scale, 1e-6), (what, err, scale)


def _reference(mux, stored, live, x):
    """Eager, unpacked ``stream_step`` on the ``stored`` weights over the live
    rows of the pool, gathered (a copy: an mha step writes the rings of its
    state): (state, out) of those rows."""
    dev, slots = mux.device, mux.slots
    rows = torch.from_numpy(np.flatnonzero(live)).to(dev)
    sub = tree_map(lambda t: t[rows] if t.ndim and t.shape[0] == slots else t, mux.pool)
    with torch.no_grad():
        return stream_step(stored, mux.cfg, sub, torch.from_numpy(x[live]).to(dev))


def _config(bottleneck):
    return (CleanUMambaConfig() if bottleneck == "mamba"  # E8
            else CleanUMambaConfig(bottleneck="mha", tsfm_n_layers=5, norm_epsilon=1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("weights,slots,bottleneck", [("fp32", 8, "mamba"),
                                                      ("bf16", 16, "mamba"),
                                                      ("bf16", 16, "mha")])
def test_packed_ticks_match_the_unpacked_step_on_the_card(weights, slots, bottleneck):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3/K4 and the graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg = _config(bottleneck)
    fl, tsr = cfg.frame_length, cfg.total_stride
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    stored = prepare_weight_view(params, weights)[0]
    mux = SessionMultiplexer(params, cfg, slots=slots, weights=weights, device=dev)
    assert mux.packed_levels == 2 * cfg.encoder_n_layers
    rng = np.random.default_rng(0)
    for s in range(slots):  # every slot admitted (primed); no tick yet
        assert mux.open() == s
        mux.feed(s, (rng.normal(size=fl) * 0.1).astype(np.float32))
    assert mux.ticks == 0
    for k in range(5):  # eager, captured, replayed
        for s in range(slots):
            mux._drain(s)
        live = np.array([(s + k) % 3 != 0 for s in range(slots)])
        x = (rng.normal(size=(slots, tsr)) * 0.1).astype(np.float32) * live[:, None]
        for s in np.flatnonzero(live):
            mux._buf[s] = x[s]  # a hop for each live session; the others pause
        before = own(mux.pool)
        ref_state, ref_out = _reference(mux, stored, live, x)
        mux._pump()
        assert mux.ticks == k + 1
        rows = torch.from_numpy(np.flatnonzero(live)).to(dev)
        got_out = torch.from_numpy(np.stack([mux._out[s][0] for s in np.flatnonzero(live)]))
        _close(got_out, ref_out.cpu(), f"tick {k} output")
        assert all(not mux._out[s] for s in np.flatnonzero(~live))
        for i, (got, want, old) in enumerate(zip(tree_leaves(mux.pool), tree_leaves(ref_state),
                                                 tree_leaves(before))):
            if got.ndim == 0 or got.shape[0] != slots or not got.numel():
                continue
            paused = torch.from_numpy(np.flatnonzero(~live)).to(dev)
            assert torch.equal(got[paused], old[paused]), (k, i)
            _close(got[rows], want, f"tick {k} state leaf {i}")


WIDTH_SEQUENCE = (1, 16, 1, 2)  # live rows of the ticks, each its own width


@pytest.mark.cuda
@pytest.mark.parametrize("bottleneck,weights", [("mamba", "bf16"), ("mha", "bf16"),
                                               ("mamba", "fp32")])
def test_width_ticks_replayed_match_the_unpacked_step_on_the_card(bottleneck, weights):
    """A tick at width 1, then ticks at widths 1, 16, 1, 2, the sequence three
    times (each width eager, then captured, then replayed; width 1 captured
    before the first wider tick), at 16 slots with bf16 and fp32 weights
    (every width packed): each tick's live rows against eager, unpacked
    ``stream_step`` over those rows gathered from the same pool (1e-5 of
    max|ref|), every other row bit for bit; one graph a width; no K3/K4
    pack's scratch moves after the first capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3/K4 and the graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, slots = torch.device("cuda:0"), 16
    cfg = _config(bottleneck)
    fl, tsr = cfg.frame_length, cfg.total_stride
    params = init_params(cfg, torch.Generator().manual_seed(1), dev)
    stored = prepare_weight_view(params, weights)[0]
    mux = SessionMultiplexer(params, cfg, slots=slots, weights=weights, device=dev)
    assert mux.packed_levels == 2 * cfg.encoder_n_layers
    scratch = [a["scratch"] for a in mux._packs[0]["enc"] + mux._packs[0]["dec"]]
    rng = np.random.default_rng(1)
    for s in range(slots):
        assert mux.open() == s
        mux.feed(s, (rng.normal(size=fl) * 0.1).astype(np.float32))
    ptrs, k = None, 0
    for n in (1,) + WIDTH_SEQUENCE * 3:  # width 1 captured before the first wider tick
        for s in range(slots):
            mux._drain(s)
        live = np.zeros(slots, bool)
        live[[(k * 5 + i) % slots for i in range(n)]] = True
        x = (rng.normal(size=(slots, tsr)) * 0.1).astype(np.float32) * live[:, None]
        for s in np.flatnonzero(live):
            mux._buf[s] = x[s]
        before = own(mux.pool)
        ref_state, ref_out = _reference(mux, stored, live, x)
        stepped = mux.rows_stepped
        mux._pump()
        k += 1
        assert mux.ticks == k and mux.rows_stepped - stepped == n
        if ptrs is None and len(mux._graphs) > 1:  # the prime's and the first tick's
            ptrs = [a["scratch"].data_ptr() for a in mux._packs[0]["enc"]
                    + mux._packs[0]["dec"]]
        rows = torch.from_numpy(np.flatnonzero(live)).to(dev)
        paused = torch.from_numpy(np.flatnonzero(~live)).to(dev)
        got_out = torch.from_numpy(np.stack([mux._out[s][0] for s in np.flatnonzero(live)]))
        _close(got_out, ref_out.cpu(), f"tick {k} (width {n}) output")
        for i, (got, want, old) in enumerate(zip(tree_leaves(mux.pool),
                                                 tree_leaves(ref_state),
                                                 tree_leaves(before))):
            if got.ndim == 0 or got.shape[0] != slots or not got.numel():
                continue
            assert torch.equal(got[paused], old[paused]), (k, n, i)
            _close(got[rows], want, f"tick {k} (width {n}) state leaf {i}")
    assert len(mux._graphs) == 1 + len(set(WIDTH_SEQUENCE))  # the prime and one a width
    assert ptrs == [a["scratch"].data_ptr() for a in mux._packs[0]["enc"]
                    + mux._packs[0]["dec"]]
    assert all(a is b for a, b in zip(scratch, [a["scratch"] for a in mux._packs[0]["enc"]
                                                + mux._packs[0]["dec"]]))


WIDENED_WIDTHS = (1, 2, 4, 8, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("bottleneck", ["mamba", "mha"])
def test_widened_ticks_equal_the_ticks_that_cast_on_the_card(bottleneck):
    """bf16 weights, fp32 state, 16 slots, E8's and CleanUNet's geometries:
    ``widened`` reads 17 and 32, and no bf16 leaf is left in the tick's
    tree.  Beside it a multiplexer that reads the stored bf16 weights and
    casts each per product in every tick.  Both take the same traffic: ticks
    at widths 1, 2, 4, 8 and 16 (each eager, captured, replayed), the live
    set turning; every tick's output and the whole pool are equal bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3/K4 and the graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, slots = torch.device("cuda:0"), 16
    cfg = _config(bottleneck)
    params = init_params(cfg, torch.Generator().manual_seed(2), dev)
    muxes = [SessionMultiplexer(params, cfg, slots=slots, weights="bf16", device=dev)
             for _ in range(2)]
    wide, cast = muxes
    assert wide.widened == {"mamba": 17, "mha": 32}[bottleneck]
    assert not any(t.dtype == torch.bfloat16 for t in tensor_leaves(wide._step_params))
    stored = prepare_weight_view(params, "bf16")[0]
    cast.params, cast._step_params = stored, without_packed_levels(stored, cast._packs[1])
    del params
    rng = np.random.default_rng(2)
    first = (rng.normal(size=(slots, cfg.frame_length)) * 0.1).astype(np.float32)
    for mux in muxes:
        for s in range(slots):
            assert mux.open() == s
            mux.feed(s, first[s])
    k = 0
    for w in WIDENED_WIDTHS:
        for _ in range(4):
            live = [(k * w + i) % slots for i in range(w)]
            x = (rng.normal(size=(w, cfg.total_stride)) * 0.1).astype(np.float32)
            outs = []
            for mux in muxes:
                for i, s in enumerate(live):
                    mux._buf[s] = x[i]
                mux._pump()
                outs.append([mux._drain(s) for s in live])
            k += 1
            assert all(np.array_equal(a, b) for a, b in zip(*outs)), (w, k)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(wide.pool),
                                                     tree_leaves(cast.pool))), w
    assert wide.ticks == cast.ticks == 4 * len(WIDENED_WIDTHS)
    assert len(wide._graphs) == len(cast._graphs) == 1 + len(WIDENED_WIDTHS)
