"""The mha bottleneck (CleanUNet) served by ``SessionMultiplexer``, against
the plain reference ``portbench/reference/cleanunet.py``.

Each session keeps its own KV rings and position in the pool.  At a small
CleanUNet-shaped size in fp32 on the CPU, with the window shrunk to 5
tokens so that rings wrap: sessions of different lengths, admitted on
different ticks, one paused for several ticks, each match the reference
streaming the same audio with a banded causal attention (1e-5 of max|ref|:
both fp32, the program attending from its rings a token at a time, the
reference in blocks of queries: only the order of the sums differs); a
session beside others equals itself alone bit for bit; the counters count
the attended windows; a slot closed and admitted again starts from an empty
window; ``export_stream`` refuses the model, whose step writes its rings
in place.  Also the benchmark's weight layout of the published
configuration against the program's ``init_params``.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.models import bottleneck_mha
from cleanumamba_tpu_torch.models.cleanumamba import count_params, init_params
from cleanumamba_tpu_torch.params import prepare_weight_view, tensor_leaves, tree_leaves
from cleanumamba_tpu_torch.serve import SessionMultiplexer
from cleanumamba_tpu_torch.streaming import without_packed_levels
from portbench import cleanunet_weights
from portbench.reference import cleanunet as ref
from portbench.weights import leaf_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(channels_input=1, channels_output=1, channels_H=8, max_H=16, encoder_n_layers=4,
             kernel_size=4, stride=2, tsfm_n_layers=2, tsfm_n_head=2, tsfm_d_model=16,
             tsfm_d_inner=32, bottleneck="mha", normalize_input=True, norm_epsilon=1e-6)
W = 5  # tokens a session attends to: fewer than most sessions here step
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops here run on one thread: the suite's workers share the
    cores, and an oversubscribed thread pool makes small ops far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _window(monkeypatch):
    """The program's window shrunk to W tokens, so that sessions wrap."""
    monkeypatch.setattr(bottleneck_mha, "mha_max_len", lambda cfg: W)


@pytest.fixture(scope="module")
def model():
    cfg = CleanUMambaConfig(**SMALL)
    return cfg, cleanunet_weights.make_params(SMALL, torch.Generator().manual_seed(3))


def _audio(seed, n):
    return (np.random.default_rng(seed).normal(size=n) * 0.2).astype(np.float32)


def _serve(mux, audios, pause=(), start=None):
    """Feed every session a hop a round (its first frame whole), session i
    opened at round ``start[i]``; the sessions in ``pause`` get nothing in
    rounds 2-5.  Returns ({i: output}, {i: sid})."""
    cfg = mux.cfg
    fl, ts = cfg.frame_length, cfg.total_stride
    start = start or [0] * len(audios)
    outs, sids, at = {i: [] for i in range(len(audios))}, {}, [0] * len(audios)
    k = 0
    while any(at[i] < len(a) for i, a in enumerate(audios)):
        for i, a in enumerate(audios):
            if k < start[i] or at[i] >= len(a) or (i in pause and 2 <= k < 6):
                continue
            if i not in sids:
                sids[i] = mux.open()
            n = min(at[i] + (fl if at[i] == 0 else ts), len(a))
            outs[i].append(mux.feed(sids[i], a[at[i]:n]))
            at[i] = n
        k += 1
    return {i: np.concatenate(o + [mux._drain(sids[i])]) for i, o in outs.items()}, sids


def _lengths(cfg, ticks):
    return [cfg.frame_length + n * cfg.total_stride for n in ticks]


def test_sessions_match_the_reference(model):
    """Three sessions at 4 slots: admitted on rounds 0, 1 and 3; the second
    paused for four rounds; the first and third wrap their rings."""
    cfg, P = model
    audios = [_audio(i, n) for i, n in enumerate(_lengths(cfg, (14, 4, 9)))]
    mux = SessionMultiplexer(P, cfg, slots=4, device="cpu")
    outs, _ = _serve(mux, audios, pause=(1,), start=[0, 1, 3])
    assert int(mux.pool["bottleneck"]["pos"].max()) > W  # a ring has wrapped
    for i, a in enumerate(audios):
        want = ref.stream(P, SMALL, torch.from_numpy(a)[None], W)[0].numpy()
        assert outs[i].shape == want.shape, (i, outs[i].shape, want.shape)
        assert np.abs(outs[i] - want).max() <= REL * np.abs(want).max(), i


def test_a_session_beside_others_equals_itself_alone(model):
    cfg, P = model
    audios = [_audio(10 + i, n) for i, n in enumerate(_lengths(cfg, (11, 7, 9)))]
    crowd, _ = _serve(SessionMultiplexer(P, cfg, slots=4, device="cpu"), audios,
                      pause=(0,), start=[0, 2, 1])
    alone, _ = _serve(SessionMultiplexer(P, cfg, slots=4, device="cpu"),
                      audios[:1], pause=(0,))
    assert np.array_equal(crowd[0], alone[0])


def test_kv_positions_sum_the_live_rows_windows(model):
    """Each tick a live row's token attends to min(its tokens so far, W)
    slots; the prime's token is its first."""
    cfg, P = model
    ticks = (8, 3, 6)
    mux = SessionMultiplexer(P, cfg, slots=4, device="cpu")
    _serve(mux, [_audio(20 + i, n) for i, n in enumerate(_lengths(cfg, ticks))], pause=(1,))
    assert mux.kv_positions == sum(min(n + 1, W) for t in ticks for n in range(1, t + 1))


def test_paused_and_closed_rows(model):
    """A paused session's rings and position stay bitwise as they were; the
    next session admitted in a closed slot starts from an empty window (the
    splice writes its position: the prime's one token) and matches the
    reference."""
    cfg, P = model
    fl, ts = cfg.frame_length, cfg.total_stride
    mux = SessionMultiplexer(P, cfg, slots=3, device="cpu")
    a, b = mux.open(), mux.open()
    mux.feed(a, _audio(30, fl + 2 * ts))
    mux.feed(b, _audio(31, fl + ts))
    rows = [t[b].clone() for t in tree_leaves(mux.pool["bottleneck"])]
    mux.feed(a, _audio(32, 6 * ts))  # six ticks of a alone
    assert all(torch.equal(t[b], r) for t, r in zip(tree_leaves(mux.pool["bottleneck"]), rows))
    assert int(mux.pool["bottleneck"]["pos"][a]) == 9  # the prime's token and 8 ticks
    mux.close(a)
    c = mux.open()
    assert c == a
    x = _audio(33, fl + 7 * ts)
    first = mux.feed(c, x[:fl])
    assert int(mux.pool["bottleneck"]["pos"][c]) == 1
    got = np.concatenate([first, mux.feed(c, x[fl:]), mux._drain(c)])
    want = ref.stream(P, SMALL, torch.from_numpy(x)[None], W)[0].numpy()
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_block_ticks_match_the_reference(model):
    """block=3 ticks (the bottleneck's token loop over the gathered rows)."""
    cfg, P = model
    fl, ts = cfg.frame_length, cfg.total_stride
    mux = SessionMultiplexer(P, cfg, slots=2, block=3, device="cpu")
    x, y = _audio(40, fl + 12 * ts), _audio(41, fl + 3 * ts)
    s, t = mux.open(), mux.open()
    mux.feed(t, y)
    got = np.concatenate([mux.feed(s, x), mux._drain(s)])
    want = ref.stream(P, SMALL, torch.from_numpy(x)[None], W)[0].numpy()
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_bundle_path_refuses_mha(model):
    cfg, P = model
    with pytest.raises(ValueError, match="mha"):
        SessionMultiplexer(P, cfg, slots=2, device="cpu",
                           fns={"prime": lambda p, f: None, "step": lambda p, s, n: None})


def test_export_stream_refuses_mha(model):
    """The bundle's step is stateless; an mha step writes its rings in
    place, so it is refused with the reason rather than traced."""
    from cleanumamba_tpu_torch.export import export_stream

    cfg, P = model
    with pytest.raises(ValueError, match="mha model's step writes its KV rings in place"):
        export_stream(P, cfg, batch=1, block=1)


def test_benchmark_layout_is_the_programs_tree():
    """The published configuration's file, laid out by the benchmark's
    weights module, has the tree of the program's ``init_params``:
    46,071,937 parameters, 15,752,704 of them in the transformer."""
    conf = json.loads((ROOT / "portbench" / "configs" / "cleanunet-dns-large.json").read_text())
    geom = conf["model"]
    cfg = CleanUMambaConfig(**geom)
    pt = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [(p, tuple(t.shape)) for p, t in leaf_paths(pt)] == \
        [(p, s) for p, s, *_ in cleanunet_weights.layout(geom)]
    assert count_params(pt) == cleanunet_weights.param_count(geom) == conf["derived"]["params"] \
        == 46071937
    assert sum(t.numel() for t in tree_leaves(pt["bottleneck"])) == 15752704
    small = cleanunet_weights.make_params(SMALL, torch.Generator().manual_seed(0))
    assert [p for p, _ in leaf_paths(small)] == \
        [p for p, _ in leaf_paths(init_params(CleanUMambaConfig(**SMALL),
                                              torch.Generator().manual_seed(0), "cpu"))]


# --- the tick at the width of its live rows ---------------------------------

WIDTH_SLOTS = 6
# live rows a tick -> its width (5: every slot, one of them paused)
WIDTHS = {1: 1, 2: 2, 3: 4, 5: WIDTH_SLOTS, WIDTH_SLOTS: WIDTH_SLOTS}


@pytest.mark.parametrize("n_live", sorted(WIDTHS))
def test_width_ticks_keep_other_rings_and_match_the_reference(model, n_live):
    """Ticks of 1, 2, 3 (width 4), 5 (every slot, one paused) and every live
    row, the live set turning: the rings and positions of every row without
    a hop (paused sessions, padding rows) stay bitwise as they were, the
    pool a tick read is left alone, and every session, its ring wrapped,
    matches the reference."""
    cfg, P = model
    fl, ts = cfg.frame_length, cfg.total_stride
    mux = SessionMultiplexer(P, cfg, slots=WIDTH_SLOTS, device="cpu")
    audio = {s: _audio(70 + s, fl) for s in range(WIDTH_SLOTS)}
    outs = {}
    for s in range(WIDTH_SLOTS):
        assert mux.open() == s
        outs[s] = [mux.feed(s, audio[s])]
    rounds = 2 * W * WIDTH_SLOTS // n_live  # every session steps past its window
    for r in range(rounds):
        live = sorted((r * n_live + k) % WIDTH_SLOTS for k in range(n_live))
        rest = [s for s in range(WIDTH_SLOTS) if s not in live]
        before = [t.clone() for t in tree_leaves(mux.pool["bottleneck"])]
        pool_in = mux.pool
        for s in live:
            x = _audio(1000 * r + s, ts)
            audio[s] = np.concatenate([audio[s], x])
            mux._buf[s], mux._fed[s] = x, mux._fed[s] + ts
        mux._pump()
        for got, old in zip(tree_leaves(mux.pool["bottleneck"]), before):
            assert torch.equal(got[rest], old[rest])
        assert all(torch.equal(t, old) for t, old in
                   zip(tree_leaves(pool_in["bottleneck"]), before))
    assert mux.ticks == rounds and mux.rows_stepped == rounds * WIDTHS[n_live]
    assert int(mux.pool["bottleneck"]["pos"].min()) > W  # every ring has wrapped
    for s in range(WIDTH_SLOTS):
        got = np.concatenate(outs[s] + [mux._drain(s)])
        want = ref.stream(P, SMALL, torch.from_numpy(audio[s])[None], W)[0].numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= REL * np.abs(want).max(), s


@pytest.mark.parametrize("n_live", [1, 2, 5, WIDTH_SLOTS])
def test_widened_ticks_equal_the_ticks_that_cast(model, n_live):
    """bf16 weights, fp32 state: the six matrices of each layer and the two
    bottleneck projections are held in fp32 (``widened``), and no bf16 leaf
    is left in the tick's tree.  Ticks of 1, 2, 5 (every slot, one paused)
    and every live row, the live set turning past the window, give bit for
    bit the outputs and pool of the same ticks over the stored bf16 weights
    cast per product (what the ticks did before the widening); bf16 state
    widens nothing."""
    cfg, P = model
    fl, ts = cfg.frame_length, cfg.total_stride
    stored = prepare_weight_view(P, "bf16")[0]
    assert SessionMultiplexer(P, cfg, slots=2, weights="bf16", dtype=torch.bfloat16,
                              device="cpu").widened == 0
    muxes = [SessionMultiplexer(P, cfg, slots=WIDTH_SLOTS, weights="bf16", device="cpu")
             for _ in range(2)]
    wide, cast = muxes
    assert wide.widened == 6 * cfg.tsfm_n_layers + 2
    assert not any(t.dtype == torch.bfloat16 for t in tensor_leaves(wide._step_params))
    cast.params, cast._step_params = stored, without_packed_levels(stored, cast._packs[1])
    outs = [{}, {}]
    for mux, out in zip(muxes, outs):
        for s in range(WIDTH_SLOTS):
            assert mux.open() == s
            out[s] = [mux.feed(s, _audio(80 + s, fl))]
        for r in range(2 * W * WIDTH_SLOTS // n_live):
            for k in range(n_live):
                s = (r * n_live + k) % WIDTH_SLOTS
                mux._buf[s], mux._fed[s] = _audio(2000 * r + s, ts), mux._fed[s] + ts
            mux._pump()
    assert wide.ticks == cast.ticks and int(wide.pool["bottleneck"]["pos"].min()) > W
    for s in range(WIDTH_SLOTS):
        assert np.array_equal(np.concatenate(outs[0][s] + [wide._drain(s)]),
                              np.concatenate(outs[1][s] + [cast._drain(s)])), s
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(wide.pool), tree_leaves(cast.pool)))
