"""The CleanUNet configuration and its live cell: the configuration's file
against the manifest and the weights module, the counts of K6 and of
CleanUNet's FLOPs on hand-worked shapes, the new readers on made-up
records, and the driver at a tiny size on the CPU."""

from __future__ import annotations

import pytest
import torch

from portbench import cleanunet_weights
from portbench.counts import cleanunet_flops, k6, model_flops, peaks
from portbench.harness import ROOT, Manifest, load_json, module
from portbench.tests import tiny
from portbench.weights import leaf_paths

CONF = load_json(ROOT / "portbench" / "configs" / "cleanunet-dns-large.json")
TINY_MHA = dict(tiny.TINY_GEOM, bottleneck="mha", tsfm_n_layers=2, norm_epsilon=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_configuration_states_the_published_geometry():
    g = CONF["model"]
    assert (g["channels_H"], g["max_H"], g["encoder_n_layers"], g["kernel_size"], g["stride"]) \
        == (64, 768, 8, 4, 2)
    assert (g["tsfm_n_layers"], g["tsfm_n_head"], g["tsfm_d_model"], g["tsfm_d_inner"]) \
        == (5, 8, 512, 2048)
    assert g["bottleneck"] == "mha" and g["norm_epsilon"] == 1e-6 and g["normalize_input"]
    assert CONF["reduced"] == [] and "attention_window" in CONF["assumed"]
    assert CONF["streaming"]["attention_window"] == 16000 * 10 // 256 == 625
    assert cleanunet_weights.param_count(g) == CONF["derived"]["params"] == 46071937
    m = Manifest()
    assert m.configs["cleanunet-dns-large"]["file"] == "portbench/configs/cleanunet-dns-large.json"
    cell = m.cell("cleanunet-mux-live")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("cleanunet-dns-large", "mux-calls", 1)
    assert [x["name"] for x in m.metrics("cleanunet-mux-live", trace=False)] == \
        ["hop_p95_ms", "setup_s"]
    assert {x["name"] for x in m.metrics("cleanunet-mux-live", trace=True)} == \
        {"k6_roofline.cleanunet-live", "mfu.cleanunet-live", "live_row_share.live",
         "device_ms_per_hop.live", "idle_share.live"}


def test_weights_are_drawn_from_the_seed():
    a = cleanunet_weights.make_params(TINY_MHA, torch.Generator().manual_seed(5))
    b = cleanunet_weights.make_params(TINY_MHA, torch.Generator().manual_seed(5))
    c = cleanunet_weights.make_params(TINY_MHA, torch.Generator().manual_seed(6))
    la, lb, lc = (torch.cat([t.reshape(-1) for _, t in leaf_paths(x)]) for x in (a, b, c))
    assert torch.equal(la, lb) and not torch.equal(la, lc)
    w = a["bottleneck"]["layers"][1]["ffn_w2"]
    assert w.shape == (16, 8) and float(w.abs().max()) <= 16 ** -0.5
    assert torch.equal(a["bottleneck"]["enc_norm"]["scale"], torch.ones(8))


def test_k6_cost_on_a_hand_worked_shape():
    g = {"tsfm_n_layers": 2, "tsfm_d_model": 8, "tsfm_n_head": 2}
    ops, nbytes = k6.cost(g, positions=10, rows=3)
    assert ops == 2 * 10 * (4 * 8 + 2) == 680
    assert nbytes == 2 * (2 * 8 * 10 + 4 * 8 * 3) * 4 == 2048
    # one live row with a full window of the cell: bytes bound it
    ops, nbytes = k6.cost(CONF["model"], positions=625, rows=1)
    assert nbytes == 5 * (2 * 512 * 625 + 4 * 512) * 4
    assert nbytes / peaks.HBM_BYTES_PER_S > ops / peaks.FLOPS["fp32"]


def test_cleanunet_flops_on_hand_worked_shapes():
    g = CONF["model"]
    assert cleanunet_flops.token_flops(g) == 5 * (8 * 512 ** 2 + 4 * 512 * 2048) == 31457280
    assert cleanunet_flops.attention_flops(g, 625) == 5 * 4 * 512 * 625
    # the U-Net part is model_flops' count without a bottleneck layer
    positions = model_flops.frame_positions(g)
    assert cleanunet_flops.unet_flops(g, positions) == model_flops.flops(
        dict(g, tsfm_n_layers=0), positions)
    assert cleanunet_flops.frame_flops(g) == cleanunet_flops.unet_flops(g, positions) \
        + cleanunet_flops.token_flops(g)


def test_readers_on_made_up_records():
    g = CONF["model"]
    trace = {"ops": {"_anonymous_namespace_::kv_attention_kernel<float, 64>": (50, 2e-4),
                     "glu_kernel": (80, 1e-3)}}
    counts = {"kv_positions_traced": 6000, "ticks_traced": 10, "live_rows": 1000,
              "kv_positions": 300000, "feed_s": 2.0, "flush_s": 0.5}
    rec = {"geom": g, "counts": counts, "trace": trace}
    ops, nbytes = k6.cost(g, 6000, 10)
    got = module("metrics", "k6_roofline.cleanunet-live").read(rec)
    assert got == pytest.approx(100 * peaks.bound_s(ops, nbytes) / 2e-4)
    assert module("metrics", "k6_roofline.cleanunet-live").read(
        dict(rec, trace={"ops": {"glu_kernel": (80, 1e-3)}})) is None
    assert module("metrics", "k6_roofline.cleanunet-live").read(
        dict(rec, counts={"feed_s": 1.0})) is None
    flops = 1000 * cleanunet_flops.frame_flops(g) + cleanunet_flops.attention_flops(g, 300000)
    assert module("metrics", "mfu.cleanunet-live").read(rec) == pytest.approx(
        100 * flops / 2.5 / peaks.FLOPS["fp32"])
    assert module("metrics", "mfu.cleanunet-live").read(dict(rec, counts={"feed_s": 1.0})) \
        is None


def test_cleanunet_driver_runs_tiny_on_the_cpu():
    ctx = tiny.context("cleanunet-mux-live", seconds=0.6,
                       traffic={"calls": 2, "call_seconds": [0.1, 0.4], "durations": 8})
    ctx.config = {"model": dict(TINY_MHA), "streaming": {"attention_window": 625}}
    out = tiny.run(ctx)
    assert out["e2e"]["hop_p95_ms"] > 0 and out["e2e"]["setup_s"] >= 0
    assert out["attempted"] > 0 and out["failed"] == 0
    for name, value, limit in out["compared"]:
        assert value <= limit, (name, value, limit)
    c = out["counts"]
    assert c["ticks"] == c["live_rows"] > 0 and c["admitted"] > 0
    # each live row's token attends to at least its own slot and its prime's
    assert c["kv_positions"] >= 2 * c["live_rows"]
    assert c["kv_positions_traced"] == c["ticks_traced"] == 0  # no trace taken
    # the serving layer's reader finds what it reads in this driver's counts
    assert 0 < module("metrics", "live_row_share.live").read({"counts": c, "trace": None}) <= 100
