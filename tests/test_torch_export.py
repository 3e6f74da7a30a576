"""Serving bundles of the port (``export.py``, ``cli/export.py``,
``SessionMultiplexer.from_bundle``, and K1 as the custom op
``cleanumamba::selective_scan``) on the CPU, after JAX's
``tests/test_export.py``: the loaded offline forward and prime equal the
eager calls exactly, a loaded step continues a loaded prime as the live step
does, ``bundle.json`` carries batch and block, a block-4 step equals four
single steps, ``from_bundle`` serves as the live multiplexer does, a process
runs a bundle with no model module imported, and the export CLI's selftest
passes.  The loaded offline forward is also held against JAX's forward on
the same weights.

The port runs before JAX in each test.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig as JCfg
from cleanumamba_tpu.models.cleanumamba import forward as jax_forward
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu_torch import export as ex
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.models.cleanumamba import forward
from cleanumamba_tpu_torch.ops.cuda import selective_scan as k1
from cleanumamba_tpu_torch.params import from_numpy
from cleanumamba_tpu_torch.serve import SessionMultiplexer
from cleanumamba_tpu_torch.streaming import stream_prime, stream_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(channels_H=8, max_H=16, tsfm_n_head=2, tsfm_d_model=16, tsfm_d_inner=32,
            normalize_input=True)
OP = "cleanumamba.selective_scan"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops here run on one thread: the suite's workers share the
    cores, and an oversubscribed thread pool makes small ops far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(port config, port params, JAX config, numpy params): one set of weights."""
    jcfg = JCfg(bottleneck="mamba", **TINY)
    pn = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    return CleanUMambaConfig(**dataclasses.asdict(jcfg)), from_numpy(pn, "cpu"), jcfg, pn


@pytest.fixture(scope="module")
def bundle(model, tmp_path_factory):
    cfg, params, _, _ = model
    L = cfg.valid_length(4000)
    path = str(tmp_path_factory.mktemp("bundle"))
    prime_exp, step_exp = ex.export_stream(params, cfg)
    offline = ex.export_offline(params, cfg, L)
    ex.save_bundle(path, cfg, {"offline": offline, "prime": prime_exp, "step": step_exp},
                   extra_meta={"length": L})
    return L, path, offline


def _audio(seed, n, batch=1):
    return torch.from_numpy(
        (np.random.default_rng(seed).normal(size=(batch, n)) * 0.3).astype(np.float32))


def _ops(exported):
    return [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]


def test_offline_roundtrip_exact_and_matches_jax(model, bundle):
    cfg, params, jcfg, pn = model
    L, path, _ = bundle
    cfg2, fns = ex.load_bundle(path)
    assert cfg2 == cfg
    x = _audio(0, L)
    with torch.no_grad():
        y_eager = forward(params, x, cfg)
    y_loaded = fns["offline"](params, x)
    assert y_loaded.shape == y_eager.shape == (1, L)
    assert torch.equal(y_loaded, y_eager)
    y_jax = np.asarray(jax_forward(jax.tree_util.tree_map(jnp.asarray, pn),
                                   jnp.asarray(x.numpy()), jcfg))
    assert np.abs(y_loaded.numpy() - y_jax).max() <= 1e-4 * np.abs(y_jax).max()


def test_stream_state_handoff_exact(model, bundle):
    """The loaded prime equals the eager prime, and two loaded steps from
    the loaded state equal two live steps from the live state."""
    cfg, params, _, _ = model
    L, path, _ = bundle
    _, fns = ex.load_bundle(path)
    x = _audio(1, L)
    f0 = x[:, :cfg.frame_length]
    with torch.no_grad():
        state_d, out_d = stream_prime(params, cfg, f0)
    state_l, out_l = fns["prime"](params, f0)
    assert torch.equal(out_l, out_d)
    pos = cfg.frame_length
    for _ in range(2):
        new = x[:, pos:pos + cfg.total_stride]
        with torch.no_grad():
            state_d, od = stream_step(params, cfg, state_d, new)
        state_l, ol = fns["step"](params, state_l, new)
        assert torch.equal(ol, od)
        pos += cfg.total_stride


def test_bundle_is_self_describing(bundle):
    L, path, _ = bundle
    with open(os.path.join(path, "bundle.json")) as f:
        meta = json.load(f)
    assert meta["bundle_version"] == 1 and meta["torch_version"] == torch.__version__
    assert meta["length"] == L
    # batch/block are schema fields derived from the traced shapes
    assert meta["batch"] == 1 and meta["block"] == 1
    assert set(meta["functions"]) == {"offline", "prime", "step"}
    for entry in meta["functions"].values():
        assert entry["device"] == "cpu" and entry["in_shapes"], entry
        assert os.path.exists(os.path.join(path, entry["file"]))
    assert meta["functions"]["offline"]["in_shapes"][-1] == f"float32[1, {L}]"


def test_k1_is_one_custom_op_node_in_the_traced_graphs(model, bundle):
    """The offline forward and the block step reach the scan as the custom
    op, once per bottleneck layer; the single-frame step does not scan."""
    cfg, params, _, _ = model
    _, _, offline = bundle
    assert _ops(offline).count(OP + ".default") == cfg.tsfm_n_layers
    _, step4 = ex.export_stream(params, cfg, block=4)
    assert _ops(step4).count(OP + ".default") == cfg.tsfm_n_layers


def test_custom_op_registration_checks():
    """torch.library's own checks of the op (schema, fake implementation,
    autograd registration) on CPU inputs, with and without h0, D and the
    chunk states; and its outputs equal the plain scan."""
    g = torch.Generator().manual_seed(3)
    Bsz, L, Di, Ds = 2, 37, 24, 8
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    u, dt, A = rn(Bsz, L, Di), rn(Bsz, L, Di).abs() * 0.1, -rn(Di, Ds).abs()
    B, C, D, h0 = rn(Bsz, L, Ds), rn(Bsz, L, Ds), rn(Di), rn(Bsz, Di, Ds)
    for d, h, starts in ((D, h0, False), (None, None, True), (D, h0, True)):
        torch.library.opcheck(torch.ops.cleanumamba.selective_scan.default,
                              (u, dt, A, B, C, d, h, starts))
        y, h_last, h_starts = torch.ops.cleanumamba.selective_scan(u, dt, A, B, C, d, h, starts)
        y_ref, h_ref = k1.selective_scan_plain(u, dt, A, B, C, d, h)
        assert torch.equal(y, y_ref) and torch.equal(h_last, h_ref)
        assert h_starts.shape == ((Bsz, 2, Di, Ds) if starts else (Bsz, 0, Di, Ds))


def test_block4_bundle_equals_four_single_steps(model, tmp_path):
    cfg, params, _, _ = model
    prime_exp, step4 = ex.export_stream(params, cfg, block=4)
    ex.save_bundle(str(tmp_path), cfg, {"prime": prime_exp, "step": step4})
    _, fns = ex.load_bundle(str(tmp_path))
    with open(tmp_path / "bundle.json") as f:
        assert json.load(f)["block"] == 4
    tsr = cfg.total_stride
    x = _audio(3, cfg.frame_length + 8 * tsr)
    state, _ = fns["prime"](params, x[:, :cfg.frame_length])
    state_b = state
    single, block = [], []
    pos = cfg.frame_length
    for _ in range(2):
        blk = x[:, pos:pos + 4 * tsr]
        with torch.no_grad():
            for j in range(4):
                state, o = stream_step(params, cfg, state, blk[:, j * tsr:(j + 1) * tsr])
                single.append(o)
        state_b, ob = fns["step"](params, state_b, blk)
        block.append(ob)
        pos += 4 * tsr
    single, block = torch.cat(single, 1), torch.cat(block, 1)
    assert (single - block).abs().max() <= 1e-4 * single.abs().max()


def test_from_bundle_serves_as_the_live_multiplexer(model, tmp_path):
    """An exported bundle drives the multiplexer (batch 2 -> slots, block 1):
    two staggered sessions give what the multiplexer gives over the live
    functions the bundle traced, bit for bit on the CPU, and what the live
    multiplexer gives (its ticks run the level packs: another sum order) at
    the serving tests' 1e-5; a bundle without batch/block is refused."""
    cfg, params, _, _ = model
    fl, tsr = cfg.frame_length, cfg.total_stride
    prime_exp, step_exp = ex.export_stream(params, cfg, batch=2, block=1)
    ex.save_bundle(str(tmp_path), cfg, {"prime": prime_exp, "step": step_exp})
    mux_b = SessionMultiplexer.from_bundle(str(tmp_path), params)
    assert (mux_b.slots, mux_b.block, mux_b.device) == (2, 1, torch.device("cpu"))
    assert mux_b.packed_levels == 0
    traced = {"prime": lambda p, f: stream_prime(p, cfg, f),
              "step": lambda p, s, n: stream_step(p, cfg, s, n)}
    mux_f = SessionMultiplexer(params, cfg, slots=2, device="cpu", fns=traced)
    mux_l = SessionMultiplexer(params, cfg, slots=2, device="cpu")
    assert mux_l.packed_levels == 2 * cfg.encoder_n_layers
    a0, a1 = _audio(40, fl + 6 * tsr)[0].numpy(), _audio(41, fl + 4 * tsr)[0].numpy()
    outs = []
    for mux in (mux_b, mux_f, mux_l):
        s0 = mux.open()
        first = mux.feed(s0, a0[:fl + 2 * tsr])
        s1 = mux.open()
        second = mux.feed(s1, a1)
        rest = mux.feed(s0, a0[fl + 2 * tsr:])
        outs.append([np.concatenate([first, rest, mux._drain(s0)]),
                     np.concatenate([second, mux._drain(s1)])])
    for got, want, live in zip(*outs):
        assert got.shape == want.shape == live.shape and got.size > 0
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, live, rtol=1e-5, atol=1e-5)

    meta = json.loads((tmp_path / "bundle.json").read_text())
    del meta["block"]
    (tmp_path / "bundle.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="batch/block"):
        SessionMultiplexer.from_bundle(str(tmp_path), params)


def test_multiplexer_refuses_a_weight_precision_with_fns(model):
    """The functions of ``fns`` take the params as given, so a storage
    precision other than fp32 would go unapplied: refused."""
    cfg, params, _, _ = model
    fns = {"prime": lambda p, f: None, "step": lambda p, s, n: None}
    for weights in ("bf16", "int8"):
        with pytest.raises(ValueError, match="fns"):
            SessionMultiplexer(params, cfg, slots=2, device="cpu", weights=weights, fns=fns)
    assert SessionMultiplexer(params, cfg, slots=2, device="cpu", fns=fns)._step is fns["step"]


def test_a_loader_process_runs_the_bundle_without_model_code(model, bundle, tmp_path):
    """A fresh process loads the bundle and runs prime, two steps and the
    offline forward; no model module and no streaming module is imported,
    and its outputs equal this process's eager calls."""
    cfg, params, _, _ = model
    L, path, _ = bundle
    x = _audio(5, L)
    torch.save({"params": params, "x": x}, tmp_path / "inputs.pt")
    code = (
        "import sys, torch\n"
        "from cleanumamba_tpu_torch.export import load_bundle\n"
        f"cfg, fns = load_bundle({path!r})\n"
        f"d = torch.load({str(tmp_path / 'inputs.pt')!r})\n"
        "p, x = d['params'], d['x']\n"
        "fl, ts = cfg.frame_length, cfg.total_stride\n"
        "state, out = fns['prime'](p, x[:, :fl])\n"
        "outs = [out]\n"
        "for k in range(2):\n"
        "    state, out = fns['step'](p, state, x[:, fl + k * ts: fl + (k + 1) * ts])\n"
        "    outs.append(out)\n"
        "y = fns['offline'](p, x)\n"
        f"torch.save({{'stream': torch.cat(outs, 1), 'y': y}}, {str(tmp_path / 'out.pt')!r})\n"
        "bad = [m for m in sys.modules if m.startswith(('cleanumamba_tpu_torch.models',\n"
        "       'cleanumamba_tpu_torch.streaming')) or m.split('.')[0] in ('jax', 'cleanumamba_tpu')]\n"
        "print('modules', len(bad), bad)\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "modules 0 []" in r.stdout, r.stdout
    got = torch.load(tmp_path / "out.pt")
    fl, tsr = cfg.frame_length, cfg.total_stride
    with torch.no_grad():
        state, out = stream_prime(params, cfg, x[:, :fl])
        outs = [out]
        for k in range(2):
            state, out = stream_step(params, cfg, state, x[:, fl + k * tsr: fl + (k + 1) * tsr])
            outs.append(out)
        assert torch.equal(got["stream"], torch.cat(outs, 1))
        assert torch.equal(got["y"], forward(params, x, cfg))


def test_export_cli_selftest_on_the_cpu(tmp_path, capsys):
    from cleanumamba_tpu_torch.cli import export as cli

    out = tmp_path / "bundle"
    cli.main(["--ckpt", os.path.join(ROOT, "artifacts", "pruned_473k_finetuned.pkl"),
              "--out", str(out), "--length", "8000", "--block", "2", "--batch", "2",
              "--selftest", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "selftest OK" in text and "offline max|err| = 0" in text
    meta = json.loads((out / "bundle.json").read_text())
    assert (meta["batch"], meta["block"]) == (2, 2)
    assert meta["ckpt"].endswith("pruned_473k_finetuned.pkl")
    assert {e["device"] for e in meta["functions"].values()} == {"cpu"}
