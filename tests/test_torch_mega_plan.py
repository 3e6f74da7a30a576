"""The cluster plan of the whole-frame kernel (K5) and its normalising contract.

``mega_plan`` cuts every product of a frame over a thread block cluster of
8, 4, 2 or 1 blocks and schedules each block's weight slabs through a ring
of shared memory; it is pure Python, so it is held here, on every geometry
that the tests and ``chip_smoke.py`` run: each product's rows x columns
covered exactly once in rank order (or whole in every block), each slab
within the ring and copied only once the space it takes has been read, the
shared memory within the card's limit, and the kernel's weight buffer
holding the pack's matrices.  Then the plain version of the new contract,
``mega_stream_frame`` (the input normalisation inside the step), against
JAX's ``stream_step_mega`` over 4 frames, fp32, atol 2e-5 (the tolerance of
tests/test_stream_mega.py): the tail, the running std, the frame count, the
state and the output.  The port runs before JAX in each test.  The kernel
itself is held against the plain version on a GPU (the case marked ``cuda``).
"""

import dataclasses
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu import streaming as js
from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu.ops.pallas.stream_mega import pack_mega as jax_pack_mega
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch import streaming as ts
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.ops.cuda import stream_mega as sm

FULLMINI = dict(channels_H=32, max_H=64, encoder_n_layers=8, tsfm_n_layers=3, tsfm_n_head=8,
                tsfm_d_model=64, tsfm_d_inner=128)
SMALL = dict(channels_H=16, max_H=48, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
             tsfm_d_model=32, tsfm_d_inner=64)
CKPTS = ["artifacts/pruned_473k_finetuned.pkl", "artifacts/capstone_724k_scratch.pkl"]
# every geometry that the tests and chip_smoke.py drive through the kernel
GEOMETRIES = {
    **{f"fullmini-{f}": dict(FULLMINI, bottleneck=f)
       for f in ("mamba", "mamba2", "lstm", "mamba_s4", "mha")},
    "width-16..32": dict(FULLMINI, channels_H=16, max_H=32),
    "width-64..128": dict(FULLMINI, channels_H=64, max_H=128),
    "D=4": dict(FULLMINI, encoder_n_layers=4),
    "D=7": dict(FULLMINI, encoder_n_layers=7),
    "L=1": dict(FULLMINI, tsfm_n_layers=1),
    "L=6": dict(FULLMINI, tsfm_n_layers=6),
    "small-mha": dict(SMALL, bottleneck="mha"),
    **{ck.split("/")[-1]: ck for ck in CKPTS},
}
TOL = dict(atol=2e-5, rtol=1e-4)


def _model(geometry):
    spec = GEOMETRIES[geometry]
    if isinstance(spec, str):
        return tparams.load_checkpoint(spec, "cpu")
    cfg = CleanUMambaConfig(**spec)
    return cfg, tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _check_plan(meta, C):
    plan = sm.mega_plan(meta, C)
    assert plan["smem"] <= sm._SMEM_LIMIT and plan["ring"] > 0
    assert plan["ring_off"] >= sm._HEAD + meta["smem_bytes"] and sm._HEAD == 8320
    prods = plan["products"]
    assert len(prods) <= sm._MAX_PROD
    esize = torch.empty((), dtype=meta["cdt"]).element_size()
    for p in prods:
        T, N, NW = p["T"], p["N"], len(p["srcs"])
        cover = np.zeros((T, N), np.int64)
        blocks = []
        for r, (row0, rows, n0, nc, src, nbytes, ring, after) in enumerate(p["ranks"]):
            assert nbytes == -(-p["K"] * NW * nc * esize // 16) * 16
            cover[row0: row0 + rows, n0: n0 + nc] += 1
            if rows and nc:
                blocks.append((row0, n0))
        if p["split"]:
            assert (cover == 1).all(), p["name"]    # every output exactly once
            assert blocks == sorted(blocks), p["name"]  # ranks in row-major order
        else:
            assert (cover == C).all(), p["name"]    # whole in every block
    # each block's ring: within bounds, copied after an earlier product, in
    # order, and never over a slab that a product not yet ended still reads
    for r in range(C):
        live = []
        last = -1
        for pi, p in enumerate(prods):
            _, _, _, _, _, nbytes, ring, after = p["ranks"][r]
            if ring < 0:
                assert nbytes == 0 or nbytes > plan["ring"]
                continue
            assert plan["ring_off"] <= ring and ring + nbytes <= plan["ring_off"] + plan["ring"]
            assert ring % 16 == 0 and -1 <= after < pi and after >= last
            last = after
            for q, lo, hi in live:
                if q > after and lo < ring + nbytes and ring < hi:
                    raise AssertionError(f"rank {r}: {p['name']} overwrites product {q}")
            live.append((pi, ring, ring + nbytes))
    return plan


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_cluster_plan_covers_and_fits(geometry):
    """Every cluster size, fp32 and bf16 packs."""
    cfg, params = _model(geometry)
    for cdt in (torch.float32, torch.bfloat16):
        view = params if cdt == torch.float32 else tparams.prepare_weight_view(params, "bf16")[0]
        packed = sm.pack_mega(view, cfg, cdt)
        assert packed is not None, geometry
        for C in sm.CLUSTERS:
            _check_plan(packed[1], C)


@pytest.mark.parametrize("geometry", ["fullmini-mamba_s4", "fullmini-mha",
                                      "pruned_473k_finetuned.pkl"])
def test_cluster_pack_holds_the_matrices(geometry):
    """Every block's slab in the kernel's weight buffer is its columns of the
    product's matrices, (K, weight set, columns) row-major."""
    cfg, params = _model(geometry)
    arrays, meta = sm.pack_mega(params, cfg, torch.float32)
    for C in (8, 2):
        wk, table, smem = sm._cluster_pack(arrays, meta, C)
        plan = sm.mega_plan(meta, C)
        assert table.tolist() == plan["table"] and smem == plan["smem"]
        for p in plan["products"]:
            for row0, rows, n0, nc, src, nbytes, ring, after in p["ranks"]:
                got = wk[src: src + p["K"] * len(p["srcs"]) * nc].view(p["K"], -1, nc)
                for j, (name, col) in enumerate(p["srcs"]):
                    off, shape = meta["slices_w"][name]
                    m = arrays["w"][off: off + math.prod(shape)].view(shape[0], -1)
                    torch.testing.assert_close(got[:, j], m[:, col + n0: col + n0 + nc],
                                               atol=0, rtol=0)


def test_cluster_plan_cuts_the_outer_levels():
    """FullMini at C = 8: the outer levels' products are cut and, with fp32
    weights, run on the tensor cores, 16 columns a block where at least 8
    rows are left; a level of fewer rows keeps 32 columns a block on the SIMT
    path; the one-token products are small enough to run whole in every
    block or cut by columns, and never go to the tensor cores."""
    cfg, params = _model("fullmini-mamba")
    meta = sm.pack_mega(params, cfg, torch.float32)[1]
    plan = sm.mega_plan(meta, 8)
    by_name = {p["name"]: p for p in plan["products"]}
    e1c = by_name["e1c"]
    assert e1c["split"] and e1c["mma"] and {r[3] for r in e1c["ranks"]} == {16}
    assert e1c["ranks"][0][1] == 32 and by_name["d7t"]["mma"]
    e5c = by_name["e5c"]  # T = 4
    assert e5c["split"] and not e5c["mma"] and {r[3] for r in e5c["ranks"]} == {32}
    assert not by_name["m0dtw"]["split"] and not by_name["c1"]["split"]
    assert all(r[1] == 1 for r in by_name["e7c"]["ranks"])  # one token: columns only
    assert not any(p["mma"] for p in plan["products"] if not p["multi"])
    # bf16 packs keep the SIMT path's sum order
    bf16 = sm.pack_mega(tparams.prepare_weight_view(params, "bf16")[0], cfg, torch.bfloat16)[1]
    assert not any(p["mma"] for p in sm.mega_plan(bf16, 8)["products"])


def _jax_model(family, normalize):
    jcfg = JaxConfig(bottleneck=family, normalize_input=normalize, **SMALL)
    pj = jax_init_params(jax.random.PRNGKey(5), jcfg)
    return jcfg, pj, tparams.from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("family", ["mamba", "mha"])
def test_frame_contract_matches_jax(family, normalize):
    """mega_stream_frame (tail, new samples, std, count in; all new state out)
    on the CPU == JAX stream_step_mega (Pallas interpret), 4 frames."""
    jcfg, pj, pt = _jax_model(family, normalize)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    fl, tsd = cfg.frame_length, cfg.total_stride
    x = (np.random.default_rng(41).normal(size=(1, fl + 4 * tsd)) * 0.3).astype(np.float32)
    arrays, meta = sm.pack_mega(pt, cfg, torch.float32)
    st, _ = ts.stream_prime(pt, cfg, torch.from_numpy(x[:, :fl]))
    states, outs = [], []
    for t in range(4):
        new = torch.from_numpy(x[:, fl + t * tsd: fl + (t + 1) * tsd])
        st, y = sm.mega_stream_frame(st, new, arrays, meta, normalize)
        states.append(tparams.to_numpy(st))
        outs.append(y.numpy())
    jmega = jax_pack_mega(pj, jcfg, jnp.float32)
    sj, _ = js.stream_prime(pj, jcfg, jnp.asarray(x[:, :fl]))
    for t in range(4):
        new = jnp.asarray(x[:, fl + t * tsd: fl + (t + 1) * tsd])
        sj, yj = js.stream_step_mega(jcfg, sj, new, jmega, interpret=True)
        np.testing.assert_allclose(outs[t], np.asarray(yj), **TOL)
        for key in ("input_tail", "input_std", "frames"):
            np.testing.assert_allclose(states[t][key], np.asarray(sj[key]), **TOL, err_msg=key)
        got = jax.tree_util.tree_leaves(states[t])
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, sj))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)


def test_frame_contract_equals_step_contract():
    """The two entry points on the CPU: mega_stream_frame == the prologue,
    mega_stream_step on the normalised frame, the epilogue; the step's state
    is repeatable (the inputs are left as they were)."""
    jcfg, _, pt = _jax_model("lstm", True)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    arrays, meta = sm.pack_mega(pt, cfg, torch.float32)
    fl, tsd = cfg.frame_length, cfg.total_stride
    x = torch.from_numpy((np.random.default_rng(42).normal(size=(2, fl + tsd)) * 0.3)
                         .astype(np.float32))
    st, _ = ts.stream_prime(pt, cfg, x[:, :fl])
    before = [t.clone() for t in tparams.tree_leaves(st)]
    new = x[:, fl:]
    got, y = sm.mega_stream_frame(st, new, arrays, meta, True)
    frame = torch.cat([st["input_tail"], new], 1)
    frames = st["frames"] + 1
    std = (frame.std(dim=1, keepdim=True, correction=0) + 1e-3) / frames \
        + (1 - 1 / frames.float()) * st["input_std"]
    upd, y_step = sm.mega_stream_step(frame / std, st, arrays, meta)
    torch.testing.assert_close(y, y_step * std, atol=0, rtol=0)
    torch.testing.assert_close(got["input_std"], std, atol=0, rtol=0)
    assert got["frames"].dtype == torch.int32 and (got["frames"] == frames).all()
    torch.testing.assert_close(got["input_tail"], frame[:, tsd:], atol=0, rtol=0)
    for a, b in zip(tparams.tree_leaves(upd), tparams.tree_leaves(
            {k: got[k] for k in ("enc", "dec", "bottleneck")})):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    for t0, t1 in zip(before, tparams.tree_leaves(st)):
        torch.testing.assert_close(t0, t1, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("family", ["mamba", "mha", "mamba_s4"])
def test_frame_kernel_matches_plain_on_cuda(family, normalize):
    """K5 with the normalisation inside against mega_stream_frame_ref on the
    card: 4 carried frames at batch 2 (fp32 1e-4 of max|ref|), and a repeated
    launch bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a GPU")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CleanUMambaConfig(bottleneck=family, normalize_input=normalize, **FULLMINI)
    pt = tm.init_params(cfg, torch.Generator().manual_seed(2), dev)
    arrays, meta = sm.pack_mega(pt, cfg, torch.float32)
    fl, tsd = cfg.frame_length, cfg.total_stride
    x = torch.from_numpy((np.random.default_rng(43).normal(size=(2, fl + 4 * tsd)) * 0.3)
                         .astype(np.float32)).to(dev)
    st, _ = ts.stream_prime(pt, cfg, x[:, :fl])
    st = tparams.tree_map(lambda t: t.contiguous(), st)
    for t in range(4):
        new = x[:, fl + t * tsd: fl + (t + 1) * tsd]
        got, y = sm.mega_stream_frame(st, new, arrays, meta, normalize)
        again, y2 = sm.mega_stream_frame(st, new, arrays, meta, normalize)
        want, y_ref = sm.mega_stream_frame_ref(st, new, arrays, meta, normalize)
        assert torch.equal(y, y2)
        for a, b, c in zip([y] + tparams.tree_leaves(got), [y_ref] + tparams.tree_leaves(want),
                           [y2] + tparams.tree_leaves(again)):
            assert torch.equal(a, c)
            if b.numel():
                assert float((a.float() - b.float()).abs().max()) <= 1e-4 * max(
                    float(b.float().abs().max()), 1e-30)
        st = want


def test_pack_budget_refuses_what_jax_refuses():
    """The port's 16 MiB budget counts its own pack, which has none of the TPU
    pack's lane padding and selection matrices: the wide-lane geometry that
    JAX's 24 MiB budget refuses (11.3 M parameters, 22.4 MiB as the port packs
    it in bf16) is refused here too, and the released small geometry packs in
    both."""
    big = dict(channels_H=64, max_H=768, encoder_n_layers=2, tsfm_n_head=8, tsfm_d_model=512,
               tsfm_d_inner=2048)
    for spec, packs in ((big, False), (FULLMINI, True)):
        cfg = CleanUMambaConfig(**spec)
        ours = sm.pack_mega(tm.init_params(cfg, torch.Generator().manual_seed(1), "cpu"), cfg,
                            torch.bfloat16)
        jcfg = JaxConfig(**spec)
        theirs = jax_pack_mega(jax_init_params(jax.random.PRNGKey(1), jcfg), jcfg, jnp.bfloat16)
        assert (ours is not None) == (theirs is not None) == packs, spec
