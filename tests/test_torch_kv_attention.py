"""K6 (``ops/cuda/kv_attention.py``): one token of attention over per-row KV
rings.

On the CPU the plain version is held against the plain reference's banded
causal attention (``portbench/reference/cleanunet.py::attention``): rows of
different lengths stepped a token at a time, each row paused while the
others step (left out of that round's call, as a multiplexer's tick leaves
it out of the rows it gathers), windows shorter and longer than the ring
(1e-5 of max|ref|, fp32 on both sides, sums in another order).  On a card
the kernel is held against the plain version at every head width it is
built for: CleanUNet's widths (8 heads of 64) in fp32 and bf16, the
released small geometry's (8 heads of 8) and a test configuration's (2
heads of 16); 16 rows, a ring of 625, positions from empty to wrapped many
times; and the kernel over a gathered subset of the rows gives those rows'
results bit for bit.  Outputs at 1e-5 of max|ref| in fp32 (TF32 off;
another sum order) and 1e-2 in bf16 (both sides sum in fp32 and round
their result to bf16 once: a bf16 step is 2^-8 of the value), the rings
bit for bit (the kernel copies the new key and value).  The card cases
import no JAX: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_kv_attention.py``.
"""

import math

import numpy as np
import pytest
import torch

from cleanumamba_tpu_torch.ops.cuda.kv_attention import kv_attention, kv_attention_ref
from portbench.reference.cleanunet import attention
from portbench.reference.model import Prec

REL = 1e-5
REL_BF16 = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops here run on one thread: the suite's workers share the
    cores, and an oversubscribed thread pool makes small ops far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("W,n_head,d", [(4, 2, 16), (7, 4, 32), (16, 1, 8)])
def test_plain_version_matches_banded_attention(W, n_head, d):
    """Row b steps tokens 0..lengths[b]-1, one a round; a row that has run
    out, and row 1 in rounds 3-5, are paused: the rows still running step as
    their own batch, their rings gathered and copied back.  Each live row's
    output is the banded attention of its token over its last W tokens; a
    paused row's rings stay as they were."""
    lengths = [3 * W + 2, W + 1, 2, W]
    B = len(lengths)
    rng = np.random.default_rng(W + d)
    seq = {n: torch.from_numpy(rng.normal(size=(B, max(lengths), d)).astype(np.float32))
           for n in ("q", "k", "v")}
    want = attention(seq["q"], seq["k"], seq["v"], n_head, W, Prec())
    k_ring = torch.zeros((B, 3, W, d))[:, 1]  # a view of a larger cache, as a layer's
    v_ring = torch.zeros((B, 3, W, d))[:, 1]
    pos = torch.zeros(B, dtype=torch.int32)
    rounds = max(lengths) + 3
    for r in range(rounds):
        live = torch.tensor([int(pos[b]) < lengths[b] and not (b == 1 and 3 <= r < 6)
                             for b in range(B)])
        rows = live.nonzero()[:, 0]
        before = (k_ring.clone(), v_ring.clone())
        if rows.numel():
            q, k, v = (seq[n][rows, pos[rows].long()] for n in ("q", "k", "v"))
            kr, vr = k_ring[rows], v_ring[rows]  # gathered: a copy
            out = kv_attention(q, k, v, kr, vr, pos[rows], n_head)
            k_ring[rows], v_ring[rows] = kr, vr
            for i, b in enumerate(rows.tolist()):
                ref = want[b, int(pos[b])]
                assert float((out[i] - ref).abs().max()) <= REL * float(ref.abs().max())
        for b in (~live).nonzero()[:, 0].tolist():
            assert torch.equal(k_ring[b], before[0][b]) and torch.equal(v_ring[b], before[1][b])
        pos = pos + live.to(torch.int32)
    assert pos.tolist() == lengths


def test_plain_version_refuses_what_the_kernel_refuses():
    q = torch.zeros(2, 16)
    ring = torch.zeros(2, 4, 16)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="pos"):
        kv_attention(q, q, q, ring, ring.clone(), pos.long(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        kv_attention(q, q, q, torch.zeros(2, 16, 4).transpose(1, 2), ring, pos, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,H", [(torch.float32, 512, 8), (torch.bfloat16, 512, 8),
                                       (torch.float32, 64, 8), (torch.bfloat16, 32, 2)],
                         ids=["fp32-64", "bf16-64", "fp32-8", "bf16-16"])
def test_kernel_matches_plain_on_the_card(dtype, d, H):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    B, L, W = 16, 5, 625
    rel = REL if dtype == torch.float32 else REL_BF16
    g = torch.Generator(device=dev).manual_seed(0)
    k_cache = torch.randn((B, L, W, d), generator=g, device=dev).to(dtype)
    v_cache = torch.randn((B, L, W, d), generator=g, device=dev).to(dtype)
    pos = torch.tensor([0, 1, 2, 7, 78, 79, 80, 300, 623, 624, 625, 626, 1249, 1250, 5000, 40],
                       dtype=torch.int32, device=dev)
    sub = torch.tensor([b for b in range(B) if b % 5 != 3], device=dev)  # a gathered subset
    scale = 1.0 / math.sqrt(d)
    for li in (0, L - 1):
        q, k, v = ((torch.randn((B, d), generator=g, device=dev) * scale * 8).to(dtype)
                   for _ in range(3))
        kk, vk = k_cache.clone(), v_cache.clone()
        kp, vp = k_cache.clone(), v_cache.clone()
        ks, vs = k_cache[sub], v_cache[sub]  # the subset's rows gathered: a copy
        got = kv_attention(q, k, v, kk[:, li], vk[:, li], pos, H)
        again = kv_attention(q, k, v, kk.clone()[:, li], vk.clone()[:, li], pos, H)
        want = kv_attention_ref(q, k, v, kp[:, li], vp[:, li], pos, H)
        part = kv_attention(q[sub], k[sub], v[sub], ks[:, li], vs[:, li], pos[sub], H)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(kk, kp) and torch.equal(vk, vp)
        err = float((got.float() - want.float()).abs().max())
        assert err <= rel * float(want.float().abs().max()), err
        assert torch.equal(part, got[sub])
        assert torch.equal(ks, kk[sub]) and torch.equal(vs, vk[sub])
