"""K2, the selective scan's backward (``ops/cuda/selective_scan.py`` ->
``csrc/selective_scan.cu``: ``scan_bwd_kernel``, the walk, and
``scan_bwd_finish_kernel``, the last level of its sums; one call is one of
each).

Operations per state element and step, the least the gradient needs:
the forward state again (exp(dt * A), dt * A, B * (dt * u), its
multiply-add: 5), the state's gradient (C * gy and dA * g_h: 3), and the
gradients of C (h * gy into gC: 2), B (g_h * dt u into gB: 2), dt and A
(g_h * (A dA h_prev + B u) into gdt, gA: 4): 16.  Bytes: the inputs u, B, C,
gy in their dtype and dt, A, D, the chunk states' first read of h0, gh_last
in fp32; the outputs gu, gB, gC in their dtype and gdt, gA, gD, gh0 in fp32,
each once."""

PATTERN = r"\bscan_bwd_(finish_)?kernel\b"
CALL_PATTERN = r"\bscan_bwd_kernel\b"


def cost(B: int, L: int, Di: int, N: int, esize: int):
    """(operations, bytes) of one call (both launches)."""
    ops = B * L * Di * N * 16
    nbytes = (2 * B * L * Di * (2 * esize + 4)  # u, gy in, gu, dt in, gdt out
              + 4 * B * L * N * esize  # B, C in; gB, gC out
              + 2 * (Di * N * 4 + Di * 4)  # A, D in; gA, gD out
              + 2 * B * Di * N * 4)  # gh_last in, gh0 out
    return ops, nbytes
