"""K1, the selective scan's forward (``ops/cuda/selective_scan.py`` ->
``csrc/selective_scan.cu::scan_fwd_kernel``).

Operations per state element and step: exp(dt * A) (2), B * (dt * u) (1),
the state's multiply-add (2), C's multiply-add into y (2): 7, and per
channel and step dt * u and the skip D * u + y (3).  Bytes: u, B, C in
their dtype, dt, A, D, h0 and h_last in fp32, y in u's dtype, each once;
the chunk states a training forward also writes are left out."""

PATTERN = r"\bscan_fwd_kernel\b"


def cost(B: int, L: int, Di: int, N: int, esize: int):
    """(operations, bytes) of one launch."""
    ops = B * L * Di * (7 * N + 3)
    nbytes = (B * L * Di * (2 * esize + 4)  # u, y; dt
              + 2 * B * L * N * esize  # B, C
              + Di * N * 4 + Di * 4  # A, D
              + 2 * B * Di * N * 4)  # h0, h_last
    return ops, nbytes
