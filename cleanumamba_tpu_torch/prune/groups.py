"""Prunable dependency groups for CleanUMamba (the port's copy of
``cleanumamba_tpu/prune/groups.py``; the port's trees are dicts and lists
of tensors, and ``set_path`` rebuilds them as it rebuilds the JAX pytree).

Mirrors the reference's group graph (``CleanUMambaPrunableChannels``,
pruninggroup.py:405-501) over our param pytree:

- ``encode_down_{i}``: encoder conv out-channels + mix in-channels.
- ``decode_mix_{i}``:  decoder mix out-channels (2 GLU heads) + convT
  in-channels.
- ``skip_conn_{i}``:   encoder mix out (2 GLU heads), decoder mix in, and the
  consumers of that level's features: next encoder conv in / previous decoder
  convT out, or tsfm_conv1 in + tsfm_conv2 out at the deepest level.
- ``d_model``:         tsfm_conv1 out, tsfm_conv2 in, all norms, every
  mixer's in_proj in / out_proj out.
- ``d_inner{l}``:      in_proj out (2 heads: x and z), out_proj in, depthwise
  conv, x_proj in, dt_proj out, A_log rows, D.
- ``d_state{l}``:      x_proj out columns after dt_rank (2 heads: B and C),
  A_log cols.
- ``dt_rank{l}``:      x_proj out columns before d_state, dt_proj in.

A channel ``c`` of a group maps, in each participating tensor slice, to
indices ``offset + h * n_channels + c`` along ``axis`` for each head ``h``
(this fixes a reference inconsistency: its importance reshape grouped rows
``c*n_heads + h`` while its prune removed rows ``h*n_channels + c``;
pruninggroup.py:199 vs :244 — we use the prune convention everywhere).

Everything (widths, dt_rank offsets) is derived from the *current* shapes, so
groups remain valid across successive prunes with no offset bookkeeping.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from cleanumamba_tpu_torch.config import CleanUMambaConfig

Path = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Slice:
    """One tensor view participating in a group."""

    path: Path
    axis: int
    n_heads: int = 1
    offset: int = 0
    tail: int = 0  # fixed elements after the group's span along axis
    importance: bool = True  # participates in weight/grad importance
    telemetry_tap: Optional[str] = None  # key into the taps dict, if any


@dataclasses.dataclass
class PruneGroup:
    name: str
    n_channels: int
    slices: List[Slice]

    def check(self, params):
        for s in self.slices:
            leaf = get_path(params, s.path)
            span = leaf.shape[s.axis] - s.offset - s.tail
            assert span % s.n_heads == 0 and span // s.n_heads == self.n_channels, (
                self.name,
                s.path,
                leaf.shape,
                s,
                self.n_channels,
            )


def get_path(tree, path: Path):
    for p in path:
        tree = tree[p]
    return tree


def set_path(tree, path: Path, value):
    """Functional set: returns a new tree with tree[path] = value."""
    if len(path) == 1:
        if isinstance(tree, dict):
            new = dict(tree)
            new[path[0]] = value
            return new
        new = list(tree)
        new[path[0]] = value
        return new
    child = set_path(tree[path[0]], path[1:], value)
    if isinstance(tree, dict):
        new = dict(tree)
        new[path[0]] = child
        return new
    new = list(tree)
    new[path[0]] = child
    return new


def build_groups(params, cfg: CleanUMambaConfig) -> List[PruneGroup]:
    """Construct all groups from the current param shapes."""
    groups: List[PruneGroup] = []
    D = len(params["encoder"])

    for i in range(D):
        di = D - 1 - i  # decoder index mirroring encoder level i
        enc = params["encoder"][i]
        dec = params["decoder"][di]

        # --- encode_down_{i}: conv out + mix in (pruninggroup.py:420-427)
        ch = enc["conv_w"].shape[2]
        groups.append(
            PruneGroup(
                f"encode_down_{i}",
                ch,
                [
                    Slice(("encoder", i, "conv_w"), axis=2, telemetry_tap=f"enc_conv_{i}"),
                    Slice(("encoder", i, "conv_b"), axis=0, importance=False),
                    Slice(("encoder", i, "mix_w"), axis=1),
                ],
            )
        )

        # --- decode_mix_{i}: dec mix out (2 GLU heads) + convT in (:429-436)
        ch = dec["mix_w"].shape[2] // 2
        groups.append(
            PruneGroup(
                f"decode_mix_{i}",
                ch,
                [
                    Slice(("decoder", di, "mix_w"), axis=2, n_heads=2, telemetry_tap=f"dec_mix_{di}"),
                    Slice(("decoder", di, "mix_b"), axis=0, n_heads=2, importance=False),
                    Slice(("decoder", di, "convt_w"), axis=1),
                ],
            )
        )

        # --- skip_conn_{i}: enc mix out heads + consumers (:438-450)
        ch = enc["mix_w"].shape[2] // 2
        slices = [
            Slice(("encoder", i, "mix_w"), axis=2, n_heads=2, telemetry_tap=f"enc_out_{i}"),
            Slice(("encoder", i, "mix_b"), axis=0, n_heads=2, importance=False),
            Slice(("decoder", di, "mix_w"), axis=1),
        ]
        if i + 1 == D:
            slices += [
                Slice(("tsfm_conv1", "w"), axis=1),
                Slice(("tsfm_conv2", "w"), axis=2),
                Slice(("tsfm_conv2", "b"), axis=0, importance=False),
            ]
        else:
            slices += [
                Slice(("encoder", i + 1, "conv_w"), axis=1),
                Slice(("decoder", di - 1, "convt_w"), axis=2),
                Slice(("decoder", di - 1, "convt_b"), axis=0, importance=False),
            ]
        groups.append(PruneGroup(f"skip_conn_{i}", ch, slices))

    if cfg.bottleneck != "mamba":
        return groups

    bott = params["bottleneck"]
    n_layers = len(bott["layers"])

    # --- d_model (:452-463)
    ch = params["tsfm_conv1"]["w"].shape[2]
    slices = [
        Slice(("tsfm_conv1", "w"), axis=2, telemetry_tap="d_model_in"),
        Slice(("tsfm_conv1", "b"), axis=0, importance=False),
        Slice(("tsfm_conv2", "w"), axis=1),
        Slice(("bottleneck", "norm_f", "scale"), axis=0),
        Slice(("bottleneck", "norm_f", "bias"), axis=0, importance=False),
    ]
    for l in range(n_layers):
        slices += [
            Slice(("bottleneck", "layers", l, "norm", "scale"), axis=0),
            Slice(("bottleneck", "layers", l, "norm", "bias"), axis=0, importance=False),
            Slice(("bottleneck", "layers", l, "mixer", "in_proj"), axis=0),
            Slice(("bottleneck", "layers", l, "mixer", "out_proj"), axis=1),
        ]
    groups.append(PruneGroup("d_model", ch, slices))

    for l in range(n_layers):
        mixer = bott["layers"][l]["mixer"]
        mp: Path = ("bottleneck", "layers", l, "mixer")
        d_inner = mixer["dt_proj_w"].shape[1]
        dt_rank = mixer["dt_proj_w"].shape[0]
        d_state = (mixer["x_proj"].shape[1] - dt_rank) // 2

        # --- d_inner{l} (:466-478)
        groups.append(
            PruneGroup(
                f"d_inner{l}",
                d_inner,
                [
                    Slice(mp + ("in_proj",), axis=1, n_heads=2, telemetry_tap=f"d_inner_xz_{l}"),
                    Slice(mp + ("out_proj",), axis=0),
                    Slice(mp + ("conv_w",), axis=1),
                    Slice(mp + ("conv_b",), axis=0, importance=False),
                    Slice(mp + ("x_proj",), axis=0),
                    Slice(mp + ("dt_proj_w",), axis=1),
                    Slice(mp + ("dt_proj_b",), axis=0, importance=False),
                    Slice(mp + ("A_log",), axis=0),
                    Slice(mp + ("D",), axis=0),
                ],
            )
        )

        # --- d_state{l} (:480-491)
        groups.append(
            PruneGroup(
                f"d_state{l}",
                d_state,
                [
                    Slice(mp + ("x_proj",), axis=1, n_heads=2, offset=dt_rank),
                    Slice(mp + ("A_log",), axis=1),
                ],
            )
        )

        # --- dt_rank{l} (:493-498)
        groups.append(
            PruneGroup(
                f"dt_rank{l}",
                dt_rank,
                [
                    Slice(mp + ("x_proj",), axis=1, tail=2 * d_state),
                    Slice(mp + ("dt_proj_w",), axis=0),
                ],
            )
        )

    for g in groups:
        g.check(params)
    return groups
