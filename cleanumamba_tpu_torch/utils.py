"""Run records and model accounting (port of the parts of
``cleanumamba_tpu/utils.py`` that need no XLA).

``MetricsLogger`` is the append-only JSONL system of record of a run (the
reference logged to wandb only); ``model_macs_torch_convention`` is the
analytic MAC count in the reference's published convention.  The JAX
module's ``count_macs``/``model_macs`` read XLA's cost analysis of a
compiled function and have no counterpart here.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from cleanumamba_tpu_torch.models.cleanumamba import count_params

# the JAX package's name in this module: elements of every tensor leaf (an S4
# kernel's ``l_kernel`` and other static tags are not counted)
count_parameters = count_params


def model_macs_torch_convention(params, cfg, seconds: float = 1.0,
                                sample_rate: int = 16000) -> int:
    """MACs in the reference's published convention: what
    ``torchprofile.profile_macs`` reports on the traced torch model
    (reference pruning/util.py:128-130; README.md:11 quotes 468M for the
    442K model this way).

    That convention counts every convolution on its OUTPUT size
    (out_numel * Cin/g * K), conv-transpose included, where the output is S
    times longer than the input: it over-counts the true multiplies by the
    stride.  GEMMs count M*N*K; ops without a tracer handler count ZERO: the
    selective scan, the (I)FFTs of the S4 path, the fused LSTM op and all
    elementwise work.  Computed from the param shapes alone."""
    K, S, D = cfg.kernel_size, cfg.stride, cfg.encoder_n_layers
    L = cfg.valid_length(int(seconds * sample_rate))
    macs = 0
    lens = []
    # encoder: strided conv (grouped) + 1x1 GLU mix
    for i, ep in enumerate(params["encoder"]):
        k, cin, cout = ep["conv_w"].shape
        g = cfg.group_of_layer(i)
        L = (L - k) // S + 1
        lens.append(L)
        macs += L * cout * (cin // g) * k
        _, h, h2 = ep["mix_w"].shape
        macs += L * h * h2
    T = lens[-1]
    # bottleneck in/out 1x1s
    macs += T * params["tsfm_conv1"]["w"].shape[1] * params["tsfm_conv1"]["w"].shape[2]
    macs += T * params["tsfm_conv2"]["w"].shape[1] * params["tsfm_conv2"]["w"].shape[2]
    bp = params["bottleneck"]
    if cfg.bottleneck == "lstm":
        pass  # one fused aten::lstm op with no tracer handler: counted 0
    elif cfg.bottleneck == "mha":
        for lp in bp["layers"]:
            d_model = lp["attn"]["wq"].shape[0] if "attn" in lp else cfg.tsfm_d_model
            # q, k, v, out projections + the q k^T and attn @ v products + FFN
            macs += 4 * T * d_model * d_model
            macs += 2 * T * T * d_model
            if "ff1" in lp:
                macs += T * lp["ff1"]["w"].shape[0] * lp["ff1"]["w"].shape[1]
                macs += T * lp["ff2"]["w"].shape[0] * lp["ff2"]["w"].shape[1]
    else:
        for lp in bp["layers"]:
            p = lp["mixer"]
            if "x_proj" in p:  # mamba1 / mamba_s4 mixer projections
                d_model, two_din = p["in_proj"].shape
                d_inner = two_din // 2
                macs += T * d_model * two_din
                if "conv_w" in p:
                    macs += T * p["conv_w"].shape[0] * d_inner  # depthwise
                macs += T * p["x_proj"].shape[0] * p["x_proj"].shape[1]
                if "dt_proj_w" in p:
                    macs += T * p["dt_proj_w"].shape[0] * p["dt_proj_w"].shape[1]
                macs += T * p["out_proj"].shape[0] * p["out_proj"].shape[1]
                # selective scan / S4 FFT conv: custom op, counted 0
            else:  # mamba2: in_proj + depthwise conv over xBC + out_proj
                macs += T * p["in_proj"].shape[0] * p["in_proj"].shape[1]
                macs += T * p["conv_w"].shape[0] * p["conv_w"].shape[1]
                macs += T * p["out_proj"].shape[0] * p["out_proj"].shape[1]
    # decoder: 1x1 GLU mix + conv-transpose counted on its OUTPUT length
    for j, dp in enumerate(params["decoder"]):
        L_in = lens[D - 1 - j]
        _, cin, c2 = dp["mix_w"].shape
        macs += L_in * cin * c2
        k, ci, co = dp["convt_w"].shape
        L_out = (L_in - 1) * S + k
        macs += L_out * ci * co * k
    return int(macs)


class MetricsLogger:
    """Append-only JSONL run tracker (the JAX package's schema).

    One JSON object per line in wandb's history-row schema (``_step``,
    ``_runtime``, ``_timestamp``) plus ``_run_id`` and ``_kind``; every write
    is flushed, so a killed run loses at most the line in flight.  Reopen
    with the same ``run_id`` to append (resume): ``_runtime`` continues from
    the prior record.  :func:`read_history` reconstructs the trajectory and
    tolerates a torn last line.  An optional wandb mirror activates when the
    package and a login are available."""

    def __init__(self, path: Optional[str] = None, use_wandb: bool = False,
                 wandb_project: str = "cleanumamba-tpu", run_id: Optional[str] = None,
                 config: Optional[dict] = None):
        self.run_id = run_id or new_run_id()
        self.path = path
        self._fh = None
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            prior = read_history(path, run_id=self.run_id) if os.path.exists(path) else []
            if prior:
                # max over records: the dedupe sort may not put the newest last
                self._t0 -= max(float(r.get("_runtime", 0.0)) for r in prior)
            self._fh = open(path, "a")
            if config is not None and not prior:
                self._write({"_kind": "config", **_jsonable(config)})
        self._wandb = None
        if use_wandb:
            try:  # pragma: no cover - wandb is optional
                import wandb

                run = wandb.init(project=wandb_project, id=run_id,
                                 resume="must" if run_id else None, config=config)
                self._wandb = wandb
                self.run_id = run.id
            except Exception:
                self._wandb = None

    @classmethod
    def for_run(cls, directory: str, run_id: Optional[str] = None, **kw):
        """Open ``<directory>/metrics.jsonl`` for ``run_id`` (a new id if None)."""
        return cls(path=os.path.join(directory, "metrics.jsonl"), run_id=run_id, **kw)

    def _write(self, rec: Dict[str, Any]):
        now = time.time()
        rec = {"_run_id": self.run_id, "_timestamp": now,
               "_runtime": now - self._t0, **rec}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None,
            kind: str = "train"):
        rec = {k: _jsonable(v) for k, v in metrics.items()}
        if step is not None:
            rec["_step"] = step
        rec["_kind"] = kind
        if self._fh:
            self._write(rec)
        if self._wandb:  # pragma: no cover
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def new_run_id() -> str:
    return os.urandom(6).hex()


def read_history(path: str, run_id: Optional[str] = None,
                 kind: Optional[str] = None, dedupe: bool = True) -> list:
    """A run's trajectory from a metrics JSONL file.

    Skips torn or corrupt lines (a crash mid-write leaves at most one) and
    filters by run and kind when given.  ``dedupe`` keeps the LAST record
    per (_kind, _step): a run resumed from a checkpoint replays the
    iterations after it, and the replayed record is the one that reflects
    the surviving state (wandb's resume semantics)."""
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if run_id is not None and rec.get("_run_id") != run_id:
                continue
            if kind is not None and rec.get("_kind") != kind:
                continue
            rows.append(rec)
    if dedupe:
        last = {}
        for i, rec in enumerate(rows):
            if "_step" in rec:
                last[(rec.get("_kind"), rec["_step"])] = i
        keep = set(last.values())
        rows = [r for i, r in enumerate(rows) if "_step" not in r or i in keep]
        rows.sort(key=lambda r: (r.get("_timestamp", 0.0),
                                 r.get("_step", -1) if "_step" in r else -1))
    return rows


def _jsonable(v):
    """A JSON-serializable value: scalars stay scalars, arrays become lists,
    anything else a str."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "ndim"):
        if getattr(v, "ndim", 1) == 0 or getattr(v, "size", 2) == 1:
            return float(v)
        try:
            return [_jsonable(x) for x in v.tolist()]
        except Exception:
            return str(v)
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
