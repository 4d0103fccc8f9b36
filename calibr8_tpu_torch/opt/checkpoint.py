"""Checkpoint and resume of long calibration runs.

The counterpart of calibr8_tpu's opt/checkpoint.py, which writes the
payload with orbax (a JAX library).  The port writes the same payload
(`x_canonical`, `history_x`, `history_J`, `meta`) with numpy into one
.npz file at the path given, `meta` as JSON text, so that
run_inverse(checkpoint_path=..., resume=True) restarts from it.
Trajectories persist as a compressed .npz and come back as tensors on a
given device.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def save_checkpoint(path, x_canonical, history=None, meta=None) -> None:
    """The optimizer's state: its canonical parameters, the evaluation
    history [(x, J)] and metadata, written to `path` whole or not at all
    (a temporary file, then os.replace)."""
    history = history or []
    payload = {
        "x_canonical": np.asarray(x_canonical, dtype=np.float64),
        "history_x": np.asarray([h[0] for h in history], dtype=np.float64).reshape(
            len(history), -1),
        "history_J": np.asarray([h[1] for h in history], dtype=np.float64),
        "meta": np.asarray(json.dumps(dict(meta or {}))),
    }
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path):
    """(x_canonical, history [(x, J)], meta)."""
    with np.load(path) as d:
        history = [(np.asarray(r), float(v)) for r, v in zip(d["history_x"], d["history_J"])]
        return np.asarray(d["x_canonical"]), history, json.loads(str(d["meta"]))


def save_trajectory(path, traj) -> None:
    """A primal trajectory (x, xi, path per step, the step QoI values),
    for adjoint-only restarts and postprocessing."""
    def stack(vs):
        return np.stack([v.detach().cpu().numpy() for v in vs])

    np.savez_compressed(path, x=stack(traj.x), xi=stack(traj.xi), path=stack(traj.path),
                        qoi_values=np.asarray(traj.qoi_values, dtype=np.float64))


def load_trajectory(path, device="cpu"):
    from calibr8_tpu_torch.solve.primal import Trajectory

    with np.load(path) as d:
        def tensors(k):
            return [torch.as_tensor(v, device=device) for v in d[k]]

        return Trajectory(x=tensors("x"), xi=tensors("xi"), path=tensors("path"),
                          qoi_values=[float(v) for v in d["qoi_values"]])
